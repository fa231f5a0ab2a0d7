// Dependent-quantization scans for Hopper (sm_90a).
//
// K1 dq_trellis  replaces the Pallas kernel wrenc_tpu/kernels/
//                trellis_pallas.py::_kernel (launched by _call): the exact
//                8-state (q_state x trailing) Viterbi with backtrack and
//                the committed-level rate. Eight lanes per block of
//                coefficients; one launch takes up to K1_MAX_JOBS jobs of
//                mixed block sizes (the device commit engine's wave).
// K2 dq_greedy   replaces the lax.scan in wrenc_tpu/kernels/quantize.py::
//                greedy_depquant: greedy two-candidate dep-quant with the
//                RD level rate. 128-thread CTAs of about 4,096 positions;
//                1 or 8 lanes per block walk the chain.
//
// Bound: both are sequential scans over the P coding-order positions. The
// DRAM traffic is one read of the coefficients and one write of the
// levels; the work is a fixed number of 32-bit integer operations per
// position. At the small batches of the commit scan (tens of blocks) the
// dependent chain of P steps sets K1's time, not the bound.
//
// K2's design: the greedy choice at a position depends on the carried
// state (q_state, trailing) only through delta = q_state >> 1 and
// trailing, so the position's step is a map of the 8 states, fixed by
// its coefficient: one word of 8 nibbles (k2_record). All the work of
// the choice (the floor division, four candidate costs) is done for
// every position in parallel, coalesced in t's memory order, into
// shared-memory records; the chain is then a shift and a mask per
// position (k2_walk; with 8 lanes per block segment-parallel, k2_map);
// the levels are recomputed from the entry states in parallel and
// written as int16 in raster order; one lane per block sums the rates
// in ascending coding order (P dependent f32 adds: K2's chain floor).
// It reads t in place (row- or column-major blocks) and writes nothing
// but q and rate; lam_dq / lv are read through __ldg (L1-resident).
//
// K1's design against that chain (one warp per CTA; a launch takes up to
// K1_MAX_JOBS jobs of mixed sizes, CTAs of the largest size first):
// - G = 8 lanes per block (4 blocks a warp): lane d holds destination
//   state d's cost. Every edge into d comes from one of four source states
//   (k1_dest), so a step is one round of 8 shuffles (the previous step's
//   costs), four adds, a min of four, and the min of eight for the
//   normalisation, which is applied after the argmin and so needs no
//   second round. Ahead of the chain, the group's 8 lanes compute 8
//   positions' edge ingredients at once (one floor division each) and
//   every destination's four edge costs into a shared-memory ring.
// - G = 1 (32 blocks a warp), for large batches of 4 x 4 blocks, where
//   the card is full either way and one lane per block issues fewer
//   instructions per position: the lane carries all 8 states and computes
//   the next position's ingredients during this one's relaxation.
// - Backpointers: per position and block one word of 8 nibbles (hit bit
//   and source state), in shared memory. With G = 8 the backtrack runs in
//   8 segments, one per lane (each maps its segment's top states to its
//   bottom states, the maps are chained, each lane walks its segment).
// - The levels are recomputed from the chosen source in parallel
//   positions, written as int16 in raster order through the coding-order
//   table (staged in shared memory); one lane sums the per-position rates
//   in ascending order.
// - Nothing of K1 touches device memory beyond t, q, rate, the per-row
//   quant parameters and the read-only tables.
//
// Arithmetic is int32 with explicit wrap (unsigned casts) and floor
// division where an operand can be negative, matching XLA. The only float
// op is the f32 rate sum, a plain add in ascending position order, which
// FMA contraction cannot touch.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int K1_MAX_JOBS = 8;

// One job: B blocks of n x n coefficients (int32, dense: row-major, or
// column-major when t_transposed is 1, as the DCT leaves them) -> levels
// (row-major int16) and committed-level rates. ls / bd: a pointer read at
// [stride * b] (stride 0 or 1), or, when the pointer is null, the value.
// K2 takes one such job (job[0] of a K1Desc, whose lanes it reads).
struct K1Job {
  const int* t;
  int16_t* q;
  float* rate;
  const int* ls;
  const int* bd;
  int B;
  int log2_n;
  int ls_stride;
  int bd_stride;
  int ls_val;
  int bd_val;
  int cta_begin;   // first CTA of this job; jobs are ordered by P descending
  int t_transposed;
};

struct K1Desc {
  K1Job job[K1_MAX_JOBS];
  int n_jobs;
  int n_ctas;
  int max_log2_n;
  int lanes;       // lanes per block of coefficients: 8 or 1
};

namespace {

constexpr int BIG = 1 << 29;
constexpr int TAB = 1024;

__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int wshl(int a, int s) {
  return (int)((uint32_t)a << s);
}
// floor division for b > 0 (C++ '/' truncates toward zero)
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int clip1023(int v) {
  return v < 0 ? 0 : (v > TAB - 1 ? TAB - 1 : v);
}
// level candidate a for (delta, k) at a coefficient: the quantizer's
// a0 = (s // ls + delta) // 2, plus k; zero coefficients have only a = 0
__device__ __forceinline__ int level_cand(int base, int delta, int k,
                                          bool zero) {
  return zero ? 0 : floordiv(base + delta, 2) + k;
}

// ------------------------------------------------------------------- K1

// One CTA is one warp. With G = 8 lanes per block it takes 4 blocks, with
// G = 1 it takes 32; the host packer picks G per launch (kernels/
// trellis.py::pack_jobs) and gives each job ceil(B / (32 / G)) CTAs.
constexpr unsigned FULL = 0xffffffffu;
// edge cost of an edge that does not reach a destination: above every
// real total (<= 2 BIG) and still no overflow when added to a cost
constexpr int NO_EDGE = 0x7fffffff - BIG - 1;
// G = 8: the ring of one tile's edge costs (8 positions x 4 blocks x 8
// destinations x int4) and a 32-word exchange for the backpointer
// transpose
constexpr int K1_RING_BYTES = 8 * 4 * 8 * 16;
constexpr int K1_LANE8_FIXED = K1_RING_BYTES + 32 * 4;

// offset of size log2_n's table in the coding-order tables of log2 sizes
// 2..5 concatenated: 16 + 64 + ... + P / 4 = (P - 16) / 3
__host__ __device__ constexpr int order_offset(int log2_n) {
  return ((1 << (2 * log2_n)) - 16) / 3;
}

// dynamic shared memory of one CTA for blocks of P positions: (G = 8) the
// ring and exchange; one backpointer word per position and block (later
// the backtrack's record, then the position's rate); the coding order
__host__ __device__ constexpr int k1_smem_bytes(int G, int P) {
  return (G == 8 ? K1_LANE8_FIXED : 0) + 4 * (32 / G) * P + 2 * P;
}

// the four (c4, sa4) edge ingredients of a coefficient on the compact
// (delta, k) grid, j = 2 * delta + k
struct Ingredients {
  int c4[4], sa4[4];
};

__device__ __forceinline__ Ingredients k1_ingredients(
    int tc, int ls, int bd, const int* __restrict__ lam) {
  Ingredients r;
  const int bdo = (1 << bd) >> 1;
  const bool neg = tc < 0;
  const bool zero = tc == 0;
  const int atc = neg ? -tc : tc;
  const int s = wadd(wshl(atc, bd), neg ? bdo : -bdo);
  const int base = zero ? 0 : floordiv(s, ls);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int delta = j >> 1, k = j & 1;
    const int a = level_cand(base, delta, k, zero);
    const int mag = a == 0 ? 0 : 2 * a - delta;
    const int dq = wadd(wmul(mag, ls), bdo) >> bd;
    const int d = atc - dq;
    const int dist = d < 0 ? -d : d;
    int c = wadd(wmul(128, dist), __ldg(lam + clip1023(a + 1)));
    c = c < BIG ? c : BIG;
    if (zero && k == 1) c = BIG;              // zeros: a single option
    r.c4[j] = c;
    r.sa4[j] = neg ? -a : a;
  }
  return r;
}

// The edges into destination state D = 2 qd + trd. They come from the
// four source states 4h..4h+3 (h = qd & 1, all with delta = h): sources
// 4h, 4h+1 (qs = 2h) through the level of parity pa = qd >> 1, sources
// 4h+2, 4h+3 through parity pa ^ 1, in each case the one k whose level
// has that parity (at a zero coefficient only k = 0, which has parity 0;
// its k = 1 edge costs more than its k = 0 edge and is never taken).
// Sources 4h+1, 4h+3 are trailing: a zero level is free (the DC position
// refunds lam_dq[1] once more) and reaches trd = 1.
// Per (h, parity) combo x = 2h + p: X = the edge from a non-trailing
// source, Yn / Yt = from a trailing source into trd = 0 / 1.
struct EdgeCosts {
  int X[4], Yn[4], Yt[4];
};

__device__ __forceinline__ EdgeCosts k1_edges(const Ingredients& in,
                                              bool zero, int refund) {
  EdgeCosts e;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int h = x >> 1, p = x & 1;
    const int k = (in.sa4[2 * h] & 1) ^ p;
    const int c = k ? in.c4[2 * h + 1] : in.c4[2 * h];
    const bool az = (k ? in.sa4[2 * h + 1] : in.sa4[2 * h]) == 0;
    const bool v = !(zero && k);
    e.X[x] = v ? c : NO_EDGE;
    e.Yn[x] = v && !az ? c : NO_EDGE;
    e.Yt[x] = v && az ? wadd(c, -refund) : NO_EDGE;
  }
  return e;
}

// destination D's four edge costs, from sources 4h + 0..3 in order
__device__ __forceinline__ int4 k1_dest(const EdgeCosts& e, int D) {
  const int qd = D >> 1, h = qd & 1, pa = qd >> 1;
  const int A = 2 * h + pa, B = 2 * h + (pa ^ 1);
  return (D & 1) ? make_int4(NO_EDGE, e.Yt[A], NO_EDGE, e.Yt[B])
                 : make_int4(e.X[A], e.Yn[A], e.X[B], e.Yn[B]);
}

// One destination's relaxation. v0..v3: the costs of its sources before
// the previous step's normalisation, mn: their common minimum over all 8
// states. Returns the new cost; *nib = 8 | source if it is below BIG,
// else 0 (the reference's slot 0).
//
// Exactness: this adds each source's cost before the normalisation and
// subtracts the minimum after the argmin, which equals the reference's
// normalise-then-add as long as no sum wraps: costs lie in [0, BIG] and
// edge costs in [-2 lam_dq[1], BIG] whenever |t| < 2^22 (t << bd_shift
// and 128 * dist then fit in int32), far above any transform coefficient.
__device__ __forceinline__ int k1_relax(int v0, int v1, int v2, int v3,
                                        int mn, int4 c, int h, int* nib) {
  const int r0 = v0 + c.x, r1 = v1 + c.y, r2 = v2 + c.z, r3 = v3 + c.w;
  const int m01 = min(r0, r1), m23 = min(r2, r3);
  const int nc = min(min(m01, m23) - mn, BIG);
  // the first edge of the minimum = the sequential strict-< relaxation
  const bool s01 = r1 < r0, s23 = r3 < r2, sB = m23 < m01;
  const int e = sB ? 2 + (int)s23 : (int)s01;
  *nib = nc < BIG ? 8 | (4 * h) | e : 0;
  return nc;
}

// first-index argmin of the normalised final costs
__device__ __forceinline__ int k1_final_state(const int (&v)[8]) {
  int mn = v[0];
#pragma unroll
  for (int s = 1; s < 8; ++s) mn = min(mn, v[s]);
  int state = 0, best = wadd(v[0], -mn);
#pragma unroll
  for (int s = 1; s < 8; ++s) {
    const int c = wadd(v[s], -mn);
    if (c < best) { best = c; state = s; }
  }
  return state;
}

// Walks backpointer words of positions hi-1 down to lo (word(p) its
// address; hi - lo a multiple of CH) from state D; overwrites each with
// the record D << 4 | nibble and returns the state below lo. The words
// are loaded CH at a time ahead of the chain.
template <int CH, class Word>
__device__ __forceinline__ int k1_walk(uint32_t* bp, Word word, int lo,
                                       int hi, int D) {
  for (int p0 = hi; p0 > lo; p0 -= CH) {
    uint32_t w[CH];
#pragma unroll
    for (int u = 0; u < CH; ++u) w[u] = bp[word(p0 - 1 - u)];
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const uint32_t nib = (w[u] >> (4 * D)) & 0xFu;
      bp[word(p0 - 1 - u)] = ((uint32_t)D << 4) | nib;
      D = (int)(nib & 7u);
    }
  }
  return D;
}

// The same walk from all 8 states at once, without writing: nibble s of
// the result is the state below lo reached from state s at hi.
template <int CH, class Word>
__device__ __forceinline__ uint32_t k1_map(const uint32_t* bp, Word word,
                                           int lo, int hi) {
  int st[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) st[s] = s;
  for (int p0 = hi; p0 > lo; p0 -= CH) {
    uint32_t w[CH];
#pragma unroll
    for (int u = 0; u < CH; ++u) w[u] = bp[word(p0 - 1 - u)];
#pragma unroll
    for (int u = 0; u < CH; ++u) {
#pragma unroll
      for (int s = 0; s < 8; ++s) st[s] = (w[u] >> (4 * st[s])) & 7u;
    }
  }
  uint32_t map = 0;
#pragma unroll
  for (int s = 0; s < 8; ++s) map |= (uint32_t)st[s] << (4 * s);
  return map;
}

// Levels and per-position rates at positions first + stride * j, j below
// count (a multiple of CH), CH at a time with their coefficients loaded
// first. Reads each record word and overwrites it with the position's f32
// rate.
template <int CH, class Word, class Tix>
__device__ __forceinline__ void k1_levels(
    uint32_t* bp, Word word, Tix tix, const int16_t* order, int first,
    int stride, int count, const int* tb, bool active, int16_t* qb, int ls,
    int bd, const float* __restrict__ lv) {
  const float lv0 = __ldg(lv);
  const int bdo = (1 << bd) >> 1;
  for (int j0 = 0; j0 < count; j0 += CH) {
    int at[CH], tcs[CH];
#pragma unroll
    for (int u = 0; u < CH; ++u) at[u] = order[first + stride * (j0 + u)];
#pragma unroll
    for (int u = 0; u < CH; ++u)
      tcs[u] = active ? __ldg(tb + tix(at[u])) : 0;
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const int p = first + stride * (j0 + u);
      const uint32_t rec = bp[word(p)];
      const int D = (int)(rec >> 4), src = (int)(rec & 7u);
      const bool hit = (rec & 8u) != 0;
      const int delta = src >> 2;
      const int tc = tcs[u];
      const bool neg = tc < 0;
      const int atc = neg ? -tc : tc;
      const int s = wadd(wshl(atc, bd), neg ? bdo : -bdo);
      const int a0 = floordiv(floordiv(s, ls) + delta, 2);
      // the edge's k: the one whose level has the parity that reaches D
      // from this source (see k1_dest)
      const int k = hit ? (a0 & 1) ^ (D >> 2) ^ ((src >> 1) & 1) : 0;
      const int a = tc == 0 ? 0 : a0 + k;
      const int mag = 2 * a - delta;
      if (active) qb[at[u]] = (int16_t)(a == 0 ? 0 : (neg ? -mag : mag));
      const float r =
          a == 0 ? ((src & 1) ? 0.0f : lv0) : __ldg(lv + clip1023(a));
      bp[word(p)] = __float_as_uint(r);
    }
  }
}

// committed-level rate in ASCENDING coding order (the reference's f32
// accumulation order)
template <class Word>
__device__ __forceinline__ float k1_rate_sum(const uint32_t* bp, Word word,
                                             int P) {
  float r_sum = 0.0f;
#pragma unroll 8
  for (int p = 0; p < P; ++p) r_sum = r_sum + __uint_as_float(bp[word(p)]);
  return r_sum;
}

template <int G>
__global__ void __launch_bounds__(32)
dq_trellis_kernel(const K1Desc desc, const int* __restrict__ lam,
                  const float* __restrict__ lv,
                  const int16_t* __restrict__ order_all) {
  constexpr int BPW = 32 / G;                          // blocks per warp
  extern __shared__ __align__(16) unsigned char smem[];
  // this CTA's job (compile-time indices keep the descriptor in the
  // parameter bank)
  int ji = 0;
#pragma unroll
  for (int i = 1; i < K1_MAX_JOBS; ++i)
    if (i < desc.n_jobs && (int)blockIdx.x >= desc.job[i].cta_begin) ji = i;
  K1Job job = desc.job[0];
#pragma unroll
  for (int i = 1; i < K1_MAX_JOBS; ++i)
    if (i == ji) job = desc.job[i];
  const int log2_n = job.log2_n;
  const int P = 1 << (2 * log2_n);

  const int lane = threadIdx.x;
  const int g = lane / G, d = lane % G;                // block, lane in it
  uint32_t* bp = reinterpret_cast<uint32_t*>(
      smem + (G == 8 ? K1_LANE8_FIXED : 0));
  int16_t* order = reinterpret_cast<int16_t*>(
      smem + (G == 8 ? K1_LANE8_FIXED : 0) + 4 * BPW * P);
  const int16_t* og = order_all + order_offset(log2_n);
  for (int i = lane; i < P; i += 32) order[i] = og[i];
  __syncwarp();

  // this lane's block; lanes of absent blocks run every step on zeros
  // (the shuffles need all 32 lanes) and store nothing
  const int b = ((int)blockIdx.x - job.cta_begin) * BPW + g;
  const bool active = b < job.B;
  const int bb = active ? b : 0;
  const int ls = job.ls ? job.ls[job.ls_stride * bb] : job.ls_val;
  const int bd = job.bd ? job.bd[job.bd_stride * bb] : job.bd_val;
  const int* tb = job.t + (size_t)bb * P;
  int16_t* qb = job.q + (size_t)bb * P;
  const int lam1 = __ldg(lam + 1);
  // offset in t of raster index r = y * n + x
  const int mask_n = (1 << log2_n) - 1;
  const bool tt = job.t_transposed != 0;
  auto tix = [=](int r) {
    return tt ? ((r & mask_n) << log2_n) | (r >> log2_n) : r;
  };
  // this block's backpointer word of position p
  auto word = [=](int p) { return p * BPW + g; };

  int state;
  if constexpr (G == 8) {
    // Lane d holds destination state d's cost. Per tile of 8 positions
    // the group's lanes first produce the 8 positions' edge costs of
    // every destination into the ring (lane d position d), then relax
    // them one position at a time: one round of 8 shuffles, four adds,
    // a min of four and the min of eight for the normalisation.
    int4* ring = reinterpret_cast<int4*>(smem);
    uint32_t* xch = reinterpret_cast<uint32_t*>(smem + K1_RING_BYTES);
    const int T = P >> 3;
    const int gbase = lane & 24, h = (d >> 1) & 1;
    auto fetch = [&](int tile) {
      return active ? __ldg(tb + tix(order[tile * 8 + d])) : 0;
    };
    // ring row (position i, block g): destination D at chunk D ^ i
    auto produce = [&](const Ingredients& in, int tc, bool is_dc) {
      const EdgeCosts e =
          k1_edges(in, tc == 0, wadd(lam1, is_dc ? lam1 : 0));
      int4* row = ring + (d * 4 + g) * 8;
#pragma unroll
      for (int D = 0; D < 8; ++D) row[D ^ d] = k1_dest(e, D);
    };
    int nc = d == 1 ? 0 : BIG;     // this state's cost, before the
                                   // normalisation of the step that made it
    // the tile's 8 x 8 backpointer nibbles (xch[lane]: nibble i = the
    // source into state d at position i), transposed: lane d takes the
    // word of position d (nibble s = state s)
    auto transposed = [&]() {
      const uint4 w0 = *reinterpret_cast<const uint4*>(xch + gbase);
      const uint4 w1 = *reinterpret_cast<const uint4*>(xch + gbase + 4);
      const uint32_t ws[8] = {w0.x, w0.y, w0.z, w0.w,
                              w1.x, w1.y, w1.z, w1.w};
      uint32_t pk = 0;
#pragma unroll
      for (int s = 0; s < 8; ++s)
        pk |= ((ws[s] >> (4 * d)) & 0xFu) << (4 * s);
      return pk;
    };
    {
      const int tc = fetch(0);
      produce(k1_ingredients(tc, ls, bd, lam), tc, false);   // T >= 2
    }
    int tc_next = fetch(1);
    // One basic block per tile, so that the next tile's ingredients and
    // edge costs interleave with this tile's chain. The last tile's
    // producer works on a repeated coefficient and fills a ring nobody
    // reads; tile 0 stores a word that tile 1 overwrites.
    for (int tile = 0; tile < T; ++tile) {
      __syncwarp();
      int4 R[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) R[i] = ring[(i * 4 + g) * 8 + (d ^ i)];
      bp[word(max(tile - 1, 0) * 8 + d)] = transposed();
      __syncwarp();
      const int tc1 = tc_next;
      const Ingredients in1 = k1_ingredients(tc1, ls, bd, lam);
      tc_next = fetch(min(tile + 2, T - 1));
      uint32_t acc = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        int v[8];
#pragma unroll
        for (int s = 0; s < 8; ++s)
          v[s] = __shfl_sync(FULL, nc, gbase + (s ^ (4 * h)));
        const int mn = min(min(min(v[0], v[1]), min(v[2], v[3])),
                           min(min(v[4], v[5]), min(v[6], v[7])));
        int nib;
        nc = k1_relax(v[0], v[1], v[2], v[3], mn, R[i], h, &nib);
        acc |= (uint32_t)nib << (4 * i);
      }
      produce(in1, tc1, tile + 1 == T - 1 && d == 7);
      xch[lane] = acc;
    }
    __syncwarp();
    bp[word((T - 1) * 8 + d)] = transposed();
    int v[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) v[s] = __shfl_sync(FULL, nc, gbase + s);
    state = k1_final_state(v);
    __syncwarp();
    // backtrack in 8 segments of S positions, lane d segment d: each lane
    // maps every state at its segment's top to the state below it (8
    // chains at once), the maps are chained from the top, then each lane
    // walks its segment from its own top state
    const int S = P >> 3, lo = d * S, hi = lo + S;
    const uint32_t map = S % 8 ? k1_map<2>(bp, word, lo, hi)
                               : k1_map<8>(bp, word, lo, hi);
    uint32_t maps[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) maps[l] = __shfl_sync(FULL, map, gbase + l);
    int top = state;
#pragma unroll
    for (int l = 7; l > 0; --l)
      if (l > d) top = (maps[l] >> (4 * top)) & 7u;
    if (S % 8) k1_walk<2>(bp, word, lo, hi, top);
    else k1_walk<8>(bp, word, lo, hi, top);
    __syncwarp();
    // levels: lane d takes positions d, d + 8, ...
    if (S % 8)
      k1_levels<2>(bp, word, tix, order, d, 8, S, tb, active, qb, ls, bd, lv);
    else
      k1_levels<8>(bp, word, tix, order, d, 8, S, tb, active, qb, ls, bd, lv);
    __syncwarp();
    if (d == 0 && active) job.rate[b] = k1_rate_sum(bp, word, P);
  } else {
    // G = 1: the lane carries all 8 states of its block, one position at
    // a time; the next position's ingredients are computed during this
    // one's relaxation, the coefficient after that already loaded
    int nc[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) nc[s] = s == 1 ? 0 : BIG;
    auto fetch = [&](int p) {
      return active ? __ldg(tb + tix(order[p])) : 0;
    };
    int tc = fetch(0);
    Ingredients in = k1_ingredients(tc, ls, bd, lam);
    int tc_next = fetch(1);
    for (int p = 0; p < P; ++p) {
      const EdgeCosts e =
          k1_edges(in, tc == 0, wadd(lam1, p == P - 1 ? lam1 : 0));
      const int tc1 = tc_next;
      in = k1_ingredients(tc1, ls, bd, lam);   // the last one unused
      tc_next = fetch(min(p + 2, P - 1));
      tc = tc1;
      int mn = nc[0];
#pragma unroll
      for (int s = 1; s < 8; ++s) mn = min(mn, nc[s]);
      int nn[8];
      uint32_t pk = 0;
#pragma unroll
      for (int D = 0; D < 8; ++D) {
        const int h = (D >> 1) & 1;
        int nib;
        nn[D] = k1_relax(nc[4 * h], nc[4 * h + 1], nc[4 * h + 2],
                         nc[4 * h + 3], mn, k1_dest(e, D), h, &nib);
        pk |= (uint32_t)nib << (4 * D);
      }
#pragma unroll
      for (int s = 0; s < 8; ++s) nc[s] = nn[s];
      bp[word(p)] = pk;
    }
    state = k1_final_state(nc);
    k1_walk<8>(bp, word, 0, P, state);
    k1_levels<8>(bp, word, tix, order, 0, 1, P, tb, active, qb, ls, bd, lv);
    if (active) job.rate[b] = k1_rate_sum(bp, word, P);
  }
}

// ------------------------------------------------------------------- K2

// One CTA of K2_THREADS threads takes k2_blocks(G, P) blocks, about
// K2_POS_PER_CTA positions; G of its lanes walk each block's chain.
constexpr int K2_THREADS = 128;
constexpr int K2_POS_PER_CTA = 4096;
// the record bits that survive the walk: k of each (delta, trailing)
// input j at bit 4j + 3, the sign at bit 19, a zero coefficient at 23
constexpr uint32_t K2_FLAGS = 0x00888888u;

__host__ __device__ constexpr int k2_blocks(int G, int P) {
  return (K2_POS_PER_CTA / P > K2_THREADS / G) ? K2_THREADS / G
         : (K2_POS_PER_CTA / P > 0 ? K2_POS_PER_CTA / P : 1);
}
// words of one block in a record array: one pad word per 32, so that a
// walk down a column of a column-major block meets no bank conflict,
// and one more, so that lanes walking different blocks do not either
__host__ __device__ constexpr int k2_stride(int P) {
  return P + (P >> 5) + 1;
}
__device__ __forceinline__ int k2_pad(int m) { return m + (m >> 5); }
// two record arrays, the per-block ls / bd and the walk's order
__host__ __device__ constexpr int k2_smem_bytes(int G, int P) {
  return 8 * k2_blocks(G, P) * (k2_stride(P) + 1) + 2 * P;
}

// One coefficient's record: the greedy choice depends on the carried
// state (q_state, trailing) only through delta = q_state >> 1 and
// trailing, so the step from state D = 2 q_state + trailing to the next
// state is a map of 8 states fixed by the coefficient. Nibble D of the
// word holds D's next state; bit 3 of nibble j = 2 delta + trailing the
// chosen k of that input; bits 19 / 23 the sign / a zero coefficient.
// *base: floor(s / ls), from which a level is recomputed.
__device__ __forceinline__ uint32_t k2_record(int tc, int ls, int bd,
                                              const int* __restrict__ lam,
                                              int lam0, int* base_out) {
  const int bdo = (1 << bd) >> 1;
  const bool neg = tc < 0, zero = tc == 0;
  const int atc = neg ? -tc : tc;
  const int s = wadd(wshl(atc, bd), neg ? bdo : -bdo);
  const int base = zero ? 0 : floordiv(s, ls);
  *base_out = base;
  uint32_t w = (neg ? 1u << 19 : 0u) | (zero ? 1u << 23 : 0u);
#pragma unroll
  for (int delta = 0; delta < 2; ++delta) {
    const int a0 = floordiv(base + delta, 2);
    int c[2][2];                                   // [k][trailing]
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int ak = a0 + k;
      const int mag = ak == 0 ? 0 : 2 * ak - delta;
      const int dq = wadd(wmul(mag, ls), bdo) >> bd;
      const int d = atc - dq;
      const int dc = wmul(128, d < 0 ? -d : d);
      c[k][0] = wadd(dc, __ldg(lam + clip1023(ak + 1)));
      c[k][1] = ak == 0 ? wadd(dc, lam0) : c[k][0];   // bits 0 if trailing
    }
#pragma unroll
    for (int tr = 0; tr < 2; ++tr) {
      const int k = c[1][tr] < c[0][tr] ? 1 : 0;       // strict <: ties keep a0
      const int a = zero ? 0 : a0 + k;
      // from q_state = 2 delta (D = 4 delta + tr) the level's parity p
      // leads to q_state 2p + delta; from 2 delta + 1 to 2 (p ^ 1) + delta
      const uint32_t nx =
          4u * (uint32_t)(a & 1) + 2u * delta + (tr && a == 0 ? 1u : 0u);
      w |= (uint32_t)k << (4 * (2 * delta + tr) + 3);
      w |= nx << (4 * (4 * delta + tr));
      w |= (nx ^ 4u) << (4 * (4 * delta + 2 + tr));
    }
  }
  return w;
}

// Maps every state at position lo to the state after position hi - 1
// through the records rb[ord[p]] (8 walks at once); nibble s of the
// result is the state reached from s.
__device__ __forceinline__ uint32_t k2_map(const uint32_t* rb,
                                           const int16_t* ord, int lo,
                                           int hi) {
  int st[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) st[s] = s;
  for (int p0 = lo; p0 < hi; p0 += 2) {            // hi - lo is even
    const uint32_t w0 = rb[ord[p0]], w1 = rb[ord[p0 + 1]];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      st[s] = (w0 >> (4 * st[s])) & 7u;
      st[s] = (w1 >> (4 * st[s])) & 7u;
    }
  }
  uint32_t map = 0;
#pragma unroll
  for (int s = 0; s < 8; ++s) map |= (uint32_t)st[s] << (4 * s);
  return map;
}

// Walks positions lo..hi-1 from state D, leaving in each record its
// flags and the state entering it. The records are loaded CH at a time
// ahead of the chain, whose step is a shift and a mask.
template <int CH>
__device__ __forceinline__ void k2_walk(uint32_t* rb, const int16_t* ord,
                                        int lo, int hi, int D) {
  for (int p0 = lo; p0 < hi; p0 += CH) {
    int ix[CH];
    uint32_t w[CH];
#pragma unroll
    for (int u = 0; u < CH; ++u) ix[u] = ord[p0 + u];
#pragma unroll
    for (int u = 0; u < CH; ++u) w[u] = rb[ix[u]];
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      rb[ix[u]] = (w[u] & K2_FLAGS) | (uint32_t)D;
      D = (int)((w[u] >> (4 * D)) & 7u);
    }
  }
}

// K2. G lanes per block walk its chain (G = 1: one lane walks all P
// positions; G = 8: each lane maps its segment of P / 8 positions for
// all 8 entry states, the maps are chained across the lanes by
// shuffles, and each lane walks its segment). Everything else is
// parallel over the CTA's positions, in the memory order of t and q.
template <int G>
__global__ void __launch_bounds__(K2_THREADS)
dq_greedy_kernel(const K1Job job, const int* __restrict__ lam,
                 const float* __restrict__ lv,
                 const int16_t* __restrict__ order_all) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int log2_n = job.log2_n, lg2P = 2 * log2_n;
  const int P = 1 << lg2P;
  const int NB = k2_blocks(G, P), stride = k2_stride(P);
  uint32_t* rec = reinterpret_cast<uint32_t*>(smem);  // record, then state
  int* aux = reinterpret_cast<int*>(rec + NB * stride);  // base, then rate
  int* s_ls = aux + NB * stride;
  int* s_bd = s_ls + NB;
  int16_t* ord = reinterpret_cast<int16_t*>(s_bd + NB);
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * NB;
  const int nb = min(NB, job.B - b0);                 // blocks present
  const int mask_n = (1 << log2_n) - 1;
  const bool tt = job.t_transposed != 0;
  // offset in t of raster index r = y * n + x (an involution)
  auto tix = [=](int r) {
    return tt ? ((r & mask_n) << log2_n) | (r >> log2_n) : r;
  };
  // the walk's order: coding position -> padded record index
  const int16_t* og = order_all + order_offset(log2_n);
  for (int i = tid; i < P; i += K2_THREADS) ord[i] = (int16_t)k2_pad(tix(og[i]));
  for (int i = tid; i < nb; i += K2_THREADS) {
    s_ls[i] = job.ls ? job.ls[job.ls_stride * (b0 + i)] : job.ls_val;
    s_bd[i] = job.bd ? job.bd[job.bd_stride * (b0 + i)] : job.bd_val;
  }
  __syncthreads();

  // records of every position, in t's memory order (coalesced loads)
  const int lam0 = __ldg(lam);
  const int* tb = job.t + (size_t)b0 * P;
  const int n = nb << lg2P;
  for (int f = tid; f < n; f += K2_THREADS) {
    const int bl = f >> lg2P, i = bl * stride + k2_pad(f & (P - 1));
    int base;
    rec[i] = k2_record(__ldg(tb + f), s_ls[bl], s_bd[bl], lam, lam0, &base);
    aux[i] = base;
  }
  __syncthreads();

  // the chain; lanes of absent blocks walk stale words and store nothing
  // outside shared memory (with G = 8 the lanes of a block are 8 lanes of
  // one warp, which alone take part in its shuffles)
  if (tid < NB * G) {
    const int bl = tid / G, d = tid % G;
    uint32_t* rb = rec + bl * stride;
    const int S = P / G, lo = d * S, hi = lo + S;
    int D = 1;                                        // q_state 0, trailing
    if constexpr (G > 1) {
      const uint32_t map = k2_map(rb, ord, lo, hi);
      const int gbase = (tid & 31) & ~(G - 1);
      const unsigned gmask = ((1u << G) - 1u) << gbase;
#pragma unroll
      for (int l = 0; l < G - 1; ++l) {
        const uint32_t ml = __shfl_sync(gmask, map, gbase + l);
        if (l < d) D = (int)((ml >> (4 * D)) & 7u);
      }
    }
    if (S % 8) k2_walk<2>(rb, ord, lo, hi, D);
    else k2_walk<8>(rb, ord, lo, hi, D);
  }
  __syncthreads();

  // levels (int16, raster order, coalesced) and per-position rates
  const float lv0 = __ldg(lv);
  int16_t* qb = job.q + (size_t)b0 * P;
  for (int f = tid; f < n; f += K2_THREADS) {
    const int bl = f >> lg2P;
    const int i = bl * stride + k2_pad(tix(f & (P - 1)));
    const uint32_t w = rec[i];
    const int D = (int)(w & 7u), tr = D & 1, delta = D >> 2;
    const int k = (int)((w >> (4 * (2 * delta + tr) + 3)) & 1u);
    const int a = level_cand(aux[i], delta, k, (w >> 23) & 1u);
    const int mag = a == 0 ? 0 : 2 * a - delta;
    qb[f] = (int16_t)(((w >> 19) & 1u) ? -mag : mag);
    const float r = a == 0 ? (tr ? 0.0f : lv0) : __ldg(lv + clip1023(a));
    aux[i] = __float_as_int(r);
  }
  __syncthreads();

  // the rate, summed in ASCENDING coding order (the reference's f32
  // accumulation order), one lane per block
  for (int bl = tid; bl < nb; bl += K2_THREADS) {
    const int* ab = aux + bl * stride;
    float r_sum = 0.0f;
#pragma unroll 8
    for (int p = 0; p < P; ++p) r_sum = r_sum + __int_as_float(ab[ord[p]]);
    job.rate[b0 + bl] = r_sum;
  }
}

}  // namespace

extern "C" {

// K2's blocks per CTA and dynamic shared memory per CTA, for lanes lanes
// per block (1 or 8) and blocks of 2^log2_n x 2^log2_n.
int dq_greedy_blocks_per_cta(int lanes, int log2_n) {
  const int P = 1 << (2 * log2_n);
  return lanes == 8 ? k2_blocks(8, P) : k2_blocks(1, P);
}
int dq_greedy_smem_bytes(int lanes, int log2_n) {
  const int P = 1 << (2 * log2_n);
  return lanes == 8 ? k2_smem_bytes(8, P) : k2_smem_bytes(1, P);
}

// One launch of K2 over desc.job[0] (desc.n_jobs is 1, or 0 for no
// blocks), with desc.lanes (1 or 8) lanes per block in the chain; the
// grid is ceil(B / blocks per CTA). At most 34.8 KB of dynamic shared
// memory per CTA, below the 48 KB that needs no opt-in. Returns the
// first CUDA error (0 = launched).
int dq_greedy_launch(K1Desc desc, const int* lam_dq, const float* lv,
                     const int16_t* order, void* stream) {
  const K1Job& job = desc.job[0];
  if (desc.n_jobs != 1 || job.B <= 0) return 0;
  const int nb = dq_greedy_blocks_per_cta(desc.lanes, job.log2_n);
  const int grid = (job.B + nb - 1) / nb;
  const int smem = dq_greedy_smem_bytes(desc.lanes, job.log2_n);
  cudaStream_t st = (cudaStream_t)stream;
  if (desc.lanes == 8) {
    dq_greedy_kernel<8><<<grid, K2_THREADS, smem, st>>>(job, lam_dq, lv,
                                                         order);
  } else if (desc.lanes == 1) {
    dq_greedy_kernel<1><<<grid, K2_THREADS, smem, st>>>(job, lam_dq, lv,
                                                         order);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The layout check for the ctypes mirror of K1Desc.
int dq_trellis_desc_size() { return (int)sizeof(K1Desc); }

// The dynamic shared memory one K1 launch requests per CTA, for lanes
// lanes per block and a largest block size of 2^log2_n x 2^log2_n.
int dq_trellis_smem_bytes(int lanes, int log2_n) {
  const int P = 1 << (2 * log2_n);
  return lanes == 8 ? k1_smem_bytes(8, P) : k1_smem_bytes(1, P);
}

// One launch of K1 over every job of desc, with desc.lanes (8 or 1) lanes
// per block of coefficients (the packer picks them, orders the jobs by
// block size, largest first, and gives each ceil(B / (32 / lanes))
// one-warp CTAs). The dynamic shared memory is sized for the largest
// block size: at most 22.6 KB with 8 lanes and 2.1 KB with 1 lane at
// 4 x 4, below the 48 KB that needs no opt-in. Returns the first CUDA
// error (0 = launched).
int dq_trellis_launch(K1Desc desc, const int* lam_dq, const float* lv,
                      const int16_t* order, void* stream) {
  if (desc.n_ctas <= 0) return 0;
  const int smem = dq_trellis_smem_bytes(desc.lanes, desc.max_log2_n);
  cudaStream_t st = (cudaStream_t)stream;
  if (desc.lanes == 8) {
    dq_trellis_kernel<8><<<desc.n_ctas, 32, smem, st>>>(desc, lam_dq, lv,
                                                        order);
  } else if (desc.lanes == 1) {
    dq_trellis_kernel<1><<<desc.n_ctas, 32, smem, st>>>(desc, lam_dq, lv,
                                                        order);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
