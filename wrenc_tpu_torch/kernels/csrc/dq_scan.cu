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
//                RD level rate. One thread per block; coefficients arrive
//                in coding order, position-major (P, B), and it writes q
//                (P, B) int32 that the wrapper permutes back to raster.
//
// Bound: both are sequential scans over the P coding-order positions. The
// DRAM traffic is one read of the coefficients and one write of the
// levels; the work is a fixed number of 32-bit integer operations per
// position. At the small batches of the commit scan (tens of blocks) and
// at s = 32 in stage A (4,752 blocks, ~1 warp per SM with one thread per
// block) the dependent chain of P steps sets the time, not the bound.
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
// Q_STATE_TRANS[q][parity] in closed form
__device__ __forceinline__ int trans_next(int q, int parity) {
  return ((q ^ parity) & 1) * 2 + (q >> 1);
}

__device__ __forceinline__ void load_tables(const int* lam_dq, const float* lv,
                                            int* s_lam, float* s_lv) {
  for (int i = threadIdx.x; i < TAB; i += blockDim.x) {
    s_lam[i] = lam_dq[i];
    s_lv[i] = lv[i];
  }
  __syncthreads();
}

// level candidate a for (delta, k) at a coefficient: the quantizer's
// a0 = (s // ls + delta) // 2, plus k; zero coefficients have only a = 0
__device__ __forceinline__ int level_cand(int base, int delta, int k,
                                          bool zero) {
  return zero ? 0 : floordiv(base + delta, 2) + k;
}

__global__ void dq_greedy_kernel(const int* __restrict__ tf, int P, int B,
                                 const int* __restrict__ ls_p,
                                 const int* __restrict__ bd_p, int per_block,
                                 const int* __restrict__ lam_dq,
                                 const float* __restrict__ lv,
                                 int* __restrict__ q, float* __restrict__ rate) {
  __shared__ int s_lam[TAB];
  __shared__ float s_lv[TAB];
  load_tables(lam_dq, lv, s_lam, s_lv);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int ls = ls_p[per_block ? b : 0];
  const int bd = bd_p[per_block ? b : 0];
  const int bdo = (1 << bd) >> 1;
  int q_state = 0;
  bool trailing = true;
  float r_sum = 0.0f;
  for (int p = 0; p < P; ++p) {
    const int tc = tf[(size_t)p * B + b];
    const int delta = q_state > 1 ? 1 : 0;
    const bool neg = tc < 0;
    const int atc = tc < 0 ? -tc : tc;
    int a = 0;
    if (tc != 0) {
      const int s = wadd(wshl(atc, bd), neg ? bdo : -bdo);
      const int a0 = floordiv(floordiv(s, ls) + delta, 2);
      int cst[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int ak = a0 + k;
        const int mag = ak == 0 ? 0 : 2 * ak - delta;
        const int dq = wadd(wmul(mag, ls), bdo) >> bd;
        const int d = atc - dq;
        const int dist = d < 0 ? -d : d;
        const int bits = (ak == 0 && trailing) ? 0 : ak + 1;
        cst[k] = wadd(wmul(128, dist), s_lam[clip1023(bits)]);
      }
      a = cst[1] < cst[0] ? a0 + 1 : a0;       // strict <: ties keep a0
    }
    const int mag = a == 0 ? 0 : 2 * a - delta;
    q[(size_t)p * B + b] = neg ? -mag : mag;
    const float r = a == 0 ? (trailing ? 0.0f : s_lv[0]) : s_lv[clip1023(a)];
    r_sum = r_sum + r;
    trailing = trailing && a == 0;
    q_state = trans_next(q_state, a & 1);
  }
  rate[b] = r_sum;
}

int grid_for(int B, int threads) { return (B + threads - 1) / threads; }

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

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int dq_greedy_launch(const int* tf, int P, int B, const int* ls,
                     const int* bd, int per_block, const int* lam_dq,
                     const float* lv, int* q, float* rate, void* stream) {
  const int threads = 128;
  if (B > 0) {
    dq_greedy_kernel<<<grid_for(B, threads), threads, 0,
                       (cudaStream_t)stream>>>(tf, P, B, ls, bd, per_block,
                                               lam_dq, lv, q, rate);
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
