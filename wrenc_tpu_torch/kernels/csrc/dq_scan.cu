// Dependent-quantization scans for Hopper (sm_90a): one thread per block
// of coefficients, sequential over the P coding-order positions.
//
// K1 dq_trellis  replaces the Pallas kernel wrenc_tpu/kernels/
//                trellis_pallas.py::_kernel (launched by _call): the exact
//                8-state (q_state x trailing) Viterbi with backtrack and
//                the committed-level rate.
// K2 dq_greedy   replaces the lax.scan in wrenc_tpu/kernels/quantize.py::
//                greedy_depquant: greedy two-candidate dep-quant with the
//                RD level rate.
//
// Layout: coefficients arrive in coding order, position-major (P, B), so
// the 32 threads of a warp read 32 neighbouring words at every step.
// Outputs q (P, B) int32 and rate (B,) f32; the wrapper permutes q back to
// raster order. The 1024-entry lam_dq / lv tables sit in shared memory.
//
// Bound: both are latency-bound sequential scans. Their DRAM traffic is
// one read of the coefficients and one write of the levels (plus, for
// K1, P words of backpointers and P rate words per block, which stay in
// L2 at the main-path sizes); their work is a fixed number of 32-bit
// integer operations per position. At s = 32 only B = 4,752 threads
// exist per chunk, ~1 warp per SM, so the dependent chain of P = 1024
// steps sets the time. The design keeps every per-step quantity in
// registers (the 8 state costs, the backpointer nibbles) and computes the
// edge ingredients in the thread instead of streaming them, as the TPU
// version had to.
//
// Arithmetic is int32 with explicit wrap (unsigned casts) and floor
// division where an operand can be negative, matching XLA. The only float
// op is the f32 rate sum, a plain add in ascending position order, which
// FMA contraction cannot touch.
#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void dq_trellis_kernel(const int* __restrict__ tf, int P, int B,
                                  const int* __restrict__ ls_p,
                                  const int* __restrict__ bd_p, int per_block,
                                  const int* __restrict__ lam_dq,
                                  const float* __restrict__ lv,
                                  uint32_t* __restrict__ bp,
                                  float* __restrict__ rbuf,
                                  int* __restrict__ q,
                                  float* __restrict__ rate) {
  __shared__ int s_lam[TAB];
  __shared__ float s_lv[TAB];
  load_tables(lam_dq, lv, s_lam, s_lv);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int ls = ls_p[per_block ? b : 0];
  const int bd = bd_p[per_block ? b : 0];
  const int bdo = (1 << bd) >> 1;
  const int lam1 = s_lam[1];

  int cost[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) cost[s] = s == 1 ? 0 : BIG;

  for (int p = 0; p < P; ++p) {
    const int tc = tf[(size_t)p * B + b];
    const int is_dc = p == P - 1 ? 1 : 0;
    const bool neg = tc < 0;
    const bool zero = tc == 0;
    const int atc = neg ? -tc : tc;
    const int s = wadd(wshl(atc, bd), neg ? bdo : -bdo);
    const int base = floordiv(s, ls);
    // edge ingredients on the compact (delta, k) grid, j = 2*delta + k
    int c4[4], sa4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int delta = j >> 1, k = j & 1;
      const int a = level_cand(base, delta, k, zero);
      const int mag = a == 0 ? 0 : 2 * a - delta;
      const int dq = wadd(wmul(mag, ls), bdo) >> bd;
      const int d = atc - dq;
      const int dist = d < 0 ? -d : d;
      int c = wadd(wmul(128, dist), s_lam[clip1023(a + 1)]);
      c = c < BIG ? c : BIG;
      if (zero && k == 1) c = BIG;              // zeros: a single option
      c4[j] = c;
      sa4[j] = neg ? -a : a;
    }
    int nc[8], slot_of[8];
#pragma unroll
    for (int d = 0; d < 8; ++d) { nc[d] = BIG; slot_of[d] = 0; }
    // relax order: source state OUTER, k INNER, strict < (the native/spec
    // quantizer's tie-breaking)
#pragma unroll
    for (int src = 0; src < 8; ++src) {
      const int qs = src >> 1, tr = src & 1, delta = qs > 1 ? 1 : 0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int j = delta * 2 + k;
        const int sa = sa4[j];
        const int az = sa == 0 ? 1 : 0;
        int c = c4[j];
        int dst = trans_next(qs, sa & 1) * 2;
        if (tr) {
          // trailing zeros are free; the DC position refunds lam_dq[1]
          // once more (all-zero-block correction)
          c = wadd(wadd(c, -wmul(az, lam1)), -wmul(wmul(az, lam1), is_dc));
          dst += az;
        }
        const int tot = wadd(cost[src], c);
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          if (d == dst && tot < nc[d]) { nc[d] = tot; slot_of[d] = 2 * src + k; }
        }
      }
    }
    int mn = nc[0];
#pragma unroll
    for (int d = 1; d < 8; ++d) mn = nc[d] < mn ? nc[d] : mn;
    uint32_t packed = 0;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      cost[d] = nc[d] - mn;
      packed |= (uint32_t)slot_of[d] << (4 * d);
    }
    bp[(size_t)p * B + b] = packed;
  }

  // first-index argmin over the final states
  int state = 0, best = cost[0];
#pragma unroll
  for (int s = 1; s < 8; ++s) {
    if (cost[s] < best) { best = cost[s]; state = s; }
  }
  const float lv0 = s_lv[0];
  for (int p = P - 1; p >= 0; --p) {
    const size_t at = (size_t)p * B + b;
    const int slot = (bp[at] >> (4 * state)) & 0xF;
    const int src = slot >> 1, k = slot & 1;
    const int delta = src >= 4 ? 1 : 0;
    const int tc = tf[at];
    const bool neg = tc < 0;
    const int atc = neg ? -tc : tc;
    const int s = wadd(wshl(atc, bd), neg ? bdo : -bdo);
    const int a = level_cand(floordiv(s, ls), delta, k, tc == 0);
    const int mag = 2 * a - delta;
    q[at] = a == 0 ? 0 : (neg ? -mag : mag);
    rbuf[at] = a == 0 ? ((src & 1) ? 0.0f : lv0) : s_lv[clip1023(a)];
    state = src;
  }
  // committed-level rate in ASCENDING coding order (the reference's f32
  // accumulation order; the backtrack above runs descending)
  float r_sum = 0.0f;
  for (int p = 0; p < P; ++p) r_sum = r_sum + rbuf[(size_t)p * B + b];
  rate[b] = r_sum;
}

int grid_for(int B, int threads) { return (B + threads - 1) / threads; }

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

int dq_trellis_launch(const int* tf, int P, int B, const int* ls,
                      const int* bd, int per_block, const int* lam_dq,
                      const float* lv, uint32_t* bp, float* rbuf, int* q,
                      float* rate, void* stream) {
  // few, long-running threads at the large sizes: small blocks spread
  // them over more SMs
  const int threads = 64;
  if (B > 0) {
    dq_trellis_kernel<<<grid_for(B, threads), threads, 0,
                        (cudaStream_t)stream>>>(tf, P, B, ls, bd, per_block,
                                                lam_dq, lv, bp, rbuf, q, rate);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
