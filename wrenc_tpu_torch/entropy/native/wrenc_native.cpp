// wrenc-tpu native runtime: batched dependent-quantization trellis and the
// CABAC slice entropy coder.
//
// This is the framework's native component — the TPU-native counterpart of
// the reference encoder's hot sequential code (bool_coder.rs /
// cabac_contexts.rs / ctu_encoder.rs residual+syntax path, quantizer.rs
// search_dq). The TPU produces decision tensors (modes, coefficients); this
// library turns them into CABAC bits at native speed. Exposed via a C ABI
// consumed with ctypes (no pybind11 in this image).
//
// Semantics mirror wrenc_tpu/entropy/{cabac,syntax}.py exactly (which are
// golden-tested against round-trip decode); the Python implementations stay
// as the readable reference and fallback.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

// ---------------------------------------------------------------- scans
struct ScanTables {
  // diag scan per log2 size (square), DC-first: (x,y) pairs
  std::vector<int> scan_x[6], scan_y[6];
  ScanTables() {
    for (int lg = 0; lg <= 5; ++lg) {
      int n = 1 << lg;
      int sb = std::min(lg, 2);  // 4x4 sub-blocks (whole block when smaller)
      int nsb = 1 << (lg - sb);
      // sub-block diag order
      auto diag = [](int w, int h, std::vector<int>& xs, std::vector<int>& ys) {
        for (int d = 0; d < w + h - 1; ++d)
          for (int y = std::min(d, h - 1); y >= 0; --y) {
            int x = d - y;
            if (x < w) { xs.push_back(x); ys.push_back(y); }
          }
      };
      std::vector<int> sbx, sby, cx, cy;
      diag(nsb, nsb, sbx, sby);
      diag(1 << sb, 1 << sb, cx, cy);
      for (size_t s = 0; s < sbx.size(); ++s)
        for (size_t c = 0; c < cx.size(); ++c) {
          scan_x[lg].push_back((sbx[s] << sb) + cx[c]);
          scan_y[lg].push_back((sby[s] << sb) + cy[c]);
        }
    }
  }
};
const ScanTables g_scan;

const int kQStateTrans[4][2] = {{0, 2}, {2, 0}, {1, 3}, {3, 1}};

}  // namespace

// ------------------------------------------------------------------ trellis
// Batched exact 8-state (q_state x trailing) Viterbi dependent quantizer.
// t: B x n x n int32 (row major); lam_dq: 1024 int32; q_out: B x n x n int16.
extern "C" void wrenc_trellis_quant(const int32_t* t, int B, int log2n,
                                    int32_t ls, int32_t bd_shift,
                                    const int32_t* lam_dq, int16_t* q_out) {
  const int n = 1 << log2n;
  const int P = n * n;
  const int64_t bd_offset = (int64_t{1} << bd_shift) >> 1;
  const auto& sx = g_scan.scan_x[log2n];
  const auto& sy = g_scan.scan_y[log2n];
  const int64_t BIG = int64_t{1} << 60;

  std::vector<int8_t> bp_prev(P * 8);
  std::vector<int32_t> bp_mag(P * 8);

  for (int b = 0; b < B; ++b) {
    const int32_t* tb = t + (size_t)b * P;
    int16_t* qb = q_out + (size_t)b * P;
    int64_t cost[8], ncost[8];
    for (int s = 0; s < 8; ++s) cost[s] = BIG;
    cost[1] = 0;  // q_state 0, trailing

    for (int p = 0; p < P; ++p) {
      // coding order: reverse scan
      int idx = P - 1 - p;
      int xc = sx[idx], yc = sy[idx];
      int32_t tc = tb[yc * n + xc];
      bool is_dc = (p == P - 1);
      int64_t abs_tc = tc < 0 ? -(int64_t)tc : tc;
      for (int s = 0; s < 8; ++s) ncost[s] = BIG;
      int8_t* bpp = &bp_prev[p * 8];
      int32_t* bpm = &bp_mag[p * 8];

      // The (a, mag, dist, base-cost) candidates depend only on
      // delta = (q_state > 1) and k in {0, 1} — 4 distinct tuples, not
      // 16, and one integer division per position instead of eight.
      int64_t cand_a[2][2], cand_mag[2][2], cand_c[2][2];
      int kmax = tc == 0 ? 1 : 2;
      if (tc == 0) {
        for (int d = 0; d < 2; ++d) {
          cand_a[d][0] = 0; cand_mag[d][0] = 0;
          cand_c[d][0] = 128 * abs_tc;  // dist = |tc - 0|
        }
      } else {
        int64_t s_ =
            (abs_tc << bd_shift) + (tc < 0 ? bd_offset : -bd_offset);
        int64_t q0 = s_ / ls;
        for (int d = 0; d < 2; ++d) {
          int64_t a0 = (q0 + d) / 2;
          for (int k = 0; k < 2; ++k) {
            int64_t a = a0 + k;
            int64_t mag = a == 0 ? 0 : 2 * a - d;
            int64_t dq = (mag * ls + bd_offset) >> bd_shift;
            cand_a[d][k] = a;
            cand_mag[d][k] = mag;
            cand_c[d][k] = 128 * std::abs(abs_tc - dq);
          }
        }
      }

      for (int s = 0; s < 8; ++s) {
        if (cost[s] >= BIG) continue;
        int q_state = s >> 1;
        bool trailing = s & 1;
        int d = q_state > 1 ? 1 : 0;
        for (int k = 0; k < kmax; ++k) {
          int64_t a = cand_a[d][k];
          int64_t bits = (a == 0 && trailing) ? 0 : a + 1;
          if (bits > 1023) bits = 1023;
          int64_t c = cand_c[d][k] + lam_dq[bits];
          if (is_dc && trailing && a == 0) c -= lam_dq[1];
          int nstate = kQStateTrans[q_state][a & 1] * 2 +
                       ((trailing && a == 0) ? 1 : 0);
          int64_t tot = cost[s] + c;
          if (tot < ncost[nstate]) {
            ncost[nstate] = tot;
            bpp[nstate] = (int8_t)s;
            bpm[nstate] = (int32_t)(tc < 0 ? -cand_mag[d][k] : cand_mag[d][k]);
          }
        }
      }
      for (int s = 0; s < 8; ++s) cost[s] = ncost[s];
    }
    // backtrack
    int state = 0;
    int64_t best = cost[0];
    for (int s = 1; s < 8; ++s)
      if (cost[s] < best) { best = cost[s]; state = s; }
    std::memset(qb, 0, sizeof(int16_t) * P);
    for (int p = P - 1; p >= 0; --p) {
      int idx = P - 1 - p;
      int xc = sx[idx], yc = sy[idx];
      qb[yc * n + xc] = (int16_t)bp_mag[p * 8 + state];
      state = bp_prev[p * 8 + state];
    }
  }
}

// Batched greedy dependent quantizer (same candidates, no lookahead).
extern "C" void wrenc_greedy_quant(const int32_t* t, int B, int log2n,
                                   int32_t ls, int32_t bd_shift,
                                   const int32_t* lam_dq, int16_t* q_out) {
  const int n = 1 << log2n;
  const int P = n * n;
  const int64_t bd_offset = (int64_t{1} << bd_shift) >> 1;
  const auto& sx = g_scan.scan_x[log2n];
  const auto& sy = g_scan.scan_y[log2n];
  for (int b = 0; b < B; ++b) {
    const int32_t* tb = t + (size_t)b * P;
    int16_t* qb = q_out + (size_t)b * P;
    int q_state = 0;
    bool trailing = true;
    for (int p = 0; p < P; ++p) {
      int idx = P - 1 - p;
      int xc = sx[idx], yc = sy[idx];
      int32_t tc = tb[yc * n + xc];
      int64_t abs_tc = tc < 0 ? -(int64_t)tc : tc;
      int64_t a, mag;
      if (tc == 0) {
        a = 0; mag = 0;
      } else {
        int64_t delta = q_state > 1 ? 1 : 0;
        int64_t s_ = (abs_tc << bd_shift) + (tc < 0 ? bd_offset : -bd_offset);
        int64_t a0 = (s_ / ls + delta) / 2;
        int64_t bestc = 0; a = a0; mag = 0;
        for (int k = 0; k < 2; ++k) {
          int64_t ak = a0 + k;
          int64_t mg = ak == 0 ? 0 : 2 * ak - delta;
          int64_t dq = (mg * ls + bd_offset) >> bd_shift;
          int64_t dist = std::abs(abs_tc - dq);
          int64_t bits = (ak == 0 && trailing) ? 0 : ak + 1;
          if (bits > 1023) bits = 1023;
          int64_t c = 128 * dist + lam_dq[bits];
          if (k == 0 || c < bestc) { bestc = c; a = ak; mag = mg; }
        }
      }
      qb[yc * n + xc] = (int16_t)(tc < 0 ? -mag : mag);
      trailing = trailing && a == 0;
      q_state = kQStateTrans[q_state][a & 1];
    }
  }
}

// ================================================================== CABAC
namespace {

struct BitSink {
  std::vector<uint8_t>* out;
  uint32_t cur = 0;
  int nbits = 0;
  void bit(int b) {
    cur = (cur << 1) | (b & 1);
    if (++nbits == 8) { out->push_back((uint8_t)cur); cur = 0; nbits = 0; }
  }
  void align(int b = 0) { while (nbits) bit(b); }
};

struct Cabac {
  // context state: two windows per context, per syntax element
  // flat layout from Python (offsets per SE id)
  std::vector<uint16_t> s0, s1;
  std::vector<uint8_t> shift_idx;
  std::vector<int> se_off;  // per SE id -> base index (-1 if none)

  uint32_t range = 510, offset = 0;
  bool first_bit = true;
  int outstanding = 0;
  BitSink* w = nullptr;

  void init_engine() { range = 510; offset = 0; }

  void put(int b) {
    if (!first_bit) w->bit(b);
    first_bit = false;
    while (outstanding > 0) { w->bit(!b); --outstanding; }
  }
  void put_trailing(int b) {
    w->bit(b);
    while (outstanding > 0) { w->bit(!b); --outstanding; }
  }
  void renorm() {
    while (range < 256) {
      if (offset < 256) put(0);
      else if (offset >= 512) { offset -= 512; put(1); }
      else { offset -= 256; ++outstanding; }
      range <<= 1; offset <<= 1;
    }
  }
  void bin(int se, int inc, int b) {
    int i = se_off[se] + inc;
    uint32_t p_state = s1[i] + 16u * s0[i];
    int val_mps = p_state >> 14;
    uint32_t q = range >> 5;
    uint32_t lps = ((q * ((val_mps == 0 ? p_state : 32767 - p_state) >> 9)) >> 1) + 4;
    if (b == val_mps) range -= lps;
    else { offset += range - lps; range = lps; }
    renorm();
    int sh = shift_idx[i];
    int sh0 = (sh >> 2) + 2, sh1 = (sh & 3) + 3 + sh0;
    s0[i] = (uint16_t)(s0[i] - (s0[i] >> sh0) + ((1023 * b) >> sh0));
    s1[i] = (uint16_t)(s1[i] - (s1[i] >> sh1) + ((16383 * b) >> sh1));
  }
  void bypass(int b) {
    offset <<= 1;
    if (b) offset += range;
    if (offset >= 1024) { put(1); offset -= 1024; }
    else if (offset < 512) put(0);
    else { offset -= 512; ++outstanding; }
  }
  void terminate(int b) {
    range -= 2;
    if (b) {
      offset += range;
      range = 2;
      renorm();
      put((offset >> 9) & 1);
      uint32_t two = ((offset >> 7) & 3) | 1;
      put_trailing((two >> 1) & 1);
      put_trailing(two & 1);
      first_bit = true;
      outstanding = 0;
    } else {
      renorm();
    }
  }
};

// ----------------------------------------------------------- syntax state
// SE ids (match core.tables.SE / the reference CabacContext enum)
enum {
  SE_SplitCuFlag = 16, SE_IntraLumaMpmFlag = 34, SE_IntraLumaNotPlanarFlag = 35,
  SE_CclmModeFlag = 40, SE_CclmModeIdx = 41, SE_IntraChromaPredMode = 42,
  SE_MtsIdx = 67,
  SE_TuYCodedFlag = 87, SE_TuCbCodedFlag = 88, SE_TuCrCodedFlag = 89,
  SE_CuQpDeltaAbs = 90, SE_TransformSkipFlag = 94,
  SE_LastSigCoeffXPrefix = 96, SE_LastSigCoeffYPrefix = 97,
  SE_SbCodedFlag = 100, SE_SigCoeffFlag = 101, SE_ParLevelFlag = 102,
  SE_AbsLevelGtxFlag = 103,
};

const int kRiceParams[32] = {0,0,0,0,0,0,0,1,1,1,1,1,1,1,2,2,
                             2,2,2,2,2,2,2,2,2,2,2,2,3,3,3,3};

struct CuRec {
  int32_t x, y, log2, tree;  // tree: 0=S 1=L 2=C
  int32_t luma_mode, chroma_mode;
  int64_t coeff_off[3];      // offsets into coeff buffer, -1 if absent
};

struct SliceCoder {
  Cabac c;
  int W = 0, H = 0, log2_ctu = 5, qp = 32;
  bool dep_quant = true, transform_skip_enabled = true, cclm_enabled = true;
  bool explicit_mts_intra = true;
  // maps at 4x4 granularity
  std::vector<int32_t> mode_map;
  std::vector<uint8_t> mode_set;
  std::vector<int16_t> cbw_map, cbh_map;
  bool cu_qp_delta_coded = false;
  // MtsDcOnly / MtsZeroOutSigCoeffFlag, reset per CU (ctu_encoder.rs:1219)
  bool mts_dc_only = true, mts_zero_out = true;
  // per-TB scratch
  int32_t pass1[32 * 32];
  int32_t abs_lv[32 * 32];
  int q_state = 0;
  const int16_t* coeffs = nullptr;

  int n4w() const { return W >> 2; }

  // morton-based availability (matches spec/avail.py)
  static uint64_t morton(int x, int y) {
    uint64_t z = 0;
    for (int b = 0; b < 16; ++b) {
      z |= (uint64_t)((x >> b) & 1) << (2 * b);
      z |= (uint64_t)((y >> b) & 1) << (2 * b + 1);
    }
    return z;
  }
  bool avail(int cx, int cy, int nx, int ny) const {
    if (nx < 0 || ny < 0 || nx >= W || ny >= H) return false;
    int ccx = cx >> log2_ctu, ccy = cy >> log2_ctu;
    int ncx = nx >> log2_ctu, ncy = ny >> log2_ctu;
    if (ncy > ccy) return false;
    if (ncy < ccy) return true;
    if (ncx > ccx) return false;
    if (ncx < ccx) return true;
    int m = (1 << log2_ctu) - 1;
    return morton(nx & m, ny & m) < morton(cx & m, cy & m);
  }

  // ---------------- MPM (ctu.rs:1530 / syntax.py derive_mpm_list)
  void mpm_list(int x, int y, int size, int out[5]) const {
    int l = 0, a = 0;
    int lx = x - 1, ly = y + size - 1;
    if (x > 0 && mode_set[(ly >> 2) * n4w() + (lx >> 2)])
      l = mode_map[(ly >> 2) * n4w() + (lx >> 2)];
    int ax = x + size - 1, ay = y - 1;
    int ctu_top = (y >> log2_ctu) << log2_ctu;
    if (y > 0 && y - 1 >= ctu_top && mode_set[(ay >> 2) * n4w() + (ax >> 2)])
      a = mode_map[(ay >> 2) * n4w() + (ax >> 2)];
    auto fill = [&](int m0, int m1, int m2, int m3, int m4) {
      out[0]=m0; out[1]=m1; out[2]=m2; out[3]=m3; out[4]=m4; };
    if (l == a && l > 1) {
      fill(l, 2+(l+61)%64, 2+(l-1)%64, 2+(l+60)%64, 2+l%64);
    } else if (l != a && (l > 1 || a > 1)) {
      int mn = std::min(l, a), mx = std::max(l, a);
      if (mn > 1) {
        int d = mx - mn;
        if (d == 1) fill(l, a, 2+(mn+61)%64, 2+(mx-1)%64, 2+(mn+60)%64);
        else if (d >= 62) fill(l, a, 2+(mn-1)%64, 2+(mx+61)%64, 2+mn%64);
        else if (d == 2) fill(l, a, 2+(mn-1)%64, 2+(mn+61)%64, 2+(mx-1)%64);
        else fill(l, a, 2+(mn+61)%64, 2+(mn-1)%64, 2+(mx+61)%64);
      } else {
        fill(mx, 2+(mx+61)%64, 2+(mx-1)%64, 2+(mx+60)%64, 2+mx%64);
      }
    } else {
      fill(1, 50, 18, 46, 54);
    }
  }

  // ---------------- coding tree / CU syntax
  void code_luma_mode(const CuRec& cu) {
    int size = 1 << cu.log2;
    int cand[5];
    mpm_list(cu.x, cu.y, size, cand);
    int mode = cu.luma_mode;
    if (mode == 0) {
      c.bin(SE_IntraLumaMpmFlag, 0, 1);
      c.bin(SE_IntraLumaNotPlanarFlag, 1, 0);
    } else {
      int idx = -1;
      for (int i = 0; i < 5; ++i) if (cand[i] == mode) { idx = i; break; }
      if (idx >= 0) {
        c.bin(SE_IntraLumaMpmFlag, 0, 1);
        c.bin(SE_IntraLumaNotPlanarFlag, 1, 1);
        for (int i = 0; i < idx; ++i) c.bypass(1);
        if (idx < 4) c.bypass(0);
      } else {
        c.bin(SE_IntraLumaMpmFlag, 0, 0);
        int s[5]; std::memcpy(s, cand, sizeof(s));
        std::sort(s, s + 5);
        int rem;
        if (mode > s[4]) rem = mode - 6;
        else if (mode > s[3]) rem = mode - 5;
        else if (mode > s[2]) rem = mode - 4;
        else if (mode > s[1]) rem = mode - 3;
        else if (mode > s[0]) rem = mode - 2;
        else rem = mode - 1;
        // TB(60): n=61, k=5, u=3
        const int k = 5, u = 3;
        if (rem < u) { for (int i = k - 1; i >= 0; --i) c.bypass((rem >> i) & 1); }
        else { int v = rem + u; for (int i = k; i >= 0; --i) c.bypass((v >> i) & 1); }
      }
    }
  }

  void code_chroma_mode(const CuRec& cu, int derived_luma) {
    if (cclm_enabled) {
      int is_cclm = cu.chroma_mode >= 81;
      c.bin(SE_CclmModeFlag, 0, is_cclm);
      if (is_cclm) {
        int idx = cu.chroma_mode - 81;
        c.bin(SE_CclmModeIdx, 0, idx > 0);
        if (idx > 0) c.bypass(idx - 1);
        return;
      }
    }
    // only the derived mode (idx 4) is produced by the search
    if (cu.chroma_mode == derived_luma) {
      c.bin(SE_IntraChromaPredMode, 0, 0);
    } else {
      // Table 20 index
      int idx = -1;
      const int base[4] = {0, 50, 18, 1};
      for (int i = 0; i < 4; ++i) {
        int m = (derived_luma == base[i]) ? 66 : base[i];
        if (m == cu.chroma_mode) { idx = i; break; }
      }
      c.bin(SE_IntraChromaPredMode, 0, 1);
      c.bypass((idx >> 1) & 1);
      c.bypass(idx & 1);
    }
  }

  // ---------------- residual (syntax.py _code_residual; non-TS, I-slice)
  void code_residual(const int16_t* q, int log2n, int c_idx) {
    int n = 1 << log2n;
    int P = n * n;
    std::memset(pass1, 0, sizeof(int32_t) * P);
    std::memset(abs_lv, 0, sizeof(int32_t) * P);
    const auto& sx = g_scan.scan_x[log2n];
    const auto& sy = g_scan.scan_y[log2n];

    // last significant position
    int last_idx = -1;
    for (int i = 0; i < P; ++i)
      if (q[sy[i] * n + sx[i]] != 0) last_idx = i;
    int last_x = sx[last_idx], last_y = sy[last_idx];

    code_last_prefix_suffix(SE_LastSigCoeffXPrefix, c_idx, log2n, last_x);
    code_last_prefix_suffix(SE_LastSigCoeffYPrefix, c_idx, log2n, last_y);

    int num_sb_coeff = std::min(P, 16);
    int sb_sz = num_sb_coeff == 16 ? 4 : n;        // sub-block dimension
    int log2_sb = sb_sz == 4 ? 2 : log2n;
    int nsb_dim = n / sb_sz;
    int last_sb = last_idx / num_sb_coeff;
    int last_scan_pos = last_idx % num_sb_coeff;

    // MtsDcOnly cleared when luma last-sig is not DC (ctu_encoder.rs:1955)
    if (c_idx == 0 && last_idx > 0) mts_dc_only = false;

    int rem_bins = (P * 7) >> 2;
    q_state = 0;
    std::vector<uint8_t> sb_coded_map(nsb_dim * nsb_dim, 0);

    for (int i = last_sb; i >= 0; --i) {
      // sub-block origin (from the full scan: first coeff of sb i)
      int x0 = sx[i * num_sb_coeff] & ~(sb_sz - 1);
      int y0 = sy[i * num_sb_coeff] & ~(sb_sz - 1);
      int sxs = x0 / sb_sz, sys = y0 / sb_sz;
      int start_q_state = q_state;

      int64_t sb_abs[16];
      int qs = q_state;
      for (int p = num_sb_coeff - 1; p >= 0; --p) {
        int gi = i * num_sb_coeff + p;
        int qv = std::abs((int)q[sy[gi] * n + sx[gi]]);
        if (dep_quant) {
          sb_abs[p] = (qv + (qs > 1 ? 1 : 0)) / 2;
          qs = kQStateTrans[qs][sb_abs[p] & 1];
        } else {
          sb_abs[p] = qv;
        }
      }
      bool sb_nonzero = false;
      for (int p = 0; p < num_sb_coeff; ++p) sb_nonzero |= sb_abs[p] != 0;
      bool sb_coded = sb_nonzero || (sxs == 0 && sys == 0);

      bool infer_dc = false;
      if (i < last_sb && i > 0) {
        int csbf = 0;
        if (sxs < nsb_dim - 1) csbf += sb_coded_map[sys * nsb_dim + sxs + 1];
        if (sys < nsb_dim - 1) csbf += sb_coded_map[(sys + 1) * nsb_dim + sxs];
        csbf = std::min(csbf, 1);
        int inc = c_idx == 0 ? csbf : 2 + csbf;
        c.bin(SE_SbCodedFlag, inc, sb_coded ? 1 : 0);
        infer_dc = true;
      } else {
        sb_coded = true;
      }
      sb_coded_map[sys * nsb_dim + sxs] = sb_coded;
      // MtsZeroOutSigCoeffFlag: coded luma sub-block outside the top-left
      // 16x16 region clears it (ctu_encoder.rs:2009-2011)
      if (sb_coded && (sxs > 3 || sys > 3) && c_idx == 0) mts_zero_out = false;

      int first_pos_mode0 = (i == last_sb) ? last_scan_pos : num_sb_coeff - 1;
      int first_pos_mode1 = first_pos_mode0;
      for (int p = first_pos_mode0; p >= 0; --p) {
        if (rem_bins < 4) break;
        int gi = i * num_sb_coeff + p;
        int xc = sx[gi], yc = sy[gi];
        bool is_last = (xc == last_x && yc == last_y);
        bool in_sb_dc = (xc % sb_sz == 0) && (yc % sb_sz == 0);
        int sig = (sb_abs[p] != 0 || is_last ||
                   (in_sb_dc && infer_dc && sb_coded)) ? 1 : 0;
        bool emitted = sb_coded && (p > 0 || !infer_dc) && !is_last;
        if (emitted) {
          c.bin(SE_SigCoeffFlag, sig_ctx(xc, yc, c_idx, log2n), sig);
          --rem_bins;
          if (sig) infer_dc = false;
        }
        int gt0 = 0, par = 0, gt1 = 0;
        int64_t a = sb_abs[p];
        if (sig) {
          gt0 = a > 1;
          gt1 = a > 3;
          par = (a > 1 && (a & 1)) ? 1 : 0;
          c.bin(SE_AbsLevelGtxFlag, gtx_ctx(xc, yc, c_idx, log2n, 0, last_x, last_y), gt0);
          --rem_bins;
          if (gt0) {
            c.bin(SE_ParLevelFlag, gtx_ctx(xc, yc, c_idx, log2n, -1, last_x, last_y), par);
            c.bin(SE_AbsLevelGtxFlag, gtx_ctx(xc, yc, c_idx, log2n, 1, last_x, last_y), gt1);
            rem_bins -= 2;
          }
        }
        int p1 = sig + par + gt0 + 2 * gt1;
        pass1[yc * n + xc] = p1;
        if (dep_quant) q_state = kQStateTrans[q_state][p1 & 1];
        first_pos_mode1 = p - 1;
      }
      // pass 2: abs_remainder
      for (int p = first_pos_mode0; p > first_pos_mode1; --p) {
        int gi = i * num_sb_coeff + p;
        int xc = sx[gi], yc = sy[gi];
        int p1 = pass1[yc * n + xc];
        int64_t rem = 0;
        if (p1 >= 4) {
          rem = (sb_abs[p] - p1) / 2;
          int rice = rice_param(xc, yc, log2n, 4);
          code_rice_escape(rice, rem);
        }
        abs_lv[yc * n + xc] = (int32_t)(p1 + 2 * rem);
      }
      // pass 3: dec_abs_level
      for (int p = first_pos_mode1; p >= 0; --p) {
        int gi = i * num_sb_coeff + p;
        int xc = sx[gi], yc = sy[gi];
        if (sb_coded) {
          int rice = rice_param(xc, yc, log2n, 0);
          int64_t zero_pos = (int64_t)(dep_quant ? (q_state < 2 ? 1 : 2) : 1)
                             << rice;
          int64_t v = sb_abs[p];
          int64_t dec = v == 0 ? zero_pos : (zero_pos >= v ? v - 1 : v);
          code_rice_escape(rice, dec);
        }
        abs_lv[yc * n + xc] = (int32_t)sb_abs[p];
        if (dep_quant) q_state = kQStateTrans[q_state][sb_abs[p] & 1];
      }
      // signs
      for (int p = num_sb_coeff - 1; p >= 0; --p) {
        int gi = i * num_sb_coeff + p;
        int xc = sx[gi], yc = sy[gi];
        if (sb_abs[p] > 0) c.bypass(q[yc * n + xc] < 0 ? 1 : 0);
      }
      (void)start_q_state;
    }
  }

  int local_template(int xc, int yc, int log2n, const int32_t* m, bool cap1) const {
    int n = 1 << log2n;
    int s = 0;
    auto val = [&](int x, int y) {
      int v = m[y * n + x];
      return cap1 ? std::min(v, 1) : v;
    };
    if (xc < n - 1) {
      s += val(xc + 1, yc);
      if (xc < n - 2) s += val(xc + 2, yc);
      if (yc < n - 1) s += val(xc + 1, yc + 1);
    }
    if (yc < n - 1) {
      s += val(xc, yc + 1);
      if (yc < n - 2) s += val(xc, yc + 2);
    }
    return s;
  }

  int sig_ctx(int xc, int yc, int c_idx, int log2n) const {
    int sum_p1 = local_template(xc, yc, log2n, pass1, false);
    int d = xc + yc;
    int qs = dep_quant ? std::max(q_state - 1, 0) : 0;
    if (c_idx == 0)
      return 12 * qs + std::min((sum_p1 + 1) >> 1, 3) +
             (d < 2 ? 8 : d < 5 ? 4 : 0);
    return 36 + 8 * qs + std::min((sum_p1 + 1) >> 1, 3) + (d < 2 ? 4 : 0);
  }

  // j = -1 for par_level_flag
  int gtx_ctx(int xc, int yc, int c_idx, int log2n, int j, int lx, int ly) const {
    int sum_p1 = local_template(xc, yc, log2n, pass1, false);
    int num_sig = local_template(xc, yc, log2n, pass1, true);
    int off = std::min(sum_p1 - num_sig, 4);
    int d = xc + yc;
    int inc;
    if (xc == lx && yc == ly) inc = c_idx == 0 ? 0 : 21;
    else if (c_idx == 0)
      inc = 1 + off + (d == 0 ? 15 : d < 3 ? 10 : d < 10 ? 5 : 0);
    else
      inc = 22 + off + (d == 0 ? 5 : 0);
    if (j == 1) inc += 32;
    return inc;
  }

  int rice_param(int xc, int yc, int log2n, int base) const {
    int s = local_template(xc, yc, log2n, abs_lv, false);
    s = std::min(std::max(s - base * 5, 0), 31);
    return kRiceParams[s];
  }

  void code_rice_escape(int rice, int64_t value) {
    int64_t c_max = int64_t{6} << rice;
    int64_t prefix_val = std::min(value, c_max);
    int prefix = (int)(prefix_val >> rice);
    int max_prefix = 6;
    if (prefix < max_prefix) {
      for (int i = 0; i < prefix; ++i) c.bypass(1);
      c.bypass(0);
      for (int i = rice - 1; i >= 0; --i)
        c.bypass((int)((prefix_val >> i) & 1));
    } else {
      for (int i = 0; i < max_prefix; ++i) c.bypass(1);
      // limited EG(rice+1), max_pre 11, trunc 15
      int64_t v = value - c_max;
      int k = rice + 1;
      int64_t code_value = v >> k;
      int pre = 0;
      while (pre < 11 && code_value > (int64_t{2} << pre) - 2) { ++pre; c.bypass(1); }
      int esc;
      if (pre == 11) esc = 15;
      else { c.bypass(0); esc = pre + k; }
      int64_t rem = v - (((int64_t{1} << pre) - 1) << k);
      for (int i = esc - 1; i >= 0; --i) c.bypass((int)((rem >> i) & 1));
    }
  }

  void code_last_prefix_suffix(int se, int c_idx, int log2n, int value) {
    int c_max = (std::min(log2n, 5) << 1) - 1;
    int prefix, suffix = 0, suffix_bits = 0;
    if (value <= 3) prefix = value;
    else {
      suffix_bits = 1;
      while ((value >> suffix_bits) >= 4) ++suffix_bits;
      suffix = value - ((value >> suffix_bits) << suffix_bits);
      prefix = ((suffix_bits + 1) << 1) + ((value >> suffix_bits) & 1);
    }
    static const int OFFSET_Y[6] = {0, 0, 3, 6, 10, 15};
    auto ctx = [&](int b) {
      int off, shift;
      if (c_idx == 0) { off = OFFSET_Y[log2n - 1]; shift = (log2n + 1) >> 2; }
      else { off = 20; shift = std::min(std::max((1 << log2n) >> 3, 0), 2); }
      return (b >> shift) + off;
    };
    for (int b = 0; b < std::min(prefix, c_max); ++b) c.bin(se, ctx(b), 1);
    if (prefix < c_max) c.bin(se, ctx(prefix), 0);
    if (prefix > 3) {
      int nb = (prefix >> 1) - 1;
      for (int i = nb - 1; i >= 0; --i) c.bypass((suffix >> i) & 1);
    }
  }

  // ---------------- transform unit
  void code_tu(const CuRec& cu) {
    bool luma_active = cu.tree != 2;
    bool chroma_active = cu.tree != 1;
    mts_dc_only = true;
    mts_zero_out = true;
    const int16_t* qy = cu.coeff_off[0] >= 0 ? coeffs + cu.coeff_off[0] : nullptr;
    const int16_t* qcb = cu.coeff_off[1] >= 0 ? coeffs + cu.coeff_off[1] : nullptr;
    const int16_t* qcr = cu.coeff_off[2] >= 0 ? coeffs + cu.coeff_off[2] : nullptr;
    int nl = 1 << cu.log2, nc = nl >> 1;
    auto nz = [](const int16_t* q, int n) {
      if (!q) return false;
      for (int i = 0; i < n * n; ++i) if (q[i]) return true;
      return false;
    };
    int y_coded = luma_active && nz(qy, nl);
    int cb_coded = chroma_active && nz(qcb, nc);
    int cr_coded = chroma_active && nz(qcr, nc);
    if (chroma_active) {
      c.bin(SE_TuCbCodedFlag, 0, cb_coded);
      c.bin(SE_TuCrCodedFlag, cb_coded ? 1 : 0, cr_coded);
    }
    if (luma_active) c.bin(SE_TuYCodedFlag, 0, y_coded);
    if ((y_coded || cb_coded || cr_coded) && cu.tree != 2 && !cu_qp_delta_coded) {
      c.bin(SE_CuQpDeltaAbs, 0, 0);  // fixed-QP: delta always 0
      cu_qp_delta_coded = true;
    }
    if (y_coded && cu.tree != 2) {
      if (transform_skip_enabled) c.bin(SE_TransformSkipFlag, 0, 0);
      code_residual(qy, cu.log2, 0);
    }
    if (cb_coded && cu.tree != 1) {
      if (transform_skip_enabled) c.bin(SE_TransformSkipFlag, 1, 0);
      code_residual(qcb, cu.log2 - 1, 1);
    }
    if (cr_coded && cu.tree != 1) {
      if (transform_skip_enabled) c.bin(SE_TransformSkipFlag, 1, 0);
      code_residual(qcr, cu.log2 - 1, 2);
    }
    // CU-level mts_idx (ctu_encoder.rs:1292-1319): single/luma tree,
    // lfnst_idx 0, no TS/ISP/SBT, size <= 32, zero-out set, not DC-only.
    // Search never selects MTS, so the value is always 0 (one '0' bin,
    // TR(4,0) with ctxInc = binIdx).
    if (cu.tree != 2 && explicit_mts_intra && nl <= 32 &&
        mts_zero_out && !mts_dc_only)
      c.bin(SE_MtsIdx, 0, 0);
  }

  void code_cu(const CuRec& cu) {
    int size = 1 << cu.log2;
    if (cu.tree != 2) code_luma_mode(cu);
    if (cu.tree != 1) {
      int derived;
      if (cu.tree == 2) {
        int cxc = cu.x + size / 2, cyc = cu.y + size / 2;
        derived = mode_map[(cyc >> 2) * n4w() + (cxc >> 2)];
      } else derived = cu.luma_mode;
      code_chroma_mode(cu, derived);
    }
    if (cu.tree != 2) {
      int x4 = cu.x >> 2, y4 = cu.y >> 2, nn = std::max(size >> 2, 1);
      for (int yy = 0; yy < nn; ++yy)
        for (int xx = 0; xx < nn; ++xx) {
          mode_map[(y4 + yy) * n4w() + x4 + xx] = cu.luma_mode;
          mode_set[(y4 + yy) * n4w() + x4 + xx] = 1;
        }
    }
    code_tu(cu);
  }

  // coding tree: node stream consumed pre-order; -1 = split, else CU index
  size_t code_tree(const int32_t* nodes, size_t pos, const CuRec* cus,
                   int x, int y, int log2, int tree) {
    int size = 1 << log2;
    bool allow_qt = (tree != 2) && size > 4;
    int32_t tag = nodes[pos++];
    bool split = tag == -1;
    if (allow_qt && y + size <= H) {
      // split_cu_flag ctx
      bool al = avail(x, y, x - 1, y);
      bool aa = avail(x, y, x, y - 1);
      int cond_l = al && cbh_map[(y >> 2) * n4w() + ((x - 1) >> 2)] < size;
      int cond_a = aa && cbw_map[((y - 1) >> 2) * n4w() + (x >> 2)] < size;
      c.bin(SE_SplitCuFlag, cond_l + cond_a, split ? 1 : 0);
    }
    if (split) {
      int half = size >> 1;
      bool scipu = (tree == 0 && size == 8);
      for (int i = 0; i < 4; ++i) {
        int cx = x + (i % 2) * half, cy = y + (i / 2) * half;
        pos = code_tree(nodes, pos, cus, cx, cy, log2 - 1,
                        scipu ? 1 : tree);
      }
      if (scipu) pos = code_tree(nodes, pos, cus, x, y, log2, 2);
    } else {
      const CuRec& cu = cus[tag];
      // record cb size for split ctx of later neighbours
      if (cu.tree != 2) {
        int x4 = x >> 2, y4 = y >> 2, nn = std::max(size >> 2, 1);
        for (int yy = 0; yy < nn; ++yy)
          for (int xx = 0; xx < nn; ++xx) {
            cbw_map[(y4 + yy) * n4w() + x4 + xx] = (int16_t)size;
            cbh_map[(y4 + yy) * n4w() + x4 + xx] = (int16_t)size;
          }
      }
      code_cu(cu);
    }
    return pos;
  }
};

}  // namespace

// ------------------------------------------------------------------ C API
// Encode one slice's CTU data. Returns number of bytes written to out.
//
// ctx_init: flattened context table: n_se ints of offsets (or -1), then
//   total*3 int32: init_value, shift_idx packed by caller as separate arrays.
extern "C" int64_t wrenc_encode_slice(
    // geometry / flags
    int W, int H, int log2_ctu, int qp, int dep_quant, int ts_enabled,
    int cclm_enabled, int explicit_mts_intra,
    // cabac context init data (I-slice): per-SE offsets and flat tables
    const int32_t* se_off, int n_se,
    const int32_t* init_vals, const int32_t* shift_vals, int n_ctx,
    // decisions
    const int32_t* nodes, int64_t n_nodes,
    const int32_t* cu_data, int64_t n_cus,  // 6 ints per CU
    const int64_t* coeff_offs,              // 3 per CU
    const int16_t* coeffs,
    // output buffer (caller-allocated)
    uint8_t* out_buf, int64_t out_cap,
    // WPP (entropy_coding_sync): one CABAC subset per CTU row, context
    // storage after the first CTU of a row + sync at the next row start
    // (slice_encoder.rs:380-411, bool_coder.rs:1096-1104). marks_out
    // (n_rows entries) receives the cumulative byte size after each row.
    int wpp, int64_t* marks_out) {
  SliceCoder sc;
  sc.W = W; sc.H = H; sc.log2_ctu = log2_ctu; sc.qp = qp;
  sc.dep_quant = dep_quant; sc.transform_skip_enabled = ts_enabled;
  sc.cclm_enabled = cclm_enabled;
  sc.explicit_mts_intra = explicit_mts_intra;
  sc.mode_map.assign((W >> 2) * (H >> 2), 0);
  sc.mode_set.assign((W >> 2) * (H >> 2), 0);
  sc.cbw_map.assign((W >> 2) * (H >> 2), 0);
  sc.cbh_map.assign((W >> 2) * (H >> 2), 0);
  sc.coeffs = coeffs;

  // contexts
  sc.c.se_off.assign(se_off, se_off + n_se);
  sc.c.s0.resize(n_ctx);
  sc.c.s1.resize(n_ctx);
  sc.c.shift_idx.resize(n_ctx);
  int qp_c = std::min(std::max(qp, 0), 63);
  for (int i = 0; i < n_ctx; ++i) {
    int init = init_vals[i];
    int slope = (init >> 3) - 4;
    int offs = (init & 7) * 18 + 1;
    int pre = ((slope * (qp_c - 16)) >> 1) + offs;
    pre = std::min(std::max(pre, 1), 127);
    sc.c.s0[i] = (uint16_t)(pre << 3);
    sc.c.s1[i] = (uint16_t)(pre << 7);
    sc.c.shift_idx[i] = (uint8_t)shift_vals[i];
  }
  sc.c.init_engine();

  std::vector<uint8_t> out;
  out.reserve(1 << 16);
  BitSink sink{&out};
  sc.c.w = &sink;

  std::vector<CuRec> cus((size_t)n_cus);
  for (int64_t i = 0; i < n_cus; ++i) {
    const int32_t* d = cu_data + i * 6;
    cus[i] = CuRec{d[0], d[1], d[2], d[3], d[4], d[5],
                   {coeff_offs[i * 3], coeff_offs[i * 3 + 1],
                    coeff_offs[i * 3 + 2]}};
  }

  int cs = 1 << log2_ctu;
  int n_cols = W / cs, n_rows = H / cs;
  int n_ctu = n_cols * n_rows;
  size_t pos = 0;
  int idx = 0;
  std::vector<uint16_t> snap0, snap1;
  for (int r = 0; r < n_rows; ++r) {
    if (wpp && r > 0) {
      sc.c.init_engine();
      sc.c.s0 = snap0;
      sc.c.s1 = snap1;
    }
    for (int col = 0; col < n_cols; ++col) {
      sc.cu_qp_delta_coded = false;
      pos = sc.code_tree(nodes, pos, cus.data(), col * cs, r * cs,
                         log2_ctu, 0);
      if (wpp && col == 0) { snap0 = sc.c.s0; snap1 = sc.c.s1; }
      bool last = idx == n_ctu - 1;
      sc.c.terminate((last || (wpp && col == n_cols - 1)) ? 1 : 0);
      ++idx;
    }
    if (wpp) {
      sink.align(0);
      if (marks_out) marks_out[r] = (int64_t)out.size();
    }
  }
  if (!wpp) sink.align(0);
  if ((int64_t)out.size() > out_cap) return -1;
  std::memcpy(out_buf, out.data(), out.size());
  return (int64_t)out.size();
}

// ============================================================ commit engine
// Native reconstruction/commit pass: walk a frame's CU decisions in coding
// order and run predict -> residual -> forward DCT-II -> dependent-quant ->
// dequant -> inverse -> reconstruct, bit-exact with the Python spec model
// (wrenc_tpu/spec/{intra,transform,quant}.py; behavioural reference
// intra_predictor.rs / transformer.rs / quantizer.rs). This replaces the
// NumPy wavefront commit pass on the host hot path.
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdlib>
#include <mutex>
#include <thread>

namespace {

struct CommitTabs {
  const int32_t* dct[4];        // 4/8/16/32 forward DCT-II (n x n)
  const int32_t* angle;         // 95 entries, index 14+mode
  const int32_t* fc;            // 32x4
  const int32_t* fg;            // 32x4
  const int32_t* pdpc_w;        // 3x64
  const int32_t* cclm_div;      // 16
  const int32_t* ls_tab;        // [2][4] by (min(c,1), log2-2)
  const int32_t* bd_tab;        // [2][4]
  const int32_t* lam_dq;        // 1024
  int dep_quant, trellis;
};

inline int ilog2i(int v) { return 31 - __builtin_clz((unsigned)v); }

struct FrameCommitter {
  int W, H, log2_ctu;
  int32_t* plane[3];            // recon planes (written)
  const int32_t* orig[3];       // original planes
  const CommitTabs* tabs;

  static uint64_t morton(int x, int y) {
    uint64_t z = 0;
    for (int b = 0; b < 16; ++b) {
      z |= (uint64_t)((x >> b) & 1) << (2 * b);
      z |= (uint64_t)((y >> b) & 1) << (2 * b + 1);
    }
    return z;
  }
  bool avail(int cx, int cy, int nx, int ny) const {
    if (nx < 0 || ny < 0 || nx >= W || ny >= H) return false;
    int ccx = cx >> log2_ctu, ccy = cy >> log2_ctu;
    int ncx = nx >> log2_ctu, ncy = ny >> log2_ctu;
    if (ncy != ccy) return ncy < ccy;
    if (ncx != ccx) return ncx < ccx;
    int m = (1 << log2_ctu) - 1;
    return morton(nx & m, ny & m) < morton(cx & m, cy & m);
  }

  // ---- reference samples (spec 8.4.5.2.8; spec/intra.py gather_ref_samples)
  // left: ref_h+1 entries, left[0] = corner; above: ref_w entries.
  void gather_refs(int c, int cx, int cy, int s, int lx, int ly,
                   int32_t* left, int32_t* above) const {
    int shift = c == 0 ? 0 : 1;
    int ref_w = 2 * s, ref_h = 2 * s;
    int pw = W >> shift, ph = H >> shift;
    const int32_t* pl = plane[c];
    for (int k = 0; k <= ref_h; ++k) {
      int ny = cy - 1 + k, nx = cx - 1;
      left[k] = (nx >= 0 && ny >= 0 && ny < ph
                 && avail(lx, ly, nx << shift, ny << shift))
                    ? pl[ny * pw + nx] : -1;
    }
    for (int k = 0; k < ref_w; ++k) {
      int ny = cy - 1, nx = cx + k;
      above[k] = (ny >= 0 && nx < pw
                  && avail(lx, ly, nx << shift, ny << shift))
                     ? pl[ny * pw + nx] : -1;
    }
    bool any = false;
    for (int k = 0; k <= ref_h && !any; ++k) any = left[k] >= 0;
    for (int k = 0; k < ref_w && !any; ++k) any = above[k] >= 0;
    if (!any) {
      for (int k = 0; k <= ref_h; ++k) left[k] = 128;
      for (int k = 0; k < ref_w; ++k) above[k] = 128;
      return;
    }
    if (left[ref_h] < 0) {
      bool found = false;
      for (int i = ref_h - 1; i >= 0; --i)
        if (left[i] >= 0) { left[ref_h] = left[i]; found = true; break; }
      if (!found)
        for (int k = 0; k < ref_w; ++k)
          if (above[k] >= 0) { left[ref_h] = above[k]; break; }
    }
    for (int i = ref_h - 1; i >= 0; --i)
      if (left[i] < 0) left[i] = left[i + 1];
    if (above[0] < 0) above[0] = left[0];
    for (int i = 1; i < ref_w; ++i)
      if (above[i] < 0) above[i] = above[i - 1];
  }

  static bool ref_filter_mode(int m) {
    switch (m) {
      case 0: case -14: case -12: case -10: case -6: case 2: case 34:
      case 66: case 72: case 76: case 78: case 80: return true;
      default: return false;
    }
  }

  // [1 2 1] smoothing (8.4.5.2.10); in place via temporaries
  static void filter_refs(int32_t* left, int32_t* above, int s, int c,
                          int mode) {
    if (!(s * s > 32 && c == 0 && ref_filter_mode(mode))) return;
    int ref_w = 2 * s, ref_h = 2 * s;
    int32_t lf[65], af[64];
    lf[0] = (left[1] + 2 * left[0] + above[0] + 2) >> 2;
    for (int y = 0; y < ref_h - 1; ++y)
      lf[1 + y] = (left[2 + y] + 2 * left[1 + y] + left[y] + 2) >> 2;
    lf[ref_h] = left[ref_h];
    af[0] = (left[0] + 2 * above[0] + above[1] + 2) >> 2;
    for (int x = 0; x < ref_w - 2; ++x)
      af[1 + x] = (above[x] + 2 * above[x + 1] + above[x + 2] + 2) >> 2;
    af[ref_w - 1] = above[ref_w - 1];
    std::memcpy(left, lf, sizeof(int32_t) * (ref_h + 1));
    std::memcpy(above, af, sizeof(int32_t) * ref_w);
  }

  // ---- PDPC (8.4.5.2.15; spec/intra.py _pdpc). l = p[-1][y] (2s), a =
  // p[x][-1] (2s), corner = p[-1][-1].
  void pdpc(int32_t* pred, int mode, int inv_angle, const int32_t* l,
            const int32_t* a, int corner, int s) const {
    int log2s = ilog2i(s);
    int ns;
    if (mode > 50) ns = std::min(2, log2s - ilog2i(3 * inv_angle - 2) + 8);
    else if (mode > 1 && mode < 18)
      ns = std::min(2, log2s - ilog2i(3 * inv_angle - 2) + 8);
    else ns = (2 * log2s - 2) >> 2;
    const int32_t* w = tabs->pdpc_w + ns * 64;
    if (mode < 2) {
      for (int y = 0; y < s; ++y)
        for (int x = 0; x < s; ++x) {
          int64_t wl = w[x], wt = w[y];
          int64_t p = (int64_t)l[y] * wl + (int64_t)a[x] * wt
                      + (64 - wt - wl) * pred[y * s + x] + 32;
          int v = (int)(p >> 6);
          pred[y * s + x] = v < 0 ? 0 : (v > 255 ? 255 : v);
        }
    } else if (mode == 18 || mode == 50) {
      for (int y = 0; y < s; ++y)
        for (int x = 0; x < s; ++x) {
          int64_t pv = pred[y * s + x];
          int64_t rl = l[y] - corner + pv;
          int64_t rt = a[x] - corner + pv;
          int64_t wl = mode == 50 ? w[x] : 0;
          int64_t wt = mode == 18 ? w[y] : 0;
          int64_t p = rl * wl + rt * wt + (64 - wt - wl) * pv + 32;
          int v = (int)(p >> 6);
          pred[y * s + x] = v < 0 ? 0 : (v > 255 ? 255 : v);
        }
    } else if (mode < 18) {
      if (ns < 0) return;
      for (int y = 0; y < s; ++y) {
        int64_t wt = w[y];
        int dx_int = (((y + 1) * inv_angle + 256) >> 9);
        for (int x = 0; x < s; ++x) {
          int64_t rt = 0;
          if (y < (3 << ns)) {
            int dx = x + dx_int;
            rt = a[std::min(dx, 2 * s - 1)];
          }
          int64_t p = rt * wt + (64 - wt) * pred[y * s + x] + 32;
          int v = (int)(p >> 6);
          pred[y * s + x] = v < 0 ? 0 : (v > 255 ? 255 : v);
        }
      }
    } else {  // mode > 50
      if (ns < 0) return;
      for (int x = 0; x < s; ++x) {
        int64_t wl = w[x];
        int dy_int = (((x + 1) * inv_angle + 256) >> 9);
        for (int y = 0; y < s; ++y) {
          int64_t rl = 0;
          if (x < (3 << ns)) {
            int dy = y + dy_int;
            rl = l[std::min(dy, 2 * s - 1)];
          }
          int64_t p = rl * wl + (64 - wl) * pred[y * s + x] + 32;
          int v = (int)(p >> 6);
          pred[y * s + x] = v < 0 ? 0 : (v > 255 ? 255 : v);
        }
      }
    }
  }

  // ---- PLANAR / DC / angular (spec/intra.py predict_*; square blocks only)
  void predict(int c, int mode, const int32_t* left, const int32_t* above,
               int s, int32_t* pred) const {
    const int32_t* l = left + 1;  // p[-1][y]
    const int32_t* a = above;     // p[x][-1]
    int corner = left[0];
    int log2s = ilog2i(s);
    if (mode == 0) {
      for (int y = 0; y < s; ++y)
        for (int x = 0; x < s; ++x) {
          int64_t pv = ((int64_t)(s - 1 - y) * a[x] + (int64_t)(y + 1) * l[s])
                       << log2s;
          int64_t ph = ((int64_t)(s - 1 - x) * l[y] + (int64_t)(x + 1) * a[s])
                       << log2s;
          pred[y * s + x] = (int32_t)((pv + ph + (int64_t)s * s)
                                      >> (2 * log2s + 1));
        }
      if (s >= 4) pdpc(pred, 0, 0, l, a, corner, s);
      return;
    }
    if (mode == 1) {
      int64_t sum = 0;
      for (int x = 0; x < s; ++x) sum += a[x];
      for (int y = 0; y < s; ++y) sum += l[y];
      int dc = (int)((sum + s) >> (log2s + 1));
      for (int i = 0; i < s * s; ++i) pred[i] = dc;
      if (s >= 4) pdpc(pred, 1, 0, l, a, corner, s);
      return;
    }
    // angular; wide-angle map is identity for square blocks
    int angle = tabs->angle[14 + mode];
    int inv_angle = 0;
    if (angle > 0) inv_angle = (512 * 32 + angle / 2) / angle;
    else if (angle < 0) inv_angle = -((512 * 32 + (-angle) / 2) / (-angle));
    bool ffl = false;
    if (c == 0 && !ref_filter_mode(mode)) {
      int n_tb_s = log2s;  // (log2+log2)>>1
      int md = std::min(std::abs(mode - 50), std::abs(mode - 18));
      int thres = n_tb_s == 2 ? 24 : (n_tb_s == 3 ? 14 : (n_tb_s == 4 ? 2 : 0));
      ffl = md > thres;
    }
    const int32_t* filt = ffl ? tabs->fg : tabs->fc;
    int32_t buf[200];
    int32_t* rp = buf + 64;  // negative-index base
    int lo, hi;              // valid index range [lo, hi]
    if (mode >= 34) {
      rp[0] = corner;
      for (int x = 0; x <= s; ++x) rp[1 + x] = a[x];
      hi = s + 1;
      lo = 0;
      if (angle < 0) {
        for (int x = -s; x < 0; ++x) {
          int idx = std::min((x * inv_angle + 256) >> 9, s);
          rp[x] = left[idx];  // corner-inclusive lrs
        }
        lo = -s;
      } else {
        for (int x = s + 2; x < 2 * s; ++x) rp[x] = a[x - 1];
        for (int x = 2 * s; x < 2 * s + 3; ++x) rp[x] = a[2 * s - 1];
        hi = 2 * s + 2;
      }
      for (int y = 0; y < s; ++y) {
        int i_idx = ((y + 1) * angle) >> 5;
        int i_fact = ((y + 1) * angle) & 31;
        for (int x = 0; x < s; ++x) {
          int idx = x + i_idx;
          if (c == 0) {
            const int32_t* f = filt + i_fact * 4;
            int64_t sm = 0;
            for (int i = 0; i < 4; ++i) sm += (int64_t)f[i] * rp[idx + i];
            int v = (int)((sm + 32) >> 6);
            pred[y * s + x] = v < 0 ? 0 : (v > 255 ? 255 : v);
          } else if (i_fact != 0) {
            pred[y * s + x] = (int32_t)(((32 - i_fact) * (int64_t)rp[idx + 1]
                                         + i_fact * (int64_t)rp[idx + 2] + 16)
                                        >> 5);
          } else {
            pred[y * s + x] = rp[idx + 1];
          }
        }
      }
    } else {
      for (int x = 0; x < s + 2; ++x) rp[x] = left[x];
      hi = s + 1;
      lo = 0;
      if (angle < 0) {
        for (int x = -s; x < 0; ++x) {
          int idx = std::min((x * inv_angle + 256) >> 9, s);
          rp[x] = idx == 0 ? corner : a[idx - 1];
        }
        lo = -s;
      } else {
        for (int x = s + 2; x <= 2 * s; ++x) rp[x] = left[x];
        rp[2 * s + 1] = left[2 * s];
        rp[2 * s + 2] = left[2 * s];
        hi = 2 * s + 2;
      }
      for (int x = 0; x < s; ++x) {
        int i_idx = ((x + 1) * angle) >> 5;
        int i_fact = ((x + 1) * angle) & 31;
        for (int y = 0; y < s; ++y) {
          int idx = y + i_idx;
          if (c == 0) {
            const int32_t* f = filt + i_fact * 4;
            int64_t sm = 0;
            for (int i = 0; i < 4; ++i) sm += (int64_t)f[i] * rp[idx + i];
            int v = (int)((sm + 32) >> 6);
            pred[y * s + x] = v < 0 ? 0 : (v > 255 ? 255 : v);
          } else if (i_fact != 0) {
            pred[y * s + x] = (int32_t)(((32 - i_fact) * (int64_t)rp[idx + 1]
                                         + i_fact * (int64_t)rp[idx + 2] + 16)
                                        >> 5);
          } else {
            pred[y * s + x] = rp[idx + 1];
          }
        }
      }
    }
    (void)lo; (void)hi;
    if (s >= 4 && (mode <= 18 || (mode >= 50 && mode < 81)))
      pdpc(pred, mode, inv_angle, l, a, corner, s);
  }

  // ---- CCLM (8.4.5.2.13/14; spec/intra.py predict_cclm), scalar port.
  // (cx, cy, s) in chroma coords; luma pos = (2cx, 2cy).
  void predict_cclm(int mode, int cx, int cy, int s, int32_t* pred) const {
    int lx = 2 * cx, ly = 2 * cy, tw = s, th = s;
    int lw = 2 * tw, lh = 2 * th;
    const int32_t* luma = plane[0];
    bool avail_l = avail(lx, ly, lx - 1, ly);
    bool avail_t = avail(lx, ly, lx, ly - 1);

    int num_top_right = 0;
    if (mode == 83)
      for (int x = tw; x < 2 * tw; ++x) {
        if (!avail(lx, ly, lx + x * 2, ly - 1)) break;
        ++num_top_right;
      }
    int num_below_left = 0;
    if (mode == 82)
      for (int y = th; y < 2 * th; ++y) {
        if (!avail(lx, ly, lx - 1, ly + y * 2)) break;
        ++num_below_left;
      }

    int num_samp_t, num_samp_l;
    if (mode == 81) {
      num_samp_t = avail_t ? tw : 0;
      num_samp_l = avail_l ? th : 0;
    } else {
      num_samp_t = (avail_t && mode == 83)
                       ? tw + std::min(num_top_right, th) : 0;
      num_samp_l = (avail_l && mode == 82)
                       ? th + std::min(num_below_left, tw) : 0;
    }
    if (num_samp_l == 0 && num_samp_t == 0) {
      for (int i = 0; i < s * s; ++i) pred[i] = 128;
      return;
    }

    bool b_ctu = (ly & ((1 << log2_ctu) - 1)) == 0;
    bool num_is_4 = !(avail_t && avail_l && mode == 81);

    auto picks = [&](int num, int* out) {
      int start = num >> (2 + (num_is_4 ? 1 : 0));
      int step = std::max(num >> (1 + (num_is_4 ? 1 : 0)), 1);
      int cnt = std::min((1 + (num_is_4 ? 1 : 0)) << 1, num);
      for (int p = 0; p < cnt; ++p) out[p] = start + p * step;
      return cnt;
    };
    int pick_t[4] = {0}, pick_l[4] = {0};
    int cnt_t = (avail_t && (mode == 81 || mode == 83))
                    ? picks(num_samp_t, pick_t) : 0;
    int cnt_l = (avail_l && (mode == 81 || mode == 82))
                    ? picks(num_samp_l, pick_l) : 0;

    auto gl = [&](int yy, int xx) -> int64_t {
      if (yy < 0) yy = 0; if (yy >= H) yy = H - 1;
      if (xx < 0) xx = 0; if (xx >= W) xx = W - 1;
      return luma[yy * W + xx];
    };
    int cw = W >> 1, ch = H >> 1;
    const int32_t* chroma = plane[pred_c_];
    auto gc = [&](int yy, int xx) -> int64_t {
      if (yy < 0) yy = 0; if (yy >= ch) yy = ch - 1;
      if (xx < 0) xx = 0; if (xx >= cw) xx = cw - 1;
      return chroma[yy * cw + xx];
    };

    // downsampled co-located luma; left column replicated when no left nbr
    int64_t p_ds[32 * 32];
    for (int y = 0; y < th; ++y)
      for (int x = 0; x < tw; ++x) {
        int xc = lx + 2 * x;
        int xm = x == 0 ? (avail_l ? lx - 1 : lx) : xc - 1;
        int xr = xc + 1;
        int r0 = ly + 2 * y, r1 = r0 + 1;
        p_ds[y * tw + x] = (gl(r0, xm) + gl(r1, xm) + 2 * gl(r0, xc)
                            + 2 * gl(r1, xc) + gl(r0, xr) + gl(r1, xr) + 4)
                           >> 3;
      }

    int64_t sel_y[4] = {0}, sel_c[4] = {0};
    for (int i = 0; i < cnt_t; ++i) {
      int p = pick_t[i];
      sel_c[i] = gc(cy - 1, cx + p);
      int xc = lx + 2 * p;
      int xm = (p > 0 || avail_l) ? xc - 1 : lx;
      int xr = xc + 1;
      if (!b_ctu)
        sel_y[i] = (gl(ly - 1, xm) + gl(ly - 2, xm) + 2 * gl(ly - 1, xc)
                    + 2 * gl(ly - 2, xc) + gl(ly - 1, xr) + gl(ly - 2, xr)
                    + 4) >> 3;
      else
        sel_y[i] = (gl(ly - 1, xm) + 2 * gl(ly - 1, xc) + gl(ly - 1, xr) + 2)
                   >> 2;
    }
    for (int i = 0; i < cnt_l; ++i) {
      int p = pick_l[i];
      sel_c[cnt_t + i] = gc(cy + p, cx - 1);
      int r0 = ly + 2 * p, r1 = r0 + 1;
      sel_y[cnt_t + i] = (gl(r0, lx - 3) + gl(r1, lx - 3)
                          + 2 * gl(r0, lx - 2) + 2 * gl(r1, lx - 2)
                          + gl(r0, lx - 1) + gl(r1, lx - 1) + 4) >> 3;
    }
    if (cnt_t + cnt_l == 2) {
      // two-point fallback (unreachable for s >= 4; kept for parity):
      // new (0,1,2,3) = old (1,3,1,0)
      int64_t y0 = sel_y[0], y1 = sel_y[1], y3 = sel_y[3];
      int64_t c0 = sel_c[0], c1 = sel_c[1], c3 = sel_c[3];
      sel_y[0] = y1; sel_y[1] = y3; sel_y[2] = y1; sel_y[3] = y0;
      sel_c[0] = c1; sel_c[1] = c3; sel_c[2] = c1; sel_c[3] = c0;
    }

    int mn0 = 0, mn1 = 2, mx0 = 1, mx1 = 3;
    if (sel_y[mn0] > sel_y[mn1]) std::swap(mn0, mn1);
    if (sel_y[mx0] > sel_y[mx1]) std::swap(mx0, mx1);
    if (sel_y[mn0] > sel_y[mx1]) { std::swap(mn0, mx0); std::swap(mn1, mx1); }
    if (sel_y[mn1] > sel_y[mx0]) std::swap(mn1, mx0);
    int64_t max_y = (sel_y[mx0] + sel_y[mx1] + 1) >> 1;
    int64_t max_c = (sel_c[mx0] + sel_c[mx1] + 1) >> 1;
    int64_t min_y = (sel_y[mn0] + sel_y[mn1] + 1) >> 1;
    int64_t min_c = (sel_c[mn0] + sel_c[mn1] + 1) >> 1;

    int64_t a = 0, b = min_c;
    int k = 0;
    int64_t diff = max_y - min_y;
    if (diff != 0) {
      int64_t diff_c = max_c - min_c;
      int x_ = ilog2i((int)diff);
      int norm = (int)(((diff << 4) >> x_) & 15);
      x_ += norm != 0 ? 1 : 0;
      int y_ = diff_c != 0 ? ilog2i((int)std::abs(diff_c)) + 1 : 0;
      if (diff_c == 0) a = 0;
      else a = (diff_c * (tabs->cclm_div[norm] | 8)
                + ((int64_t)1 << (y_ - 1))) >> y_;
      if (3 + x_ - y_ < 1) {
        k = 1;
        a = a < 0 ? -15 : (a > 0 ? 15 : 0);
      } else {
        k = 3 + x_ - y_;
      }
      b = min_c - ((a * min_y) >> k);
    }
    for (int y = 0; y < th; ++y)
      for (int x = 0; x < tw; ++x) {
        int64_t v = ((p_ds[y * tw + x] * a) >> k) + b;
        pred[y * tw + x] = (int32_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
      }
  }
  mutable int pred_c_ = 1;  // chroma component being CCLM-predicted

  // ---- transforms (spec/transform.py; DCT-II square, zero-out at 32)
  const int32_t* dct_mat(int s) const {
    return tabs->dct[ilog2i(s) - 2];
  }
  // int32 accumulation throughout (auto-vectorizes): |res| <= 255,
  // |T| <= 91, so pass-1 sums <= 255*91*32 < 2^20; the >>shift1 rows are
  // <= ~46.4k, so pass-2 sums <= 46410*91*32 < 2^28; inverse sums
  // <= 32768*91*32 < 2^27 — all safely inside int32.
  void forward_dct2(const int32_t* res, int s, int32_t* out) const {
    const int32_t* T = dct_mat(s);
    int log2s = ilog2i(s);
    int shift1 = log2s - 1, shift2 = log2s + 6;
    int32_t h[32 * 32];
    const int32_t r1 = 1 << (shift1 - 1);
    const int32_t r2 = 1 << (shift2 - 1);
    for (int y = 0; y < s; ++y)
      for (int i = 0; i < s; ++i) {
        int32_t sm = 0;
        for (int x = 0; x < s; ++x)
          sm += res[y * s + x] * T[i * s + x];
        h[y * s + i] = (sm + r1) >> shift1;
      }
    for (int i = 0; i < s; ++i)
      for (int x = 0; x < s; ++x) {
        int32_t sm = 0;
        for (int y = 0; y < s; ++y)
          sm += T[i * s + y] * h[y * s + x];
        out[i * s + x] = (sm + r2) >> shift2;
      }
  }
  void inverse_dct2(const int16_t* d, int s, int32_t* out) const {
    const int32_t* T = dct_mat(s);
    int32_t v[32 * 32];
    for (int y = 0; y < s; ++y)
      for (int x = 0; x < s; ++x) {
        int32_t sm = 0;
        for (int i = 0; i < s; ++i)
          sm += T[i * s + y] * (int32_t)d[i * s + x];
        sm = (sm + 64) >> 7;
        if (sm < -32768) sm = -32768;
        if (sm > 32767) sm = 32767;
        v[y * s + x] = sm;
      }
    const int bd_shift = 12;  // 20 - bit_depth(8)
    for (int y = 0; y < s; ++y)
      for (int x = 0; x < s; ++x) {
        int32_t sm = 0;
        for (int i = 0; i < s; ++i)
          sm += v[y * s + i] * T[i * s + x];
        out[y * s + x] = (sm + (1 << (bd_shift - 1))) >> bd_shift;
      }
  }

  // ---- one component of one CU
  void commit_comp(int c, int x, int y, int log2, int mode,
                   int16_t* coeff_out) const {
    int sh = c == 0 ? 0 : 1;
    int s = 1 << (log2 - sh);
    int cx = x >> sh, cy = y >> sh;
    int pw = W >> sh;
    int32_t pred[32 * 32];
    if (c != 0 && mode >= 81) {
      pred_c_ = c;
      predict_cclm(mode, cx, cy, s, pred);
    } else {
      int32_t left[65], above[64];
      gather_refs(c, cx, cy, s, x, y, left, above);
      filter_refs(left, above, s, c, mode);
      predict(c, mode, left, above, s, pred);
    }
    int32_t res[32 * 32], t[32 * 32];
    const int32_t* op = orig[c];
    for (int yy = 0; yy < s; ++yy)
      for (int xx = 0; xx < s; ++xx)
        res[yy * s + xx] = op[(cy + yy) * pw + cx + xx]
                           - pred[yy * s + xx];
    forward_dct2(res, s, t);
    int ci = c == 0 ? 0 : 1;
    int32_t ls = tabs->ls_tab[ci * 4 + (log2 - sh - 2)];
    int32_t bd = tabs->bd_tab[ci * 4 + (log2 - sh - 2)];
    int16_t q[32 * 32];
    if (tabs->dep_quant) {
      if (tabs->trellis)
        wrenc_trellis_quant(t, 1, log2 - sh, ls, bd, tabs->lam_dq, q);
      else
        wrenc_greedy_quant(t, 1, log2 - sh, ls, bd, tabs->lam_dq, q);
    } else {
      int64_t bd_off = ((int64_t)1 << bd) >> 1;
      for (int i = 0; i < s * s; ++i) {
        int64_t tq = ((int64_t)t[i] << bd) - bd_off;
        int64_t v = tq >= 0 ? (tq + ls / 2) / ls : -((-tq + ls / 2) / ls);
        q[i] = (int16_t)v;
      }
    }
    std::memcpy(coeff_out, q, sizeof(int16_t) * s * s);
    // dequant + inverse + reconstruct
    int64_t bd_off = ((int64_t)1 << bd) >> 1;
    int16_t d[32 * 32];
    bool any = false;
    for (int i = 0; i < s * s; ++i) {
      int64_t v = ((int64_t)q[i] * ls + bd_off) >> bd;
      if (v < -32768) v = -32768;
      if (v > 32767) v = 32767;
      d[i] = (int16_t)v;
      any = any || q[i] != 0;
    }
    int32_t* rp = plane[c];
    if (!any) {
      for (int yy = 0; yy < s; ++yy)
        for (int xx = 0; xx < s; ++xx)
          rp[(cy + yy) * pw + cx + xx] = pred[yy * s + xx];
      return;
    }
    int32_t r[32 * 32];
    inverse_dct2(d, s, r);
    for (int yy = 0; yy < s; ++yy)
      for (int xx = 0; xx < s; ++xx) {
        int v = pred[yy * s + xx] + r[yy * s + xx];
        rp[(cy + yy) * pw + cx + xx] = v < 0 ? 0 : (v > 255 ? 255 : v);
      }
  }
};

}  // namespace

// Commit a batch of frames' CU decisions: for each frame, walk CUs in
// coding order and reconstruct. cu_meta: 6 int32 per CU (x, y, log2, tree,
// luma_mode, chroma_mode); frame_off: F+1 offsets into the CU list;
// coeff_off: 3 int64 per CU into coeffs_out (-1 = component absent).
extern "C" void wrenc_commit_frames(
    int W, int H, int log2_ctu, int n_frames, int n_threads,
    const int32_t* orig_y, const int32_t* orig_cb, const int32_t* orig_cr,
    int32_t* rec_y, int32_t* rec_cb, int32_t* rec_cr,
    const int32_t* cu_meta, const int64_t* frame_off,
    const int64_t* coeff_off, int16_t* coeffs_out,
    const int32_t* ls_tab, const int32_t* bd_tab, const int32_t* lam_dq,
    int dep_quant, int trellis,
    const int32_t* dct4, const int32_t* dct8, const int32_t* dct16,
    const int32_t* dct32, const int32_t* angle_tab, const int32_t* fc,
    const int32_t* fg, const int32_t* pdpc_w, const int32_t* cclm_div) {
  CommitTabs tabs;
  tabs.dct[0] = dct4; tabs.dct[1] = dct8; tabs.dct[2] = dct16;
  tabs.dct[3] = dct32;
  tabs.angle = angle_tab; tabs.fc = fc; tabs.fg = fg; tabs.pdpc_w = pdpc_w;
  tabs.cclm_div = cclm_div; tabs.ls_tab = ls_tab; tabs.bd_tab = bd_tab;
  tabs.lam_dq = lam_dq; tabs.dep_quant = dep_quant; tabs.trellis = trellis;

  int ysz = W * H, csz = (W / 2) * (H / 2);
  auto run_frame = [&](int f) {
    FrameCommitter fc_;
    fc_.W = W; fc_.H = H; fc_.log2_ctu = log2_ctu; fc_.tabs = &tabs;
    fc_.orig[0] = orig_y + (int64_t)f * ysz;
    fc_.orig[1] = orig_cb + (int64_t)f * csz;
    fc_.orig[2] = orig_cr + (int64_t)f * csz;
    fc_.plane[0] = rec_y + (int64_t)f * ysz;
    fc_.plane[1] = rec_cb + (int64_t)f * csz;
    fc_.plane[2] = rec_cr + (int64_t)f * csz;
    for (int64_t i = frame_off[f]; i < frame_off[f + 1]; ++i) {
      const int32_t* m = cu_meta + i * 6;
      int x = m[0], y = m[1], log2 = m[2], tree = m[3];
      int lm = m[4], cm = m[5];
      if (tree != 2)  // S or L: luma
        fc_.commit_comp(0, x, y, log2, lm, coeffs_out + coeff_off[i * 3]);
      if (tree != 1) {  // S or C: chroma
        fc_.commit_comp(1, x, y, log2, cm,
                        coeffs_out + coeff_off[i * 3 + 1]);
        fc_.commit_comp(2, x, y, log2, cm,
                        coeffs_out + coeff_off[i * 3 + 2]);
      }
    }
  };
  if (n_threads <= 1 || n_frames <= 1) {
    for (int f = 0; f < n_frames; ++f) run_frame(f);
  } else {
    std::vector<std::thread> ts;
    std::atomic_int next{0};
    for (int t = 0; t < std::min(n_threads, n_frames); ++t)
      ts.emplace_back([&] {
        int f;
        while ((f = next.fetch_add(1)) < n_frames) run_frame(f);
      });
    for (auto& th : ts) th.join();
  }
}

// ==================================================== commit-time RD re-pick
// The reference decides modes against TRUE reconstructions
// (block_splitter.rs:110 uses the rolling recon planes); stage A decides on
// original-pixel references. This pass re-runs the leaf mode decision in
// coding order on the true reconstruction, restricted to the stage-A
// candidate list: per CU, every candidate gets the full
// predict -> DCT -> trellis DQ -> dequant -> inverse -> SSD evaluation plus
// the exact rate model (level-rate walk + MPM-aware mode bits,
// block_splitter.rs:377-473), and the chroma CCLM-vs-derived decision is
// re-made the same way (block_splitter.rs:1039-1076). The partition stays
// as stage A chose it.
namespace {

struct RdConsts {
  const int64_t* lv;  // 1024-entry level-rate table (trellis variant)
  double lam;
  double planar_offset, non_planar_offset;
  double mpm_idx_offset, mpm_idx_pow;
  double mpm_remainder_mult, mpm_remainder_offset, mpm_remainder_pow;
  double cclm_offset, cclm_mode_idx_offset, cclm_pow, non_cclm_offset;
  int cclm_enabled, dep_quant;
  double hb, chb;  // header_bits / chroma_header_bits (trellis variants)
  int chroma_redecide = 1;  // 0: trust the stage-A chroma pick
  int rank_full = 0;        // 1: include chroma in candidate ranking
  int rank_trellis = 0;     // 1: rank with the trellis quantizer
};

// optional commit profiling (WRENC_COMMIT_PROF=1): accumulated seconds per
// phase across threads, printed by wrenc_commit_frames_tree
struct CommitProf {
  std::atomic<int64_t> luma_rank_us{0}, luma_final_us{0}, chroma_us{0};
  std::atomic<int64_t> n_cu{0}, n_rank_evals{0}, n_refine{0}, n_pruned{0};
};
static CommitProf g_commit_prof;

static inline int64_t now_us() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

struct RdCommitter {
  FrameCommitter fc;
  const RdConsts* rd;
  bool prof = false;
  // MPM state at 4x4 granularity (coding order), as in spec/encoder.py
  // _search_mpm / SliceCoder::mpm_list: the frame's maps, shared by the
  // threads of its CTU rows (each CU writes only its own area)
  int32_t* mode_map = nullptr;
  uint8_t* mode_set = nullptr;

  int n4w() const { return fc.W >> 2; }

  void set_mode_map(int x, int y, int size, int mode) {
    int x4 = x >> 2, y4 = y >> 2, nn = std::max(size >> 2, 1);
    for (int yy = 0; yy < nn; ++yy)
      for (int xx = 0; xx < nn; ++xx) {
        mode_map[(y4 + yy) * n4w() + x4 + xx] = mode;
        mode_set[(y4 + yy) * n4w() + x4 + xx] = 1;
      }
  }

  void mpm_list(int x, int y, int size, int out[5]) const {
    int l = 0, a = 0;
    int lx = x - 1, ly = y + size - 1;
    if (x > 0 && mode_set[(ly >> 2) * n4w() + (lx >> 2)])
      l = mode_map[(ly >> 2) * n4w() + (lx >> 2)];
    int ax = x + size - 1, ay = y - 1;
    int ctu_top = (y >> fc.log2_ctu) << fc.log2_ctu;
    if (y > 0 && y - 1 >= ctu_top && mode_set[(ay >> 2) * n4w() + (ax >> 2)])
      a = mode_map[(ay >> 2) * n4w() + (ax >> 2)];
    auto fill = [&](int m0, int m1, int m2, int m3, int m4) {
      out[0]=m0; out[1]=m1; out[2]=m2; out[3]=m3; out[4]=m4; };
    if (l == a && l > 1) {
      fill(l, 2+(l+61)%64, 2+(l-1)%64, 2+(l+60)%64, 2+l%64);
    } else if (l != a && (l > 1 || a > 1)) {
      int mn = std::min(l, a), mx = std::max(l, a);
      if (mn > 1) {
        int d = mx - mn;
        if (d == 1) fill(l, a, 2+(mn+61)%64, 2+(mx-1)%64, 2+(mn+60)%64);
        else if (d >= 62) fill(l, a, 2+(mn-1)%64, 2+(mx+61)%64, 2+mn%64);
        else if (d == 2) fill(l, a, 2+(mn-1)%64, 2+(mn+61)%64, 2+(mx-1)%64);
        else fill(l, a, 2+(mn+61)%64, 2+(mn-1)%64, 2+(mx+61)%64);
      } else {
        fill(mx, 2+(mx+61)%64, 2+(mx-1)%64, 2+(mx+60)%64, 2+mx%64);
      }
    } else {
      fill(1, 50, 18, 46, 54);
    }
  }

  // mode-bits estimate for a luma mode given the MPM list
  // (spec/encoder.py _mode_bits; block_splitter.rs:377-398)
  double luma_mode_bits(int mode, const int cand[5]) const {
    if (mode == 0) return rd->planar_offset;
    for (int i = 0; i < 5; ++i)
      if (cand[i] == mode)
        return rd->non_planar_offset +
               std::pow(i + rd->mpm_idx_offset, rd->mpm_idx_pow);
    int s[5]; std::memcpy(s, cand, sizeof(s));
    std::sort(s, s + 5);
    int rem;
    if (mode > s[4]) rem = mode - 6;
    else if (mode > s[3]) rem = mode - 5;
    else if (mode > s[2]) rem = mode - 4;
    else if (mode > s[1]) rem = mode - 3;
    else if (mode > s[0]) rem = mode - 2;
    else rem = mode - 1;
    return rd->non_planar_offset +
           rd->mpm_remainder_mult *
               std::pow(rem + rd->mpm_remainder_offset,
                        rd->mpm_remainder_pow);
  }

  // level-rate walk over the quantized block in coding order
  // (spec/encoder.py _level_rate; block_splitter.rs:415-471)
  int64_t level_rate(const int16_t* q, int log2n) const {
    const int n = 1 << log2n;
    const int P = n * n;
    const auto& sx = g_scan.scan_x[log2n];
    const auto& sy = g_scan.scan_y[log2n];
    int64_t total = 0;
    if (!rd->dep_quant) {
      for (int i = 0; i < P; ++i) {
        int64_t v = std::abs((int)q[i]);
        total += rd->lv[v > 1023 ? 1023 : v];
      }
      return total;
    }
    int qs = 0;
    bool trailing = true;
    for (int p = 0; p < P; ++p) {
      int idx = P - 1 - p;
      int v = std::abs((int)q[sy[idx] * n + sx[idx]]);
      int64_t a = (v + (qs > 1 ? 1 : 0)) / 2;
      if (a == 0) {
        if (!trailing) total += rd->lv[0];
      } else {
        total += rd->lv[a > 1023 ? 1023 : a];
        trailing = false;
      }
      qs = kQStateTrans[qs][a & 1];
    }
    return total;
  }

  // full evaluation of one component with one mode, WITHOUT writing:
  // returns SSD, fills q (levels) and rec. Math identical to
  // FrameCommitter::commit_comp. trellis < 0 follows tabs->trellis;
  // 0 forces the greedy quantizer (cheap candidate ranking).
  int64_t eval_comp(int c, int x, int y, int log2, int mode, int16_t* q,
                    int32_t* rec, int trellis = -1) const {
    int sh = c == 0 ? 0 : 1;
    int s = 1 << (log2 - sh);
    int cx = x >> sh, cy = y >> sh;
    int pw = fc.W >> sh;
    int32_t pred[32 * 32];
    if (c != 0 && mode >= 81) {
      fc.pred_c_ = c;
      fc.predict_cclm(mode, cx, cy, s, pred);
    } else {
      int32_t left[65], above[64];
      fc.gather_refs(c, cx, cy, s, x, y, left, above);
      FrameCommitter::filter_refs(left, above, s, c, mode);
      fc.predict(c, mode, left, above, s, pred);
    }
    int32_t res[32 * 32], t[32 * 32];
    const int32_t* op = fc.orig[c];
    for (int yy = 0; yy < s; ++yy)
      for (int xx = 0; xx < s; ++xx)
        res[yy * s + xx] = op[(cy + yy) * pw + cx + xx] - pred[yy * s + xx];
    fc.forward_dct2(res, s, t);
    int ci = c == 0 ? 0 : 1;
    int32_t ls = fc.tabs->ls_tab[ci * 4 + (log2 - sh - 2)];
    int32_t bd = fc.tabs->bd_tab[ci * 4 + (log2 - sh - 2)];
    if (trellis < 0) trellis = fc.tabs->trellis;
    if (fc.tabs->dep_quant) {
      if (trellis)
        wrenc_trellis_quant(t, 1, log2 - sh, ls, bd, fc.tabs->lam_dq, q);
      else
        wrenc_greedy_quant(t, 1, log2 - sh, ls, bd, fc.tabs->lam_dq, q);
    } else {
      int64_t bd_off = ((int64_t)1 << bd) >> 1;
      for (int i = 0; i < s * s; ++i) {
        int64_t tq = ((int64_t)t[i] << bd) - bd_off;
        int64_t v = tq >= 0 ? (tq + ls / 2) / ls : -((-tq + ls / 2) / ls);
        q[i] = (int16_t)v;
      }
    }
    int64_t bd_off = ((int64_t)1 << bd) >> 1;
    int16_t d[32 * 32];
    bool any = false;
    for (int i = 0; i < s * s; ++i) {
      int64_t v = ((int64_t)q[i] * ls + bd_off) >> bd;
      if (v < -32768) v = -32768;
      if (v > 32767) v = 32767;
      d[i] = (int16_t)v;
      any = any || q[i] != 0;
    }
    int64_t ssd = 0;
    if (!any) {
      for (int yy = 0; yy < s; ++yy)
        for (int xx = 0; xx < s; ++xx) {
          int v = pred[yy * s + xx];
          rec[yy * s + xx] = v;
          int64_t e = v - op[(cy + yy) * pw + cx + xx];
          ssd += e * e;
        }
      return ssd;
    }
    int32_t r[32 * 32];
    fc.inverse_dct2(d, s, r);
    for (int yy = 0; yy < s; ++yy)
      for (int xx = 0; xx < s; ++xx) {
        int v = pred[yy * s + xx] + r[yy * s + xx];
        v = v < 0 ? 0 : (v > 255 ? 255 : v);
        rec[yy * s + xx] = v;
        int64_t e = v - op[(cy + yy) * pw + cx + xx];
        ssd += e * e;
      }
    return ssd;
  }

  void write_comp(int c, int x, int y, int log2, const int32_t* rec,
                  const int16_t* q, int16_t* coeff_out) const {
    int sh = c == 0 ? 0 : 1;
    int s = 1 << (log2 - sh);
    int cx = x >> sh, cy = y >> sh;
    int pw = fc.W >> sh;
    int32_t* rp = fc.plane[c];
    for (int yy = 0; yy < s; ++yy)
      for (int xx = 0; xx < s; ++xx)
        rp[(cy + yy) * pw + cx + xx] = rec[yy * s + xx];
    std::memcpy(coeff_out, q, sizeof(int16_t) * s * s);
  }

  // prediction-only SAD over cb+cr (block_splitter.rs aux chroma cost)
  int64_t aux_chroma_sad(int x, int y, int log2, int mode) const {
    int s = 1 << (log2 - 1);
    int cx = x >> 1, cy = y >> 1;
    int pw = fc.W >> 1;
    int64_t sad = 0;
    int32_t pred[16 * 16];
    for (int c = 1; c <= 2; ++c) {
      if (mode >= 81) {
        fc.pred_c_ = c;
        fc.predict_cclm(mode, cx, cy, s, pred);
      } else {
        int32_t left[65], above[64];
        fc.gather_refs(c, cx, cy, s, x, y, left, above);
        fc.predict(c, mode, left, above, s, pred);
      }
      const int32_t* op = fc.orig[c];
      for (int yy = 0; yy < s; ++yy)
        for (int xx = 0; xx < s; ++xx)
          sad += std::abs(op[(cy + yy) * pw + cx + xx] - pred[yy * s + xx]);
    }
    return sad;
  }

  // chroma RD (cb+cr) for one mode: SSD + lam*(level + mb*16384)/16384
  double chroma_cost(int x, int y, int log2, int mode, double mb,
                     int16_t* qcb, int32_t* rcb, int16_t* qcr,
                     int32_t* rcr) const {
    int64_t ssd = eval_comp(1, x, y, log2, mode, qcb, rcb) +
                  eval_comp(2, x, y, log2, mode, qcr, rcr);
    int64_t level = level_rate(qcb, log2 - 1) + level_rate(qcr, log2 - 1) +
                    (int64_t)(mb * 16384.0);
    return (double)ssd + rd->lam * ((double)level / 16384.0);
  }

  // one CU: re-decide modes on true reconstruction, write winner.
  // Returns the CU's RD cost (ssd + lam*(level + mode_bits*16384)/16384
  // over its active components, WITHOUT the per-CU header constant —
  // the tree walk adds lam*hb / lam*hb/3 / lam*chb by tree type).
  double commit_cu(int x, int y, int log2, int tree, const int32_t* cands,
                 int n_cand, int16_t* coeff_y, int16_t* coeff_cb,
                 int16_t* coeff_cr, int32_t* modes_out, int sa_chroma) {
    int size = 1 << log2;
    int luma_mode = 0;
    double luma_cost = 0.0;
    int16_t best_qy[32 * 32];
    int32_t best_ry[32 * 32];
    // when the rank quantizer equals the commit quantizer, the winner's
    // ranking encode IS the final encode — cache it (bit-identical reuse)
    const bool reuse = rd->rank_trellis || !fc.tabs->trellis;
    bool have_luma = false, have_chroma = false;
    int16_t save_qcb[16 * 16], save_qcr[16 * 16];
    int32_t save_rcb[16 * 16], save_rcr[16 * 16];
    int64_t save_ssd_c = 0, save_level_c = 0;
    if (tree != 2) {
      int cand5[5];
      mpm_list(x, y, size, cand5);
      // candidate ranking: full leaf cost over the active components with
      // the derived chroma (the reference's get_intra_pred_cost,
      // block_splitter.rs:110); rank_full / rank_trellis narrow it
      double best = 0;
      bool first = true;
      int16_t qy[32 * 32];
      int32_t ry[32 * 32];
      int n_live = 0;
      int last_live = 0;
      for (int k = 0; k < n_cand; ++k)
        if (cands[k] >= 0) { ++n_live; last_live = cands[k]; }
      int64_t tp0 = prof ? now_us() : 0;
      if (n_live == 1) {
        luma_mode = last_live;
        if (prof) g_commit_prof.n_pruned.fetch_add(1);
      } else {
        int16_t qcb_t[16 * 16], qcr_t[16 * 16];
        int32_t rcb_t[16 * 16], rcr_t[16 * 16];
        const int csz = (size >> 1) * (size >> 1);
        for (int k = 0; k < n_cand; ++k) {
          int m = cands[k];
          if (m < 0) continue;
          bool dup = false;
          for (int j = 0; j < k; ++j) dup = dup || cands[j] == m;
          if (dup) continue;
          int64_t ssd_y =
              eval_comp(0, x, y, log2, m, qy, ry, rd->rank_trellis ? -1 : 0);
          double mb = luma_mode_bits(m, cand5);
          int64_t level_y = level_rate(qy, log2) + (int64_t)(mb * 16384.0);
          double cost_y =
              (double)ssd_y + rd->lam * ((double)level_y / 16384.0);
          double cost = cost_y;
          int64_t ssd_c = 0, level_c = 0;
          const bool with_chroma = rd->rank_full && tree == 0;
          if (with_chroma) {
            int rtq = rd->rank_trellis ? -1 : 0;
            ssd_c = eval_comp(1, x, y, log2, m, qcb_t, rcb_t, rtq);
            level_c = level_rate(qcb_t, log2 - 1);
            ssd_c += eval_comp(2, x, y, log2, m, qcr_t, rcr_t, rtq);
            level_c += level_rate(qcr_t, log2 - 1);
            cost += (double)ssd_c + rd->lam * ((double)level_c / 16384.0);
          }
          if (prof) g_commit_prof.n_rank_evals.fetch_add(1);
          if (first || cost < best) {
            first = false;
            best = cost;
            luma_mode = m;
            if (reuse) {
              std::memcpy(best_qy, qy, sizeof(int16_t) * size * size);
              std::memcpy(best_ry, ry, sizeof(int32_t) * size * size);
              luma_cost = cost_y;
              have_luma = true;
              if (with_chroma) {
                std::memcpy(save_qcb, qcb_t, sizeof(int16_t) * csz);
                std::memcpy(save_qcr, qcr_t, sizeof(int16_t) * csz);
                std::memcpy(save_rcb, rcb_t, sizeof(int32_t) * csz);
                std::memcpy(save_rcr, rcr_t, sizeof(int32_t) * csz);
                save_ssd_c = ssd_c;
                save_level_c = level_c;
                have_chroma = true;
              }
            }
          }
        }
      }
      int64_t tp1 = prof ? now_us() : 0;
      if (!have_luma) {
        // final encode of the winner with the commit quantizer
        int64_t ssd_y =
            eval_comp(0, x, y, log2, luma_mode, best_qy, best_ry);
        double mb = luma_mode_bits(luma_mode, cand5);
        int64_t level_y =
            level_rate(best_qy, log2) + (int64_t)(mb * 16384.0);
        luma_cost = (double)ssd_y + rd->lam * ((double)level_y / 16384.0);
      }
      write_comp(0, x, y, log2, best_ry, best_qy, coeff_y);
      set_mode_map(x, y, size, luma_mode);
      modes_out[0] = luma_mode;
      if (prof) {
        int64_t tp2 = now_us();
        g_commit_prof.luma_rank_us.fetch_add(tp1 - tp0);
        g_commit_prof.luma_final_us.fetch_add(tp2 - tp1);
        g_commit_prof.n_cu.fetch_add(1);
      }
    } else {
      modes_out[0] = 0;
    }
    if (tree == 1) {
      modes_out[1] = 0;
      return luma_cost;
    }
    // chroma: derived vs best-of-3 CCLM (aux SAD pick, then full RD;
    // derived wins ties — block_splitter.rs:1039-1076)
    int64_t tc0 = prof ? now_us() : 0;
    int derived;
    if (tree == 2) {
      int cxc = x + size / 2, cyc = y + size / 2;
      derived = mode_map[(cyc >> 2) * n4w() + (cxc >> 2)];
    } else {
      derived = luma_mode;
    }
    int16_t qcb[16 * 16], qcr[16 * 16];
    int32_t rcb[16 * 16], rcr[16 * 16];
    if (rd->cclm_enabled && !rd->chroma_redecide) {
      // trust stage A's derived-vs-CCLM pick; encode only that mode
      int cm = sa_chroma >= 81 ? sa_chroma : derived;
      double mb = cm >= 81
                      ? rd->cclm_offset +
                            std::pow(cm - 81 + rd->cclm_mode_idx_offset,
                                     rd->cclm_pow)
                      : rd->non_cclm_offset;
      double cost = chroma_cost(x, y, log2, cm, mb, qcb, rcb, qcr, rcr);
      write_comp(1, x, y, log2, rcb, qcb, coeff_cb);
      write_comp(2, x, y, log2, rcr, qcr, coeff_cr);
      modes_out[1] = cm;
      if (prof) g_commit_prof.chroma_us.fetch_add(now_us() - tc0);
      return luma_cost + cost;
    }
    double mbd = rd->cclm_enabled ? rd->non_cclm_offset : 0.0;
    double cost_d;
    if (have_chroma) {
      // the winner's derived-mode chroma encode was cached in ranking —
      // rebuild cost_d with identical arithmetic instead of re-encoding
      const int csz = (size >> 1) * (size >> 1);
      std::memcpy(qcb, save_qcb, sizeof(int16_t) * csz);
      std::memcpy(qcr, save_qcr, sizeof(int16_t) * csz);
      std::memcpy(rcb, save_rcb, sizeof(int32_t) * csz);
      std::memcpy(rcr, save_rcr, sizeof(int32_t) * csz);
      int64_t level = save_level_c + (int64_t)(mbd * 16384.0);
      cost_d = (double)save_ssd_c + rd->lam * ((double)level / 16384.0);
    } else {
      cost_d = chroma_cost(x, y, log2, derived, mbd, qcb, rcb, qcr, rcr);
    }
    int chroma_mode = derived;
    if (rd->cclm_enabled) {
      int64_t best_sad = 0;
      int cclm = 81;
      for (int m = 81; m <= 83; ++m) {
        int64_t sad = aux_chroma_sad(x, y, log2, m);
        if (m == 81 || sad < best_sad) { best_sad = sad; cclm = m; }
      }
      double mbc = rd->cclm_offset +
                   std::pow(cclm - 81 + rd->cclm_mode_idx_offset,
                            rd->cclm_pow);
      int16_t qcb2[16 * 16], qcr2[16 * 16];
      int32_t rcb2[16 * 16], rcr2[16 * 16];
      double cost_c =
          chroma_cost(x, y, log2, cclm, mbc, qcb2, rcb2, qcr2, rcr2);
      if (cost_c < cost_d) {
        chroma_mode = cclm;
        cost_d = cost_c;
        std::memcpy(qcb, qcb2, sizeof(qcb));
        std::memcpy(qcr, qcr2, sizeof(qcr));
        std::memcpy(rcb, rcb2, sizeof(rcb));
        std::memcpy(rcr, rcr2, sizeof(rcr));
      }
    }
    write_comp(1, x, y, log2, rcb, qcb, coeff_cb);
    write_comp(2, x, y, log2, rcr, qcr, coeff_cr);
    modes_out[1] = chroma_mode;
    if (prof) g_commit_prof.chroma_us.fetch_add(now_us() - tc0);
    return luma_cost + cost_d;
  }

  // ---- QT split refinement (snapshot/rollback like block_splitter.rs
  // :1085-1152): at nodes stage A flagged as ambiguous, both the merged
  // leaf and the split subtree are committed against the true
  // reconstruction and the cheaper one kept.
  struct RegionSnap {
    std::vector<int32_t> y, cb, cr, mm;
    std::vector<uint8_t> ms;
  };

  void snap_region(int x, int y, int s, RegionSnap& r) const {
    int cw = fc.W >> 1;
    r.y.resize(s * s);
    r.cb.resize((s / 2) * (s / 2));
    r.cr.resize((s / 2) * (s / 2));
    for (int yy = 0; yy < s; ++yy)
      std::memcpy(&r.y[yy * s], fc.plane[0] + (y + yy) * fc.W + x,
                  sizeof(int32_t) * s);
    for (int yy = 0; yy < s / 2; ++yy) {
      std::memcpy(&r.cb[yy * (s / 2)],
                  fc.plane[1] + (y / 2 + yy) * cw + x / 2,
                  sizeof(int32_t) * (s / 2));
      std::memcpy(&r.cr[yy * (s / 2)],
                  fc.plane[2] + (y / 2 + yy) * cw + x / 2,
                  sizeof(int32_t) * (s / 2));
    }
    int n4 = s >> 2, x4 = x >> 2, y4 = y >> 2;
    r.mm.resize(n4 * n4);
    r.ms.resize(n4 * n4);
    for (int yy = 0; yy < n4; ++yy)
      for (int xx = 0; xx < n4; ++xx) {
        r.mm[yy * n4 + xx] = mode_map[(y4 + yy) * n4w() + x4 + xx];
        r.ms[yy * n4 + xx] = mode_set[(y4 + yy) * n4w() + x4 + xx];
      }
  }

  void restore_region(int x, int y, int s, const RegionSnap& r) {
    int cw = fc.W >> 1;
    for (int yy = 0; yy < s; ++yy)
      std::memcpy(fc.plane[0] + (y + yy) * fc.W + x, &r.y[yy * s],
                  sizeof(int32_t) * s);
    for (int yy = 0; yy < s / 2; ++yy) {
      std::memcpy(fc.plane[1] + (y / 2 + yy) * cw + x / 2,
                  &r.cb[yy * (s / 2)], sizeof(int32_t) * (s / 2));
      std::memcpy(fc.plane[2] + (y / 2 + yy) * cw + x / 2,
                  &r.cr[yy * (s / 2)], sizeof(int32_t) * (s / 2));
    }
    int n4 = s >> 2, x4 = x >> 2, y4 = y >> 2;
    for (int yy = 0; yy < n4; ++yy)
      for (int xx = 0; xx < n4; ++xx) {
        mode_map[(y4 + yy) * n4w() + x4 + xx] = r.mm[yy * n4 + xx];
        mode_set[(y4 + yy) * n4w() + x4 + xx] = r.ms[yy * n4 + xx];
      }
  }

  // tree walk state
  struct TreeCtx {
    const int32_t* nodes;
    int64_t pos = 0;
    const int32_t* cu_meta;
    const int32_t* cands;
    int n_cand;
    const int64_t* coeff_off;
    int16_t* coeffs;
    int32_t* modes_out;
    int8_t* decisions;
    int64_t dpos = 0;
  };

  double commit_cu_idx(TreeCtx& t, int idx) {
    const int32_t* m = t.cu_meta + (int64_t)idx * 6;
    const int64_t* co = t.coeff_off + (int64_t)idx * 3;
    return commit_cu(m[0], m[1], m[2], m[3], t.cands + (int64_t)idx * t.n_cand,
                     t.n_cand,
                     co[0] >= 0 ? t.coeffs + co[0] : nullptr,
                     co[1] >= 0 ? t.coeffs + co[1] : nullptr,
                     co[2] >= 0 ? t.coeffs + co[2] : nullptr,
                     t.modes_out + (int64_t)idx * 2, m[5]);
  }

  double header_cost(int tree) const {
    if (tree == 0) return rd->lam * rd->hb;
    if (tree == 1) return rd->lam * rd->hb / 3.0;
    return rd->lam * rd->chb;
  }

  double commit_children(TreeCtx& t, int x, int y, int log2, int tree) {
    int half = 1 << (log2 - 1);
    bool scipu = (tree == 0 && log2 == 3);
    double cost = 0.0;
    for (int i = 0; i < 4; ++i)
      cost += commit_tree(t, x + (i % 2) * half, y + (i / 2) * half,
                          log2 - 1, scipu ? 1 : tree);
    if (scipu) cost += commit_tree(t, x, y, log2, 2);
    return cost;
  }

  // node stream: tag >= 0 leaf CU index; -1 split; -2 refine node
  // followed by the merged-leaf CU index, then the children subtree.
  double commit_tree(TreeCtx& t, int x, int y, int log2, int tree) {
    int tag = t.nodes[t.pos++];
    if (tag >= 0) return commit_cu_idx(t, tag) + header_cost(tree);
    if (tag == -1) return commit_children(t, x, y, log2, tree);
    // refine: evaluate merged leaf first (the reference evaluates
    // no-split first; no-split wins ties, block_splitter.rs:1125)
    int leaf_idx = t.nodes[t.pos++];
    if (prof) g_commit_prof.n_refine.fetch_add(1);
    int64_t my_d = t.dpos++;
    int s = 1 << log2;
    RegionSnap pre, after_leaf;
    snap_region(x, y, s, pre);
    double cost_leaf = commit_cu_idx(t, leaf_idx) + header_cost(tree);
    snap_region(x, y, s, after_leaf);
    restore_region(x, y, s, pre);
    double cost_split = commit_children(t, x, y, log2, tree);
    if (cost_split > cost_leaf) {
      restore_region(x, y, s, after_leaf);
      t.decisions[my_d] = 0;
      return cost_leaf;
    }
    t.decisions[my_d] = 1;
    return cost_split;
  }
};

}  // namespace

// The CTU-row wavefront of wrenc_commit_frames_tree. CTU (r, c) reads the
// reconstruction of CTUs (r, c-1) and (r-1, c-1 .. c+1) only: reference
// samples and CCLM neighbours reach at most twice the CU's width to the
// right on the row above (avail() refuses the row below), and the MPM list
// and refinement snapshots stay inside the CU's own CTU and the CTU to its
// left. So a row may run CTU c once the row above has finished c + 2 of its
// CTUs, and every CU still sees exactly the samples of a raster-order walk.
namespace {

struct RowProgress {
  std::atomic<int> done{0};  // CTUs of the row finished
  std::mutex m;
  std::condition_variable cv;
};

// blocks (no spinning: other host work shares the cores) until `row` has
// finished `need` CTUs; acquire pairs with finish()'s release, so the
// row's samples and mode maps are visible after it returns
inline void wait_row(RowProgress& row, int need) {
  if (row.done.load(std::memory_order_acquire) >= need) return;
  std::unique_lock<std::mutex> lk(row.m);
  row.cv.wait(lk, [&] {
    return row.done.load(std::memory_order_acquire) >= need;
  });
}

// stored under the mutex, so a waiter between its check and its sleep
// cannot miss the wake-up
inline void finish(RowProgress& row, int n_done) {
  {
    std::lock_guard<std::mutex> lk(row.m);
    row.done.store(n_done, std::memory_order_release);
  }
  row.cv.notify_all();
}

inline double seconds_between(std::chrono::steady_clock::time_point a,
                              std::chrono::steady_clock::time_point b) {
  return std::chrono::duration<double>(b - a).count();
}

}  // namespace

// Commit with mode re-decision AND QT split refinement. Each CTU's
// decision tree arrives as a pre-order node stream (tag >= 0: leaf CU
// index; -1: split; -2: refine node, followed by the merged-leaf CU index
// and then the children subtree); CTU k (frame-major, raster order in the
// frame) starts at ctu_node_off[k] and ends at ctu_node_off[k + 1].
// decisions_out receives one byte per refine node in pre-order (0 = merged
// leaf kept, 1 = split kept), CTU k's from ctu_dec_off[k]. rd_consts has 17
// doubles (the 12 of the rate model, header_bits, chroma_header_bits and
// the three commit switches).
//
// Work is one task per CTU row of a frame, handed out row-major across the
// frames ((row 0, frame 0), (row 0, frame 1), ..., (row 1, frame 0), ...)
// to min(n_threads, tasks) threads, the caller's among them. Before CTU c
// of row r a thread waits until row r - 1 of the same frame has finished
// min(c + 2, columns) CTUs. This cannot deadlock: tasks are taken in
// order and a row waits only on the row above, a lower task already
// taken, so the lowest unfinished task never waits and always advances.
// Each thread has its own RdCommitter (its prediction scratch is mutable);
// a frame's threads share its planes and mode maps, and every CU writes
// its coefficients, modes and decisions to offsets fixed by the caller.
// stats_out: threads used, their summed busy seconds, their summed
// seconds blocked on the row above, and the number of CTUs whose walk did
// not end where the next CTU's stream starts (0 unless the offsets are
// wrong).
extern "C" void wrenc_commit_frames_tree(
    int W, int H, int log2_ctu, int n_frames, int n_threads,
    const int32_t* orig_y, const int32_t* orig_cb, const int32_t* orig_cr,
    int32_t* rec_y, int32_t* rec_cb, int32_t* rec_cr,
    const int32_t* nodes, const int64_t* ctu_node_off,
    const int32_t* cu_meta,
    const int64_t* coeff_off, int16_t* coeffs_out,
    const int32_t* ls_tab, const int32_t* bd_tab, const int32_t* lam_dq,
    int dep_quant, int trellis, int cclm_enabled,
    const int32_t* cands, int n_cand, const double* rd_consts,
    const int64_t* lv, int32_t* modes_out,
    int8_t* decisions_out, const int64_t* ctu_dec_off,
    const int32_t* dct4, const int32_t* dct8, const int32_t* dct16,
    const int32_t* dct32, const int32_t* angle_tab, const int32_t* fc,
    const int32_t* fg, const int32_t* pdpc_w, const int32_t* cclm_div,
    double* stats_out) {
  CommitTabs tabs;
  tabs.dct[0] = dct4; tabs.dct[1] = dct8; tabs.dct[2] = dct16;
  tabs.dct[3] = dct32;
  tabs.angle = angle_tab; tabs.fc = fc; tabs.fg = fg; tabs.pdpc_w = pdpc_w;
  tabs.cclm_div = cclm_div; tabs.ls_tab = ls_tab; tabs.bd_tab = bd_tab;
  tabs.lam_dq = lam_dq; tabs.dep_quant = dep_quant; tabs.trellis = trellis;

  RdConsts rc;
  rc.lv = lv;
  rc.lam = rd_consts[0];
  rc.planar_offset = rd_consts[1];
  rc.non_planar_offset = rd_consts[2];
  rc.mpm_idx_offset = rd_consts[3];
  rc.mpm_idx_pow = rd_consts[4];
  rc.mpm_remainder_mult = rd_consts[5];
  rc.mpm_remainder_offset = rd_consts[6];
  rc.mpm_remainder_pow = rd_consts[7];
  rc.cclm_offset = rd_consts[8];
  rc.cclm_mode_idx_offset = rd_consts[9];
  rc.cclm_pow = rd_consts[10];
  rc.non_cclm_offset = rd_consts[11];
  rc.hb = rd_consts[12];
  rc.chb = rd_consts[13];
  rc.chroma_redecide = rd_consts[14] != 0.0;
  rc.rank_full = rd_consts[15] != 0.0;
  rc.rank_trellis = rd_consts[16] != 0.0;
  rc.cclm_enabled = cclm_enabled;
  rc.dep_quant = dep_quant;

  int ysz = W * H, csz = (W / 2) * (H / 2);
  int cs = 1 << log2_ctu;
  int n_cols = W / cs, n_rows = H / cs;
  int n4 = (W >> 2) * (H >> 2);
  const bool prof = std::getenv("WRENC_COMMIT_PROF") != nullptr;
  std::vector<int32_t> mode_map((size_t)n_frames * n4, 0);
  std::vector<uint8_t> mode_set((size_t)n_frames * n4, 0);
  const int n_tasks = n_frames * n_rows;
  std::vector<RowProgress> progress(n_tasks);  // [frame][row]
  std::atomic<int> next_task{0};
  std::atomic<int64_t> bad_walks{0};
  const int n_workers = std::max(1, std::min(n_threads, n_tasks));
  std::vector<double> busy_s(n_workers, 0.0), wait_s(n_workers, 0.0);

  auto worker = [&](int w) {
    using clk = std::chrono::steady_clock;
    const auto t_start = clk::now();
    RdCommitter rdc;
    rdc.prof = prof;
    rdc.fc.W = W; rdc.fc.H = H; rdc.fc.log2_ctu = log2_ctu;
    rdc.fc.tabs = &tabs;
    rdc.rd = &rc;
    RdCommitter::TreeCtx t;
    t.cu_meta = cu_meta;
    t.cands = cands;
    t.n_cand = n_cand;
    t.coeff_off = coeff_off;
    t.coeffs = coeffs_out;
    t.modes_out = modes_out;
    int k;
    while ((k = next_task.fetch_add(1)) < n_tasks) {
      const int r = k / n_frames, f = k % n_frames;
      rdc.fc.orig[0] = orig_y + (int64_t)f * ysz;
      rdc.fc.orig[1] = orig_cb + (int64_t)f * csz;
      rdc.fc.orig[2] = orig_cr + (int64_t)f * csz;
      rdc.fc.plane[0] = rec_y + (int64_t)f * ysz;
      rdc.fc.plane[1] = rec_cb + (int64_t)f * csz;
      rdc.fc.plane[2] = rec_cr + (int64_t)f * csz;
      rdc.mode_map = mode_map.data() + (size_t)f * n4;
      rdc.mode_set = mode_set.data() + (size_t)f * n4;
      RowProgress& mine = progress[(size_t)f * n_rows + r];
      for (int col = 0; col < n_cols; ++col) {
        if (r > 0) {
          RowProgress& above = progress[(size_t)f * n_rows + r - 1];
          const int need = std::min(col + 2, n_cols);
          if (above.done.load(std::memory_order_acquire) < need) {
            const auto t0 = clk::now();
            wait_row(above, need);
            wait_s[w] += seconds_between(t0, clk::now());
          }
        }
        const int64_t ctu = ((int64_t)f * n_rows + r) * n_cols + col;
        t.nodes = nodes + ctu_node_off[ctu];
        t.pos = 0;
        t.decisions = decisions_out + ctu_dec_off[ctu];
        t.dpos = 0;
        rdc.commit_tree(t, col * cs, r * cs, log2_ctu, 0);
        if (t.pos != ctu_node_off[ctu + 1] - ctu_node_off[ctu] ||
            t.dpos != ctu_dec_off[ctu + 1] - ctu_dec_off[ctu])
          bad_walks.fetch_add(1);
        finish(mine, col + 1);
      }
    }
    busy_s[w] = seconds_between(t_start, clk::now()) - wait_s[w];
  };
  {
    std::vector<std::thread> ts;
    for (int w = 1; w < n_workers; ++w) ts.emplace_back(worker, w);
    worker(0);
    for (auto& th : ts) th.join();
  }
  double busy = 0.0, waited = 0.0;
  for (int w = 0; w < n_workers; ++w) {
    busy += busy_s[w];
    waited += wait_s[w];
  }
  stats_out[0] = n_workers;
  stats_out[1] = busy;
  stats_out[2] = waited;
  stats_out[3] = (double)bad_walks.load();
  if (prof) {
    auto& p = g_commit_prof;
    std::fprintf(stderr,
                 "[commit prof] cu=%lld rank_evals=%lld pruned=%lld "
                 "refine=%lld luma_rank=%.3fs luma_final=%.3fs "
                 "chroma=%.3fs (thread-summed)\n",
                 (long long)p.n_cu.load(), (long long)p.n_rank_evals.load(),
                 (long long)p.n_pruned.load(),
                 (long long)p.n_refine.load(),
                 p.luma_rank_us.load() / 1e6, p.luma_final_us.load() / 1e6,
                 p.chroma_us.load() / 1e6);
    p.luma_rank_us = 0; p.luma_final_us = 0; p.chroma_us = 0;
    p.n_cu = 0; p.n_rank_evals = 0; p.n_refine = 0; p.n_pruned = 0;
  }
}

// ====================================================== chroma stage A (RD)
// Host-side chroma candidate RD: derived-mode and CCLM costs for every
// aligned chroma block over ORIGINAL planes (the stage-A convention of
// search/wavefront.py). Replaces per-size device round-trips; numerically
// identical to kernels/quantize.greedy_depquant's fused RD (same greedy
// decisions, same float32 accumulation order for the lv rate).
namespace {

void greedy_rd_block(const int32_t* t, int log2n, int32_t ls, int32_t bd,
                     const int32_t* lam_dq, const float* lv, int16_t* q,
                     float* rate_out) {
  const int n = 1 << log2n;
  const int P = n * n;
  const int64_t bd_offset = (int64_t{1} << bd) >> 1;
  const auto& sx = g_scan.scan_x[log2n];
  const auto& sy = g_scan.scan_y[log2n];
  int q_state = 0;
  bool trailing = true;
  float rate = 0.0f;
  for (int p = 0; p < P; ++p) {
    int idx = P - 1 - p;
    int xc = sx[idx], yc = sy[idx];
    int32_t tc = t[yc * n + xc];
    int64_t abs_tc = tc < 0 ? -(int64_t)tc : tc;
    int64_t a = 0, mag = 0;
    if (tc != 0) {
      int64_t delta = q_state > 1 ? 1 : 0;
      int64_t s_ = (abs_tc << bd) + (tc < 0 ? bd_offset : -bd_offset);
      int64_t a0 = (s_ / ls + delta) / 2;
      int64_t bestc = 0;
      for (int k = 0; k < 2; ++k) {
        int64_t ak = a0 + k;
        int64_t mg = ak == 0 ? 0 : 2 * ak - delta;
        int64_t dq = (mg * ls + bd_offset) >> bd;
        int64_t dist = std::abs(abs_tc - dq);
        int64_t bits = (ak == 0 && trailing) ? 0 : ak + 1;
        if (bits > 1023) bits = 1023;
        int64_t c = 128 * dist + lam_dq[bits];
        if (k == 0 || c < bestc) { bestc = c; a = ak; mag = mg; }
      }
    }
    q[yc * n + xc] = (int16_t)(tc < 0 ? -mag : mag);
    int64_t av = a > 1023 ? 1023 : a;
    rate += (a == 0) ? (trailing ? 0.0f : lv[0]) : lv[av];
    trailing = trailing && a == 0;
    q_state = kQStateTrans[q_state][a & 1];
  }
  *rate_out = rate;
}

struct ChromaStageA {
  FrameCommitter fc;
  const int32_t* ls_c;   // per chroma log2 2..4
  const int32_t* bd_c;
  const int32_t* lam_dq;
  const float* lv;

  // RD of one chroma block (chroma coords) with one mode.
  void rd(int c, int cx, int cy, int s, int mode, int64_t* ssd_out,
          float* rate_out) {
    int log2 = ilog2i(s);
    int32_t pred[16 * 16];
    if (mode >= 81) {
      fc.pred_c_ = c;
      fc.predict_cclm(mode, cx, cy, s, pred);
    } else {
      int32_t left[65], above[64];
      fc.gather_refs(c, cx, cy, s, 2 * cx, 2 * cy, left, above);
      fc.predict(c, mode, left, above, s, pred);
    }
    int cw = fc.W >> 1;
    const int32_t* op = fc.orig[c];
    int32_t res[16 * 16], t[16 * 16];
    for (int y = 0; y < s; ++y)
      for (int x = 0; x < s; ++x)
        res[y * s + x] = op[(cy + y) * cw + cx + x] - pred[y * s + x];
    fc.forward_dct2(res, s, t);
    int32_t ls = ls_c[log2 - 2], bd = bd_c[log2 - 2];
    int16_t q[16 * 16];
    float rate;
    greedy_rd_block(t, log2, ls, bd, lam_dq, lv, q, &rate);
    int64_t bd_off = ((int64_t)1 << bd) >> 1;
    int16_t d[16 * 16];
    bool any = false;
    for (int i = 0; i < s * s; ++i) {
      int64_t v = ((int64_t)q[i] * ls + bd_off) >> bd;
      if (v < -32768) v = -32768;
      if (v > 32767) v = 32767;
      d[i] = (int16_t)v;
      any = any || q[i] != 0;
    }
    int64_t ssd = 0;
    if (any) {
      int32_t r[16 * 16];
      fc.inverse_dct2(d, s, r);
      for (int y = 0; y < s; ++y)
        for (int x = 0; x < s; ++x) {
          int v = pred[y * s + x] + r[y * s + x];
          v = v < 0 ? 0 : (v > 255 ? 255 : v);
          int64_t e = v - op[(cy + y) * cw + cx + x];
          ssd += e * e;
        }
    } else {
      for (int y = 0; y < s; ++y)
        for (int x = 0; x < s; ++x) {
          int64_t e = pred[y * s + x] - op[(cy + y) * cw + cx + x];
          ssd += e * e;
        }
    }
    *ssd_out = ssd;
    *rate_out = rate;
  }
};

}  // namespace

// Chroma stage A for all frames: derived-mode (leaf + SCIPU) and CCLM
// candidate costs per aligned chroma block. dmodesN / outputs may be NULL
// when that size is not in the partition ladder. Output layout:
//   d_ssd / d_rate: (F, N, 2) per comp (cb, cr)
//   sc_*: (F, N4, 2); cc_*: (F, 3, N, 2) for modes 81/82/83.
extern "C" void wrenc_chroma_stage_a(
    int W, int H, int log2_ctu, int F, int n_threads,
    const int32_t* orig_y, const int32_t* orig_cb, const int32_t* orig_cr,
    const int32_t* dmodes4, const int32_t* dmodes8, const int32_t* dmodes16,
    const int32_t* scipu_modes, int cclm_enabled,
    const int32_t* ls_c, const int32_t* bd_c,
    const int32_t* lam_dq, const float* lv,
    int64_t* d_ssd4, float* d_rate4, int64_t* d_ssd8, float* d_rate8,
    int64_t* d_ssd16, float* d_rate16,
    int64_t* sc_ssd, float* sc_rate,
    int64_t* cc_ssd4, float* cc_rate4, int64_t* cc_ssd8, float* cc_rate8,
    int64_t* cc_ssd16, float* cc_rate16,
    const int32_t* dct4, const int32_t* dct8, const int32_t* dct16,
    const int32_t* dct32, const int32_t* angle_tab, const int32_t* fc_tab,
    const int32_t* fg_tab, const int32_t* pdpc_w, const int32_t* cclm_div) {
  CommitTabs tabs;
  tabs.dct[0] = dct4; tabs.dct[1] = dct8; tabs.dct[2] = dct16;
  tabs.dct[3] = dct32;
  tabs.angle = angle_tab; tabs.fc = fc_tab; tabs.fg = fg_tab;
  tabs.pdpc_w = pdpc_w; tabs.cclm_div = cclm_div;
  tabs.ls_tab = ls_c; tabs.bd_tab = bd_c; tabs.lam_dq = lam_dq;
  tabs.dep_quant = 1; tabs.trellis = 0;
  int ysz = W * H, csz = (W / 2) * (H / 2);
  const int css[3] = {4, 8, 16};
  const int32_t* dmodes[3] = {dmodes4, dmodes8, dmodes16};
  int64_t* dssd[3] = {d_ssd4, d_ssd8, d_ssd16};
  float* drate[3] = {d_rate4, d_rate8, d_rate16};
  int64_t* cssd[3] = {cc_ssd4, cc_ssd8, cc_ssd16};
  float* crate[3] = {cc_rate4, cc_rate8, cc_rate16};

  auto run_frame = [&](int f) {
    ChromaStageA st;
    st.fc.W = W; st.fc.H = H; st.fc.log2_ctu = log2_ctu;
    st.fc.tabs = &tabs;
    st.fc.orig[0] = orig_y + (int64_t)f * ysz;
    st.fc.orig[1] = orig_cb + (int64_t)f * csz;
    st.fc.orig[2] = orig_cr + (int64_t)f * csz;
    // prediction reads "recon" = original planes (stage-A convention)
    st.fc.plane[0] = const_cast<int32_t*>(st.fc.orig[0]);
    st.fc.plane[1] = const_cast<int32_t*>(st.fc.orig[1]);
    st.fc.plane[2] = const_cast<int32_t*>(st.fc.orig[2]);
    st.ls_c = ls_c; st.bd_c = bd_c; st.lam_dq = lam_dq; st.lv = lv;

    for (int si = 0; si < 3; ++si) {
      int cs = css[si];
      int nbw = (W / 2) / cs, nbh = (H / 2) / cs;
      int N = nbw * nbh;
      bool want_d = dmodes[si] != nullptr;
      bool want_sc = si == 0 && scipu_modes != nullptr;
      bool want_cc = cclm_enabled && cssd[si] != nullptr;
      if (!want_d && !want_sc && !want_cc) continue;
      for (int i = 0; i < N; ++i) {
        int cx = (i % nbw) * cs, cy = (i / nbw) * cs;
        for (int c = 1; c <= 2; ++c) {
          if (want_d) {
            int mode = dmodes[si][(int64_t)f * N + i];
            st.rd(c, cx, cy, cs, mode,
                  &dssd[si][((int64_t)f * N + i) * 2 + (c - 1)],
                  &drate[si][((int64_t)f * N + i) * 2 + (c - 1)]);
          }
          if (want_sc) {
            int mode = scipu_modes[(int64_t)f * N + i];
            st.rd(c, cx, cy, cs, mode,
                  &sc_ssd[((int64_t)f * N + i) * 2 + (c - 1)],
                  &sc_rate[((int64_t)f * N + i) * 2 + (c - 1)]);
          }
          if (want_cc) {
            for (int m = 0; m < 3; ++m)
              st.rd(c, cx, cy, cs, 81 + m,
                    &cssd[si][(((int64_t)f * 3 + m) * N + i) * 2 + (c - 1)],
                    &crate[si][(((int64_t)f * 3 + m) * N + i) * 2 + (c - 1)]);
          }
        }
      }
    }
  };
  if (n_threads <= 1 || F <= 1) {
    for (int f = 0; f < F; ++f) run_frame(f);
  } else {
    std::vector<std::thread> ts;
    std::atomic_int next{0};
    for (int t = 0; t < std::min(n_threads, F); ++t)
      ts.emplace_back([&] {
        int f;
        while ((f = next.fetch_add(1)) < F) run_frame(f);
      });
    for (auto& th : ts) th.join();
  }
}

// ================================================================= decoder
// Native slice decoder: CABAC + syntax parse (the decode direction of
// SliceCoder, mirroring entropy/syntax.py 'dec' mode) + reconstruction via
// FrameCommitter's spec-exact predict/dequant/inverse. Used by the Python
// decoder as a fast path; the Python implementation remains the
// independent conformance oracle (equality-tested against this one).
namespace {

struct BitSource {
  const uint8_t* data;
  int64_t nbits;
  int64_t pos = 0;
  int bit() {
    if (pos >= nbits) return 0;  // rbsp padding reads as zero
    int b = (data[pos >> 3] >> (7 - (pos & 7))) & 1;
    ++pos;
    return b;
  }
};

struct CabacDec {
  std::vector<uint16_t> s0, s1;
  std::vector<uint8_t> shift_idx;
  std::vector<int> se_off;
  uint32_t range = 510, offset = 0;
  BitSource* r = nullptr;

  void init_engine() {
    range = 510;
    offset = 0;
    for (int i = 0; i < 9; ++i) offset = (offset << 1) | r->bit();
  }
  int bin(int se, int inc) {
    int i = se_off[se] + inc;
    uint32_t p_state = s1[i] + 16u * s0[i];
    int val_mps = p_state >> 14;
    uint32_t q = range >> 5;
    uint32_t lps =
        ((q * ((val_mps == 0 ? p_state : 32767 - p_state) >> 9)) >> 1) + 4;
    range -= lps;
    int b;
    if (offset >= range) {
      b = 1 - val_mps;
      offset -= range;
      range = lps;
    } else {
      b = val_mps;
    }
    while (range < 256) {
      range <<= 1;
      offset = (offset << 1) | r->bit();
    }
    int sh = shift_idx[i];
    int sh0 = (sh >> 2) + 2, sh1 = (sh & 3) + 3 + sh0;
    s0[i] = (uint16_t)(s0[i] - (s0[i] >> sh0) + ((1023 * b) >> sh0));
    s1[i] = (uint16_t)(s1[i] - (s1[i] >> sh1) + ((16383 * b) >> sh1));
    return b;
  }
  int bypass() {
    offset = (offset << 1) | r->bit();
    if (offset >= range) { offset -= range; return 1; }
    return 0;
  }
  int terminate() {
    range -= 2;
    if (offset >= range) return 1;
    while (range < 256) {
      range <<= 1;
      offset = (offset << 1) | r->bit();
    }
    return 0;
  }
};

struct SliceDecoder {
  CabacDec c;
  FrameCommitter fc;            // reconstruction + availability
  int W = 0, H = 0, log2_ctu = 5;
  bool dep_quant = true, transform_skip_enabled = true, cclm_enabled = true;
  bool explicit_mts_intra = true;
  bool mts_dc_only = true, mts_zero_out = true;
  const int32_t* ls_tab = nullptr;  // [2][4] (min(c,1), log2-2)
  const int32_t* bd_tab = nullptr;
  // per-QP quant tables [64][2][4] (qp, min(c,1), log2-2); chroma rows
  // are precomputed at the mapped chroma QP of each luma QP. Enables
  // nonzero cu_qp_delta reconstruction (spec 8.7.1).
  const int32_t* ls_qp_tab = nullptr;
  const int32_t* bd_qp_tab = nullptr;
  // QG (== CTU, cu_qp_delta_subdiv = 0) QP state, spec 8.7.1: at CTU
  // granularity the A/B neighbours are outside the current CTB so the
  // prediction reduces to qP_Y_PREV, except at a CTB-row start where
  // the above QG's QP applies (quantizer.rs:95-234)
  int qp_y_prev = 0, qg_pred_qp = 0, qg_delta = 0, cur_qp_y = 0;
  std::vector<int32_t> qg_qp_col0;
  std::vector<int32_t> mode_map;
  std::vector<uint8_t> mode_set;
  std::vector<int16_t> cbw_map, cbh_map;
  bool cu_qp_delta_coded = false;
  int32_t pass1[32 * 32];
  int32_t abs_lv[32 * 32];
  int q_state = 0;
  bool error = false;
  int ecode = -1;

  int n4w() const { return W >> 2; }
  bool avail(int cx, int cy, int nx, int ny) const {
    return fc.avail(cx, cy, nx, ny);
  }

  void mpm_list(int x, int y, int size, int out[5]) const {
    int l = 0, a = 0;
    int lx = x - 1, ly = y + size - 1;
    if (x > 0 && mode_set[(ly >> 2) * n4w() + (lx >> 2)])
      l = mode_map[(ly >> 2) * n4w() + (lx >> 2)];
    int ax = x + size - 1, ay = y - 1;
    int ctu_top = (y >> log2_ctu) << log2_ctu;
    if (y > 0 && y - 1 >= ctu_top && mode_set[(ay >> 2) * n4w() + (ax >> 2)])
      a = mode_map[(ay >> 2) * n4w() + (ax >> 2)];
    auto fill = [&](int m0, int m1, int m2, int m3, int m4) {
      out[0]=m0; out[1]=m1; out[2]=m2; out[3]=m3; out[4]=m4; };
    if (l == a && l > 1) {
      fill(l, 2+(l+61)%64, 2+(l-1)%64, 2+(l+60)%64, 2+l%64);
    } else if (l != a && (l > 1 || a > 1)) {
      int mn = std::min(l, a), mx = std::max(l, a);
      if (mn > 1) {
        int d = mx - mn;
        if (d == 1) fill(l, a, 2+(mn+61)%64, 2+(mx-1)%64, 2+(mn+60)%64);
        else if (d >= 62) fill(l, a, 2+(mn-1)%64, 2+(mx+61)%64, 2+mn%64);
        else if (d == 2) fill(l, a, 2+(mn-1)%64, 2+(mn+61)%64, 2+(mx-1)%64);
        else fill(l, a, 2+(mn+61)%64, 2+(mn-1)%64, 2+(mx+61)%64);
      } else {
        fill(mx, 2+(mx+61)%64, 2+(mx-1)%64, 2+(mx+60)%64, 2+mx%64);
      }
    } else {
      fill(1, 50, 18, 46, 54);
    }
  }

  int decode_luma_mode(int x, int y, int size) {
    int cand[5];
    mpm_list(x, y, size, cand);
    int mode;
    if (c.bin(SE_IntraLumaMpmFlag, 0)) {
      if (c.bin(SE_IntraLumaNotPlanarFlag, 1)) {
        int idx = 0;
        while (idx < 4 && c.bypass()) ++idx;
        mode = cand[idx];
      } else {
        mode = 0;
      }
    } else {
      // TB(60): n=61, k=5, u=3
      int v = 0;
      for (int i = 0; i < 5; ++i) v = (v << 1) | c.bypass();
      int rem = v < 3 ? v : ((v << 1) | c.bypass()) - 3;
      int s[5]; std::memcpy(s, cand, sizeof(s));
      std::sort(s, s + 5);
      mode = rem + 1;
      for (int i = 0; i < 5; ++i)
        if (mode >= s[i]) ++mode;
    }
    return mode;
  }

  int decode_chroma_mode(int derived_luma) {
    if (cclm_enabled && c.bin(SE_CclmModeFlag, 0)) {
      int idx = 0;
      if (c.bin(SE_CclmModeIdx, 0)) idx = 1 + c.bypass();
      return 81 + idx;
    }
    int idx;
    if (c.bin(SE_IntraChromaPredMode, 0))
      idx = (c.bypass() << 1) | c.bypass();
    else
      idx = 4;
    if (idx == 4) return derived_luma;
    const int base[4] = {0, 50, 18, 1};
    return derived_luma == base[idx] ? 66 : base[idx];
  }

  // --- ctx helpers (identical formulas to SliceCoder)
  int local_template(int xc, int yc, int log2n, const int32_t* m,
                     bool cap1) const {
    int n = 1 << log2n;
    int s = 0;
    auto val = [&](int x, int y) {
      int v = m[y * n + x];
      return cap1 ? std::min(v, 1) : v;
    };
    if (xc < n - 1) {
      s += val(xc + 1, yc);
      if (xc < n - 2) s += val(xc + 2, yc);
      if (yc < n - 1) s += val(xc + 1, yc + 1);
    }
    if (yc < n - 1) {
      s += val(xc, yc + 1);
      if (yc < n - 2) s += val(xc, yc + 2);
    }
    return s;
  }
  int sig_ctx(int xc, int yc, int c_idx, int log2n) const {
    int sum_p1 = local_template(xc, yc, log2n, pass1, false);
    int d = xc + yc;
    int qs = dep_quant ? std::max(q_state - 1, 0) : 0;
    if (c_idx == 0)
      return 12 * qs + std::min((sum_p1 + 1) >> 1, 3) +
             (d < 2 ? 8 : d < 5 ? 4 : 0);
    return 36 + 8 * qs + std::min((sum_p1 + 1) >> 1, 3) + (d < 2 ? 4 : 0);
  }
  int gtx_ctx(int xc, int yc, int c_idx, int log2n, int j, int lx,
              int ly) const {
    int sum_p1 = local_template(xc, yc, log2n, pass1, false);
    int num_sig = local_template(xc, yc, log2n, pass1, true);
    int off = std::min(sum_p1 - num_sig, 4);
    int d = xc + yc;
    int inc;
    if (xc == lx && yc == ly) inc = c_idx == 0 ? 0 : 21;
    else if (c_idx == 0)
      inc = 1 + off + (d == 0 ? 15 : d < 3 ? 10 : d < 10 ? 5 : 0);
    else
      inc = 22 + off + (d == 0 ? 5 : 0);
    if (j == 1) inc += 32;
    return inc;
  }
  int rice_param(int xc, int yc, int log2n, int base) const {
    int s = local_template(xc, yc, log2n, abs_lv, false);
    s = std::min(std::max(s - base * 5, 0), 31);
    return kRiceParams[s];
  }

  int64_t decode_rice_escape(int rice) {
    int prefix = 0;
    while (prefix < 6 && c.bypass()) ++prefix;
    if (prefix < 6) {
      int64_t v = prefix;
      for (int i = 0; i < rice; ++i) v = (v << 1) | c.bypass();
      return v;
    }
    int64_t c_max = int64_t{6} << rice;
    int k = rice + 1;
    int pre = 0;
    while (pre < 11 && c.bypass()) ++pre;
    int esc = pre == 11 ? 15 : pre + k;
    int64_t rem = 0;
    for (int i = 0; i < esc; ++i) rem = (rem << 1) | c.bypass();
    return c_max + ((((int64_t)1 << pre) - 1) << k) + rem;
  }

  int decode_last_prefix_suffix(int se, int c_idx, int log2n) {
    int c_max = (std::min(log2n, 5) << 1) - 1;
    static const int OFFSET_Y[6] = {0, 0, 3, 6, 10, 15};
    auto ctx = [&](int b) {
      int off, shift;
      if (c_idx == 0) { off = OFFSET_Y[log2n - 1]; shift = (log2n + 1) >> 2; }
      else { off = 20; shift = std::min(std::max((1 << log2n) >> 3, 0), 2); }
      return (b >> shift) + off;
    };
    int prefix = 0;
    while (prefix < c_max && c.bin(se, ctx(prefix))) ++prefix;
    if (prefix <= 3) return prefix;
    int nb = (prefix >> 1) - 1;
    int suffix = 0;
    for (int i = 0; i < nb; ++i) suffix = (suffix << 1) | c.bypass();
    return ((2 + (prefix & 1)) << nb) + suffix;
  }

  // decode one residual block into q (int16 n*n)
  void decode_residual(int16_t* q, int log2n, int c_idx) {
    int n = 1 << log2n;
    int P = n * n;
    std::memset(q, 0, sizeof(int16_t) * P);
    std::memset(pass1, 0, sizeof(int32_t) * P);
    std::memset(abs_lv, 0, sizeof(int32_t) * P);
    const auto& sx = g_scan.scan_x[log2n];
    const auto& sy = g_scan.scan_y[log2n];

    int last_x = decode_last_prefix_suffix(SE_LastSigCoeffXPrefix, c_idx,
                                           log2n);
    int last_y = decode_last_prefix_suffix(SE_LastSigCoeffYPrefix, c_idx,
                                           log2n);
    int last_idx = -1;
    for (int i = 0; i < P; ++i)
      if (sx[i] == last_x && sy[i] == last_y) { last_idx = i; break; }
    if (last_idx < 0) { error = true; ecode = -5; return; }

    int num_sb_coeff = std::min(P, 16);
    int sb_sz = num_sb_coeff == 16 ? 4 : n;
    int nsb_dim = n / sb_sz;
    int last_sb = last_idx / num_sb_coeff;
    int last_scan_pos = last_idx % num_sb_coeff;

    if (c_idx == 0 && last_idx > 0) mts_dc_only = false;

    int rem_bins = (P * 7) >> 2;
    q_state = 0;
    std::vector<uint8_t> sb_coded_map(nsb_dim * nsb_dim, 0);
    int8_t sign_map[32 * 32];

    for (int i = last_sb; i >= 0; --i) {
      int x0 = sx[i * num_sb_coeff] & ~(sb_sz - 1);
      int y0 = sy[i * num_sb_coeff] & ~(sb_sz - 1);
      int sxs = x0 / sb_sz, sys = y0 / sb_sz;
      int start_q_state = q_state;
      int64_t sb_abs[16] = {0};
      std::memset(sign_map, 0, sizeof(sign_map));

      bool sb_coded;
      bool infer_dc = false;
      if (i < last_sb && i > 0) {
        int csbf = 0;
        if (sxs < nsb_dim - 1) csbf += sb_coded_map[sys * nsb_dim + sxs + 1];
        if (sys < nsb_dim - 1) csbf += sb_coded_map[(sys + 1) * nsb_dim + sxs];
        csbf = std::min(csbf, 1);
        int inc = c_idx == 0 ? csbf : 2 + csbf;
        sb_coded = c.bin(SE_SbCodedFlag, inc);
        infer_dc = true;
      } else {
        sb_coded = true;
      }
      sb_coded_map[sys * nsb_dim + sxs] = sb_coded;
      if (sb_coded && (sxs > 3 || sys > 3) && c_idx == 0) mts_zero_out = false;

      int first_pos_mode0 = (i == last_sb) ? last_scan_pos
                                           : num_sb_coeff - 1;
      int first_pos_mode1 = first_pos_mode0;

      for (int p = first_pos_mode0; p >= 0; --p) {
        if (rem_bins < 4) break;
        int gi = i * num_sb_coeff + p;
        int xc = sx[gi], yc = sy[gi];
        bool is_last = (xc == last_x && yc == last_y);
        bool in_sb_dc = (xc % sb_sz == 0) && (yc % sb_sz == 0);
        bool emitted = sb_coded && (p > 0 || !infer_dc) && !is_last;
        int sig;
        if (emitted) {
          sig = c.bin(SE_SigCoeffFlag, sig_ctx(xc, yc, c_idx, log2n));
          --rem_bins;
          if (sig) infer_dc = false;
        } else {
          sig = is_last ? 1 : (in_sb_dc && infer_dc && sb_coded ? 1 : 0);
        }
        int gt0 = 0, par = 0, gt1 = 0;
        if (sig) {
          gt0 = c.bin(SE_AbsLevelGtxFlag,
                      gtx_ctx(xc, yc, c_idx, log2n, 0, last_x, last_y));
          --rem_bins;
          if (gt0) {
            par = c.bin(SE_ParLevelFlag,
                        gtx_ctx(xc, yc, c_idx, log2n, -1, last_x, last_y));
            gt1 = c.bin(SE_AbsLevelGtxFlag,
                        gtx_ctx(xc, yc, c_idx, log2n, 1, last_x, last_y));
            rem_bins -= 2;
          }
        }
        int p1 = sig + par + gt0 + 2 * gt1;
        pass1[yc * n + xc] = p1;
        sb_abs[p] = p1;
        if (dep_quant) q_state = kQStateTrans[q_state][p1 & 1];
        first_pos_mode1 = p - 1;
      }
      // pass 2
      for (int p = first_pos_mode0; p > first_pos_mode1; --p) {
        int gi = i * num_sb_coeff + p;
        int xc = sx[gi], yc = sy[gi];
        int p1 = pass1[yc * n + xc];
        int64_t rem = 0;
        if (p1 >= 4) {
          int rice = rice_param(xc, yc, log2n, 4);
          rem = decode_rice_escape(rice);
        }
        abs_lv[yc * n + xc] = (int32_t)(p1 + 2 * rem);
        sb_abs[p] = abs_lv[yc * n + xc];
      }
      // pass 3
      for (int p = first_pos_mode1; p >= 0; --p) {
        int gi = i * num_sb_coeff + p;
        int xc = sx[gi], yc = sy[gi];
        if (sb_coded) {
          int rice = rice_param(xc, yc, log2n, 0);
          int64_t zero_pos = (int64_t)(dep_quant ? (q_state < 2 ? 1 : 2) : 1)
                             << rice;
          int64_t dec = decode_rice_escape(rice);
          int64_t v = dec == zero_pos ? 0 : (dec < zero_pos ? dec + 1 : dec);
          sb_abs[p] = v;
        }
        abs_lv[yc * n + xc] = (int32_t)sb_abs[p];
        if (dep_quant) q_state = kQStateTrans[q_state][sb_abs[p] & 1];
      }
      // signs
      for (int p = num_sb_coeff - 1; p >= 0; --p) {
        int gi = i * num_sb_coeff + p;
        int xc = sx[gi], yc = sy[gi];
        if (sb_abs[p] > 0) sign_map[yc * n + xc] = (int8_t)c.bypass();
      }
      // reconstruct stored q levels
      int qs = start_q_state;
      for (int p = num_sb_coeff - 1; p >= 0; --p) {
        int gi = i * num_sb_coeff + p;
        int xc = sx[gi], yc = sy[gi];
        int64_t a = sb_abs[p];
        int64_t mag;
        if (dep_quant) {
          mag = a > 0 ? 2 * a - (qs > 1 ? 1 : 0) : 0;
          qs = kQStateTrans[qs][a & 1];
        } else {
          mag = a;
        }
        q[yc * n + xc] = (int16_t)(sign_map[yc * n + xc] ? -mag : mag);
      }
    }
  }

  // reconstruct one component of a CU from decoded coefficients
  void reconstruct(int c_comp, int x, int y, int log2, int mode,
                   const int16_t* q, bool any) {
    int sh = c_comp == 0 ? 0 : 1;
    int s = 1 << (log2 - sh);
    int cx = x >> sh, cy = y >> sh;
    int pw = W >> sh;
    int32_t pred[32 * 32];
    if (c_comp != 0 && mode >= 81) {
      fc.pred_c_ = c_comp;
      fc.predict_cclm(mode, cx, cy, s, pred);
    } else {
      int32_t left[65], above[64];
      fc.gather_refs(c_comp, cx, cy, s, x, y, left, above);
      FrameCommitter::filter_refs(left, above, s, c_comp, mode);
      fc.predict(c_comp, mode, left, above, s, pred);
    }
    int32_t* rp = fc.plane[c_comp];
    if (!any) {
      for (int yy = 0; yy < s; ++yy)
        for (int xx = 0; xx < s; ++xx)
          rp[(cy + yy) * pw + cx + xx] = pred[yy * s + xx];
      return;
    }
    int ci = c_comp == 0 ? 0 : 1;
    int32_t ls, bd;
    if (ls_qp_tab) {        // per-QG QpY (spec 8.7.1)
      ls = ls_qp_tab[cur_qp_y * 8 + ci * 4 + (log2 - sh - 2)];
      bd = bd_qp_tab[cur_qp_y * 8 + ci * 4 + (log2 - sh - 2)];
    } else {
      ls = ls_tab[ci * 4 + (log2 - sh - 2)];
      bd = bd_tab[ci * 4 + (log2 - sh - 2)];
    }
    int64_t bd_off = ((int64_t)1 << bd) >> 1;
    int16_t d[32 * 32];
    for (int i = 0; i < s * s; ++i) {
      int64_t v = ((int64_t)q[i] * ls + bd_off) >> bd;
      if (v < -32768) v = -32768;
      if (v > 32767) v = 32767;
      d[i] = (int16_t)v;
    }
    int32_t r[32 * 32];
    fc.inverse_dct2(d, s, r);
    for (int yy = 0; yy < s; ++yy)
      for (int xx = 0; xx < s; ++xx) {
        int v = pred[yy * s + xx] + r[yy * s + xx];
        rp[(cy + yy) * pw + cx + xx] = v < 0 ? 0 : (v > 255 ? 255 : v);
      }
  }

  void decode_cu(int x, int y, int log2, int tree) {
    int size = 1 << log2;
    int luma_mode = 0, chroma_mode = 0;
    if (tree != 2) luma_mode = decode_luma_mode(x, y, size);
    if (tree != 1) {
      int derived;
      if (tree == 2) {
        int cxc = x + size / 2, cyc = y + size / 2;
        derived = mode_map[(cyc >> 2) * n4w() + (cxc >> 2)];
      } else derived = luma_mode;
      chroma_mode = decode_chroma_mode(derived);
    }
    if (tree != 2) {
      int x4 = x >> 2, y4 = y >> 2, nn = std::max(size >> 2, 1);
      for (int yy = 0; yy < nn; ++yy)
        for (int xx = 0; xx < nn; ++xx) {
          mode_map[(y4 + yy) * n4w() + x4 + xx] = luma_mode;
          mode_set[(y4 + yy) * n4w() + x4 + xx] = 1;
        }
    }
    // transform unit
    bool luma_active = tree != 2;
    bool chroma_active = tree != 1;
    mts_dc_only = true;
    mts_zero_out = true;
    int cb_coded = 0, cr_coded = 0, y_coded = 0;
    if (chroma_active) {
      cb_coded = c.bin(SE_TuCbCodedFlag, 0);
      cr_coded = c.bin(SE_TuCrCodedFlag, cb_coded ? 1 : 0);
    }
    if (luma_active) y_coded = c.bin(SE_TuYCodedFlag, 0);
    if ((y_coded || cb_coded || cr_coded) && tree != 2
        && !cu_qp_delta_coded) {
      // full binarization: TR(5) prefix (bin0 ctx 0, rest ctx 1) + EG0
      // bypass suffix + bypass sign (spec 9.3.3)
      int v = 0;
      while (v < 5 && c.bin(SE_CuQpDeltaAbs, v == 0 ? 0 : 1)) ++v;
      if (v == 5) {
        int pre = 0;
        while (c.bypass()) ++pre;
        int suf = 0;
        for (int i = 0; i < pre; ++i) suf = (suf << 1) | c.bypass();
        v += (1 << pre) - 1 + suf;
      }
      int sign = v ? c.bypass() : 0;
      int delta = sign ? -v : v;
      if (delta != 0 && !ls_qp_tab) { error = true; ecode = -3; return; }
      qg_delta = delta;
      cur_qp_y = (qg_pred_qp + delta + 64) % 64;
      cu_qp_delta_coded = true;
    }
    int16_t qbuf[32 * 32];
    if (luma_active) {
      if (y_coded) {
        if (transform_skip_enabled && c.bin(SE_TransformSkipFlag, 0)) {
          error = true; ecode = -4; return;
        }
        decode_residual(qbuf, log2, 0);
        reconstruct(0, x, y, log2, luma_mode, qbuf, true);
      } else {
        reconstruct(0, x, y, log2, luma_mode, nullptr, false);
      }
    }
    if (chroma_active) {
      if (cb_coded) {
        if (transform_skip_enabled && c.bin(SE_TransformSkipFlag, 1)) {
          error = true; ecode = -6; return;
        }
        decode_residual(qbuf, log2 - 1, 1);
        reconstruct(1, x, y, log2, chroma_mode, qbuf, true);
      } else {
        reconstruct(1, x, y, log2, chroma_mode, nullptr, false);
      }
      if (cr_coded) {
        if (transform_skip_enabled && c.bin(SE_TransformSkipFlag, 1)) {
          error = true; ecode = -7; return;
        }
        decode_residual(qbuf, log2 - 1, 2);
        reconstruct(2, x, y, log2, chroma_mode, qbuf, true);
      } else {
        reconstruct(2, x, y, log2, chroma_mode, nullptr, false);
      }
    }
    // CU-level mts_idx (ctu_encoder.rs:1292-1319): luma was already
    // reconstructed with DCT-II above, so any mts_idx != 0 (never produced
    // by this encoder) aborts native decode; the Python decoder handles it.
    if (tree != 2 && explicit_mts_intra && size <= 32 &&
        mts_zero_out && !mts_dc_only) {
      int mts = 0;
      while (mts < 4 && c.bin(SE_MtsIdx, mts)) ++mts;
      if (mts != 0) { error = true; ecode = -8; return; }
    }
  }

  void decode_tree(int x, int y, int log2, int tree) {
    if (error) return;
    int size = 1 << log2;
    bool allow_qt = (tree != 2) && size > 4;
    bool split = false;
    if (allow_qt && y + size <= H) {
      bool al = avail(x, y, x - 1, y);
      bool aa = avail(x, y, x, y - 1);
      int cond_l = al && cbh_map[(y >> 2) * n4w() + ((x - 1) >> 2)] < size;
      int cond_a = aa && cbw_map[((y - 1) >> 2) * n4w() + (x >> 2)] < size;
      split = c.bin(SE_SplitCuFlag, cond_l + cond_a);
    } else if (allow_qt) {
      split = true;   // bottom-boundary CTUs would force split; H%32==0 here
    }
    if (split) {
      int half = size >> 1;
      bool scipu = (tree == 0 && size == 8);
      for (int i = 0; i < 4; ++i)
        decode_tree(x + (i % 2) * half, y + (i / 2) * half, log2 - 1,
                    scipu ? 1 : tree);
      if (scipu) decode_tree(x, y, log2, 2);
    } else {
      if (tree != 2) {
        int x4 = x >> 2, y4 = y >> 2, nn = std::max(size >> 2, 1);
        for (int yy = 0; yy < nn; ++yy)
          for (int xx = 0; xx < nn; ++xx) {
            cbw_map[(y4 + yy) * n4w() + x4 + xx] = (int16_t)size;
            cbh_map[(y4 + yy) * n4w() + x4 + xx] = (int16_t)size;
          }
      }
      decode_cu(x, y, log2, tree);
    }
  }
};

}  // namespace

// Decode one slice's payload (post-SH, de-emulated RBSP bytes) into the
// recon planes. Returns 0 on success, negative on parse error.
extern "C" int wrenc_decode_slice(
    int W, int H, int log2_ctu, int qp, int dep_quant, int ts_enabled,
    int cclm_enabled, int explicit_mts_intra,
    const int32_t* se_off, int n_se,
    const int32_t* init_vals, const int32_t* shift_vals, int n_ctx,
    const uint8_t* data, int64_t n_bytes,
    int wpp, const int64_t* entry_lens, int n_entry,
    const int32_t* ls_tab, const int32_t* bd_tab,
    const int32_t* dct4, const int32_t* dct8, const int32_t* dct16,
    const int32_t* dct32, const int32_t* angle_tab, const int32_t* fc_tab,
    const int32_t* fg_tab, const int32_t* pdpc_w, const int32_t* cclm_div,
    const int32_t* ls_qp_tab, const int32_t* bd_qp_tab,
    int32_t* rec_y, int32_t* rec_cb, int32_t* rec_cr) {
  CommitTabs tabs;
  tabs.dct[0] = dct4; tabs.dct[1] = dct8; tabs.dct[2] = dct16;
  tabs.dct[3] = dct32;
  tabs.angle = angle_tab; tabs.fc = fc_tab; tabs.fg = fg_tab;
  tabs.pdpc_w = pdpc_w; tabs.cclm_div = cclm_div;
  tabs.ls_tab = ls_tab; tabs.bd_tab = bd_tab; tabs.lam_dq = nullptr;
  tabs.dep_quant = dep_quant; tabs.trellis = 0;

  SliceDecoder sd;
  sd.W = W; sd.H = H; sd.log2_ctu = log2_ctu;
  sd.dep_quant = dep_quant; sd.transform_skip_enabled = ts_enabled;
  sd.cclm_enabled = cclm_enabled;
  sd.explicit_mts_intra = explicit_mts_intra;
  sd.ls_tab = ls_tab; sd.bd_tab = bd_tab;
  sd.ls_qp_tab = ls_qp_tab; sd.bd_qp_tab = bd_qp_tab;
  sd.qp_y_prev = qp; sd.qg_pred_qp = qp; sd.cur_qp_y = qp;
  sd.qg_qp_col0.assign(H >> log2_ctu ? H >> log2_ctu : 1, qp);
  sd.mode_map.assign((W >> 2) * (H >> 2), 0);
  sd.mode_set.assign((W >> 2) * (H >> 2), 0);
  sd.cbw_map.assign((W >> 2) * (H >> 2), 0);
  sd.cbh_map.assign((W >> 2) * (H >> 2), 0);
  sd.fc.W = W; sd.fc.H = H; sd.fc.log2_ctu = log2_ctu; sd.fc.tabs = &tabs;
  sd.fc.plane[0] = rec_y; sd.fc.plane[1] = rec_cb; sd.fc.plane[2] = rec_cr;
  std::memset(rec_y, 0, sizeof(int32_t) * W * H);
  std::memset(rec_cb, 0, sizeof(int32_t) * (W / 2) * (H / 2));
  std::memset(rec_cr, 0, sizeof(int32_t) * (W / 2) * (H / 2));

  sd.c.se_off.assign(se_off, se_off + n_se);
  sd.c.s0.resize(n_ctx);
  sd.c.s1.resize(n_ctx);
  sd.c.shift_idx.resize(n_ctx);
  int qp_c = std::min(std::max(qp, 0), 63);
  for (int i = 0; i < n_ctx; ++i) {
    int init = init_vals[i];
    int slope = (init >> 3) - 4;
    int offs = (init & 7) * 18 + 1;
    int pre = ((slope * (qp_c - 16)) >> 1) + offs;
    pre = std::min(std::max(pre, 1), 127);
    sd.c.s0[i] = (uint16_t)(pre << 3);
    sd.c.s1[i] = (uint16_t)(pre << 7);
    sd.c.shift_idx[i] = (uint8_t)shift_vals[i];
  }

  int cs = 1 << log2_ctu;
  int n_cols = W / cs, n_rows = H / cs;
  int n_ctu = n_cols * n_rows;
  bool use_wpp = wpp && n_rows > 1;

  std::vector<int64_t> starts(1, 0);
  for (int i = 0; i < n_entry; ++i)
    starts.push_back(starts.back() + entry_lens[i]);

  BitSource src{data, n_bytes * 8};
  sd.c.r = &src;
  sd.c.init_engine();
  std::vector<uint16_t> snap0, snap1;

  int idx = 0;
  for (int r = 0; r < n_rows; ++r) {
    if (use_wpp && r > 0) {
      src.pos = starts[r] * 8;
      sd.c.s0 = snap0;
      sd.c.s1 = snap1;
      sd.c.init_engine();
    }
    for (int col = 0; col < n_cols; ++col) {
      sd.cu_qp_delta_coded = false;
      // QG begin (spec 8.7.1): row starts predict from the above QG
      sd.qg_pred_qp = (col == 0 && r > 0) ? sd.qg_qp_col0[r - 1]
                                          : sd.qp_y_prev;
      sd.qg_delta = 0;
      sd.cur_qp_y = sd.qg_pred_qp;
      sd.decode_tree(col * cs, r * cs, log2_ctu, 0);
      if (sd.error) return sd.ecode * 1000 - idx;
      // QG end: finalize QpY (delta 0 when none was coded)
      sd.qp_y_prev = (sd.qg_pred_qp + sd.qg_delta + 64) % 64;
      if (col == 0) sd.qg_qp_col0[r] = sd.qp_y_prev;
      if (use_wpp && col == 0) { snap0 = sd.c.s0; snap1 = sd.c.s1; }
      int end = sd.c.terminate();
      bool last = idx == n_ctu - 1;
      int want = (last || (use_wpp && col == n_cols - 1)) ? 1 : 0;
      if (end != want) return -2;
      ++idx;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Commit-schedule dependency ranks over 4x4 cells — the C twin of
// search/device_commit._cu_ranks (WavefrontSearch._commit discipline).
// cu_meta: (N, 6) int32 rows [x, y, log2, is_phantom, ext_l, ext_t];
// ext_l/ext_t say whether the below-left / above-right reference samples
// are AVAILABLE (spec 6.4.4) — unavailable extensions are never read
// (substitution masks them), so the dependency window is the block
// height/width alone there, which shortens the critical rank chains.
// A normal CU ranks strictly after everything it reads:
// max(windows, own) + 1. A PHANTOM (merged-leaf refine alternative)
// reads only its OUTSIDE refs and its region's accumulated costs — not
// its children's pixels — so it shares the rank of its region's last
// contributor: max(windows + 1, own). The in-scan resolver orders
// same-step classes 'C' < 'L' < 'S'(ascending size), which makes every
// same-step region contributor visible before the phantom resolves.
// Both kinds write the grid, so later readers rank after resolution —
// with zero rank-depth inflation vs a phantom-free schedule.
// ranks_out: (N,) int32.
extern "C" void wrenc_cu_ranks2(const int32_t* cu_meta, int64_t n_cu, int W,
                                int H, int32_t* ranks_out) {
  const int gw = W >> 2, gh = H >> 2;
  std::vector<int32_t> grid((size_t)gw * gh, 0);
  for (int64_t i = 0; i < n_cu; ++i) {
    const int32_t* m = cu_meta + i * 6;
    int x = m[0], y = m[1], s = 1 << m[2], phantom = m[3];
    int ext_l = m[4], ext_t = m[5];
    int x4 = x >> 2, y4 = y >> 2, n4 = s >> 2 ? s >> 2 : 1;
    int r_nb = 0, r_own = 0;
    if (x > 0) {
      int y0 = y4 - 1 < 0 ? 0 : y4 - 1;
      int yext = y4 + (ext_l ? 2 * n4 : n4);
      int y1 = yext < gh ? yext : gh;
      for (int yy = y0; yy < y1; ++yy) {
        int v = grid[(size_t)yy * gw + x4 - 1];
        if (v > r_nb) r_nb = v;
      }
    }
    if (y > 0) {
      int x0 = x4 - 1 < 0 ? 0 : x4 - 1;
      int xext = x4 + (ext_t ? 2 * n4 : n4);
      int x1 = xext < gw ? xext : gw;
      const int32_t* row = &grid[(size_t)(y4 - 1) * gw];
      for (int xx = x0; xx < x1; ++xx)
        if (row[xx] > r_nb) r_nb = row[xx];
    }
    for (int yy = y4; yy < y4 + n4; ++yy)
      for (int xx = x4; xx < x4 + n4; ++xx) {
        int v = grid[(size_t)yy * gw + xx];
        if (v > r_own) r_own = v;
      }
    int r;
    if (phantom) {
      r = r_nb + 1 > r_own ? r_nb + 1 : r_own;
    } else {
      r = (r_nb > r_own ? r_nb : r_own) + 1;
    }
    ranks_out[i] = r;
    for (int yy = y4; yy < y4 + n4; ++yy)
      for (int xx = x4; xx < x4 + n4; ++xx) {
        int32_t* c = &grid[(size_t)yy * gw + xx];
        if (r > *c) *c = r;
      }
  }
}

// Legacy 4-column entry point (conservative full windows).
extern "C" void wrenc_cu_ranks(const int32_t* cu_meta, int64_t n_cu, int W,
                               int H, int32_t* ranks_out) {
  std::vector<int32_t> m6((size_t)n_cu * 6);
  for (int64_t i = 0; i < n_cu; ++i) {
    for (int j = 0; j < 4; ++j) m6[i * 6 + j] = cu_meta[i * 4 + j];
    m6[i * 6 + 4] = 1;
    m6[i * 6 + 5] = 1;
  }
  wrenc_cu_ranks2(m6.data(), n_cu, W, H, ranks_out);
}
