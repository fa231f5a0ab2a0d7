"""Quantization / dequantization incl. dependent-quantization trellis.

Behavioural reference: quantizer.rs (derive_qp :95, quantize :519,
search_dq :338, dequantize :761). The trellis here is an exact Viterbi over
the same cost model — state (q_state, trailing_zeros), 2 candidate levels
per position — rather than the reference's memoized recursion; it optimizes
the identical objective.

All blocks are square power-of-two in this codebase; chroma QP mapping with
the default SPS QP tables is the identity clamped to [0, 63]
(encoder_context.rs:609-650 with QpTable defaults).
"""
from dataclasses import dataclass

import numpy as np

from ..core import tables


def full_scan(log2_w, log2_h):
    """Whole-TB scan order: 4x4 sub-blocks in diagonal order, coefficients in
    diagonal order inside each sub-block. Returns (N,2) (x,y) int array.
    (Sub-block size per spec 6.5.2 / ctu.rs get_log2_sb_size; >=4x4 blocks
    always use 4x4 sub-blocks here, 2xN handling included for completeness.)
    """
    log2_sb_w, log2_sb_h = sb_size(log2_w, log2_h)
    sub = tables.diag_scan(log2_sb_h, log2_sb_w)
    sbs = tables.diag_scan(log2_h - log2_sb_h, log2_w - log2_sb_w)
    out = []
    for sx, sy in sbs:
        base_x, base_y = sx << log2_sb_w, sy << log2_sb_h
        for cx, cy in sub:
            out.append((base_x + cx, base_y + cy))
    return np.array(out, dtype=np.int32)


def sb_size(log2_w, log2_h):
    """log2 sub-block (width, height) — ctu.rs:827-845."""
    log2_sb_w = 1 if min(log2_w, log2_h) < 2 else 2
    log2_sb_h = log2_sb_w
    if log2_w + log2_h > 3:
        if log2_w < 2:
            log2_sb_w = log2_w
            log2_sb_h = 4 - log2_sb_w
        elif log2_h < 2:
            log2_sb_h = log2_h
            log2_sb_w = 4 - log2_sb_h
    return log2_sb_w, log2_sb_h


def chroma_qp_from_luma(qp_y):
    """Default chroma QP table is identity (see module docstring)."""
    return int(np.clip(qp_y, 0, 63))


@dataclass
class QuantParams:
    """Per-TU-component quantization parameters."""
    qp: int            # qp' for this component
    bd_shift: int
    ls: int            # level scale (uniform; flat scaling matrix m=16)

    @property
    def bd_offset(self):
        return (1 << self.bd_shift) >> 1


def derive_quant_params(qp, log2_tw, log2_th, *, dep_quant, transform_skip,
                        bit_depth=8, qp_prime_ts_min=4):
    """Spec 8.7.3 scaling parameters for a square/rect TB (quantizer.rs:540-631)."""
    if not transform_skip:
        qp = int(np.clip(qp, 0, 63))
        rect = (log2_tw + log2_th) & 1
        bd_shift = bit_depth + rect + (log2_tw + log2_th) // 2 - 5 + (1 if dep_quant else 0)
    else:
        qp = int(np.clip(qp, qp_prime_ts_min, 63))
        rect = 0
        bd_shift = 10
    if dep_quant and not transform_skip:
        scale = int(tables.LEVEL_SCALE[rect][(qp + 1) % 6])
        shift = (qp + 1) // 6
    else:
        scale = int(tables.LEVEL_SCALE[rect][qp % 6])
        shift = qp // 6
    ls = (16 * scale) << shift
    return QuantParams(qp=qp, bd_shift=bd_shift, ls=ls)


def quantize_rdoq_off(t, qp_params):
    """Plain scalar quantization (non-dep-quant path, quantizer.rs:722-736)."""
    t = np.asarray(t, dtype=np.int64)
    ls = qp_params.ls
    tq = (t << qp_params.bd_shift) - qp_params.bd_offset
    pos = (tq + ls // 2) // ls
    neg = -((-tq + ls // 2) // ls)
    return np.where(tq >= 0, pos, neg).astype(np.int16)


def _rate_table(lv_pow):
    i = np.arange(1024, dtype=np.float64) * 16384.0
    return np.power(i, lv_pow).astype(np.int64)


class DepQuantizer:
    """Dependent quantizer with greedy and trellis modes."""

    def __init__(self, rate_model):
        self.rm = rate_model
        self._dq_table = _rate_table(rate_model.quant_lv_pow)

    def _lambda(self, qp, trellis):
        rm = self.rm
        qp_div = rm.quant_qp_div_trellis if trellis else rm.quant_qp_div
        mul = rm.quant_lambda_mul_trellis if trellis else rm.quant_lambda_mul
        off = rm.quant_lambda_offset_trellis if trellis else rm.quant_lambda_offset
        return int(2.0 ** (qp / qp_div) * mul) + off

    def _rate(self, bits):
        return self._dq_table[min(int(bits), 1023)]

    def _candidates(self, tc, q_state, qp):
        """Two candidate levels (a, q, dist) for transform coeff tc."""
        ls = qp.ls
        delta = 1 if q_state > 1 else 0
        s = (abs(int(tc)) << qp.bd_shift) + (qp.bd_offset if tc < 0 else -qp.bd_offset)
        sign = -1 if tc < 0 else 1
        a0 = (s // ls + delta) // 2
        out = []
        for a in (a0, a0 + 1):
            q = 0 if a == 0 else sign * (2 * a - delta)
            dq = (q * ls + qp.bd_offset) >> qp.bd_shift
            out.append((a, q, abs(int(tc) - dq)))
        return out

    def quantize(self, t, qp_y, qp_params, trellis):
        """Dependent quantization of transform block `t` ((th,tw) int).

        Returns the stored quantized levels q (int16, the "2a-delta" form the
        dequantizer consumes; coded AbsLevel a is re-derived from q plus the
        running state, cf. quantize/search_dq in quantizer.rs).
        """
        t = np.asarray(t)
        th, tw = t.shape
        log2_tw, log2_th = tw.bit_length() - 1, th.bit_length() - 1
        scan = full_scan(log2_tw, log2_th)  # DC-first order
        coding_order = scan[::-1]           # high-frequency first
        lam = self._lambda(qp_y, trellis)
        n = len(coding_order)
        trans = tables.Q_STATE_TRANS

        if not trellis:
            q_out = np.zeros((th, tw), dtype=np.int16)
            q_state, trailing = 0, True
            for i, (x, y) in enumerate(coding_order):
                tc = int(t[y, x])
                if tc == 0:
                    a, q = 0, 0
                else:
                    best = None
                    for a_c, q_c, dist in self._candidates(tc, q_state, qp_params):
                        bits = 0 if (a_c == 0 and trailing) else a_c + 1
                        cost = 128 * dist + lam * self._rate(bits)
                        if best is None or cost < best[0]:
                            best = (cost, a_c, q_c)
                    a, q = best[1], best[2]
                q_out[y, x] = q
                trailing = trailing and a == 0
                q_state = int(trans[q_state][a & 1])
            return q_out

        # Trellis: Viterbi over 8 states (q_state x trailing).
        NEG = np.int64(1) << 60
        cost = np.full(8, NEG, dtype=np.int64)
        cost[0 * 2 + 1] = 0  # state 0, trailing=True
        # backpointers: (n, 8) -> (prev_state, a, q)
        bp_state = np.zeros((n, 8), dtype=np.int8)
        bp_a = np.zeros((n, 8), dtype=np.int32)
        bp_q = np.zeros((n, 8), dtype=np.int32)
        for i, (x, y) in enumerate(coding_order):
            tc = int(t[y, x])
            new_cost = np.full(8, NEG, dtype=np.int64)
            for st in range(8):
                if cost[st] >= NEG:
                    continue
                q_state, trailing = st >> 1, st & 1
                if tc == 0:
                    cands = [(0, 0, 0)]
                else:
                    cands = self._candidates(tc, q_state, qp_params)
                for a, q, dist in cands:
                    if a == 0 and trailing:
                        bits = 0
                    else:
                        bits = a + 1
                    c = cost[st] + 128 * dist + lam * self._rate(bits)
                    if i == n - 1 and trailing and a == 0:
                        # all-zero block correction (search_dq :512)
                        c -= lam * self._rate(1)
                    nst = int(trans[q_state][a & 1]) * 2 + (1 if (trailing and a == 0) else 0)
                    if c < new_cost[nst]:
                        new_cost[nst] = c
                        bp_state[i, nst] = st
                        bp_a[i, nst] = a
                        bp_q[i, nst] = q
            cost = new_cost
        # backtrack from best final state
        st = int(np.argmin(cost))
        q_out = np.zeros((th, tw), dtype=np.int16)
        for i in range(n - 1, -1, -1):
            x, y = coding_order[i]
            q_out[y, x] = bp_q[i, st]
            st = int(bp_state[i, st])
        return q_out


def dequantize(q, qp_params):
    """d = clamp((q * ls + bd_offset) >> bd_shift) (quantizer.rs:761)."""
    q = np.asarray(q, dtype=np.int64)
    d = (q * qp_params.ls + qp_params.bd_offset) >> qp_params.bd_shift
    return np.clip(d, -(1 << 15), (1 << 15) - 1).astype(np.int16)


def abs_levels_from_q(q, log2_tw, log2_th):
    """Re-derive coded AbsLevel array + per-position q_state from stored q.

    Walks the coding (reverse-scan) order advancing the DQ state machine;
    returns (abs_level array int32, q_state array int32) both (th, tw).
    Used by the entropy writer and the RD rate estimator.
    """
    th, tw = 1 << log2_th, 1 << log2_tw
    scan = full_scan(log2_tw, log2_th)
    coding_order = scan[::-1]
    a_out = np.zeros((th, tw), dtype=np.int32)
    s_out = np.zeros((th, tw), dtype=np.int32)
    q_state = 0
    trans = tables.Q_STATE_TRANS
    for x, y in coding_order:
        qc = abs(int(q[y, x]))
        s_out[y, x] = q_state
        if qc == 0:
            a = 0
        else:
            a = (qc + (1 if q_state > 1 else 0)) // 2
        a_out[y, x] = a
        q_state = int(trans[q_state][a & 1])
    return a_out, s_out


# ------------------------------------------------------------------ BDPCM
# Residual DPCM on quantized transform-skip levels (spec 8.7.3 "BDPCM"
# arm). The reference carries this as dead code (quantizer.rs:736-758
# forward, :864-889 inverse; sps_bdpcm_enabled_flag is never written, so
# neither path ever runs). Note the reference's forward pass differences
# IN PLACE against the already-differenced neighbour, which does not
# invert its own decoder-side prefix sum — dead-code bug. The pair here
# is the spec-correct one: forward diffs against the ORIGINAL neighbour
# level, inverse is the clamped running prefix sum the spec (and the
# reference's :864-889) defines, and round-trips bit-exactly.

COEFF_MIN, COEFF_MAX = -(1 << 15), (1 << 15) - 1


def bdpcm_dpcm(q, dir_flag):
    """Forward residual DPCM: d[0]=q[0]; d[i]=q[i]-q[i-1] along columns
    (dir_flag=1, vertical prediction) or rows (dir_flag=0, horizontal).
    Returns int32 diffs (a diff of two int16-range levels can exceed
    int16; the entropy layer codes levels at int32 range)."""
    q = np.asarray(q, dtype=np.int32)
    d = q.copy()
    if dir_flag:
        d[1:, :] -= q[:-1, :]
    else:
        d[:, 1:] -= q[:, :-1]
    return d


def bdpcm_inverse(d, dir_flag):
    """Inverse residual DPCM (quantizer.rs:868-889 discipline): running
    prefix sum along the DPCM axis, clamped to the int16 coefficient
    range at EVERY step (the clamp is observable only on adversarial
    bitstreams; for any encoder-produced diff sequence the sums are the
    original int16 levels and the clamp never binds)."""
    d = np.asarray(d, dtype=np.int64)
    # the reference holds levels as i16, so the seed row/column is
    # int16-range by construction; clamp it here for the same contract
    r = np.clip(d, COEFF_MIN, COEFF_MAX)
    if dir_flag:
        for y in range(1, r.shape[0]):
            r[y, :] = np.clip(r[y - 1, :] + r[y, :], COEFF_MIN, COEFF_MAX)
    else:
        for x in range(1, r.shape[1]):
            r[:, x] = np.clip(r[:, x - 1] + r[:, x], COEFF_MIN, COEFF_MAX)
    return r.astype(np.int32)
