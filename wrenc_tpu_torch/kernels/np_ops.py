"""NumPy twins of the batched kernels, used by the wavefront commit pass.

The commit pass runs many small variable-size batches (one per dependency
rank x block size); doing it in vectorized NumPy avoids a jit recompile per
batch shape while staying bit-exact with the spec model (same integer
formulas as kernels/{transforms,quantize}.py).
"""
import numpy as np

from ..core import tables
from . import intra_mats, quantize as kq


def predict_modes_np(v, mode_ids, size, c_idx):
    """Single-mode batched prediction: v (N, 2L) int, mode_ids (N,)."""
    m = intra_mats.build_mode_matrices(size, c_idx)
    W1 = m["W1"][mode_ids].astype(np.int64)      # (N, 2L, WH)
    x1 = np.einsum('nl,nlp->np', v.astype(np.int64), W1)
    p1 = (x1 + m["c1"][mode_ids][:, None]) >> m["s1"][mode_ids][:, None]
    p1 = np.where(m["clamp1"][mode_ids][:, None], np.clip(p1, 0, 255), p1)
    W2 = m["W2"][mode_ids].astype(np.int64)
    x2 = np.einsum('nl,nlp->np', v.astype(np.int64), W2)
    p2 = (x2 + m["B2"][mode_ids] * p1 + 32) >> 6
    return np.clip(p2, 0, 255).astype(np.int32)


def forward_dct2_np(res):
    n = res.shape[-1]
    log2n = n.bit_length() - 1
    t = tables.dct2_matrix(n).astype(np.int64)
    h = np.einsum('nyx,ix->nyi', res.astype(np.int64), t)
    s1 = log2n - 1
    h = (h + (1 << (s1 - 1))) >> s1
    c = np.einsum('nyi,jy->nji', h, t)
    s2 = log2n + 6
    return ((c + (1 << (s2 - 1))) >> s2).astype(np.int32)


def inverse_dct2_np(coeffs):
    n = coeffs.shape[-1]
    t = tables.dct2_matrix(n).astype(np.int64)
    v = np.einsum('nix,iy->nyx', coeffs.astype(np.int64), t)
    v = np.clip((v + 64) >> 7, -(1 << 15), (1 << 15) - 1)
    r = np.einsum('nyi,ix->nyx', v, t)
    return ((r + (1 << 11)) >> 12).astype(np.int32)


def dequantize_np(q, ls, bd_shift):
    bd_offset = (1 << bd_shift) >> 1
    d = (q.astype(np.int64) * ls + bd_offset) >> bd_shift
    return np.clip(d, -(1 << 15), (1 << 15) - 1).astype(np.int32)


def _cand_costs(tc, a, delta, ls, bd_shift, bd_offset, trailing, lam_dq):
    mag = np.where(a == 0, 0, 2 * a - delta)
    dq = (mag * ls + bd_offset) >> bd_shift
    dist = np.abs(np.abs(tc) - dq)
    bits = np.where((a == 0) & trailing, 0, a + 1)
    return 128 * dist + lam_dq[np.clip(bits, 0, 1023)].astype(np.int64), mag


def greedy_depquant_np(t, ls, bd_shift, lam_dq, log2_n):
    """Batched greedy dependent quantization -> stored q levels (B,n,n)."""
    B = t.shape[0]
    order = np.asarray(kq.coding_order(log2_n))
    tf = t.reshape(B, -1)[:, order].astype(np.int64)
    bd_offset = (1 << bd_shift) >> 1
    trans = tables.Q_STATE_TRANS
    q_state = np.zeros(B, dtype=np.int64)
    trailing = np.ones(B, dtype=bool)
    out = np.zeros_like(tf)
    for p in range(tf.shape[1]):
        tc = tf[:, p]
        delta = (q_state > 1).astype(np.int64)
        s_ = (np.abs(tc) << bd_shift) + np.where(tc < 0, bd_offset, -bd_offset)
        a0 = (s_ // ls + delta) // 2
        c0, m0 = _cand_costs(tc, a0, delta, ls, bd_shift, bd_offset,
                             trailing, lam_dq)
        c1, m1 = _cand_costs(tc, a0 + 1, delta, ls, bd_shift, bd_offset,
                             trailing, lam_dq)
        pick1 = c1 < c0
        a = np.where(tc == 0, 0, np.where(pick1, a0 + 1, a0))
        mag = np.where(tc == 0, 0, np.where(pick1, m1, m0))
        out[:, p] = np.where(tc < 0, -mag, mag)
        trailing &= a == 0
        q_state = trans[q_state, a & 1]
    q = np.zeros((B, (1 << log2_n) ** 2), dtype=np.int64)
    q[:, order] = out
    return q.reshape(t.shape).astype(np.int16)


def trellis_depquant_np(t, ls, bd_shift, lam_dq, log2_n):
    """Batched exact 8-state Viterbi (q_state x trailing), numpy."""
    B = t.shape[0]
    order = np.asarray(kq.coding_order(log2_n))
    P = len(order)
    tf = t.reshape(B, -1)[:, order].astype(np.int64)
    bd_offset = (1 << bd_shift) >> 1
    trans = tables.Q_STATE_TRANS
    BIG = np.int64(1) << 50
    q_states = (np.arange(8) >> 1).astype(np.int64)[None, :]
    trailing_s = (np.arange(8) & 1).astype(bool)[None, :]
    cost = np.full((B, 8), BIG, dtype=np.int64)
    cost[:, 1] = 0
    bp_prev = np.zeros((B, P, 8), dtype=np.int8)
    bp_mag = np.zeros((B, P, 8), dtype=np.int32)

    for p in range(P):
        tc = tf[:, p][:, None]
        is_dc = (p == P - 1)
        delta = (q_states > 1).astype(np.int64)
        s_ = (np.abs(tc) << bd_shift) + np.where(tc < 0, bd_offset, -bd_offset)
        a0 = (s_ // ls + delta) // 2
        new_cost = np.full((B, 8), BIG, dtype=np.int64)
        nb_prev = np.zeros((B, 8), dtype=np.int8)
        nb_mag = np.zeros((B, 8), dtype=np.int32)
        zero = tc == 0
        rows = np.arange(B)
        cands = []
        for k in (0, 1):
            a = np.where(zero, 0, a0 + k)
            mag = np.where(a == 0, 0, 2 * a - delta)
            dq = (mag * ls + bd_offset) >> bd_shift
            dist = np.abs(np.abs(tc) - dq)
            bits = np.where((a == 0) & trailing_s, 0, a + 1)
            c = 128 * dist + lam_dq[np.clip(bits, 0, 1023)].astype(np.int64)
            if is_dc:
                c = c - np.where(trailing_s & (a == 0), int(lam_dq[1]), 0)
            if k == 1:
                c = np.where(zero, BIG, c)
            nstate = trans[np.broadcast_to(q_states, a.shape), a & 1] * 2 + \
                (trailing_s & (a == 0)).astype(np.int64)
            total = cost + c
            smag = np.where(tc < 0, -mag, mag).astype(np.int32)
            cands.append((total, nstate, smag))
        # relax order matters on TIES: source state OUTER / k INNER with
        # strict <, matching spec/quant.py, wrenc_native.cpp and the JAX
        # kernels — the first (src, k) in that order wins
        for src in range(8):
            for total, nstate, smag in cands:
                dst = nstate[:, src]
                tot = total[:, src]
                cur = new_cost[rows, dst]
                upd = tot < cur
                new_cost[rows[upd], dst[upd]] = tot[upd]
                nb_prev[rows[upd], dst[upd]] = src
                nb_mag[rows[upd], dst[upd]] = smag[upd, src]
        bp_prev[:, p] = nb_prev
        bp_mag[:, p] = nb_mag
        cost = new_cost - new_cost.min(axis=1, keepdims=True)

    state = np.argmin(cost, axis=1)
    out = np.zeros((B, P), dtype=np.int64)
    rows = np.arange(B)
    for p in range(P - 1, -1, -1):
        out[:, p] = bp_mag[rows, p, state]
        state = bp_prev[rows, p, state]
    q = np.zeros((B, (1 << log2_n) ** 2), dtype=np.int64)
    q[:, order] = out
    return q.reshape(t.shape).astype(np.int16)


# --------------------------------------------------------------- CCLM batch
def _ilog2_np(v):
    """floor(log2(v)) for int arrays (v >= 1); 0 where v == 0."""
    v = np.asarray(v, dtype=np.int64)
    e = np.frexp(np.maximum(v, 1).astype(np.float64))[1] - 1
    return e.astype(np.int64)


def predict_cclm_np(mode, luma, chroma, xs, ys, cs, masks, ctu_size=32):
    """Batched bit-exact CCLM prediction (spec/intra.py predict_cclm;
    intra_predictor.rs:1604). One mode (81/82/83) for the whole batch.

    luma/chroma: full planes (int arrays). (xs, ys): chroma positions of B
    same-size cs x cs blocks. masks: (B, 4*cs+1) availability rows from
    refs.avail_masks (corner, left 0..2cs-1, above 0..2cs-1) — for
    QT-aligned geometry these decide the same 4x4 cells the spec's
    luma-domain checks hit, so they are equivalent. Requires cs >= 4 (true
    for every chroma block in this encoder: min chroma CB is 4x4), which
    makes the spec's two-point fallback (cnt == 2) unreachable.
    """
    assert cs >= 4, "cs < 4 would need the spec's 2-point fallback"
    luma = np.asarray(luma, dtype=np.int64)
    chroma = np.asarray(chroma, dtype=np.int64)
    H, W = luma.shape
    xs = np.asarray(xs, dtype=np.int64)
    ys = np.asarray(ys, dtype=np.int64)
    B = len(xs)
    lx, ly = 2 * xs, 2 * ys
    tw = th = cs

    avail_l = masks[:, 1].astype(bool)
    avail_t = masks[:, 1 + 2 * cs].astype(bool)
    # contiguous available run lengths of the extended refs (spec's loop
    # breaks at the first unavailable sample)
    nbl = np.cumprod(masks[:, 1 + cs:1 + 2 * cs], axis=1).sum(1)
    ntr = np.cumprod(masks[:, 1 + 3 * cs:1 + 4 * cs], axis=1).sum(1)

    if mode == 81:
        num_t = np.where(avail_t, tw, 0)
        num_l = np.where(avail_l, th, 0)
    elif mode == 83:
        num_t = np.where(avail_t, tw + np.minimum(ntr, th), 0)
        num_l = np.zeros(B, dtype=np.int64)
    else:  # 82
        num_t = np.zeros(B, dtype=np.int64)
        num_l = np.where(avail_l, th + np.minimum(nbl, tw), 0)
    empty = (num_t == 0) & (num_l == 0)
    num4 = (~(avail_t & avail_l & (mode == 81))).astype(np.int64)

    def picks(num):
        start = num >> (2 + num4)
        step = np.maximum(num >> (1 + num4), 1)
        cnt = np.minimum((1 + num4) << 1, num)
        j = np.arange(4)[None, :]
        return cnt, start[:, None] + j * step[:, None]

    cnt_t, pick_t = picks(num_t)
    cnt_l, pick_l = picks(num_l)

    def gl(yy, xx):
        return luma[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)]

    # downsampled co-located luma (6-tap, non-collocated chroma siting);
    # left column replicates column 0 when the left neighbour is missing
    xg = np.arange(cs)[None, :]
    yg = np.arange(cs)[:, None]
    xc = lx[:, None, None] + 2 * xg[None]
    xm = xc - 1
    xm0 = np.where(avail_l, lx - 1, lx)
    xm = np.where(xg[None] == 0, xm0[:, None, None], xm)
    xr = xc + 1
    r0 = ly[:, None, None] + 2 * yg[None]
    r1 = r0 + 1
    p_ds = (gl(r0, xm) + gl(r1, xm) + 2 * gl(r0, xc) + 2 * gl(r1, xc)
            + gl(r0, xr) + gl(r1, xr) + 4) >> 3

    # selected neighbour pairs (top picks then left picks; cnt sums to 4)
    p = pick_t
    txc = lx[:, None] + 2 * p
    txm = np.where((p > 0) | avail_l[:, None], txc - 1, lx[:, None])
    txr = txc + 1
    ra = (ly - 1)[:, None]
    rb = (ly - 2)[:, None]
    ctu_b = ((ly & (ctu_size - 1)) == 0)[:, None]
    sel_norm = (gl(ra, txm) + gl(rb, txm) + 2 * gl(ra, txc) + 2 * gl(rb, txc)
                + gl(ra, txr) + gl(rb, txr) + 4) >> 3
    sel_bdry = (gl(ra, txm) + 2 * gl(ra, txc) + gl(ra, txr) + 2) >> 2
    sel_y_t = np.where(ctu_b, sel_bdry, sel_norm)
    sel_c_t = chroma[np.clip(ys - 1, 0, None)[:, None],
                     np.clip(xs[:, None] + p, 0, W // 2 - 1)]

    q = pick_l
    lr0 = ly[:, None] + 2 * q
    lr1 = lr0 + 1
    c1_ = np.clip(lx - 1, 0, None)[:, None]
    c2_ = np.clip(lx - 2, 0, None)[:, None]
    c3_ = np.clip(lx - 3, 0, None)[:, None]
    sel_y_l = (gl(lr0, c3_) + gl(lr1, c3_) + 2 * gl(lr0, c2_)
               + 2 * gl(lr1, c2_) + gl(lr0, c1_) + gl(lr1, c1_) + 4) >> 3
    sel_c_l = chroma[np.clip(ys[:, None] + q, 0, H // 2 - 1),
                     np.clip(xs - 1, 0, None)[:, None]]

    j = np.arange(4)[None, :]
    from_top = j < cnt_t[:, None]
    li = np.clip(j - cnt_t[:, None], 0, 3)
    rows = np.arange(B)[:, None]
    sel_y = np.where(from_top, sel_y_t, sel_y_l[rows, li])
    sel_c = np.where(from_top, sel_c_t, sel_c_l[rows, li])

    # 4-point min/max network (exact comparison/swap order of the spec)
    mn0 = np.zeros(B, dtype=np.int64)
    mn1 = np.full(B, 2, dtype=np.int64)
    mx0 = np.ones(B, dtype=np.int64)
    mx1 = np.full(B, 3, dtype=np.int64)
    r = np.arange(B)

    def g(idx):
        return sel_y[r, idx]

    sw = g(mn0) > g(mn1)
    mn0, mn1 = np.where(sw, mn1, mn0), np.where(sw, mn0, mn1)
    sw = g(mx0) > g(mx1)
    mx0, mx1 = np.where(sw, mx1, mx0), np.where(sw, mx0, mx1)
    sw = g(mn0) > g(mx1)
    mn0, mx0 = np.where(sw, mx0, mn0), np.where(sw, mn0, mx0)
    mn1, mx1 = np.where(sw, mx1, mn1), np.where(sw, mn1, mx1)
    sw = g(mn1) > g(mx0)
    mn1, mx0 = np.where(sw, mx0, mn1), np.where(sw, mn1, mx0)

    max_y = (g(mx0) + g(mx1) + 1) >> 1
    max_c = (sel_c[r, mx0] + sel_c[r, mx1] + 1) >> 1
    min_y = (g(mn0) + g(mn1) + 1) >> 1
    min_c = (sel_c[r, mn0] + sel_c[r, mn1] + 1) >> 1

    diff = max_y - min_y
    diff_c = max_c - min_c
    x_ = _ilog2_np(diff)
    norm = ((diff << 4) >> np.maximum(x_, 0)) & 15
    x_ = x_ + (norm != 0)
    y_ = np.where(np.abs(diff_c) > 0, _ilog2_np(np.abs(diff_c)) + 1, 0)
    y_s = np.maximum(y_, 1)
    tbl = tables.CCLM_DIV_SIG_TABLE[norm].astype(np.int64) | 8
    a0 = np.where(diff_c == 0, 0,
                  (diff_c * tbl + (1 << np.maximum(y_ - 1, 0))) >> y_s)
    low_k = (3 + x_ - y_) < 1
    a = np.where(low_k, np.sign(a0) * 15, a0)
    k = np.where(low_k, 1, 3 + x_ - y_)
    b = min_c - ((a * min_y) >> k)
    a = np.where(diff == 0, 0, a)
    k = np.where(diff == 0, 0, k)
    b = np.where(diff == 0, min_c, b)

    pred = ((p_ds * a[:, None, None]) >> k[:, None, None]) + b[:, None, None]
    pred = np.clip(pred, 0, 255)
    return np.where(empty[:, None, None], 128, pred).astype(np.int32)
