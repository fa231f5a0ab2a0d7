"""Intra prediction: reference samples, PLANAR/DC/angular + PDPC, CCLM.

Spec 8.4.5.2; behavioural reference: intra_predictor.rs (ref-sample gather/
substitution/filter :146-353, PDPC :355, planar :759, DC :1148, angular
:1287, CCLM :1604). Operating point: 8-bit, 4:2:0, MRL/ISP/MIP/BDPCM off
(ref_idx always 0), square blocks (QT-only partitioning).

All functions take the reconstruction plane for the component plus an
`Availability` oracle working in luma coordinates.
"""
import numpy as np

from ..core.tables import (INTRA_ANGLE_TABLE, F_C, F_G, PDPC_WEIGHTS,
                           CCLM_DIV_SIG_TABLE)

# modes whose reference samples get the [1 2 1] smoothing filter
_REF_FILTER_MODES = frozenset([0, -14, -12, -10, -6, 2, 34, 66, 72, 76, 78, 80])


def _ilog2(v):
    return int(v).bit_length() - 1


def wide_angle_map(mode, nw, nh):
    """Wide-angle intra prediction mode mapping (spec 8.4.5.2.7)."""
    if nw == nh:
        return mode
    ratio = abs(_ilog2(nw) - _ilog2(nh))
    if nw > nh and 2 <= mode < (8 + 2 * ratio if ratio > 1 else 8):
        return mode + 65
    if nh > nw and mode <= 66 and mode > (60 - 2 * ratio if ratio > 1 else 60):
        return mode - 67
    return mode


def gather_ref_samples(recon, cx, cy, tw, th, luma_pos, luma_size, avail,
                       c_idx, bit_depth=8):
    """Reference-sample availability marking + substitution (8.4.5.2.8).

    recon: component plane; (cx, cy): component-domain block position;
    (tw, th): component-domain block size; luma_pos/luma_size: the block in
    luma coordinates for availability checks.

    Returns (left, above): left has ref_h+1 entries (index 0 = corner
    p[-1][-1], index 1+k = p[-1][k]); above has ref_w entries (above[k] =
    p[k][-1]).
    """
    ref_w, ref_h = 2 * tw, 2 * th
    shift = 1 if c_idx != 0 else 0
    lx, ly = luma_pos
    lw, lh = luma_size

    left = np.full(ref_h + 1, -1, dtype=np.int32)
    above = np.full(ref_w, -1, dtype=np.int32)

    # left column x = cx-1, y = cy-1 .. cy+ref_h-1
    for k in range(ref_h + 1):
        ny = cy - 1 + k
        nx = cx - 1
        if avail.available(lx, ly, nx << shift, ny << shift):
            left[k] = recon[ny, nx]
    # above row y = cy-1, x = cx .. cx+ref_w-1
    for k in range(ref_w):
        ny = cy - 1
        nx = cx + k
        if avail.available(lx, ly, nx << shift, ny << shift):
            above[k] = recon[ny, nx]

    if (left < 0).all() and (above < 0).all():
        fill = 1 << (bit_depth - 1)
        left[:] = fill
        above[:] = fill
    else:
        if left[-1] < 0:
            # search upward in left, then left-to-right in above
            found = False
            for i in range(len(left) - 2, -1, -1):
                if left[i] >= 0:
                    left[-1] = left[i]
                    found = True
                    break
            if not found:
                for v in above:
                    if v >= 0:
                        left[-1] = v
                        break
        for i in range(len(left) - 2, -1, -1):
            if left[i] < 0:
                left[i] = left[i + 1]
    if above[0] < 0:
        above[0] = left[0]
    for i in range(1, len(above)):
        if above[i] < 0:
            above[i] = above[i - 1]
    return left, above


def filter_ref_samples(left, above, tw, th, c_idx, mode):
    """[1 2 1] reference smoothing (8.4.5.2.10). Returns (possibly new)
    (left, above) arrays."""
    ref_w, ref_h = 2 * tw, 2 * th
    do = (tw * th > 32 and c_idx == 0 and mode in _REF_FILTER_MODES)
    if not do:
        return left, above
    lf = np.empty_like(left)
    af = np.empty_like(above)
    lf[0] = (left[1] + 2 * left[0] + above[0] + 2) >> 2
    for y in range(ref_h - 1):
        lf[1 + y] = (left[2 + y] + 2 * left[1 + y] + left[y] + 2) >> 2
    lf[ref_h] = left[ref_h]
    af[0] = (left[0] + 2 * above[0] + above[1] + 2) >> 2
    for x in range(ref_w - 2):
        af[1 + x] = (above[x] + 2 * above[x + 1] + above[x + 2] + 2) >> 2
    af[ref_w - 1] = above[ref_w - 1]
    return lf, af


def _pdpc(pred, mode, inv_angle, left, above, corner, tw, th):
    """Position-dependent prediction combination (8.4.5.2.15).

    left: th+ samples p[-1][y]; above: tw+ samples p[x][-1]; corner p[-1][-1].
    Mutates and returns `pred` (int32 array).
    """
    log2w, log2h = _ilog2(tw), _ilog2(th)
    xs = np.arange(tw)
    ys = np.arange(th)
    if mode > 50:
        ns = min(2, log2h - _ilog2(3 * inv_angle - 2) + 8)
    elif 1 < mode < 18:
        ns = min(2, log2w - _ilog2(3 * inv_angle - 2) + 8)
    else:
        ns = (log2w + log2h - 2) >> 2

    zeros_w = np.zeros(tw, dtype=np.int64)
    zeros_h = np.zeros(th, dtype=np.int64)
    if mode < 2:
        ref_l = np.broadcast_to(left[:th, None], (th, tw)).astype(np.int64)
        ref_t = np.broadcast_to(above[None, :tw], (th, tw)).astype(np.int64)
        wl = PDPC_WEIGHTS[ns, :tw].astype(np.int64)
        wt = PDPC_WEIGHTS[ns, :th].astype(np.int64)
    elif mode in (18, 50):
        ref_l = (left[:th, None] - corner + pred).astype(np.int64)
        ref_t = (above[None, :tw] - corner + pred).astype(np.int64)
        wl = PDPC_WEIGHTS[ns, :tw].astype(np.int64) if mode == 50 else zeros_w
        wt = PDPC_WEIGHTS[ns, :th].astype(np.int64) if mode == 18 else zeros_h
    elif mode < 18 and ns >= 0:
        dx_int = ((ys + 1) * inv_angle + 256) >> 9
        dx = xs[None, :] + dx_int[:, None]
        ref_t = np.where(ys[:, None] < (3 << ns),
                         above[np.minimum(dx, len(above) - 1)], 0).astype(np.int64)
        ref_l = np.zeros((th, tw), dtype=np.int64)
        wl = zeros_w
        wt = PDPC_WEIGHTS[ns, :th].astype(np.int64)
    elif mode > 50 and ns >= 0:
        dy_int = ((xs + 1) * inv_angle + 256) >> 9
        dy = ys[:, None] + dy_int[None, :]
        ref_l = np.where(xs[None, :] < (3 << ns),
                         left[np.minimum(dy, len(left) - 1)], 0).astype(np.int64)
        ref_t = np.zeros((th, tw), dtype=np.int64)
        wl = PDPC_WEIGHTS[ns, :tw].astype(np.int64)
        wt = zeros_h
    else:
        return pred

    p = (ref_l * wl[None, :] + ref_t * wt[:, None]
         + (64 - wt[:, None] - wl[None, :]) * pred + 32) >> 6
    return np.clip(p, 0, 255).astype(np.int32)


def predict_planar(left, above, tw, th, apply_pdpc=True):
    """PLANAR prediction (8.4.5.2.5) + PDPC. left/above are the filtered
    reference arrays from gather/filter (left[0] = corner)."""
    l = left[1:].astype(np.int64)   # p[-1][y]
    a = above.astype(np.int64)      # p[x][-1]
    log2w, log2h = _ilog2(tw), _ilog2(th)
    xs = np.arange(tw, dtype=np.int64)
    ys = np.arange(th, dtype=np.int64)
    pv = ((th - 1 - ys)[:, None] * a[None, :tw] + (ys + 1)[:, None] * l[th]) << log2w
    ph = ((tw - 1 - xs)[None, :] * l[:th, None] + (xs + 1)[None, :] * a[tw]) << log2h
    pred = ((pv + ph + (tw * th)) >> (log2w + log2h + 1)).astype(np.int32)
    if apply_pdpc and tw >= 4 and th >= 4:
        pred = _pdpc(pred, 0, 0, l, a, left[0], tw, th)
    return pred


def predict_dc(left, above, tw, th, apply_pdpc=True):
    """DC prediction (8.4.5.2.3) + PDPC."""
    l = left[1:1 + th].astype(np.int64)
    a = above[:tw].astype(np.int64)
    if tw == th:
        dc = (int(a.sum() + l.sum()) + tw) >> (_ilog2(tw) + 1)
    elif tw > th:
        dc = (int(a.sum()) + (tw >> 1)) >> _ilog2(tw)
    else:
        dc = (int(l.sum()) + (th >> 1)) >> _ilog2(th)
    pred = np.full((th, tw), dc, dtype=np.int32)
    if apply_pdpc and tw >= 4 and th >= 4:
        pred = _pdpc(pred, 1, 0, l, a, left[0], tw, th)
    return pred


def predict_angular(left, above, tw, th, mode, c_idx, apply_pdpc=True):
    """Angular prediction (8.4.5.2.12) + PDPC.

    `mode` is the (possibly wide-angle-mapped) prediction mode in [-14..80].
    left/above are the (filtered) reference arrays; left[0] = corner.
    """
    corner = int(left[0])
    lrs = left      # corner-inclusive: lrs[k] = p[-1][k-1]
    ars = above     # ars[x] = p[x][-1]
    ref_w, ref_h = 2 * tw, 2 * th

    angle = int(INTRA_ANGLE_TABLE[14 + mode])
    if angle > 0:
        inv_angle = (512 * 32 + angle // 2) // angle
    elif angle < 0:
        inv_angle = -((512 * 32 + (-angle) // 2) // (-angle))
    else:
        inv_angle = 0

    filter_flag = _angular_filter_flag(mode, tw, th, c_idx)

    pred = np.zeros((th, tw), dtype=np.int32)
    if mode >= 34:
        # main reference = above row (+ corner), extended
        refx = [corner] + [int(ars[x]) for x in range(tw + 1)]
        if angle < 0:
            ext = []
            for x in range(-th, 0):
                idx = min((x * inv_angle + 256) >> 9, th)
                ext.append(int(lrs[idx]))
            refx = refx + ext  # negative indices wrap to the end
        else:
            for x in range(tw + 2, ref_w):
                refx.append(int(ars[x - 1]))
            for _ in range(3):
                refx.append(int(ars[ref_w - 1]))
        refx = np.array(refx, dtype=np.int64)
        n = len(refx)
        for y in range(th):
            i_idx = ((y + 1) * angle) >> 5
            i_fact = ((y + 1) * angle) & 31
            idx = np.arange(tw) + i_idx
            if c_idx == 0:
                f = (F_G if filter_flag else F_C)[i_fact].astype(np.int64)
                s = sum(f[i] * refx[(idx + i) % n] for i in range(4))
                pred[y] = np.clip((s + 32) >> 6, 0, 255)
            elif i_fact != 0:
                s = ((32 - i_fact) * refx[(idx + 1) % n]
                     + i_fact * refx[(idx + 2) % n] + 16) >> 5
                pred[y] = s
            else:
                pred[y] = refx[(idx + 1) % n]
    else:
        # main reference = left column (corner-inclusive), extended
        refx = [int(lrs[x]) for x in range(th + 2)]
        if angle < 0:
            ext = []
            for x in range(-tw, 0):
                idx = min((x * inv_angle + 256) >> 9, tw)
                ext.append(corner if idx == 0 else int(ars[idx - 1]))
            refx = refx + ext
        else:
            for x in range(th + 2, ref_h + 1):
                refx.append(int(lrs[x]))
            for _ in range(2):
                refx.append(int(lrs[ref_h]))
        refx = np.array(refx, dtype=np.int64)
        n = len(refx)
        for x in range(tw):
            i_idx = ((x + 1) * angle) >> 5
            i_fact = ((x + 1) * angle) & 31
            idx = np.arange(th) + i_idx
            if c_idx == 0:
                f = (F_G if filter_flag else F_C)[i_fact].astype(np.int64)
                s = sum(f[i] * refx[(idx + i) % n] for i in range(4))
                pred[:, x] = np.clip((s + 32) >> 6, 0, 255)
            elif i_fact != 0:
                s = ((32 - i_fact) * refx[(idx + 1) % n]
                     + i_fact * refx[(idx + 2) % n] + 16) >> 5
                pred[:, x] = s
            else:
                pred[:, x] = refx[(idx + 1) % n]

    if apply_pdpc and tw >= 4 and th >= 4 and (mode <= 18 or 50 <= mode < 81):
        pred = _pdpc(pred, mode, inv_angle, lrs[1:], ars, corner, tw, th)
    return pred


def _angular_filter_flag(mode, tw, th, c_idx):
    """Interpolation-filter switch fG vs fC (intra_predictor.rs:1364-1387)."""
    if mode in _REF_FILTER_MODES or c_idx != 0:
        return False
    n_tb_s = (_ilog2(tw) + _ilog2(th)) >> 1
    min_dist = min(abs(mode - 50), abs(mode - 18))
    thres = {2: 24, 3: 14, 4: 2, 5: 0, 6: 0}[n_tb_s]
    return min_dist > thres


def predict(mode, left, above, tw, th, c_idx):
    """Dispatch PLANAR/DC/angular for (already filtered) reference arrays."""
    if mode == 0:
        return predict_planar(left, above, tw, th)
    if mode == 1:
        return predict_dc(left, above, tw, th)
    return predict_angular(left, above, tw, th, mode, c_idx)


def predict_block(recon, cx, cy, tw, th, luma_pos, luma_size, avail, c_idx,
                  mode):
    """Full non-CCLM intra prediction for one block: gather + substitute +
    filter reference samples, predict, PDPC. `mode` is the signalled mode
    (wide-angle mapping is applied internally; square blocks are identity).
    """
    left, above = gather_ref_samples(recon, cx, cy, tw, th, luma_pos,
                                     luma_size, avail, c_idx)
    m = mode if mode <= 1 else wide_angle_map(mode, tw, th)
    left, above = filter_ref_samples(left, above, tw, th, c_idx, m)
    return predict(m, left, above, tw, th, c_idx)


def predict_cclm(mode, recon_luma, recon_chroma, cx, cy, tw, th, luma_pos,
                 avail, ctu_size=32, bit_depth=8):
    """CCLM prediction (8.4.5.2.13/14), 4:2:0 non-collocated filters.

    mode: 81 (LT), 82 (L), 83 (T). recon_luma: full luma plane;
    recon_chroma: the chroma plane being predicted; (cx, cy, tw, th) in
    chroma coordinates; luma_pos = (lx, ly) of the block.
    """
    lx, ly = luma_pos
    lw, lh = 2 * tw, 2 * th
    H, W = recon_luma.shape

    avail_l = avail.available(lx, ly, lx - 1, ly)
    avail_t = avail.available(lx, ly, lx, ly - 1)

    num_top_right = 0
    if mode == 83:
        ok = True
        for x in range(tw, 2 * tw):
            ok = ok and avail.available(lx, ly, lx + x * 2, ly - 1)
            if not ok:
                break
            num_top_right += 1
    num_below_left = 0
    if mode == 82:
        ok = True
        for y in range(th, 2 * th):
            ok = ok and avail.available(lx, ly, lx - 1, ly + y * 2)
            if not ok:
                break
            num_below_left += 1

    if mode == 81:
        num_samp_t = tw if avail_t else 0
        num_samp_l = th if avail_l else 0
    else:
        num_samp_t = (tw + min(num_top_right, th)) if (avail_t and mode == 83) else 0
        num_samp_l = (th + min(num_below_left, tw)) if (avail_l and mode == 82) else 0

    if num_samp_l == 0 and num_samp_t == 0:
        return np.full((th, tw), 1 << (bit_depth - 1), dtype=np.int32)

    b_ctu_boundary = (ly & (ctu_size - 1)) == 0
    num_is_4 = not (avail_t and avail_l and mode == 81)

    def picks(num_samp):
        start = num_samp >> (2 + (1 if num_is_4 else 0))
        step = max(num_samp >> (1 + (1 if num_is_4 else 0)), 1)
        cnt = min((1 + (1 if num_is_4 else 0)) << 1, num_samp)
        return cnt, [start + p * step for p in range(cnt)]

    cnt_t, pick_t = picks(num_samp_t) if (avail_t and mode in (81, 83)) else (0, [])
    cnt_l, pick_l = picks(num_samp_l) if (avail_l and mode in (81, 82)) else (0, [])

    # padded luma neighbourhood, offset 3
    ph_, pw_ = lh + lw + 3, lw + lh + 3
    p_y = np.zeros((ph_ + 4, pw_ + 4), dtype=np.int64)
    o = 3

    def safe_luma(yy, xx):
        return int(recon_luma[min(max(yy, 0), H - 1), min(max(xx, 0), W - 1)])

    for y in range(lh):
        for x in range(lw):
            p_y[y + o, x + o] = recon_luma[ly + y, lx + x]
    if avail_l:
        y0 = -1 if avail_t else 0
        for y in range(y0, 2 * max(num_samp_l, th)):
            for x in (-3, -2, -1):
                p_y[y + o, x + o] = safe_luma(ly + y, lx + x)
    if not avail_t:
        for y in (-2, -1):
            for x in range(-2, lw):
                p_y[y + o, x + o] = p_y[o, x + o]
    if avail_t:
        for y in (-3, -2, -1):
            x0 = -1 if avail_l else 0
            for x in range(x0, 2 * max(num_samp_t, tw)):
                p_y[y + o, x + o] = safe_luma(ly + y, lx + x)
    if not avail_l:
        for y in range(-2, 2 * th):
            p_y[y + o, -1 + o] = p_y[y + o, o]

    # downsample co-located luma (chroma_vertical/horizontal_collocated=false)
    p_ds = np.zeros((th, tw), dtype=np.int64)
    for y in range(th):
        for x in range(tw):
            sx, sy = 2 * x + o, 2 * y + o
            p_ds[y, x] = (p_y[sy, sx - 1] + p_y[sy + 1, sx - 1]
                          + 2 * p_y[sy, sx] + 2 * p_y[sy + 1, sx]
                          + p_y[sy, sx + 1] + p_y[sy + 1, sx + 1] + 4) >> 3

    sel_y = np.zeros(max(cnt_t + cnt_l, 4), dtype=np.int64)
    sel_c = np.zeros(max(cnt_t + cnt_l, 4), dtype=np.int64)
    for i in range(cnt_t):
        x = pick_t[i]
        sel_c[i] = recon_chroma[cy - 1, cx + x]
        sx = 2 * x + o
        if not b_ctu_boundary:
            sel_y[i] = (p_y[o - 1, sx - 1] + p_y[o - 2, sx - 1]
                        + 2 * p_y[o - 1, sx] + 2 * p_y[o - 2, sx]
                        + p_y[o - 1, sx + 1] + p_y[o - 2, sx + 1] + 4) >> 3
        else:
            sel_y[i] = (p_y[o - 1, sx - 1] + 2 * p_y[o - 1, sx]
                        + p_y[o - 1, sx + 1] + 2) >> 2
    for i in range(cnt_l):
        y = pick_l[i]
        sel_c[cnt_t + i] = recon_chroma[cy + y, cx - 1]
        sx, sy = -2 + o, 2 * y + o
        sel_y[cnt_t + i] = (p_y[sy, sx - 1] + p_y[sy + 1, sx - 1]
                            + 2 * p_y[sy, sx] + 2 * p_y[sy + 1, sx]
                            + p_y[sy, sx + 1] + p_y[sy + 1, sx + 1] + 4) >> 3

    if cnt_t + cnt_l == 2:
        sel_y[0], sel_y[1], sel_y[2], sel_y[3] = sel_y[1], sel_y[3], sel_y[1], sel_y[0]
        sel_c[0], sel_c[1], sel_c[2], sel_c[3] = sel_c[1], sel_c[3], sel_c[1], sel_c[0]

    mn = [0, 2]
    mx = [1, 3]
    if sel_y[mn[0]] > sel_y[mn[1]]:
        mn = [mn[1], mn[0]]
    if sel_y[mx[0]] > sel_y[mx[1]]:
        mx = [mx[1], mx[0]]
    if sel_y[mn[0]] > sel_y[mx[1]]:
        mn, mx = mx, mn
    if sel_y[mn[1]] > sel_y[mx[0]]:
        mn[1], mx[0] = mx[0], mn[1]
    max_y = (int(sel_y[mx[0]]) + int(sel_y[mx[1]]) + 1) >> 1
    max_c = (int(sel_c[mx[0]]) + int(sel_c[mx[1]]) + 1) >> 1
    min_y = (int(sel_y[mn[0]]) + int(sel_y[mn[1]]) + 1) >> 1
    min_c = (int(sel_c[mn[0]]) + int(sel_c[mn[1]]) + 1) >> 1

    diff = max_y - min_y
    if diff != 0:
        diff_c = max_c - min_c
        x_ = _ilog2(diff)
        norm_diff = ((diff << 4) >> x_) & 15
        x_ += 1 if norm_diff != 0 else 0
        y_ = (_ilog2(abs(diff_c)) + 1) if abs(diff_c) > 0 else 0
        if diff_c == 0:
            a = 0
        else:
            a = (diff_c * (int(CCLM_DIV_SIG_TABLE[norm_diff]) | 8)
                 + (1 << (y_ - 1))) >> y_
        if 3 + x_ - y_ < 1:
            k = 1
            a = -15 if a < 0 else (15 if a > 0 else 0)
        else:
            k = 3 + x_ - y_
        b = min_c - ((a * min_y) >> k)
    else:
        a, k, b = 0, 0, min_c

    pred = ((p_ds * a) >> k) + b
    return np.clip(pred, 0, 255).astype(np.int32)
