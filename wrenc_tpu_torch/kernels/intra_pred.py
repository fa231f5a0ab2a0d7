"""Batched intra prediction in PyTorch: the 67-mode sweep as two exact
f32 matmuls.

p  = clip((v @ W1 + c1) >> s1);  p' = clip((v @ W2 + B*p + 32) >> 6)

with v = [u, filter121(u)] per block. Counterpart of
wrenc_tpu/kernels/intra_pred.py (`mats_host_f32`, `predict_all_modes_m`,
`predict_modes_m`, `predict_modes`, `make_v`, and the CCLM pieces: the
strips of the device commit engine and the device chroma stage A,
`cclm_strips`, `cclm_cstrips`, `cclm_from_own`; the patches of the
apply-decisions commit, `predict_cclm`, `cclm_luma_patch`,
`cclm_chroma_patch`, `cclm_from_patches`; both share the pick rule
`_cclm_picks`, the tap combine `_cclm_from_taps` and the fit). Every
per-pixel sum is below 2^24, so f32 without TF32 is exact. The JAX module's one-hot
selects (`_sel_cols`, the reciprocal LUT) are a TPU workaround for slow
gathers; here they are plain gathers with the same results.
"""
import functools

import numpy as np
import torch

from . import intra_mats
from ..core import tables
from .transforms import f32mm


@functools.lru_cache(maxsize=None)
def mats_host_f32(size, c_idx):
    """Mode matrices with W1/W2 pre-cast to f32 (numpy, host)."""
    m = intra_mats.build_mode_matrices(size, c_idx)
    return {"W1": m["W1"].astype(np.float32),
            "W2": m["W2"].astype(np.float32),
            "c1": m["c1"], "s1": m["s1"], "clamp1": m["clamp1"],
            "B2": m["B2"]}


_MATS_DEV_CACHE = {}


def mats_device_f32(size, c_idx, device):
    """Device-resident mode matrices, uploaded once per process and device
    (~180 MB for the four luma sizes). W1/W2 are stored pre-flattened as
    (2L, 67*WH) so the sweep is one plain matmul per stage."""
    key = (size, c_idx, torch.device(device))
    if key not in _MATS_DEV_CACHE:
        m = mats_host_f32(size, c_idx)

        def flat(w):
            M, L2, WH = w.shape
            return torch.as_tensor(
                np.ascontiguousarray(w.transpose(1, 0, 2).reshape(L2, M * WH)),
                device=device)

        _MATS_DEV_CACHE[key] = {
            "W1": flat(m["W1"]), "W2": flat(m["W2"]),
            "c1": torch.as_tensor(m["c1"], device=device),
            "s1": torch.as_tensor(m["s1"], device=device),
            "clamp1": torch.as_tensor(m["clamp1"], device=device),
            "B2": torch.as_tensor(m["B2"], device=device)}
    return _MATS_DEV_CACHE[key]


def predict_all_modes_m(v, m, size):
    """67-mode sweep. v: (N, 2L) int32, m: from mats_device_f32 ->
    (N, 67, WH) int32."""
    N = v.shape[0]
    WH = size * size
    x1 = f32mm(v, m["W1"]).view(N, -1, WH)
    p1 = (x1 + m["c1"][None, :, None]) >> m["s1"][None, :, None]
    p1 = torch.where(m["clamp1"][None, :, None], torch.clamp(p1, 0, 255), p1)
    x2 = f32mm(v, m["W2"]).view(N, -1, WH)
    p2 = (x2 + m["B2"][None, :, :] * p1 + 32) >> 6
    return torch.clamp(p2, 0, 255)


def predict_modes_m(v, mode_ids, m):
    """Per-block single-mode prediction. v: (N, 2L) int32, mode_ids: (N,)
    int, m: from mats_device_f32 -> (N, WH) int32."""
    L2 = m["W1"].shape[0]
    WH = m["B2"].shape[1]
    ids = mode_ids.long()

    def per_mode(w):
        return w.view(L2, -1, WH)[:, ids].permute(1, 0, 2)   # (N, 2L, WH)
    x1 = f32mm(v[:, None, :], per_mode(m["W1"]))[:, 0]
    p1 = (x1 + m["c1"][ids][:, None]) >> m["s1"][ids][:, None]
    p1 = torch.where(m["clamp1"][ids][:, None], torch.clamp(p1, 0, 255), p1)
    x2 = f32mm(v[:, None, :], per_mode(m["W2"]))[:, 0]
    p2 = (x2 + m["B2"][ids] * p1 + 32) >> 6
    return torch.clamp(p2, 0, 255)


def make_v(u, size):
    """v = [u, filtered(u)] (N, 2L) int32 (host-side numpy)."""
    uf = intra_mats.filter_ref_vector(u, size)
    return np.concatenate([u, uf], axis=1).astype(np.int32)


def predict_modes(v, mode_ids, size, c_idx):
    """Per-block single-mode prediction: v (N, 2L) int32 tensor, mode_ids
    (N,) -> (N, WH) int32, with the mode matrices of (size, c_idx) on v's
    device."""
    return predict_modes_m(v, mode_ids, mats_device_f32(size, c_idx,
                                                        v.device))


def _ilog2_u8(v):
    """floor(log2(v)) for int tensors with 0 <= v <= 255 (0 -> 0), exact
    integer formulation (comparison ladder; no float log)."""
    v = torch.clamp(v, min=1)
    return sum((v >= (1 << b)).to(torch.int32) for b in range(1, 9))


def _sel_cols(row, px, PW):
    """row (B, PW), px (B, K) column picks -> (B, K); out-of-range picks
    yield 0 (only ever produced for unused pick slots)."""
    got = row.gather(1, px.clamp(0, PW - 1).long())
    return torch.where((px >= 0) & (px < PW), got, 0)


def cclm_strips(luma_flat, lx, ly, cs, H, W, bfl):
    """Thin boundary strips for cclm_from_own (B blocks): top strip
    (B, 2, 4cs+1) = plane rows ly-2/ly-1, cols lx-1 .. lx+4cs-1; left
    strip (B, 4cs, 3) = rows ly .. ly+4cs-1, cols lx-3 .. lx-1; lcol
    (B, 2cs) = col lx-1, rows ly .. ly+2cs-1 (the downsample's left
    taps). All edge-clipped like the spec's clamped reads. luma_flat:
    (F, H*W); bfl: (B,) frame of each block."""
    dev = lx.device
    bfl = bfl.long()
    TW = 4 * cs + 1
    tr = torch.clamp(ly[:, None] + torch.arange(2, device=dev)[None, :] - 2,
                     0, H - 1)
    tcl = torch.clamp(lx[:, None] + torch.arange(TW, device=dev)[None, :] - 1,
                      0, W - 1)
    tstrip = luma_flat[bfl[:, None, None],
                       (tr[:, :, None] * W + tcl[:, None, :]).long()]
    LH = 4 * cs
    lr = torch.clamp(ly[:, None] + torch.arange(LH, device=dev)[None, :],
                     0, H - 1)
    lcl = torch.clamp(lx[:, None] + torch.arange(3, device=dev)[None, :] - 3,
                      0, W - 1)
    lstrip = luma_flat[bfl[:, None, None],
                       (lr[:, :, None] * W + lcl[:, None, :]).long()]
    ccol = torch.clamp(lx - 1, 0, W - 1)
    rr = torch.clamp(ly[:, None] + torch.arange(2 * cs, device=dev)[None, :],
                     0, H - 1)
    lcol = luma_flat[bfl[:, None], (rr * W + ccol[:, None]).long()]
    return tstrip, lstrip, lcol


def cclm_cstrips(ch_flat, xs, ys, cs, hh, hw, bf):
    """Chroma boundary strips: top row ys-1 cols xs .. xs+2cs-1 and left
    col xs-1 rows ys .. ys+2cs-1, each (B, 2cs), edge-clipped."""
    dev = xs.device
    bf = bf.long()
    span = torch.arange(2 * cs, device=dev)[None, :]
    tcols = torch.clamp(xs[:, None] + span, 0, hw - 1)
    trow = torch.clamp(ys - 1, 0, hh - 1)
    ct = ch_flat[bf[:, None], (trow[:, None] * hw + tcols).long()]
    lrows = torch.clamp(ys[:, None] + span, 0, hh - 1)
    lcolc = torch.clamp(xs - 1, 0, hw - 1)
    cl = ch_flat[bf[:, None], (lrows * hw + lcolc[:, None]).long()]
    return ct, cl


def _cclm_picks(m, masks, cs):
    """The spec's boundary sample picks of modes m (B,) (81/82/83) from the
    (B, 4cs+1) availability rows: left availability, the empty flag, the
    count taken from the top and the top / left pick positions (B, 4)."""
    dev = m.device
    tw = th = cs
    masks = masks.to(torch.int32)
    avail_l = masks[:, 1].bool()
    avail_t = masks[:, 1 + 2 * cs].bool()
    nbl = torch.cumprod(masks[:, 1 + cs:1 + 2 * cs], dim=1).sum(1)
    ntr = torch.cumprod(masks[:, 1 + 3 * cs:1 + 4 * cs], dim=1).sum(1)
    is81, is82, is83 = m == 81, m == 82, m == 83
    num_t = torch.where(is82, 0, torch.where(
        avail_t, tw + torch.where(is83, torch.clamp(ntr, max=th), 0), 0))
    num_l = torch.where(is83, 0, torch.where(
        avail_l, th + torch.where(is82, torch.clamp(nbl, max=tw), 0), 0))
    empty = (num_t == 0) & (num_l == 0)
    num4 = (~(avail_t & avail_l & is81)).to(num_t.dtype)
    j = torch.arange(4, device=dev)[None, :]

    def picks(num):
        start = num >> (2 + num4)
        step = torch.clamp(num >> (1 + num4), min=1)
        cnt = torch.minimum((1 + num4) << 1, num)
        return cnt, start[:, None] + j * step[:, None]

    cnt_t, pick_t = picks(num_t)
    _, pick_l = picks(num_l)
    return avail_l, empty, cnt_t, pick_t, pick_l


def _cclm_from_taps(ysel, csel, cnt_t, ly, ctu_size, p_ds, empty):
    """The prediction from the picked boundary taps: ysel (B, 12, 4) luma
    taps (rows ly-1 and ly-2 at the three downsample columns, then the
    left columns lx-3 / lx-2 / lx-1 at two rows each), csel (B, 2, 4)
    chroma samples (top, left), cnt_t (B,) the count taken from the top,
    p_ds (B, cs, cs) the downsampled own luma."""
    dev = ysel.device
    sm_a, sc_a, sr_a, sm_b, sc_b, sr_b = (ysel[:, i] for i in range(6))
    sel_norm = (sm_a + sm_b + 2 * sc_a + 2 * sc_b + sr_a + sr_b + 4) >> 3
    sel_bdry = (sm_a + 2 * sc_a + sr_a + 2) >> 2
    ctu_b = ((ly & (ctu_size - 1)) == 0)[:, None]
    sel_y_t = torch.where(ctu_b, sel_bdry, sel_norm)
    sel_y_l = (ysel[:, 6] + ysel[:, 7] + 2 * ysel[:, 8] + 2 * ysel[:, 9]
               + ysel[:, 10] + ysel[:, 11] + 4) >> 3
    sel_c_t, sel_c_l = csel[:, 0], csel[:, 1]
    j = torch.arange(4, device=dev)[None, :]
    from_top = j < cnt_t[:, None]
    li = torch.clamp(j - cnt_t[:, None], 0, 3)
    sel_y = torch.where(from_top, sel_y_t, _sel_cols(sel_y_l, li, 4))
    sel_c = torch.where(from_top, sel_c_t, _sel_cols(sel_c_l, li, 4))
    return _cclm_fit_predict(sel_y, sel_c, p_ds, empty)


def cclm_from_own(m, own, lcol, tstrip, lstrip, ct, cl_, masks, ly, cs,
                  ctu_size):
    """CCLM prediction reading the block's OWN luma from a dense array
    (the commit wavefront evaluates CCLM in the step that committed the
    co-located luma); only the thin boundary strips (cclm_strips /
    cclm_cstrips) come from the reconstruction planes. Bit-identical to
    the spec's CCLM (intra_predictor.rs:1604-2056).

    m: (B,) modes 81/82/83; own: (B, 2cs, 2cs); lcol/tstrip/lstrip/ct/cl_
    from the strip helpers; masks: (B, 4cs+1) availability rows; ly: (B,)
    luma y. Returns (B, cs, cs) int32."""
    B = m.shape[0]
    TW, LH = 4 * cs + 1, 4 * cs
    avail_l, empty, cnt_t, pick_t, pick_l = _cclm_picks(m, masks, cs)

    # ---- 2x2 downsample from the dense own-luma + the left column
    own = own.reshape(B, 2 * cs, 2 * cs)
    rsum = own[:, 0::2, :] + own[:, 1::2, :]             # (B, cs, 2cs)
    xc_sum = rsum[:, :, 0::2]
    xr_sum = rsum[:, :, 1::2]
    lc_sum = lcol[:, 0::2] + lcol[:, 1::2]               # (B, cs)
    xm0 = torch.where(avail_l[:, None], lc_sum, xc_sum[:, :, 0])
    xm_sum = torch.cat([xm0[:, :, None], xr_sum[:, :, :-1]], dim=2)
    p_ds = (xm_sum + 2 * xc_sum + xr_sum + 4) >> 3

    # ---- boundary selects on the concatenated strips:
    # [top row ly-1 | top row ly-2 | left c3 | left c2 | left c1]
    p = pick_t
    px_c = 1 + 2 * p                                     # strip col of txc
    px_m = torch.where((p > 0) | avail_l[:, None], 2 * p, 1)
    px_r = px_c + 1
    q = pick_l
    py0 = 2 * q
    ystrip = torch.cat(
        [tstrip[:, 1, :], tstrip[:, 0, :],
         lstrip[:, :, 0], lstrip[:, :, 1], lstrip[:, :, 2]], dim=1)
    o_rb, o_c3 = TW, 2 * TW
    o_c2, o_c1 = 2 * TW + LH, 2 * TW + 2 * LH
    yidx = torch.cat(
        [px_m, px_c, px_r,
         px_m + o_rb, px_c + o_rb, px_r + o_rb,
         py0 + o_c3, py0 + 1 + o_c3,
         py0 + o_c2, py0 + 1 + o_c2,
         py0 + o_c1, py0 + 1 + o_c1], dim=1)
    ysel = _sel_cols(ystrip, yidx, 2 * TW + 3 * LH).reshape(B, 12, 4)
    cstrip = torch.cat([ct, cl_], dim=1)
    cidx = torch.cat([p, q + 2 * cs], dim=1)
    csel = _sel_cols(cstrip, cidx, 4 * cs).reshape(B, 2, 4)
    return _cclm_from_taps(ysel, csel, cnt_t, ly, ctu_size, p_ds, empty)


def cclm_luma_patch(luma_flat, lx, ly, cs, H, W, bfl):
    """ONE gather per block: the (4cs+2, 4cs+3) luma window at rows
    ly-2 .. ly+4cs-1, cols lx-3 .. lx+4cs-1 (edge-clipped like the spec's
    clamped reads); every luma sample CCLM reads lies inside it.
    luma_flat: (F, H*W); bfl: (B,) frame of each block."""
    dev = lx.device
    PH, PW = 4 * cs + 2, 4 * cs + 3
    prow = torch.clamp(ly[:, None] + torch.arange(PH, device=dev)[None, :]
                       - 2, 0, H - 1)
    pcol = torch.clamp(lx[:, None] + torch.arange(PW, device=dev)[None, :]
                       - 3, 0, W - 1)
    pidx = prow[:, :, None] * W + pcol[:, None, :]
    return luma_flat[bfl.long()[:, None, None], pidx.long()]   # (B, PH, PW)


def cclm_chroma_patch(ch_flat, xs, ys, cs, hh, hw, bf):
    """(B, 2cs+1, 2cs+1) chroma window at rows ys-1 .. ys+2cs-1, cols
    xs-1 .. xs+2cs-1 (edge-clipped): the above row and left column CCLM
    fits the linear model on."""
    dev = xs.device
    span = torch.arange(2 * cs + 1, device=dev)[None, :] - 1
    crow = torch.clamp(ys[:, None] + span, 0, hh - 1)
    ccol = torch.clamp(xs[:, None] + span, 0, hw - 1)
    cidx = crow[:, :, None] * hw + ccol[:, None, :]
    return ch_flat[bf.long()[:, None, None], cidx.long()]      # (B, CH, CW)


def predict_cclm_impl(mode, luma, chroma, xs, ys, cs, masks, ctu_size=32,
                      bf=None, bf_luma=None):
    """Batched bit-exact CCLM prediction (the twin of
    np_ops.predict_cclm_np; intra_predictor.rs:1604-2056). cs >= 4.

    luma / chroma: (recon) planes as tensors, (H, W) / (h, w) or stacked
    per frame ((F, H, W) / (F, h, w)) with `bf` giving each block's frame
    (`bf_luma` the luma frame where the chroma stack differs); (xs, ys):
    chroma block positions; masks: (B, 4cs+1) availability rows
    (refs.avail_masks). mode: one mode for all blocks or (B,) modes.
    Position and mask arrays may be numpy; they go to luma's device.
    Returns (B, cs, cs) int32."""
    assert cs >= 4
    dev = luma.device
    luma = luma.to(torch.int32)
    chroma = chroma.to(torch.int32)
    if luma.dim() == 2:
        luma = luma[None]
        chroma = chroma[None]
    H, W = luma.shape[1:]
    hh, hw = chroma.shape[1:]

    def i32(a):
        return torch.as_tensor(np.asarray(a) if not isinstance(
            a, torch.Tensor) else a, device=dev).to(torch.int32)
    xs, ys, masks = i32(xs), i32(ys), i32(masks)
    B = xs.shape[0]
    bf = torch.zeros(B, dtype=torch.int32, device=dev) if bf is None \
        else i32(bf)
    bfl = bf if bf_luma is None else i32(bf_luma)
    m = torch.broadcast_to(i32(mode), (B,))
    LP = cclm_luma_patch(luma.reshape(luma.shape[0], H * W), 2 * xs, 2 * ys,
                         cs, H, W, bfl)
    CP = cclm_chroma_patch(chroma.reshape(chroma.shape[0], hh * hw), xs, ys,
                           cs, hh, hw, bf)
    return cclm_from_patches(m, LP, CP, masks, 2 * ys, cs, ctu_size)


# the JAX package jits predict_cclm_impl under this name; eager here
predict_cclm = predict_cclm_impl


def cclm_from_patches(m, LP, CP, masks, ly, cs, ctu_size):
    """CCLM prediction from pre-gathered patches. m: (B,) modes (81/82/83);
    LP: (B, 4cs+2, 4cs+3) luma patches; CP: (B, 2cs+1, 2cs+1) chroma
    patches; masks: (B, 4cs+1); ly: (B,) luma y of each block."""
    B = m.shape[0]
    PH, PW = 4 * cs + 2, 4 * cs + 3
    avail_l, empty, cnt_t, pick_t, pick_l = _cclm_picks(m, masks, cs)

    # ---- 2x2 downsample grid from static patch slices (plane row ly+r is
    # patch row r+2; plane col lx+c is patch col c+3)
    r0 = LP[:, 2:2 + 2 * cs:2, :]                        # even luma rows
    r1 = LP[:, 3:3 + 2 * cs:2, :]                        # odd luma rows

    def cols(rr, base):
        return rr[:, :, base:base + 2 * cs:2]            # (B, cs, cs)

    xm_a = cols(r0, 2) + cols(r1, 2)
    # first downsample column: lx-1 when the left edge exists, else lx
    xm_edge = r0[:, :, 2] + r1[:, :, 2]
    xm_self = r0[:, :, 3] + r1[:, :, 3]
    first0 = torch.arange(cs, device=LP.device)[None, None, :] == 0
    xm_s = torch.where(avail_l[:, None, None], xm_edge[:, :, None],
                       xm_self[:, :, None])
    xm_sum = torch.where(first0, xm_s, xm_a)
    xc_sum = cols(r0, 3) + cols(r1, 3)
    xr_sum = cols(r0, 4) + cols(r1, 4)
    p_ds = (xm_sum + 2 * xc_sum + xr_sum + 4) >> 3

    # ---- boundary samples from one concatenated strip per plane:
    #   luma strip  = [row ly-1 | row ly-2 | col lx-3 | col lx-2 | col lx-1]
    #   chroma strip = [row ys-1 | col xs-1]
    p = pick_t
    px_c = 3 + 2 * p
    px_m = torch.where((p > 0) | avail_l[:, None], px_c - 1, 3)
    px_r = px_c + 1
    q = pick_l
    py0 = 2 + 2 * q
    ystrip = torch.cat(
        [LP[:, 1, :], LP[:, 0, :], LP[:, :, 0], LP[:, :, 1], LP[:, :, 2]],
        dim=1)
    o_rb, o_c3, o_c2, o_c1 = PW, 2 * PW, 2 * PW + PH, 2 * PW + 2 * PH
    yidx = torch.cat(
        [px_m, px_c, px_r,                                  # ra (ly-1)
         px_m + o_rb, px_c + o_rb, px_r + o_rb,             # rb (ly-2)
         py0 + o_c3, py0 + 1 + o_c3,
         py0 + o_c2, py0 + 1 + o_c2,
         py0 + o_c1, py0 + 1 + o_c1], dim=1)                # (B, 48)
    ysel = _sel_cols(ystrip, yidx, 2 * PW + 3 * PH).reshape(B, 12, 4)
    CW_ = 2 * cs + 1
    cstrip = torch.cat([CP[:, 0, :], CP[:, :, 0]], dim=1)
    cidx = torch.cat([1 + p, 1 + q + CW_], dim=1)           # (B, 8)
    csel = _sel_cols(cstrip, cidx, 2 * CW_).reshape(B, 2, 4)
    return _cclm_from_taps(ysel, csel, cnt_t, ly, ctu_size, p_ds, empty)


@functools.lru_cache(maxsize=None)
def _div_sig(device):
    """The 16-entry CCLM reciprocal table on the device (cached: a fresh
    host tensor per call would block the caller)."""
    return torch.as_tensor(np.asarray(tables.CCLM_DIV_SIG_TABLE, np.int32),
                           device=device)


def _cclm_fit_predict(sel_y, sel_c, p_ds, empty):
    """Linear-model fit + prediction from the 4 selected (luma, chroma)
    boundary pairs (intra_predictor.rs:1830-2056)."""
    # 4-point min/max network (exact spec comparison/swap order),
    # value-tracked: (y, c) pairs swap together, no index indirection
    ymn0, ymx0, ymn1, ymx1 = (sel_y[:, i] for i in range(4))
    cmn0, cmx0, cmn1, cmx1 = (sel_c[:, i] for i in range(4))

    def swp(sw, a, b):
        return torch.where(sw, b, a), torch.where(sw, a, b)

    sw = ymn0 > ymn1
    ymn0, ymn1 = swp(sw, ymn0, ymn1)
    cmn0, cmn1 = swp(sw, cmn0, cmn1)
    sw = ymx0 > ymx1
    ymx0, ymx1 = swp(sw, ymx0, ymx1)
    cmx0, cmx1 = swp(sw, cmx0, cmx1)
    sw = ymn0 > ymx1
    ymn0, ymx0 = swp(sw, ymn0, ymx0)
    cmn0, cmx0 = swp(sw, cmn0, cmx0)
    ymn1, ymx1 = swp(sw, ymn1, ymx1)
    cmn1, cmx1 = swp(sw, cmn1, cmx1)
    sw = ymn1 > ymx0
    ymn1, ymx0 = swp(sw, ymn1, ymx0)
    cmn1, cmx0 = swp(sw, cmn1, cmx0)

    max_y = (ymx0 + ymx1 + 1) >> 1
    max_c = (cmx0 + cmx1 + 1) >> 1
    min_y = (ymn0 + ymn1 + 1) >> 1
    min_c = (cmn0 + cmn1 + 1) >> 1

    diff = max_y - min_y
    diff_c = max_c - min_c
    x_ = _ilog2_u8(diff)
    norm = ((diff << 4) >> torch.clamp(x_, min=0)) & 15
    x_ = x_ + (norm != 0).to(x_.dtype)
    y_ = torch.where(diff_c.abs() > 0, _ilog2_u8(diff_c.abs()) + 1, 0)
    y_s = torch.clamp(y_, min=1)
    tbl = _div_sig(norm.device)[norm.long()] | 8
    a0 = torch.where(diff_c == 0, 0,
                     (diff_c * tbl + (1 << torch.clamp(y_ - 1, min=0)))
                     >> y_s)
    low_k = (3 + x_ - y_) < 1
    a = torch.where(low_k, torch.sign(a0) * 15, a0)
    k = torch.where(low_k, 1, 3 + x_ - y_)
    b = min_c - ((a * min_y) >> k)
    a = torch.where(diff == 0, 0, a)
    k = torch.where(diff == 0, 0, k)
    b = torch.where(diff == 0, min_c, b)

    pred = ((p_ds * a[:, None, None]) >> k[:, None, None]) + b[:, None, None]
    pred = torch.clamp(pred, 0, 255)
    return torch.where(empty[:, None, None], 128, pred).to(torch.int32)
