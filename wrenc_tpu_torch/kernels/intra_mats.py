"""Per-mode intra-prediction matrices.

Key observation driving the TPU design: every non-CCLM intra predictor
(PLANAR, DC, all angular modes, incl. the 121 reference filter and PDPC) is
an integer-LINEAR function of the reference-sample vector, interrupted only
by two fixed shift/clamp stages. So for each (component, block size, mode)
we precompute:

    stage 1:  p  = clip((v @ W1 + c1) >> s1)            # base prediction
    stage 2:  p' = clip((v @ W2 + B * p + 32) >> 6)     # PDPC blend

where v = [u, u_filtered] is the length-2L concatenation of the substituted
reference vector u (layout: [corner, left_0..left_{2h-1},
above_0..above_{2w-1}]) and its 121-filtered version. The whole 67-mode
sweep then runs as two batched int32 matmuls on the MXU.

Weights are constructed here (NumPy, cached) mirroring spec/intra.py /
spec 8.4.5.2; golden tests assert bit-exactness against the scalar model
for every (mode, size, component).
"""
import functools

import numpy as np

from .. import trace
from ..core.tables import INTRA_ANGLE_TABLE, F_C, F_G, PDPC_WEIGHTS

_REF_FILTER_MODES = frozenset([0, 2, 34, 66])  # subset reachable for squares


def _ilog2(v):
    return int(v).bit_length() - 1


def _inv_angle(angle):
    if angle > 0:
        return (512 * 32 + angle // 2) // angle
    if angle < 0:
        return -((512 * 32 + (-angle) // 2) // (-angle))
    return 0


def _uses_filtered(mode, size, c_idx):
    return c_idx == 0 and size * size > 32 and mode in _REF_FILTER_MODES


def _angular_filter_flag(mode, size, c_idx):
    if mode in _REF_FILTER_MODES or c_idx != 0:
        return False
    n_tb_s = _ilog2(size)
    min_dist = min(abs(mode - 50), abs(mode - 18))
    thres = {2: 24, 3: 14, 4: 2, 5: 0}[n_tb_s]
    return min_dist > thres


def _refx_umap(mode, size, angle, inv_angle):
    """Map refx indices -> u indices (see spec/intra.py predict_angular)."""
    w = h = size
    if mode >= 34:
        m = [0] + [1 + 2 * h + x for x in range(w + 1)]
        if angle < 0:
            for x in range(-h, 0):
                idx = min((x * inv_angle + 256) >> 9, h)
                m.append(idx)            # lrs[idx]: corner-inclusive left
        else:
            for x in range(w + 2, 2 * w):
                m.append(1 + 2 * h + (x - 1))
            for _ in range(3):
                m.append(1 + 2 * h + 2 * w - 1)
    else:
        m = list(range(h + 2))           # lrs[0..h+1] = u[0..h+1]
        if angle < 0:
            for x in range(-w, 0):
                idx = min((x * inv_angle + 256) >> 9, w)
                m.append(0 if idx == 0 else 1 + 2 * h + idx - 1)
        else:
            for x in range(h + 2, 2 * h + 1):
                m.append(x)
            for _ in range(2):
                m.append(2 * h)
    return m


@functools.lru_cache(maxsize=None)
@trace.table
def build_mode_matrices(size, c_idx):
    """Stacked per-mode stage matrices for `size`x`size` blocks.

    Returns dict of numpy arrays: W1 (67, 2L, WH) int32, c1/s1 (67,) int32,
    clamp1 (67,) bool, W2 (67, 2L, WH) int32, B2 (67, WH) int32.
    L = 4*size + 1; WH = size*size; output pixel p = y*size + x.
    """
    w = h = size
    L = 4 * size + 1
    WH = size * size
    M = 67
    W1 = np.zeros((M, 2 * L, WH), dtype=np.int32)
    W2 = np.zeros((M, 2 * L, WH), dtype=np.int32)
    c1 = np.zeros(M, dtype=np.int32)
    s1 = np.zeros(M, dtype=np.int32)
    clamp1 = np.zeros(M, dtype=bool)
    B2 = np.full((M, WH), 64, dtype=np.int32)

    def uidx(mode, i):
        """Index into v for u[i], honouring the filter half."""
        return i + (L if _uses_filtered(mode, size, c_idx) else 0)

    lw, lh = _ilog2(w), _ilog2(h)
    for mode in range(67):
        o = L if _uses_filtered(mode, size, c_idx) else 0
        if mode == 0:      # PLANAR
            for y in range(h):
                for x in range(w):
                    p = y * w + x
                    W1[mode, o + 1 + 2 * h + x, p] += (h - 1 - y) << lw
                    W1[mode, o + 1 + h, p] += (y + 1) << lw          # left[h]
                    W1[mode, o + 1 + y, p] += (w - 1 - x) << lh
                    W1[mode, o + 1 + 2 * h + w, p] += (x + 1) << lh  # above[w]
            c1[mode] = w * h
            s1[mode] = lw + lh + 1
        elif mode == 1:    # DC (square)
            for p in range(WH):
                for x in range(w):
                    W1[mode, o + 1 + 2 * h + x, p] += 1
                for y in range(h):
                    W1[mode, o + 1 + y, p] += 1
            c1[mode] = w
            s1[mode] = lw + 1
        else:              # angular
            angle = int(INTRA_ANGLE_TABLE[14 + mode])
            inv = _inv_angle(angle)
            umap = _refx_umap(mode, size, angle, inv)
            n = len(umap)
            ff = _angular_filter_flag(mode, size, c_idx)
            taps = F_G if ff else F_C
            if mode >= 34:
                for y in range(h):
                    i_idx = ((y + 1) * angle) >> 5
                    i_fact = ((y + 1) * angle) & 31
                    for x in range(w):
                        p = y * w + x
                        base = x + i_idx
                        if c_idx == 0:
                            for i in range(4):
                                r = (base + i) % n
                                W1[mode, o + umap[r], p] += int(taps[i_fact][i])
                        elif i_fact != 0:
                            W1[mode, o + umap[(base + 1) % n], p] += 32 - i_fact
                            W1[mode, o + umap[(base + 2) % n], p] += i_fact
                        else:
                            W1[mode, o + umap[(base + 1) % n], p] += 32
            else:
                for x in range(w):
                    i_idx = ((x + 1) * angle) >> 5
                    i_fact = ((x + 1) * angle) & 31
                    for y in range(h):
                        p = y * w + x
                        base = y + i_idx
                        if c_idx == 0:
                            for i in range(4):
                                r = (base + i) % n
                                W1[mode, o + umap[r], p] += int(taps[i_fact][i])
                        elif i_fact != 0:
                            W1[mode, o + umap[(base + 1) % n], p] += 32 - i_fact
                            W1[mode, o + umap[(base + 2) % n], p] += i_fact
                        else:
                            W1[mode, o + umap[(base + 1) % n], p] += 32
            if c_idx == 0:
                c1[mode], s1[mode], clamp1[mode] = 32, 6, True
            else:
                c1[mode], s1[mode] = 16, 5

        # ---------------- stage 2: PDPC ----------------
        if size < 4 or not (mode <= 18 or 50 <= mode <= 66):
            continue
        angle = int(INTRA_ANGLE_TABLE[14 + mode]) if mode > 1 else 0
        inv = _inv_angle(angle) if mode > 1 else 0
        if mode > 50:
            ns = min(2, lh - _ilog2(3 * inv - 2) + 8)
        elif 1 < mode < 18:
            ns = min(2, lw - _ilog2(3 * inv - 2) + 8)
        else:
            ns = (lw + lh - 2) >> 2
        if mode < 2:
            for y in range(h):
                wt = int(PDPC_WEIGHTS[ns, y])
                for x in range(w):
                    wl = int(PDPC_WEIGHTS[ns, x])
                    p = y * w + x
                    W2[mode, uidx(mode, 1 + y), p] += wl
                    W2[mode, uidx(mode, 1 + 2 * h + x), p] += wt
                    B2[mode, p] = 64 - wl - wt
        elif mode in (18, 50):
            for y in range(h):
                for x in range(w):
                    p = y * w + x
                    if mode == 50:
                        wl = int(PDPC_WEIGHTS[ns, x])
                        W2[mode, uidx(mode, 1 + y), p] += wl
                        W2[mode, uidx(mode, 0), p] -= wl
                    else:
                        wt = int(PDPC_WEIGHTS[ns, y])
                        W2[mode, uidx(mode, 1 + 2 * h + x), p] += wt
                        W2[mode, uidx(mode, 0), p] -= wt
                    B2[mode, p] = 64
        elif mode < 18:
            if ns < 0:
                continue
            for y in range(h):
                wt = int(PDPC_WEIGHTS[ns, y])
                dx_int = ((y + 1) * inv + 256) >> 9
                for x in range(w):
                    p = y * w + x
                    if y < (3 << ns):
                        dx = min(x + dx_int, 2 * w - 1)
                        W2[mode, uidx(mode, 1 + 2 * h + dx), p] += wt
                    B2[mode, p] = 64 - wt
        else:  # mode > 50
            if ns < 0:
                continue
            for x in range(w):
                wl = int(PDPC_WEIGHTS[ns, x])
                dy_int = ((x + 1) * inv + 256) >> 9
                for y in range(h):
                    p = y * w + x
                    if x < (3 << ns):
                        dy = min(y + dy_int, 2 * h - 1)
                        W2[mode, uidx(mode, 1 + dy), p] += wl
                    B2[mode, p] = 64 - wl

    return {"W1": W1, "c1": c1, "s1": s1, "clamp1": clamp1,
            "W2": W2, "B2": B2, "L": L}


def filter_ref_vector(u, size):
    """121-filtered version of a batch of unified ref vectors u (N, L).

    Mirrors spec/intra.py filter_ref_samples: corner gets (left0+2c+above0),
    left run filtered with last entry copied, above run likewise.
    """
    u = np.asarray(u)
    N, L = u.shape
    h = w = size
    uf = u.copy()
    # corner: (left[1] + 2*left[0] + above[0] + 2) >> 2 with
    # left[0]=corner=u[0], left[1]=u[1], above[0]=u[1+2h]
    uf[:, 0] = (u[:, 1] + 2 * u[:, 0] + u[:, 1 + 2 * h] + 2) >> 2
    # left samples u[1..2h]: lf[1+y] = (left[2+y] + 2 left[1+y] + left[y] + 2)>>2
    for y in range(2 * h - 1):
        uf[:, 1 + y] = (u[:, 2 + y] + 2 * u[:, 1 + y] + u[:, y] + 2) >> 2
    uf[:, 2 * h] = u[:, 2 * h]
    # above: af[0] = (corner + 2*above[0] + above[1] + 2)>>2
    a0 = 1 + 2 * h
    uf[:, a0] = (u[:, 0] + 2 * u[:, a0] + u[:, a0 + 1] + 2) >> 2
    for x in range(2 * w - 2):
        uf[:, a0 + 1 + x] = (u[:, a0 + x] + 2 * u[:, a0 + 1 + x]
                             + u[:, a0 + 2 + x] + 2) >> 2
    uf[:, a0 + 2 * w - 1] = u[:, a0 + 2 * w - 1]
    return uf
