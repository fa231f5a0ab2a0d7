"""Forward / inverse transforms (spec 8.7.4).

Separable integer transforms over int32/int64 with the spec's shift/round/
clamp discipline. Behavioural reference: transformer.rs:2040 (forward) and
:2380 (inverse). Matrices come from core.tables (spec data).

Conventions: blocks are (th, tw) arrays indexed [y][x]; tr_type 0=DCT-II,
1=DST-VII, 2=DCT-VIII; transform-skip is handled by the caller (passthrough).
"""
import numpy as np

from ..core import tables

COEFF_MIN = -(1 << 15)
COEFF_MAX = (1 << 15) - 1


def non_zero_size(tw, th, tr_type_hor, tr_type_ver):
    """Zero-out region (spec: MTS keeps 16, DCT-II keeps 32 coefficients)."""
    nzw = min(tw, 16 if tr_type_hor > 0 else 32)
    nzh = min(th, 16 if tr_type_ver > 0 else 32)
    return nzw, nzh


def forward(res, tr_type_hor=0, tr_type_ver=0, bit_depth=8):
    """Forward transform of residual block `res` ((th, tw) int) -> int32 coeffs.

    Matches transformer.rs:2040: horizontal pass, shift log2(tw)-1+(bd-8);
    vertical pass, shift log2(th)+6; zero-out applied.
    """
    res = np.asarray(res, dtype=np.int64)
    th, tw = res.shape
    log2_tw = tw.bit_length() - 1
    log2_th = th.bit_length() - 1
    nzw, nzh = non_zero_size(tw, th, tr_type_hor, tr_type_ver)

    t_h = tables.trans_matrix(tr_type_hor, tw).astype(np.int64)  # (rows, tw)
    t_v = tables.trans_matrix(tr_type_ver, th).astype(np.int64)  # (rows, th)

    # horizontal: H[y][i] = sum_x T_h[i][x] * res[y][x]
    h = res @ t_h[:nzw].T  # (th, nzw)
    shift1 = log2_tw - 1 + (bit_depth - 8)
    h = (h + (1 << (shift1 - 1))) >> shift1

    # vertical: C[i][x] = sum_y T_v[i][y] * H[y][x]
    c = t_v[:nzh] @ h  # (nzh, nzw)
    shift2 = log2_th + 6
    c = (c + (1 << (shift2 - 1))) >> shift2

    out = np.zeros((th, tw), dtype=np.int32)
    out[:nzh, :nzw] = c
    return out


def inverse(coeffs, tr_type_hor=0, tr_type_ver=0, bit_depth=8):
    """Inverse transform of dequantized coefficients -> int16 residual.

    Matches transformer.rs:2380: vertical pass first, intermediate
    (v+64)>>7 clamp to int16 range, horizontal pass, final shift
    20-bit_depth.
    """
    coeffs = np.asarray(coeffs, dtype=np.int64)
    th, tw = coeffs.shape
    nzw, nzh = non_zero_size(tw, th, tr_type_hor, tr_type_ver)

    t_h = tables.trans_matrix(tr_type_hor, tw).astype(np.int64)
    t_v = tables.trans_matrix(tr_type_ver, th).astype(np.int64)

    # vertical: V[y][x] = sum_i T_v[i][y] * C[i][x], i < nzh
    v = t_v[:nzh].T @ coeffs[:nzh]  # (th, tw)
    v = np.clip((v + 64) >> 7, COEFF_MIN, COEFF_MAX)

    # horizontal: R[y][x] = sum_i T_h[i][x] * V[y][i], i < nzw
    r = v[:, :nzw] @ t_h[:nzw]  # (th, tw)

    bd_shift = 20 - bit_depth
    r = (r + (1 << (bd_shift - 1))) >> bd_shift
    return r.astype(np.int16)


# ---------------------------------------------------------------------------
# LFNST (low-frequency non-separable transform, spec 8.7.4.2/8.7.4.3;
# matrices transformer.rs:11-933, set selection :1929-1946, forward apply
# :2319-2366, inverse apply :2410-2470). Disabled in the default tool set
# (sps_lfnst_enabled=0, matching the reference); shipped for capability
# parity and exercised by golden tests.
# ---------------------------------------------------------------------------

def lfnst_set_index(pred_mode_intra):
    """LFNST transform-set from the (wide-angle-remapped) intra mode."""
    m = pred_mode_intra
    if m < 0:
        return 1
    if m <= 1:
        return 0
    if m <= 12:
        return 1
    if m <= 23:
        return 2
    if m <= 44:
        return 3
    if m <= 55:
        return 2
    return 1


def _lfnst_geometry(tw, th):
    """(region size n, nTrS, nonZeroSize) for an LFNST-eligible TB."""
    big = tw >= 8 and th >= 8
    n = 8 if big else 4
    n_tr_s = 48 if big else 16
    nz = 8 if ((tw == 4 and th == 4) or (tw == 8 and th == 8)) else 16
    return n, n_tr_s, nz


def _lfnst_region_indices(n, n_tr_s, transposed):
    """(ys, xs) gather order of the nTrS-sample low-frequency region:
    row-major over the top 4 rows (full n wide), then the left 4 columns
    of rows 4..n (transformer.rs:2352-2365; transposed swaps x/y)."""
    ys, xs = [], []
    for i in range(n_tr_s):
        if i < 4 * n:
            y, x = i // n, i % n
        else:
            k = i - 32
            y, x = 4 + k // 4, k % 4
        if transposed:
            y, x = x, y
        ys.append(y)
        xs.append(x)
    return np.array(ys), np.array(xs)


def forward_lfnst(coeffs, pred_mode_intra, lfnst_idx):
    """Apply the forward LFNST to separable-transform output `coeffs`.

    Returns a new (th, tw) int32 array: nonZeroSize secondary coefficients
    in the top-left 4x4 diagonal scan, everything else zero."""
    assert lfnst_idx in (1, 2)
    th, tw = coeffs.shape
    n, n_tr_s, nz = _lfnst_geometry(tw, th)
    transposed = pred_mode_intra > 34
    ys, xs = _lfnst_region_indices(n, n_tr_s, transposed)
    v = np.asarray(coeffs, dtype=np.int64)[ys, xs]          # (nTrS,)
    m = tables.lfnst_matrix(n_tr_s, lfnst_set_index(pred_mode_intra),
                            lfnst_idx).astype(np.int64)     # (16, nTrS)
    u = (m @ v + 64) >> 7                                   # (16,)
    out = np.zeros((th, tw), dtype=np.int32)
    scan = tables.diag_scan(2, 2)
    for i in range(nz):
        x, y = int(scan[i][0]), int(scan[i][1])
        out[y, x] = u[i]
    return out


def inverse_lfnst(coeffs, pred_mode_intra, lfnst_idx):
    """Invert the LFNST on dequantized coefficients before the separable
    inverse transform (spec 8.7.4.2: v = clip((M^T u + 64) >> 7))."""
    assert lfnst_idx in (1, 2)
    th, tw = coeffs.shape
    n, n_tr_s, nz = _lfnst_geometry(tw, th)
    transposed = pred_mode_intra > 34
    scan = tables.diag_scan(2, 2)
    u = np.array([coeffs[int(scan[i][1]), int(scan[i][0])]
                  for i in range(nz)], dtype=np.int64)
    m = tables.lfnst_matrix(n_tr_s, lfnst_set_index(pred_mode_intra),
                            lfnst_idx).astype(np.int64)     # (16, nTrS)
    v = np.clip((m[:nz].T @ u + 64) >> 7, COEFF_MIN, COEFF_MAX)  # (nTrS,)
    out = np.array(coeffs, dtype=np.int32, copy=True)
    ys, xs = _lfnst_region_indices(n, n_tr_s, transposed)
    # region is overwritten; remaining positions keep their coefficients
    # (zero in a legal stream: LFNST implies the zero-out condition)
    out[ys, xs] = v
    return out
