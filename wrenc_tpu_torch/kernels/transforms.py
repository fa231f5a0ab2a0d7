"""Batched integer transforms in PyTorch, bit-exact vs spec/transform.py.

Counterpart of wrenc_tpu/kernels/transforms.py: DCT-II (`forward_impl` /
`inverse_impl`, named `forward_dct2` / `inverse_dct2`), MTS (DST-VII /
DCT-VIII, `forward_mts` / `inverse_mts`) and LFNST (`forward_lfnst` /
`inverse_lfnst`), with the same rounding shifts and clips, the integer
products carried as f32 matmuls that are exact because every partial sum
stays below 2^24 (the hi/lo split covers the stages that would not), at
the same stages as the reference. Shapes: blocks (N, n, n), n = 4..32.
MTS and LFNST are outside the default tool set, as in the reference,
whose search never selects them; they are here for capability parity.

Also home of the port's two exact-arithmetic helpers: `f32mm`, the one
exact matmul (never TF32), and `fma`, the single-rounding f32
multiply-add that the JAX reference gets from XLA's FMA contraction.
"""
import functools

import numpy as np
import torch

from ..core import tables

COEFF_MIN = -(1 << 15)
COEFF_MAX = (1 << 15) - 1


def f32mm(a, b):
    """Exact integer matmul a @ b carried in f32 (all sums < 2^24).

    On CUDA it asserts that TF32 is off for both matmul backends: a TF32
    product keeps 10 mantissa bits and would silently round."""
    if a.is_cuda:
        assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul on"
        assert not torch.backends.cudnn.allow_tf32, "TF32 cuDNN on"
    return torch.matmul(a.to(torch.float32),
                        b.to(torch.float32)).to(torch.int32)


def f32mm_split(a, b, bits=9):
    """Exact a @ b for int32 `a` whose sums may exceed 2^24: hi/lo split."""
    lo = a & ((1 << bits) - 1)
    hi = a >> bits          # arithmetic shift keeps hi*2^bits + lo == a
    return (f32mm(hi, b) << bits) + f32mm(lo, b)


def fma(a, b, c):
    """f32 a*b + c with ONE rounding, elementwise (broadcasting).

    XLA contracts the reference's f32 `c + a*b` into a fused multiply-add;
    eager PyTorch rounds twice and then disagrees in the last ulp on ~1%
    of elements. Emulated exactly in f64 on any device: the product of two
    f32 values is exact in f64, the f64 sum's rounding error is recovered
    with TwoSum, and it decides the one case where rounding the f64 sum to
    f32 could differ from rounding the exact sum — the f64 sum lying
    exactly halfway between two f32 values."""
    a64 = torch.as_tensor(a, dtype=torch.float64, device=_dev(a, b, c))
    b64 = torch.as_tensor(b, dtype=torch.float64, device=a64.device)
    c64 = torch.as_tensor(c, dtype=torch.float64, device=a64.device)
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    up = s > r64
    inf = torch.full_like(r, float('inf'))
    nb = torch.nextafter(r, torch.where(up, inf, -inf))
    mid = (r64 + nb.to(torch.float64)) * 0.5
    go_nb = (s == mid) & (err != 0) & ((err > 0) == up)
    return torch.where(go_nb, nb, r)


def _dev(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device('cpu')


@functools.lru_cache(maxsize=None)
def _dct2(n, device):
    return torch.as_tensor(tables.dct2_matrix(n).astype(np.int32),
                           device=device)


def forward_impl(res):
    """res (N, n, n) int -> DCT-II coefficients (N, n, n) int32."""
    n = res.shape[-1]
    log2n = n.bit_length() - 1
    t = _dct2(n, res.device)
    # horizontal: H[y,i] = sum_x T[i,x] res[y,x] — sums < 2^24, f32 exact
    h = f32mm(res.to(torch.int32), t.T)
    s1 = log2n - 1
    h = (h + (1 << (s1 - 1))) >> s1
    # vertical: C[j,i] = sum_y T[j,y] H[y,i] — needs the hi/lo split
    c = f32mm_split(h.transpose(1, 2), t.T).transpose(1, 2)
    s2 = log2n + 6
    return (c + (1 << (s2 - 1))) >> s2


def inverse_impl(coeffs):
    """coeffs (N, n, n) int -> residual (N, n, n) int32 (8-bit)."""
    n = coeffs.shape[-1]
    t = _dct2(n, coeffs.device)
    # vertical: V[y,x] = sum_i T[i,y] C[i,x]
    v = f32mm_split(coeffs.to(torch.int32).transpose(1, 2), t).transpose(1, 2)
    v = torch.clamp((v + 64) >> 7, COEFF_MIN, COEFF_MAX)
    # horizontal: R[y,x] = sum_i T[i,x] V[y,i]
    r = f32mm_split(v, t)
    bd_shift = 12  # 20 - bit_depth(8)
    return (r + (1 << (bd_shift - 1))) >> bd_shift


def forward_dct2(res):
    return forward_impl(res)


def inverse_dct2(coeffs):
    return inverse_impl(coeffs)


# ---------------------------------------------------------------------------
# MTS (DST-VII / DCT-VIII) and LFNST
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tmat_padded(tr_type, n, device):
    """Transform matrix padded to (n, n), on the device: the 32-pt MTS
    matrices store only 16 rows (zero-out); zero rows produce the
    zeroed-out coefficients."""
    m = tables.trans_matrix(tr_type, n).astype(np.int32)
    if m.shape[0] < n:
        m = np.concatenate([m, np.zeros((n - m.shape[0], n), np.int32)])
    return torch.as_tensor(m, device=device)


def forward_mts(res, tr_type_hor, tr_type_ver):
    """Forward separable transform, any (tr_hor, tr_ver) pair; blocks
    (N, n, n) int -> (N, n, n) int32 with zero-out applied."""
    n = res.shape[-1]
    log2n = n.bit_length() - 1
    th_m = _tmat_padded(tr_type_hor, n, res.device)
    tv_m = _tmat_padded(tr_type_ver, n, res.device)
    # horizontal: H[y,i] = sum_x Th[i,x] res[y,x]
    h = f32mm(res.to(torch.int32), th_m.T)
    s1 = log2n - 1
    h = (h + (1 << (s1 - 1))) >> s1
    # vertical: C[j,i] = sum_y Tv[j,y] H[y,i]
    c = f32mm_split(h.transpose(1, 2), tv_m.T).transpose(1, 2)
    s2 = log2n + 6
    return (c + (1 << (s2 - 1))) >> s2


def inverse_mts(coeffs, tr_type_hor, tr_type_ver):
    """Inverse separable transform, any (tr_hor, tr_ver) pair (8-bit)."""
    from ..spec.transform import non_zero_size
    n = coeffs.shape[-1]
    dev = coeffs.device
    nzw, nzh = non_zero_size(n, n, tr_type_hor, tr_type_ver)
    # mask coefficients outside the zero-out region (the spec sums only
    # i < nz; a legal stream has zeros there anyway)
    ar = torch.arange(n, device=dev)
    mask = (ar[:, None] < nzh) & (ar[None, :] < nzw)
    c = torch.where(mask[None], coeffs.to(torch.int32), 0)
    th_m = _tmat_padded(tr_type_hor, n, dev)
    tv_m = _tmat_padded(tr_type_ver, n, dev)
    # vertical: V[y,x] = sum_i Tv[i,y] C[i,x]
    v = f32mm_split(c.transpose(1, 2), tv_m).transpose(1, 2)
    v = torch.clamp((v + 64) >> 7, COEFF_MIN, COEFF_MAX)
    # horizontal: R[y,x] = sum_i Th[i,x] V[y,i]
    r = f32mm_split(v, th_m)
    bd_shift = 12
    return (r + (1 << (bd_shift - 1))) >> bd_shift


@functools.lru_cache(maxsize=None)
def _lfnst_consts(n, n_tr_s, set_idx, lfnst_idx, transposed, device):
    """The LFNST region's (ys, xs), the kernel matrix (16, nTrS) and the
    4x4 diagonal scan's (y, x), on the device."""
    from ..spec import transform as st
    ys, xs = st._lfnst_region_indices(n, n_tr_s, transposed)
    m = tables.lfnst_matrix(n_tr_s, set_idx, lfnst_idx).astype(np.int32)
    scan = tables.diag_scan(2, 2)
    return tuple(torch.as_tensor(np.asarray(a), device=device) for a in (
        np.asarray(ys, np.int64), np.asarray(xs, np.int64), m,
        scan[:, 1].astype(np.int64), scan[:, 0].astype(np.int64)))


def _lfnst_setup(coeffs, pred_mode_intra, lfnst_idx):
    from ..spec import transform as st
    _, th_, tw = coeffs.shape
    n, n_tr_s, nz = st._lfnst_geometry(tw, th_)
    consts = _lfnst_consts(n, n_tr_s, st.lfnst_set_index(pred_mode_intra),
                           lfnst_idx, pred_mode_intra > 34, coeffs.device)
    return nz, consts


def forward_lfnst(coeffs, pred_mode_intra, lfnst_idx, _unused=0):
    """Batched forward LFNST on (N, th, tw) separable-transform outputs.

    All blocks share one (mode-derived set, lfnst_idx); group by those to
    batch. Bit-exact vs spec/transform.forward_lfnst. The fourth argument
    is unused, as in the reference."""
    nz, (ys, xs, m, sy, sx) = _lfnst_setup(coeffs, pred_mode_intra,
                                           lfnst_idx)
    v = coeffs[:, ys, xs].to(torch.int32)                   # (N, nTrS)
    u = f32mm_split(v, m.T)
    u = (u + 64) >> 7                                       # (N, 16)
    out = torch.zeros(coeffs.shape, dtype=torch.int32, device=coeffs.device)
    out[:, sy[:nz], sx[:nz]] = u[:, :nz]
    return out


def inverse_lfnst(coeffs, pred_mode_intra, lfnst_idx):
    """Batched inverse LFNST on (N, th, tw) dequantized coefficients."""
    nz, (ys, xs, m, sy, sx) = _lfnst_setup(coeffs, pred_mode_intra,
                                           lfnst_idx)
    u = coeffs[:, sy[:nz], sx[:nz]].to(torch.int32)         # (N, nz)
    v = f32mm_split(u, m[:nz])                              # (N, nTrS)
    v = torch.clamp((v + 64) >> 7, COEFF_MIN, COEFF_MAX)
    out = coeffs.to(torch.int32).clone()
    out[:, ys, xs] = v
    return out
