"""Batched integer DCT-II in PyTorch, bit-exact vs spec/transform.py.

Counterpart of wrenc_tpu/kernels/transforms.py (`forward_impl` /
`inverse_impl`): the same rounding shifts and clips, with the integer
products carried as f32 matmuls that are exact because every partial sum
stays below 2^24 (the hi/lo split covers the stages that would not).
Shapes: blocks (N, n, n), n = 4..32.

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
