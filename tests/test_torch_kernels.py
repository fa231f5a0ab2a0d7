"""The port's kernel modules against the JAX package, on the CPU.

Every comparison is exact equality: DCT-II, the 67-mode sweep, greedy
dep-quant (levels and f32 rate), the trellis (levels and f32 rate) and
the f32 fused multiply-add. On the CPU the quantizer wrappers run their
plain PyTorch twins; the CUDA kernels K1/K2 are held against those twins
on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wrenc_tpu.core.config import RateModelConfig
from wrenc_tpu.kernels import intra_pred as jip
from wrenc_tpu.kernels import quantize as jkq
from wrenc_tpu.kernels import trellis_pallas
from wrenc_tpu.kernels import transforms as jtr
from wrenc_tpu.spec import quant

from wrenc_tpu_torch.kernels import intra_pred as tip
from wrenc_tpu_torch.kernels import quantize as tkq
from wrenc_tpu_torch.kernels import transforms as ttr
from wrenc_tpu_torch.kernels import trellis as ttl

from tests.test_trellis_pallas import _adversarial_blocks

torch.set_num_threads(1)


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_dct_matches_jax(log2):
    rng = np.random.default_rng(40 + log2)
    n = 1 << log2
    res = rng.integers(-255, 256, (12, n, n)).astype(np.int32)
    res[0] = 255
    res[1] = -255
    res[2] = np.where(rng.integers(0, 2, (n, n)) > 0, 255, -255)
    fwd = ttr.forward_impl(torch.as_tensor(res)).numpy()
    assert (fwd == np.asarray(jtr._forward(jnp.asarray(res)))).all()
    coeffs = np.concatenate([fwd, rng.integers(-(1 << 15), 1 << 15,
                                               (4, n, n))]).astype(np.int32)
    inv = ttr.inverse_impl(torch.as_tensor(coeffs)).numpy()
    assert (inv == np.asarray(jtr._inverse(jnp.asarray(coeffs)))).all()


@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_predict_all_modes_matches_jax(size):
    rng = np.random.default_rng(size)
    L = 4 * size + 1
    v = rng.integers(0, 256, (5, 2 * L)).astype(np.int32)
    v[0] = 255
    want = np.asarray(jip.predict_all_modes_m(
        jnp.asarray(v), jip.mats_host_f32(size, 0), size))
    m = tip.mats_device_f32(size, 0, 'cpu')
    got = tip.predict_all_modes_m(torch.as_tensor(v), m, size).numpy()
    assert (got == want).all()


def _quant_case(log2, qp, trellis):
    rm = RateModelConfig()
    t = _adversarial_blocks(log2, seed=13 * log2 + qp)
    qpar = quant.derive_quant_params(qp, log2, log2, dep_quant=True,
                                     transform_skip=False)
    try:
        lam = jkq.lam_dq_table(rm, qp, trellis=trellis)
    except AssertionError:
        # the greedy lambda table leaves the f32-exact range at QP 51 (the
        # JAX package refuses it); the scan takes any table, so feed the
        # trellis one
        lam = jkq.lam_dq_table(rm, qp, trellis=True)
    lv = jkq.lv_table_device(rm, True, trellis)
    return t, qpar, lam, lv


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("qp", [8, 32, 51])
def test_greedy_depquant_matches_jax(log2, qp):
    t, qpar, lam, lv = _quant_case(log2, qp, trellis=False)
    q_j, r_j = jkq.greedy_depquant(jnp.asarray(t), qpar.ls, qpar.bd_shift,
                                   jnp.asarray(lam), log2, jnp.asarray(lv))
    q_t, r_t = tkq.greedy_depquant(torch.as_tensor(t), qpar.ls,
                                   qpar.bd_shift, lam, log2, lv)
    assert (q_t.numpy() == np.asarray(q_j)).all()
    assert (r_t.numpy() == np.asarray(r_j)).all()


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("qp", [8, 32, 51])
def test_trellis_rate_matches_jax(log2, qp):
    t, qpar, lam, lv = _quant_case(log2, qp, trellis=True)
    tj = jnp.asarray(t)
    q_seq = np.asarray(jkq.trellis_depquant(tj, qpar.ls, qpar.bd_shift,
                                            jnp.asarray(lam), log2))
    r_seq = np.asarray(jkq.dq_rate_scan(jnp.asarray(q_seq), log2,
                                        jnp.asarray(lv)))
    q_t, r_t = ttl.trellis_rate(torch.as_tensor(t), qpar.ls, qpar.bd_shift,
                                lam, lv, log2)
    assert (q_t.numpy() == q_seq).all()
    assert (r_t.numpy() == r_seq).all()
    if log2 in (2, 5):
        # the Pallas kernel itself, in interpret mode
        q_p, r_p = trellis_pallas.trellis_rate(
            tj, np.int32(qpar.ls), np.int32(qpar.bd_shift),
            jnp.asarray(lam), jnp.asarray(lv), log2)
        assert (q_t.numpy() == np.asarray(q_p)).all()
        assert (r_t.numpy() == np.asarray(r_p)).all()


def test_trellis_rate_per_block_params():
    """(B,) per-block ls/bd_shift equal per-group scalar calls."""
    log2 = 3
    t, qa, lam, lv = _quant_case(log2, 22, trellis=True)
    qb = quant.derive_quant_params(37, log2, log2, dep_quant=True,
                                   transform_skip=False)
    B = t.shape[0]
    ls = np.where(np.arange(B) % 2 == 0, qa.ls, qb.ls)
    bd = np.where(np.arange(B) % 2 == 0, qa.bd_shift, qb.bd_shift)
    q_t, r_t = ttl.trellis_rate(torch.as_tensor(t), ls, bd, lam, lv, log2)
    for par, sel in ((qa, slice(0, None, 2)), (qb, slice(1, None, 2))):
        q_s, r_s = ttl.trellis_rate(torch.as_tensor(t[sel]), par.ls,
                                    par.bd_shift, lam, lv, log2)
        assert (q_t[sel] == q_s).all() and (r_t[sel] == r_s).all()


def test_fma_matches_float64_fma():
    rng = np.random.default_rng(5)
    n = 200_000
    a = rng.standard_normal(n).astype(np.float32)
    b = (rng.standard_normal(n) * 1e3).astype(np.float32)
    c = (rng.standard_normal(n) * 1e6).astype(np.float32)
    # hard cases: a*b + c lands exactly halfway between two f32 values in
    # f64, with the f64 rounding error deciding the direction
    a[:4] = np.float32(1.0 + 2.0 ** -23)
    b[:4] = np.float32(1.0 + 2.0 ** -23)
    c[:4] = np.float32(-1.0)
    got = ttr.fma(torch.as_tensor(a), torch.as_tensor(b),
                  torch.as_tensor(c)).numpy()
    from fractions import Fraction
    exact = a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)
    assert (got == exact.astype(np.float32)).mean() > 0.999
    for i in list(range(4)) + list(rng.integers(0, n, 300)):
        e = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(e))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda x: (abs(Fraction(float(x)) - e),
                                         int(np.float32(x).view(np.int32)) & 1))
        assert got[i] == best, i
    # the XLA contraction the reference relies on
    want = np.asarray(jax.jit(lambda x, y, z: z + x * y)(a, b, c))
    assert (got == want).all()
    # ... which eager PyTorch's two roundings do not reproduce
    ta, tb, tc = (torch.as_tensor(x) for x in (a, b, c))
    assert ((tc + ta * tb).numpy() != want).any()
