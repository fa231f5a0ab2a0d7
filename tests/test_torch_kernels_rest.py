"""The port's last `kernels/` formulations against the JAX package's, on
the CPU: MTS (DST-VII / DCT-VIII), LFNST, the named DCT-II entries, the
trellis entries `trellis_depquant` / `trellis_depquant_pscan` (K1's
plain twin here; chip_smoke.py holds K1 against it on the card), the
level-rate walks `dq_rate_scan` / `dq_rate_device` and BDPCM. The same
seeded numpy inputs go through both packages; every comparison is exact
(the f32 rates bit for bit, each against its own JAX function: their
summation orders differ from each other).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wrenc_tpu.core.config import RateModelConfig
from wrenc_tpu.kernels import quantize as jkq
from wrenc_tpu.kernels import transforms as jkt
from wrenc_tpu.spec import quant

from wrenc_tpu_torch.kernels import quantize as tkq
from wrenc_tpu_torch.kernels import transforms as tkt

torch.set_num_threads(1)

MTS_PAIRS = [(1, 1), (2, 1), (1, 2), (2, 2), (0, 1)]


def _same(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("tr", MTS_PAIRS)
def test_mts_matches_jax(n, tr):
    rng = np.random.default_rng(n * 10 + tr[0] * 2 + tr[1])
    res = rng.integers(-255, 256, (5, n, n)).astype(np.int32)
    res[0] = np.where(rng.integers(0, 2, (n, n)) > 0, 255, -255)
    fwd = np.asarray(jkt.forward_mts(res, tr[0], tr[1]))
    _same(tkt.forward_mts(torch.as_tensor(res), tr[0], tr[1]), fwd)
    # the inverse on the forward's output scaled down, and on raw values
    # outside the zero-out region (masked as in the reference)
    coeffs = np.concatenate([fwd // 16, rng.integers(
        -4000, 4000, (3, n, n))]).astype(np.int32)
    _same(tkt.inverse_mts(torch.as_tensor(coeffs), tr[0], tr[1]),
          jkt.inverse_mts(coeffs, tr[0], tr[1]))


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_dct2_named_entries_match_jax(n):
    rng = np.random.default_rng(n)
    res = rng.integers(-255, 256, (5, n, n)).astype(np.int32)
    fwd = np.asarray(jkt.forward_dct2(res))
    _same(tkt.forward_dct2(torch.as_tensor(res)), fwd)
    _same(tkt.inverse_dct2(torch.as_tensor(fwd.copy())),
          jkt.inverse_dct2(fwd))


@pytest.mark.parametrize("size", [(4, 4), (8, 8), (16, 16), (4, 8), (8, 16)])
@pytest.mark.parametrize("mode", [0, 1, 10, 18, 34, 40, 50, 66])
@pytest.mark.parametrize("lfnst_idx", [1, 2])
def test_lfnst_matches_jax(size, mode, lfnst_idx):
    th, tw = size
    rng = np.random.default_rng(th * 100 + tw + mode)
    blocks = rng.integers(-512, 512, (4, th, tw)).astype(np.int32)
    fwd = np.asarray(jkt.forward_lfnst(blocks, mode, lfnst_idx))
    _same(tkt.forward_lfnst(torch.as_tensor(blocks), mode, lfnst_idx), fwd)
    # the unused fourth argument of the reference
    _same(tkt.forward_lfnst(torch.as_tensor(blocks), mode, lfnst_idx, 7),
          fwd)
    coeffs = (fwd // 4).astype(np.int32)
    got = tkt.inverse_lfnst(torch.as_tensor(coeffs), mode, lfnst_idx)
    _same(got, jkt.inverse_lfnst(coeffs, mode, lfnst_idx))
    # the input is not written through
    assert (coeffs == (fwd // 4)).all()


def _rate_blocks(log2, seed):
    """tests/test_kernels_quant.py's level recipe plus seeded adversarial
    blocks: int16 extremes, a lone last-position level, alternating
    parities and levels around the 1023 clip of the table."""
    rng = np.random.default_rng(seed)
    s = 1 << log2
    q = rng.integers(-40, 41, (24, s, s))
    q[0] = 0                                   # all-zero
    q[1] = 0
    q[1, 0, 0] = 3                             # DC-only
    q[2] = np.where(rng.random((s, s)) < 0.9, 0, q[2])   # sparse
    q[3] = rng.integers(1800, 2400, (s, s))    # clips at lv[1023]
    q[4] = rng.choice([-32768, 32767, 0, 1, -1], (s, s))
    q[5] = 0
    q[5, s - 1, s - 1] = -7                    # first coded position only
    q[6] = np.where((np.arange(s * s) % 2).reshape(s, s) == 0, 1, 2)
    q[7] = rng.integers(2040, 2052, (s, s)) * rng.choice([-1, 1], (s, s))
    return q.astype(np.int16)


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("trellis", [False, True])
@pytest.mark.parametrize("walk", ["scan", "device"])
def test_dq_rate_matches_jax(log2, trellis, walk):
    rm = RateModelConfig()
    lv = jkq.lv_table_device(rm, True, trellis)
    jfn, tfn = {"scan": (jkq.dq_rate_scan, tkq.dq_rate_scan),
                "device": (jkq.dq_rate_device, tkq.dq_rate_device)}[walk]
    for seed in (31 + log2, 97 * log2 + trellis):
        q = _rate_blocks(log2, seed)
        _same(tfn(torch.as_tensor(q), log2, lv),
              jfn(jnp.asarray(q), log2, jnp.asarray(lv)))


def _trellis_blocks(log2, seed):
    """tests/test_kernels_quant.py's trellis recipe plus a saturated
    residual's coefficients and a +-1 field (ties)."""
    from wrenc_tpu.spec import transform
    rng = np.random.default_rng(seed)
    s = 1 << log2
    t = rng.integers(-3000, 3000, (24, s, s)).astype(np.int32)
    t[0] = 0                                   # all-zero block
    t[1] = 0
    t[1, 0, 0] = 1                             # DC-only
    t[2] = rng.integers(-3, 4, (s, s))         # tie-heavy small coeffs
    res = np.where(rng.integers(0, 2, (s, s)) > 0, 255, -255)
    t[3] = np.asarray(transform.forward(res.astype(np.int32)))
    t[4] = rng.integers(-1, 2, (s, s))
    return t


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("qp", [22, 37, 51])
def test_trellis_depquant_matches_jax(log2, qp):
    rm = RateModelConfig()
    t = _trellis_blocks(log2, 7 + log2 + qp)
    qpar = quant.derive_quant_params(qp, log2, log2, dep_quant=True,
                                     transform_skip=False)
    lam = jkq.lam_dq_table(rm, qp, trellis=True)
    want = jkq.trellis_depquant(jnp.asarray(t), qpar.ls, qpar.bd_shift,
                                jnp.asarray(lam), log2)
    _same(tkq.trellis_depquant(torch.as_tensor(t), qpar.ls, qpar.bd_shift,
                               lam, log2), want)
    want_p = jkq.trellis_depquant_pscan(jnp.asarray(t), qpar.ls,
                                        qpar.bd_shift, jnp.asarray(lam),
                                        log2)
    _same(tkq.trellis_depquant_pscan(torch.as_tensor(t), qpar.ls,
                                     qpar.bd_shift, lam, log2), want_p)


@pytest.mark.parametrize("log2", [2, 4])
def test_trellis_pscan_per_block_params_match_jax(log2):
    """The parallel-scan entry takes (B,) per-block ls / bd_shift."""
    rm = RateModelConfig()
    t = _trellis_blocks(log2, 3 * log2)
    qa = quant.derive_quant_params(22, log2, log2, dep_quant=True,
                                   transform_skip=False)
    qb = quant.derive_quant_params(40, log2, log2, dep_quant=True,
                                   transform_skip=False)
    B = t.shape[0]
    ls = np.where(np.arange(B) % 3 == 0, qa.ls, qb.ls).astype(np.int32)
    bd = np.where(np.arange(B) % 3 == 0, qa.bd_shift,
                  qb.bd_shift).astype(np.int32)
    lam = jkq.lam_dq_table(rm, 30, trellis=True)
    want = jkq.trellis_depquant_pscan(jnp.asarray(t), jnp.asarray(ls),
                                      jnp.asarray(bd), jnp.asarray(lam),
                                      log2)
    _same(tkq.trellis_depquant_pscan(torch.as_tensor(t), ls, bd, lam, log2),
          want)


@pytest.mark.parametrize("n", [4, 8, 32])
@pytest.mark.parametrize("dir_flag", [0, 1])
def test_bdpcm_matches_jax(n, dir_flag):
    rng = np.random.default_rng(5 + dir_flag + n)
    q = rng.integers(-(1 << 14), 1 << 14, (6, n, n)).astype(np.int32)
    d = np.array(jkq.bdpcm_dpcm(jnp.asarray(q), dir_flag))
    _same(tkq.bdpcm_dpcm(torch.as_tensor(q), dir_flag), d)
    _same(tkq.bdpcm_inverse(torch.as_tensor(d), dir_flag),
          jkq.bdpcm_inverse(jnp.asarray(d), dir_flag))
    # coded values beyond int16 and running sums that saturate
    big = rng.integers(-70000, 70000, (3, n, n)).astype(np.int32)
    _same(tkq.bdpcm_inverse(torch.as_tensor(big), dir_flag),
          jkq.bdpcm_inverse(jnp.asarray(big), dir_flag))


def test_bdpcm_inverse_clamps_per_step():
    d = np.zeros((1, 4, 4), np.int32)
    d[0, 0] = [30000, 10000, 10000, -70000]
    got = tkq.bdpcm_inverse(torch.as_tensor(d), 0)
    _same(got, jkq.bdpcm_inverse(jnp.asarray(d), 0))
    assert got[0, 0].tolist() == [30000, 32767, 32767, -1]
