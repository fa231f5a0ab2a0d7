"""K2 (greedy dependent quantization) on the CPU: its decomposition, its
launch contract and its per-block parameters.

K2 rests on one claim: the greedy choice at a position depends on the
carried state (q_state, trailing) only through delta = q_state >> 1 and
trailing, so each position's step is a map of the 8 states, fixed by its
coefficient, packed as one word of 8 nibbles. `_k2_reference` below is a
numpy model of the kernel's three phases with the kernel's own bit
layout (records of every position, the walk through the map words, the
levels and rates recomputed from the entry states) and is held against
the JAX `greedy_depquant`, exactly. The launch descriptor is checked on
CPU tensors without a launch; chip_smoke.py holds the kernel itself
against the plain twin on the card.
"""
import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wrenc_tpu.core.config import RateModelConfig
from wrenc_tpu.kernels import quantize as jkq
from wrenc_tpu.spec import quant

from wrenc_tpu_torch.kernels import _build
from wrenc_tpu_torch.kernels import quantize as tkq

from tests.test_trellis_pallas import _adversarial_blocks

torch.set_num_threads(1)

CU = (pathlib.Path(tkq.__file__).parent / "csrc" / "dq_scan.cu").read_text()
FLAGS = 0x00888888


def _floordiv(a, b):
    return np.floor_divide(a, b)


def _k2_reference(t, ls, bd, lam, lv, log2):
    """The kernel's decomposition in numpy int32 (wrapping like the card):
    returns (q (B, n, n) int16, rate (B,) f32, map words (B, P))."""
    B = t.shape[0]
    n = 1 << log2
    order = tkq.coding_order(log2)
    tc = t.reshape(B, -1)[:, order].astype(np.int32)          # (B, P)
    ls = np.broadcast_to(np.asarray(ls, np.int32).reshape(-1, 1), tc.shape)
    bd = np.broadcast_to(np.asarray(bd, np.int32).reshape(-1, 1), tc.shape)
    lam = np.asarray(lam, np.int32)
    lv = np.asarray(lv, np.float32)
    with np.errstate(over="ignore"):
        bdo = (np.int32(1) << bd) >> 1
        neg, zero = tc < 0, tc == 0
        atc = np.abs(tc)
        s = (atc << bd) + np.where(neg, bdo, -bdo)
        base = np.where(zero, 0, _floordiv(s, ls)).astype(np.int32)
        # phase 1: the record of every position
        w = (neg.astype(np.uint32) << 19) | (zero.astype(np.uint32) << 23)
        for delta in (0, 1):
            a0 = _floordiv(base + delta, 2)
            c = {}
            for k in (0, 1):
                ak = a0 + k
                mag = np.where(ak == 0, 0, 2 * ak - delta).astype(np.int32)
                dq = (mag * ls + bdo) >> bd
                dc = np.int32(128) * np.abs(atc - dq)
                c[k, 0] = dc + lam[np.clip(ak + 1, 0, 1023)]
                c[k, 1] = np.where(ak == 0, dc + lam[0], c[k, 0])
            for tr in (0, 1):
                k = (c[1, tr] < c[0, tr]).astype(np.int32)   # ties keep a0
                a = np.where(zero, 0, a0 + k)
                nx = (4 * (a & 1) + 2 * delta
                      + (tr & (a == 0))).astype(np.uint32)
                w |= k.astype(np.uint32) << (4 * (2 * delta + tr) + 3)
                w |= nx << (4 * (4 * delta + tr))
                w |= (nx ^ 4) << (4 * (4 * delta + 2 + tr))
        # phase 2: the walk, from q_state 0 trailing (state 1)
        P = tc.shape[1]
        entry = np.empty((B, P), np.uint32)
        st = np.ones(B, np.uint32)
        for p in range(P):
            entry[:, p] = st
            st = (w[:, p] >> (4 * st)) & 7
        rec = (w & FLAGS) | entry
        # phase 3: levels and rates from the entry states
        D = (rec & 7).astype(np.int32)
        tr, delta = D & 1, D >> 2
        k = ((rec >> (4 * (2 * delta + tr) + 3)) & 1).astype(np.int32)
        a = np.where(((rec >> 23) & 1) == 1, 0,
                     _floordiv(base + delta, 2) + k)
        mag = np.where(a == 0, 0, 2 * a - delta)
        lev = np.where(((rec >> 19) & 1) == 1, -mag, mag)
        r = np.where(a == 0, np.where(tr == 1, np.float32(0), lv[0]),
                     lv[np.clip(a, 0, 1023)]).astype(np.float32)
    rate = np.zeros(B, np.float32)
    for p in range(P):                      # ascending coding order, f32
        rate = (rate + r[:, p]).astype(np.float32)
    q = np.zeros((B, n * n), np.int32)
    q[:, order] = lev
    return q.reshape(t.shape).astype(np.int16), rate, w


def _case(log2, qp):
    rm = RateModelConfig()
    qpar = quant.derive_quant_params(qp, log2, log2, dep_quant=True,
                                     transform_skip=False)
    try:
        lam = jkq.lam_dq_table(rm, qp, trellis=False)
    except AssertionError:
        # the greedy table leaves the f32-exact range at QP 51 (the JAX
        # package refuses it); the scan takes any table
        lam = jkq.lam_dq_table(rm, qp, trellis=True)
    return qpar, lam, jkq.lv_table_device(rm, True, False)


def _jax(t, ls, bd, lam, lv, log2):
    q, r = jkq.greedy_depquant(jnp.asarray(t), ls, bd, jnp.asarray(lam),
                               log2, jnp.asarray(lv))
    return np.asarray(q), np.asarray(r)


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("qp", [8, 32, 51])
def test_decomposition_matches_jax(log2, qp):
    """Per-position 8-state map words, walked, then levels and rates from
    the entry states == the sequential JAX scan, levels and f32 rate."""
    t = _adversarial_blocks(log2, seed=13 * log2 + qp)
    qpar, lam, lv = _case(log2, qp)
    q, rate, w = _k2_reference(t, qpar.ls, qpar.bd_shift, lam, lv, log2)
    q_j, r_j = _jax(t, qpar.ls, qpar.bd_shift, lam, lv, log2)
    assert (q == q_j).all()
    assert (rate == r_j).all()
    # every nibble is a state; the choice sees only (delta, trailing): the
    # two states of one input (q_state 2 delta and 2 delta + 1) lead to
    # states that differ exactly in the parity bit of the next q_state
    nib = [(w >> (4 * s)) & 7 for s in range(8)]
    for delta in (0, 1):
        for tr in (0, 1):
            assert ((nib[4 * delta + tr] ^ nib[4 * delta + 2 + tr])
                    == 4).all()


def test_decomposition_wraps_like_the_scan():
    """Coefficients near the int32 range (t << bd_shift wraps) still give
    the scan's levels and rate."""
    rng = np.random.default_rng(8)
    t = rng.integers(-(1 << 30), 1 << 30, (6, 8, 8)).astype(np.int32)
    t[0, :2] = np.iinfo(np.int32).max
    qpar, lam, lv = _case(3, 32)
    q, rate, _ = _k2_reference(t, qpar.ls, qpar.bd_shift, lam, lv, 3)
    q_j, r_j = _jax(t, qpar.ls, qpar.bd_shift, lam, lv, 3)
    assert (q == q_j).all() and (rate == r_j).all()


def test_greedy_depquant_per_block_params():
    """(B,) per-block ls / bd_shift equal per-group JAX calls."""
    log2 = 4
    t = _adversarial_blocks(log2, seed=61)
    qa, lam, lv = _case(log2, 22)
    qb = quant.derive_quant_params(37, log2, log2, dep_quant=True,
                                   transform_skip=False)
    B = t.shape[0]
    even = np.arange(B) % 2 == 0
    ls = np.where(even, qa.ls, qb.ls).astype(np.int32)
    bd = np.where(even, qa.bd_shift, qb.bd_shift).astype(np.int32)
    q_t, r_t = tkq.greedy_depquant(torch.as_tensor(t), torch.as_tensor(ls),
                                   torch.as_tensor(bd), lam, log2, lv)
    for par, sel in ((qa, slice(0, None, 2)), (qb, slice(1, None, 2))):
        q_j, r_j = _jax(t[sel], par.ls, par.bd_shift, lam, lv, log2)
        assert (q_t[sel].numpy() == q_j).all()
        assert (r_t[sel].numpy() == r_j).all()
    q_m, r_m, _ = _k2_reference(t, ls, bd, lam, lv, log2)
    assert (q_m == q_t.numpy()).all() and (r_m == r_t.numpy()).all()


def _outs(t):
    return (torch.empty(t.shape, dtype=torch.int16),
            torch.empty((t.shape[0],), dtype=torch.float32))


@pytest.mark.parametrize("layout", ["row", "col", "one_block_col"])
def test_k2_desc_reads_t_in_place(layout):
    """Row-major blocks, and the DCT's column-major ones, are read where
    they lie: the descriptor holds t's own pointer and a layout flag."""
    from wrenc_tpu_torch.kernels import transforms
    res = torch.zeros((5 if layout != "one_block_col" else 1, 8, 8),
                      dtype=torch.int32)
    t = transforms.forward_impl(res)
    if layout == "row":
        t = t.contiguous()
    desc = tkq.k2_desc(t, 7, 3, 3, *_outs(t))
    j = desc.job[0]
    assert desc.n_jobs == 1
    assert j.t == t.data_ptr() and j.B == t.shape[0] and j.log2_n == 3
    assert j.t_transposed == (layout != "row")


def test_k2_desc_params_by_value_or_in_place():
    t = torch.zeros((5, 4, 4), dtype=torch.int32)
    q, rate = _outs(t)
    j = tkq.k2_desc(t, 9, 4, 2, q, rate).job[0]
    assert (j.ls, j.bd, j.ls_val, j.bd_val) == (None, None, 9, 4)
    assert (j.q, j.rate) == (q.data_ptr(), rate.data_ptr())
    rows = torch.arange(5, dtype=torch.int32)
    one = torch.tensor([6], dtype=torch.int32)
    j = tkq.k2_desc(t, rows, one, 2, q, rate).job[0]
    assert (j.ls, j.ls_stride) == (rows.data_ptr(), 1)
    assert (j.bd, j.bd_stride) == (one.data_ptr(), 0)
    # a tensor already as the kernel takes it is passed as it is
    assert tkq._param(rows, 5, rows.device) is rows
    assert tkq._param(np.int32(3), 5, rows.device) == 3


def test_k2_desc_empty_batch():
    t = torch.zeros((0, 8, 8), dtype=torch.int32)
    assert tkq.k2_desc(t, 1, 1, 3, *_outs(t)).n_jobs == 0


@pytest.mark.parametrize("case", [
    "int64_t", "non_dense_t", "gapped_batch", "ls_length", "bd_dtype",
    "q_dtype", "rate_shape", "bad_size", "three_lanes"])
def test_k2_desc_refuses(case):
    B = 5
    t = torch.zeros((B, 8, 8), dtype=torch.int32)
    ls, bd, lg, lanes = 7, 3, 3, None
    q, rate = _outs(t)
    if case == "int64_t":
        t = t.to(torch.int64)
    elif case == "non_dense_t":
        t = torch.zeros((B, 8, 16), dtype=torch.int32)[:, :, ::2]
    elif case == "gapped_batch":
        t = torch.zeros((2 * B, 8, 8), dtype=torch.int32)[::2]
    elif case == "ls_length":
        ls = torch.zeros(B - 1, dtype=torch.int32)
    elif case == "bd_dtype":
        bd = torch.zeros(B, dtype=torch.int64)
    elif case == "q_dtype":
        q = q.to(torch.int32)
    elif case == "rate_shape":
        rate = rate[:-1]
    elif case == "bad_size":
        lg = 2
    elif case == "three_lanes":
        lanes = 3
    with pytest.raises(ValueError):
        tkq.k2_desc(t, ls, bd, lg, q, rate, lanes)


def test_lanes_rule():
    """1 lane per block only for a large batch of 4 x 4 blocks (stage A's
    smallest size), else 8."""
    big = tkq.K2_ONE_LANE_MIN_B
    assert tkq.k2_lanes(2, big) == 1 and tkq.k2_lanes(2, big - 1) == 8
    assert tkq.k2_lanes(3, 10 * big) == 8 and tkq.k2_lanes(5, 1) == 8
    t = torch.zeros((3, 16, 16), dtype=torch.int32)
    assert tkq.k2_desc(t, 1, 1, 4, *_outs(t)).lanes == 8
    t = torch.zeros((big, 4, 4), dtype=torch.int32)
    assert tkq.k2_desc(t, 1, 1, 2, *_outs(t)).lanes == 1


def test_launch_dispatches_only_its_outputs(monkeypatch):
    """The CUDA route's host side, run on CPU tensors with the library
    call stubbed: it dispatches the two output allocations and no other
    operator (no gather, transpose, scatter, cast or parameter copy),
    and hands the library t's own pointer."""
    from torch.utils._python_dispatch import TorchDispatchMode
    import contextlib
    calls = []

    class Lib:
        def dq_greedy_launch(self, desc, lam, lv, order, stream):
            calls.append((desc.job[0].t, desc.job[0].q, lam, lv, order))
            return 0
    monkeypatch.setattr(_build, "lib", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    from wrenc_tpu_torch.kernels import transforms
    t = transforms.forward_impl(torch.zeros((6, 16, 16), dtype=torch.int32))
    args = (torch.tensor([7], dtype=torch.int32),
            torch.tensor([3], dtype=torch.int32),
            torch.zeros(1024, dtype=torch.int32),
            torch.zeros(1024, dtype=torch.float32), 4)
    tkq.order_table(t.device)
    ops = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))
    with Count():
        q, rate = tkq._launch_k2(t, *args)
    assert ops == ["empty", "empty"]
    assert q.dtype == torch.int16 and q.shape == t.shape
    assert calls == [(t.data_ptr(), q.data_ptr(), args[2].data_ptr(),
                      args[3].data_ptr(), tkq.order_table("cpu").data_ptr())]


def test_launcher_signature_matches_the_kernel_source():
    """dq_greedy_launch takes the K1Desc by value, then the tables, the
    coding orders and the stream, as its ctypes signature says."""
    sig = re.search(r"int dq_greedy_launch\(([^)]*)\)", CU).group(1)
    types = [re.sub(r"\s*\w+$", "", a.strip()) for a in sig.split(",")]
    assert types == ["K1Desc", "const int*", "const float*",
                     "const int16_t*", "void*"]
    assert _build._SIGNATURES["dq_scan"]["dq_greedy_launch"] == [
        _build.K1Desc] + [ctypes.c_void_p] * 4
    assert re.search(r"constexpr uint32_t K2_FLAGS = 0x00888888u;", CU)
