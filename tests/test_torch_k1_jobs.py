"""K1's launch descriptor and its batched entry, on the CPU.

`pack_jobs` builds the by-value descriptor of one K1 launch from shapes
and pointers; these tests hold its grouping, order and CTA offsets, its
refusals, and the ctypes mirror of its struct against csrc/dq_scan.cu. The
batched entry on CPU tensors (its plain twin) is held against the JAX
`trellis_rate_batch`, exactly. chip_smoke.py holds the kernel itself
against the plain twin on the card.
"""
import ctypes
import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wrenc_tpu.core.config import RateModelConfig
from wrenc_tpu.kernels import quantize as jkq
from wrenc_tpu.kernels import trellis_pallas
from wrenc_tpu.spec import quant

from wrenc_tpu_torch.kernels import _build
from wrenc_tpu_torch.kernels import quantize as tkq
from wrenc_tpu_torch.kernels import trellis as ttl

torch.set_num_threads(1)

CU = (pathlib.Path(ttl.__file__).parent / "csrc" / "dq_scan.cu").read_text()


def _job(log2, B, ls=7, bd=3):
    n = 1 << log2
    t = torch.zeros((B, n, n), dtype=torch.int32)
    return (t, ls, bd, log2), (torch.empty((B, n, n), dtype=torch.int16),
                               torch.empty((B,), dtype=torch.float32))


@pytest.mark.parametrize("mix", [
    [(3, 5), (2, 1), (5, 3), (4, 4753), (3, 2), (2, 4)],
    [(2, 1)],
    [(5, 16), (5, 17), (2, 3)],
    [(2, 7), (3, 5), (4, 6), (5, 1), (2, 2), (3, 3), (4, 4), (5, 5)],
])
def test_pack_jobs_orders_and_offsets(mix):
    pairs = [_job(lg, B) for lg, B in mix]
    jobs, outs = [p[0] for p in pairs], [p[1] for p in pairs]
    desc = ttl.pack_jobs(jobs, outs)
    # largest block size first, stable within a size
    want = sorted(range(len(mix)), key=lambda i: -mix[i][0])
    assert desc.n_jobs == len(mix)
    cta = 0
    for slot, i in enumerate(want):
        j = desc.job[slot]
        lg, B = mix[i]
        assert (j.log2_n, j.B, j.cta_begin) == (lg, B, cta)
        assert j.t == jobs[i][0].data_ptr()
        assert j.q == outs[i][0].data_ptr()
        assert j.rate == outs[i][1].data_ptr()
        assert (j.ls, j.bd, j.ls_val, j.bd_val) == (None, None, 7, 3)
        cta += -(-B // (32 // desc.lanes))
    assert desc.n_ctas == cta
    assert desc.max_log2_n == max(lg for lg, _ in mix)
    # the CTA ranges are ascending, as the kernel's job lookup needs
    begins = [desc.job[k].cta_begin for k in range(desc.n_jobs)]
    assert begins == sorted(begins)


def test_pack_jobs_params_by_value_or_pointer():
    B = 5
    (t, _, _, lg), out = _job(3, B)
    rows = torch.arange(B, dtype=torch.int32)
    one = torch.tensor([9], dtype=torch.int32)
    desc = ttl.pack_jobs([(t, rows, one, lg)], [out])
    j = desc.job[0]
    assert (j.ls, j.ls_stride) == (rows.data_ptr(), 1)
    assert (j.bd, j.bd_stride) == (one.data_ptr(), 0)
    # B = 1 with a one-value tensor: stride 0
    (t1, _, _, _), out1 = _job(2, 1)
    j1 = ttl.pack_jobs([(t1, one, 4, 2)], [out1]).job[0]
    assert (j1.ls_stride, j1.bd, j1.bd_val) == (0, None, 4)


def test_pack_jobs_reads_the_dct_layout_in_place():
    """The DCT leaves each block column-major (strides (n*n, 1, n)); K1
    reads that layout without a copy, flagged per job."""
    from wrenc_tpu_torch.kernels import transforms
    res = torch.zeros((3, 8, 8), dtype=torch.int32)
    t = transforms.forward_impl(res)
    assert not t.is_contiguous() and t.stride() == (64, 1, 8)
    (_, _, _, _), out = _job(3, 3)
    rowm = t.contiguous()
    one = rowm[:1].transpose(1, 2)               # B = 1: any batch stride
    desc = ttl.pack_jobs([(t, 1, 1, 3), (rowm, 1, 1, 3), (one, 1, 1, 3)],
                         [out, _job(3, 3)[1], _job(3, 1)[1]])
    assert [desc.job[k].t_transposed for k in range(3)] == [1, 0, 1]
    assert desc.job[0].t == t.data_ptr()


def test_lanes_rule():
    """One lane per block only for one large job of 4 x 4 blocks (stage
    A's smallest size); 32 blocks per CTA then."""
    big = _job(2, ttl.ONE_LANE_MIN_B)
    assert ttl.k1_lanes([big[0]]) == 1
    assert ttl.k1_lanes([_job(2, ttl.ONE_LANE_MIN_B - 1)[0]]) == 8
    assert ttl.k1_lanes([_job(3, ttl.ONE_LANE_MIN_B)[0]]) == 8
    assert ttl.k1_lanes([big[0], _job(2, 3)[0]]) == 8
    desc = ttl.pack_jobs([big[0]], [big[1]])
    assert desc.lanes == 1
    assert desc.n_ctas == -(-ttl.ONE_LANE_MIN_B // 32)
    (j, out) = _job(2, 65)
    desc = ttl.pack_jobs([j], [out], lanes=1)
    assert (desc.lanes, desc.n_ctas) == (1, 3)
    desc = ttl.pack_jobs([j], [out], lanes=8)
    assert (desc.lanes, desc.n_ctas) == (8, 17)


def test_pack_jobs_skips_empty_jobs():
    pairs = [_job(4, 0), _job(2, 3)]
    desc = ttl.pack_jobs([p[0] for p in pairs], [p[1] for p in pairs])
    assert desc.n_jobs == 1 and desc.n_ctas == 1
    assert desc.job[0].log2_n == 2 and desc.max_log2_n == 2


@pytest.mark.parametrize("case", [
    "too_many_jobs", "int64_t", "non_dense_t", "gapped_batch",
    "ls_length",
    "bd_length", "ls_dtype", "bad_size", "q_dtype", "rate_shape",
    "ls_float", "one_lane_8x8", "four_lanes"])
def test_pack_jobs_refuses(case):
    B = 5
    (t, ls, bd, lg), (q, rate) = _job(3, B)
    jobs = [(t, ls, bd, lg)]
    outs = [(q, rate)]
    if case == "too_many_jobs":
        pairs = [_job(2, 1) for _ in range(ttl.K1_MAX_JOBS + 1)]
        jobs, outs = [p[0] for p in pairs], [p[1] for p in pairs]
    elif case == "int64_t":
        jobs = [(t.to(torch.int64), ls, bd, lg)]
    elif case == "non_dense_t":
        jobs = [(torch.zeros((B, 8, 16), dtype=torch.int32)[:, :, ::2], ls,
                 bd, lg)]
    elif case == "gapped_batch":
        jobs = [(torch.zeros((2 * B, 8, 8), dtype=torch.int32)[::2], ls, bd,
                 lg)]
    elif case == "ls_length":
        jobs = [(t, torch.zeros(B - 2, dtype=torch.int32), bd, lg)]
    elif case == "bd_length":
        jobs = [(t, ls, torch.zeros(B + 1, dtype=torch.int32), lg)]
    elif case == "ls_dtype":
        jobs = [(t, torch.zeros(B, dtype=torch.int64), bd, lg)]
    elif case == "bad_size":
        jobs = [(t, ls, bd, 4)]
    elif case == "q_dtype":
        outs = [(q.to(torch.int32), rate)]
    elif case == "rate_shape":
        outs = [(q, rate[:-1])]
    elif case == "ls_float":
        jobs = [(t, 1.5, bd, lg)]
    with pytest.raises(ValueError):
        ttl.pack_jobs(jobs, outs, {"one_lane_8x8": 1,
                                   "four_lanes": 4}.get(case))


def test_descriptor_layout_matches_the_kernel_source():
    """The ctypes mirror's field order and byte layout, against the
    struct definitions of csrc/dq_scan.cu (the library's own sizeof is
    checked when it is loaded on the card)."""
    ctype = {"const int*": ctypes.c_void_p, "int16_t*": ctypes.c_void_p,
             "float*": ctypes.c_void_p, "int": ctypes.c_int}
    for struct, mirror in (("K1Job", _build.K1Job),
                           ("K1Desc", _build.K1Desc)):
        body = re.search(r"struct %s \{(.*?)\};" % struct, CU, re.S).group(1)
        fields = re.findall(r"^\s*([\w*\s]+?[\w*])\s+(\w+)(\[\w+\])?;",
                            body, re.M)
        assert [f[1] for f in fields] == [f[0] for f in mirror._fields_]
        for (typ, name, arr), (_, mtype) in zip(fields, mirror._fields_):
            if arr:
                assert mtype is _build.K1Job * ttl.K1_MAX_JOBS
            else:
                assert mtype is ctype[typ], name
    assert ctypes.sizeof(_build.K1Job) == 72
    assert ctypes.sizeof(_build.K1Desc) == 72 * 8 + 16
    assert _build.K1Desc.n_jobs.offset == 576
    assert re.search(r"constexpr int K1_MAX_JOBS = (\d+);", CU).group(1) \
        == str(ttl.K1_MAX_JOBS)


def test_order_table_concatenates_the_coding_orders():
    """Size log2_n's coding order starts at (4^log2_n - 16) / 3, as the
    kernel's order_offset computes it."""
    tab = ttl.order_table(torch.device("cpu")).numpy()
    assert tab.dtype == np.int16 and tab.shape == (16 + 64 + 256 + 1024,)
    for lg in tkq.LOG2_SIZES:
        P = 1 << (2 * lg)
        off = (P - 16) // 3
        assert (tab[off:off + P] == tkq.coding_order(lg)).all()
        assert sorted(tab[off:off + P]) == list(range(P))


def test_order_table_is_one_upload_per_device(monkeypatch):
    """'cuda' (a device without an index, as the search holds it) and
    'cuda:<current>' (a tensor's device, as a launch reads it) share one
    table; so do 'cpu' and torch.device('cpu')."""
    assert ttl.order_table("cpu") is ttl.order_table(torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    made = []

    @functools.lru_cache(maxsize=None)
    def fake(device):
        made.append(device)
        return object()
    monkeypatch.setattr(tkq, "_order_table", fake)
    a = ttl.order_table(torch.device("cuda"))
    assert ttl.order_table(torch.device("cuda", 0)) is a
    assert ttl.order_table("cuda:0") is a
    assert made == [torch.device("cuda", 0)]


def _jax_batch(jobs, lam, lv):
    lgs = [j[3] for j in jobs]
    return jax.jit(lambda ts, lss, bds, lam, lv: trellis_pallas
                   .trellis_rate_batch(list(zip(ts, lss, bds, lgs)), lam,
                                       lv))(*(
        [jnp.asarray(j[i]) for j in jobs] for i in range(3)),
        jnp.asarray(lam), jnp.asarray(lv))


@pytest.mark.parametrize("mix", [[(3, 1)], [(2, 3), (2, 5)],
                                 [(4, 1), (2, 1), (4, 2)]])
def test_trellis_rate_batch_small_matches_jax(mix):
    """B = 1, and two jobs of one size in one wave, per-row ls/bd."""
    rng = np.random.default_rng(sum(lg * 7 + B for lg, B in mix))
    rm = RateModelConfig()
    lam = jkq.lam_dq_table(rm, 27, trellis=True)
    lv = jkq.lv_table_device(rm, True, True)
    jobs = []
    for log2, B in mix:
        s = 1 << log2
        t = rng.integers(-700, 700, (B, s, s)).astype(np.int32)
        t[0, 1:] = rng.integers(-2, 3, (s - 1, s))
        qps = rng.choice([22, 32, 37], B)
        par = [quant.derive_quant_params(int(q), log2, log2, dep_quant=True,
                                         transform_skip=False) for q in qps]
        jobs.append((t, np.array([p.ls for p in par], np.int32),
                     np.array([p.bd_shift for p in par], np.int32), log2))
    want = _jax_batch(jobs, lam, lv)
    launches = ttl.trellis_rate_batch.launches
    got = ttl.trellis_rate_batch(
        [(torch.as_tensor(t), torch.as_tensor(ls), torch.as_tensor(bd), lg)
         for t, ls, bd, lg in jobs], torch.as_tensor(lam),
        torch.as_tensor(lv))
    assert ttl.trellis_rate_batch.launches == launches     # plain twin
    for (qg, rg), (qw, rw), job in zip(got, want, jobs):
        assert qg.dtype == torch.int16 and qg.shape == job[0].shape
        assert (qg.numpy() == np.asarray(qw)).all()
        assert (rg.numpy() == np.asarray(rw)).all()
