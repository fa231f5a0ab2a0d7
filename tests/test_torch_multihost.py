"""The port's multi-process stage A (wrenc_tpu_torch/dist/process_group.py,
wrenc_tpu_torch/tools/multihost_smoke.py) on the CPU.

Two gloo processes run the row-band stage A of scripts/multihost_smoke.py
(W, H, F = 64, 128, 2, the same seeded planes) in both layouts, frame 2 x
row 4 (the frame axis spans the processes) and frame 1 x row 2 (the halo
crosses them), each rank through the search's own `_dispatch_mesh`; the
gathered result must equal the JAX one-device `_fused_luma_builder`'s
exactly. In one process, a group of one rank gives the single-process
mesh's `_dispatch_mesh` result. A failing or
hanging worker fails the run, and its workers are stopped.
"""
import socket

import numpy as np
import pytest
import torch

import jax

from wrenc_tpu.core.config import RateModelConfig
from wrenc_tpu.kernels import intra_pred
from wrenc_tpu.kernels import quantize as jkq
from wrenc_tpu.search.wavefront import _fused_luma_builder
from wrenc_tpu.spec import quant

from wrenc_tpu_torch import dist
from wrenc_tpu_torch.core.config import EncoderConfig
from wrenc_tpu_torch.dist import process_group as pg
from wrenc_tpu_torch.search import WavefrontSearch
from wrenc_tpu_torch.search import wavefront as twf
from wrenc_tpu_torch.tools import multihost_smoke as mh
from wrenc_tpu_torch.tools.scaling_bench import stage_a_args

torch.set_num_threads(1)

SIZES = (4, 8, 16, 32)


def _jax_single():
    """scripts/multihost_smoke.py's one-device reference, verbatim in its
    arguments."""
    W, H, F, QP = mh.W, mh.H, mh.F, mh.QP
    planes = np.random.default_rng(0).integers(
        0, 256, (F, H, W)).astype(np.int32)
    rm = RateModelConfig()
    qpar = {s: quant.derive_quant_params(
        QP, s.bit_length() - 1, s.bit_length() - 1, dep_quant=True,
        transform_skip=False) for s in SIZES}
    ls = {s: np.int32(qpar[s].ls) for s in SIZES}
    bd = {s: np.int32(qpar[s].bd_shift) for s in SIZES}
    lam = np.float32(2.0 ** (QP / rm.qp_div_dq_trellis)
                     * rm.lambda_mul_dq_trellis)
    mats = {s: intra_pred.mats_device_f32(s, 0) for s in SIZES}
    run = _fused_luma_builder(W, H, 5, SIZES, F, 4)
    out = run(jax.device_put(planes), ls, bd,
              jax.device_put(jkq.lam_dq_table(rm, QP, trellis=False)),
              jax.device_put(jkq.lv_table_device(rm, True, False)), lam,
              mats)
    return {s: tuple(np.asarray(x) for x in out[s]) for s in SIZES}


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("multihost") / "gathered.npz"
    res = mh.run(device="cpu", out=str(out), timeout=240)
    return res, np.load(out)


@pytest.mark.parametrize("layout", ["2x4", "1x2"])
def test_two_processes_match_jax_single_device(layout, two_process_run):
    res, got = two_process_run
    assert res["ok"], res
    assert [r["rank"] for r in sorted(res["ranks"],
                                      key=lambda r: r["rank"])] == [0, 1]
    cells = {r["rank"]: r["layouts"][layout]["cells"] for r in res["ranks"]}
    if layout == "2x4":       # one frame cell's four bands per process
        assert cells == {0: [[0, r] for r in range(4)],
                         1: [[1, r] for r in range(4)]}
    else:                     # one band per process: the halo crosses
        assert cells == {0: [[0, 0]], 1: [[0, 1]]}
    want = _jax_single()
    for s in SIZES:
        for i, w in enumerate(want[s]):
            g = got[f"{layout}_s{s}_{i}"]
            assert g.dtype == w.dtype and g.shape == w.shape, (s, i)
            assert g.tobytes() == w.tobytes(), (s, i)


@pytest.mark.parametrize("shape,world,want", [
    ((2, 4), 2, [[(0, 0), (0, 1), (0, 2), (0, 3)],
                 [(1, 0), (1, 1), (1, 2), (1, 3)]]),
    ((1, 2), 2, [[(0, 0)], [(0, 1)]]),
    ((2, 3), 3, [[(0, 0), (0, 1)], [(0, 2), (1, 0)], [(1, 1), (1, 2)]]),
])
def test_cells_are_split_by_rank_in_row_major_order(shape, world, want):
    assert [pg.rank_cells(shape, r, world) for r in range(world)] == want
    for r, cells in enumerate(want):
        assert all(pg.owner(c, shape, world) == r for c in cells)


def test_uneven_split_raises():
    with pytest.raises(ValueError, match="equal runs"):
        pg.rank_cells((1, 3), 0, 2)


def test_one_rank_group_equals_the_single_process_mesh():
    """_dispatch_mesh as rank 0 of a group of one rank, its cells gathered
    by gather_cells, gives the no-group _dispatch_mesh's cells as
    _fetch_cells assembles them, on a (2, 4) grid of CPU cells."""
    W, H, F = 64, 128, 4
    planes = np.random.default_rng(3).integers(
        0, 256, (F, H, W)).astype(np.uint8)
    cpu = torch.device("cpu")
    search = WavefrontSearch(EncoderConfig(width=W, height=H, qp=30),
                             mesh=dist.make_mesh([cpu] * 8, frame_axis=2))
    pg.init_group(0, 1, pg.free_port())
    try:
        got = twf._fetch_cells(pg.gather_cells(
            search._dispatch_mesh(planes, list(SIZES), 0, 1), 1))
    finally:
        torch.distributed.destroy_process_group()
    want = twf._fetch_cells(search._dispatch_mesh(planes, list(SIZES)))
    for s in SIZES:
        for g, w in zip(got[s], want[s]):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes(), s


def test_a_failing_worker_fails_the_run(monkeypatch):
    """SMOKE_PORT names a port another socket holds: rank 0 cannot open
    the group's store and fails; its peer, left waiting, is stopped."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        s.listen()
        monkeypatch.setenv("SMOKE_PORT", str(s.getsockname()[1]))
        res = mh.run(device="cpu", timeout=240)
    assert not res["ok"] and res["failure"] == "a worker failed", res
    assert all(rc is not None for rc in res["returncodes"])


def test_a_hanging_worker_is_stopped():
    res = mh.run(device="cpu", timeout=0.5)
    assert not res["ok"] and res["failure"].startswith("timeout")
    assert all(rc is not None for rc in res["returncodes"])
