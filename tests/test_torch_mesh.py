"""The port's sharded stage A against the JAX package's, on the CPU.

`WavefrontSearch(cfg, mesh=...)` over a `wrenc_tpu_torch.dist.Mesh` of
CPU device copies (a device may repeat; the JAX tests' counterpart is
the 8 virtual CPU devices of tests/conftest.py): the frame mesh, the
(frame, row) mesh with its one-row halo, the trellis stage A and the
device commit engine give the JAX mesh search's bytes, which are the
single-device bytes; the row-band stage A's per-size outputs equal
`_fused_luma_sharded_builder`'s; unaligned bands raise as they do there;
`tools/encode.py --dp`. Every comparison is exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec

from wrenc_tpu import dist as jdist
from wrenc_tpu.core.config import EncoderConfig
from wrenc_tpu.encoder import Encoder as JaxEncoder
from wrenc_tpu.search import WavefrontSearch as JaxSearch
from wrenc_tpu.search import wavefront as jwf

from wrenc_tpu_torch import dist
from wrenc_tpu_torch.core import config as tconfig
from wrenc_tpu_torch.encoder import Encoder
from wrenc_tpu_torch.search import WavefrontSearch
from wrenc_tpu_torch.search import wavefront as twf
from wrenc_tpu_torch.tools import encode as tencode
from wrenc_tpu_torch.tools import yuv

from tests.test_torch_native_ref import jax_native_host_build  # noqa: F401

torch.set_num_threads(1)

CPU = torch.device('cpu')


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for k in ("WRENC_COMMIT_ENGINE", "WRENC_CHROMA_STAGE_A",
              "WRENC_STAGE_A_SELECT"):
        monkeypatch.delenv(k, raising=False)


def _port_cfg(cfg):
    return tconfig.config_from_dict(dataclasses.asdict(cfg))


def _frames(W, H, seed, n=3):
    """tests/test_wavefront.py's mesh frames."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for i in range(n):
        y = np.clip(np.sin(xx / 6 + i) * 70 + np.cos(yy / 11) * 40 + 120
                    + rng.integers(-6, 7, (H, W)), 0, 255).astype(np.uint8)
        cb = (y[::2, ::2] // 2 + 50).astype(np.uint8)
        cr = (210 - y[::2, ::2] // 2).astype(np.uint8)
        out.append((y, cb, cr))
    return out


def _meshes(frame, row):
    """The JAX mesh of frame x row virtual CPU devices and the port's of
    as many CPU cells; row None makes a 1-D ('frame',) mesh."""
    n = frame * (row or 1)
    jd = np.array(jax.devices()[:n])
    if row is None:
        return (JaxMesh(jd, ("frame",)),
                dist.Mesh([CPU] * frame, ("frame",)))
    return (JaxMesh(jd.reshape(frame, row), ("frame", "row")),
            dist.make_mesh([CPU] * n, frame_axis=frame))


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_matches_jax(n):
    jm = jdist.make_mesh(jax.devices()[:n])
    tm = dist.make_mesh([torch.device('cpu')] * n)
    assert tm.shape == dict(jm.shape)
    assert tm.axis_names == tuple(jm.axis_names) == ("frame", "row")
    assert all(d == CPU for d in tm.devices.reshape(-1))
    for fa in (1, n):
        assert dist.make_mesh([CPU] * n, frame_axis=fa).shape == dict(
            jdist.make_mesh(jax.devices()[:n], frame_axis=fa).shape)


def _check_mesh(cfg, frames, frame, row, single=None, **kw):
    """Port mesh bytes == JAX mesh bytes == port single-device bytes
    (single: the single-device search's arguments, default kw), and the
    reconstructions equal."""
    jmesh, tmesh = _meshes(frame, row)
    want, want_rec = JaxEncoder(cfg, search=JaxSearch(
        cfg, mesh=jmesh, **kw)).encode(frames)
    pcfg = _port_cfg(cfg)
    search = WavefrontSearch(pcfg, mesh=tmesh, **kw)
    got, rec = Encoder(pcfg, search=search).encode(frames)
    one, one_rec = Encoder(pcfg, search=WavefrontSearch(
        pcfg, device='cpu', **(kw if single is None else single))) \
        .encode(frames)
    assert got == want
    assert got == one
    for k in range(len(frames)):
        for c in range(3):
            assert (rec[k][c] == want_rec[k][c]).all(), (k, c)
            assert (rec[k][c] == one_rec[k][c]).all(), (k, c)
    return search


@pytest.mark.parametrize("cells", [2, 8])
def test_frame_mesh_matches_jax_and_single(cells):
    """3 frames over 2 and 8 frame cells: the bucket's padding, then the
    padding to a multiple of the frame axis."""
    cfg = EncoderConfig(width=96, height=64, qp=30)
    search = _check_mesh(cfg, _frames(96, 64, 9), cells, None)
    assert search.device == CPU and search._cells.shape == (cells, 1)


def test_frame_mesh_host_select_matches_jax(monkeypatch):
    """The (2, 2) mesh at 96x64: its band stage A returns unselected
    candidates, so the port selects the luma winners on the host
    (_select_modes), and only there."""
    calls = []
    select = WavefrontSearch._select_modes
    monkeypatch.setattr(WavefrontSearch, "_select_modes",
                        lambda self, s, *a: calls.append(s) or select(
                            self, s, *a))
    cfg = EncoderConfig(width=96, height=64, qp=33)
    _check_mesh(cfg, _frames(96, 64, 4), 2, 2)
    assert sorted(set(calls)) == [4, 8, 16, 32] and len(calls) == 4


def test_frame_mesh_device_chroma_runs_native_like_jax():
    """A mesh uploads no shared planes, so chroma stage A runs in the
    native library even when the device one is asked for."""
    cfg = EncoderConfig(width=96, height=64, qp=30)
    frames = _frames(96, 64, 3, n=2)
    search = _check_mesh(cfg, frames, 2, None,
                         single={"chroma_stage_a": "native"},
                         chroma_stage_a="device")
    assert search._chroma_device
    assert search._dispatch_stage_a(frames)[3] is None


def test_row_mesh_matches_jax_and_single():
    """The (2, 4) mesh at 96x128: one CTU row per band, halo rows from
    the band above (tests/test_wavefront.py's row-band case)."""
    cfg = EncoderConfig(width=96, height=128, qp=30)
    _check_mesh(cfg, _frames(96, 128, 11), 2, 4)


def test_row_mesh_trellis_stage_a_matches_jax_and_single():
    cfg = EncoderConfig(width=96, height=128, qp=32)
    cfg.rate_model.stage_a_trellis_rd = 1.0
    _check_mesh(cfg, _frames(96, 128, 12, n=2), 2, 4)


def test_mesh_device_engine_matches_jax_and_single():
    """commit_engine='device' under a (2, 2) mesh: the engine uploads its
    own planes (the sharded stage A shares none) and chroma stage A runs
    native, as in the JAX search."""
    cfg = EncoderConfig(width=64, height=64, qp=30)
    _check_mesh(cfg, _frames(64, 64, 13), 2, 2,
                single={"commit_engine": "device",
                        "chroma_stage_a": "native"},
                commit_engine="device")


@pytest.mark.parametrize("trellis", [0, 1])
def test_band_stage_a_matches_jax_builder(trellis):
    """Per size, the row-band stage A's (cands, cost) over a (1, 4) mesh
    (three interior bands: an off-by-one in the band-local offset shows
    on every band's top row) equal _fused_luma_sharded_builder's."""
    W, H, F = 96, 128, 2
    cfg = EncoderConfig(width=W, height=H, qp=29)
    cfg.rate_model.stage_a_trellis_rd = float(trellis)
    planes = np.stack([f[0] for f in _frames(W, H, 21 + trellis, n=F)])
    jmesh, tmesh = _meshes(1, 4)
    js = JaxSearch(cfg, mesh=jmesh)
    sizes = (4, 8, 16, 32)
    sharded = jax.device_put(planes, NamedSharding(
        jmesh, PartitionSpec("frame", "row", None)))
    want = js._fused_luma(F, sizes)(sharded)
    ts = WavefrontSearch(_port_cfg(cfg), mesh=tmesh)
    cells = ts._dispatch_mesh(planes, sizes)
    assert len(cells) == 1 and len(cells[0]) == 4
    got = twf._fetch_cells(cells)
    for s in sizes:
        (jc, jcost), (tc, tcost) = want[s], got[s]
        jc, jcost = np.asarray(jc), np.asarray(jcost)
        assert tc.dtype == jc.dtype and tcost.dtype == jcost.dtype
        assert tc.shape == jc.shape == (F, (H // s) * (W // s), 6)
        assert (tc == jc).all(), s
        assert tcost.tobytes() == jcost.tobytes(), s


@pytest.mark.parametrize("rows", [3, 8])
def test_unaligned_bands_raise_like_jax(rows):
    """128 rows in 3 bands (unequal) or 8 (16 rows, not a CTU row)."""
    W, H = 96, 128
    sizes = (4, 8, 16, 32)
    jmesh, tmesh = _meshes(1, rows)
    with pytest.raises(AssertionError, match="CTU-row-aligned"):
        jwf._fused_luma_sharded_builder(W, H, 5, sizes, 1, 4, jmesh, False)
    cfg = _port_cfg(EncoderConfig(width=W, height=H, qp=30))
    with pytest.raises(AssertionError, match="CTU-row-aligned"):
        Encoder(cfg, search=WavefrontSearch(cfg, mesh=tmesh)).encode(
            _frames(W, H, 1, n=1))


def test_mesh_arguments_checked():
    cfg = _port_cfg(EncoderConfig(width=64, height=64))
    mesh = dist.Mesh(['cpu', 'cpu'], ("frame",))
    assert WavefrontSearch(cfg, mesh=mesh, device='cpu').device == CPU
    with pytest.raises(ValueError, match="first cell"):
        WavefrontSearch(cfg, mesh=mesh, device='meta')
    with pytest.raises(ValueError, match="axes"):
        WavefrontSearch(cfg, mesh=dist.Mesh(['cpu'], ("row",)))
    with pytest.raises(ValueError):
        dist.Mesh(['cpu', 'cpu'], ("frame", "row"))
    assert dist.Mesh(np.array([['cpu', 'cpu']], dtype=object),
                     ("frame", "row")).shape == {"frame": 1, "row": 2}


def test_encode_cli_dp_matches_single(tmp_path, capsys):
    W, H = 96, 64
    src = tmp_path / "in.yuv"
    yuv.write_yuv420(str(src), _frames(W, H, 17))
    base = ["-i", str(src), "--input-size", f"{W}x{H}", "--output-size",
            f"{W}x{H}", "--num-pictures", "3", "--qp", "31", "--device",
            "cpu"]
    out = {}
    for dp in (2, 1, 0):
        path = tmp_path / f"dp{dp}.vvc"
        assert tencode.main(base + ["-o", str(path), "--dp", str(dp)]) == 0
        err = capsys.readouterr().err
        assert ("frame-parallel over 2 devices" in err) == (dp == 2), err
        out[dp] = path.read_bytes()
    assert out[2] == out[1] == out[0]
