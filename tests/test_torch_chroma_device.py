"""The port's device chroma stage A against the JAX package's, on the CPU.

`fused_chroma_stage_a` against the JAX `_fused_chroma_builder` on the same
inputs, every output bit for bit; the port's device chroma against its
native chroma (within tests/test_chroma_device.py's tolerance: one path
combines in f32, the other in f64); whole encodes with device chroma
against the JAX encodes in the same configuration (bytes and
reconstruction); the chroma and engine defaults against the JAX search's;
and the device engine's fallback to the native engine. Every comparison is
exact unless a tolerance is stated. On the CPU the RD chain runs K2's (or,
under stage_a_trellis_rd=1, K1's) plain twin; chip_smoke.py holds both
kernels against their twins on the card at the chroma shapes.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wrenc_tpu.core.config import EncoderConfig
from wrenc_tpu.encoder import Encoder as JaxEncoder
from wrenc_tpu.kernels import intra_pred as jip
from wrenc_tpu.search import WavefrontSearch as JaxSearch
from wrenc_tpu.search import wavefront as jwf

from wrenc_tpu_torch.conformance import decode_annexb_independent
from wrenc_tpu_torch.core import config as tconfig
from wrenc_tpu_torch.decoder import decode_annexb
from wrenc_tpu_torch.encoder import Encoder
from wrenc_tpu_torch.search import WavefrontSearch
from wrenc_tpu_torch.search import wavefront as twf

from tests.test_torch_native_ref import jax_native_host_build  # noqa: F401
from tests.test_entropy_roundtrip import synth_frame

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_engine_env(monkeypatch):
    monkeypatch.delenv("WRENC_COMMIT_ENGINE", raising=False)
    monkeypatch.delenv("WRENC_CHROMA_STAGE_A", raising=False)


def _port_cfg(cfg):
    return tconfig.config_from_dict(dataclasses.asdict(cfg))


def _cfg(w, h, qp, trellis=0, **kw):
    cfg = EncoderConfig(width=w, height=h, qp=qp, **kw)
    cfg.rate_model.stage_a_trellis_rd = float(trellis)
    return cfg


# ------------------------------------------------------- fused chroma stage A
def _builder_inputs(cfg, F, seed):
    """Seeded planes (noise over a gradient) and luma modes of every QT
    size, as a chunk of F frames would give them."""
    rng = np.random.default_rng(seed)
    W, H = cfg.width, cfg.height
    yy, xx = np.mgrid[0:H, 0:W]
    py = np.clip((xx * 3 + yy * 2) % 256 + rng.integers(-40, 41, (F, H, W)),
                 0, 255).astype(np.uint8)
    pcb = rng.integers(0, 256, (F, H // 2, W // 2)).astype(np.uint8)
    pcr = np.clip(255 - py[:, ::2, ::2] // 2
                  + rng.integers(-30, 31, (F, H // 2, W // 2)),
                  0, 255).astype(np.uint8)
    sizes = [1 << (cfg.log2_ctu_size - d)
             for d in range(cfg.max_split_depth, -1, -1)]
    modes = {s: rng.integers(0, 67, (F, (H // s) * (W // s)))
             for s in sizes}
    return (py.reshape(F, -1), pcb.reshape(F, -1), pcr.reshape(F, -1),
            sizes, modes)


def _chroma_search(cfg):
    """The port's search with device chroma: its stage-A arguments then
    hold the chroma entries."""
    return WavefrontSearch(_port_cfg(cfg), chroma_stage_a='device',
                           device='cpu')


def _tie_lam(lam, bits, ulp_exp=-10):
    """The first f32 lambda above `lam` whose product with one of the CCLM
    mode bits rounds (inexactly) to an odd multiple of 2^(ulp_exp - 1):
    then, for CCLM costs of ulp 2^ulp_exp (8192 to 16384 at -10), adding
    the rounded product lands on a tie that the exact product does not,
    and one rounding and two part ways."""
    x = np.float32(lam)
    while True:
        x = np.nextafter(x, np.float32(np.inf), dtype=np.float32)
        for b in bits:
            exact = float(x) * float(b)
            p = float(np.float32(exact))
            if p != exact and (p / 2.0 ** (ulp_exp - 1)) % 2 == 1:
                return x


def _run_both(cfg, F=2, seed=0, lam=None):
    """The JAX builder and the port's function on the same inputs, each
    fed as its own search's _prefill_chroma_device feeds it (lam: another
    f32 lambda for both)."""
    py, pcb, pcr, sizes, modes = _builder_inputs(cfg, F, seed)
    W, H = cfg.width, cfg.height
    css = tuple(sorted(s // 2 for s in sizes if s >= 8))
    scipu = 4 in sizes and 8 in sizes

    def sc_modes():
        if not scipu:
            return np.zeros((F, 1), np.int32)
        return modes[4].reshape(F, H // 4, W // 4)[:, 1::2, 1::2] \
            .reshape(F, -1).astype(np.int32)

    js = JaxSearch(cfg)
    tr = bool(cfg.rate_model.stage_a_trellis_rd)
    run = jwf._fused_chroma_builder(W, H, cfg.log2_ctu_size, css, F,
                                    bool(cfg.cclm_enabled), scipu, tr)
    dep = cfg.dep_quant_enabled
    rm = cfg.rate_model
    bits = np.float32([rm.pick('cclm_offset', dep, True)
                       + (i + rm.pick('cclm_mode_idx_offset', dep, True))
                       ** rm.cclm_pow for i in range(3)])
    lam = np.float32(js.lam if lam is None else lam)
    want = run(py, pcb, pcr,
               {cs: modes[2 * cs].astype(np.int32) for cs in css},
               sc_modes(),
               np.int32([js.qpar[(1, lg)].ls for lg in (2, 3, 4)]),
               np.int32([js.qpar[(1, lg)].bd_shift for lg in (2, 3, 4)]),
               jnp.asarray(js.lam_dq_trellis if tr else js.lam_dq_greedy),
               jnp.asarray(js.lv_trellis if tr else js.lv_greedy),
               lam, bits,
               {('c', cs): jip.mats_device_f32(cs, 1) for cs in css})
    want = jax.tree_util.tree_map(np.asarray, want)

    ts = _chroma_search(cfg)
    assert ts._chroma_sizes() == css
    args = ts._stage_a_args()
    assert (args['cclm_bits'].numpy() == bits).all()
    got = twf.fused_chroma_stage_a(
        torch.as_tensor(py), torch.as_tensor(pcb), torch.as_tensor(pcr), W,
        H, cfg.log2_ctu_size, css, bool(cfg.cclm_enabled), scipu,
        args['trellis'],
        {cs: torch.as_tensor(modes[2 * cs]) for cs in css},
        torch.as_tensor(sc_modes()), args['ls_c'], args['bd_c'],
        args['lam_dq'], args['lv'], torch.as_tensor(lam),
        args['cclm_bits'], args['mats_c'])
    assert float(args['lam']) == np.float32(js.lam)
    return want, got


@pytest.mark.parametrize("case", [
    "64x64_qp32", "96x64_qp22_trellis", "64x96_qp37_no_cclm", "depth2",
    "64x64_qp32_cclm_tie"])
def test_fused_chroma_matches_jax_builder(case):
    """Every output bit for bit. The last case takes a lambda (_tie_lam)
    at which the CCLM mode-bit term's one rounding (XLA's contraction)
    and two roundings give different costs."""
    cfg = {"64x64_qp32": lambda: _cfg(64, 64, 32),
           "96x64_qp22_trellis": lambda: _cfg(96, 64, 22, trellis=1),
           "64x96_qp37_no_cclm": lambda: _cfg(64, 96, 37,
                                              cclm_enabled=False),
           "depth2": lambda: _cfg(64, 64, 27, max_split_depth=2),
           "64x64_qp32_cclm_tie": lambda: _cfg(64, 64, 32)}[case]()
    lam = None
    if case.endswith("tie"):
        ts = _chroma_search(cfg)
        lam = _tie_lam(ts.lam, ts._stage_a_args()['cclm_bits'].numpy())
    want, got = _run_both(cfg, seed=len(case), lam=lam)
    assert set(got) == set(want)
    assert (('sc', 4) in got) == (case != "depth2")
    assert any(k[0] == 'cc' for k in got) == cfg.cclm_enabled
    for k, w in want.items():
        g = got[k]
        if k[0] == 'cc':
            assert g[1].dtype == torch.int8
            assert (g[1].numpy() == w[1]).all(), k
            assert len(set(g[1].numpy().ravel().tolist())) > 1, k
            g, w = g[0], w[0]
        assert g.dtype == torch.float32 and g.shape == w.shape, k
        assert (g.numpy() == w).all(), (k, int((g.numpy() != w).sum()))


def test_fused_chroma_runs_one_rd_chain_per_cost(monkeypatch):
    """cb and cr go through the RD chain (and so K2 or K1 on the card) in
    one batch: per chroma size one call for the derived modes, one for the
    SCIPU variant at cs = 4, one for the three CCLM candidates; and the
    stage-A arguments hold the chroma entries only under device chroma."""
    cfg = _cfg(64, 64, 32)
    F = 2
    calls = []
    inner = twf._rd_eval_inner

    def spy(pred, *a, **k):
        calls.append((pred.shape[1], pred.shape[0]))
        return inner(pred, *a, **k)
    monkeypatch.setattr(twf, "_rd_eval_inner", spy)
    _run_both(cfg, F=F)
    n = {cs: (32 // cs) ** 2 for cs in (4, 8, 16)}
    assert calls == [(4, 2 * F * n[4]), (4, 2 * F * n[4]), (4, 6 * F * n[4]),
                     (8, 2 * F * n[8]), (8, 6 * F * n[8]),
                     (16, 2 * F * n[16]), (16, 6 * F * n[16])]
    native = WavefrontSearch(_port_cfg(cfg), device='cpu')._stage_a_args()
    assert not {'ls_c', 'bd_c', 'cclm_bits', 'mats_c'} & set(native)


def test_rd_cost_matches_jax():
    """The stage-A RD cost ssd + lam * (rate / 16384) of luma and chroma,
    which XLA contracts into one FMA, on random costs where two roundings
    differ."""
    rng = np.random.default_rng(8)
    n = 20000
    ssd = rng.integers(0, 300000, n).astype(np.float32)
    rate = rng.integers(0, 1 << 24, n).astype(np.float32)
    lam = np.float32(37.71234)
    want = np.asarray(jax.jit(lambda s, r, l: s + l * (r / 16384.0))(
        ssd, rate, lam))
    got = twf._rd_cost(torch.as_tensor(ssd), torch.as_tensor(rate),
                              torch.as_tensor(lam)).numpy()
    two = ssd + lam * (rate / np.float32(16384.0))
    assert (got == want).all()
    assert (two != want).any()


# ---------------------------------------------------- device vs native chroma
class _Captured(Exception):
    pass


@pytest.mark.parametrize("w,h,qp,seeds", [
    (96, 64, 32, (5, 6)), (64, 96, 22, (7,)),
])
def test_device_chroma_matches_native_chroma(w, h, qp, seeds):
    """Mirror of tests/test_chroma_device.py on the port: both chroma
    engines on identical stage-A inputs; costs within f32 accuracy, and
    CCLM picks that differ only at near-ties, under 2 %."""
    ws = WavefrontSearch(_port_cfg(_cfg(w, h, qp)), commit_engine='device',
                         device='cpu')
    assert ws._chroma_device
    got = {}
    orig = ws._prefill_chroma_device
    frames = [synth_frame(w, h, seed=s) for s in seeds]

    def spy(cache, luma_mode_b, sizes, F, dev_planes):
        orig(cache, luma_mode_b, sizes, F, dev_planes)
        ncache = {}
        ws._prefill_chroma_cache(ncache, luma_mode_b, sizes, [
            [np.asarray(p, np.int32) for p in f] for f in frames])
        got['dev'], got['nat'] = dict(cache), ncache
        raise _Captured

    ws._prefill_chroma_device = spy
    with pytest.raises(_Captured):
        ws.encode_frames(frames)
    dev, nat = got['dev'], got['nat']
    assert set(dev) == set(nat)
    ties = total = 0
    for key in sorted(nat):
        if key[0] == 'cclm':
            (cd, md), (cn, mn) = dev[key], nat[key]
            np.testing.assert_allclose(cd, cn, rtol=2e-5, atol=0.5,
                                       err_msg=str(key))
            diff = md != mn
            ties += int(diff.sum())
            total += int(mn.size)
            assert diff.mean() < 0.02, (key, int(diff.sum()))
        else:
            np.testing.assert_allclose(dev[key], nat[key], rtol=2e-5,
                                       atol=0.5, err_msg=str(key))
    assert ties / max(total, 1) < 0.02, (ties, total)


# ------------------------------------------------------------------ encodes
def _strip_frame(W, H):
    """tests/test_large_frames.py's 1920-wide strip content."""
    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[0:H, 0:W]
    y = np.clip(np.sin(xx / 19) * 70 + np.cos(yy / 7) * 40 + 128
                + rng.integers(-6, 7, (H, W)), 0, 255).astype(np.uint8)
    return (y, (y[::2, ::2] // 2 + 50).astype(np.uint8),
            (210 - y[::2, ::2] // 2).astype(np.uint8))


def _check_encode(cfg, frames, jax_kw, port_kw):
    want, want_rec = JaxEncoder(cfg, search=JaxSearch(cfg, **jax_kw)) \
        .encode(frames)
    search = WavefrontSearch(_port_cfg(cfg), device='cpu', **port_kw)
    got, rec = Encoder(_port_cfg(cfg), search=search).encode(frames)
    assert got == want
    for k in range(len(frames)):
        for c in range(3):
            assert (rec[k][c] == want_rec[k][c]).all(), (k, c)
    return search, got, rec


@pytest.mark.parametrize("case", ["64x64", "96x64_trellis", "1920x64_wpp"])
def test_device_chroma_encode_matches_jax(case):
    """Native engine with device chroma: bytes and reconstruction equal to
    the JAX encode; the port's own decoders reproduce the
    reconstruction."""
    if case == "64x64":
        cfg = _cfg(64, 64, 30)
        frames = [synth_frame(64, 64, seed=40 + k) for k in range(2)]
    elif case == "96x64_trellis":
        cfg = _cfg(96, 64, 27, trellis=1)
        frames = [synth_frame(96, 64, seed=50)]
    else:
        cfg = _cfg(1920, 64, 34, entropy_coding_sync_enabled=True,
                   entry_point_offsets_present=True)
        frames = [_strip_frame(1920, 64)]
    kw = {"chroma_stage_a": "device"}
    search, stream, rec = _check_encode(cfg, frames, kw, kw)
    assert search._chroma_device and not search._device_commit
    for decoded in (decode_annexb(stream), decode_annexb_independent(stream)):
        assert len(decoded) == len(frames)
        for k in range(len(frames)):
            for c in range(3):
                assert (np.asarray(decoded[k][c]) == rec[k][c]).all()


def test_device_engine_default_matches_jax():
    """The device engine in its default configuration (device chroma):
    bytes equal to the JAX device engine's."""
    cfg = _cfg(64, 64, 32)
    frames = [synth_frame(64, 64, seed=60)]
    kw = {"commit_engine": "device"}
    search, _, _ = _check_encode(cfg, frames, kw, kw)
    assert search._device_commit and search._chroma_device


@pytest.mark.parametrize("engine", ["native", "device"])
@pytest.mark.parametrize("w,h", [(352, 288), (1024, 512), (1920, 1088),
                                 (3840, 2176)])
def test_chroma_default_follows_jax(w, h, engine):
    """The chroma engine and the stage-A batch buckets the search picks,
    on construction, against the JAX search's."""
    cfg = EncoderConfig(width=w, height=h, qp=32)
    js = JaxSearch(cfg, commit_engine=engine)
    ts = WavefrontSearch(_port_cfg(cfg), commit_engine=engine, device='cpu')
    assert ts._device_commit == js._device_commit == (engine == "device")
    assert ts._chroma_device == js._chroma_device
    assert ts._chroma_device == (engine == "device" or w * h >= 1 << 19)
    assert ts._buckets() == js._buckets()
    assert ts.commit_engine == js.commit_engine == engine


@pytest.mark.parametrize("off", ["commit_rank_full", "commit_rank_trellis",
                                 "commit_chroma_redecide", "dep_quant"])
def test_device_engine_falls_back_like_jax(off):
    """commit_engine='device' with a rate-model switch off, or without
    dep-quant, runs the native engine (and the chroma default of the
    geometry), byte-identical to the JAX search with the same
    arguments."""
    cfg = _cfg(64, 64, 29)
    if off == "dep_quant":
        cfg.dep_quant_enabled = False
    else:
        setattr(cfg.rate_model, off, 0.0)
    frames = [synth_frame(64, 64, seed=70)]
    kw = {"commit_engine": "device"}
    search, _, _ = _check_encode(cfg, frames, kw, kw)
    assert search.commit_engine == "device"
    assert not search._device_commit and not search._chroma_device
