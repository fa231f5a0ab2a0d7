"""The port's scalar search and clean-room decoder, on the CPU.

`wrenc_tpu_torch.spec.encoder.ScalarEncoder` and
`wrenc_tpu_torch.conformance` are copies of the JAX package's numpy
modules. Held here: the scalar encoder's bytes and reconstruction against
the JAX package's; the port's clean-room decoder against the port's
reconstruction (WavefrontSearch and WPP streams), against the JAX
oracle's verdict on a stream with a dropped syntax element, and bin for
bin against the encoder's CABAC trace; and the CLI's `--search scalar`
and `--independent` end to end. Every comparison is exact.
"""
import dataclasses

import pytest
import torch

from wrenc_tpu.conformance import ConformanceError as JaxConformanceError
from wrenc_tpu.conformance import decode_annexb_independent as jax_oracle
from wrenc_tpu.core.config import EncoderConfig as JaxConfig
from wrenc_tpu.encoder import Encoder as JaxEncoder
from wrenc_tpu.spec.encoder import ScalarEncoder as JaxScalar

from wrenc_tpu_torch.conformance import (ConformanceError,
                                         decode_annexb_independent)
from wrenc_tpu_torch.core import config as tconfig
from wrenc_tpu_torch.core.config import EncoderConfig
from wrenc_tpu_torch.encoder import Encoder
from wrenc_tpu_torch.search import WavefrontSearch
from wrenc_tpu_torch.spec.encoder import ScalarEncoder

from tests.test_torch_native_ref import jax_native_host_build  # noqa: F401
from tests.test_conformance_oracle import synth

torch.set_num_threads(1)


@pytest.mark.parametrize("w,h,qp,seed", [(32, 32, 32, 1), (64, 32, 37, 3)])
def test_scalar_encoder_matches_jax(w, h, qp, seed):
    jcfg = JaxConfig(width=w, height=h, qp=qp)
    frame = synth(w, h, seed)
    want, want_rec = JaxEncoder(jcfg, search=JaxScalar(jcfg)).encode([frame])
    cfg = tconfig.config_from_dict(dataclasses.asdict(jcfg))
    got, rec = Encoder(cfg, search=ScalarEncoder(cfg)).encode([frame])
    assert got == want
    for c in range(3):
        assert (rec[0][c] == want_rec[0][c]).all(), c
    frames = decode_annexb_independent(got)
    assert len(frames) == 1
    for c in range(3):
        assert (frames[0][c] == rec[0][c]).all(), c


def _wavefront_encode(cfg, frames, **kw):
    return Encoder(cfg, search=WavefrontSearch(cfg, device='cpu'),
                   **kw).encode(frames)


@pytest.mark.parametrize("wpp", [False, True])
def test_independent_decode_matches_port_reconstruction(wpp):
    """A WavefrontSearch stream, and a two-frame WPP stream with
    slice-header entry points, through the port's clean-room decoder."""
    cfg = EncoderConfig(width=64, height=64, qp=30 if wpp else 27)
    if wpp:
        cfg.entropy_coding_sync_enabled = True
        cfg.entry_point_offsets_present = True
    fr = [synth(64, 64, 5 + k) for k in range(2 if wpp else 1)]
    stream, recons = _wavefront_encode(cfg, fr)
    frames = decode_annexb_independent(stream)
    assert len(frames) == len(fr)
    for k in range(len(fr)):
        for c in range(3):
            assert (frames[k][c] == recons[k][c]).all(), (k, c)


def test_oracle_catches_missing_syntax_element(monkeypatch):
    """Mirror of tests/test_conformance_oracle.py: drop mts_idx from the
    port's encoder (Python syntax layer); the port's oracle detects the
    desync with the JAX oracle's verdict (the same exception and
    message, or the same mismatching pictures)."""
    from wrenc_tpu_torch.core.tables import SE
    from wrenc_tpu_torch.entropy.syntax import SliceSyntax

    orig = SliceSyntax._bin

    def drop_mts(self, se, inc, v=None):
        if se == SE.MtsIdx:
            return 0
        return orig(self, se, inc, v)

    monkeypatch.setattr(SliceSyntax, "_bin", drop_mts)
    cfg = EncoderConfig(width=64, height=64, qp=27)
    stream, recons = _wavefront_encode(cfg, [synth(64, 64, 7)],
                                       use_native=False)

    def verdict(decode, errors):
        try:
            frames = decode(stream)
        except errors as e:
            return type(e).__name__, str(e)
        return "decoded", [bool((frames[0][c] == recons[0][c]).all())
                           for c in range(3)]

    errs = (AssertionError, IndexError, ValueError)
    got = verdict(decode_annexb_independent, (ConformanceError,) + errs)
    want = verdict(jax_oracle, (JaxConformanceError,) + errs)
    assert got == want
    assert got[0] != "decoded" or not all(got[1]), got


def test_per_bin_trace_alignment():
    """The port's encoder CABAC trace and the port's clean-room decoder
    trace agree bin for bin."""
    import wrenc_tpu_torch.entropy.cabac as cab

    enc_trace = []
    orig_init = cab.CabacEncoder.__init__

    def patched(self, wtr, trace=None):
        orig_init(self, wtr, trace=enc_trace)

    cab.CabacEncoder.__init__ = patched
    try:
        cfg = EncoderConfig(width=64, height=64, qp=27)
        stream, _ = _wavefront_encode(cfg, [synth(64, 64, 8)],
                                      use_native=False)
    finally:
        cab.CabacEncoder.__init__ = orig_init
    dec_trace = []
    decode_annexb_independent(stream, trace=dec_trace)
    assert enc_trace and len(enc_trace) == len(dec_trace)
    for i, (e, d) in enumerate(zip(enc_trace, dec_trace)):
        assert e == d[:3], (i, e, d)


@pytest.mark.parametrize("independent", [False, True])
def test_cli_scalar_search_end_to_end(independent, tmp_path):
    """tools/encode.py --search scalar, then tools/decode.py (with and
    without --independent): the decoded YUV equals the encoder's
    --reconst output, and the stream equals the scalar encode's."""
    from wrenc_tpu_torch.tools import decode, encode, yuv
    w, h = 32, 32
    frame = synth(w, h, 11)
    src = tmp_path / "in.yuv"
    yuv.write_yuv420(str(src), [frame])
    out, rec, dec = (str(tmp_path / n) for n in ("o.vvc", "r.yuv", "d.yuv"))
    assert encode.main(["-i", str(src), "-o", out, "-r", rec,
                        "--input-size", f"{w}x{h}", "--output-size",
                        f"{w}x{h}", "--num-pictures", "1", "--qp", "33",
                        "--search", "scalar"]) == 0
    assert decode.main(["-i", out, "-o", dec]
                       + (["--independent"] if independent else [])) == 0
    with open(rec, "rb") as a, open(dec, "rb") as b:
        assert a.read() == b.read()
    cfg = EncoderConfig(width=w, height=h, qp=33)
    want, _ = Encoder(cfg, search=ScalarEncoder(cfg)).encode([frame])
    with open(out, "rb") as f:
        assert f.read() == want
