"""End to end on the CPU: the port's encode is byte-identical to the JAX
WavefrontSearch encode, and both of the repo's decoders, and the port's
own two, reproduce the port's reconstruction."""
import dataclasses

import numpy as np
import pytest
import torch

from wrenc_tpu.conformance import decode_annexb_independent
from wrenc_tpu.core.config import EncoderConfig
from wrenc_tpu.decoder import decode_annexb
from wrenc_tpu.encoder import Encoder as JaxEncoder
from wrenc_tpu.search import WavefrontSearch as JaxSearch

from wrenc_tpu_torch.conformance import (
    decode_annexb_independent as port_independent)
from wrenc_tpu_torch.core import config as tconfig
from wrenc_tpu_torch.decoder import decode_annexb as port_decode
from wrenc_tpu_torch.encoder import Encoder
from wrenc_tpu_torch.search import WavefrontSearch

from tests.test_torch_native_ref import jax_native_host_build  # noqa: F401
from tests.test_entropy_roundtrip import synth_frame

torch.set_num_threads(1)


def _cfg(w, h, qp, trellis):
    cfg = EncoderConfig(width=w, height=h, qp=qp)
    cfg.rate_model.stage_a_trellis_rd = float(trellis)
    return cfg


def _port_encode(cfg, frames):
    pcfg = tconfig.config_from_dict(dataclasses.asdict(cfg))
    return Encoder(pcfg, search=WavefrontSearch(pcfg, device='cpu')).encode(
        frames)


def test_config_from_dict_round_trips():
    cfg = EncoderConfig(width=96, height=64, qp=29,
                        entropy_coding_sync_enabled=True)
    cfg.rate_model.stage_a_trellis_rd = 1.0
    cfg.rate_model.split_refine_margin = 0.3
    d = dataclasses.asdict(cfg)
    port = tconfig.config_from_dict(d)
    assert isinstance(port, tconfig.EncoderConfig)
    assert isinstance(port.rate_model, tconfig.RateModelConfig)
    assert dataclasses.asdict(port) == d
    with pytest.raises(TypeError):
        tconfig.config_from_dict(dict(d, not_a_field=1))


@pytest.mark.parametrize("w,h,qp,trellis", [
    (64, 64, 27, 0), (96, 64, 37, 0), (64, 64, 32, 1), (96, 64, 27, 1),
    # 4 x 5 CTUs: the commit's row wavefront runs rows on several threads
    (160, 128, 32, 0)])
def test_encode_bytes_match_jax(w, h, qp, trellis):
    cfg = _cfg(w, h, qp, trellis)
    frames = [synth_frame(w, h, seed=qp + k) for k in range(2)]
    want, want_rec = JaxEncoder(cfg, search=JaxSearch(cfg)).encode(frames)
    got, rec = _port_encode(cfg, frames)
    assert got == want
    for k in range(2):
        for c in range(3):
            assert (rec[k][c] == want_rec[k][c]).all()


@pytest.mark.parametrize("trellis", [0, 1])
def test_port_stream_decodes_to_reconstruction(trellis):
    cfg = _cfg(64, 64, 30, trellis)
    frames = [synth_frame(64, 64, seed=70 + k) for k in range(2)]
    stream, recons = _port_encode(cfg, frames)
    for decoded in (decode_annexb(stream), port_decode(stream),
                    decode_annexb_independent(stream),
                    port_independent(stream)):
        assert len(decoded) == 2
        for k in range(2):
            for c in range(3):
                assert (np.asarray(decoded[k][c]) == recons[k][c]).all()


@pytest.mark.parametrize("qp", [48, 51])
def test_high_qp_refused_like_the_reference(qp):
    """A fault shared with the JAX package (ROADMAP.md queue 3): the greedy
    lambda table leaves its asserted f32-exact range from QP 48 on, so
    both searches refuse QP 48..63 when they are built."""
    cfg = EncoderConfig(width=64, height=64, qp=qp)
    with pytest.raises(AssertionError, match="lam_dq"):
        JaxSearch(cfg)
    with pytest.raises(AssertionError, match="lam_dq"):
        WavefrontSearch(tconfig.config_from_dict(dataclasses.asdict(cfg)),
                        device='cpu')
