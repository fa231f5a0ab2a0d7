"""The port's luma stage A against the JAX package's, on the CPU.

The fused stage A (reference gathers, 67-mode sweep, SAD top-K, RD chain
with the greedy or trellis quantizer, MPM-Jacobi selection and ranking)
must give EXACTLY the JAX outputs: ranked int8 candidates, best cost and
top-2 costs, bit for bit. No tolerance is needed: the f32 cost combines
`ssd + lam*rate` and `base + sc*bits`, which XLA contracts into fused
multiply-adds, are computed as single-rounding FMAs in the port too.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wrenc_tpu.core.config import EncoderConfig
from wrenc_tpu.entropy.syntax import derive_mpm_list
from wrenc_tpu.search import WavefrontSearch as JaxSearch
from wrenc_tpu.search import wavefront as jwf

from wrenc_tpu_torch.core.config import config_from_dict
from wrenc_tpu_torch.search import WavefrontSearch
from wrenc_tpu_torch.search import wavefront as twf

from tests.test_torch_native_ref import jax_native_host_build  # noqa: F401
from tests.test_entropy_roundtrip import synth_frame

torch.set_num_threads(1)


def test_mpm_list_matches_derive_mpm_list():
    ll, aa = np.meshgrid(np.arange(67), np.arange(67), indexing='ij')
    got = twf._mpm_list_dev(torch.as_tensor(ll.ravel()),
                            torch.as_tensor(aa.ravel())).numpy()
    want = np.array([derive_mpm_list(int(l), int(a))
                     for l, a in zip(ll.ravel(), aa.ravel())])
    assert (got == want).all()
    dev = np.asarray(jwf._mpm_list_dev(jnp.asarray(ll.ravel(), jnp.int32),
                                       jnp.asarray(aa.ravel(), jnp.int32)))
    assert (got == dev).all()


@pytest.mark.parametrize("w,h", [(64, 64), (96, 64)])
@pytest.mark.parametrize("qp", [22, 37])
@pytest.mark.parametrize("trellis", [0, 1])
def test_fused_luma_stage_a_matches_jax(w, h, qp, trellis):
    import dataclasses
    cfg = EncoderConfig(width=w, height=h, qp=qp)
    cfg.rate_model.stage_a_trellis_rd = float(trellis)
    frames = [synth_frame(w, h, seed=qp + k) for k in range(3)]
    _, sizes, res_j, _ = JaxSearch(cfg)._dispatch_stage_a(frames)
    ws = WavefrontSearch(config_from_dict(dataclasses.asdict(cfg)),
                         device='cpu')
    _, sizes_t, res_t, _, _ = ws._dispatch_stage_a(frames)
    assert sizes_t == sizes
    for s in sizes:
        rk_j, cost_j, c2_j = (np.asarray(x) for x in res_j[s])
        rk_t, cost_t, c2_t = (x.numpy() for x in res_t[s])
        assert rk_t.dtype == np.int8 and rk_t.shape == rk_j.shape
        assert (rk_t == rk_j).all(), s
        assert (cost_t == cost_j).all(), s
        assert (c2_t == c2_j).all(), s
