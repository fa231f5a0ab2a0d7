"""Batched intra prediction in PyTorch: the 67-mode sweep as two exact
f32 matmuls.

p  = clip((v @ W1 + c1) >> s1);  p' = clip((v @ W2 + B*p + 32) >> 6)

with v = [u, filter121(u)] per block. Counterpart of
wrenc_tpu/kernels/intra_pred.py (`mats_host_f32`, `predict_all_modes_m`).
Every per-pixel sum is below 2^24, so f32 without TF32 is exact.
"""
import functools

import numpy as np
import torch

from . import intra_mats
from .transforms import f32mm


@functools.lru_cache(maxsize=None)
def mats_host_f32(size, c_idx):
    """Mode matrices with W1/W2 pre-cast to f32 (numpy, host)."""
    m = intra_mats.build_mode_matrices(size, c_idx)
    return {"W1": m["W1"].astype(np.float32),
            "W2": m["W2"].astype(np.float32),
            "c1": m["c1"], "s1": m["s1"], "clamp1": m["clamp1"],
            "B2": m["B2"]}


_MATS_DEV_CACHE = {}


def mats_device_f32(size, c_idx, device):
    """Device-resident mode matrices, uploaded once per process and device
    (~180 MB for the four luma sizes). W1/W2 are stored pre-flattened as
    (2L, 67*WH) so the sweep is one plain matmul per stage."""
    key = (size, c_idx, torch.device(device))
    if key not in _MATS_DEV_CACHE:
        m = mats_host_f32(size, c_idx)

        def flat(w):
            M, L2, WH = w.shape
            return torch.as_tensor(
                np.ascontiguousarray(w.transpose(1, 0, 2).reshape(L2, M * WH)),
                device=device)

        _MATS_DEV_CACHE[key] = {
            "W1": flat(m["W1"]), "W2": flat(m["W2"]),
            "c1": torch.as_tensor(m["c1"], device=device),
            "s1": torch.as_tensor(m["s1"], device=device),
            "clamp1": torch.as_tensor(m["clamp1"], device=device),
            "B2": torch.as_tensor(m["B2"], device=device)}
    return _MATS_DEV_CACHE[key]


def predict_all_modes_m(v, m, size):
    """67-mode sweep. v: (N, 2L) int32, m: from mats_device_f32 ->
    (N, 67, WH) int32."""
    N = v.shape[0]
    WH = size * size
    x1 = f32mm(v, m["W1"]).view(N, -1, WH)
    p1 = (x1 + m["c1"][None, :, None]) >> m["s1"][None, :, None]
    p1 = torch.where(m["clamp1"][None, :, None], torch.clamp(p1, 0, 255), p1)
    x2 = f32mm(v, m["W2"]).view(N, -1, WH)
    p2 = (x2 + m["B2"][None, :, :] * p1 + 32) >> 6
    return torch.clamp(p2, 0, 255)
