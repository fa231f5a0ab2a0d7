"""Batched dependent quantization in PyTorch.

Counterpart of wrenc_tpu/kernels/quantize.py for the stage-A path:
`coding_order`, `lam_dq_table`, `lv_table_device` (numpy tables, copied),
`dequantize`, and `greedy_depquant` — the greedy dep-quant scan with the
RD level rate. The JAX version's one-hot MXU lookups (`_lut1024_i32`) are
a TPU workaround; here a rate-table lookup is a plain index with the same
clip to [0, 1023].

`greedy_depquant` launches the hand-written CUDA kernel K2 (`dq_greedy`
in csrc/dq_scan.cu) for CUDA tensors and runs `greedy_depquant_plain`,
its plain PyTorch twin, for CPU tensors.
"""
import functools

import numpy as np
import torch

from ..spec import quant as squant
from . import _build


@functools.lru_cache(maxsize=None)
def coding_order(log2_n):
    """Flattened (P,) indices into an n*n block in coding (reverse scan)
    order: flat index = y*n + x."""
    scan = squant.full_scan(log2_n, log2_n)[::-1]
    n = 1 << log2_n
    return (scan[:, 1] * n + scan[:, 0]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _order_dev(log2_n, device):
    return torch.as_tensor(coding_order(log2_n).astype(np.int64),
                           device=device)


def lam_dq_table(rate_model, qp, trellis):
    """Exact int32 table lam_q * dq_rate_table (the quantizer cost model's
    rate term, quantizer.rs:29 with integer lambda). Values stay below
    2^24 (asserted), as in the JAX package."""
    i = np.arange(1024, dtype=np.float64)
    dq = ((i * 16384.0) ** rate_model.quant_lv_pow).astype(np.int64)
    qp_div = rate_model.quant_qp_div_trellis if trellis else rate_model.quant_qp_div
    mul = rate_model.quant_lambda_mul_trellis if trellis else rate_model.quant_lambda_mul
    off = (rate_model.quant_lambda_offset_trellis if trellis
           else rate_model.quant_lambda_offset)
    lam = int(2.0 ** (qp / qp_div) * mul) + off
    out = lam * dq
    assert 0 <= out.min() and out.max() < (1 << 24), \
        "lam_dq values exceed the f32-exact LUT range"
    return out.astype(np.int32)


def lv_table_device(rate_model, dep_quant, trellis):
    """RD level-rate table (block_splitter.rs:45-53) as f32 (integral
    values below 2^24, asserted)."""
    i = np.arange(1024, dtype=np.float64)
    if not dep_quant:
        p, off = rate_model.lv_pow, rate_model.lv_offset
    elif trellis:
        p, off = rate_model.lv_pow_dq_trellis, rate_model.lv_offset_dq_trellis
    else:
        p, off = rate_model.lv_pow_dq, rate_model.lv_offset_dq
    out = ((i + off) ** p * 16384.0).astype(np.int64)
    assert 0 <= out.min() and out.max() < (1 << 24), \
        "lv values exceed the f32-exact LUT range"
    return out.astype(np.float32)


def param_rows(v, B, device):
    """A scalar or (B,) per-block quant parameter as an int32 tensor:
    shape (1,) for a scalar, (B,) per block."""
    t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                        else v, device=device).to(torch.int32).reshape(-1)
    if t.numel() not in (1, B):
        raise ValueError(f"quant parameter of {t.numel()} values for "
                         f"{B} blocks")
    return t


def table(v, dtype, device):
    t = torch.as_tensor(v, device=device).to(dtype).contiguous()
    if t.shape != (1024,):
        raise ValueError(f"rate table of shape {tuple(t.shape)}, want (1024,)")
    return t


def to_coding_order(t, log2_n):
    """(B, n, n) -> (B, P) int32 in coding order."""
    n = 1 << log2_n
    if t.dim() != 3 or tuple(t.shape[1:]) != (n, n):
        raise ValueError(f"blocks of shape {tuple(t.shape)}, want (B, {n}, {n})")
    B = t.shape[0]
    return t.reshape(B, -1)[:, _order_dev(log2_n, t.device)].to(torch.int32)


def from_coding_order(qf, log2_n):
    """(B, P) levels in coding order -> (B, n, n) int16 raster."""
    B = qf.shape[0]
    n = 1 << log2_n
    q = torch.zeros((B, n * n), dtype=torch.int32, device=qf.device)
    q[:, _order_dev(log2_n, qf.device)] = qf.to(torch.int32)
    return q.reshape(B, n, n).to(torch.int16)


def trans_next(q_state, parity):
    """Q_STATE_TRANS[q, p] == ((q ^ p) & 1) * 2 + (q >> 1), elementwise."""
    return ((q_state ^ parity) & 1) * 2 + (q_state >> 1)


def greedy_depquant(t, ls, bd_shift, lam_dq, log2_n, lv_table):
    """Greedy dependent quantization + RD level-rate, batched.

    t: (B, n, n) int32 transform coefficients; ls/bd_shift scalars or (B,);
    lam_dq: (1024,) int32 lambda-scaled quantizer rate table; lv_table:
    (1024,) f32 RD level-rate table. Returns (q (B,n,n) int16 stored
    levels, rate (B,) f32). CUDA tensors launch kernel K2; CPU tensors
    take greedy_depquant_plain."""
    if t.device.type == 'cpu':
        return greedy_depquant_plain(t, ls, bd_shift, lam_dq, log2_n,
                                     lv_table)
    if not t.is_cuda:
        raise ValueError(f"greedy_depquant: unsupported device {t.device}")
    tf = to_coding_order(t, log2_n).T.contiguous()        # (P, B)
    q, rate = launch_dq(tf, ls, bd_shift, lam_dq, lv_table)
    greedy_depquant.launches += 1
    return from_coding_order(q.T, log2_n), rate


greedy_depquant.launches = 0


def kernel_params(ls, bd_shift, B, device):
    """ls / bd_shift for a kernel launch: both (1,) with per_block 0, or
    both (B,) with per_block 1."""
    lsr = param_rows(ls, B, device)
    bdr = param_rows(bd_shift, B, device)
    if lsr.numel() == 1 and bdr.numel() == 1:
        return lsr.contiguous(), bdr.contiguous(), 0
    return (lsr.expand(B).contiguous(), bdr.expand(B).contiguous(), 1)


def launch_dq(tf, ls, bd_shift, lam_dq, lv_table):
    """One launch of K2 (dq_greedy) from csrc/dq_scan.cu, the one place
    that calls its C interface. tf: (P, B) contiguous int32 coefficients
    in coding order, position-major, on a CUDA device; the other
    arguments as in greedy_depquant. Returns (levels (P, B) int32, rate
    (B,) f32). Raises on a launch error. The wrapper, not this helper,
    counts main-path launches. (K1 is launched by kernels/trellis.py.)"""
    P, B = tf.shape
    dev = tf.device
    lsr, bdr, per_block = kernel_params(ls, bd_shift, B, dev)
    lam = table(lam_dq, torch.int32, dev)
    lv = table(lv_table, torch.float32, dev)
    q = torch.empty((P, B), dtype=torch.int32, device=dev)
    rate = torch.empty((B,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib("dq_scan").dq_greedy_launch(
            tf.data_ptr(), P, B, lsr.data_ptr(), bdr.data_ptr(), per_block,
            lam.data_ptr(), lv.data_ptr(), q.data_ptr(), rate.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "dq_greedy")
    return q, rate


def greedy_depquant_plain(t, ls, bd_shift, lam_dq, log2_n, lv_table):
    """Plain PyTorch greedy dep-quant (the semantics of the JAX lax.scan,
    one Python step per coding-order position)."""
    B = t.shape[0]
    dev = t.device
    tf = to_coding_order(t, log2_n)                       # (B, P)
    ls = param_rows(ls, B, dev)
    bd = param_rows(bd_shift, B, dev)
    bdo = (1 << bd) >> 1
    lam = table(lam_dq, torch.int32, dev)
    lv = table(lv_table, torch.float32, dev)
    q_state = torch.zeros(B, dtype=torch.int32, device=dev)
    trailing = torch.ones(B, dtype=torch.bool, device=dev)
    rate = torch.zeros(B, dtype=torch.float32, device=dev)
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    cols = []
    for p in range(tf.shape[1]):
        tc = tf[:, p]
        atc = tc.abs()
        delta = (q_state > 1).to(torch.int32)
        sign_neg = tc < 0
        s_ = (atc << bd) + torch.where(sign_neg, bdo, -bdo)
        a0 = (s_ // ls + delta) // 2

        def cost_of(a):
            mag = torch.where(a == 0, 0, 2 * a - delta)
            dq = (mag * ls + bdo) >> bd
            dist = (atc - dq).abs()
            bits = torch.where((a == 0) & trailing, 0, a + 1)
            return 128 * dist + lam[bits.clamp(0, 1023).long()]

        pick1 = cost_of(a0 + 1) < cost_of(a0)
        a = torch.where(tc == 0, 0, torch.where(pick1, a0 + 1, a0))
        mag = torch.where(a == 0, 0, 2 * a - delta)
        cols.append(torch.where(sign_neg, -mag, mag))
        r = torch.where(a == 0, torch.where(trailing, zero_f, lv[0]),
                        lv[a.clamp(0, 1023).long()])
        rate = rate + r
        trailing = trailing & (a == 0)
        q_state = trans_next(q_state, a & 1)
    return from_coding_order(torch.stack(cols, 1), log2_n), rate


def dequantize(q, ls, bd_shift):
    """ls/bd_shift: scalars or (B,) per-row (broadcast over the block)."""
    q = q.to(torch.int32)
    ls = param_rows(ls, q.shape[0], q.device).reshape(-1, 1, 1)
    bd = param_rows(bd_shift, q.shape[0], q.device).reshape(-1, 1, 1)
    bd_offset = (1 << bd) >> 1
    d = (q * ls + bd_offset) >> bd
    return torch.clamp(d, -(1 << 15), (1 << 15) - 1)
