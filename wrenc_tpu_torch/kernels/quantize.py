"""Batched dependent quantization in PyTorch.

Counterpart of wrenc_tpu/kernels/quantize.py: `coding_order`,
`lam_dq_table`, `lv_table_device` (numpy tables, copied), `dequantize`,
`greedy_depquant` — the greedy dep-quant scan with the RD level rate —,
the trellis entries `trellis_depquant` / `trellis_depquant_pscan` (K1),
the level-rate walks `dq_rate_scan` / `dq_rate_device`, and BDPCM's
`bdpcm_dpcm` / `bdpcm_inverse`. The JAX version's one-hot lookups
(`_lut1024_i32`, an MXU contraction, and the one-hot selects `_sel_last`
/ `_sel_map`) are TPU workarounds for slow gathers; here a rate-table
lookup is a plain index with the same clip to [0, 1023] and a selection
is a gather.

`greedy_depquant` launches the hand-written CUDA kernel K2 (`dq_greedy`
in csrc/dq_scan.cu) for CUDA tensors and runs `greedy_depquant_plain`,
its plain PyTorch twin, for CPU tensors. K2 reads the raster (B, n, n)
int32 coefficients in place through the coding-order table and writes
raster int16 levels, so a launch allocates q and rate and nothing else.

The launch contract K1 (kernels/trellis.py) and K2 share lives here: the
coding-order table (`order_table`), the quant parameters by value or in
place (`_param`), and one job of the C struct K1Job (`fill_job`).
"""
import functools

import numpy as np
import torch

from .. import trace
from ..spec import quant as squant
from . import _build

LOG2_SIZES = range(2, 6)


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
    """A (1024,) rate table as a contiguous `dtype` tensor on `device`;
    one already so is passed as it is."""
    if (isinstance(v, torch.Tensor) and v.dtype == dtype
            and v.device == device and v.is_contiguous()):
        t = v
    else:
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


# K2 walks each block's chain with 8 lanes (segment-parallel), or with 1
# lane for one launch of at least K2_ONE_LANE_MIN_B blocks of 4 x 4:
# there the card is full either way, and one lane per block issues fewer
# instructions. From chip_smoke.py's sweep of both over B at every size
# on an H100 (PERF.md): at 4 x 4, 8 lanes are 1.6x faster at 19,008
# blocks, 1 lane 1.1x faster from 76,032 on; at 8 x 8 .. 32 x 32, 8 lanes
# are never slower by more than 1 %.
K2_ONE_LANE_MIN_B = 65536


def k2_lanes(log2_n, B):
    """K2's lanes per block for B blocks of 2^log2_n x 2^log2_n: 1 for 4 x 4
    blocks with B >= K2_ONE_LANE_MIN_B, else 8. The rule of the launch."""
    return 1 if log2_n == 2 and B >= K2_ONE_LANE_MIN_B else 8


def greedy_depquant(t, ls, bd_shift, lam_dq, log2_n, lv_table):
    """Greedy dependent quantization + RD level-rate, batched.

    t: (B, n, n) int32 transform coefficients; ls/bd_shift scalars or (B,);
    lam_dq: (1024,) int32 lambda-scaled quantizer rate table; lv_table:
    (1024,) f32 RD level-rate table. Returns (q (B,n,n) int16 stored
    levels, rate (B,) f32). CUDA tensors launch kernel K2, which reads t
    in place (each block row- or column-major, the blocks packed) and
    writes q itself; CPU tensors take greedy_depquant_plain. Each call
    counts one launch of its shape (trace.count)."""
    trace.count('dq_greedy', t.device.type, (t,))
    if t.device.type == 'cpu':
        return greedy_depquant_plain(t, ls, bd_shift, lam_dq, log2_n,
                                     lv_table)
    if not t.is_cuda:
        raise ValueError(f"greedy_depquant: unsupported device {t.device}")
    out = _launch_k2(t, ls, bd_shift, lam_dq, lv_table, log2_n)
    greedy_depquant.launches += 1
    return out


greedy_depquant.launches = 0


def _launch_k2(t, ls, bd_shift, lam_dq, lv_table, log2_n, lanes=None):
    """One K2 launch: allocates q and rate (nothing else), packs the
    descriptor (k2_desc; lanes None takes k2_lanes), launches on the
    current stream and raises on a launch error. The wrapper counts
    main-path launches."""
    dev = t.device
    B = t.shape[0]
    q = torch.empty(t.shape, dtype=torch.int16, device=dev)
    rate = torch.empty((B,), dtype=torch.float32, device=dev)
    # every tensor the kernel reads stays referenced until it is enqueued:
    # a temporary freed earlier could be handed to the next upload
    ls, bd = _param(ls, B, dev), _param(bd_shift, B, dev)
    lam = table(lam_dq, torch.int32, dev)
    lv = table(lv_table, torch.float32, dev)
    desc = k2_desc(t, ls, bd, log2_n, q, rate, lanes)
    with torch.cuda.device(dev):
        rc = _build.lib("dq_scan").dq_greedy_launch(
            desc, lam.data_ptr(), lv.data_ptr(), order_table(dev).data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "dq_greedy")
    return q, rate


def k2_desc(t, ls, bd_shift, log2_n, q, rate, lanes=None):
    """K2's launch descriptor: a K1Desc whose job[0] is the one job
    (fill_job's contract and checks; n_jobs 0 when B = 0) and whose lanes
    are K2's lanes per block, 1 or 8 (None: k2_lanes)."""
    desc = _build.K1Desc()
    desc.lanes = k2_lanes(log2_n, t.shape[0]) if lanes is None else lanes
    if desc.lanes not in (1, 8):
        raise ValueError(f"k2_desc: {desc.lanes} lanes per block")
    desc.n_jobs = int(fill_job(desc.job[0], (t, ls, bd_shift, log2_n),
                               (q, rate)))
    return desc


def order_table(device):
    """The coding orders of log2 sizes 2..5 concatenated (1,360 int16 raster
    indices; size log2_n's starts at (4^log2_n - 16) / 3), on `device`;
    uploaded once per device ('cuda' and 'cuda:<current>' are one)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _order_table(device)


@functools.lru_cache(maxsize=None)
def _order_table(device):
    return torch.as_tensor(np.concatenate(
        [coding_order(lg) for lg in LOG2_SIZES]).astype(np.int16),
        device=device)


def _param(v, B, device):
    """A quant parameter as K1 and K2 take it: a Python int (passed by
    value) or an int32 tensor of 1 or B values on the device (read in
    place; one already so is passed as it is)."""
    if isinstance(v, torch.Tensor):
        if (v.dtype == torch.int32 and v.dim() == 1 and v.is_contiguous()
                and v.device == device):
            return v
        return v.to(device=device, dtype=torch.int32).reshape(-1).contiguous()
    a = np.asarray(v)
    if a.ndim == 0:
        return int(a)
    return param_rows(a, B, device)


def t_layout(t):
    """0 for packed row-major (B, n, n) blocks, 1 for packed column-major
    ones (the DCT's output: strides (n*n, 1, n)), None otherwise."""
    n = t.shape[-1]
    sb, sy, sx = t.stride()
    if t.shape[0] > 1 and sb != n * n:
        return None
    return {(n, 1): 0, (1, n): 1}.get((sy, sx))


def fill_job(j, job, out):
    """Fills the K1Job j (csrc/dq_scan.cu) for job (t, ls, bd_shift,
    log2_n) and its outputs (q, rate), from shapes and data pointers
    only (no tensor value is read, so it never synchronizes with the
    device). Returns False, leaving j unfilled, for B = 0.

    t: (B, n, n) int32, n = 2^log2_n with log2_n in 2..5, each block
    row- or column-major and the blocks packed (read in place); ls /
    bd_shift: a Python int (passed by value) or a contiguous int32
    tensor of 1 or B values on t's device; q: (B, n, n) int16 and rate:
    (B,) f32, contiguous. Raises ValueError on anything else."""
    t, ls, bd, lg = job
    q, rate = out
    if lg not in LOG2_SIZES:
        raise ValueError(f"log2 size {lg} not in 2..5")
    N = 1 << lg
    if t.dim() != 3 or tuple(t.shape[1:]) != (N, N):
        raise ValueError(f"blocks of shape {tuple(t.shape)}, "
                         f"want (B, {N}, {N})")
    B = t.shape[0]
    layout = t_layout(t)
    if t.dtype != torch.int32 or layout is None:
        raise ValueError("t must be int32, each block dense row- or "
                         "column-major and the blocks packed")
    if (q.dtype != torch.int16 or q.shape != t.shape
            or not q.is_contiguous() or rate.dtype != torch.float32
            or tuple(rate.shape) != (B,) or not rate.is_contiguous()):
        raise ValueError("outputs must be (B, n, n) int16 and (B,) f32, "
                         "contiguous")
    if B == 0:
        return False
    j.t, j.q, j.rate = t.data_ptr(), q.data_ptr(), rate.data_ptr()
    j.B, j.log2_n, j.t_transposed = B, lg, layout
    for name, v in (("ls", ls), ("bd", bd)):
        if isinstance(v, torch.Tensor):
            if (v.dtype != torch.int32 or v.dim() != 1
                    or not v.is_contiguous() or v.numel() not in (1, B)
                    or v.device != t.device):
                raise ValueError(
                    f"{name} must be a contiguous int32 tensor of 1 or {B} "
                    f"values on {t.device}, got {v.dtype} "
                    f"{tuple(v.shape)} on {v.device}")
            setattr(j, name, v.data_ptr())
            setattr(j, name + "_stride", int(v.numel() > 1))
        elif isinstance(v, int):
            setattr(j, name + "_val", v)
        else:
            raise ValueError(f"{name} must be an int or a tensor, got "
                             f"{type(v).__name__}")
    return True


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


@functools.lru_cache(maxsize=None)
def _zero_lv(device):
    """A (1024,) zero rate table on `device`, uploaded once."""
    return torch.zeros(1024, dtype=torch.float32, device=device)


def trellis_depquant(t, ls, bd_shift, lam_dq, log2_n):
    """Exact 8-state (q_state x trailing) dependent-quantization Viterbi,
    batched: t (B, n, n) int transform coefficients, ls / bd_shift scalars
    or (B,) per block, lam_dq (1024,) int32. Returns q (B, n, n) int16
    stored levels.

    The levels of kernels/trellis.trellis_rate, whose rate is dropped (the
    levels do not depend on its rate table): a CUDA tensor launches K1, a
    CPU tensor runs K1's plain twin. The reference's sequential lax.scan,
    its log-depth twin and the Pallas kernel are three formulations of
    one Viterbi; the port keeps one."""
    from . import trellis
    q, _ = trellis.trellis_rate(t, ls, bd_shift, lam_dq, _zero_lv(t.device),
                                log2_n)
    return q


def trellis_depquant_pscan(t, ls, bd_shift, lam_dq, log2_n):
    """The reference's parallel-scan Viterbi: its min-plus associative
    scan over the positions is a log-depth formulation for the TPU, where
    a sequential chain serialises the vector units; its levels are those
    of the sequential trellis, so here it is trellis_depquant (K1 on a
    CUDA tensor, its plain twin on the CPU)."""
    return trellis_depquant(t, ls, bd_shift, lam_dq, log2_n)


def dq_rate_scan(q, log2_n, lv_table):
    """RD level-rate of stored q levels (dep-quant walk), batched -> (B,)
    f32: the per-position rates summed in f32 in ascending coding order
    (lv_table[a] for a level a > 0, lv_table[0] for a zero once a nonzero
    level has been coded, nothing for the trailing zeros)."""
    B = q.shape[0]
    dev = q.device
    qf = to_coding_order(q, log2_n).abs()
    lv = table(lv_table, torch.float32, dev)
    q_state = torch.zeros(B, dtype=torch.int32, device=dev)
    trailing = torch.ones(B, dtype=torch.bool, device=dev)
    rate = torch.zeros(B, dtype=torch.float32, device=dev)
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    for p in range(qf.shape[1]):
        qv = qf[:, p]
        a = torch.where(qv == 0, 0, (qv + (q_state > 1).to(torch.int32)) // 2)
        rate = rate + torch.where(a == 0,
                                  torch.where(trailing, zero_f, lv[0]),
                                  lv[a.clamp(0, 1023).long()])
        trailing = trailing & (a == 0)
        q_state = trans_next(q_state, a & 1)
    return rate


def dq_rate_device(q, log2_n, lv_table):
    """RD level-rate of stored q levels by pairwise composition: the
    dep-quant state walk is a chain of deterministic 8-state maps (state =
    q_state*2 + trailing), each position a map and a rate per source
    state; adjacent positions compose as (r1 + r2[n1], n2[n1]) until one
    is left, read from the start state (q_state 0, trailing). The same
    composition order as the reference, so the f32 sums are bit-equal to
    its; they differ from dq_rate_scan's sequential sum in the last bits.
    Returns (B,) f32."""
    dev = q.device
    v = to_coding_order(q, log2_n).abs()                     # (B, P)
    P = v.shape[1]
    lv = table(lv_table, torch.float32, dev)
    st = torch.arange(8, dtype=torch.int32, device=dev)
    qs, tr = st >> 1, (st & 1).bool()
    delta_s = (qs > 1).long()
    # a only depends on delta: the rates on the compact (B, P, 2) grid,
    # then expanded to the 8 states by indexing
    a2 = (v[:, :, None] + torch.arange(2, dtype=torch.int32, device=dev)) // 2
    r2 = lv[a2.clamp(0, 1023).long()]
    a = a2[:, :, delta_s]                                    # (B, P, 8)
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    r = torch.where(a == 0, torch.where(tr, zero_f, lv[0]), r2[:, :, delta_s])
    n = (trans_next(qs, a & 1) * 2 + (tr & (a == 0)).to(torch.int32)).long()
    while P > 1:   # compose adjacent position pairs (earlier, later)
        n1, n2 = n[:, 0::2], n[:, 1::2]
        r = r[:, 0::2] + r[:, 1::2].gather(2, n1)
        n = n2.gather(2, n1)
        P //= 2
    return r[:, 0, 1]    # start state: q_state 0, trailing true


def bdpcm_dpcm(q, dir_flag):
    """Batched forward residual DPCM on (B, n, n) quantized levels, each
    level minus its ORIGINAL neighbour above (dir_flag 1, vertical) or to
    the left (0); int32."""
    q = q.to(torch.int32)
    out = q.clone()
    if dir_flag:
        out[:, 1:, :] -= q[:, :-1, :]
    else:
        out[:, :, 1:] -= q[:, :, :-1]
    return out


def bdpcm_inverse(d, dir_flag):
    """Batched inverse residual DPCM: the running sum along the DPCM axis,
    clamped to int16 at every step (not once at the end), of the
    int16-clamped coded values; int32."""
    lo, hi = -(1 << 15), (1 << 15) - 1
    d = torch.clamp(d.to(torch.int32), lo, hi)
    axis = 1 if dir_flag else 2
    carry = torch.zeros_like(d.select(axis, 0))
    rows = []
    for row in d.unbind(axis):
        carry = torch.clamp(carry + row, lo, hi)
        rows.append(carry)
    return torch.stack(rows, axis)
