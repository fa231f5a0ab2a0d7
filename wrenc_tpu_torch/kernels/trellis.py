"""Exact 8-state dependent-quantization Viterbi with the committed-level
rate.

`trellis_rate` has the semantics of wrenc_tpu/kernels/trellis_pallas.py::
trellis_rate_impl (the repo's only Pallas kernel, `_kernel` launched by
`_call`): stored levels identical to the sequential trellis, and the
rate of those levels summed in f32 in ascending coding order.
`trellis_rate_batch` is the same kernel's batched entry (JAX
`trellis_rate_batch`), used by the device commit engine. CUDA tensors
launch the hand-written kernel K1 (`dq_trellis` in csrc/dq_scan.cu),
once per call whatever the mix of block sizes; CPU tensors take the plain
twins `trellis_rate_plain` / `trellis_rate_batch_plain`.

K1 reads the raster (B, n, n) int32 coefficients through the coding-order
table and writes raster (B, n, n) int16 levels, so a launch needs no
gather, transpose, scatter or scratch tensor: the wrapper allocates the
outputs and packs a descriptor of its jobs (`pack_jobs`: pointers and
shapes only, passed to the kernel by value).
"""
import torch

from .. import trace
from . import _build
from .quantize import (_param, fill_job, from_coding_order, order_table,
                       param_rows, t_layout, table, to_coding_order,
                       trans_next)

BIG = 1 << 29
K1_MAX_JOBS = _build.K1_MAX_JOBS
# K1 runs 8 lanes per block of coefficients (4 blocks per one-warp CTA),
# or 1 lane (32 blocks per CTA) for a launch of one job of 4 x 4 blocks
# and at least ONE_LANE_MIN_B blocks: stage A's smallest size, where the
# card is full either way and one lane per block issues fewer
# instructions per position. From chip_smoke.py's sweep of both over B
# at 4 x 4 on an H100 (PERF.md): 8 lanes are faster up to 12,288 blocks,
# 1 lane from 16,384 on (2x at 304,128).
ONE_LANE_MIN_B = 16384


def trellis_rate(t, ls, bd_shift, lam_dq, lv_table, log2_n):
    """t: (B, n, n) int32 transform coefficients; ls/bd_shift scalars or
    (B,) per block; lam_dq (1024,) int32; lv_table (1024,) f32 (integral
    values). Returns (q (B, n, n) int16, rate (B,) f32). Each call counts
    one launch of its shape (trace.count)."""
    trace.count('dq_trellis', t.device.type, (t,))
    if t.device.type == 'cpu':
        return trellis_rate_plain(t, ls, bd_shift, lam_dq, lv_table, log2_n)
    if not t.is_cuda:
        raise ValueError(f"trellis_rate: unsupported device {t.device}")
    (out,) = _launch_k1([(t, ls, bd_shift, log2_n)], lam_dq, lv_table)
    trellis_rate.launches += 1
    return out


trellis_rate.launches = 0


def trellis_rate_batch(jobs, lam_dq, lv_table):
    """Several block sizes in one wave. jobs: list of (t (B, n, n) int32,
    ls, bd_shift, log2_n) with ls / bd_shift scalars or (B,) per block;
    at most K1_MAX_JOBS jobs. Returns [(q (B, n, n) int16, rate (B,) f32)]
    in job order, values identical to trellis_rate per job.

    On CUDA tensors K1 is launched once for all jobs; per-row ls /
    bd_shift tensors are read in place. The JAX entry shares one
    edge-ingredient precompute across sizes (`build_rate_tabs`:
    index-shifted tables for a one-hot MXU rate lookup, because gathers
    are slow on a TPU); K1 needs no counterpart of it, since its lanes
    compute the candidates on the chip from the 1024-entry tables. CPU
    tensors take trellis_rate_batch_plain. Each call counts one launch
    of its jobs' shapes (trace.count) and one in `launches`: a call
    captured into a CUDA graph counts once, at its capture, and the
    graph's replays do not call it (the device commit's RdScan.counts
    counts those)."""
    trace.count('dq_trellis', jobs[0][0].device.type, [j[0] for j in jobs])
    if all(j[0].device.type == 'cpu' for j in jobs):
        return trellis_rate_batch_plain(jobs, lam_dq, lv_table)
    if not all(j[0].is_cuda for j in jobs):
        raise ValueError("trellis_rate_batch: unsupported device "
                         f"{sorted({str(j[0].device) for j in jobs})}")
    out = _launch_k1(jobs, lam_dq, lv_table)
    trellis_rate_batch.launches += 1
    return out


trellis_rate_batch.launches = 0


def _launch_k1(jobs, lam_dq, lv_table, lanes=None):
    """One K1 launch for `jobs` (all on one CUDA device). Allocates the
    outputs, packs the descriptor (lanes: see pack_jobs), launches on the
    current stream and raises on a launch error. The wrappers count
    main-path launches."""
    dev = jobs[0][0].device
    if any(j[0].device != dev for j in jobs):
        raise ValueError("trellis: jobs on several devices")
    lam = table(lam_dq, torch.int32, dev)
    lv = table(lv_table, torch.float32, dev)
    packed, outs = [], []
    for t, ls, bd, lg in jobs:
        t = t.to(torch.int32)
        if t_layout(t) is None:
            t = t.contiguous()
        B = t.shape[0]
        packed.append((t, _param(ls, B, dev), _param(bd, B, dev), lg))
        outs.append((torch.empty(t.shape, dtype=torch.int16, device=dev),
                     torch.empty((B,), dtype=torch.float32, device=dev)))
    desc = pack_jobs(packed, outs, lanes)
    with torch.cuda.device(dev):
        rc = _build.lib("dq_scan").dq_trellis_launch(
            desc, lam.data_ptr(), lv.data_ptr(), order_table(dev).data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "dq_trellis")
    return outs


def k1_lanes(jobs):
    """K1's lanes per block for a launch of `jobs` [(t, ls, bd, log2_n)]:
    1 for a single job of 4 x 4 blocks with at least ONE_LANE_MIN_B
    blocks, else 8. The rule of the launch."""
    if len(jobs) == 1:
        t, _, _, lg = jobs[0]
        if lg == 2 and t.shape[0] >= ONE_LANE_MIN_B:
            return 1
    return 8


def pack_jobs(jobs, outs, lanes=None):
    """The K1 launch descriptor for jobs [(t, ls, bd_shift, log2_n)] and
    their outputs [(q, rate)], from shapes and data pointers only (no
    tensor value is read, so packing never synchronizes with the device).

    Each job and its outputs as quantize.fill_job takes them (K1 reads t
    in place, row- or column-major blocks). lanes: K1's lanes per block,
    8 or 1 (4 x 4 blocks only); None takes k1_lanes(jobs). Jobs are
    ordered by block size, largest first (stable), so the CTAs of the
    longest chains are issued first; each job takes ceil(B / (32 /
    lanes)) one-warp CTAs. Jobs with B = 0 take none and are left out.
    Raises ValueError on anything else, and on more than K1_MAX_JOBS
    jobs."""
    if len(jobs) != len(outs):
        raise ValueError("pack_jobs: one (q, rate) per job")
    if len(jobs) > K1_MAX_JOBS:
        raise ValueError(f"pack_jobs: {len(jobs)} jobs, the K1 descriptor "
                         f"holds {K1_MAX_JOBS}")
    desc = _build.K1Desc()
    desc.lanes = k1_lanes(jobs) if lanes is None else lanes
    if desc.lanes not in (1, 8) or (desc.lanes == 1 and any(
            j[3] != 2 for j in jobs)):
        raise ValueError(f"pack_jobs: {desc.lanes} lanes per block for "
                         f"sizes {sorted({j[3] for j in jobs})}")
    per_cta = 32 // desc.lanes
    order = sorted(range(len(jobs)), key=lambda i: -jobs[i][3])
    n, cta = 0, 0
    for i in order:
        if not fill_job(desc.job[n], jobs[i], outs[i]):
            continue
        j = desc.job[n]
        j.cta_begin = cta
        cta += -(-j.B // per_cta)
        desc.max_log2_n = max(desc.max_log2_n, j.log2_n)
        n += 1
    desc.n_jobs, desc.n_ctas = n, cta
    return desc


def trellis_rate_batch_plain(jobs, lam_dq, lv_table):
    """Plain twin of trellis_rate_batch: trellis_rate_plain per job."""
    return [trellis_rate_plain(t, ls, bd, lam_dq, lv_table, lg)
            for t, ls, bd, lg in jobs]


def trellis_rate_plain(t, ls, bd_shift, lam_dq, lv_table, log2_n):
    """Plain PyTorch Viterbi. Per position, the 16 edges (slot = 2*src + k)
    are relaxed at once: each destination takes the FIRST slot of minimal
    total cost below BIG — exactly what the sequential src-outer, k-inner,
    strict-< relaxation from BIG leaves behind."""
    B = t.shape[0]
    dev = t.device
    i32 = torch.int32
    tf = to_coding_order(t, log2_n)                       # (B, P)
    P = tf.shape[1]
    ls = param_rows(ls, B, dev).reshape(-1, 1, 1)
    bd = param_rows(bd_shift, B, dev).reshape(-1, 1, 1)
    bdo = (1 << bd) >> 1
    lam = table(lam_dq, i32, dev)
    lv = table(lv_table, torch.float32, dev)
    lam1 = lam[1]

    # edge ingredients on the compact (delta, k) grid, j = 2*delta + k
    j = torch.arange(4, dtype=i32, device=dev)
    dlt, kk = j >> 1, j & 1
    tc = tf[:, :, None]                                   # (B, P, 1)
    atc = tc.abs()
    neg = tc < 0
    zero = tc == 0
    base = ((atc << bd) + torch.where(neg, bdo, -bdo)) // ls
    a4 = torch.where(zero, 0, (base + dlt) // 2 + kk)     # (B, P, 4)
    mag4 = torch.where(a4 == 0, 0, 2 * a4 - dlt)
    dist4 = (atc - ((mag4 * ls + bdo) >> bd)).abs()
    c4 = torch.clamp(128 * dist4 + lam[(a4 + 1).clamp(0, 1023).long()],
                     max=BIG)
    c4 = torch.where(zero & (kk == 1), BIG, c4)           # zeros: one option
    sa4 = torch.where(neg, -a4, a4)
    lv4 = lv[a4.clamp(0, 1023).long()]

    # the 16 edges, slot = 2*src + k (source state outer, k inner)
    slot = torch.arange(16, dtype=i32, device=dev)
    src = slot >> 1
    qs, tr = src >> 1, (src & 1).bool()
    sj = ((qs > 1).to(i32) * 2 + (slot & 1)).long()
    sa16 = sa4[:, :, sj]                                   # (B, P, 16)
    az16 = sa16 == 0
    is_dc = (torch.arange(P, device=dev) == P - 1).to(i32)[None, :, None]
    refund = tr & az16
    c16 = c4[:, :, sj] - refund * lam1 - refund * lam1 * is_dc
    dst16 = trans_next(qs, sa16 & 1) * 2 + refund.to(i32)

    states = torch.arange(8, dtype=i32, device=dev)[None, :, None]
    cost = torch.full((B, 8), BIG, dtype=i32, device=dev)
    cost[:, 1] = 0
    bps = []
    for p in range(P):
        tot = cost[:, src.long()] + c16[:, p]               # (B, 16)
        cand = torch.where(dst16[:, p, None, :] == states,
                           tot[:, None, :], BIG)           # (B, 8, 16)
        mn = cand.amin(-1)
        first = cand.argmin(-1).to(i32)                    # first index
        hit = mn < BIG
        new = torch.where(hit, mn, BIG)
        bps.append(torch.where(hit, first, 0))
        cost = new - new.amin(1, keepdim=True)

    state = cost.argmin(1)                                 # first index
    qv = [None] * P
    rv = [None] * P
    lv0 = lv[0]
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    for p in range(P - 1, -1, -1):
        sl = bps[p].gather(1, state[:, None])[:, 0]
        s_src = sl >> 1
        delta = (s_src >= 4).to(i32)
        jj = (delta * 2 + (sl & 1)).long()[:, None]
        sa = sa4[:, p].gather(1, jj)[:, 0]
        az = sa == 0
        mag = 2 * sa.abs() - delta
        qv[p] = torch.where(az, 0, torch.where(sa < 0, -mag, mag))
        rv[p] = torch.where(az, torch.where((s_src & 1) == 1, zero_f, lv0),
                            lv4[:, p].gather(1, jj)[:, 0])
        state = s_src.long()
    rate = torch.zeros(B, dtype=torch.float32, device=dev)
    for p in range(P):                # ascending coding order, f32
        rate = rate + rv[p]
    return from_coding_order(torch.stack(qv, 1), log2_n), rate
