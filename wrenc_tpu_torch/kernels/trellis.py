"""Exact 8-state dependent-quantization Viterbi with the committed-level
rate.

`trellis_rate` has the semantics of wrenc_tpu/kernels/trellis_pallas.py::
trellis_rate_impl (the repo's only Pallas kernel, `_kernel` launched by
`_call`): stored levels identical to the sequential trellis, and the
rate of those levels summed in f32 in ascending coding order.
`trellis_rate_batch` is the same kernel's batched entry (JAX
`trellis_rate_batch`), used by the device commit engine. CUDA tensors
launch the hand-written kernel K1 (`dq_trellis` in csrc/dq_scan.cu); CPU
tensors take the plain twins `trellis_rate_plain` /
`trellis_rate_batch_plain`.
"""
import torch

from .quantize import (from_coding_order, launch_dq, param_rows, table,
                       to_coding_order, trans_next)

BIG = 1 << 29


def trellis_rate(t, ls, bd_shift, lam_dq, lv_table, log2_n):
    """t: (B, n, n) int32 transform coefficients; ls/bd_shift scalars or
    (B,) per block; lam_dq (1024,) int32; lv_table (1024,) f32 (integral
    values). Returns (q (B, n, n) int16, rate (B,) f32)."""
    if t.device.type == 'cpu':
        return trellis_rate_plain(t, ls, bd_shift, lam_dq, lv_table, log2_n)
    if not t.is_cuda:
        raise ValueError(f"trellis_rate: unsupported device {t.device}")
    out = _launch_k1(t, ls, bd_shift, lam_dq, lv_table, log2_n)
    trellis_rate.launches += 1
    return out


trellis_rate.launches = 0


def _launch_k1(t, ls, bd_shift, lam_dq, lv_table, log2_n):
    tf = to_coding_order(t, log2_n).T.contiguous()        # (P, B)
    q, rate = launch_dq("dq_trellis", tf, ls, bd_shift, lam_dq, lv_table)
    return from_coding_order(q.T, log2_n), rate


def trellis_rate_batch(jobs, lam_dq, lv_table):
    """Several block sizes in one wave. jobs: list of (t (B, n, n) int32,
    ls, bd_shift, log2_n) with ls / bd_shift scalars or (B,) per block.
    Returns [(q (B, n, n) int16, rate (B,) f32)] in job order, values
    identical to trellis_rate per job.

    On CUDA tensors K1 is launched once per distinct size, with per-block
    ls / bd_shift. The JAX entry shares one edge-ingredient precompute
    across sizes (`build_rate_tabs`: index-shifted tables for a one-hot
    MXU rate lookup, because gathers are slow on a TPU); K1 needs no
    counterpart of it, since each thread computes its four candidates
    from the 1024-entry tables staged in shared memory. CPU tensors take
    trellis_rate_batch_plain."""
    if all(j[0].device.type == 'cpu' for j in jobs):
        return trellis_rate_batch_plain(jobs, lam_dq, lv_table)
    if not all(j[0].is_cuda for j in jobs):
        raise ValueError("trellis_rate_batch: unsupported device "
                         f"{sorted({str(j[0].device) for j in jobs})}")
    out = [None] * len(jobs)
    for lg in sorted({j[3] for j in jobs}):
        idx = [i for i, j in enumerate(jobs) if j[3] == lg]
        ts = [jobs[i][0] for i in idx]
        dev = ts[0].device
        ls = torch.cat([_rows(jobs[i][1], t.shape[0], dev)
                        for i, t in zip(idx, ts)])
        bd = torch.cat([_rows(jobs[i][2], t.shape[0], dev)
                        for i, t in zip(idx, ts)])
        q, rate = _launch_k1(torch.cat(ts), ls, bd, lam_dq, lv_table, lg)
        trellis_rate_batch.launches += 1
        off = 0
        for i, t in zip(idx, ts):
            n = t.shape[0]
            out[i] = (q[off:off + n], rate[off:off + n])
            off += n
    return out


trellis_rate_batch.launches = 0


def _rows(v, B, device):
    """A scalar or (B,) quant parameter as a (B,) int32 tensor."""
    return param_rows(v, B, device).expand(B)


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
