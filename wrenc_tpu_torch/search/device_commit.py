"""Device RD commit engine in PyTorch (`commit_engine='device'`).

Counterpart of the RD half of wrenc_tpu/search/device_commit.py: the
native C++ RdCommitter's re-decision discipline (block_splitter.rs:110
true-reconstruction decisions) run as a rank wavefront on the device.
Each rank step re-ranks every CU's stage-A candidate list by full
trellis RD (kernel K1 through `kernels/trellis.trellis_rate_batch`) with
the exact MPM-aware mode-bit model read from an evolving device mode map,
re-decides derived-vs-CCLM chroma, and scatters reconstruction and
coefficients. Refine-flagged QT splits are resolved in-scan: the merged
leaf rides the wavefront as a PHANTOM ranked with its region's last
contributor, every committed CU adds its cost into a per-4x4-cell cost
plane, and at the phantom's step the device compares the region's
accumulated split cost with the merged leaf's and, when the leaf wins,
overwrites the region (block_splitter.rs:1079-1152).

The JAX `lax.scan` becomes a Python loop over rank steps. The host knows
every step's live rows from the schedule, and pads each class's rows in a
step to a cap from a power-of-two ladder (`ROW_CAP_MIN` and up), so that
few distinct step shapes exist. A padded row is never valid and never a
phantom; it names its own block of one of the pad frames that follow the
scan's frames in every plane, so no two rows of one scatter share a
target. A row that must not write (a padded row, a phantom, or a phantom
that lost) rewrites the values it reads back, so every scatter is a
deterministic index_put_. Each step scatters its outputs in place: the
winners' coefficients into the carry's coefficient planes, the modes
and refine flags into per-class planes indexed like the blocks.

The scan's state outlives a call (`_ScanContext`, one per device, QP,
geometry, frame count and rate model): constants, carry, the frames'
planes, per-shape row buffers and, on CUDA, one CUDA graph per step
shape, captured at its first step and replayed for every later one, so
a step costs the host one staging copy and one replay. Off CUDA the
same steps run eagerly on the same buffers. Nothing in the step loop
waits for the device; the planes are fetched once after the loop.

The module also holds the JAX module's apply-decisions prototype,
`commit_frame_device` (rd_commit=False semantics, the greedy quantizer:
kernel K2 once per rank group and component), at the end.
"""
import collections
import contextlib
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from ..entropy import native
from ..kernels import intra_pred, quantize as kq, refs, transforms
from ..kernels import trellis as ktr
from ..spec import quant

BIG_COST = np.float32(3e38)


@functools.lru_cache(maxsize=None)
def _geometry(W, H, s, c_idx, log2_ctu):
    """Static per-size tables: substitution gather rows, fill flags,
    filter indices, block scatter rows, availability masks."""
    src, fill = refs.subst_gather(W, H, s, c_idx, log2_ctu)
    pi, ni, keep = refs.filter121_indices(s)
    sh = 0 if c_idx == 0 else 1
    w = W >> sh
    xs, ys = refs.block_grid(W, H, s, c_idx)
    n_bw = w // s
    scat = (ys[:, None, None] + np.arange(s)[None, :, None]) * w \
        + (xs[:, None, None] + np.arange(s)[None, None, :])
    masks = refs.avail_masks(W, H, s, c_idx, log2_ctu)
    return (src.astype(np.int32), fill, pi, ni, keep,
            scat.reshape(len(xs), -1).astype(np.int32), n_bw, masks,
            xs.astype(np.int32), ys.astype(np.int32))


def _cost16384(ssd, level, mb16384, lam):
    """ssd + lam * ((level + mb) / 16384) in f32 (C++: the same in f64).
    XLA contracts the multiply-add into one FMA; `transforms.fma` rounds
    once the same way. lam: a 0-d f32 tensor on the device."""
    return transforms.fma(lam, (level + mb16384) / 16384.0,
                          ssd.to(torch.float32))


def _sel_modes(pall, cl):
    """Per-candidate predictions from the 67-mode sweep: pall (N, 67, P),
    cl (N, K) -> (N, K, P), an exact gather."""
    return pall.gather(1, cl[:, :, None].expand(-1, -1, pall.shape[2]))


def _sel_win(arr, win):
    """arr (N, K, ...), win (N,) -> (N, ...): each row's winner."""
    idx = win.reshape((-1, 1) + (1,) * (arr.ndim - 2))
    return torch.take_along_dim(arr, idx, dim=1)[:, 0]


@functools.lru_cache(maxsize=None)
def _cell_table(W, H, s, log2_ctu):
    """(N, (s/4)^2) flat 4x4-cell indices of each aligned luma block — the
    mode-map scatter rows (RdCommitter::set_mode_map granularity)."""
    xs, ys = refs.block_grid(W, H, s, 0)
    n4w = W >> 2
    n4 = max(s >> 2, 1)
    d = np.arange(n4)
    rows = ((ys[:, None, None] >> 2) + d[None, :, None]) * n4w \
        + (xs[:, None, None] >> 2) + d[None, None, :]
    return rows.reshape(len(xs), -1).astype(np.int32)


def mpm_key(rm, dep):
    """The rate-model constants the mode-bit tables depend on: (po, npo,
    mio, mip, mrm, mro, mrp)."""
    return (rm.pick('planar_offset', dep, True),
            rm.pick('non_planar_offset', dep, True),
            rm.pick('mpm_idx_offset', dep, True), rm.mpm_idx_pow,
            rm.pick('mpm_remainder_mult', dep, True),
            rm.pick('mpm_remainder_offset', dep, True),
            rm.mpm_remainder_pow)


@functools.lru_cache(maxsize=None)
def _mpm_bits_f64(key_consts):
    """(67, 67, 67) f64 mode-bit estimate for coding `mode` given (left,
    above) neighbour modes: the rate model's formula (the native
    committer's RdCommitter::luma_mode_bits, the scalar encoder's
    _mode_bits) closed over all (l, a) pairs. key_consts: mpm_key."""
    (po, npo, mio, mip, mrm, mro, mrp) = key_consts
    from ..entropy.syntax import derive_mpm_list
    modes = np.arange(67, dtype=np.float64)
    T = np.empty((67, 67, 67), dtype=np.float64)
    for l in range(67):
        for a in range(67):
            cand = derive_mpm_list(l, a)
            srt = np.sort(cand)
            rem = modes - 1 - np.searchsorted(srt, modes, side='left')
            row = npo + mrm * (rem + mro) ** mrp
            for idx, m in reversed(list(enumerate(cand))):
                row[m] = npo + (idx + mio) ** mip
            row[0] = po
            T[l, a] = row
    return T


@functools.lru_cache(maxsize=None)
def mpm_bits_f32(key_consts):
    """_mpm_bits_f64 rounded to f32: the host selection's table."""
    return _mpm_bits_f64(key_consts).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mpm_bits16384(key_consts):
    """(67, 67, 67) f32 table of trunc(mode_bits * 16384), truncated in
    f64 as the native committer does, so the int64 truncation matches
    bit for bit (values < 2^24, exact in f32)."""
    return np.trunc(_mpm_bits_f64(key_consts) * 16384.0).astype(np.float32)


SEG = 64          # ranks per scan segment
# the least row cap: a class's n rows in a rank step are padded to the
# least power of two that holds them and is at least this
ROW_CAP_MIN = 16


def _row_cap(n):
    """The cap a class's n rows of one rank step are padded to."""
    return max(ROW_CAP_MIN, _buckets(n))


def _grid(ck):
    """The block grid a class's `bi` counts on: 8 for SCIPU chroma, else
    the block size."""
    return 8 if ck[0] == 'C' else 1 << ck[1]


def _pad_frames(W, H, F, log2_ctu):
    """The pad frames a scan of F frames needs: the most padded rows any
    class can have in one step (at most F * blocks rows, no two on one
    block of one frame), the k-th naming block k % blocks of frame
    F + k // blocks."""
    P = 0
    for gs in {8} | {1 << lg for lg in range(2, log2_ctu + 1)}:
        nb = (W // gs) * (H // gs)
        most, c = ROW_CAP_MIN - 1, ROW_CAP_MIN
        while c < F * nb:           # n = c + 1 rows pad to 2c: c - 1 pads
            most, c = c - 1, c << 1
        P = max(P, -(-most // nb))
    return P


def _carry_init(W, H, F, device):
    """Reconstruction planes (int32), mode map, cost plane and coefficient
    planes (int16), flat per frame (the scan's frames, then its pad
    frames)."""
    HW, hw = H * W, (H // 2) * (W // 2)
    n4 = (W >> 2) * (H >> 2)

    def z(n, dt):
        return torch.zeros((F, n), dtype=dt, device=device)
    return [z(HW, torch.int32), z(hw, torch.int32), z(hw, torch.int32),
            z(n4, torch.int32), z(n4, torch.float32),
            z(HW, torch.int16), z(hw, torch.int16), z(hw, torch.int16)]


def _carry_final(carry, F):
    """The first F frames in fetch-side dtypes: recon uint8, coefficients
    int16."""
    ry, rcb, rcr, mm, cp, cy, ccb, ccr = (t[:F] for t in carry)
    return (ry.to(torch.uint8), rcb.to(torch.uint8), rcr.to(torch.uint8),
            cy, ccb, ccr)


def _put(plane, bf, rows, val, keep=None):
    """plane[bf, rows] = val for (n,) frames and (n, k) rows whose targets
    are distinct. Rows with keep False write back what they read."""
    if keep is not None:
        val = torch.where(keep.reshape((-1,) + (1,) * (val.ndim - 1)), val,
                          plane[bf[:, None], rows])
    plane[bf[:, None], rows] = val.to(plane.dtype)


def _add_at(plane, bf, cell, val, keep=None):
    """plane[bf, cell] += val for (n,) distinct cells (none where keep is
    False)."""
    _put(plane, bf, cell[:, None], (plane[bf, cell] + val)[:, None], keep)


def _region_sum(v):
    """Row sums of a (n, k) f32 cost patch, k in {4, 16, 64}, in the order
    the JAX reference gets from XLA on the CPU: up to 32 columns one after
    another; 64 as two sequential halves of 32, then their sum."""
    n, k = v.shape
    parts = v.reshape(n, -1, min(k, 32))
    acc = parts[:, :, 0]
    for j in range(1, parts.shape[2]):
        acc = acc + parts[:, :, j]
    out = acc[:, 0]
    for j in range(1, acc.shape[1]):
        out = out + acc[:, j]
    return out


def _build_v(plane, bf, bi, g):
    """Substituted, [1 2 1]-filtered reference vectors (n, 2L) read from
    the evolving reconstruction."""
    src, fill, pi, ni, keep = g['src'], g['fill'], g['pi'], g['ni'], g['keep']
    u = torch.where(fill[bi][:, None], 128, plane[bf[:, None], src[bi]])
    uf = torch.where(keep[None, :], u,
                     (u[:, pi] + 2 * u + u[:, ni] + 2) >> 2)
    return torch.cat([u, uf], dim=1)


@functools.lru_cache(maxsize=None)
def _geo_dev(W, H, s, c_idx, log2_ctu, device):
    """_geometry (and the cell table for luma) on the device."""
    (src, fill, pi, ni, keep, scat, n_bw, masks, xs,
     ys) = _geometry(W, H, s, c_idx, log2_ctu)

    def t(a, dt=torch.int64):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)
    g = {'src': t(src), 'fill': t(fill, torch.bool), 'pi': t(pi),
         'ni': t(ni), 'keep': t(keep, torch.bool), 'scat': t(scat),
         'masks': t(masks, torch.int32), 'xs': t(xs, torch.int32),
         'ys': t(ys, torch.int32)}
    if c_idx == 0:
        g['cells'] = t(_cell_table(W, H, s, log2_ctu))
    return g


def _collect_leaf_cus(trees):
    """Coding-order (cu, is_phantom) pairs. Each refine node contributes
    its split subtree's CUs normally plus its merged-leaf alternative
    (alt_cu) as a PHANTOM appended after the subtree: phantoms are
    evaluated by the scan (full candidate ranking + chroma re-decision)
    and scatter ONLY when their in-scan cost comparison picks the
    merged leaf over the region's accumulated split cost."""
    out = []

    def walk(n):
        if getattr(n, 'refine', False):
            for c in n.children:
                walk(c)
            out.append((n.alt_cu, True))
        elif n.split:
            for c in n.children:
                walk(c)
        elif n.cu is not None:
            out.append((n.cu, False))
    for t in trees:
        walk(t)
    return out


def _cu_ranks(cus, W, H, log2_ctu=5):
    """Dependency rank per (cu, is_phantom) over 4x4 cells
    (WavefrontSearch._commit discipline). A normal CU ranks strictly
    after everything it reads: max(windows, own) + 1. A PHANTOM
    (merged-leaf refine alternative) reads only its OUTSIDE reference
    samples and its region's accumulated costs — never its children's
    pixels — so it SHARES the rank of its region's last contributor:
    max(windows + 1, own). The in-scan resolver's phase-4 class order
    ('C' < 'S' ascending size; 'L' adds in phase 2) makes every
    same-step region contribution visible before the phantom resolves.
    Phantoms write the grid (dependents rank after resolution and read
    the RESOLVED reconstruction — the visibility the native DFS
    rollback gives its sequential successors) with ZERO rank-depth
    inflation vs a phantom-free schedule.

    The left/above dependency windows extend to 2x the block span only
    where the below-left / above-right reference samples are AVAILABLE
    (spec 6.4.4; unavailable samples are substitution-masked and never
    read) — exact-availability windows shorten the critical rank chains
    substantially vs the conservative geometric windows."""
    n = len(cus)
    xs_ = np.fromiter((cu.x for cu, ph in cus), np.int64, n)
    ys_ = np.fromiter((cu.y for cu, ph in cus), np.int64, n)
    lg_ = np.fromiter((cu.log2 for cu, ph in cus), np.int64, n)
    ph_ = np.fromiter((1 if ph else 0 for cu, ph in cus), np.int64, n)
    ext_l = np.zeros(n, np.int64)
    ext_t = np.zeros(n, np.int64)
    for lg in np.unique(lg_):
        s = 1 << int(lg)
        sel = lg_ == lg
        masks = refs.avail_masks(W, H, s, 0, log2_ctu)
        bi = (ys_[sel] // s) * (W // s) + xs_[sel] // s
        ext_l[sel] = masks[bi, 1 + s]
        ext_t[sel] = masks[bi, 1 + 3 * s]
    meta = np.stack([xs_, ys_, lg_, ph_, ext_l, ext_t],
                    axis=1).astype(np.int32)
    return native.cu_ranks_native(meta, W, H)


class Rows(NamedTuple):
    """One class's rows of one segment, ordered by (rank step, fill order):
    fields {'valid', 'bf', 'bi'[, 'cands'][, 'ph']} of (n, ...) arrays,
    off (SEG + 1) offsets so that step r's rows are [off[r], off[r+1]),
    n_ph (SEG) phantoms per step, cus the n (cu, is_phantom) pairs."""
    fields: dict
    off: list
    n_ph: list
    cus: list


def _build_schedule(cfg, all_trees):
    """Compact per-class worklists for the scan, split into SEG-rank
    segments.

    Returns (segments, has_ph): segments a list of {class: Rows} holding
    only the classes with rows in that segment. A class is ('C', 3),
    ('L', log2) or ('S', log2); within a rank step its rows keep the fill
    order frame by frame, coding order within a frame. has_ph is True when
    ANY refine phantom exists in the schedule; 'S' classes then carry a
    'ph' field for the in-scan resolution. Frame indices are int32."""
    W, H = cfg.width, cfg.height
    items = {}          # class -> list of (rank, f, cu, is_phantom)
    R = 0
    for f, trees in enumerate(all_trees):
        cus = _collect_leaf_cus(trees)
        ranks = _cu_ranks(cus, W, H, cfg.log2_ctu_size)
        R = max(R, int(ranks.max()) if len(ranks) else 0)
        for (cu, ph), r in zip(cus, ranks):
            ck = ('C', 3) if cu.tree == 'C' else (cu.tree, cu.log2)
            items.setdefault(ck, []).append((int(r) - 1, f, cu, ph))
    n_cand = max([len(lst[0][2].cands) for ck, lst in items.items()
                  if ck[0] != 'C'] + [1])
    has_ph = any(e[3] for lst in items.values() for e in lst)

    segments = [{} for _ in range(-(-R // SEG))]
    for ck in sorted(items):
        tree, log2 = ck
        lst = sorted(items[ck], key=lambda e: e[0])          # stable
        n = len(lst)
        r_a = np.fromiter((e[0] for e in lst), np.int64, n)
        ph_a = np.fromiter((e[3] for e in lst), bool, n)
        gs = _grid(ck)
        fields = {
            'valid': ~ph_a,
            'bf': np.fromiter((e[1] for e in lst), np.int32, n),
            'bi': np.fromiter(((e[2].y // gs) * (W // gs) + e[2].x // gs
                               for e in lst), np.int32, n)}
        if tree != 'C':
            fields['cands'] = np.full((n, n_cand), -1, np.int8)
            cl = np.array([e[2].cands for e in lst], np.int8)
            fields['cands'][:, :cl.shape[1]] = cl
        if has_ph and tree == 'S':
            fields['ph'] = ph_a
        _check_targets(ck, r_a, fields['bf'], fields['bi'], len(all_trees))
        bounds = np.searchsorted(r_a, np.arange(len(segments) + 1) * SEG)
        for si, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
            if a == b:
                continue
            rl = r_a[a:b] - si * SEG
            off = np.zeros(SEG + 1, np.int64)
            off[1:] = np.cumsum(np.bincount(rl, minlength=SEG))
            n_ph = np.bincount(rl, weights=ph_a[a:b], minlength=SEG)
            segments[si][ck] = Rows(
                {f: v[a:b] for f, v in fields.items()}, off.tolist(),
                n_ph.astype(np.int64).tolist(),
                [(e[2], e[3]) for e in lst[a:b]])
    return segments, has_ph


def _check_targets(ck, steps, bf, bi, F):
    """A class's rows scatter to their own block. Its schedule rows name
    frames below F, and no two of them the same block of the same frame,
    in the whole scan (the modes are read back per block); its padded
    rows (bf >= F) name pad frames, and no two rows of one step the same
    block there."""
    pad = bf >= F
    key = np.stack([np.where(pad, steps, -1), bf, bi], axis=1)
    if len(np.unique(key, axis=0)) != len(key):
        raise RuntimeError(f"commit schedule: class {ck} repeats a scatter "
                           "target")


class ScanStep(NamedTuple):
    """One rank step of a scan: sig, the (class, row cap, has a phantom)
    of each class with rows in it, sorted; rows, every such class's
    padded rows packed in sig order (_layout, int64); live and pad, its
    schedule rows and padded rows."""
    sig: tuple
    rows: np.ndarray
    live: int
    pad: int


def _layout(ck, cap, n_cand, has_ph):
    """The fields of a class's block of cap rows, each a run of the block:
    [(field, start, shape)], and the block's length. 'valid', 'bf', 'bi'
    and, for 'S' in a scan with phantoms, 'ph' (cap each), then but for
    'C' the candidates (cap, n_cand)."""
    names = ['valid', 'bf', 'bi'] + (['ph'] if has_ph and ck[0] == 'S'
                                      else [])
    lay = [(f, i * cap, (cap,)) for i, f in enumerate(names)]
    o = len(names) * cap
    if ck[0] != 'C':
        lay.append(('cands', o, (cap, n_cand)))
        o += cap * n_cand
    return lay, o


def _pack_steps(cfg, segment, has_ph, F, n_cand):
    """Segment's rank steps as ScanSteps: each class's rows in a step padded
    to _row_cap(n) rows. The k-th padded row of a class names block
    k % blocks of pad frame F + k // blocks (_pad_frames), is not valid
    and no phantom, and has no candidate."""
    W, H = cfg.width, cfg.height
    steps = []
    for r in range(SEG):
        sig, blocks, live, pad = [], [], 0, 0
        for ck in sorted(segment):
            sr = segment[ck]
            a, b = sr.off[r], sr.off[r + 1]
            if a == b:
                continue
            n = b - a
            cap = _row_cap(n)
            nb = (W // _grid(ck)) * (H // _grid(ck))
            k = np.arange(cap - n)
            lay, length = _layout(ck, cap, n_cand, has_ph)
            blk = np.zeros(length, np.int64)
            for f, o, shp in lay:
                col = blk[o:o + int(np.prod(shp))].reshape(shp)
                col[:n] = sr.fields[f][a:b]
                if f == 'bf':
                    col[n:] = F + k // nb
                elif f == 'bi':
                    col[n:] = k % nb
                elif f == 'cands':
                    col[n:] = -1
            sig.append((ck, cap, sr.n_ph[r] > 0))
            blocks.append(blk)
            live, pad = live + n, pad + cap - n
        if sig:
            steps.append(ScanStep(tuple(sig), np.concatenate(blocks), live,
                                  pad))
    return steps


def _apply_refine_flags(all_trees, use_map):
    """Rewrite every refine node to the winner the DEVICE picked in-scan
    (use_map: id(alt_cu) -> merged leaf won). The comparison itself —
    min(split subtree, merged leaf) with header costs, nested refines
    bottom-up, ties keeping the split — ran on the cost plane inside the
    scan (the device analog of RdCommitter::commit_tree's
    snapshot/rollback; block_splitter.rs:1079-1152); the host only
    mirrors the recorded decisions into the tree structure. An outer
    winning leaf discards its children's (already applied) inner
    rewrites, matching the device's later-write-wins scatter order."""
    def walk(n):
        if getattr(n, 'refine', False):
            for c in n.children:
                walk(c)
            n.refine = False
            if use_map.get(id(n.alt_cu), False):
                n.split = False
                n.cu = n.alt_cu
                n.children = []
            n.alt_cu = None
        elif n.split:
            for c in n.children:
                walk(c)
    for trees in all_trees:
        for t in trees:
            walk(t)


def commit_frames_device_rd(cfg, origs, all_trees, dev_planes=None,
                            device='cuda', sums=None):
    """Re-decision commit of every frame's tree on the device, one scan.

    Same decision discipline as the native RdCommitter at the production
    operating point (rank_full + rank_trellis + chroma redecide + split
    refinement), with f32 costs (the C++ uses f64), and byte-identical to
    the JAX engine. dev_planes: the (y, cb, cr) uint8 (F', H*W / H*W/4)
    planes of the F = len(origs) frames (F' >= F), already on the device
    that runs the scan; None uploads the frames' planes from `origs` to
    `device` (a sharded stage A shares none). Updates
    cu.luma_mode/chroma_mode/coeffs and the tree structure in place;
    returns per-frame (ry, rcb, rcr).

    Its four phases are spans (trace.span) of the caller's call and
    chunk: device_commit_schedule (the schedule, its padded steps and
    their upload, the scan context's reset), device_commit_scan (issuing
    every rank step; nothing in it waits for the device),
    device_commit_fetch (the one wait: planes and outputs to the host)
    and device_commit_writeback (modes, coefficients and refine flags
    into the CUs). The scan holds its context's lock from the reset to
    the fetch. sums: a dict that gets each phase's seconds and the scan's
    counts (RdScan.counts, COUNTS) added; the counts are also attributes
    of the device_commit_scan span."""
    with contextlib.ExitStack() as held:
        with trace.span('device_commit_schedule', sums):
            if dev_planes is None:
                dev_planes = tuple(
                    _upload(np.stack([np.asarray(o[c], np.uint8).reshape(-1)
                                      for o in origs]), torch.device(device))
                    for c in range(3))
            segments, has_ph = _build_schedule(cfg, all_trees)
            ctx = _context(cfg, len(origs), dev_planes[0].device)
            held.enter_context(ctx.lock)
            scan = RdScan(cfg, len(origs), segments, has_ph, dev_planes, ctx)
        with trace.span('device_commit_scan', sums):
            for si in range(len(segments)):
                scan.run_segment(si)
            trace.annotate(**scan.counts)
        with trace.span('device_commit_fetch', sums):
            host = scan.fetch()
    with trace.span('device_commit_writeback', sums):
        recons, use_map = scan.write_back(host)
        if has_ph:
            _apply_refine_flags(all_trees, use_map)
    if sums is not None:
        for k, v in scan.counts.items():
            sums[k] = sums.get(k, 0) + v
    return recons


# what RdScan.counts holds: rank steps run; K1 launches and their
# positions (the sum of P * B over each launch's jobs, padded rows
# included); graphs captured and replayed (0 off CUDA); schedule rows and
# padded rows over the steps run
COUNTS = ('n_commit_steps', 'n_dq_trellis_launches', 'n_dq_trellis_positions',
          'n_commit_graph_captures', 'n_commit_graph_replays',
          'n_commit_rows_live', 'n_commit_rows_padded')
# scan contexts kept, the most recently used
MAX_CONTEXTS = 4
_contexts = collections.OrderedDict()
_contexts_lock = threading.Lock()


def _context(cfg, F, dev):
    """The scan context of a scan of F frames on `dev` under cfg's
    geometry, QP and rate model: made at its first scan, kept among the
    MAX_CONTEXTS most recently used."""
    P = _pad_frames(cfg.width, cfg.height, F, cfg.log2_ctu_size)
    key = (str(dev), cfg.width, cfg.height, cfg.log2_ctu_size, F, P, cfg.qp,
           bool(cfg.dep_quant_enabled), bool(cfg.cclm_enabled),
           repr(cfg.rate_model))
    with _contexts_lock:
        ctx = _contexts.pop(key, None) or _ScanContext(cfg, F, P, dev)
        _contexts[key] = ctx
        while len(_contexts) > MAX_CONTEXTS:
            _contexts.popitem(last=False)
    return ctx


class _ScanContext:
    """What a scan reads and writes that outlives it, for one device,
    geometry, frame count (F frames, then P pad frames in every plane),
    QP and rate model: the constants and tables, the carry, the frames'
    planes, each class's tables and output planes (`prepare`), a rows
    buffer per step shape (`bufs`) and, on CUDA, per step shape a graph
    and the job shapes of its K1 launches (`graphs`). A captured graph
    reads these tensors by address, so the context holds every one of
    them as long as its graphs; the graphs share one memory pool, and no
    tensor allocated in a capture outlives it. `lock` keeps one scan at
    a time on the context."""

    def __init__(self, cfg, F, P, dev):
        W, H = cfg.width, cfg.height
        self.W, self.H, self.F, self.P, self.dev = W, H, F, P, dev
        self.log2_ctu = cfg.log2_ctu_size
        self.lock = threading.Lock()
        self._consts(cfg, dev)
        # the tables the step reads that their modules make on first use:
        # made here, before any capture
        self.tables = [transforms._dct2(n, dev) for n in (4, 8, 16, 32)] + [
            intra_pred._div_sig(dev), ktr.order_table(dev)]
        self.carry = _carry_init(W, H, F + P, dev)
        self.oy, self.ocb, self.ocr = (
            torch.zeros((F + P, n), dtype=torch.int32, device=dev)
            for n in (H * W, (H // 2) * (W // 2), (H // 2) * (W // 2)))
        self.geo, self.mats, self.out = {}, {}, {}
        self.bufs, self.graphs = {}, {}
        if dev.type == 'cuda':
            self.stream = torch.cuda.Stream(dev)
            self.pool = torch.cuda.graph_pool_handle()
            # cuBLAS's workspace on the capture stream, before any capture
            with torch.cuda.device(dev), torch.cuda.stream(self.stream):
                a = torch.ones((1, 1, 1), device=dev)
                torch.matmul(a, a)
                torch.matmul(a[0], a[0])

    def _consts(self, cfg, dev):
        """QP / rate-model tables and scalars on the device."""
        rm = cfg.rate_model
        dep = cfg.dep_quant_enabled
        qp = cfg.qp
        qp_c = quant.chroma_qp_from_luma(qp)
        self.ls_tab = np.zeros((2, 4), np.int32)
        self.bd_tab = np.zeros((2, 4), np.int32)
        for c in (0, 1):
            for lg in (2, 3, 4, 5):
                qpar = quant.derive_quant_params(
                    qp if c == 0 else qp_c, lg, lg, dep_quant=dep,
                    transform_skip=False)
                self.ls_tab[c, lg - 2] = qpar.ls
                self.bd_tab[c, lg - 2] = qpar.bd_shift
        self.T = _dev_table(mpm_key(rm, dep), dev)
        lam = np.float32(2.0 ** (qp / rm.pick('qp_div', dep, True))
                         * rm.pick('lambda_mul', dep, True))
        co = rm.pick('cclm_offset', dep, True)
        cio = rm.pick('cclm_mode_idx_offset', dep, True)
        cclm_mb = np.float32([int((co + (i + cio) ** rm.cclm_pow) * 16384.0)
                              for i in range(3)])
        self.ncc = float(np.float32(
            int(rm.pick('non_cclm_offset', dep, True) * 16384.0)
            if cfg.cclm_enabled else 0.0))
        # per-CU header-cost constants for the in-scan refine compare
        hdr_s = float(lam) * rm.pick('header_bits', dep, True)
        self.hdr = [float(h) for h in np.float32(
            [hdr_s, hdr_s / 3.0,
             float(lam) * rm.pick('chroma_header_bits', dep, True)])]
        self.lam = _upload(np.asarray(lam, np.float32), dev)
        self.cclm_mb = _upload(cclm_mb, dev)
        self.lam_dq = _upload(kq.lam_dq_table(rm, qp, trellis=True), dev)
        self.lv = _upload(kq.lv_table_device(rm, dep, True), dev)

    def prepare(self, ck):
        """Class ck's tables and output planes, made at its first scan:
        its geometry (`geo`, _geo_dev's), mode matrices (`mats`), and
        output planes (`out`), (F + P, blocks) each, indexed like its
        rows' (bf, bi): 'mode' (int8) but for 'C', 'cmode' (int8) but for
        'L', 'use' (bool, refine phantom won) for 'S'."""
        if ck in self.out:
            return
        W, H, dev = self.W, self.H, self.dev
        tree, log2 = ck
        s = 1 << log2
        if tree != 'C':
            self.geo[(tree, log2, 0)] = _geo_dev(W, H, s, 0, self.log2_ctu,
                                                 dev)
            self.mats[('y', s)] = intra_pred.mats_device_f32(s, 0, dev)
        if tree != 'L':
            cs = s >> 1 if tree == 'S' else 4
            self.geo[(tree, log2, 1)] = _geo_dev(W, H, cs, 1, self.log2_ctu,
                                                 dev)
            self.mats[('c', cs)] = intra_pred.mats_device_f32(cs, 1, dev)
        nb = (W // _grid(ck)) * (H // _grid(ck))
        names = ([] if tree == 'C' else ['mode']) + \
            ([] if tree == 'L' else ['cmode']) + \
            (['use'] if tree == 'S' else [])
        self.out[ck] = {
            f: torch.zeros((self.F + self.P, nb), device=dev,
                           dtype=torch.bool if f == 'use' else torch.int8)
            for f in names}

    def reset(self, dev_planes):
        """A new scan: the carry zeroed, the frames' planes copied in."""
        for t in self.carry:
            t.zero_()
        for dst, src in zip((self.oy, self.ocb, self.ocr), dev_planes):
            dst[:self.F].copy_(src[:self.F])

    def rows_buffer(self, key, n):
        """The (n,) int64 rows buffer of step shape `key`."""
        if key not in self.bufs:
            self.bufs[key] = torch.empty(n, dtype=torch.int64,
                                         device=self.dev)
        return self.bufs[key]

    def capture(self, key, step):
        """step() captured as the graph of step shape `key` (it returns
        the job shapes of its K1 launches): (graph, those shapes). The
        capture runs nothing."""
        g = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.dev), torch.cuda.stream(self.stream):
            g.capture_begin(pool=self.pool, capture_error_mode='thread_local')
            try:
                k1 = step()
            finally:
                g.capture_end()
        self.graphs[key] = (g, k1)
        return self.graphs[key]


class RdScan:
    """One pass of the rank wavefront over a segmented schedule on a scan
    context (_context), which the caller holds by its lock from before
    `__init__` to after the fetch: `__init__` pads and packs the steps
    (_pack_steps), uploads them and resets the context; then
    `run_segment` for each segment in order (no host-device
    synchronization inside), then `finish` (one fetch; writes modes and
    coefficients into the CU objects). `counts` holds what the scan has
    run (COUNTS); it alone counts the K1 launches of replayed graphs."""

    def __init__(self, cfg, F, segments, has_ph, dev_planes, ctx):
        self.W, self.H = cfg.width, cfg.height
        self.cfg = cfg
        self.segments = segments
        self.has_ph = has_ph
        self.cclm = bool(cfg.cclm_enabled)
        self.log2_ctu = cfg.log2_ctu_size
        self.F = F
        dev = dev_planes[0].device
        self.ctx = ctx
        for seg in segments:
            for ck in seg:
                ctx.prepare(ck)
        self.geo, self.mats = ctx.geo, ctx.mats
        n_cand = next((r.fields['cands'].shape[1] for seg in segments
                       for ck, r in seg.items() if ck[0] != 'C'), 1)
        self.key = (has_ph, n_cand)
        self.steps = [_pack_steps(cfg, seg, has_ph, F, n_cand)
                      for seg in segments]
        rows = [st.rows for seg in self.steps for st in seg]
        ends = np.cumsum([len(r) for r in rows]).tolist()
        starts = iter([0] + ends)
        self.offs = [[next(starts) for _ in seg] for seg in self.steps]
        self.sched = _upload(np.concatenate(rows) if rows
                             else np.zeros(0, np.int64), dev)
        ctx.reset(dev_planes)
        self.counts = dict.fromkeys(COUNTS, 0)

    # ------------------------------------------------------------ the scan
    def run_segment(self, si):
        """Every rank step of segment si, in order: its rows copied into
        its shape's buffer, then on CUDA its shape's graph replayed
        (captured first at the shape's first step), else the step run."""
        c = self.counts
        for st, o in zip(self.steps[si], self.offs[si]):
            key = self.key + (st.sig,)
            buf = self.ctx.rows_buffer(key, len(st.rows))
            buf.copy_(self.sched[o:o + len(st.rows)])
            if buf.is_cuda:
                g = self.ctx.graphs.get(key)
                if g is None:
                    g = self.ctx.capture(
                        key, lambda: self._step(self._live(st.sig, buf)))
                    c['n_commit_graph_captures'] += 1
                graph, k1 = g
                graph.replay()
                c['n_commit_graph_replays'] += 1
            else:
                k1 = self._step(self._live(st.sig, buf))
            c['n_commit_steps'] += 1
            c['n_dq_trellis_launches'] += len(k1)
            c['n_dq_trellis_positions'] += sum(
                B * n * m for jobs in k1 for B, n, m in jobs)
            c['n_commit_rows_live'] += st.live
            c['n_commit_rows_padded'] += st.pad

    def _live(self, sig, buf):
        """{class: (fields, has a phantom)} of a step of shape sig, each
        field a view of its rows buffer (_layout); 'valid' and 'ph' as
        bool."""
        live, o = {}, 0
        for ck, cap, ph in sig:
            lay, n = _layout(ck, cap, self.key[1], self.has_ph)
            x = {f: buf[o + a:o + a + int(np.prod(shp))].reshape(shp)
                 for f, a, shp in lay}
            for f in ('valid', 'ph'):
                if f in x:
                    x[f] = x[f] != 0
            live[ck] = (x, ph)
            o += n
        return live

    def _step(self, live):
        """One rank step over the padded rows of every class with rows in
        it (live: _live's), in the JAX scan body's four parts: wave A,
        phase 2, wave B, phase 4. The classes are visited sorted ('C' <
        'L' < 'S', sizes ascending): phase 4 relies on that order (see
        _cu_ranks). Every scatter of the carry is masked by the rows'
        'valid' (and a winning phantom's flag); the outputs go into the
        context's output planes (a padded row's into its pad frame, which
        the fetch does not read). Returns the job shapes of its K1
        launches, [[(B, n, n) per job] per launch]."""
        W, H = self.W, self.H
        ctx = self.ctx
        ry, rcb, rcr, mm, cp, cy, ccb, ccr = ctx.carry
        HWc = (H // 2, W // 2)
        hdrS, hdrL, hdrC = ctx.hdr
        classes = sorted(live)
        k1 = []
        # ---- wave A: luma + derived-chroma predictions against the carry
        # reconstruction (same-rank CUs are never neighbours), then one
        # trellis-RD chain per distinct block size
        A = {}
        pre = {}
        for ck in classes:
            tree, log2 = ck
            x, _n_ph = live[ck]
            n = x['bf'].shape[0]
            s = 1 << log2
            cs = (s >> 1) if tree == 'S' else 4
            lgc = cs.bit_length() - 1
            bf, bi = x['bf'], x['bi']
            d = {'cs': cs, 'n': n}
            if tree != 'C':
                g = self.geo[(tree, log2, 0)]
                cl = x['cands'].clamp(0, 66)
                pall = intra_pred.predict_all_modes_m(
                    _build_v(ry, bf, bi, g), self.mats[('y', s)], s)
                p6 = _sel_modes(pall, cl)
                orig = ctx.oy[bf[:, None], g['scat'][bi]]
                K = cl.shape[1]
                d['cl'] = cl
                d['luma'] = self._push(A, log2, p6.reshape(-1, s * s),
                                       orig[:, None].expand(n, K, s * s)
                                       .reshape(-1, s * s), 0)
            if tree != 'L':
                gc = self.geo[(tree, log2, 1)]
                vcb = _build_v(rcb, bf, bi, gc)
                vcr = _build_v(rcr, bf, bi, gc)
                d['ocb'] = ctx.ocb[bf[:, None], gc['scat'][bi]]
                d['ocr'] = ctx.ocr[bf[:, None], gc['scat'][bi]]
                mc = self.mats[('c', cs)]
                if tree == 'S':
                    K = d['cl'].shape[1]
                    for comp, v in (('cb', vcb), ('cr', vcr)):
                        p6c = _sel_modes(intra_pred.predict_all_modes_m(
                            v, mc, cs), d['cl'])
                        o6 = d['o' + comp][:, None].expand(n, K, cs * cs)
                        d[comp] = self._push(A, lgc, p6c.reshape(-1, cs * cs),
                                             o6.reshape(-1, cs * cs), 1)
                else:
                    # SCIPU chroma: derived from the centre child
                    bx8 = (bi % (W // 8)) * 8
                    by8 = (bi // (W // 8)) * 8
                    ci = ((by8 + 4) >> 2) * (W >> 2) + ((bx8 + 4) >> 2)
                    derived = mm[bf, ci]
                    d['derived'] = derived
                    d['cb'] = self._push(
                        A, 2, intra_pred.predict_modes_m(vcb, derived, mc),
                        d['ocb'], 1)
                    d['cr'] = self._push(
                        A, 2, intra_pred.predict_modes_m(vcr, derived, mc),
                        d['ocr'], 1)
            pre[ck] = d
        resA = self._tq_all(A, k1)

        # ---- phase 2: luma ranking + scatters + mode map; derived chroma
        # costs kept for the CCLM comparison
        for ck in classes:
            tree, log2 = ck
            x, _n_ph = live[ck]
            d = pre[ck]
            n = d['n']
            bf, bi = x['bf'], x['bi']
            keep = x['valid']
            s = 1 << log2
            cs = d['cs']
            o = ctx.out[ck]
            if tree != 'C':
                g = self.geo[(tree, log2, 0)]
                qy, recy, ssd, level = _got(resA, d['luma'])
                K = d['cl'].shape[1]
                n4w = W >> 2
                nbw = W // s
                bx = (bi % nbw) * s
                by = (bi // nbw) * s
                li = ((by + s - 1) >> 2) * n4w + ((bx - 1) >> 2)
                ai = ((by - 1) >> 2) * n4w + ((bx + s - 1) >> 2)
                lm = torch.where(bx > 0, mm[bf, li.clamp(min=0)], 0)
                am = torch.where((by & ((1 << self.log2_ctu) - 1)) != 0,
                                 mm[bf, ai.clamp(min=0)], 0)
                mb = ctx.T[lm[:, None].long(), am[:, None].long(), d['cl']]
                cost_y_mat = _cost16384(ssd.reshape(n, K),
                                        level.reshape(n, K), mb, ctx.lam)
                cost = cost_y_mat
                if tree == 'S':
                    qcb, reccb, ssdcb, lvlcb = _got(resA, d['cb'])
                    qcr, reccr, ssdcr, lvlcr = _got(resA, d['cr'])
                    ssd_c = (ssdcb + ssdcr).reshape(n, K)
                    lvl_c = (lvlcb + lvlcr).reshape(n, K)
                    cost = cost + _cost16384(ssd_c, lvl_c, 0.0, ctx.lam)
                cost = torch.where(x['cands'] < 0, float(BIG_COST), cost)
                win = cost.argmin(1)                      # first index
                m_win = _sel_win(d['cl'], win)
                qy_w = _sel_win(qy.reshape(n, K, -1), win)
                recy_w = _sel_win(recy.reshape(n, K, -1), win)
                rows = g['scat'][bi]
                _put(ry, bf, rows, recy_w, keep)
                crow = g['cells'][bi]
                _put(mm, bf, crow, m_win[:, None].expand(crow.shape), keep)
                o['mode'][bf, bi] = m_win.to(torch.int8)
                # in-step coefficient scatter (a later phantom must be
                # able to overwrite these rows in scan order)
                _put(cy, bf, rows, qy_w, keep)
                cost_w = _sel_win(cost_y_mat, win)
                if tree == 'L' and self.has_ph:
                    # L CUs cannot be phantoms: their cost goes into the
                    # cost plane here
                    _add_at(cp, bf, g['cells'][bi, 0], cost_w + hdrL, keep)
                if tree == 'S':
                    d['cost_y_w'] = cost_w
                    d['qcb_w'] = _sel_win(qcb.reshape(n, K, -1), win) \
                        .reshape(n, cs, cs)
                    d['qcr_w'] = _sel_win(qcr.reshape(n, K, -1), win) \
                        .reshape(n, cs, cs)
                    d['rcb_w'] = _sel_win(reccb.reshape(n, K, -1), win)
                    d['rcr_w'] = _sel_win(reccr.reshape(n, K, -1), win)
                    d['cost_d'] = _cost16384(_sel_win(ssd_c, win),
                                             _sel_win(lvl_c, win), ctx.ncc,
                                             ctx.lam)
                    d['derived'] = m_win
                    d['recy_w'] = recy_w
                    d['qy_w'] = qy_w
            else:
                qcb_w, rcb_w, scb, lcb = _got(resA, d['cb'])
                qcr_w, rcr_w, scr, lcr = _got(resA, d['cr'])
                d['qcb_w'], d['rcb_w'] = qcb_w, rcb_w
                d['qcr_w'], d['rcr_w'] = qcr_w, rcr_w
                d['cost_d'] = _cost16384(scb + scr, lcb + lcr, ctx.ncc,
                                         ctx.lam)

        # ---- wave B: best-of-3 CCLM per chroma CU on the UPDATED luma,
        # then one trellis chain per chroma size
        Bj = {}
        if self.cclm:
            for ck in classes:
                tree, log2 = ck
                if tree == 'L':
                    continue
                x, _n_ph = live[ck]
                d = pre[ck]
                n, cs = d['n'], d['cs']
                lgc = cs.bit_length() - 1
                gc = self.geo[(tree, log2, 1)]
                bf, bi = x['bf'], x['bi']
                gx, gy = gc['xs'][bi], gc['ys'][bi]
                mk = gc['masks'][bi]
                if tree == 'S':
                    own = d['recy_w']
                else:
                    dy8 = torch.arange(8, device=bi.device)
                    bx8 = (bi % (W // 8)) * 8
                    by8 = (bi // (W // 8)) * 8
                    ridx = ((by8[:, None, None] + dy8[None, :, None]) * W
                            + bx8[:, None, None] + dy8[None, None, :])
                    own = ry[bf[:, None, None], ridx].reshape(n, -1)
                TS, LS, LC = intra_pred.cclm_strips(ry, 2 * gx, 2 * gy, cs,
                                                    H, W, bf)
                ctb, clb = intra_pred.cclm_cstrips(rcb, gx, gy, cs, *HWc, bf)
                ctr, clr = intra_pred.cclm_cstrips(rcr, gx, gy, cs, *HWc, bf)
                CT2 = torch.cat([ctb, ctr])
                CL2 = torch.cat([clb, clr])
                modes6 = torch.arange(81, 84, dtype=torch.int32,
                                      device=bi.device).repeat_interleave(
                                          2 * n)
                p6 = intra_pred.cclm_from_own(
                    modes6, own.repeat(6, 1), LC.repeat(6, 1),
                    TS.repeat(6, 1, 1), LS.repeat(6, 1, 1), CT2.repeat(3, 1),
                    CL2.repeat(3, 1), mk.repeat(6, 1), (2 * gy).repeat(6),
                    cs, 1 << self.log2_ctu)
                p6 = p6.reshape(3, 2, n, cs * cs)
                pcb3, pcr3 = p6[:, 0], p6[:, 1]               # (3, n, P)
                sad = ((pcb3 - d['ocb'][None]).abs().sum(2)
                       + (pcr3 - d['ocr'][None]).abs().sum(2))
                pick = sad.argmin(0)                          # 81 wins ties
                idx = pick[None, :, None].expand(1, n, cs * cs)
                d['pick'] = pick
                d['ccb'] = self._push(Bj, lgc, pcb3.gather(0, idx)[0],
                                      d['ocb'], 1)
                d['ccr'] = self._push(Bj, lgc, pcr3.gather(0, idx)[0],
                                      d['ocr'], 1)
        resB = self._tq_all(Bj, k1)

        # ---- phase 4: CCLM-vs-derived decision, chroma scatters and the
        # in-scan refine resolution (phantom vs accumulated region cost)
        for ck in classes:
            tree, log2 = ck
            if tree == 'L':
                continue
            x, n_ph = live[ck]
            d = pre[ck]
            n, cs = d['n'], d['cs']
            bf, bi = x['bf'], x['bi']
            valid = x['valid']
            gc = self.geo[(tree, log2, 1)]
            o = ctx.out[ck]
            cmode = d['derived']
            cost_ch = d['cost_d']
            qcb_w, rcb_w = d['qcb_w'], d['rcb_w']
            qcr_w, rcr_w = d['qcr_w'], d['rcr_w']
            if self.cclm:
                qcb_c, rcb_c, scb, lcb = _got(resB, d['ccb'])
                qcr_c, rcr_c, scr, lcr = _got(resB, d['ccr'])
                pick = d['pick']
                cost_c = _cost16384(scb + scr, lcb + lcr, ctx.cclm_mb[pick],
                                    ctx.lam)
                use = cost_c < d['cost_d']                # derived wins ties
                cmode = torch.where(use, 81 + pick, cmode)
                cost_ch = torch.where(use, cost_c, cost_ch)
                qcb_w = torch.where(use[:, None, None],
                                    qcb_c.reshape(n, cs, cs), qcb_w)
                qcr_w = torch.where(use[:, None, None],
                                    qcr_c.reshape(n, cs, cs), qcr_w)
                rcb_w = torch.where(use[:, None], rcb_c, rcb_w)
                rcr_w = torch.where(use[:, None], rcr_c, rcr_w)
            cost_cu = (d['cost_y_w'] + cost_ch if tree == 'S' else cost_ch)
            keep = valid
            if self.has_ph and tree == 'S':
                gl = self.geo[(tree, log2, 0)]
                cells_r = gl['cells'][bi]                     # (n, n4c)
                if n_ph:
                    # merged-leaf vs accumulated-split comparison at the
                    # phantom's own rank; ties keep the split
                    region = _region_sum(cp[bf[:, None], cells_r])
                    cost_leaf = cost_cu + hdrS
                    use_ph = x['ph'] & (region > cost_leaf)
                    keep = valid | use_ph
                    o['use'][bf, bi] = use_ph
                    prow = gl['scat'][bi]
                    _put(ry, bf, prow, d['recy_w'], use_ph)
                    _put(cy, bf, prow, d['qy_w'], use_ph)
                    _put(mm, bf, cells_r,
                         d['derived'][:, None].expand(cells_r.shape), use_ph)
                _add_at(cp, bf, cells_r[:, 0], cost_cu + hdrS, valid)
                if n_ph:
                    # a winning phantom resets its region to its own leaf
                    # cost (nested refines then see the min)
                    first = torch.zeros_like(cells_r, dtype=torch.float32)
                    first[:, 0] = 1.0
                    _put(cp, bf, cells_r, cost_leaf[:, None] * first, use_ph)
            elif self.has_ph and tree == 'C':
                bx8 = (bi % (W // 8)) * 8
                by8 = (bi // (W // 8)) * 8
                _add_at(cp, bf, (by8 >> 2) * (W >> 2) + (bx8 >> 2),
                        cost_ch + hdrC, valid)
            crows = gc['scat'][bi]
            _put(rcb, bf, crows, rcb_w, keep)
            _put(rcr, bf, crows, rcr_w, keep)
            _put(ccb, bf, crows, qcb_w.reshape(n, -1), keep)
            _put(ccr, bf, crows, qcr_w.reshape(n, -1), keep)
            o['cmode'][bf, bi] = cmode.to(torch.int8)
        return k1

    def _push(self, jobs, lg, pred, orig, c):
        """Queue one trellis-RD job of block size 2^lg for component class
        c (0 luma, 1 chroma); returns its (size, index) tag."""
        n = pred.shape[0]
        full = functools.partial(torch.full, (n,), dtype=torch.int32,
                                 device=pred.device)
        jobs.setdefault(lg, []).append(
            (pred, orig, full(int(self.ctx.ls_tab[c, lg - 2])),
             full(int(self.ctx.bd_tab[c, lg - 2]))))
        return lg, len(jobs[lg]) - 1

    def _tq_all(self, A, k1):
        """DCT -> trellis (K1, one launch for the wave) -> dequant ->
        inverse -> reconstruct -> SSD for every job of one wave; the
        launch's job shapes appended to k1. Returns {lg: [(q, rec, ssd,
        level) per job]}."""
        staged = []
        tr_jobs = []
        for lg in sorted(A):
            jobs = A[lg]
            s = 1 << lg
            pred = torch.cat([j[0] for j in jobs])
            orig = torch.cat([j[1] for j in jobs])
            ls_r = torch.cat([j[2] for j in jobs])
            bd_r = torch.cat([j[3] for j in jobs])
            t = transforms.forward_impl((orig - pred).reshape(-1, s, s))
            staged.append((lg, pred, orig, ls_r, bd_r, jobs))
            tr_jobs.append((t, ls_r, bd_r, lg))
        tr_out = []
        if tr_jobs:
            tr_out = ktr.trellis_rate_batch(tr_jobs, self.ctx.lam_dq,
                                            self.ctx.lv)
            k1.append([tuple(t.shape) for t, _, _, _ in tr_jobs])
        res_map = {}
        for (lg, pred, orig, ls_r, bd_r, jobs), (q, level) in zip(staged,
                                                                  tr_out):
            s = 1 << lg
            r = transforms.inverse_impl(kq.dequantize(q, ls_r, bd_r))
            rec = torch.clamp(pred.reshape(-1, s, s) + r, 0, 255).reshape(
                pred.shape[0], -1)
            e = rec - orig
            ssd = (e * e).sum(1, dtype=torch.int32)
            out, off = [], 0
            for j in jobs:
                n = j[0].shape[0]
                out.append((q[off:off + n], rec[off:off + n],
                            ssd[off:off + n], level[off:off + n]))
                off += n
            res_map[lg] = out
        return res_map

    # ----------------------------------------------------------- the fetch
    def finish(self):
        """Fetch the planes once; write the winner modes, refine flags and
        coefficients into the CUs. Returns ([(ry, rcb, rcr)] int32
        planes, {id(alt_cu): leaf won})."""
        return self.write_back(self.fetch())

    def fetch(self):
        """The scan's frames of the final planes and of its classes'
        output planes on the host: the scan's one wait for the device."""
        F = self.F
        fin = [t.cpu().numpy() for t in _carry_final(self.ctx.carry, F)]
        outs = {ck: {f: t[:F].cpu().numpy()
                     for f, t in self.ctx.out[ck].items()}
                for ck in {ck for seg in self.segments for ck in seg}}
        return fin, outs

    def write_back(self, host):
        """fetch()'s arrays into the CUs: winner modes, refine flags and
        coefficients. Returns finish()'s planes and refine map."""
        W, H, F = self.W, self.H, self.F
        fin, outs = host
        use_map = {}
        for seg in self.segments:
            _extract_costs_modes(seg, outs, use_map)
        ry, rcb, rcr, cyp, ccbp, ccrp = fin
        ry = ry.astype(np.int32).reshape(F, H, W)
        rcb = rcb.astype(np.int32).reshape(F, H // 2, W // 2)
        rcr = rcr.astype(np.int32).reshape(F, H // 2, W // 2)
        for seg in self.segments:
            _extract_coeffs(self.cfg, seg, cyp, ccbp, ccrp, use_map)
        return [(ry[f], rcb[f], rcr[f]) for f in range(F)], use_map


def _got(res, tag):
    lg, i = tag
    return res[lg][i]


def _upload(a, dev):
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


@functools.lru_cache(maxsize=None)
def _dev_table(key, dev):
    """The (67, 67, 67) mode-bit table on the device, once per key."""
    return _upload(_mpm_bits16384(key), dev)


def _extract_costs_modes(seg, outs, use_map):
    """Winner modes and refine flags of a segment's rows from their
    classes' output planes, read at each row's (bf, bi). (Per-CU costs
    stay on device — the in-scan refine resolution is their only
    consumer.)"""
    for ck, rows in seg.items():
        tree = ck[0]
        at = (rows.fields['bf'], rows.fields['bi'])
        o = {f: v[at].tolist() for f, v in outs[ck].items()}
        # modes are written for phantoms too: a refine-flipped merged
        # leaf becomes the final CU with the modes its phantom
        # evaluation ranked best
        if tree != 'C':
            for (cu, ph), m in zip(rows.cus, o['mode']):
                cu.luma_mode = m
        if tree != 'L':
            for (cu, ph), m in zip(rows.cus, o['cmode']):
                cu.chroma_mode = m
        if 'ph' in rows.fields:
            for (cu, ph), u in zip(rows.cus, o['use']):
                if ph:
                    use_map[id(cu)] = bool(u)


def _extract_coeffs(cfg, seg, cyp, ccbp, ccrp, use_map):
    """Winner coefficients from the dense int16 planes (one fancy
    gather per class, then cheap assignments). Losing phantoms carry no
    plane data; winning phantoms are the region's final leaves and
    extract like committed CUs."""
    W, H = cfg.width, cfg.height
    for ck, rows in seg.items():
        tree, log2 = ck
        s = 1 << log2
        sel = [i for i, (cu, ph) in enumerate(rows.cus)
               if (not ph) or use_map.get(id(cu), False)]
        if not sel:
            continue
        live = [rows.cus[i][0] for i in sel]
        bfv = rows.fields['bf'][sel].astype(np.int64)
        biv = rows.fields['bi'][sel]
        if tree != 'C':
            gy_ = _geometry(W, H, s, 0, cfg.log2_ctu_size)
            qy = cyp[bfv[:, None], gy_[5][biv]].reshape(-1, s, s)
            for i, cu in enumerate(live):
                cu.coeffs[0] = qy[i]
        if tree != 'L':
            cs = (s >> 1) if tree == 'S' else 4
            gc_ = _geometry(W, H, cs, 1, cfg.log2_ctu_size)
            qcb = ccbp[bfv[:, None], gc_[5][biv]].reshape(-1, cs, cs)
            qcr = ccrp[bfv[:, None], gc_[5][biv]].reshape(-1, cs, cs)
            for i, cu in enumerate(live):
                cu.coeffs[1] = qcb[i]
                cu.coeffs[2] = qcr[i]


# ========================================================= apply-decisions
# The prototype: decided CU modes applied in dependency-rank order, every
# numeric stage on the device. The host orders the work (rank_groups) and
# plans every step's rows up front (plan_steps); the device runs one step
# per (rank, size, tree, component) group at the bucket-padded batch
# _buckets(B): substituted references from the evolving reconstruction,
# [1 2 1] filter, prediction (or CCLM), DCT-II, greedy dep-quant (K2),
# dequantization, inverse DCT and the scatter. Nothing in the step loop
# waits for the device; the planes and levels are fetched once.


def rank_groups(cus, W, H):
    """Dependency ranks over 4x4 cells (WavefrontSearch._commit's), then
    the CUs grouped by (rank, log2, tree) in sorted key order, each group
    in rank-stable CU order: [((rank, log2, tree), [cu, ...]), ...]."""
    rank_grid = np.zeros((H // 4, W // 4), dtype=np.int32)
    ranks = np.zeros(len(cus), dtype=np.int32)
    for i, cu in enumerate(cus):
        s = 1 << cu.log2
        x4, y4, n4 = cu.x // 4, cu.y // 4, max(s // 4, 1)
        r = 0
        if cu.x > 0:
            col = rank_grid[max(y4 - 1, 0):min(y4 + 2 * n4, H // 4), x4 - 1]
            if col.size:
                r = max(r, int(col.max()))
        if cu.y > 0:
            row = rank_grid[y4 - 1, max(x4 - 1, 0):min(x4 + 2 * n4, W // 4)]
            if row.size:
                r = max(r, int(row.max()))
        # own region: nonzero only for the SCIPU chroma CU (its luma
        # children share these cells) — CCLM reads their co-located luma
        # reconstruction, so it must commit after them
        own = rank_grid[y4:y4 + n4, x4:x4 + n4]
        if own.size:
            r = max(r, int(own.max()))
        ranks[i] = r + 1
        # max, not assignment: the SCIPU chroma CU shares cells with its
        # luma children and must not lower their recorded ranks
        region = rank_grid[y4:y4 + n4, x4:x4 + n4]
        rank_grid[y4:y4 + n4, x4:x4 + n4] = np.maximum(region, ranks[i])
    order = np.argsort(ranks, kind='stable')
    groups = {}
    for i in order:
        cu = cus[i]
        groups.setdefault((int(ranks[i]), cu.log2, cu.tree), []).append(cu)
    return [(k, groups[k]) for k in sorted(groups)]


def _buckets(n):
    """The batch a group of n CUs is padded to: the next power of two."""
    b = 1
    while b < n:
        b <<= 1
    return b


class Step(NamedTuple):
    """One component of one rank group: its CUs (B of them), the padded
    batch Bp, the component and log2 size, and the host arrays the
    device reads: idx (Bp,) block indices on the size's grid (the pads
    repeat the last), modes (Bp,), and the CCLM / other rows of a mixed
    group (None when the group has no CCLM row)."""
    cus: list
    B: int
    Bp: int
    c_idx: int
    log2: int
    idx: np.ndarray
    modes: np.ndarray
    cclm: np.ndarray
    norm: np.ndarray


def plan_steps(cfg, cus):
    """The prototype's schedule: a Step for every non-empty component
    group of rank_groups, in commit order."""
    W, H = cfg.width, cfg.height
    steps = []
    for (rank, log2, tree), batch in rank_groups(cus, W, H):
        comps = ([(0, log2)] if tree in ('S', 'L') else []) + \
            ([(1, log2 - 1), (2, log2 - 1)] if tree in ('S', 'C') else [])
        for c_idx, lg in comps:
            s = 1 << lg
            sh = 0 if c_idx == 0 else 1
            n_bw = (W >> sh) // s
            B = len(batch)
            Bp = _buckets(B)
            idx = np.array([((cu.y >> sh) // s) * n_bw + ((cu.x >> sh) // s)
                            for cu in batch], dtype=np.int64)
            modes = np.array([cu.luma_mode if c_idx == 0 else cu.chroma_mode
                              for cu in batch], dtype=np.int64)
            idx = np.concatenate([idx, np.repeat(idx[-1:], Bp - B)])
            modes = np.concatenate([modes, np.repeat(modes[-1:], Bp - B)])
            is_cclm = modes >= 81
            cclm = norm = None
            if is_cclm.any():
                cclm, norm = np.where(is_cclm)[0], np.where(~is_cclm)[0]
            steps.append(Step(batch, B, Bp, c_idx, lg, idx, modes, cclm,
                              norm))
    return steps


def _step_pred(s, c_idx, recon_flat, src, fill, pi, ni, keep, modes):
    """Gather substituted refs from the reconstruction, [1 2 1]-filter,
    and predict one mode per block. recon_flat has one trailing pad slot;
    src never points at it."""
    if fill.dim() == 1:
        fill = fill[:, None]
    u = torch.where(fill, 128, recon_flat[src])             # (B, L)
    uf = torch.where(keep[None, :], u,
                     (u[:, pi] + 2 * u + u[:, ni] + 2) >> 2)
    v = torch.cat([u, uf], dim=1)
    return intra_pred.predict_modes(v, modes, s, 0 if c_idx == 0 else 1)


def _step_residual(pred, orig, log2, ls, bd_shift, lam_dq, lv):
    """DCT -> greedy dep-quant (K2 on the card) -> dequant -> inverse ->
    reconstruct. Returns (rec (B, s, s) int32, q (B, s, s) int16)."""
    s = 1 << log2
    pred = pred.reshape(-1, s, s).to(torch.int32)
    t = transforms.forward_impl(orig.reshape(-1, s, s) - pred)
    q, _ = kq.greedy_depquant(t, ls, bd_shift, lam_dq, log2, lv)
    d = kq.dequantize(q, ls, bd_shift)
    rec = torch.clamp(pred + transforms.inverse_impl(d), 0, 255)
    return rec, q


def commit_frame_device(cfg, orig_planes, cus, rate_model=None,
                        device=None):
    """Apply decided CU modes on the device in dependency-rank order.

    orig_planes: (Y, Cb, Cr) of one frame; cus: its CuDecisions in coding
    order (WavefrontSearch._collect_cus). device: None = 'cuda' (raises
    without a card). Returns the recon planes [Y, Cb, Cr] as int32 numpy
    and writes each CU's levels into cu.coeffs. Bit-exact against
    WavefrontSearch._commit with trellis_commit=False. On the card every
    step launches K2 once, at its padded batch."""
    from .wavefront import resolve_device
    dev = resolve_device(device)
    W, H = cfg.width, cfg.height
    rm = rate_model or cfg.rate_model
    qp = cfg.qp
    qp_c = quant.chroma_qp_from_luma(qp)
    steps = plan_steps(cfg, cus)
    # every table, parameter and host array the steps read goes up once;
    # the steps index views of it (a blocking upload per step would wait
    # for the device each time)
    qtab = {}
    for c in (0, 1):
        for lg in (2, 3, 4, 5):
            qpar = quant.derive_quant_params(
                qp if c == 0 else qp_c, lg, lg,
                dep_quant=cfg.dep_quant_enabled, transform_skip=False)
            qtab[(c, lg)] = (qpar.ls, qpar.bd_shift)
    keys = sorted(qtab)
    host = [np.asarray([v for k in keys for v in qtab[k]], np.int64)]
    for st in steps:
        host += [st.idx, st.modes] + ([st.cclm, st.norm]
                                      if st.cclm is not None else [])
    pool = _upload(np.concatenate(host), dev)
    views, o = [], 0
    for a in host:
        views.append(pool[o:o + len(a)])
        o += len(a)
    qv = views[0].to(torch.int32)
    qdev = {k: (qv[2 * i:2 * i + 1], qv[2 * i + 1:2 * i + 2])
            for i, k in enumerate(keys)}
    lam_dq = _upload(kq.lam_dq_table(rm, qp, trellis=False), dev)
    lv = _upload(kq.lv_table_device(rm, cfg.dep_quant_enabled, False), dev)
    orig = [_upload(np.asarray(p, np.int32).reshape(-1), dev)
            for p in orig_planes]
    # recon planes, flat with one trailing pad slot: the padded rows of a
    # step scatter there, and nothing reads it
    pads = (H * W, (H // 2) * (W // 2), (H // 2) * (W // 2))
    planes = [torch.zeros(n + 1, dtype=torch.int32, device=dev)
              for n in pads]
    qs = []
    v = 1
    for st in steps:
        idx, modes = views[v], views[v + 1]
        v += 2
        s = 1 << st.log2
        sh = 0 if st.c_idx == 0 else 1
        g = _geo_dev(W, H, s, st.c_idx, cfg.log2_ctu_size, dev)
        rows = g['scat'][idx]                               # (Bp, s*s)
        if st.cclm is None:
            pred = _step_pred(s, st.c_idx, planes[st.c_idx], g['src'][idx],
                              g['fill'][idx], g['pi'], g['ni'], g['keep'],
                              modes)
        else:
            cc, nm = views[v], views[v + 1]
            v += 2
            pred = torch.zeros((st.Bp, s * s), dtype=torch.int32,
                               device=dev)
            ic = idx[cc]
            pred[cc] = intra_pred.predict_cclm(
                modes[cc], planes[0][:-1].reshape(H, W),
                planes[st.c_idx][:-1].reshape(H >> sh, W >> sh),
                g['xs'][ic], g['ys'][ic], s, g['masks'][ic],
                1 << cfg.log2_ctu_size).reshape(-1, s * s)
            if len(st.norm):
                ino = idx[nm]
                pred[nm] = _step_pred(s, st.c_idx, planes[st.c_idx],
                                      g['src'][ino], g['fill'][ino],
                                      g['pi'], g['ni'], g['keep'], modes[nm])
        ls, bd = qdev[(min(st.c_idx, 1), st.log2)]
        rec, q = _step_residual(pred, orig[st.c_idx][rows], st.log2, ls, bd,
                                lam_dq, lv)
        # padded rows write the trailing pad slot
        rows[st.B:] = pads[st.c_idx]
        planes[st.c_idx][rows.reshape(-1)] = rec.reshape(-1)
        qs.append(q[:st.B].reshape(-1))
    sizes = list(pads) + [int(q.numel()) for q in qs]
    flat = torch.cat([p[:-1] for p in planes]
                     + [q.to(torch.int32) for q in qs]).cpu().numpy()
    parts = np.split(flat, np.cumsum(sizes)[:-1])
    for st, qh in zip(steps, parts[3:]):
        s = 1 << st.log2
        qh = qh.astype(np.int16).reshape(st.B, s, s)
        for i, cu in enumerate(st.cus):
            cu.coeffs[st.c_idx] = qh[i]
    return [parts[0].reshape(H, W), parts[1].reshape(H // 2, W // 2),
            parts[2].reshape(H // 2, W // 2)]
