"""Wavefront search in PyTorch: batched QT partition + intra mode decision.

Counterpart of wrenc_tpu/search/wavefront.py for the main path (see that
module's docstring for the two-stage design):

Stage A, luma — on the device: per QT size, the substitution gather and
[1 2 1] filter, the 67-mode sweep as two exact matmuls, SAD + top-K, the
RD chain (DCT-II, greedy dep-quant scan = CUDA kernel K2, or the trellis
= CUDA kernel K1 under `stage_a_trellis_rd=1`, dequantization, SSD), and
the on-device MPM-Jacobi winner selection and ranking. Dispatch does not
synchronize, so chunk k+1's device work runs under chunk k's host passes.

Stage A, chroma — on the device (`fused_chroma_stage_a`: derived-mode,
SCIPU and CCLM candidate RD of every chroma size through the same RD
chain, one fetch per chunk) by default at >= 0.5 Mpx and under the device
commit engine; below that, in the native C++ library. Env
WRENC_CHROMA_STAGE_A or `chroma_stage_a` picks either.

Stage B — on the host, in the native C++ library: the bottom-up QT
decision, tree assembly, and the RD commit against the true
reconstruction in a worker thread (`trellis_commit=False`: the greedy
quantizer; `rd_commit=False`: stage A's decisions applied as they are).
Under `commit_engine='device'` the commit runs on the device instead
(search/device_commit.py), from planes uploaded once per chunk. Under
`qp_delta_pattern` (per-QG QP) every CU carries its CTU's QP and the
NumPy rank-wavefront commit (`_commit`) runs. The decide is a stage of
values: each frame's QT decision is a FrameDecision, its trees are built
from that alone (`_assemble_trees`), and the search object keeps only
its constants and caches, so any commit overlaps the next chunk.

Under `mesh=` (a `dist.Mesh` of torch devices, one process driving every
cell) stage A is sharded: the chunk is padded to a multiple of the
`frame` axis and each frame cell runs `fused_luma_stage_a` on its frames;
with a `row` axis each cell runs `fused_luma_band_stage_a` on its
CTU-row band, with a one-row halo copied from the band above; that
stage A returns unselected candidates, so only there the luma winners
are selected on the host (`_select_modes`). The results are fetched per
cell and concatenated: bit-identical to one device. A mesh uploads no shared
planes, so chroma stage A runs in the native library and the device
commit engine uploads its own planes.
"""
import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from ..dist.process_group import band_stage_a
from ..entropy import native
from ..entropy.structure import CtNode, CuDecision
from ..kernels import intra_pred, np_ops, quantize as kq, refs, transforms
from ..kernels import trellis as ktr
from ..spec import quant
from .device_commit import (commit_frames_device_rd, mpm_bits_f32,
                            mpm_key, rank_groups)


def resolve_device(device):
    """None means the card; a missing card raises (no CPU fallback)."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return dev


def _indexed(dev):
    """'cuda' as the current card's index, so that a mesh's cells and a
    device argument compare as the devices they are."""
    if dev.type == 'cuda' and dev.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return dev


def _mesh_cells(mesh):
    """The mesh's devices as a (frame, row) grid (the row axis of a 1-D
    ('frame',) mesh is 1), each resolved as resolve_device does."""
    names = tuple(mesh.axis_names)
    if names not in (('frame',), ('frame', 'row')):
        raise ValueError(f"mesh axes {names}: want ('frame',) or "
                         "('frame', 'row')")
    shape = mesh.shape
    grid = np.empty(mesh.devices.size, dtype=object)
    for i, d in enumerate(mesh.devices.reshape(-1)):
        grid[i] = _indexed(resolve_device(d))
    return grid.reshape(shape['frame'], shape.get('row', 1))


class WavefrontSearch:
    def __init__(self, cfg, trellis_commit=True, mesh=None, rd_commit=True,
                 commit_engine=None, chroma_stage_a=None, device=None):
        """device: torch device for stage A and the device commit; None =
        'cuda' (raises when no card is present). The other options are as
        in the JAX package: commit_engine 'native' (the threaded C++ RD
        tree commit, default; env WRENC_COMMIT_ENGINE) or 'device' (the
        rank wavefront of search/device_commit.py; it runs only with the
        RD trellis commit, dep-quant and the rate model's
        commit_rank_full, commit_rank_trellis and commit_chroma_redecide
        on, else the native engine runs); chroma_stage_a 'device' or
        'native' (env WRENC_CHROMA_STAGE_A; default 'device' under the
        device engine or at >= 0.5 Mpx); trellis_commit False quantizes
        the commit greedily; rd_commit False applies stage A's decisions
        without re-deciding them.

        mesh: optional dist.Mesh with a 'frame' axis and optionally a
        'row' axis: stage A is sharded over its cells (see the module
        docstring); host passes (decide, commit, entropy) are per frame
        and unaffected. The search's own device is then the mesh's
        first cell, and a `device` naming another raises."""
        cfg.validate()
        self.mesh = mesh
        self._cells = None if mesh is None else _mesh_cells(mesh)
        self.trellis_commit = trellis_commit
        self.rd_commit = rd_commit
        self.commit_engine = commit_engine or os.environ.get(
            'WRENC_COMMIT_ENGINE', 'native')
        if self.commit_engine not in ('native', 'device'):
            raise ValueError(f"commit_engine={self.commit_engine!r}: want "
                             "'native' or 'device'")
        rm = cfg.rate_model
        self._device_commit = bool(
            self.commit_engine == 'device' and rd_commit and trellis_commit
            and cfg.dep_quant_enabled
            and getattr(rm, 'commit_rank_full', 0)
            and getattr(rm, 'commit_rank_trellis', 0)
            and getattr(rm, 'commit_chroma_redecide', 0))
        auto_chroma = ('device' if (self._device_commit or
                                    cfg.width * cfg.height >= 1 << 19)
                       else 'native')
        self._chroma_device = (chroma_stage_a or os.environ.get(
            'WRENC_CHROMA_STAGE_A', auto_chroma)) == 'device'
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = self._cells[0, 0]
            if (device is not None
                    and _indexed(resolve_device(device)) != self.device):
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"cell {self.device}")
        self.cfg = cfg
        self.rm = cfg.rate_model
        qp = cfg.qp
        self.qp_c = quant.chroma_qp_from_luma(qp)
        self.qpar = {}
        for c_idx in (0, 1):
            q = qp if c_idx == 0 else self.qp_c
            for log2 in (2, 3, 4, 5):
                self.qpar[(c_idx, log2)] = quant.derive_quant_params(
                    q, log2, log2, dep_quant=cfg.dep_quant_enabled,
                    transform_skip=False)
        self.lam_dq_greedy = kq.lam_dq_table(self.rm, qp, trellis=False)
        self.lam_dq_trellis = kq.lam_dq_table(self.rm, qp, trellis=True)
        self.lv_greedy = kq.lv_table_device(self.rm, cfg.dep_quant_enabled,
                                            False)
        self.lv_trellis = kq.lv_table_device(self.rm, cfg.dep_quant_enabled,
                                             True)
        dep = cfg.dep_quant_enabled
        self.lam = 2.0 ** (qp / self.rm.pick('qp_div', dep, True)) \
            * self.rm.pick('lambda_mul', dep, True)
        self._mode_bits = self._approx_mode_bits()
        self.mode_bits_scale = getattr(self.rm, 'stage_a_mode_bits_scale',
                                       2.0)
        self._refine_margin = self.rm.split_refine_margin
        self._dev_args = {}
        # summed seconds per phase of the last call (encode_frames resets
        # it), and under keys that start with 'n_' counts (the device
        # commit engine's)
        self.phase_times = {}

    # ------------------------------------------------------------- stage A
    def _approx_mode_bits(self):
        """Static per-mode luma mode-bits estimate (MPM membership is
        neighbour-dependent; stage A uses the expectation)."""
        rm, dep = self.rm, self.cfg.dep_quant_enabled
        out = np.zeros(67, dtype=np.float32)
        out[0] = rm.pick('planar_offset', dep, True)
        mpm = (1.0 + rm.pick('mpm_idx_offset', dep, True)) ** rm.mpm_idx_pow
        rem = rm.pick('mpm_remainder_mult', dep, True) * \
            (30.0 + rm.pick('mpm_remainder_offset', dep, True)) \
            ** rm.mpm_remainder_pow
        out[1:] = rm.pick('non_planar_offset', dep, True) + \
            0.5 * (mpm + rem)
        return out

    def encode_frame(self, planes):
        return self.encode_frames([planes])[0]

    # fixed stage-A batch buckets, as in the JAX package: every frame
    # batch is padded up to one of these, and large frames cap the chunk
    # by a pixel budget so the per-chunk device working set stays bounded
    BATCH_BUCKETS = (1, 2, 4, 8)
    CHUNK_PIXEL_BUDGET = 3_500_000
    # the device commit engine shares one scan among a chunk's frames, so
    # it takes chunks as large as stage-A working memory allows
    DEVICE_BATCH_BUCKETS = (1, 2, 4, 8, 16)
    DEVICE_CHUNK_PIXEL_BUDGET = 9_000_000

    def _commit_group_frames(self):
        """Frames per device commit scan, as in the JAX package: the rank
        count does not grow with the frames, so a larger group spreads each
        step's fixed cost over more of them; 64 up to 0.5 Mpx, else 4."""
        px = self.cfg.width * self.cfg.height
        return 64 if px <= 524_288 else 4

    def _buckets(self):
        px = self.cfg.width * self.cfg.height
        buckets = (self.DEVICE_BATCH_BUCKETS if self._device_commit
                   else self.BATCH_BUCKETS)
        budget = (self.DEVICE_CHUNK_PIXEL_BUDGET if self._device_commit
                  else self.CHUNK_PIXEL_BUDGET)
        bs = [b for b in buckets if b * px <= budget]
        return bs or [1]

    def _bucket(self, n):
        bs = self._buckets()
        for b in bs:
            if n <= b:
                return b
        return bs[-1]

    def encode_frames(self, frames):
        """Chunked batched API: frames are processed in fixed-size stage-A
        batches (padded to a bucket size). The device stage A of chunk k+1
        is dispatched BEFORE the host passes of chunk k run (dispatch does
        not synchronize), and the commit of chunk k runs in a worker
        thread (the native call releases the GIL) under chunk k+1's decide
        phase whenever the call has more than one chunk. The device commit
        engine commits several chunks in one scan (_commit_group_frames).
        Returns [(trees, recon), ...]. Each phase is a span (trace.span) of the
        call's root span and of its chunk; phase_times sums them."""
        from concurrent.futures import ThreadPoolExecutor
        self.phase_times = {}
        out = []
        max_b = self._buckets()[-1]
        chunks = [frames[i:i + max_b] for i in range(0, len(frames), max_b)]
        group_n = 1
        if self._device_commit and max_b < self._commit_group_frames():
            group_n = max(1, self._commit_group_frames() // max_b)
        overlap = len(chunks) > 1
        with trace.call(), ThreadPoolExecutor(max_workers=1) as pool:
            pending = self._dispatch_stage_a(chunks[0], 0)
            prev = None
            gb, gt, gd = [], [], []
            for k, chunk in enumerate(chunks):
                nxt = (self._dispatch_stage_a(chunks[k + 1], k + 1)
                       if k + 1 < len(chunks) else None)
                batch, trees, devp = self._decide_chunk(pending, k)
                gb.extend(batch)
                gt.extend(trees)
                gd.append((devp, len(batch)))
                pending = nxt
                if len(chunks) == k + 1 or (k + 1) % group_n == 0:
                    if not overlap:
                        sums = {}
                        with self._phase('host_commit', k):
                            recons = self._commit_all(gt, gb,
                                                      _merge_devp(gd), sums)
                        self._add_phases(sums)
                        out.extend(zip(gt, recons))
                    else:
                        if prev is not None:
                            out.extend(self._join_commit(prev))
                        fut = pool.submit(self._commit_work, gb, gt,
                                          _merge_devp(gd),
                                          dict(trace.context(), chunk=k))
                        prev = (fut, gt, k)
                    gb, gt, gd = [], [], []
            if prev is not None:
                out.extend(self._join_commit(prev))
        return out

    def _commit_work(self, batch, all_trees, dev_planes, ctx):
        """One commit group in the worker thread, as the span
        host_commit_work of the call and chunk in ctx (trace.context() of
        the submitting thread, and the group's last chunk): (recons, the
        commit's own sums: host_commit_work and the device engine's)."""
        sums = {}
        with trace.span('host_commit_work', sums, **ctx):
            recons = self._commit_all(all_trees, batch, dev_planes, sums)
        return recons, sums

    def _join_commit(self, prev):
        fut, trees, chunk = prev
        # host_commit = time this thread BLOCKED on the commit (the
        # overlap with the next chunk's decide is hidden);
        # host_commit_work = the commit's own wall time in the worker
        with self._phase('host_commit', chunk):
            recons, sums = fut.result()
        # added on this thread: the worker writes into no shared dict
        self._add_phases(sums)
        return list(zip(trees, recons))

    def _add_phases(self, sums):
        """A commit's own sums into phase_times, on the calling thread."""
        for k, v in sums.items():
            self.phase_times[k] = self.phase_times.get(k, 0) + v

    def _phase(self, name, chunk):
        """The span of phase `name` of chunk `chunk`; its seconds add
        into phase_times."""
        return trace.span(name, self.phase_times, chunk=chunk)

    def _device_time(self, m0, m1):
        """Stage A's device seconds between the trace.device_mark marks m0
        and m1, where both were recorded, into
        phase_times['stage_a_device'] and the innermost open span's
        device_ms."""
        dt = trace.device_seconds(m0, m1)
        if dt is not None:
            self.phase_times['stage_a_device'] = (
                self.phase_times.get('stage_a_device', 0.0) + dt)
            trace.annotate(device_ms=dt * 1e3)

    def _stage_a_args(self, dev=None):
        """Device-resident QP tables and scalars for stage A, uploaded once
        per search and device (None: the search's; a mesh's cells each
        read their own): a host scalar handed to a CUDA op inside the
        dispatch would cost a blocking copy per chunk."""
        dev = self.device if dev is None else dev
        if dev not in self._dev_args:
            cfg = self.cfg
            tr = bool(getattr(self.rm, 'stage_a_trellis_rd', 0.0))
            sizes = self._sizes()

            def i32(v):
                return torch.tensor([int(v)], dtype=torch.int32, device=dev)

            def f32(v):
                return torch.as_tensor(np.asarray(v, np.float32), device=dev)

            po, idx_bits, rem_bits = _mpm_scalar_tabs(
                self.rm, cfg.dep_quant_enabled)
            args = self._dev_args[dev] = dict(
                K=int(getattr(self.rm, 'stage_a_num_rd_cands', 4)),
                trellis=tr,
                ls={s: i32(self.qpar[(0, s.bit_length() - 1)].ls)
                    for s in sizes},
                bd={s: i32(self.qpar[(0, s.bit_length() - 1)].bd_shift)
                    for s in sizes},
                lam_dq=torch.as_tensor(
                    self.lam_dq_trellis if tr else self.lam_dq_greedy,
                    device=dev),
                lv=f32(self.lv_trellis if tr else self.lv_greedy),
                lam=f32(np.float32(self.lam)),
                mats={s: intra_pred.mats_device_f32(s, 0, dev)
                      for s in sizes},
                seltabs=(f32(np.float32(self.lam * self.mode_bits_scale)),
                         f32(self._mode_bits), f32(po), f32(idx_bits),
                         f32(rem_bits)))
            if self._chroma_device and self.mesh is None:
                # the chroma QP's ls / bd_shift per chroma size (4, 8, 16),
                # the CCLM mode bits and the chroma mode matrices (a mesh
                # runs chroma stage A in the native library)
                rm, dep = self.rm, cfg.dep_quant_enabled
                co = rm.pick('cclm_offset', dep, True)
                cio = rm.pick('cclm_mode_idx_offset', dep, True)
                args.update(
                    ls_c=tuple(i32(self.qpar[(1, lg)].ls)
                               for lg in (2, 3, 4)),
                    bd_c=tuple(i32(self.qpar[(1, lg)].bd_shift)
                               for lg in (2, 3, 4)),
                    cclm_bits=f32([co + (i + cio) ** rm.cclm_pow
                                   for i in range(3)]),
                    mats_c={cs: intra_pred.mats_device_f32(cs, 1, dev)
                            for cs in self._chroma_sizes()})
            kq.order_table(dev)   # K1's / K2's coding orders, uploaded once
        return self._dev_args[dev]

    def _chroma_sizes(self):
        """Chroma block sizes of the single-tree leaves (QT sizes >= 8)."""
        return tuple(sorted(s // 2 for s in self._sizes() if s >= 8))

    def _sizes(self):
        cfg = self.cfg
        return [1 << (cfg.log2_ctu_size - d)
                for d in range(cfg.max_split_depth, -1, -1)]

    def _dispatch_stage_a(self, frames, chunk=0):
        """Dispatch the fused luma stage A for chunk `chunk` of a call;
        does NOT block. Returns (batch, sizes, device results, device
        planes, marks): the results are fused_luma_stage_a's dict, or under
        a mesh _dispatch_mesh's cells; the planes are (y, cb, cr) uint8
        (F', H*W / H*W/4) for the device chroma stage A and the device
        commit engine, which share the upload, and None when neither runs
        (always under a mesh); the marks are trace.device_mark's pair
        around the dispatch, (None, None) with the recorder off."""
        cfg = self.cfg
        batch = [[np.asarray(p, dtype=np.int32) for p in planes]
                 for planes in frames]
        F = len(batch)
        Fpad = self._bucket(F)
        padded = batch + [batch[-1]] * (Fpad - F) if Fpad > F else batch
        sizes = self._sizes()
        if self.mesh is not None:
            with self._phase('device_dispatch', chunk):
                res = self._dispatch_mesh(
                    np.stack([b[0] for b in padded]).astype(np.uint8), sizes)
            return batch, sizes, res, None, (None, None)
        a = self._stage_a_args()
        with self._phase('device_dispatch', chunk):
            m0 = trace.device_mark(self.device)
            planes = self._upload([b[0] for b in padded])
            dev_planes = None
            if self._device_commit or self._chroma_device:
                dev_planes = (planes.reshape(len(padded), -1),
                              self._upload([b[1] for b in padded]).reshape(
                                  len(padded), -1),
                              self._upload([b[2] for b in padded]).reshape(
                                  len(padded), -1))
            res = fused_luma_stage_a(
                planes, cfg.width, cfg.height, cfg.log2_ctu_size,
                tuple(sizes), a['K'], a['trellis'], a['ls'], a['bd'],
                a['lam_dq'], a['lv'], a['lam'], a['mats'], a['seltabs'])
            marks = (m0, trace.device_mark(self.device))
        return batch, sizes, res, dev_planes, marks

    def _dispatch_mesh(self, planes_y, sizes, rank=0, world_size=1):
        """The sharded stage A of one chunk (planes_y: (F', H, W) uint8 on
        the host, padded to the bucket); does NOT block. The frames are
        padded to a multiple of the frame axis by repeating the last one,
        and the cells run through dist/process_group.band_stage_a: each
        frame cell uploads its frames to its device; under a row axis each
        (frame, row) cell uploads its band, takes the last row of the band
        above as its halo (band 0: zeros) and runs the band stage A, so
        the luma winners are selected on the host. In a torch.distributed
        group (world_size > 1) this rank runs only its own cells. Returns
        the cells' device results, [[{s: outputs} per row band] per frame
        cell] (None for other ranks' cells)."""
        cfg = self.cfg
        W, H, log2_ctu = cfg.width, cfg.height, cfg.log2_ctu_size
        nf, nr = self._cells.shape
        pad = (-len(planes_y)) % nf
        if pad:
            planes_y = np.concatenate(
                [planes_y, np.repeat(planes_y[-1:], pad, axis=0)])

        def run_cell(band, halo, r, dev):
            a = self._stage_a_args(dev)
            if halo is None:
                return fused_luma_stage_a(
                    band, W, H, log2_ctu, tuple(sizes), a['K'],
                    a['trellis'], a['ls'], a['bd'], a['lam_dq'], a['lv'],
                    a['lam'], a['mats'], a['seltabs'])
            return fused_luma_band_stage_a(
                band, halo, W, H, log2_ctu, tuple(sizes), nr, r, a['K'],
                a['trellis'], a['ls'], a['bd'], a['lam_dq'], a['lv'],
                a['lam'], a['mats'])
        return band_stage_a(planes_y, self._cells, self._upload, run_cell,
                            rank, world_size)

    def _upload(self, planes, dev=None):
        """Planes (or rows of small integers) to `dev` (None: the search's
        device) as uint8, from pinned memory without blocking (the caching
        host allocator keeps the pinned block until the copy has run)."""
        dev = self.device if dev is None else dev
        host = torch.from_numpy(np.stack(planes).astype(np.uint8))
        if dev.type == 'cuda':
            host = host.pin_memory()
        return host.to(dev, non_blocking=True)

    def _decide_chunk(self, dispatched, chunk=0):
        """Wait for a dispatched stage A (of chunk `chunk`) and run the
        decide phases; returns (batch, all_trees, device planes) ready for
        _commit_all. The chunk's arrays stay in locals: the search holds
        nothing of a chunk, so chunks may be decided in any order."""
        batch, sizes, res, dev_planes, marks = dispatched
        F = len(batch)
        luma_mode_b, luma_cost_b, luma_cands_b, luma_cand_cost_b = \
            {}, {}, {}, {}
        with self._phase('device_stage_a', chunk):
            res = _fetch_cells(res)                   # waits for the device
            self._device_time(*marks)
        with self._phase('host_select', chunk):
            for s in sizes:
                if len(res[s]) == 3:       # device-side winner selection
                    rk, cost, c2 = res[s]
                    luma_mode_b[s] = rk[:F, :, 0].astype(np.int64)
                    luma_cost_b[s] = cost[:F]
                    luma_cands_b[s] = rk[:F].astype(np.int32)
                    luma_cand_cost_b[s] = c2[:F]
                else:                      # a row mesh's bands: unselected
                    cands, base = res[s]
                    (luma_mode_b[s], luma_cost_b[s], luma_cands_b[s],
                     luma_cand_cost_b[s]) = self._select_modes(
                         s, cands[:F], base[:F])
        with self._phase('host_chroma_rd', chunk):
            chroma_cache = {}
            if self._chroma_device and dev_planes is not None:
                self._prefill_chroma_device(chroma_cache, luma_mode_b, sizes,
                                            F, dev_planes)
            else:
                self._prefill_chroma_cache(chroma_cache, luma_mode_b, sizes,
                                           batch)
        with self._phase('host_decide', chunk):
            all_trees = []
            for fi in range(F):
                dec = self._decide_frame(
                    *({s: b[s][fi] for s in sizes} for b in (
                        luma_mode_b, luma_cost_b, luma_cands_b,
                        luma_cand_cost_b)), chroma_cache, fi)
                all_trees.append(_assemble_trees(self.cfg, dec))
        return batch, all_trees, dev_planes

    def _commit_all(self, all_trees, batch, dev_planes=None, sums=None):
        """Commit every frame's decisions against true reconstruction: in
        the native C++ engine (coding-order walk, the frames' CTU rows a
        wavefront across the host's cores; the RD tree commit, or under
        rd_commit=False the plain commit of the decided CUs), under commit_engine='device' in the device rank
        wavefront, and under qp_delta_pattern in the NumPy rank wavefront
        (`_commit`). The port's native loader raises where the JAX search
        would fall back to the NumPy commit. Runs in a worker thread when
        it overlaps the next chunk (see encode_frames); it reads only its
        arguments and the search's constants. sums: a dict of the caller's
        that the device engine adds its phases' seconds and counts into
        (commit_frames_device_rd)."""
        cfg = self.cfg
        pat = tuple(getattr(cfg, 'qp_delta_pattern', ()) or ())
        if pat:
            # per-QG QP mode: tag every CU with its CTU's target QpY and
            # commit on the NumPy path (per-CU qpar sub-batching)
            n_cols = cfg.width >> cfg.log2_ctu_size
            for trees in all_trees:
                for cu in self._collect_cus(trees):
                    ci = ((cu.y >> cfg.log2_ctu_size) * n_cols
                          + (cu.x >> cfg.log2_ctu_size))
                    cu.qp_y = int(np.clip(cfg.qp + pat[ci % len(pat)],
                                          0, 63))
            return [self._commit(trees, orig)
                    for trees, orig in zip(all_trees, batch)]
        if self._device_commit:
            return commit_frames_device_rd(self.cfg, batch, all_trees,
                                           dev_planes, self.device, sums)
        ls_tab = np.zeros((2, 4), dtype=np.int32)
        bd_tab = np.zeros((2, 4), dtype=np.int32)
        for c in (0, 1):
            for log2 in (2, 3, 4, 5):
                qpar = self.qpar[(c, log2)]
                ls_tab[c, log2 - 2] = qpar.ls
                bd_tab[c, log2 - 2] = qpar.bd_shift
        lam_dq = (self.lam_dq_trellis if self.trellis_commit
                  else self.lam_dq_greedy)
        if self.rd_commit:
            rm, dep = self.rm, self.cfg.dep_quant_enabled
            i = np.arange(1024, dtype=np.float64)
            lv64 = ((i + rm.pick('lv_offset', dep, True))
                    ** rm.pick('lv_pow', dep, True)
                    * 16384.0).astype(np.int64)
            return native.commit_frames_tree_native(
                self.cfg, batch, all_trees, ls_tab, bd_tab, lam_dq,
                self.trellis_commit, lv64)
        cu_lists = [self._collect_cus(trees) for trees in all_trees]
        return native.commit_frames_native(
            self.cfg, batch, cu_lists, ls_tab, bd_tab, lam_dq,
            self.trellis_commit)

    def _decide_frame(self, luma_mode, luma_cost, luma_cands,
                      luma_cand_costs, chroma_cache, fi):
        """The bottom-up QT decision of frame fi of a chunk, from its luma
        stage A ({s: per block} for each QT size, smallest first: the
        winning modes and their costs, the ranked candidates and their
        costs) and the chunk's chroma costs (chroma_cache); returns its
        FrameDecision."""
        cfg = self.cfg
        W, H = cfg.width, cfg.height
        dep = cfg.dep_quant_enabled
        sizes = list(luma_cost)
        cand_mat = (self._prep_cand_matrices(luma_cands, luma_cand_costs)
                    if self.rd_commit else None)

        # chroma costs with derived modes (batched across frames, cached)
        hb = self.rm.pick('header_bits', dep, True)
        chb = self.rm.pick('chroma_header_bits', dep, True)
        ncc = (self.rm.pick('non_cclm_offset', dep, True)
               if cfg.cclm_enabled else 0.0)

        # bottom-up QT decision
        min_s = sizes[0]
        cost = None
        split = {}
        refine = {}
        margin = self._refine_margin if self.rd_commit else 0.0
        cclm_choice = {}
        scipu_choice = None
        for s in sizes:
            n_bw, n_bh = W // s, H // s
            lc = luma_cost[s].reshape(n_bh, n_bw)
            if s == 4:
                # dual-tree luma leaves (inside SCIPU): hb/3, no chroma
                # (mode bits are already inside lc)
                leaf = lc + self.lam * (hb / 3.0)
                cost = leaf
                continue
            cs = s // 2
            # single-tree leaf: luma + best-of(derived, CCLM) chroma + bits
            ch = chroma_cache[('leaf', s)][fi]
            ch_total = ch + self.lam * ncc
            if cfg.cclm_enabled:
                cc, cm = (a[fi] for a in chroma_cache[('cclm', cs)])
                use = cc < ch_total
                cclm_choice[s] = np.where(use, cm, -1)
                ch_total = np.where(use, cc, ch_total)
            leaf = (lc + ch_total.reshape(n_bh, n_bw)
                    + self.lam * hb)
            if cost is None:
                cost = leaf
                split[s] = np.zeros_like(leaf, dtype=bool)
                continue
            agg = (cost[0::2, 0::2] + cost[0::2, 1::2]
                   + cost[1::2, 0::2] + cost[1::2, 1::2])
            if s == 8 and min_s == 4:
                # SCIPU: 4 luma-only children + one chroma CU whose mode is
                # derived from the centre (bottom-right) 4x4 child
                sc_total = chroma_cache[('scipu', 8)][fi] + self.lam * ncc
                if cfg.cclm_enabled:
                    cc, cm = (a[fi] for a in chroma_cache[('cclm', 4)])
                    use = cc < sc_total
                    scipu_choice = np.where(use, cm, -1)
                    sc_total = np.where(use, cc, sc_total)
                agg = agg + sc_total.reshape(n_bh, n_bw) + self.lam * chb
            split_here = agg <= leaf
            split[s] = split_here
            if margin > 0:
                refine[s] = (np.abs(agg - leaf)
                             <= margin * np.maximum(np.abs(leaf), 1.0))
            cost = np.where(split_here, agg, leaf)
        # plain Python lists for the tree walk (one bulk .tolist() per
        # array instead of per-element numpy scalar indexing)
        return FrameDecision(
            {s: m.tolist() for s, m in split.items()},
            {s: m.tolist() for s, m in refine.items()},
            {s: np.asarray(m).tolist() for s, m in luma_mode.items()},
            {s: np.asarray(c).tolist() for s, c in cclm_choice.items()},
            (None if scipu_choice is None
             else np.asarray(scipu_choice).tolist()),
            cand_mat)

    def _select_modes(self, s, cands, base):
        """Pick the winning luma mode per block from stage A's candidates
        on the host, in numpy, where stage A returns them unselected (a
        row mesh's band stage A): the JAX search's arithmetic and dtypes,
        so the same picks and the same np.argsort tie order.

        base is ssd + lam*rate (no mode bits). After a provisional pick
        with the static expectation, each block's MPM list is approximated
        from its left / above same-size neighbours' picks and the
        candidates re-ranked (two Jacobi iterations). The returned cost
        INCLUDES the mode-bit term once."""
        F, N, K = cands.shape
        cfg = self.cfg
        n_bw = cfg.width // s
        n_bh = cfg.height // s
        sc = self.lam * self.mode_bits_scale
        bits = self._mode_bits[cands]
        total = base + sc * bits
        best = np.argmin(total, axis=2)
        mode = np.take_along_axis(cands, best[..., None], 2)[..., 0]
        T = mpm_bits_f32(mpm_key(self.rm, cfg.dep_quant_enabled))
        ctu = cfg.ctu_size
        top_rows = (np.arange(n_bh) * s) % ctu == 0
        for _ in range(2):
            g = mode.reshape(F, n_bh, n_bw)
            lm = np.zeros_like(g)
            lm[:, :, 1:] = g[:, :, :-1]
            am = np.zeros_like(g)
            am[:, 1:, :] = g[:, :-1, :]
            am[:, top_rows, :] = 0       # above-CTU-row not usable
            bits = T[lm.reshape(F, N)[..., None],
                     am.reshape(F, N)[..., None], cands]
            total = base + sc * bits
            best = np.argmin(total, axis=2)
            mode = np.take_along_axis(cands, best[..., None], 2)[..., 0]
        cost = np.take_along_axis(total, best[..., None], 2)[..., 0]
        # candidate list for commit-time re-decision, ranked by stage-A cost
        order = np.argsort(total, axis=2)
        ranked = np.take_along_axis(cands, order, axis=2)
        ranked_cost = np.take_along_axis(total, order, axis=2)
        return (mode.astype(np.int64), cost, ranked.astype(np.int32),
                ranked_cost)

    def _prefill_chroma_cache(self, cache, luma_mode_b, sizes, batch):
        """All chroma stage-A costs of the chunk's frames (batch: per
        frame its three int32 planes) in one native host call
        (wrenc_chroma_stage_a), combined in f64."""
        cfg = self.cfg
        W, H = cfg.width, cfg.height
        F = len(batch)
        dmodes = {}
        for cs in (4, 8, 16):
            s = 2 * cs
            dmodes[cs] = luma_mode_b[s] if s in sizes else None
        scipu_modes = None
        if 4 in sizes and 8 in sizes:
            scipu_modes = luma_mode_b[4].reshape(
                F, H // 4, W // 4)[:, 1::2, 1::2].reshape(F, -1)
        ls_c = [self.qpar[(1, lg)].ls for lg in (2, 3, 4)]
        bd_c = [self.qpar[(1, lg)].bd_shift for lg in (2, 3, 4)]
        res = native.chroma_stage_a_native(
            cfg, batch, dmodes, scipu_modes, ls_c, bd_c,
            self.lam_dq_greedy, self.lv_greedy)
        lam = self.lam
        dep = cfg.dep_quant_enabled

        def combine(ssd, rate):
            c = ssd.astype(np.float64) + lam * rate.astype(np.float64) \
                / 16384.0
            return c[..., 0] + c[..., 1]

        for cs in (4, 8, 16):
            if ('d', cs) in res:
                cache[('leaf', 2 * cs)] = combine(*res[('d', cs)])
        if ('sc',) in res:
            cache[('scipu', 8)] = combine(*res[('sc',)])
        if cfg.cclm_enabled:
            co = self.rm.pick('cclm_offset', dep, True)
            cio = self.rm.pick('cclm_mode_idx_offset', dep, True)
            bits = np.array([co + (i + cio) ** self.rm.cclm_pow
                             for i in range(3)])
            for cs in (4, 8, 16):
                if ('cc', cs) not in res:
                    continue
                c = combine(*res[('cc', cs)])          # (F, 3, N)
                c = c + (lam * bits)[None, :, None]
                best = np.argmin(c, axis=1)
                cost = np.take_along_axis(c, best[:, None, :], axis=1)[:, 0]
                cache[('cclm', cs)] = (cost, (81 + best).astype(np.int32))

    def _prefill_chroma_device(self, cache, luma_mode_b, sizes, F,
                               dev_planes):
        """All chroma stage-A costs on the device (fused_chroma_stage_a),
        combined in f32 there, fetched in one copy and cut to the chunk's
        F frames. While the recorder is on, its device time between marks
        around the dispatch is read once the fetch has waited."""
        m0 = trace.device_mark(self.device)
        res = self._dispatch_chroma(luma_mode_b, sizes, dev_planes)
        m1 = trace.device_mark(self.device)
        parts = [(k, x) for k, v in res.items()
                 for x in (v if isinstance(v, tuple) else (v,))]
        flat = torch.cat([x.reshape(-1).to(torch.float32)
                          for _, x in parts]).cpu().numpy()   # waits
        self._device_time(m0, m1)
        host, o = {}, 0
        for k, x in parts:
            host.setdefault(k, []).append(
                flat[o:o + x.numel()].reshape(x.shape)[:F])
            o += x.numel()
        for (tag, cs), v in host.items():
            if tag == 'd':
                cache[('leaf', 2 * cs)] = v[0].astype(np.float64)
            elif tag == 'sc':
                cache[('scipu', 8)] = v[0].astype(np.float64)
            else:
                best, pick = v
                cache[('cclm', cs)] = (best.astype(np.float64),
                                       (81 + pick).astype(np.int32))

    def _dispatch_chroma(self, luma_mode_b, sizes, dev_planes):
        """Dispatch the fused chroma stage A for one chunk; does NOT block
        (the modes go up from pinned memory). luma_mode_b: {s: (F, N)}
        host luma modes, padded here to the planes' bucket. Returns
        fused_chroma_stage_a's dict, still on the device."""
        cfg = self.cfg
        W, H = cfg.width, cfg.height
        css = self._chroma_sizes()
        scipu = 4 in sizes and 8 in sizes
        Fp = int(dev_planes[0].shape[0])
        a = self._stage_a_args()

        def up(a):
            a = np.asarray(a)
            if a.shape[0] < Fp:
                a = np.concatenate([a] + [a[-1:]] * (Fp - a.shape[0]))
            return self._upload(a)

        dmodes = {cs: up(luma_mode_b[2 * cs]) for cs in css}
        if scipu:
            m4 = luma_mode_b[4]
            scipu_modes = up(m4.reshape(-1, H // 4, W // 4)[:, 1::2, 1::2]
                             .reshape(m4.shape[0], -1))
        else:
            scipu_modes = torch.zeros((Fp, 1), dtype=torch.uint8,
                                      device=self.device)
        return fused_chroma_stage_a(
            *dev_planes, W, H, cfg.log2_ctu_size, css,
            bool(cfg.cclm_enabled), scipu, a['trellis'], dmodes,
            scipu_modes, a['ls_c'], a['bd_c'], a['lam_dq'], a['lv'],
            a['lam'], a['cclm_bits'], a['mats_c'])

    def _prep_cand_matrices(self, luma_cands, luma_cand_costs):
        """Vectorised commit candidate lists per size: ranked stage-A
        candidates + the +-1 probes around the best angular (the reference
        step search's final refinement, block_splitter.rs:905-974), with
        confident blocks pruned to the winner alone. -1 pads. Returns
        {s: (N, K+2) int32}."""
        cand_mat = {}
        prune = getattr(self.rm, 'rd_commit_prune_margin', 0.0)
        for s in luma_cands:
            cands = np.asarray(luma_cands[s])             # (N, K) ranked
            costs = np.asarray(luma_cand_costs[s])
            N, K = cands.shape
            out = np.full((N, K + 2), -1, np.int32)
            out[:, :K] = cands
            has_ang = cands >= 2
            first = np.argmax(has_ang, axis=1)
            ang = cands[np.arange(N), first]
            valid = has_ang.any(axis=1)
            for d, col in ((-1, K), (1, K + 1)):
                nb = ang + d
                ok = (valid & (nb >= 2) & (nb <= 66)
                      & ~(cands == nb[:, None]).any(axis=1))
                out[ok, col] = nb[ok]
            if prune > 0 and K > 1:
                pr = (costs[:, 1] - costs[:, 0]
                      > prune * np.maximum(np.abs(costs[:, 0]), 1.0))
                out[pr, 1:] = -1
            cand_mat[s] = out
        return cand_mat

    # ------------------------------------------------------------- commit
    def _collect_cus(self, trees):
        out = []

        def walk(n):
            if n.split:
                for c in n.children:
                    walk(c)
            else:
                out.append(n.cu)
        for t in trees:
            if t.split:
                for c in t.children:
                    walk(c)
            elif t.cu is not None:
                out.append(t.cu)
            # SCIPU chroma node appears in children; handled by walk
        return out

    def _commit(self, trees, orig):
        """The NumPy rank-wavefront commit of one frame (orig: its three
        int32 planes): the decided modes applied in dependency-rank order
        (rank_groups), each (rank, size, tree) group as one batch per
        component."""
        cfg = self.cfg
        W, H = cfg.width, cfg.height
        recon = [np.zeros((H, W), dtype=np.int32),
                 np.zeros((H // 2, W // 2), dtype=np.int32),
                 np.zeros((H // 2, W // 2), dtype=np.int32)]
        for (rank, log2, tree), batch in rank_groups(
                self._collect_cus(trees), W, H):
            if tree in ('S', 'L'):
                self._commit_comp(batch, 0, log2, recon, orig)
            if tree in ('S', 'C'):
                self._commit_comp(batch, 1, log2 - 1, recon, orig)
                self._commit_comp(batch, 2, log2 - 1, recon, orig)
        return recon

    def _commit_comp(self, batch, c_idx, log2, recon, orig):
        cfg = self.cfg
        W, H = cfg.width, cfg.height
        s = 1 << log2
        sh = 0 if c_idx == 0 else 1
        xs = np.array([cu.x >> sh for cu in batch], dtype=np.int64)
        ys = np.array([cu.y >> sh for cu in batch], dtype=np.int64)
        masks_all = refs.avail_masks(W, H, s, 0 if c_idx == 0 else 1,
                                     cfg.log2_ctu_size)
        n_bw = (W >> sh) // s
        midx = (ys // s) * n_bw + (xs // s)
        masks = masks_all[midx]
        modes = np.array([cu.luma_mode if c_idx == 0 else cu.chroma_mode
                          for cu in batch], dtype=np.int64)
        is_cclm = modes >= 81
        pred = np.zeros((len(batch), s, s), dtype=np.int32)
        norm = np.where(~is_cclm)[0]
        if norm.size:
            u = refs.gather_u(recon[c_idx], xs[norm], ys[norm], s)
            u = refs.substitute(u, masks[norm], s)
            v = intra_pred.make_v(u, s)
            pred[norm] = np_ops.predict_modes_np(
                v, modes[norm], s, 0 if c_idx == 0 else 1).reshape(-1, s, s)
        for m in (81, 82, 83):
            sel = np.where(modes == m)[0]
            if sel.size:
                pred[sel] = np_ops.predict_cclm_np(
                    m, recon[0], recon[c_idx], xs[sel], ys[sel], s,
                    masks[sel], cfg.ctu_size)
        org = np.stack([orig[c_idx][y:y + s, x:x + s]
                        for x, y in zip(xs, ys)])
        res = org - pred
        t = np_ops.forward_dct2_np(res)
        lam_dq = np.asarray(self.lam_dq_trellis if self.trellis_commit
                            else self.lam_dq_greedy)
        # per-CU quant params: fixed-QP uses the precomputed pair; the
        # qp_delta_pattern mode sub-batches by each CU's target QpY
        # (lam_dq stays at the base QP — level choice is an RD matter,
        # conformance only needs quantize/dequantize at the signalled QP)
        qp_cu = np.array([getattr(cu, 'qp_y', -1) if
                          getattr(cu, 'qp_y', None) is not None else -1
                          for cu in batch])
        if (qp_cu >= 0).any():
            qpars = {}
            for uq in np.unique(qp_cu):
                qq = cfg.qp if uq < 0 else int(uq)
                if c_idx != 0:
                    qq = quant.chroma_qp_from_luma(qq)
                qpars[uq] = quant.derive_quant_params(
                    qq, log2, log2, dep_quant=cfg.dep_quant_enabled,
                    transform_skip=False)
        else:
            qpars = {-1: self.qpar[(min(c_idx, 1), log2)]}
            qp_cu = np.full(len(batch), -1)
        q = np.zeros_like(t)
        d = np.zeros_like(t)
        for uq, qpar in qpars.items():
            sel = np.where(qp_cu == uq)[0]
            ts = t[sel]
            if cfg.dep_quant_enabled:
                # the JAX search takes np_ops' quantizers when the native
                # library is missing; the port's loader raises instead, so
                # here they are never a second path (the tests hold the
                # native quantizers to them)
                fn = (native.trellis_quant_native if self.trellis_commit
                      else native.greedy_quant_native)
                qs = fn(ts, qpar.ls, qpar.bd_shift, lam_dq, log2)
            else:
                qs = np.stack([quant.quantize_rdoq_off(tt, qpar)
                               for tt in ts])
            q[sel] = qs
            d[sel] = np_ops.dequantize_np(qs, qpar.ls, qpar.bd_shift)
        r = np_ops.inverse_dct2_np(d)
        rec = np.clip(pred + r, 0, 255)
        for i, cu in enumerate(batch):
            recon[c_idx][ys[i]:ys[i] + s, xs[i]:xs[i] + s] = rec[i]
            cu.coeffs[c_idx] = q[i]


class FrameDecision(NamedTuple):
    """One frame's QT decision (WavefrontSearch._decide_frame) as plain
    lists per QT size s: split / refine flags (H/s rows of W/s), each
    block's luma mode and CCLM choice (-1: derived) in raster order, the
    SCIPU chroma CU's CCLM choice per 8x8 block (None without SCIPU or
    CCLM), and the RD commit's candidate rows (None without it)."""
    split: dict
    refine: dict
    luma_mode: dict
    cclm_choice: dict
    scipu_choice: list
    cand_mat: dict


def _assemble_trees(cfg, dec):
    """One frame's CTU trees, in raster order, from its FrameDecision
    alone."""
    W = cfg.width
    min_log2 = cfg.log2_ctu_size - cfg.max_split_depth

    def leaf(x, y, log2, tree, s):
        idx = (y // s) * (W // s) + x // s
        m = int(dec.luma_mode[s][idx])
        cmode = m
        if tree == 'S' and s in dec.cclm_choice:
            cc = int(dec.cclm_choice[s][idx])
            if cc >= 0:
                cmode = cc
        cu = CuDecision(x, y, log2, tree, luma_mode=m,
                        chroma_mode=(cmode if tree == 'S' else 0))
        if dec.cand_mat is not None:
            cu.cands = dec.cand_mat[s][idx]   # fixed-width row, -1 padded
        return cu

    def node(x, y, log2, cqt_depth, tree, mode_type):
        s = 1 << log2
        n = CtNode(x, y, log2, cqt_depth, tree, mode_type)
        do_split = log2 > min_log2 and bool(dec.split[s][y // s][x // s])
        if (tree == 'S' and log2 > min_log2 and s in dec.refine
                and bool(dec.refine[s][y // s][x // s])):
            n.refine = True
            n.alt_cu = leaf(x, y, log2, tree, s)
            do_split = True
        if not do_split:
            n.cu = leaf(x, y, log2, tree, s)
            return n
        n.split = True
        half = s >> 1
        scipu = tree == 'S' and s == 8 and cfg.chroma_format == 1
        for i in range(4):
            n.children.append(node(
                x + (i % 2) * half, y + (i // 2) * half, log2 - 1,
                cqt_depth + 1, 'L' if scipu else tree,
                'INTRA' if scipu else mode_type))
        if scipu:
            ch = CtNode(x, y, log2, cqt_depth, 'C', 'INTRA')
            center = int(dec.luma_mode[4][(y // 4 + 1) * (W // 4)
                                          + (x // 4 + 1)])
            if dec.scipu_choice is not None:
                cc = int(dec.scipu_choice[(y // 8) * (W // 8) + x // 8])
                if cc >= 0:
                    center = cc
            ch.cu = CuDecision(x, y, log2, 'C', luma_mode=0,
                               chroma_mode=center)
            n.children.append(ch)
        return n

    cs = cfg.ctu_size
    return [node(cx, cy, cfg.log2_ctu_size, 0, 'S', 'ALL')
            for cy in range(0, cfg.height, cs) for cx in range(0, W, cs)]


def _fetch_cells(cells):
    """Stage A's device results on the host: {s: outputs} of one device,
    or a mesh's [[{s: outputs} per row band] per frame cell], each cell's
    outputs fetched (waiting for its device), the bands of a frame cell
    concatenated along the blocks (in row order, which is the full-frame
    raster block order) and the frame cells along the frames. Returns
    {s: tuple of numpy arrays}."""
    if isinstance(cells, dict):
        cells = [[cells]]

    def cat(parts, axis):
        if len(parts) == 1:
            return parts[0]
        return {s: tuple(np.concatenate([p[s][i] for p in parts], axis)
                         for i in range(len(parts[0][s])))
                for s in parts[0]}

    return cat([cat([{s: tuple(x.cpu().numpy() for x in r)
                      for s, r in band.items()} for band in bands], 1)
                for bands in cells], 0)


def _merge_devp(gd):
    """Concatenate per-chunk device planes ((y, cb, cr) uint8, padded to
    the stage-A bucket) into one commit group's; None for the native
    engine."""
    if any(d is None for d, n in gd):
        return None
    if len(gd) == 1:
        d, n = gd[0]
        return tuple(p[:n] for p in d)
    return tuple(torch.cat([d[i][:n] for d, n in gd]) for i in range(3))


# ------------------------------------------------------ luma stage A
def _mpm_list_dev(l, a):
    """Tensor replica of entropy.syntax.derive_mpm_list over int vectors
    (spec 8.4.2; ctu.rs:1530-1601). Pure integer logic — agrees with the
    scalar host function for every (l, a) pair (unit-tested)."""
    mn, mx = torch.minimum(l, a), torch.maximum(l, a)
    d = mx - mn

    def m64(x, k):
        return 2 + (x + k) % 64           # floor modulo, as in Python

    def st(*cols):
        return torch.stack(cols, dim=-1)

    A = st(l, m64(l, 61), m64(l, -1), m64(l, 60), m64(l, 0))
    B1 = st(l, a, m64(mn, 61), m64(mx, -1), m64(mn, 60))
    B2 = st(l, a, m64(mn, -1), m64(mx, 61), m64(mn, 0))
    B3 = st(l, a, m64(mn, -1), m64(mn, 61), m64(mx, -1))
    B4 = st(l, a, m64(mn, 61), m64(mn, -1), m64(mx, 61))
    C = st(mx, m64(mx, 61), m64(mx, -1), m64(mx, 60), m64(mx, 0))
    D = _mpm_default(l.dtype, l.device).expand(l.shape + (5,))
    d_ = d[..., None]
    B = torch.where(d_ == 1, B1,
                    torch.where(d_ >= 62, B2, torch.where(d_ == 2, B3, B4)))
    diff = (l != a)[..., None]
    any_ang = ((l > 1) | (a > 1))[..., None]
    return torch.where(((l == a) & (l > 1))[..., None], A,
                       torch.where(diff & any_ang & (mn > 1)[..., None], B,
                                   torch.where(diff & any_ang, C, D)))


@functools.lru_cache(maxsize=None)
def _mpm_default(dtype, device):
    """The MPM list when neither neighbour is angular (cached on the
    device: a fresh host tensor per call would block the dispatch)."""
    return torch.tensor([1, 50, 18, 46, 54], dtype=dtype, device=device)


def _bits_dev(cands, C, po, idx_bits, rem_bits):
    """Mode-bit estimate for each candidate given the (.., 5) MPM list —
    the device replica of the host (67, 67, 67) table's row construction.
    po/idx_bits/rem_bits are host-precomputed in f64 and rounded to f32."""
    cm = cands[..., None] == C[..., None, :]              # (.., K, 5)
    has = cm.any(-1)
    fi = cm.to(torch.int32).argmax(-1)                    # first index
    ib = idx_bits[fi]
    cnt = (C[..., None, :] < cands[..., None]).sum(-1)
    rem = (cands - 1 - cnt).clamp(0, rem_bits.shape[0] - 1)
    rb = rem_bits[rem]
    return torch.where(cands == 0, po, torch.where(has, ib, rb))


def _select_modes_dev(base, cands, nbh, nbw, top_mask, sc, mb67, po,
                      idx_bits, rem_bits, iters=2):
    """Static-bits provisional pick, then `iters` Jacobi refinements where
    each block's MPM list is approximated from its left/above same-size
    neighbours' picks; ranks the candidates by final cost. Every f32
    `base + sc * bits` is one fused multiply-add, as XLA computes it."""
    F = base.shape[0]
    total = transforms.fma(sc, mb67[cands], base)
    pick = total.argmin(2)                                # first index
    mode = cands.gather(2, pick[..., None])[..., 0]
    for _ in range(iters):
        g = mode.reshape(F, nbh, nbw)
        lm = torch.zeros_like(g)
        lm[:, :, 1:] = g[:, :, :-1]
        am = torch.zeros_like(g)
        am[:, 1:, :] = g[:, :-1, :]
        am = torch.where(top_mask[None, :, None], 0, am)   # above-CTU row
        C = _mpm_list_dev(lm.reshape(F, -1), am.reshape(F, -1))
        bits = _bits_dev(cands, C, po, idx_bits, rem_bits)
        total = transforms.fma(sc, bits, base)
        pick = total.argmin(2)
        mode = cands.gather(2, pick[..., None])[..., 0]
    order = torch.argsort(total, dim=2, stable=True)
    ranked = cands.gather(2, order)
    cost = total.gather(2, order)
    return ranked.to(torch.int8), cost[..., 0], cost[..., :2]


def _mpm_scalar_tabs(rm, dep):
    """Host-side f64-exact scalar tables consumed by _bits_dev."""
    po = rm.pick('planar_offset', dep, True)
    npo = rm.pick('non_planar_offset', dep, True)
    mio = rm.pick('mpm_idx_offset', dep, True)
    mrm = rm.pick('mpm_remainder_mult', dep, True)
    mro = rm.pick('mpm_remainder_offset', dep, True)
    idx_bits = np.float32([npo + (i + mio) ** rm.mpm_idx_pow
                           for i in range(5)])
    rem = np.arange(66, dtype=np.float64)
    rem_bits = (npo + mrm * (rem + mro) ** rm.mpm_remainder_pow) \
        .astype(np.float32)
    return np.float32(po), idx_bits, rem_bits


@functools.lru_cache(maxsize=None)
@trace.table
def _luma_consts(W, H, log2_ctu, sizes, device):
    """Static per-geometry gather tables on the device (cached per
    process, geometry and device)."""
    consts = {}
    ctu = 1 << log2_ctu
    for s in sizes:
        src, fill = refs.subst_gather(W, H, s, 0, log2_ctu)
        pi, ni, keep = refs.filter121_indices(s)
        top_mask = (np.arange(H // s) * s) % ctu == 0
        consts[s] = tuple(torch.as_tensor(x, device=device) for x in (
            src.astype(np.int64), fill, pi.astype(np.int64),
            ni.astype(np.int64), keep, top_mask))
    return consts


@functools.lru_cache(maxsize=None)
@trace.table
def _chroma_consts(W, H, log2_ctu, css, device):
    """Static per-geometry chroma tables on the device (cached per process,
    geometry and device): per chroma size the substitution gather, the
    [1 2 1] filter indices, the availability masks and the block grid."""
    consts = {}
    for cs in css:
        src, fill = refs.subst_gather(W, H, cs, 1, log2_ctu)
        pi, ni, keep = refs.filter121_indices(cs)
        masks = refs.avail_masks(W, H, cs, 1, log2_ctu)
        xs, ys = refs.block_grid(W, H, cs, 1)
        consts[cs] = tuple(torch.as_tensor(x, device=device) for x in (
            src.astype(np.int64), fill, pi.astype(np.int64),
            ni.astype(np.int64), keep, masks, xs, ys))
    return consts


def fused_chroma_stage_a(py, pcb, pcr, W, H, log2_ctu, css, cclm, scipu,
                         trellis, dmodes, scipu_modes, ls_c, bd_c, lam_dq,
                         lv, lam, cclm_bits, mats):
    """The whole chroma stage A for one chunk (the JAX
    `_fused_chroma_builder`), from the ORIGINAL planes: for every chroma
    size cs in `css`, the derived-mode RD cost per block (cb + cr), the
    SCIPU variant at cs = 4 when `scipu`, and, when `cclm`, the three CCLM
    candidates' costs with their mode bits and the pick.

    py: (F, H*W), pcb / pcr: (F, H*W/4) uint8 planes on the device;
    dmodes: {cs: (F, N_cs) derived modes}; scipu_modes: (F, N_4) (unused
    without SCIPU); ls_c / bd_c: the chroma QP's parameters for cs 4, 8,
    16; lam_dq / lv: the stage-A quantizer tables (trellis variants when
    `trellis`: K1, else K2); lam: f32 lambda; cclm_bits: (3,) f32; mats:
    {cs: intra_pred.mats_device_f32(cs, 1, device)}. Every cost is
    ssd + lam * rate / 16384 with one rounding (_rd_cost). Returns
    {('d', cs): (F, N) f32, ('sc', 4): (F, N) f32, ('cc', cs): (best cost
    (F, N) f32, pick (F, N) int8, the first of equal costs)}, all still on
    the device."""
    F = py.shape[0]
    consts = _chroma_consts(W, H, log2_ctu, css, py.device)
    py = py.to(torch.int32)
    # cb and cr as one batch of 2F planes: every block's cost is its own,
    # so one RD chain serves both and the halves are added after
    pc = torch.cat([pcb, pcr]).to(torch.int32)
    hh, hw = H // 2, W // 2
    out = {}
    for cs in css:
        src, fill, pi, ni, keep, masks, xs, ys = consts[cs]
        lgc = cs.bit_length() - 1
        N = src.shape[0]
        ls, bd = ls_c[lgc - 2], bd_c[lgc - 2]
        m = mats[cs]

        def eval_rd(pred, orig):
            ssd, rate = _rd_eval_inner(pred.reshape(-1, cs, cs), orig, ls,
                                       bd, lam_dq, lv, lgc, trellis)
            return _rd_cost(ssd, rate, lam)

        oc = _tiles(pc, hh, hw, cs)                    # (2*F*N, cs, cs)
        vc = _ref_vectors(pc, src, fill, pi, ni, keep)

        def derived_cost(modes):
            c = eval_rd(intra_pred.predict_modes_m(
                vc, modes.reshape(-1).repeat(2), m), oc).reshape(2, F, N)
            return c[0] + c[1]

        if cs in dmodes:
            out[('d', cs)] = derived_cost(dmodes[cs])
        if cs == 4 and scipu:
            out[('sc', cs)] = derived_cost(scipu_modes)
        if cclm:
            out[('cc', cs)] = _cclm_costs(
                py, pc, oc, masks, xs, ys, cs, F, H, W, log2_ctu, eval_rd,
                lam, cclm_bits)
    return out


def _cclm_costs(py, pc, oc, masks, xs, ys, cs, F, H, W, log2_ctu, eval_rd,
                lam, cclm_bits):
    """The three CCLM candidates (81, 82, 83) of every cs-block of the F
    frames, candidate-major over (plane, frame, block) in one batch of
    6 * F * N (pc: the 2F cb-then-cr planes, oc their blocks): the cb + cr
    RD cost plus lam * the mode's bits, and the pick (int8 0..2, the first
    of equal costs, as jnp.argmin) with its cost."""
    dev = py.device
    N = xs.shape[0]
    B1 = F * N
    hh, hw = H // 2, W // 2
    # the frame of each (plane, frame, block): cr's planes follow cb's
    frame = torch.arange(2 * F, dtype=torch.int32, device=dev)[:, None] \
        .expand(2 * F, N).reshape(-1)
    xB, yB = xs.repeat(F), ys.repeat(F)
    own = _tiles(py, H, W, 2 * cs)
    TS, LS, LC = intra_pred.cclm_strips(py, 2 * xB, 2 * yB, cs, H, W,
                                        frame[:B1])
    ct, cl = intra_pred.cclm_cstrips(pc, xB.repeat(2), yB.repeat(2), cs, hh,
                                     hw, frame)

    def rep(a, n):
        return a.repeat((n,) + (1,) * (a.dim() - 1))

    m6 = torch.arange(81, 84, dtype=torch.int32, device=dev)[:, None] \
        .expand(3, 2 * B1).reshape(-1)
    p6 = intra_pred.cclm_from_own(
        m6, rep(own, 6), rep(LC, 6), rep(TS, 6), rep(LS, 6), rep(ct, 3),
        rep(cl, 3), masks.repeat(6 * F, 1), rep(2 * yB, 6), cs, 1 << log2_ctu)
    c6 = eval_rd(p6, rep(oc, 3)).reshape(3, 2, F, N)
    cc = c6[:, 0] + c6[:, 1]
    # XLA contracts the reference's cc + lam * bits into one FMA as well
    c0, c1, c2 = transforms.fma(lam, cclm_bits[:, None, None], cc).unbind(0)
    # the first index of the least cost, with two strict compares
    first = c1 < c0
    best = torch.where(first, c1, c0)
    pick = first.to(torch.int8)
    second = c2 < best
    return torch.where(second, c2, best), torch.where(second, 2, pick)


def _rd_cost(ssd, rate, lam):
    """The stage-A RD cost ssd + lam * (rate / 16384) in f32 with one
    rounding: XLA contracts the reference's expression into a fused
    multiply-add."""
    return transforms.fma(lam, rate / 16384.0, ssd)


def _tiles(flat, h, w, s):
    """(F, h*w) planes -> (F*N, s, s) blocks of the aligned s-grid, in
    raster order of the blocks."""
    return flat.reshape(-1, h // s, s, w // s, s).permute(0, 1, 3, 2, 4) \
        .reshape(-1, s, s)


def _ref_vectors(flat, src, fill, pi, ni, keep):
    """Every block's reference vector v = [u, [1 2 1]-filtered u] from
    (F, h*w) planes: the static substitution gather (`refs.subst_gather`;
    blocks with nothing available read 128) and the filter's index
    tables (`refs.filter121_indices`). Returns (F*N, 2L) int32."""
    u = torch.where(fill[None, :, None], 128, flat[:, src])
    u = u.reshape(-1, src.shape[1])
    uf = torch.where(keep[None, :], u,
                     (u[:, pi] + 2 * u + u[:, ni] + 2) >> 2)
    return torch.cat([u, uf], dim=1)


def fused_luma_stage_a(planes, W, H, log2_ctu, sizes, K, trellis, ls, bd,
                       lam_dq, lv, lam, mats, seltabs=None, sel=True):
    """The whole luma stage A for one chunk (the JAX `_fused_luma_builder`).
    planes: (F, H, W) uint8 on the device. With on-device selection (sel)
    returns {s: (ranked cands int8 (F, N, K+2), best cost f32 (F, N),
    top-2 costs f32 (F, N, 2))}; without, {s: (cands int8 (F, N, K+2),
    base cost f32 (F, N, K+2))} for the host's _select_modes. All still on
    the device. seltabs (the selection's tables) is read only under sel."""
    F = planes.shape[0]
    consts = _luma_consts(W, H, log2_ctu, sizes, planes.device)
    flat = planes.to(torch.int32).reshape(F, H * W)
    if sel:
        sc, mb67, po, idx_bits, rem_bits = seltabs
    out = {}
    for s in sizes:
        N, top_mask = consts[s][0].shape[0], consts[s][5]
        cands, cost = _luma_cands(flat, flat, H, W, s, consts[s], K,
                                  trellis, ls, bd, lam_dq, lv, lam, mats)
        if not sel:
            out[s] = (cands.reshape(F, N, -1), cost.reshape(F, N, -1))
            continue
        out[s] = _select_modes_dev(
            cost.reshape(F, N, -1), cands.reshape(F, N, -1).long(), H // s,
            W // s, top_mask, sc, mb67, po, idx_bits, rem_bits)
    return out


@functools.lru_cache(maxsize=None)
@trace.table
def _band_tables(W, H, log2_ctu, sizes, nr):
    """The row-band gather tables of `nr` equal CTU-row bands (the JAX
    `_fused_luma_sharded_builder`'s): per size, (band 0's, the interior
    bands') (src, fill), the full-frame substitution gather's rows of
    the band moved into band-local coordinates, where row 0 is the halo
    row from the band above. Band 0 keeps its own table (the picture
    top); every other band shares one, which is asserted, as are
    CTU-row-aligned equal bands."""
    band_h = H // nr
    if band_h % (1 << log2_ctu) or band_h * nr != H:
        # the mesh is the caller's input: checked under -O too, with the
        # reference's exception
        raise AssertionError("row sharding requires CTU-row-aligned equal "
                             "bands")
    out = {}
    for s in sizes:
        src, fill = refs.subst_gather(W, H, s, 0, log2_ctu)
        nb = (band_h // s) * (W // s)
        loc = [src[b * nb:(b + 1) * nb] - (b * band_h - 1) * W
               for b in range(nr)]
        # interior bands share one pattern; band 0 differs (picture top)
        for b in range(2, nr):
            assert (loc[b] == loc[1]).all(), "interior bands must match"
        fl = [fill[b * nb:(b + 1) * nb] for b in range(nr)]
        for b in range(2, nr):
            assert (fl[b] == fl[1]).all()
        # a filled block (nothing available: band 0's first) reads a
        # substitution source outside the band; XLA's gather clamps it
        # and the fill flag masks the value, so clamp it here as well
        loc = [np.clip(x, 0, (band_h + 1) * W - 1) for x in loc]
        out[s] = ((loc[0], fl[0]), (loc[-1], fl[-1]))
    return out


@functools.lru_cache(maxsize=None)
@trace.table
def _band_consts(W, H, log2_ctu, sizes, nr, interior, device):
    """_band_tables' tables of band 0 (interior False) or of the interior
    bands on the device, with the [1 2 1] filter's indices (cached per
    process, geometry, band kind and device)."""
    consts = {}
    for s, tabs in _band_tables(W, H, log2_ctu, sizes, nr).items():
        src, fill = tabs[int(interior)]
        pi, ni, keep = refs.filter121_indices(s)
        consts[s] = tuple(torch.as_tensor(x, device=device) for x in (
            src.astype(np.int64), fill, pi.astype(np.int64),
            ni.astype(np.int64), keep))
    return consts


def fused_luma_band_stage_a(planes, halo, W, H, log2_ctu, sizes, nr, band,
                            K, trellis, ls, bd, lam_dq, lv, lam, mats):
    """The luma stage A of one CTU-row band (band `band` of `nr` equal
    bands), the cell function of the JAX `_fused_luma_sharded_builder`:
    the same cost model as fused_luma_stage_a, bit-identical by
    construction. planes: (F, H / nr, W) uint8, the band's rows; halo:
    (F, W) uint8, the last row of the band above (band 0: zeros, which
    its fill flags mask), on the same device. Returns {s: (cands int8
    (F, nb, K+2), base cost f32 (F, nb, K+2))} for the band's nb blocks
    in raster order, still on the device; the host selects the
    winners."""
    F, band_h = planes.shape[0], planes.shape[1]
    consts = _band_consts(W, H, log2_ctu, sizes, nr, band > 0,
                          planes.device)
    x = torch.cat([halo[:, None, :], planes], dim=1).to(torch.int32)
    flat = x.reshape(F, (band_h + 1) * W)
    out = {}
    for s in sizes:
        nb = consts[s][0].shape[0]
        cands, cost = _luma_cands(flat, x[:, 1:], band_h, W, s, consts[s],
                                  K, trellis, ls, bd, lam_dq, lv, lam, mats)
        out[s] = (cands.reshape(F, nb, -1), cost.reshape(F, nb, -1))
    return out


def _luma_cands(flat, plane, h, w, s, consts, K, trellis, ls, bd, lam_dq,
                lv, lam, mats):
    """One QT size of the luma stage A: every s-block's reference vector
    (gathered from `flat` through consts' src / fill / [1 2 1] indices),
    the 67-mode sweep, and the RD of the top candidates against the
    block's pixels (the s-grid of `plane`, (F, h, w) or (F, h*w)).
    Returns (cands int8 (B, K+2), base cost f32 (B, K+2))."""
    src, fill, pi, ni, keep = consts[:5]
    v = _ref_vectors(flat, src, fill, pi, ni, keep)
    pred = intra_pred.predict_all_modes_m(v, mats[s], s)
    blocks = _tiles(plane, h, w, s).reshape(-1, s * s)
    return _stage_a_select(pred, blocks, K, ls[s], bd[s], lam_dq, lv,
                           s.bit_length() - 1, lam, trellis)


def _stage_a_select(pred, orig, num_cands, ls, bd_shift, lam_dq, lv, log2,
                    lam, trellis=False):
    """pred (N,67,WH), orig (N,WH) -> (cands (N,K+2) int8, cost (N,K+2)).

    Cost is ssd + lam*rate WITHOUT mode bits. The top-K angular modes by
    SAD keep the lower mode on equal SAD (jax.lax.top_k's rule), via a
    stable ascending sort."""
    sad = (pred - orig[:, None, :]).abs().sum(-1, dtype=torch.int32)
    top = torch.sort(sad[:, 2:], dim=1, stable=True).indices[:, :num_cands]
    N = sad.shape[0]
    cands = torch.cat([torch.zeros((N, 1), dtype=top.dtype,
                                   device=top.device),
                       torch.ones((N, 1), dtype=top.dtype, device=top.device),
                       top + 2], dim=1)                        # (N, K+2)
    K = num_cands + 2
    s = 1 << log2
    p = pred.gather(1, cands[:, :, None].expand(-1, -1, s * s))
    o = orig[:, None, :].expand(-1, K, -1)
    ssd, rate = _rd_eval_inner(p.reshape(-1, s, s), o.reshape(-1, s, s),
                               ls, bd_shift, lam_dq, lv, log2, trellis)
    return cands.to(torch.int8), _rd_cost(ssd, rate, lam).reshape(-1, K)


def _rd_eval_inner(pred, orig, ls, bd_shift, lam_dq, lv, log2,
                   trellis=False):
    """pred/orig (B,s,s) -> (ssd (B,) f32, rate (B,) f32). trellis=True
    quantizes with the exact Viterbi (pass trellis-variant tables)."""
    orig = orig.to(torch.int32)
    pred = pred.to(torch.int32)
    t = transforms.forward_impl(orig - pred)
    if trellis:
        q, rate = ktr.trellis_rate(t, ls, bd_shift, lam_dq, lv, log2)
    else:
        q, rate = kq.greedy_depquant(t, ls, bd_shift, lam_dq, log2, lv)
    d = kq.dequantize(q, ls, bd_shift)
    rec = torch.clamp(pred + transforms.inverse_impl(d), 0, 255)
    e = rec - orig
    ssd = (e * e).sum((1, 2), dtype=torch.int32)
    return ssd.to(torch.float32), rate
