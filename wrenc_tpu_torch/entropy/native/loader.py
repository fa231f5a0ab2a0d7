"""ctypes loader/wrapper for the native runtime (wrenc_native.cpp).

Builds the shared library on first use with g++ into the package's
`_build/` directory (plain C ABI + ctypes; no binary is shipped). The
port's main path needs the native committer, chroma stage A and slice
coder, so a failed build or load RAISES — there is no slower fallback
that would silently change behaviour.
"""
import ctypes
import fcntl
import os
import subprocess
import threading
from typing import NamedTuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "wrenc_native.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")
_SO = os.path.join(_BUILD, "libwrenc_native.so")
_lock = threading.Lock()
_lib = None


def _stale(src, so):
    return (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src))


def build_library(src, so):
    """Compile `src` into the shared library `so` unless `so` is newer.

    Compiles to a private temporary name and renames into place, under a
    file lock beside `so`: concurrent test workers and the commit thread
    never see a half-written library. Raises when g++ fails."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    with open(so + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not _stale(src, so):
            return
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread", src, "-o", tmp],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ build of {os.path.basename(src)} "
                               "failed:\n" + proc.stderr[-4000:])
        os.replace(tmp, so)


def _get():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build_library(_SRC, _SO)
        lib = ctypes.CDLL(_SO)
        lib.wrenc_trellis_quant.restype = None
        lib.wrenc_greedy_quant.restype = None
        lib.wrenc_encode_slice.restype = ctypes.c_int64
        lib.wrenc_commit_frames.restype = None
        lib.wrenc_commit_frames_tree.restype = None
        lib.wrenc_chroma_stage_a.restype = None
        lib.wrenc_cu_ranks2.restype = None
        _lib = lib
        return _lib


def available():
    """Builds and loads the library; raises when either fails."""
    return _get() is not None


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def trellis_quant_native(t, ls, bd_shift, lam_dq, log2_n):
    """t: (B, n, n) int32 -> q (B, n, n) int16 (exact trellis)."""
    lib = _get()
    t = np.ascontiguousarray(t, dtype=np.int32)
    lam = np.ascontiguousarray(lam_dq, dtype=np.int32)
    q = np.zeros(t.shape, dtype=np.int16)
    lib.wrenc_trellis_quant(
        _i32p(t), ctypes.c_int(t.shape[0]), ctypes.c_int(log2_n),
        ctypes.c_int32(ls), ctypes.c_int32(bd_shift), _i32p(lam),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    return q


def greedy_quant_native(t, ls, bd_shift, lam_dq, log2_n):
    lib = _get()
    t = np.ascontiguousarray(t, dtype=np.int32)
    lam = np.ascontiguousarray(lam_dq, dtype=np.int32)
    q = np.zeros(t.shape, dtype=np.int16)
    lib.wrenc_greedy_quant(
        _i32p(t), ctypes.c_int(t.shape[0]), ctypes.c_int(log2_n),
        ctypes.c_int32(ls), ctypes.c_int32(bd_shift), _i32p(lam),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    return q


_TREE_ID = {'S': 0, 'L': 1, 'C': 2}


def serialize_decisions(trees):
    """Flatten CtNode trees into (nodes, cu_data, coeff_offs, coeffs)."""
    nodes = []
    cu_data = []
    coeff_offs = []
    coeff_chunks = []
    total = 0

    def walk(n):
        nonlocal total
        if n.split:
            nodes.append(-1)
            for ch in n.children:
                walk(ch)
        else:
            cu = n.cu
            nodes.append(len(cu_data) // 6)
            cu_data.extend([cu.x, cu.y, cu.log2, _TREE_ID[cu.tree],
                            cu.luma_mode, cu.chroma_mode])
            for c in range(3):
                q = cu.coeffs[c]
                if q is None:
                    coeff_offs.append(-1)
                else:
                    q = np.ascontiguousarray(q, dtype=np.int16)
                    coeff_offs.append(total)
                    coeff_chunks.append(q.ravel())
                    total += q.size

    for t in trees:
        walk(t)
    coeffs = (np.concatenate(coeff_chunks) if coeff_chunks
              else np.zeros(1, dtype=np.int16))
    return (np.array(nodes, dtype=np.int32),
            np.array(cu_data, dtype=np.int32),
            np.array(coeff_offs, dtype=np.int64),
            coeffs)


def _ctx_arrays():
    from ...core import tables
    offsets, inits, shifts = tables.cabac_ctx_layout()
    n_se = 110
    se_off = np.full(n_se, -1, dtype=np.int32)
    for se_id, off in offsets.items():
        se_off[se_id] = off
    return se_off, inits[0].astype(np.int32), shifts[0].astype(np.int32)


def _encode_slice(cfg, trees, slice_qp, wpp):
    lib = _get()
    nodes, cu_data, coeff_offs, coeffs = serialize_decisions(trees)
    se_off, inits, shifts = _ctx_arrays()
    cap = max(1 << 16, coeffs.size * 8 + 4096)
    out = np.zeros(cap, dtype=np.uint8)
    n_rows = cfg.height >> cfg.log2_ctu_size
    marks = np.zeros(max(n_rows, 1), dtype=np.int64)
    n = lib.wrenc_encode_slice(
        ctypes.c_int(cfg.width), ctypes.c_int(cfg.height),
        ctypes.c_int(cfg.log2_ctu_size), ctypes.c_int(slice_qp),
        ctypes.c_int(1 if cfg.dep_quant_enabled else 0),
        ctypes.c_int(1 if cfg.transform_skip_enabled else 0),
        ctypes.c_int(1 if cfg.cclm_enabled else 0),
        ctypes.c_int(1 if getattr(cfg, 'explicit_mts_intra_enabled', False)
                     else 0),
        _i32p(se_off), ctypes.c_int(len(se_off)),
        _i32p(inits), _i32p(shifts), ctypes.c_int(len(inits)),
        _i32p(nodes), ctypes.c_int64(len(nodes)),
        _i32p(cu_data), ctypes.c_int64(len(cu_data) // 6),
        coeff_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(cap),
        ctypes.c_int(1 if wpp else 0),
        marks.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    assert n > 0, "native slice buffer overflow"
    return bytes(out[:n]), marks


def encode_slice_native(cfg, trees, slice_qp):
    """Entropy-code one slice's CTU decision trees -> CABAC payload bytes."""
    return _encode_slice(cfg, trees, slice_qp, wpp=False)[0]


def wpp_supported():
    return available()


def encode_slice_wpp_native(cfg, trees, slice_qp):
    """WPP slice: returns (entry_lens, payload bytes)."""
    data, marks = _encode_slice(cfg, trees, slice_qp, wpp=True)
    n_rows = cfg.height >> cfg.log2_ctu_size
    lens = [int(marks[r] - (marks[r - 1] if r else 0))
            for r in range(n_rows - 1)]
    return lens, data


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def commit_frames_native(cfg, origs, cu_lists, ls_tab, bd_tab, lam_dq,
                         trellis, n_threads=0):
    """Native commit: reconstruct all frames' CU decisions in coding order.

    origs: list of (Y, Cb, Cr) int planes per frame. cu_lists: per-frame
    CuDecision lists in coding order. Fills cu.coeffs in place and returns
    the recon planes per frame.
    """
    import os
    from ...core import tables
    lib = _get()
    F = len(origs)
    W, H = cfg.width, cfg.height
    oy = np.ascontiguousarray(
        np.stack([o[0] for o in origs]), dtype=np.int32)
    ocb = np.ascontiguousarray(
        np.stack([o[1] for o in origs]), dtype=np.int32)
    ocr = np.ascontiguousarray(
        np.stack([o[2] for o in origs]), dtype=np.int32)
    ry = np.zeros_like(oy)
    rcb = np.zeros_like(ocb)
    rcr = np.zeros_like(ocr)

    meta = []
    frame_off = [0]
    coeff_off = []
    total = 0
    for cus in cu_lists:
        for cu in cus:
            meta.extend([cu.x, cu.y, cu.log2, _TREE_ID[cu.tree],
                         cu.luma_mode, cu.chroma_mode])
            for c in range(3):
                has = (c == 0 and cu.tree != 'C') or (c > 0 and cu.tree != 'L')
                if has:
                    sz = (1 << (cu.log2 - (0 if c == 0 else 1))) ** 2
                    coeff_off.append(total)
                    total += sz
                else:
                    coeff_off.append(-1)
        frame_off.append(frame_off[-1] + len(cus))
    meta = np.array(meta, dtype=np.int32)
    frame_off = np.array(frame_off, dtype=np.int64)
    coeff_off = np.array(coeff_off, dtype=np.int64)
    coeffs = np.zeros(max(total, 1), dtype=np.int16)

    def c32(a):
        return np.ascontiguousarray(a, dtype=np.int32)

    dcts = [c32(tables.dct2_matrix(n)) for n in (4, 8, 16, 32)]
    angle = c32(tables.INTRA_ANGLE_TABLE)
    fcm = c32(tables.F_C)
    fgm = c32(tables.F_G)
    pdpcw = c32(tables.PDPC_WEIGHTS)
    cclmd = c32(tables.CCLM_DIV_SIG_TABLE)
    ls_tab = c32(ls_tab)
    bd_tab = c32(bd_tab)
    lam = c32(lam_dq)
    if n_threads <= 0:
        n_threads = min(F, os.cpu_count() or 1)

    lib.wrenc_commit_frames(
        ctypes.c_int(W), ctypes.c_int(H), ctypes.c_int(cfg.log2_ctu_size),
        ctypes.c_int(F), ctypes.c_int(n_threads),
        _i32p(oy), _i32p(ocb), _i32p(ocr),
        _i32p(ry), _i32p(rcb), _i32p(rcr),
        _i32p(meta), _i64p(frame_off), _i64p(coeff_off),
        coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        _i32p(ls_tab), _i32p(bd_tab), _i32p(lam),
        ctypes.c_int(1 if cfg.dep_quant_enabled else 0),
        ctypes.c_int(1 if trellis else 0),
        _i32p(dcts[0]), _i32p(dcts[1]), _i32p(dcts[2]), _i32p(dcts[3]),
        _i32p(angle), _i32p(fcm), _i32p(fgm), _i32p(pdpcw), _i32p(cclmd))

    k = 0
    for cus in cu_lists:
        for cu in cus:
            for c in range(3):
                off = coeff_off[k]
                k += 1
                if off < 0:
                    continue
                s = 1 << (cu.log2 - (0 if c == 0 else 1))
                cu.coeffs[c] = coeffs[off:off + s * s] \
                    .reshape(s, s).copy()
    return [(ry[f], rcb[f], rcr[f]) for f in range(F)]


def _rd_consts(cfg, with_headers=False):
    rm, dep = cfg.rate_model, cfg.dep_quant_enabled
    vals = [
        2.0 ** (cfg.qp / rm.pick('qp_div', dep, True))
        * rm.pick('lambda_mul', dep, True),
        rm.pick('planar_offset', dep, True),
        rm.pick('non_planar_offset', dep, True),
        rm.pick('mpm_idx_offset', dep, True), rm.mpm_idx_pow,
        rm.pick('mpm_remainder_mult', dep, True),
        rm.pick('mpm_remainder_offset', dep, True), rm.mpm_remainder_pow,
        rm.pick('cclm_offset', dep, True),
        rm.pick('cclm_mode_idx_offset', dep, True), rm.cclm_pow,
        rm.pick('non_cclm_offset', dep, True),
    ]
    if with_headers:
        vals += [rm.pick('header_bits', dep, True),
                 rm.pick('chroma_header_bits', dep, True),
                 float(getattr(rm, 'commit_chroma_redecide', 1.0)),
                 float(getattr(rm, 'commit_rank_full', 1.0)),
                 float(getattr(rm, 'commit_rank_trellis', 1.0))]
    return np.array(vals, dtype=np.float64)


CPU_MAX = "/sys/fs/cgroup/cpu.max"


def usable_cores(cpu_max=CPU_MAX):
    """The cores this process may use: its CPU affinity, capped by the
    cgroup (v2) CPU quota in `cpu_max` where one is set, rounded up."""
    n = len(os.sched_getaffinity(0))
    try:
        with open(cpu_max) as f:
            quota, period = f.read().split()[:2]
        if quota == "max":
            return n
        return max(1, min(n, -(-int(quota) // int(period))))
    except (OSError, ValueError):
        return n


class CommitStreams(NamedTuple):
    """The tree commit's input streams (serialize_commit_trees)."""
    nodes: np.ndarray         # pre-order: CU index; -1 split; -2 refine
    ctu_node_off: np.ndarray  # (F * CTUs + 1,) each CTU's start in nodes
    ctu_dec_off: np.ndarray   # (F * CTUs + 1,) ... in the refine decisions
    meta: np.ndarray          # (CUs, 6) x, y, log2, tree, luma, chroma mode
    cands: np.ndarray         # (CUs, n) candidate luma modes, -1 padded
    coeff_off: np.ndarray     # (CUs * 3,) into the coefficients, -1 absent
    n_coeffs: int
    cu_objs: list             # the CU objects, in the order of meta


class CommitResult(NamedTuple):
    """What the native tree commit writes (commit_tree_streams)."""
    recons: list              # per frame (Y, Cb, Cr) int32 planes
    coeffs: np.ndarray        # int16, at CommitStreams.coeff_off
    modes: np.ndarray         # (CUs * 2,) luma, chroma mode per CU
    decisions: np.ndarray     # int8 per refine node: 0 leaf, 1 split kept
    threads: int              # threads the wavefront used
    busy_s: float             # their summed busy seconds
    lag_wait_s: float         # their summed seconds blocked on the row above


def serialize_commit_trees(all_trees, n_ctus):
    """Flatten per-frame CtNode tree lists (one root per CTU, raster
    order) into the tree commit's CommitStreams, recording where each
    CTU's nodes and refine decisions start."""
    nodes = []
    ctu_node_off = [0]
    ctu_dec_off = [0]
    cu_objs = []
    meta = []
    cand_rows = []
    ndec = 0

    def add_cu(cu):
        idx = len(cu_objs)
        cu_objs.append(cu)
        meta.extend([cu.x, cu.y, cu.log2, _TREE_ID[cu.tree],
                     cu.luma_mode, cu.chroma_mode])
        cl = getattr(cu, 'cands', None)
        cand_rows.append(cl if cl is not None and len(cl)
                         else (cu.luma_mode,))
        return idx

    def walk(n):
        nonlocal ndec
        if getattr(n, 'refine', False):
            nodes.append(-2)
            nodes.append(add_cu(n.alt_cu))
            ndec += 1
            for ch in n.children:
                walk(ch)
        elif n.split:
            nodes.append(-1)
            for ch in n.children:
                walk(ch)
        else:
            nodes.append(add_cu(n.cu))

    for trees in all_trees:
        if len(trees) != n_ctus:
            raise ValueError(f"{len(trees)} CTU trees in a frame of "
                             f"{n_ctus} CTUs")
        for t in trees:
            walk(t)
            ctu_node_off.append(len(nodes))
            ctu_dec_off.append(ndec)

    lens = np.fromiter((len(r) for r in cand_rows), dtype=np.int64,
                       count=len(cand_rows))
    n_cand = int(lens.max()) if len(lens) else 1
    if (lens == n_cand).all():
        cands = np.ascontiguousarray(np.stack(cand_rows), dtype=np.int32) \
            if len(cand_rows) else np.zeros((0, 1), np.int32)
    else:
        cands = np.full((len(cand_rows), n_cand), -1, dtype=np.int32)
        for i, r in enumerate(cand_rows):
            cands[i, :len(r)] = r

    # per-CU coefficient buffer offsets (vectorised)
    meta = np.array(meta, dtype=np.int32).reshape(-1, 6)
    tree_id = meta[:, 3]
    log2s = meta[:, 2].astype(np.int64)
    sizes3 = np.stack([
        np.where(tree_id != 2, (1 << log2s) ** 2, 0),       # luma
        np.where(tree_id != 1, (1 << (log2s - 1)) ** 2, 0),  # cb
        np.where(tree_id != 1, (1 << (log2s - 1)) ** 2, 0),  # cr
    ], axis=1).reshape(-1)
    ends = np.cumsum(sizes3)
    coeff_off = np.where(sizes3 > 0, ends - sizes3, -1).astype(np.int64)
    return CommitStreams(
        np.array(nodes, dtype=np.int32),
        np.array(ctu_node_off, dtype=np.int64),
        np.array(ctu_dec_off, dtype=np.int64),
        meta, cands, coeff_off, int(ends[-1]) if len(ends) else 0, cu_objs)


def commit_tree_streams(cfg, origs, streams, ls_tab, bd_tab, lam_dq,
                        trellis, lv_trellis, n_threads=0):
    """Run the native tree commit (wrenc_commit_frames_tree) on
    CommitStreams; reads its inputs only. The frames' CTU rows run as a
    wavefront over `n_threads` threads (0: `usable_cores()`), at most one
    per row; the output does not depend on the count. Returns a
    CommitResult."""
    from ...core import tables
    lib = _get()
    F = len(origs)
    W, H = cfg.width, cfg.height
    oy = np.ascontiguousarray(np.stack([o[0] for o in origs]), dtype=np.int32)
    ocb = np.ascontiguousarray(np.stack([o[1] for o in origs]), dtype=np.int32)
    ocr = np.ascontiguousarray(np.stack([o[2] for o in origs]), dtype=np.int32)
    ry = np.zeros_like(oy)
    rcb = np.zeros_like(ocb)
    rcr = np.zeros_like(ocr)
    n_cus = len(streams.meta)
    coeffs = np.zeros(max(streams.n_coeffs, 1), dtype=np.int16)
    modes_out = np.zeros(max(n_cus, 1) * 2, dtype=np.int32)
    decisions = np.zeros(max(int(streams.ctu_dec_off[-1]), 1), dtype=np.int8)
    rd_consts = _rd_consts(cfg, with_headers=True)
    lv = np.ascontiguousarray(lv_trellis, dtype=np.int64)
    stats = np.zeros(4, dtype=np.float64)

    def c32(a):
        return np.ascontiguousarray(a, dtype=np.int32)

    dcts = [c32(tables.dct2_matrix(n)) for n in (4, 8, 16, 32)]
    ls_tab = c32(ls_tab)
    bd_tab = c32(bd_tab)
    lam = c32(lam_dq)
    if n_threads <= 0:
        n_threads = usable_cores()

    lib.wrenc_commit_frames_tree(
        ctypes.c_int(W), ctypes.c_int(H), ctypes.c_int(cfg.log2_ctu_size),
        ctypes.c_int(F), ctypes.c_int(n_threads),
        _i32p(oy), _i32p(ocb), _i32p(ocr),
        _i32p(ry), _i32p(rcb), _i32p(rcr),
        _i32p(streams.nodes), _i64p(streams.ctu_node_off),
        _i32p(streams.meta), _i64p(streams.coeff_off),
        coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        _i32p(ls_tab), _i32p(bd_tab), _i32p(lam),
        ctypes.c_int(1 if cfg.dep_quant_enabled else 0),
        ctypes.c_int(1 if trellis else 0),
        ctypes.c_int(1 if cfg.cclm_enabled else 0),
        _i32p(streams.cands), ctypes.c_int(streams.cands.shape[1]),
        rd_consts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _i64p(lv),
        _i32p(modes_out),
        decisions.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        _i64p(streams.ctu_dec_off),
        _i32p(dcts[0]), _i32p(dcts[1]), _i32p(dcts[2]), _i32p(dcts[3]),
        _i32p(c32(tables.INTRA_ANGLE_TABLE)), _i32p(c32(tables.F_C)),
        _i32p(c32(tables.F_G)), _i32p(c32(tables.PDPC_WEIGHTS)),
        _i32p(c32(tables.CCLM_DIV_SIG_TABLE)),
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if stats[3]:
        raise RuntimeError(f"{int(stats[3])} CTU walks did not end at the "
                           "next CTU's stream offset")
    return CommitResult([(ry[f], rcb[f], rcr[f]) for f in range(F)],
                        coeffs, modes_out, decisions, int(stats[0]),
                        float(stats[1]), float(stats[2]))


def commit_frames_tree_native(cfg, origs, all_trees, ls_tab, bd_tab, lam_dq,
                              trellis, lv_trellis, n_threads=0):
    """Native commit with mode re-decision AND QT split refinement.

    all_trees: per-frame CtNode tree lists. Nodes with `refine=True` carry
    an `alt_cu` merged-leaf alternative; the committer evaluates both the
    leaf and the split subtree on the true reconstruction and keeps the
    cheaper (the reference's snapshot/rollback discipline,
    block_splitter.rs:1079-1152). Trees are updated in place to the chosen
    structure; cu modes/coeffs are filled in. Returns recon planes.

    The CTU-row wavefront's threads, their summed busy and lag-wait
    seconds go onto the caller's open trace span as commit_threads,
    commit_busy_s and commit_lag_wait_s.
    """
    from ... import trace
    n_ctus = ((cfg.width >> cfg.log2_ctu_size)
              * (cfg.height >> cfg.log2_ctu_size))
    streams = serialize_commit_trees(all_trees, n_ctus)
    res = commit_tree_streams(cfg, origs, streams, ls_tab, bd_tab, lam_dq,
                              trellis, lv_trellis, n_threads)
    trace.annotate(commit_threads=res.threads, commit_busy_s=res.busy_s,
                   commit_lag_wait_s=res.lag_wait_s)

    # modes + coeffs back into every CU object (winners referenced by trees)
    coeff_off = streams.coeff_off
    for i, cu in enumerate(streams.cu_objs):
        if cu.tree != 'C':
            cu.luma_mode = int(res.modes[i * 2])
        if cu.tree != 'L':
            cu.chroma_mode = int(res.modes[i * 2 + 1])
        for c in range(3):
            off = coeff_off[i * 3 + c]
            if off < 0:
                continue
            s = 1 << (cu.log2 - (0 if c == 0 else 1))
            cu.coeffs[c] = res.coeffs[off:off + s * s].reshape(s, s).copy()

    # apply refine decisions (same pre-order walk)
    it = iter(res.decisions)

    def apply(n):
        if getattr(n, 'refine', False):
            d = int(next(it))
            for ch in n.children:
                apply(ch)
            if d == 0:
                n.split = False
                n.cu = n.alt_cu
                n.children = []
            n.refine = False
            n.alt_cu = None
        elif n.split:
            for ch in n.children:
                apply(ch)
    for trees in all_trees:
        for t in trees:
            apply(t)
    return res.recons


def chroma_stage_a_native(cfg, origs, dmodes, scipu_modes, ls_c, bd_c,
                          lam_dq, lv, n_threads=0):
    """Chroma stage-A candidate RD on host (wrenc_chroma_stage_a).

    origs: per-frame (Y, Cb, Cr) int planes. dmodes: {cs: (F, N) int32
    derived modes or None} for cs in (4, 8, 16). scipu_modes: (F, N4) or
    None. Returns {('d', cs): (ssd, rate), ('sc',): ..., ('cc', cs): ...}
    with ssd (F[,3],N,2) int64 and rate float32 of the same shape.
    """
    import os
    lib = _get()
    F = len(origs)
    W, H = cfg.width, cfg.height

    def planes(idx):
        return np.ascontiguousarray(np.stack([o[idx] for o in origs]),
                                    dtype=np.int32)

    oy, ocb, ocr = planes(0), planes(1), planes(2)
    NULL32 = ctypes.POINTER(ctypes.c_int32)()

    def n_of(cs):
        return ((W // 2) // cs) * ((H // 2) // cs)

    out = {}
    dm_ptrs, d_out = [], []
    cc_out = []
    for cs in (4, 8, 16):
        N = n_of(cs)
        m = dmodes.get(cs)
        if m is not None:
            m = np.ascontiguousarray(m, dtype=np.int32)
            dm_ptrs.append((m, _i32p(m)))
            ssd = np.zeros((F, N, 2), dtype=np.int64)
            rate = np.zeros((F, N, 2), dtype=np.float32)
            out[('d', cs)] = (ssd, rate)
            d_out.append((ssd, rate))
        else:
            dm_ptrs.append((None, NULL32))
            d_out.append((np.zeros(1, np.int64), np.zeros(1, np.float32)))
        if cfg.cclm_enabled and (m is not None or
                                 (cs == 4 and scipu_modes is not None)):
            ssd = np.zeros((F, 3, N, 2), dtype=np.int64)
            rate = np.zeros((F, 3, N, 2), dtype=np.float32)
            out[('cc', cs)] = (ssd, rate)
            cc_out.append((ssd, rate))
        else:
            cc_out.append((np.zeros(1, np.int64), np.zeros(1, np.float32)))

    if scipu_modes is not None:
        scipu_modes = np.ascontiguousarray(scipu_modes, dtype=np.int32)
        sc_ptr = _i32p(scipu_modes)
        N4 = n_of(4)
        sc_ssd = np.zeros((F, N4, 2), dtype=np.int64)
        sc_rate = np.zeros((F, N4, 2), dtype=np.float32)
        out[('sc',)] = (sc_ssd, sc_rate)
    else:
        sc_ptr = NULL32
        sc_ssd = np.zeros(1, np.int64)
        sc_rate = np.zeros(1, np.float32)

    ls_c = np.ascontiguousarray(ls_c, dtype=np.int32)
    bd_c = np.ascontiguousarray(bd_c, dtype=np.int32)
    lam = np.ascontiguousarray(lam_dq, dtype=np.int32)
    lvf = np.ascontiguousarray(lv, dtype=np.float32)
    from ...core import tables

    def c32(a):
        return np.ascontiguousarray(a, dtype=np.int32)

    dcts = [c32(tables.dct2_matrix(n)) for n in (4, 8, 16, 32)]
    angle = c32(tables.INTRA_ANGLE_TABLE)
    fcm = c32(tables.F_C)
    fgm = c32(tables.F_G)
    pdpcw = c32(tables.PDPC_WEIGHTS)
    cclmd = c32(tables.CCLM_DIV_SIG_TABLE)
    if n_threads <= 0:
        n_threads = min(F, os.cpu_count() or 1)

    def i64p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    def f32p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    lib.wrenc_chroma_stage_a(
        ctypes.c_int(W), ctypes.c_int(H), ctypes.c_int(cfg.log2_ctu_size),
        ctypes.c_int(F), ctypes.c_int(n_threads),
        _i32p(oy), _i32p(ocb), _i32p(ocr),
        dm_ptrs[0][1], dm_ptrs[1][1], dm_ptrs[2][1],
        sc_ptr, ctypes.c_int(1 if cfg.cclm_enabled else 0),
        _i32p(ls_c), _i32p(bd_c), _i32p(lam), f32p(lvf),
        i64p(d_out[0][0]), f32p(d_out[0][1]),
        i64p(d_out[1][0]), f32p(d_out[1][1]),
        i64p(d_out[2][0]), f32p(d_out[2][1]),
        i64p(sc_ssd), f32p(sc_rate),
        i64p(cc_out[0][0]), f32p(cc_out[0][1]),
        i64p(cc_out[1][0]), f32p(cc_out[1][1]),
        i64p(cc_out[2][0]), f32p(cc_out[2][1]),
        _i32p(dcts[0]), _i32p(dcts[1]), _i32p(dcts[2]), _i32p(dcts[3]),
        _i32p(angle), _i32p(fcm), _i32p(fgm), _i32p(pdpcw), _i32p(cclmd))
    return out


def decode_supported():
    return available()


def decode_slice_native(p, payload, entry_lens=None):
    """Decode one slice payload (post-SH de-emulated RBSP bytes) natively.

    p: ParsedParams (geometry/flags/slice_qp). Returns (Y, Cb, Cr) int32
    planes, or None on parse error (caller falls back to Python)."""
    from ...core import tables
    from ...spec import quant
    lib = _get()
    lib.wrenc_decode_slice.restype = ctypes.c_int
    W, H = p.width, p.height
    se_off, inits, shifts = _ctx_arrays()
    ls_tab = np.zeros((2, 4), dtype=np.int32)
    bd_tab = np.zeros((2, 4), dtype=np.int32)
    for c in (0, 1):
        qp = p.slice_qp if c == 0 else quant.chroma_qp_from_luma(p.slice_qp)
        for log2 in (2, 3, 4, 5):
            qpar = quant.derive_quant_params(
                qp, log2, log2, dep_quant=p.dep_quant_used,
                transform_skip=False, bit_depth=p.bit_depth)
            ls_tab[c, log2 - 2] = qpar.ls
            bd_tab[c, log2 - 2] = qpar.bd_shift
    # per-QP tables [64][2][4] for nonzero cu_qp_delta (spec 8.7.1);
    # chroma rows at the mapped chroma QP of each luma QP
    ls_qp = np.zeros((64, 2, 4), dtype=np.int32)
    bd_qp = np.zeros((64, 2, 4), dtype=np.int32)
    for qy in range(64):
        for c in (0, 1):
            qp = qy if c == 0 else quant.chroma_qp_from_luma(qy)
            for log2 in (2, 3, 4, 5):
                qpar = quant.derive_quant_params(
                    qp, log2, log2, dep_quant=p.dep_quant_used,
                    transform_skip=False, bit_depth=p.bit_depth)
                ls_qp[qy, c, log2 - 2] = qpar.ls
                bd_qp[qy, c, log2 - 2] = qpar.bd_shift

    def c32(a):
        return np.ascontiguousarray(a, dtype=np.int32)

    dcts = [c32(tables.dct2_matrix(n)) for n in (4, 8, 16, 32)]
    ry = np.zeros((H, W), dtype=np.int32)
    rcb = np.zeros((H // 2, W // 2), dtype=np.int32)
    rcr = np.zeros((H // 2, W // 2), dtype=np.int32)
    data = np.frombuffer(bytes(payload), dtype=np.uint8)
    lens = np.asarray(entry_lens or [], dtype=np.int64)
    wpp = 1 if (getattr(p, 'entropy_coding_sync_enabled', False)
                and len(lens)) else 0
    rc = lib.wrenc_decode_slice(
        ctypes.c_int(W), ctypes.c_int(H), ctypes.c_int(p.log2_ctu_size),
        ctypes.c_int(p.slice_qp),
        ctypes.c_int(1 if p.dep_quant_used else 0),
        ctypes.c_int(1 if p.transform_skip_enabled else 0),
        ctypes.c_int(1 if getattr(p, 'cclm_enabled', True) else 0),
        ctypes.c_int(1 if getattr(p, 'explicit_mts_intra_enabled', False)
                     else 0),
        _i32p(se_off), ctypes.c_int(len(se_off)),
        _i32p(inits), _i32p(shifts), ctypes.c_int(len(inits)),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(len(data)),
        ctypes.c_int(wpp),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int(len(lens)),
        _i32p(ls_tab), _i32p(bd_tab),
        _i32p(dcts[0]), _i32p(dcts[1]), _i32p(dcts[2]), _i32p(dcts[3]),
        _i32p(c32(tables.INTRA_ANGLE_TABLE)), _i32p(c32(tables.F_C)),
        _i32p(c32(tables.F_G)), _i32p(c32(tables.PDPC_WEIGHTS)),
        _i32p(c32(tables.CCLM_DIV_SIG_TABLE)),
        _i32p(ls_qp), _i32p(bd_qp),
        _i32p(ry), _i32p(rcb), _i32p(rcr))
    if rc != 0:
        return None
    return ry, rcb, rcr


def cu_ranks_native(cu_meta, W, H):
    """Commit-schedule dependency ranks (wrenc_cu_ranks2).

    cu_meta: (N, 6) int32 [x, y, log2, is_phantom, ext_l, ext_t] in
    coding order — ext flags mark AVAILABLE below-left / above-right
    reference extensions (unavailable ones are never read, so they do
    not constrain the schedule). Returns (N,) int32 ranks (1-based)."""
    lib = _get()
    m = np.ascontiguousarray(cu_meta, dtype=np.int32)
    out = np.zeros(len(m), dtype=np.int32)
    lib.wrenc_cu_ranks2(_i32p(m), ctypes.c_int64(len(m)),
                        ctypes.c_int(W), ctypes.c_int(H), _i32p(out))
    return out
