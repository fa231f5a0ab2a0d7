"""The port's remaining single-device search paths against the JAX
package's, on the CPU.

Per-QG QP (qp_delta_pattern, the NumPy rank-wavefront commit), the
non-RD and greedy commits, the device engine's fallback under them, the
apply-decisions prototype `commit_frame_device`, the patch-based CCLM
prediction and host-side luma selection (`_select_modes`, which a row
mesh runs): the same seeded inputs through both packages, every
comparison exact. The decide as a stage of values: the search keeps no
chunk state, so chunks decide in any order and every multi-chunk call
overlaps its commit. On the
CPU the prototype's residual step runs K2's plain twin; chip_smoke.py
holds K2 against the twin on the card at the prototype's shapes.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wrenc_tpu.core.config import EncoderConfig
from wrenc_tpu.encoder import Encoder as JaxEncoder
from wrenc_tpu.kernels import intra_pred as jip
from wrenc_tpu.kernels import np_ops as jnp_ops
from wrenc_tpu.search import WavefrontSearch as JaxSearch
from wrenc_tpu.search import device_commit as jdc

from wrenc_tpu_torch.conformance import decode_annexb_independent
from wrenc_tpu_torch.core import config as tconfig
from wrenc_tpu_torch.decoder import decode_annexb
from wrenc_tpu_torch.encoder import Encoder
from wrenc_tpu_torch.kernels import intra_pred as tip
from wrenc_tpu_torch.kernels import np_ops, refs
from wrenc_tpu_torch.kernels import quantize as kq
from wrenc_tpu_torch.search import WavefrontSearch
from wrenc_tpu_torch.search import device_commit as tdc
from wrenc_tpu_torch.search import wavefront as twf

from tests.test_torch_native_ref import jax_native_host_build  # noqa: F401
from tests.test_entropy_roundtrip import synth_frame

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for k in ("WRENC_COMMIT_ENGINE", "WRENC_CHROMA_STAGE_A",
              "WRENC_STAGE_A_SELECT"):
        monkeypatch.delenv(k, raising=False)


def _port_cfg(cfg):
    return tconfig.config_from_dict(dataclasses.asdict(cfg))


def _check_encode(cfg, frames, **kw):
    """Port encode (device='cpu') == JAX encode with the same search
    arguments: bytes and reconstruction. Returns the port's search,
    stream and reconstruction."""
    want, want_rec = JaxEncoder(cfg, search=JaxSearch(cfg, **kw)) \
        .encode(frames)
    search = WavefrontSearch(_port_cfg(cfg), device='cpu', **kw)
    got, rec = Encoder(_port_cfg(cfg), search=search).encode(frames)
    assert got == want
    for k in range(len(frames)):
        for c in range(3):
            assert (rec[k][c] == want_rec[k][c]).all(), (k, c)
    return search, got, rec


def _decodes_to(stream, recons):
    """The port's three decoders (shipped Python, shipped with native
    CABAC, clean-room) reproduce the reconstruction."""
    for dec in (decode_annexb(stream, use_native=False),
                decode_annexb(stream, use_native=True),
                decode_annexb_independent(stream)):
        assert len(dec) == len(recons)
        for got, want in zip(dec, recons):
            for c in range(3):
                assert (np.asarray(got[c], np.uint8)
                        == np.asarray(want[c], np.uint8)).all()


# ------------------------------------------------------------- per-QG QP
@pytest.mark.parametrize("w,h,qp,pattern,seeds", [
    (96, 64, 32, (-3, 0, 4), (11, 12)),     # 3x2 CTUs: row-start prediction
    (64, 96, 27, (5, -5), (11, 12)),        # 2x3 CTUs, alternating +-5
    (64, 64, 38, (7,), (11, 12)),           # every delta nonzero
    (64, 64, 30, (9, -8), (5,)),            # |delta| >= 5: the EG0 suffix
], ids=["96x64", "64x96", "64x64_const", "eg_suffix"])
def test_qp_delta_matches_jax(w, h, qp, pattern, seeds):
    """tests/test_qp_delta.py's cases: bytes == the JAX search's, and the
    port's three decoders reproduce the per-QG reconstruction."""
    cfg = EncoderConfig(width=w, height=h, qp=qp, qp_delta_pattern=pattern)
    frames = [synth_frame(w, h, seed=s) for s in seeds]
    _, stream, rec = _check_encode(cfg, frames)
    _decodes_to(stream, rec)


# ------------------------------------------------------- commit options
@pytest.mark.parametrize("kw", [{"rd_commit": False}, {"rd_commit": True},
                                {"trellis_commit": False}],
                         ids=["non_rd", "rd", "greedy"])
@pytest.mark.parametrize("w,h,qp", [(64, 64, 30), (96, 64, 33)])
def test_commit_options_match_jax(w, h, qp, kw):
    cfg = EncoderConfig(width=w, height=h, qp=qp)
    frames = [synth_frame(w, h, seed=qp + k) for k in range(2)]
    search, _, _ = _check_encode(cfg, frames, **kw)
    assert not search._device_commit


@pytest.mark.parametrize("kw", [{"trellis_commit": False},
                                {"rd_commit": False}],
                         ids=["greedy", "non_rd"])
def test_device_engine_falls_back_under_commit_options(kw):
    """commit_engine='device' with the greedy or the non-RD commit runs
    the native engine, as the JAX search does, with its bytes."""
    cfg = EncoderConfig(width=64, height=64, qp=29)
    frames = [synth_frame(64, 64, seed=71)]
    search, _, _ = _check_encode(cfg, frames, commit_engine='device', **kw)
    assert search.commit_engine == 'device'
    assert not search._device_commit and not search._chroma_device


def _jax_trees(cfg, frame, **kw):
    """One frame's decided trees from the JAX search."""
    js = JaxSearch(cfg, **kw)
    trees, _ = js.encode_frames([frame])[0]
    return js, trees


def _levels(cus):
    return [[None if c is None else np.asarray(c).copy() for c in cu.coeffs]
            for cu in cus]


def _same_levels(a, b):
    for ca, cb in zip(a, b):
        for x, y in zip(ca, cb):
            assert (x is None) == (y is None)
            if x is not None:
                assert (np.asarray(x) == np.asarray(y)).all()


@pytest.mark.parametrize("trellis_commit", [True, False])
def test_numpy_commit_matches_jax(trellis_commit):
    """The port's _commit on a copy of the JAX search's trees == the JAX
    _commit: reconstruction and every CU's levels."""
    cfg = EncoderConfig(width=96, height=64, qp=31)
    frame = synth_frame(96, 64, seed=23)
    js, trees = _jax_trees(cfg, frame, rd_commit=False)
    js.trellis_commit = trellis_commit
    mine = copy.deepcopy(trees)
    js.orig = [np.asarray(p, np.int32) for p in frame]
    want = js._commit(trees)
    ts = WavefrontSearch(_port_cfg(cfg), trellis_commit=trellis_commit,
                         rd_commit=False, device='cpu')
    got = ts._commit(mine, [np.asarray(p, np.int32) for p in frame])
    for c in range(3):
        assert (got[c] == want[c]).all(), c
    _same_levels(_levels(ts._collect_cus(mine)),
                 _levels(js._collect_cus(trees)))


# ------------------------------------------------ the device prototype
@pytest.mark.parametrize("w,h,qp,seed", [
    (96, 64, 30, 21), (64, 64, 22, 3), (64, 96, 37, 8),
])
def test_commit_frame_device_matches(w, h, qp, seed):
    """tests/test_device_commit.py's cases: the port's commit_frame_device
    (device='cpu') == the port's _commit(trellis_commit=False) == the JAX
    commit_frame_device, reconstruction and levels."""
    cfg = EncoderConfig(width=w, height=h, qp=qp)
    frame = synth_frame(w, h, seed=seed)
    js, trees = _jax_trees(cfg, frame, trellis_commit=False,
                           rd_commit=False)
    ts = WavefrontSearch(_port_cfg(cfg), trellis_commit=False,
                         rd_commit=False, device='cpu')
    t_np, t_dev, j_dev = (copy.deepcopy(trees) for _ in range(3))
    rec_np = ts._commit(t_np, [np.asarray(p, np.int32) for p in frame])
    kq.greedy_depquant.launches = 0
    cus = ts._collect_cus(t_dev)
    rec_dev = tdc.commit_frame_device(_port_cfg(cfg), frame, cus,
                                      device='cpu')
    assert kq.greedy_depquant.launches == 0      # the plain twin on the CPU
    j_cus = js._collect_cus(j_dev)
    rec_jax = jdc.commit_frame_device(cfg, frame, j_cus)
    for c in range(3):
        assert (rec_dev[c] == rec_np[c]).all(), c
        assert (rec_dev[c] == np.asarray(rec_jax[c])).all(), c
    _same_levels(_levels(cus), _levels(ts._collect_cus(t_np)))
    _same_levels(_levels(cus), _levels(j_cus))


def test_plan_steps_pads_only_into_the_pad_slot():
    """The prototype's schedule: every non-empty component group is one
    step; its real rows scatter to distinct plane positions, its padded
    rows repeat the last block (and scatter to the pad slot), and no
    reference gather reads the pad slot."""
    cfg = _port_cfg(EncoderConfig(width=96, height=64, qp=30))
    frame = synth_frame(96, 64, seed=21)
    ts = WavefrontSearch(cfg, trellis_commit=False, rd_commit=False,
                         device='cpu')
    trees, _ = ts.encode_frames([frame])[0]
    cus = ts._collect_cus(trees)
    steps = tdc.plan_steps(cfg, cus)
    groups = tdc.rank_groups(cus, cfg.width, cfg.height)
    want = sum((tree in ('S', 'L')) + 2 * (tree in ('S', 'C'))
               for (_, _, tree), _ in groups)
    assert len(steps) == want
    assert any(st.Bp > st.B for st in steps)
    assert any(st.cclm is not None for st in steps)
    for st in steps:
        s = 1 << st.log2
        src, _, _, _, _, scat, _, _, _, _ = tdc._geometry(
            cfg.width, cfg.height, s, st.c_idx, cfg.log2_ctu_size)
        pad = (cfg.width >> (st.c_idx > 0)) * (cfg.height >> (st.c_idx > 0))
        assert st.Bp == tdc._buckets(st.B)
        assert (st.idx[st.B:] == st.idx[st.B - 1]).all()
        real = scat[st.idx[:st.B]].reshape(-1)
        assert len(np.unique(real)) == real.size and real.max() < pad
        assert src[st.idx].max() < pad


# ------------------------------------------------------------ CCLM
@pytest.mark.parametrize("cs", [4, 8, 16])
def test_predict_cclm_matches_jax_and_numpy(cs):
    """The port's patch-based predict_cclm == the JAX predict_cclm ==
    predict_cclm_np, modes 81-83 on 96x64 (tests/test_cclm.py's
    geometry: corners, edges, CTU-row boundaries); one call with a mode
    per block gives the same integers."""
    rng = np.random.default_rng(17)
    W, H = 96, 64
    luma = rng.integers(0, 256, (H, W)).astype(np.int32)
    chroma = rng.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
    xs, ys = refs.block_grid(W, H, cs, 1)
    masks = refs.avail_masks(W, H, cs, 1, 5)
    got = {}
    for mode in (81, 82, 83):
        want = jnp_ops.predict_cclm_np(mode, luma, chroma, xs, ys, cs, masks)
        assert (np_ops.predict_cclm_np(mode, luma, chroma, xs, ys, cs, masks)
                == want).all()
        jx = np.asarray(jip.predict_cclm(mode, jnp.asarray(luma),
                                         jnp.asarray(chroma), xs, ys, cs,
                                         masks))
        got[mode] = tip.predict_cclm(mode, torch.as_tensor(luma),
                                     torch.as_tensor(chroma), xs, ys, cs,
                                     masks).numpy()
        assert (got[mode] == want).all() and (jx == want).all(), mode
    m = np.array([81, 82, 83])[np.arange(len(xs)) % 3]
    mixed = tip.predict_cclm(torch.as_tensor(m), torch.as_tensor(luma),
                             torch.as_tensor(chroma), xs, ys, cs,
                             masks).numpy()
    for i, mode in enumerate(m):
        assert (mixed[i] == got[mode][i]).all()


# ------------------------------------------------- host-side selection
def _unselected(ts, frames):
    """The port's luma stage A of one chunk without the winner selection
    (fused_luma_stage_a, sel=False): {s: (cands, base)} on the host."""
    cfg, a, sizes = ts.cfg, ts._stage_a_args(), ts._sizes()
    res = twf.fused_luma_stage_a(
        ts._upload([f[0] for f in frames]), cfg.width, cfg.height,
        cfg.log2_ctu_size, tuple(sizes), a['K'], a['trellis'], a['ls'],
        a['bd'], a['lam_dq'], a['lv'], a['lam'], a['mats'], sel=False)
    return {s: tuple(x.numpy() for x in res[s]) for s in sizes}


def _stage_a_host(cfg, frames):
    """Both packages' non-selecting luma stage A on the same chunk:
    (port search, JAX search, sizes, {s: (cands, base)} port, JAX)."""
    ts = WavefrontSearch(_port_cfg(cfg), device='cpu')
    sizes = ts._sizes()
    port = _unselected(ts, frames)
    js = JaxSearch(cfg)
    js._select_device = False
    _, _, jres, _ = js._dispatch_stage_a(frames)
    return ts, js, sizes, port, {s: tuple(np.asarray(x) for x in jres[s])
                                 for s in sizes}


def test_non_selecting_stage_a_matches_jax():
    """fused_luma_stage_a(sel=False) == the JAX _fused_luma_builder with
    sel=False: candidates and f32 base costs, bit for bit."""
    cfg = EncoderConfig(width=96, height=64, qp=32)
    frames = [synth_frame(96, 64, seed=s) for s in (3, 4)]
    _, _, sizes, port, jax_ = _stage_a_host(cfg, frames)
    for s in sizes:
        (pc, pb), (jc, jb) = port[s], jax_[s]
        assert pc.dtype == jc.dtype and pb.dtype == jb.dtype == np.float32
        assert (pc == jc).all() and (pb == jb).all(), s


def test_select_modes_matches_jax():
    """The port's host _select_modes == the JAX one on the same stage-A
    outputs: modes, costs, ranked candidates and costs, with the same
    dtypes (numpy's promotion of the f32 base and the Python-float
    lambda)."""
    cfg = EncoderConfig(width=96, height=64, qp=32)
    frames = [synth_frame(96, 64, seed=s) for s in (3, 4)]
    ts, js, sizes, port, jax_ = _stage_a_host(cfg, frames)
    for s in sizes:
        got = ts._select_modes(s, *port[s])
        want = js._select_modes(s, *jax_[s])
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and (a == b).all(), s


@pytest.mark.parametrize("w,h,qp", [(64, 64, 30), (96, 64, 27)])
def test_host_select_encode_matches_jax(w, h, qp):
    """The host selection (_select_modes, a row mesh's) and the device
    one (_select_modes_dev, every other search's) on the same unselected
    stage-A output: the same winners and the same ranked candidates; the
    costs within one f32 step (the host rounds base + sc * bits twice,
    the device once, as XLA's fused multiply-add)."""
    cfg = EncoderConfig(width=w, height=h, qp=qp)
    frames = [synth_frame(w, h, seed=qp + k) for k in range(2)]
    ts = WavefrontSearch(_port_cfg(cfg), device='cpu')
    a = ts._stage_a_args()
    sizes = ts._sizes()
    consts = twf._luma_consts(w, h, ts.cfg.log2_ctu_size, tuple(sizes),
                              ts.device)
    for s, (cands, base) in _unselected(ts, frames).items():
        mode, cost, ranked, ranked_cost = ts._select_modes(s, cands, base)
        d_ranked, d_cost, d_top2 = (x.numpy() for x in twf._select_modes_dev(
            torch.as_tensor(base), torch.as_tensor(cands).long(), h // s,
            w // s, consts[s][5], *a['seltabs']))
        assert (d_ranked == ranked).all() and (d_ranked[..., 0] == mode).all()
        for d, h_ in ((d_cost, cost), (d_top2, ranked_cost[..., :2])):
            assert d.dtype == h_.dtype == np.float32
            assert (np.abs(d - h_) <= np.spacing(np.abs(h_))).all(), s


@pytest.mark.parametrize("case", ["non_rd", "qp_delta"])
def test_multi_chunk_matches_jax(case):
    """Nine 64x64 frames make two stage-A chunks: the commit of the first
    (the non-RD native one, or the per-QG NumPy one) runs in the worker
    thread under the next chunk's decide."""
    kw = {}
    cfg = EncoderConfig(width=64, height=64, qp=33)
    if case == "non_rd":
        kw["rd_commit"] = False
    else:
        cfg.qp_delta_pattern = (4, -2)
    frames = [synth_frame(64, 64, seed=80 + k) for k in range(9)]
    search, _, _ = _check_encode(cfg, frames, **kw)
    assert 'host_commit_work' in search.phase_times


# ------------------------------------------------ the decide as values
# what the search held of a chunk or a frame before the decide returned
# its decisions as values
CHUNK_STATE = {"batch", "orig", "luma_cands", "luma_cand_costs", "split",
               "refine", "luma_mode", "cclm_choice", "scipu_choice",
               "cand_mat", "_luma_marks"}


def _cu_key(cu):
    return None if cu is None else (
        cu.x, cu.y, cu.log2, cu.tree, cu.luma_mode, cu.chroma_mode,
        None if cu.cands is None else np.asarray(cu.cands).tolist())


def _tree_key(n):
    """A CtNode tree as nested tuples of its decisions."""
    return (n.x, n.y, n.log2, n.cqt_depth, n.tree, n.mode_type, n.split,
            n.refine, _cu_key(n.cu), _cu_key(n.alt_cu),
            tuple(_tree_key(c) for c in n.children))


def test_search_keeps_no_chunk_state():
    """After a two-chunk call the search holds the names __init__ set
    and none of a chunk's or a frame's."""
    search = WavefrontSearch(_port_cfg(EncoderConfig(width=64, height=64,
                                                     qp=33)), device='cpu')
    fresh = set(vars(search))
    out = search.encode_frames([synth_frame(64, 64, seed=80 + k)
                                for k in range(9)])
    assert len(out) == 9 and 'host_commit_work' in search.phase_times
    assert set(vars(search)) == fresh and not fresh & CHUNK_STATE


def test_chunks_decide_in_any_order():
    """Two chunks dispatched together and decided B first, then A, give
    the trees that a fresh search gives deciding A, then B."""
    cfg = _port_cfg(EncoderConfig(width=64, height=64, qp=31))
    a = [synth_frame(64, 64, seed=s) for s in (31, 32)]
    b = [synth_frame(64, 64, seed=33)]

    def keys(trees):
        return [[_tree_key(t) for t in f] for f in trees]
    search = WavefrontSearch(cfg, device='cpu')
    da, db = search._dispatch_stage_a(a, 0), search._dispatch_stage_a(b, 1)
    tb = keys(search._decide_chunk(db, 1)[1])
    ta = keys(search._decide_chunk(da, 0)[1])
    fresh = WavefrontSearch(cfg, device='cpu')
    want = [keys(fresh._decide_chunk(fresh._dispatch_stage_a(c, k), k)[1])
            for k, c in enumerate((a, b))]
    assert [ta, tb] == want and len(ta) == 2 and len(tb) == 1


def test_trees_assemble_from_the_decision_alone():
    """_assemble_trees needs no search: a 64x64 decision that splits only
    the first CTU's 32x32 gives four 16x16 leaves there and 32x32 leaves
    elsewhere, each with its size's mode, CCLM choice and candidates."""
    cfg = _port_cfg(EncoderConfig(width=64, height=64, qp=32))
    n = {s: (64 // s) ** 2 for s in (4, 8, 16, 32)}
    split = {32: [[True, False], [False, False]], 16: [[False] * 4] * 4}
    dec = twf.FrameDecision(
        split, {}, {s: [s + 1] * n[s] for s in n},
        {32: [-1] * n[32], 16: [82] * n[16]}, None,
        {s: np.full((n[s], 6), s, np.int32) for s in n})
    trees = twf._assemble_trees(cfg, dec)
    assert [(t.x, t.y, t.split) for t in trees] == [
        (0, 0, True), (32, 0, False), (0, 32, False), (32, 32, False)]
    leaves = [(n.cu.log2, n.cu.luma_mode, n.cu.chroma_mode,
               int(n.cu.cands[0]))
              for t in trees for n in (t.children if t.split else [t])]
    assert leaves == [(4, 17, 82, 16)] * 4 + [(5, 33, 33, 32)] * 3
