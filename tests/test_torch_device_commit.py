"""The port's device RD commit engine (`commit_engine='device'`) against
the JAX package's, on the CPU.

Every comparison is exact (tolerance 0): the batched trellis entry, the
per-row dequantizer, single-mode prediction and the CCLM pieces, the
commit schedule, and whole encodes (bytes and reconstruction), with and
without refine phantoms. On the CPU `trellis_rate_batch` runs its plain
twin; chip_smoke.py holds kernel K1 against that twin on the card.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wrenc_tpu.conformance import decode_annexb_independent
from wrenc_tpu.core.config import EncoderConfig, RateModelConfig
from wrenc_tpu.decoder import decode_annexb
from wrenc_tpu.encoder import Encoder as JaxEncoder
from wrenc_tpu.kernels import intra_pred as jip
from wrenc_tpu.kernels import quantize as jkq
from wrenc_tpu.kernels import refs
from wrenc_tpu.kernels import trellis_pallas
from wrenc_tpu.search import WavefrontSearch as JaxSearch
from wrenc_tpu.search import device_commit as jdc
from wrenc_tpu.spec import quant

from wrenc_tpu_torch.conformance import (
    decode_annexb_independent as port_independent)
from wrenc_tpu_torch.core import config as tconfig
from wrenc_tpu_torch.decoder import decode_annexb as port_decode
from wrenc_tpu_torch.encoder import Encoder
from wrenc_tpu_torch.kernels import intra_pred as tip
from wrenc_tpu_torch.kernels import quantize as tkq
from wrenc_tpu_torch.kernels import trellis as ttl
from wrenc_tpu_torch.search import WavefrontSearch
from wrenc_tpu_torch.search import device_commit as tdc

from tests.test_torch_native_ref import jax_native_host_build  # noqa: F401
from tests.test_entropy_roundtrip import synth_frame

torch.set_num_threads(1)


def _port_cfg(cfg):
    return tconfig.config_from_dict(dataclasses.asdict(cfg))


def _device_search(cfg, **kw):
    return WavefrontSearch(_port_cfg(cfg), commit_engine='device',
                           chroma_stage_a='native', device='cpu', **kw)


def _leaf_cus(trees):
    out = []

    def walk(n):
        if n.split:
            for c in n.children:
                walk(c)
        elif n.cu is not None:
            out.append(n.cu)
    for t in trees:
        walk(t)
    return out


# ------------------------------------------------------------- kernels
def test_trellis_rate_batch_plain_matches_jax():
    """Seeded mixed sizes in one wave, each with per-row ls / bd_shift
    (luma and chroma rows of several QPs), two jobs sharing a size."""
    rng = np.random.default_rng(5)
    rm = RateModelConfig()
    lam = jkq.lam_dq_table(rm, 32, trellis=True)
    lv = jkq.lv_table_device(rm, True, True)
    jobs = []
    for log2, B in ((3, 5), (2, 7), (5, 3), (4, 4), (3, 2)):
        s = 1 << log2
        t = rng.integers(-900, 900, (B, s, s)).astype(np.int32)
        t[0] = 0
        t[1] = rng.integers(-2, 3, (s, s))
        qp = rng.choice([22, 27, 32, 37], B)
        qps = [quant.derive_quant_params(int(q), log2, log2, dep_quant=True,
                                         transform_skip=False) for q in qp]
        ls = np.array([p.ls for p in qps], np.int32)
        bd = np.array([p.bd_shift for p in qps], np.int32)
        jobs.append((t, ls, bd, log2))
    lgs = [j[3] for j in jobs]
    want = jax.jit(lambda ts, lss, bds, lam, lv: trellis_pallas
                   .trellis_rate_batch(list(zip(ts, lss, bds, lgs)), lam,
                                       lv))(*(
        [jnp.asarray(j[i]) for j in jobs] for i in range(3)),
        jnp.asarray(lam), jnp.asarray(lv))
    launches = ttl.trellis_rate_batch.launches
    got = ttl.trellis_rate_batch(
        [(torch.as_tensor(t), torch.as_tensor(ls), torch.as_tensor(bd), lg)
         for t, ls, bd, lg in jobs], torch.as_tensor(lam),
        torch.as_tensor(lv))
    assert ttl.trellis_rate_batch.launches == launches     # plain twin
    assert len(got) == len(jobs)
    for (qg, rg), (qw, rw), job in zip(got, want, jobs):
        assert qg.dtype == torch.int16 and qg.shape == job[0].shape
        assert (qg.numpy() == np.asarray(qw)).all()
        assert (rg.numpy() == np.asarray(rw)).all()


def test_dequantize_per_row_matches_jax():
    rng = np.random.default_rng(9)
    q = rng.integers(-(1 << 15), 1 << 15, (6, 8, 8)).astype(np.int16)
    q[0] = 0
    ls = rng.integers(1, 1 << 14, 6).astype(np.int32)
    bd = rng.integers(3, 12, 6).astype(np.int32)
    want = np.asarray(jkq.dequantize_impl(jnp.asarray(q), jnp.asarray(ls),
                                          jnp.asarray(bd)))
    got = tkq.dequantize(torch.as_tensor(q), torch.as_tensor(ls),
                         torch.as_tensor(bd)).numpy()
    assert (want == got).all()
    assert (np.abs(got) == 1 << 15).any() or (got == (1 << 15) - 1).any()


@pytest.mark.parametrize("size,c_idx", [(4, 1), (8, 0), (16, 1)])
def test_predict_modes_m_matches_jax(size, c_idx):
    rng = np.random.default_rng(size + c_idx)
    L = 4 * size + 1
    v = rng.integers(0, 256, (9, 2 * L)).astype(np.int32)
    v[0] = 255
    modes = rng.integers(0, 67, 9).astype(np.int32)
    modes[:3] = (0, 1, 66)
    want = np.asarray(jip.predict_modes_m(
        jnp.asarray(v), jnp.asarray(modes), jip.mats_host_f32(size, c_idx)))
    got = tip.predict_modes_m(torch.as_tensor(v), torch.as_tensor(modes),
                              tip.mats_device_f32(size, c_idx, 'cpu'))
    assert (got.numpy() == want).all()


def test_ilog2_matches_jax():
    v = np.arange(256, dtype=np.int32)
    assert (tip._ilog2_u8(torch.as_tensor(v)).numpy()
            == np.asarray(jip._ilog2_u8(jnp.asarray(v)))).all()


@pytest.mark.parametrize("cs", [4, 8, 16])
def test_cclm_pieces_match_jax(cs):
    """Every chroma block of a 64x64 frame pair (corner, edge and
    interior blocks, so unavailable left / top sides occur), each mode,
    on seeded reconstruction planes and own-luma blocks."""
    W, H, F = 64, 64, 2
    rng = np.random.default_rng(100 + cs)
    luma = rng.integers(0, 256, (F, H * W)).astype(np.int32)
    cb = rng.integers(0, 256, (F, H * W // 4)).astype(np.int32)
    xs, ys = refs.block_grid(W, H, cs, 1)
    masks = refs.avail_masks(W, H, cs, 1, 5).astype(np.int32)
    assert not masks[:, 1].all() and not masks[:, 1 + 2 * cs].all()
    B = len(xs)
    bf = rng.integers(0, F, B).astype(np.int32)
    modes = rng.integers(81, 84, B).astype(np.int32)
    own = rng.integers(0, 256, (B, 2 * cs, 2 * cs)).astype(np.int32)
    xs, ys = xs.astype(np.int32), ys.astype(np.int32)
    arrs = dict(luma=luma, cb=cb, xs=xs, ys=ys, bf=bf, masks=masks,
                modes=modes, own=own)
    J = {k: jnp.asarray(a) for k, a in arrs.items()}
    T = {k: torch.as_tensor(a) for k, a in arrs.items()}

    def run(m, L):
        strips = m.cclm_strips(L['luma'], 2 * L['xs'], 2 * L['ys'], cs, H,
                               W, L['bf'])
        cstrips = m.cclm_cstrips(L['cb'], L['xs'], L['ys'], cs, H // 2,
                                 W // 2, L['bf'])
        TS, LS, LC = strips
        ct, cl = cstrips
        pred = m.cclm_from_own(L['modes'], L['own'], LC, TS, LS, ct, cl,
                               L['masks'], 2 * L['ys'], cs, 32)
        return list(strips) + list(cstrips) + [pred]

    for w, g in zip(jax.jit(lambda L: run(jip, L))(J), run(tip, T)):
        assert (np.asarray(w) == g.numpy()).all()


# ------------------------------------------------------------ schedule
def _port_trees(w, h, qp, margin, seeds):
    cfg = EncoderConfig(width=w, height=h, qp=qp)
    cfg.rate_model.split_refine_margin = margin
    ws = WavefrontSearch(_port_cfg(cfg), device='cpu')
    frames = [synth_frame(w, h, seed=s) for s in seeds]
    _, all_trees, _ = ws._decide_chunk(ws._dispatch_stage_a(frames))
    return cfg, all_trees


@pytest.mark.parametrize("margin", [0.0, 10.0])
def test_schedule_matches_jax(margin):
    """The port's compact rows are the live entries of the JAX package's
    padded (SEG, cap) arrays, in (step, slot) order."""
    cfg, all_trees = _port_trees(96, 64, 35, margin, (5, 6))
    for trees in all_trees:
        cus = tdc._collect_leaf_cus(trees)
        assert [(c.x, c.y, c.log2, c.tree, p) for c, p in cus] == [
            (c.x, c.y, c.log2, c.tree, p)
            for c, p in jdc._collect_leaf_cus(trees)]
        assert any(p for _, p in cus) == (margin > 0)
        want = np.asarray(jdc._cu_ranks(cus, 96, 64, 5))
        assert (tdc._cu_ranks(cus, 96, 64, 5) == want).all()
    seg_t, ph_t = tdc._build_schedule(cfg, all_trees)
    seg_j, _n_j, ph_j = jdc._build_schedule(cfg, all_trees)
    assert ph_t == ph_j and len(seg_t) == len(seg_j)
    for rows_t, (caps_j, xs_j, ent_j) in zip(seg_t, seg_j):
        assert sorted(rows_t) == sorted(ck for ck, _cap in caps_j)
        for ck, rows in rows_t.items():
            ent = sorted(ent_j[ck], key=lambda e: (e[0], e[1]))
            rl = np.array([e[0] for e in ent])
            kl = np.array([e[1] for e in ent])
            assert [(id(cu), p) for cu, p in rows.cus] == [
                (id(e[2]), e[3]) for e in ent]
            assert sorted(rows.fields) == sorted(xs_j[ck])
            for f, a in rows.fields.items():
                assert (a == xs_j[ck][f][rl, kl]).all(), (ck, f)
            counts = np.bincount(rl, minlength=tdc.SEG)
            assert rows.off == [0] + np.cumsum(counts).tolist()
            assert rows.n_ph == np.bincount(
                rl, weights=[e[3] for e in ent],
                minlength=tdc.SEG).astype(int).tolist()


@pytest.mark.parametrize("has_ph", [False, True])
def test_schedule_refuses_repeated_scatter_targets(has_ph):
    """A class's schedule rows (frames below F) name distinct blocks in
    the whole scan: each step scatters its coefficients and its modes,
    read back per block, in place. Padded rows (frames F and up) may
    repeat a block in another step only. has_ph: the class checked is
    the split-refine class ('S'), whose rows may be phantoms, else a
    luma class, which has none; one rule holds for both."""
    ck = ('S', 3) if has_ph else ('L', 2)
    F = 2
    bf = np.zeros(2, np.int32)
    tdc._check_targets(ck, np.array([0, 0]), bf, np.array([0, 1]), F)
    for steps in ([0, 1], [0, 0]):
        with pytest.raises(RuntimeError, match="repeats"):
            tdc._check_targets(ck, np.array(steps), bf, np.array([0, 0]), F)
    pad = np.full(2, F, np.int32)
    tdc._check_targets(ck, np.array([0, 1]), pad, np.array([0, 0]), F)
    with pytest.raises(RuntimeError, match="repeats"):
        tdc._check_targets(ck, np.array([0, 0]), pad, np.array([0, 0]), F)


@pytest.mark.parametrize("margin", [0.0, 10.0])
def test_padded_steps_name_pad_frames(margin, monkeypatch):
    """Each rank step packs, per class with rows in it (in sorted order),
    the schedule's rows of that step, then padded rows up to the
    power-of-two cap _row_cap gives (at least ROW_CAP_MIN, also forced
    larger): the padded rows are not valid, no phantom, hold no
    candidate, and each names its own block of a pad frame (F up to
    F + _pad_frames), distinct from each other and from every schedule
    row of the step (_check_targets)."""
    cfg, all_trees = _port_trees(96, 64, 35, margin, (5, 6))
    F = len(all_trees)
    segs, has_ph = tdc._build_schedule(cfg, all_trees)
    n_cand = next(r.fields['cands'].shape[1] for seg in segs
                  for ck, r in seg.items() if ck[0] != 'C')
    for cap_min in (16, 64):
        monkeypatch.setattr(tdc, "ROW_CAP_MIN", cap_min)
        P = tdc._pad_frames(96, 64, F, 5)
        pads = 0
        for seg in segs:
            ranks = [r for r in range(tdc.SEG)
                     if any(sr.off[r + 1] > sr.off[r] for sr in seg.values())]
            steps = tdc._pack_steps(cfg, seg, has_ph, F, n_cand)
            assert len(steps) == len(ranks)
            for r, st in zip(ranks, steps):
                assert [ck for ck, _, _ in st.sig] == sorted(
                    ck for ck, sr in seg.items() if sr.off[r + 1] > sr.off[r])
                o = live = pad = 0
                for ck, cap, ph in st.sig:
                    sr = seg[ck]
                    a, b = sr.off[r], sr.off[r + 1]
                    n = b - a
                    assert cap == tdc._row_cap(n) >= max(n, cap_min)
                    assert cap & (cap - 1) == 0 and cap < 2 * max(n, cap_min)
                    assert ph == (sr.n_ph[r] > 0)
                    lay, length = tdc._layout(ck, cap, n_cand, has_ph)
                    x = {f: st.rows[o + i:o + i + int(np.prod(shp))]
                         .reshape(shp) for f, i, shp in lay}
                    assert sorted(x) == sorted(sr.fields)
                    for f, v in sr.fields.items():
                        assert (x[f][:n] == v[a:b]).all(), (ck, f)
                    assert not x['valid'][n:].any()
                    if 'ph' in x:
                        assert not x['ph'][n:].any()
                    if 'cands' in x:
                        assert (x['cands'][n:] == -1).all()
                    assert (x['bf'][:n] < F).all()
                    assert ((x['bf'][n:] >= F) & (x['bf'][n:] < F + P)).all()
                    nb = (96 // tdc._grid(ck)) * (64 // tdc._grid(ck))
                    assert ((x['bi'] >= 0) & (x['bi'] < nb)).all()
                    tdc._check_targets(ck, np.zeros(cap, np.int64), x['bf'],
                                       x['bi'], F)
                    o, live, pad = o + length, live + n, pad + cap - n
                assert o == len(st.rows)
                assert (st.live, st.pad) == (live, pad)
                pads += pad
        assert pads > 0


def test_cost16384_matches_jax():
    """The RD cost ssd + lam * ((level + mb) / 16384), which XLA contracts
    into one FMA, on random costs where two roundings differ."""
    rng = np.random.default_rng(4)
    n = 20000
    ssd = rng.integers(0, 200000, n).astype(np.int32)
    level = rng.integers(0, 1 << 22, n).astype(np.float32)
    mb = rng.integers(0, 1 << 20, n).astype(np.float32)
    lam = np.float32(57.123456)
    want = np.asarray(jax.jit(jdc._cost16384)(ssd, level, mb, lam))
    got = tdc._cost16384(torch.as_tensor(ssd), torch.as_tensor(level),
                         torch.as_tensor(mb), torch.as_tensor(lam))
    assert (got.numpy() == want).all()


def test_region_sum_order():
    """The refine compare's region cost sums columns in XLA's CPU order:
    sequential, in halves of 32 for 64 cells. Against the JAX sum on rows
    where other orders round differently."""
    rng = np.random.default_rng(2)
    for k in (4, 16, 64):
        v = np.zeros((4000, k), np.float32)
        for i in range(len(v)):
            j = rng.choice(k, 4, replace=False)
            v[i, j] = rng.standard_normal(4) * 10.0 ** rng.integers(-1, 7, 4)
        want = np.asarray(jnp.asarray(v).sum(1))
        assert (tdc._region_sum(torch.as_tensor(v)).numpy() == want).all()


# -------------------------------------------------------------- encode
@pytest.mark.parametrize("w,h,qp,margin,n", [
    (64, 64, 32, None, 1), (96, 64, 35, 10.0, 1)])
def test_device_engine_bytes_match_jax(w, h, qp, margin, n, monkeypatch):
    """Byte-identical to the JAX device engine in the same configuration;
    margin 10 makes every internal split a refine node, so phantoms run
    and some merged leaves win. The repo's decoders and the port's two
    reproduce the port's reconstruction."""
    cfg = EncoderConfig(width=w, height=h, qp=qp)
    if margin is not None:
        cfg.rate_model.split_refine_margin = margin
    frames = [synth_frame(w, h, seed=qp + k) for k in range(n)]
    want, want_rec = JaxEncoder(cfg, search=JaxSearch(
        cfg, commit_engine='device', chroma_stage_a='native')).encode(frames)
    search = _device_search(cfg)
    runs = []
    encode_frames = search.encode_frames
    monkeypatch.setattr(search, "encode_frames",
                        lambda f: runs.append(encode_frames(f)) or runs[-1])
    got, rec = Encoder(_port_cfg(cfg), search=search).encode(frames)
    assert got == want
    for k in range(n):
        for c in range(3):
            assert (rec[k][c] == want_rec[k][c]).all()
    for decoded in (decode_annexb(got), port_decode(got),
                    decode_annexb_independent(got), port_independent(got)):
        assert len(decoded) == n
        for k in range(n):
            for c in range(3):
                assert (np.asarray(decoded[k][c]) == rec[k][c]).all()
    if margin:
        # every split was a refine node, so the all-split trees would hold
        # no single-tree leaf: each one is a merged leaf that won
        assert any(cu.tree == 'S' for trees, _ in runs[0]
                   for cu in _leaf_cus(trees))


def _k1_positions_per_row(ck, n_cand, cclm):
    """K1 positions one row of class ck adds to a rank step: its luma
    candidates, its chroma candidates ('S') or derived chroma ('C'), and
    its CCLM pick (but for 'L')."""
    tree, log2 = ck
    s = 1 << log2
    cs = s >> 1 if tree == 'S' else 4
    p = 0 if tree == 'C' else n_cand * s * s
    p += 2 * cs * cs * (n_cand if tree == 'S' else 1 if tree == 'C' else 0)
    return p + (2 * cs * cs if cclm and tree != 'L' else 0)


@pytest.mark.parametrize("w,h,qp,margin,n", [
    (64, 64, 32, None, 1), (96, 64, 35, 10.0, 1)])
def test_device_engine_bytes_match_jax_at_larger_caps(w, h, qp, margin, n,
                                                      monkeypatch):
    """test_device_engine_bytes_match_jax's cases with the row caps
    forced up (ROW_CAP_MIN 32 for 16): the bytes and reconstruction stay
    the JAX engine's, phantoms included. The scan's counts stay but for
    K1's positions, which are the schedule rows' positions plus the
    padded rows'; n_commit_rows_live is the schedule's row count; off
    CUDA nothing is captured or replayed."""
    cfg = EncoderConfig(width=w, height=h, qp=qp)
    if margin is not None:
        cfg.rate_model.split_refine_margin = margin
    frames = [synth_frame(w, h, seed=qp + k) for k in range(n)]
    want, want_rec = JaxEncoder(cfg, search=JaxSearch(
        cfg, commit_engine='device', chroma_stage_a='native')).encode(frames)
    seen = {}
    build, pack = tdc._build_schedule, tdc._pack_steps

    def built(*a):
        segs, has_ph = build(*a)
        seen['rows'] = sum(len(r.cus) for seg in segs for r in seg.values())
        return segs, has_ph

    def packed(cfg_, seg, has_ph, F, n_cand):
        steps = pack(cfg_, seg, has_ph, F, n_cand)
        for st in steps:
            for ck, cap, _ in st.sig:
                seen['pos'] = seen.get('pos', 0) + cap * \
                    _k1_positions_per_row(ck, n_cand, cfg_.cclm_enabled)
        for ck, sr in seg.items():
            seen['live_pos'] = seen.get('live_pos', 0) + len(sr.cus) * \
                _k1_positions_per_row(ck, n_cand, cfg_.cclm_enabled)
        return steps
    monkeypatch.setattr(tdc, "_build_schedule", built)
    monkeypatch.setattr(tdc, "_pack_steps", packed)
    runs = {}
    for cap_min in (16, 32):
        monkeypatch.setattr(tdc, "ROW_CAP_MIN", cap_min)
        seen.clear()
        enc = Encoder(_port_cfg(cfg), search=_device_search(cfg))
        got, rec = enc.encode(frames)
        assert got == want
        for k in range(n):
            for c in range(3):
                assert (rec[k][c] == want_rec[k][c]).all()
        ph = enc.phase_times
        assert ph['n_commit_rows_live'] == seen['rows']
        assert ph['n_dq_trellis_positions'] == seen['pos']
        assert ph['n_commit_graph_captures'] == 0
        assert ph['n_commit_graph_replays'] == 0
        runs[cap_min] = (dict(ph), seen['live_pos'])
    (small, live_s), (large, live_l) = runs[16], runs[32]
    assert live_s == live_l
    for k in ('n_commit_steps', 'n_dq_trellis_launches',
              'n_commit_rows_live'):
        assert small[k] == large[k] > 0
    assert large['n_commit_rows_padded'] > small['n_commit_rows_padded'] > 0
    assert large['n_dq_trellis_positions'] > small['n_dq_trellis_positions'] \
        > live_s


def test_device_engine_matches_native_engine():
    """Mirror of tests/test_device_commit.py: with refinement off both of
    the port's engines decide the same modes and coefficients and give
    the same reconstruction."""
    cfg = EncoderConfig(width=96, height=64, qp=32)
    frames = [synth_frame(96, 64, seed=s) for s in (21, 4)]
    ws_n = WavefrontSearch(_port_cfg(cfg), commit_engine='native',
                           chroma_stage_a='native', device='cpu')
    ws_n._refine_margin = 0.0
    out_n = ws_n.encode_frames(frames)
    ws_d = _device_search(cfg)
    ws_d._refine_margin = 0.0
    out_d = ws_d.encode_frames(frames)
    for (trees_d, rec_d), (trees_n, rec_n) in zip(out_d, out_n):
        cus_d, cus_n = _leaf_cus(trees_d), _leaf_cus(trees_n)
        assert len(cus_d) == len(cus_n)
        for a, b in zip(cus_d, cus_n):
            assert (a.x, a.y, a.tree, a.luma_mode, a.chroma_mode) == \
                (b.x, b.y, b.tree, b.luma_mode, b.chroma_mode)
            for c in range(3):
                if b.coeffs[c] is None:
                    assert a.coeffs[c] is None
                else:
                    assert (np.asarray(a.coeffs[c]) == b.coeffs[c]).all()
        for c in range(3):
            assert (rec_d[c] == rec_n[c]).all()


@pytest.mark.parametrize("group,sizes", [(2, [2, 1]), (1, [1, 1, 1])])
def test_device_engine_commit_groups(group, sizes, monkeypatch):
    """One-frame stage-A chunks committed in groups of `group` give the
    bytes of one chunk and one scan: the groups' device planes are
    concatenated and the scan is per-frame exact. Groups of two: the last
    group a single chunk. Groups of one, the plan above 0.5 Mpx (one scan
    per chunk): three scans, each in the commit worker, chunk k's joined
    only after chunk k + 1's decide."""
    cfg = EncoderConfig(width=64, height=64, qp=30)
    frames = [synth_frame(64, 64, seed=80 + k) for k in range(3)]
    want, _ = Encoder(_port_cfg(cfg), search=_device_search(cfg)).encode(
        frames)
    monkeypatch.setattr(WavefrontSearch, "DEVICE_BATCH_BUCKETS", (1,))
    monkeypatch.setattr(WavefrontSearch, "_commit_group_frames",
                        lambda self: group)
    search = _device_search(cfg)
    commits, events = [], []
    commit_all, decide = search._commit_all, search._decide_chunk
    monkeypatch.setattr(search, "_commit_all", lambda t, b, d, s: commits.append(
        (len(b), threading.current_thread() is threading.main_thread()))
        or commit_all(t, b, d, s))
    monkeypatch.setattr(search, "_decide_chunk", lambda p, k: events.append(
        ("decide", k)) or decide(p, k))
    join = search._join_commit
    monkeypatch.setattr(search, "_join_commit", lambda prev: events.append(
        ("join", prev[2])) or join(prev))
    got, _ = Encoder(_port_cfg(cfg), search=search).encode(frames)
    assert commits == [(n, False) for n in sizes]
    assert got == want
    if group == 1:
        # the main thread joins chunk k's commit only after chunk k + 1's
        # decide: the worker's scan of chunk k runs under it
        assert events == [("decide", 0), ("decide", 1), ("join", 0),
                          ("decide", 2), ("join", 1), ("join", 2)]


@pytest.mark.parametrize("how", ["arg", "env"])
def test_device_engine_defaults_to_device_chroma(how, monkeypatch):
    """The device engine, asked for by argument or environment, takes the
    device chroma stage A by default (as the JAX search does) and
    encodes; both of the port's decoders reproduce its reconstruction.
    WRENC_CHROMA_STAGE_A=native still selects the native chroma."""
    cfg = tconfig.EncoderConfig(width=64, height=64, qp=31)
    monkeypatch.delenv("WRENC_CHROMA_STAGE_A", raising=False)
    if how == "env":
        monkeypatch.setenv("WRENC_COMMIT_ENGINE", "device")
        kw = {}
    else:
        monkeypatch.delenv("WRENC_COMMIT_ENGINE", raising=False)
        kw = {"commit_engine": "device"}
    search = WavefrontSearch(cfg, device='cpu', **kw)
    assert search._device_commit and search._chroma_device
    frames = [synth_frame(64, 64, seed=90)]
    stream, rec = Encoder(cfg, search=search).encode(frames)
    for decoded in (port_decode(stream), port_independent(stream)):
        for c in range(3):
            assert (np.asarray(decoded[0][c]) == rec[0][c]).all()
    monkeypatch.setenv("WRENC_CHROMA_STAGE_A", "native")
    search = WavefrontSearch(cfg, device='cpu', **kw)
    assert search._device_commit and not search._chroma_device


def test_device_engine_plan_at_1080p(monkeypatch):
    """The device engine's plan at 1920x1088, the JAX package's: stage-A
    buckets [1, 2, 4] (DEVICE_CHUNK_PIXEL_BUDGET), one scan per 4 frames,
    so an 8-frame call is two chunks and two commits, both in the commit
    worker, the first joined after the second chunk's decide. No encode:
    stage A, the decide and the commit are stubbed."""
    monkeypatch.delenv("WRENC_COMMIT_GROUP", raising=False)
    cfg = EncoderConfig(width=1920, height=1088, qp=32)
    search = WavefrontSearch(_port_cfg(cfg), commit_engine='device',
                             device='cpu')
    jax_search = JaxSearch(cfg, commit_engine='device')
    assert search._device_commit and search._chroma_device
    assert search._buckets() == jax_search._buckets() == [1, 2, 4]
    assert search._commit_group_frames() == \
        jax_search._commit_group_frames() == 4
    events, commits = [], []
    monkeypatch.setattr(search, "_dispatch_stage_a", lambda fr, k: events.append(
        ("dispatch", k, len(fr))) or (list(fr), k))
    monkeypatch.setattr(search, "_decide_chunk", lambda d, k: events.append(
        ("decide", k)) or (d[0], [("trees", f) for f in d[0]], None))
    monkeypatch.setattr(search, "_commit_all", lambda t, b, d, s: commits.append(
        (len(b), threading.current_thread() is threading.main_thread()))
        or [("recon", f) for f in b])
    join = search._join_commit
    monkeypatch.setattr(search, "_join_commit", lambda prev: events.append(
        ("join", prev[2])) or join(prev))
    out = search.encode_frames(list(range(8)))
    assert out == [(("trees", f), ("recon", f)) for f in range(8)]
    assert commits == [(4, False), (4, False)]
    assert events == [("dispatch", 0, 4), ("dispatch", 1, 4), ("decide", 0),
                      ("decide", 1), ("join", 0), ("join", 1)]
    assert search.phase_times["host_commit_work"] >= 0
