"""The plain reference of the device RD commit's re-decision
(perfbench/benchlib/commit_ref.py, over the frozen spec modules of
perfbench/vvcref) against the port's device engine on the CPU.

Sound encodes (64x64 and 96x64, two frames, QP 30 and 32, the refine
margin at its default, at 10 so that every split is a refine node and
merged leaves win, and off) read every number at 0; each planted fault
fails the number that judges it: the scan's trellis levels (K1) replaced
by the greedy quantizer's (K2), one block's luma mode swapped for its
runner-up, one block's chroma choice flipped, one coded level changed by
one after the scan. The reference's trellis is the spec trellis of
vvcref (DepQuantizer), up to the sign of the distortion it documents, and
its candidate lists are the ones the search handed the commit.
"""
import copy
import functools
import os
import sys

import numpy as np
import pytest
import torch

PERFBENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "perfbench")
if PERFBENCH not in sys.path:
    sys.path.append(PERFBENCH)

from benchlib import capture, commit_ref  # noqa: E402
from vvcref.core.config import RateModelConfig  # noqa: E402
from vvcref.spec import quant as spec_quant  # noqa: E402

from wrenc_tpu_torch.core.config import EncoderConfig  # noqa: E402
from wrenc_tpu_torch.encoder import Encoder  # noqa: E402
from wrenc_tpu_torch.kernels import quantize as kq  # noqa: E402
from wrenc_tpu_torch.kernels import trellis as ktr  # noqa: E402
from wrenc_tpu_torch.search import WavefrontSearch, wavefront  # noqa: E402

from tests.test_entropy_roundtrip import synth_frame  # noqa: E402

torch.set_num_threads(1)

CONFIG = {"encoder_config": {"log2_ctu_size": 5, "cclm_enabled": True}}
# (width, height, qp, split_refine_margin; None: the rate model's)
CASES = [(64, 64, 30, None), (96, 64, 32, 10.0), (64, 64, 32, 0.0)]


def _encode(w, h, qp, margin, seed=40):
    """A CPU encode of two frames by the device engine, with what luma
    stage A handed on kept as the harness keeps it: (frames, stream, the
    search's results [(trees, recon)], the kept stage-A outputs, cfg)."""
    cfg = EncoderConfig(width=w, height=h, qp=qp)
    if margin is not None:
        cfg.rate_model.split_refine_margin = margin
    frames = [synth_frame(w, h, seed=seed + k) for k in range(2)]
    search = WavefrontSearch(cfg, commit_engine="device", device="cpu")
    results = []
    encode_frames = search.encode_frames
    search.encode_frames = lambda f: results.append(encode_frames(f)) or \
        results[-1]
    cap = capture.StageACapture(wavefront).install()
    try:
        cap.active = True
        stream, _ = Encoder(cfg, search=search).encode(frames)
        kept = capture.StageACapture.fetch(cap.take())
    finally:
        cap.uninstall()
    return frames, stream, results[0], kept, cfg


def _judge(frames, stream, kept, qp, details=None):
    return commit_ref.numbers(frames, stream, [0, 1],
                              commit_ref.cand_rows(kept, frames), qp, CONFIG,
                              None, np.random.default_rng(0), details)


class _Fixed:
    """A search that hands back fixed results: the stream of edited
    decisions, as CABAC codes them."""

    def __init__(self, results):
        self.results = results

    def encode_frames(self, frames):
        return self.results


def _recode(cfg, frames, results):
    return Encoder(cfg, search=_Fixed(results)).encode(frames)[0]


def _leaves(trees):
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


def _find(results, pic, b):
    """The CU of picture `pic` that the recorded block b is."""
    (cu,) = [cu for cu in _leaves(results[pic][0])
             if (cu.x, cu.y, cu.log2, cu.tree)
             == (b["x"], b["y"], b["log2"], b["tree"])]
    return cu


@functools.lru_cache(maxsize=None)
def _sound(w, h, qp, margin):
    frames, stream, results, kept, cfg = _encode(w, h, qp, margin)
    details = []
    n = _judge(frames, stream, kept, qp, details)
    return {"frames": frames, "stream": stream, "results": results,
            "kept": kept, "cfg": cfg, "qp": qp, "margin": margin,
            "numbers": n, "details": details}


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "x".join(
    map(str, c)))
def sound(request):
    return _sound(*request.param)


def test_the_reference_reads_the_engine_sound(sound):
    n = sound["numbers"]
    assert n["commit_levels_differing"] == 0
    assert n["commit_picks_differing"] == 0
    assert 0 <= n["commit_cost_gap"] <= commit_ref.LIMITS["commit_cost_gap"]
    # every coded block was judged, luma picks and chroma choices alike
    d = sound["details"]
    assert len(d) == sum(len(_leaves(t)) for t, _ in sound["results"])
    assert any("luma" in x for x in d) and any("chroma" in x for x in d)
    assert any(x["block"]["chroma"] >= 81 for x in d)
    if sound["margin"] == 10.0:
        # every split was a refine node, so each single-tree leaf is a
        # merged leaf that won in the scan
        assert any(x["block"]["tree"] == "S" for x in d)


def test_the_candidate_lists_are_the_ones_the_commit_got(sound):
    """The reference's commit_candidates at every coded luma block equal
    the list the search handed the engine (cu.cands)."""
    frames, kept = sound["frames"], sound["kept"]
    rows = commit_ref.cand_rows(kept, frames)
    prune = RateModelConfig().rd_commit_prune_margin
    W = frames[0][0].shape[1]
    seen = 0
    for k, (trees, _) in enumerate(sound["results"]):
        for cu in _leaves(trees):
            if cu.tree == "C":
                continue
            s = 1 << cu.log2
            ranked, top2 = rows[(k, s)]
            bi = (cu.y // s) * (W // s) + cu.x // s
            want = commit_ref.commit_candidates(ranked[bi:bi + 1],
                                                top2[bi:bi + 1], prune)[0]
            assert list(want) == [int(m) for m in cu.cands]
            seen += 1
    assert seen > 0


@pytest.fixture(scope="module")
def case64():
    c = _sound(*CASES[0])
    return c["frames"], c["results"], c["kept"], c["cfg"], c["details"]


def test_k2_levels_in_the_scan_fail_the_levels(monkeypatch):
    """The scan's trellis (K1) replaced by the greedy quantizer (K2) at the
    same tables: its levels are not the trellis's."""
    def greedy(jobs, lam_dq, lv):
        return [kq.greedy_depquant(t, ls, bd, lam_dq, lg, lv)
                for t, ls, bd, lg in jobs]
    monkeypatch.setattr(ktr, "trellis_rate_batch", greedy)
    frames, stream, _, kept, _ = _encode(64, 64, 30, None)
    n = _judge(frames, stream, kept, 30)
    assert n["commit_levels_differing"] > 0


def _gap(costs, mode):
    return commit_ref._gap(costs[mode], min(costs.values()))


def test_a_luma_runner_up_fails_the_picks(case64):
    frames, results, kept, cfg, details = case64
    # the block whose runner-up costs most over its winner
    best = max((d for d in details if "luma" in d and len(d["luma"]) > 1),
               key=lambda d: sorted(d["luma"].values())[1]
               - min(d["luma"].values()))
    runner_up = sorted(best["luma"], key=best["luma"].get)[1]
    assert _gap(best["luma"], runner_up) > commit_ref.LIMITS["commit_cost_gap"]
    res = copy.deepcopy(results)
    cu = _find(res, best["pic"], best["block"])
    if cu.tree == "S" and cu.chroma_mode == cu.luma_mode:
        cu.chroma_mode = runner_up           # the derived chroma follows
    cu.luma_mode = runner_up
    n = _judge(frames, _recode(cfg, frames, res), kept, 30)
    assert n["commit_picks_differing"] > 0


def test_a_flipped_chroma_choice_fails_the_picks(case64):
    frames, results, kept, cfg, details = case64
    best = max((d for d in details if len(d.get("chroma", {})) == 2),
               key=lambda d: max(d["chroma"].values())
               - min(d["chroma"].values()))
    other = next(m for m in best["chroma"] if m != best["block"]["chroma"])
    assert _gap(best["chroma"], other) > commit_ref.LIMITS["commit_cost_gap"]
    res = copy.deepcopy(results)
    _find(res, best["pic"], best["block"]).chroma_mode = other
    n = _judge(frames, _recode(cfg, frames, res), kept, 30)
    assert n["commit_picks_differing"] > 0


def test_a_level_changed_by_one_fails_the_levels(case64):
    """One coded level one higher after the scan: the DC level of a
    transform block, the last in coding order, so that no other level's
    state changes; CABAC codes it as it stands."""
    frames, results, kept, cfg, _ = case64
    res = copy.deepcopy(results)
    cu, c = next((cu, c) for cu in _leaves(res[0][0])
                 for c in range(3) if cu.coeffs[c] is not None
                 and cu.coeffs[c][0, 0] != 0)
    q = np.array(cu.coeffs[c])
    q[0, 0] += 2 * np.sign(q[0, 0])          # |q| = 2a - delta -> a + 1
    cu.coeffs[c] = q
    n = _judge(frames, _recode(cfg, frames, res), kept, 30)
    assert n["commit_levels_differing"] >= 1


def _random_blocks(rng, log2, n):
    s = 1 << log2
    scale = rng.choice([4, 30, 200], size=(n, 1, 1))
    decay = 1.0 / (1 + np.add.outer(np.arange(s), np.arange(s)))
    return np.round(rng.laplace(size=(n, s, s)) * scale * decay).astype(
        np.int64)


@pytest.mark.parametrize("log2,n", [(2, 40), (3, 12), (4, 4), (5, 1)])
def test_the_trellis_is_the_spec_trellis(log2, n):
    """commit_ref.trellis against vvcref's spec trellis (DepQuantizer,
    trellis mode) on non-negative coefficients, where the spec's signed
    distortion is the magnitude's; on negated blocks the reference's
    levels are the negated levels (the distortion of a level's
    magnitude). Its rate is the commit's level rate of the spec levels."""
    rng = np.random.default_rng(log2)
    rm = RateModelConfig()
    prm = commit_ref.Params(31)
    dq = spec_quant.DepQuantizer(rm)
    for c_idx in (0, 1):
        qpar = prm.qpar(c_idx, log2)
        t = np.abs(_random_blocks(rng, log2, n))
        q, rate = commit_ref.trellis(t, qpar, prm)
        qn, raten = commit_ref.trellis(-t, qpar, prm)
        assert (qn == -q).all() and (raten == rate).all()
        for b in range(n):
            want = dq.quantize(t[b], prm.qp if c_idx == 0 else prm.qp_c,
                               qpar, trellis=True)
            assert (q[b] == want).all()
            a, _ = spec_quant.abs_levels_from_q(want, log2, log2)
            order = spec_quant.full_scan(log2, log2)[::-1]
            r, trailing = 0, True
            for x, y in order:
                trailing = trailing and a[y, x] == 0
                r += 0 if trailing else int(prm.lv[min(a[y, x], 1023)])
            assert r == rate[b]
