"""The native tree commit's CTU-row wavefront (wrenc_commit_frames_tree):
the same decided trees of CIF frames, committed over 1, 2, 3 and 8
threads, five times over, give the one-thread run's reconstruction,
coefficients, modes and refine decisions; the per-CTU stream offsets add
up to each frame's; the thread count follows the process's cores; the
commit's span carries the wavefront's counts only with the recorder on."""
import copy
import functools

import numpy as np
import pytest
import torch

from wrenc_tpu_torch import trace
from wrenc_tpu_torch.core.config import EncoderConfig
from wrenc_tpu_torch.encoder import Encoder
from wrenc_tpu_torch.entropy import native
from wrenc_tpu_torch.entropy.native import loader
from wrenc_tpu_torch.search import WavefrontSearch

from tests.test_entropy_roundtrip import synth_frame

torch.set_num_threads(1)

W, H = 352, 288
N_ROWS, N_COLS = H // 32, W // 32
THREADS = (1, 2, 3, 8)
REPEATS = 5


def _frame(seed):
    """A gradient with noise, overlaid with flat and noisy rectangles, so
    that the trees mix sizes, refine nodes and CCLM."""
    rng = np.random.default_rng(seed)
    y, cb, cr = synth_frame(W, H, seed=seed)
    y = y.astype(np.int32)
    for _ in range(12):
        x0, y0 = rng.integers(0, W - 32), rng.integers(0, H - 32)
        sw, sh = rng.integers(8, 96), rng.integers(8, 96)
        patch = y[y0:y0 + sh, x0:x0 + sw]
        patch[...] = (rng.integers(0, 256) + rng.integers(0, 2)
                      * rng.integers(-40, 41, patch.shape))
    return np.clip(y, 0, 255).astype(np.uint8), cb, cr


@functools.lru_cache(maxsize=None)
def _decided(qp):
    """(search, frames, trees) of three CIF frames decided at `qp`, not
    yet committed."""
    search = WavefrontSearch(EncoderConfig(width=W, height=H, qp=qp),
                             device="cpu")
    pending = search._dispatch_stage_a([_frame(40 + k) for k in range(3)], 0)
    batch, trees, _ = search._decide_chunk(pending, 0)
    return search, batch, trees


def _counts(n):
    """(nodes, refine nodes) of a tree in the commit's stream."""
    if getattr(n, "refine", False):
        kids = [_counts(c) for c in n.children]
        return (2 + sum(k[0] for k in kids), 1 + sum(k[1] for k in kids))
    if n.split:
        kids = [_counts(c) for c in n.children]
        return (1 + sum(k[0] for k in kids), sum(k[1] for k in kids))
    return (1, 0)


def _commit_args(monkeypatch, search, batch, trees):
    """The arguments the search's own commit (`_commit_all`) hands the
    native tree commit, taken from a run on deep copies of `trees`."""
    seen = []
    monkeypatch.setattr(native, "commit_frames_tree_native",
                        lambda *a: seen.append(a) or [None] * len(batch))
    search._commit_all(copy.deepcopy(trees), batch, None)
    (args,) = seen
    return args


@pytest.mark.parametrize("qp,n_frames", [(22, 1), (22, 3), (37, 1), (37, 3)])
def test_wavefront_commit_matches_one_thread(monkeypatch, qp, n_frames):
    search, batch, trees = _decided(qp)
    batch, trees = batch[:n_frames], trees[:n_frames]
    cfg, origs, all_trees, *tabs = _commit_args(monkeypatch, search, batch,
                                                trees)
    n_ctus = N_ROWS * N_COLS
    streams = loader.serialize_commit_trees(all_trees, n_ctus)
    node_off, dec_off = streams.ctu_node_off, streams.ctu_dec_off
    assert len(node_off) == len(dec_off) == n_frames * n_ctus + 1
    assert node_off[-1] == len(streams.nodes)
    assert (streams.nodes == -2).sum() == dec_off[-1] > 0
    for f, ts in enumerate(all_trees):
        counts = np.array([_counts(t) for t in ts])
        lo, hi = f * n_ctus, (f + 1) * n_ctus
        assert (np.diff(node_off[lo:hi + 1]) == counts[:, 0]).all()
        assert (np.diff(dec_off[lo:hi + 1]) == counts[:, 1]).all()
        alone = loader.serialize_commit_trees([ts], n_ctus)
        assert (alone.ctu_node_off == node_off[lo:hi + 1] - node_off[lo]).all()
        assert (alone.ctu_dec_off == dec_off[lo:hi + 1] - dec_off[lo]).all()

    # the native commit reads its streams only, so they serve every run
    want = loader.commit_tree_streams(cfg, origs, streams, *tabs,
                                      n_threads=1)
    assert want.threads == 1
    assert 0 < want.decisions.sum() < len(want.decisions)
    for _ in range(REPEATS):
        for n in THREADS:
            got = loader.commit_tree_streams(cfg, origs, streams, *tabs,
                                             n_threads=n)
            assert got.threads == min(n, n_frames * N_ROWS)
            for f in range(n_frames):
                for c in range(3):
                    assert (got.recons[f][c] == want.recons[f][c]).all()
            assert (got.coeffs == want.coeffs).all()
            assert (got.modes == want.modes).all()
            assert (got.decisions == want.decisions).all()


@pytest.mark.parametrize("cores,cpu_max,want", [
    (6, None, 6),               # no cgroup file
    (6, "max 100000", 6),       # no quota
    (6, "250000 100000", 3),    # 2.5 cores, rounded up
    (6, "50000 100000", 1),     # half a core
    (6, "800000 100000", 6),    # quota above the affinity
    (8, "not a quota", 8),      # unreadable: the affinity
])
def test_commit_thread_count(monkeypatch, tmp_path, cores, cpu_max, want):
    """The commit's threads: the process's CPU affinity, capped by the
    cgroup quota (the native call caps them at one per CTU row, as
    test_commit_span_attributes shows)."""
    monkeypatch.setattr(loader.os, "sched_getaffinity",
                        lambda pid: set(range(cores)))
    path = tmp_path / "cpu.max"
    if cpu_max is not None:
        path.write_text(cpu_max + "\n")
    assert loader.usable_cores(str(path)) == want


@pytest.mark.parametrize("recorder", ["on", "off"])
def test_commit_span_attributes(monkeypatch, recorder):
    """One 64x64 frame on 16 usable cores: the call's blocking host_commit
    span carries the threads used (one per CTU row: 2), their busy and
    lag-wait seconds with the recorder on; with it off nothing is
    recorded."""
    monkeypatch.setattr(loader.os, "sched_getaffinity",
                        lambda pid: set(range(16)))
    cfg = EncoderConfig(width=64, height=64, qp=32)
    enc = Encoder(cfg, search=WavefrontSearch(cfg, device="cpu"))
    frame = synth_frame(64, 64, seed=3)
    enc.encode([frame])  # the host tables' set-up, outside the spans read
    trace.drain()
    try:
        if recorder == "on":
            trace.enable()
        enc.encode([frame])
        drained = trace.drain()
    finally:
        trace.disable()
    commits = [s for s in drained["spans"] if s["name"] == "host_commit"]
    if recorder == "off":
        assert drained["spans"] == [] and commits == []
        return
    (span,) = commits
    a = span["attrs"]
    assert a["commit_threads"] == 2
    seconds = (span["t1_ns"] - span["t0_ns"]) * 1e-9
    assert 0 < a["commit_busy_s"] <= a["commit_threads"] * seconds
    assert 0 <= a["commit_lag_wait_s"] <= a["commit_threads"] * seconds
