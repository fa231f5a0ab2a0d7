"""The device commit engine's spans and counters on a tiny CPU encode:
its four phases are spans of the call and chunk they commit, its counts
(rank steps, K1 launches and their positions) reach phase_times and the
scan span's attributes, equal to counts taken around the scan's own
calls, and do so from the worker thread where a call commits in several
scans. The recorder changes no byte of the stream."""
import numpy as np
import pytest
import torch

from wrenc_tpu_torch import trace
from wrenc_tpu_torch.core.config import EncoderConfig
from wrenc_tpu_torch.encoder import Encoder
from wrenc_tpu_torch.kernels import trellis as ktr
from wrenc_tpu_torch.search import WavefrontSearch
from wrenc_tpu_torch.search import device_commit as dc

from tests.test_entropy_roundtrip import synth_frame

torch.set_num_threads(1)

SPANS = ("device_commit_schedule", "device_commit_scan",
         "device_commit_fetch", "device_commit_writeback")
COUNTS = ("n_commit_steps", "n_dq_trellis_launches", "n_dq_trellis_positions")


def _run(monkeypatch, n_frames, group=None):
    """Two CPU encodes of n_frames 64x64 frames by the device engine, the
    recorder on for the first: (streams, phase_times of the first, drained
    spans, counts taken by wrapping the scan's step and K1's entry)."""
    if group:
        # one-frame stage-A chunks, committed `group` frames per scan
        monkeypatch.setattr(WavefrontSearch, "DEVICE_BATCH_BUCKETS", (1,))
        monkeypatch.setattr(WavefrontSearch, "_commit_group_frames",
                            lambda self: group)
    seen = {k: 0 for k in COUNTS}
    batch, step = ktr.trellis_rate_batch, dc.RdScan._step

    def counted_batch(jobs, lam_dq, lv):
        seen["n_dq_trellis_launches"] += 1
        seen["n_dq_trellis_positions"] += sum(
            t.shape[0] * t.shape[1] * t.shape[2] for t, _, _, _ in jobs)
        return batch(jobs, lam_dq, lv)

    def counted_step(self, live):
        seen["n_commit_steps"] += 1
        return step(self, live)
    monkeypatch.setattr(ktr, "trellis_rate_batch", counted_batch)
    monkeypatch.setattr(dc.RdScan, "_step", counted_step)
    cfg = EncoderConfig(width=64, height=64, qp=32)
    enc = Encoder(cfg, search=WavefrontSearch(cfg, commit_engine="device",
                                              device="cpu"))
    frames = [synth_frame(64, 64, seed=60 + k) for k in range(n_frames)]
    try:
        trace.enable()
        stream, _ = enc.encode(frames)
        d = trace.drain()
    finally:
        trace.disable()
    counted = dict(seen)
    phases = dict(enc.phase_times)
    again, _ = enc.encode(frames)
    return (stream, again), phases, d, counted


@pytest.mark.parametrize("case", ["one_scan", "two_scans_in_the_worker"])
def test_device_commit_spans_and_counts(case, monkeypatch):
    two = case == "two_scans_in_the_worker"
    (stream, again), phases, d, counted = _run(monkeypatch, 2,
                                               group=1 if two else None)
    assert stream == again
    (root,) = [s for s in d["spans"] if s["name"] == "encode"]
    by_id = {s["id"]: s for s in d["spans"]}
    mine = [s for s in d["spans"] if s["name"] in SPANS]
    assert len(mine) == 4 * (2 if two else 1)
    # each phase nests in the commit that ran it: the worker's
    # host_commit_work with two scans, else the main thread's host_commit
    parent = "host_commit_work" if two else "host_commit"
    for s in mine:
        p = by_id[s["parent"]]
        assert p["name"] == parent and p["thread"] == s["thread"]
        assert s["call"] == root["call"] and s["chunk"] == p["chunk"]
        assert (s["thread"] != root["thread"]) == two
    assert sorted(s["chunk"] for s in mine
                  if s["name"] == "device_commit_scan") == ([0, 1] if two
                                                            else [0])
    # the counts: in phase_times, summed over the scans, and each scan's
    # on its span; equal to the counts taken around the calls
    assert all(counted[k] > 0 for k in COUNTS)
    assert {k: phases[k] for k in COUNTS} == counted
    scans = [s for s in mine if s["name"] == "device_commit_scan"]
    assert {k: sum(s["attrs"][k] for s in scans) for k in COUNTS} == counted
    for name in SPANS:
        secs = sum((s["t1_ns"] - s["t0_ns"]) * 1e-9 for s in mine
                   if s["name"] == name)
        assert phases[name] == pytest.approx(secs, abs=1e-6)
    assert isinstance(phases["n_commit_steps"], int)


def test_the_counts_without_the_recorder(monkeypatch):
    """Recorder off: the spans' seconds and the counts still reach
    phase_times, every count an integer."""
    cfg = EncoderConfig(width=64, height=64, qp=32)
    enc = Encoder(cfg, search=WavefrontSearch(cfg, commit_engine="device",
                                              device="cpu"))
    enc.encode([synth_frame(64, 64, seed=70)])
    ph = enc.phase_times
    assert set(SPANS) | set(COUNTS) <= set(ph)
    assert all(isinstance(ph[k], int) and ph[k] > 0 for k in COUNTS)
    assert all(isinstance(ph[k], float) for k in SPANS)
    assert trace.drain()["spans"] == []
    assert np.isfinite(sum(ph[k] for k in SPANS))


def test_the_graph_and_row_counts():
    """Every count of the scan (dc.COUNTS: the three above, the graphs
    captured and replayed, the schedule's and the padded rows) is an
    integer of phase_times and an attribute of the scan span, equal.
    Off CUDA the steps run eagerly: nothing captured or replayed."""
    cfg = EncoderConfig(width=64, height=64, qp=32)
    enc = Encoder(cfg, search=WavefrontSearch(cfg, commit_engine="device",
                                              device="cpu"))
    try:
        trace.enable()
        enc.encode([synth_frame(64, 64, seed=71)])
        d = trace.drain()
    finally:
        trace.disable()
    ph = enc.phase_times
    (scan,) = [s for s in d["spans"] if s["name"] == "device_commit_scan"]
    assert {k: scan["attrs"][k] for k in dc.COUNTS} == \
        {k: ph[k] for k in dc.COUNTS}
    assert all(isinstance(ph[k], int) for k in dc.COUNTS)
    assert ph["n_commit_graph_captures"] == ph["n_commit_graph_replays"] == 0
    assert ph["n_commit_rows_live"] > 0 and ph["n_commit_rows_padded"] > 0
