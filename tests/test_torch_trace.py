"""The port's span and counter recorder (wrenc_tpu_torch/trace.py) on a
tiny CPU encode: ten 64x64 frames make two stage-A chunks (8 + 2 frames),
so the commit of chunk 0 runs in the worker thread under chunk 1's
decide. Spans nest, carry their call id, sum to phase_times; K2's counted
launch shapes follow the chunking; the recorder off records nothing and
leaves phase_times and the stream as they were."""
import json
import sys
import threading

import numpy as np
import pytest
import torch

from wrenc_tpu_torch import trace
from wrenc_tpu_torch.core.config import EncoderConfig
from wrenc_tpu_torch.encoder import Encoder
from wrenc_tpu_torch.kernels import refs
from wrenc_tpu_torch.search import WavefrontSearch

W = H = 64
N_FRAMES = 10
# the phases of a two-chunk call, as phase_times has named them
PHASES = {"device_dispatch", "device_stage_a", "host_select",
          "host_chroma_rd", "host_decide", "host_commit",
          "host_commit_work", "host_entropy"}


def _frames(seed):
    rng = np.random.default_rng(seed)
    y = np.clip(np.add.outer(np.arange(H), np.arange(W)) * 2
                + rng.integers(0, 40, (H, W)), 0, 255).astype(np.uint8)
    c = rng.integers(90, 160, (2, H // 2, W // 2)).astype(np.uint8)
    return (y, c[0], c[1])


@pytest.fixture(scope="module")
def runs():
    """Two encodes with the recorder on (drained after each) and one with
    it off: {'on': [(stream, phase_times, drained)] * 2, 'off': ...}."""
    cfg = EncoderConfig(width=W, height=H, qp=32)
    frames = [_frames(k) for k in range(N_FRAMES)]
    enc = Encoder(cfg, search=WavefrontSearch(cfg, device="cpu"))
    out = {"on": []}
    try:
        trace.enable()
        for _ in range(2):
            stream, _ = enc.encode(frames)
            out["on"].append((stream, dict(enc.phase_times), trace.drain()))
    finally:
        trace.disable()
    stream, _ = enc.encode(frames)
    out["off"] = (stream, dict(enc.phase_times), trace.drain())
    out["search"] = enc.search
    return out


def _calls(drained):
    return [s for s in drained["spans"] if s["name"] == "encode"]


def test_spans_nest_under_their_parents(runs):
    for _, _, d in runs["on"]:
        by_id = {s["id"]: s for s in d["spans"]}
        (root,) = _calls(d)
        assert root["parent"] is None and root["chunk"] is None
        for s in d["spans"]:
            if s["parent"] is None:
                # the root, the worker thread's commit and set-up work
                # outside any call have no parent
                assert s["name"] in ("encode", "host_commit_work",
                                     "setup_tables")
                continue
            p = by_id[s["parent"]]
            assert p["thread"] == s["thread"]
            assert p["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= p["t1_ns"]
            if s["name"] in PHASES:
                assert p is root
        worker = [s for s in d["spans"] if s["name"] == "host_commit_work"]
        assert len(worker) == 2
        assert all(s["thread"] != root["thread"] for s in worker)
        assert all(root["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= root["t1_ns"]
                   for s in worker)


def test_every_span_carries_its_call_id(runs):
    ids = []
    for _, _, d in runs["on"]:
        (root,) = _calls(d)
        ids.append(root["call"])
        in_call = [s for s in d["spans"]
                   if root["t0_ns"] <= s["t0_ns"] <= root["t1_ns"]]
        assert {s["call"] for s in in_call} == {root["call"]}
        assert "host_commit_work" in {s["name"] for s in in_call}
        assert {c["call"] for c in d["counters"]} == {root["call"]}
    assert ids[1] == ids[0] + 1


def test_chunks_of_the_phases(runs):
    _, _, d = runs["on"][1]
    chunks = {}
    for s in d["spans"]:
        if s["name"] in PHASES - {"host_entropy"}:
            chunks.setdefault(s["name"], []).append(s["chunk"])
    for name in PHASES - {"host_entropy"}:
        assert sorted(chunks[name]) == [0, 1], name
    # chunk 1 is dispatched before chunk 0 is decided
    order = [(s["name"], s["chunk"]) for s in
             sorted(d["spans"], key=lambda s: s["t0_ns"])
             if s["name"] in ("device_dispatch", "host_decide")]
    assert order == [("device_dispatch", 0), ("device_dispatch", 1),
                     ("host_decide", 0), ("host_decide", 1)]


def test_span_sums_equal_phase_times(runs):
    for _, phases, d in runs["on"]:
        sums, device = {}, 0.0
        for s in d["spans"]:
            if s["name"] in PHASES:
                sums[s["name"]] = sums.get(s["name"], 0.0) + (
                    s["t1_ns"] - s["t0_ns"]) * 1e-9
            device += s["attrs"].get("device_ms", 0.0) * 1e-3
        assert set(sums) == PHASES
        for name, v in sums.items():
            assert phases[name] == pytest.approx(v, abs=1e-6), name
        assert phases["stage_a_device"] == pytest.approx(device, abs=1e-6)
        assert phases["stage_a_device"] > 0


def test_phase_times_keys_with_the_recorder_off_and_on(runs):
    assert set(runs["off"][1]) == PHASES
    for _, phases, _ in runs["on"]:
        assert set(phases) == PHASES | {"stage_a_device"}
    assert all(isinstance(v, float) for v in runs["off"][1].values())


def test_the_recorder_off_records_nothing(runs):
    stream, _, d = runs["off"]
    assert d["spans"] == [] and d["counters"] == []
    assert runs["search"]._dispatch_stage_a([_frames(0)])[4] == (None, None)
    # the recorder changes no byte of the stream
    assert stream == runs["on"][0][0] == runs["on"][1][0]
    assert trace.device_mark(runs["search"].device) is None
    with trace.span("x", {}) as sp:
        assert sp.rec is None
    assert trace.drain()["spans"] == []


def test_k2_shapes_follow_buckets_and_sizes(runs):
    search = runs["search"]
    K = 6                 # stage_a_num_rd_cands (4) + PLANAR and DC
    max_b = search._buckets()[-1]
    want = {}
    for k, n in enumerate([max_b, N_FRAMES - max_b]):
        F = search._bucket(n)
        want[k] = sorted((s * s, F * (W // s) * (H // s) * K)
                         for s in search._sizes())
    for _, _, d in runs["on"]:
        got = {}
        for c in d["counters"]:
            assert c["kernel"] == "dq_greedy" and c["device"] == "cpu"
            assert len(c["jobs"]) == 1
            got.setdefault(c["chunk"], []).extend(
                [tuple(c["jobs"][0])] * c["count"])
        assert {k: sorted(v) for k, v in got.items()} == want


def test_a_table_build_is_one_span_per_cache_miss():
    args = (72, 56, 8, 1)                 # a geometry no other test builds
    refs.block_grid.cache_clear()
    try:
        trace.enable()
        refs.block_grid(*args)
        refs.block_grid(*args)
        spans = trace.drain()["spans"]
    finally:
        trace.disable()
    assert [(s["name"], s["attrs"]) for s in spans] == [
        ("setup_tables", {"table": "block_grid"})]


def test_spans_export_on_the_chrome_trace_axis(tmp_path):
    try:
        trace.enable()
        with trace.call():
            with trace.span("outer", chunk=3, note="n"):
                pass
        d = trace.drain()
    finally:
        trace.disable()
    base = 1_700_000_000_000_000_000
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": base,
                                "traceEvents": [{"ph": "X", "ts": 1.0}]}))
    events = trace.merge_chrome_trace(str(path), d)
    doc = json.loads(path.read_text())
    assert doc["traceEvents"][1:] == events and len(events) == 2
    outer = next(e for e in events if e["name"] == "outer")
    s = next(s for s in d["spans"] if s["name"] == "outer")
    assert outer["args"]["chunk"] == 3 and outer["args"]["note"] == "n"
    assert outer["args"]["call"] == s["call"] is not None
    unix_us = (s["t0_ns"] + d["unix_offset_ns"]) * 1e-3
    assert outer["ts"] + base * 1e-3 == pytest.approx(unix_us, abs=1.0)
    assert outer["dur"] == pytest.approx((s["t1_ns"] - s["t0_ns"]) * 1e-3)


def test_threads_record_their_own_spans_and_counts():
    """More threads than cores, switching often: every span and count of
    each thread is kept, under its own call and parents."""
    n_threads, n_spans = 16, 200
    t = torch.zeros((3, 4, 4))
    errors = []

    def work():
        try:
            with trace.call():
                for i in range(n_spans):
                    with trace.span("s", chunk=i):
                        trace.count("k", "cpu", (t,))
        except Exception as e:          # reported below, with the thread
            errors.append(e)
    interval = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)
        trace.enable()
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        d = trace.drain()
    finally:
        sys.setswitchinterval(interval)
        trace.disable()
    assert errors == []
    roots = {s["id"]: s for s in d["spans"] if s["name"] == "encode"}
    assert len(roots) == n_threads
    assert len({r["call"] for r in roots.values()}) == n_threads
    inner = [s for s in d["spans"] if s["name"] == "s"]
    assert len(inner) == n_threads * n_spans
    for s in inner:
        root = roots[s["parent"]]
        assert s["thread"] == root["thread"] and s["call"] == root["call"]
    assert sorted((c["call"], c["chunk"]) for c in d["counters"]) == sorted(
        (r["call"], i) for r in roots.values() for i in range(n_spans))
    assert {(c["count"], tuple(map(tuple, c["jobs"])))
            for c in d["counters"]} == {(1, ((16, 3),))}
