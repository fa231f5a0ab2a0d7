"""The 1080p device commit cell (b1080p_qp32_device_commit): its files
load by name with its five metrics, its readers read a canned record and
nothing where their inputs are missing, commit_check.py runs the commit's
reference through the harness's window under the cell's plan (one scan
per stage-A chunk, several chunks per call, the scans in the commit
worker; on the CPU at a tiny size), and on the card every graph capture
of a call is one device_commit_capture span."""
import json
import os
import subprocess
import sys

import pytest

from benchlib import commit_ref, spec, tracing

ROOT = os.path.dirname(spec.PERFBENCH)
CELL = "b1080p_qp32_device_commit"
METRICS = {"commit_capture_ms_per_frame.devcommit1080",
           "commit_scan_wait_ms_per_frame.devcommit1080",
           "commit_host_ms_per_frame.devcommit1080",
           "commit_wait_pct.devcommit1080",
           "device_idle_pct.devcommit1080"}
SEED = 3_200_000_021


def test_the_cell_loads_with_its_metrics():
    b = spec.load_benchmark(ROOT)
    c = spec.cell(b, CELL, ROOT)
    b1080 = spec.cell(b, "b1080p_qp32_clip2", ROOT)
    assert c["chips"] == 1
    assert c["config"]["search"] == {"commit_engine": "device"}
    assert c["config"]["encoder_config"] == b1080["config"]["encoder_config"]
    assert c["config"]["picture"] == b1080["config"]["picture"]
    assert c["config"]["reduced"] == []
    assert {m["name"] for m, _ in c["per_layer"]} == METRICS
    assert {m["name"] for m, _ in c["end_to_end"]} == {"encode_fps",
                                                        "setup_s"}
    t = c["traffic"]
    assert (t["frames_per_call"], t["qp"], t["pool_frames"]) == (8, 32, 24)
    assert (t["check_calls"], t["check_pictures"]) == (1, 2)
    assert t["content"] == b1080["traffic"]["content"]


def _ev(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def canned():
    """A window of 10 s, busy 2 s; the program's sums for 2 calls of 8
    frames, 4 s of wall time each."""
    mark = "void at::native::vectorized_elementwise_kernel<4, add>(int)"
    ev = [_ev(mark, 0, 1), _ev(mark, 10_000_000, 1),
          _ev("void dq_trellis_kernel<8>(K1Desc)", 1_000, 2_000_000 - 2)]
    phases = {"device_commit_schedule": 0.4, "device_commit_scan": 3.2,
              "device_commit_capture": 0.8, "device_commit_fetch": 1.6,
              "device_commit_writeback": 0.24, "host_commit": 2.0,
              "n_commit_graph_captures": 12, "n_commit_steps": 3_700}
    return {"frames": 16, "wall_s": 8.0,
            "calls": [(0.0, 4.0, 8), (4.0, 8.0, 8)], "phases": phases,
            "trace": tracing.reduce(sorted(ev, key=lambda e: e["ts"]))}


def metric(name, record):
    return spec.load_reader("layer_metrics", name).read(record)


def test_the_readers_on_a_canned_record():
    r = canned()
    assert metric("commit_capture_ms_per_frame.devcommit1080", r) == \
        pytest.approx(800 / 16)
    assert metric("commit_scan_wait_ms_per_frame.devcommit1080", r) == \
        pytest.approx(1600 / 16)
    assert metric("commit_host_ms_per_frame.devcommit1080", r) == \
        pytest.approx(640 / 16)
    assert metric("commit_wait_pct.devcommit1080", r) == pytest.approx(25.0)
    assert metric("device_idle_pct.devcommit1080", r) == pytest.approx(
        100 * (1 - 2.0 / 10.0), abs=1e-3)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_the_readers_read_nothing_without_their_inputs(name):
    r = canned()
    if name.startswith("device_idle"):
        assert metric(name, dict(r, trace=None)) is None
    else:
        assert metric(name, dict(r, phases={})) is None


def test_the_capture_reader_without_captures_or_without_the_span():
    """No capture in the window reads 0; captures without the span (a
    program that lacks it) read nothing."""
    name = "commit_capture_ms_per_frame.devcommit1080"
    r = canned()
    none = dict(r["phases"], n_commit_graph_captures=0)
    del none["device_commit_capture"]
    assert metric(name, dict(r, phases=none)) == 0.0
    lacking = dict(r["phases"])
    del lacking["device_commit_capture"]
    assert metric(name, dict(r, phases=lacking)) is None


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A checkout's benchmark files with one more cell: the 1080p device
    commit configuration at 64x64, 2 frames per call."""
    root = tmp_path_factory.mktemp("checkout")
    (root / "perfbench").mkdir()
    for d in ("configs", "traffic"):
        (root / "perfbench" / d).mkdir()
    conf = json.load(open(os.path.join(
        spec.PERFBENCH, "configs", "ai_class_b_1080p_device_commit.json")))
    conf.update(picture=[64, 64], encoder_config=dict(
        conf["encoder_config"], width=64, height=64))
    (root / "perfbench" / "configs" / "tiny_dc1080.json").write_text(
        json.dumps(conf))
    t = json.load(open(os.path.join(spec.PERFBENCH, "traffic",
                                    "clip8_qp32.json")))
    (root / "perfbench" / "traffic" / "tiny2_qp32.json").write_text(
        json.dumps(dict(t, frames_per_call=2, pool_frames=4,
                        check_blocks_per_size=4)))
    for d in ("end_to_end", "layer_metrics"):
        os.symlink(os.path.join(spec.PERFBENCH, d), root / "perfbench" / d)
    b = spec.load_benchmark(ROOT)
    b["configs"].append({"name": "tiny_dc1080", "source": "test",
                         "file": "perfbench/configs/tiny_dc1080.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny_dc1080_qp32",
                           "config": "tiny_dc1080", "traffic": "tiny2_qp32",
                           "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


def test_commit_check_runs_under_the_1080p_plan_on_the_cpu(tiny_root,
                                                           monkeypatch):
    """At 64x64 the plan of 1080p: one-frame stage-A chunks (as 4-frame
    chunks are at 1080p), each committed in a scan of its own in the
    commit worker, two per call."""
    import torch
    import commit_check
    from wrenc_tpu_torch.search import WavefrontSearch
    torch.set_num_threads(1)
    monkeypatch.setattr(WavefrontSearch, "DEVICE_BATCH_BUCKETS", (1,))
    monkeypatch.setattr(WavefrontSearch, "_commit_group_frames",
                        lambda self: 1)
    scans = []
    work = WavefrontSearch._commit_work

    def counted(self, batch, *a):
        scans.append(len(batch))
        return work(self, batch, *a)
    monkeypatch.setattr(WavefrontSearch, "_commit_work", counted)
    r = commit_check.run(str(tiny_root), "tiny_dc1080_qp32", SEED, 0.5,
                         device="cpu")
    assert r["calls"] >= 1 and r["passes"] is True
    assert scans == [1] * 2 * (r["calls"] + 1)     # the warm-up call too
    assert r["numbers"]["commit_levels_differing"] == 0
    assert r["numbers"]["commit_picks_differing"] == 0
    assert 0 <= r["numbers"]["commit_cost_gap"] <= \
        commit_ref.LIMITS["commit_cost_gap"]


def card_capture_spans():
    """One 8-frame call of the cell on the card, the recorder on: one JSON
    line with the capture spans, the scan spans and phase_times."""
    from benchlib import content
    from wrenc_tpu_torch import trace
    from wrenc_tpu_torch.core.config import EncoderConfig
    from wrenc_tpu_torch.encoder import Encoder
    from wrenc_tpu_torch.search import WavefrontSearch
    c = spec.cell(spec.load_benchmark(ROOT), CELL, ROOT)
    config, traffic = c["config"], c["traffic"]
    cfg = EncoderConfig(**dict(config["encoder_config"], qp=traffic["qp"]))
    frames = content.make_frames(
        traffic["content"], tuple(config["picture"]), (cfg.width, cfg.height),
        traffic["frames_per_call"], content.seed_sequence(SEED, 0))
    enc = Encoder(cfg, search=WavefrontSearch(cfg, **config["search"]))
    trace.enable()
    enc.encode(frames)
    d = trace.drain()
    keep = ("device_commit_capture", "device_commit_scan")
    print(json.dumps({"spans": [s for s in d["spans"] if s["name"] in keep],
                      "phases": enc.phase_times}, default=list))


@pytest.mark.card
def test_one_capture_span_per_captured_graph(card):
    """In a call that captures, the capture spans are as many as
    n_commit_graph_captures, each inside a scan span of its call and
    chunk, their seconds summed in phase_times. In a process of its own,
    as the graphs test runs its card encodes."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, "-c", "import test_perfbench_devcommit1080 as t; "
         "t.card_capture_spans()"], cwd=here, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [here, spec.PERFBENCH, ROOT])))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    ph = r["phases"]
    caps = [s for s in r["spans"] if s["name"] == "device_commit_capture"]
    scans = {s["id"]: s for s in r["spans"]
             if s["name"] == "device_commit_scan"}
    assert len(scans) == 2
    assert len(caps) == ph["n_commit_graph_captures"] > 0
    for s in caps:
        p = scans[s["parent"]]
        assert (s["call"], s["chunk"], s["thread"]) == \
            (p["call"], p["chunk"], p["thread"])
        assert p["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= p["t1_ns"]
        assert s["attrs"]["shape"]
    assert ph["device_commit_capture"] == pytest.approx(
        sum((s["t1_ns"] - s["t0_ns"]) * 1e-9 for s in caps), abs=1e-6)
