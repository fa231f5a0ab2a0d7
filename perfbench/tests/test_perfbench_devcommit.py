"""The device commit cell (cif_qp32_device_commit): its files load by name,
its five readers read a canned record and nothing where their inputs are
missing, K1's yardstick holds at the launch shapes a CPU run counts, and
commit_check.py runs the commit's reference through the harness's window
(on the CPU at a tiny size; on the card at the cell's own)."""
import json
import os

import numpy as np
import pytest

from benchlib import commit_ref, roofline_k1, spec, tracing

ROOT = os.path.dirname(spec.PERFBENCH)
CELL = "cif_qp32_device_commit"
METRICS = {"commit_scan_issue_ms_per_frame.devcommit",
           "commit_scan_wait_ms_per_frame.devcommit",
           "commit_host_ms_per_frame.devcommit",
           "device_ops_per_commit_step.devcommit",
           "dq_trellis_roofline.devcommit"}
SEED = 3_160_000_017


def test_the_cell_loads_with_its_metrics():
    b = spec.load_benchmark(ROOT)
    c = spec.cell(b, CELL, ROOT)
    cif = spec.cell(b, "cif_qp22_clip16", ROOT)
    assert c["chips"] == 1
    assert c["config"]["search"] == {"commit_engine": "device"}
    assert c["config"]["encoder_config"] == cif["config"]["encoder_config"]
    assert c["config"]["reduced"] == []
    assert {m["name"] for m, _ in c["per_layer"]} == METRICS
    assert {m["name"] for m, _ in c["end_to_end"]} == {"encode_fps",
                                                        "setup_s"}
    t = c["traffic"]
    assert (t["frames_per_call"], t["qp"]) == (16, 32)
    assert t["content"] == cif["traffic"]["content"]


def _ev(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def canned(k1_launches=3, k1_us=500):
    """A window of 10 s with 3 K1 launches of k1_us each and 7 other
    device operations; the program's sums for 2 calls of 16 frames."""
    mark = "void at::native::vectorized_elementwise_kernel<4, add>(int)"
    ev = [_ev(mark, 0, 1), _ev(mark, 10_000_000, 1)]
    ev += [_ev("void dq_trellis_kernel<8>(K1Desc)", 100 + 1000 * i, k1_us)
           for i in range(k1_launches)]
    ev += [_ev("void at::native::index_put_kernel", 50_000 + 10 * i, 5)
           for i in range(7)]
    phases = {"device_commit_schedule": 0.2, "device_commit_scan": 6.4,
              "device_commit_fetch": 1.6, "device_commit_writeback": 0.12,
              "n_commit_steps": 5, "n_dq_trellis_launches": 3,
              "n_dq_trellis_positions": 1_000_000}
    return {"frames": 32, "phases": phases,
            "trace": tracing.reduce(sorted(ev, key=lambda e: e["ts"]))}


def metric(name, record):
    return spec.load_reader("layer_metrics", name).read(record)


def test_the_readers_on_a_canned_record():
    r = canned()
    assert metric("commit_scan_issue_ms_per_frame.devcommit", r) == \
        pytest.approx(6400 / 32)
    assert metric("commit_scan_wait_ms_per_frame.devcommit", r) == \
        pytest.approx(1600 / 32)
    assert metric("commit_host_ms_per_frame.devcommit", r) == \
        pytest.approx(320 / 32)
    assert metric("device_ops_per_commit_step.devcommit", r) == \
        pytest.approx(10 / 5)
    want = 100 * 315 * 1_000_000 / 33.5e12 / 1.5e-3
    assert metric("dq_trellis_roofline.devcommit", r) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_the_readers_read_nothing_without_their_inputs(name):
    r = canned()
    assert metric(name, dict(r, phases={})) is None
    if name.startswith(("device_ops", "dq_trellis")):
        assert metric(name, dict(r, trace=None)) is None


def test_the_roofline_reads_nothing_when_the_k1_counts_disagree():
    name = "dq_trellis_roofline.devcommit"
    assert metric(name, canned(k1_launches=4)) is None
    assert metric(name, canned(k1_launches=0)) is None


def test_the_k1_bound_at_the_shapes_a_cpu_run_counts():
    """Per launch the larger of bytes and operations, summed over the
    launches a CPU encode counted, equals the bound from the positions
    alone (the operations bound at every K1 shape), and the program's
    counters equal the recorder's."""
    import torch
    from wrenc_tpu_torch import trace
    from wrenc_tpu_torch.core.config import EncoderConfig
    from wrenc_tpu_torch.encoder import Encoder
    from wrenc_tpu_torch.search import WavefrontSearch
    torch.set_num_threads(1)
    cfg = EncoderConfig(width=64, height=64, qp=32)
    enc = Encoder(cfg, search=WavefrontSearch(cfg, device="cpu",
                                              commit_engine="device"))
    rng = np.random.default_rng(5)
    frames = [tuple(rng.integers(0, 256, (h, w)).astype(np.uint8)
                    for h, w in ((64, 64), (32, 32), (32, 32)))]
    try:
        trace.enable()
        enc.encode(frames)
        d = trace.drain()
    finally:
        trace.disable()
    jobs = [(c["jobs"], c["count"]) for c in d["counters"]
            if c["kernel"] == "dq_trellis"]
    ph = enc.phase_times
    assert sum(n for _, n in jobs) == ph["n_dq_trellis_launches"] > 0
    positions = sum(P * B * n for js, n in jobs for P, B in js)
    assert positions == ph["n_dq_trellis_positions"]
    assert min(P for js, _ in jobs for P, _ in js) >= 16
    by_launch = sum(roofline_k1.launch_bound_s(js) * n for js, n in jobs)
    assert by_launch == pytest.approx(
        roofline_k1.positions_bound_s(positions), rel=1e-12)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A checkout's benchmark files with one more cell: the device commit
    configuration at 64x64, 2 frames per call."""
    root = tmp_path_factory.mktemp("checkout")
    (root / "perfbench").mkdir()
    for d in ("configs", "traffic"):
        (root / "perfbench" / d).mkdir()
    conf = json.load(open(os.path.join(spec.PERFBENCH, "configs",
                                       "ai_cif_device_commit.json")))
    conf.update(picture=[64, 64], encoder_config=dict(
        conf["encoder_config"], width=64, height=64))
    (root / "perfbench" / "configs" / "tiny_dc.json").write_text(
        json.dumps(conf))
    t = json.load(open(os.path.join(spec.PERFBENCH, "traffic",
                                    "clip16_qp32.json")))
    (root / "perfbench" / "traffic" / "tiny2_qp32.json").write_text(
        json.dumps(dict(t, frames_per_call=2, pool_frames=4,
                        check_blocks_per_size=4)))
    for d in ("end_to_end", "layer_metrics"):
        os.symlink(os.path.join(spec.PERFBENCH, d), root / "perfbench" / d)
    b = spec.load_benchmark(ROOT)
    b["configs"].append({"name": "tiny_dc", "source": "test",
                         "file": "perfbench/configs/tiny_dc.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny_dc_qp32", "config": "tiny_dc",
                           "traffic": "tiny2_qp32", "chips": 1,
                           "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


def test_commit_check_runs_on_the_cpu(tiny_root):
    import commit_check
    r = commit_check.run(str(tiny_root), "tiny_dc_qp32", SEED, 0.5,
                         device="cpu")
    assert r["calls"] >= 1 and r["passes"] is True
    assert r["numbers"]["commit_levels_differing"] == 0
    assert r["numbers"]["commit_picks_differing"] == 0
    assert 0 <= r["numbers"]["commit_cost_gap"] <= \
        commit_ref.LIMITS["commit_cost_gap"]


@pytest.mark.card
def test_commit_check_on_the_card(card):
    import commit_check
    r = commit_check.run(ROOT, CELL, SEED, 5.0)
    assert r["calls"] >= 1 and r["passes"] is True, r
