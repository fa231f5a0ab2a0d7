"""Each metric reader, and the trace reduction, on canned records."""
import json

import pytest

from benchlib import roofline, spec, tracing

CIF = {"encoder_config": {"width": 352, "height": 288, "log2_ctu_size": 5,
                          "max_split_depth": 3}, "search": {}}


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


MARK = "void at::native::vectorized_elementwise_kernel<4, add>(int)"


def canned_trace():
    """A 1 s window (µs from 1,000,000) between the two marker kernels: two
    K2 launches and a copy that overlaps one of them, and host events that
    are not device work."""
    return [
        _ev("kernel", MARK, 1_000_000, 2),
        _ev("kernel", "void dq_greedy_kernel<8>(K1Job, int const*)",
            1_100_000, 100_000),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 1_150_000,
            100_000),
        _ev("kernel", "void dq_greedy_kernel<1>(K1Job, int const*)",
            1_600_000, 50_000),
        _ev("kernel", MARK, 1_999_998, 2),
        _ev("cuda_runtime", "cudaLaunchKernel", 1_090_000, 5_000),
        _ev("gpu_user_annotation", "anything", 1_000_000, 900_000),
    ]


def test_reduce_busy_gaps_and_ops():
    red = tracing.reduce(canned_trace(), call_starts=[0.0, 0.5])
    assert red["window_s"] == pytest.approx(1.0)
    # union: the markers, [1.10, 1.25] and [1.60, 1.65] -> 0.2 s busy
    assert red["busy_s"] == pytest.approx(0.2 + 4e-6)
    assert MARK not in red["kernels"]
    assert red["kernels"]["Memcpy DtoH (Device -> Pinned)"] == [
        1, pytest.approx(0.1)]
    assert red["device_ops"][0][1] == pytest.approx(0.1)
    gaps = red["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([0.35, 0.35, 0.1], abs=1e-5)
    # 1.25-1.60 s lies in call 0, 1.65-2.00 s in call 1
    assert gaps[0][0].startswith("call 0: host work after Memcpy")
    assert gaps[1][0].startswith("call 1: host work after void dq_greedy")
    assert tracing.reduce([e for e in canned_trace()
                           if e["cat"] not in tracing.DEVICE_CATS]) is None


def test_reduce_reads_an_exported_file(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": canned_trace()}))
    assert tracing.reduce(tracing.load(str(p)))["busy_s"] == pytest.approx(
        0.2 + 4e-6)


def record(trace=None, config=CIF, calls=((0.0, 2.0, 16), (2.0, 4.5, 16))):
    return {"setup_s": 12.5, "calls": list(calls),
            "frames": sum(c[2] for c in calls),
            "wall_s": sum(b - a for a, b, _ in calls),
            "phases": {"host_commit": 1.5, "host_commit_work": 3.2,
                       "host_decide": 0.64, "device_dispatch": 0.1,
                       "device_stage_a": 0.02, "host_chroma_rd": 0.2,
                       "host_entropy": 0.32},
            "config": config, "traffic": {}, "trace": trace}


def metric(name, rec):
    kind = "end_to_end" if name in ("encode_fps", "setup_s",
                                    "frame_latency_p95_ms") else "layer_metrics"
    return spec.load_reader(kind, name).read(rec)


def test_end_to_end_readers():
    r = record()
    assert metric("encode_fps", r) == pytest.approx(32 / 4.5)
    assert metric("setup_s", r) == 12.5
    lat = record(calls=[(i, i + 0.1 + i / 100, 1) for i in range(21)])
    assert metric("frame_latency_p95_ms", lat) == pytest.approx(290.0)
    assert metric("frame_latency_p90_ms.live", lat) == pytest.approx(280.0)


@pytest.mark.parametrize("sfx", ["clip", "live"])
def test_phase_readers(sfx):
    r = record()
    assert metric(f"decide_ms_per_frame.{sfx}", r) == pytest.approx(20.0)
    assert metric(f"stage_a_host_ms_per_frame.{sfx}", r) == pytest.approx(
        320 / 32)
    assert metric(f"entropy_ms_per_frame.{sfx}", r) == pytest.approx(10.0)
    assert metric(f"device_idle_pct.{sfx}", r) is None
    t = dict(r, trace=tracing.reduce(canned_trace()))
    assert metric(f"device_idle_pct.{sfx}", t) == pytest.approx(80.0, abs=1e-3)


def test_commit_readers():
    r = record()
    assert metric("commit_work_ms_per_frame.clip", r) == pytest.approx(100.0)
    assert metric("commit_wait_pct.clip", r) == pytest.approx(100 * 1.5 / 4.5)
    assert metric("commit_ms_per_frame.live", r) == pytest.approx(1500 / 32)
    empty = dict(r, phases={})
    for name in ("commit_work_ms_per_frame.clip", "commit_wait_pct.clip",
                 "commit_ms_per_frame.live"):
        assert metric(name, empty) is None


def test_k2_launch_count():
    # CIF, 16 frames: two 8-frame chunks, one launch per luma size
    cif = roofline.k2_launches(352, 288, 5, 3, 16)
    assert cif[:4] == [(16, 8 * 88 * 72 * 6), (64, 8 * 44 * 36 * 6),
                       (256, 8 * 22 * 18 * 6), (1024, 8 * 11 * 9 * 6)]
    assert len(cif) == 8 and cif[4:] == cif[:4]
    # a 1-frame CIF call pads nothing: the 1-frame bucket
    assert roofline.k2_launches(352, 288, 5, 3, 1)[0] == (16, 88 * 72 * 6)
    # 1080p: 1-frame chunks, 4 luma + 7 chroma launches each
    hd = roofline.k2_launches(1920, 1088, 5, 3, 2)
    assert len(hd) == 22
    n4 = (960 // 4) * (544 // 4)
    assert hd[4:7] == [(16, 2 * n4), (16, 2 * n4), (16, 6 * n4)]
    assert roofline.chunk_frames(352, 288, 11) == [8, 4]


def _k2_trace(launches, secs_each):
    ev = [_ev("kernel", MARK, 0, 1), _ev("kernel", MARK, 10_000_000, 1)]
    ev += [_ev("kernel", "void dq_greedy_kernel<8>(K1Job)", 10 + 10 * i,
               secs_each * 1e6) for i in range(launches)]
    return tracing.reduce(ev)


def test_roofline_reader():
    name = "dq_greedy_roofline.clip"
    calls = [(0.0, 1.0, 16)]
    bound = roofline.k2_bound_s(roofline.k2_launches(352, 288, 5, 3, 16))
    r = record(trace=_k2_trace(8, bound / 8 * 5), calls=calls)
    assert metric(name, r) == pytest.approx(20.0)
    # a launch more or less than the count predicts: nothing is read
    assert metric(name, record(trace=_k2_trace(9, 1e-3), calls=calls)) is None
    assert metric(name, record(trace=None, calls=calls)) is None
    other = dict(CIF, search={"commit_engine": "device"})
    assert metric(name, record(trace=_k2_trace(8, 1e-3), config=other,
                               calls=calls)) is None
    # the bytes bound leads at the main-path shapes
    P, B = roofline.k2_launches(1920, 1088, 5, 3, 1)[0]
    b, o = roofline.launch_bound_s(P, B)
    assert b > o
