"""The port's tools (wrenc_tpu_torch/tools/) against the JAX package's, on
the CPU.

The same seeded numpy inputs go through each JAX tool function and its
counterpart in the port: the metrics (exact: the same numpy code), the
config files, run_point and evaluate.main (bytes, per-frame PSNR and
SSIM exact; the clip loader replaced by synthetic frames, as the clips
are absent), the dashboard's HTML, engine_ab's encodes with both commit
engines, tune's search space and objective, bench1080p's frames and
record, and scaling_bench's sharded == serial on CPU cells. Every entry
point defaults to the card and raises without one.
"""
import ast
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from wrenc_tpu.tools import bench1080p as jbench
from wrenc_tpu.tools import dashboard as jdash
from wrenc_tpu.tools import engine_ab as jab
from wrenc_tpu.tools import evaluate as jev
from wrenc_tpu.tools import metrics as jmet
from wrenc_tpu.tools import tune as jtune

from wrenc_tpu_torch.tools import bench1080p as tbench
from wrenc_tpu_torch.tools import dashboard as tdash
from wrenc_tpu_torch.tools import engine_ab as tab
from wrenc_tpu_torch.tools import evaluate as tev
from wrenc_tpu_torch.tools import metrics as tmet
from wrenc_tpu_torch.tools import multihost_smoke as tmh
from wrenc_tpu_torch.tools import scaling_bench as tscale
from wrenc_tpu_torch.tools import tune as ttune

from tests.test_torch_native_ref import jax_native_host_build  # noqa: F401

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOOLS = ROOT / "wrenc_tpu_torch" / "tools"
# a clip the anchors list, so BD-rates and the tune objective are computed
VIDEO = "bus_352x288_30fps_30fr.mp4"


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for k in ("WRENC_COMMIT_ENGINE", "WRENC_CHROMA_STAGE_A",
              "WRENC_STAGE_A_SELECT"):
        monkeypatch.delenv(k, raising=False)


def _frames(W, H, n, seed=0):
    """chip_smoke.py's synthetic frames (bench.py's generator)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for i in range(n):
        y = np.clip((np.sin(xx / 11 + i * 0.3) * 50
                     + np.cos(yy / 7 - i * 0.2) * 40 + 128)
                    + rng.integers(-10, 11, (H, W)), 0, 255).astype(np.uint8)
        out.append((y, (y[::2, ::2] // 2 + 64).astype(np.uint8),
                    (200 - y[::2, ::2] // 2).astype(np.uint8)))
    return out


# ---------------------------------------------------------------- metrics
def _metric_args(name):
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (3, 40, 48)).astype(np.uint8)
    b = np.clip(a + rng.integers(-9, 10, a.shape), 0, 255).astype(np.uint8)
    planes = [(a[0], a[1][:20, :24], a[2][:20, :24]),
              (b[0], b[1][:20, :24], b[2][:20, :24])]
    return {
        "psnr": ((a[0], b[0]), {}),
        "yuv_psnr": (tuple(planes), {}),
        "ssim": ((a[0], b[0]), {}),
        "bd_rate": (([900, 700, 500, 330], [40.1, 38.2, 35.9, 33.0],
                     [1000, 760, 520, 360], [40.5, 38.0, 36.1, 33.4]), {}),
        "device_mac_estimate": ((352, 288, 16), {"max_depth": 3}),
    }[name]


@pytest.mark.parametrize("name", ["psnr", "yuv_psnr", "ssim", "bd_rate",
                                  "device_mac_estimate"])
def test_metrics_match_jax(name):
    args, kw = _metric_args(name)
    want = getattr(jmet, name)(*args, **kw)
    got = getattr(tmet, name)(*args, **kw)
    assert repr(got) == repr(want)


def test_psnr_of_identical_planes_is_99():
    a = np.full((8, 8), 7, np.uint8)
    assert tmet.psnr(a, a) == jmet.psnr(a, a) == 99.0


def test_mfu_against_the_h100_f32_rate():
    macs = tmet.device_mac_estimate(1920, 1088, 4)
    assert tmet.H100_PEAK_MACS == 33.5e12
    assert tmet.mfu_estimate(1920, 1088, 4, 2.0) == float(
        macs / (2.0 * 33.5e12))
    src = (TOOLS / "metrics.py").read_text()
    assert "V5E" not in src and "98.5e12" not in src


# ----------------------------------------------------------- config files
@pytest.mark.parametrize("name", ["anchors.json", "presets.json"])
def test_config_file_is_the_jax_file(name):
    jdir = ROOT / "wrenc_tpu" / "tools" / "config"
    assert (TOOLS / "config" / name).read_bytes() == \
        (jdir / name).read_bytes()


def test_videos_config_reads_clips_inside_the_checkout():
    """videos.json as the JAX file, but its assets_dir is relative: the
    port reads its clips from the repository's assets/ directory."""
    want = json.loads((ROOT / "wrenc_tpu" / "tools" / "config" /
                       "videos.json").read_text())
    got = json.loads((TOOLS / "config" / "videos.json").read_text())
    assert got.pop("assets_dir") == "assets"
    want.pop("assets_dir")
    assert got == want
    assert tev.DEFAULT_ASSETS == str(ROOT / "assets")
    assert tev.ANCHORS == jev.ANCHORS


# --------------------------------------------------------------- evaluate
@pytest.mark.parametrize("qp", [27, 37])
def test_run_point_matches_jax(qp):
    frames = _frames(64, 64, 2, seed=3)
    want = jev.run_point(frames, qp, 3)
    got = tev.run_point(frames, qp, 3, device="cpu")
    assert got[0] == want[0]                                # bytes
    assert got[1] == want[1] and got[2] == want[2]          # summaries
    assert got[4] == want[4] and got[5] == want[5]          # per frame


def _summary(main, mod, monkeypatch, tmp_path, tag, extra=()):
    frames = _frames(64, 64, 2, seed=7)
    monkeypatch.setattr(mod, "load_clip_yuv", lambda path, n: frames[:n])
    out = tmp_path / f"{tag}.json"
    assert main(["--videos", VIDEO, "--qps", "22,32,37", "--frames", "2",
                 "--per-frame", "--out", str(out), *extra]) == 0
    return json.loads(out.read_text())


def _strip(summary):
    summary = dict(summary)
    for k in ("date", "encoder"):
        summary.pop(k)
    for preset in summary["results"]:
        for vr in preset["results"]:
            for r in vr["results"]:
                r.pop("duration")
    return json.dumps(summary, sort_keys=True)


def test_evaluate_main_matches_jax(monkeypatch, tmp_path):
    want = _summary(jev.main, jev, monkeypatch, tmp_path, "jax")
    got = _summary(tev.main, tev, monkeypatch, tmp_path, "port",
                   ("--device", "cpu"))
    assert got["encoder"] == "wrenc_tpu_torch"
    assert set(got) == set(want)
    assert _strip(got) == _strip(want)
    assert not math.isnan(got["bd_rate_vs_anchors"][VIDEO]["x265"])


# -------------------------------------------------------------- dashboard
def _hand_summary():
    pts = [(22, 9100, 41.25, 0.981), (27, 5200, 38.5, 0.962),
           (32, 3100, 35.125, 0.93), (37, 1800, 32.0, 0.88)]
    return {"date": "2026-01-02 03:04:05",
            "results": [{"results": [{
                "video": VIDEO,
                "results": [{"qp": q, "bytes": b, "duration": 1.5 + q / 10,
                             "metrics": {"PSNR": {"summary": {"Avg": p}},
                                         "SSIM": {"summary": {"Avg": s}}}}
                            for q, b, p, s in pts]}]}],
            "bd_rate_vs_anchors": {VIDEO: {"wrenc": 1.25,
                                           "x265": float("nan")}}}


def test_dashboard_matches_jax(tmp_path):
    summary = _hand_summary()
    html = tdash.build_html(summary)
    assert html == jdash.build_html(summary)
    src = tmp_path / "s.json"
    src.write_text(json.dumps(summary))
    out = tmp_path / "sub" / "d.html"
    assert tdash.main(["-i", str(src), "-o", str(out)]) == 0
    assert out.read_text() == html


# -------------------------------------------------------------- engine_ab
@pytest.mark.parametrize("engine", ["native", "device"])
def test_engine_ab_encode_matches_jax(engine):
    frames = _frames(64, 64, 2, seed=9)
    cfg_kw = dict(width=64, height=64, qp=32)
    want = jab._encode(cfg_kw, frames, engine)
    got = tab._encode(cfg_kw, frames, engine, device="cpu")
    assert got[0] == want[0]
    assert tab._verify(got[0], got[1])
    for k in range(len(frames)):
        for c in range(3):
            assert (got[1][k][c] == want[1][k][c]).all()


def test_engine_ab_report_passes_its_gate():
    frames = _frames(64, 64, 2, seed=9)
    report = tab.run_ab([("synthetic", frames)], [32], 2, device="cpu")
    (row,) = report["points"]
    assert row["byte_identical"] and report["all_byte_identical"]
    assert row["native"]["conformant"] and row["device"]["conformant"]
    assert tab.passes_gate(report)
    row["byte_identical"] = report["all_byte_identical"] = False
    report["max_abs_size_delta_pct"] = 0.05
    assert not tab.passes_gate(report)


# ------------------------------------------------------------------- tune
def test_tunable_names_match_jax():
    assert ttune.tunable_names() == jtune.tunable_names()
    only = ",".join(jtune.tunable_names()[:3])
    assert ttune.tunable_names(only) == jtune.tunable_names(only)


def test_tune_objective_matches_jax():
    name = jtune.tunable_names()[0]
    params = {name: getattr(jtune.RateModelConfig(), name) * 1.1}
    vf = [(VIDEO, _frames(64, 64, 2, seed=11))]
    want = jtune.objective(params, vf, [26, 32, 38], 3)
    got = ttune.objective(params, vf, [26, 32, 38], 3, device="cpu")
    assert repr(got) == repr(want)


def test_tune_fallback_writes_a_resumable_study(tmp_path):
    class Args:
        study = str(tmp_path / "study.json")
        seed, sigma, moves, trials = 0, 0.15, 2, 1
        max_split_depth, device = 2, "cpu"
    vf = [(VIDEO, _frames(64, 64, 1, seed=12))]
    best = ttune.run_fallback(Args, vf, [26, 38], ttune.tunable_names())
    study = json.loads(pathlib.Path(Args.study).read_text())
    assert len(study["trials"]) == 2 and study["trials"][0]["params"] == {}
    assert best["value"] == min(t["value"] for t in study["trials"])


# ------------------------------------------------------------- bench1080p
def test_frames_1080p_match_jax():
    want = jbench.frames_1080p(2, 128, 64)
    got = tbench.frames_1080p(2, 128, 64)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        for pa, pb in zip(a, b):
            assert pa.dtype == pb.dtype and (pa == pb).all()


def test_bench1080p_main_matches_jax(monkeypatch, tmp_path):
    jout = tmp_path / "jax" / "rec.json"
    monkeypatch.setattr(sys, "argv", [
        "bench1080p", "--size", "128x64", "--frames", "1", "--out",
        str(jout)])
    jbench.main()
    want = json.loads(jout.read_text())
    tout = tmp_path / "port" / "rec.json"
    got = tbench.main(["--size", "128x64", "--frames", "1", "--out",
                       str(tout), "--device", "cpu"])
    assert json.loads(tout.read_text()) == got
    assert set(got) == set(want)
    for k in ("resolution", "frames", "qp", "wpp_rows", "bytes",
              "conformance_roundtrip"):
        assert got[k] == want[k], k
    assert got["platform"] == "cpu"
    assert got["mfu"] == tmet.mfu_estimate(128, 64, 1, got["encode_s"])


# ---------------------------------------------------------- scaling_bench
def test_scaling_bench_sharded_equals_serial_on_cpu_cells(tmp_path):
    """n_list (1, 2) on CPU cells (the CPU device twice): main asserts
    the gathered band outputs equal the serial stage A; the record keeps
    the JAX tool's keys and says that one device shows no scaling."""
    out = tmp_path / "scaling.json"
    res = tscale.main((1, 2), W=64, out_path=str(out), device="cpu")
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    for k in ("what", "width", "frames", "qp", "band_h_per_device",
              "physical_cores", "caveat", "by_devices"):
        assert k in res
    rows = res["by_devices"]
    assert rows[2]["cells"] == ["cpu", "cpu"] and not res["distinct_cards"]
    assert rows[1]["distinct_cards"] and not rows[2]["distinct_cards"]
    for r in rows.values():
        for k in ("H", "t_sharded_s", "t_serial_1dev_s", "weak_efficiency",
                  "sharding_overhead_pct"):
            assert k in r
    assert "no scaling" in res["caveat"]


# -------------------------------------------------- entry points, imports
_ENTRY = {
    "evaluate": lambda: tev.main(["--videos", VIDEO]),
    "bench1080p": lambda: tbench.main(["--size", "64x64"]),
    "engine_ab": lambda: tab.main(["--clips", "bus"]),
    "tune": lambda: ttune.main(["--videos", VIDEO]),
    "scaling_bench": lambda: tscale.cli(["--cells", "1"]),
    "multihost_smoke": lambda: tmh.main([]),
    "run_point": lambda: tev.run_point(_frames(64, 64, 1), 32, 3),
}


@pytest.mark.parametrize("name", sorted(_ENTRY))
def test_entry_points_default_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _ENTRY[name]()


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("name", ["metrics", "evaluate", "bench1080p",
                                  "engine_ab", "dashboard", "tune",
                                  "scaling_bench", "multihost_smoke"])
def test_tool_imports_no_optional_module_at_import(name):
    """cv2 and optuna are imported inside the functions that use them;
    the card's machine has neither. test_torch_package's import rules
    list the module."""
    from tests.test_torch_package import _modules
    assert f"wrenc_tpu_torch.tools.{name}" in _modules()
    top = set(_top_level_imports(TOOLS / f"{name}.py"))
    assert not top & {"cv2", "optuna", "jax", "wrenc_tpu"}, top


def test_tools_import_without_cv2_and_optuna():
    code = ("import sys\n"
            "for m in ('cv2', 'optuna', 'jax', 'wrenc_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from wrenc_tpu_torch.tools import (bench1080p, dashboard, "
            "engine_ab, evaluate, metrics, multihost_smoke, scaling_bench, "
            "tune)\n"
            "frames = bench1080p.frames_1080p(1, 64, 32)\n"
            "assert frames[0][0].shape == (32, 64)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
