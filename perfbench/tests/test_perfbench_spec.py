"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""
import json
import os
import re

import pytest

from benchlib import spec

ROOT = os.path.dirname(spec.PERFBENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark(ROOT)


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(bench):
    assert list(bench) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/") and c["file"] not in files
        files.add(c["file"])
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
        ec = conf["encoder_config"]
        w, h = conf["picture"]
        # the coded size is the picture padded up to the CTU, a padding
        # that `assumed` records; any other change is a cut, listed
        ctu = 1 << ec["log2_ctu_size"]
        for dim, n in (("width", w), ("height", h)):
            padded = -(-n // ctu) * ctu
            assert (ec[dim] != padded) == (dim in c["reduced"])
            assert ec[dim] == n or "padding" in conf["assumed"]


def test_workloads(bench):
    names = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert len({w["name"] for w in bench["workloads"]}) == len(pairs)


def test_metrics_match_their_files(bench):
    seen = set()
    for kind, key in (("end_to_end", "end_to_end"),
                      ("layer_metrics", "per_layer")):
        for m in bench[key]:
            assert NAME.match(m["name"]) and m["name"] not in seen
            seen.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
            mod = spec.load_reader(kind, m["name"])
            assert (mod.UNIT, mod.SOURCE) == (m["unit"], m["source"])
            if key == "end_to_end":
                assert set(m) <= {"name", "unit", "better", "bound", "source",
                                  "workloads"}
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert set(m) == {"name", "unit", "better", "source", "layer",
                                  "moves", "workloads"}
                assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
                assert _line(m["layer"])
                if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
                    assert m["unit"] == "%"


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        c = spec.cell(bench, w["name"], ROOT)
        reported = {m["name"] for m, _ in c["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert c["per_layer"]
        for m, _ in c["per_layer"]:
            assert m["moves"] in reported
    for m in bench["per_layer"]:
        for cell in m["workloads"]:
            wl = e2e[m["moves"]].get("workloads")
            assert wl is None or cell in wl


def test_traffic_files(bench):
    for w in bench["workloads"]:
        t = spec.cell(bench, w["name"], ROOT)["traffic"]
        assert t["loop"] == "closed" and t["callers"] == 1
        assert t["frames_per_call"] >= 1 and 0 <= t["qp"] <= 63
        assert t["pool_frames"] >= t["frames_per_call"]
        assert t["check_calls"] >= 1


def test_a_new_traffic_file_is_found_by_name(tmp_path, bench):
    """A traffic mix is data: a new file and a workload entry are all that
    a new cell needs."""
    (tmp_path / "traffic").mkdir()
    t = dict(spec.cell(bench, bench["workloads"][0]["name"], ROOT)["traffic"],
             qp=27, frames_per_call=3)
    (tmp_path / "traffic" / "clip3_qp27.json").write_text(json.dumps(t))
    for kind in ("end_to_end", "layer_metrics"):
        os.symlink(os.path.join(spec.PERFBENCH, kind), tmp_path / kind)
    b = dict(bench, workloads=bench["workloads"] + [
        dict(bench["workloads"][0], name="new_cell", traffic="clip3_qp27")])
    c = spec.cell(b, "new_cell", ROOT, bench_dir=str(tmp_path))
    assert (c["traffic"]["qp"], c["traffic"]["frames_per_call"]) == (27, 3)
    with pytest.raises(spec.SpecError):
        spec.cell(b, "no_such_cell", ROOT, bench_dir=str(tmp_path))
