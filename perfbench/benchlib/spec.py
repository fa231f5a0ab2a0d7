"""BENCHMARK.json and the files it names, each found by its name.

A cell (`workloads` entry) names a configuration (`configs` entry, whose
`file` holds the encoder settings) and a traffic mix
(`perfbench/traffic/<traffic>.json`). Each metric is a reader module:
`perfbench/end_to_end/<name>.py` or `perfbench/layer_metrics/<name>.py`.
A metric belongs to a cell when its `workloads` list names the cell, or
when it has no such list.
"""
import importlib.util
import json
import os

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class SpecError(Exception):
    """BENCHMARK.json, or a file it names, is missing or inconsistent."""


def _json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"missing file {path}") from None


def load_benchmark(root):
    return _json(os.path.join(root, "BENCHMARK.json"))


def load_reader(kind, name, bench_dir=PERFBENCH):
    """The module `<bench_dir>/<kind>/<name>.py` (kind: end_to_end or
    layer_metrics). It defines read(record) -> number or None, and the
    constants UNIT, SOURCE (and for a per-layer metric LAYER and MOVES)
    that BENCHMARK.json repeats."""
    path = os.path.join(bench_dir, kind, name + ".py")
    if not os.path.exists(path):
        raise SpecError(f"no reader {path} for metric {name}")
    mod_spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def _reports(metric, cell_name):
    return cell_name in metric.get("workloads", [cell_name])


def cell(bench, name, root, bench_dir=PERFBENCH):
    """Everything one cell needs: its entry, its configuration file, its
    traffic file, and the metrics (entry, reader) that it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                        f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {name}: no config {w['config']!r}")
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    return {
        "name": name,
        "chips": int(w["chips"]),
        "config_name": w["config"],
        "traffic_name": w["traffic"],
        "config": config,
        "traffic": traffic,
        "end_to_end": [(m, load_reader("end_to_end", m["name"], bench_dir))
                       for m in bench["end_to_end"] if _reports(m, name)],
        "per_layer": [(m, load_reader("layer_metrics", m["name"], bench_dir))
                      for m in bench["per_layer"] if _reports(m, name)],
    }
