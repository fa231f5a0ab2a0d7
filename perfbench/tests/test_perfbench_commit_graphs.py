"""The device commit engine's rank steps as CUDA graphs, on the card, in
the device commit cell's configuration and content: two consecutive
4-frame CIF QP 32 encodes give the bytes of the same code on the CPU; the
second call captures no graph and replays one for every rank step; and a
torch.profiler trace of the second call holds exactly the K1 kernels the
scan counted (the reading of dq_trellis_roofline.devcommit). The card's
encodes run in a process of their own: after device-engine encodes, a
later torch.profiler session of the same process was seen to miss
kernels, which would fail the card tests that follow. On the
card: python -m pytest perfbench/tests -m card. On the CPU: the readers
of the two metrics that count the graphs and the padded rows."""
import json
import os
import subprocess
import sys

import pytest

from benchlib import content, spec

ROOT = os.path.dirname(spec.PERFBENCH)
CELL = "cif_qp32_device_commit"
SEED = 3_170_000_017
N_FRAMES = 4


def _cell():
    """The cell's EncoderConfig, search arguments and N_FRAMES frames."""
    from wrenc_tpu_torch.core.config import EncoderConfig
    c = spec.cell(spec.load_benchmark(ROOT), CELL, ROOT)
    config, traffic = c["config"], c["traffic"]
    cfg = EncoderConfig(**dict(config["encoder_config"], qp=traffic["qp"]))
    frames = content.make_frames(traffic["content"], tuple(config["picture"]),
                                 (cfg.width, cfg.height), N_FRAMES,
                                 content.seed_sequence(SEED, 0))
    return cfg, config["search"], frames


def card_encodes():
    """Two encodes on the card, the second under torch.profiler: one JSON
    line with both streams (hex), the second call's phase_times and the
    K1 kernels its trace holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from wrenc_tpu_torch.encoder import Encoder
    from wrenc_tpu_torch.search import WavefrontSearch
    cfg, search, frames = _cell()
    enc = Encoder(cfg, search=WavefrontSearch(cfg, **search))
    first, _ = enc.encode(frames)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        second, _ = enc.encode(frames)
        torch.cuda.synchronize()
    k1 = sum(1 for e in prof.events() if "dq_trellis_kernel" in e.name)
    print(json.dumps({"first": first.hex(), "second": second.hex(),
                      "phases": enc.phase_times, "k1": k1}))


@pytest.mark.card
def test_the_step_graphs_on_the_card(card):
    from wrenc_tpu_torch.encoder import Encoder
    from wrenc_tpu_torch.search import WavefrontSearch
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, "-c", "import test_perfbench_commit_graphs as t; "
         "t.card_encodes()"], cwd=here, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [here, spec.PERFBENCH, ROOT])))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    cfg, search, frames = _cell()
    cpu, _ = Encoder(cfg, search=WavefrontSearch(
        cfg, device="cpu", **search)).encode(frames)
    assert bytes.fromhex(r["first"]) == bytes.fromhex(r["second"]) == cpu
    ph = r["phases"]
    assert ph["n_commit_graph_captures"] == 0
    assert ph["n_commit_graph_replays"] == ph["n_commit_steps"] > 0
    assert r["k1"] == ph["n_dq_trellis_launches"] > 0


def _read(name, record):
    return spec.load_reader("layer_metrics", name).read(record)


def test_the_graph_readers_on_a_canned_record():
    """The padded rows' share and the captures per call, from the window's
    summed phase_times; nothing where the program has no such counts (a
    parent without the graphs)."""
    record = {"calls": [(0.0, 2.0, 16), (2.0, 4.5, 16)], "frames": 32,
              "phases": {"n_commit_rows_live": 300,
                         "n_commit_rows_padded": 100,
                         "n_commit_graph_captures": 3},
              "trace": None}
    assert _read("commit_rows_padded_pct.devcommit", record) == 25.0
    assert _read("commit_graph_captures_per_call.devcommit", record) == 1.5
    for name in ("commit_rows_padded_pct.devcommit",
                 "commit_graph_captures_per_call.devcommit"):
        assert _read(name, dict(record, phases={})) is None
