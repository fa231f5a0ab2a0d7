#!/usr/bin/env python3
"""Multi-device scaling measurement of the sharded stage A of the
PyTorch/CUDA port — the counterpart of wrenc_tpu.tools.scaling_bench.

The cells of each mesh are torch devices (dist.Mesh): distinct cards when
the process sees enough of them, else the first card (or the CPU)
repeated, which every cell then runs on in turn. Per cell count n, a
(frame 1, row n) mesh over a frame of n CTU rows (one row band per cell):

- ``t_sharded_s``: the band dispatch, fused_luma_band_stage_a per band
  with its one-row halo from the band above, as
  WavefrontSearch._dispatch_mesh drives it, until every cell's device is
  idle;
- ``t_serial_1dev_s``: fused_luma_stage_a on ONE device over the same
  total frame, unsharded;
- ``weak_efficiency``: t(1 cell) / t(n cells) with FIXED WORK PER CELL;
- ``sharding_overhead_pct``: (t_sharded - t_serial) / t_serial.

With every cell on one device, the cells run in turn and there is no
scaling to read: the record says so (``distinct_cards`` false). The
gathered sharded outputs are asserted equal to the serial ones.

Writes results/torch/scaling.json. Run:
    python -m wrenc_tpu_torch.tools.scaling_bench [--device cuda|cpu] \
        [--cells 1,2,4,8]
"""
import argparse
import json
import os
import time

import numpy as np
import torch

SIZES = (4, 8, 16, 32)


def stage_a_args(cfg, device):
    """The luma stage A's QP tables and scalars for `cfg` on `device`, as
    the search uploads them (WavefrontSearch._stage_a_args): the keyword
    arguments of fused_luma_stage_a and fused_luma_band_stage_a after
    the geometry."""
    from ..search import WavefrontSearch
    a = WavefrontSearch(cfg, device=device)._stage_a_args()
    return {k: a[k] for k in ("K", "trellis", "ls", "bd", "lam_dq", "lv",
                              "lam", "mats")}


def mesh_cells(n, device):
    """n cells on `device`'s type: n distinct cards when there are that
    many, else the device n times. Returns (devices, whether the n cells
    are n distinct devices)."""
    device = torch.device(device)
    if device.type == "cuda":
        if torch.cuda.device_count() >= n:
            return [torch.device("cuda", i) for i in range(n)], True
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return [device] * n, n == 1


def _sync(devices):
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _time_run(fn, devices, reps=5):
    """The least of `reps` wall times of fn() until every device in
    `devices` is idle, after one untimed call."""
    fn()
    _sync(devices)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(devices)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main(n_list=(1, 2, 4, 8), W=704, F=2, qp=32, out_path=None,
         device="cuda"):
    from .. import dist
    from ..core.config import EncoderConfig
    from ..search import WavefrontSearch
    from ..search import wavefront as wf
    dev = wf.resolve_device(device)
    rng = np.random.default_rng(0)
    band_h = 32                      # one CTU row of work per cell
    rows = {}
    for nd in n_list:
        H = band_h * nd
        planes = rng.integers(0, 256, (F, H, W)).astype(np.uint8)
        cells, distinct = mesh_cells(nd, dev)
        cfg = EncoderConfig(width=W, height=H, qp=qp)
        # serial reference: one device, same total frame, unsharded
        a = stage_a_args(cfg, cells[0])

        def serial():
            return wf.fused_luma_stage_a(
                torch.from_numpy(planes).to(cells[0]), W, H, 5, SIZES,
                sel=False, **a)
        t_serial = _time_run(serial, cells[:1])
        if nd == 1:
            t_shard = t_serial
        else:
            search = WavefrontSearch(
                cfg, mesh=dist.make_mesh(cells, frame_axis=1))

            def sharded():
                return search._dispatch_mesh(planes, list(SIZES))
            t_shard = _time_run(sharded, cells)
            want = wf._fetch_cells(serial())
            got = wf._fetch_cells(sharded())
            for s in SIZES:
                for x, y in zip(want[s], got[s]):
                    if x.dtype != y.dtype or x.shape != y.shape or \
                            x.tobytes() != y.tobytes():
                        raise AssertionError(f"n={nd}: sharded stage A != "
                                             f"serial at s={s}")
        rows[nd] = {"H": H, "t_sharded_s": t_shard,
                    "t_serial_1dev_s": t_serial,
                    "cells": [str(c) for c in cells],
                    "distinct_cards": distinct}
        print(f"n={nd}: sharded {t_shard:.4f}s, serial-1dev "
              f"{t_serial:.4f}s, cells {rows[nd]['cells']}"
              + (" (sharded == serial)" if nd > 1 else ""), flush=True)

    t1 = rows[n_list[0]]["t_sharded_s"]
    for nd in n_list:
        r = rows[nd]
        r["weak_efficiency"] = t1 / r["t_sharded_s"]
        r["sharding_overhead_pct"] = (100.0 * (r["t_sharded_s"]
                                               - r["t_serial_1dev_s"])
                                      / r["t_serial_1dev_s"])
    distinct = all(r["distinct_cards"] for r in rows.values())
    result = {
        "what": "row-band-sharded fused stage A, torch device mesh",
        "width": W, "frames": F, "qp": qp, "band_h_per_device": band_h,
        "physical_cores": os.cpu_count(),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "distinct_cards": distinct,
        "caveat": ("every mesh has one distinct device per cell: "
                   "weak_efficiency reads the design's scaling, "
                   "sharding_overhead_pct its partition + halo cost"
                   if distinct else
                   "the cells share one device and run in turn: there is "
                   "no scaling to read; the times show the band "
                   "dispatch's cost against the unsharded stage A"),
        "by_devices": rows,
    }
    out_path = out_path or os.path.join(
        os.path.dirname(__file__), "..", "..", "results", "torch",
        "scaling.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result["by_devices"].items()}))
    return result


def cli(argv=None):
    ap = argparse.ArgumentParser(
        description="scaling of the sharded stage A (PyTorch/CUDA port)")
    ap.add_argument("--cells", default="1,2,4,8",
                    help="cell counts, one row band per cell")
    ap.add_argument("--device", default="cuda",
                    help="torch device type of the cells (default: cuda)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    return main(tuple(int(n) for n in args.cells.split(",")),
                out_path=args.out, device=args.device)


if __name__ == "__main__":
    cli()
