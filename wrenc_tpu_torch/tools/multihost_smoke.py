#!/usr/bin/env python3
"""Multi-process smoke test of the PyTorch/CUDA port: the row-band-sharded
luma stage A over TWO processes joined by torch.distributed (gloo) — the
counterpart of scripts/multihost_smoke.py (two JAX processes joined by
jax.distributed).

Both processes make the same seeded planes (W, H, F = 64, 128, 2,
default_rng(0)), and each runs the search's own sharded dispatch
(WavefrontSearch._dispatch_mesh) as its rank of the group: it reads only
its own cells' rows and runs only its own cells
(dist/process_group.py). Two (frame, row) layouts:

- frame 2 x row 4, the JAX script's: four cells per process, devices
  ordered by rank as jax.devices() orders them, so each process holds one
  frame cell's four row bands; the frame axis spans the processes and
  every halo stays inside one. (The JAX docstring says its halo crosses
  the process boundary; with its reshape(2, 4) it is the frame axis that
  does.)
- frame 1 x row 2: one band per process, so the one-row halo crosses the
  process boundary, by send / recv of a CPU tensor.

Every rank gathers the result (all_gather of CPU tensors) and compares it
exactly with the one-device fused_luma_stage_a. The orchestrator exits
nonzero on a mismatch, a failed worker or a worker timeout, and kills the
workers it started.

--device cuda puts each rank's cells on cuda:(rank % card count). The
group's backend stays gloo, which moves CPU copies: on a one-card machine
both ranks share the card, and NCCL does not allow two ranks on one card.

    python -m wrenc_tpu_torch.tools.multihost_smoke [--device cuda|cpu] \
        [--out result.npz] [--timeout 300]
"""
import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

N_PROC = 2
LAYOUTS = {"2x4": (2, 4), "1x2": (1, 2)}
W, H, F, QP = 64, 128, 2, 32
SIZES = (4, 8, 16, 32)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def worker(rank, port, device, out=None):
    """One rank: join the group, run its share of each layout, gather,
    compare with one device. Prints a RESULT line; returns 0 when every
    layout matched exactly."""
    import torch
    from .. import dist
    from ..core.config import EncoderConfig
    from ..dist import process_group as pg
    from ..kernels import quantize as kq
    from ..kernels import trellis as ktr
    from ..search import wavefront as wf
    from .scaling_bench import stage_a_args
    if device == "cpu":
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        dev = dist.cuda_devices()[rank % torch.cuda.device_count()]
    counters = {"dq_greedy": kq.greedy_depquant,
                "dq_trellis": ktr.trellis_rate,
                "dq_trellis_batch": ktr.trellis_rate_batch}
    cfg = EncoderConfig(width=W, height=H, qp=QP)
    pg.init_group(rank, N_PROC, port)
    try:
        planes = np.random.default_rng(0).integers(
            0, 256, (F, H, W)).astype(np.uint8)     # same data everywhere
        single = wf._fetch_cells(wf.fused_luma_stage_a(
            torch.from_numpy(planes).to(dev), W, H, 5, SIZES, sel=False,
            **stage_a_args(cfg, dev)))
        ok, report, saved = True, {}, {}
        for name, shape in LAYOUTS.items():
            # this rank's device stands for every cell; only its own run
            search = wf.WavefrontSearch(cfg, mesh=dist.Mesh(
                [[dev] * shape[1]] * shape[0], ("frame", "row")))
            for f in counters.values():
                f.launches = 0
            cells = search._dispatch_mesh(planes, list(SIZES), rank, N_PROC)
            launches = {k: f.launches for k, f in counters.items()}
            got = wf._fetch_cells(pg.gather_cells(cells, N_PROC))
            same = all(x.dtype == y.dtype and x.shape == y.shape
                       and x.tobytes() == y.tobytes()
                       for s in SIZES for x, y in zip(got[s], single[s]))
            ok &= same
            report[name] = {"cells": pg.rank_cells(shape, rank, N_PROC),
                            "exact": same, "launches": launches}
            print(f"[p{rank}] {name} row-band stage A on {dev}: "
                  f"{'OK (exact match)' if same else 'MISMATCH'}",
                  flush=True)
            for s in SIZES:
                for i, x in enumerate(got[s]):
                    saved[f"{name}_s{s}_{i}"] = x
        if out and rank == 0:
            np.savez(out, **saved)
    finally:
        torch.distributed.destroy_process_group()
    print("RESULT " + json.dumps({"rank": rank, "device": str(dev),
                                  "ok": ok, "layouts": report}), flush=True)
    return 0 if ok else 1


def _pump(proc, rank, lines):
    for line in proc.stdout:
        lines.append(line)
        print(f"[worker {rank}] {line}", end="", flush=True)


def run(device="cuda", out=None, timeout=300):
    """Start the N_PROC workers, wait for them (at most `timeout` seconds,
    then kill them), and return {"ok", "failure", "returncodes", "port",
    "seconds", "ranks": each rank's RESULT, "launches": each kernel's
    launches in the sharded runs, summed over the ranks and layouts}. The
    group's port is SMOKE_PORT, else a free one."""
    from ..search.wavefront import resolve_device
    from ..dist.process_group import free_port
    resolve_device(device)
    port = int(os.environ.get("SMOKE_PORT", 0)) or free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    procs, pumps, outputs = [], [], []
    for i in range(N_PROC):
        cmd = [sys.executable, "-m", "wrenc_tpu_torch.tools.multihost_smoke",
               "--worker", str(i), "--port", str(port), "--device", device]
        if out and i == 0:
            cmd += ["--out", os.path.abspath(out)]
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
        outputs.append([])
        pumps.append(threading.Thread(target=_pump,
                                      args=(procs[-1], i, outputs[-1])))
        pumps[-1].start()
    timed_out = False
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.perf_counter() - t0 > timeout:
                timed_out = True
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for t in pumps:
            t.join()
    rcs = [p.returncode for p in procs]
    failed = (f"timeout after {timeout} s" if timed_out else
              "a worker failed" if any(rcs) else None)
    ranks = [json.loads(ln[len("RESULT "):]) for lines in outputs
             for ln in lines if ln.startswith("RESULT ")]
    ok = failed is None and not any(rcs) and len(ranks) == N_PROC and all(
        r["ok"] for r in ranks)
    return {"ok": ok, "failure": failed, "returncodes": rcs, "port": port,
            "seconds": time.perf_counter() - t0, "ranks": ranks,
            "launches": {k: sum(v["launches"][k] for r in ranks
                                for v in r["layouts"].values())
                         for k in ("dq_greedy", "dq_trellis",
                                   "dq_trellis_batch")}}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="two-process row-band stage A (PyTorch/CUDA port)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None,
                    help="rank 0 writes the gathered results here (.npz)")
    ap.add_argument("--timeout", type=float, default=300)
    ap.add_argument("--worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        return worker(args.worker, args.port, args.device, args.out)
    res = run(args.device, args.out, args.timeout)
    if not res["ok"]:
        print(f"multihost smoke FAILED: {res['failure']}, return codes "
              f"{res['returncodes']}", flush=True)
        return 1
    print(f"multihost smoke PASSED: {N_PROC} processes, layouts "
          f"{', '.join(LAYOUTS)}, halo across the process boundary in 1x2, "
          f"exact results", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
