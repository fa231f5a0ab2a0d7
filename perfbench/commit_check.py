#!/usr/bin/env python3
"""The plain reference of the device RD commit's re-decision
(benchlib/commit_ref.py) against the program, at a cell's own load.

    python3 perfbench/commit_check.py --workload cif_qp32_device_commit \
        --seeds 1,2,3 --seconds 51 [--precision bf16]

Per seed it runs the harness's window (benchlib/runner.py's set-up and
closed loop, its stage-A capture and its reservoir sample of calls, from
the same seed streams), then decodes the sampled calls' picked pictures
(the pictures the harness's decode check draws) with the recording spec
decoder and rebuilds the commit's decisions of `check_blocks_per_size`
coded blocks of each class, drawn from the seed. It prints one JSON line
per seed: the three numbers beside their limits, and whether all hold.
--precision bf16 (or tf32) first rebinds the program's matmul helper in
this process (control.lower_precision), the control that the numbers
must catch. The benchmark's own runs do not run this.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def run(root, workload, seed, seconds, device=None):
    """{'calls', 'numbers', 'passes'} of one window of `workload` on
    `device` (None: the card)."""
    from benchlib import capture, commit_ref, content, runner, spec
    import torch
    c = spec.cell(spec.load_benchmark(root), workload, root,
                  os.path.join(root, "perfbench"))
    from wrenc_tpu_torch.core.config import EncoderConfig
    from wrenc_tpu_torch.encoder import Encoder
    from wrenc_tpu_torch.search import WavefrontSearch, wavefront
    config, traffic = c["config"], c["traffic"]
    cfg = EncoderConfig(**dict(config["encoder_config"], qp=traffic["qp"]))
    enc = Encoder(cfg, search=WavefrontSearch(cfg, device=device,
                                              **config.get("search", {})))
    cap = capture.StageACapture(wavefront).install()
    try:
        picture, coded = tuple(config["picture"]), (cfg.width, cfg.height)
        pool = content.make_frames(traffic["content"], picture, coded,
                                   traffic["pool_frames"],
                                   content.seed_sequence(seed, 0))
        warm = content.make_frames(traffic["content"], picture, coded,
                                   traffic["frames_per_call"],
                                   content.seed_sequence(seed, 1))
        sync = torch.cuda.synchronize if device is None else (lambda: None)
        enc.encode(warm)
        sync()
        calls, kept = runner._window(
            enc, enc.encode, pool, traffic["frames_per_call"], seconds, sync,
            cap, int(traffic["check_calls"]), content.seed_sequence(seed, 2))
        stage_a = {i: capture.StageACapture.fetch(ch)
                   for i, ch in kept.items()}
    finally:
        cap.uninstall()
    made = pool + warm
    rng = content.seed_sequence(seed, 3)
    total = {"commit_levels_differing": 0, "commit_picks_differing": 0,
             "commit_cost_gap": 0.0}
    if not stage_a:
        total["commit_picks_differing"] += 1
    for i in sorted(stage_a):
        frames = [made[j] for j in calls[i].idx]
        n_pics = traffic.get("check_pictures") or len(frames)
        pics = sorted(int(j) for j in rng.choice(
            len(frames), size=min(n_pics, len(frames)), replace=False))
        commit_ref.add(total, commit_ref.numbers(
            frames, calls[i].stream, pics,
            commit_ref.cand_rows(stage_a[i], frames), traffic["qp"], config,
            int(traffic["check_blocks_per_size"]), rng))
    return {"calls": len(calls), "numbers": total,
            "passes": commit_ref.passes(total)}


def main(argv):
    ap = argparse.ArgumentParser(prog="perfbench/commit_check.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--precision", default="",
                    help="tf32 or bf16: the control; none: the program")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("commit_check: no CUDA device", file=sys.stderr)
        return 2
    from benchlib import commit_ref
    if a.precision:
        from control import lower_precision
        lower_precision(a.precision)
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        r = run(ROOT, a.workload, seed, a.seconds)
        print(json.dumps({
            "workload": a.workload, "seed": seed,
            "reading": f"control_{a.precision}" if a.precision else "program",
            "calls": r["calls"], "passes": r["passes"],
            "numbers": {k: {"value": v, "limit": commit_ref.LIMITS[k]}
                        for k, v in r["numbers"].items()},
            "run_s": time.perf_counter() - t0,
            "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
    sys.path[:0] = [HERE, ROOT]
    sys.exit(main(sys.argv[1:]))
