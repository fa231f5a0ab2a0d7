#!/usr/bin/env python3
"""The control of the check that decides `correct`: the program's timed
path with its matmuls in a precision below the float32 (TF32 off) that the
port states, run through the harness's own window and check. A control
that the check does not fail shows the check cannot see that precision.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--precision tf32,bf16] [--program]

The port carries every matmul of stage A (intra prediction, transforms)
through one helper, `kernels.transforms.f32mm` (also bound in
`kernels.intra_pred`). For the control this script rebinds it, in this
process only, to 'tf32' (float32 operands on the TF32 tensor-core path)
or 'bf16' (bfloat16 operands and product). --program first reads the
program as it is (the sound reading). Per seed and reading it runs one
window of `--seconds` at the cell's own load and prints one JSON line
with the check's numbers. The benchmark's own runs do not run this.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def lower_precision(precision):
    """Rebind the port's matmul helper to `precision` for CUDA operands;
    CPU operands keep the exact float32 product."""
    import torch
    from wrenc_tpu_torch.kernels import intra_pred, transforms
    exact = transforms.f32mm
    if precision == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

        def low(a, b):
            return torch.matmul(a.to(torch.float32),
                                b.to(torch.float32)).to(torch.int32)
    elif precision == "bf16":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        def low(a, b):
            return torch.matmul(a.to(torch.bfloat16),
                                b.to(torch.bfloat16)).to(torch.int32)
    else:
        raise ValueError(f"precision {precision!r}: want tf32 or bf16")

    def mm(a, b):
        return low(a, b) if a.is_cuda else exact(a, b)
    transforms.f32mm = mm
    intra_pred.f32mm = mm


def readings(workload, seeds, seconds, precisions, program, device=None):
    """[(seed, what, result)] for the program (with `program`, read first)
    and the control in each of `precisions` in turn: one harness run per
    seed and reading, on `device` (None: the card)."""
    from benchlib import runner
    steps = ([("program", None)] if program else []) + \
        [(f"control_{p}", p) for p in precisions]
    out = []
    for what, p in steps:
        if p is not None:
            lower_precision(p)
        for seed in seeds:
            t0 = time.perf_counter()
            r = runner.run(ROOT, workload, seed, seconds, 0, device=device)
            out.append((seed, what, r))
            print(json.dumps({
                "workload": workload, "seed": seed, "reading": what,
                "correct": r["correct"], "calls": r["attempted"],
                "numbers": {k: v["value"] for k, v in r["checks"].items()},
                "run_s": time.perf_counter() - t0}), flush=True)
    return out


def main(argv):
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--precision", default="tf32,bf16",
                    help="comma-separated, each tf32 or bf16")
    ap.add_argument("--program", action="store_true")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    readings(a.workload, [int(s) for s in a.seeds.split(",")], a.seconds,
             [p for p in a.precision.split(",") if p], a.program)
    return 0


if __name__ == "__main__":
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
    sys.path[:0] = [HERE, ROOT]
    sys.exit(main(sys.argv[1:]))
