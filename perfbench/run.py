#!/usr/bin/env python3
"""Benchmark of wrenc_tpu_torch on one NVIDIA GPU.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints diagnostics on standard error, the
numbers that decide `correct` beside their limits as its last lines, and as
the last line of standard output one JSON object (correct, attempted,
failed, metrics, device[, breakdown], checks). With --trace 0 the metrics
are the cell's end-to-end metrics, with --trace 1 its per-layer metrics.
Exits nonzero, printing no result, without the cards the cell asks for,
or when jax, jaxlib, flax or the JAX package wrenc_tpu is loaded.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(1, ROOT)

if __name__ == "__main__":
    from benchlib import runner
    sys.exit(runner.main(sys.argv[1:], T_START))
