"""The benchmark harness of wrenc_tpu_torch (see perfbench/README.md).

spec      BENCHMARK.json and the files it names, found by name
content   the synthetic frame generator that the traffic files parametrise
runner    set-up, the closed-loop window, the result line
tracing   the profiler's trace reduced to device intervals and gaps
roofline  the H100's peaks and the K2 (dq_greedy) launch count
capture   keeps the sampled calls' luma stage-A outputs
checks    the comparison that decides `correct`: the spec decoder
          (vvcref) and the stage-A model
stage_a_ref  the scalar spec model of luma stage A
readers   small helpers that the per-layer metric files share

Nothing here imports jax or the JAX package; the program is imported only
inside the functions that run it.
"""
