"""The program's spans (wrenc_tpu_torch.trace) on the profiler's time axis:
a span drained from the program and merged into the Chrome trace that
torch.profiler exports (trace.merge_chrome_trace) must contain the work
it wrapped. On the CPU with CPU activity; on the card with CUDA activity
only, as the traced run records it."""
import time

import pytest

TOL_US = 500.0


def _profiled(activities, work):
    """Run work() in the span `probe` under torch.profiler, export the
    trace and merge the drained spans into it: (the trace's events, the
    probe span's event)."""
    import json
    import os
    import tempfile

    from torch.profiler import profile
    from wrenc_tpu_torch import trace
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.json")
        try:
            trace.enable()
            with profile(activities=activities) as prof:
                time.sleep(0.02)
                with trace.span("probe"):
                    work()
                time.sleep(0.02)
            drained = trace.drain()
        finally:
            trace.disable()
        prof.export_chrome_trace(path)
        (probe,) = trace.merge_chrome_trace(path, drained)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return events, probe


def _inside(ev, span):
    return (span["ts"] - TOL_US <= ev["ts"]
            and ev["ts"] + ev["dur"] <= span["ts"] + span["dur"] + TOL_US)


def test_a_span_contains_its_host_op_on_the_cpu():
    import torch
    from torch.profiler import ProfilerActivity
    a = torch.randn(400, 400)
    events, probe = _profiled([ProfilerActivity.CPU], lambda: a @ a)
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert _inside(mm, probe), (mm, probe)
    # the sleeps around the span lie outside it
    assert probe["dur"] < 20_000


@pytest.mark.card
def test_a_span_contains_its_kernel_on_the_card(card):
    import torch
    from torch.profiler import ProfilerActivity
    a = torch.randn(4096, 4096, device=card)
    a @ a                       # cuBLAS set up before the profile
    torch.cuda.synchronize()

    def work():
        for _ in range(4):
            a @ a
        torch.cuda.synchronize()
    events, probe = _profiled([ProfilerActivity.CUDA], work)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert len(kernels) >= 4, sorted({e.get("cat") for e in events})
    offsets = [(k["ts"] - probe["ts"], probe["ts"] + probe["dur"] - k["ts"]
                - k["dur"]) for k in kernels]
    assert all(_inside(k, probe) for k in kernels), (offsets, probe)
    # the first kernel starts right after the span's start: launch latency
    assert min(k["ts"] for k in kernels) - probe["ts"] < TOL_US + 5_000, (
        offsets, probe)
