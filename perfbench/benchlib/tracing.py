"""The profiler's device trace (torch.profiler with CUDA activity only, its
Chrome trace JSON) reduced to what the per-layer metrics and the
breakdown read.

Device work is every event of the categories kernel, gpu_memcpy and
gpu_memset. The runner launches one marker kernel right after it starts
the profiler and one right before it stops it, each on an idle device,
so the first and the last device events bound the traced window; busy
time is the union of the device intervals between them.
"""
import bisect
import collections
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load(path):
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def device_events(events):
    """[(start µs, end µs, name)] of the device work, by start."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e.get("name", "?"))
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)


def reduce(events, call_starts=()):
    """{'window_s', 'busy_s', 'kernels': {name: [count, seconds]},
    'device_ops': [[name, seconds]] (top 10), 'idle_gaps': [[name,
    seconds]] (top 10)}, or None without device events. call_starts: the
    calls' start times in seconds from the window's start (host clock),
    which name the call a gap falls in."""
    dev = device_events(events)
    if not dev:
        return None
    w0, w1 = dev[0][0], max(b for _, b, _ in dev)
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for a, b, n in dev[1:-1]:                 # the markers are no work
        kernels[n][0] += 1
        kernels[n][1] += (b - a) * 1e-6
    busy, gaps, cur_end, prev_name = 0.0, [], w0, dev[0][2]
    for a, b, n in dev:
        if a > cur_end:
            gaps.append((cur_end, a, prev_name))
        if b > cur_end:
            busy += b - max(a, cur_end)
            cur_end, prev_name = b, n
    gaps.sort(key=lambda g: g[0] - g[1])

    def where(t):
        i = bisect.bisect_right(list(call_starts), (t - w0) * 1e-6)
        return f"call {i - 1}" if i else "before the first call"
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "kernels": dict(kernels),
        "device_ops": sorted(([n[:160], v[1]] for n, v in kernels.items()),
                             key=lambda t: -t[1])[:10],
        "idle_gaps": [[f"{where((a + b) / 2)}: host work after "
                       f"{prev[:120]}", (b - a) * 1e-6]
                      for a, b, prev in gaps[:10]],
    }
