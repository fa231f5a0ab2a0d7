"""Spans and counters of one process, recorded in memory while switched on.

The recorder is off by default. `enable()` switches it on and empties it,
`drain()` hands over what it holds and empties it again, `disable()`
switches it off. It is one per process, as torch.profiler is: the kernel
wrappers that count into it are plain functions with no object to carry
it. Nothing else reads it: the program's own per-call sums
(`WavefrontSearch.phase_times`) are kept by `span` whether the recorder
is on or off.

A span is a `with span(name, sums, **attrs)` block. Off, it costs one
`perf_counter_ns` pair and, when given a `sums` dict, one add into it.
On, it also records its name, its start and end (ns on the
`perf_counter_ns` clock; `drain()` gives the offset to Unix time), its
thread, its parent (the innermost span open on the same thread), and the
`call` and `chunk` of the `Encoder.encode` call it belongs to: given as
attributes, or else inherited from the parent. `call()` opens the root
span `encode` of a call, with a new call id, where the thread has no
open span.

A counter counts launches of one kernel at one launch shape on one device
type, per call and chunk (those of the innermost open span), so memory
grows with the distinct shapes, not with the launches.

A device mark (`device_mark`) is a CUDA event recorded on the device's
current stream, or on the CPU, whose operations run in turn, the host
clock; `device_seconds` reads the time between two marks without
waiting, or None while the later one has not been reached.

`merge_chrome_trace` appends drained spans to a trace that
torch.profiler exported, on its time axis, so that the host's phases
and the device's kernels lie on one timeline (Perfetto, chrome://tracing).
"""
import collections
import contextlib
import functools
import itertools
import json
import os
import threading
import time

import torch

_state = threading.local()
_lock = threading.Lock()
_on = False
_spans = []
_counts = collections.Counter()
_ids = itertools.count(1)
_calls = itertools.count()


def enable():
    """Switch the recorder on, empty."""
    global _on
    drain()
    _on = True


def disable():
    global _on
    _on = False


def _unix_offset_ns():
    """Unix time minus perf_counter_ns, in ns: the tightest of a few
    readings of both clocks."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


def drain():
    """{'spans': [...], 'counters': [...], 'unix_offset_ns': int}, and the
    recorder emptied. A span: {'name', 't0_ns', 't1_ns' (perf_counter_ns),
    'thread', 'id', 'parent', 'call', 'chunk', 'attrs'}; a counter:
    {'kernel', 'jobs' ([[P, B]] per job of the launch), 'device', 'call',
    'chunk', 'count'}. Spans still open are not included."""
    global _spans, _counts
    with _lock:
        spans, counts = _spans, _counts
        _spans, _counts = [], collections.Counter()
    return {"spans": spans,
            "counters": [{"kernel": k, "jobs": [list(j) for j in jobs],
                          "device": dev, "call": c, "chunk": ch, "count": n}
                         for (k, jobs, dev, c, ch), n in counts.items()],
            "unix_offset_ns": _unix_offset_ns()}


def _stack():
    st = getattr(_state, "stack", None)
    if st is None:
        st = _state.stack = []
    return st


class span:
    """`with span(name, sums=None, **attrs) as sp:` times its block. sums:
    a dict that gets the block's seconds added under `name`. attrs: call,
    chunk and any other attributes of the recorded span."""
    __slots__ = ("name", "sums", "attrs", "t0", "t1", "rec")

    def __init__(self, name, sums=None, **attrs):
        self.name, self.sums, self.attrs, self.rec = name, sums, attrs, None

    def __enter__(self):
        if _on:
            st = _stack()
            parent = st[-1] if st else None
            a = self.attrs
            self.rec = {
                "name": self.name, "t0_ns": 0, "t1_ns": 0,
                "thread": threading.get_native_id(), "id": next(_ids),
                "parent": parent["id"] if parent else None,
                "call": a.pop("call", parent["call"] if parent else None),
                "chunk": a.pop("chunk", parent["chunk"] if parent else None),
                "attrs": a}
            st.append(self.rec)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.sums is not None:
            self.sums[self.name] = self.sums.get(self.name, 0.0) + self.seconds
        rec = self.rec
        if rec is not None:
            rec["t0_ns"], rec["t1_ns"] = self.t0, self.t1
            st = _stack()
            if st and st[-1] is rec:
                st.pop()
            with _lock:
                _spans.append(rec)
        return False

    @property
    def seconds(self):
        return (self.t1 - self.t0) * 1e-9


def call():
    """The root span `encode` of a call, with a new call id; nothing where
    the recorder is off or this thread already has an open span."""
    if not _on or _stack():
        return contextlib.nullcontext()
    return span("encode", call=next(_calls), chunk=None)


def context():
    """{'call', 'chunk'} of this thread's innermost open span (empty
    without one), for work handed to another thread."""
    st = _stack() if _on else None
    return {"call": st[-1]["call"], "chunk": st[-1]["chunk"]} if st else {}


def annotate(**attrs):
    """Add attributes to this thread's innermost open span."""
    st = _stack() if _on else None
    if st:
        st[-1]["attrs"].update(attrs)


def count(kernel, device, blocks):
    """One launch of `kernel` on a device of type `device` over `blocks`,
    the (B, n, n) coefficient tensor of each of its jobs, counted under
    its jobs' (P, B): positions per block and blocks."""
    if not _on:
        return
    st = _stack()
    top = st[-1] if st else None
    jobs = tuple((t.shape[1] * t.shape[2], t.shape[0]) for t in blocks)
    key = (kernel, jobs, device, top and top["call"], top and top["chunk"])
    with _lock:
        _counts[key] += 1


def device_mark(device):
    """A point in `device`'s work (None while the recorder is off): a
    CUDA event recorded on its current stream, or on the CPU the host
    clock."""
    if not _on:
        return None
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev
    return time.perf_counter_ns()


def device_seconds(m0, m1):
    """Seconds of device work from mark m0 to m1; None for a missing mark
    or while the device has not reached m1 (never waits)."""
    if m0 is None or m1 is None:
        return None
    if isinstance(m0, int):
        return (m1 - m0) * 1e-9
    if not m1.query():
        return None
    return m0.elapsed_time(m1) * 1e-3


def merge_chrome_trace(path, drained):
    """Append the spans of `drained` (drain()'s) to the Chrome trace file
    at `path`, as torch.profiler's export_chrome_trace writes it, on its
    time axis: "X" events of this process, one track per thread, ts and
    dur in µs, ts from the file's `baseTimeNanoseconds` on the Unix clock;
    args: the span's call, chunk, id, parent and attributes. Returns the
    events appended."""
    with open(path) as f:
        doc = json.load(f)
    off = drained["unix_offset_ns"] - doc.get("baseTimeNanoseconds", 0)
    events = [{"ph": "X", "cat": "wrenc_span", "name": s["name"],
               "pid": os.getpid(), "tid": s["thread"],
               "ts": (s["t0_ns"] + off) * 1e-3,
               "dur": (s["t1_ns"] - s["t0_ns"]) * 1e-3,
               "args": dict(s["attrs"], call=s["call"], chunk=s["chunk"],
                            id=s["id"], parent=s["parent"])}
              for s in drained["spans"]]
    doc["traceEvents"].extend(events)
    with open(path, "w") as f:
        json.dump(doc, f)
    return events


def table(fn):
    """Decorator for the body of a cached host-table builder (put it under
    `functools.lru_cache`): each run of the body, a cache miss, is a
    `setup_tables` span named by the builder."""
    @functools.wraps(fn)
    def body(*a, **kw):
        with span("setup_tables", table=fn.__name__):
            return fn(*a, **kw)
    return body
