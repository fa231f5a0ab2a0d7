"""device_idle_pct.live: Share of the traced window in which no kernel, copy or memset runs on the card (the union of the profiler's device intervals)."""
from benchlib import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frame_latency_p95_ms"


def read(record):
    return readers.device_idle_pct(record)
