"""frame_latency_p90_ms.live: 90th percentile over all calls of the window of the time from a call's start to its return; a steadier tail beside frame_latency_p95_ms, with twice the calls beyond it."""
from benchlib import readers

LAYER = "whole call"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "frame_latency_p95_ms"


def read(record):
    return readers.latency_pct_ms(record, 90)
