"""device_idle_pct.devcommit1080: Share of the traced window in which no kernel, copy or memset runs on the card (the union of the profiler's device intervals), in the 1080p device commit cell."""
from benchlib import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "encode_fps"


def read(record):
    return readers.device_idle_pct(record)
