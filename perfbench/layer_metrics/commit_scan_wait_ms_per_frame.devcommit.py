"""commit_scan_wait_ms_per_frame.devcommit: device_commit_fetch (the host waiting for the device to drain the scan, then the planes and per-step outputs copied to it) per frame."""
from benchlib import readers

LAYER = "device commit"
UNIT = "ms/frame"
SOURCE = "program_span"
MOVES = "encode_fps"


def read(record):
    return readers.phase_ms_per_frame(record, ("device_commit_fetch",))
