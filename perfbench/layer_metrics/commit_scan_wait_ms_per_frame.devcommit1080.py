"""commit_scan_wait_ms_per_frame.devcommit1080: device_commit_fetch (the commit worker waiting for the card to drain a 1080p rank scan, then the planes and per-step outputs copied to the host) per frame."""
from benchlib import readers

LAYER = "device commit"
UNIT = "ms/frame"
SOURCE = "program_span"
MOVES = "encode_fps"


def read(record):
    return readers.phase_ms_per_frame(record, ("device_commit_fetch",))
