"""commit_scan_issue_ms_per_frame.devcommit: device_commit_scan (the host's time to issue every rank step of the device commit engine's scan; nothing in it waits for the device) per frame."""
from benchlib import readers

LAYER = "device commit"
UNIT = "ms/frame"
SOURCE = "program_span"
MOVES = "encode_fps"


def read(record):
    return readers.phase_ms_per_frame(record, ("device_commit_scan",))
