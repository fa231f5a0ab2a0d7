"""commit_host_ms_per_frame.devcommit: device_commit_schedule (the schedule, the scan's constants, geometry and row uploads) plus device_commit_writeback (modes, coefficients and refine flags into the CUs) per frame."""
from benchlib import readers

LAYER = "device commit"
UNIT = "ms/frame"
SOURCE = "program_span"
MOVES = "encode_fps"


def read(record):
    return readers.phase_ms_per_frame(
        record, ("device_commit_schedule", "device_commit_writeback"))
