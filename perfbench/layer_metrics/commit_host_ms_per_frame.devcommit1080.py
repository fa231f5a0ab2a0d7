"""commit_host_ms_per_frame.devcommit1080: device_commit_schedule (the schedule of a scan's 8,160 CTUs, its padded steps, their upload) plus device_commit_writeback (modes, coefficients and refine flags into the CUs), the device commit's Python half, per frame."""
from benchlib import readers

LAYER = "device commit"
UNIT = "ms/frame"
SOURCE = "program_span"
MOVES = "encode_fps"


def read(record):
    return readers.phase_ms_per_frame(
        record, ("device_commit_schedule", "device_commit_writeback"))
