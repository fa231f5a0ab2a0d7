"""commit_ms_per_frame.live: host_commit per frame: with one chunk per call the commit runs in turn, so this is its whole time."""
from benchlib import readers

LAYER = "native commit"
UNIT = "ms/frame"
SOURCE = "program_span"
MOVES = "frame_latency_p95_ms"


def read(record):
    return readers.phase_ms_per_frame(record, ("host_commit",))
