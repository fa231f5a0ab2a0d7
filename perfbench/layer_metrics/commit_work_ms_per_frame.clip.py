"""commit_work_ms_per_frame.clip: host_commit_work (the native RD commit's own wall time in its worker thread, search/wavefront._commit_timed) per frame; recorded where a call has more than one chunk."""
from benchlib import readers

LAYER = "native commit"
UNIT = "ms/frame"
SOURCE = "program_span"
MOVES = "encode_fps"


def read(record):
    return readers.phase_ms_per_frame(record, ("host_commit_work",))
