"""commit_wait_pct.devcommit1080: host_commit (the main thread blocked on the device commit's worker) as a share of the calls' wall time: how much of the two scans per call the overlap with the second chunk's stage A and decide leaves exposed."""
from benchlib import readers

LAYER = "device commit"
UNIT = "%"
SOURCE = "program_span"
MOVES = "encode_fps"


def read(record):
    return readers.phase_pct_of_wall(record, "host_commit")
