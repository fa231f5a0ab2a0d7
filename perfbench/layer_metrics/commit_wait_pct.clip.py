"""commit_wait_pct.clip: host_commit (the main thread blocked on the commit) as a share of the calls' wall time."""
from benchlib import readers

LAYER = "native commit"
UNIT = "%"
SOURCE = "program_span"
MOVES = "encode_fps"


def read(record):
    return readers.phase_pct_of_wall(record, "host_commit")
