"""commit_capture_ms_per_frame.devcommit1080: device_commit_capture (the device commit engine capturing the CUDA graph of a rank-step shape it had not run before, inside device_commit_scan) per frame. 0 where the window captured no graph (n_commit_graph_captures 0); nothing where the program has captures but no such span."""
from benchlib import readers

LAYER = "device commit"
UNIT = "ms/frame"
SOURCE = "program_span"
MOVES = "encode_fps"


def read(record):
    ph = record["phases"]
    if ph.get("n_commit_graph_captures") == 0 and record["frames"]:
        return 0.0
    return readers.phase_ms_per_frame(record, ("device_commit_capture",))
