"""decide_ms_per_frame.clip: host_decide (WavefrontSearch._decide_chunk: the Python QT decision and tree assembly) per frame."""
from benchlib import readers

LAYER = "search host half"
UNIT = "ms/frame"
SOURCE = "program_span"
MOVES = "encode_fps"


def read(record):
    return readers.phase_ms_per_frame(record, ("host_decide",))
