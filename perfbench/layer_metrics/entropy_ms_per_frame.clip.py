"""entropy_ms_per_frame.clip: host_entropy (Encoder.encode: the native CABAC slice coder and NAL writing) per frame."""
from benchlib import readers

LAYER = "entry and CABAC"
UNIT = "ms/frame"
SOURCE = "program_span"
MOVES = "encode_fps"


def read(record):
    return readers.phase_ms_per_frame(record, ("host_entropy",))
