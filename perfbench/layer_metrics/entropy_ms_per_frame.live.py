"""entropy_ms_per_frame.live: host_entropy (Encoder.encode: the native CABAC slice coder and NAL writing) per frame."""
from benchlib import readers

LAYER = "entry and CABAC"
UNIT = "ms/frame"
SOURCE = "program_span"
MOVES = "frame_latency_p95_ms"


def read(record):
    return readers.phase_ms_per_frame(record, ("host_entropy",))
