"""dq_greedy_roofline.clip: The CUDA kernel K2's least time at its launch shapes (benchlib/roofline.py) over its device time in the traced window."""
from benchlib import readers

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "encode_fps"


def read(record):
    return readers.dq_greedy_roofline_pct(record)
