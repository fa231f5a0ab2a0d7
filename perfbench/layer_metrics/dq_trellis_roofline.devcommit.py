"""dq_trellis_roofline.devcommit: The CUDA kernel K1's least time at the positions the device commit engine counted (benchlib/roofline_k1.py) over its device time in the traced window."""
from benchlib import roofline_k1

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "encode_fps"


def read(record):
    return roofline_k1.roofline_pct(record)
