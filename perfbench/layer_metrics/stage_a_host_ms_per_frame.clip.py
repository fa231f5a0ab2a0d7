"""stage_a_host_ms_per_frame.clip: Host time of stage A per frame: device_dispatch (launching fused_luma_stage_a), device_stage_a (blocked on its results) and host_chroma_rd (fused_chroma_stage_a, or the native chroma stage A below 0.5 Mpx)."""
from benchlib import readers

LAYER = "stage A"
UNIT = "ms/frame"
SOURCE = "program_span"
MOVES = "encode_fps"


def read(record):
    return readers.phase_ms_per_frame(record, ("device_dispatch", "device_stage_a", "host_chroma_rd"))
