"""frame_latency_p95_ms: 95th percentile over all calls of the window of the time from a call's start to its return (ending in torch.cuda.synchronize()); one frame per call in the cells that report it."""
from benchlib import readers

UNIT = "ms"
SOURCE = "host_clock"


def read(record):
    return readers.latency_pct_ms(record, 95)
