"""encode_fps: Frames returned by all calls of the window over the wall time from the first call's start to the last call's end."""
from benchlib import readers

UNIT = "frames/s"
SOURCE = "host_clock"


def read(record):
    return readers.encode_fps(record)
