"""device_ops_per_commit_step.devcommit: the device operations of the traced window (kernels, copies and memsets; stage A's and the copies of the calls included) over the device commit engine's rank steps (n_commit_steps) in it."""
LAYER = "device commit"
UNIT = "ops/step"
SOURCE = "device_trace"
MOVES = "encode_fps"


def read(record):
    tr, steps = record["trace"], record["phases"].get("n_commit_steps")
    if not tr or not steps:
        return None
    return sum(v[0] for v in tr["kernels"].values()) / steps
