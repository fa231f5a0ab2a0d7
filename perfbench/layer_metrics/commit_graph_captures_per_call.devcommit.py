"""commit_graph_captures_per_call.devcommit: the CUDA graphs the device commit engine captured in the window (n_commit_graph_captures: one per rank-step shape it had not run before; every other step replays one), over the window's calls."""
LAYER = "device commit"
UNIT = "captures/call"
SOURCE = "program_counter"
MOVES = "encode_fps"


def read(record):
    n = record["phases"].get("n_commit_graph_captures")
    if n is None or not record["calls"]:
        return None
    return n / len(record["calls"])
