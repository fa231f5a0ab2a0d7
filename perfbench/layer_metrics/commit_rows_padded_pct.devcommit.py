"""commit_rows_padded_pct.devcommit: the device commit engine's padded rows (n_commit_rows_padded: each class's rows of a rank step padded up to its row cap) as a share of all the rows its rank steps ran (n_commit_rows_live + n_commit_rows_padded), over the window's calls."""
LAYER = "device commit"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "encode_fps"


def read(record):
    ph = record["phases"]
    live, pad = ph.get("n_commit_rows_live"), ph.get("n_commit_rows_padded")
    if live is None or pad is None or not live + pad:
        return None
    return 100.0 * pad / (live + pad)
