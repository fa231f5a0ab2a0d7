"""The yardstick for the roofline share of the CUDA kernel K1 (dq_trellis),
the 8-state dependent-quantization Viterbi that the device commit engine
launches once per wave of its rank scan.

Peaks: roofline.py's (imported). K1's count (PERF.md, the port's kernel
table): per coefficient position 315 32-bit operations, the Viterbi
step's 16 edges relaxed into 8 states (each edge's candidate level,
distortion, rate lookups, refund and compare), and 6 bytes, an int32
coefficient read and an int16 level written; per block 4 bytes more, its
f32 rate. A launch of jobs [(P, B)] (P positions per block, B blocks)
needs 315 * sum(P * B) operations and sum(6 * P * B + 4 * B) bytes, and
its least time is the larger of operations / INT_OPS_S and bytes /
HBM_BYTES_S.

At every K1 shape P >= 16 (4 x 4 blocks and up), and there the operations
bound the launch: 315 / 33.5e12 = 9.40e-12 s per position against at most
(6 + 4 / 16) / 3.35e12 = 1.87e-12 s of bytes. So the least time of a
window's launches is 315 * (their positions) / INT_OPS_S, which needs
only the positions the program counts (`n_dq_trellis_positions`).
"""
from .roofline import HBM_BYTES_S, INT_OPS_S

OPS_PER_POS = 315


def launch_bound_s(jobs):
    """The least time of one K1 launch of jobs [(P, B)]: the larger of its
    bytes and its operations bound."""
    n_bytes = sum(6 * P * B + 4 * B for P, B in jobs)
    n_ops = OPS_PER_POS * sum(P * B for P, B in jobs)
    return max(n_bytes / HBM_BYTES_S, n_ops / INT_OPS_S)


def positions_bound_s(positions):
    """The least time of launches that hold `positions` coefficient
    positions in all, every job of them at P >= 16 (the operations bound)."""
    return OPS_PER_POS * positions / INT_OPS_S


def roofline_pct(record):
    """Share of K1's device time in the traced window that its least time
    makes up, from the scan's counted positions. None without a trace or
    the program's counts, and unless the trace holds exactly the K1
    launches that the program counted (another launch of K1, or a count
    that missed one, would be read wrong)."""
    tr, ph = record["trace"], record["phases"]
    launches = ph.get("n_dq_trellis_launches")
    positions = ph.get("n_dq_trellis_positions")
    if not tr or not launches or not positions:
        return None
    hits = [v for n, v in tr["kernels"].items() if "dq_trellis" in n]
    count, secs = sum(v[0] for v in hits), sum(v[1] for v in hits)
    if count != launches or not secs:
        return None
    return 100.0 * positions_bound_s(positions) / secs
