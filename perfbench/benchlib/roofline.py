"""The yardstick for kernel roofline shares: the H100's published peaks and
the bytes and operations of the CUDA kernel K2 (dq_greedy) at the launch
shapes of the default path.

Peaks (NVIDIA H100 SXM data sheet, at its 700 W limit): 3.35 TB/s of HBM3;
67 TFLOP/s f32 on the CUDA cores. The sheet gives no integer rate, so the
operation bound takes the issue ceiling derived from the f32 line: 4
schedulers x 32 lanes = 128 instructions per SM per clock, 67e12 / 2 =
33.5e12 per second. (Copied from chip_smoke.py.)

K2's count (copied from chip_smoke._launch_bound): per launch of B blocks
of P coefficient positions it reads int32 coefficients and writes int16
levels and one f32 rate per block, 6 * P * B + 4 * B bytes, and needs 48
32-bit operations per position, the sequential scan's step (two candidate
costs of 13 each, the level pick, the rate and the state update).

K2's launches per stage-A chunk (chip_smoke's SIZES / N_CANDS and
_chroma_jobs): one per luma QT size s at B = F * (W / s) * (H / s) * 6
(the K + 2 = 6 RD candidates of each block), and where chroma stage A runs
on the device (>= 0.5 Mpx) seven more: per chroma size cs in 4, 8, 16 the
derived modes at B = 2 * F * N (at cs 4 twice: derived and SCIPU) and the
three CCLM candidates at B = 6 * F * N, N = (W / 2 / cs) * (H / 2 / cs).
F is the chunk's bucketed frame count. The program splits a call into
chunks of at most the largest bucket (1, 2, 4, 8) whose frames stay under
3.5 Mpx and pads each chunk up to a bucket.
"""
HBM_BYTES_S = 3.35e12
INT_OPS_S = 67e12 / 2
OPS_PER_POS = {"dq_greedy": 48}
BATCH_BUCKETS = (1, 2, 4, 8)
CHUNK_PIXEL_BUDGET = 3_500_000
CHROMA_DEVICE_PIXELS = 1 << 19
N_CANDS = 6


def launch_bound_s(P, B, kname="dq_greedy"):
    """(bytes seconds, operations seconds) of one launch."""
    return ((6 * P * B + 4 * B) / HBM_BYTES_S,
            OPS_PER_POS[kname] * P * B / INT_OPS_S)


def chunk_frames(width, height, n_frames):
    """The bucketed frame count of each chunk of an n-frame call."""
    px = width * height
    buckets = [b for b in BATCH_BUCKETS if b * px <= CHUNK_PIXEL_BUDGET] or [1]
    out = []
    for k in range(0, n_frames, buckets[-1]):
        n = min(buckets[-1], n_frames - k)
        out.append(next(b for b in buckets if n <= b))
    return out


def k2_launches(width, height, log2_ctu, max_split_depth, n_frames):
    """[(P, B)] of K2's launches in one n-frame call of the default path."""
    sizes = [1 << (log2_ctu - d) for d in range(max_split_depth, -1, -1)]
    out = []
    for F in chunk_frames(width, height, n_frames):
        out += [(s * s, F * (width // s) * (height // s) * N_CANDS)
                for s in sizes]
        if width * height >= CHROMA_DEVICE_PIXELS:
            for cs in (4, 8, 16):
                N = (width // 2 // cs) * (height // 2 // cs)
                out += [(cs * cs, 2 * F * N)] * (2 if cs == 4 else 1)
                out.append((cs * cs, 6 * F * N))
    return out


def k2_bound_s(launches):
    """The least time of the launches: per launch the larger of its bytes
    and its operations bound, summed."""
    return sum(max(launch_bound_s(P, B)) for P, B in launches)
