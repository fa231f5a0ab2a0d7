"""PSNR / SSIM / BD-rate metrics (evaluation-harness parity with
tools/evaluation in the reference: evaluate_mp.py, calculate_bd_rate_*),
plus the MFU estimate the perf results record. A copy of
wrenc_tpu/tools/metrics.py whose MFU is taken against the H100."""
import numpy as np

# H100 SXM (NVIDIA data sheet): 67 TFLOP/s f32 on the CUDA cores = 132 SMs
# x 128 FMA lanes x 2 flops x 1.98 GHz, i.e. 33.5e12 f32 multiply-adds per
# second. The port's stage-A matmuls run in exact f32 with TF32 off, so
# this is the peak they can reach.
H100_PEAK_MACS = 67e12 / 2


def device_mac_estimate(W, H, frames, max_depth=3, K=6, n_cand=8,
                        cclm=True):
    """Logical multiply-accumulate count of the device compute per
    encode — a documented ESTIMATE for the MFU figure. Exact for the
    stage-A sweeps; the commit re-ranking is approximated as one more
    stage-A-shaped pass (one 67-mode sweep + n_cand RD evals per
    aligned block of every size):

    - stage A luma, per size s: N blocks x (two 67-mode matmuls of
      2L x s^2 each + (K+2) RD evals of ~4 s^3 transform MACs)
    - chroma stage A, per cs: derived (2 comps) + 3 CCLM candidates
    - commit: the same sweep shape with K+2 -> n_cand.
    """
    total = 0.0
    for d in range(max_depth + 1):
        s = 32 >> d
        N = (W // s) * (H // s) * frames
        L2 = 2 * (4 * s + 1)
        sweep = 2 * L2 * 67 * s * s
        total += N * (sweep + (K + 2) * 4 * s ** 3)      # stage A
        total += N * (sweep + n_cand * 4 * s ** 3)       # commit approx
        if s >= 8:
            cs = s // 2
            Nc = (W // 2 // cs) * (H // 2 // cs) * frames
            Lc2 = 2 * (4 * cs + 1)
            total += Nc * 2 * (2 * Lc2 * cs * cs + 4 * cs ** 3)
            if cclm:
                total += Nc * 6 * 4 * cs ** 3
    return total


def mfu_estimate(W, H, frames, encode_s, **kw):
    """MFU over encode wall time against the H100's f32 FMA rate."""
    macs = device_mac_estimate(W, H, frames, **kw)
    return float(macs / (encode_s * H100_PEAK_MACS))


def psnr(a, b, peak=255.0):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    return 99.0 if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def yuv_psnr(ref, rec, weights=(6, 1, 1)):
    """Weighted YUV PSNR over (Y, Cb, Cr) plane tuples."""
    ps = [psnr(r, d) for r, d in zip(ref, rec)]
    w = np.asarray(weights, dtype=np.float64)
    return float((np.asarray(ps) * w).sum() / w.sum()), ps


def ssim(a, b, c1=(0.01 * 255) ** 2, c2=(0.03 * 255) ** 2, win=8):
    """Mean SSIM over non-overlapping win x win windows (single plane)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    h, w = a.shape
    h -= h % win
    w -= w % win
    aw = a[:h, :w].reshape(h // win, win, w // win, win).transpose(0, 2, 1, 3)
    bw = b[:h, :w].reshape(h // win, win, w // win, win).transpose(0, 2, 1, 3)
    aw = aw.reshape(-1, win * win)
    bw = bw.reshape(-1, win * win)
    mu_a = aw.mean(1)
    mu_b = bw.mean(1)
    va = aw.var(1)
    vb = bw.var(1)
    cov = (aw * bw).mean(1) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / \
        ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2))
    return float(s.mean())


def bd_rate(rate_a, psnr_a, rate_b, psnr_b, points=100):
    """Bjontegaard-style rate ratio of A vs B over the overlapping PSNR
    range (the reference's area-ratio method,
    calculate_bd_rate_against_x265.py:150-199). < 1.0 means A needs fewer
    bits at equal quality."""
    rate_a = np.log(np.asarray(rate_a, dtype=np.float64))
    rate_b = np.log(np.asarray(rate_b, dtype=np.float64))
    psnr_a = np.asarray(psnr_a, dtype=np.float64)
    psnr_b = np.asarray(psnr_b, dtype=np.float64)
    lo = max(psnr_a.min(), psnr_b.min())
    hi = min(psnr_a.max(), psnr_b.max())
    if hi <= lo:
        return float("nan")
    xs = np.linspace(lo, hi, points)
    ia = np.interp(xs, np.sort(psnr_a), rate_a[np.argsort(psnr_a)])
    ib = np.interp(xs, np.sort(psnr_b), rate_b[np.argsort(psnr_b)])
    return float(np.exp((ia - ib).mean()))
