"""RD evaluation harness of the PyTorch/CUDA port — the counterpart of
wrenc_tpu.tools.evaluate (parity with the reference's evaluation stack,
tools/evaluation/evaluate_mp.py + calculate_bd_rate_against_x265.py),
plus --device.

Encodes the reference test clips (decoded via OpenCV) over a QP ladder,
verifies the bitstream decodes bit-exactly against the encoder
reconstruction (our conformance oracle), computes PSNR/SSIM in the same
convention as the reference harness (combined-MSE "Avg" PSNR with 4:1:1
plane weights; 4:1:1 weighted SSIM), writes a summary.json in the
reference's schema, and reports BD-rate vs the reference's PUBLISHED
anchor points (tools/evaluation/summary.json, commit 1d5b5ec).

The clips are read from config/videos.json's assets_dir, relative to the
repository root (assets/); OpenCV is imported only to decode them.

    python -m wrenc_tpu_torch.tools.evaluate \
        --out results/torch/summary.json [--qps 22,27,32,37] \
        [--frames 30] [--device cuda|cpu]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

from .metrics import bd_rate, ssim

_CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "config")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load_config(name):
    with open(os.path.join(_CONFIG_DIR, name)) as f:
        return json.load(f)


# Published anchor RD points from the reference evaluation
# (tools/evaluation/summary.json @ 1d5b5ec): [qp, bytes, psnr, ssim] —
# external JSON like the reference's videos/presets/metrics config files.
ANCHORS = {name: {vid: [tuple(p) for p in pts] for vid, pts in table.items()}
           for name, table in _load_config("anchors.json").items()}
_VIDEOS = _load_config("videos.json")

DEFAULT_ASSETS = os.path.join(_ROOT, _VIDEOS["assets_dir"])


def load_clip_yuv(path, num_frames=None):
    """Decode an mp4 clip to planar YUV420 frames [(Y, Cb, Cr), ...]."""
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    while num_frames is None or len(frames) < num_frames:
        ok, bgr = cap.read()
        if not ok:
            break
        h, w = bgr.shape[:2]
        i420 = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_I420)
        y = i420[:h]
        cb = i420[h:h + h // 4].reshape(h // 2, w // 2)
        cr = i420[h + h // 4:].reshape(h // 2, w // 2)
        frames.append((y.copy(), cb.copy(), cr.copy()))
    cap.release()
    return frames


def frame_psnr_avg(ref, rec):
    """Combined-MSE PSNR over Y/Cb/Cr with 4:1:1 size weights (the
    reference harness' 'Avg', matching ffmpeg's psnr_avg)."""
    mses, out = [], {}
    for name, r, d in zip("YUV", ref, rec):
        mse = np.mean((np.asarray(r, np.float64) - np.asarray(d, np.float64))
                      ** 2)
        mses.append(mse)
        out[name] = 99.0 if mse == 0 else \
            10.0 * np.log10(255.0 ** 2 / mse)
    wmse = (4 * mses[0] + mses[1] + mses[2]) / 6.0
    out["Avg"] = 99.0 if wmse == 0 else 10.0 * np.log10(255.0 ** 2 / wmse)
    return out


def frame_ssim_avg(ref, rec):
    out = {n: ssim(r, d) for n, r, d in zip("YUV", ref, rec)}
    out["Avg"] = (4 * out["Y"] + out["U"] + out["V"]) / 6.0
    return out


def run_point(frames, qp, max_split_depth, verify=True, extra=None,
              engine=None, device="cuda"):
    """Encode one RD point on `device` (the card unless the caller asks
    for the CPU); return (bytes, psnr_summary, ssim_summary, duration_s,
    per-frame psnr, per-frame ssim)."""
    from ..core.config import EncoderConfig
    from ..encoder import Encoder
    from ..search import WavefrontSearch

    h, w = frames[0][0].shape
    cfg = EncoderConfig(width=w, height=h, qp=qp,
                        max_split_depth=max_split_depth)
    if extra:
        cfg.rate_model.apply_extra_params(extra)
    enc = Encoder(cfg, search=WavefrontSearch(cfg, commit_engine=engine,
                                              device=device))
    t0 = time.perf_counter()
    stream, recons = enc.encode(frames)
    dt = time.perf_counter() - t0

    if verify:
        from ..decoder import decode_annexb
        dec = decode_annexb(stream)
        assert len(dec) == len(recons), "decoder frame count mismatch"
        for i, (a, b) in enumerate(zip(recons, dec)):
            for pa, pb in zip(a, b):
                if not np.array_equal(pa, pb):
                    raise AssertionError(
                        f"conformance FAIL: frame {i} decode != recon")

    ps = [frame_psnr_avg(r, d) for r, d in zip(frames, recons)]
    ss = [frame_ssim_avg(r, d) for r, d in zip(frames, recons)]
    psum = {k: float(np.mean([p[k] for p in ps])) for k in ("Avg", "Y",
                                                            "U", "V")}
    ssum = {k: float(np.mean([s[k] for s in ss])) for k in ("Avg", "Y",
                                                            "U", "V")}
    return len(stream), psum, ssum, dt, ps, ss


def evaluate_clips(clips, qps, max_split_depth=3, verify=True,
                   per_frame=False, extra=None, engine=None, device="cuda"):
    """The QP ladder over clips [(video name, frames), ...]: one warm-up
    point on the first clip's first 8 frames, then every (clip, QP)
    point, and the BD-rate of each clip against the anchors that list it.
    Returns the summary.json record (the JAX tool's schema)."""
    all_results = []
    warmed = False
    for video, frames in clips:
        print(f"== {video}: {len(frames)} frames "
              f"{frames[0][0].shape[1]}x{frames[0][0].shape[0]}",
              file=sys.stderr, flush=True)
        if not warmed:
            # absorb first-call costs (host tables, kernel builds) so the
            # first RD point's duration measures encoding (use a full
            # chunk so the warmed geometry matches the timed runs)
            run_point(frames[:8], qps[0], max_split_depth, verify=False,
                      extra=extra, engine=engine, device=device)
            warmed = True
        vres = []
        for qp in qps:
            nbytes, psum, ssum, dt, ps, ss = run_point(
                frames, qp, max_split_depth, verify=verify, extra=extra,
                engine=engine, device=device)
            rec = {
                "title": f"{os.path.splitext(video)[0]}"
                         f"[wrenc_tpu@max_split_depth="
                         f"{max_split_depth},qp={qp}]",
                "qp": qp, "bytes": nbytes, "duration": dt,
                "metrics": {"PSNR": {"summary": psum},
                            "SSIM": {"summary": ssum}},
            }
            if per_frame:
                rec["metrics"]["PSNR"]["per_frame"] = ps
                rec["metrics"]["SSIM"]["per_frame"] = ss
            vres.append(rec)
            print(f"  qp={qp}: {nbytes} B  PSNR {psum['Avg']:.3f} dB  "
                  f"SSIM {ssum['Avg']:.4f}  {len(frames) / dt:.2f} fps"
                  f"{'  [decode OK]' if verify else ''}",
                  file=sys.stderr, flush=True)
        all_results.append({"video": video, "results": vres})

    # BD-rate vs published anchors over the overlapping PSNR range
    bd = {}
    for (video, _), vr in zip(clips, all_results):
        ours_rate = [r["bytes"] for r in vr["results"]]
        ours_psnr = [r["metrics"]["PSNR"]["summary"]["Avg"]
                     for r in vr["results"]]
        bd[video] = {}
        for name, table in ANCHORS.items():
            if video not in table:
                continue
            a_rate = [p[1] for p in table[video]]
            a_psnr = [p[2] for p in table[video]]
            ratio = bd_rate(ours_rate, ours_psnr, a_rate, a_psnr)
            bd[video][name] = ratio
            delta = (ratio - 1.0) * 100.0
            print(f"BD-rate {video} vs {name}: {delta:+.2f}% "
                  f"({'better' if delta < 0 else 'worse'})",
                  file=sys.stderr, flush=True)

    return {
        "date": time.strftime("%Y-%m-%d %H:%M:%S"),
        "encoder": "wrenc_tpu_torch",
        "results": [{
            "preset": "wrenc_tpu_fixed_qp",
            "tag": f"wrenc_tpu@max_split_depth={max_split_depth}",
            "results": all_results,
        }],
        "bd_rate_vs_anchors": bd,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="wrenc-tpu RD evaluation (PyTorch/CUDA port)")
    ap.add_argument("--assets", default=DEFAULT_ASSETS)
    ap.add_argument("--videos", default="bus_352x288_30fps_30fr.mp4,"
                    "mobile_352x288_30fps_30fr.mp4")
    ap.add_argument("--qps", default="22,27,32,37")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--max-split-depth", type=int, default=3)
    ap.add_argument("--out", default="results/torch/summary.json")
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--per-frame", action="store_true",
                    help="include per-frame metrics in summary.json")
    ap.add_argument("--extra-params", default=None,
                    help="rate-model overrides KEY=VAL,... (the "
                         "reference's --extra-params escape hatch)")
    ap.add_argument("--engine", default=None,
                    help="commit engine: native|device (default: "
                         "WRENC_COMMIT_ENGINE or native)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the search (default: cuda)")
    args = ap.parse_args(argv)

    from ..search.wavefront import resolve_device
    resolve_device(args.device)
    extra = (dict(kv.split("=") for kv in args.extra_params.split(","))
             if args.extra_params else None)
    qps = [int(q) for q in args.qps.split(",")]
    clips = [(video, load_clip_yuv(os.path.join(args.assets, video),
                                   args.frames))
             for video in args.videos.split(",")]
    summary = evaluate_clips(clips, qps, args.max_split_depth,
                             verify=not args.no_verify,
                             per_frame=args.per_frame, extra=extra,
                             engine=args.engine, device=args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
