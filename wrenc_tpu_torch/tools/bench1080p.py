#!/usr/bin/env python3
"""1080p-class all-intra encode benchmark of the PyTorch/CUDA port — the
counterpart of wrenc_tpu.tools.bench1080p, plus --device.

Encodes N 1920x1088 frames (the bus clip upscaled when the clip and
OpenCV are available, else synthetic) through the full pipeline with WPP
on (34 CTU rows), verifies the conformance round trip, and writes
results/torch/1080p.json: fps, per-phase times, first-encode time, stream
size. --size 3840x2176 runs the 4K target class.

    python -m wrenc_tpu_torch.tools.bench1080p [--size 3840x2176] \
        [--frames 4] [--device cuda|cpu]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

CLIP = "bus_352x288_30fps_30fr.mp4"


def _upscaled_clip(n, W, H):
    """The bus clip's first n frames upscaled to W x H, or None when the
    clip or OpenCV is absent."""
    from .evaluate import DEFAULT_ASSETS, load_clip_yuv
    path = os.path.join(DEFAULT_ASSETS, CLIP)
    if not os.path.exists(path):
        return None
    try:
        import cv2
    except ImportError:
        return None
    out = []
    for y, cb, cr in load_clip_yuv(path, n)[:n]:
        Y = cv2.resize(y, (W, H), interpolation=cv2.INTER_CUBIC)
        CB = cv2.resize(cb, (W // 2, H // 2), interpolation=cv2.INTER_CUBIC)
        CR = cv2.resize(cr, (W // 2, H // 2), interpolation=cv2.INTER_CUBIC)
        out.append((Y, CB, CR))
    return out or None


def frames_1080p(n, W=1920, H=1088):
    clip = _upscaled_clip(n, W, H)
    if clip:
        return clip
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for i in range(n):
        y = np.clip(np.sin(xx / 23 + i * .4) * 60 + np.cos(yy / 17) * 50
                    + 128 + rng.integers(-8, 9, (H, W)), 0,
                    255).astype(np.uint8)
        out.append((y, (y[::2, ::2] // 2 + 60).astype(np.uint8),
                    (220 - y[::2, ::2] // 2).astype(np.uint8)))
    return out


def _platform(dev):
    """The torch device, and the card's name on CUDA."""
    import torch
    if dev.type == "cuda":
        return f"{dev}: {torch.cuda.get_device_name(dev)}"
    return str(dev)


def main(argv=None):
    """Runs the benchmark; returns the record it writes."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--size", default="1920x1088",
                    help="WxH (e.g. 3840x2176 for the 4K target class)")
    ap.add_argument("--qp", type=int, default=32)
    ap.add_argument("--out", default="results/torch/1080p.json")
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the search (default: cuda)")
    args = ap.parse_args(argv)

    from ..core.config import EncoderConfig
    from ..encoder import Encoder
    from ..search import WavefrontSearch
    from ..search.wavefront import resolve_device
    from .metrics import mfu_estimate

    dev = resolve_device(args.device)
    W, H = (int(v) for v in args.size.split("x"))
    cfg = EncoderConfig(width=W, height=H, qp=args.qp,
                        entropy_coding_sync_enabled=True,
                        entry_point_offsets_present=True)
    frames = frames_1080p(args.frames, W, H)
    enc = Encoder(cfg, search=WavefrontSearch(cfg, device=dev))

    # warm-up on the SAME content: the host tables and the device
    # commit's scan geometry depend on the geometry and the content
    t0 = time.perf_counter()
    enc.encode(frames)
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    stream, recons = enc.encode(frames)
    dt = time.perf_counter() - t0

    verified = None
    if not args.no_verify:
        from ..decoder import decode_annexb
        dec = decode_annexb(stream)
        verified = all((dec[i][c] == recons[i][c]).all()
                       for i in range(len(frames)) for c in range(3))
        assert verified, "1080p conformance round trip FAILED"

    rec = {
        "resolution": f"{W}x{H}",
        "frames": len(frames),
        "qp": args.qp,
        "wpp_rows": H // 32,
        "fps": len(frames) / dt,
        "encode_s": dt,
        "first_compile_s": compile_s,
        "bytes": len(stream),
        "mfu": mfu_estimate(W, H, len(frames), dt),
        "mfu_note": ("logical device MACs (metrics.device_mac_estimate: "
                     "stage-A sweeps exact, commit approximated as one "
                     "more sweep) / (encode wall x the H100's 33.5e12 f32 "
                     "FMA/s)"),
        "phases_s": dict(getattr(enc, "phase_times", {})),
        "conformance_roundtrip": verified,
        "platform": _platform(dev),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), file=sys.stderr)
    tag = "4k" if W >= 3840 else "1080p"
    print(json.dumps({"metric": f"encode_fps_{tag}_qp32",
                      "value": rec["fps"], "unit": "frames/s"}))
    return rec


if __name__ == "__main__":
    main()
