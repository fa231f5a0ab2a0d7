#!/usr/bin/env python3
"""A/B the native C++ commit engine vs the device RD commit engine of the
PyTorch/CUDA port — the counterpart of wrenc_tpu.tools.engine_ab, plus
--device.

Encodes full clips at a QP ladder with both engines and reports, per
(clip, qp): stream sizes, byte-identity, PSNR, per-engine wall time, and
conformance (decode == encoder reconstruction). The native RdCommitter
is the bit-exactness oracle; the device engine compares costs in f32
(vs f64 in C++), so rare near-ties may pick a different — equally
coded — winner. The acceptance gate (round-2 VERDICT #4): byte-identical
streams, or a BD-rate-scale size delta under 0.02% with conformance
holding on both (passes_gate).

    python -m wrenc_tpu_torch.tools.engine_ab --frames 30 \
        --qps 22,27,32,37 --out results/torch/engine_ab.json \
        [--device cuda|cpu]
"""
import argparse
import json
import os
import time

import numpy as np

from .evaluate import DEFAULT_ASSETS

CLIPS = {
    "bus": os.path.join(DEFAULT_ASSETS, "bus_352x288_30fps_30fr.mp4"),
    "mobile": os.path.join(DEFAULT_ASSETS, "mobile_352x288_30fps_30fr.mp4"),
}
# the gate's size delta, in percent
GATE_DELTA_PCT = 0.02


def _encode(cfg_kw, frames, engine, device="cuda"):
    from ..core.config import EncoderConfig
    from ..encoder import Encoder
    from ..search import WavefrontSearch
    cfg = EncoderConfig(**cfg_kw)
    enc = Encoder(cfg, search=WavefrontSearch(cfg, commit_engine=engine,
                                              device=device))
    t0 = time.perf_counter()
    stream, recons = enc.encode(frames)
    dt = time.perf_counter() - t0
    return stream, recons, dt, dict(getattr(enc, 'phase_times', {}))


def _verify(stream, recons):
    from ..decoder import decode_annexb
    dec = decode_annexb(stream)
    if len(dec) != len(recons):
        return False
    for got, want in zip(dec, recons):
        for c in range(3):
            if not (np.asarray(got[c], np.uint8)
                    == np.asarray(want[c], np.uint8)).all():
                return False
    return True


def run_ab(clips, qps, frames, verify=True, device="cuda"):
    """Both engines over clips [(clip name, frames), ...] at each QP, at
    the clips' own size; returns the report (the JAX tool's schema;
    `frames` is the frame count it records)."""
    from .evaluate import frame_psnr_avg
    from .metrics import bd_rate
    report = {"frames": frames, "points": []}
    for clip, clip_frames in clips:
        h, w = clip_frames[0][0].shape
        for qp in qps:
            cfg_kw = dict(width=w, height=h, qp=qp)
            row = {"clip": clip, "qp": qp}
            streams = {}
            for engine in ("native", "device"):
                stream, recons, dt, phases = _encode(cfg_kw, clip_frames,
                                                     engine, device)
                streams[engine] = (stream, recons)
                psnr = float(np.mean([frame_psnr_avg(r, d)["Avg"]
                                      for r, d in zip(clip_frames, recons)]))
                row[engine] = {
                    "bytes": len(stream),
                    "psnr": round(psnr, 4),
                    "time_s": dt,
                    "phases": phases,
                }
                if verify:
                    row[engine]["conformant"] = _verify(stream, recons)
            sn, sd = streams["native"][0], streams["device"][0]
            row["byte_identical"] = sn == sd
            row["size_delta_pct"] = round(
                100.0 * (len(sd) - len(sn)) / len(sn), 4)
            report["points"].append(row)
            print(json.dumps(row, default=str))
    ident = [p["byte_identical"] for p in report["points"]]
    deltas = [abs(p["size_delta_pct"]) for p in report["points"]]
    report["all_byte_identical"] = all(ident)
    report["max_abs_size_delta_pct"] = max(deltas) if deltas else 0.0
    # BD-rate of the device curve vs the native curve per clip (the
    # equivalence gate: |delta| < 0.02%)
    report["bd_device_vs_native"] = {}
    for clip, _ in clips:
        pts = [p for p in report["points"] if p["clip"] == clip]
        if len(pts) < 3:
            continue
        ratio = bd_rate([p["device"]["bytes"] for p in pts],
                        [p["device"]["psnr"] for p in pts],
                        [p["native"]["bytes"] for p in pts],
                        [p["native"]["psnr"] for p in pts])
        report["bd_device_vs_native"][clip] = ratio
    return report


def passes_gate(report):
    """The acceptance gate: byte-identical streams, or every size delta
    under GATE_DELTA_PCT; and every verified stream conformant."""
    conformant = all(p[e].get("conformant", True)
                     for p in report["points"] for e in ("native", "device"))
    return conformant and (report["all_byte_identical"] or
                           report["max_abs_size_delta_pct"] < GATE_DELTA_PCT)


def main(argv=None):
    from .evaluate import load_clip_yuv
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--qps", default="22,27,32,37")
    ap.add_argument("--clips", default="bus,mobile")
    ap.add_argument("--verify", action="store_true", default=True)
    ap.add_argument("--out", default="results/torch/engine_ab.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device for both engines (default: cuda)")
    args = ap.parse_args(argv)

    from ..search.wavefront import resolve_device
    resolve_device(args.device)
    qps = [int(q) for q in args.qps.split(",")]
    clips = [(clip, load_clip_yuv(CLIPS[clip], args.frames))
             for clip in args.clips.split(",")]
    report = run_ab(clips, qps, args.frames, verify=args.verify,
                    device=args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"all_byte_identical": report["all_byte_identical"],
                      "max_abs_size_delta_pct":
                      report["max_abs_size_delta_pct"]}))
    return report


if __name__ == "__main__":
    main()
