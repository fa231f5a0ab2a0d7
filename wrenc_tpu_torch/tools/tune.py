"""Rate-model parameter tuner — parity with the reference's Optuna study
(tools/evaluation/optimize_bd_psnr.py): minimizes BD-rate vs the x265
placebo anchors over the ~40 tunable rate-model constants (the values the
reference passes via --extra-params and hard-codes as defaults after
tuning).

Optuna is used when importable; otherwise a self-contained log-normal
perturbation search (random restart + shrinking step) runs with the same
objective and a resumable JSON study file. A copy of wrenc_tpu/tools/tune.py
whose encodes run through the PyTorch/CUDA port, plus --device; Optuna is
imported only inside run_optuna.

    python -m wrenc_tpu_torch.tools.tune --trials 50 --frames 8 \
        --study results/torch/tune_study.json [--device cuda|cpu]
"""
import argparse
import dataclasses
import json
import math
import os
import random
import sys
import time

import numpy as np

from ..core.config import EncoderConfig, RateModelConfig
from .evaluate import ANCHORS, load_clip_yuv, frame_psnr_avg, DEFAULT_ASSETS
from .metrics import bd_rate


# behavioural SWITCHES, not continuous constants — excluded from the
# perturbation search (their values are picked by explicit A/B evals)
_SWITCHES = {"commit_chroma_redecide", "commit_rank_full",
             "commit_rank_trellis"}


def tunable_names(only=None):
    """Float-valued rate-model constants (the Optuna search space).

    only: optional comma-separated subset."""
    rm = RateModelConfig()
    names = [f.name for f in dataclasses.fields(rm)
             if isinstance(getattr(rm, f.name), float)
             and f.name not in _SWITCHES]
    if only:
        want = set(only.split(","))
        unknown = want - set(names)
        assert not unknown, f"unknown tunables: {unknown}"
        names = [n for n in names if n in want]
    return names


def objective(params, videos_frames, qps, max_split_depth, device="cuda"):
    """Mean BD-rate ratio vs x265 anchors over the loaded clips, encoding
    on `device`."""
    from ..encoder import Encoder
    from ..search import WavefrontSearch

    ratios = []
    for video, frames in videos_frames:
        rates, psnrs = [], []
        h, w = frames[0][0].shape
        for qp in qps:
            cfg = EncoderConfig(width=w, height=h, qp=qp,
                                max_split_depth=max_split_depth)
            cfg.rate_model.apply_extra_params(
                {k: str(v) for k, v in params.items()})
            enc = Encoder(cfg, search=WavefrontSearch(cfg, device=device))
            stream, recons = enc.encode(frames)
            ps = [frame_psnr_avg(r, d)["Avg"]
                  for r, d in zip(frames, recons)]
            rates.append(len(stream))
            psnrs.append(float(np.mean(ps)))
        anchor = ANCHORS["x265"].get(video)
        if anchor is None:
            continue
        ratios.append(bd_rate(rates, psnrs,
                              [a[1] for a in anchor],
                              [a[2] for a in anchor]))
    return float(np.mean(ratios))


def run_fallback(args, videos_frames, qps, names):
    """Log-normal perturbation search with a resumable JSON study."""
    study = {"trials": [], "best": None}
    if os.path.exists(args.study):
        with open(args.study) as f:
            study = json.load(f)
    rng = random.Random(args.seed + len(study["trials"]))
    base = {k: getattr(RateModelConfig(), k) for k in names}
    best = study["best"]
    if best is None:
        v0 = objective({}, videos_frames, qps, args.max_split_depth,
                       args.device)
        best = {"params": {}, "value": v0}
        study["best"] = best
        study["trials"].append({"params": {}, "value": v0})
        print(f"baseline objective: {v0:.5f}", file=sys.stderr, flush=True)

    for t in range(args.trials):
        # shrink the perturbation as the study grows (anneal)
        sigma = args.sigma * (0.5 ** (len(study["trials"]) / 40.0))
        sigma = max(sigma, 0.02)
        cand = dict(best["params"])
        for k in rng.sample(names, k=min(args.moves, len(names))):
            cur = cand.get(k, base[k])
            if cur == 0.0:
                cand[k] = rng.gauss(0.0, sigma)
            else:
                cand[k] = cur * math.exp(rng.gauss(0.0, sigma))
        t0 = time.time()
        v = objective(cand, videos_frames, qps, args.max_split_depth,
                      args.device)
        study["trials"].append({"params": cand, "value": v})
        mark = ""
        if v < best["value"]:
            best = {"params": cand, "value": v}
            study["best"] = best
            mark = "  ** new best"
        print(f"trial {len(study['trials'])}: {v:.5f} "
              f"(best {best['value']:.5f}, {time.time()-t0:.1f}s){mark}",
              file=sys.stderr, flush=True)
        with open(args.study, "w") as f:
            json.dump(study, f, indent=1)
    return best


def run_optuna(args, videos_frames, qps, names):
    import optuna
    base = {k: getattr(RateModelConfig(), k) for k in names}

    def obj(trial):
        params = {}
        for k in names:
            b = base[k]
            if b == 0.0:
                params[k] = trial.suggest_float(k, -2.0, 2.0)
            else:
                lo, hi = sorted((b * 0.25, b * 4.0))
                params[k] = trial.suggest_float(k, lo, hi, log=(b > 0))
        return objective(params, videos_frames, qps, args.max_split_depth,
                         args.device)

    study = optuna.create_study(
        study_name="wrenc_tpu_bd", direction="minimize",
        storage=f"sqlite:///{args.study}.db", load_if_exists=True)
    study.optimize(obj, n_trials=args.trials)
    return {"params": study.best_params, "value": study.best_value}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="wrenc-tpu rate-model tuner (PyTorch/CUDA port)")
    ap.add_argument("--assets", default=DEFAULT_ASSETS)
    ap.add_argument("--videos", default="bus_352x288_30fps_30fr.mp4,"
                    "mobile_352x288_30fps_30fr.mp4")
    ap.add_argument("--qps", default="26,32,38")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--trials", type=int, default=30)
    ap.add_argument("--max-split-depth", type=int, default=3)
    ap.add_argument("--study", default="results/torch/tune_study.json")
    ap.add_argument("--sigma", type=float, default=0.15,
                    help="initial log-perturbation scale")
    ap.add_argument("--moves", type=int, default=6,
                    help="parameters perturbed per trial")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--params", default=None,
                    help="comma-separated subset of constants to tune")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the encodes (default: cuda)")
    args = ap.parse_args(argv)

    from ..search.wavefront import resolve_device
    resolve_device(args.device)

    qps = [int(q) for q in args.qps.split(",")]
    names = tunable_names(args.params)
    videos_frames = []
    for video in args.videos.split(","):
        frames = load_clip_yuv(os.path.join(args.assets, video), args.frames)
        videos_frames.append((video, frames))
    os.makedirs(os.path.dirname(args.study) or ".", exist_ok=True)

    try:
        import optuna  # noqa: F401
        best = run_optuna(args, videos_frames, qps, names)
    except ImportError:
        best = run_fallback(args, videos_frames, qps, names)
    print(json.dumps(best, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
