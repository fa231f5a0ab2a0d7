"""One run of one cell: set-up, the closed-loop window, the metrics, the
check, and the result line.

Set-up builds one Encoder(cfg, search=WavefrontSearch(cfg)) of the cell's
configuration at its traffic's QP (device None: the card), makes the
traffic's pool of frames and one call's warm-up frames from the seed, and
runs that warm-up call. The window then runs closed-loop calls, one caller:
each call encodes the next `frames_per_call` frames of the pool, ends in
torch.cuda.synchronize(), and the next starts when it returns. Every call
that starts before `seconds` have passed completes and counts. The seed
samples `check_calls` of the window's calls as they come (reservoir
sampling: before each call a draw decides whether it replaces one kept
so far), and their stage-A outputs are kept (capture.py) for the check
after the window (checks.py).
"""
import argparse
import collections
import gc
import json
import os
import statistics
import subprocess
import sys
import time

from . import capture, checks, content, spec, tracing

BANNED = ("jax", "jaxlib", "flax", "wrenc_tpu")


class NoCard(Exception):
    """The machine lacks the cards the cell asks for."""


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def banned_modules():
    """Top-level names in sys.modules that are jax, jaxlib, flax or the
    JAX package, compared whole (wrenc_tpu_torch is not wrenc_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


# one call of the window: host-clock start and end, the pool indices of
# its frames, what it returned, and the program's phase_times after it
Call = collections.namedtuple("Call", "t0 t1 idx stream recons phases")


def _window(enc, encode, pool, fpc, seconds, sync, cap, n_kept, rng):
    """The window's calls, and {call index: its stage-A chunks, still on
    the card} for the n_kept calls that the seed's reservoir sample kept."""
    calls, slots, kept = [], [], {}
    t_w = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if calls and t0 - t_w >= seconds:
            break
        i = len(calls)
        slot = i if i < n_kept else int(rng.integers(i + 1))
        cap.active = slot < n_kept
        idx = [(i * fpc + j) % len(pool) for j in range(fpc)]
        stream, recons = encode([pool[j] for j in idx])
        sync()
        t1 = time.perf_counter()
        if cap.active:
            if slot < len(slots):
                kept.pop(slots[slot])
                slots[slot] = i
            else:
                slots.append(i)
            kept[i] = cap.take()
            cap.active = False
        calls.append(Call(t0, t1, idx, stream, recons,
                          dict(getattr(enc, "phase_times", {}))))
    return calls, kept


def run(root, workload, seed, seconds, trace, device=None, t_start=None,
        wrap=None):
    """The result dict of one run. device None is the card (NoCard when
    it is missing); the tests pass 'cpu'. wrap(encoder) -> encode lets a
    test plant a fault in what the window calls."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench_dir = os.path.join(root, "perfbench")
    c = spec.cell(spec.load_benchmark(root), workload, root, bench_dir)
    import torch
    on_card = device is None
    if on_card:
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < c["chips"]:
            raise NoCard(f"{torch.cuda.device_count()} CUDA device(s), the "
                         f"cell asks for {c['chips']}")
    from wrenc_tpu_torch.core.config import EncoderConfig
    from wrenc_tpu_torch.encoder import Encoder
    from wrenc_tpu_torch.search import WavefrontSearch, wavefront
    config, traffic = c["config"], c["traffic"]
    if traffic.get("loop") != "closed" or traffic.get("callers") != 1:
        raise spec.SpecError(f"traffic {c['traffic_name']}: only a closed "
                             "loop with one caller is implemented")
    cfg = EncoderConfig(**dict(config["encoder_config"], qp=traffic["qp"]))
    enc = Encoder(cfg, search=WavefrontSearch(cfg, device=device,
                                              **config.get("search", {})))
    cap = capture.StageACapture(wavefront).install()
    encode = enc.encode if wrap is None else wrap(enc)
    picture, coded = tuple(config["picture"]), (cfg.width, cfg.height)
    t_built = time.perf_counter()
    pool = content.make_frames(traffic["content"], picture, coded,
                               traffic["pool_frames"],
                               content.seed_sequence(seed, 0))
    warm = content.make_frames(traffic["content"], picture, coded,
                               traffic["frames_per_call"],
                               content.seed_sequence(seed, 1))
    t_frames = time.perf_counter()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    encode(warm)                      # one call of the window's shapes
    sync()
    log(f"set-up: imports and encoder {t_built - t_start:.3f} s, frames "
        f"{t_frames - t_built:.3f} s, warm-up call "
        f"{time.perf_counter() - t_frames:.3f} s")

    prof = None
    if trace:
        # device activity only; a marker kernel on the idle card at each
        # end of the window bounds it in the trace (tracing.py)
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA] if on_card
                       else [ProfilerActivity.CPU])
        marker = torch.zeros(1, device="cuda") if on_card else None
        prof.start()
        if on_card:
            marker.add_(1)
    calls, kept = _window(enc, encode, pool, traffic["frames_per_call"],
                          seconds, sync, cap, int(traffic["check_calls"]),
                          content.seed_sequence(seed, 2))
    if prof is not None:
        if on_card:
            marker.add_(1)
            sync()
        prof.stop()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    durs = [k.t1 - k.t0 for k in calls]
    phases = {}
    for k in calls:
        checks.add(phases, k.phases)
    log(f"window: {len(calls)} calls, {sum(len(k.recons) for k in calls)} "
        f"frames; call seconds first {[round(d, 3) for d in durs[:2]]}, min "
        f"{min(durs):.3f}, median {statistics.median(durs):.3f}, max "
        f"{max(durs):.3f}; stream bytes of call 0 {len(calls[0].stream)}; "
        f"device memory peak {peak} bytes; phases summed (s) "
        f"{json.dumps(phases)}")
    record = {"setup_s": calls[0].t0 - t_start,
              "calls": [(k.t0, k.t1, len(k.recons)) for k in calls],
              "frames": sum(len(k.recons) for k in calls),
              "wall_s": sum(durs), "phases": phases,
              "config": config, "traffic": traffic, "trace": None}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": c["chips"], "memory_peak_bytes": peak}
    metrics, breakdown = {}, None
    if trace:
        os.makedirs(os.path.join(bench_dir, "out"), exist_ok=True)
        path = os.path.join(bench_dir, "out", f"{workload}.trace.json")
        prof.export_chrome_trace(path)
        red = tracing.reduce(tracing.load(path),
                             [k.t0 - calls[0].t0 for k in calls])
        record["trace"] = red
        device.update(busy_s=red["busy_s"] if red else 0.0,
                      window_s=red["window_s"] if red
                      else calls[-1].t1 - calls[0].t0)
        breakdown = {"device_ops": red["device_ops"] if red else [],
                     "idle_gaps": red["idle_gaps"] if red else []}
        log(f"trace: {path}")
    for m, reader in (c["per_layer"] if trace else c["end_to_end"]):
        v = reader.read(record)
        if v is None and not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    stage_a = {i: capture.StageACapture.fetch(ch) for i, ch in kept.items()}
    cap.uninstall()
    del enc, encode, cap, kept
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers, failed = _check(config, traffic, calls, pool + warm, stage_a,
                             seed)
    result = {"correct": checks.passes(numbers), "attempted": len(calls),
              "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": checks.LIMITS[k]}
                        for k, v in numbers.items()}
    return result


def _check(config, traffic, calls, frames_made, stage_a, seed):
    """The check's numbers (checks.py): pictures_missing over every call,
    the others over the sampled calls whose stage-A outputs were kept
    (`stage_a`, by call index); and the number of calls that failed."""
    total = {k: 0 for k in checks.LIMITS}
    failed = 0
    for k in calls:
        miss = checks.pictures_missing(len(k.idx), k.stream, k.recons)
        total["pictures_missing"] += miss
        failed += miss > 0
    rng = content.seed_sequence(seed, 3)
    if not stage_a:
        log("check: no sampled call was made in the window")
        total["stage_a_cands_differing"] += 1
        failed += 1
    for i in sorted(stage_a):
        k = calls[i]
        frames = [frames_made[j] for j in k.idx]
        n_pics = traffic.get("check_pictures") or len(frames)
        pics = sorted(int(j) for j in rng.choice(
            len(frames), size=min(n_pics, len(frames)), replace=False))
        t0 = time.perf_counter()
        numbers = {
            "decode_samples_differing": checks.decode_samples_differing(
                frames, k.stream, k.recons, pics, log),
            "pictures_nearer_another_frame":
                checks.pictures_nearer_another_frame(frames, k.recons,
                                                     frames_made)}
        t1 = time.perf_counter()
        numbers.update(checks.stage_a_numbers(
            stage_a[i], frames, traffic["qp"], config,
            int(traffic["check_blocks_per_size"]), rng))
        if not stage_a[i]["luma"]:      # stage A handed nothing on
            numbers["stage_a_cands_differing"] += 1
        log(f"check: call {i}: decode of pictures {pics} {t1 - t0:.3f} s, "
            f"stage A ({len(stage_a[i]['luma'])} luma and "
            f"{len(stage_a[i]['chroma'])} chroma chunks) "
            f"{time.perf_counter() - t1:.3f} s; {json.dumps(numbers)}; "
            f"{len(k.stream)} bytes, PSNR of its first picture "
            f"{json.dumps(checks.psnr_avg(frames[0], k.recons[0]) if k.recons else {})}")
        failed += not all(numbers[n] <= checks.LIMITS[n] for n in numbers)
        checks.add(total, numbers)
    return total, failed


def _card_note():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e!r}"


def main(argv, t_start):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    root = os.path.dirname(spec.PERFBENCH)
    try:
        result = run(root, a.workload, a.seed, a.seconds, a.trace,
                     t_start=t_start)
    except (NoCard, spec.SpecError) as e:
        log(f"perfbench: {e}")
        return 2
    banned = banned_modules()
    if banned:
        log(f"perfbench: modules that must not load are in sys.modules: "
            f"{banned}")
        return 3
    log(f"card: {_card_note()}")
    for k, v in result["checks"].items():
        log(f"check {k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0
