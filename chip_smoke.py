#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each fatal on failure:
  1. the card's name and power limit; build the native library (g++) and
     the CUDA kernels K1/K2 (nvcc, with ptxas's register and spill
     report) from the checkout's sources, in parallel;
  2. K1 (dq_trellis) and K2 (dq_greedy) against their plain PyTorch
     versions on the card: adversarial blocks at log2 2..5 x QP 8/32/51;
     K1 also at B = 1, 3, 5 and 4,753 in both instantiations (8 lanes per
     block, 1 lane at 4 x 4) and on a mixed-size wave with per-row ls /
     bd_shift in one launch; K2 also at B = 1, 3, 5 and 4,753 in both
     instantiations (1 and 8 lanes per block), row- and column-major t,
     scalar and per-row ls / bd_shift, and the operators one CUDA
     greedy_depquant call dispatches (its two output allocations only);
     then the main-path shapes of a CIF chunk (K2 also the 16-frame
     chunk); exact equality of levels and f32 rate; kernel, wrapper and
     plain times (CUDA events) and device time per instantiation in a
     CUDA graph beside the bound, and the SM clock read under load; then
     each kernel's instantiations over a sweep of batch sizes, the
     measurement behind its launch rule;
  3. the port's f32 FMA helper on the card against f64-computed FMAs;
  4. the main path: 16 synthetic CIF frames at QP 32 through
     wrenc_tpu_torch.encoder.Encoder + WavefrontSearch, default config and
     stage_a_trellis_rd=1, warm-up then timed, with the kernels' launch
     counters reset just before and read just after each timed encode;
  5. K1 and K2 against their plain versions at the device chroma stage
     A's shapes (chroma sizes 4 / 8 / 16, cb and cr in one batch: 2*F*N
     derived / SCIPU and 6*F*N CCLM blocks, the chroma QP's ls /
     bd_shift) of four chunks: CIF 8 and 16 frames, 1080p 1 and 4
     frames; through the launch helpers in both instantiations at 4 x 4
     and through the wrappers with the search's device arguments; each
     kernel's device time per launch in a CUDA graph beside its bound;
  6. 1080p: 4 synthetic 1920x1088 frames at QP 32 on the default path
     (native engine, device chroma), warm-up then timed with the counters
     reset just before and read just after, decode == reconstruction;
     one chunk's chroma stage A alone: its dispatch under the CUDA sync
     debug mode "error" with the counters reset just before and read just
     after (K2's launches checked against the chunk's shapes), those
     launches replayed in a CUDA graph (K2's device time per chunk), the
     PyTorch operators it dispatches; the same chunk under
     stage_a_trellis_rd=1 (K1's launches at the chroma shapes, counted
     the same way); then the device engine in its
     default configuration (device chroma), one 4-frame group, one
     encode that captures its scan's step graphs (captures, steps and
     padded rows logged) and one that replays them (same bytes), and its
     chroma stage A alone as above (its scan is not run alone at 1080p:
     phase 8 does so at CIF);
  7. a 2-frame CIF encode per config (both stage-A configurations and
     chroma_stage_a='device') on the card equals the same encode on the
     CPU byte for byte, and the port's decoder reproduces the card's
     reconstruction; the same for the device commit engine on 2 frames at
     96x64, with native and with its default device chroma, and for one
     1920x1088 frame on the default path;
  8. the device commit engine (commit_engine='device',
     chroma_stage_a='native'): 16 CIF frames at QP 32, warm-up (which
     captures the rank steps' graphs) then timed with the launch
     counters reset just before and read just after: no graph captured,
     every step a replay (trellis_rate_batch never called), decode ==
     reconstruction, the native engine's bytes and PSNR beside it, and
     one more timed encode in the engine's default configuration
     (device chroma) with its chroma stage A alone as in 6; then the scan
     alone on those frames, its first segment under
     torch.cuda.set_sync_debug_mode("error") (no host-device sync inside
     the step loop), its steps and wall time; again under torch.profiler
     (the kernels' summed device time, each K1 launch's device time: as
     many K1 kernels as the step graphs hold and as the timed encode
     counted, in as many steps as the schedule has); again counting the
     PyTorch operators it dispatches (per step); the engine committing
     in the worker thread (_device_groups: 32 CIF frames in one scan,
     captured then replayed, equal to two 16-frame calls; 48 frames of
     64x64 in commit groups of 16, card bytes == CPU bytes); and K1
     through trellis_rate_batch against its plain twin at the scan's
     shapes in one launch, with kernel-alone and plain times beside the
     bound;
  9. the commit paths, on CIF frames at QP 32: qp_delta_pattern=(-3, 0, 4)
     on 2 frames (the three decoders reproduce the reconstruction, card
     bytes == CPU bytes, wall and phase times); rd_commit=False and
     trellis_commit=False on 16 frames each (host selection runs under
     the row meshes of phase 10), warm-up then timed with the counters
     reset just before and read just after (fps, phase times, decode ==
     reconstruction, card bytes == CPU bytes on 2 frames); the
     apply-decisions prototype
     commit_frame_device on the trees of 2 frames of a trellis_commit=False,
     rd_commit=False search: reconstruction and levels == the NumPy
     _commit's, K2's launches counted from 0 == the plan's steps, padded
     rows only in the pad slot, the commit's wall time and K2's device time
     for those launches in a CUDA graph beside their bound, then K2 in both
     instantiations at every (n, padded B) it launched, exactly against
     its plain twin with the prototype's tables;
 10. the sharded stage A (WavefrontSearch(cfg, mesh=...)), cells on
     distinct cards where there are enough, else cuda:0 repeated (logged;
     then no scaling claim): 16 CIF frames at QP 32 on a ('frame',) mesh
     of 2 cells and a (frame 2, row 3) mesh (3 CTU rows per band), the
     latter also under stage_a_trellis_rd=1 and with the device commit
     engine; card bytes == the single-device card bytes, decode ==
     reconstruction, fps and phase times, the stage-A kernel's launches
     counted from 0 == chunks x cells x 4 sizes, and the kernel's device
     time per cell (one cell's launches of one chunk in a CUDA graph)
     beside its bound; 1080p on a (1, 2) mesh: one chunk's stage A == one
     device's exactly, a 1-frame encode == the single-device bytes, K2's
     device time per band cell;
 11. the kernels/ formulations (DCT-II's named entries, MTS, LFNST,
     dq_rate_scan / dq_rate_device, bdpcm_*, trellis_depquant /
     trellis_depquant_pscan on K1) on a CUDA tensor == on the CPU;
 12. (run after 6) 4K: wrenc_tpu_torch.tools.bench1080p.main(--size
     3840x2176 --frames 1), a warm-up encode, the timed encode and
     decode == reconstruction, counted from 0; one 1-frame chunk's stage
     A alone (luma + device chroma) counted from 0: K2 launched once per
     luma size and chroma job, the card's peak memory for the chunk; K2
     equal to its plain twin at each of those launches on their own
     inputs, the plain twin's time, and K2's device time for the chunk's
     launches in a CUDA graph beside the bound;
 13. the tools, each counted from 0: evaluate.evaluate_clips over the 16
     CIF frames at QP 22 / 27 / 32 / 37 (decode == reconstruction at each
     point, the QP 32 point's size == phase 4's default stream), the QP
     27 point once more (a first-call cost shows as a faster second
     encode) and dashboard.build_html of its summary; engine_ab.run_ab on 4 frames at
     QP 32 within the tool's gate (byte-identical or a size delta under
     0.02 %, both conformant); one tune.objective; scaling_bench over 1
     and 2 cells (sharded == serial); multihost_smoke.run('cuda'): two
     gloo processes, both layouts exact against one device.
Prints each phase's wall time and the total, the kernels' JSON line,
then as its last line {"ok": true, "device": {...}}. Exits nonzero,
printing no result, without a CUDA device or outside a checkout of the
repo. Imports nothing of JAX.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM rates (NVIDIA data sheet): 3.35 TB/s HBM3; 67 TFLOP/s f32 on
# the CUDA cores = 132 SMs x 128 FMA lanes x 2 flops x 1.98 GHz. The data
# sheet gives no integer rate, so the bound takes the issue ceiling,
# derived from that line: 4 schedulers x 32 lanes = 128 instructions per
# SM per clock, 67e12 / 2 = 33.5e12 per second. The INT32 pipe alone has
# half those lanes; integer work that also issues IMADs and f32 adds on
# the FMA pipe can reach the ceiling, so it is the least time.
HBM_BYTES_S = 3.35e12
OPS_S = 67e12 / 2
# 32-bit integer operations the algorithms need per coefficient position,
# counted from csrc/dq_scan.cu: K2 = the sequential scan's step, two
# candidate costs (13 each) plus the level pick, rate and state update
# (the kernel evaluates the costs of both deltas, twice that, to take
# them off the chain; the bound counts what the function needs); K1 =
# four edge ingredients (16 each), 16 edge relaxations (12 each), the
# 8-state normalisation and backpointer packing (32), and the backtrack
# (20).
OPS_PER_POS = {"dq_greedy": 48, "dq_trellis": 315}
# K1's 4 x 4 batch sizes timed in both instantiations: the 64x64 test
# geometry's chunk (12,288), 1, 2, 4 and 8 CIF frames (38,016 each)
LANES_SWEEP_B = (1024, 4096, 12288, 16384, 38016, 76032, 152064, 304128)
SIZES = (4, 8, 16, 32)
N_CANDS = 6                      # K + 2 stage-A candidates per block
CIF = (352, 288)
P1080 = (1920, 1088)
K4 = (3840, 2176)
# an anchored clip's name: tune's objective scores frames against its
# x265 points (the tools phase passes synthetic frames under it)
ANCHORED = "bus_352x288_30fps_30fr.mp4"
# the chunks whose chroma stage-A shapes K1 / K2 are checked at: (name,
# geometry, frames per chunk); the 16- and 4-frame ones are the device
# engine's buckets
CHROMA_CHUNKS = (("CIF 8 frames", CIF, 8),
                 ("CIF 16 frames (device engine)", CIF, 16),
                 ("1080p 1 frame", P1080, 1),
                 ("1080p 4 frames (device engine)", P1080, 4))


def log(*a):
    print(*a, flush=True)


def synth_frames(n, w, h, seed=0):
    """bench.py's synthetic frame generator (copied)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    frames = []
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        y = np.clip((np.sin(xx / 11 + i * 0.3) * 50
                     + np.cos(yy / 7 - i * 0.2) * 40 + 128)
                    + rng.integers(-10, 11, (h, w)), 0, 255).astype(np.uint8)
        cb = (y[::2, ::2] // 2 + 64).astype(np.uint8)
        cr = (200 - y[::2, ::2] // 2).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def adversarial_blocks(log2, seed):
    """tests/test_trellis_pallas.py's adversarial recipe (copied)."""
    import numpy as np
    from wrenc_tpu_torch.spec import transform
    rng = np.random.default_rng(seed)
    s = 1 << log2
    t = rng.integers(-3000, 3000, (24, s, s)).astype(np.int32)
    t[0] = 0                                    # all-zero block
    t[1] = 0
    t[1, 0, 0] = 1                              # DC-only
    t[2] = rng.integers(-3, 4, (s, s))          # tie-heavy small coeffs
    res = np.where(rng.integers(0, 2, (s, s)) > 0, 255, -255)
    t[3] = np.asarray(transform.forward(res.astype(np.int32)))  # saturated
    t[4] = rng.integers(-1, 2, (s, s))          # +-1 field
    return t


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from wrenc_tpu_torch.entropy.native import loader
    from wrenc_tpu_torch.kernels import _build

    def native():
        t0 = time.perf_counter()
        loader.available()
        return time.perf_counter() - t0

    def cuda():
        t0 = time.perf_counter()
        _, msg = _build.build("dq_scan", ("-Xptxas", "-v"))
        _build.lib("dq_scan")
        return time.perf_counter() - t0, msg

    with ThreadPoolExecutor(max_workers=2) as pool:
        fn, fc = pool.submit(native), pool.submit(cuda)
        t_native = fn.result()
        t_cuda, msg = fc.result()
    log(f"build: native g++ {t_native:.1f} s, CUDA dq_scan.cu nvcc "
        f"{t_cuda:.1f} s (in parallel)")
    ptxas = [line.strip() for line in msg.splitlines()
             if "registers" in line or "spill" in line
             or "Compiling" in line]
    for line in ptxas:
        log("  ptxas:", line)
    # K1's shared memory is dynamic: what the launcher requests per CTA
    k1 = _build.lib("dq_scan")
    smem = {f"lanes{lanes}_log2_{lg}": k1.dq_trellis_smem_bytes(lanes, lg)
            for lanes, lgs in ((8, (2, 3, 4, 5)), (1, (2,))) for lg in lgs}
    log(f"  K1 dynamic shared memory per CTA (bytes, the launcher's "
        f"request by lanes and largest size): {json.dumps(smem)}")
    k2 = {f"lanes{lanes}_log2_{lg}": [k1.dq_greedy_blocks_per_cta(lanes, lg),
                                      k1.dq_greedy_smem_bytes(lanes, lg)]
          for lanes in (1, 8) for lg in (2, 3, 4, 5)}
    log(f"  K2 blocks per 128-thread CTA and dynamic shared memory per CTA "
        f"(bytes), by lanes and size: {json.dumps(k2)}")
    return {"ptxas": ptxas, "k2_blocks_smem": k2}


def _qcase(log2, qp, trellis):
    from wrenc_tpu_torch.core.config import RateModelConfig
    from wrenc_tpu_torch.kernels import quantize as kq
    from wrenc_tpu_torch.spec import quant
    rm = RateModelConfig()
    qpar = quant.derive_quant_params(qp, log2, log2, dep_quant=True,
                                     transform_skip=False)
    try:
        lam = kq.lam_dq_table(rm, qp, trellis=trellis)
    except AssertionError:       # greedy table leaves the exact range at 51
        lam = kq.lam_dq_table(rm, qp, trellis=True)
    return qpar, lam, kq.lv_table_device(rm, True, trellis)


def _kernels():
    from wrenc_tpu_torch.kernels import quantize as kq
    from wrenc_tpu_torch.kernels import trellis as ktr

    def greedy(t, ls, bd, lam, lv, lg):
        return kq.greedy_depquant(t, ls, bd, lam, lg, lv)

    def greedy_plain(t, ls, bd, lam, lv, lg):
        return kq.greedy_depquant_plain(t, ls, bd, lam, lg, lv)

    return {"dq_greedy": (greedy, greedy_plain, False),
            "dq_trellis": (ktr.trellis_rate, ktr.trellis_rate_plain, True)}


def _err(a, b):
    (qa, ra), (qb, rb) = a, b
    return max(float((qa.int() - qb.int()).abs().max()),
               float((ra - rb).abs().max()))


def phase_kernel_checks():
    import torch
    errs = {}
    for name, (kern, plain, tr) in _kernels().items():
        worst = 0.0
        for log2 in (2, 3, 4, 5):
            for qp in (8, 32, 51):
                qpar, lam, lv = _qcase(log2, qp, tr)
                t = torch.as_tensor(adversarial_blocks(log2, 13 * log2 + qp),
                                    device="cuda")
                got = kern(t, qpar.ls, qpar.bd_shift, lam, lv, log2)
                want = plain(t, qpar.ls, qpar.bd_shift, lam, lv, log2)
                torch.cuda.synchronize()
                e = _err(got, want)
                if e != 0:
                    raise AssertionError(f"{name} != plain at log2 {log2} "
                                         f"QP {qp}: max abs err {e}")
                worst = max(worst, e)
        errs[name] = worst
        log(f"{name}: equal to the plain version on the adversarial blocks "
            f"(log2 2..5 x QP 8/32/51)")
    return errs


def _k1_case(log2, qp, B, rng):
    """K1's check blocks: the adversarial recipe tiled to B blocks, the
    blocks past the recipe's 24 random in +-3000."""
    import numpy as np
    base = adversarial_blocks(log2, 13 * log2 + qp)
    t = np.concatenate([base] * (-(-B // len(base))))[:B]
    s = 1 << log2
    t[len(base):] = rng.integers(-3000, 3000, (max(B - len(base), 0), s, s))
    return t


def _per_row(log2, B, rng):
    """Per-row ls / bd_shift on the card for B blocks of mixed QPs."""
    import numpy as np
    import torch
    qps = rng.choice([22, 27, 32, 37], B)
    pars = [_qcase(log2, int(q), True)[0] for q in qps]
    return tuple(torch.as_tensor(np.array([getattr(p, f) for p in pars],
                                          np.int32), device="cuda")
                 for f in ("ls", "bd_shift"))


def phase_k1_checks():
    """K1 against its plain twin, exactly: the adversarial blocks at log2
    2..5 x QP 8/32/51 at B = 1, 3, 5 and 4,753, in both instantiations
    (8 lanes per block, and 1 lane at 4 x 4, the only size the launch rule
    gives it); then one launch of a mixed-size wave with per-row ls /
    bd_shift."""
    import numpy as np
    import torch
    from wrenc_tpu_torch.kernels import trellis as ktr
    rng = np.random.default_rng(17)
    worst, cases = 0.0, 0
    for log2 in (2, 3, 4, 5):
        for qp in (8, 32, 51):
            qpar, lam, lv = _qcase(log2, qp, True)
            for B in (1, 3, 5, 4753):
                t = torch.as_tensor(_k1_case(log2, qp, B, rng), device="cuda")
                want = ktr.trellis_rate_plain(t, qpar.ls, qpar.bd_shift, lam,
                                              lv, log2)
                for lanes in ((8, 1) if log2 == 2 else (8,)):
                    (got,) = ktr._launch_k1([(t, qpar.ls, qpar.bd_shift,
                                              log2)], lam, lv, lanes)
                    torch.cuda.synchronize()
                    e = _err(got, want)
                    if e != 0:
                        raise AssertionError(
                            f"K1 ({lanes} lanes) != plain at log2 {log2} QP "
                            f"{qp} B {B}: max abs err {e}")
                    worst, cases = max(worst, e), cases + 1
    # the table a search uploads ('cuda') is the one a launch reads
    if ktr.order_table(torch.device("cuda")) is not ktr.order_table(t.device):
        raise AssertionError("K1's coding-order table uploaded twice")
    _, lam, lv = _qcase(2, 32, True)
    jobs = []
    for log2, B in ((3, 5), (2, 7), (5, 3), (4, 1), (3, 2), (2, 4753),
                    (5, 70), (4, 33)):
        t = torch.as_tensor(_k1_case(log2, 32, B, rng), device="cuda")
        jobs.append((t, *_per_row(log2, B, rng), log2))
    before = ktr.trellis_rate_batch.launches
    got = ktr.trellis_rate_batch(jobs, lam, lv)
    launched = ktr.trellis_rate_batch.launches - before
    want = ktr.trellis_rate_batch_plain(jobs, lam, lv)
    torch.cuda.synchronize()
    e = max(_err(g, w) for g, w in zip(got, want))
    if e != 0 or launched != 1:
        raise AssertionError(f"mixed-size wave: max abs err {e}, "
                             f"{launched} launches")
    log(f"K1: equal to the plain version in {cases} cases (log2 2..5 x QP "
        f"8/32/51 x B 1/3/5/4753, 8 lanes; 1 lane at log2 2) and on a "
        f"mixed-size wave of {len(jobs)} jobs with per-row ls / bd_shift "
        f"in one launch")
    return max(worst, e)


def phase_k2_checks():
    """K2 against its plain twin, exactly: the adversarial blocks at log2
    2..5 x QP 8/32/51 at B = 1, 3, 5 and 4,753, in both instantiations
    (1 and 8 lanes per block) with row- and column-major t, and with
    per-row ls / bd_shift; then the operators one CUDA greedy_depquant
    call dispatches with stage A's device-resident arguments: its two
    output allocations and nothing else."""
    import numpy as np
    import torch
    from wrenc_tpu_torch.kernels import quantize as kq
    rng = np.random.default_rng(19)
    worst, cases = 0.0, 0
    for log2 in (2, 3, 4, 5):
        for qp in (8, 32, 51):
            qpar, lam, lv = _qcase(log2, qp, False)
            for B in (1, 3, 5, 4753):
                t = torch.as_tensor(_k1_case(log2, qp, B, rng), device="cuda")
                params = [(qpar.ls, qpar.bd_shift)]
                if B > 1:
                    params.append(_per_row(log2, B, rng))
                for ls, bd in params:
                    want = kq.greedy_depquant_plain(t, ls, bd, lam, log2, lv)
                    # the same values column-major in each block
                    tc = t.transpose(1, 2).contiguous().transpose(1, 2)
                    for lanes in (1, 8):
                        for tt in (t, tc):
                            got = kq._launch_k2(tt, ls, bd, lam, lv, log2,
                                                lanes)
                            torch.cuda.synchronize()
                            e = _err(got, want)
                            if e != 0:
                                raise AssertionError(
                                    f"K2 ({lanes} lanes, t strides "
                                    f"{tt.stride()}) != plain at log2 {log2}"
                                    f" QP {qp} B {B}: max abs err {e}")
                            worst, cases = max(worst, e), cases + 1
    # one call as stage A makes it: the DCT's column-major coefficients,
    # tables and quant parameters already on the card
    from wrenc_tpu_torch.kernels import transforms
    qpar, lam, lv = _qcase(3, 32, False)
    res = rng.integers(-24, 25, (4753, 8, 8)).astype(np.int32)
    t = transforms.forward_impl(torch.as_tensor(res, device="cuda"))
    args = (torch.tensor([qpar.ls], dtype=torch.int32, device="cuda"),
            torch.tensor([qpar.bd_shift], dtype=torch.int32, device="cuda"),
            torch.as_tensor(lam, device="cuda"), 3,
            torch.as_tensor(lv, device="cuda"))
    kq.greedy_depquant(t, *args)                  # loads the library
    torch.cuda.synchronize()
    with _OpCount() as oc:
        kq.greedy_depquant(t, *args)
    ops = dict(oc.counts)
    if ops != {"empty": 2}:
        raise AssertionError(f"greedy_depquant dispatched {ops}, want only "
                             f"its two output allocations")
    log(f"K2: equal to the plain version in {cases} cases (log2 2..5 x QP "
        f"8/32/51 x B 1/3/5/4753, 1 and 8 lanes, row- and column-major t, "
        f"scalar and per-row ls / bd_shift); one CUDA call dispatches "
        f"{ops}")
    return worst, ops


def _time_ms(fn, reps, per=1):
    """Median over `reps` CUDA-event timings of `per` back-to-back calls,
    divided by `per` (per > 1 hides the host's launch time under the
    kernel's)."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    times.sort()
    return times[len(times) // 2]


def _graph_ms(fn, n=20, reps=11):
    """The device time per call of fn: n calls captured in a CUDA graph,
    the graph replayed reps times between CUDA events; the median over
    the replays, divided by n (no host launch time inside)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return _time_ms(graph.replay, reps) / n


def _sm_clock_mhz(fn, n):
    """The SM clock nvidia-smi reads while n calls of fn are queued."""
    import torch
    torch.cuda.synchronize()
    for _ in range(n):
        fn()
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    torch.cuda.synchronize()
    return mhz


def phase_kernel_timing(errs):
    """Each kernel at the main-path shapes of one CIF chunk (8 frames x 6
    candidates per block), on DCT coefficients of residual noise: kernel
    alone (CUDA events over 10 back-to-back launches), device time in a
    CUDA graph per instantiation, the wrapper and the plain version,
    beside the bound; K2 also at the device engine's 16-frame chunk.
    The SM clock while each kernel runs at 32 x 32."""
    import numpy as np
    import torch
    from wrenc_tpu_torch.kernels import quantize as kq
    from wrenc_tpu_torch.kernels import transforms
    from wrenc_tpu_torch.kernels import trellis as ktr
    W, H = CIF
    rows = {}
    rng = np.random.default_rng(3)
    for name, (kern, plain, tr) in _kernels().items():
        rows[name] = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                      "bytes_ms": 0.0, "ops_ms": 0.0, "per_size": {}}
        if not tr:
            rows[name]["per_size_16_frames"] = {}
        for frames in ((8,) if tr else (8, 16)):
            for s in SIZES:
                log2 = s.bit_length() - 1
                B = frames * (W // s) * (H // s) * N_CANDS
                P = s * s
                res = rng.integers(-24, 25, (B, s, s)).astype(np.int32)
                t = transforms.forward_impl(torch.as_tensor(res,
                                                            device="cuda"))
                qpar, lam, lv = _qcase(log2, 32, tr)
                got = kern(t, qpar.ls, qpar.bd_shift, lam, lv, log2)
                want = plain(t, qpar.ls, qpar.bd_shift, lam, lv, log2)
                torch.cuda.synchronize()
                e = _err(got, want)
                if e != 0:
                    raise AssertionError(f"{name} != plain at s={s}, "
                                         f"{frames} frames: {e}")
                errs[name] = max(errs[name], e)
                # the kernel alone, with the tables and quant parameters
                # on the card, through the wrappers' own launch helpers
                dev_args = (
                    torch.tensor([qpar.ls], dtype=torch.int32,
                                 device="cuda"),
                    torch.tensor([qpar.bd_shift], dtype=torch.int32,
                                 device="cuda"),
                    kq.table(lam, torch.int32, "cuda"),
                    kq.table(lv, torch.float32, "cuda"))
                if tr:
                    job = (t, dev_args[0], dev_args[1], log2)

                    def launch(lanes=None):
                        ktr._launch_k1([job], *dev_args[2:], lanes)
                    rule = ktr.k1_lanes([job])
                    both = log2 == 2
                else:
                    def launch(lanes=None):
                        kq._launch_k2(t, dev_args[0], dev_args[1],
                                      dev_args[2], dev_args[3], log2, lanes)
                    rule = kq.k2_lanes(log2, B)
                    both = True
                launch()
                dev_ms = {lanes: _graph_ms(lambda: launch(lanes))
                          for lanes in ((8, 1) if both else (8,))}
                if s == 32 and frames == 8:
                    rows[name]["sm_clock_mhz"] = _sm_clock_mhz(launch, 2000)
                ms = _time_ms(launch, 21, per=10)
                wrap_ms = _time_ms(
                    lambda: kern(t, qpar.ls, qpar.bd_shift, lam, lv, log2), 11)
                # as stage A calls it: every argument already on the card
                wrap_dev_ms = _time_ms(
                    lambda: kern(t, dev_args[0], dev_args[1], dev_args[2],
                                 dev_args[3], log2), 11)
                # each input read once, each output written once: int32
                # coefficients in, int16 levels and an f32 rate out
                nbytes = 6 * P * B + 4 * B + 8 * 1024
                ops = OPS_PER_POS[name] * P * B
                bytes_ms = nbytes / HBM_BYTES_S * 1e3
                ops_ms = ops / OPS_S * 1e3
                out = {"B": B, "P": P, "ms": ms, "device_ms": dev_ms,
                       "lanes": rule, "wrapper_ms": wrap_ms,
                       "wrapper_dev_args_ms": wrap_dev_ms,
                       "bound_ms": max(bytes_ms, ops_ms)}
                row = rows[name]
                if frames == 8:
                    plain_ms = _time_ms(
                        lambda: plain(t, qpar.ls, qpar.bd_shift, lam, lv,
                                      log2), 3)
                    out["plain_ms"] = plain_ms
                    row["ms"] += ms
                    row["plain_ms"] += plain_ms
                    row["bound_ms"] += max(bytes_ms, ops_ms)
                    row["bytes_ms"] += bytes_ms
                    row["ops_ms"] += ops_ms
                    row["per_size"][s] = out
                else:
                    row["per_size_16_frames"][s] = out
                log(f"{name} {frames:2d} frames s={s:2d} B={B:6d} P={P:4d}: "
                    f"kernel {ms:.4f} ms (events), device ms by lanes "
                    f"{json.dumps(dev_ms)}, launch rule {rule} lane(s); "
                    f"wrapper {wrap_ms:.4f} ms (host args) / "
                    f"{wrap_dev_ms:.4f} ms (device args)"
                    + (f", plain {out['plain_ms']:.2f} ms" if frames == 8
                       else "")
                    + f", bound {max(bytes_ms, ops_ms):.4f} ms")
        log(f"{name}: SM clock {rows[name]['sm_clock_mhz']:.0f} MHz under "
            f"load at s = 32 (nvidia-smi)")
    return rows


def phase_k1_lanes_sweep():
    """K1's two instantiations at 4 x 4, device time per launch in a CUDA
    graph, at the batch sizes LANES_SWEEP_B (prefixes of one batch of DCT
    coefficients of residual noise); the two agree exactly at the
    largest. The launch rule's ONE_LANE_MIN_B is read off this sweep."""
    import numpy as np
    import torch
    from wrenc_tpu_torch.kernels import quantize as kq
    from wrenc_tpu_torch.kernels import transforms
    from wrenc_tpu_torch.kernels import trellis as ktr
    rng = np.random.default_rng(5)
    res = rng.integers(-24, 25, (max(LANES_SWEEP_B), 4, 4)).astype(np.int32)
    t_all = transforms.forward_impl(torch.as_tensor(res, device="cuda"))
    qpar, lam, lv = _qcase(2, 32, True)
    lam = kq.table(lam, torch.int32, "cuda")
    lv = kq.table(lv, torch.float32, "cuda")
    job = (t_all, qpar.ls, qpar.bd_shift, 2)
    (a,) = ktr._launch_k1([job], lam, lv, 1)
    (b,) = ktr._launch_k1([job], lam, lv, 8)
    torch.cuda.synchronize()
    if _err(a, b) != 0:
        raise AssertionError("K1 at 4 x 4: 1 lane != 8 lanes")
    out = {}
    for B in LANES_SWEEP_B:
        jb = (t_all[:B], qpar.ls, qpar.bd_shift, 2)
        out[B] = {lanes: _graph_ms(lambda: ktr._launch_k1([jb], lam, lv,
                                                          lanes))
                  for lanes in (1, 8)}
        log(f"K1 4x4 B={B:6d}: 1 lane {out[B][1]:.5f} ms, 8 lanes "
            f"{out[B][8]:.5f} ms device; the rule takes "
            f"{ktr.k1_lanes([jb])} lane(s)")
    return out


def phase_k2_lanes_sweep():
    """K2's two instantiations (1 and 8 lanes per block) at every size,
    device time per launch in a CUDA graph, at B = 1/16, 1/8, 1/4, 1 and 2
    times the 8-frame CIF chunk's batch of that size (prefixes of one
    batch of DCT coefficients of residual noise); the two agree exactly
    at the largest. The launch rule (quantize.k2_lanes) is read off this
    sweep."""
    import numpy as np
    import torch
    from wrenc_tpu_torch.kernels import quantize as kq
    from wrenc_tpu_torch.kernels import transforms
    W, H = CIF
    rng = np.random.default_rng(23)
    out = {}
    for s in SIZES:
        log2 = s.bit_length() - 1
        b8 = 8 * (W // s) * (H // s) * N_CANDS
        res = rng.integers(-24, 25, (2 * b8, s, s)).astype(np.int32)
        t_all = transforms.forward_impl(torch.as_tensor(res, device="cuda"))
        qpar, lam, lv = _qcase(log2, 32, False)
        args = (torch.tensor([qpar.ls], dtype=torch.int32, device="cuda"),
                torch.tensor([qpar.bd_shift], dtype=torch.int32,
                             device="cuda"),
                kq.table(lam, torch.int32, "cuda"),
                kq.table(lv, torch.float32, "cuda"), log2)
        a = kq._launch_k2(t_all, *args, 1)
        b = kq._launch_k2(t_all, *args, 8)
        torch.cuda.synchronize()
        if _err(a, b) != 0:
            raise AssertionError(f"K2 at s={s}: 1 lane != 8 lanes")
        out[s] = {}
        for B in (b8 // 16, b8 // 8, b8 // 4, b8, 2 * b8):
            tb = t_all[:B]
            out[s][B] = {lanes: _graph_ms(lambda: kq._launch_k2(tb, *args,
                                                                lanes))
                         for lanes in (1, 8)}
            log(f"K2 s={s:2d} B={B:6d}: 1 lane {out[s][B][1]:.5f} ms, 8 "
                f"lanes {out[s][B][8]:.5f} ms device; the rule takes "
                f"{kq.k2_lanes(log2, B)} lane(s)")
    return out


def _chroma_jobs(size, F):
    """The K1 / K2 launches of one chunk's device chroma stage A, as (cs,
    B, launches): cb and cr go in one batch, the derived modes (at cs = 4
    also the SCIPU variant) at B = 2 * F * N blocks and the three CCLM
    candidates at 6 * F * N."""
    W, H = size
    out = []
    for cs in (4, 8, 16):
        N = (W // 2 // cs) * (H // 2 // cs)
        out += [(cs, 2 * F * N, 2 if cs == 4 else 1), (cs, 6 * F * N, 1)]
    return out


def _chroma_case(log2, trellis):
    """Quant parameters of the chroma QP of luma QP 32 (stage A's chroma
    ls / bd_shift) with the luma QP's stage-A tables, as the search passes
    them."""
    from wrenc_tpu_torch.core.config import RateModelConfig
    from wrenc_tpu_torch.kernels import quantize as kq
    from wrenc_tpu_torch.spec import quant
    rm = RateModelConfig()
    qpar = quant.derive_quant_params(quant.chroma_qp_from_luma(32), log2,
                                     log2, dep_quant=True,
                                     transform_skip=False)
    return (qpar, kq.lam_dq_table(rm, 32, trellis=trellis),
            kq.lv_table_device(rm, True, trellis))


def _launch_bound(P, B, kname):
    """(bytes ms, operations ms) of one launch at B blocks of P positions:
    int32 coefficients in, int16 levels and an f32 rate out."""
    return ((6 * P * B + 4 * B) / HBM_BYTES_S * 1e3,
            OPS_PER_POS[kname] * P * B / OPS_S * 1e3)


def phase_chroma_kernels(errs):
    """K1 and K2 against their plain twins, exactly, at the chroma shapes
    of CHROMA_CHUNKS (DCT coefficients of residual noise): through each
    launch helper in both instantiations at 4 x 4 (each lanes rule crosses
    between those shapes), and through the wrapper with the arguments the
    search uploads (ls / bd_shift as (1,) tensors, the tables on the
    card) at the rule's lanes; then each kernel's device time per launch
    in a CUDA graph per instantiation beside its bound: K2 on the default
    path, K1 under stage_a_trellis_rd=1."""
    import numpy as np
    import torch
    from wrenc_tpu_torch.kernels import quantize as kq
    from wrenc_tpu_torch.kernels import transforms
    from wrenc_tpu_torch.kernels import trellis as ktr
    rng = np.random.default_rng(29)
    out, cases = {}, 0
    for name, size, F in CHROMA_CHUNKS:
        out[name] = []
        for cs, B, _ in _chroma_jobs(size, F):
            log2 = cs.bit_length() - 1
            P = cs * cs
            res = rng.integers(-24, 25, (B, cs, cs)).astype(np.int32)
            t = transforms.forward_impl(torch.as_tensor(res, device="cuda"))
            lanes_list = (1, 8) if log2 == 2 else (8,)
            row = {"cs": cs, "B": B}
            for kname, (wrap, plain, tr) in _kernels().items():
                qpar, lam, lv = _chroma_case(log2, tr)
                want = plain(t, qpar.ls, qpar.bd_shift, lam, lv, log2)
                ls, bd = (torch.tensor([v], dtype=torch.int32, device="cuda")
                          for v in (qpar.ls, qpar.bd_shift))
                lam_d = kq.table(lam, torch.int32, "cuda")
                lv_d = kq.table(lv, torch.float32, "cuda")
                if tr:
                    def launch(lanes):
                        return ktr._launch_k1([(t, ls, bd, log2)], lam_d,
                                              lv_d, lanes)[0]
                    rule = ktr.k1_lanes([(t, ls, bd, log2)])
                else:
                    def launch(lanes):
                        return kq._launch_k2(t, ls, bd, lam_d, lv_d, log2,
                                             lanes)
                    rule = kq.k2_lanes(log2, B)
                got = {lanes: launch(lanes) for lanes in lanes_list}
                got["wrapper"] = wrap(t, ls, bd, lam_d, lv_d, log2)
                torch.cuda.synchronize()
                for how, g in got.items():
                    e = _err(g, want)
                    if e != 0:
                        raise AssertionError(
                            f"{kname} ({how}) != plain at the chroma shape "
                            f"cs={cs} B={B} ({name}): {e}")
                    errs[kname] = max(errs[kname], e)
                    cases += 1
                bytes_ms, ops_ms = _launch_bound(P, B, kname)
                row[kname] = {
                    "device_ms": {lanes: _graph_ms(lambda: launch(lanes))
                                  for lanes in lanes_list},
                    "lanes": rule, "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": ("operations" if ops_ms >= bytes_ms
                                 else "bytes")}
            out[name].append(row)
            k2, k1 = row["dq_greedy"], row["dq_trellis"]
            log(f"chroma {name}: cs={cs:2d} B={B:6d}: K1 and K2 equal to "
                f"plain (launch helpers and wrappers); device ms per launch "
                f"by lanes K2 {json.dumps(k2['device_ms'])} (rule "
                f"{k2['lanes']}), K1 {json.dumps(k1['device_ms'])} (rule "
                f"{k1['lanes']}); bound K2 {k2['bound_ms']:.4f} ms, K1 "
                f"{k1['bound_ms']:.4f} ms")
    log(f"K1 and K2: equal to their plain versions in {cases} chroma-shape "
        f"cases")
    return out


def phase_fma():
    import numpy as np
    import torch
    from wrenc_tpu_torch.kernels.transforms import fma
    rng = np.random.default_rng(11)
    n = 1 << 20
    a = rng.standard_normal(n).astype(np.float32)
    b = (rng.standard_normal(n) * 1e3).astype(np.float32)
    c = (rng.standard_normal(n) * 1e6).astype(np.float32)
    got = fma(*(torch.as_tensor(x, device="cuda") for x in (a, b, c)))
    got = got.cpu().numpy()
    want = (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)
    cpu = fma(*(torch.as_tensor(x) for x in (a, b, c))).numpy()
    if not ((got == want).all() and (got == cpu).all()):
        raise AssertionError("FMA helper on the card != f64 FMA")
    log(f"fma: equal to the f64-computed FMA on {n} random elements")


def _cfg(trellis):
    from wrenc_tpu_torch.core.config import EncoderConfig
    cfg = EncoderConfig(width=CIF[0], height=CIF[1], qp=32)
    cfg.rate_model.stage_a_trellis_rd = float(trellis)
    return cfg


def phase_main_path():
    import numpy as np
    import torch
    from wrenc_tpu_torch.decoder import decode_annexb
    from wrenc_tpu_torch.encoder import Encoder
    from wrenc_tpu_torch.search import WavefrontSearch
    frames = synth_frames(16, *CIF, seed=1)
    counters = _counters()
    out = {}
    for tr, name in ((0, "default"), (1, "stage_a_trellis_rd=1")):
        cfg = _cfg(tr)
        enc = Encoder(cfg, search=WavefrontSearch(cfg))
        t0 = time.perf_counter()
        enc.encode(frames)                                 # warm-up
        warm = time.perf_counter() - t0
        for f in counters.values():
            f.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream, recons = enc.encode(frames)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        n_chunks = -(-len(frames) // enc.search._buckets()[-1])
        need = "dq_trellis" if tr else "dq_greedy"
        if launches[need] <= 0:
            raise AssertionError(f"{name}: {need} never launched")
        # one chunk's luma stage A alone, dispatch to results on the host;
        # the dispatch itself must not synchronize (any blocking CUDA call
        # raises under the sync debug mode)
        search = enc.search
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            dispatched = search._dispatch_stage_a(frames[:8])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        search._decide_chunk(dispatched)
        t0 = time.perf_counter()
        search._decide_chunk(search._dispatch_stage_a(frames[:8]))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        search._dispatch_stage_a(frames[:8])
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        stage_a = {"dispatch_ms": (t2 - t1) * 1e3,
                   "dispatch_to_idle_ms": (t3 - t1) * 1e3,
                   "with_host_decide_ms": (t1 - t0) * 1e3}
        dec = decode_annexb(stream)
        if len(dec) != len(frames) or not all(
                (dec[k][c] == recons[k][c]).all()
                for k in range(len(frames)) for c in range(3)):
            raise AssertionError(f"{name}: decode != reconstruction")
        mse = np.mean([(r[0].astype(np.float64) - f[0]) ** 2
                       for r, f in zip(recons, frames)])
        psnr = 10 * np.log10(255 ** 2 / mse)
        phases = {k: round(v, 4) for k, v in enc.phase_times.items()}
        STREAMS[name] = stream
        out[name] = {"fps": len(frames) / dt, "seconds": dt,
                     "warmup_seconds": warm, "bytes": len(stream),
                     "psnr_y": psnr, "launches": launches,
                     "launches_per_chunk": {
                         k: v / n_chunks for k, v in launches.items()},
                     "phase_times": phases, "stage_a_one_chunk": stage_a}
        log(f"main path [{name}]: {len(frames)} CIF frames QP 32 in "
            f"{dt:.3f} s = {len(frames) / dt:.3f} fps (warm-up {warm:.1f} "
            f"s), {len(stream)} bytes, PSNR-Y {psnr:.2f} dB, launches "
            f"{launches}")
        log(f"  phase_times (s): {json.dumps(phases)}")
        log(f"  stage A, one 8-frame chunk alone: dispatch "
            f"{stage_a['dispatch_ms']:.1f} ms, dispatch until the device "
            f"is idle {stage_a['dispatch_to_idle_ms']:.1f} ms; with the "
            f"host decide {stage_a['with_host_decide_ms']:.1f} ms")
    return out


def phase_card_vs_cpu():
    from wrenc_tpu_torch.core.config import EncoderConfig
    from wrenc_tpu_torch.decoder import decode_annexb
    from wrenc_tpu_torch.encoder import Encoder
    from wrenc_tpu_torch.search import WavefrontSearch
    # (name, config, search arguments, frames, device chroma expected)
    cases = [(f"stage_a_trellis_rd={tr}", _cfg(tr), {}, 2, False)
             for tr in (0, 1)]
    cases.append(("chroma_stage_a=device", _cfg(0),
                  {"chroma_stage_a": "device"}, 2, True))
    small = EncoderConfig(width=96, height=64, qp=32)
    cases.append(("commit_engine=device", small, DEVICE_ENGINE, 2, False))
    cases.append(("commit_engine=device, default chroma", small,
                  {"commit_engine": "device"}, 2, True))
    cases.append(("default", EncoderConfig(width=P1080[0], height=P1080[1],
                                           qp=32), {}, 1, True))
    out = {}
    for name, cfg, kw, n, chroma_dev in cases:
        size = (cfg.width, cfg.height)
        frames = synth_frames(n, *size, seed=5)
        search = WavefrontSearch(cfg, **kw)
        if search._chroma_device != chroma_dev:
            raise AssertionError(f"{name}: device chroma "
                                 f"{search._chroma_device}")
        s_gpu, r_gpu = Encoder(cfg, search=search).encode(frames)
        t0 = time.perf_counter()
        s_cpu, _ = Encoder(cfg, search=WavefrontSearch(
            cfg, device="cpu", **kw)).encode(frames)
        t_cpu = time.perf_counter() - t0
        if s_gpu != s_cpu:
            raise AssertionError(f"{name} {size}: card bytes != CPU bytes")
        dec = decode_annexb(s_gpu)
        if not all((dec[k][c] == r_gpu[k][c]).all()
                   for k in range(n) for c in range(3)):
            raise AssertionError(f"{name} {size}: decode != reconstruction")
        if size == P1080:
            STREAMS["1080p"] = s_gpu
        out[f"{size[0]}x{size[1]} {name}"] = {"bytes": len(s_gpu),
                                               "cpu_seconds": t_cpu}
        log(f"{n}-frame {size[0]}x{size[1]} encode, {name}: card bytes == "
            f"CPU bytes ({len(s_gpu)} bytes; CPU encode {t_cpu:.1f} s), "
            f"decode == reconstruction")
    return out


def _same_planes(a, b, name):
    if len(a) != len(b) or not all(
            (a[k][c] == b[k][c]).all() for k in range(len(a))
            for c in range(3)):
        raise AssertionError(f"{name}: reconstructions differ")


def phase_commit_paths():
    """The commit paths on CIF synthetic frames at QP 32 (the main path's
    geometry): per-QG QP (qp_delta_pattern) on 2 frames, its three
    decoders and card bytes == CPU bytes; rd_commit=False and
    trellis_commit=False on 16 frames each,
    warm-up then timed with the counters reset just before and read just
    after, decode == reconstruction, card bytes == CPU bytes on 2 frames;
    the apply-decisions prototype commit_frame_device on the trees of 2
    frames of a trellis_commit=False, rd_commit=False search (_proto)."""
    import numpy as np
    from wrenc_tpu_torch.conformance import decode_annexb_independent
    from wrenc_tpu_torch.decoder import decode_annexb
    from wrenc_tpu_torch.encoder import Encoder
    from wrenc_tpu_torch.search import WavefrontSearch
    frames = synth_frames(16, *CIF, seed=1)
    out = {}

    name = "qp_delta_pattern=(-3, 0, 4)"
    cfg = _cfg(0)
    cfg.qp_delta_pattern = (-3, 0, 4)
    enc = Encoder(cfg, search=WavefrontSearch(cfg))
    stream, recons, dt, launches = _timed_encode(enc, frames[:2],
                                                 ["dq_greedy"])
    for how, dec in (("shipped", decode_annexb(stream, use_native=False)),
                     ("shipped, native", decode_annexb(stream)),
                     ("clean-room", decode_annexb_independent(stream))):
        _same_planes([tuple(np.asarray(p) for p in f) for f in dec],
                     recons, f"{name}, {how} decoder")
    s_cpu, _ = Encoder(cfg, search=WavefrontSearch(cfg, device="cpu")) \
        .encode(frames[:2])
    if s_cpu != stream:
        raise AssertionError(f"{name}: card bytes != CPU bytes")
    phases = {k: round(v, 4) for k, v in enc.phase_times.items()}
    out[name] = {"frames": 2, "seconds": dt, "bytes": len(stream),
                 "launches": launches, "phase_times": phases}
    log(f"commit paths [{name}]: 2 CIF frames in {dt:.3f} s, {len(stream)} "
        f"bytes, launches {launches}; the three decoders reproduce the "
        f"reconstruction; card bytes == CPU bytes")
    log(f"  phase_times (s): {json.dumps(phases)}")

    cfg = _cfg(0)
    for name, kw in (("rd_commit=False", {"rd_commit": False}),
                     ("trellis_commit=False", {"trellis_commit": False})):
        search = WavefrontSearch(cfg, **kw)
        cpu = WavefrontSearch(cfg, device="cpu", **kw)
        enc = Encoder(cfg, search=search)
        enc.encode(frames)                                 # warm-up
        stream, recons, dt, launches = _timed_encode(enc, frames,
                                                     ["dq_greedy"])
        _decodes(stream, recons, name)
        phases = {k: round(v, 4) for k, v in enc.phase_times.items()}
        s2, _ = enc.encode(frames[:2])
        c2, _ = Encoder(cfg, search=cpu).encode(frames[:2])
        if s2 != c2:
            raise AssertionError(f"{name}: card bytes != CPU bytes")
        out[name] = {"fps": len(frames) / dt, "seconds": dt,
                     "bytes": len(stream), "psnr_y": _psnr_y(recons, frames),
                     "launches": launches, "phase_times": phases}
        log(f"commit paths [{name}]: {len(frames)} CIF frames in {dt:.3f} s "
            f"= {out[name]['fps']:.3f} fps, {len(stream)} bytes, PSNR-Y "
            f"{out[name]['psnr_y']:.2f} dB, launches {launches}; decode == "
            f"reconstruction; card bytes == CPU bytes on 2 frames")
        log(f"  phase_times (s): {json.dumps(phases)}")
    out["commit_frame_device"] = _proto(frames[:2])
    return out


def _proto(frames):
    """commit_frame_device on the card against the port's NumPy _commit
    (reconstruction and every CU's levels), per frame: its plan's padded
    rows scatter only into the pad slot (the real rows' targets distinct,
    no gather reads the slot); every launch counter set to 0 just before
    each call and read just after: K2's equals the plan's steps (non-empty
    component groups) and the launches its helper saw, K1's are 0;
    the commit's wall time; those very launches replayed in a CUDA graph
    (K2's device time per frame) beside their bound. Then K2's launch
    helper in both instantiations at every distinct (n, padded B) the
    prototype launched, with the tables it uploaded, exactly against
    greedy_depquant_plain; device and plain time per launch."""
    import copy
    import numpy as np
    import torch
    from wrenc_tpu_torch.kernels import quantize as kq
    from wrenc_tpu_torch.search import WavefrontSearch
    from wrenc_tpu_torch.search import device_commit as dc
    cfg = _cfg(0)
    search = WavefrontSearch(cfg, trellis_commit=False, rd_commit=False)
    launch = kq._launch_k2
    per_frame, shapes = [], {}
    launches = dict.fromkeys(_counters(), 0)
    for fi, (trees, _) in enumerate(search.encode_frames(frames)):
        ref, mine = copy.deepcopy(trees), copy.deepcopy(trees)
        orig = [np.asarray(p, np.int32) for p in frames[fi]]
        t0 = time.perf_counter()
        rec_np = search._commit(ref, orig)
        np_s = time.perf_counter() - t0
        cus = search._collect_cus(mine)
        steps = dc.plan_steps(cfg, cus)
        for st in steps:
            s = 1 << st.log2
            src, _, _, _, _, scat = dc._geometry(
                cfg.width, cfg.height, s, st.c_idx, cfg.log2_ctu_size)[:6]
            pad = (cfg.width >> (st.c_idx > 0)) * (cfg.height
                                                   >> (st.c_idx > 0))
            real = scat[st.idx[:st.B]].reshape(-1)
            if (len(np.unique(real)) != real.size or real.max() >= pad
                    or src[st.idx].max() >= pad
                    or (st.idx[st.B:] != st.idx[st.B - 1]).any()):
                raise AssertionError("commit_frame_device: a step's rows "
                                     "repeat a target or read the pad slot")
        recorded = []

        def record(*a):
            recorded.append(a)
            return launch(*a)
        kq._launch_k2 = record
        counters = _counters()
        for f in counters.values():
            f.launches = 0
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = dc.commit_frame_device(cfg, frames[fi], cus)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            kq._launch_k2 = launch
        counted = {k: f.launches for k, f in counters.items()}
        for k, v in counted.items():
            launches[k] += v
        n = counted["dq_greedy"]
        if not n == len(steps) == len(recorded):
            raise AssertionError(f"commit_frame_device: K2 launched {n} "
                                 f"times, {len(recorded)} seen, "
                                 f"{len(steps)} steps")
        if counted["dq_trellis"] or counted["dq_trellis_batch"]:
            raise AssertionError(f"commit_frame_device launched K1: "
                                 f"{counted}")
        for c in range(3):
            if not (rec[c] == rec_np[c]).all():
                raise AssertionError(f"commit_frame_device: plane {c} != "
                                     "the NumPy commit's")
        for a, b in zip(cus, search._collect_cus(ref)):
            for c in range(3):
                if (a.coeffs[c] is None) != (b.coeffs[c] is None) or (
                        a.coeffs[c] is not None
                        and not (a.coeffs[c] == b.coeffs[c]).all()):
                    raise AssertionError("commit_frame_device: levels != "
                                         "the NumPy commit's")
        device_ms = _graph_ms(lambda: [launch(*a) for a in recorded], n=2,
                              reps=5)
        bounds = [_launch_bound(a[0].shape[1] ** 2, a[0].shape[0],
                                "dq_greedy") for a in recorded]
        for a in recorded:
            key = (a[0].shape[1], a[0].shape[0])
            shapes.setdefault(key, [a, 0])[1] += 1
        per_frame.append({
            "steps": len(steps), "k2_launches": n, "cus": len(cus),
            "seconds": dt, "numpy_commit_seconds": np_s,
            "k2_device_ms": device_ms,
            "k2_bound_ms": sum(max(b) for b in bounds),
            "k2_bytes_ms": sum(b[0] for b in bounds)})
        f = per_frame[-1]
        log(f"commit_frame_device, CIF frame {fi}: launches counted from 0 "
            f"{counted} (K2 = {len(steps)} steps, {len(cus)} CUs), {dt:.3f} s "
            f"(NumPy commit {np_s:.3f} s), reconstruction and levels == the "
            f"NumPy commit's; K2 {device_ms:.4f} ms device time for those "
            f"launches (CUDA graph), bound {f['k2_bound_ms']:.4f} ms "
            f"(bytes {f['k2_bytes_ms']:.4f})")
    rows, cases = [], 0
    for (s, B), (a, count) in sorted(shapes.items()):
        t, ls, bd, lam, lv, lg = a
        want = kq.greedy_depquant_plain(t, ls, bd, lam, lg, lv)
        for lanes in (1, 8):
            e = _err(launch(*a, lanes), want)
            torch.cuda.synchronize()
            if e != 0:
                raise AssertionError(f"K2 ({lanes} lanes) != plain at the "
                                     f"prototype's n={s} B={B}: {e}")
            cases += 1
        bytes_ms, ops_ms = _launch_bound(s * s, B, "dq_greedy")
        rows.append({
            "n": s, "B": B, "launches": count, "lanes": kq.k2_lanes(lg, B),
            "device_ms": _graph_ms(lambda: launch(*a)),
            "plain_ms": _time_ms(
                lambda: kq.greedy_depquant_plain(t, ls, bd, lam, lg, lv), 1),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"})
    log(f"K2: equal to its plain version in {cases} cases at the "
        f"prototype's {len(rows)} distinct (n, padded B), both "
        f"instantiations, with the tables it uploaded; per launch "
        f"(n, B, launches, device ms, plain ms, bound ms): "
        + json.dumps([(r["n"], r["B"], r["launches"],
                       round(r["device_ms"], 5), round(r["plain_ms"], 3),
                       round(r["bound_ms"], 6)) for r in rows]))
    return {"frames": per_frame, "per_launch": rows, "cases": cases,
            "launches": launches}


DEVICE_ENGINE = {"commit_engine": "device", "chroma_stage_a": "native"}
# the single-device card streams of the 16 CIF frames (seed 1, QP 32) by
# configuration, kept by phases 4 and 8 for the mesh phase to compare
STREAMS = {}


def _decodes(stream, recons, name):
    from wrenc_tpu_torch.decoder import decode_annexb
    dec = decode_annexb(stream)
    if len(dec) != len(recons) or not all(
            (dec[k][c] == recons[k][c]).all()
            for k in range(len(recons)) for c in range(3)):
        raise AssertionError(f"{name}: decode != reconstruction")


def _psnr_y(recons, frames):
    import numpy as np
    mse = np.mean([(r[0].astype(np.float64) - f[0]) ** 2
                   for r, f in zip(recons, frames)])
    return 10 * np.log10(255 ** 2 / mse)


def _counted(fn, need=()):
    """fn() between a reset of the launch counters and a read of them,
    each side synchronized; fails when a kernel in `need` was not
    launched. Returns (fn's result, seconds, launches)."""
    import torch
    counters = _counters()
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    for k in need:
        if launches[k] <= 0:
            raise AssertionError(f"{k} never launched")
    return res, dt, launches


def _timed_encode(enc, frames, need):
    """One encode counted from 0 (_counted)."""
    (stream, recons), dt, launches = _counted(lambda: enc.encode(frames),
                                              need)
    return stream, recons, dt, launches


def _helper(kname):
    """(module, name) of `kname`'s launch helper, which the wrapper calls
    and which does not count."""
    from wrenc_tpu_torch.kernels import quantize as kq
    from wrenc_tpu_torch.kernels import trellis as ktr
    return (ktr, "_launch_k1") if kname == "dq_trellis" else \
        (kq, "_launch_k2")


@contextlib.contextmanager
def _recording(kname):
    """Every call of `kname`'s launch helper inside the block, its
    arguments kept (the tensors stay alive) in the list it yields."""
    mod, name = _helper(kname)
    launch, recorded = getattr(mod, name), []

    def record(*a):
        recorded.append(a)
        return launch(*a)
    setattr(mod, name, record)
    try:
        yield recorded
    finally:
        setattr(mod, name, launch)


def _replay(kname, recorded):
    """A function that launches the recorded calls again through the
    helper (uncounted)."""
    mod, name = _helper(kname)
    launch = getattr(mod, name)
    return lambda: [launch(*a) for a in recorded]


def _launch_shapes(kname, recorded):
    """(s, B, lanes) of each recorded launch, lanes by the launch rule."""
    from wrenc_tpu_torch.kernels import quantize as kq
    from wrenc_tpu_torch.kernels import trellis as ktr
    if kname == "dq_trellis":
        return [(a[0][0][0].shape[1], a[0][0][0].shape[0],
                 ktr.k1_lanes(a[0])) for a in recorded]
    return [(a[0].shape[1], a[0].shape[0],
             kq.k2_lanes(a[5], a[0].shape[0])) for a in recorded]


def _bounds(kname, shapes):
    """(bound ms, bytes ms, bound_by) of the launches at `shapes`."""
    bounds = [_launch_bound(s * s, B, kname) for s, B, _ in shapes]
    bytes_ms, ops_ms = (sum(b[i] for b in bounds) for i in (0, 1))
    return (sum(max(b) for b in bounds), bytes_ms,
            "operations" if ops_ms >= bytes_ms else "bytes")


def _chroma_inputs(search, frames):
    """The arguments of one chunk's _dispatch_chroma (the luma modes its
    decide saw, the sizes, the device planes), from one dispatch and
    decide."""
    seen = {}
    prefill = search._prefill_chroma_device

    def spy(cache, luma_mode_b, sizes, F, dev_planes):
        seen["args"] = (luma_mode_b, sizes, dev_planes)
        return prefill(cache, luma_mode_b, sizes, F, dev_planes)
    search._prefill_chroma_device = spy
    try:
        search._decide_chunk(search._dispatch_stage_a(frames))
    finally:
        del search._prefill_chroma_device
    return seen["args"]


def _chroma_chunk(search, frames, name):
    """One chunk's device chroma stage A alone, from the luma modes its
    decide saw. The dispatch runs under the CUDA sync debug mode "error"
    (any blocking call raises) with the launch counters set to 0 just
    before it and read just after: the count of the kernel its RD chain
    runs (K2, or K1 under stage_a_trellis_rd=1) must equal the launches
    that kernel's launch helper saw and _chroma_jobs' count for the
    chunk, and the other kernels' must be 0. Then those very launches
    (their arguments kept) replayed in a CUDA graph: the kernel's device
    time per chunk beside its bound; a second dispatch counting the
    PyTorch operators; a third with its one fetch."""
    import torch
    lmb, sizes, devp = _chroma_inputs(search, frames)
    Fp = int(devp[0].shape[0])
    trellis = bool(search.rm.stage_a_trellis_rd)
    kname = "dq_trellis" if trellis else "dq_greedy"
    counters = _counters()
    torch.cuda.synchronize()
    with _recording(kname) as recorded:
        for f in counters.values():
            f.launches = 0
        torch.cuda.set_sync_debug_mode("error")
        try:
            t1 = time.perf_counter()
            search._dispatch_chroma(lmb, sizes, devp)
            t2 = time.perf_counter()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    launches = {k: f.launches for k, f in counters.items()}
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    want = sum(n for _, _, n in _chroma_jobs(
        (search.cfg.width, search.cfg.height), Fp))
    others = sum(v for k, v in launches.items() if k != kname)
    if not launches[kname] == len(recorded) == want or others:
        raise AssertionError(f"{name}: chroma stage A launched {launches}, "
                             f"{kname}'s helper saw {len(recorded)}, want "
                             f"{want}")
    shapes = _launch_shapes(kname, recorded)
    device_ms = _graph_ms(_replay(kname, recorded), n=5)
    bound, bytes_ms, _ = _bounds(kname, shapes)
    with _OpCount() as oc:
        search._dispatch_chroma(lmb, sizes, devp)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    search._prefill_chroma_device({}, lmb, sizes, len(frames), devp)
    t5 = time.perf_counter()
    ops = dict(oc.counts.most_common())
    out = {"frames": Fp, "kernel": kname, "dispatch_ms": (t2 - t1) * 1e3,
           "dispatch_to_idle_ms": (t3 - t1) * 1e3,
           "with_fetch_ms": (t5 - t4) * 1e3, "launches": launches,
           "shapes": shapes, "device_ms": device_ms, "bound_ms": bound,
           "bytes_ms": bytes_ms,
           "ops": sum(ops.values()), "top_ops": dict(list(ops.items())[:12])}
    log(f"  chroma stage A, one {Fp}-frame chunk alone ({name}): dispatch "
        f"{out['dispatch_ms']:.1f} ms (under the sync debug mode 'error'), "
        f"until the device is idle {out['dispatch_to_idle_ms']:.1f} ms, "
        f"with the fetch {out['with_fetch_ms']:.1f} ms; launches {launches}"
        f" (cs, B, lanes) {shapes}; {kname} {device_ms:.4f} ms device time "
        f"per chunk (those launches in a CUDA graph), bound "
        f"{out['bound_ms']:.4f} ms; {out['ops']} PyTorch operators, most "
        f"frequent {json.dumps(out['top_ops'])}")
    return out


def phase_1080p():
    """4 synthetic 1920x1088 frames at QP 32. The default path (native
    engine, device chroma: 1-frame chunks), warm-up then timed; one
    chunk's chroma stage A alone; then the device engine in its default
    configuration, one 4-frame group: an encode that captures its
    scan's step graphs, one that replays them, and its chroma stage A
    alone."""
    from wrenc_tpu_torch.core.config import EncoderConfig
    from wrenc_tpu_torch.encoder import Encoder
    from wrenc_tpu_torch.search import WavefrontSearch
    frames = synth_frames(4, *P1080, seed=2)
    cfg = EncoderConfig(width=P1080[0], height=P1080[1], qp=32)
    search = WavefrontSearch(cfg)
    if not search._chroma_device or search._device_commit:
        raise AssertionError("1080p default: want device chroma, native "
                             "engine")
    enc = Encoder(cfg, search=search)
    t0 = time.perf_counter()
    enc.encode(frames)                                     # warm-up
    warm = time.perf_counter() - t0
    stream, recons, dt, launches = _timed_encode(enc, frames, ["dq_greedy"])
    _decodes(stream, recons, "1080p default")
    n_chunks = -(-len(frames) // search._buckets()[-1])
    phases = {k: round(v, 4) for k, v in enc.phase_times.items()}
    out = {"fps": len(frames) / dt, "seconds": dt, "warmup_seconds": warm,
           "bytes": len(stream), "psnr_y": _psnr_y(recons, frames),
           "launches": launches, "chunks": n_chunks,
           "launches_per_chunk": {k: v / n_chunks
                                  for k, v in launches.items()},
           "phase_times": phases}
    log(f"1080p default: {len(frames)} frames QP 32 in {dt:.3f} s = "
        f"{out['fps']:.3f} fps (warm-up {warm:.1f} s), {len(stream)} bytes,"
        f" PSNR-Y {out['psnr_y']:.2f} dB, {n_chunks} chunks, launches "
        f"{launches}; decode == reconstruction")
    log(f"  phase_times (s): {json.dumps(phases)}")
    out["chroma_one_chunk"] = _chroma_chunk(search, frames[:1],
                                            "1080p default")
    # K1 at the chroma shapes: the same chunk under stage_a_trellis_rd=1
    tcfg = EncoderConfig(width=P1080[0], height=P1080[1], qp=32)
    tcfg.rate_model.stage_a_trellis_rd = 1.0
    out["chroma_one_chunk_trellis"] = _chroma_chunk(
        WavefrontSearch(tcfg), frames[:1], "1080p stage_a_trellis_rd=1")

    # the device engine in its default configuration: one 4-frame group
    dsearch = WavefrontSearch(cfg, commit_engine="device")
    if not (dsearch._device_commit and dsearch._chroma_device):
        raise AssertionError("1080p device engine: want device chroma")
    denc = Encoder(cfg, search=dsearch)
    dstream, drecons, ddt, dl = _timed_encode(denc, frames, ["dq_greedy"])
    first = _scan_counts(denc)
    _decodes(dstream, drecons, "1080p device engine")
    # again: the scan replays the graphs the first call captured
    again, _, adt, dl = _timed_encode(denc, frames, ["dq_greedy"])
    counts = _scan_counts(denc)
    if (again != dstream or counts["n_commit_graph_captures"] != 0
            or counts["n_commit_graph_replays"] != counts["n_commit_steps"]):
        raise AssertionError(f"1080p device engine again: {counts}, same "
                             f"bytes {again == dstream}")
    dl["dq_trellis_in_scan"] = counts["n_dq_trellis_launches"]
    dphases = {k: round(v, 4) for k, v in denc.phase_times.items()}
    d = out["device_engine"] = {
        "fps": len(frames) / adt, "seconds": adt, "bytes": len(dstream),
        "first_seconds": ddt, "first_counts": first, "counts": counts,
        "psnr_y": _psnr_y(drecons, frames), "launches": dl,
        "phase_times": dphases}
    log(f"1080p device engine (default chroma): {len(frames)} frames in one "
        f"group; first call {ddt:.3f} s ({first['n_commit_graph_captures']} "
        f"graphs captured, {first['n_commit_steps']} steps, "
        f"{first['n_commit_rows_padded']} padded rows of "
        f"{first['n_commit_rows_padded'] + first['n_commit_rows_live']}), "
        f"again {adt:.3f} s = {d['fps']:.3f} fps (all replays), "
        f"{len(dstream)} bytes (native engine {len(stream)}), PSNR-Y "
        f"{d['psnr_y']:.2f} dB, launches {dl}; decode == reconstruction")
    log(f"  phase_times (s): {json.dumps(dphases)}")
    d["chroma_one_chunk"] = _chroma_chunk(dsearch, frames,
                                          "1080p device engine")
    return out


def _counters():
    from wrenc_tpu_torch.kernels import quantize, trellis
    return {"dq_greedy": quantize.greedy_depquant,
            "dq_trellis": trellis.trellis_rate,
            "dq_trellis_batch": trellis.trellis_rate_batch}


class _OpCount:
    """Counts the PyTorch operators dispatched while it is entered."""

    def __init__(self):
        import collections
        from torch.utils._python_dispatch import TorchDispatchMode
        counts = self.counts = collections.Counter()

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counts[str(func.overloadpacket.__name__)] += 1
                return func(*args, **(kwargs or {}))
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _scan(search, frames, debug_first=False, profile=False,
          count_ops=False):
    """Stage A and the decide for `frames` (one chunk), then the device
    commit alone: the schedule and the scan's set-up (host clock), and
    the scan timed from its first step to its fetched result, with the
    job shapes [(P, B)] of each K1 launch in launch order (from the
    step graphs that ran) and the scan's counts.
    debug_first: run the first segment under the CUDA sync debug mode
    "error", so any host-device synchronization in the step loop raises.
    profile: trace the scan's kernels with torch.profiler (CUDA activity
    only) and return their summed device time and each K1 kernel's
    device time, in launch order. count_ops: count the PyTorch operators
    the step loop dispatches."""
    import torch
    from wrenc_tpu_torch.search import device_commit as dc
    batch, trees, devp = search._decide_chunk(
        search._dispatch_stage_a(frames))
    t0 = time.perf_counter()
    segs, has_ph = dc._build_schedule(search.cfg, trees)
    t1 = time.perf_counter()
    ctx = dc._context(search.cfg, len(batch), devp[0].device)
    rec = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) if profile
        else _OpCount() if count_ops else contextlib.nullcontext())
    with ctx.lock:
        scan = dc.RdScan(search.cfg, len(batch), segs, has_ph, devp, ctx)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with rec as prof:
            t3 = time.perf_counter()
            for si in range(len(segs)):
                if debug_first and si == 0:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    scan.run_segment(si)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            recons, _ = scan.finish()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t3
    steps = sum(len({r for rows in seg.values() for r in range(dc.SEG)
                     if rows.off[r + 1] > rows.off[r]}) for seg in segs)
    shapes = [tuple((n * m, B) for B, n, m in jobs)
              for seg in scan.steps for st in seg
              for jobs in scan.ctx.graphs[scan.key + (st.sig,)][1]]
    out = {"seconds": dt, "schedule_seconds": t1 - t0,
           "setup_seconds": t2 - t1, "steps": steps, "segments": len(segs),
           "phantoms": has_ph, "k1_shapes": shapes,
           "counts": dict(scan.counts)}
    if profile:
        out["device_busy_seconds"] = sum(
            getattr(e, "self_device_time_total", 0.0)
            for e in prof.key_averages()) / 1e6
        k1 = sorted((e for e in prof.events()
                     if "dq_trellis_kernel" in e.name),
                    key=lambda e: e.time_range.start)
        out["k1_device_ms"] = [e.device_time_total / 1e3 for e in k1]
    if count_ops:
        out["ops"] = dict(prof.counts.most_common())
    return out, recons


def phase_device_commit(native_report):
    import numpy as np
    import torch
    from wrenc_tpu_torch.decoder import decode_annexb
    from wrenc_tpu_torch.encoder import Encoder
    from wrenc_tpu_torch.search import WavefrontSearch
    frames = synth_frames(16, *CIF, seed=1)
    cfg = _cfg(0)
    enc = Encoder(cfg, search=WavefrontSearch(cfg, **DEVICE_ENGINE))
    t0 = time.perf_counter()
    enc.encode(frames)                                     # warm-up
    warm = time.perf_counter() - t0
    warm_counts = {k: v for k, v in enc.phase_times.items()
                   if k.startswith("n_")}
    # the same frames again: every rank step replays the graph its shape
    # captured in the warm-up, so trellis_rate_batch is never called; the
    # scan's count of the K1 launches it replayed is held against a
    # torch.profiler trace of the same scan below
    stream, recons, dt, launches = _timed_encode(enc, frames, ["dq_greedy"])
    counts = _scan_counts(enc)
    if (counts["n_commit_graph_captures"] != 0
            or counts["n_commit_graph_replays"] != counts["n_commit_steps"]
            or launches["dq_trellis_batch"] != 0):
        raise AssertionError(f"device engine, same frames again: {counts}, "
                             f"launches {launches}")
    launches["dq_trellis_in_scan"] = counts["n_dq_trellis_launches"]
    dec = decode_annexb(stream)
    if len(dec) != len(frames) or not all(
            (dec[k][c] == recons[k][c]).all()
            for k in range(len(frames)) for c in range(3)):
        raise AssertionError("device engine: decode != reconstruction")
    mse = np.mean([(r[0].astype(np.float64) - f[0]) ** 2
                   for r, f in zip(recons, frames)])
    psnr = 10 * np.log10(255 ** 2 / mse)
    phases = {k: round(v, 4) for k, v in enc.phase_times.items()}
    STREAMS["commit_engine=device"] = stream
    log(f"device engine: {len(frames)} CIF frames QP 32 in {dt:.3f} s = "
        f"{len(frames) / dt:.3f} fps (warm-up {warm:.1f} s: "
        f"{warm_counts['n_commit_graph_captures']} step graphs captured), "
        f"{len(stream)} bytes, PSNR-Y {psnr:.2f} dB, launches {launches} "
        f"(one K1 launch per wave); native engine (report only): "
        f"{native_report['bytes']} bytes, PSNR-Y "
        f"{native_report['psnr_y']:.2f} dB")
    log(f"  phase_times (s): {json.dumps(phases)}")

    # the engine's default configuration: device chroma
    enc_dc = Encoder(cfg, search=WavefrontSearch(cfg,
                                                 commit_engine="device"))
    if not enc_dc.search._chroma_device:
        raise AssertionError("device engine: default chroma is not device")
    s_dc, r_dc, dt_dc, l_dc = _timed_encode(enc_dc, frames, ["dq_greedy"])
    l_dc["dq_trellis_in_scan"] = _scan_counts(enc_dc)["n_dq_trellis_launches"]
    _decodes(s_dc, r_dc, "device engine, default chroma")
    default_chroma = {
        "fps": len(frames) / dt_dc, "seconds": dt_dc, "bytes": len(s_dc),
        "psnr_y": _psnr_y(r_dc, frames), "launches": l_dc,
        "phase_times": {k: round(v, 4)
                        for k, v in enc_dc.phase_times.items()}}
    log(f"device engine, default (device) chroma: {len(frames)} CIF frames "
        f"in {dt_dc:.3f} s = {len(frames) / dt_dc:.3f} fps, {len(s_dc)} "
        f"bytes (native chroma {len(stream)}), launches {l_dc}; "
        f"phase_times {json.dumps(default_chroma['phase_times'])}")
    default_chroma["chroma_one_chunk"] = _chroma_chunk(
        enc_dc.search, frames, "CIF device engine")

    # the scan alone: first segment under the sync debug mode, then timed
    search = enc.search
    sc, rec_scan = _scan(search, frames, debug_first=True)
    if not all((rec_scan[k][c] == recons[k][c]).all()
               for k in range(len(frames)) for c in range(3)):
        raise AssertionError("device engine: scan alone != encode")
    log(f"  scan alone: schedule {sc['schedule_seconds']:.3f} s, set-up "
        f"{sc['setup_seconds']:.3f} s, then {sc['steps']} rank steps in "
        f"{sc['segments']} segments (phantoms: {sc['phantoms']}) in "
        f"{sc['seconds']:.3f} s = {sc['seconds'] / sc['steps'] * 1e3:.2f} "
        f"ms per step; the first segment ran under the sync debug mode "
        f"'error'; counts {json.dumps(sc['counts'])}")
    prof, _ = _scan(search, frames, profile=True)
    k1_ms = prof["k1_device_ms"]
    shapes = prof["k1_shapes"]
    # the same frames make the same schedule: the timed encode's counts
    # against the schedule's steps and the trace's K1 kernels
    if not (len(k1_ms) == len(shapes) == counts["n_dq_trellis_launches"]
            and sc["steps"] == counts["n_commit_steps"]):
        raise AssertionError(
            f"torch.profiler traced {len(k1_ms)} K1 kernels in "
            f"{sc['steps']} steps; the step graphs hold {len(shapes)} "
            f"launches; the timed encode counted {counts}")
    busy = prof["device_busy_seconds"]
    sc["device_busy_seconds"] = busy
    sc["profiled_seconds"] = prof["seconds"]
    log(f"  scan under torch.profiler (CUDA activity): {prof['seconds']:.3f}"
        f" s, kernels {busy:.3f} s = device busy "
        f"{100 * busy / prof['seconds']:.1f} % of the profiled scan, "
        f"{100 * busy / sc['seconds']:.1f} % of the unprofiled one"
        if busy else "  scan under torch.profiler: no device time traced")
    t_ops = time.perf_counter()
    ops = _scan(search, frames, count_ops=True)[0]["ops"]
    n_ops = sum(ops.values())
    sc["ops_per_step"] = n_ops / sc["steps"]
    sc["top_ops"] = dict(list(ops.items())[:12])
    log(f"  scan step loop: {n_ops} PyTorch operators dispatched, "
        f"{n_ops / sc['steps']:.0f} per step; most frequent: "
        f"{json.dumps(sc['top_ops'])} "
        f"({time.perf_counter() - t_ops:.1f} s with the counter)")
    log(f"  K1 inside the scan: {len(k1_ms)} launches traced by "
        f"torch.profiler = the timed encode's count, {sum(k1_ms):.3f} ms "
        f"summed device time")
    groups = _device_groups(cfg)
    return {"fps": len(frames) / dt, "seconds": dt, "warmup_seconds": warm,
            "warmup_counts": warm_counts, "counts": counts,
            "bytes": len(stream), "psnr_y": psnr, "launches": launches,
            "phase_times": phases, "default_chroma": default_chroma,
            "native_engine": {k: native_report[k] for k in ("bytes",
                                                            "psnr_y")},
            "scan": dict(sc, k1_launches=len(k1_ms),
                         k1_device_ms_sum=sum(k1_ms)),
            "k1_shapes": shapes, "k1_ms": k1_ms, "groups": groups}


def _scan_counts(enc):
    """The device commit's counts (device_commit.COUNTS) of enc's last
    call, from its phase_times; fails when its scans launched no K1."""
    from wrenc_tpu_torch.search import device_commit as dc
    counts = {k: enc.phase_times.get(k, 0) for k in dc.COUNTS}
    if counts["n_dq_trellis_launches"] <= 0:
        raise AssertionError(f"device engine: no K1 launch in the scan "
                             f"({counts})")
    return counts


def _device_groups(cfg):
    """The device engine committing in the worker thread. 32 CIF frames
    (two 16-frame chunks, one 32-frame scan in the worker), twice: the
    first call captures that scan's graphs, the second replays them;
    reconstructions equal to the two halves encoded apart (each a
    16-frame scan on the main thread), decode == reconstruction. Then
    48 frames of 64x64 in commit groups of 16 (_commit_group_frames): each
    group's graphs captured in the worker while the main thread runs the
    next chunk's stage A and decide; card bytes == CPU bytes."""
    from wrenc_tpu_torch.core.config import EncoderConfig
    from wrenc_tpu_torch.encoder import Encoder
    from wrenc_tpu_torch.search import WavefrontSearch
    out = {}
    frames = synth_frames(32, *CIF, seed=3)
    enc = Encoder(cfg, search=WavefrontSearch(cfg, **DEVICE_ENGINE))
    calls = []
    for _ in range(2):
        stream, recons, dt, _ = _timed_encode(enc, frames, ["dq_greedy"])
        calls.append((stream, dt, _scan_counts(enc)))
    _decodes(stream, recons, "device engine, 32 CIF frames")
    halves = [r for part in (frames[:16], frames[16:])
              for r in enc.encode(part)[1]]
    _same_planes(halves, recons, "device engine, 32 CIF frames against "
                 "two 16-frame calls")
    (s1, dt1, c1), (s2, dt2, c2) = calls
    if (s1 != s2 or c1["n_commit_graph_captures"] <= 0
            or c2["n_commit_graph_captures"] != 0
            or c2["n_commit_graph_replays"] != c2["n_commit_steps"]):
        raise AssertionError(f"device engine, 32 CIF frames: first call "
                             f"{c1}, second {c2}, same bytes {s1 == s2}")
    out["cif_32"] = {"first_seconds": dt1, "second_seconds": dt2,
                     "first_counts": c1, "second_counts": c2,
                     "bytes": len(s2)}
    log(f"device engine, 32 CIF frames (one scan in the worker): first call "
        f"{dt1:.3f} s ({c1['n_commit_graph_captures']} graphs captured, "
        f"{c1['n_commit_steps']} steps), second {dt2:.3f} s (all replays); "
        f"reconstructions == two 16-frame calls'; decode == reconstruction")
    small = EncoderConfig(width=64, height=64, qp=32)
    frames = synth_frames(48, 64, 64, seed=5)
    searches = (WavefrontSearch(small, **DEVICE_ENGINE),
                WavefrontSearch(small, device="cpu", **DEVICE_ENGINE))
    for search in searches:
        search._commit_group_frames = lambda: 16
    s_gpu, r_gpu, dt, _ = _timed_encode(Encoder(small, search=searches[0]),
                                        frames, ["dq_greedy"])
    t0 = time.perf_counter()
    s_cpu, _ = Encoder(small, search=searches[1]).encode(frames)
    t_cpu = time.perf_counter() - t0
    if s_gpu != s_cpu:
        raise AssertionError("device engine, 64x64 groups of 16: card bytes "
                             "!= CPU bytes")
    _decodes(s_gpu, r_gpu, "device engine, 64x64 groups of 16")
    out["64x64_groups"] = {"seconds": dt, "cpu_seconds": t_cpu,
                           "bytes": len(s_gpu)}
    log(f"device engine, 48 frames of 64x64 in commit groups of 16 (the "
        f"worker captures while the main thread runs stage A): {dt:.3f} s, "
        f"card bytes == CPU bytes ({len(s_gpu)} bytes; CPU {t_cpu:.1f} s)")
    return out


def phase_batch_check(dev):
    """K1 through trellis_rate_batch against its plain twin on the card at
    the scan's shapes: one wave of one job per size at the median batch
    of that size's jobs, with per-row ls / bd_shift as the scan passes
    them, in one launch. Then that wave's and each size's K1 device time
    alone beside the plain time and the bound; and the scan's launches
    grouped by their wave's largest size (their device time in the
    scan's step graphs)."""
    import numpy as np
    import torch
    from wrenc_tpu_torch.kernels import quantize as kq
    from wrenc_tpu_torch.kernels import transforms
    from wrenc_tpu_torch.kernels import trellis as ktr
    jobs_b = {}
    by_top = {}
    for wave, ms in zip(dev["k1_shapes"], dev["k1_ms"]):
        for P, B in wave:
            jobs_b.setdefault(P, []).append(B)
        by_top.setdefault(max(P for P, _ in wave), []).append(ms)
    rng = np.random.default_rng(7)
    _, lam, lv = _qcase(2, 32, True)
    lam_d = kq.table(lam, torch.int32, "cuda")
    lv_d = kq.table(lv, torch.float32, "cuda")

    def bound(wave):
        nbytes = sum(6 * P * B + 12 * B for P, B in wave) + 8 * 1024
        ops = sum(OPS_PER_POS["dq_trellis"] * P * B for P, B in wave)
        return nbytes / HBM_BYTES_S * 1e3, ops / OPS_S * 1e3
    jobs, per_size = [], {}
    for P in sorted(jobs_b):
        log2 = (P.bit_length() - 1) // 2
        s = 1 << log2
        bs = sorted(jobs_b[P])
        B = bs[len(bs) // 2]
        res = rng.integers(-24, 25, (B, s, s)).astype(np.int32)
        t = transforms.forward_impl(torch.as_tensor(res, device="cuda"))
        job = (t, *_per_row(log2, B, rng), log2)
        jobs.append(job)
        plain_ms = _time_ms(lambda: ktr.trellis_rate_plain(
            t, job[1], job[2], lam_d, lv_d, log2), 1)
        per_size[s] = {"P": P, "jobs": len(bs), "B_median": B,
                       "B_max": bs[-1],
                       "ms_alone": _graph_ms(
                           lambda: ktr._launch_k1([job], lam_d, lv_d)),
                       "plain_ms": plain_ms,
                       "bound_ms": max(bound([(P, B)]))}
    before = ktr.trellis_rate_batch.launches
    got = ktr.trellis_rate_batch(jobs, lam_d, lv_d)
    launched = ktr.trellis_rate_batch.launches - before
    want = ktr.trellis_rate_batch_plain(jobs, lam_d, lv_d)
    torch.cuda.synchronize()
    err = max(_err(g, w) for g, w in zip(got, want))
    if err != 0 or launched != 1:
        raise AssertionError(f"trellis_rate_batch != plain: {err}, "
                             f"{launched} launches")
    wave_ms = _graph_ms(lambda: ktr._launch_k1(jobs, lam_d, lv_d))
    log(f"trellis_rate_batch: K1 equal to the plain twin at the scan's "
        f"shapes (sizes {sorted(per_size)}, one launch); that wave alone "
        f"{wave_ms:.4f} ms device time")
    for s, row in per_size.items():
        log(f"  K1 s={s:2d}: {row['jobs']} jobs in the scan, B median "
            f"{row['B_median']} max {row['B_max']}; alone "
            f"{row['ms_alone']:.4f} ms device, plain {row['plain_ms']:.1f} "
            f"ms, bound {row['bound_ms']:.5f} ms")
    per_top = {}
    for P, v in sorted(by_top.items()):
        s = 1 << ((P.bit_length() - 1) // 2)
        per_top[s] = {"launches": len(v),
                      "ms_in_scan_mean": float(np.mean(v))}
        log(f"  waves whose largest size is s={s:2d}: {len(v)} launches, "
            f"{per_top[s]['ms_in_scan_mean']:.4f} ms device in the scan "
            f"(mean)")
    b = [bound(w) for w in dev["k1_shapes"]]
    n = len(b)
    return {"err": err, "per_size": per_size, "per_wave_top": per_top,
            "wave_alone_ms": wave_ms,
            "bytes_ms": sum(x for x, _ in b) / n,
            "ops_ms": sum(y for _, y in b) / n,
            "bound_ms": sum(max(x, y) for x, y in b) / n,
            "plain_ms": sum(per_size[1 << ((P.bit_length() - 1) // 2)]
                            ["plain_ms"] for w in dev["k1_shapes"]
                            for P, _ in w) / n}

def _mesh_cells(n):
    """n mesh cells: n distinct cards when there are that many, else
    cuda:0 n times. Returns (devices, distinct)."""
    import torch
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)], True
    return [torch.device("cuda", 0)] * n, False


def _mesh(n, frame_axis):
    """A ('frame',) mesh of n cells (frame_axis None) or a (frame, row)
    one, logged with its cells."""
    from wrenc_tpu_torch import dist
    devs, distinct = _mesh_cells(n)
    mesh = (dist.Mesh(devs, ("frame",)) if frame_axis is None
            else dist.make_mesh(devs, frame_axis=frame_axis))
    cells = [str(d) for d in devs]
    log(f"mesh {mesh.shape}: cells {cells}" + (
        "" if distinct else " (every cell the one card: no scaling claim)"))
    return mesh, {"shape": mesh.shape, "cells": cells,
                  "distinct_cards": distinct}


def phase_mesh():
    """The sharded stage A (WavefrontSearch(cfg, mesh=...)) on the card:
    16 CIF frames at QP 32 on a ('frame',) mesh of 2 cells and on a
    (frame 2, row 3) mesh (96 rows, 3 CTU rows per band), the default
    configuration warm-up then timed; on the (2, 3) mesh also
    stage_a_trellis_rd=1 (K1), warm-up then timed, and the device commit
    engine (one encode: it uploads its own planes). Cells are distinct
    cards where there are enough, else cuda:0 repeated. Each encode's
    launch counters are set to 0 just before it and read just after: the
    stage-A kernel launches once per cell and QT size in every chunk, and
    the card bytes equal the single-device card bytes of phases 4 / 8,
    decode == reconstruction. Then 1080p on a (1, 2) mesh: one chunk's
    stage A equals the single-device chunk's (without its selection)
    exactly,
    and a 1-frame encode gives the single-device encode's bytes (native
    chroma, as a mesh runs it)."""
    import numpy as np
    import torch
    from wrenc_tpu_torch.core.config import EncoderConfig
    from wrenc_tpu_torch.encoder import Encoder
    from wrenc_tpu_torch.search import WavefrontSearch
    from wrenc_tpu_torch.search import wavefront as wf
    t_phase = time.perf_counter()
    frames = synth_frames(16, *CIF, seed=1)
    out = {}
    frame2, info2 = _mesh(2, None)
    rows23, info23 = _mesh(6, 2)
    cases = (("frame 2, default", frame2, info2, 0, {}, "default",
              "dq_greedy", True),
             ("frame 2 x row 3, default", rows23, info23, 0, {}, "default",
              "dq_greedy", True),
             ("frame 2 x row 3, stage_a_trellis_rd=1", rows23, info23, 1,
              {}, "stage_a_trellis_rd=1", "dq_trellis", True),
             ("frame 2 x row 3, commit_engine=device", rows23, info23, 0,
              {"commit_engine": "device"}, "commit_engine=device",
              "dq_greedy", False))
    for name, mesh, info, tr, kw, ref, kern, warm_up in cases:
        cfg = _cfg(tr)
        search = WavefrontSearch(cfg, mesh=mesh, **kw)
        enc = Encoder(cfg, search=search)
        warm = None
        if warm_up:
            t0 = time.perf_counter()
            enc.encode(frames)
            warm = time.perf_counter() - t0
        stream, recons, dt, launches = _timed_encode(enc, frames, [kern])
        if kw:
            launches["dq_trellis_in_scan"] = _scan_counts(enc)[
                "n_dq_trellis_launches"]
        _decodes(stream, recons, f"mesh [{name}]")
        if stream != STREAMS[ref]:
            raise AssertionError(f"mesh [{name}]: card bytes != the "
                                 f"single-device card bytes ({ref})")
        # stage A only: a mesh runs chroma stage A native (device chroma
        # would add its own launches), and the commit launches neither
        chunks = -(-len(frames) // search._buckets()[-1])
        n_cells = mesh.size
        want = chunks * n_cells * len(SIZES)
        other = "dq_trellis" if kern == "dq_greedy" else "dq_greedy"
        if launches[kern] != want or launches[other] != 0:
            raise AssertionError(
                f"mesh [{name}]: launches {launches}, want {kern} = "
                f"{chunks} chunks x {n_cells} cells x {len(SIZES)} sizes")
        phases = {k: round(v, 4) for k, v in enc.phase_times.items()}
        out[name] = dict(info, fps=len(frames) / dt, seconds=dt,
                         warmup_seconds=warm, bytes=len(stream),
                         launches=launches, chunks=chunks,
                         launches_per_chunk={k: v / chunks
                                             for k, v in launches.items()},
                         phase_times=phases)
        log(f"mesh [{name}]: {len(frames)} CIF frames QP 32 in {dt:.3f} s "
            f"= {len(frames) / dt:.3f} fps" + (
                f" (warm-up {warm:.1f} s)" if warm else " (one encode)")
            + f", {len(stream)} bytes == single-device card bytes; "
            f"launches {launches} = {want // chunks} {kern} per chunk "
            f"({chunks} chunks x {n_cells} cells x {len(SIZES)} sizes); "
            f"decode == reconstruction")
        log(f"  phase_times (s): {json.dumps(phases)}")
        if warm_up:
            c = out[name]["cell_kernel"] = _cell_times(search, frames[:8],
                                                       kern)
            log(f"  {kern} per cell of one chunk: (s, B, lanes) "
                f"{c['shapes_per_cell']}, {c['device_ms_per_cell']:.4f} ms "
                f"device time (a cell's launches in a CUDA graph), bound "
                f"{c['bound_ms_per_cell']:.4f} ms ({c['bound_by']})")

    # 1080p on a (1, 2) mesh: 1088 = 2 x 17 CTU rows
    cfg = EncoderConfig(width=P1080[0], height=P1080[1], qp=32)
    mesh, info = _mesh(2, 1)
    f1 = synth_frames(1, *P1080, seed=2)
    single = WavefrontSearch(cfg)
    msearch = WavefrontSearch(cfg, mesh=mesh)
    got = {}
    for key, search, run in (
            ("single", single, lambda: _unselected_stage_a(single, f1)),
            ("mesh", msearch, lambda: msearch._dispatch_stage_a(f1)[2])):
        search._decide_chunk(search._dispatch_stage_a(f1))     # tables
        counters = _counters()
        for f in counters.values():
            f.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        t1 = time.perf_counter()
        host = wf._fetch_cells(res)
        t2 = time.perf_counter()
        got[key] = (host, {"dispatch_ms": (t1 - t0) * 1e3,
                           "dispatch_to_host_ms": (t2 - t0) * 1e3,
                           "launches": {k: f.launches
                                        for k, f in counters.items()}})
    for s_ in SIZES:
        for a, b in zip(got["single"][0][s_], got["mesh"][0][s_]):
            if a.dtype != b.dtype or a.shape != b.shape or \
                    a.tobytes() != b.tobytes():
                raise AssertionError(f"1080p (1, 2) mesh stage A != one "
                                     f"device at s={s_}")
    k2 = got["mesh"][1]["launches"]["dq_greedy"]
    if k2 != 2 * len(SIZES):
        raise AssertionError(f"1080p mesh stage A: {k2} K2 launches")
    p = out["1080p (1, 2) stage A, one chunk"] = dict(
        info, single=got["single"][1], mesh=got["mesh"][1])
    log(f"mesh 1080p (1, 2): one 1-frame chunk's stage A equals one "
        f"device's (cands, cost) at every size; dispatch "
        f"{p['mesh']['dispatch_ms']:.1f} ms (one device "
        f"{p['single']['dispatch_ms']:.1f}), to the host "
        f"{p['mesh']['dispatch_to_host_ms']:.1f} ms (one device "
        f"{p['single']['dispatch_to_host_ms']:.1f}), K2 launches "
        f"{k2} (one device "
        f"{got['single'][1]['launches']['dq_greedy']})")
    f5 = synth_frames(1, *P1080, seed=5)
    s_one, _ = Encoder(cfg, search=WavefrontSearch(
        cfg, chroma_stage_a="native")).encode(f5)
    enc = Encoder(cfg, search=WavefrontSearch(cfg, mesh=mesh))
    stream, recons, dt, launches = _timed_encode(enc, f5, ["dq_greedy"])
    _decodes(stream, recons, "mesh 1080p")
    if stream != s_one:
        raise AssertionError("mesh 1080p: card bytes != single-device "
                             "card bytes")
    out["1080p (1, 2), 1 frame"] = {
        "seconds": dt, "bytes": len(stream), "launches": launches,
        "same_as_default_device_chroma": stream == STREAMS.get("1080p"),
        "phase_times": {k: round(v, 4)
                        for k, v in enc.phase_times.items()}}
    log(f"mesh 1080p (1, 2): 1-frame encode {dt:.3f} s, {len(stream)} "
        f"bytes == single-device (native chroma) card bytes; launches "
        f"{launches}")
    c = out["1080p (1, 2), 1 frame"]["cell_kernel"] = _cell_times(
        msearch, f5, "dq_greedy")
    log(f"  dq_greedy per 1080p band cell: (s, B, lanes) "
        f"{c['shapes_per_cell']}, {c['device_ms_per_cell']:.4f} ms device "
        f"time, bound {c['bound_ms_per_cell']:.4f} ms ({c['bound_by']})")
    out["wall_seconds"] = time.perf_counter() - t_phase
    log(f"mesh phase: {out['wall_seconds']:.1f} s")
    return out


def _unselected_stage_a(search, frames):
    """One chunk's luma stage A of a single-device search without the
    winner selection (fused_luma_stage_a, sel=False), as a row mesh's
    band stage A returns it; still on the card."""
    from wrenc_tpu_torch.search import wavefront as wf
    cfg, a = search.cfg, search._stage_a_args()
    return wf.fused_luma_stage_a(
        search._upload([f[0] for f in frames]), cfg.width, cfg.height,
        cfg.log2_ctu_size, tuple(search._sizes()), a['K'], a['trellis'],
        a['ls'], a['bd'], a['lam_dq'], a['lv'], a['lam'], a['mats'],
        sel=False)


def _cell_times(search, frames, kname):
    """One chunk's sharded stage A dispatch (frames: one chunk) with
    `kname`'s launches recorded: one per cell and QT size, every cell at
    the same shapes (asserted); the first cell's launches replayed in a
    CUDA graph on its card, the kernel's device time per cell beside its
    bound."""
    import torch
    with _recording(kname) as rec:
        search._dispatch_stage_a(frames)
    torch.cuda.synchronize()
    n = len(SIZES)
    shapes = _launch_shapes(kname, rec)
    if len(rec) % n or any(shapes[i:i + n] != shapes[:n]
                           for i in range(0, len(rec), n)):
        raise AssertionError(f"{kname}: cells at different shapes {shapes}")
    cell = rec[:n]
    first = cell[0][0][0][0] if kname == "dq_trellis" else cell[0][0]
    with torch.cuda.device(first.device):
        device_ms = _graph_ms(_replay(kname, cell), n=5)
    bound, bytes_ms, by = _bounds(kname, shapes[:n])
    return {"kernel": kname, "cells": len(rec) // n,
            "shapes_per_cell": shapes[:n],
            "device_ms_per_cell": device_ms, "bound_ms_per_cell": bound,
            "bytes_ms_per_cell": bytes_ms, "bound_by": by}


def phase_4k():
    """3840x2176, the 4K target class, on the default path: the port's
    bench1080p.main(--size 3840x2176 --frames 1) (a warm-up encode, the
    timed encode, decode == reconstruction), counted from 0 around the
    call. Then one chunk's stage A alone, luma and device chroma (8.4 Mpx
    is past the 0.5 Mpx device-chroma switch and the 3.5 Mpx chunk
    budget, so a chunk is one frame): counted from 0, K2 launched once
    per luma size and chroma job (_chroma_jobs), the card's peak memory
    for the chunk; a second dispatch with K2's launches recorded: each
    launch against the plain twin on its own inputs, exactly, the plain
    twin's time, and the launches replayed in a CUDA graph (K2's device
    time per chunk) beside the bound."""
    import torch
    from wrenc_tpu_torch.core.config import EncoderConfig
    from wrenc_tpu_torch.kernels import quantize as kq
    from wrenc_tpu_torch.search import WavefrontSearch
    from wrenc_tpu_torch.tools import bench1080p
    W, H = K4
    rec, dt, launches = _counted(lambda: bench1080p.main(
        ["--size", f"{W}x{H}", "--frames", "1", "--out",
         os.path.join(ROOT, "results", "torch", "4k.json")]), ["dq_greedy"])
    if not rec["conformance_roundtrip"]:
        raise AssertionError("4K: decode != reconstruction")
    out = {"bench": rec, "bench_seconds": dt,
           "bench_launches": launches}
    log(f"4K bench1080p --size {W}x{H} --frames 1: first encode "
        f"{rec['first_compile_s']:.1f} s, timed encode {rec['encode_s']:.3f}"
        f" s = {rec['fps']:.4f} fps, {rec['bytes']} bytes, decode == "
        f"reconstruction; launches over both encodes {launches}; "
        f"{dt:.1f} s in all")
    log(f"  record: {json.dumps(rec)}")

    frames = bench1080p.frames_1080p(1, W, H)
    cfg = EncoderConfig(width=W, height=H, qp=32,
                        entropy_coding_sync_enabled=True,
                        entry_point_offsets_present=True)
    search = WavefrontSearch(cfg)
    if not search._chroma_device or search._buckets() != [1]:
        raise AssertionError("4K: want device chroma and 1-frame chunks")
    lmb, sizes, devp = _chroma_inputs(search, frames)
    want = len(SIZES) + sum(n for _, _, n in _chroma_jobs((W, H), 1))

    def chunk():
        res = search._dispatch_stage_a(frames)
        search._dispatch_chroma(lmb, sizes, devp)
        return res
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, chunk_s, counts = _counted(chunk)
    peak = torch.cuda.max_memory_allocated()
    if counts["dq_greedy"] != want or counts["dq_trellis"] or \
            counts["dq_trellis_batch"]:
        raise AssertionError(f"4K chunk: launches {counts}, want dq_greedy "
                             f"{want} ({len(SIZES)} luma sizes + chroma "
                             f"jobs)")
    with _recording("dq_greedy") as recd:
        chunk()
    torch.cuda.synchronize()
    if len(recd) != want:
        raise AssertionError(f"4K chunk: K2's helper saw {len(recd)}")
    shapes = _launch_shapes("dq_greedy", recd)
    err, plain_ms = 0.0, 0.0
    for a in recd:
        got = kq._launch_k2(*a)
        plain = kq.greedy_depquant_plain(a[0], a[1], a[2], a[3], a[5], a[4])
        e = _err(got, plain)
        if e != 0:
            raise AssertionError(f"K2 != plain at the 4K shape (s, B) = "
                                 f"{a[0].shape[1]}, {a[0].shape[0]}: {e}")
        err = max(err, e)
        plain_ms += _time_ms(lambda: kq.greedy_depquant_plain(
            a[0], a[1], a[2], a[3], a[5], a[4]), reps=1)
    device_ms = _graph_ms(_replay("dq_greedy", recd), n=3, reps=5)
    bound, bytes_ms, by = _bounds("dq_greedy", shapes)
    out["chunk"] = {"launches": counts, "seconds": chunk_s,
                    "shapes": shapes, "max_abs_err": err,
                    "device_ms": device_ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bytes_ms": bytes_ms,
                    "bound_by": by, "memory_allocated_before": base,
                    "max_memory_allocated": peak}
    log(f"4K one chunk's stage A (luma + device chroma): launches {counts} "
        f"({len(SIZES)} luma + {want - len(SIZES)} chroma K2); (s, B, "
        f"lanes) {shapes}; K2 == plain at each, exactly; K2 "
        f"{device_ms:.4f} ms device time per chunk (those launches in a "
        f"CUDA graph), plain {plain_ms:.1f} ms, bound {bound:.4f} ms "
        f"({by}); max_memory_allocated {peak / 2**30:.3f} GiB (before the "
        f"chunk {base / 2**30:.3f} GiB)")
    return out


def phase_tools():
    """The port's tools on the card, each step fatal on failure and
    counted from 0: evaluate.evaluate_clips over the 16 CIF frames (seed
    1) at QP 22 / 27 / 32 / 37 (its warm-up point first; each point
    decodes == reconstruction; the QP 32 point's size equals the main
    path's default stream), the QP 27 point once more, uncounted, and
    dashboard.build_html of its summary; engine_ab.run_ab on 4 of them at QP 32 (both engines conformant,
    within the tool's gate); one tune.objective evaluation (the synthetic
    frames scored against an anchored clip's x265 points: it runs the
    objective, it is no RD result); scaling_bench over 1 and 2 cells; and
    multihost_smoke's two processes on the card (their own counters)."""
    import math
    from wrenc_tpu_torch.tools import (dashboard, engine_ab, evaluate,
                                       multihost_smoke, scaling_bench, tune)
    t_phase = time.perf_counter()
    frames = synth_frames(16, *CIF, seed=1)
    out = {}
    summary, dt, launches = _counted(lambda: evaluate.evaluate_clips(
        [("synthetic CIF seed 1", frames)], [22, 27, 32, 37]),
        ["dq_greedy"])
    points = summary["results"][0]["results"][0]["results"]
    by_qp = {p["qp"]: p for p in points}
    if by_qp[32]["bytes"] != len(STREAMS["default"]):
        raise AssertionError(f"evaluate QP 32: {by_qp[32]['bytes']} bytes, "
                             f"the main path {len(STREAMS['default'])}")
    out["evaluate"] = {
        "seconds": dt, "launches": launches,
        "points": {q: {"bytes": p["bytes"],
                       "psnr_avg": p["metrics"]["PSNR"]["summary"]["Avg"],
                       "ssim_avg": p["metrics"]["SSIM"]["summary"]["Avg"],
                       "fps": len(frames) / p["duration"]}
                   for q, p in by_qp.items()}}
    log(f"tools: evaluate, 16 CIF frames, decode == reconstruction at every "
        f"QP, QP 32 bytes == the main path's: "
        f"{json.dumps(out['evaluate']['points'])}; launches {launches}")
    again = evaluate.run_point(frames, 27, 3, verify=False)[3]
    out["evaluate"]["qp27_again_fps"] = len(frames) / again
    log(f"tools: evaluate's QP 27 point again: {again:.3f} s, "
        f"{len(frames) / again:.3f} fps (first: "
        f"{out['evaluate']['points'][27]['fps']:.3f} fps)")
    html = dashboard.build_html(summary)
    if html.count("<svg") != 2:
        raise AssertionError("dashboard: want the PSNR and SSIM plots")
    out["dashboard_bytes"] = len(html)
    report, dt, launches = _counted(lambda: engine_ab.run_ab(
        [("synthetic CIF seed 1", frames[:4])], [32], 4), ["dq_greedy"])
    if not engine_ab.passes_gate(report):
        raise AssertionError(f"engine_ab: outside the gate {report}")
    (row,) = report["points"]
    launches["dq_trellis_in_scan"] = row["device"]["phases"].get(
        "n_dq_trellis_launches", 0)
    if launches["dq_trellis_in_scan"] <= 0:
        raise AssertionError(f"engine_ab: no K1 launch in the device "
                             f"engine's scan ({launches})")
    out["engine_ab"] = {"seconds": dt, "launches": launches,
                        "byte_identical": row["byte_identical"],
                        "size_delta_pct": row["size_delta_pct"],
                        "native": row["native"], "device": row["device"]}
    nat, dev = row["native"], row["device"]
    log(f"tools: engine_ab, 4 CIF frames QP 32: native {nat['bytes']} / "
        f"device {dev['bytes']} bytes, byte identical "
        f"{row['byte_identical']}, both conformant; time native "
        f"{nat['time_s']:.2f} s, device {dev['time_s']:.2f} s; launches "
        f"{launches}")
    value, dt, launches = _counted(lambda: tune.objective(
        {}, [(ANCHORED, frames[:4])], [26, 32, 38], 3), ["dq_greedy"])
    if not math.isfinite(value):
        raise AssertionError(f"tune objective {value}")
    out["tune"] = {"objective": value, "seconds": dt, "launches": launches,
                   "tunables": len(tune.tunable_names())}
    log(f"tools: one tune objective (4 CIF frames, QP 26 / 32 / 38): "
        f"{value!r} in {dt:.2f} s; launches {launches}")
    res, dt, launches = _counted(lambda: scaling_bench.main((1, 2)),
                                 ["dq_greedy"])
    out["scaling_bench"] = {"seconds": dt, "launches": launches,
                            "result": res}
    log(f"tools: scaling_bench cells 1, 2 (sharded == serial): "
        f"{json.dumps(res['by_devices'])}; {res['caveat']}; launches "
        f"{launches}")
    mh = multihost_smoke.run(device="cuda", timeout=300)
    if not mh["ok"]:
        raise AssertionError(f"multihost_smoke failed: {mh}")
    out["multihost_smoke"] = mh
    log(f"tools: multihost_smoke --device cuda: 2 gloo processes, layouts "
        f"2x4 and 1x2, exact against one device on each rank, "
        f"{mh['seconds']:.1f} s; workers' launches {mh['launches']}")
    out["wall_seconds"] = time.perf_counter() - t_phase
    return out


def _rate_levels(log2, seed):
    """Stored levels for the level-rate walks: random, all-zero,
    DC-only, sparse, levels past the table's 1023 clip, int16 extremes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    s = 1 << log2
    q = rng.integers(-40, 41, (64, s, s))
    q[0] = 0
    q[1] = 0
    q[1, 0, 0] = 3
    q[2] = np.where(rng.random((s, s)) < 0.9, 0, q[2])
    q[3] = rng.integers(1800, 2400, (s, s))
    q[4] = rng.choice([-32768, 32767, 0, 1, -1], (s, s))
    return q.astype(np.int16)


def phase_item4():
    """The last kernels/ formulations on a CUDA tensor against the same
    call on the CPU, exactly (values, dtype, shape): DCT-II's named
    entries and MTS at n = 4..32 for every (tr_hor, tr_ver) of the golden
    tests, LFNST at their sizes, modes and indices, dq_rate_scan and
    dq_rate_device at every size (both rate tables), bdpcm_* both ways,
    and trellis_depquant / trellis_depquant_pscan at every size and QP
    22 / 37 / 51, each call advancing K1's counter by exactly one."""
    import numpy as np
    import torch
    from wrenc_tpu_torch.core.config import RateModelConfig
    from wrenc_tpu_torch.kernels import quantize as kq
    from wrenc_tpu_torch.kernels import transforms as kt
    from wrenc_tpu_torch.kernels import trellis as ktr
    from wrenc_tpu_torch.spec import quant
    t_phase = time.perf_counter()
    rng = np.random.default_rng(8)
    checks = {}

    def same(name, fn, *args):
        arrays = [isinstance(a, np.ndarray) for a in args]
        cpu = fn(*[torch.as_tensor(a) if t else a
                   for a, t in zip(args, arrays)])
        got = fn(*[torch.as_tensor(a, device="cuda") if t else a
                   for a, t in zip(args, arrays)]).cpu()
        if (got.dtype != cpu.dtype or got.shape != cpu.shape
                or not torch.equal(got, cpu)):
            scalars = [a for a, t in zip(args, arrays) if not t]
            raise AssertionError(f"{name} {scalars}: card != CPU")
        checks[name] = checks.get(name, 0) + 1
        return cpu.numpy()

    for n in SIZES:
        res = rng.integers(-255, 256, (64, n, n)).astype(np.int32)
        fwd = same("forward_dct2", kt.forward_dct2, res)
        same("inverse_dct2", kt.inverse_dct2, fwd)
        for tr in ((1, 1), (2, 1), (1, 2), (2, 2), (0, 1)):
            c = same("forward_mts", kt.forward_mts, res, *tr)
            same("inverse_mts", kt.inverse_mts, c // 16, *tr)
    for th, tw in ((4, 4), (8, 8), (16, 16), (4, 8), (8, 16)):
        blocks = rng.integers(-512, 512, (64, th, tw)).astype(np.int32)
        for mode in (0, 1, 10, 18, 34, 40, 50, 66):
            for idx in (1, 2):
                c = same("forward_lfnst", kt.forward_lfnst, blocks, mode,
                         idx)
                same("inverse_lfnst", kt.inverse_lfnst, c // 4, mode, idx)
    rm = RateModelConfig()
    for log2 in (2, 3, 4, 5):
        q = _rate_levels(log2, 40 + log2)
        for trellis in (False, True):
            lv = kq.lv_table_device(rm, True, trellis)
            same("dq_rate_scan", kq.dq_rate_scan, q, log2, lv)
            same("dq_rate_device", kq.dq_rate_device, q, log2, lv)
    for n in (4, 8, 32):
        q = rng.integers(-(1 << 14), 1 << 14, (16, n, n)).astype(np.int32)
        big = rng.integers(-70000, 70000, (16, n, n)).astype(np.int32)
        for d in (0, 1):
            same("bdpcm_dpcm", kq.bdpcm_dpcm, q, d)
            same("bdpcm_inverse", kq.bdpcm_inverse, big, d)
    for log2 in (2, 3, 4, 5):
        t = adversarial_blocks(log2, 60 + log2)
        for qp in (22, 37, 51):
            qpar = quant.derive_quant_params(qp, log2, log2, dep_quant=True,
                                             transform_skip=False)
            lam = kq.lam_dq_table(rm, qp, trellis=True)
            for name, fn in (("trellis_depquant", kq.trellis_depquant),
                             ("trellis_depquant_pscan",
                              kq.trellis_depquant_pscan)):
                before = ktr.trellis_rate.launches
                same(name, fn, t, qpar.ls, qpar.bd_shift, lam, log2)
                k1 = ktr.trellis_rate.launches - before
                if k1 != 1:
                    raise AssertionError(f"{name}: K1 launched {k1} times "
                                         "for one call")
    wall = time.perf_counter() - t_phase
    log(f"kernels/ formulations on the card == on the CPU, exactly: "
        f"{json.dumps(checks)} calls; K1's counter advanced by one per "
        f"trellis_depquant* call; {wall:.1f} s")
    return {"checks": checks, "wall_seconds": wall}


def main():
    if not os.path.isdir(os.path.join(ROOT, "wrenc_tpu_torch")):
        print("chip_smoke: run from a checkout of the repo (no "
              "wrenc_tpu_torch beside this script)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    import wrenc_tpu_torch  # noqa: F401  (TF32 off)
    walls = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        walls[name] = time.perf_counter() - t0
        log(f"phase {name}: {walls[name]:.1f} s (total "
            f"{time.perf_counter() - t_start:.1f} s)")
        return res

    build = phase("build", phase_build)
    errs = phase("kernel checks", phase_kernel_checks)
    errs["dq_trellis"] = max(errs["dq_trellis"],
                             phase("K1 checks", phase_k1_checks))
    k2_err, k2_ops = phase("K2 checks", phase_k2_checks)
    errs["dq_greedy"] = max(errs["dq_greedy"], k2_err)
    rows = phase("kernel timing", phase_kernel_timing, errs)
    sweep = phase("K1 lanes sweep", phase_k1_lanes_sweep)
    k2_sweep = phase("K2 lanes sweep", phase_k2_lanes_sweep)
    chroma = phase("chroma kernels", phase_chroma_kernels, errs)
    phase("fma", phase_fma)
    main_path = phase("main path", phase_main_path)
    p1080 = phase("1080p", phase_1080p)
    p4k = phase("4K", phase_4k)
    errs["dq_greedy"] = max(errs["dq_greedy"], p4k["chunk"]["max_abs_err"])
    card_cpu = phase("card vs CPU", phase_card_vs_cpu)
    paths = phase("commit paths", phase_commit_paths)
    dev = phase("device engine", phase_device_commit, main_path["default"])
    batch = phase("K1 batch check", phase_batch_check, dev)
    mesh = phase("mesh", phase_mesh)
    item4 = phase("kernels/ formulations", phase_item4)
    tools = phase("tools", phase_tools)

    replaces = {"dq_trellis": "wrenc_tpu/kernels/trellis_pallas.py:55",
                "dq_greedy": "wrenc_tpu/kernels/quantize.py:136"}
    config_of = {"dq_trellis": "stage_a_trellis_rd=1",
                 "dq_greedy": "default"}
    per_path = {p: main_path[p]["launches"] for p in main_path}
    per_path["commit_engine=device"] = dev["launches"]
    per_path["commit_engine=device, device chroma"] = \
        dev["default_chroma"]["launches"]
    per_path["1080p default"] = p1080["launches"]
    per_path["1080p commit_engine=device"] = \
        p1080["device_engine"]["launches"]
    # one chunk's chroma stage A alone, as measured (launches from the
    # counters, K2's device time of those launches in a CUDA graph)
    chroma_chunks = {
        "CIF 16 frames (device engine)":
            dev["default_chroma"]["chroma_one_chunk"],
        "1080p 1 frame": p1080["chroma_one_chunk"],
        "1080p 4 frames (device engine)":
            p1080["device_engine"]["chroma_one_chunk"]}
    for n, c in chroma_chunks.items():
        per_path[f"chroma stage A alone, {n}"] = c["launches"]
    trellis_chunk = p1080["chroma_one_chunk_trellis"]
    per_path["chroma stage A alone, 1080p 1 frame, stage_a_trellis_rd=1"] = \
        trellis_chunk["launches"]
    for n, c in paths.items():
        if n == "commit_frame_device":
            n = "commit_frame_device, 2 CIF frames"
        per_path[n] = c["launches"]
    for n, c in mesh.items():
        if isinstance(c, dict) and "launches" in c:
            per_path[f"mesh {n}"] = c["launches"]
    per_path["mesh 1080p (1, 2) stage A, one chunk"] = \
        mesh["1080p (1, 2) stage A, one chunk"]["mesh"]["launches"]
    per_path["4K bench1080p, warm-up + timed encode"] = p4k["bench_launches"]
    per_path["4K one chunk's stage A"] = p4k["chunk"]["launches"]
    for n in ("evaluate", "engine_ab", "tune", "scaling_bench"):
        per_path[f"tools: {n}"] = tools[n]["launches"]
    per_path["tools: multihost_smoke (its two processes)"] = \
        tools["multihost_smoke"]["launches"]
    sharded = {n: c["cell_kernel"] for n, c in mesh.items()
               if isinstance(c, dict) and "cell_kernel" in c}
    kernels = []
    for name in ("dq_trellis", "dq_greedy"):
        r = rows[name]
        kernels.append({
            "name": name, "entry": ("trellis_rate" if name == "dq_trellis"
                                    else "greedy_depquant"),
            "route": "cuda",
            "source": "wrenc_tpu_torch/kernels/csrc/dq_scan.cu",
            "replaces": replaces[name],
            "launches": main_path[config_of[name]]["launches"][name],
            "launches_per_path": {p: v[name] for p, v in per_path.items()},
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": ("operations" if r["ops_ms"] >= r["bytes_ms"]
                         else "bytes"),
            "library_ms": None,
            "per_size": r["per_size"]})
        kernels[-1].update(
            sharded_cells={n: c for n, c in sharded.items()
                           if c["kernel"] == name},
            sm_clock_mhz=r["sm_clock_mhz"],
            device_ms_per_chunk=sum(v["device_ms"][v["lanes"]]
                                    for v in r["per_size"].values()),
            chroma_per_launch={n: [dict(cs=x["cs"], B=x["B"], **x[name])
                                   for x in v] for n, v in chroma.items()})
        if name == "dq_trellis":
            kernels[-1].update(
                also_entries=["trellis_depquant", "trellis_depquant_pscan"],
                ptxas=build["ptxas"], lanes_sweep_4x4_ms=sweep,
                chroma_per_chunk={"1080p 1 frame, stage_a_trellis_rd=1": {
                    "launches": trellis_chunk["launches"]["dq_trellis"],
                    "device_ms": trellis_chunk["device_ms"],
                    "bound_ms": trellis_chunk["bound_ms"],
                    "bytes_ms": trellis_chunk["bytes_ms"]}})
        else:
            kernels[-1].update(
                per_size_16_frames=r["per_size_16_frames"],
                device_ms_per_16_frame_chunk=sum(
                    v["device_ms"][v["lanes"]]
                    for v in r["per_size_16_frames"].values()),
                lanes_sweep_ms=k2_sweep, ops_one_call=k2_ops,
                blocks_smem=build["k2_blocks_smem"],
                chroma_per_chunk={
                    n: {"launches": c["launches"]["dq_greedy"],
                        "device_ms": c["device_ms"],
                        "bound_ms": c["bound_ms"],
                        "bytes_ms": c["bytes_ms"]}
                    for n, c in chroma_chunks.items()},
                at_4k=p4k["chunk"],
                commit_prototype=paths["commit_frame_device"]["frames"],
                commit_prototype_per_launch=paths["commit_frame_device"][
                    "per_launch"])
    # K1 on the device commit path: per launch (one per wave), the mean
    # over the scan's launches (device time traced by torch.profiler
    # inside the scan's step graphs; bound and plain time from each
    # launch's jobs).
    scan = dev["scan"]
    kernels.append({
        "name": "dq_trellis", "entry": "trellis_rate_batch", "route": "cuda",
        "source": "wrenc_tpu_torch/kernels/csrc/dq_scan.cu",
        "replaces": "wrenc_tpu/kernels/trellis_pallas.py:296",
        "launches": dev["counts"]["n_dq_trellis_launches"],
        "launches_per_path": {p: v.get("dq_trellis_in_scan",
                                       v["dq_trellis_batch"])
                              for p, v in per_path.items()
                              if "dq_trellis_batch" in v},
        "max_abs_err": batch["err"],
        "ms": scan["k1_device_ms_sum"] / scan["k1_launches"],
        "plain_ms": batch["plain_ms"], "bound_ms": batch["bound_ms"],
        "bound_by": ("operations" if batch["ops_ms"] >= batch["bytes_ms"]
                     else "bytes"),
        "library_ms": None,
        "ms_sum_in_scan": scan["k1_device_ms_sum"],
        "wave_alone_ms": batch["wave_alone_ms"],
        "per_wave_top": batch["per_wave_top"],
        "per_size": batch["per_size"]})
    dev = {k: v for k, v in dev.items() if not k.startswith("k1_")}
    log(f"main path: {json.dumps(main_path)}")
    log(f"1080p: {json.dumps(p1080)}")
    log(f"card vs CPU: {json.dumps(card_cpu)}")
    log(f"commit paths: {json.dumps(paths)}")
    log(f"device engine: {json.dumps(dev)}")
    log(f"mesh: {json.dumps(mesh)}")
    log(f"kernels/ formulations: {json.dumps(item4)}")
    log(f"4K: {json.dumps(p4k)}")
    log(f"tools: {json.dumps(tools)}")
    log(f"phase wall times (s): {json.dumps(walls)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
