"""What the metric files under perfbench/end_to_end/ and
perfbench/layer_metrics/ share. Each takes the run's record:

setup_s   seconds from process start to the first timed call
calls     [(start, end, frames returned)] of the window's calls, host clock
frames    frames returned by all calls
wall_s    the calls' summed wall time
phases    WavefrontSearch.phase_times + Encoder's host_entropy, summed
          over the calls (the program resets them at each call)
config, traffic   the cell's files
trace     tracing.reduce() of the traced window, or None

and returns a number, or None where it finds nothing to read.
"""
import numpy as np

from . import roofline


def encode_fps(record):
    calls = record["calls"]
    return record["frames"] / (calls[-1][1] - calls[0][0])


def latency_pct_ms(record, q):
    return float(np.percentile([(b - a) * 1e3 for a, b, _ in record["calls"]],
                               q))


def phase_ms_per_frame(record, names):
    ph = record["phases"]
    if not record["frames"] or not any(n in ph for n in names):
        return None
    return 1e3 * sum(ph.get(n, 0.0) for n in names) / record["frames"]


def phase_pct_of_wall(record, name):
    if name not in record["phases"] or not record["wall_s"]:
        return None
    return 100.0 * record["phases"][name] / record["wall_s"]


def device_idle_pct(record):
    tr = record["trace"]
    if not tr or not tr["busy_s"] or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def dq_greedy_roofline_pct(record):
    """Share of K2's device time in the window that its launches' least
    time makes up. None unless the trace holds exactly the launches that
    roofline.k2_launches predicts for the window's calls (another launch
    pattern would be counted wrong)."""
    tr = record["trace"]
    if not tr:
        return None
    hits = [v for n, v in tr["kernels"].items() if "dq_greedy" in n]
    count, secs = sum(v[0] for v in hits), sum(v[1] for v in hits)
    ec = record["config"]["encoder_config"]
    if (not count or record["config"].get("search")
            or ec.get("rate_model", {}).get("stage_a_trellis_rd")):
        return None
    launches = []
    for _, _, n in record["calls"]:
        launches += roofline.k2_launches(ec["width"], ec["height"],
                                         ec["log2_ctu_size"],
                                         ec["max_split_depth"], n)
    if len(launches) != count:
        return None
    return 100.0 * roofline.k2_bound_s(launches) / secs
