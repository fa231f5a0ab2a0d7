"""The plain reference of the device RD commit's re-decision.

The device commit engine (`commit_engine='device'`) re-decides every coded
block of stage A's trees against the true reconstruction, as the native
RdCommitter does (block_splitter.rs:110, the true-reconstruction
decisions; :476, the re-ranking by full trellis RD; :905-974, the
candidate list), and codes what it decides. This file rebuilds those
decisions for coded blocks drawn from the seed, from the stream alone and
the frames the program was given, with the scalar spec modules of
`vvcref/`; it imports nothing of the program and takes none of its
tables.

A sampled call's picked pictures are decoded by `Recorder`, the spec
decoder (use_native=False) with its `_reconstruct_cu` overridden: before
each block is reconstructed it records the block's position, size, tree,
coded modes and levels, and its luma neighbours' modes (left and above
4x4 cells, as MPM derivation reads them; the centre luma child of a
dual-tree chroma block). The prediction of any mode is then made from the
decoded picture: every sample a block reads precedes it in decoding order
and is never written again, so the decoded picture holds what the block
read when it was coded (a merged refine leaf included: the engine compares
it with its split in the scan, and the stream holds the winner).

For each sampled block, against the original frame:

commit_levels_differing  every transform block whose coded levels are not
    the 8-state dependent-quantization trellis's levels (`trellis`) of the
    residual of its coded mode, at the commit's lambda table and level-rate
    table (`Params`). Exact; limit 0.
commit_picks_differing   luma: blocks whose coded mode is not in the
    candidate list that stage A handed the commit (`commit_candidates`:
    the ranked candidates and top-2 costs of stage A's selection, as the
    harness's capture keeps them, with the +-1 probes around the first
    angular candidate and the pruning of a confident block to its winner),
    or whose coded mode's full RD cost exceeds the list's least by more
    than the gap limit. The cost of a mode m: ssd + lam * (level rate +
    mode bits(m | left, above)) / 16384 of its luma, plus (single tree)
    ssd + lam * level rate / 16384 of its chroma predicted in the same
    mode. Chroma: blocks whose coded chroma mode is neither the derived
    mode nor the CCLM mode the SAD of the three CCLM predictions picks
    (81 on ties), or whose cost exceeds the other option's by more than
    the gap limit; derived costs lam * non-CCLM bits, CCLM lam * its mode
    bits. Exact count; limit 0.
commit_cost_gap          the largest relative gap (cost - least) /
    max(least, 1) of a coded pick over the sampled blocks. The engine's
    own f32 costs stay on the device, so the reference's cost of the coded
    candidate is compared with its own least.

The limit of the gap: the engine computes every cost in f32 (one fused
multiply-add, its level rate summed in f32), the reference in f64 as the
C++ commit does, so a sound pick is the reference's least or within f32
rounding of it (relative ~1e-7); a pick made on costs computed below f32
strays far further. 1e-3 lies between (PERF.md, the readings).

Departures: the reference computes in f64 and integers (the engine in
f32, the C++ in f64). The trellis takes the distortion of a level from its
magnitude, |abs(t) - ((mag * ls + bd_offset) >> bd_shift)|, as quantizer.rs
and K1 do; vvcref's spec trellis (`DepQuantizer`, trellis mode) takes it
from the signed level, which rounds a negative level's half-way case the
other way. Everything else of the trellis is the spec trellis's: its lambda
(`DepQuantizer._lambda(qp, trellis=True)`), its rate table, the state
machine, the all-zero correction at DC and the tie order (source state,
then the lower level, first wins). The level rate it sums beside the
levels, and the commit's level-rate table, are not in the spec trellis.
Whether a refine merge itself was right is not judged here.
"""
import functools

import numpy as np

from vvcref.bitstream import nal
from vvcref.bitstream.headers import parse_ph, parse_pps, parse_sps
from vvcref.core import tables
from vvcref.core.config import RateModelConfig
from vvcref.decoder import Decoder
from vvcref.entropy.syntax import derive_mpm_list
from vvcref.spec import intra, quant, transform
from vvcref.spec.avail import Availability

LIMITS = {"commit_levels_differing": 0, "commit_picks_differing": 0,
          "commit_cost_gap": 1e-3}
INF = np.int64(1) << 62
_SLICES = (nal.IDR_W_RADL, nal.IDR_N_LP, nal.TRAIL_NUT)


class Params:
    """The commit's constants at one QP, from the rate model (dependent
    quantization, the trellis variants)."""

    def __init__(self, qp, cclm=True):
        rm = RateModelConfig()
        self.qp, self.qp_c = qp, quant.chroma_qp_from_luma(qp)
        self.lam = 2.0 ** (qp / rm.pick("qp_div", True, True)) \
            * rm.pick("lambda_mul", True, True)
        # the trellis's cost of coding a level: lam_q * rate(a + 1)
        dq = quant.DepQuantizer(rm)
        self.lam_dq = dq._lambda(qp, True) * dq._dq_table
        i = np.arange(1024, dtype=np.float64)
        # the commit's level-rate table (block_splitter.rs:45-53)
        self.lv = ((i + rm.pick("lv_offset", True, True))
                   ** rm.pick("lv_pow", True, True) * 16384.0).astype(np.int64)
        self.mode_consts = (
            rm.pick("planar_offset", True, True),
            rm.pick("non_planar_offset", True, True),
            rm.pick("mpm_idx_offset", True, True), rm.mpm_idx_pow,
            rm.pick("mpm_remainder_mult", True, True),
            rm.pick("mpm_remainder_offset", True, True),
            rm.mpm_remainder_pow)
        self.ncc = (int(rm.pick("non_cclm_offset", True, True) * 16384.0)
                    if cclm else 0)
        co = rm.pick("cclm_offset", True, True)
        cio = rm.pick("cclm_mode_idx_offset", True, True)
        self.cclm_bits = [int((co + (k + cio) ** rm.cclm_pow) * 16384.0)
                          for k in range(3)]
        self.prune = rm.rd_commit_prune_margin
        self.cclm = cclm

    def qpar(self, c_idx, log2):
        return quant.derive_quant_params(
            self.qp if c_idx == 0 else self.qp_c, log2, log2,
            dep_quant=True, transform_skip=False)

    def mode_bits(self, mode, left, above):
        """Bits of coding luma `mode` given the neighbours' modes, times
        16384 and truncated (RdCommitter::luma_mode_bits)."""
        return _mode_bits16384(self.mode_consts, left, above)[mode]


@functools.lru_cache(maxsize=None)
def _mode_bits16384(consts, left, above):
    po, npo, mio, mip, mrm, mro, mrp = consts
    mpm = derive_mpm_list(left, above)
    out = np.empty(67, np.int64)
    for m in range(67):
        if m == 0:
            bits = po
        elif m in mpm:
            bits = npo + (mpm.index(m) + mio) ** mip
        else:
            rem = m - 1 - sum(1 for c in mpm if c < m)
            bits = npo + mrm * (rem + mro) ** mrp
        out[m] = int(np.trunc(bits * 16384.0))
    return out


@functools.lru_cache(maxsize=None)
def _coding_order(log2):
    return quant.full_scan(log2, log2)[::-1]


def trellis(t, qpar, prm):
    """The 8-state dependent-quantization Viterbi of (B, s, s) coefficient
    blocks t at one quantization step. States (q_state, trailing) as
    2 * q_state + trailing, from (0, trailing); at each position in coding
    order every live state relaxes its candidate levels a0 and a0 + 1 (a
    zero coefficient only 0), source states in order, the lower level
    first, a later candidate winning only at a strictly lower cost.
    Returns (q (B, s, s) stored levels, rate (B,) the commit's level rate
    of the chosen levels: lv[a] for each level coded, lv[0] for a zero
    after the last significant one, nothing for the trailing zeros)."""
    t = np.asarray(t, np.int64)
    B, s = t.shape[0], t.shape[1]
    order = _coding_order(s.bit_length() - 1)
    tc = t[:, order[:, 1], order[:, 0]]                    # (B, P)
    P = tc.shape[1]
    ls, bd, bdo = qpar.ls, qpar.bd_shift, qpar.bd_offset
    atc, neg = np.abs(tc), tc < 0
    base = ((atc << bd) + np.where(neg, bdo, -bdo)) // ls
    trans = tables.Q_STATE_TRANS
    rows = np.arange(B)
    cost = np.full((B, 8), INF)
    cost[:, 1] = 0
    bp_state = np.zeros((P, B, 8), np.int64)
    bp_level = np.zeros((P, B, 8), np.int64)
    bp_rate = np.zeros((P, B, 8), np.int64)
    for p in range(P):
        zero = atc[:, p] == 0
        new = np.full((B, 8), INF)
        n_state = np.zeros((B, 8), np.int64)
        n_level = np.zeros((B, 8), np.int64)
        n_rate = np.zeros((B, 8), np.int64)
        for st in range(8):
            q_state, trailing = st >> 1, st & 1
            delta = 1 if q_state > 1 else 0
            a0 = np.where(zero, 0, (base[:, p] + delta) // 2)
            for k in (0, 1):
                a = a0 + k
                mag = np.where(a == 0, 0, 2 * a - delta)
                dist = np.abs(atc[:, p] - ((mag * ls + bdo) >> bd))
                coded = (a != 0) | (trailing == 0)
                c = cost[:, st] + 128 * dist + np.where(
                    coded, prm.lam_dq[np.minimum(a + 1, 1023)], 0)
                if p == P - 1 and trailing:
                    # the all-zero block's correction at DC
                    c = c - np.where(a == 0, prm.lam_dq[1], 0)
                nst = trans[q_state][a & 1] * 2 + (~coded)
                live = (cost[:, st] < INF) & ((k == 0) | ~zero)
                win = live & (c < new[rows, nst])
                r, d = rows[win], nst[win]
                new[r, d] = c[win]
                n_state[r, d] = st
                n_level[r, d] = np.where(neg[:, p], -mag, mag)[win]
                n_rate[r, d] = np.where(coded, prm.lv[np.minimum(a, 1023)],
                                        0)[win]
        cost = new
        bp_state[p], bp_level[p], bp_rate[p] = n_state, n_level, n_rate
    st = cost.argmin(1)
    q = np.zeros((B, s, s), np.int64)
    rate = np.zeros(B, np.int64)
    for p in range(P - 1, -1, -1):
        x, y = order[p]
        q[:, y, x] = bp_level[p, rows, st]
        rate += bp_rate[p, rows, st]
        st = bp_state[p, rows, st]
    return q, rate


def commit_candidates(ranked, top2, prune):
    """The commit's candidate lists of one QT size (block_splitter.rs:
    905-974): stage A's ranked candidates (N, K), then the modes one below
    and one above the first angular candidate where they are angular and
    not listed, and a block whose second cost exceeds its first by more
    than `prune` relative (f32) keeps its winner alone. -1 pads."""
    ranked = np.asarray(ranked, np.int64)
    c = np.asarray(top2, np.float32)
    N, K = ranked.shape
    out = np.full((N, K + 2), -1, np.int64)
    out[:, :K] = ranked
    angular = ranked >= 2
    first = ranked[np.arange(N), angular.argmax(1)]
    for d, col in ((-1, K), (1, K + 1)):
        nb = first + d
        ok = (angular.any(1) & (nb >= 2) & (nb <= 66)
              & ~(ranked == nb[:, None]).any(1))
        out[ok, col] = nb[ok]
    if prune > 0 and K > 1:
        sure = c[:, 1] - c[:, 0] > np.float32(prune) * np.maximum(
            np.abs(c[:, 0]), np.float32(1.0))
        out[sure, 1:] = -1
    return out


def cand_rows(kept, frames):
    """{(k, s): (ranked (N, K), top2 (N, 2))} of the call's frames k from
    what the harness's capture kept of luma stage A (StageACapture.fetch():
    per chunk its luma planes and per size the selection's outputs); a
    chunk row is matched to the frame whose luma it holds."""
    out = {}
    for ch in kept["luma"]:
        planes = ch["planes"]
        H = planes.shape[1]
        for r in range(planes.shape[0]):
            k = next((k for k, fr in enumerate(frames)
                      if np.array_equal(planes[r], fr[0])), None)
            if k is None:
                continue
            for nbh, nbw, base, cands, ranked, best, top2 in ch["sizes"]:
                out.setdefault((k, H // nbh), (ranked[r], top2[r]))
    return out


class Recorder(Decoder):
    """The spec decoder, recording each coded block before it is
    reconstructed: {'x', 'y', 'log2', 'tree', 'luma', 'chroma', 'levels'
    (per component, None where not coded), 'left', 'above' (the luma
    neighbours' modes, PLANAR where none), 'centre' (a dual-tree chroma
    block's centre luma child's mode)} per block, in `blocks`."""

    def __init__(self):
        super().__init__(use_native=False)
        self.blocks = []

    def _decode_slice(self, rbsp):
        p = self.p
        self.blocks = []
        self.modes = np.zeros((p.height >> 2, p.width >> 2), np.int64)
        super()._decode_slice(rbsp)

    def _reconstruct_cu(self, cu):
        ctu = 1 << self.p.log2_ctu_size
        s = 1 << cu.log2
        x4, y4, n4 = cu.x >> 2, cu.y >> 2, max(s >> 2, 1)
        m = self.modes
        self.blocks.append({
            "x": cu.x, "y": cu.y, "log2": cu.log2, "tree": cu.tree,
            "luma": cu.luma_mode, "chroma": cu.chroma_mode,
            "levels": [None if q is None else np.array(q, np.int64)
                       for q in cu.coeffs],
            "left": int(m[(cu.y + s - 1) >> 2, (cu.x - 1) >> 2])
            if cu.x > 0 else 0,
            "above": int(m[(cu.y - 1) >> 2, (cu.x + s - 1) >> 2])
            if cu.y & (ctu - 1) else 0,
            "centre": int(m[(cu.y + 4) >> 2, (cu.x + 4) >> 2])
            if cu.tree == "C" else None})
        if cu.tree != "C":
            m[y4:y4 + n4, x4:x4 + n4] = cu.luma_mode
        super()._reconstruct_cu(cu)


def decode(stream, picks):
    """{k: (blocks, decoded planes (Y, Cb, Cr) int64)} for the pictures k
    in `picks` (stream order) of an all-intra stream: every parameter set
    and picture header is parsed, and only the picked slices decoded."""
    dec, out, k = Recorder(), {}, 0
    for nut, _, rbsp in nal.parse_annexb(bytes(stream)):
        if nut == nal.SPS_NUT:
            parse_sps(rbsp, dec.p)
        elif nut == nal.PPS_NUT:
            parse_pps(rbsp, dec.p)
        elif nut == nal.PH_NUT:
            parse_ph(rbsp, dec.p)
        elif nut in _SLICES:
            if k in picks:
                dec._decode_slice(rbsp)
                out[k] = (dec.blocks, [np.asarray(r, np.int64)
                                       for r in dec.recon])
            k += 1
    return out


class _Picture:
    """One decoded picture and its original frame: predictions of any mode
    of a block, and the transform blocks queued for the trellis."""

    def __init__(self, frame, planes, log2_ctu, prm):
        self.orig = [np.asarray(p, np.int64) for p in frame]
        self.dec = planes
        H, W = planes[0].shape
        self.avail = Availability(W, H, log2_ctu)
        self.ctu = 1 << log2_ctu
        self.prm = prm

    def block(self, b, c):
        """(x, y, size) of block b's component c."""
        sh = 0 if c == 0 else 1
        return b["x"] >> sh, b["y"] >> sh, (1 << b["log2"]) >> sh

    def pred(self, b, c, mode):
        """The spec decoder's prediction of block b's component c in
        `mode`, from the decoded picture."""
        x, y, s = self.block(b, c)
        size = 1 << b["log2"]
        if c == 0 or mode < 81:
            return np.asarray(intra.predict_block(
                self.dec[c], x, y, s, s, (b["x"], b["y"]), (size, size),
                self.avail, c, mode), np.int64)
        return np.asarray(intra.predict_cclm(
            mode, self.dec[0], self.dec[c], x, y, s, s, (b["x"], b["y"]),
            self.avail, self.ctu, 8), np.int64)

    def orig_block(self, b, c):
        x, y, s = self.block(b, c)
        return self.orig[c][y:y + s, x:x + s]


class _Jobs:
    """Transform blocks (picture, block, component, mode) rated once each:
    forward transform, the trellis batched per (component class, size),
    dequantization, inverse transform, reconstruction, SSD."""

    def __init__(self, prm):
        self.prm = prm
        self.pending = {}        # key -> (pred, orig)
        self.done = {}           # key -> (levels, rate, ssd)

    def want(self, pic, key, b, c, mode):
        if key not in self.done and key not in self.pending:
            self.pending[key] = (c, pic.pred(b, c, mode),
                                 pic.orig_block(b, c))

    def run(self):
        groups = {}
        for key, (c, pred, orig) in self.pending.items():
            groups.setdefault((min(c, 1), pred.shape[0]), []).append(
                (key, pred, orig))
        for (cc, s), items in groups.items():
            qpar = self.prm.qpar(cc, s.bit_length() - 1)
            t = np.stack([transform.forward(o - p) for _, p, o in items])
            q, rate = trellis(t, qpar, self.prm)
            for (key, pred, orig), qi, ri in zip(items, q, rate):
                rec = np.clip(pred + np.asarray(transform.inverse(
                    quant.dequantize(qi, qpar)), np.int64), 0, 255)
                self.done[key] = (qi, int(ri), int(((rec - orig) ** 2).sum()))
        self.pending = {}

    def cost(self, keys, bits):
        """f64 ssd + lam * (level rate + bits) / 16384 over `keys`."""
        ssd = sum(self.done[k][2] for k in keys)
        rate = sum(self.done[k][1] for k in keys)
        return float(ssd) + self.prm.lam * ((rate + bits) / 16384.0)


def _gap(cost, least):
    return (cost - least) / max(least, 1.0)


def numbers(frames, stream, picks, cands, qp, config, per_class, rng,
            details=None):
    """The three numbers of one call: `frames` the call's frames (Y, Cb,
    Cr), `stream` its stream, `picks` the pictures to decode, `cands`
    cand_rows()'s, `per_class` the blocks of each class (tree and size:
    S 32, 16, 8, the dual tree's L 4 and C 8) drawn from the seed over the
    picked pictures (None: every block). details:
    a list that gets one dict per judged block (its picture and record,
    and its candidates' and chroma options' costs)."""
    ec = config["encoder_config"]
    log2_ctu = ec["log2_ctu_size"]
    prm = Params(qp, cclm=ec.get("cclm_enabled", True))
    decoded = decode(stream, set(picks))
    n = {"commit_levels_differing": 0, "commit_picks_differing": 0,
         "commit_cost_gap": 0.0}
    missing = [k for k in picks if k not in decoded]
    n["commit_picks_differing"] += len(missing)
    pics = {k: _Picture(frames[k], decoded[k][1], log2_ctu, prm)
            for k in sorted(decoded)}
    pool = {}
    for k in sorted(decoded):
        for b in decoded[k][0]:
            pool.setdefault((b["tree"], b["log2"]), []).append((k, b))
    chosen = []
    for cls in sorted(pool):
        entries = pool[cls]
        if per_class is None or len(entries) <= per_class:
            chosen += entries
        else:
            chosen += [entries[int(i)] for i in sorted(rng.choice(
                len(entries), size=per_class, replace=False))]
    jobs = _Jobs(prm)
    plans = []
    for k, b in chosen:
        pic = pics[k]
        comps = {"L": (0,), "C": (1, 2), "S": (0, 1, 2)}[b["tree"]]
        plan = {"pic": k, "block": b, "comps": comps}
        for c in comps:
            mode = b["luma"] if c == 0 else b["chroma"]
            jobs.want(pic, (k, id(b), c, mode), b, c, mode)
        if b["tree"] != "C":
            s = 1 << b["log2"]
            row = cands.get((k, s))
            if row is None:
                plan["cands"] = None
            else:
                bi = (b["y"] // s) * (pic.dec[0].shape[1] // s) + b["x"] // s
                lst = commit_candidates(row[0][bi:bi + 1], row[1][bi:bi + 1],
                                        prm.prune)[0]
                plan["cands"] = [int(m) for m in lst if m >= 0]
                for m in plan["cands"]:
                    for c in comps:
                        jobs.want(pic, (k, id(b), c, m), b, c, m)
        if b["tree"] != "L":
            dm = b["luma"] if b["tree"] == "S" else b["centre"]
            plan["derived"] = dm
            for c in (1, 2):
                jobs.want(pic, (k, id(b), c, dm), b, c, dm)
            if prm.cclm:
                sad = [sum(int(np.abs(pic.pred(b, c, 81 + i)
                                      - pic.orig_block(b, c)).sum())
                           for c in (1, 2)) for i in range(3)]
                plan["cclm"] = int(np.argmin(sad))
                for c in (1, 2):
                    jobs.want(pic, (k, id(b), c, 81 + plan["cclm"]), b, c,
                              81 + plan["cclm"])
        plans.append(plan)
    jobs.run()

    for plan in plans:
        k, b = plan["pic"], plan["block"]

        def key(c, m):
            return k, id(b), c, m
        for c in plan["comps"]:
            want = jobs.done[key(c, b["luma"] if c == 0 else b["chroma"])][0]
            got = b["levels"][c]
            got = np.zeros_like(want) if got is None else got
            n["commit_levels_differing"] += int(not np.array_equal(got, want))
        detail = {"pic": k, "block": b}
        if b["tree"] != "C":
            if plan["cands"] is None:
                n["commit_picks_differing"] += 1
            else:
                costs = {}
                for m in plan["cands"]:
                    costs[m] = jobs.cost([key(0, m)], prm.mode_bits(
                        m, b["left"], b["above"]))
                    if b["tree"] == "S":
                        costs[m] += jobs.cost([key(1, m), key(2, m)], 0)
                detail["luma"] = costs
                _judge(n, costs, b["luma"])
        if b["tree"] != "L":
            dm = plan["derived"]
            opts = {dm: jobs.cost([key(1, dm), key(2, dm)], prm.ncc)}
            if prm.cclm:
                p = plan["cclm"]
                opts[81 + p] = jobs.cost([key(1, 81 + p), key(2, 81 + p)],
                                         prm.cclm_bits[p])
            detail["chroma"] = opts
            _judge(n, opts, b["chroma"])
        if details is not None:
            details.append(detail)
    return n


def _judge(n, costs, coded):
    """A coded pick against its options' costs: counted when it is not an
    option or its gap exceeds the limit; the gap joins the largest."""
    if coded not in costs:
        n["commit_picks_differing"] += 1
        return
    gap = _gap(costs[coded], min(costs.values()))
    n["commit_cost_gap"] = max(n["commit_cost_gap"], gap)
    n["commit_picks_differing"] += int(gap > LIMITS["commit_cost_gap"])


def add(total, numbers):
    for k, v in numbers.items():
        total[k] = (max(total.get(k, v), v) if k == "commit_cost_gap"
                    else total.get(k, 0) + v)
    return total


def passes(numbers):
    return all(k in numbers and numbers[k] <= LIMITS[k] for k in LIMITS)
