"""The plain reference of luma stage A, built from the scalar spec modules.

Stage A, as the port defines it, rates every aligned s-block of a frame
(s = the QT sizes) for intra coding against the source picture itself:
the block's reference samples are the source samples around it, marked
available and substituted as in spec 8.4.5.2.8 (z-scan order inside the
CTU, raster order across CTUs; 128 where nothing is available) and
[1 2 1]-filtered as in 8.4.5.2.10; all 67 luma modes are predicted
(PLANAR, DC, angular with PDPC); the top `K` angular modes by SAD (the
lower mode first on equal SAD) join PLANAR and DC as the block's K + 2
candidates; each candidate's residual is transformed (DCT-II), quantized
by the greedy dependent quantizer, dequantized and inverse transformed,
and its cost is ssd + lam * rate / 16384, with rate the level-rate
table's entries summed over the coded positions (trailing zeros cost
nothing). The selection then adds the mode bits: a static estimate for a
provisional pick, then two Jacobi passes in which each block's MPM list
(spec 8.4.2) comes from its left and above same-size neighbours' picks
(no above neighbour on a CTU's top row), every f32 `base + sc * bits` one
fused multiply-add, and the candidates are ranked by that cost.

Chroma stage A (where it runs on the card) rates every chroma cs-block
(cs = 4, 8, 16, under the luma sizes 8, 16, 32) of Cb and Cr against the
source: the derived mode (the co-located luma block's pick, chroma
prediction rules), at cs = 4 also the SCIPU mode (the pick of the luma
4x4 at the 8x8's odd row and column), and the three CCLM modes (8.4.5.2.13
with the source luma), each cost the Cb and Cr costs added, CCLM's plus
lam * its mode bits, CCLM picking the least.

Everything here is NumPy over `vvcref.spec` (prediction, transforms,
quantization parameters, availability) and `vvcref.entropy.syntax
.derive_mpm_list`, with the rate model's constants from
`vvcref.core.config`; it imports nothing of the program and takes none of
its tables.
"""
import functools

import numpy as np

from vvcref.core.config import RateModelConfig
from vvcref.entropy.syntax import derive_mpm_list
from vvcref.spec import intra, quant, transform
from vvcref.spec.avail import Availability
from vvcref.core import tables


class Params:
    """The constants of stage A at one QP, from the rate model."""

    def __init__(self, qp, dep_quant=True, rm=None):
        rm = rm or RateModelConfig()
        self.qp, self.dep = qp, dep_quant
        self.K = int(getattr(rm, "stage_a_num_rd_cands", 4))
        # the RD lambda of stage A (the rate model's trellis constants)
        lam = 2.0 ** (qp / rm.pick("qp_div", dep_quant, True)) \
            * rm.pick("lambda_mul", dep_quant, True)
        self.lam = np.float32(lam)
        self.sc = np.float32(lam * getattr(rm, "stage_a_mode_bits_scale",
                                           2.0))
        # the greedy quantizer's integer lambda and rate table
        self.lam_q = int(2.0 ** (qp / rm.quant_qp_div)
                         * rm.quant_lambda_mul) + rm.quant_lambda_offset
        i = np.arange(1024, dtype=np.float64)
        self.q_rate = ((i * 16384.0) ** rm.quant_lv_pow).astype(np.int64)
        # the RD level-rate table (block_splitter's lv, greedy dep-quant)
        if dep_quant:
            p, off = rm.lv_pow_dq, rm.lv_offset_dq
        else:
            p, off = rm.lv_pow, rm.lv_offset
        self.lv = ((i + off) ** p * 16384.0).astype(np.int64)
        # mode bits: the static expectation and the MPM-dependent terms
        po = rm.pick("planar_offset", dep_quant, True)
        npo = rm.pick("non_planar_offset", dep_quant, True)
        mio = rm.pick("mpm_idx_offset", dep_quant, True)
        mrm = rm.pick("mpm_remainder_mult", dep_quant, True)
        mro = rm.pick("mpm_remainder_offset", dep_quant, True)
        mpm = (1.0 + mio) ** rm.mpm_idx_pow
        rem = mrm * (30.0 + mro) ** rm.mpm_remainder_pow
        self.static_bits = np.full(67, npo + 0.5 * (mpm + rem), np.float32)
        self.static_bits[0] = po
        self.po = np.float32(po)
        self.idx_bits = np.float32([npo + (k + mio) ** rm.mpm_idx_pow
                                    for k in range(5)])
        self.rem_bits = (npo + mrm * (np.arange(66.0) + mro)
                         ** rm.mpm_remainder_pow).astype(np.float32)
        co = rm.pick("cclm_offset", dep_quant, True)
        cio = rm.pick("cclm_mode_idx_offset", dep_quant, True)
        self.cclm_bits = np.float32([co + (k + cio) ** rm.cclm_pow
                                     for k in range(3)])
        self.qp_c = quant.chroma_qp_from_luma(qp)

    def qpar(self, c_idx, log2):
        return quant.derive_quant_params(
            self.qp if c_idx == 0 else self.qp_c, log2, log2,
            dep_quant=self.dep, transform_skip=False)


@functools.lru_cache(maxsize=None)
def _coding_order(log2):
    return quant.full_scan(log2, log2)[::-1]


def greedy_rate(t, qpar, prm):
    """Greedy dependent quantization of the (s, s) coefficients t, as
    spec/quant.DepQuantizer's greedy mode decides each level (a candidate
    a0 + 1 replaces a0 only at a strictly lower 128 * dist + lam * rate),
    with the RD level rate summed alongside. Returns (q, rate)."""
    s = t.shape[0]
    q = np.zeros((s, s), np.int64)
    q_state, trailing, rate = 0, True, 0
    ls, bd, bdo = qpar.ls, qpar.bd_shift, qpar.bd_offset
    trans = tables.Q_STATE_TRANS
    for x, y in _coding_order(s.bit_length() - 1):
        tc = int(t[y, x])
        a = 0
        if tc != 0:
            delta = 1 if q_state > 1 else 0
            atc = abs(tc)
            a0 = (((atc << bd) + (bdo if tc < 0 else -bdo)) // ls
                  + delta) // 2
            best = None
            for a_c in (a0, a0 + 1):
                mag = 0 if a_c == 0 else 2 * a_c - delta
                dist = abs(atc - ((mag * ls + bdo) >> bd))
                bits = 0 if (a_c == 0 and trailing) else a_c + 1
                cost = 128 * dist + prm.lam_q * prm.q_rate[min(bits, 1023)]
                if best is None or cost < best[0]:
                    best = (cost, a_c, mag)
            a, mag = best[1], best[2]
            q[y, x] = -mag if tc < 0 else mag
        if a or not trailing:
            rate += int(prm.lv[min(a, 1023)])
        trailing = trailing and a == 0
        q_state = int(trans[q_state][a & 1])
    return q, rate


def rd_cost(orig, pred, qpar, prm):
    """ssd + lam * rate / 16384 (float64) of predicting `orig` by `pred`:
    forward DCT-II, greedy dependent quantization, dequantization, inverse
    transform, reconstruction clipped to 8 bits."""
    t = transform.forward(orig - pred)
    q, rate = greedy_rate(t, qpar, prm)
    rec = np.clip(pred + transform.inverse(quant.dequantize(q, qpar)),
                  0, 255)
    ssd = int(((rec - orig) ** 2).sum())
    return float(ssd) + float(prm.lam) * (rate / 16384.0)


class Block:
    """One luma s-block at (bx, by) of the luma plane (H, W): its 67 spec
    predictions, its K + 2 candidate modes in stage A's order (`cands`),
    and `costs(modes)`, the base cost of any modes."""

    def __init__(self, y_plane, bx, by, s, log2_ctu, prm):
        plane = np.asarray(y_plane, np.int32)
        H, W = plane.shape
        avail = Availability(W, H, log2_ctu)
        left, above = intra.gather_ref_samples(plane, bx, by, s, s,
                                               (bx, by), (s, s), avail, 0)
        self.orig = plane[by:by + s, bx:bx + s].astype(np.int64)
        self.preds = []
        for m in range(67):
            lf, af = intra.filter_ref_samples(left, above, s, s, 0, m)
            self.preds.append(np.asarray(intra.predict(m, lf, af, s, s, 0),
                                         np.int64))
        sad = np.array([np.abs(p - self.orig).sum() for p in self.preds])
        top = np.argsort(sad[2:], kind="stable")[:prm.K] + 2
        self.cands = np.concatenate([[0, 1], top]).astype(np.int64)
        self.qpar = prm.qpar(0, s.bit_length() - 1)
        self.prm = prm

    def costs(self, modes):
        return np.array([rd_cost(self.orig, self.preds[int(m)], self.qpar,
                                 self.prm) for m in modes])


class ChromaBlock:
    """One chroma cs-block at chroma (cx, cy) of a frame (Y, Cb, Cr):
    `mode_cost(m)`, the Cb + Cr cost of intra mode m, and `cclm_costs()`,
    the three CCLM modes' Cb + Cr costs plus lam * their bits."""

    def __init__(self, frame, cx, cy, cs, log2_ctu, prm):
        self.y = np.asarray(frame[0], np.int32)
        self.c = [np.asarray(p, np.int32) for p in frame[1:3]]
        H, W = self.y.shape
        self.avail = Availability(W, H, log2_ctu)
        self.at, self.cs, self.ctu = (cx, cy), cs, 1 << log2_ctu
        self.orig = [p[cy:cy + cs, cx:cx + cs].astype(np.int64)
                     for p in self.c]
        self.qpar = prm.qpar(1, cs.bit_length() - 1)
        self.prm = prm

    def _cost(self, preds):
        return sum(rd_cost(o, np.asarray(p, np.int64), self.qpar, self.prm)
                   for o, p in zip(self.orig, preds))

    def mode_cost(self, mode):
        (cx, cy), cs = self.at, self.cs
        return self._cost([intra.predict_block(
            p, cx, cy, cs, cs, (2 * cx, 2 * cy), (2 * cs, 2 * cs),
            self.avail, 1, int(mode)) for p in self.c])

    def cclm_costs(self):
        (cx, cy), cs = self.at, self.cs
        return np.array([self._cost([intra.predict_cclm(
            m, self.y, p, cx, cy, cs, cs, (2 * cx, 2 * cy), self.avail,
            self.ctu, 8) for p in self.c]) for m in (81, 82, 83)]) \
            + float(self.prm.lam) * self.prm.cclm_bits.astype(np.float64)


def _fma32(a, b, c):
    """f32 a * b + c with one rounding: the f64 product of two f32 is
    exact, and the f64 sum is rounded once more to f32."""
    return (np.float64(a) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mpm_table():
    """(67, 67, 5): the spec's MPM list for each (left, above) pair."""
    return np.array([[derive_mpm_list(l, a) for a in range(67)]
                     for l in range(67)], np.int64)


def _mode_bits(cands, C, prm):
    """Mode bits of each candidate (.., K) given MPM lists C (.., 5):
    PLANAR its own offset, a mode in the list its index's bits, any
    other the remainder's bits at its rank among the modes not listed."""
    hit = cands[..., None] == C[..., None, :]
    first = hit.argmax(-1)
    rem = np.clip(cands - 1 - (C[..., None, :] < cands[..., None]).sum(-1),
                  0, len(prm.rem_bits) - 1)
    return np.where(cands == 0, prm.po,
                    np.where(hit.any(-1), prm.idx_bits[first],
                             prm.rem_bits[rem])).astype(np.float32)


def select(base, cands, nbh, nbw, s, ctu, prm, iters=2):
    """Stage A's selection over whole frames: base (F, N, K+2) f32, cands
    (F, N, K+2) modes, N = nbh * nbw blocks in raster order. Returns
    (ranked cands, best cost, top-2 costs) as the program hands them on."""
    base = np.asarray(base, np.float32)
    cands = np.asarray(cands, np.int64)
    F = base.shape[0]
    total = _fma32(prm.sc, prm.static_bits[cands], base)
    mode = np.take_along_axis(cands, total.argmin(2)[..., None], 2)[..., 0]
    top_rows = (np.arange(nbh) * s) % ctu == 0
    T = _mpm_table()
    for _ in range(iters):
        g = mode.reshape(F, nbh, nbw)
        lm = np.zeros_like(g)
        lm[:, :, 1:] = g[:, :, :-1]
        am = np.zeros_like(g)
        am[:, 1:, :] = g[:, :-1, :]
        am[:, top_rows, :] = 0
        C = T[lm.reshape(F, -1), am.reshape(F, -1)]
        total = _fma32(prm.sc, _mode_bits(cands, C, prm), base)
        mode = np.take_along_axis(cands, total.argmin(2)[..., None],
                                  2)[..., 0]
    order = np.argsort(total, axis=2, kind="stable")
    ranked = np.take_along_axis(cands, order, 2)
    cost = np.take_along_axis(total, order, 2)
    return ranked.astype(np.int8), cost[..., 0], cost[..., :2]
