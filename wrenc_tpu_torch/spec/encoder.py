"""Scalar reference encoder: QT partition RD search + mode decision.

Behavioural counterpart of block_splitter.rs (costs :110, chroma :476,
search :782): exhaustive quad-tree search with per-leaf mode decision
(15-candidate sweep + 2-step refinement around the best angular, final
trellis re-encode of the winner, CCLM-vs-derived chroma decision), the
hand-fitted rate model with Optuna-tuned constants (RateModelConfig), and
reconstruction-dependent prediction handled by snapshot/rollback.

This is the golden model: slow, exact, used for tests and as the oracle the
TPU wavefront search is measured against. Output per CTU is a CtNode
decision tree consumable by entropy.syntax.SliceSyntax.
"""
import numpy as np

from ..core import tables
from ..entropy.structure import CtNode, CuDecision
from ..entropy.syntax import derive_mpm_list, MODE_LT_CCLM
from . import intra, quant, transform
from .avail import Availability

CAND_MODES = [0, 1, 2, 7, 13, 18, 23, 29, 34, 39, 45, 50, 55, 60, 66]


class ScalarEncoder:
    def __init__(self, cfg):
        cfg.validate()
        self.cfg = cfg
        self.rm = cfg.rate_model
        self.dq = quant.DepQuantizer(self.rm)
        self._lv_tables = {
            'plain': self._mk_lv(self.rm.lv_pow, self.rm.lv_offset),
            'dq': self._mk_lv(self.rm.lv_pow_dq, self.rm.lv_offset_dq),
            'dq_trellis': self._mk_lv(self.rm.lv_pow_dq_trellis,
                                      self.rm.lv_offset_dq_trellis),
        }

    @staticmethod
    def _mk_lv(p, off):
        i = np.arange(1024, dtype=np.float64)
        return ((i + off) ** p * 16384.0).astype(np.int64)

    # ------------------------------------------------------------ frame API
    def encode_frame(self, planes):
        """planes: (Y, Cb, Cr) uint8 arrays. Returns (ctu_trees, recon)."""
        cfg = self.cfg
        self.orig = [np.asarray(p, dtype=np.int32) for p in planes]
        self.recon = [np.zeros_like(p) for p in self.orig]
        self.avail = Availability(cfg.width, cfg.height, cfg.log2_ctu_size)
        n4w, n4h = cfg.width >> 2, cfg.height >> 2
        self.mode_map = np.zeros((n4h, n4w), dtype=np.int32)
        self.mode_set = np.zeros((n4h, n4w), dtype=bool)
        trees = []
        cs = cfg.ctu_size
        for cy in range(0, cfg.height, cs):
            for cx in range(0, cfg.width, cs):
                node = CtNode(cx, cy, cfg.log2_ctu_size)
                self._search_ct(node, cfg.max_split_depth)
                trees.append(node)
        return trees, self.recon

    # --------------------------------------------------------------- search
    def _search_ct(self, node, depth):
        if depth == 0 or node.log2 == 2:
            return self._eval_leaf(node)
        no_split_node = CtNode(node.x, node.y, node.log2, node.cqt_depth,
                               node.tree, node.mode_type)
        # evaluate no-split first (matches reference order: reconstruction
        # after no-split eval is snapshotted, split path overwrites it)
        no_split_cost = self._eval_leaf(no_split_node)
        snap = self._snapshot(node)
        split_node = CtNode(node.x, node.y, node.log2, node.cqt_depth,
                            node.tree, node.mode_type, split=True)
        self._make_children(split_node)
        split_cost = 0.0
        for child in split_node.children:
            split_cost += self._search_ct(child, depth - 1)
        if split_cost > no_split_cost:
            self._restore(node, snap)
            node.split = False
            node.children = []
            node.cu = no_split_node.cu
            # re-register leaf modes for MPM of later blocks
            self._set_mode_map(no_split_node.cu)
            return no_split_cost
        node.split = True
        node.children = split_node.children
        node.cu = None
        return split_cost

    def _make_children(self, node):
        half = node.size >> 1
        scipu = (node.tree == 'S' and node.size == 8
                 and self.cfg.chroma_format == 1)
        for i in range(4):
            cx = node.x + (i % 2) * half
            cy = node.y + (i // 2) * half
            node.children.append(
                CtNode(cx, cy, node.log2 - 1, node.cqt_depth + 1,
                       'L' if scipu else node.tree,
                       'INTRA' if scipu else node.mode_type))
        if scipu:
            node.children.append(
                CtNode(node.x, node.y, node.log2, node.cqt_depth,
                       'C', 'INTRA'))

    def _snapshot(self, node):
        x, y, s = node.x, node.y, node.size
        snap = []
        for c in range(3):
            if node.tree == 'L' and c > 0:
                snap.append(None)
                continue
            if node.tree == 'C' and c == 0:
                snap.append(None)
                continue
            sh = 0 if c == 0 else 1
            snap.append(self.recon[c][y >> sh:(y + s) >> sh,
                                      x >> sh:(x + s) >> sh].copy())
        m = (self.mode_map[y >> 2:(y + s) >> 2, x >> 2:(x + s) >> 2].copy(),
             self.mode_set[y >> 2:(y + s) >> 2, x >> 2:(x + s) >> 2].copy())
        return snap, m

    def _restore(self, node, snapm):
        snap, m = snapm
        x, y, s = node.x, node.y, node.size
        for c in range(3):
            if snap[c] is None:
                continue
            sh = 0 if c == 0 else 1
            self.recon[c][y >> sh:(y + s) >> sh, x >> sh:(x + s) >> sh] = snap[c]
        self.mode_map[y >> 2:(y + s) >> 2, x >> 2:(x + s) >> 2] = m[0]
        self.mode_set[y >> 2:(y + s) >> 2, x >> 2:(x + s) >> 2] = m[1]

    def _set_mode_map(self, cu):
        if cu is None or cu.tree == 'C':
            return
        x4, y4, n = cu.x >> 2, cu.y >> 2, max(1 << (cu.log2 - 2), 1)
        self.mode_map[y4:y4 + n, x4:x4 + n] = cu.luma_mode
        self.mode_set[y4:y4 + n, x4:x4 + n] = True

    # ----------------------------------------------------------- leaf modes
    def _eval_leaf(self, node):
        if node.tree == 'C':
            cost = self._chroma_leaf(node)
        else:
            cost = self._luma_leaf(node)
        self._set_mode_map(node.cu)
        return cost

    def _luma_leaf(self, node):
        """Luma (+chroma if single-tree) mode decision
        (block_splitter.rs:886-1077)."""
        cu = CuDecision(node.x, node.y, node.log2, node.tree)
        node.cu = cu
        costs = []
        for m in CAND_MODES:
            if m <= 1:
                costs.append(self._full_cost(cu, m, m, trellis=True))
            else:
                costs.append(self._aux_cost(cu, m, m))
        dir_costs = costs[2:]
        best_dir = CAND_MODES[2 + int(np.argmin(dir_costs))]
        best_dir, _ = self._step_search(cu, best_dir, 2, min(dir_costs), aux=True)
        best_dir, dir_cost = self._step_search(cu, best_dir, 1,
                                               min(dir_costs), aux=False)
        cand = [0, 1, best_dir]
        cand_costs = [costs[0], costs[1], dir_cost]
        best_idx = int(np.argmin(cand_costs))
        mode = cand[best_idx]
        min_cost = cand_costs[best_idx]
        # final luma re-encode with trellis, committing reconstruction
        self._encode_component(cu, 0, mode, trellis=True, write=True)
        # optional transform-skip decision for the winner (RD compare of
        # the TS encode vs the DCT-II encode; sizes <= max_ts)
        if (getattr(self.cfg, 'transform_skip_search', False)
                and self.cfg.transform_skip_enabled
                and (1 << cu.log2)
                <= (1 << self.cfg.log2_transform_skip_max_size)):
            ssd_dct = int(((self.recon[0][cu.y:cu.y + (1 << cu.log2),
                                          cu.x:cu.x + (1 << cu.log2)]
                            - self.orig[0][cu.y:cu.y + (1 << cu.log2),
                                           cu.x:cu.x + (1 << cu.log2)])
                           .astype(np.int64) ** 2).sum())
            rate_dct = self._level_rate(cu.coeffs[0], cu.log2, True)
            ssd_ts, q_ts = self._encode_component(cu, 0, mode, trellis=True,
                                                  ts=True)
            rate_ts = self._level_rate(q_ts, cu.log2, True)
            lam = self._lam(True)
            if (ssd_ts + lam * rate_ts / 16384.0
                    < ssd_dct + lam * rate_dct / 16384.0) and (q_ts != 0).any():
                self._encode_component(cu, 0, mode, trellis=True, write=True,
                                       ts=True)
        cu.luma_mode = mode
        self._set_mode_map(cu)

        if node.tree != 'L' and self.cfg.cclm_enabled:
            cur_cost = self._full_chroma_cost(cu, mode, trellis=True, write=True)
            aux = [self._aux_chroma_cost(cu, m)
                   for m in (MODE_LT_CCLM, MODE_LT_CCLM + 1, MODE_LT_CCLM + 2)]
            cclm_mode = MODE_LT_CCLM + int(np.argmin(aux))
            snap = self._snapshot_chroma(cu)
            cclm_cost = self._full_chroma_cost(cu, cclm_mode, trellis=True,
                                               write=True)
            if cur_cost <= cclm_cost:
                self._restore_chroma(cu, snap)
                cu.chroma_mode = mode
                self._full_chroma_cost(cu, mode, trellis=True, write=True)
                min_cost = self._full_cost(cu, mode, mode, trellis=True,
                                           write=True)
            else:
                cu.chroma_mode = cclm_mode
                min_cost = self._full_cost(cu, mode, cclm_mode, trellis=True,
                                           write=True)
        elif node.tree == 'L':
            cu.chroma_mode = 0
            min_cost = self._full_cost(cu, mode, None, trellis=True, write=True)
        else:
            cu.chroma_mode = mode
            min_cost = self._full_cost(cu, mode, mode, trellis=True, write=True)
        return min_cost

    def _step_search(self, cu, mode, step, cur_cost, aux):
        if not aux:
            cur_cost = self._full_cost(cu, mode, mode, trellis=True)
        while step > 0:
            cost0 = cost1 = np.inf
            if mode - step >= 2:
                cost0 = (self._aux_cost(cu, mode - step, mode - step) if aux
                         else self._full_cost(cu, mode - step, mode - step,
                                              trellis=True))
            if mode + step <= 66:
                cost1 = (self._aux_cost(cu, mode + step, mode + step) if aux
                         else self._full_cost(cu, mode + step, mode + step,
                                              trellis=True))
            m = min(cur_cost, cost0, cost1)
            if m == cost0 and m != cur_cost:
                mode, cur_cost = mode - step, cost0
            elif m == cost1 and m != cur_cost and m != cost0:
                mode, cur_cost = mode + step, cost1
            step //= 2
        return mode, cur_cost

    def _chroma_leaf(self, node):
        """SCIPU chroma CU decision (block_splitter.rs:794-885)."""
        cu = CuDecision(node.x, node.y, node.log2, 'C')
        node.cu = cu
        size = node.size
        derived = int(self.mode_map[(node.y + size // 2) >> 2,
                                    (node.x + size // 2) >> 2])
        if self.cfg.cclm_enabled:
            aux = [self._aux_chroma_cost(cu, m)
                   for m in (MODE_LT_CCLM, MODE_LT_CCLM + 1, MODE_LT_CCLM + 2)]
            cclm_mode = MODE_LT_CCLM + int(np.argmin(aux))
            cclm_cost = self._full_chroma_cost(cu, cclm_mode, trellis=True,
                                               write=True)
            snap = self._snapshot_chroma(cu)
            cur_cost = self._full_chroma_cost(cu, derived, trellis=True,
                                              write=True)
            if cclm_cost < cur_cost:
                cu.chroma_mode = cclm_mode
                self._restore_chroma(cu, snap)
                return cclm_cost
            cu.chroma_mode = derived
            return cur_cost
        cu.chroma_mode = derived
        return self._full_chroma_cost(cu, derived, trellis=True, write=True)

    def _snapshot_chroma(self, cu):
        x, y, s = cu.x >> 1, cu.y >> 1, 1 << (cu.log2 - 1)
        return ([self.recon[c][y:y + s, x:x + s].copy() for c in (1, 2)],
                [None if cu.coeffs[c] is None else cu.coeffs[c].copy()
                 for c in range(3)])

    def _restore_chroma(self, cu, snap):
        planes, coeffs = snap
        x, y, s = cu.x >> 1, cu.y >> 1, 1 << (cu.log2 - 1)
        for i, c in enumerate((1, 2)):
            self.recon[c][y:y + s, x:x + s] = planes[i]
        cu.coeffs = coeffs

    # --------------------------------------------------------- RD machinery
    def _predict(self, cu, c_idx, mode):
        size = 1 << cu.log2
        if c_idx == 0:
            return intra.predict_block(self.recon[0], cu.x, cu.y, size, size,
                                       (cu.x, cu.y), (size, size), self.avail,
                                       0, mode)
        cs = size >> 1
        cx, cy = cu.x >> 1, cu.y >> 1
        if mode >= MODE_LT_CCLM:
            return intra.predict_cclm(mode, self.recon[0], self.recon[c_idx],
                                      cx, cy, cs, cs, (cu.x, cu.y), self.avail,
                                      self.cfg.ctu_size)
        return intra.predict_block(self.recon[c_idx], cx, cy, cs, cs,
                                   (cu.x, cu.y), (size, size), self.avail,
                                   c_idx, mode)

    def _encode_component(self, cu, c_idx, mode, trellis, write=False,
                          ts=None):
        """predict->transform->quant->dequant->inverse->reconstruct.

        Returns (ssd, q). If write: commits reconstruction + stores coeffs.
        ts=True uses the transform-skip path (spec 8.7.2: no transform,
        bd_shift 10, no dependent quantization); ts=None inherits the CU's
        already-decided per-component flag.
        """
        if ts is None:
            ts = bool(cu.ts[c_idx])
        cfg = self.cfg
        size = 1 << cu.log2
        sh = 0 if c_idx == 0 else 1
        cs = size >> sh
        x, y = cu.x >> sh, cu.y >> sh
        log2 = cu.log2 - sh
        pred = self._predict(cu, c_idx, mode)
        org = self.orig[c_idx][y:y + cs, x:x + cs]
        res = org - pred
        qp_y = cfg.qp
        qp_c = quant.chroma_qp_from_luma(qp_y)
        qp = qp_y if c_idx == 0 else qp_c
        qpar = quant.derive_quant_params(qp, log2, log2,
                                         dep_quant=cfg.dep_quant_enabled,
                                         transform_skip=ts,
                                         bit_depth=cfg.bit_depth)
        if ts:
            q = quant.quantize_rdoq_off(res, qpar)
            d = quant.dequantize(q, qpar)
            rec = np.clip(pred + d, 0, 255)
        else:
            t = transform.forward(res, 0, 0, cfg.bit_depth)
            if cfg.dep_quant_enabled:
                q = self.dq.quantize(t, qp_y, qpar, trellis=trellis)
            else:
                q = quant.quantize_rdoq_off(t, qpar)
            d = quant.dequantize(q, qpar)
            r = transform.inverse(d, 0, 0, cfg.bit_depth)
            rec = np.clip(pred + r, 0, 255)
        ssd = int(((rec - org).astype(np.int64) ** 2).sum())
        if write:
            self.recon[c_idx][y:y + cs, x:x + cs] = rec
            cu.coeffs[c_idx] = q.astype(np.int16)
            cu.ts[c_idx] = 1 if ts else 0
        return ssd, q

    def _aux_cost(self, cu, luma_mode, chroma_mode):
        """Prediction-only SAD over active components."""
        sad = 0
        comps = [0] if cu.tree == 'L' else [0, 1, 2]
        for c in comps:
            mode = luma_mode if c == 0 else chroma_mode
            pred = self._predict(cu, c, mode)
            sh = 0 if c == 0 else 1
            cs = (1 << cu.log2) >> sh
            x, y = cu.x >> sh, cu.y >> sh
            org = self.orig[c][y:y + cs, x:x + cs]
            sad += int(np.abs(pred - org).sum())
        return float(sad)

    def _aux_chroma_cost(self, cu, mode):
        sad = 0
        for c in (1, 2):
            pred = self._predict(cu, c, mode)
            cs = (1 << cu.log2) >> 1
            x, y = cu.x >> 1, cu.y >> 1
            org = self.orig[c][y:y + cs, x:x + cs]
            sad += int(np.abs(pred - org).sum())
        return float(sad)

    def _lam(self, trellis):
        rm = self.rm
        dep = self.cfg.dep_quant_enabled
        qp_div = rm.pick('qp_div', dep, trellis)
        mul = rm.pick('lambda_mul', dep, trellis)
        return float(2.0 ** (self.cfg.qp / qp_div) * mul)

    def _lv_table(self, trellis):
        if not self.cfg.dep_quant_enabled:
            return self._lv_tables['plain']
        return self._lv_tables['dq_trellis' if trellis else 'dq']

    def _level_rate(self, q, log2, trellis):
        """Coefficient-rate estimate (block_splitter.rs:415-471)."""
        lv = self._lv_table(trellis)
        if not self.cfg.dep_quant_enabled:
            v = np.minimum(np.abs(q.astype(np.int64)), 1023)
            return int(lv[v].sum())
        a, _ = quant.abs_levels_from_q(q, log2, log2)
        scan = quant.full_scan(log2, log2)[::-1]
        total = 0
        trailing = True
        for sx, sy in scan:
            av = int(a[sy, sx])
            if av == 0:
                if not trailing:
                    total += int(lv[0])
            else:
                total += int(lv[min(av, 1023)])
                trailing = False
        return total

    def _mode_bits(self, cu, luma_mode, chroma_mode, trellis):
        """Mode-bits model (block_splitter.rs:377-406)."""
        rm = self.rm
        dep = self.cfg.dep_quant_enabled
        cclm_bits = 0.0
        if self.cfg.cclm_enabled:
            if chroma_mode is not None and chroma_mode >= MODE_LT_CCLM:
                cclm_bits = (rm.pick('cclm_offset', dep, trellis)
                             + (chroma_mode - MODE_LT_CCLM
                                + rm.pick('cclm_mode_idx_offset', dep, trellis))
                             ** rm.cclm_pow)
            elif cu.tree == 'L':
                cclm_bits = 0.0
            else:
                cclm_bits = rm.pick('non_cclm_offset', dep, trellis)
        if luma_mode != 0:
            cand = self._search_mpm(cu)
            if luma_mode in cand:
                mode_bits = (rm.pick('non_planar_offset', dep, trellis)
                             + (cand.index(luma_mode)
                                + rm.pick('mpm_idx_offset', dep, trellis))
                             ** rm.mpm_idx_pow)
            else:
                s = sorted(cand)
                if luma_mode > s[4]:
                    remainder = luma_mode - 6
                elif luma_mode > s[3]:
                    remainder = luma_mode - 5
                elif luma_mode > s[2]:
                    remainder = luma_mode - 4
                elif luma_mode > s[1]:
                    remainder = luma_mode - 3
                elif luma_mode > s[0]:
                    remainder = luma_mode - 2
                else:
                    remainder = luma_mode - 1
                mode_bits = (rm.pick('non_planar_offset', dep, trellis)
                             + rm.pick('mpm_remainder_mult', dep, trellis)
                             * (remainder
                                + rm.pick('mpm_remainder_offset', dep, trellis))
                             ** rm.mpm_remainder_pow)
        else:
            mode_bits = rm.pick('planar_offset', dep, trellis)
        mode_bits += cclm_bits
        hb = rm.pick('header_bits', dep, trellis)
        if cu.tree == 'S':
            return hb + mode_bits
        if cu.tree == 'L':
            return hb / 3.0 + mode_bits
        return cclm_bits  # DUAL_TREE_CHROMA

    def _search_mpm(self, cu):
        x, y, size = cu.x, cu.y, 1 << cu.log2
        lm = 0
        if x > 0 and self.mode_set[(y + size - 1) >> 2, (x - 1) >> 2]:
            lm = int(self.mode_map[(y + size - 1) >> 2, (x - 1) >> 2])
        am = 0
        ctu_top = (y >> self.cfg.log2_ctu_size) << self.cfg.log2_ctu_size
        if y > 0 and y - 1 >= ctu_top and self.mode_set[(y - 1) >> 2,
                                                        (x + size - 1) >> 2]:
            am = int(self.mode_map[(y - 1) >> 2, (x + size - 1) >> 2])
        return derive_mpm_list(lm, am)

    def _full_cost(self, cu, luma_mode, chroma_mode, trellis, write=False):
        """Full RD cost over active components (block_splitter.rs:110)."""
        ssd = 0
        level = 0
        comps = [0] if cu.tree == 'L' else ([1, 2] if cu.tree == 'C'
                                            else [0, 1, 2])
        for c in comps:
            mode = luma_mode if c == 0 else (chroma_mode if chroma_mode
                                             is not None else luma_mode)
            s, q = self._encode_component(cu, c, mode, trellis, write=write)
            ssd += s
            sh = 0 if c == 0 else 1
            level += self._level_rate(q, cu.log2 - sh, trellis)
        header = self._mode_bits(cu, luma_mode, chroma_mode, trellis)
        level += int(header * 16384.0)
        lam = self._lam(trellis)
        return float(ssd) + lam * (level / 16384.0)

    def _full_chroma_cost(self, cu, mode, trellis, write=False):
        """Chroma-only RD (block_splitter.rs:524)."""
        ssd = 0
        level = 0
        for c in (1, 2):
            s, q = self._encode_component(cu, c, mode, trellis, write=write)
            ssd += s
            level += self._level_rate(q, cu.log2 - 1, trellis)
        rm = self.rm
        dep = self.cfg.dep_quant_enabled
        if self.cfg.cclm_enabled:
            if mode >= MODE_LT_CCLM:
                mb = (rm.pick('cclm_offset', dep, trellis)
                      + (mode - MODE_LT_CCLM
                         + rm.pick('cclm_mode_idx_offset', dep, trellis))
                      ** rm.cclm_pow)
            else:
                mb = rm.pick('non_cclm_offset', dep, trellis)
        else:
            mb = 0.0
        header = rm.pick('chroma_header_bits', dep, trellis) + mb
        level += int(header * 16384.0)
        lam = self._lam(trellis)
        return float(ssd) + lam * (level / 16384.0)
