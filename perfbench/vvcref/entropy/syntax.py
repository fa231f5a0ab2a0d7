"""Slice-data syntax: coding tree / coding unit / transform unit / residual.

One implementation drives both the encoder and the decoder: every syntax
element goes through `_bin`/`_bypass` which either encode a provided value
or decode one, so context derivations can never diverge between the two
directions. Behavioural reference: ctu_encoder.rs (tree :227, CU :440,
TU :1414, residual :1786) and the ctxInc derivations in
bool_coder.rs:1486-2966, restricted to the I-slice operating point
(QT-only, no IBC/PLT/MIP/MRL/ISP/BDPCM/SBT/LFNST, CCLM + dep-quant on).

Maps (luma-4x4 granularity, filled in coding order) provide the neighbour
state for MPM and the split-flag contexts.
"""
import numpy as np

from ..core import tables
from ..core.tables import SE
from ..spec import quant
from ..spec.avail import Availability
from . import binarize
from .structure import CtNode, CuDecision

MODE_LT_CCLM, MODE_L_CCLM, MODE_T_CCLM = 81, 82, 83


def derive_mpm_list(left_mode, above_mode):
    """Luma MPM candidate list (spec 8.4.2; ctu.rs:1530-1601).

    left/above are neighbour luma intra modes (PLANAR when unavailable).
    Returns the 5-entry list (not including PLANAR, which is candidate -1).
    """
    l, a = left_mode, above_mode
    if l == a and l > 1:
        return [l, 2 + (l + 61) % 64, 2 + (l - 1) % 64,
                2 + (l + 60) % 64, 2 + l % 64]
    if l != a and (l > 1 or a > 1):
        mn, mx = min(l, a), max(l, a)
        if mn > 1:
            d = mx - mn
            if d == 1:
                return [l, a, 2 + (mn + 61) % 64, 2 + (mx - 1) % 64,
                        2 + (mn + 60) % 64]
            if d >= 62:
                return [l, a, 2 + (mn - 1) % 64, 2 + (mx + 61) % 64,
                        2 + mn % 64]
            if d == 2:
                return [l, a, 2 + (mn - 1) % 64, 2 + (mn + 61) % 64,
                        2 + (mx - 1) % 64]
            return [l, a, 2 + (mn + 61) % 64, 2 + (mn - 1) % 64,
                    2 + (mx + 61) % 64]
        return [mx, 2 + (mx + 61) % 64, 2 + (mx - 1) % 64,
                2 + (mx + 60) % 64, 2 + mx % 64]
    return [1, 50, 18, 46, 54]


def chroma_mode_from_idx(idx, luma_mode):
    """intra_chroma_pred_mode index -> chroma prediction mode (Table 20)."""
    if idx == 4:
        return luma_mode
    base = [0, 50, 18, 1][idx]
    return 66 if luma_mode == base else base


def chroma_idx_from_mode(mode, luma_mode):
    if mode == luma_mode:
        return 4
    for idx in range(4):
        if chroma_mode_from_idx(idx, luma_mode) == mode:
            return idx
    raise ValueError((mode, luma_mode))


class SliceSyntax:
    """Codes (or parses) one slice's CTU data.

    mode='enc': `cabac` is a CabacEncoder, decision trees are inputs.
    mode='dec': `cabac` is a CabacDecoder, decision trees are outputs; a
    `on_cu` callback receives each CU as soon as it is parsed (so the
    caller can reconstruct before neighbouring CUs need the samples).
    """

    def __init__(self, cabac, params, mode, on_cu=None):
        self.c = cabac
        self.p = params                 # EncoderConfig (enc) / ParsedParams (dec)
        self.enc = (mode == 'enc')
        self.on_cu = on_cu
        W, H = params.width, params.height
        self.avail = Availability(W, H, params.log2_ctu_size)
        n4w, n4h = W >> 2, H >> 2
        self.mode_map = np.zeros((n4h, n4w), dtype=np.int32)   # luma intra mode
        self.mode_set = np.zeros((n4h, n4w), dtype=bool)
        self.cqt_map = np.zeros((n4h, n4w), dtype=np.int32)
        self.cbw_map = np.zeros((n4h, n4w), dtype=np.int32)
        self.cbh_map = np.zeros((n4h, n4w), dtype=np.int32)
        self.qp = params.qp if self.enc else params.slice_qp
        self.dep_quant = (params.dep_quant_enabled if self.enc
                          else params.dep_quant_used)
        self.min_qt_log2 = params.log2_min_cb_size  # QT-only operating point
        # per-TB scratch (64x64 covers max TB)
        self._abs_level = np.zeros((32, 32), dtype=np.int64)
        self._pass1 = np.zeros((32, 32), dtype=np.int64)
        self.q_state = 0
        self.is_cu_qp_delta_coded = False
        self._sao_map = {}
        # --- QG (quantization group) QP bookkeeping, spec 8.7.1. The
        # operating point has cu_qp_delta_subdiv=0, so QG == CTU, and one
        # tile/slice per picture: at CTU granularity the A/B neighbours
        # of 8.7.1 always fall outside the current CTB, so
        # qP_Y_A == qP_Y_B == qP_Y_PREV and the prediction reduces to
        # qP_Y_PREV — except at a CTB-row start, where the above QG's QP
        # is used when available (quantizer.rs:95-234 derive_qp).
        cs = 1 << params.log2_ctu_size
        self.qg_qp_map = np.full((max(H // cs, 1), max(W // cs, 1)),
                                 self.qp, dtype=np.int32)
        self.qp_y_prev = self.qp       # last QG's final QpY
        self.qg_pred_qp = self.qp      # predicted QP of the current QG
        self.qg_delta = 0              # CuQpDeltaVal of the current QG
        self.cur_qp_y = self.qp        # QpY in effect (dequantization)
        self._qg_pos = None

    # ------------------------------------------------------------- QG / QP
    def _qg_begin(self, x, y):
        """Start a new quantization group (== CTU): finalize the previous
        QG's QpY (delta 0 if none was coded) and derive this QG's
        predicted QP per spec 8.7.1."""
        if self._qg_pos is not None:
            qpy = (self.qg_pred_qp + self.qg_delta + 64) % 64
            self.qp_y_prev = qpy
            px, py = self._qg_pos
            self.qg_qp_map[py, px] = qpy
        cs = 1 << self.p.log2_ctu_size
        cx, cy = x // cs, y // cs
        self._qg_pos = (cx, cy)
        self.qg_delta = 0
        if cx == 0 and cy > 0:
            # first QG in a CTB row: predict from the above QG
            pred = int(self.qg_qp_map[cy - 1, 0])
        else:
            pred = self.qp_y_prev
        self.qg_pred_qp = pred
        self.cur_qp_y = pred

    # ------------------------------------------------------------------ io
    def _bin(self, se, inc, v=None):
        if self.enc:
            self.c.encode_bin(se, inc, int(v))
            return int(v)
        return self.c.decode_bin(se, inc)

    def _bypass(self, v=None):
        if self.enc:
            self.c.encode_bypass(int(v))
            return int(v)
        return self.c.decode_bypass()

    def _bypass_bins(self, bins=None, reader=None):
        """Encode a list of bypass bins, or decode via reader callback."""
        if self.enc:
            for b in bins:
                self.c.encode_bypass(int(b))
        # decode side handled by callers with _bypass()

    # ------------------------------------------------------------ neighbours
    def _left_above_avail(self, x, y):
        return (self.avail.available(x, y, x - 1, y),
                self.avail.available(x, y, x, y - 1))

    def _map_at(self, m, x, y):
        return int(m[y >> 2, x >> 2])

    # ------------------------------------------------------------------ CTU
    def code_ctu(self, node, first_in_slice):
        """Code one CTU. In decode mode, `node` is a fresh CtNode at the CTU
        position which gets populated."""
        if first_in_slice:
            self.c.init_slice(self.qp)
            self._sao_map = {}
        if self._sao_signalled():
            self._code_sao(node)
        self.code_coding_tree(node)
        return node

    # ------------------------------------------------------------------ SAO
    def _sao_signalled(self):
        if self.enc:
            return bool(getattr(self.p, 'sao_enabled', False))
        return bool(getattr(self.p, 'sao_luma_used', False)
                    or getattr(self.p, 'sao_chroma_used', False))

    def _code_sao(self, node):
        """Per-CTU SAO parameter syntax (ctu_encoder.rs:2611-2730; spec
        7.3.11.3). Syntax-only capability parity: like the reference, the
        search never produces SAO offsets, and the filter itself is not
        applied (sao is carried on the CTU node).

        NOTE: sao_merge_left/up share ONE context per spec Table 51 (the
        reference's dead code splits them; identical init values)."""
        from .structure import CtuSao
        p = self.p
        rx = node.x >> p.log2_ctu_size
        ry = node.y >> p.log2_ctu_size
        sao = node.sao if (self.enc and node.sao is not None) else CtuSao()
        if not self.enc:
            node.sao = sao
        luma_used = bool(getattr(p, 'sao_luma_used', True)) \
            if not self.enc else True
        chroma_used = bool(getattr(p, 'sao_chroma_used', True)) \
            if not self.enc else (p.chroma_format != 0)

        merge_left = merge_up = 0
        if rx > 0:
            merge_left = self._bin(SE.AlfSaoMergeLeftFlag, 0,
                                   sao.merge_left if self.enc else None)
        if ry > 0 and not merge_left:
            merge_up = self._bin(SE.AlfSaoMergeLeftFlag, 0,
                                 sao.merge_up if self.enc else None)
        sao.merge_left, sao.merge_up = merge_left, merge_up
        if merge_left or merge_up:
            src = self._sao_map[(rx - 1, ry) if merge_left else (rx, ry - 1)]
            sao.type_idx = list(src.type_idx)
            sao.offset_abs = [list(o) for o in src.offset_abs]
            sao.offset_sign = [list(o) for o in src.offset_sign]
            sao.band_position = list(src.band_position)
            sao.eo_class = list(src.eo_class)
            self._sao_map[(rx, ry)] = sao
            return

        for c_idx in range(3 if p.chroma_format != 0 else 1):
            if not ((luma_used and c_idx == 0)
                    or (chroma_used and c_idx > 0)):
                continue
            ti = sao.type_idx[0 if c_idx == 0 else 1]
            if c_idx in (0, 1):
                se = (SE.AlfSaoTypeIdxLuma if c_idx == 0
                      else SE.AlfSaoTypeIdxChroma)
                # TR(2,0): first bin ctx 0, second bypass
                b0 = self._bin(se, 0, int(ti > 0) if self.enc else None)
                if b0:
                    b1 = self._bypass(int(ti == 2) if self.enc else None)
                    ti = 2 if b1 else 1
                else:
                    ti = 0
                if not self.enc:
                    sao.type_idx[0 if c_idx == 0 else 1] = ti
            if ti != 0:
                # sao_offset_abs: TR(cMax=7, 0), bypass (8-bit)
                for i in range(4):
                    if self.enc:
                        v = sao.offset_abs[c_idx][i]
                        for b in binarize.tr_bins(v, 7, 0):
                            self._bypass(b)
                    else:
                        v = 0
                        while v < 7 and self._bypass():
                            v += 1
                        sao.offset_abs[c_idx][i] = v
                if ti == 1:      # band offset
                    for i in range(4):
                        if sao.offset_abs[c_idx][i] != 0:
                            s = self._bypass(sao.offset_sign[c_idx][i]
                                             if self.enc else None)
                            if not self.enc:
                                sao.offset_sign[c_idx][i] = s
                    if self.enc:
                        for b in binarize.fl_bins(
                                sao.band_position[c_idx], 31):
                            self._bypass(b)
                    else:
                        bp = 0
                        for _ in range(5):
                            bp = (bp << 1) | self._bypass()
                        sao.band_position[c_idx] = bp
                elif c_idx in (0, 1):   # edge offset class, luma/chroma
                    if self.enc:
                        for b in binarize.fl_bins(
                                sao.eo_class[0 if c_idx == 0 else 1], 3):
                            self._bypass(b)
                    else:
                        eo = (self._bypass() << 1) | self._bypass()
                        sao.eo_class[0 if c_idx == 0 else 1] = eo
        self._sao_map[(rx, ry)] = sao

    # ---------------------------------------------------------- coding tree
    def code_coding_tree(self, node):
        size = node.size
        allow_qt = self._allow_split_qt(node)
        # QP-group bookkeeping: QG == CTU (cu_qp_delta_subdiv = 0)
        if node.log2 == self.p.log2_ctu_size:
            self.is_cu_qp_delta_coded = False
            self._qg_begin(node.x, node.y)

        split = 0
        if allow_qt and node.y + size <= self.p.height:
            inc = self._split_cu_flag_ctx(node)
            split = self._bin(SE.SplitCuFlag, inc,
                              node.split if self.enc else None)
        if not self.enc:
            node.split = bool(split)

        if node.split:
            # split_qt_flag inferred 1 (no BT/TT in this operating point)
            half = size >> 1
            scipu = (node.tree == 'S' and size == 8
                     and self.p.chroma_format == 1)
            if not self.enc:
                for i in range(4):
                    cx = node.x + (i % 2) * half
                    cy = node.y + (i // 2) * half
                    child = CtNode(cx, cy, node.log2 - 1,
                                   cqt_depth=node.cqt_depth + 1,
                                   tree='L' if scipu else node.tree,
                                   mode_type='INTRA' if scipu else node.mode_type)
                    node.children.append(child)
                if scipu:
                    chroma = CtNode(node.x, node.y, node.log2,
                                    cqt_depth=node.cqt_depth,
                                    tree='C', mode_type='INTRA')
                    node.children.append(chroma)
            for child in node.children:
                self.code_coding_tree(child)
        else:
            if not self.enc:
                node.cu = CuDecision(node.x, node.y, node.log2, node.tree)
            # record split-context state for following neighbours
            self._fill_ct_maps(node)
            self.code_coding_unit(node.cu)

    def _fill_ct_maps(self, node):
        if node.tree == 'C':
            return
        x4, y4 = node.x >> 2, node.y >> 2
        n = max(node.size >> 2, 1)
        self.cqt_map[y4:y4 + n, x4:x4 + n] = node.cqt_depth
        self.cbw_map[y4:y4 + n, x4:x4 + n] = node.size
        self.cbh_map[y4:y4 + n, x4:x4 + n] = node.size

    def _allow_split_qt(self, node):
        """derive_allow_split_qt (encoder_context.rs:958), mtt_depth==0."""
        if node.tree == 'C':
            return False  # chroma SCIPU node: size/2 <= 4 and MODE_TYPE_INTRA
        return node.size > (1 << self.min_qt_log2)

    def _split_cu_flag_ctx(self, node):
        """ctxInc for split_cu_flag (bool_coder.rs:2689-2744)."""
        x, y, size = node.x, node.y, node.size
        avail_l, avail_a = self._left_above_avail(x, y)
        cond_l = avail_l and self._map_at(self.cbh_map, x - 1, y) < size
        cond_a = avail_a and self._map_at(self.cbw_map, x, y - 1) < size
        # only QT allowed: ctx_set_idx = (2*1 - 1)//2 = 0
        return int(cond_l) + int(cond_a)

    # ------------------------------------------------------------------ CU
    def code_coding_unit(self, cu):
        size = 1 << cu.log2
        if cu.tree in ('S', 'L'):
            self._code_luma_intra_mode(cu)
        if cu.tree in ('S', 'C'):
            self._code_chroma_intra_mode(cu)
        if cu.tree in ('S', 'L'):
            # record luma mode for MPM of later CUs
            x4, y4 = cu.x >> 2, cu.y >> 2
            n = max(size >> 2, 1)
            self.mode_map[y4:y4 + n, x4:x4 + n] = cu.luma_mode
            self.mode_set[y4:y4 + n, x4:x4 + n] = True
        self.code_transform_unit(cu)
        if self.on_cu is not None:
            self.on_cu(cu)

    def _derive_mpm(self, cu):
        x, y, size = cu.x, cu.y, 1 << cu.log2
        lm = 0
        lx, ly = x - 1, y + size - 1
        if x > 0 and self.mode_set[ly >> 2, lx >> 2]:
            lm = int(self.mode_map[ly >> 2, lx >> 2])
        am = 0
        ax, ay = x + size - 1, y - 1
        ctu_top = (y >> self.p.log2_ctu_size) << self.p.log2_ctu_size
        if y > 0 and y - 1 >= ctu_top and self.mode_set[ay >> 2, ax >> 2]:
            am = int(self.mode_map[ay >> 2, ax >> 2])
        return derive_mpm_list(lm, am)

    def _code_luma_intra_mode(self, cu):
        cand = self._derive_mpm(cu)
        if self.enc:
            mode = cu.luma_mode
            if mode == 0:
                mpm_flag, not_planar, mpm_idx, remainder = 1, 0, 0, 0
            elif mode in cand:
                mpm_flag, not_planar = 1, 1
                mpm_idx = cand.index(mode)
                remainder = 0
            else:
                mpm_flag, not_planar, mpm_idx = 0, 1, 0
                s = sorted(cand)
                # remainder = mode minus the candidates (and PLANAR) below it
                # (ctu.rs:1613-1628)
                if mode > s[4]:
                    remainder = mode - 6
                elif mode > s[3]:
                    remainder = mode - 5
                elif mode > s[2]:
                    remainder = mode - 4
                elif mode > s[1]:
                    remainder = mode - 3
                elif mode > s[0]:
                    remainder = mode - 2
                else:
                    remainder = mode - 1
        else:
            mpm_flag = not_planar = mpm_idx = remainder = None

        mpm_flag = self._bin(SE.IntraLumaMpmFlag, 0, mpm_flag)
        if mpm_flag:
            not_planar = self._bin(SE.IntraLumaNotPlanarFlag, 1, not_planar)
            if not_planar:
                # TR(4,0), all bypass
                if self.enc:
                    for b in binarize.tr_bins(mpm_idx, 4, 0):
                        self._bypass(b)
                else:
                    mpm_idx = 0
                    while mpm_idx < 4 and self._bypass():
                        mpm_idx += 1
                mode = cand[mpm_idx]
            else:
                mode = 0
        else:
            # TB(60) bypass
            if self.enc:
                for b in binarize.tb_bins(remainder, 60):
                    self._bypass(b)
            else:
                remainder = binarize.read_tb(self._bypass_read, 60)
            # invert: insert the 5 sorted candidates + planar
            mode = remainder + 1
            for c in sorted(cand):
                if mode >= c:
                    mode += 1
        if not self.enc:
            cu.luma_mode = mode
        else:
            assert mode == cu.luma_mode, (mode, cu.luma_mode, cand)

    def _bypass_read(self):
        return self._bypass()

    def _derived_chroma_luma_mode(self, cu):
        """Luma mode used for chroma derivation: co-located centre CU."""
        if cu.tree == 'C':
            size = 1 << cu.log2
            cx, cy = cu.x + size // 2, cu.y + size // 2
            return int(self.mode_map[cy >> 2, cx >> 2])
        return cu.luma_mode

    def _code_chroma_intra_mode(self, cu):
        if self.p.chroma_format == 0:
            return
        luma_for_chroma = self._derived_chroma_luma_mode(cu)
        if getattr(self.p, 'cclm_enabled', True):
            if self.enc:
                cclm = 1 if cu.chroma_mode >= MODE_LT_CCLM else 0
            else:
                cclm = None
            cclm = self._bin(SE.CclmModeFlag, 0, cclm)
            if cclm:
                # cclm_mode_idx TR(2,0): first bin ctx 0, second bypass
                if self.enc:
                    idx = cu.chroma_mode - MODE_LT_CCLM
                    bins = binarize.tr_bins(idx, 2, 0)
                    self._bin(SE.CclmModeIdx, 0, bins[0])
                    for b in bins[1:]:
                        self._bypass(b)
                else:
                    idx = 0
                    if self.c.decode_bin(SE.CclmModeIdx, 0):
                        idx = 1 + self.c.decode_bypass()
                    cu.chroma_mode = MODE_LT_CCLM + idx
                return
        # intra_chroma_pred_mode: 4 -> '0'; m -> '1' + FL2(m)
        if self.enc:
            idx = chroma_idx_from_mode(cu.chroma_mode, luma_for_chroma)
            if idx == 4:
                self._bin(SE.IntraChromaPredMode, 0, 0)
            else:
                self._bin(SE.IntraChromaPredMode, 0, 1)
                self._bypass((idx >> 1) & 1)
                self._bypass(idx & 1)
        else:
            if self.c.decode_bin(SE.IntraChromaPredMode, 0):
                idx = (self.c.decode_bypass() << 1) | self.c.decode_bypass()
            else:
                idx = 4
            cu.chroma_mode = chroma_mode_from_idx(idx, luma_for_chroma)

    # ------------------------------------------------------------------ TU
    def code_transform_unit(self, cu):
        log2_l = cu.log2
        chroma_active = cu.tree in ('S', 'C')
        luma_active = cu.tree in ('S', 'L')
        # MtsDcOnly / MtsZeroOutSigCoeffFlag reset per CU before the
        # transform tree (ctu_encoder.rs:1219-1220); updated during luma
        # residual coding, consumed by the CU-level mts_idx condition.
        self.mts_dc_only = True
        self.mts_zero_out = True

        if self.enc:
            y_coded = luma_active and cu.coeffs[0] is not None and (cu.coeffs[0] != 0).any()
            cb_coded = chroma_active and cu.coeffs[1] is not None and (cu.coeffs[1] != 0).any()
            cr_coded = chroma_active and cu.coeffs[2] is not None and (cu.coeffs[2] != 0).any()
        else:
            y_coded = cb_coded = cr_coded = None

        if chroma_active:
            cb_coded = self._bin(SE.TuCbCodedFlag, 0, cb_coded)
            cr_coded = self._bin(SE.TuCrCodedFlag, int(bool(cb_coded)), cr_coded)
        else:
            cb_coded = cr_coded = 0
        if luma_active:
            # intra non-ACT: tu_y_coded_flag always signalled, ctx 0
            y_coded = self._bin(SE.TuYCodedFlag, 0, y_coded)
        else:
            y_coded = 0

        # cu_qp_delta (QG = CTU): full binarization — TR(5) prefix (bin0
        # ctx 0, bins 1..4 ctx 1), EG0 bypass suffix when the prefix
        # saturates, bypass sign when abs > 0 (spec 9.3.3;
        # ctu_encoder.rs:1604-1650). Nonzero deltas update the QG's QpY
        # per spec 8.7.1 (_qg_begin / cur_qp_y); the encoder signals a
        # per-QG target via cu.qp_y (fixed-QP streams leave it unset, so
        # the delta is 0: target == predicted)
        if ((y_coded or cb_coded or cr_coded) and cu.tree != 'C'
                and getattr(self.p, 'cu_qp_delta_enabled', True)
                and not self.is_cu_qp_delta_coded):
            if self.enc:
                target = getattr(cu, 'qp_y', None)
                delta = (target - self.qg_pred_qp if target is not None
                         else getattr(cu, 'qp_delta', 0))
                v = abs(delta)
                for b_idx, b in enumerate(binarize.tr_bins(min(v, 5), 5, 0)):
                    self._bin(SE.CuQpDeltaAbs, 0 if b_idx == 0 else 1, b)
                if v >= 5:
                    for b in binarize.egk_bins(v - 5, 0):
                        self._bypass(b)
                if v:
                    self._bypass(1 if delta < 0 else 0)
            else:
                v = 0
                while v < 5 and self.c.decode_bin(SE.CuQpDeltaAbs,
                                                  0 if v == 0 else 1):
                    v += 1
                if v == 5:
                    v += binarize.read_egk(self._bypass_read, 0)
                sign = self._bypass() if v else 0
                delta = -v if sign else v
                cu.qp_delta = delta
            self.qg_delta = int(delta)
            self.cur_qp_y = (self.qg_pred_qp + int(delta) + 64) % 64
            self.is_cu_qp_delta_coded = True

        max_ts = 1 << self.p.log2_transform_skip_max_size
        ts_in = getattr(cu, 'ts', None) or [0, 0, 0]
        if y_coded and cu.tree != 'C':
            ts = 0
            if self.p.transform_skip_enabled and (1 << log2_l) <= max_ts:
                ts = self._bin(SE.TransformSkipFlag, 0,
                               ts_in[0] if self.enc else None)
            if not self.enc:
                cu.ts[0] = ts
            if ts:
                self._code_residual_ts(cu, 0, log2_l, log2_l)
            else:
                self._code_residual(cu, 0, log2_l, log2_l)
        if cb_coded and cu.tree != 'L':
            ts = 0
            if self.p.transform_skip_enabled and (1 << (log2_l - 1)) <= max_ts:
                ts = self._bin(SE.TransformSkipFlag, 1,
                               ts_in[1] if self.enc else None)
            if not self.enc:
                cu.ts[1] = ts
            if ts:
                self._code_residual_ts(cu, 1, log2_l - 1, log2_l - 1)
            else:
                self._code_residual(cu, 1, log2_l - 1, log2_l - 1)
        if cr_coded and cu.tree != 'L':
            ts = 0
            if self.p.transform_skip_enabled and (1 << (log2_l - 1)) <= max_ts:
                ts = self._bin(SE.TransformSkipFlag, 1,
                               ts_in[2] if self.enc else None)
            if not self.enc:
                cu.ts[2] = ts
            if ts:
                self._code_residual_ts(cu, 2, log2_l - 1, log2_l - 1)
            else:
                self._code_residual(cu, 2, log2_l - 1, log2_l - 1)
        if not self.enc:
            for c_idx, coded in ((0, y_coded), (1, cb_coded), (2, cr_coded)):
                active = luma_active if c_idx == 0 else chroma_active
                if active and not coded:
                    lg = log2_l if c_idx == 0 else log2_l - 1
                    cu.coeffs[c_idx] = np.zeros((1 << lg, 1 << lg),
                                                dtype=np.int16)

        # CU-level mts_idx (ctu_encoder.rs:1292-1319; spec 7.3.11.5): emitted
        # when explicit intra MTS is signalled in the SPS, single/luma tree,
        # lfnst_idx 0 (LFNST off), no transform skip, size <= 32, no ISP/SBT,
        # MtsZeroOutSigCoeffFlag still set and the luma TB is not DC-only.
        ts_luma = bool(y_coded) and bool((getattr(cu, 'ts', None)
                                          or [0, 0, 0])[0])
        if (cu.tree != 'C' and (1 << log2_l) <= 32 and not ts_luma
                and getattr(self.p, 'explicit_mts_intra_enabled', False)
                and self.mts_zero_out and not self.mts_dc_only):
            # TR(4,0) binarization, ctxInc = binIdx (cabac_contexts.rs:1487)
            if self.enc:
                assert getattr(cu, 'mts_idx', 0) == 0, \
                    "search never selects explicit MTS"
                self._bin(SE.MtsIdx, 0, 0)
            else:
                idx = 0
                while idx < 4 and self.c.decode_bin(SE.MtsIdx, idx):
                    idx += 1
                cu.mts_idx = idx

    # ------------------------------------------------------------ residual
    def _code_residual(self, cu, c_idx, log2_w, log2_h):
        """encode_residual / parse counterpart (ctu_encoder.rs:1786)."""
        tw, th = 1 << log2_w, 1 << log2_h
        dep_quant = self.dep_quant
        q = cu.coeffs[c_idx] if self.enc else None
        if not self.enc:
            cu.coeffs[c_idx] = np.zeros((th, tw), dtype=np.int16)

        abs_level = self._abs_level
        pass1 = self._pass1
        abs_level[:th, :tw] = 0
        pass1[:th, :tw] = 0
        sign_map = np.zeros((th, tw), dtype=np.int8)

        log2_sb_w, log2_sb_h = quant.sb_size(log2_w, log2_h)
        sub = tables.diag_scan(log2_sb_h, log2_sb_w)
        sbs = tables.diag_scan(log2_h - log2_sb_h, log2_w - log2_sb_w)
        num_sb_coeff = 1 << (log2_sb_w + log2_sb_h)
        last_subblock_max = len(sbs) - 1

        # ---- last significant position
        if self.enc:
            scan = quant.full_scan(log2_w, log2_h)
            last_idx = -1
            for i, (sx, sy) in enumerate(scan):
                if q[sy, sx] != 0:
                    last_idx = i
            assert last_idx >= 0
            last_x, last_y = int(scan[last_idx][0]), int(scan[last_idx][1])
        else:
            last_x = last_y = None

        last_x = self._code_last_prefix_suffix(SE.LastSigCoeffXPrefix,
                                               SE.LastSigCoeffXSuffix,
                                               c_idx, log2_w, last_x)
        last_y = self._code_last_prefix_suffix(SE.LastSigCoeffYPrefix,
                                               SE.LastSigCoeffYSuffix,
                                               c_idx, log2_h, last_y)

        # locate last position in scan
        sb_of = {}
        for i, (sx, sy) in enumerate(sbs):
            sb_of[(int(sx), int(sy))] = i
        last_sb = sb_of[(last_x >> log2_sb_w, last_y >> log2_sb_h)]
        lx_in = last_x & ((1 << log2_sb_w) - 1)
        ly_in = last_y & ((1 << log2_sb_h) - 1)
        last_scan_pos = next(i for i, (cx, cy) in enumerate(sub)
                             if cx == lx_in and cy == ly_in)

        # MtsDcOnly: cleared when the luma last-significant position is not
        # DC (ctu_encoder.rs:1955-1957)
        if c_idx == 0 and (last_sb > 0 or last_scan_pos > 0):
            self.mts_dc_only = False

        rem_bins = ((1 << (log2_w + log2_h)) * 7) >> 2
        self.q_state = 0
        sb_coded_map = np.zeros((len(sbs),), dtype=bool)

        for i in range(last_sb, -1, -1):
            sx, sy = int(sbs[i][0]), int(sbs[i][1])
            x0, y0 = sx << log2_sb_w, sy << log2_sb_h
            start_q_state = self.q_state

            if self.enc:
                # coded AbsLevels for this sub-block from stored q
                sb_abs = np.zeros(num_sb_coeff, dtype=np.int64)
                qs = self.q_state
                for n in range(num_sb_coeff - 1, -1, -1):
                    xc = x0 + int(sub[n][0])
                    yc = y0 + int(sub[n][1])
                    qv = abs(int(q[yc, xc]))
                    if dep_quant:
                        sb_abs[n] = (qv + (1 if qs > 1 else 0)) // 2
                        qs = int(tables.Q_STATE_TRANS[qs][sb_abs[n] & 1])
                    else:
                        sb_abs[n] = qv
                sb_coded = bool((sb_abs != 0).any()) or (sx, sy) == (0, 0)
            else:
                sb_abs = np.zeros(num_sb_coeff, dtype=np.int64)
                sb_coded = None

            infer_dc = False
            if i < last_sb and i > 0:
                inc = self._sb_coded_ctx(sb_coded_map, sb_of, sx, sy,
                                         log2_w - log2_sb_w, log2_h - log2_sb_h,
                                         c_idx)
                sb_coded = bool(self._bin(SE.SbCodedFlag, inc, sb_coded))
                infer_dc = True
            elif sb_coded is None:
                sb_coded = True  # last sub-block and DC sub-block
            sb_coded_map[i] = sb_coded
            # MtsZeroOutSigCoeffFlag: cleared by a coded luma sub-block
            # outside the top-left 16x16 region (ctu_encoder.rs:2009-2011)
            if sb_coded and (sx > 3 or sy > 3) and c_idx == 0:
                self.mts_zero_out = False

            first_pos_mode0 = last_scan_pos if i == last_sb else num_sb_coeff - 1
            first_pos_mode1 = first_pos_mode0
            sig_flags = np.zeros(num_sb_coeff, dtype=np.int64)

            # ---- pass 1
            n = first_pos_mode0
            while n >= 0:
                if rem_bins < 4:
                    break
                xc = x0 + int(sub[n][0])
                yc = y0 + int(sub[n][1])
                is_last = (xc == last_x and yc == last_y)
                in_sb_dc = (int(sub[n][0]), int(sub[n][1])) == (0, 0)
                if self.enc:
                    sig = int(sb_abs[n] != 0 or is_last
                              or (in_sb_dc and infer_dc and sb_coded))
                else:
                    sig = None
                emitted = (sb_coded and (n > 0 or not infer_dc) and not is_last)
                if emitted:
                    inc = self._sig_ctx(xc, yc, c_idx, log2_w, log2_h)
                    sig = self._bin(SE.SigCoeffFlag, inc, sig)
                    rem_bins -= 1
                    if sig:
                        infer_dc = False
                else:
                    if not self.enc:
                        if is_last:
                            sig = 1
                        elif in_sb_dc and infer_dc and sb_coded:
                            sig = 1
                        else:
                            sig = 0
                sig_flags[n] = sig

                gt0 = par = gt1 = 0
                if self.enc:
                    a = int(sb_abs[n])
                    gt0 = int(a > 1)
                    gt1 = int(a > 3)
                    par = int(a > 1 and a % 2 == 1)
                if sig:
                    gt0 = self._bin(SE.AbsLevelGtxFlag,
                                    self._gtx_ctx(xc, yc, c_idx, log2_w, log2_h,
                                                  0, last_x, last_y),
                                    gt0 if self.enc else None)
                    rem_bins -= 1
                    if gt0:
                        par = self._bin(SE.ParLevelFlag,
                                        self._gtx_ctx(xc, yc, c_idx, log2_w,
                                                      log2_h, None, last_x, last_y),
                                        par if self.enc else None)
                        gt1 = self._bin(SE.AbsLevelGtxFlag,
                                        self._gtx_ctx(xc, yc, c_idx, log2_w,
                                                      log2_h, 1, last_x, last_y),
                                        gt1 if self.enc else None)
                        rem_bins -= 2
                p1 = sig + par + gt0 + 2 * gt1
                pass1[yc, xc] = p1
                if not self.enc:
                    sb_abs[n] = p1  # provisional; pass 2 adds the remainder
                if dep_quant:
                    self.q_state = int(tables.Q_STATE_TRANS[self.q_state][p1 & 1])
                first_pos_mode1 = n - 1
                n -= 1

            # ---- pass 2: abs_remainder for saturated pass-1 levels
            for n in range(first_pos_mode0, first_pos_mode1, -1):
                xc = x0 + int(sub[n][0])
                yc = y0 + int(sub[n][1])
                gt1_set = (pass1[yc, xc] >= 4)
                rem = 0
                if self.enc and sb_abs[n] > 3:
                    rem = (int(sb_abs[n]) - int(pass1[yc, xc])) // 2
                if gt1_set:
                    rem = self._code_abs_remainder(xc, yc, c_idx, log2_w,
                                                   log2_h, abs_level,
                                                   rem if self.enc else None)
                abs_level[yc, xc] = pass1[yc, xc] + 2 * rem
                if not self.enc:
                    sb_abs[n] = abs_level[yc, xc]
                if self.enc:
                    assert abs_level[yc, xc] == sb_abs[n]

            # ---- pass 3: dec_abs_level
            for n in range(first_pos_mode1, -1, -1):
                xc = x0 + int(sub[n][0])
                yc = y0 + int(sub[n][1])
                if sb_coded:
                    a = self._code_dec_abs_level(
                        xc, yc, log2_w, log2_h, abs_level,
                        int(sb_abs[n]) if self.enc else None)
                    if not self.enc:
                        sb_abs[n] = a
                abs_level[yc, xc] = sb_abs[n]
                if dep_quant:
                    self.q_state = int(
                        tables.Q_STATE_TRANS[self.q_state][int(sb_abs[n]) & 1])

            # ---- signs
            for n in range(num_sb_coeff - 1, -1, -1):
                xc = x0 + int(sub[n][0])
                yc = y0 + int(sub[n][1])
                if sb_abs[n] > 0:
                    s = self._bypass(int(q[yc, xc] < 0) if self.enc else None)
                    sign_map[yc, xc] = s

            # ---- reconstruct stored q levels (decode side)
            if not self.enc:
                qs = start_q_state
                out = cu.coeffs[c_idx]
                for n in range(num_sb_coeff - 1, -1, -1):
                    xc = x0 + int(sub[n][0])
                    yc = y0 + int(sub[n][1])
                    a = int(sb_abs[n])
                    if dep_quant:
                        mag = 2 * a - (1 if qs > 1 else 0) if a > 0 else 0
                        qs = int(tables.Q_STATE_TRANS[qs][a & 1])
                    else:
                        mag = a
                    out[yc, xc] = -mag if sign_map[yc, xc] else mag

    # --------------------------------------------------------- TS residual
    def _code_residual_ts(self, cu, c_idx, log2_w, log2_h):
        """Transform-skip residual coding (ctu_encoder.rs:2271-2610; TS ctx
        derivations bool_coder.rs:2102,2246,2292,2373). No BDPCM.

        Forward sub-block scan; levels are coded with the left/above
        magnitude prediction remap; signs are context-coded; no dependent
        quantization inside TS blocks."""
        tw, th = 1 << log2_w, 1 << log2_h
        q = cu.coeffs[c_idx] if self.enc else None
        if not self.enc:
            cu.coeffs[c_idx] = np.zeros((th, tw), dtype=np.int16)
            q = cu.coeffs[c_idx]

        log2_sb_w, log2_sb_h = quant.sb_size(log2_w, log2_h)
        sub = tables.diag_scan(log2_sb_h, log2_sb_w)
        sbs = tables.diag_scan(log2_h - log2_sb_h, log2_w - log2_sb_w)
        num_sb = 1 << (log2_sb_w + log2_sb_h)
        last_sb = len(sbs) - 1
        nsb_w = tw >> log2_sb_w

        pass1 = np.zeros((th, tw), np.int64)
        pass2 = np.zeros((th, tw), np.int64)
        sig_map = np.zeros((th, tw), np.int64)
        sign_map = np.zeros((th, tw), np.int8)
        sign_lvl = np.zeros((th, tw), np.int8)   # -1 / 0 / +1
        sb_coded_grid = np.zeros((th >> log2_sb_h, tw >> log2_sb_w), bool)
        rem_ccbs = (tw * th * 7) >> 2
        infer_sb_cbf = True

        def pred_coeff(xc, yc):
            """Left/above magnitude prediction (final stored coeffs)."""
            left = abs(int(q[yc, xc - 1])) if xc > 0 else 0
            above = abs(int(q[yc - 1, xc])) if yc > 0 else 0
            return max(left, above)

        def remap_level(xc, yc):
            """Coded level for |coeff| with the prediction remap
            (ctu_encoder.rs:2345-2362)."""
            pred = pred_coeff(xc, yc)
            a = abs(int(q[yc, xc]))
            if a == pred and pred > 0:
                return 1
            return a + 1 if a < pred else a

        def unmap_level(lvl, xc, yc):
            pred = pred_coeff(xc, yc)
            if lvl == 1 and pred > 0:
                return pred
            return lvl - 1 if lvl <= pred else lvl

        for i in range(len(sbs)):
            sx, sy = int(sbs[i][0]), int(sbs[i][1])
            x0, y0 = sx << log2_sb_w, sy << log2_sb_h
            if self.enc:
                blk = q[y0:y0 + (1 << log2_sb_h), x0:x0 + (1 << log2_sb_w)]
                sb_coded = int((blk != 0).any())
            else:
                sb_coded = None
            if i != last_sb or not infer_sb_cbf:
                # TS ctx: 4 + left/above coded sub-blocks
                inc = 4
                if sx > 0:
                    inc += int(sb_coded_grid[sy, sx - 1])
                if sy > 0:
                    inc += int(sb_coded_grid[sy - 1, sx])
                sb_coded = self._bin(SE.SbCodedFlag, inc, sb_coded)
            else:
                if not self.enc:
                    sb_coded = 1
                else:
                    assert sb_coded == 1, "inferred sb must be coded"
            sb_coded_grid[sy, sx] = bool(sb_coded)
            if sb_coded and i < last_sb:
                infer_sb_cbf = False

            # ---- pass 1: sig + sign + gt0 + par
            infer_sb_sig = True
            pass1_pos = -1
            n = 0
            while n < num_sb and rem_ccbs >= 4:
                xc = x0 + int(sub[n][0])
                yc = y0 + int(sub[n][1])
                pass1_pos = n
                sig = int(q[yc, xc] != 0) if self.enc else None
                emitted = sb_coded and (n != num_sb - 1 or not infer_sb_sig)
                if emitted:
                    # TS sig ctx: 60 + processed-sig neighbours
                    inc = 60
                    if xc > 0 and pass1[yc, xc - 1] >= 1:
                        inc += 1
                    if yc > 0 and pass1[yc - 1, xc] >= 1:
                        inc += 1
                    sig = self._bin(SE.SigCoeffFlag, inc, sig)
                    rem_ccbs -= 1
                    if sig:
                        infer_sb_sig = False
                elif not self.enc:
                    sig = 1 if (sb_coded and n == num_sb - 1
                                and infer_sb_sig) else 0
                sig_map[yc, xc] = sig
                gt0 = par = 0
                if sig:
                    # context-coded sign (bool_coder.rs:2373)
                    sgn = int(q[yc, xc] < 0) if self.enc else None
                    sgn = self._bin(SE.CoeffSignFlag,
                                    self._ts_sign_ctx(sign_lvl, xc, yc), sgn)
                    rem_ccbs -= 1
                    sign_map[yc, xc] = sgn
                    sign_lvl[yc, xc] = -1 if sgn else 1
                    lvl = remap_level(xc, yc) if self.enc else None
                    gt0 = self._bin(SE.AbsLevelGtxFlag,
                                    self._ts_gtx0_ctx(sig_map, xc, yc),
                                    int(lvl > 1) if self.enc else None)
                    rem_ccbs -= 1
                    if gt0:
                        par = self._bin(SE.ParLevelFlag, 32,
                                        int(lvl > 1 and lvl % 2 == 1)
                                        if self.enc else None)
                        rem_ccbs -= 1
                pass1[yc, xc] = sig + par + gt0
                n += 1

            # ---- pass 2: abs_level_gtx_flag j = 1..4
            pass2_pos = -1
            n = 0
            while n < num_sb and rem_ccbs >= 4:
                if n > pass1_pos:
                    break
                xc = x0 + int(sub[n][0])
                yc = y0 + int(sub[n][1])
                pass2[yc, xc] = pass1[yc, xc]
                lvl = remap_level(xc, yc) if self.enc else None
                gt_prev = bool(pass1[yc, xc] >= 2)   # gt0 was set
                for j in range(1, 5):
                    if not gt_prev:
                        break
                    gt_j = self._bin(SE.AbsLevelGtxFlag, 67 + j,
                                     int(lvl > 2 * j + 1)
                                     if self.enc else None)
                    rem_ccbs -= 1
                    pass2[yc, xc] += 2 * gt_j
                    gt_prev = bool(gt_j)
                pass2_pos = n
                n += 1

            # ---- pass 3: abs_remainder + trailing signs
            for n in range(num_sb):
                xc = x0 + int(sub[n][0])
                yc = y0 + int(sub[n][1])
                if self.enc:
                    lvl = remap_level(xc, yc) if n <= pass1_pos \
                        else abs(int(q[yc, xc]))
                    if n <= pass2_pos:
                        rem_v = (lvl - int(pass2[yc, xc])) // 2
                    elif n <= pass1_pos:
                        rem_v = (lvl - int(pass1[yc, xc])) // 2
                    else:
                        rem_v = lvl
                    assert rem_v >= 0
                else:
                    rem_v = 0
                emit_rem = ((n <= pass2_pos and pass2[yc, xc] >= 10)
                            or (pass2_pos < n <= pass1_pos
                                and pass1[yc, xc] >= 2)
                            or (n > pass1_pos and sb_coded))
                if emit_rem:
                    # rice parameter is fixed 1 in TS mode
                    # (bool_coder.rs:1405-1407)
                    rem_v = self._code_rice_escape(
                        1, rem_v if self.enc else None)
                if n > pass2_pos and n > pass1_pos and rem_v > 0:
                    sgn = int(q[yc, xc] < 0) if self.enc else None
                    sgn = self._bin(SE.CoeffSignFlag,
                                    self._ts_sign_ctx(sign_lvl, xc, yc), sgn)
                    sign_map[yc, xc] = sgn
                if not self.enc and sb_coded:
                    if n <= pass2_pos:
                        lvl = int(pass2[yc, xc]) + 2 * rem_v
                    elif n <= pass1_pos:
                        lvl = int(pass1[yc, xc]) + 2 * rem_v
                    else:
                        lvl = rem_v
                    if lvl > 0:
                        a = unmap_level(lvl, xc, yc) if n <= pass1_pos \
                            else lvl
                        q[yc, xc] = -a if sign_map[yc, xc] else a

    @staticmethod
    def _ts_sign_ctx(sign_lvl, xc, yc):
        """coeff_sign_flag ctxInc in TS mode (bool_coder.rs:2373-2399),
        no BDPCM."""
        left = int(sign_lvl[yc, xc - 1]) if xc > 0 else 0
        above = int(sign_lvl[yc - 1, xc]) if yc > 0 else 0
        if (left == 0 and above == 0) or left == -above:
            return 0
        return 1 if (left >= 0 and above >= 0) else 2

    @staticmethod
    def _ts_gtx0_ctx(sig_map, xc, yc):
        """abs_level_gtx_flag j=0 ctxInc in TS mode
        (bool_coder.rs:2305-2320), no BDPCM."""
        inc = 64
        if xc > 0:
            inc += int(sig_map[yc, xc - 1])
        if yc > 0:
            inc += int(sig_map[yc - 1, xc])
        return inc

    # ------------------------------------------------ residual ctx helpers
    def _code_last_prefix_suffix(self, se_prefix, se_suffix, c_idx, log2_size,
                                 value):
        """last_sig_coeff_{x,y} prefix (TR, ctx) + suffix (FL bypass)."""
        c_max = (min(log2_size, 5) << 1) - 1

        def prefix_ctx(bin_idx):
            OFFSET_Y = [0, 0, 3, 6, 10, 15]
            if c_idx == 0:
                off = OFFSET_Y[log2_size - 1]
                shift = (log2_size + 1) >> 2
            else:
                off = 20
                shift = int(np.clip((1 << log2_size) >> 3, 0, 2))
            return (bin_idx >> shift) + off

        if self.enc:
            if value <= 3:
                prefix, suffix, suffix_bits = value, 0, 0
            else:
                suffix_bits = 1
                while True:
                    pre = value >> suffix_bits
                    if pre < 4:
                        break
                    suffix_bits += 1
                suffix = value - ((value >> suffix_bits) << suffix_bits)
                prefix = ((suffix_bits + 1) << 1) + ((value >> suffix_bits) & 1)
            for b_idx, b in enumerate(binarize.tr_bins(prefix, c_max, 0)):
                self._bin(se_prefix, prefix_ctx(b_idx), b)
            if prefix > 3:
                n = (prefix >> 1) - 1
                for b in binarize.fl_bins(suffix, (1 << n) - 1):
                    self._bypass(b)
            return value
        # decode
        prefix = 0
        while prefix < c_max and self.c.decode_bin(se_prefix, prefix_ctx(prefix)):
            prefix += 1
        if prefix <= 3:
            return prefix
        n = (prefix >> 1) - 1
        suffix = 0
        for _ in range(n):
            suffix = (suffix << 1) | self.c.decode_bypass()
        return (1 << n) * (2 + (prefix & 1)) + suffix

    def _sb_coded_ctx(self, sb_coded_map, sb_of, sx, sy, log2_nsb_w,
                      log2_nsb_h, c_idx):
        """sb_coded_flag ctxInc (bool_coder.rs:2102; non-TS path: right/below
        neighbours)."""
        csbf = 0
        if sx < (1 << log2_nsb_w) - 1:
            j = sb_of.get((sx + 1, sy))
            if j is not None:
                csbf += int(sb_coded_map[j])
        if sy < (1 << log2_nsb_h) - 1:
            j = sb_of.get((sx, sy + 1))
            if j is not None:
                csbf += int(sb_coded_map[j])
        csbf = min(csbf, 1)
        return csbf if c_idx == 0 else 2 + csbf

    def _local_template(self, xc, yc, log2_w, log2_h, m):
        """Sum over the (x+1,y),(x+2,y),(x+1,y+1),(x,y+1),(x,y+2) template."""
        w, h = 1 << log2_w, 1 << log2_h
        s = 0
        if xc < w - 1:
            s += int(m[yc, xc + 1])
            if xc < w - 2:
                s += int(m[yc, xc + 2])
            if yc < h - 1:
                s += int(m[yc + 1, xc + 1])
        if yc < h - 1:
            s += int(m[yc + 1, xc])
            if yc < h - 2:
                s += int(m[yc + 2, xc])
        return s

    def _loc_sums(self, xc, yc, log2_w, log2_h):
        sum_abs_p1 = self._local_template(xc, yc, log2_w, log2_h, self._pass1)
        num_sig = self._local_template(xc, yc, log2_w, log2_h,
                                       np.minimum(self._pass1, 1))
        return num_sig, sum_abs_p1

    def _sig_ctx(self, xc, yc, c_idx, log2_w, log2_h):
        """sig_coeff_flag ctxInc (bool_coder.rs:2246, non-TS)."""
        _, sum_p1 = self._loc_sums(xc, yc, log2_w, log2_h)
        d = xc + yc
        qs = max(self.q_state - 1, 0) if self.dep_quant else 0
        if c_idx == 0:
            return (12 * qs + min((sum_p1 + 1) >> 1, 3)
                    + (8 if d < 2 else 4 if d < 5 else 0))
        return 36 + 8 * qs + min((sum_p1 + 1) >> 1, 3) + (4 if d < 2 else 0)

    def _gtx_ctx(self, xc, yc, c_idx, log2_w, log2_h, j, last_x, last_y):
        """par_level_flag (j=None) / abs_level_gtx_flag ctxInc
        (bool_coder.rs:2292, non-TS)."""
        num_sig, sum_p1 = self._loc_sums(xc, yc, log2_w, log2_h)
        off = min(sum_p1 - num_sig, 4)
        d = xc + yc
        if xc == last_x and yc == last_y:
            inc = 0 if c_idx == 0 else 21
        elif c_idx == 0:
            inc = 1 + off + (15 if d == 0 else 10 if d < 3 else 5 if d < 10 else 0)
        else:
            inc = 22 + off + (5 if d == 0 else 0)
        if j == 1:
            inc += 32
        return inc

    def _rice_param(self, xc, yc, log2_w, log2_h, abs_level, base_level):
        """Rice parameter from the local absolute-level sum
        (bool_coder.rs:1133; Table 126)."""
        s = self._local_template(xc, yc, log2_w, log2_h, abs_level)
        s = int(np.clip(s - base_level * 5, 0, 31))
        return int(tables.C_RICE_PARAMS[s])

    def _code_abs_remainder(self, xc, yc, c_idx, log2_w, log2_h, abs_level,
                            value):
        rice = self._rice_param(xc, yc, log2_w, log2_h, abs_level, 4)
        return self._code_rice_escape(rice, value)

    def _code_dec_abs_level(self, xc, yc, log2_w, log2_h, abs_level, abs_val):
        rice = self._rice_param(xc, yc, log2_w, log2_h, abs_level, 0)
        zero_pos = (1 if self.q_state < 2 else 2) << rice if self.dep_quant \
            else 1 << rice
        if self.enc:
            v = abs_val
            if v == 0:
                dec = zero_pos
            elif zero_pos >= v:
                dec = v - 1
            else:
                dec = v
            self._code_rice_escape(rice, dec)
            return abs_val
        dec = self._code_rice_escape(rice, None)
        if dec == zero_pos:
            return 0
        return dec + 1 if dec < zero_pos else dec

    def _code_rice_escape(self, rice, value):
        """TR(6<<rice, rice) prefix with limited-EG(rice+1) escape — the
        abs_remainder / dec_abs_level binarization (bool_coder.rs:1384)."""
        c_max = 6 << rice
        if self.enc:
            prefix_val = min(c_max, value)
            bins = binarize.tr_bins(prefix_val, c_max, rice)
            for b in bins:
                self._bypass(b)
            if len(bins) == 6 and all(bins):
                for b in binarize.limited_egk_bins(value - c_max, rice + 1,
                                                   11, 15):
                    self._bypass(b)
            return value
        # decode
        val, prefix = binarize.read_tr(lambda i: self.c.decode_bypass(),
                                       self.c.decode_bypass, c_max, rice)
        if prefix == 6:
            val = c_max + binarize.read_limited_egk(self.c.decode_bypass,
                                                    rice + 1, 11, 15)
        return val
