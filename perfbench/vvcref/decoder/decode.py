"""Conformance decoder for the supported VVC subset.

Parses Annex-B streams produced by this framework (all-intra, QT-only,
CTU 32, 4:2:0 8-bit) and reconstructs pictures. This is the repo's
conformance oracle: encoder reconstruction must byte-match the decode
(the role VTM plays for the reference, scripts/intergration_test.sh).
"""
import numpy as np

from ..bitstream import nal
from ..bitstream.bitio import BitReader
from ..bitstream.headers import (ParsedParams, parse_pps, parse_ph, parse_sh,
                                 parse_sps)
from ..entropy.cabac import CabacDecoder
from ..entropy.structure import CtNode
from ..entropy.syntax import SliceSyntax, MODE_LT_CCLM
from ..spec import intra, quant, transform
from ..spec.avail import Availability


class Decoder:
    def __init__(self, use_native=True):
        """use_native: decode via the C++ fast path when available. The
        Python path below remains the independent oracle (the native
        decoder is equality-tested against it)."""
        self.p = ParsedParams()
        self.frames = []
        self.use_native = use_native

    def decode(self, data):
        """Decode an Annex-B byte stream; returns list of (Y, Cb, Cr)."""
        for nut, layer_id, rbsp in nal.parse_annexb(bytes(data)):
            if nut == nal.SPS_NUT:
                parse_sps(rbsp, self.p)
            elif nut == nal.PPS_NUT:
                parse_pps(rbsp, self.p)
            elif nut == nal.PH_NUT:
                parse_ph(rbsp, self.p)
            elif nut in (nal.IDR_W_RADL, nal.IDR_N_LP, nal.TRAIL_NUT):
                self._decode_slice(rbsp)
            # VPS / other NALs carry no decoding state we need
        return self.frames

    # ------------------------------------------------------------------
    def _decode_slice(self, rbsp):
        p = self.p
        r = BitReader(rbsp)
        parse_sh(r, p)
        W, H = p.width, p.height
        if self.use_native and not getattr(p, 'sao_luma_used', False) \
                and not getattr(p, 'sao_chroma_used', False):
            from ..entropy import native
            if native.decode_supported():
                res = native.decode_slice_native(
                    p, rbsp[r.byte_pos:], getattr(p, 'entry_lens', []))
                if res is not None:
                    self.frames.append(
                        tuple(pl.astype(np.uint8) for pl in res))
                    return
        self.recon = [np.zeros((H, W), dtype=np.int32),
                      np.zeros((H // 2, W // 2), dtype=np.int32),
                      np.zeros((H // 2, W // 2), dtype=np.int32)]
        self.avail = Availability(W, H, p.log2_ctu_size)
        cabac = CabacDecoder(r)
        syn = SliceSyntax(cabac, p, 'dec', on_cu=self._reconstruct_cu)
        self.syn = syn          # _reconstruct_cu reads the live QG QpY
        cs = 1 << p.log2_ctu_size
        n_cols, n_rows = W // cs, H // cs
        n_ctus = n_cols * n_rows
        wpp = p.entropy_coding_sync_enabled and n_rows > 1
        if not wpp:
            idx = 0
            for cy in range(0, H, cs):
                for cx in range(0, W, cs):
                    node = CtNode(cx, cy, p.log2_ctu_size)
                    syn.code_ctu(node, first_in_slice=(idx == 0))
                    end = cabac.decode_terminate()
                    last = (idx == n_ctus - 1)
                    assert end == (1 if last else 0), (idx, end)
                    idx += 1
        else:
            # WPP: one CABAC subset per CTU row, located via the slice
            # header entry points; contexts sync from the state stored
            # after the first CTU of the row above
            starts = [r.byte_pos]
            for ln in p.entry_lens:
                starts.append(starts[-1] + ln)
            assert len(starts) == n_rows, (len(p.entry_lens), n_rows)
            snap = None
            for row in range(n_rows):
                if row > 0:
                    r.pos = starts[row] * 8
                    cabac.ctx.restore(snap)
                    cabac.init_engine()
                for col in range(n_cols):
                    idx = row * n_cols + col
                    node = CtNode(col * cs, row * cs, p.log2_ctu_size)
                    syn.code_ctu(node, first_in_slice=(idx == 0))
                    if col == 0:
                        snap = cabac.ctx.snapshot()
                    end = cabac.decode_terminate()
                    want = 1 if (idx == n_ctus - 1 or col == n_cols - 1) \
                        else 0
                    assert end == want, (row, col, end)
        self.frames.append(tuple(pl.astype(np.uint8) for pl in self.recon))

    # ------------------------------------------------------------------
    def _reconstruct_cu(self, cu):
        p = self.p
        comps = [0] if cu.tree == 'L' else ([1, 2] if cu.tree == 'C'
                                            else [0, 1, 2])
        for c in comps:
            sh = 0 if c == 0 else 1
            cs = (1 << cu.log2) >> sh
            x, y = cu.x >> sh, cu.y >> sh
            log2 = cu.log2 - sh
            mode = cu.luma_mode if c == 0 else cu.chroma_mode
            size = 1 << cu.log2
            if c == 0 or mode < MODE_LT_CCLM:
                pred = intra.predict_block(self.recon[c], x, y, cs, cs,
                                           (cu.x, cu.y), (size, size),
                                           self.avail, c, mode)
            else:
                pred = intra.predict_cclm(mode, self.recon[0], self.recon[c],
                                          x, y, cs, cs, (cu.x, cu.y),
                                          self.avail, 1 << p.log2_ctu_size,
                                          p.bit_depth)
            q = cu.coeffs[c]
            if q is None or not (q != 0).any():
                rec = pred
            else:
                qp_y = self.syn.cur_qp_y      # per-QG QpY (spec 8.7.1)
                qp = qp_y if c == 0 else quant.chroma_qp_from_luma(qp_y)
                is_ts = bool(cu.ts[min(c, 2)]) if cu.ts else False
                qpar = quant.derive_quant_params(
                    qp, log2, log2, dep_quant=p.dep_quant_used,
                    transform_skip=is_ts, bit_depth=p.bit_depth)
                d = quant.dequantize(q, qpar)
                if is_ts:
                    # transform skip: residual = dequantized levels
                    # (spec 8.7.2; no inverse transform)
                    res = d
                else:
                    # explicit MTS (luma only; transformer.rs:1896-1903)
                    if c == 0 and cu.mts_idx:
                        th, tv = [(0, 0), (1, 1), (2, 1),
                                  (1, 2), (2, 2)][cu.mts_idx]
                    else:
                        th, tv = 0, 0
                    res = transform.inverse(d, th, tv, p.bit_depth)
                rec = np.clip(pred + res, 0, 255)
            self.recon[c][y:y + cs, x:x + cs] = rec


def decode_annexb(data, use_native=True):
    return Decoder(use_native=use_native).decode(data)
