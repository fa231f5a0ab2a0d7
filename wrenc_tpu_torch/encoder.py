"""Top-level encoder: search + entropy + bitstream assembly.

Produces Annex-B VVC streams (VPS/SPS/PPS, then per picture PH + one
I-slice), mirroring the reference's main loop (main.rs:117-403). A copy
of wrenc_tpu/encoder.py whose default search is this package's
WavefrontSearch (on the card); the scalar search (spec/encoder.py, host
only) runs when a caller passes it.
"""
import numpy as np

from . import trace
from .bitstream import nal
from .bitstream.bitio import BitWriter
from .bitstream.headers import write_pps, write_ph, write_sh, write_sps, write_vps
from .entropy.cabac import CabacEncoder
from .entropy.syntax import SliceSyntax


class Encoder:
    def __init__(self, cfg, search=None, use_native=None):
        self.cfg = cfg.validate()
        if search is None:
            from .search import WavefrontSearch
            search = WavefrontSearch(cfg)
        self.search = search
        if use_native is None:
            from .entropy import native
            use_native = native.available()
        self.use_native = use_native

    def encode(self, frames):
        """frames: list of (Y, Cb, Cr) uint8 planes.

        Returns (annexb_bytes, [reconstruction per frame]). The call is
        the root span `encode` of the recorder (trace.call), the slices'
        coding its span `host_entropy`.
        """
        with trace.call():
            cfg = self.cfg
            out = bytearray()
            nal.write_nal(out, 1, nal.VPS_NUT, write_vps(cfg))
            nal.write_nal(out, 9, nal.SPS_NUT, write_sps(cfg))
            nal.write_nal(out, 9, nal.PPS_NUT, write_pps(cfg))
            recons = []
            if hasattr(self.search, "encode_frames"):
                results = self.search.encode_frames(frames)
            else:
                results = [self.search.encode_frame(p) for p in frames]
            with trace.span('host_entropy') as sp:
                for poc, (trees, recon) in enumerate(results):
                    nal.write_nal(out, 9, nal.PH_NUT, write_ph(cfg, poc))
                    rbsp = self.encode_slice(trees)
                    nal.write_nal(out, 9, nal.IDR_W_RADL, rbsp)
                    recons.append(tuple(p.astype(np.uint8) for p in recon))
            # the search's per-call sums (seconds; 'n_' keys are counts)
            self.phase_times = dict(getattr(self.search, 'phase_times', {}))
            self.phase_times['host_entropy'] = sp.seconds
        return bytes(out), recons

    def encode_slice(self, trees):
        """Entropy-code one slice from per-CTU decision trees -> RBSP."""
        from .core.partition import single_layout
        cfg = self.cfg
        n_cols = cfg.width >> cfg.log2_ctu_size
        n_rows = cfg.height >> cfg.log2_ctu_size
        wpp = cfg.entropy_coding_sync_enabled and n_rows > 1
        if not wpp:
            w = BitWriter()
            write_sh(w, cfg, cfg.qp)
            # the native slice coder handles the production decision set;
            # transform-skip / SAO streams go through the Python syntax layer
            if (self.use_native and not cfg.transform_skip_search
                    and not cfg.sao_enabled
                    and not getattr(cfg, 'qp_delta_pattern', ())):
                from .entropy import native
                return w.bytes() + native.encode_slice_native(cfg, trees,
                                                              cfg.qp)
            cabac = CabacEncoder(w)
            syn = SliceSyntax(cabac, cfg, 'enc')
            # CTU coding order through the picture layout (tile scan;
            # 1 tile/slice/subpic at the operating point = raster)
            order = single_layout(n_cols, n_rows).ctu_order()
            n = len(order)
            for i, (cx, cy) in enumerate(order):
                syn.code_ctu(trees[cy * n_cols + cx],
                             first_in_slice=(i == 0))
                cabac.encode_terminate(1 if i == n - 1 else 0)
            w.byte_align()
            return w.bytes()
        return self._encode_slice_wpp(trees, n_cols, n_rows)

    def _encode_slice_wpp(self, trees, n_cols, n_rows):
        """WPP (entropy_coding_sync) slice: one CABAC subset per CTU row.

        Context state is stored after the first CTU of each row and the next
        row's contexts sync from it; each non-final row ends with
        end_of_subset_one_bit (terminate), an engine flush and byte
        alignment, and its byte length becomes a slice-header entry-point
        offset (slice_encoder.rs:302-333,380-411; bool_coder.rs:1096-1104).
        """
        cfg = self.cfg
        if self.use_native and not cfg.transform_skip_search \
                and not cfg.sao_enabled \
                and not getattr(cfg, 'qp_delta_pattern', ()):
            from .entropy import native
            if native.wpp_supported():
                lens, data = native.encode_slice_wpp_native(cfg, trees,
                                                            cfg.qp)
                w = BitWriter()
                write_sh(w, cfg, cfg.qp, entry_lens=lens)
                return w.bytes() + data
        sd = BitWriter()
        cabac = CabacEncoder(sd)
        syn = SliceSyntax(cabac, cfg, 'enc')
        marks = []
        snap = None
        for row in range(n_rows):
            if row > 0:
                cabac.init_engine()
                cabac.ctx.restore(snap)
            for col in range(n_cols):
                i = row * n_cols + col
                syn.code_ctu(trees[i], first_in_slice=(i == 0))
                if col == 0:
                    snap = cabac.ctx.snapshot()
                last_ctu = (i == len(trees) - 1)
                cabac.encode_terminate(
                    1 if (last_ctu or col == n_cols - 1) else 0)
            sd.byte_align()
            marks.append(len(sd._bytes))
        lens = [marks[r] - (marks[r - 1] if r else 0)
                for r in range(n_rows - 1)]
        w = BitWriter()
        write_sh(w, cfg, cfg.qp, entry_lens=lens)
        return w.bytes() + sd.bytes()
