"""Independent conformance decoder — the repo's second, clean-room oracle.

This module is deliberately written as a SEPARATE author-path from
`wrenc_tpu_torch.entropy` / `wrenc_tpu_torch.bitstream.headers`: its bit
reader, CABAC engine, header parsers, slice-data parser, context-increment derivations,
scan generation, MPM list, and neighbour availability share no code (and a
different structure) with the encoder's syntax layer. The behavioural spec
is the VVC standard as realised by the reference encoder, cited as
its src/ file:line throughout (the reference's output is
VTM-validated, so matching its syntax is the conformance bar in an
environment without VTM).

Reconstruction arithmetic (intra prediction, dequant, inverse transform)
reuses `wrenc_tpu_torch.spec.*` — the scalar golden model that is
independently golden-tested against the device kernels and the native library. The
parsing layer, where the encode->decode shared-source round trip is blind,
is fully independent.

Supported operating point (anything else raises ConformanceError):
all-intra, 4:2:0 8-bit, one tile/slice/subpicture, QT-only partitioning,
CTU 32, CCLM, dependent quantization, optional WPP. This mirrors the
reference's own operating point (sps.rs:229-347).
"""
import json
import os

import numpy as np

from ..spec import intra as spec_intra
from ..spec import quant as spec_quant
from ..spec import transform as spec_transform
from ..spec.avail import Availability


class ConformanceError(Exception):
    """Raised when the stream leaves the supported conformance subset or a
    parse invariant fails (the independent decoder's 'VTM would reject
    this' signal)."""


def _expect(cond, what):
    if not cond:
        raise ConformanceError(what)


# =========================================================================
# Bit reading (own implementation; MSB-first, ue(v)/se(v) per spec 9.2)
# =========================================================================

class Bits:
    def __init__(self, data):
        self.d = data
        self.n = len(data) * 8
        self.p = 0

    def u(self, k):
        v = 0
        for _ in range(k):
            _expect(self.p < self.n, "read past end of RBSP")
            v = (v << 1) | ((self.d[self.p >> 3] >> (7 - (self.p & 7))) & 1)
            self.p += 1
        return v

    def ue(self):
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            _expect(zeros < 32, "ue(v) too long")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self):
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def byte_align(self):
        while self.p & 7:
            self.p += 1

    @property
    def byte_pos(self):
        return self.p >> 3


# =========================================================================
# Annex-B framing (own implementation; spec B.2 + 7.4.1 emulation removal)
# =========================================================================

def split_annexb(data):
    """Yield (nal_unit_type, nuh_layer_id, rbsp_bytes) per NAL unit."""
    data = bytes(data)
    i, n = 0, len(data)
    starts = []
    while i + 2 < n:
        if data[i] == 0 and data[i + 1] == 0 and data[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    _expect(starts, "no start codes found")
    for k, s in enumerate(starts):
        e = (starts[k + 1] - 3) if k + 1 < len(starts) else n
        # trailing zero bytes before the next start code belong to framing
        while e > s and data[e - 1] == 0 and k + 1 < len(starts):
            e -= 1
        unit = data[s:e]
        _expect(len(unit) >= 2, "NAL unit shorter than its header")
        _expect(unit[0] >> 7 == 0, "forbidden_zero_bit set")
        layer_id = unit[0] & 0x3F
        nut = unit[1] >> 3
        # remove emulation prevention: 00 00 03 -> 00 00
        body = bytearray()
        z = 0
        j = 2
        while j < len(unit):
            b = unit[j]
            if z >= 2 and b == 3:
                z = 0
                j += 1
                continue
            body.append(b)
            z = z + 1 if b == 0 else 0
            j += 1
        yield nut, layer_id, bytes(body)


NUT_TRAIL, NUT_IDR_W_RADL, NUT_IDR_N_LP = 0, 7, 8
NUT_VPS, NUT_SPS, NUT_PPS, NUT_PH = 14, 15, 16, 19


# =========================================================================
# Parameter-set parsing (field order per the reference encoders, which are
# the VTM-validated realisation of spec 7.3.2: sps_encoder.rs:29-678,
# pps_encoder.rs:24-351, ph_encoder.rs:29-460, slice_encoder.rs:32-341)
# =========================================================================

class PS:
    """Flat store for everything the slice decoder needs."""
    pass


def _parse_gci(b):
    """general_constraints_info (gci_encoder.rs:24-111)."""
    if b.u(1):                       # gci_present_flag
        b.u(3)                       # intra_only / all_layers_indep / one_au
        b.u(4)                       # 16 - max bitdepth idc
        b.u(2)                       # 3 - max chroma format idc
        b.u(10)                      # NAL-unit-type constraints
        b.u(6)                       # tile/slice/subpic constraints
        b.u(2)                       # 3 - max log2 ctu size idc
        b.u(3)                       # partition constraints
        b.u(6)                       # intra-tool constraints
        b.u(16)                      # inter-tool constraints
        b.u(13)                      # transform/quant/residual constraints
        b.u(6)                       # loop-filter constraints
        nres = b.u(8)                # gci_num_reserved_bits
        b.u(nres)
    b.byte_align()


def _parse_ptl(b, max_sublayers, pt_present=True):
    """profile_tier_level (ptl_encoder.rs:25-70)."""
    if pt_present:
        b.u(7)                       # general_profile_idc
        b.u(1)                       # general_tier_flag
    b.u(8)                           # general_level_idc
    b.u(1)                           # ptl_frame_only_constraint_flag
    b.u(1)                           # ptl_multilayer_enabled_flag
    if pt_present:
        _parse_gci(b)
    sub_present = [b.u(1) for _ in range(max_sublayers - 1)]
    b.byte_align()
    for f in sub_present:
        if f:
            b.u(8)                   # sublayer_level_idc
    if pt_present:
        nsp = b.u(8)                 # ptl_num_sub_profiles
        for _ in range(nsp):
            b.u(32)


def _parse_dpb(b, max_sublayers, sublayer_info):
    lo = 0 if sublayer_info else max_sublayers - 1
    for _ in range(lo, max_sublayers):
        b.ue()                       # max_dec_pic_buffering_minus1? (as-is)
        b.ue()                       # max_num_reorder_pics
        b.ue()                       # max_latency_increase


def _parse_rpls(b, sps_long_term, sps_ilp, rpls_idx, num_rpl):
    """ref_pic_list_struct (rpl_encoder.rs:112-139)."""
    num_ref = b.ue()
    ltrp_in_header = False
    if sps_long_term and rpls_idx < num_rpl and num_ref > 0:
        ltrp_in_header = bool(b.u(1))
    for _ in range(num_ref):
        ilrp = bool(b.u(1)) if sps_ilp else False
        if not ilrp:
            st = bool(b.u(1)) if sps_long_term else True
            if st:
                abs_delta = b.ue()
                if abs_delta + 1 > 0:   # weighted pred off -> +1 form
                    b.u(1)              # strp_entry_sign_flag
            elif not ltrp_in_header:
                b.u(4)                  # rpls_poc_lsb_lt
        else:
            b.ue()                      # ilrp_idx


def parse_sps(rbsp, ps):
    """SPS per sps_encoder.rs:29-678 (strict field order)."""
    b = Bits(rbsp)
    b.u(4)                                   # sps id
    vps_id = b.u(4)
    max_sublayers = b.u(3) + 1
    ps.chroma_format = b.u(2)
    _expect(ps.chroma_format == 1, "only 4:2:0 supported")
    ps.log2_ctu_size = b.u(2) + 5
    _expect(ps.log2_ctu_size == 5, "only CTU 32 supported")
    ptl_present = bool(b.u(1))
    if ptl_present:
        _parse_ptl(b, max_sublayers)
    b.u(1)                                   # gdr_enabled
    if b.u(1):                               # ref_pic_resampling
        b.u(1)
    ps.width = b.ue()
    ps.height = b.ue()
    if b.u(1):                               # conformance window present
        b.ue(); b.ue(); b.ue(); b.ue()
    _expect(b.u(1) == 0, "subpic info unsupported")
    ps.bit_depth = b.ue() + 8
    _expect(ps.bit_depth == 8, "only 8-bit supported")
    ps.wpp = bool(b.u(1))
    ps.entry_points_present = bool(b.u(1))
    ps.log2_max_poc_lsb = b.u(4) + 4
    if b.u(1):                               # poc_msb_cycle
        b.ue()
    b.u(8 * b.u(2))                          # extra PH bits
    b.u(8 * b.u(2))                          # extra SH bits
    if ptl_present:
        if max_sublayers > 1:
            b.u(1)
        _parse_dpb(b, max_sublayers, False)
    ps.log2_min_cb = b.ue() + 2
    ps.partition_override = bool(b.u(1))
    ps.log2_diff_min_qt_min_cb_intra = b.ue()
    _expect(b.ue() == 0, "MTT partitioning unsupported")
    if ps.chroma_format != 0:
        _expect(b.u(1) == 0, "qtbtt dual tree intra unsupported")
    b.ue()                                   # min_qt_min_cb inter
    if b.ue() != 0:                          # mtt depth inter
        b.ue(); b.ue()
    ps.transform_skip_enabled = bool(b.u(1))
    ps.log2_ts_max = 0
    bdpcm = False
    if ps.transform_skip_enabled:
        ps.log2_ts_max = b.ue()
        bdpcm = bool(b.u(1))
        _expect(not bdpcm, "BDPCM unsupported")
    ps.mts_enabled = bool(b.u(1))
    ps.explicit_mts_intra = ps.explicit_mts_inter = False
    if ps.mts_enabled:
        ps.explicit_mts_intra = bool(b.u(1))
        ps.explicit_mts_inter = bool(b.u(1))
    _expect(b.u(1) == 0, "LFNST unsupported")
    if ps.chroma_format != 0:
        _expect(b.u(1) == 0, "joint CbCr unsupported")
        same_qp_table = bool(b.u(1))
        for _ in range(1 if same_qp_table else 2):
            b.se()                           # qp_table_start_minus26
            for _ in range(b.ue() + 1):
                b.ue(); b.ue()
    ps.sao_enabled = bool(b.u(1))
    _expect(b.u(1) == 0, "ALF unsupported")
    _expect(b.u(1) == 0, "LMCS unsupported")
    b.u(1); b.u(1)                           # weighted pred / bipred
    long_term = bool(b.u(1))
    ilp = False
    if vps_id > 0:                           # sps_encoder.rs:620-623
        ilp = bool(b.u(1))
        _expect(not ilp, "inter-layer prediction unsupported")
    ps.idr_rpl_present = bool(b.u(1))
    rpl1_same = bool(b.u(1))
    for i in range(1 if rpl1_same else 2):
        num_rpl = b.ue()
        for j in range(num_rpl):
            _parse_rpls(b, long_term, ilp, j, num_rpl)
    b.u(1)                                   # ref_wraparound
    if b.u(1):                               # temporal mvp
        b.u(1)
    amvr = bool(b.u(1))
    if b.u(1):                               # bdof
        b.u(1)
    b.u(1)                                   # smvd
    if b.u(1):                               # dmvr
        b.u(1)
    if b.u(1):                               # mmvd
        b.u(1)
    six_minus_mmc = b.ue()
    max_num_merge_cand = 6 - six_minus_mmc
    b.u(1)                                   # sbt
    if b.u(1):                               # affine
        b.ue(); b.u(1)
        if amvr:
            b.u(1)
        if b.u(1):                           # affine prof
            b.u(1)
    b.u(1); b.u(1)                           # bcw, ciip
    if max_num_merge_cand >= 2:
        gpm = bool(b.u(1))
        if gpm and max_num_merge_cand >= 3:
            b.ue()
    b.ue()                                   # log2_parallel_merge_level-2
    _expect(b.u(1) == 0, "ISP unsupported")
    _expect(b.u(1) == 0, "MRL unsupported")
    _expect(b.u(1) == 0, "MIP unsupported")
    if ps.chroma_format != 0:
        ps.cclm_enabled = bool(b.u(1))
    if ps.chroma_format == 1:
        ps.chroma_h_collocated = bool(b.u(1))
        ps.chroma_v_collocated = bool(b.u(1))
    _expect(b.u(1) == 0, "palette unsupported")
    # act: only for 4:4:4
    if ps.transform_skip_enabled:
        b.ue()                               # min_qp_prime_ts
    _expect(b.u(1) == 0, "IBC unsupported")
    _expect(b.u(1) == 0, "LADF unsupported")
    _expect(b.u(1) == 0, "explicit scaling list unsupported")
    ps.dep_quant_enabled = bool(b.u(1))
    ps.sdh_enabled = bool(b.u(1))
    _expect(b.u(1) == 0, "virtual boundaries unsupported")
    if ptl_present:
        _expect(b.u(1) == 0, "timing/HRD unsupported")
    b.u(1)                                   # field_seq
    _expect(b.u(1) == 0, "VUI unsupported")
    _expect(b.u(1) == 0, "SPS extension unsupported")
    _expect(b.u(1) == 1, "missing rbsp_stop_one_bit in SPS")


def parse_pps(rbsp, ps):
    """PPS per pps_encoder.rs:24-351 (strict field order)."""
    b = Bits(rbsp)
    b.u(6); b.u(4)                           # pps id, sps id
    b.u(1)                                   # mixed_nalu_types
    w = b.ue()
    h = b.ue()
    _expect(w == ps.width and h == ps.height, "PPS/SPS size mismatch")
    if b.u(1):                               # conformance window
        b.ue(); b.ue(); b.ue(); b.ue()
    _expect(b.u(1) == 0, "scaling window unsupported")
    b.u(1)                                   # output_flag_present
    no_partition = bool(b.u(1))
    _expect(no_partition, "tiles/rect slices unsupported")
    _expect(b.u(1) == 0, "subpic id mapping unsupported")
    b.u(1)                                   # cabac_init_present
    b.ue(); b.ue()                           # num_ref_idx defaults
    b.u(1)                                   # rpl1_idx_present
    b.u(1); b.u(1)                           # weighted pred/bipred
    if b.u(1):                               # ref wraparound
        b.ue()
    ps.init_qp = b.se() + 26
    ps.cu_qp_delta_enabled = bool(b.u(1))
    if b.u(1):                               # chroma tool offsets present
        ps.cb_qp_offset = b.se()
        ps.cr_qp_offset = b.se()
        if b.u(1):
            b.se()
        b.u(1)                               # slice_chroma_qp_offsets
        _expect(b.u(1) == 0, "cu chroma qp offset list unsupported")
    else:
        ps.cb_qp_offset = ps.cr_qp_offset = 0
    if b.u(1):                               # deblocking control present
        b.u(1)                               # override enabled
        dbf_disabled = bool(b.u(1))
        _expect(dbf_disabled, "deblocking unsupported")
        # no_pic_partition -> no dbf_info_in_ph flag; disabled -> no offsets
    # no_pic_partition -> no *_info_in_ph flags
    b.u(1)                                   # ph extension present
    b.u(1)                                   # sh extension present
    _expect(b.u(1) == 0, "PPS extension unsupported")
    _expect(b.u(1) == 1, "missing rbsp_stop_one_bit in PPS")


def parse_ph(rbsp, ps):
    """PH per ph_encoder.rs:29-460, at this operating point."""
    b = Bits(rbsp)
    b.u(1)                                   # gdr_or_irap
    b.u(1)                                   # non_ref_pic
    # gdr_pic_flag present iff gdr_or_irap: re-read properly
    b.p = 0
    gdr_or_irap = bool(b.u(1))
    b.u(1)
    if gdr_or_irap:
        _expect(b.u(1) == 0, "GDR unsupported")
    inter_allowed = bool(b.u(1))
    ps.intra_allowed = True
    if inter_allowed:
        ps.intra_allowed = bool(b.u(1))
    _expect(not inter_allowed, "inter slices unsupported")
    b.ue()                                   # pps id
    ps.poc_lsb = b.u(ps.log2_max_poc_lsb)
    if ps.partition_override:
        _expect(b.u(1) == 0, "partition override unsupported")
    # intra allowed:
    if ps.cu_qp_delta_enabled:
        ps.cu_qp_delta_subdiv = b.ue()
        _expect(ps.cu_qp_delta_subdiv == 0,
                "cu_qp_delta_subdiv != 0 unsupported")
    _expect(b.u(1) == 1, "missing rbsp_stop_one_bit in PH")


def parse_sh(b, ps):
    """Slice header per slice_encoder.rs:32-341; b positioned at RBSP
    start. Returns after the byte alignment (CABAC payload follows)."""
    _expect(b.u(1) == 0, "PH-in-SH unsupported")
    # one slice/tile/subpic, no extra bits -> nothing until nal-type block
    # IDR: no_output_of_prior_pics_flag
    b.u(1)
    if ps.idr_rpl_present:
        raise ConformanceError("IDR RPL unsupported")
    ps.slice_qp = ps.init_qp + b.se()        # sh.qp_delta
    ps.sao_luma_used = ps.sao_chroma_used = False
    if ps.sao_enabled:                        # slice_encoder.rs:232-239
        ps.sao_luma_used = bool(b.u(1))
        ps.sao_chroma_used = bool(b.u(1))
    ps.dep_quant_used = bool(b.u(1)) if ps.dep_quant_enabled else False
    ps.sdh_used = False
    if ps.sdh_enabled and not ps.dep_quant_used:
        ps.sdh_used = bool(b.u(1))
    ps.ts_residual_disabled = False
    if (ps.transform_skip_enabled and not ps.dep_quant_used
            and not ps.sdh_used):
        ps.ts_residual_disabled = bool(b.u(1))
    # entry points
    ps.entry_lens = []
    n_rows = ps.height >> ps.log2_ctu_size
    n_entry = (n_rows - 1) if (ps.entry_points_present and ps.wpp
                               and n_rows > 1) else 0
    if n_entry > 0:
        off_len = b.ue() + 1
        ps.entry_lens = [b.u(off_len) + 1 for _ in range(n_entry)]
    _expect(b.u(1) == 1, "missing byte_alignment bit in SH")
    b.byte_align()


# =========================================================================
# CABAC arithmetic decoding engine (own implementation; spec 9.3.4.3)
# =========================================================================

_DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "core", "data")
with open(os.path.join(_DATA, "cabac_init.json")) as _f:
    _CABJ = json.load(_f)

# syntax-element ids matching the reference CabacContext enum
# (cabac_contexts.rs:16-128); used only to index the Table-51 json data
SAO_MERGE, SAO_TYPE_LUMA, SAO_TYPE_CHROMA = 7, 9, 10
SPLIT_CU, MPM_FLAG, NOT_PLANAR = 16, 34, 35
CCLM_FLAG, CCLM_IDX, CHROMA_MODE = 40, 41, 42
MTS_IDX = 67
Y_CBF, CB_CBF, CR_CBF, QP_DELTA_ABS, TS_FLAG = 87, 88, 89, 90, 94
LAST_X_PREF, LAST_Y_PREF = 96, 97
SB_CODED, SIG_COEFF, PAR_LEVEL, GTX_FLAG = 100, 101, 102, 103
SIGN_FLAG = 106

_RICE_TABLE = (0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 2, 2,
               2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3)

_Q_NEXT = ((0, 2), (2, 0), (1, 3), (3, 1))   # spec Table 125


class Arith:
    """Arithmetic decoder + context models (spec 9.3.2.2, 9.3.4.3)."""

    def __init__(self, bits, trace=None):
        self.b = bits
        self.trace = trace
        self.s0 = {}
        self.s1 = {}
        self.sh = {}
        self.range = 0
        self.offset = 0

    def init_contexts(self, slice_qp):
        qp = min(max(slice_qp, 0), 63)
        for se, ent in enumerate(_CABJ["ctx_table"]):
            if ent is None:
                continue
            init = ent["init"][0]     # initType 0 = I slice
            shift = ent["shift"][0]
            n = len(init)
            s0 = np.zeros(n, dtype=np.int64)
            s1 = np.zeros(n, dtype=np.int64)
            for i, iv in enumerate(init):
                m = (iv >> 3) - 4
                off = (iv & 7) * 18 + 1
                pre = min(max(((m * (qp - 16)) >> 1) + off, 1), 127)
                s0[i] = pre << 3
                s1[i] = pre << 7
            self.s0[se] = s0
            self.s1[se] = s1
            self.sh[se] = np.array(shift, dtype=np.int64)

    def snapshot(self):
        return ({k: v.copy() for k, v in self.s0.items()},
                {k: v.copy() for k, v in self.s1.items()})

    def restore(self, snap):
        self.s0 = {k: v.copy() for k, v in snap[0].items()}
        self.s1 = {k: v.copy() for k, v in snap[1].items()}

    def start(self):
        self.range = 510
        self.offset = self.b.u(9)

    def _renorm(self):
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.b.u(1)

    def bin(self, se, inc, name=""):
        s0, s1 = int(self.s0[se][inc]), int(self.s1[se][inc])
        p_state = s1 + 16 * s0
        val_mps = p_state >> 14
        q = self.range >> 5
        lps = ((q * ((32767 - p_state if val_mps else p_state) >> 9)) >> 1) + 4
        self.range -= lps
        if self.offset >= self.range:
            v = 1 - val_mps
            self.offset -= self.range
            self.range = lps
        else:
            v = val_mps
        self._renorm()
        sidx = int(self.sh[se][inc])
        sh0 = (sidx >> 2) + 2
        sh1 = (sidx & 3) + 3 + sh0
        self.s0[se][inc] = s0 - (s0 >> sh0) + ((1023 * v) >> sh0)
        self.s1[se][inc] = s1 - (s1 >> sh1) + ((16383 * v) >> sh1)
        if self.trace is not None:
            self.trace.append((se, inc, v, name))
        return v

    def bypass(self, name=""):
        self.offset = (self.offset << 1) | self.b.u(1)
        _expect(self.offset < 1024, "bypass offset overflow (desync)")
        if self.offset >= self.range:
            self.offset -= self.range
            v = 1
        else:
            v = 0
        if self.trace is not None:
            self.trace.append((-1, -1, v, name))
        return v

    def terminate(self):
        self.range -= 2
        if self.offset >= self.range:
            return 1
        self._renorm()
        return 0


# =========================================================================
# Slice-data parsing + reconstruction
# =========================================================================

def _diag_positions(w, h):
    """Up-right diagonal scan: by anti-diagonal, bottom-left to top-right
    (spec 6.5.2) — formulated as a sort rather than the generator loop."""
    return sorted(((x, y) for y in range(h) for x in range(w)),
                  key=lambda p: (p[0] + p[1], p[0]))


def _mpm_list(cand_a, cand_b):
    """Luma MPM candidate list (spec 8.4.2), excluding implicit PLANAR.

    Written from the spec's case analysis; behavioural check vs
    ctu.rs:1498-1635."""
    def adj(m, d):
        return 2 + (m + d) % 64
    if cand_a == cand_b and cand_a > 1:
        return [cand_a, adj(cand_a, 61), adj(cand_a, -1),
                adj(cand_a, 60), adj(cand_a, 0)]
    if cand_a != cand_b and (cand_a > 1 or cand_b > 1):
        lo, hi = min(cand_a, cand_b), max(cand_a, cand_b)
        if lo > 1:
            d = hi - lo
            if d == 1:
                rest = [adj(lo, 61), adj(hi, -1), adj(lo, 60)]
            elif d >= 62:
                rest = [adj(lo, -1), adj(hi, 61), adj(lo, 0)]
            elif d == 2:
                rest = [adj(lo, -1), adj(lo, 61), adj(hi, -1)]
            else:
                rest = [adj(lo, 61), adj(lo, -1), adj(hi, 61)]
            return [cand_a, cand_b] + rest
        return [hi, adj(hi, 61), adj(hi, -1), adj(hi, 60), adj(hi, 0)]
    return [1, 50, 18, 46, 54]


class SliceDecoder:
    def __init__(self, ps, trace=None):
        self.ps = ps
        W, H = ps.width, ps.height
        self.W, self.H = W, H
        self.y = np.zeros((H, W), dtype=np.int32)
        self.cb = np.zeros((H // 2, W // 2), dtype=np.int32)
        self.cr = np.zeros((H // 2, W // 2), dtype=np.int32)
        n4w, n4h = W >> 2, H >> 2
        self.done4 = np.zeros((n4h, n4w), dtype=bool)     # luma CU decoded
        self.lmode4 = np.zeros((n4h, n4w), dtype=np.int32)
        self.cbw4 = np.zeros((n4h, n4w), dtype=np.int32)  # decoded CB dims
        self.cbh4 = np.zeros((n4h, n4w), dtype=np.int32)
        self.trace = trace
        self.a = None
        # prediction-side availability oracle (shared spec model)
        self.avail = Availability(W, H, ps.log2_ctu_size)
        self.min_qt = max(ps.log2_min_cb,
                          ps.log2_min_cb + ps.log2_diff_min_qt_min_cb_intra)
        # QG QP state (spec 8.7.1, QG == CTU since cu_qp_delta_subdiv=0):
        # at CTU granularity the A/B neighbours are always outside the
        # current CTB so the prediction is qP_Y_PREV, except at a CTB-row
        # start where the above QG's QP applies (quantizer.rs:95-234)
        self.qp_y_prev = ps.slice_qp
        self.qg_pred_qp = ps.slice_qp
        self.qg_delta = 0
        self.cur_qp_y = ps.slice_qp
        self.qg_qp_col0 = np.full(max(H // (1 << ps.log2_ctu_size), 1),
                                  ps.slice_qp, dtype=np.int32)

    # ----------------------------------------------------------- neighbours
    def _decoded(self, x, y):
        """Syntax-side availability: inside the picture and already
        decoded (spec 6.4.4 with everything in one slice/tile)."""
        if x < 0 or y < 0 or x >= self.W or y >= self.H:
            return False
        return bool(self.done4[y >> 2, x >> 2])

    # ------------------------------------------------------------------ run
    def run(self, payload):
        ps = self.ps
        cs = 1 << ps.log2_ctu_size
        cols, rows = self.W // cs, self.H // cs
        wpp = ps.wpp and rows > 1 and ps.entry_lens
        bits = Bits(payload)
        self.a = Arith(bits, trace=self.trace)
        starts = [0]
        for ln in (ps.entry_lens or []):
            starts.append(starts[-1] + ln)
        if wpp:
            _expect(len(starts) == rows, "entry point count != CTU rows")
        snap = None
        idx = 0
        for r in range(rows):
            if r == 0:
                self.a.init_contexts(ps.slice_qp)
                self.a.start()
            elif wpp:
                bits.p = starts[r] * 8
                self.a.restore(snap)
                self.a.start()
            for c in range(cols):
                self.ctu(c * cs, r * cs)
                if wpp and c == 0:
                    snap = self.a.snapshot()
                end = self.a.terminate()
                last = idx == rows * cols - 1
                want = 1 if (last or (wpp and c == cols - 1)) else 0
                _expect(end == want,
                        f"end_of_subset bit mismatch at CTU {idx}")
                idx += 1
        return (np.clip(self.y, 0, 255).astype(np.uint8),
                np.clip(self.cb, 0, 255).astype(np.uint8),
                np.clip(self.cr, 0, 255).astype(np.uint8))

    # ------------------------------------------------------------------ CTU
    def ctu(self, x, y):
        self.qp_delta_pending = True
        cs = 1 << self.ps.log2_ctu_size
        cx, cy = x // cs, y // cs
        if cx == 0 and cy > 0:
            # first QG in a CTB row: predict from the above QG
            self.qg_pred_qp = int(self.qg_qp_col0[cy - 1])
        else:
            self.qg_pred_qp = self.qp_y_prev
        self.qg_delta = 0
        self.cur_qp_y = self.qg_pred_qp
        if (getattr(self.ps, 'sao_luma_used', False)
                or getattr(self.ps, 'sao_chroma_used', False)):
            self.parse_sao(x >> self.ps.log2_ctu_size,
                           y >> self.ps.log2_ctu_size)
        self.tree(x, y, self.ps.log2_ctu_size, tree='S')
        # finalize the QG's QpY (CuQpDeltaVal = 0 when none was coded)
        qpy = (self.qg_pred_qp + self.qg_delta + 64) % 64
        self.qp_y_prev = qpy
        if cx == 0:
            self.qg_qp_col0[cy] = qpy

    def parse_sao(self, rx, ry):
        """SAO parameters (spec 7.3.11.3; ctu_encoder.rs:2611-2730). The
        filter is not applied (the encoder under test emits parameters but
        never filters, matching the reference's syntax-only SAO)."""
        a = self.a
        ps = self.ps
        if not hasattr(self, 'sao_store'):
            self.sao_store = {}
        params = {"type": [0, 0], "abs": [[0] * 4 for _ in range(3)],
                  "sign": [[0] * 4 for _ in range(3)], "band": [0, 0, 0],
                  "eo": [0, 0]}
        merge_left = merge_up = 0
        if rx > 0:
            merge_left = a.bin(SAO_MERGE, 0, "sao_merge_left_flag")
        if ry > 0 and not merge_left:
            merge_up = a.bin(SAO_MERGE, 0, "sao_merge_up_flag")
        if merge_left or merge_up:
            self.sao_store[(rx, ry)] = self.sao_store[
                (rx - 1, ry) if merge_left else (rx, ry - 1)]
            return
        n_comp = 3 if ps.chroma_format != 0 else 1
        for c in range(n_comp):
            if not ((ps.sao_luma_used and c == 0)
                    or (ps.sao_chroma_used and c > 0)):
                continue
            if c in (0, 1):
                se = SAO_TYPE_LUMA if c == 0 else SAO_TYPE_CHROMA
                t = 0
                if a.bin(se, 0, "sao_type_idx"):
                    t = 2 if a.bypass("sao_type_idx") else 1
                params["type"][0 if c == 0 else 1] = t
            t = params["type"][0 if c == 0 else 1]
            if t:
                for i in range(4):
                    v = 0
                    while v < 7 and a.bypass("sao_offset_abs"):
                        v += 1
                    params["abs"][c][i] = v
                if t == 1:
                    for i in range(4):
                        if params["abs"][c][i]:
                            params["sign"][c][i] = a.bypass("sao_sign")
                    bp = 0
                    for _ in range(5):
                        bp = (bp << 1) | a.bypass("sao_band_position")
                    params["band"][c] = bp
                elif c in (0, 1):
                    params["eo"][0 if c == 0 else 1] = \
                        (a.bypass("sao_eo_class") << 1) | \
                        a.bypass("sao_eo_class")
        self.sao_store[(rx, ry)] = params

    def tree(self, x, y, log2, tree):
        size = 1 << log2
        allow_qt = tree != 'C' and size > (1 << self.min_qt)
        split = False
        if allow_qt:
            # ctxInc (bool_coder.rs:2689-2744): cond = neighbour CB smaller
            avail_l = self._decoded(x - 1, y)
            avail_a = self._decoded(x, y - 1)
            inc = 0
            if avail_l and self.cbh4[y >> 2, (x - 1) >> 2] < size:
                inc += 1
            if avail_a and self.cbw4[(y - 1) >> 2, x >> 2] < size:
                inc += 1
            split = bool(self.a.bin(SPLIT_CU, inc, "split_cu_flag"))
        if split:
            half = size >> 1
            scipu = (tree == 'S' and size == 8
                     and self.ps.chroma_format == 1)
            child_tree = 'L' if scipu else tree
            for i in range(4):
                self.tree(x + (i & 1) * half, y + (i >> 1) * half,
                          log2 - 1, child_tree)
            if scipu:
                self.cu(x, y, log2, 'C')
        else:
            self.cu(x, y, log2, tree)

    # ------------------------------------------------------------------- CU
    def cu(self, x, y, log2, tree):
        size = 1 << log2
        luma_mode = chroma_mode = None
        if tree != 'C':
            luma_mode = self.luma_mode(x, y, size)
        if tree != 'L':
            if tree == 'C':
                cx, cy = x + size // 2, y + size // 2
                derived = int(self.lmode4[cy >> 2, cx >> 2])
            else:
                derived = luma_mode
            chroma_mode = self.chroma_mode(derived)
        if tree != 'C':
            x4, yy4, n = x >> 2, y >> 2, max(size >> 2, 1)
            self.lmode4[yy4:yy4 + n, x4:x4 + n] = luma_mode
            self.cbw4[yy4:yy4 + n, x4:x4 + n] = size
            self.cbh4[yy4:yy4 + n, x4:x4 + n] = size
        self.tu(x, y, log2, tree, luma_mode, chroma_mode)
        if tree != 'C':
            x4, yy4, n = x >> 2, y >> 2, max(size >> 2, 1)
            self.done4[yy4:yy4 + n, x4:x4 + n] = True

    def luma_mode(self, x, y, size):
        """intra_luma_mpm syntax + spec 8.4.2 mode reconstruction."""
        a = self.a
        # candA: left (x-1, y+size-1); candB: above (x+size-1, y-1),
        # above only within the same CTU row (spec 8.4.2)
        cand_a = cand_b = 0
        lx, ly = x - 1, y + size - 1
        if self._decoded(lx, ly):
            cand_a = int(self.lmode4[ly >> 2, lx >> 2])
        ax, ay = x + size - 1, y - 1
        ctu_top = (y >> self.ps.log2_ctu_size) << self.ps.log2_ctu_size
        if ay >= ctu_top and self._decoded(ax, ay):
            cand_b = int(self.lmode4[ay >> 2, ax >> 2])
        cands = _mpm_list(cand_a, cand_b)

        if a.bin(MPM_FLAG, 0, "intra_luma_mpm_flag"):
            # not_planar ctxInc = !ISP = 1 (bool_coder.rs:2425)
            if a.bin(NOT_PLANAR, 1, "intra_luma_not_planar_flag"):
                idx = 0
                while idx < 4 and a.bypass("intra_luma_mpm_idx"):
                    idx += 1
                return cands[idx]
            return 0
        # remainder: TB(60) -> k=5, u=2^6-61=3 (spec 9.3.3.8)
        k, u = 5, 3
        v = 0
        for _ in range(k):
            v = (v << 1) | a.bypass("intra_luma_mpm_remainder")
        if v >= u:
            v = (v << 1) | a.bypass("intra_luma_mpm_remainder")
            v -= u
        mode = v + 1
        for c in sorted(cands):
            if mode >= c:
                mode += 1
        return mode

    def chroma_mode(self, derived):
        a = self.a
        if getattr(self.ps, 'cclm_enabled', True):
            if a.bin(CCLM_FLAG, 0, "cclm_mode_flag"):
                if a.bin(CCLM_IDX, 0, "cclm_mode_idx"):
                    return 82 + a.bypass("cclm_mode_idx")
                return 81
        if a.bin(CHROMA_MODE, 0, "intra_chroma_pred_mode"):
            idx = (a.bypass("intra_chroma_pred_mode") << 1) | \
                a.bypass("intra_chroma_pred_mode")
            base = (0, 50, 18, 1)[idx]
            return 66 if derived == base else base
        return derived

    # ------------------------------------------------------------------- TU
    def tu(self, x, y, log2, tree, luma_mode, chroma_mode):
        a = self.a
        ps = self.ps
        size = 1 << log2
        self.mts_dc_only = True
        self.mts_zero_out = True
        cb_cbf = cr_cbf = y_cbf = 0
        if tree != 'L':
            cb_cbf = a.bin(CB_CBF, 0, "tu_cb_coded_flag")
            cr_cbf = a.bin(CR_CBF, 1 if cb_cbf else 0, "tu_cr_coded_flag")
        if tree != 'C':
            y_cbf = a.bin(Y_CBF, 0, "tu_y_coded_flag")
        if ((y_cbf or cb_cbf or cr_cbf) and tree != 'C'
                and ps.cu_qp_delta_enabled and self.qp_delta_pending):
            # full binarization: TR(5) prefix (bin0 ctx0, rest ctx1) +
            # EG0 bypass suffix + bypass sign (spec 9.3.3)
            v = 0
            while v < 5 and a.bin(QP_DELTA_ABS, 0 if v == 0 else 1,
                                  "cu_qp_delta_abs"):
                v += 1
            if v == 5:
                pre = 0
                while a.bypass("cu_qp_delta_abs_eg"):
                    pre += 1
                suf = 0
                for _ in range(pre):
                    suf = (suf << 1) | a.bypass("cu_qp_delta_abs_eg")
                v += (1 << pre) - 1 + suf
            sign = a.bypass("cu_qp_delta_sign") if v else 0
            self.qg_delta = -v if sign else v
            self.cur_qp_y = (self.qg_pred_qp + self.qg_delta + 64) % 64
            self.qp_delta_pending = False
        qy = qcb = qcr = None
        ts = [0, 0, 0]
        max_ts = 1 << ps.log2_ts_max
        if y_cbf and tree != 'C':
            if ps.transform_skip_enabled and size <= max_ts:
                ts[0] = a.bin(TS_FLAG, 0, "transform_skip_flag")
            qy = (self.residual_ts(log2, log2, 0) if ts[0]
                  else self.residual(log2, log2, 0))
        if cb_cbf and tree != 'L':
            csz = size >> 1
            if ps.transform_skip_enabled and csz <= max_ts:
                ts[1] = a.bin(TS_FLAG, 1, "transform_skip_flag")
            qcb = (self.residual_ts(log2 - 1, log2 - 1, 1) if ts[1]
                   else self.residual(log2 - 1, log2 - 1, 1))
        if cr_cbf and tree != 'L':
            csz = size >> 1
            if ps.transform_skip_enabled and csz <= max_ts:
                ts[2] = a.bin(TS_FLAG, 1, "transform_skip_flag")
            qcr = (self.residual_ts(log2 - 1, log2 - 1, 2) if ts[2]
                   else self.residual(log2 - 1, log2 - 1, 2))
        # mts_idx (ctu_encoder.rs:1292-1319; spec 7.3.11.5)
        mts = 0
        if (tree != 'C' and ps.explicit_mts_intra and size <= 32
                and not ts[0]
                and self.mts_zero_out and not self.mts_dc_only):
            while mts < 4 and a.bin(MTS_IDX, mts, "mts_idx"):
                mts += 1
        # reconstruct
        if tree != 'C':
            self.reconstruct(0, x, y, log2, luma_mode, qy, mts, ts[0])
        if tree != 'L':
            self.reconstruct(1, x, y, log2, chroma_mode, qcb, 0, ts[1])
            self.reconstruct(2, x, y, log2, chroma_mode, qcr, 0, ts[2])

    # ------------------------------------------------------------ residual
    def residual(self, log2w, log2h, c_idx):
        """residual_coding per spec 7.3.11.11 (non-TS), dep-quant aware.

        Returns the stored quantized levels q (the dequantizer input),
        reconstructed from AbsLevel + sign + q_state parity
        (ctu_encoder.rs:1786-2270)."""
        a = self.a
        w, h = 1 << log2w, 1 << log2h
        dq = self.ps.dep_quant_used
        # scans
        log2sb = 2 if min(log2w, log2h) >= 2 else 1
        sbw, sbh = 1 << log2sb, 1 << log2sb
        in_sb = _diag_positions(sbw, sbh)
        sbs = _diag_positions(w >> log2sb, h >> log2sb)
        nsbc = sbw * sbh

        last_x = self._last_pos(LAST_X_PREF, c_idx, log2w)
        last_y = self._last_pos(LAST_Y_PREF, c_idx, log2h)
        _expect(last_x < w and last_y < h, "last position out of range")

        sb_index = {p: i for i, p in enumerate(sbs)}
        last_sb = sb_index[(last_x >> log2sb, last_y >> log2sb)]
        last_pos = in_sb.index((last_x & (sbw - 1), last_y & (sbh - 1)))

        if c_idx == 0 and (last_sb > 0 or last_pos > 0):
            self.mts_dc_only = False

        pass1 = np.zeros((h, w), dtype=np.int64)
        abs_lv = np.zeros((h, w), dtype=np.int64)
        q = np.zeros((h, w), dtype=np.int16)
        sb_coded_flags = np.zeros(len(sbs), dtype=bool)
        rem_bins = (w * h * 7) >> 2
        q_state = 0

        for i in range(last_sb, -1, -1):
            sx, sy = sbs[i]
            ox, oy = sx << log2sb, sy << log2sb
            q_state_at_sb = q_state
            infer_dc = False
            if 0 < i < last_sb:
                nb = 0
                if (sx + 1, sy) in sb_index:
                    nb += int(sb_coded_flags[sb_index[(sx + 1, sy)]])
                if (sx, sy + 1) in sb_index:
                    nb += int(sb_coded_flags[sb_index[(sx, sy + 1)]])
                inc = min(nb, 1) + (0 if c_idx == 0 else 2)
                coded = bool(a.bin(SB_CODED, inc, "sb_coded_flag"))
                infer_dc = True
            else:
                coded = True
            sb_coded_flags[i] = coded
            if coded and (sx > 3 or sy > 3) and c_idx == 0:
                self.mts_zero_out = False

            levels = np.zeros(nsbc, dtype=np.int64)
            first0 = last_pos if i == last_sb else nsbc - 1
            first1 = first0
            n = first0
            while n >= 0 and rem_bins >= 4:
                xc, yc = ox + in_sb[n][0], oy + in_sb[n][1]
                is_last = (xc == last_x and yc == last_y)
                if coded and (n > 0 or not infer_dc) and not is_last:
                    sig = a.bin(SIG_COEFF,
                                self._sig_inc(pass1, xc, yc, c_idx, w, h,
                                              q_state, dq),
                                "sig_coeff_flag")
                    rem_bins -= 1
                    if sig:
                        infer_dc = False
                else:
                    sig = 1 if (is_last or (in_sb[n] == (0, 0) and infer_dc
                                            and coded)) else 0
                gt0 = par = gt1 = 0
                if sig:
                    gt0 = a.bin(GTX_FLAG,
                                self._gtx_inc(pass1, xc, yc, c_idx, w, h,
                                              0, last_x, last_y),
                                "abs_level_gtx_flag0")
                    rem_bins -= 1
                    if gt0:
                        par = a.bin(PAR_LEVEL,
                                    self._gtx_inc(pass1, xc, yc, c_idx, w,
                                                  h, None, last_x, last_y),
                                    "par_level_flag")
                        gt1 = a.bin(GTX_FLAG,
                                    self._gtx_inc(pass1, xc, yc, c_idx, w,
                                                  h, 1, last_x, last_y),
                                    "abs_level_gtx_flag1")
                        rem_bins -= 2
                p1 = sig + par + gt0 + 2 * gt1
                pass1[yc, xc] = p1
                levels[n] = p1
                if dq:
                    q_state = _Q_NEXT[q_state][p1 & 1]
                first1 = n - 1
                n -= 1

            for n in range(first0, first1, -1):
                xc, yc = ox + in_sb[n][0], oy + in_sb[n][1]
                rem = 0
                if pass1[yc, xc] >= 4:
                    rice = self._rice(abs_lv, xc, yc, w, h, 4)
                    rem = self._rice_value(rice, "abs_remainder")
                abs_lv[yc, xc] = pass1[yc, xc] + 2 * rem
                levels[n] = abs_lv[yc, xc]

            for n in range(first1, -1, -1):
                xc, yc = ox + in_sb[n][0], oy + in_sb[n][1]
                if coded:
                    rice = self._rice(abs_lv, xc, yc, w, h, 0)
                    zero_pos = ((1 if q_state < 2 else 2) if dq else 1) \
                        << rice
                    dec = self._rice_value(rice, "dec_abs_level")
                    if dec == zero_pos:
                        v = 0
                    else:
                        v = dec + 1 if dec < zero_pos else dec
                    levels[n] = v
                abs_lv[yc, xc] = levels[n]
                if dq:
                    q_state = _Q_NEXT[q_state][int(levels[n]) & 1]

            signs = np.zeros(nsbc, dtype=np.int64)
            for n in range(nsbc - 1, -1, -1):
                if levels[n] > 0:
                    signs[n] = a.bypass("coeff_sign_flag")

            st = q_state_at_sb
            for n in range(nsbc - 1, -1, -1):
                xc, yc = ox + in_sb[n][0], oy + in_sb[n][1]
                v = int(levels[n])
                if dq:
                    mag = 2 * v - (1 if st > 1 else 0) if v > 0 else 0
                    st = _Q_NEXT[st][v & 1]
                else:
                    mag = v
                q[yc, xc] = -mag if signs[n] else mag
        return q

    def residual_ts(self, log2w, log2h, c_idx):
        """Transform-skip residual (ctu_encoder.rs:2271-2610; TS ctx
        derivations bool_coder.rs:2102,2246,2292,2373). Forward sub-block
        scan, context-coded signs, left/above level-prediction remap, no
        dependent quantization."""
        a = self.a
        w, h = 1 << log2w, 1 << log2h
        log2sb = 2 if min(log2w, log2h) >= 2 else 1
        sbw = 1 << log2sb
        in_sb = _diag_positions(sbw, sbw)
        sbs = _diag_positions(w >> log2sb, h >> log2sb)
        nsbc = sbw * sbw

        q = np.zeros((h, w), dtype=np.int16)
        pass1 = np.zeros((h, w), np.int64)
        pass2 = np.zeros((h, w), np.int64)
        sig = np.zeros((h, w), np.int64)
        sign = np.zeros((h, w), np.int8)
        slvl = np.zeros((h, w), np.int8)
        sb_coded_grid = np.zeros((h >> log2sb, w >> log2sb), bool)
        rem = (w * h * 7) >> 2
        infer_cbf = True

        def sign_inc(xc, yc):
            left = int(slvl[yc, xc - 1]) if xc > 0 else 0
            above = int(slvl[yc - 1, xc]) if yc > 0 else 0
            if (left == 0 and above == 0) or left == -above:
                return 0
            return 1 if (left >= 0 and above >= 0) else 2

        for i, (sx, sy) in enumerate(sbs):
            ox, oy = sx << log2sb, sy << log2sb
            last_sb = (i == len(sbs) - 1)
            if not last_sb or not infer_cbf:
                inc = 4
                if sx > 0:
                    inc += int(sb_coded_grid[sy, sx - 1])
                if sy > 0:
                    inc += int(sb_coded_grid[sy - 1, sx])
                coded = bool(a.bin(SB_CODED, inc, "ts_sb_coded_flag"))
            else:
                coded = True
            sb_coded_grid[sy, sx] = coded
            if coded and not last_sb:
                infer_cbf = False

            # pass 1: sig + sign + gt0 + par
            infer_sig = True
            p1_pos = -1
            n = 0
            while n < nsbc and rem >= 4:
                xc, yc = ox + in_sb[n][0], oy + in_sb[n][1]
                p1_pos = n
                if coded and (n != nsbc - 1 or not infer_sig):
                    inc = 60
                    if xc > 0 and pass1[yc, xc - 1] >= 1:
                        inc += 1
                    if yc > 0 and pass1[yc - 1, xc] >= 1:
                        inc += 1
                    s = a.bin(SIG_COEFF, inc, "ts_sig_coeff_flag")
                    rem -= 1
                    if s:
                        infer_sig = False
                else:
                    s = 1 if (coded and n == nsbc - 1 and infer_sig) else 0
                sig[yc, xc] = s
                gt0 = par = 0
                if s:
                    sg = a.bin(SIGN_FLAG, sign_inc(xc, yc),
                               "ts_coeff_sign_flag")
                    rem -= 1
                    sign[yc, xc] = sg
                    slvl[yc, xc] = -1 if sg else 1
                    inc = 64 + (int(sig[yc, xc - 1]) if xc > 0 else 0) \
                        + (int(sig[yc - 1, xc]) if yc > 0 else 0)
                    gt0 = a.bin(GTX_FLAG, inc, "ts_abs_level_gtx_flag0")
                    rem -= 1
                    if gt0:
                        par = a.bin(PAR_LEVEL, 32, "ts_par_level_flag")
                        rem -= 1
                pass1[yc, xc] = s + par + gt0
                n += 1

            # pass 2: gtx j = 1..4
            p2_pos = -1
            n = 0
            while n < nsbc and rem >= 4 and n <= p1_pos:
                xc, yc = ox + in_sb[n][0], oy + in_sb[n][1]
                pass2[yc, xc] = pass1[yc, xc]
                gt_prev = pass1[yc, xc] >= 2
                for j in range(1, 5):
                    if not gt_prev:
                        break
                    g = a.bin(GTX_FLAG, 67 + j, "ts_abs_level_gtx_flag")
                    rem -= 1
                    pass2[yc, xc] += 2 * g
                    gt_prev = bool(g)
                p2_pos = n
                n += 1

            # pass 3: remainder + trailing signs; finalize coefficients
            for n in range(nsbc):
                xc, yc = ox + in_sb[n][0], oy + in_sb[n][1]
                rv = 0
                if ((n <= p2_pos and pass2[yc, xc] >= 10)
                        or (p2_pos < n <= p1_pos and pass1[yc, xc] >= 2)
                        or (n > p1_pos and coded)):
                    rv = self._rice_value(1, "ts_abs_remainder")
                if n > p2_pos and n > p1_pos and rv > 0:
                    sign[yc, xc] = a.bin(SIGN_FLAG, sign_inc(xc, yc),
                                         "ts_coeff_sign_flag")
                if not coded:
                    continue
                if n <= p2_pos:
                    lvl = int(pass2[yc, xc]) + 2 * rv
                elif n <= p1_pos:
                    lvl = int(pass1[yc, xc]) + 2 * rv
                else:
                    lvl = rv
                if lvl <= 0:
                    continue
                if n <= p1_pos:
                    left = abs(int(q[yc, xc - 1])) if xc > 0 else 0
                    above = abs(int(q[yc - 1, xc])) if yc > 0 else 0
                    pred = max(left, above)
                    if lvl == 1 and pred > 0:
                        mag = pred
                    elif lvl <= pred:
                        mag = lvl - 1
                    else:
                        mag = lvl
                else:
                    mag = lvl
                q[yc, xc] = -mag if sign[yc, xc] else mag
        return q

    def _last_pos(self, se, c_idx, log2size):
        """last_sig_coeff_{x,y}: TR-coded prefix + FL bypass suffix
        (spec 9.3.4.2.4 ctx derivation)."""
        a = self.a
        c_max = (min(log2size, 5) << 1) - 1
        if c_idx == 0:
            off = 3 * (log2size - 2) + ((log2size - 1) >> 2)
            shift = (log2size + 1) >> 2
        else:
            off = 20
            shift = min(max((1 << log2size) >> 3, 0), 2)
        prefix = 0
        while prefix < c_max and a.bin(se, (prefix >> shift) + off,
                                       "last_sig_prefix"):
            prefix += 1
        if prefix <= 3:
            return prefix
        nbits = (prefix >> 1) - 1
        suffix = 0
        for _ in range(nbits):
            suffix = (suffix << 1) | a.bypass("last_sig_suffix")
        return ((2 + (prefix & 1)) << nbits) + suffix

    @staticmethod
    def _template_sum(m, xc, yc, w, h, cap=None):
        """Local template (x+1,y),(x+2,y),(x+1,y+1),(x,y+1),(x,y+2)."""
        total = 0
        for dx, dy in ((1, 0), (2, 0), (1, 1), (0, 1), (0, 2)):
            nx, ny = xc + dx, yc + dy
            if nx < w and ny < h:
                v = int(m[ny, nx])
                total += min(v, cap) if cap is not None else v
        return total

    def _sig_inc(self, pass1, xc, yc, c_idx, w, h, q_state, dq):
        s = self._template_sum(pass1, xc, yc, w, h)
        d = xc + yc
        qs = max(q_state - 1, 0) if dq else 0
        if c_idx == 0:
            return (12 * qs + min((s + 1) >> 1, 3)
                    + (8 if d < 2 else 4 if d < 5 else 0))
        return 36 + 8 * qs + min((s + 1) >> 1, 3) + (4 if d < 2 else 0)

    def _gtx_inc(self, pass1, xc, yc, c_idx, w, h, j, lx, ly):
        s = self._template_sum(pass1, xc, yc, w, h)
        n1 = self._template_sum(pass1, xc, yc, w, h, cap=1)
        off = min(s - n1, 4)
        d = xc + yc
        if (xc, yc) == (lx, ly):
            inc = 0 if c_idx == 0 else 21
        elif c_idx == 0:
            inc = 1 + off + (15 if d == 0 else 10 if d < 3 else
                             5 if d < 10 else 0)
        else:
            inc = 22 + off + (5 if d == 0 else 0)
        return inc + (32 if j == 1 else 0)

    def _rice(self, abs_lv, xc, yc, w, h, base):
        s = self._template_sum(abs_lv, xc, yc, w, h)
        return _RICE_TABLE[min(max(s - 5 * base, 0), 31)]

    def _rice_value(self, rice, name):
        """abs_remainder / dec_abs_level: TR(cMax=6<<rice, rice) prefix with
        limited-EG(rice+1) escape (bool_coder.rs:1384-1466)."""
        a = self.a
        prefix = 0
        while prefix < 6 and a.bypass(name):
            prefix += 1
        if prefix < 6:
            suffix = 0
            for _ in range(rice):
                suffix = (suffix << 1) | a.bypass(name)
            return (prefix << rice) | suffix
        # escape: limited EG(rice+1), maxPreExt 11, truncSuffixLen 15
        k = rice + 1
        pre = 0
        while pre < 11 and a.bypass(name):
            pre += 1
        esc = 15 if pre == 11 else pre + k
        rem = 0
        for _ in range(esc):
            rem = (rem << 1) | a.bypass(name)
        return (6 << rice) + (((1 << pre) - 1) << k) + rem

    # -------------------------------------------------------- reconstruction
    def reconstruct(self, c, x, y, log2, mode, qlv, mts, ts=0):
        ps = self.ps
        shift = 0 if c == 0 else 1
        plane = (self.y, self.cb, self.cr)[c]
        cx, cy = x >> shift, y >> shift
        s = 1 << (log2 - shift)
        if c == 0 or mode < 81:
            pred = spec_intra.predict_block(
                plane, cx, cy, s, s, (x, y), (1 << log2, 1 << log2),
                self.avail, c, mode)
        else:
            pred = spec_intra.predict_cclm(
                mode, self.y, plane, cx, cy, s, s, (x, y), self.avail,
                1 << ps.log2_ctu_size, ps.bit_depth)
        if qlv is None:
            plane[cy:cy + s, cx:cx + s] = pred
            return
        qp = self.cur_qp_y if c == 0 else \
            spec_quant.chroma_qp_from_luma(self.cur_qp_y)
        qpar = spec_quant.derive_quant_params(
            qp, log2 - shift, log2 - shift, dep_quant=ps.dep_quant_used,
            transform_skip=bool(ts), bit_depth=ps.bit_depth)
        d = spec_quant.dequantize(qlv, qpar)
        if ts:
            res = d   # transform skip: residual = dequantized levels
        else:
            if c == 0 and mts:
                th, tv = ((0, 0), (1, 1), (2, 1), (1, 2), (2, 2))[mts]
            else:
                th, tv = 0, 0
            res = spec_transform.inverse(d, th, tv, ps.bit_depth)
        plane[cy:cy + s, cx:cx + s] = np.clip(pred + res, 0, 255)


# =========================================================================
# Top level
# =========================================================================

def decode_annexb_independent(data, trace=None):
    """Decode an Annex-B stream with the independent oracle.

    Returns a list of (Y, Cb, Cr) uint8 planes. Raises ConformanceError on
    any syntax violation or unsupported feature (the 'VTM would choke'
    signal)."""
    ps = PS()
    frames = []
    for nut, _layer, rbsp in split_annexb(data):
        if nut == NUT_SPS:
            parse_sps(rbsp, ps)
        elif nut == NUT_PPS:
            parse_pps(rbsp, ps)
        elif nut == NUT_PH:
            parse_ph(rbsp, ps)
        elif nut in (NUT_IDR_W_RADL, NUT_IDR_N_LP, NUT_TRAIL):
            b = Bits(rbsp)
            parse_sh(b, ps)
            dec = SliceDecoder(ps, trace=trace)
            frames.append(dec.run(rbsp[b.byte_pos:]))
        # VPS and others carry no state this subset needs
    return frames
