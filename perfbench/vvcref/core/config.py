"""Encoder configuration.

Two layers:
- `EncoderConfig`: coding-tool configuration mirroring the reference's
  operating point (SPS/PPS constructor defaults, sps.rs:229-347 /
  slice_header.rs:64-124): CTU 32x32, 8-bit 4:2:0, QT-only partitioning,
  CCLM on, dependent quantization on, transform-skip signalled, explicit MTS
  signalled with mts_idx always 0, SAO/ALF/LMCS/ISP/MRL/MIP/IBC/palette off.
- `RateModelConfig`: the ~30 Optuna-fitted rate-model constants consumed by
  the RD search (block_splitter.rs:20-375, quantizer.rs:15-26,650-683).
  Values are data, overridable via `extra_params` exactly like the
  reference's `--extra-params KEY=VAL,...` escape hatch.
"""
from dataclasses import dataclass, field, fields


@dataclass
class RateModelConfig:
    # level-rate tables: rate(v) ~ (v + offset)^pow * 16384
    lv_pow: float = 0.5
    lv_pow_dq: float = 0.5850246891437862
    lv_pow_dq_trellis: float = 0.48592678233563835
    lv_offset: float = 0.67196167
    lv_offset_dq: float = 0.13731084642527322
    lv_offset_dq_trellis: float = 0.15150746310196822
    # weight of the luma mode-bit term in the wavefront stage-A costs
    # (this framework's own knob — not in the reference; ~2x measures best
    # with the reference-tuned constants, see search/wavefront.py)
    stage_a_mode_bits_scale: float = 2.0
    # commit-time QT split refinement: stage-A split decisions whose
    # relative cost margin is below this are re-decided on the true
    # reconstruction (0 disables; framework knob, not in the reference).
    # 0.15 measured BD-rate-neutral vs 0.5 at ~2x less commit work
    # (tools/ab_margins.py, bus 8fr x 4QP)
    split_refine_margin: float = 0.15
    # commit-time mode re-decision is skipped (winner encoded directly)
    # when stage A's top-2 relative margin exceeds this (0 disables)
    rd_commit_prune_margin: float = 0.25
    # re-decide chroma (derived vs CCLM) at commit time on the true
    # reconstruction; 0 trusts stage A's pick (cheaper)
    commit_chroma_redecide: float = 1.0
    # 1: include the derived-mode chroma contribution in commit candidate
    # ranking (the reference's full get_intra_pred_cost covers all three
    # components; dropping it costs ~1.2% BD-rate, measured on the clips)
    commit_rank_full: float = 1.0
    # 1: rank with the trellis quantizer; 0: greedy ranking (winner is
    # always re-encoded with the commit quantizer). Trellis ranking is
    # what beats the reference's BD-rate (greedy ranking costs ~1% —
    # measured on the full clips); keep 1.
    commit_rank_trellis: float = 1.0
    # stage-A angular full-RD candidates on top of PLANAR/DC
    stage_a_num_rd_cands: int = 4
    # 1: stage-A full-RD evals rank with the TRELLIS quantizer (the
    # reference's search quantizes with trellis=true everywhere,
    # block_splitter.rs:146-185 -> quantizer.rs:519); 0: greedy (faster).
    # The in-VMEM Pallas Viterbi makes the trellis affordable in stage A.
    stage_a_trellis_rd: float = 0.0
    # mode-bits model
    non_planar_offset: float = 2.4951231
    non_planar_offset_dq: float = 2.6002965
    non_planar_offset_dq_trellis: float = 2.2153597
    mpm_idx_offset: float = 1.3215903
    mpm_idx_offset_dq: float = 1.5069426
    mpm_idx_offset_dq_trellis: float = 1.3660221
    mpm_remainder_mult: float = 0.67373323
    mpm_remainder_mult_dq: float = 0.45641026
    mpm_remainder_mult_dq_trellis: float = 0.5007182
    mpm_remainder_offset: float = 2.6947212
    mpm_remainder_offset_dq: float = 2.352948
    mpm_remainder_offset_dq_trellis: float = 2.2973304
    planar_offset: float = 0.5961908
    planar_offset_dq: float = 0.9626864
    planar_offset_dq_trellis: float = 0.9626864
    header_bits: float = 1.7622861
    header_bits_dq: float = 0.98212564
    header_bits_dq_trellis: float = 1.1772872
    chroma_header_bits: float = 1.1804068
    chroma_header_bits_dq: float = 1.1223906
    chroma_header_bits_dq_trellis: float = 1.309252
    qp_div: float = 7.0
    qp_div_dq: float = 3.970736
    qp_div_dq_trellis: float = 4.4043665
    lambda_mul: float = 7.915166
    lambda_mul_dq: float = 1.3439287
    lambda_mul_dq_trellis: float = 1.1282581
    mpm_idx_pow: float = 0.40271285
    mpm_remainder_pow: float = 0.34385094
    # CCLM mode-bits model
    cclm_pow: float = 0.4587651
    cclm_mode_idx_offset: float = 1.9448606
    cclm_mode_idx_offset_dq: float = 2.1
    cclm_mode_idx_offset_dq_trellis: float = 2.1
    non_cclm_offset: float = 0.97943497
    non_cclm_offset_dq: float = 0.89
    non_cclm_offset_dq_trellis: float = 0.89
    cclm_offset: float = 0.1
    cclm_offset_dq: float = 0.53
    cclm_offset_dq_trellis: float = 0.53
    # quantizer trellis lambda model
    quant_lv_pow: float = 0.5004010166085378
    quant_qp_div: float = 4.049512651290126
    quant_qp_div_trellis: float = 5.218413785332902
    quant_lambda_mul: float = 1.2602364115635767
    quant_lambda_mul_trellis: float = 1.2709404305806742
    quant_lambda_offset: int = 4
    quant_lambda_offset_trellis: int = 11

    def pick(self, base: str, dep_quant: bool, trellis: bool):
        """Select the {plain, _dq, _dq_trellis} variant of a constant."""
        if not dep_quant:
            return getattr(self, base)
        if trellis:
            return getattr(self, base + "_dq_trellis")
        return getattr(self, base + "_dq")

    def apply_extra_params(self, extra: dict):
        """Override constants from a {name: str_value} dict (CLI escape hatch)."""
        names = {f.name: f.type for f in fields(self)}
        for k, v in extra.items():
            if k in names:
                setattr(self, k, type(getattr(self, k))(float(v)))


@dataclass
class EncoderConfig:
    width: int = 352
    height: int = 288
    qp: int = 32
    max_split_depth: int = 3
    # structural constants (reference operating point)
    log2_ctu_size: int = 5
    log2_min_cb_size: int = 2
    bit_depth: int = 8
    chroma_format: int = 1  # 4:2:0
    # coding tools
    dep_quant_enabled: bool = True
    cclm_enabled: bool = True
    transform_skip_enabled: bool = True  # signalled in SPS; search may use it
    log2_transform_skip_max_size: int = 5
    # RD-select transform skip per luma TB (ScalarEncoder; useful for
    # screen content). Entropy coding then runs on the Python syntax path.
    transform_skip_search: bool = False
    mts_enabled: bool = True             # explicit MTS signalled, idx always 0
    explicit_mts_intra_enabled: bool = True
    explicit_mts_inter_enabled: bool = True
    lfnst_enabled: bool = False
    sao_enabled: bool = False
    alf_enabled: bool = False
    joint_cbcr_enabled: bool = False
    sign_data_hiding_enabled: bool = False
    entropy_coding_sync_enabled: bool = False  # WPP; wavefront mode sets True
    entry_point_offsets_present: bool = False
    # per-QG (== CTU) QP-offset pattern, cycled over CTUs in raster
    # order: exercises nonzero cu_qp_delta signalling + spec 8.7.1 QP
    # prediction end-to-end (quantizer.rs:95-234). Empty = fixed QP.
    # Routes commit to the NumPy path and entropy to the Python syntax
    # layer (the batched native/device engines quantize at one QP).
    qp_delta_pattern: tuple = ()
    rate_model: RateModelConfig = field(default_factory=RateModelConfig)

    # derived
    @property
    def ctu_size(self):
        return 1 << self.log2_ctu_size

    @property
    def ctus_wide(self):
        return (self.width + self.ctu_size - 1) >> self.log2_ctu_size

    @property
    def ctus_high(self):
        return (self.height + self.ctu_size - 1) >> self.log2_ctu_size

    @property
    def qp_bd_offset(self):
        return 6 * (self.bit_depth - 8)

    def validate(self):
        assert self.width % self.ctu_size == 0 and self.height % self.ctu_size == 0, \
            "picture dimensions must be multiples of the CTU size"
        assert self.bit_depth == 8, "only 8-bit supported (reference parity)"
        return self


def config_from_dict(d):
    """EncoderConfig from `dataclasses.asdict(cfg)` of a config with the
    same fields (this package's or the JAX package's), including the
    nested rate model. Unknown keys raise, so a config never loses a
    setting on the way across."""
    d = dict(d)
    rm = RateModelConfig(**d.pop('rate_model', {}))
    if 'qp_delta_pattern' in d:
        d['qp_delta_pattern'] = tuple(d['qp_delta_pattern'] or ())
    return EncoderConfig(rate_model=rm, **d)
