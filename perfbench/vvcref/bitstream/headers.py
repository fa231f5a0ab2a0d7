"""VPS/SPS/PPS/PH/SH syntax (spec 7.3.2) for the supported operating point.

Writers emit the same syntax-element sequence the reference produces for its
operating defaults (sps.rs:229 / pps.rs:150 / picture_header.rs:91 /
slice_header.rs:64, encoders vps_encoder.rs / sps_encoder.rs /
pps_encoder.rs / ph_encoder.rs / slice_encoder.rs:32), parameterized on
EncoderConfig. Parsers mirror the writers exactly (they assert on syntax
branches outside the supported operating point) and are used by the
conformance decoder.

Operating point: single layer, single tile/slice/subpicture, all-intra,
8-bit 4:2:0, CTU 32, QT-only partitioning; CABAC-level tools per
EncoderConfig (dep-quant, CCLM, transform-skip signalling, explicit MTS).
"""
from dataclasses import dataclass

from .bitio import BitWriter, BitReader

VPS_LAYER_ID = 9  # reference emits nuh_layer_id 1 for VPS, 9 elsewhere, and
                  # vps_layer_id[0] = 9 (main.rs:233,246, vps.rs:89)


def _write_ptl(w, max_sublayers, pt_present=True):
    """profile_tier_level with all-zero profile/level (ptl_encoder.rs:25)."""
    if pt_present:
        w.u(0, 7)   # general_profile_idc
        w.u(0, 1)   # general_tier_flag
    w.u(0, 8)       # general_level_idc
    w.bit(0)        # ptl_frame_only_constraint_flag
    w.bit(0)        # ptl_multilayer_enabled_flag
    if pt_present:
        w.bit(0)    # gci_present_flag
        w.byte_align()
    for _ in range(max_sublayers - 1):
        w.bit(0)    # sublayer_level_idc_present
    w.byte_align()
    if pt_present:
        w.u(0, 8)   # ptl_num_sub_profiles


def _parse_ptl(r, max_sublayers, pt_present=True):
    if pt_present:
        r.u(7); r.u(1)
    r.u(8); r.bit(); r.bit()
    if pt_present:
        assert r.bit() == 0  # gci not supported
        r.byte_align()
    for _ in range(max_sublayers - 1):
        assert r.bit() == 0
    r.byte_align()
    if pt_present:
        assert r.u(8) == 0


def _write_dpb(w):
    w.ue(8)  # dpb_max_dec_pic_buffering_minus1... (reference values dpb.rs)
    w.ue(4)  # dpb_max_num_reorder_pics
    w.ue(1)  # dpb_max_latency_increase_plus1


def _parse_dpb(r):
    r.ue(); r.ue(); r.ue()


def _write_rpls(w, lx):
    """SPS candidate ref-pic-list structure (reference defaults,
    reference_picture.rs:14-27; unused for all-intra but signalled)."""
    w.ue(3)  # num_ref_entries
    for delta in (0, 2, 3):
        w.ue(delta)          # abs_delta_poc_st
        w.bit(1 if lx == 0 else 0)  # strp_entry_sign_flag
    return


def _parse_rpls(r):
    n = r.ue()
    for _ in range(n):
        d = r.ue()
        r.bit()


def write_vps(cfg):
    """VPS RBSP — single layer (vps_encoder.rs:27)."""
    w = BitWriter()
    w.u(8, 4)       # vps_video_parameter_set_id (reference uses 8)
    w.u(0, 6)       # vps_max_layers_minus1
    w.u(0, 3)       # vps_max_sublayers_minus1
    w.u(VPS_LAYER_ID, 6)  # vps_layer_id[0]
    _write_ptl(w, 1, pt_present=True)
    # vps_each_layer_is_an_ols inferred 0 by the reference's model ->
    # dpb parameter block is present (vps_encoder.rs:146)
    w.ue(0)         # vps_num_dpb_params_minus1
    _write_dpb(w)
    w.bit(0)        # vps_timing_hrd_params_present_flag
    w.bit(0)        # vps_extension_flag
    w.rbsp_trailing()
    return w.bytes()


def write_sps(cfg):
    """SPS RBSP for the operating point (sps_encoder.rs:29)."""
    w = BitWriter()
    w.u(1, 4)                     # sps_seq_parameter_set_id
    w.u(8, 4)                     # sps_video_parameter_set_id
    w.u(0, 3)                     # sps_max_sublayers_minus1
    w.u(cfg.chroma_format, 2)     # sps_chroma_format_idc
    w.u(cfg.log2_ctu_size - 5, 2)
    w.bit(1)                      # sps_ptl_dpb_hrd_params_present_flag
    _write_ptl(w, 1)
    w.bit(0)                      # sps_gdr_enabled_flag
    w.bit(0)                      # sps_ref_pic_resampling_enabled_flag
    w.ue(cfg.width)
    w.ue(cfg.height)
    w.bit(0)                      # sps_conformance_window_flag
    w.bit(0)                      # sps_subpic_info_present_flag
    w.ue(cfg.bit_depth - 8)
    w.bit(1 if cfg.entropy_coding_sync_enabled else 0)
    w.bit(1 if cfg.entry_point_offsets_present else 0)
    w.u(0, 4)                     # sps_log2_max_pic_order_cnt_lsb_minus4
    w.bit(0)                      # sps_poc_msb_cycle_flag
    w.u(0, 2)                     # sps_num_extra_ph_bytes
    w.u(0, 2)                     # sps_num_extra_sh_bytes
    _write_dpb(w)
    w.ue(cfg.log2_min_cb_size - 2)
    w.bit(0)                      # sps_partition_constraints_override_enabled
    w.ue(0)                       # log2_diff_min_qt_min_cb_intra_slice_luma
    w.ue(0)                       # sps_max_mtt_hierarchy_depth_intra_slice_luma
    w.bit(0)                      # sps_qtbtt_dual_tree_intra_flag
    w.ue(0)                       # log2_diff_min_qt_min_cb_inter_slice
    w.ue(0)                       # sps_max_mtt_hierarchy_depth_inter_slice
    # ctb_size 32 -> no sps_max_luma_transform_size_64_flag
    assert cfg.log2_ctu_size == 5
    w.bit(1 if cfg.transform_skip_enabled else 0)
    if cfg.transform_skip_enabled:
        w.ue(cfg.log2_transform_skip_max_size)
        w.bit(0)                  # sps_bdpcm_enabled_flag
    w.bit(1 if cfg.mts_enabled else 0)
    if cfg.mts_enabled:
        w.bit(1 if cfg.explicit_mts_intra_enabled else 0)
        w.bit(1 if cfg.explicit_mts_inter_enabled else 0)
    w.bit(1 if cfg.lfnst_enabled else 0)
    w.bit(1 if cfg.joint_cbcr_enabled else 0)
    w.bit(1)                      # sps_same_qp_table_for_chroma_flag
    # one identity chroma QP table (QpTable::new defaults, sps.rs:34-56)
    w.se(0 - 26)                  # sps_qp_table_start_minus26
    w.ue(63 - 1)                  # sps_num_points_in_qp_table_minus1
    for _ in range(63):
        w.ue(0)                   # sps_delta_qp_in_val_minus1
        w.ue(1)                   # sps_delta_qp_diff_val
    w.bit(1 if cfg.sao_enabled else 0)
    w.bit(1 if cfg.alf_enabled else 0)
    w.bit(0)                      # sps_lmcs_enabled_flag
    w.bit(0)                      # sps_weighted_pred_flag
    w.bit(0)                      # sps_weighted_bipred_flag
    w.bit(0)                      # sps_long_term_ref_pics_flag
    w.bit(0)                      # sps_inter_layer_prediction (vps id > 0)
    w.bit(0)                      # sps_idr_rpl_present_flag
    w.bit(0)                      # sps_rpl1_same_as_rpl0_flag
    for lx in range(2):
        w.ue(1)                   # sps_num_ref_pic_lists
        _write_rpls(w, lx)
    w.bit(0)                      # sps_ref_wraparound_enabled_flag
    w.bit(0)                      # sps_temporal_mvp_enabled_flag
    w.bit(0)                      # sps_amvr_enabled_flag
    w.bit(0)                      # sps_bdof_enabled_flag
    w.bit(0)                      # sps_smvd_enabled_flag
    w.bit(0)                      # sps_dmvr_enabled_flag
    w.bit(0)                      # sps_mmvd_enabled_flag
    w.ue(0)                       # sps_six_minus_max_num_merge_cand
    w.bit(0)                      # sps_sbt_enabled_flag
    w.bit(0)                      # sps_affine_enabled_flag
    w.bit(0)                      # sps_bcw_enabled_flag
    w.bit(0)                      # sps_ciip_enabled_flag
    w.bit(0)                      # sps_gpm_enabled_flag (MaxNumMergeCand=6)
    w.ue(0)                       # sps_log2_parallel_merge_level_minus2
    w.bit(0)                      # sps_isp_enabled_flag
    w.bit(0)                      # sps_mrl_enabled_flag
    w.bit(0)                      # sps_mip_enabled_flag
    w.bit(1 if cfg.cclm_enabled else 0)
    w.bit(0)                      # sps_chroma_horizontal_collocated_flag
    w.bit(0)                      # sps_chroma_vertical_collocated_flag
    w.bit(0)                      # sps_palette_enabled_flag
    if cfg.transform_skip_enabled:
        w.ue(0)                   # sps_min_qp_prime_ts
    w.bit(0)                      # sps_ibc_enabled_flag
    w.bit(0)                      # sps_ladf_enabled_flag
    w.bit(0)                      # sps_explicit_scaling_list_enabled_flag
    w.bit(1 if cfg.dep_quant_enabled else 0)
    w.bit(1 if cfg.sign_data_hiding_enabled else 0)
    w.bit(0)                      # sps_virtual_boundaries_enabled_flag
    w.bit(0)                      # sps_timing_hrd_params_present_flag
    w.bit(0)                      # sps_field_seq_flag
    w.bit(0)                      # sps_vui_parameters_present_flag
    w.bit(0)                      # sps_extension_flag
    w.rbsp_trailing()
    return w.bytes()


@dataclass
class ParsedParams:
    """Everything the decoder needs from the parameter sets + headers."""
    width: int = 0
    height: int = 0
    log2_ctu_size: int = 5
    log2_min_cb_size: int = 2
    chroma_format: int = 1
    bit_depth: int = 8
    transform_skip_enabled: bool = True
    log2_transform_skip_max_size: int = 5
    mts_enabled: bool = True
    explicit_mts_intra_enabled: bool = True
    explicit_mts_inter_enabled: bool = True
    lfnst_enabled: bool = False
    joint_cbcr_enabled: bool = False
    cclm_enabled: bool = True
    sao_enabled: bool = False
    alf_enabled: bool = False
    dep_quant_enabled: bool = True
    sign_data_hiding_enabled: bool = False
    entropy_coding_sync_enabled: bool = False
    entry_point_offsets_present: bool = False
    init_qp: int = 26
    cu_qp_delta_enabled: bool = True
    # slice-level
    slice_qp: int = 26
    dep_quant_used: bool = True
    sign_data_hiding_used: bool = False
    ts_residual_coding_disabled: bool = False
    poc: int = 0


def parse_sps(rbsp, p):
    r = BitReader(rbsp)
    r.u(4); r.u(4); r.u(3)
    p.chroma_format = r.u(2)
    p.log2_ctu_size = r.u(2) + 5
    if r.bit():
        _parse_ptl(r, 1)
    r.bit()
    r.bit()
    p.width = r.ue()
    p.height = r.ue()
    assert r.bit() == 0
    assert r.bit() == 0
    p.bit_depth = r.ue() + 8
    p.entropy_coding_sync_enabled = bool(r.bit())
    p.entry_point_offsets_present = bool(r.bit())
    r.u(4); assert r.bit() == 0
    assert r.u(2) == 0 and r.u(2) == 0
    _parse_dpb(r)
    p.log2_min_cb_size = r.ue() + 2
    assert r.bit() == 0
    assert r.ue() == 0 and r.ue() == 0  # QT-only intra
    assert r.bit() == 0                 # no dual tree
    assert r.ue() == 0 and r.ue() == 0  # inter partitioning
    p.transform_skip_enabled = bool(r.bit())
    if p.transform_skip_enabled:
        p.log2_transform_skip_max_size = r.ue()
        assert r.bit() == 0  # bdpcm
    p.mts_enabled = bool(r.bit())
    if p.mts_enabled:
        p.explicit_mts_intra_enabled = bool(r.bit())
        p.explicit_mts_inter_enabled = bool(r.bit())
    p.lfnst_enabled = bool(r.bit())
    p.joint_cbcr_enabled = bool(r.bit())
    same_qp_table = r.bit()
    num_tables = 1 if same_qp_table else (3 if p.joint_cbcr_enabled else 2)
    for _ in range(num_tables):
        r.se()
        n = r.ue() + 1
        for _ in range(n):
            r.ue(); r.ue()
    p.sao_enabled = bool(r.bit())
    p.alf_enabled = bool(r.bit())
    assert p.alf_enabled is False
    assert r.bit() == 0  # lmcs
    r.bit(); r.bit()     # weighted pred/bipred
    assert r.bit() == 0  # long_term_ref_pics
    r.bit()              # inter_layer_prediction
    assert r.bit() == 0  # idr_rpl_present
    rpl1_same = r.bit()
    for _ in range(1 if rpl1_same else 2):
        n = r.ue()
        for _ in range(n):
            _parse_rpls(r)
    r.bit()                      # ref_wraparound
    assert r.bit() == 0          # temporal_mvp
    r.bit(); r.bit(); r.bit(); r.bit(); r.bit()  # amvr..mmvd
    r.ue()                       # six_minus_max_num_merge_cand
    r.bit(); assert r.bit() == 0  # sbt, affine
    r.bit(); r.bit()             # bcw, ciip
    r.bit()                      # gpm
    r.ue()                       # log2_parallel_merge_level_minus2
    assert r.bit() == 0          # isp
    assert r.bit() == 0          # mrl
    assert r.bit() == 0          # mip
    p.cclm_enabled = bool(r.bit())
    if p.chroma_format == 1:
        assert r.bit() == 0 and r.bit() == 0  # collocated flags
    assert r.bit() == 0          # palette
    if p.transform_skip_enabled:
        r.ue()                   # min_qp_prime_ts
    assert r.bit() == 0          # ibc
    assert r.bit() == 0          # ladf
    assert r.bit() == 0          # explicit scaling list
    p.dep_quant_enabled = bool(r.bit())
    p.sign_data_hiding_enabled = bool(r.bit())
    assert r.bit() == 0          # virtual boundaries
    assert r.bit() == 0          # timing hrd
    r.bit()                      # field_seq
    assert r.bit() == 0          # vui
    assert r.bit() == 0          # extension
    return p


def write_pps(cfg):
    """PPS RBSP (pps_encoder.rs:24; defaults pps.rs:150)."""
    w = BitWriter()
    init_qp = max(cfg.qp, 26)
    w.u(1, 6)        # pps_pic_parameter_set_id
    w.u(1, 4)        # pps_seq_parameter_set_id
    w.bit(0)         # pps_mixed_nalu_types_in_pic_flag
    w.ue(cfg.width)
    w.ue(cfg.height)
    w.bit(0)         # pps_conformance_window_flag
    w.bit(0)         # pps_scaling_window_explicit_signalling_flag
    w.bit(0)         # pps_output_flag_present_flag
    w.bit(1)         # pps_no_pic_partition_flag
    w.bit(0)         # pps_subpic_id_mapping_present_flag
    w.bit(0)         # pps_cabac_init_present_flag
    w.ue(2)          # pps_num_ref_idx_default_active_minus1[0]
    w.ue(2)          # pps_num_ref_idx_default_active_minus1[1]
    w.bit(0)         # pps_rpl1_idx_present_flag
    w.bit(0)         # pps_weighted_pred_flag
    w.bit(0)         # pps_weighted_bipred_flag
    w.bit(0)         # pps_ref_wraparound_enabled_flag
    w.se(init_qp - 26)
    w.bit(1)         # pps_cu_qp_delta_enabled_flag
    w.bit(0)         # pps_chroma_tool_offsets_present_flag
    w.bit(1)         # pps_deblocking_filter_control_present_flag
    w.bit(0)         # pps_deblocking_filter_override_enabled_flag
    w.bit(1)         # pps_deblocking_filter_disabled_flag
    w.bit(0)         # pps_picture_header_extension_present_flag
    w.bit(0)         # pps_slice_header_extension_present_flag
    w.bit(0)         # pps_extension_flag
    w.rbsp_trailing()
    return w.bytes()


def parse_pps(rbsp, p):
    r = BitReader(rbsp)
    r.u(6); r.u(4); r.bit()
    p.width = r.ue()
    p.height = r.ue()
    assert r.bit() == 0 and r.bit() == 0 and r.bit() == 0
    assert r.bit() == 1  # no_pic_partition
    assert r.bit() == 0  # subpic mapping
    assert r.bit() == 0  # cabac_init_present
    r.ue(); r.ue(); r.bit(); r.bit(); r.bit(); r.bit()
    p.init_qp = r.se() + 26
    p.cu_qp_delta_enabled = bool(r.bit())
    assert r.bit() == 0  # chroma tool offsets
    if r.bit():          # deblocking control present
        assert r.bit() == 0   # override
        assert r.bit() == 1   # disabled
    assert r.bit() == 0 and r.bit() == 0 and r.bit() == 0
    return p


def write_ph(cfg, poc):
    """PH RBSP, all-intra IRAP (ph_encoder.rs:29)."""
    w = BitWriter()
    w.bit(1)         # ph_gdr_or_irap_pic_flag
    w.bit(0)         # ph_non_ref_pic_flag
    w.bit(0)         # ph_gdr_pic_flag
    w.bit(0)         # ph_inter_slice_allowed_flag
    w.ue(1)          # ph_pic_parameter_set_id
    w.u(poc & 0xF, 4)  # ph_pic_order_cnt_lsb
    w.ue(0)          # ph_cu_qp_delta_subdiv_intra_slice
    w.rbsp_trailing()
    return w.bytes()


def parse_ph(rbsp, p):
    r = BitReader(rbsp)
    assert r.bit() == 1
    r.bit()
    assert r.bit() == 0
    assert r.bit() == 0  # intra only
    r.ue()
    p.poc = r.u(4)
    r.ue()               # cu_qp_delta_subdiv
    return p


def write_sh(w, cfg, slice_qp, entry_lens=None):
    """Slice header bits into writer `w` (slice data follows byte-aligned;
    slice_encoder.rs:32-341). With WPP (entropy_coding_sync), `entry_lens`
    holds the byte length of each subset except the last; they become
    sh_entry_point_offset_minus1 (slice_encoder.rs:302-333)."""
    init_qp = max(cfg.qp, 26)
    w.bit(0)                     # sh_picture_header_in_slice_header_flag
    w.bit(0)                     # sh_no_output_of_prior_pics_flag
    w.se(slice_qp - init_qp)     # sh_qp_delta
    if cfg.sao_enabled:          # slice_encoder.rs:232-239
        w.bit(1)                 # sh_sao_luma_used_flag
        w.bit(1)                 # sh_sao_chroma_used_flag
    if cfg.dep_quant_enabled:
        w.bit(1)                 # sh_dep_quant_used_flag
    if cfg.sign_data_hiding_enabled and not cfg.dep_quant_enabled:
        w.bit(0)                 # sh_sign_data_hiding_used_flag
    if cfg.transform_skip_enabled and not cfg.dep_quant_enabled:
        w.bit(0)                 # sh_ts_residual_coding_disabled_flag
    if entry_lens:
        olen = max(int(v - 1).bit_length() for v in entry_lens)
        olen = max(olen, 1)
        w.ue(olen - 1)           # sh_entry_offset_len_minus1
        for v in entry_lens:
            w.u(v - 1, olen)     # sh_entry_point_offset_minus1
    w.bit(1)                     # byte_alignment bit
    w.byte_align()


def parse_sh(r, p):
    """Parse slice header from BitReader `r`; leaves r at the byte-aligned
    start of the slice data."""
    assert r.bit() == 0          # ph not in sh
    r.bit()                      # no_output_of_prior_pics
    qp_delta = r.se()
    p.slice_qp = p.init_qp + qp_delta
    p.sao_luma_used = p.sao_chroma_used = False
    if p.sao_enabled:
        p.sao_luma_used = bool(r.bit())
        p.sao_chroma_used = bool(r.bit())
    if p.dep_quant_enabled:
        p.dep_quant_used = bool(r.bit())
    else:
        p.dep_quant_used = False
    if p.sign_data_hiding_enabled and not p.dep_quant_used:
        p.sign_data_hiding_used = bool(r.bit())
    if p.transform_skip_enabled and not p.dep_quant_used and not p.sign_data_hiding_used:
        p.ts_residual_coding_disabled = bool(r.bit())
    p.entry_lens = []
    if p.entropy_coding_sync_enabled and p.entry_point_offsets_present:
        ctu = 1 << p.log2_ctu_size
        num_entry = (p.height + ctu - 1) // ctu - 1
        if num_entry > 0:
            olen = r.ue() + 1
            p.entry_lens = [r.u(olen) + 1 for _ in range(num_entry)]
    assert r.bit() == 1
    r.byte_align()
    return p
