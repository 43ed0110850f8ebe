"""High-level syntax writers (SPS/PPS/slice header/SEI) for the encoder.

Mirror of EncoderLib/VLCWriter.cpp for the v1 All-Intra feature set:
single tree, CTU 64, DCT2-only, no loop filters, single slice per picture,
picture header in slice header, IDR every frame.  Field order mirrors
vtm_jax.decoder.vlc exactly (which is bit-exact against the reference).
"""

from __future__ import annotations

from vtm_jax.bitstream.writer import BitWriter, make_nal
from vtm_jax.bitstream import reader as nalio


def write_constraint_info(w: BitWriter):
    # general constraint flags: all zero except frame-only
    w.flag(0)  # non_packed
    w.flag(1)  # frame_only
    for _ in range(3):
        w.flag(0)  # non_projected, one_picture_only, intra_only
    w.u(2, 4)  # max_bitdepth_constraint_idc (10-bit − 8)
    w.u(1, 2)  # max_chroma_format_constraint_idc (4:2:0)
    w.flag(0)  # single_layer
    w.flag(1)  # all_layers_independent (must be 1 only if single_layer; 0 ok)
    for _ in range(45):
        w.flag(0)


def write_ptl(w: BitWriter, level_idc: int = 51):
    w.u(1, 7)  # general_profile_idc: Main10
    w.flag(0)  # tier
    write_constraint_info(w)
    w.u(level_idc, 8)
    w.u(0, 8)  # num_sub_profiles
    # no sub layers → no flags; ptl alignment
    while not w.byte_aligned():
        w.u(0, 1)


def write_sps(cfg) -> bytes:
    w = BitWriter()
    w.u(0, 4)  # sps id
    w.u(0, 4)  # vps id
    w.u(0, 3)  # max_sub_layers_minus1
    w.u(0, 4)  # reserved
    w.flag(1)  # ptl_dpb_hrd_present
    write_ptl(w)
    w.flag(0)  # gdr_enabled
    w.u(cfg.chroma_format_idc, 2)
    w.flag(0)  # ref_pic_resampling
    w.ue(cfg.width)
    w.ue(cfg.height)
    w.flag(0)  # conformance window
    w.u(cfg.log2_ctu_size - 5, 2)
    w.flag(0)  # subpic_info_present
    w.ue(cfg.bit_depth - 8)
    w.flag(1 if getattr(cfg, "wpp", False) else 0)  # entropy_coding_sync
    w.flag(1 if getattr(cfg, "wpp", False) else 0)  # entry_point_offsets_present
    w.u(4, 4)  # log2_max_pic_order_cnt_lsb_minus4 → 8 bits
    w.flag(0)  # poc_msb_flag
    w.u(0, 2)  # num_extra_ph_bits_bytes
    w.u(0, 2)  # num_extra_sh_bits_bytes
    # dpb (ptl present, single sublayer)
    w.ue(7 if getattr(cfg, "inter", False) else 0)  # max_dec_pic_buffering_minus1
    w.ue(5 if getattr(cfg, "inter", False) else 0)  # max_num_reorder_pics
    w.ue(0)  # max_latency_increase_plus1
    w.flag(0)  # qtbtt_dual_tree_intra (chroma 420 present)
    w.ue(cfg.log2_min_cb_size - 2)
    w.flag(0)  # partition_constraints_override
    w.ue(cfg.log2_min_qt_intra - cfg.log2_min_cb_size)
    w.ue(cfg.max_mtt_depth_intra)
    if cfg.max_mtt_depth_intra:
        w.ue(cfg.log2_max_bt_intra - cfg.log2_min_qt_intra)
        w.ue(cfg.log2_max_tt_intra - cfg.log2_min_qt_intra)
    w.ue(cfg.log2_min_qt_inter - cfg.log2_min_cb_size)
    w.ue(cfg.max_mtt_depth_inter)
    if cfg.max_mtt_depth_inter:
        w.ue(cfg.log2_max_bt_inter - cfg.log2_min_qt_inter)
        w.ue(cfg.log2_max_tt_inter - cfg.log2_min_qt_inter)
    if cfg.ctu_size > 32:
        w.flag(1 if cfg.log2_max_tb_size == 6 else 0)
    # chroma QP table: identity
    w.flag(0)  # joint_cbcr
    w.flag(1)  # same_qp_table_for_chroma
    w.se(0)  # qp_table_start_minus26
    w.ue(0)  # num_points_minus1
    w.ue(0)  # delta_qp_in_val_minus1[0]
    w.ue(1)  # delta_qp_diff_val[0] → deltaOut = 1^0 = 1 (identity table)
    w.flag(1 if getattr(cfg, "sao", False) else 0)  # sao
    if getattr(cfg, "alf", False):
        w.flag(1)  # alf
        if cfg.chroma_format_idc != 0:
            w.flag(1 if getattr(cfg, "ccalf", False) else 0)  # ccalf
    else:
        w.flag(0)  # alf
    w.flag(0)  # transform_skip
    w.flag(0)  # weighted_pred
    w.flag(0)  # weighted_bipred
    w.flag(0)  # long_term_ref_pics
    w.flag(0)  # idr_rpl_present
    w.flag(1)  # rpl1_copy_from_rpl0
    w.ue(0)  # num_ref_pic_lists_in_sps[0]
    w.flag(0)  # ref_wraparound
    if getattr(cfg, "tmvp", False):
        w.flag(1)  # temporal_mvp
        w.flag(0)  # sbtmvp
    else:
        w.flag(0)  # temporal_mvp
    w.flag(1 if getattr(cfg, "amvr", False) else 0)  # amvr
    w.flag(0)  # bdof
    w.flag(0)  # smvd
    w.flag(0)  # dmvr
    if getattr(cfg, "mmvd", False):
        w.flag(1)  # mmvd
        w.flag(0)  # mmvd_fullpel_only
    else:
        w.flag(0)  # mmvd
    w.ue(1)  # six_minus_max_num_merge_cand → 5
    w.flag(1 if getattr(cfg, "sbt", False) else 0)  # sbt
    if getattr(cfg, "affine", False):
        w.flag(1)  # affine
        w.ue(0)    # five_minus_max_num_subblock_merge_cand → 5
        w.flag(1)  # 6-parameter affine (affine_type)
        if getattr(cfg, "amvr", False):
            w.flag(0)  # affine_amvr
        w.flag(1)  # PROF
        w.flag(0)  # prof_control_present
    else:
        w.flag(0)  # affine
    w.flag(1 if getattr(cfg, "bcw", False) else 0)  # bcw
    w.flag(1 if getattr(cfg, "ciip", False) else 0)  # ciip
    if getattr(cfg, "geo", False):
        w.flag(1)  # gpm
        w.ue(0)    # max_num_merge_cand_minus_max_num_gpm_cand (geo cand = 5)
    else:
        w.flag(0)  # gpm (max merge cand >= 2)
    w.ue(0)  # log2_parallel_merge_level_minus2
    w.flag(1 if getattr(cfg, 'isp', False) else 0)  # isp
    w.flag(1 if getattr(cfg, 'mrl', False) else 0)  # mrl
    w.flag(1 if getattr(cfg, 'mip', False) else 0)  # mip
    w.flag(1 if getattr(cfg, 'cclm', False) else 0)  # cclm
    if cfg.chroma_format_idc == 1:
        w.flag(1)  # chroma_horizontal_collocated
        w.flag(0)  # chroma_vertical_collocated
    if getattr(cfg, "mts", False):
        w.flag(1)  # mts
        w.flag(1)  # explicit_mts_intra
        w.flag(0)  # explicit_mts_inter
    else:
        w.flag(0)  # mts
    w.flag(0)  # palette
    w.flag(0)  # ibc
    w.flag(0)  # lmcs
    w.flag(1 if getattr(cfg, 'lfnst', False) else 0)  # lfnst
    w.flag(0)  # ladf
    w.flag(0)  # explicit_scaling_list
    w.flag(1 if getattr(cfg, "dep_quant", False) else 0)  # dep_quant
    w.flag(0)  # sign_data_hiding
    w.flag(0)  # virtual_boundaries_enabled
    w.flag(0)  # general_hrd_params_present
    w.flag(0)  # field_seq
    w.flag(0)  # vui_present
    w.flag(0)  # sps_extension
    w.write_rbsp_trailing()
    return make_nal(nalio.NAL_SPS, w.data())


def write_pps(cfg) -> bytes:
    w = BitWriter()
    w.u(0, 6)  # pps id
    w.u(0, 4)  # sps id
    w.flag(0)  # mixed_nalu_types
    w.ue(cfg.width)
    w.ue(cfg.height)
    w.flag(0)  # conformance window
    w.flag(0)  # scaling window
    w.flag(0)  # output_flag_present
    w.flag(1)  # no_pic_partition
    w.flag(0)  # subpic_id_mapping_in_pps
    w.flag(0)  # cabac_init_present
    w.ue(0)  # num_ref_idx_l0_default_active_minus1
    w.ue(0)  # num_ref_idx_l1_default_active_minus1
    w.flag(0)  # rpl1_idx_present
    w.se(cfg.init_qp - 26)
    w.flag(1 if (getattr(cfg, "aqp", False) or getattr(cfg, "ctu_rc", False)) else 0)  # cu_qp_delta_enabled
    w.flag(0)  # chroma_tool_offsets_present
    w.flag(0)  # weighted_pred
    w.flag(0)  # weighted_bipred
    w.flag(0)  # deblocking_filter_control_present
    w.flag(0)  # pps_ref_wraparound
    w.flag(0)  # picture_header_extension
    w.flag(0)  # slice_header_extension
    w.flag(0)  # pps_extension
    w.write_rbsp_trailing()
    return make_nal(nalio.NAL_PPS, w.data())


def write_aps_alf(p, aps_id: int = 0) -> bytes:
    """ALF APS NAL (field order mirrors vlc.parse_aps, which is bit-exact
    against VTM 9.3 ALF streams: aps_id u(5), type u(3), payload)."""
    w = BitWriter()
    w.u(aps_id, 5)
    w.u(0, 3)  # APS_ALF
    w.flag(1 if p.new_filter_luma else 0)
    w.flag(1 if p.new_filter_chroma else 0)
    w.flag(1 if p.new_ccalf[0] else 0)
    w.flag(1 if p.new_ccalf[1] else 0)

    def coeffs(row, n):
        for i in range(n - 1):
            v = int(row[i])
            w.ue(abs(v))
            if v:
                w.flag(1 if v < 0 else 0)

    if p.new_filter_luma:
        w.flag(1 if p.nonlinear_luma else 0)
        w.ue(p.num_luma_filters - 1)
        if p.num_luma_filters > 1:
            length = max(1, (p.num_luma_filters - 1).bit_length())
            for i in range(25):
                w.u(p.filter_coeff_delta_idx[i], length)
        for f in range(p.num_luma_filters):
            coeffs(p.luma_coeff[f], 13)
        if p.nonlinear_luma:
            for f in range(p.num_luma_filters):
                for i in range(12):
                    w.u(p.luma_clip[f][i], 2)
    if p.new_filter_chroma:
        w.flag(1 if p.nonlinear_chroma else 0)
        w.ue(p.num_alternatives_chroma - 1)
        for alt in range(p.num_alternatives_chroma):
            coeffs(p.chroma_coeff[alt], 7)
            if p.nonlinear_chroma:
                for i in range(6):
                    w.u(p.chroma_clip[alt][i], 2)
    for cc_idx in range(2):
        if p.new_ccalf[cc_idx]:
            w.ue(p.ccalf_filter_count[cc_idx] - 1)
            for f in range(p.ccalf_filter_count[cc_idx]):
                for i in range(7):  # CCALF_NUM_COEFF - 1 signalled coeffs
                    v = int(p.ccalf_coeff[cc_idx][f][i])
                    code = 0 if v == 0 else abs(v).bit_length()
                    w.u(code, 3)
                    if code:
                        w.flag(1 if v < 0 else 0)
    w.flag(0)  # aps_extension
    w.write_rbsp_trailing()
    return make_nal(nalio.NAL_PREFIX_APS, w.data())


def write_picture_header(w: BitWriter, cfg, poc: int, is_irap: bool = True,
                         mvd_l1_zero: bool = True):
    """PH embedded in slice header (mirrors vlc.parse_picture_header)."""
    w.flag(1 if is_irap else 0)  # gdr_or_irap
    if is_irap:
        w.flag(0)  # gdr_pic
    w.flag(0 if is_irap else 1)  # ph_inter_slice_allowed
    if not is_irap:
        w.flag(0)  # ph_intra_slice_allowed (pure inter picture)
    w.flag(0)  # non_reference_picture
    w.ue(0)  # pps id
    w.u(poc & 0xFF, 8)  # poc lsb
    if is_irap:
        w.flag(0)  # no_output_of_prior_pics
        if getattr(cfg, "aqp", False) or getattr(cfg, "ctu_rc", False):
            w.ue(0)  # ph_cu_qp_delta_subdiv_intra (QG = CTU)
    if not is_irap:
        # inter-slice PH fields (affine/bdof/dmvr still off in our SPS)
        if getattr(cfg, "aqp", False) or getattr(cfg, "ctu_rc", False):
            w.ue(0)  # ph_cu_qp_delta_subdiv_inter
        if getattr(cfg, "tmvp", False):
            w.flag(1)  # ph_temporal_mvp_enabled
        w.flag(1 if mvd_l1_zero else 0)  # mvd_l1_zero
    # nothing else for our SPS/PPS feature set


def _write_rpl(w: BitWriter, deltas):
    """ref_pic_list_struct of short-term refs; deltas are POC differences
    (positive = past ref: ref_poc = poc - delta), cumulative-coded
    (VLCWriter xCodeRefPicListStruct; parse mirror vlc.parse_ref_pic_list)."""
    w.ue(len(deltas))
    prev = 0
    for d in deltas:
        rv = d - prev
        prev = d
        # sps weighted pred off → abs_delta_poc_st carries abs-1 always
        w.ue(abs(rv) - 1)
        w.flag(1 if rv > 0 else 0)


def _write_rpl_one_past_ref(w: BitWriter, delta: int):
    _write_rpl(w, [delta])


def write_slice_header_head(cfg, poc: int, qp: int, slice_type=None,
                            rpl0=None, rpl1=None, slice_type_p: bool = False,
                            ref_delta: int = 1, mvd_l1_zero: bool = True,
                            sao=(False, False), entry_points=None,
                            alf=None, active=None) -> BitWriter:
    """Slice header up to (and including) byte alignment before slice data.

    rpl0/rpl1: lists of POC deltas (positive = past, negative = future)."""
    from vtm_jax.common.types import SliceType

    if slice_type is None:
        slice_type = SliceType.P if slice_type_p else SliceType.I
        if slice_type_p:
            rpl0 = rpl1 = [ref_delta]
    w = BitWriter()
    w.flag(1)  # picture_header_in_slice_header
    write_picture_header(w, cfg, poc, is_irap=slice_type == SliceType.I,
                         mvd_l1_zero=mvd_l1_zero)
    # no subpics, rect slice single → no address; no extra bits
    if slice_type != SliceType.I:
        w.ue(int(slice_type))  # sh_slice_type (B=0, P=1)
    if getattr(cfg, "alf", False):
        # sh ALF info (parse mirror vlc.parse_slice_header: right after
        # sh_slice_type, before RPL/QP/SAO)
        luma_on = bool(alf and alf.alf_enabled[0])
        w.flag(1 if luma_on else 0)
        if luma_on:
            w.u(alf.num_alf_aps, 3)
            for aid in alf.alf_aps_ids:
                w.u(aid, 3)
            if cfg.chroma_format_idc != 0:
                w.u(1 if alf.alf_enabled[1] else 0, 1)
                w.u(1 if alf.alf_enabled[2] else 0, 1)
                if alf.alf_enabled[1] or alf.alf_enabled[2]:
                    w.u(alf.alf_aps_id_chroma, 3)
            if getattr(cfg, "ccalf", False):
                cb_on = bool(getattr(alf, "ccalf_cb_enabled", False))
                w.flag(1 if cb_on else 0)
                if cb_on:
                    w.u(alf.ccalf_cb_aps_id, 3)
                cr_on = bool(getattr(alf, "ccalf_cr_enabled", False))
                w.flag(1 if cr_on else 0)
                if cr_on:
                    w.u(alf.ccalf_cr_aps_id, 3)
    if slice_type != SliceType.I:
        # explicit RPLs (no SPS candidate lists): L0 then L1
        _write_rpl(w, rpl0)
        _write_rpl(w, rpl1)
        # num_ref_idx_active_override (SH parse: present when rpl0>1 or B&rpl1>1)
        if len(rpl0) > 1 or (slice_type == SliceType.B and len(rpl1) > 1):
            n0 = active[0] if active else 1
            n1 = active[1] if active else (1 if slice_type == SliceType.B else 0)
            if n0 == 1 and n1 <= 1:
                w.flag(0)  # use defaults (PPS num_ref_idx_default_active = 1)
            else:
                w.flag(1)
                if len(rpl0) > 1:
                    w.ue(n0 - 1)
                if slice_type == SliceType.B and len(rpl1) > 1:
                    w.ue(n1 - 1)
        if getattr(cfg, "tmvp", False) and slice_type == SliceType.B:
            w.flag(1)  # sh_collocated_from_l0
        if getattr(cfg, "tmvp", False):
            n0 = active[0] if active else 1
            if n0 > 1:  # collocated list is L0 (col_from_l0 = 1)
                w.ue(0)  # sh_collocated_ref_idx
    w.se(qp - cfg.init_qp)  # slice_qp_delta
    if getattr(cfg, "sao", False):
        w.flag(1 if sao[0] else 0)  # sh_sao_used_flag (luma)
        if cfg.chroma_format_idc != 0:
            w.flag(1 if sao[1] else 0)  # sh_sao_used_flag (chroma)
    # no deblocking override
    if getattr(cfg, "dep_quant", False):
        w.flag(1)  # sh_dep_quant_used_flag
    # no sdh / ts flags (sps flags off)
    if entry_points:
        offset_len = max(1, max(o - 1 for o in entry_points).bit_length())
        w.ue(offset_len - 1)
        for o in entry_points:
            w.u(o - 1, offset_len)
    w.write_byte_alignment()
    return w


def write_hash_sei(digest: bytes, hash_type: int = 0) -> bytes:
    w = BitWriter()
    w.u(132, 8)  # payload type: decoded_picture_hash
    w.u(1 + len(digest), 8)  # payload size
    w.u(hash_type, 8)
    for b in digest:
        w.u(b, 8)
    w.write_rbsp_trailing()
    return make_nal(nalio.NAL_SUFFIX_SEI, w.data())
