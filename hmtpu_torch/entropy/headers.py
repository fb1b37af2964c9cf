"""High-level syntax: VPS/SPS/PPS and slice-header writing/parsing
(H.265 7.3.2, 7.3.6).

Capability parity with the reference's TEncCavlc.cpp:1-1517 (writers)
and TDecCAVLC (parsers), restricted to the capability envelope this
encoder signals.  Pure bit-level code on the host — never a hot path.
"""
from __future__ import annotations

from dataclasses import dataclass

from hmtpu_torch.common.constants import NalUnitType, SliceType
from hmtpu_torch.common.params import Pps, ProfileTierLevel, Sps, Vps
from hmtpu_torch.io.bitstream import BitReader, BitWriter
from hmtpu_torch.io.nal import NalUnit


class UnsupportedStream(Exception):
    """A conformant stream uses a feature outside this decoder's
    envelope (typed so callers can distinguish it from a parse bug)."""


# --------------------------------------------------------------------------
# profile_tier_level

def _write_ptl(bw: BitWriter, ptl: ProfileTierLevel) -> None:
    bw.write(0, 2)                               # general_profile_space
    bw.write(ptl.general_tier_flag, 1)
    bw.write(ptl.general_profile_idc, 5)
    bw.write(ptl.general_profile_compatibility, 32)
    bw.write(1, 1)                               # progressive_source
    bw.write(0, 1)                               # interlaced_source
    bw.write(0, 1)                               # non_packed_constraint
    bw.write(0, 1)                               # frame_only_constraint
    if ptl.general_profile_idc in (4, 5):        # Main-RExt / HT-RExt
        # A.3.5/A.3.6 constraint flags (TEncCavlc codeProfileTier)
        from hmtpu_torch.common.constants import ChromaFormat
        bd = ptl.bit_depth_constraint
        cf = ptl.chroma_constraint
        bw.write_flag(bd <= 12)                  # max_12bit
        bw.write_flag(bd <= 10)                  # max_10bit
        bw.write_flag(bd <= 8)                   # max_8bit
        bw.write_flag(cf in (ChromaFormat.C422, ChromaFormat.C420,
                             ChromaFormat.C400))  # max_422chroma
        bw.write_flag(cf in (ChromaFormat.C420,
                             ChromaFormat.C400))  # max_420chroma
        bw.write_flag(cf == ChromaFormat.C400)   # max_monochrome
        bw.write_flag(ptl.intra_constraint)
        bw.write_flag(ptl.one_picture_only_constraint)
        bw.write_flag(ptl.lower_bit_rate_constraint)
        bw.write(0, 34)                          # reserved zero 34
        bw.write(0, 1)                           # inbld_flag
    else:
        bw.write(0, 44)                          # reserved 43 + inbld
    bw.write(ptl.general_level_idc, 8)


def _read_ptl(br: BitReader) -> ProfileTierLevel:
    br.read(2)
    tier = br.read(1)
    profile = br.read(5)
    compat = br.read(32)
    br.read(4)
    br.read(44)
    level = br.read(8)
    return ProfileTierLevel(profile, tier, level, compat)


# --------------------------------------------------------------------------
# VPS

def write_vps(vps: Vps) -> NalUnit:
    bw = BitWriter()
    bw.write(vps.vps_id, 4)
    bw.write(3, 2)                               # base_layer_internal+available
    bw.write(0, 6)                               # vps_max_layers_minus1
    bw.write(vps.max_sub_layers - 1, 3)
    bw.write(1, 1)                               # temporal_id_nesting
    bw.write(0xFFFF, 16)                         # reserved
    _write_ptl(bw, vps.ptl)
    bw.write(0, 1)                               # sub_layer_ordering_info
    bw.write_ue(vps.max_dec_pic_buffering - 1)
    bw.write_ue(vps.max_num_reorder_pics)
    bw.write_ue(0)                               # max_latency_increase
    bw.write(0, 6)                               # vps_max_layer_id
    bw.write_ue(0)                               # num_layer_sets_minus1
    bw.write(0, 1)                               # timing_info_present
    bw.write(0, 1)                               # vps_extension
    bw.write_rbsp_trailing_bits()
    return NalUnit(NalUnitType.VPS_NUT, bw.get_bytes())


# --------------------------------------------------------------------------
# SPS

def _write_hrd(bw: BitWriter, sps: Sps) -> None:
    """hrd_parameters(1, 0) (E.2.2): one NAL CPB, fixed picture rate."""
    bw.write_flag(True)                          # nal_hrd_parameters
    bw.write_flag(False)                         # vcl_hrd_parameters
    bw.write_flag(False)                         # sub_pic_hrd_params
    bw.write(0, 4)                               # bit_rate_scale
    bw.write(0, 4)                               # cpb_size_scale
    bw.write(23, 5)                              # initial_cpb_removal_delay_len-1
    bw.write(23, 5)                              # au_cpb_removal_delay_len-1
    bw.write(23, 5)                              # dpb_output_delay_len-1
    # sub-layer 0
    bw.write_flag(True)                          # fixed_pic_rate_general
    bw.write_ue(0)                               # elemental_duration_in_tc-1
    bw.write_ue(0)                               # cpb_cnt_minus1
    # sub_layer_hrd_parameters(0), NAL, j = 0
    bw.write_ue(max(sps.hrd_bit_rate // 64, 1) - 1)   # bit_rate_value-1
    bw.write_ue(max(sps.hrd_cpb_size // 16, 1) - 1)   # cpb_size_value-1
    bw.write_flag(False)                         # cbr_flag


def _read_hrd(br: BitReader, sps: Sps) -> None:
    nal = br.read_flag()
    vcl = br.read_flag()
    if nal or vcl:
        sub_pic = br.read_flag()
        if sub_pic:
            raise UnsupportedStream("sub_pic HRD parameters")
        br.read(4), br.read(4)                   # scales
        br.read(5), br.read(5), br.read(5)       # lengths
    fixed_general = br.read_flag()
    if not fixed_general:
        fixed_within = br.read_flag()
    else:
        fixed_within = True
    low_delay = False
    if fixed_within:
        br.read_ue()                             # elemental_duration
    else:
        low_delay = br.read_flag()
    cpb_cnt = 0 if low_delay else br.read_ue()
    for _ in range((cpb_cnt + 1) * (int(nal) + int(vcl))):
        sps.hrd_bit_rate = (br.read_ue() + 1) * 64
        sps.hrd_cpb_size = (br.read_ue() + 1) * 16
        br.read_flag()                           # cbr


def _write_vui(bw: BitWriter, sps: Sps) -> None:
    """vui_parameters (E.2.1), timing + HRD only."""
    bw.write_flag(False)                         # aspect_ratio_info
    bw.write_flag(False)                         # overscan_info
    bw.write_flag(False)                         # video_signal_type
    bw.write_flag(False)                         # chroma_loc_info
    bw.write_flag(False)                         # neutral_chroma
    bw.write_flag(False)                         # field_seq
    bw.write_flag(False)                         # frame_field_info
    bw.write_flag(False)                         # default_display_window
    bw.write_flag(True)                          # vui_timing_info
    bw.write(sps.num_units_in_tick, 32)
    bw.write(sps.time_scale, 32)
    bw.write_flag(False)                         # poc_proportional
    bw.write_flag(sps.hrd_present)
    if sps.hrd_present:
        _write_hrd(bw, sps)
    bw.write_flag(False)                         # bitstream_restriction


def _read_vui(br: BitReader, sps: Sps) -> None:
    """Full E.2.1 parse; optional groups our encoder never writes are
    skipped field-by-field (not asserted absent) so conformant
    third-party streams still decode."""
    if br.read_flag():                           # aspect_ratio_info
        if br.read(8) == 255:                    # EXTENDED_SAR
            br.read(16), br.read(16)
    if br.read_flag():                           # overscan_info
        br.read_flag()
    if br.read_flag():                           # video_signal_type
        br.read(3), br.read_flag()
        if br.read_flag():                       # colour_description
            br.read(8), br.read(8), br.read(8)
    if br.read_flag():                           # chroma_loc_info
        br.read_ue(), br.read_ue()
    br.read_flag()                               # neutral_chroma
    br.read_flag()                               # field_seq
    br.read_flag()                               # frame_field_info
    if br.read_flag():                           # default_display_window
        br.read_ue(), br.read_ue(), br.read_ue(), br.read_ue()
    if br.read_flag():                           # vui_timing_info
        sps.vui_timing_present = True
        sps.num_units_in_tick = br.read(32)
        sps.time_scale = br.read(32)
        if br.read_flag():                       # poc_proportional
            br.read_ue()
        sps.hrd_present = br.read_flag()
        if sps.hrd_present:
            _read_hrd(br, sps)
    if br.read_flag():                           # bitstream_restriction
        br.read_flag(), br.read_flag(), br.read_flag()
        br.read_ue(), br.read_ue(), br.read_ue()
        br.read_ue(), br.read_ue()


def write_sps(sps: Sps) -> NalUnit:
    bw = BitWriter()
    bw.write(sps.vps_id, 4)
    bw.write(0, 3)                               # max_sub_layers_minus1
    bw.write(1, 1)                               # temporal_id_nesting
    _write_ptl(bw, sps.ptl)
    bw.write_ue(sps.sps_id)
    bw.write_ue(int(sps.chroma_format))
    bw.write_ue(sps.pic_width)
    bw.write_ue(sps.pic_height)
    bw.write_flag(False)                         # conformance_window
    bw.write_ue(sps.bit_depth_luma - 8)
    bw.write_ue(sps.bit_depth_chroma - 8)
    bw.write_ue(sps.log2_max_pic_order_cnt_lsb - 4)
    bw.write_flag(False)                         # sub_layer_ordering_info
    bw.write_ue(sps.max_dec_pic_buffering - 1)
    bw.write_ue(sps.max_num_reorder_pics)
    bw.write_ue(0)                               # max_latency_increase
    bw.write_ue(sps.log2_min_cb_size - 3)
    bw.write_ue(sps.log2_ctu_size - sps.log2_min_cb_size)
    bw.write_ue(sps.log2_min_tb_size - 2)
    bw.write_ue(sps.log2_max_tb_size - sps.log2_min_tb_size)
    bw.write_ue(sps.max_transform_hierarchy_depth_inter)
    bw.write_ue(sps.max_transform_hierarchy_depth_intra)
    bw.write_flag(False)                         # scaling_list_enabled
    bw.write_flag(sps.amp_enabled)
    bw.write_flag(sps.sao_enabled)
    bw.write_flag(sps.pcm_enabled)
    bw.write_ue(sps.num_short_term_rps)
    bw.write_flag(sps.long_term_ref_pics_present)
    bw.write_flag(sps.temporal_mvp_enabled)
    bw.write_flag(sps.strong_intra_smoothing)
    bw.write_flag(sps.vui_timing_present)        # vui_parameters_present
    if sps.vui_timing_present:
        _write_vui(bw, sps)
    bw.write_flag(False)                         # sps_extension_present
    bw.write_rbsp_trailing_bits()
    return NalUnit(NalUnitType.SPS_NUT, bw.get_bytes())


def parse_sps(rbsp: bytes) -> Sps:
    br = BitReader(rbsp)
    sps = Sps()
    sps.vps_id = br.read(4)
    br.read(3)
    br.read(1)
    sps.ptl = _read_ptl(br)
    sps.sps_id = br.read_ue()
    sps.chroma_format = br.read_ue()
    sps.pic_width = br.read_ue()
    sps.pic_height = br.read_ue()
    if br.read_flag():
        br.read_ue(), br.read_ue(), br.read_ue(), br.read_ue()
    sps.bit_depth_luma = 8 + br.read_ue()
    sps.bit_depth_chroma = 8 + br.read_ue()
    sps.log2_max_pic_order_cnt_lsb = 4 + br.read_ue()
    sub_layer_info = br.read_flag()
    sps.max_dec_pic_buffering = br.read_ue() + 1
    sps.max_num_reorder_pics = br.read_ue()
    br.read_ue()
    sps.log2_min_cb_size = 3 + br.read_ue()
    sps.log2_ctu_size = sps.log2_min_cb_size + br.read_ue()
    sps.log2_min_tb_size = 2 + br.read_ue()
    sps.log2_max_tb_size = sps.log2_min_tb_size + br.read_ue()
    sps.max_transform_hierarchy_depth_inter = br.read_ue()
    sps.max_transform_hierarchy_depth_intra = br.read_ue()
    assert br.read_flag() == 0, "scaling lists unsupported"
    sps.amp_enabled = bool(br.read_flag())
    sps.sao_enabled = bool(br.read_flag())
    assert br.read_flag() == 0, "PCM unsupported"
    sps.num_short_term_rps = br.read_ue()
    assert sps.num_short_term_rps == 0, "RPS parsing lands with P slices"
    sps.long_term_ref_pics_present = bool(br.read_flag())
    sps.temporal_mvp_enabled = bool(br.read_flag())
    sps.strong_intra_smoothing = bool(br.read_flag())
    if br.read_flag():                           # vui_parameters_present
        _read_vui(br, sps)
    return sps


# --------------------------------------------------------------------------
# PPS

def write_pps(pps: Pps) -> NalUnit:
    bw = BitWriter()
    bw.write_ue(pps.pps_id)
    bw.write_ue(pps.sps_id)
    bw.write_flag(False)                         # dependent_slice_segments
    bw.write_flag(False)                         # output_flag_present
    bw.write(0, 3)                               # num_extra_slice_header_bits
    bw.write_flag(pps.sign_data_hiding)
    bw.write_flag(pps.cabac_init_present)
    bw.write_ue(pps.num_ref_idx_l0_default - 1)
    bw.write_ue(pps.num_ref_idx_l1_default - 1)
    bw.write_se(pps.init_qp - 26)
    bw.write_flag(pps.constrained_intra_pred)
    bw.write_flag(pps.transform_skip_enabled)
    bw.write_flag(pps.cu_qp_delta_enabled)
    if pps.cu_qp_delta_enabled:
        bw.write_ue(pps.diff_cu_qp_delta_depth)
    bw.write_se(pps.cb_qp_offset)
    bw.write_se(pps.cr_qp_offset)
    bw.write_flag(False)                         # slice_chroma_qp_offsets
    bw.write_flag(pps.weighted_pred)
    bw.write_flag(pps.weighted_bipred)
    bw.write_flag(pps.transquant_bypass_enabled)
    bw.write_flag(pps.tiles_enabled)
    bw.write_flag(pps.entropy_coding_sync_enabled)
    bw.write_flag(pps.loop_filter_across_slices)
    bw.write_flag(pps.deblocking_filter_control_present)
    if pps.deblocking_filter_control_present:
        bw.write_flag(pps.deblocking_filter_override_enabled)
        bw.write_flag(pps.deblocking_filter_disabled)
        if not pps.deblocking_filter_disabled:
            bw.write_se(pps.beta_offset_div2)
            bw.write_se(pps.tc_offset_div2)
    bw.write_flag(False)                         # pps_scaling_list_data
    bw.write_flag(pps.lists_modification_present)
    bw.write_ue(pps.log2_parallel_merge_level - 2)
    bw.write_flag(False)                         # slice_header_extension
    bw.write_flag(False)                         # pps_extension
    bw.write_rbsp_trailing_bits()
    return NalUnit(NalUnitType.PPS_NUT, bw.get_bytes())


def parse_pps(rbsp: bytes) -> Pps:
    br = BitReader(rbsp)
    pps = Pps()
    pps.pps_id = br.read_ue()
    pps.sps_id = br.read_ue()
    assert br.read_flag() == 0
    br.read_flag()
    br.read(3)
    pps.sign_data_hiding = bool(br.read_flag())
    pps.cabac_init_present = bool(br.read_flag())
    pps.num_ref_idx_l0_default = br.read_ue() + 1
    pps.num_ref_idx_l1_default = br.read_ue() + 1
    pps.init_qp = 26 + br.read_se()
    pps.constrained_intra_pred = bool(br.read_flag())
    pps.transform_skip_enabled = bool(br.read_flag())
    pps.cu_qp_delta_enabled = bool(br.read_flag())
    if pps.cu_qp_delta_enabled:
        pps.diff_cu_qp_delta_depth = br.read_ue()
    pps.cb_qp_offset = br.read_se()
    pps.cr_qp_offset = br.read_se()
    br.read_flag()
    pps.weighted_pred = bool(br.read_flag())
    pps.weighted_bipred = bool(br.read_flag())
    pps.transquant_bypass_enabled = bool(br.read_flag())
    pps.tiles_enabled = bool(br.read_flag())
    pps.entropy_coding_sync_enabled = bool(br.read_flag())
    pps.loop_filter_across_slices = bool(br.read_flag())
    pps.deblocking_filter_control_present = bool(br.read_flag())
    if pps.deblocking_filter_control_present:
        pps.deblocking_filter_override_enabled = bool(br.read_flag())
        pps.deblocking_filter_disabled = bool(br.read_flag())
        if not pps.deblocking_filter_disabled:
            pps.beta_offset_div2 = br.read_se()
            pps.tc_offset_div2 = br.read_se()
    return pps


# --------------------------------------------------------------------------
# slice segment header

@dataclass
class SliceHeader:
    slice_type: SliceType = SliceType.I
    pps_id: int = 0
    slice_qp: int = 26
    pic_order_cnt_lsb: int = 0
    first_slice: bool = True
    nal_type: NalUnitType = NalUnitType.IDR_W_RADL
    # short_term_ref_pic_set signalled in the slice (low-delay: negative
    # refs only): list of (delta_poc > 0 meaning POC - delta, used_flag)
    negative_refs: list = None
    num_ref_idx_l0: int = 1
    num_ref_idx_override: bool = True
    sao_luma: bool = False
    sao_chroma: bool = False
    # B slices: positive (future-POC) references and the L1 list size
    positive_refs: list = None
    num_ref_idx_l1: int = 0
    mvd_l1_zero: bool = False
    five_minus_max_num_merge_cand: int = 3
    # TMVP (7.3.6.1): per-slice enable + collocated picture index
    temporal_mvp: bool = False
    collocated_ref_idx: int = 0
    # filled by parser: bit offset where slice data (CABAC) starts
    data_start_byte: int = 0
    # WPP/tiles: per-substream byte sizes (emulation-prevention bytes
    # counted, 7.4.7.1); writer input / parser output
    entry_point_offsets: list = None

    @property
    def max_num_merge_cand(self) -> int:
        return 5 - self.five_minus_max_num_merge_cand


def write_slice_header(sh: SliceHeader, sps: Sps, pps: Pps) -> BitWriter:
    """Returns an unaligned BitWriter positioned after byte_alignment();
    caller appends CABAC data bytes."""
    bw = BitWriter()
    bw.write_flag(sh.first_slice)
    if NalUnitType.BLA_W_LP <= sh.nal_type <= 23:  # IRAP
        bw.write_flag(False)                     # no_output_of_prior_pics
    bw.write_ue(sh.pps_id)
    bw.write_ue(int(sh.slice_type))
    if sh.nal_type not in (NalUnitType.IDR_W_RADL, NalUnitType.IDR_N_LP):
        bw.write(sh.pic_order_cnt_lsb
                 & ((1 << sps.log2_max_pic_order_cnt_lsb) - 1),
                 sps.log2_max_pic_order_cnt_lsb)
        bw.write_flag(False)                     # st_rps_sps_flag: explicit
        # short_term_ref_pic_set() (7.3.7): slice-signalled, negative only.
        # inter_ref_pic_set_prediction_flag absent (sps has 0 RPS).
        assert sps.num_short_term_rps == 0
        negs = sh.negative_refs or []
        poss = sh.positive_refs or []
        bw.write_ue(len(negs))                   # num_negative_pics
        bw.write_ue(len(poss))                   # num_positive_pics
        prev = 0
        for delta_poc, used in negs:
            bw.write_ue(delta_poc - prev - 1)    # delta_poc_s0_minus1
            bw.write_flag(used)
            prev = delta_poc
        prev = 0
        for delta_poc, used in poss:
            bw.write_ue(delta_poc - prev - 1)    # delta_poc_s1_minus1
            bw.write_flag(used)
            prev = delta_poc
        if sps.long_term_ref_pics_present:
            raise NotImplementedError
        if sps.temporal_mvp_enabled:
            bw.write_flag(sh.temporal_mvp)
    if sps.sao_enabled:
        bw.write_flag(sh.sao_luma)
        bw.write_flag(sh.sao_chroma)
    if sh.slice_type != SliceType.I:
        bw.write_flag(sh.num_ref_idx_override)
        if sh.num_ref_idx_override:
            bw.write_ue(sh.num_ref_idx_l0 - 1)
            if sh.slice_type == SliceType.B:
                bw.write_ue(sh.num_ref_idx_l1 - 1)
        assert not pps.lists_modification_present
        if sh.slice_type == SliceType.B:
            bw.write_flag(sh.mvd_l1_zero)
        assert not pps.cabac_init_present
        if sh.temporal_mvp:
            if sh.slice_type == SliceType.B:
                bw.write_flag(True)              # collocated_from_l0
            if sh.num_ref_idx_l0 > 1:
                bw.write_ue(sh.collocated_ref_idx)
        assert not (pps.weighted_pred or pps.weighted_bipred)
        bw.write_ue(sh.five_minus_max_num_merge_cand)
    bw.write_se(sh.slice_qp - pps.init_qp)
    # deblocking override absent (pps override_enabled false)
    if pps.loop_filter_across_slices and \
            (sh.sao_luma or sh.sao_chroma
             or not pps.deblocking_filter_disabled):
        bw.write_flag(pps.loop_filter_across_slices)
    if pps.tiles_enabled or pps.entropy_coding_sync_enabled:
        # entry_point_offset_minus1 values count emulation-prevention
        # bytes (the decoder subtracts them back,
        # TDecCAVLC.cpp:1485-1516); sh.entry_point_offsets carries the
        # already-EP-adjusted sizes from the entropy pass
        offs = sh.entry_point_offsets or []
        bw.write_ue(len(offs))
        if offs:
            max_off = max(offs)
            ln = 0
            while max_off >= (1 << (ln + 1)):
                ln += 1
            bw.write_ue(ln)
            for o in offs:
                bw.write(o - 1, ln + 1)
    bw.write_byte_alignment()
    return bw


def parse_slice_header(rbsp: bytes, sps: Sps, pps: Pps,
                       nal_type: NalUnitType) -> SliceHeader:
    br = BitReader(rbsp)
    sh = SliceHeader(nal_type=nal_type)
    sh.first_slice = bool(br.read_flag())
    if NalUnitType.BLA_W_LP <= nal_type <= 23:
        br.read_flag()
    sh.pps_id = br.read_ue()
    sh.slice_type = SliceType(br.read_ue())
    if nal_type not in (NalUnitType.IDR_W_RADL, NalUnitType.IDR_N_LP):
        sh.pic_order_cnt_lsb = br.read(sps.log2_max_pic_order_cnt_lsb)
        st_sps = br.read_flag()
        assert not st_sps, "SPS-indexed RPS not in envelope"
        n_neg = br.read_ue()
        n_pos = br.read_ue()
        sh.negative_refs = []
        prev = 0
        for _ in range(n_neg):
            delta = prev + br.read_ue() + 1
            used = bool(br.read_flag())
            sh.negative_refs.append((delta, used))
            prev = delta
        sh.positive_refs = []
        prev = 0
        for _ in range(n_pos):
            delta = prev + br.read_ue() + 1
            used = bool(br.read_flag())
            sh.positive_refs.append((delta, used))
            prev = delta
        if sps.temporal_mvp_enabled:
            sh.temporal_mvp = bool(br.read_flag())
    if sps.sao_enabled:
        sh.sao_luma = bool(br.read_flag())
        sh.sao_chroma = bool(br.read_flag())
    if sh.slice_type != SliceType.I:
        sh.num_ref_idx_override = bool(br.read_flag())
        if sh.num_ref_idx_override:
            sh.num_ref_idx_l0 = br.read_ue() + 1
            if sh.slice_type == SliceType.B:
                sh.num_ref_idx_l1 = br.read_ue() + 1
        else:
            sh.num_ref_idx_l0 = pps.num_ref_idx_l0_default
        if sh.slice_type == SliceType.B:
            sh.mvd_l1_zero = bool(br.read_flag())
        if sh.temporal_mvp:
            col_l0 = True
            if sh.slice_type == SliceType.B:
                col_l0 = bool(br.read_flag())
            if (col_l0 and sh.num_ref_idx_l0 > 1) or \
                    (not col_l0 and sh.num_ref_idx_l1 > 1):
                sh.collocated_ref_idx = br.read_ue()
        sh.five_minus_max_num_merge_cand = br.read_ue()
    sh.slice_qp = pps.init_qp + br.read_se()
    if pps.loop_filter_across_slices and \
            (sh.sao_luma or sh.sao_chroma
             or not pps.deblocking_filter_disabled):
        br.read_flag()        # slice_loop_filter_across_slices
    if pps.tiles_enabled or pps.entropy_coding_sync_enabled:
        n_entry = br.read_ue()
        sh.entry_point_offsets = []
        if n_entry:
            ln = br.read_ue()
            for _ in range(n_entry):
                sh.entry_point_offsets.append(br.read(ln + 1) + 1)
    one = br.read(1)          # alignment_bit_equal_to_one (7.3.2.10)
    assert one == 1, "byte_alignment desync"
    br.byte_align()
    sh.data_start_byte = br.bit_position // 8
    return sh
