"""Parameter sets and encoder configuration.

Capability parity with the parameter-set data model of TComSlice.h
(TComVPS :435, TComSPS :778, TComPPS :1072) reduced to the fields our
encoder actually signals; every field name mirrors the H.265 syntax
element it produces so the header writers read like the spec tables.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from hmtpu_torch.common.constants import ChromaFormat


@dataclass
class ProfileTierLevel:
    general_profile_idc: int = 1        # Main (4 = Main-RExt,
    general_tier_flag: int = 0          #  5 = High-Throughput-RExt)
    general_level_idc: int = 123        # level 4.1
    general_profile_compatibility: int = 1 << 1  # Main
    # RExt constraint flags (A.3.5/A.3.6, coded for profile_idc 4/5;
    # reference: TEncCavlc codeProfileTier RExt branch,
    # TComSlice.h:723 PTL fields)
    bit_depth_constraint: int = 8
    chroma_constraint: ChromaFormat = ChromaFormat.C420
    intra_constraint: bool = False
    one_picture_only_constraint: bool = False
    lower_bit_rate_constraint: bool = True


@dataclass
class Vps:
    vps_id: int = 0
    max_sub_layers: int = 1
    max_dec_pic_buffering: int = 4
    max_num_reorder_pics: int = 0
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)


@dataclass
class Sps:
    sps_id: int = 0
    vps_id: int = 0
    chroma_format: ChromaFormat = ChromaFormat.C420
    pic_width: int = 416
    pic_height: int = 240
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    log2_max_pic_order_cnt_lsb: int = 8
    max_dec_pic_buffering: int = 4
    max_num_reorder_pics: int = 0
    log2_min_cb_size: int = 3
    log2_ctu_size: int = 6
    log2_min_tb_size: int = 2
    log2_max_tb_size: int = 5
    max_transform_hierarchy_depth_inter: int = 0
    max_transform_hierarchy_depth_intra: int = 0
    amp_enabled: bool = False
    sao_enabled: bool = False
    pcm_enabled: bool = False
    num_short_term_rps: int = 0
    long_term_ref_pics_present: bool = False
    temporal_mvp_enabled: bool = False
    strong_intra_smoothing: bool = True
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)
    # VUI timing + HRD (E.2.1/E.2.2; TComSlice.h TComVUI/TComHRD) —
    # off by default like the BASELINE configs; enabled by the
    # buffering-period SEI path
    vui_timing_present: bool = False
    hrd_present: bool = False
    num_units_in_tick: int = 1
    time_scale: int = 50
    hrd_bit_rate: int = 1_000_000      # bps (rounded to 64-bit units)
    hrd_cpb_size: int = 2_000_000      # bits (rounded to 16-bit units)

    @property
    def ctu_size(self) -> int:
        return 1 << self.log2_ctu_size

    @property
    def pic_width_in_ctus(self) -> int:
        return (self.pic_width + self.ctu_size - 1) >> self.log2_ctu_size

    @property
    def pic_height_in_ctus(self) -> int:
        return (self.pic_height + self.ctu_size - 1) >> self.log2_ctu_size


@dataclass
class Pps:
    pps_id: int = 0
    sps_id: int = 0
    sign_data_hiding: bool = False
    cabac_init_present: bool = False
    num_ref_idx_l0_default: int = 1
    num_ref_idx_l1_default: int = 1
    init_qp: int = 26
    constrained_intra_pred: bool = False
    transform_skip_enabled: bool = False
    cu_qp_delta_enabled: bool = False
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    weighted_pred: bool = False
    weighted_bipred: bool = False
    transquant_bypass_enabled: bool = False
    tiles_enabled: bool = False
    entropy_coding_sync_enabled: bool = False
    loop_filter_across_slices: bool = True
    deblocking_filter_control_present: bool = True
    deblocking_filter_override_enabled: bool = False
    deblocking_filter_disabled: bool = True
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    lists_modification_present: bool = False
    log2_parallel_merge_level: int = 2
