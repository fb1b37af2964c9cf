"""SEI message assembly beyond the decoded-picture hash.

Capability parity with SEIEncoder.cpp / SEIwrite.cpp (payload types
SEI.h:55-77): active_parameter_sets (SEIEncoder.cpp:94,
initSEIActiveParameterSets), recovery_point (:122,
initSEIRecoveryPoint), picture timing's pic_struct signalling
(TEncGOP's xCreatePictureTimingSEI — emitted here only in its
frame-field-info form, since the BASELINE configs signal no HRD and
the reference therefore emits no buffering-period/timing clocks), and
user_data_unregistered.  All messages are prefix SEI and, like HM,
config-gated (off in the five BASELINE configs).
"""
from __future__ import annotations

import uuid

from hmtpu_torch.common.constants import NalUnitType
from hmtpu_torch.io.bitstream import BitWriter
from hmtpu_torch.io.nal import NalUnit

SEI_BUFFERING_PERIOD = 0
SEI_PIC_TIMING = 1
SEI_USER_DATA_UNREGISTERED = 5
SEI_RECOVERY_POINT = 6
SEI_ACTIVE_PARAMETER_SETS = 129


def _sei_message(ptype: int, payload_bits: BitWriter) -> bytes:
    """Wrap payload bits as one sei_message() (D.2.1): 0xFF-chained
    type/size, payload byte-aligned with bit_equal_to_one padding."""
    payload_bits = BitWriter() if payload_bits is None else payload_bits
    if payload_bits.bit_position % 8:
        payload_bits.write_flag(True)        # payload_bit_equal_to_one
        while payload_bits.bit_position % 8:
            payload_bits.write_flag(False)   # payload_bit_equal_to_zero
    payload = payload_bits.get_bytes()
    bw = BitWriter()
    t = ptype
    while t >= 255:
        bw.write_byte(255)
        t -= 255
    bw.write_byte(t)
    s = len(payload)
    while s >= 255:
        bw.write_byte(255)
        s -= 255
    bw.write_byte(s)
    bw.write_bytes(payload)
    return bw.get_bytes()


def prefix_sei_nal(messages: list[bytes], temporal_id: int = 0) -> NalUnit:
    bw = BitWriter()
    for m in messages:
        bw.write_bytes(m)
    bw.write_rbsp_trailing_bits()
    return NalUnit(NalUnitType.PREFIX_SEI_NUT, bw.get_bytes(),
                   temporal_id)


def active_parameter_sets(sps_id: int = 0,
                          full_random_access: bool = False) -> bytes:
    """active_parameter_sets (D.2.21; SEIEncoder.cpp:94)."""
    bw = BitWriter()
    bw.write(0, 4)                           # active_video_parameter_set_id
    bw.write_flag(full_random_access)        # self_contained_cvs_flag
    bw.write_flag(False)                     # no_parameter_set_update_flag
    bw.write_ue(0)                           # num_sps_ids_minus1
    bw.write_ue(sps_id)                      # active_seq_parameter_set_id
    return _sei_message(SEI_ACTIVE_PARAMETER_SETS, bw)


def recovery_point(recovery_poc_cnt: int = 0, exact_match: bool = True,
                   broken_link: bool = False) -> bytes:
    """recovery_point (D.2.8; SEIEncoder.cpp:122 sets poc_cnt 0 /
    exact-match at every intra refresh)."""
    bw = BitWriter()
    bw.write_se(recovery_poc_cnt)
    bw.write_flag(exact_match)
    bw.write_flag(broken_link)
    return _sei_message(SEI_RECOVERY_POINT, bw)


def pic_timing_frame_field(pic_struct: int = 0,
                           source_scan_type: int = 1) -> bytes:
    """pic_timing carrying only the frame_field_info fields (D.2.3 with
    frame_field_info_present_flag; the CPB/DPB removal clocks require
    HRD parameters which, like the reference configs, we do not
    signal)."""
    bw = BitWriter()
    bw.write(pic_struct, 4)                  # pic_struct (progressive 0)
    bw.write(source_scan_type, 2)            # 1 = progressive
    bw.write_flag(False)                     # duplicate_flag
    return _sei_message(SEI_PIC_TIMING, bw)


def buffering_period(sps_id: int, init_delay_90k: int) -> bytes:
    """buffering_period (D.2.2; SEIEncoder initSEIBufferingPeriod):
    one NAL CPB, 24-bit delay fields as signalled in hrd_parameters.
    init_delay_90k = initial CPB removal delay in 90 kHz units
    (typically cpb_size / bit_rate * 90000)."""
    bw = BitWriter()
    bw.write_ue(sps_id)
    bw.write_flag(False)                     # irap_cpb_params_present
    bw.write_flag(False)                     # concatenation_flag
    bw.write(0, 24)                          # au_cpb_removal_delay_delta-1
    bw.write(init_delay_90k & 0xFFFFFF, 24)  # initial_cpb_removal_delay
    bw.write(0, 24)                          # initial_cpb_removal_offset
    return _sei_message(SEI_BUFFERING_PERIOD, bw)


def pic_timing_hrd(au_cpb_removal_delay_minus1: int,
                   pic_dpb_output_delay: int) -> bytes:
    """pic_timing in its CPB/DPB-clock form (D.2.3 with
    CpbDpbDelaysPresentFlag=1, frame_field_info absent — matches the
    VUI our HRD path signals)."""
    bw = BitWriter()
    bw.write(au_cpb_removal_delay_minus1 & 0xFFFFFF, 24)
    bw.write(pic_dpb_output_delay & 0xFFFFFF, 24)
    return _sei_message(SEI_PIC_TIMING, bw)


def user_data_unregistered(text: bytes,
                           uuid_bytes: bytes | None = None) -> bytes:
    """user_data_unregistered (D.2.7)."""
    bw = BitWriter()
    bw.write_bytes(uuid_bytes or uuid.uuid5(uuid.NAMESPACE_DNS,
                                            "hmtpu").bytes)
    bw.write_bytes(text)
    return _sei_message(SEI_USER_DATA_UNREGISTERED, bw)
