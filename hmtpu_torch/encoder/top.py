"""Encoder top level: parameter sets, GOP walk and access-unit assembly
(the port of hmtpu/encoder/top.py: `EncoderConfig`, and `Encoder` with
`encode_sequence` :379 and `encode_frame_au` :582) on the all-intra
path.

`Encoder(cfg, device="cuda")` runs the frame passes on the card and
raises when there is none; `device="cpu"` runs the plain PyTorch
versions of every kernel.  Options outside the all-intra slice raise
NotImplementedError naming their ROADMAP.md item.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from hmtpu_torch.common.constants import NalUnitType, SliceType
from hmtpu_torch.common.params import Pps, Sps, Vps
from hmtpu_torch.device import resolve
from hmtpu_torch.encoder.intra import IntraFrameEncoder
from hmtpu_torch.entropy.headers import (
    SliceHeader,
    write_pps,
    write_slice_header,
    write_sps,
    write_vps,
)
from hmtpu_torch.io.hashsei import make_hash_sei_nal, picture_md5
from hmtpu_torch.io.nal import NalUnit, write_annexb
from hmtpu_torch.io.yuv import Frame
from hmtpu_torch.ops.sao import grid_from_packed


@dataclass
class EncoderConfig:
    width: int = 416
    height: int = 240
    qp: int = 32
    bit_depth: int = 8
    # profile signalled in the PTL: "" = derive (main), "main-rext" /
    # "high-throughput-rext" add the A.3.5/A.3.6 constraint flags
    profile: str = ""
    ctu_size: int = 64
    decoded_picture_hash: bool = True
    sign_data_hiding: bool = True   # HM SignHideFlag default
    frames: int = 0            # 0 = all
    deblock: bool = True       # in-loop deblocking filter
    sao: bool = True           # sample adaptive offset
    # GOP: "ai" = all intra ("ldp" / "ra" come with the P/B slices)
    gop: str = "ai"
    intra_period: int = 0
    num_refs: int = 1
    # fractional-pel strategy of the P path: "nn", "dctif", "none"
    subpel: str = "dctif"
    # RDOQ flag of the P path; the I pass always runs the trellis
    rdoq: bool = True
    transform_skip: bool = False
    wpp: bool = False
    decision: str = "scan"
    # the device wavefront pass (the only I-frame path of the port)
    wavefront: bool = True
    nn_weights_dir: str | None = None
    search_range: int = 16
    max_num_merge_cand: int = 5
    tmvp: bool = True
    gop_qp_offsets: tuple = ()
    gop_qp_factors: tuple = ()
    # R-lambda rate control; 0 = fixed QP
    target_kbps: float = 0.0
    frame_rate: float = 50.0
    # prefix-SEI messages (io/sei.py)
    sei_active_parameter_sets: bool = False
    sei_recovery_point: bool = False
    sei_pic_timing: bool = False
    sei_buffering_period: bool = False


@dataclass
class FrameResult:
    poc: int
    bits: int
    psnr_y: float
    psnr_u: float
    psnr_v: float
    seconds: float
    slice_type: str = "I"


def psnr(org: np.ndarray, rec: np.ndarray, maxv: int) -> float:
    mse = np.mean((org.astype(np.float64) - rec.astype(np.float64)) ** 2)
    if mse == 0:
        return 999.99
    return 10.0 * np.log10(maxv * maxv / mse)


def _check_slice(cfg: EncoderConfig) -> None:
    """Raise for options outside the all-intra slice of the port."""
    todo = (
        (cfg.gop != "ai",
         f"gop={cfg.gop!r}: the LDP path (ROADMAP.md A2-A5, A8, A10, A12)"
         " and the RA path (A17)"),
        (cfg.transform_skip, "transform skip (ROADMAP.md A14)"),
        (cfg.bit_depth != 8, "Main10 (ROADMAP.md A15)"),
        (not cfg.wavefront,
         "wavefront=False: the host-loop encoders (ROADMAP.md, not "
         "ported)"),
        (cfg.target_kbps > 0, "rate control (ROADMAP.md A16)"),
        (cfg.wpp, "WPP substreams (ROADMAP.md A16)"),
    )
    for bad, what in todo:
        if bad:
            raise NotImplementedError(f"hmtpu_torch: {what} is not "
                                      f"ported yet")


class Encoder:
    def __init__(self, cfg: EncoderConfig, device="cuda"):
        _check_slice(cfg)
        self.device = resolve(device)
        self.cfg = cfg
        self.sps = Sps(
            pic_width=cfg.width, pic_height=cfg.height,
            bit_depth_luma=cfg.bit_depth, bit_depth_chroma=cfg.bit_depth,
            log2_ctu_size=cfg.ctu_size.bit_length() - 1,
            sao_enabled=cfg.sao,
            temporal_mvp_enabled=False,
        )
        if cfg.sei_buffering_period:
            self.sps.vui_timing_present = True
            self.sps.hrd_present = True
            self.sps.time_scale = int(cfg.frame_rate * 1000)
            self.sps.num_units_in_tick = 1000
        prof = (cfg.profile or "").lower().replace("_", "-")
        if prof in ("main-rext", "high-throughput-rext"):
            # RExt profile signalling (A.3.5/A.3.6): constraint flags
            # describe the coded stream's envelope
            idc = 4 if prof == "main-rext" else 5
            self.sps.ptl.general_profile_idc = idc
            self.sps.ptl.general_profile_compatibility = 1 << idc
            self.sps.ptl.bit_depth_constraint = max(cfg.bit_depth, 8)
            self.sps.ptl.chroma_constraint = self.sps.chroma_format
            self.sps.ptl.intra_constraint = True
            self.sps.ptl.lower_bit_rate_constraint = True
        elif prof not in ("", "main", "main10"):
            raise ValueError(f"unsupported profile {cfg.profile}")
        self.pps = Pps(init_qp=cfg.qp, sign_data_hiding=cfg.sign_data_hiding,
                       deblocking_filter_disabled=not cfg.deblock,
                       transform_skip_enabled=False,
                       entropy_coding_sync_enabled=False)
        self.vps = Vps(max_dec_pic_buffering=self.sps.max_dec_pic_buffering,
                       max_num_reorder_pics=self.sps.max_num_reorder_pics,
                       ptl=self.sps.ptl)
        self.results: list[FrameResult] = []
        self._poc_base = 0

    def encode_sequence(self, frames: list[Frame]) -> bytes:
        """Encode `frames` as one all-intra sequence (every picture an
        IDR); returns the Annex-B byte stream."""
        out = bytearray()
        poc0 = self._poc_base
        for i, frame in enumerate(frames):
            out.extend(write_annexb(self.encode_frame_au(frame, poc0 + i)))
        self._poc_base = poc0 + len(frames)
        return bytes(out)

    def _prefix_seis(self, is_idr: bool) -> list[NalUnit]:
        """Access-unit prefix SEI per HM's TEncGOP SEI assembly:
        active_parameter_sets + recovery_point at IRAPs, pic_timing
        per picture (all config-gated, defaults off)."""
        from hmtpu_torch.io import sei

        cfg = self.cfg
        msgs = []
        if is_idr and cfg.sei_active_parameter_sets:
            msgs.append(sei.active_parameter_sets())
        if is_idr and cfg.sei_recovery_point:
            msgs.append(sei.recovery_point())
        if cfg.sei_buffering_period:
            if is_idr:
                init = min(self.sps.hrd_cpb_size * 90000
                           // max(self.sps.hrd_bit_rate, 1), 0xFFFFFF)
                msgs.append(sei.buffering_period(self.sps.sps_id,
                                                 init))
                self._au_since_bp = 0
            # HRD signalled => pic_timing with CPB/DPB clocks per AU
            n = getattr(self, "_au_since_bp", 0)
            msgs.append(sei.pic_timing_hrd(
                max(n - 1, 0) if not is_idr else 0,
                self.sps.max_num_reorder_pics + 1))
            self._au_since_bp = n + 1
        elif cfg.sei_pic_timing:
            msgs.append(sei.pic_timing_frame_field())
        return [sei.prefix_sei_nal(msgs)] if msgs else []

    def encode_frame_au(self, frame: Frame, poc: int) -> list[NalUnit]:
        """One IDR access unit: parameter sets (first picture), prefix
        SEI, the I slice, and the decoded-picture-hash SEI."""
        t0 = time.time()
        cfg = self.cfg
        qp = cfg.qp
        nals: list[NalUnit] = []
        if poc == 0:
            nals += [write_vps(self.vps), write_sps(self.sps),
                     write_pps(self.pps)]
        nals += self._prefix_seis(True)

        fe = IntraFrameEncoder(self.sps, self.pps, self.device)
        # I-slice lambda QP factor of an all-intra GOP
        # (TEncSlice::initEncSlice I_SLICE branch)
        recon, decisions, mode8, depth8 = fe.analyze_device(
            frame, qp, lam_factor=0.57, deblock=cfg.deblock,
            sao=bool(self.sps.sao_enabled))
        sh = SliceHeader(slice_type=SliceType.I, pps_id=0, slice_qp=qp,
                         nal_type=NalUnitType.IDR_W_RADL)
        sao = None
        if self.sps.sao_enabled:
            ny = self.sps.pic_height_in_ctus
            nx = self.sps.pic_width_in_ctus
            grid = grid_from_packed(fe._sao_packed.reshape(ny, nx, 3, 7))
            sh.sao_luma = True
            sh.sao_chroma = True
            sao = (grid, True, True)
        slice_rbsp = fe._entropy_pass(qp, mode8, depth8, decisions, sao=sao)

        bw = write_slice_header(sh, self.sps, self.pps)
        bw.write_bytes(slice_rbsp)
        nals.append(NalUnit(sh.nal_type, bw.get_bytes()))
        if cfg.decoded_picture_hash:
            digests = picture_md5(recon.planes(), [cfg.bit_depth] * 3)
            nals.append(make_hash_sei_nal(digests))

        maxv = (1 << cfg.bit_depth) - 1
        total_bits = sum(len(n.to_bytes()) * 8 for n in nals)
        self.results.append(FrameResult(
            poc, total_bits,
            psnr(frame.y, recon.y, maxv),
            psnr(frame.u, recon.u, maxv),
            psnr(frame.v, recon.v, maxv),
            time.time() - t0, "I"))
        return nals
