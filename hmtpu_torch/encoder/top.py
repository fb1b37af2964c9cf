"""Encoder top level: parameter sets, GOP walk and access-unit assembly
(the port of hmtpu/encoder/top.py: `EncoderConfig`, and `Encoder` with
`gop_depth` :113, `lambda_qp_factor` :136, `_load_nn` :224,
`_ldp_lists` :277, `RA_GOP8` and `_ra_schedule` :302-324,
`encode_sequence` :379, `_launch_p` :458, `_finish_p` :514 and
`encode_frame_au` :582) on the all-intra, low-delay-P and random-access
paths, at 8 and 10 bits (Main and Main10).

Random access codes hierarchical GOP-8 B pictures one access unit at a
time, as the reference does (no launch/finish pipeline): the B slice's
device pass and its host side run back to back.

`Encoder(cfg, device="cuda")` runs the frame passes on the card and
raises when there is none; `device="cpu"` runs the plain PyTorch
versions of every kernel.  Options outside the ported slices raise
NotImplementedError naming their ROADMAP.md item.
"""
from __future__ import annotations

import os
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

ROADMAP_CKPT = "checkpoint / resume (ROADMAP.md A16)"


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
    # GOP: "ai" = all intra, "ldp" = low-delay P, "ra" = random access
    # (hierarchical GOP-8 B pictures)
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
    # P frames: the device pass (host dispatch + the wait for the card)
    # and the host side (state unpack, CABAC, hash), in seconds
    device_seconds: float = 0.0
    host_seconds: float = 0.0


def psnr(org: np.ndarray, rec: np.ndarray, maxv: int) -> float:
    mse = np.mean((org.astype(np.float64) - rec.astype(np.float64)) ** 2)
    if mse == 0:
        return 999.99
    return 10.0 * np.log10(maxv * maxv / mse)


def gop_depth(poc: int, gop_size: int) -> int:
    """Hierarchy depth of a POC within the GOP (TEncSlice::initEncSlice
    depth derivation): 0 for GOP-aligned pictures, >0 otherwise; HM
    scales lambda by Clip3(2,4,(qp-12)/6) whenever depth > 0."""
    p = poc % gop_size
    if p == 0:
        return 0
    depth = 0
    step = gop_size
    i = step >> 1
    while i >= 1:
        for j in range(i, gop_size, step):
            if j == p:
                i = 0
                break
        step >>= 1
        depth += 1
        if i == 0:
            break
        i >>= 1
    return depth


def lambda_qp_factor(base_factor: float, qp: int, depth: int) -> float:
    """HM's per-slice lambda = factor * 2^((qp-12)/3), with the depth
    scale for non-anchor pictures (TEncSlice.cpp initEncSlice)."""
    f = base_factor
    if depth > 0:
        f *= min(max((qp - 12) / 6.0, 2.0), 4.0)
    return f


def _check_slice(cfg: EncoderConfig) -> None:
    """Raise for options outside the ported slices."""
    if cfg.gop not in ("ai", "ldp", "ra"):
        raise ValueError(f"unknown gop {cfg.gop!r}")
    todo = (
        (cfg.gop == "ldp" and cfg.decision != "scan",
         f"decision={cfg.decision!r}: the Jacobi decision (ROADMAP.md, "
         f"never ported)"),
        (cfg.bit_depth not in (8, 10),
         f"bit_depth={cfg.bit_depth}: the RExt bit depths (ROADMAP.md "
         f"A15)"),
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
        if cfg.gop == "ldp" and not cfg.gop_qp_offsets:
            # HM low-delay-P GOP4 defaults (Frame1..4 rows)
            cfg.gop_qp_offsets = (3, 2, 3, 1)
            cfg.gop_qp_factors = (0.4624, 0.4624, 0.4624, 0.578)
            if cfg.num_refs == 1:
                cfg.num_refs = 4     # HM LDP: four active references
        self.sps = Sps(
            pic_width=cfg.width, pic_height=cfg.height,
            bit_depth_luma=cfg.bit_depth, bit_depth_chroma=cfg.bit_depth,
            log2_ctu_size=cfg.ctu_size.bit_length() - 1,
            sao_enabled=cfg.sao,
            temporal_mvp_enabled=cfg.tmvp and cfg.gop == "ldp"
            and cfg.wavefront,
        )
        if cfg.gop == "ra":
            # hierarchical GOP-8: up to 4 retained refs + reordering
            self.sps.max_dec_pic_buffering = 6
            self.sps.max_num_reorder_pics = 4
        elif cfg.gop == "ldp":
            # HM LDP RPS keeps GOP anchors + startup recents (up to 7)
            self.sps.max_dec_pic_buffering = 8
        if cfg.sei_buffering_period and cfg.gop == "ra":
            # pic_timing_hrd writes a constant dpb_output_delay, which
            # is only conformant when the stream has no reordering
            raise ValueError("sei_buffering_period supports ai/ldp GOPs")
        if cfg.sei_buffering_period:
            self.sps.vui_timing_present = True
            self.sps.hrd_present = True
            self.sps.time_scale = int(cfg.frame_rate * 1000)
            self.sps.num_units_in_tick = 1000
        if cfg.bit_depth == 10:
            # Main10 profile signalling (A.3.3)
            self.sps.ptl.general_profile_idc = 2
            self.sps.ptl.general_profile_compatibility = 1 << 2
        prof = (cfg.profile or "").lower().replace("_", "-")
        if prof in ("main-rext", "high-throughput-rext"):
            # RExt profile signalling (A.3.5/A.3.6): constraint flags
            # describe the coded stream's envelope
            idc = 4 if prof == "main-rext" else 5
            self.sps.ptl.general_profile_idc = idc
            self.sps.ptl.general_profile_compatibility = 1 << idc
            self.sps.ptl.bit_depth_constraint = max(cfg.bit_depth, 8)
            self.sps.ptl.chroma_constraint = self.sps.chroma_format
            self.sps.ptl.intra_constraint = \
                prof == "high-throughput-rext" or cfg.gop == "ai"
            self.sps.ptl.lower_bit_rate_constraint = True
        elif prof not in ("", "main", "main10"):
            raise ValueError(f"unsupported profile {cfg.profile}")
        # TS reaches AI (4x4 luma and chroma TBs) and LDP (the 4x4 chroma
        # TBs of the device P pass); the B pass does not speak it
        self.pps = Pps(init_qp=cfg.qp, sign_data_hiding=cfg.sign_data_hiding,
                       deblocking_filter_disabled=not cfg.deblock,
                       transform_skip_enabled=cfg.transform_skip
                       and cfg.gop in ("ai", "ldp"),
                       entropy_coding_sync_enabled=False)
        self.vps = Vps(max_dec_pic_buffering=self.sps.max_dec_pic_buffering,
                       max_num_reorder_pics=self.sps.max_num_reorder_pics,
                       ptl=self.sps.ptl)
        self.results: list[FrameResult] = []
        # called with (poc, reconstructed Frame) in output (POC) order:
        # the pictures the hash SEI hashes
        self.recon_sink = None
        self._poc_base = 0
        self.dpb: list[tuple[int, Frame]] = []   # (poc, recon) newest last
        self._last_idr = 0                       # input index of last IDR
        # adapted CABAC states harvested per GOP position, pricing the
        # next same-position frame's device RDO (entropy/fracbits.py)
        self._ctx_harvest: dict[int, object] = {}
        self.nn_params = None
        if cfg.gop in ("ldp", "ra") and cfg.subpel == "nn":
            self.nn_params = self._load_nn(cfg, self.device)

    @staticmethod
    def _load_nn(cfg: EncoderConfig, device):
        """The NN-FME weights of the nearest trained QP: the reference
        trains {22, 27, 32, 37} and falls back to the QP22 block
        otherwise (TEncSearch.cpp:924).  The weights are qp*.npz files,
        in cfg.nn_weights_dir when it is set, else the port's own."""
        from hmtpu_torch.models import nnfme

        dirs = [cfg.nn_weights_dir] if cfg.nn_weights_dir else []
        dirs.append(nnfme.WEIGHTS_DIR)
        for d in dirs:
            cands = []
            if os.path.isdir(d):
                cands = [int(f[2:-4]) for f in os.listdir(d)
                         if f.startswith("qp") and f.endswith(".npz")]
            if cands:
                best = min(cands, key=lambda q: abs(q - cfg.qp))
                return nnfme.load_npz(os.path.join(d, f"qp{best}.npz"),
                                      device)
        raise FileNotFoundError(f"no NN-FME weights in {dirs}")

    def _intra_lambda_factor(self) -> float:
        """I-slice QP factor: 0.57 * (1 - Clip3(0, .5, .05*(GOPSize-1)))
        (TEncSlice::initEncSlice I_SLICE branch)."""
        if self.cfg.gop == "ai":
            return 0.57
        gop_size = 8 if self.cfg.gop == "ra" \
            else max(len(self.cfg.gop_qp_offsets), 4)
        nb = gop_size - 1
        return 0.57 * (1.0 - min(max(0.05 * nb, 0.0), 0.5))

    def _is_idr(self, poc: int) -> bool:
        if self.cfg.gop == "ai" or poc == 0:
            return True
        ip = self.cfg.intra_period
        return ip > 0 and poc % ip == 0

    # HM low-delay-P GOP4 reference rows (encoder_lowdelay_P_main.cfg
    # Frame1..4 deltaRPS columns): each P frame references the previous
    # picture plus the low-QP GOP anchors
    LDP_RPS_ROWS = ((-1, -5, -9, -13), (-1, -2, -6, -10),
                    (-1, -3, -7, -11), (-1, -4, -8, -12))

    def _ldp_lists(self, rel_poc: int, avail: set):
        """HM-parity L0 + the RPS retention set for a low-delay-P
        picture: the GOP-position row's deltas, missing entries filled
        with the most recent available pictures (TEncTop::xInitRPS
        startup RPSs), list in descending POC."""
        row = self.LDP_RPS_ROWS[(rel_poc - 1) % 4]
        want = [rel_poc + d for d in row if rel_poc + d >= 0]
        l0 = [p for p in want if p in avail]
        for p in sorted(avail, reverse=True):
            if len(l0) >= min(4, self.cfg.num_refs):
                break
            if p not in l0:
                l0.append(p)
        l0 = sorted(l0, reverse=True)[:min(4, self.cfg.num_refs)]
        keep = set(l0)
        for q in avail:
            if q % 4 == 0 and q >= rel_poc - 12:
                keep.add(q)            # anchors reachable by later rows
            if rel_poc <= 12 and q >= rel_poc - 2:
                keep.add(q)            # startup fills
        return l0, keep

    # hierarchical GOP-8 random-access structure in coding order:
    # (display offset within GOP, referenced display offsets)
    RA_GOP8 = (
        (8, (0,)),
        (4, (0, 8)),
        (2, (0, 4, 8)),
        (1, (0, 2, 4)),
        (3, (2, 4, 0)),
        (6, (4, 8, 0)),
        (5, (4, 6, 8)),
        (7, (6, 8, 4)),
    )

    def _ra_schedule(self, n: int) -> list[tuple[int, tuple[int, ...]]]:
        """Coding-order schedule [(poc, referenced pocs)] for n frames:
        full hierarchical GOP-8 groups, low-delay tail."""
        sched = [(0, ())]
        base = 0
        while base + 8 <= n - 1:
            for off, refs in self.RA_GOP8:
                sched.append((base + off, tuple(base + r for r in refs)))
            base += 8
        for poc in range(base + 1, n):
            sched.append((poc, (poc - 1,)))
        return sched

    def save_checkpoint(self, path: str) -> None:
        raise NotImplementedError(f"hmtpu_torch: {ROADMAP_CKPT} is not "
                                  f"ported yet")

    def load_checkpoint(self, path: str) -> None:
        raise NotImplementedError(f"hmtpu_torch: {ROADMAP_CKPT} is not "
                                  f"ported yet")

    def encode_sequence(self, frames: list[Frame]) -> bytes:
        """Encode `frames`; returns the Annex-B byte stream.  All-intra:
        every picture an IDR.  Low-delay P: an IDR, then P pictures in a
        two-phase pipeline -- while the device computes frame N+1 (whose
        references live on the device), the host pulls frame N's
        decision state and runs entropy coding and the hash.  Random
        access: the IDR, then GOP-8 B pictures in coding order, one
        access unit at a time."""
        if self.cfg.gop == "ra":
            return self._encode_ra(frames)
        out = bytearray()
        poc0 = self._poc_base
        pending = None
        for i, frame in enumerate(frames):
            poc = poc0 + i
            if self._is_idr(poc):
                if pending is not None:
                    out.extend(write_annexb(self._finish_p(pending)))
                    pending = None
                out.extend(write_annexb(self.encode_frame_au(frame, poc)))
            else:
                launched = self._launch_p(frame, poc)
                if pending is not None:
                    out.extend(write_annexb(self._finish_p(pending)))
                pending = launched
        if pending is not None:
            out.extend(write_annexb(self._finish_p(pending)))
        self._poc_base = poc0 + len(frames)
        return bytes(out)

    def _encode_ra(self, frames: list[Frame]) -> bytes:
        """The random-access sequence: the whole schedule, each picture
        coded with the pictures it or a later one still references."""
        if self._poc_base:
            raise NotImplementedError(f"hmtpu_torch: a second RA segment "
                                      f"needs {ROADMAP_CKPT}")
        out = bytearray()
        sched = self._ra_schedule(len(frames))
        dpb_map: dict[int, Frame] = {}
        pending, next_out = {}, 0
        for i, (poc, used) in enumerate(sched):
            future = set()
            for _, u in sched[i:]:
                future.update(u)
            retained = {p: f for p, f in dpb_map.items() if p in future}
            if poc == 0:
                nals = self.encode_frame_au(frames[0], 0)
            else:
                nals = self._encode_b_au(frames[poc], poc, used, retained)
            out.extend(write_annexb(nals))
            dpb_map = dict(retained)
            dpb_map[poc] = self._last_recon
            pending[poc] = self._last_recon
            while next_out in pending:        # output order
                if self.recon_sink is not None:
                    self.recon_sink(next_out, pending[next_out])
                del pending[next_out]
                next_out += 1
        self.dpb = sorted(dpb_map.items())
        self._poc_base = len(frames)
        return bytes(out)

    def _encode_b_au(self, frame: Frame, poc: int, used, retained: dict):
        """One B access unit (hmtpu's `encode_frame_au` RA branch): the
        RPS covers the retained pictures, L0 and L1 in their default
        order, the GOP-8 QP offset and lambda factor of the picture's
        temporal layer, no TMVP."""
        from hmtpu_torch.encoder.pframe_dev import PFrameDeviceEncoder

        t0 = time.time()
        cfg = self.cfg
        # hierarchical QP/lambda per temporal layer (the reference
        # encoder_randomaccess GOP8 table: offsets 1/2/3/4, factors
        # 0.442/0.3536/0.68)
        off_fac = {0: (1, 0.442), 4: (2, 0.3536), 2: (3, 0.3536),
                   6: (3, 0.3536)}
        ra_off, ra_fac = off_fac.get(poc % 8, (4, 0.68))
        qp = min(cfg.qp + ra_off, 51)
        past_u = sorted((p for p in used if p < poc), reverse=True)
        futr_u = sorted(p for p in used if p > poc)
        ref_pocs = past_u + futr_u                  # L0 default order
        ref_pocs_l1 = futr_u + past_u               # L1 default order
        all_pocs = set(retained) | set(used)
        negs = [(poc - p, p in used)
                for p in sorted((q for q in all_pocs if q < poc),
                                reverse=True)]
        poss = [(p - poc, p in used)
                for p in sorted(q for q in all_pocs if q > poc)]
        sh = SliceHeader(
            slice_type=SliceType.B, pps_id=0, slice_qp=qp,
            pic_order_cnt_lsb=poc & ((1 << 8) - 1),
            nal_type=NalUnitType.TRAIL_R,
            negative_refs=negs, positive_refs=poss,
            num_ref_idx_l0=len(ref_pocs), num_ref_idx_l1=len(ref_pocs_l1),
            five_minus_max_num_merge_cand=5 - cfg.max_num_merge_cand)
        pe = PFrameDeviceEncoder(self.sps, self.pps, subpel=cfg.subpel,
                                 nn_params=self.nn_params,
                                 search_range=cfg.search_range,
                                 qp_factor=ra_fac, tmvp=False,
                                 rdoq=cfg.rdoq, device=self.device)
        ctx = pe.launch(frame, qp, [retained[p] for p in ref_pocs],
                        ref_pocs, poc, sh, [retained[p] for p in ref_pocs_l1],
                        ref_pocs_l1)
        recon, _, decisions, maps = pe.finish(ctx)
        sao = None
        if self.sps.sao_enabled:
            ny = self.sps.pic_height_in_ctus
            nx = self.sps.pic_width_in_ctus
            grid = grid_from_packed(pe._sao_packed.reshape(ny, nx, 3, 7))
            sh.sao_luma = True
            sh.sao_chroma = True
            sao = (grid, True, True)
        slice_rbsp = pe._entropy_pass(qp, *maps, decisions, sh, sao=sao)
        nals = self._prefix_seis(False) + self._slice_nals(sh, slice_rbsp,
                                                            recon)
        t_end = time.time()
        self._account(poc, nals, frame, recon, t_end - t0, "B",
                      device_seconds=pe.t_fetched - t0,
                      host_seconds=t_end - pe.t_fetched)
        self._last_recon = recon
        return nals

    def _slice_nals(self, sh: SliceHeader, slice_rbsp: bytes,
                    recon: Frame) -> list[NalUnit]:
        """The slice NAL unit and, when configured, the decoded picture
        hash SEI of its reconstruction."""
        bw = write_slice_header(sh, self.sps, self.pps)
        bw.write_bytes(slice_rbsp)
        nals = [NalUnit(sh.nal_type, bw.get_bytes())]
        if self.cfg.decoded_picture_hash:
            nals.append(make_hash_sei_nal(picture_md5(
                recon.planes(), [self.cfg.bit_depth] * 3)))
        return nals

    def _account(self, poc: int, nals: list[NalUnit], frame: Frame,
                 recon: Frame, seconds: float, stype: str, **kw) -> None:
        """The access unit's bits and PSNR into `results`."""
        maxv = (1 << self.cfg.bit_depth) - 1
        self.results.append(FrameResult(
            poc, sum(len(n.to_bytes()) * 8 for n in nals),
            psnr(frame.y, recon.y, maxv), psnr(frame.u, recon.u, maxv),
            psnr(frame.v, recon.v, maxv), seconds, stype, **kw))

    # -- two-phase P-frame pipeline ------------------------------------------
    def _launch_p(self, frame: Frame, poc: int) -> dict:
        """Run the frame's device pass; a device-plane placeholder enters
        the DPB at once, so the next frame can launch before this one's
        host side."""
        from hmtpu_torch.encoder.pframe_dev import PFrameDeviceEncoder

        t0 = time.time()
        cfg = self.cfg
        rel_poc = poc - self._last_idr
        dpb_map = dict(self.dpb)
        ref_pocs, keep = self._ldp_lists(rel_poc, set(dpb_map))
        refs = [dpb_map[p] for p in ref_pocs]
        rps = sorted(keep, key=lambda p: rel_poc - p)
        negs = [(rel_poc - p, p in set(ref_pocs)) for p in rps]
        gpos = (rel_poc - 1) % len(cfg.gop_qp_offsets)
        qp = cfg.qp + cfg.gop_qp_offsets[gpos]
        qpf = lambda_qp_factor(cfg.gop_qp_factors[gpos], qp,
                               gop_depth(rel_poc, len(cfg.gop_qp_offsets)))
        sh = SliceHeader(
            slice_type=SliceType.P, pps_id=0, slice_qp=qp,
            pic_order_cnt_lsb=rel_poc, nal_type=NalUnitType.TRAIL_R,
            negative_refs=negs, num_ref_idx_l0=len(ref_pocs),
            five_minus_max_num_merge_cand=5 - cfg.max_num_merge_cand,
            temporal_mvp=self.sps.temporal_mvp_enabled)
        pe = PFrameDeviceEncoder(self.sps, self.pps, subpel=cfg.subpel,
                                 nn_params=self.nn_params,
                                 search_range=cfg.search_range,
                                 qp_factor=qpf, tmvp=cfg.tmvp,
                                 rdoq=cfg.rdoq, decision=cfg.decision,
                                 pad_refs=cfg.num_refs,
                                 ctx_states=self._ctx_harvest.get(gpos),
                                 device=self.device)
        ctx = pe.launch(frame, qp, refs, ref_pocs, rel_poc, sh)
        ph = Frame(None, None, None, cfg.bit_depth)
        ph.dev = ctx["dev"]
        ph.dev_col = ctx["col_out"]
        self.dpb.append((rel_poc, ph))
        self.dpb = [(p, f) for p, f in self.dpb
                    if p in keep or p == rel_poc]
        return dict(pe=pe, ctx=ctx, sh=sh, frame=frame, poc=poc, ph=ph,
                    gpos=gpos, t0=t0, t_launched=time.time())

    def _finish_p(self, launched: dict) -> list[NalUnit]:
        """Host half: pull decisions, entropy-code, hash, account."""
        cfg = self.cfg
        pe, sh, frame = launched["pe"], launched["sh"], launched["frame"]
        t_finish = time.time()
        recon, _, decisions, maps = pe.finish(launched["ctx"])
        ph = launched["ph"]
        ph.y, ph.u, ph.v = recon.y, recon.u, recon.v
        ph.col_np = recon.col_np

        sao = None
        if self.sps.sao_enabled:
            sh.sao_luma = True
            sh.sao_chroma = True
            sao = ("packed", pe._sao_packed)
        slice_rbsp = pe._entropy_pass(sh.slice_qp, *maps, decisions, sh,
                                      sao=sao)
        self._ctx_harvest[launched["gpos"]] = pe.final_ctx
        nals = self._prefix_seis(False) + self._slice_nals(sh, slice_rbsp,
                                                            recon)
        if self.recon_sink is not None:
            self.recon_sink(launched["poc"], recon)
        t_end = time.time()
        self._account(launched["poc"], nals, frame, recon,
                      t_end - launched["t0"], "P",
                      device_seconds=(launched["t_launched"] - launched["t0"])
                      + (pe.t_fetched - t_finish),
                      host_seconds=t_end - pe.t_fetched)
        return nals

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
        SEI, the I slice, and the decoded-picture-hash SEI; the picture
        starts a new DPB."""
        t0 = time.time()
        cfg = self.cfg
        qp = cfg.qp
        nals: list[NalUnit] = []
        if poc == 0:
            nals += [write_vps(self.vps), write_sps(self.sps),
                     write_pps(self.pps)]
        nals += self._prefix_seis(True)
        self.dpb.clear()
        self._last_idr = poc

        fe = IntraFrameEncoder(self.sps, self.pps, self.device)
        # I-slice lambda QP factor (TEncSlice::initEncSlice I_SLICE branch)
        recon, decisions, mode8, depth8 = fe.analyze_device(
            frame, qp, lam_factor=self._intra_lambda_factor(),
            deblock=cfg.deblock, sao=bool(self.sps.sao_enabled))
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
        nals += self._slice_nals(sh, slice_rbsp, recon)

        self.dpb.append((0, recon))
        self._last_recon = recon
        if self.recon_sink is not None and cfg.gop != "ra":
            self.recon_sink(poc, recon)
        self._account(poc, nals, frame, recon, time.time() - t0, "I")
        return nals
