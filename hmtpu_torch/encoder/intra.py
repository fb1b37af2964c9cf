"""All-intra frame encoder: the port of hmtpu/encoder/intra.py
(`IntraFrameEncoder.analyze_device` :119 and `_entropy_pass` :169).

The decision pass, reconstruction and in-loop filters run on the
encoder's device (encoder/iframe_dev.py); what comes back to the host
is the decision state, which the CABAC entropy pass serialises.
"""
from __future__ import annotations

import numpy as np
import torch

from hmtpu_torch.common.constants import DC_IDX, SliceType
from hmtpu_torch.common.geometry import encode_rem_mode, mpm_list
from hmtpu_torch.common.params import Pps, Sps
from hmtpu_torch.common.scan import intra_scan_idx
from hmtpu_torch.common.spec_tables import chroma_qp_from_luma
from hmtpu_torch.entropy.contexts import OFF, make_contexts
from hmtpu_torch.entropy.fracbits import ctx_bits_table
from hmtpu_torch.io.yuv import Frame


class IntraFrameEncoder:
    """Variable-CU-size all-intra encoder: batched device RDO with
    closed-loop reconstruction (encoder/iframe_dev.py), CABAC entropy of
    the chosen quadtree on the host."""

    def __init__(self, sps: Sps, pps: Pps, device: torch.device):
        self.sps = sps
        self.pps = pps
        self.bd = sps.bit_depth_luma
        self.device = device

    # -- main entry ---------------------------------------------------------
    def analyze_device(self, frame: Frame, qp: int,
                       lam_factor: float = 0.57, deblock: bool = True,
                       sao: bool = True):
        """Whole-frame device pass: decision + exact recon + in-loop
        filters.  Sets self._sao_packed (the SAO parameters the entropy
        pass writes)."""
        from hmtpu_torch.encoder.iframe_dev import (
            iframe_full_pass,
            unpack_iframe_state,
        )
        from hmtpu_torch.encoder.pframe_dev import DBG_COUNTERS

        sps = self.sps
        w, h = sps.pic_width, sps.pic_height
        qpc = chroma_qp_from_luma(qp + self.pps.cb_qp_offset)
        cb = ctx_bits_table(make_contexts(SliceType.I, qp))
        plane = lambda a: torch.as_tensor(
            np.asarray(a, np.int32)).to(self.device)
        st = iframe_full_pass(
            plane(frame.y), plane(frame.u), plane(frame.v), qp, qpc,
            torch.as_tensor(cb.reshape(-1)).to(self.device),
            w=w, h=h, bd=self.bd, sis=sps.strong_intra_smoothing,
            log2_ctu=sps.log2_ctu_size, deblock=deblock, sao=sao,
            ctu=sps.ctu_size, cb_off=self.pps.cb_qp_offset,
            cr_off=self.pps.cr_qp_offset, qp_factor=lam_factor,
            sdh=bool(self.pps.sign_data_hiding),
            ts=bool(self.pps.transform_skip_enabled))
        st = {k: v.cpu().numpy().astype(np.int32) for k, v in st.items()}
        # TBs that chose transform skip: bits 0-3 the NxN luma PUs, 4-5
        # the chroma TBs of each 8x8 CU
        DBG_COUNTERS["intra_ts_tbs"] += int(sum(
            ((st["tsf"] >> k) & 1).sum() for k in range(6)))
        mode8, depth8, decisions = unpack_iframe_state(
            st, w, h, sps.log2_ctu_size)
        recon = Frame(st["rec_y"].reshape(h, w),
                      st["rec_u"].reshape(h // 2, w // 2),
                      st["rec_v"].reshape(h // 2, w // 2), self.bd)
        self._sao_packed = st["sao"].reshape(-1, 21) if sao else None
        return recon, decisions, mode8, depth8

    # -- entropy ------------------------------------------------------------
    def _entropy_pass(self, qp, mode8, depth8, decisions,
                      sao=None) -> bytes:
        """Serialise the chosen quadtree (the reference decoder's parse,
        bin for bin).  sao = (params_grid, sao_luma, sao_chroma) or
        None."""
        from hmtpu_torch.entropy.recorder import make_backend
        from hmtpu_torch.entropy.sao_syntax import encode_sao_ctu

        sps = self.sps
        w, h = sps.pic_width, sps.pic_height
        ctx = make_contexts(SliceType.I, qp)
        enc = make_backend(ctx)
        sdh = self.pps.sign_data_hiding

        n_ctu_x = sps.pic_width_in_ctus
        n_ctu_y = sps.pic_height_in_ctus
        ctu = sps.ctu_size

        ts_on = bool(self.pps.transform_skip_enabled)

        def emit_ts_flag(log2, is_luma, val):
            """transform_skip_flag: first element of residual_coding
            for 4x4 TBs when the PPS enables TS (7.3.8.11)."""
            if ts_on and log2 == 2:
                enc.encode_bin(OFF["TRANSFORMSKIP_FLAG"]
                               + (0 if is_luma else 1), int(val))

        # PU-granular (4x4) mode map for MPM derivation, built in
        # decode order; equals replicated mode8 while no NxN CU exists
        mode4 = np.full((h // 4, w // 4), -1, np.int32)

        def mpm_at(px, py):
            """8.4.2 candidate list for the PU at (px, py) from the
            4x4-granular neighbour modes."""
            qx, qy = px // 4, py // 4
            lm = mode4[qy, qx - 1] if qx > 0 else -1
            am = mode4[qy - 1, qx] \
                if (qy > 0 and (py % ctu) != 0) else -1
            return mpm_list(lm if lm >= 0 else DC_IDX,
                            am if am >= 0 else DC_IDX)

        def mode_syntax(enc_flags_only, mode, mpms):
            if enc_flags_only:
                enc.encode_bin(OFF["INTRA_PRED_MODE"],
                               1 if mode in mpms else 0)
                return
            if mode in mpms:
                idx = mpms.index(mode)
                enc.encode_bin_ep(0 if idx == 0 else 1)
                if idx:
                    enc.encode_bin_ep(idx - 1)
            else:
                enc.encode_bins_ep(encode_rem_mode(mode, mpms), 5)

        def encode_cu(x0, y0, log2):
            bxi, byi = x0 // 8, y0 // 8
            d = decisions[(x0, y0)]
            nxn = getattr(d, "modes4", None) is not None
            if log2 == sps.log2_min_cb_size:
                enc.encode_bin(OFF["PART_SIZE"], 0 if nxn else 1)
            if nxn:
                encode_cu_nxn(x0, y0, d)
                return
            mode = int(mode8[byi, bxi])
            mpms = mpm_at(x0, y0)
            mode_syntax(True, mode, mpms)
            mode_syntax(False, mode, mpms)
            nq = (1 << log2) // 4
            mode4[y0 // 4:y0 // 4 + nq, x0 // 4:x0 // 4 + nq] = mode
            # intra_chroma_pred_mode = DM
            enc.encode_bin(OFF["CHROMA_PRED_MODE"], 0)

            cbf_y = bool(d.lev_y.any())
            cbf_cb = bool(d.lev_cb.any())
            cbf_cr = bool(d.lev_cr.any())
            # transform_tree at trafoDepth 0: cbf_cb, cbf_cr, cbf_luma
            enc.encode_bin(OFF["QT_CBF_CHROMA"] + 0, int(cbf_cb))
            enc.encode_bin(OFF["QT_CBF_CHROMA"] + 0, int(cbf_cr))
            enc.encode_bin(OFF["QT_CBF_LUMA"] + 1, int(cbf_y))
            clog2 = log2 - 1
            if cbf_y:
                enc.residual(d.lev_y, log2, True,
                             intra_scan_idx(mode, log2, True), sdh)
            if cbf_cb:
                emit_ts_flag(clog2, False, getattr(d, "ts_cb", 0))
                enc.residual(d.lev_cb, clog2, False,
                             intra_scan_idx(mode, clog2, False), sdh)
            if cbf_cr:
                emit_ts_flag(clog2, False, getattr(d, "ts_cr", 0))
                enc.residual(d.lev_cr, clog2, False,
                             intra_scan_idx(mode, clog2, False), sdh)

        def encode_cu_nxn(x0, y0, d):
            """part NxN: four 4x4 luma PUs (7.4.9.5 syntax order: all
            prev_intra flags, then per-PU mpm_idx/rem), TU split
            implied, chroma coded with the last sub-TU."""
            ms = [int(m) for m in d.modes4]
            offs = ((0, 0), (4, 0), (0, 4), (4, 4))   # z-order (dx,dy)
            # derive the four MPM lists in PU decode order, updating
            # the mode map as the decoder will
            mpms_l = []
            for m, (dx, dy) in zip(ms, offs):
                mpms_l.append(mpm_at(x0 + dx, y0 + dy))
                mode4[(y0 + dy) // 4, (x0 + dx) // 4] = m
            for m, mp in zip(ms, mpms_l):
                mode_syntax(True, m, mp)
            for m, mp in zip(ms, mpms_l):
                mode_syntax(False, m, mp)
            enc.encode_bin(OFF["CHROMA_PRED_MODE"], 0)
            cbf_cb = bool(d.lev_cb.any())
            cbf_cr = bool(d.lev_cr.any())
            enc.encode_bin(OFF["QT_CBF_CHROMA"] + 0, int(cbf_cb))
            enc.encode_bin(OFF["QT_CBF_CHROMA"] + 0, int(cbf_cr))
            ts4 = getattr(d, "ts_y4", (0, 0, 0, 0))
            for p, (dx, dy) in enumerate(offs):
                sub = d.lev_y[dy:dy + 4, dx:dx + 4]
                cbf = bool(sub.any())
                enc.encode_bin(OFF["QT_CBF_LUMA"] + 0, int(cbf))
                if cbf:
                    emit_ts_flag(2, True, ts4[p])
                    enc.residual(sub, 2, True,
                                 intra_scan_idx(ms[p], 2, True), sdh)
                if p == 3:
                    if cbf_cb:
                        emit_ts_flag(2, False, getattr(d, "ts_cb", 0))
                        enc.residual(d.lev_cb, 2, False,
                                     intra_scan_idx(ms[0], 2, False),
                                     sdh)
                    if cbf_cr:
                        emit_ts_flag(2, False, getattr(d, "ts_cr", 0))
                        enc.residual(d.lev_cr, 2, False,
                                     intra_scan_idx(ms[0], 2, False),
                                     sdh)

        def split_ctx_inc(x0, y0, depth):
            inc = 0
            bxi, byi = x0 // 8, y0 // 8
            if x0 > 0 and depth8[byi, bxi - 1] > depth:
                inc += 1
            if y0 > 0 and depth8[byi - 1, bxi] > depth:
                inc += 1
            return inc

        def encode_quadtree(x0, y0, log2, depth):
            size = 1 << log2
            inside = x0 + size <= w and y0 + size <= h
            is_leaf = (x0, y0) in decisions \
                and decisions[(x0, y0)].log2 == log2
            if inside and log2 > sps.log2_min_cb_size:
                enc.encode_bin(OFF["SPLIT_FLAG"]
                               + split_ctx_inc(x0, y0, depth),
                               0 if is_leaf else 1)
            if is_leaf:
                encode_cu(x0, y0, log2)
                return
            half = size >> 1
            for dy, dx in ((0, 0), (0, half), (half, 0), (half, half)):
                if x0 + dx < w and y0 + dy < h:
                    encode_quadtree(x0 + dx, y0 + dy, log2 - 1, depth + 1)

        for cty in range(n_ctu_y):
            for ctx_i in range(n_ctu_x):
                if sao is not None:
                    grid, sl, sc = sao
                    encode_sao_ctu(enc, grid[cty][ctx_i], ctx_i > 0,
                                   cty > 0, sl, sc, self.bd)
                encode_quadtree(ctx_i * ctu, cty * ctu, sps.log2_ctu_size, 0)
                last = (cty == n_ctu_y - 1) and (ctx_i == n_ctu_x - 1)
                if not last:
                    enc.encode_bin_trm(0)
        return enc.finish()
