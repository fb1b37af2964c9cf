"""P/B-slice encoder state, decision record and the Python slice walk:
the part of hmtpu/encoder/pframe.py (`PuDec` :57, `PFrameEncoder.__init__`
:117, `_entropy_pass` :535) that the device encoder
(encoder/pframe_dev.py) inherits.

The port writes P slices with the native CABAC engine
(native/entropy.cpp), which speaks P syntax only, and B slices with this
walk over the decision records, as the reference does.  The host-loop
encoder (`analyze` :170, `_encode_block` :303) is not ported: the port
runs the device wavefront pass only (`wavefront=False` raises).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hmtpu_torch.common.constants import DC_IDX, SliceType
from hmtpu_torch.common.geometry import encode_rem_mode, mpm_list
from hmtpu_torch.common.params import Pps, Sps
from hmtpu_torch.common.scan import intra_scan_idx
from hmtpu_torch.entropy.contexts import OFF, make_contexts
from hmtpu_torch.entropy.headers import SliceHeader
from hmtpu_torch.entropy.inter_syntax import (
    encode_inter_dir,
    encode_merge_idx,
    encode_mvd,
    encode_ref_idx,
)


@dataclass
class PuDec:
    kind: str                      # 'skip' | 'merge' | 'amvp' | 'intra'
    log2: int = 3                  # CU size (8x8 .. 64x64)
    merge_idx: int = 0
    mv: tuple = (0, 0)             # final quarter-pel MV (L0)
    mvd: tuple = (0, 0)
    mvp_idx: int = 0
    ref_idx: int = 0
    intra_mode: int = -1
    # B slices (AMVP): 1 = L0, 2 = L1, 3 = BI; L1 motion fields
    inter_dir: int = 1
    mv_l1: tuple = (0, 0)
    mvd_l1: tuple = (0, 0)
    mvp_idx_l1: int = 0
    ref_idx_l1: int = 0
    lev_y: np.ndarray | None = None
    lev_cb: np.ndarray | None = None
    lev_cr: np.ndarray | None = None
    # transform_skip_flag per 4x4 chroma TB (PPS TransformSkip on)
    ts_cb: int = 0
    ts_cr: int = 0

    @property
    def coded(self) -> bool:
        return any(l is not None and l.any()
                   for l in (self.lev_y, self.lev_cb, self.lev_cr))


class PFrameEncoder:
    """One P slice: its parameter sets and search options."""

    def __init__(self, sps: Sps, pps: Pps, subpel: str = "nn",
                 nn_params=None, search_range: int = 16):
        self.sps, self.pps = sps, pps
        self.bd = sps.bit_depth_luma
        self.subpel = subpel
        self.nn_params = nn_params
        self.search_range = search_range
        self._sdh = bool(pps.sign_data_hiding)

    # -- entropy ------------------------------------------------------------
    def _entropy_pass(self, qp, modes, skip_map, intra_map, decisions,
                      sh: SliceHeader, sao=None, depth8=None) -> bytes:
        from hmtpu_torch.entropy.recorder import make_backend
        from hmtpu_torch.entropy.sao_syntax import encode_sao_ctu

        sps = self.sps
        w, h = sps.pic_width, sps.pic_height
        ctx = make_contexts(sh.slice_type, qp)
        enc = make_backend(ctx)
        sdh = self.pps.sign_data_hiding
        ts_on = bool(self.pps.transform_skip_enabled)

        def emit_ts_chroma(val):
            """transform_skip_flag, 4x4 chroma TB (7.3.8.11)."""
            if ts_on:
                enc.encode_bin(OFF["TRANSFORMSKIP_FLAG"] + 1, int(val))
        max_merge = sh.max_num_merge_cand
        num_ref = sh.num_ref_idx_l0
        num_ref_l1 = sh.num_ref_idx_l1
        is_b = sh.slice_type == SliceType.B
        ctu = sps.ctu_size

        def skip_ctx_inc(bxi, byi):
            inc = 0
            if bxi > 0 and skip_map[byi, bxi - 1]:
                inc += 1
            if byi > 0 and skip_map[byi - 1, bxi]:
                inc += 1
            return inc

        def encode_cu(x0, y0, log2=3):
            bxi, byi = x0 // 8, y0 // 8
            d = decisions[(x0, y0)]
            enc.encode_bin(OFF["SKIP_FLAG"] + skip_ctx_inc(bxi, byi),
                           int(d.kind == "skip"))
            if d.kind == "skip":
                encode_merge_idx(enc, d.merge_idx, max_merge)
                return
            assert log2 == 3 or (log2 in (4, 5, 6) and d.kind != "intra"), \
                "intra CUs are 8x8 in this envelope"
            enc.encode_bin(OFF["PRED_MODE"], int(d.kind == "intra"))
            if d.kind == "intra":
                enc.encode_bin(OFF["PART_SIZE"], 1)   # 2Nx2N
                mode = d.intra_mode
                left_mode = modes[byi, bxi - 1] if bxi > 0 else -1
                above_mode = modes[byi - 1, bxi] \
                    if (byi > 0 and (y0 % ctu) != 0) else -1
                mpms = mpm_list(left_mode if left_mode >= 0 else DC_IDX,
                                above_mode if above_mode >= 0 else DC_IDX)
                if mode in mpms:
                    enc.encode_bin(OFF["INTRA_PRED_MODE"], 1)
                    idx = mpms.index(mode)
                    enc.encode_bin_ep(0 if idx == 0 else 1)
                    if idx:
                        enc.encode_bin_ep(idx - 1)
                else:
                    enc.encode_bin(OFF["INTRA_PRED_MODE"], 0)
                    enc.encode_bins_ep(encode_rem_mode(mode, mpms), 5)
                enc.encode_bin(OFF["CHROMA_PRED_MODE"], 0)  # DM
                cbf_cb = bool(d.lev_cb.any())
                cbf_cr = bool(d.lev_cr.any())
                cbf_y = bool(d.lev_y.any())
                enc.encode_bin(OFF["QT_CBF_CHROMA"], int(cbf_cb))
                enc.encode_bin(OFF["QT_CBF_CHROMA"], int(cbf_cr))
                enc.encode_bin(OFF["QT_CBF_LUMA"] + 1, int(cbf_y))
                if cbf_y:
                    enc.residual(d.lev_y, 3, True,
                                 intra_scan_idx(mode, 3, True), sdh)
                if cbf_cb:
                    emit_ts_chroma(d.ts_cb)
                    enc.residual(d.lev_cb, 2, False,
                                 intra_scan_idx(mode, 2, False), sdh)
                if cbf_cr:
                    emit_ts_chroma(d.ts_cr)
                    enc.residual(d.lev_cr, 2, False,
                                 intra_scan_idx(mode, 2, False), sdh)
                return

            # inter, 2Nx2N
            enc.encode_bin(OFF["PART_SIZE"], 1)
            if d.kind == "merge":
                enc.encode_bin(OFF["MERGE_FLAG"], 1)
                encode_merge_idx(enc, d.merge_idx, max_merge)
            else:
                enc.encode_bin(OFF["MERGE_FLAG"], 0)
                if is_b:
                    # bin0 ctx = CtDepth of the CU (9.3.4.2.2)
                    encode_inter_dir(enc, d.inter_dir,
                                     sps.log2_ctu_size - log2)
                if d.inter_dir & 1:
                    encode_ref_idx(enc, d.ref_idx, num_ref)
                    encode_mvd(enc, d.mvd[0], d.mvd[1])
                    enc.encode_bin(OFF["MVP_IDX"], d.mvp_idx)
                if d.inter_dir & 2:
                    encode_ref_idx(enc, d.ref_idx_l1, num_ref_l1)
                    if not sh.mvd_l1_zero or d.inter_dir != 3:
                        encode_mvd(enc, d.mvd_l1[0], d.mvd_l1[1])
                    enc.encode_bin(OFF["MVP_IDX"], d.mvp_idx_l1)
            cbf_cb = bool(d.lev_cb.any())
            cbf_cr = bool(d.lev_cr.any())
            cbf_y = bool(d.lev_y.any())
            if d.kind == "amvp":
                root = int(cbf_cb or cbf_cr or cbf_y)
                enc.encode_bin(OFF["QT_ROOT_CBF"], root)
                if not root:
                    return
            if log2 == 6:
                # TU split inferred (log2TrafoSize 6 > MaxTbLog2SizeY,
                # 7.3.8.8 interSplitFlag): root chroma cbfs at
                # trafoDepth 0, then four 32x32 TBs at trafoDepth 1
                enc.encode_bin(OFF["QT_CBF_CHROMA"], int(cbf_cb))
                enc.encode_bin(OFF["QT_CBF_CHROMA"], int(cbf_cr))
                for qy, qx in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    ly = d.lev_y[qy * 32:qy * 32 + 32,
                                 qx * 32:qx * 32 + 32]
                    lcb = d.lev_cb[qy * 16:qy * 16 + 16,
                                   qx * 16:qx * 16 + 16]
                    lcr = d.lev_cr[qy * 16:qy * 16 + 16,
                                   qx * 16:qx * 16 + 16]
                    ccb, ccr = bool(lcb.any()), bool(lcr.any())
                    cy = bool(ly.any())
                    if cbf_cb:
                        enc.encode_bin(OFF["QT_CBF_CHROMA"] + 1,
                                       int(ccb))
                    if cbf_cr:
                        enc.encode_bin(OFF["QT_CBF_CHROMA"] + 1,
                                       int(ccr))
                    enc.encode_bin(OFF["QT_CBF_LUMA"] + 0, int(cy))
                    if cy:
                        enc.residual(ly, 5, True, 0, sdh)
                    if cbf_cb and ccb:
                        enc.residual(lcb, 4, False, 0, sdh)
                    if cbf_cr and ccr:
                        enc.residual(lcr, 4, False, 0, sdh)
                return
            enc.encode_bin(OFF["QT_CBF_CHROMA"], int(cbf_cb))
            enc.encode_bin(OFF["QT_CBF_CHROMA"], int(cbf_cr))
            if cbf_cb or cbf_cr:
                enc.encode_bin(OFF["QT_CBF_LUMA"] + 1, int(cbf_y))
            # else cbf_luma inferred 1
            if cbf_y:
                enc.residual(d.lev_y, log2, True, 0, sdh)
            if cbf_cb:
                if log2 == 3:
                    emit_ts_chroma(d.ts_cb)
                enc.residual(d.lev_cb, log2 - 1, False, 0, sdh)
            if cbf_cr:
                if log2 == 3:
                    emit_ts_chroma(d.ts_cr)
                enc.residual(d.lev_cr, log2 - 1, False, 0, sdh)

        # depth of the coding tree per 8x8 cell: the real split-flag
        # context rule (9.3.4.2.2) compares neighbour CU depths
        d8 = depth8 if depth8 is not None \
            else np.full((h // 8, w // 8), sps.log2_ctu_size - 3,
                         dtype=np.int32)

        def split_ctx_inc(x0, y0, depth):
            bxi, byi = x0 // 8, y0 // 8
            inc = 0
            if x0 > 0 and d8[byi, bxi - 1] > depth:
                inc += 1
            if y0 > 0 and d8[byi - 1, bxi] > depth:
                inc += 1
            return inc

        def encode_quadtree(x0, y0, log2, depth):
            size = 1 << log2
            inside = x0 + size <= w and y0 + size <= h
            split = d8[y0 // 8, x0 // 8] > depth
            if inside and log2 > 3:
                enc.encode_bin(OFF["SPLIT_FLAG"]
                               + split_ctx_inc(x0, y0, depth),
                               int(split))
            if log2 > 3 and (split or not inside):
                half = size >> 1
                for dy, dx in ((0, 0), (0, half), (half, 0), (half, half)):
                    if x0 + dx < w and y0 + dy < h:
                        encode_quadtree(x0 + dx, y0 + dy, log2 - 1,
                                        depth + 1)
            else:
                encode_cu(x0, y0, log2)

        n_ctu_x, n_ctu_y = sps.pic_width_in_ctus, sps.pic_height_in_ctus
        wpp = bool(self.pps.entropy_coding_sync_enabled)
        # WPP (9.3.2.2 / TEncSlice.cpp:1066-1089): ctx stored after the
        # row's 2nd CTU, restored at each row start; one byte-aligned
        # substream per CTU row with end_of_subset_one_bit
        sync_x = 1 if n_ctu_x > 1 else -1
        if wpp and sync_x < 0:
            enc.save_ctx()        # width-1 fallback: slice-init state
        for cty in range(n_ctu_y):
            if wpp and cty > 0:
                enc.restore_ctx()
            for ctxi in range(n_ctu_x):
                if sao is not None:
                    grid, sl, sc = sao
                    encode_sao_ctu(enc, grid[cty][ctxi], ctxi > 0,
                                   cty > 0, sl, sc, self.bd)
                encode_quadtree(ctxi * ctu, cty * ctu, sps.log2_ctu_size, 0)
                if wpp and ctxi == sync_x:
                    enc.save_ctx()
                last = (cty == n_ctu_y - 1) and (ctxi == n_ctu_x - 1)
                if not last:
                    enc.encode_bin_trm(0)
                if wpp and ctxi == n_ctu_x - 1 and not last:
                    enc.end_substream()
        rbsp = enc.finish()
        if wpp:
            from hmtpu_torch.entropy.recorder import entry_point_sizes
            sh.entry_point_offsets = entry_point_sizes(
                rbsp, enc.boundaries)
        return rbsp
