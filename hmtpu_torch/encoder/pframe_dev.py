"""Device-resident P- and B-slice encoder: the port of
hmtpu/encoder/pframe_dev.py (`_code` :188, `wavefront_pass` :255,
`full_pframe_pass` :1506, `PFrameDeviceEncoder` :1858).  The whole
per-frame mode decision (skip / merge / AMVP inter / intra), residual
coding, reconstruction and in-loop filters run on the tensors' device;
the host pulls the decision state and writes the slice with the native
CABAC engine.

  ME       integer ME of every 8x8 / 16x16 / 32x32 block against every
           reference (K5), the coherence pass over the 8x8 field (K19),
           NN-FME sub-pel offsets (K6) kept only where their SATD (K8)
           beats the integer MV's (the NN gate; its MC is K7);
  phase 1  (no neighbour dependencies) the AMVP candidate's prediction
           (K7) and residual coding for every block at each level, the
           open-loop intra mode of every 8x8 block (K22, the I pass's
           rough mode decision at k = 1);
  phase 2  the static z-scan dependency levels (the reference's
           `lax.scan`): per 8x8 CU the exact merge list, every candidate's
           prediction, two finalists coded without and the winner with the
           RDOQ trellis, the AMVP list and its mvd, ref_idx and
           inter_pred_idc bits, the exact intra prediction and its mode's
           bits; per 16x16 and 32x32 region one larger inter CU trial that
           overwrites where it wins.  On the card a P slice walks them in
           K23 (`pframe_walk`: one launch per level, the temporal
           candidates of the CU grids from one K24 launch before it), a
           B slice in K26; the CPU runs the plain version
           (`wavefront_pass_plain`: a Python loop over the levels);
  filters  deblocking (K3) and SAO (K4's statistics and apply, K25's
           parameter choice).

The state lives in flat tensors with one spare slot at the end, where
padding lanes write (the reference sends them out of range, which XLA
drops); it is updated in place.  Ties go to the first index, as in the
reference: `argmin`, and a stable sort for the merge finalists.

With the PPS's transform skip on, the 4x4 chroma TBs of 8x8 CUs are
coded both ways and the cheaper kept (`_code_ts_sel`, `hypothesis`: K1's
level forms in their TS mode code the pair and pick inside).  Sub-pel: NN-FME as above, HM's DCT-IF search (K9,
`subpel="dctif"`: the three levels in one launch, `frac_refine_levels`),
or none.  Every coding step (`_code`) prices its TBs in one K10 launch
(RDOQ, dequantisation and the TB rate).

B slices (random access): the references of both lists are deduped
into one union stack (`l0map` / `l1map` index it per list); ME searches
every reference of both lists and keeps the best (list, ref, MV) per
block, without the coherence pass; every merge candidate is predicted
at intermediate precision (K11) and screened on the approximate final
samples or the bi-average (K12); the winner's uni prediction is redone
at final precision (K7) and its bi-average taken from the exact
hypotheses; the AMVP candidate is the ME's (uni-directional) one.  No
TMVP and no transform skip in B slices.  On the card the B z-scan is
K26 (one launch per level), with the same arithmetic inside it.  The
host writes B slices with the Python slice walk (encoder/pframe.py); P
slices with the native CABAC engine.  The Jacobi decision is not ported (not queued).
"""
from __future__ import annotations

import ctypes
import time
from functools import lru_cache

import numpy as np
import torch

from hmtpu_torch import kernels
from hmtpu_torch.common.constants import (
    K_DIR,
    K_KIND,
    K_MVX,
    K_MVX1,
    K_MVY,
    K_MVY1,
    K_REF,
    K_REF1,
    K_SZ,
    SliceType,
)
from hmtpu_torch.common.lambdas import frame_lambdas
from hmtpu_torch.common.motion import (
    MotionCtx,
    PicMotion,
    amvp_candidates,
    merge_candidates,
)
from hmtpu_torch.common.spec_tables import chroma_qp_from_luma
from hmtpu_torch.encoder.intra_rdo import rmd
from hmtpu_torch.encoder.pframe import PFrameEncoder, PuDec
from hmtpu_torch.entropy.contexts import OFF, make_contexts
from hmtpu_torch.entropy.fracbits import ctx_bits_table
from hmtpu_torch.entropy.headers import SliceHeader
from hmtpu_torch.io.yuv import Frame
from hmtpu_torch.ops.deblock import deblock_state
from hmtpu_torch.ops.interp import (
    bi_average_t,
    bi_pred,
    mc_chroma_batch_refs,
    mc_chroma_batch_refs_i,
    mc_luma2,
    mc_luma_batch_refs,
    mc_luma_batch_refs_i,
    mc_yuv,
)
from hmtpu_torch.ops.intra_pred import (
    filter_reference_batched,
    predict_one_mode,
)
from hmtpu_torch.ops.ratebits import (
    cbf_chroma_bits,
    cbf_luma_bits,
    chroma_dm_bits,
    inter_dir_bits,
    intra_mode_mpm_bits,
    merge_flag_bits,
    merge_idx_bits,
    mvd_bits,
    mvp_idx_bits,
    part_size_2nx2n_bits,
    pred_mode_bits,
    ref_idx_bits,
    rqt_root_cbf_bits,
    skip_flag_bits,
    split_flag_bits,
    ts_flag_pair,
)
from hmtpu_torch.ops.rdoq import rdoq_code
from hmtpu_torch.ops.sao import sao_frame_dev
from hmtpu_torch.ops.transform import fwd_level, inv_level, inv_level_ts
from hmtpu_torch.search.wavefront import (
    amvp_candidates_dev,
    amvp_candidates_dev_b,
    block_schedule,
    block_schedule16,
    block_schedule32,
    merge_candidates_dev,
    merge_candidates_dev_b,
    scale_mv_pair_dev,
    static_ref_gather,
    temporal_cand_grid_dev,
)

INTRA_GATE = 24.0          # evaluate intra only when inter cost > gate*lam
BIG = 3e38                 # float32 "never wins"

# host-side event counters (introspection for tests/diagnostics)
DBG_COUNTERS = {"cu64_merge": 0, "cu64_amvp": 0, "ldp_ts_tbs": 0,
                "intra_ts_tbs": 0, "ra_bi_cus": 0}



def _intra_scan_sel(m):
    """Vectorised intra_scan_idx (7.4.9.11) for the sizes where the
    coding scan is mode-dependent (4x4/8x8 luma, 4x4 chroma):
    2=vertical for modes 6-14, 1=horizontal for 22-30, else diag."""
    return torch.where((m >= 6) & (m <= 14), 2,
                       torch.where((m >= 22) & (m <= 30), 1, 0)) \
        .to(torch.int32)


def _code(org, pred, qp: int, log2: int, bd: int, lam, cbflat,
          is_luma=True, dw=None, sdh: bool = False, scan_sel=None,
          use_dst: bool = False, rdoq: bool = True):
    """transform -> quant (RDOQ, or deadzone with rdoq=False) -> dequant
    -> inverse -> clip; returns (lev, rec, sse, bits).  The DCT / DST
    steps around K10 are K1's level forms for one plane (`fwd_level`,
    `inv_level`: the residual, reconstruction and SSE inside).

    Bits are the CABAC-state-aware estimate of ops/ratebits.py; 0.0 for
    an all-zero TB (cbf priced at CU level).  dw is HM's chroma
    distortion weight applied to the returned SSE (chroma callers pass
    lam = lambda/dw).  lam and dw are float32 0-d tensors."""
    coef, = fwd_level([org], [pred], bd, use_dst)
    lev, deq, bits = rdoq_code(coef, qp, log2, bd, lam, cbflat, is_luma,
                               sdh=sdh, scan_sel=scan_sel, trellis=rdoq)
    (rec,), (sse,), *_ = inv_level([deq], [lev], [pred], [org], bd, dw,
                                   use_dst=use_dst)
    return lev, rec, sse, bits


def _code_ts_sel(org, pred, qp: int, bd: int, lam, cbflat, is_luma,
                 dw=None, sdh: bool = False, scan_sel=None,
                 use_dst: bool = False, rdoq: bool = True):
    """4x4 TBs coded both ways (DCT/DST and transform skip), the cheaper
    kept per TB with the transform_skip_flag bit priced in (the batched
    form of TComTrQuant::transformNxN's TS trial + RDOQTS): K1's level
    forms in their TS mode around K10's two codings.  Returns (lev, rec,
    sse, bits with the flag, use_ts)."""
    (c0,), (c1,) = fwd_level([org], [pred], bd, use_dst, ts=True)
    code = lambda c: rdoq_code(c, qp, 2, bd, lam, cbflat, is_luma, sdh=sdh,
                               scan_sel=scan_sel, trellis=rdoq)
    l0, q0, b0 = code(c0)
    l1, q1, b1 = code(c1)
    (rec,), (sse,), (lev,), (bits,), ts, *_ = inv_level_ts(
        [q0], [l0], [b0], [q1], [l1], [b1], [pred], [org],
        ts_flag_pair(cbflat, is_luma), lam, bd, dw, use_dst)
    return lev, rec, sse, bits, ts != 0


@lru_cache(maxsize=None)
def _p_static(w: int, h: int, log2_ctu: int):
    """Schedules and substituted ref-gather maps (numpy)."""
    sched = block_schedule(w, h, log2_ctu)
    out = dict(lv_blk=sched["lv_blk"],
               nb_ok=sched["nb_ok"].reshape(-1, 5),
               nb_flat=sched["nb_flat"].reshape(-1, 5),
               g8=static_ref_gather(w, h, log2_ctu, 8),
               g4=static_ref_gather(w // 2, h // 2, log2_ctu - 1, 4),
               sched16=None, sched32=None)
    if w % 16 == 0 and h % 16 == 0:
        s16 = block_schedule16(w, h, log2_ctu)
        out["sched16"] = (s16["lv_blk"], s16["cells"], s16["nb_ok"],
                          s16["nb_cell"])
        s32 = block_schedule32(w, h, log2_ctu)
        out["sched32"] = (s32["lv_blk"], s32["cells16"], s32["cells8"],
                          s32["nb_ok"], s32["nb_cell"], s32["full32"])
    return out


_DEV_STATIC: dict = {}


def _dev_static(w: int, h: int, log2_ctu: int, device):
    """_p_static as tensors on `device` (int64 indices), one upload per
    geometry for the whole encode."""
    key = (w, h, log2_ctu, str(device))
    st = _DEV_STATIC.get(key)
    if st is None:
        def conv(v):
            if v is None:
                return None
            if isinstance(v, tuple):
                return tuple(conv(x) for x in v)
            t = torch.as_tensor(v)
            if t.dtype != torch.bool:
                t = t.to(torch.int64)
            return t.to(device)
        st = {k: conv(v) for k, v in _p_static(w, h, log2_ctu).items()}
        _DEV_STATIC[key] = st
    return st


def _blockify(plane, n):
    h, w = plane.shape
    return plane.reshape(h // n, n, w // n, n).transpose(1, 2) \
        .reshape(-1, n, n)


def _edge_pad(plane, ph: int, pw: int):
    """(h, w) -> (ph, pw) with the last row / column replicated."""
    h, w = plane.shape
    dev = plane.device
    rows = torch.clamp(torch.arange(ph, device=dev), max=h - 1)
    cols = torch.clamp(torch.arange(pw, device=dev), max=w - 1)
    return plane[rows][:, cols]


def _scalar(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def _list_maps(l0map, l1map, device):
    """A B slice's per-list union indices as int64 tensors (None for P)."""
    if l1map is None:
        return None
    return tuple(torch.tensor(m, dtype=torch.int64, device=device)
                 for m in (l0map, l1map))


def _union_idx(r, lx, maps):
    """(ref within its list, list) -> index into the union reference
    stack of a B slice; P slices (maps None) index the stack by r."""
    if maps is None:
        return r
    l0m, l1m = maps
    i64 = lambda a: a.to(torch.int64)
    return torch.where(lx == 0, l0m[i64(torch.clamp(r, 0, len(l0m) - 1))],
                       l1m[i64(torch.clamp(r, 0, len(l1m) - 1))])


def amvp_rd(cbflat, nbv, nbp, aref, amx, amy, ref_pocs, cur_poc: int,
            num_ref: int, *, t=None, n_active=None, lx=None,
            ref_pocs_l1=None, num_ref_l1: int = 0, depth: int = 0):
    """The AMVP hypothesis's signalling of a CU batch: K18 on CUDA
    tensors, the plain version on CPU ones; arguments and results as
    `amvp_rd_plain`."""
    if not nbp.is_cuda:
        return amvp_rd_plain(cbflat, nbv, nbp, aref, amx, amy, ref_pocs,
                             cur_poc, num_ref, t=t, n_active=n_active, lx=lx,
                             ref_pocs_l1=ref_pocs_l1, num_ref_l1=num_ref_l1,
                             depth=depth)
    B = nbp.shape[0]
    is_b = lx is not None
    if nbp.dim() != 3 or nbp.shape[1] != 5 or nbp.shape[2] <= K_REF1 \
            or tuple(nbv.shape) != (B, 5) \
            or ref_pocs.numel() < num_ref or num_ref < 1 \
            or (is_b and (ref_pocs_l1 is None
                          or not 1 <= num_ref_l1 <= ref_pocs_l1.numel())):
        raise ValueError(f"amvp_rd: (B, 5) valid flags and (B, 5, 14) state "
                         f"rows with the lists' POCs, got {tuple(nbv.shape)}, "
                         f"{tuple(nbp.shape)}, {num_ref} / {num_ref_l1} "
                         f"references")
    dev = nbp.device
    oi = torch.empty((10, B), dtype=torch.int32, device=dev)
    of = torch.empty((2, B), dtype=torch.float32, device=dev)
    if B:
        i32 = lambda a: a.to(torch.int32).contiguous()
        # ref_idx's cMax (0: not coded); P slices code n_active - 1
        cmax0 = 0 if num_ref <= 1 else (
            num_ref - 1 if is_b or n_active is None
            else max(n_active - 1, 0))
        cmax1 = max(num_ref_l1 - 1, 0)
        kernels.launch(
            "amvp_rd", "hm_amvp_rd", i32(nbv), i32(nbp), i32(aref),
            i32(amx), i32(amy), i32(lx) if is_b else None,
            None if t is None else torch.stack([i32(a) for a in t], 1),
            i32(ref_pocs), i32(ref_pocs_l1) if is_b else None, cbflat, oi,
            of, B, nbp.shape[2], K_DIR, K_MVX, K_MVY, K_REF, K_MVX1, K_MVY1,
            K_REF1, int(cur_poc), num_ref, num_ref_l1 if is_b else 1, cmax0,
            cmax1, depth, OFF["MVD"], OFF["REF_PIC"], OFF["INTER_DIR"])
    return oi[0], oi[1], oi[2], of[0], of[1], tuple(oi[3:])


def amvp_rd_plain(cbflat, nbv, nbp, aref, amx, amy, ref_pocs, cur_poc: int,
                  num_ref: int, *, t=None, n_active=None, lx=None,
                  ref_pocs_l1=None, num_ref_l1: int = 0, depth: int = 0):
    """Plain version of K18: per lane the AMVP list (P: with the temporal
    candidate t = (t_ok, t_mvx, t_mvy) scaled to the lane's reference; B
    slices, lx given: the lane's target list lx), the mvd against both
    predictors (predictor 1 only when its bits are lower), the ref_idx
    bits (P: cMax from n_active when given) and, in B slices, the
    inter_pred_idc bits at CU depth `depth`.

    nbv (B, 5) bool, the neighbours' validity; nbp (B, 5, 14) their state
    rows (K_* columns); aref / amx / amy (B,) the searched reference and
    quarter-pel MV; ref_pocs (/ ref_pocs_l1) the lists' POC tensors.
    Returns (mvp index int32, mvdx, mvdy, mvd bits, ref_idx (+ dir) bits,
    the AMVP CU's motion (dir, mvx0, mvy0, ref0, mvx1, mvy1, ref1))."""
    nmx, nmy, nrf = nbp[..., K_MVX], nbp[..., K_MVY], nbp[..., K_REF]
    i64 = lambda a: a.to(torch.int64)
    is_b = lx is not None
    takw = {} if t is None else dict(t_ok=t[0], t_mvx=t[1], t_mvy=t[2])
    if is_b:
        nmx1, nmy1, nrf1 = (nbp[..., K_MVX1], nbp[..., K_MVY1],
                            nbp[..., K_REF1])
        tpoc = torch.where(
            lx == 0, ref_pocs[i64(torch.clamp(aref, 0, num_ref - 1))],
            ref_pocs_l1[i64(torch.clamp(aref, 0, num_ref_l1 - 1))])
        p0x, p0y, p1x, p1y = amvp_candidates_dev_b(
            nbv, nbp[..., K_DIR], nmx, nmy,
            ref_pocs[i64(torch.clamp(nrf, 0, num_ref - 1))], nmx1, nmy1,
            ref_pocs_l1[i64(torch.clamp(nrf1, 0, num_ref_l1 - 1))],
            lx, tpoc, cur_poc, **takw)
    else:
        p0x, p0y, p1x, p1y = amvp_candidates_dev(
            nbv, nmx, nmy, ref_pocs[i64(torch.clamp(nrf, 0, num_ref - 1))],
            ref_pocs[i64(aref)], cur_poc, **takw)
    bits0 = mvd_bits(cbflat, amx - p0x, amy - p0y)
    bits1 = mvd_bits(cbflat, amx - p1x, amy - p1y)
    use1 = bits1 < bits0
    mvdx = torch.where(use1, amx - p1x, amx - p0x)
    mvdy = torch.where(use1, amy - p1y, amy - p0y)
    zero = torch.zeros_like(amx)
    if is_b:
        b_refa = torch.where(
            lx == 0, ref_idx_bits(cbflat, aref, num_ref),
            ref_idx_bits(cbflat, aref, num_ref_l1)) \
            + inter_dir_bits(cbflat, 1 + lx, depth)
        u0a = lx == 0
        sel = lambda a, l1: torch.where(u0a == (not l1), a, 0)
        mot = (1 + lx, sel(amx, 0), sel(amy, 0), sel(aref, 0),
               sel(amx, 1), sel(amy, 1), sel(aref, 1))
    else:
        b_refa = ref_idx_bits(cbflat, aref, num_ref, n_active=n_active)
        mot = (zero + 1, amx, amy, aref, zero, zero, zero)
    return (use1.to(torch.int32), mvdx, mvdy,
            torch.minimum(bits0, bits1), b_refa, mot)


def t_level_plain(col, col_poc: int, n: int, aref, ref_pocs_t,
                  cur_poc: int, *, w: int, h: int, log2_ctu: int,
                  gw: int = None, gh: int = None):
    """Plain version of K24: the collocated candidate of every block of
    the n-grid (8.5.3.2.8, `temporal_cand_grid_dev`) scaled to reference
    0 (merge) and to the block's searched reference aref (AMVP).  col the
    collocated field (mvx, mvy, ok, ref POC on the 8x8 grid), ref_pocs_t
    the L0 POCs as a tensor.  Returns (t_ok, merge x, y, AMVP x, y)."""
    t_ok, rx, ry, rp = temporal_cand_grid_dev(
        col[0], col[1], col[2], col[3], n, w, h, log2_ctu, gw=gw, gh=gh)
    td = col_poc - rp
    tmx, tmy = scale_mv_pair_dev(rx, ry, cur_poc - ref_pocs_t[0], td)
    tax, tay = scale_mv_pair_dev(
        rx, ry, cur_poc - ref_pocs_t[aref.to(torch.int64)], td)
    return t_ok, tmx, tmy, tax, tay


def tmvp_grid_plain(col, col_poc: int, n: int, aref, ref_pocs_t,
                    cur_poc: int, *, w: int, h: int, log2_ctu: int,
                    gw: int = None, gh: int = None):
    """`tmvp_grid` through `t_level_plain`, on any device."""
    return torch.stack([a.to(torch.int32) for a in t_level_plain(
        col, col_poc, n, aref, ref_pocs_t, cur_poc, w=w, h=h,
        log2_ctu=log2_ctu, gw=gw, gh=gh)])


def tmvp_grid(col, col_poc: int, n: int, aref, ref_pocs_t, cur_poc: int,
              *, w: int, h: int, log2_ctu: int, gw: int = None,
              gh: int = None):
    """`t_level_plain`'s five outputs as one (5, gw * gh) int32 tensor:
    K24 on CUDA tensors, the plain version on CPU ones."""
    if gw is None:
        gw, gh = w // n, h // n
    if not aref.is_cuda:
        return tmvp_grid_plain(col, col_poc, n, aref, ref_pocs_t, cur_poc,
                               w=w, h=h, log2_ctu=log2_ctu, gw=gw, gh=gh)
    bw, bh = w // 8, h // 8
    if aref.numel() != gw * gh or any(tuple(c.shape) != (bh, bw)
                                      for c in col):
        raise ValueError(f"tmvp_grid: a ({gh}, {gw}) grid of references "
                         f"and ({bh}, {bw}) collocated fields, got "
                         f"{tuple(aref.shape)}, "
                         f"{[tuple(c.shape) for c in col]}")
    i32 = lambda a: a.to(torch.int32).contiguous()
    out = torch.empty((5, gw * gh), dtype=torch.int32, device=aref.device)
    kernels.launch("tmvp_grid", "hm_tmvp_grid", *(i32(c) for c in col),
                   i32(aref.reshape(-1)), i32(ref_pocs_t), out, n, gw, gh,
                   w, h, log2_ctu, int(cur_poc), int(col_poc),
                   ref_pocs_t.numel())
    return out


def tmvp_grids_plain(col, col_poc: int, grids, ref_pocs_t, cur_poc: int,
                     *, w: int, h: int, log2_ctu: int):
    """Plain version of K24's grids form: `t_level_plain` per grid, each
    stacked as `tmvp_grid_plain` stacks it."""
    return [tmvp_grid_plain(col, col_poc, n, aref, ref_pocs_t, cur_poc,
                            w=w, h=h, log2_ctu=log2_ctu, gw=gw, gh=gh)
            for n, aref, gw, gh in grids]


def tmvp_grids(col, col_poc: int, grids, ref_pocs_t, cur_poc: int, *,
               w: int, h: int, log2_ctu: int):
    """The temporal candidates of up to three CU grids of a P pass in one
    call: grids [(n, aref, gw, gh)], each grid's searched references aref
    (gw * gh,).  Returns a (5, gw * gh) int32 tensor a grid, as
    `tmvp_grid`: K24 on CUDA tensors (one launch; the grids' rows one
    after another in one output, so each is a contiguous view of it), the
    plain version on CPU ones.  col's four fields are readied once."""
    if not ref_pocs_t.is_cuda:
        return tmvp_grids_plain(col, col_poc, grids, ref_pocs_t, cur_poc,
                                w=w, h=h, log2_ctu=log2_ctu)
    bw, bh = w // 8, h // 8
    if not 1 <= len(grids) <= 3 or any(tuple(c.shape) != (bh, bw)
                                       for c in col):
        raise ValueError(f"tmvp_grids: 1-3 grids and ({bh}, {bw}) "
                         f"collocated fields, got {len(grids)} grids, "
                         f"{[tuple(c.shape) for c in col]}")
    dev = ref_pocs_t.get_device()
    cols = [kernels.ready(c) for c in col]
    pocs = kernels.ready(ref_pocs_t)
    ps = [gw * gh for _, _, gw, gh in grids]
    out = torch.empty((5 * sum(ps),), dtype=torch.int32,
                      device=ref_pocs_t.device)
    arefs, geo = [], []
    for (n, aref, gw, gh), p in zip(grids, ps):
        if aref.numel() != p:
            raise ValueError(f"tmvp_grids: a ({gh}, {gw}) grid of "
                             f"references, got {tuple(aref.shape)}")
        arefs.append(kernels.ready(aref.reshape(-1)))
        geo += [n, gw, gh]
    if any(t.get_device() != dev for t in cols + arefs):
        raise ValueError("tmvp_grids: every tensor on the POCs' CUDA "
                         "device")
    pad = 3 - len(grids)
    kernels.launch_checked(
        "tmvp_grid", "hm_tmvp_grids", dev, *(c.data_ptr() for c in cols),
        pocs.data_ptr(), out.data_ptr(), *(a.data_ptr() for a in arefs),
        *(None,) * pad, len(grids), *geo, *(0,) * (3 * pad), w, h,
        log2_ctu, int(cur_poc), int(col_poc), ref_pocs_t.numel())
    return [o.view(5, p) for o, p in zip(out.split([5 * p for p in ps]),
                                         ps)]


def wavefront_pass(org_y, org_u, org_v, refs_y, refs_u, refs_v,
                   mv_x, mv_y, mv_ref, ref_pocs, cur_poc: int,
                   mv16=None, mv32=None, qp: int = 32, qpc: int = 32,
                   col=None, col_poc: int = 0, cbflat=None,
                   mv_lx=None, ref_pocs_l1=None, **kw):
    """The P- or B-slice decision pass (arguments and result as
    `wavefront_pass_plain`): CUDA tensors run the walker (`pframe_walk`:
    in a P slice K23 once per z-scan level after one K24 launch for the
    CU grids, in a B slice K26 once per level), CPU tensors the plain
    pass."""
    args = (org_y, org_u, org_v, refs_y, refs_u, refs_v, mv_x, mv_y, mv_ref,
            ref_pocs, cur_poc, mv16, mv32, qp, qpc, col, col_poc, cbflat,
            mv_lx, ref_pocs_l1)
    if not org_y.is_cuda:
        return wavefront_pass_plain(*args, **kw)
    return pframe_walk(*args, **kw)


def wavefront_pass_plain(org_y, org_u, org_v, refs_y, refs_u, refs_v,
                         mv_x, mv_y, mv_ref, ref_pocs, cur_poc: int,
                         mv16=None, mv32=None, qp: int = 32, qpc: int = 32,
                         col=None, col_poc: int = 0, cbflat=None,
                         mv_lx=None, ref_pocs_l1=None,
                         *, w: int, h: int, num_ref: int, max_merge: int,
                         bd: int = 8, qp_factor=0.57, levels: int = 1,
                         tmvp: bool = False, log2_ctu: int = 6,
                         sdh: bool = False, rdoq: bool = True,
                         n_active=None, ts: bool = False,
                         num_ref_l1: int = 0, l0map: tuple = None,
                         l1map: tuple = None):
    """The P- or B-slice decision pass, the plain version of K23 (and of
    K24 through `t_level_plain`) and of K26.  Planes and the reference
    stacks are int32 tensors on the pass's device; mv_* the phase-1 ME field on
    the 8x8 grid (quarter-pel, ref index), mv16 / mv32 the same on the
    16 and (padded) 32 grids; ref_pocs a host list, cur_poc, col_poc,
    qp, qpc and n_active host ints; col the collocated field (4 tensors
    on the 8x8 grid) or None.  ts: the 4x4 chroma TBs of 8x8 CUs get
    the transform-skip trial.

    B slices (num_ref_l1 > 0): refs_* hold the union of both lists,
    l0map / l1map give each list's union index per reference, mv_lx and
    the fourth entries of mv16 / mv32 the ME's list per block, and
    ref_pocs_l1 the list-1 POCs.  Returns the state dict (int32)."""
    dev = org_y.device
    st8 = _dev_static(w, h, log2_ctu, dev)
    bw, bh = w // 8, h // 8
    P = bw * bh
    Ru = refs_y.shape[0]
    lam_, lam_sqrt_, wchroma_, lam_c_ = frame_lambdas(qp, qpc, qp_factor)
    lam, lam_sqrt = _scalar(lam_, dev), _scalar(lam_sqrt_, dev)
    wchroma, lam_c = _scalar(wchroma_, dev), _scalar(lam_c_, dev)
    mid = 1 << (bd - 1)
    ar = lambda n: torch.arange(n, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    ref_pocs_t = torch.tensor(list(ref_pocs), **i32)
    is_b = num_ref_l1 > 0
    maps = _list_maps(l0map, l1map, dev) if is_b else None
    union_idx = lambda r, lx: _union_idx(r, lx, maps)
    if is_b:
        ref_pocs_l1_t = torch.tensor(list(ref_pocs_l1), **i32)

    nb_ok, nb_flat = st8["nb_ok"], st8["nb_flat"]
    sub_y, none_y = st8["g8"]
    sub_u, none_c = st8["g4"]
    bidx = ar(P)
    by_all, bx_all = bidx // bw, bidx % bw
    x0_all, y0_all = bx_all * 8, by_all * 8
    org_blk = _blockify(org_y, 8)
    orgu_blk = _blockify(org_u, 4)
    orgv_blk = _blockify(org_v, 4)
    any_nz = lambda lev, B: (lev.reshape(B, -1) != 0).any(1)
    two = lambda a: torch.cat([a, a])

    def code(*a, **k):
        return _code(*a, rdoq=rdoq, **k)

    # ---- phase 1a: AMVP candidate prediction + residual for all blocks
    mvxf, mvyf = mv_x.reshape(-1), mv_y.reshape(-1)
    rself = mv_ref.reshape(-1)
    lxf = mv_lx.reshape(-1) if is_b else None
    rsu = union_idx(rself, lxf)
    pred_a = mc_luma_batch_refs(refs_y, rsu, x0_all, y0_all, mvxf, mvyf,
                                8, 8, bd)
    pred_au = mc_chroma_batch_refs(refs_u, rsu, bx_all * 4, by_all * 4,
                                   mvxf, mvyf, 4, 4, bd)
    pred_av = mc_chroma_batch_refs(refs_v, rsu, bx_all * 4, by_all * 4,
                                   mvxf, mvyf, 4, 4, bd)
    lev_ay, rec_ay, d_ay, b_ay = code(org_blk, pred_a, qp, 3, bd, lam,
                                      cbflat, True, sdh=sdh)
    if ts:
        levAC, recAC, dAC, bAC, tsAC = _code_ts_sel(
            torch.cat([orgu_blk, orgv_blk]), torch.cat([pred_au, pred_av]),
            qpc, bd, lam_c, cbflat, False, wchroma, sdh=sdh, rdoq=rdoq)
        lev_au, lev_av = levAC[:P], levAC[P:]
        rec_au, rec_av = recAC[:P], recAC[P:]
        d_au, d_av = dAC[:P], dAC[P:]
        b_au, b_av = bAC[:P], bAC[P:]
        ts_a = tsAC[:P].to(torch.int32) | (tsAC[P:].to(torch.int32) << 1)
    else:
        lev_au, rec_au, d_au, b_au = code(orgu_blk, pred_au, qpc, 2, bd,
                                          lam_c, cbflat, False, wchroma,
                                          sdh=sdh)
        lev_av, rec_av, d_av, b_av = code(orgv_blk, pred_av, qpc, 2, bd,
                                          lam_c, cbflat, False, wchroma,
                                          sdh=sdh)
        ts_a = torch.zeros((P,), **i32)
    dist_a = d_ay + d_au + d_av
    bits_a_lev = b_ay + b_au + b_av
    cbf_a8 = (any_nz(lev_ay, P), any_nz(lev_au, P), any_nz(lev_av, P))

    def cbf_bits_inter(y_nz, cb_nz, cr_nz):
        """Chroma cbf pair + luma cbf (inferred 1 when both chroma are
        zero -- the native writer's inter-CU convention)."""
        b = cbf_chroma_bits(cbflat, cb_nz) + cbf_chroma_bits(cbflat, cr_nz)
        return b + torch.where(cb_nz | cr_nz, cbf_luma_bits(cbflat, y_nz),
                               0.0)

    def root_cbf_bits(y_nz, cb_nz, cr_nz):
        """rqt_root_cbf + (cbf flags when coded) for an AMVP CU."""
        root = y_nz | cb_nz | cr_nz
        return rqt_root_cbf_bits(cbflat, root) + torch.where(
            root, cbf_bits_inter(y_nz, cb_nz, cr_nz), 0.0)

    # ---- phase 1b: open-loop intra mode per block (org-pixel refs)
    # (K22 on the card: the first of a stable sort is argmin's first
    # minimum), over the I pass's int32 gather map of the 8x8 blocks
    from hmtpu_torch.encoder.iframe_dev import _dev_static as i_static

    imode = rmd(org_y, i_static(w, h, log2_ctu, dev)["g8"], 8, 1, bd=bd,
                lam_sqrt=lam_sqrt_, sis=False)[:, 0]

    lev_a96 = torch.cat([lev_ay.reshape(P, 64), lev_au.reshape(P, 16),
                         lev_av.reshape(P, 16)], 1)
    refs_c = torch.cat([refs_u, refs_v], 0)           # (2R, H/2, W/2)

    # ---- phase 1c: collocated temporal candidates (8.5.3.2.8), one
    # dense derivation per CU-grid level; merge targets reference 0,
    # AMVP the block's searched reference
    def t_level(n, aref, gw=None, gh=None):
        return t_level_plain(col, col_poc, n, aref, ref_pocs_t, cur_poc,
                             w=w, h=h, log2_ctu=log2_ctu, gw=gw, gh=gh)

    t8 = t_level(8, rself) if tmvp else None

    # ---- phase 2 state: per 8x8 cell [kind, mi, mvdx, mvdy, mvpi, dir,
    # mvx, mvy, ref, size-code, luma-cbf, mvx1, mvy1, ref1] and the
    # (P, 96) levels; one spare slot per array for padding lanes
    st = dict(
        rec_y=torch.zeros(h * w + 1, **i32),
        rec_u=torch.zeros(h * w // 4 + 1, **i32),
        rec_v=torch.zeros(h * w // 4 + 1, **i32),
        blk=torch.zeros((P + 1, 14), **i32),
        levs=torch.zeros((P + 1, 96), **i32),
        tsf=torch.zeros(P + 1, **i32),
    )
    bits_mi_row = merge_idx_bits(cbflat, ar(max_merge), max_merge)

    def plane_index(x0, y0, n, valid, width, spare):
        """(B, n, n) flat indices of the n x n blocks at (x0, y0);
        padding lanes point at the spare slot."""
        yy = y0[:, None] + ar(n)[None, :]
        xx = x0[:, None] + ar(n)[None, :]
        fl = yy[:, :, None] * width + xx[:, None, :]
        return torch.where(valid[:, None, None], fl, spare)

    def commit(x0, y0, n, valid, rec, slots, vals):
        """Scatter reconstruction and per-cell decisions (in place)."""
        fl_y = plane_index(x0, y0, n, valid, w, h * w)
        fl_c = plane_index(x0 // 2, y0 // 2, n // 2, valid, w // 2,
                           h * w // 4)
        st["rec_y"][fl_y] = rec[0]
        st["rec_u"][fl_c] = rec[1]
        st["rec_v"][fl_c] = rec[2]
        for k, v in vals.items():
            st[k][slots] = v

    def mode_prices(g, corner, gx, gy):
        """cu_skip_flag bits from the committed state left of / above
        `corner` (9.3.4.2.2 ctx); returns (l_blk, a_blk, b_skip1,
        b_skip0)."""
        cL = torch.where(gx > 0, corner - 1, 0)
        cA = torch.where(gy > 0, corner - bw, 0)
        l_blk, a_blk = st["blk"][cL], st["blk"][cA]
        inc_sk = ((gx > 0) & (l_blk[:, K_KIND] == 0)).to(torch.int32) \
            + ((gy > 0) & (a_blk[:, K_KIND] == 0)).to(torch.int32)
        b_skip1 = skip_flag_bits(cbflat, torch.ones_like(g), inc_sk)
        b_skip0 = skip_flag_bits(cbflat, torch.zeros_like(g), inc_sk)
        return l_blk, a_blk, b_skip1, b_skip0

    def p_merge_all_rd(org, orgu, orgv, x0, y0, n: int, log2y: int,
                       cmx, cmy, crf, b_skip1, b_inter,
                       extra_y=None, extra_c=None, sel_y=None, sel_c=None):
        """Full residual RD over every merge candidate (the batched form
        of HM's xCheckRDCostMerge2Nx2N loop, TEncCu.cpp:1157): skip
        priced per candidate by its exact 3-plane SSE; the top-F
        candidates by screening coded with deadzone quantisation; the
        winner recoded with the RDOQ trellis.  extra_*: intra TBs fused
        into the same coding batches, returned after the merge lanes.
        With ts, the winner's (and the extras') 4x4 chroma TBs take the
        transform-skip trial."""
        B = org.shape[0]
        M = max_merge
        F = min(2, M)
        nc = n // 2
        rep = lambda a: a.repeat_interleave(M)
        rowsB = ar(B)
        crf_f = crf.reshape(-1)
        pred_l = mc_luma_batch_refs(
            refs_y, crf_f, rep(x0), rep(y0), cmx.reshape(-1),
            cmy.reshape(-1), n, n, bd).reshape(B, M, n, n)
        pc = mc_chroma_batch_refs(
            refs_c, torch.cat([crf_f, crf_f + Ru]), two(rep(x0 // 2)),
            two(rep(y0 // 2)), two(cmx.reshape(-1)), two(cmy.reshape(-1)),
            nc, nc, bd)
        BM = B * M
        pred_cbM = pc[:BM].reshape(B, M, nc, nc)
        pred_crM = pc[BM:].reshape(B, M, nc, nc)

        ssq = lambda a, b: ((a - b) ** 2).sum((-1, -2))
        sse3_m = ssq(org[:, None], pred_l).to(torch.float32) + wchroma * (
            ssq(orgu[:, None], pred_cbM) + ssq(orgv[:, None], pred_crM)
        ).to(torch.float32)
        cost_skip_m = sse3_m + lam * (b_skip1[:, None] + bits_mi_row[None])
        mi_skip = cost_skip_m.argmin(1)

        screen = sse3_m + lam * bits_mi_row[None]
        fidx = torch.sort(screen, dim=1, stable=True).indices[:, :F]  # (B, F)
        gf = lambda a: torch.gather(a, 1, fidx)
        fmx, fmy, frf = gf(cmx), gf(cmy), gf(crf)
        pred_f = pred_l[rowsB[:, None], fidx]                # (B, F, n, n)
        pred_cbF = pred_cbM[rowsB[:, None], fidx]
        pred_crF = pred_crM[rowsB[:, None], fidx]
        BF = B * F
        tile = lambda a: a[:, None].expand((B, F) + a.shape[1:]) \
            .reshape((BF,) + a.shape[1:])
        levYd, _, dYd, bYd = _code(tile(org), pred_f.reshape(BF, n, n),
                                   qp, log2y, bd, lam, cbflat, True,
                                   sdh=sdh, rdoq=False)
        levCd, _, dCd, bCd = _code(
            torch.cat([tile(orgu), tile(orgv)]),
            torch.cat([pred_cbF.reshape(BF, nc, nc),
                       pred_crF.reshape(BF, nc, nc)]),
            qpc, log2y - 1, bd, lam_c, cbflat, False, wchroma,
            sdh=sdh, rdoq=False)
        nzYd = (levYd.reshape(B, F, -1) != 0).any(-1)
        nzCbd = (levCd[:BF].reshape(B, F, -1) != 0).any(-1)
        nzCrd = (levCd[BF:].reshape(B, F, -1) != 0).any(-1)
        bits_mi_f = torch.gather(bits_mi_row[None].expand(B, M), 1, fidx)
        cost_f = (dYd.reshape(B, F) + dCd[:BF].reshape(B, F)
                  + dCd[BF:].reshape(B, F)) + lam * (
            bits_mi_f + cbf_bits_inter(nzYd, nzCbd, nzCrd)
            + bYd.reshape(B, F) + bCd[:BF].reshape(B, F)
            + bCd[BF:].reshape(B, F))
        fi_merge = cost_f.argmin(1)
        g1 = lambda a, fi: torch.gather(a, 1, fi[:, None])[:, 0]
        gt = lambda a, fi: a[rowsB, fi]
        w_pred = gt(pred_f, fi_merge)
        w_pcb = gt(pred_cbF, fi_merge)
        w_pcr = gt(pred_crF, fi_merge)

        # winner recoded with the RDOQ trellis; the intra extras ride
        # the same batches
        orgs_y, preds_y, sely = org, w_pred, None
        if extra_y is not None:
            orgs_y = two(org)
            preds_y = torch.cat([w_pred, extra_y])
            sely = torch.cat([torch.zeros((B,), **i32), sel_y])
        levY, recY, dY, bY = code(orgs_y, preds_y, qp, log2y, bd, lam,
                                  cbflat, True, sdh=sdh, scan_sel=sely)
        orgs_c = torch.cat([orgu, orgv])
        preds_c = torch.cat([w_pcb, w_pcr])
        selc = None
        if extra_c is not None:
            orgs_c = two(orgs_c)
            preds_c = torch.cat([preds_c, extra_c])
            selc = torch.cat([torch.zeros((2 * B,), **i32), sel_c])
        if ts and log2y == 3:
            # 4x4 chroma TBs: the transform-skip trial per TB, its flag
            # priced in (TComTrQuant.cpp:1460 TS branch)
            levC, recC, dC, bC, ts_c = _code_ts_sel(
                orgs_c, preds_c, qpc, bd, lam_c, cbflat, False, wchroma,
                sdh=sdh, scan_sel=selc, rdoq=rdoq)
        else:
            levC, recC, dC, bC = code(orgs_c, preds_c, qpc, log2y - 1, bd,
                                      lam_c, cbflat, False, wchroma,
                                      sdh=sdh, scan_sel=selc)
            ts_c = torch.zeros((orgs_c.shape[0],), dtype=torch.bool,
                               device=dev)
        lev_my, rec_my, d_my, b_my = levY[:B], recY[:B], dY[:B], bY[:B]
        lev_mu, rec_mu = levC[:B], recC[:B]
        lev_mv, rec_mv = levC[B:2 * B], recC[B:2 * B]
        d_mu, b_mu = dC[:B], bC[:B]
        d_mv, b_mv = dC[B:2 * B], bC[B:2 * B]
        y_nz, cb_nz, cr_nz = any_nz(lev_my, B), any_nz(lev_mu, B), \
            any_nz(lev_mv, B)
        mrg_hdr = b_inter + merge_flag_bits(
            cbflat, torch.ones((B,), **i32)) + g1(bits_mi_f, fi_merge)
        cost_merge = d_my + d_mu + d_mv + lam * (
            mrg_hdr + cbf_bits_inter(y_nz, cb_nz, cr_nz)
            + b_my + b_mu + b_mv)
        # an all-zero-residual merge IS skip with one extra flag; the
        # skip hypothesis covers it
        cost_merge = torch.where(y_nz | cb_nz | cr_nz, cost_merge, BIG)
        return dict(
            cost_skip=cost_skip_m.amin(1), cost_merge=cost_merge,
            mi_skip=mi_skip.to(torch.int32),
            mi_merge=g1(fidx, fi_merge).to(torch.int32),
            sk_mvx=g1(cmx, mi_skip), sk_mvy=g1(cmy, mi_skip),
            sk_ref=g1(crf, mi_skip),
            mg_mvx=g1(fmx, fi_merge), mg_mvy=g1(fmy, fi_merge),
            mg_ref=g1(frf, fi_merge),
            pred_sk_y=gt(pred_l, mi_skip), pred_sk_u=gt(pred_cbM, mi_skip),
            pred_sk_v=gt(pred_crM, mi_skip),
            lev_my=lev_my, rec_my=rec_my, lev_mu=lev_mu, rec_mu=rec_mu,
            lev_mv=lev_mv, rec_mv=rec_mv, cbf_m=(y_nz, cb_nz, cr_nz),
            ts_m=ts_c[:B].to(torch.int32) | (ts_c[B:2 * B].to(torch.int32)
                                              << 1),
            ts_extra=ts_c[2 * B:3 * B].to(torch.int32)
            | (ts_c[3 * B:].to(torch.int32) << 1),
            extra=(levY[B:], recY[B:], dY[B:], bY[B:],
                   levC[2 * B:], recC[2 * B:], dC[2 * B:], bC[2 * B:]))

    def neighbours(nb_idx, nb_avail):
        nbp = st["blk"][nb_idx]                          # (B, 5, 14)
        return nb_avail & (nbp[..., K_DIR] > 0), nbp

    def amvp_cu(nbv, nbp, aref, amx, amy, tlev, g, lxb, depth: int):
        """`amvp_rd` for one CU batch of the pass (TMVP in P slices)."""
        t = None if tlev is None or is_b \
            else (tlev[0][g], tlev[3][g], tlev[4][g])
        return amvp_rd(cbflat, nbv, nbp, aref, amx, amy, ref_pocs_t,
                       cur_poc, num_ref, t=t, n_active=n_active, lx=lxb,
                       ref_pocs_l1=ref_pocs_l1_t if is_b else None,
                       num_ref_l1=num_ref_l1, depth=depth)

    def merge_rd(org, orgu, orgv, x0, y0, n: int, log2y: int, nbv, nbp,
                 tlev, g, b_skip1, b_inter, **extra):
        """The merge and skip hypotheses of one CU batch: P slices through
        p_merge_all_rd, B slices through b_merge_rd.  Adds the skip and
        merge winners' motion (dir, L0, L1) as "sk" and "mg"."""
        if is_b:
            return b_merge_rd(org, orgu, orgv, x0, y0, n, log2y, nbv, nbp,
                              b_skip1, b_inter, **extra)
        nmx, nmy, nrf = nbp[..., K_MVX], nbp[..., K_MVY], nbp[..., K_REF]
        tkw = {} if tlev is None else dict(
            t_ok=tlev[0][g], t_mvx=tlev[1][g], t_mvy=tlev[2][g])
        cmx, cmy, crf = merge_candidates_dev(nbv, nmx, nmy, nrf, num_ref,
                                             max_merge, n_active=n_active,
                                             **tkw)
        mrd = p_merge_all_rd(org, orgu, orgv, x0, y0, n, log2y, cmx, cmy,
                             crf, b_skip1, b_inter, **extra)
        zero = torch.zeros_like(mrd["sk_mvx"])
        for k in ("sk", "mg"):
            mrd[k] = (zero + 1, mrd[k + "_mvx"], mrd[k + "_mvy"],
                      mrd[k + "_ref"], zero, zero, zero)
        return mrd

    def merge_b_nxn(nbv, nbp, x0, y0, n):
        """B-slice merge list, every candidate's hypotheses at
        intermediate precision (K11) and its screening prediction: the
        bi-average where the candidate is bi, else the approximate final
        samples of its list's hypothesis (K12)."""
        B, M = x0.shape[0], max_merge
        rep = lambda a: a.repeat_interleave(M)
        cands = merge_candidates_dev_b(
            nbv, nbp[..., K_DIR], nbp[..., K_MVX], nbp[..., K_MVY],
            nbp[..., K_REF], nbp[..., K_MVX1], nbp[..., K_MVY1],
            nbp[..., K_REF1], ref_pocs_t, ref_pocs_l1_t, num_ref,
            num_ref_l1, max_merge)
        cdir, cmx, cmy, crf, cmx1, cmy1, crf1 = cands
        zl = torch.zeros_like(cdir.reshape(-1))
        i0 = mc_luma_batch_refs_i(refs_y, union_idx(crf.reshape(-1), zl),
                                  rep(x0), rep(y0), cmx.reshape(-1),
                                  cmy.reshape(-1), n, n, bd)
        i1 = mc_luma_batch_refs_i(refs_y,
                                  union_idx(crf1.reshape(-1), zl + 1),
                                  rep(x0), rep(y0), cmx1.reshape(-1),
                                  cmy1.reshape(-1), n, n, bd)
        pred_l = bi_pred(i0, i1, cdir.reshape(-1), bd).reshape(B, M, n, n)
        return cands, i0.reshape(B, M, n, n), i1.reshape(B, M, n, n), pred_l

    def merge_b_winner(cands, i0, i1, mi, x0, y0, n):
        """The winning candidate's motion and its exact luma and chroma
        prediction: the uni prediction at final precision (K7), the
        bi-average of the exact hypotheses (K12; chroma's from K11)."""
        B = x0.shape[0]
        rowsB = ar(B)
        wm = tuple(torch.gather(a, 1, mi[:, None])[:, 0] for a in cands)
        w_dir, w_mvx, w_mvy, w_ref, w_mvx1, w_mvy1, w_ref1 = wm
        uses0 = (w_dir & 1) > 0
        u0w = union_idx(w_ref, torch.zeros_like(w_dir))
        u1w = union_idx(w_ref1, torch.ones_like(w_dir))
        uref = torch.where(uses0, u0w, u1w)
        umx = torch.where(uses0, w_mvx, w_mvx1)
        umy = torch.where(uses0, w_mvy, w_mvy1)
        pred_u = mc_luma_batch_refs(refs_y, uref, x0, y0, umx, umy, n, n,
                                    bd)
        w_bi = (w_dir == 3)[:, None, None]
        pred_m = torch.where(w_bi, bi_average_t(i0[rowsB, mi], i1[rowsB, mi],
                                                bd), pred_u)
        cx, cy, nc = two(x0 // 2), two(y0 // 2), n // 2
        pc_u = mc_chroma_batch_refs(refs_c, torch.cat([uref, uref + Ru]),
                                    cx, cy, two(umx), two(umy), nc, nc, bd)
        pc_i0 = mc_chroma_batch_refs_i(refs_c, torch.cat([u0w, u0w + Ru]),
                                       cx, cy, two(w_mvx), two(w_mvy), nc,
                                       nc, bd)
        pc_i1 = mc_chroma_batch_refs_i(refs_c, torch.cat([u1w, u1w + Ru]),
                                       cx, cy, two(w_mvx1), two(w_mvy1), nc,
                                       nc, bd)
        pred_c2 = torch.where(two(w_bi), bi_average_t(pc_i0, pc_i1, bd),
                              pc_u)
        return wm, pred_m, pred_c2[:B], pred_c2[B:]

    def b_merge_rd(org, orgu, orgv, x0, y0, n: int, log2y: int, nbv, nbp,
                   b_skip1, b_inter, extra_y=None, extra_c=None,
                   sel_y=None, sel_c=None):
        """B-slice merge RD: the candidate with the least screening SSE +
        merge_idx bits wins, its exact prediction is coded with the RDOQ
        trellis (the 8x8 level's intra TBs ride the same batches) and
        priced as skip and as merge.  Returns p_merge_all_rd's keys."""
        B = org.shape[0]
        cands, i0, i1, pred_l = merge_b_nxn(nbv, nbp, x0, y0, n)
        ssq = lambda a, b_: ((a - b_) ** 2).sum((-1, -2))
        mi = (ssq(org[:, None], pred_l).to(torch.float32)
              + lam * bits_mi_row[None]).argmin(1)
        wm, pred_m, pred_mu, pred_mv = merge_b_winner(cands, i0, i1, mi, x0,
                                                      y0, n)
        msse3 = ssq(org, pred_m).to(torch.float32) + wchroma * (
            ssq(orgu, pred_mu) + ssq(orgv, pred_mv)).to(torch.float32)
        orgs_y, preds_y, sely = org, pred_m, None
        if extra_y is not None:
            orgs_y = two(org)
            preds_y = torch.cat([pred_m, extra_y])
            sely = torch.cat([torch.zeros((B,), **i32), sel_y])
        levY, recY, dY, bY = code(orgs_y, preds_y, qp, log2y, bd, lam,
                                  cbflat, True, sdh=sdh, scan_sel=sely)
        orgs_c = torch.cat([orgu, orgv])
        preds_c = torch.cat([pred_mu, pred_mv])
        selc = None
        if extra_c is not None:
            orgs_c = two(orgs_c)
            preds_c = torch.cat([preds_c, extra_c])
            selc = torch.cat([torch.zeros((2 * B,), **i32), sel_c])
        levC, recC, dC, bC = code(orgs_c, preds_c, qpc, log2y - 1, bd,
                                  lam_c, cbflat, False, wchroma, sdh=sdh,
                                  scan_sel=selc)
        lev_my, lev_mu, lev_mv = levY[:B], levC[:B], levC[B:2 * B]
        cbf_m = (any_nz(lev_my, B), any_nz(lev_mu, B), any_nz(lev_mv, B))
        b_mi = merge_idx_bits(cbflat, mi, max_merge)
        mi = mi.to(torch.int32)
        zi = torch.zeros((B,), **i32)
        return dict(
            cost_skip=msse3 + lam * (b_skip1 + b_mi),
            cost_merge=dY[:B] + dC[:B] + dC[B:2 * B] + lam * (
                b_inter + merge_flag_bits(cbflat, torch.ones_like(mi))
                + b_mi + cbf_bits_inter(*cbf_m) + bY[:B] + bC[:B]
                + bC[B:2 * B]),
            mi_skip=mi, mi_merge=mi, sk=wm, mg=wm,
            pred_sk_y=pred_m, pred_sk_u=pred_mu, pred_sk_v=pred_mv,
            lev_my=lev_my, rec_my=recY[:B], lev_mu=lev_mu,
            rec_mu=recC[:B], lev_mv=lev_mv, rec_mv=recC[B:2 * B],
            cbf_m=cbf_m, ts_m=zi, ts_extra=zi,
            extra=(levY[B:], recY[B:], dY[B:], bY[B:],
                   levC[2 * B:], recC[2 * B:], dC[2 * B:], bC[2 * B:]))

    def motion_cols(pick, mrd, amot, zero):
        """The state's motion columns (dir, mvx, mvy, ref, mvx1, mvy1,
        ref1) of the chosen skip / merge / AMVP (/ intra: zero)
        hypothesis."""
        return [pick(s_, m_, a_, zero) for s_, m_, a_ in
                zip(mrd["sk"], mrd["mg"], amot)]

    def cell_step(blk, valid):
        """Decide one batch of 8x8 CUs against the committed state
        (commits in place); returns the chosen RD cost per lane."""
        b = torch.where(valid, blk, 0)
        byi, bxi = b // bw, b % bw
        x0, y0 = bxi * 8, byi * 8
        B = blk.shape[0]
        org, orgu, orgv = org_blk[b], orgu_blk[b], orgv_blk[b]
        nbv, nbp = neighbours(nb_flat[b], nb_ok[b])

        bL = torch.where(bxi > 0, b - 1, 0)
        bA = torch.where(byi > 0, b - bw, 0)
        l_blk, a_blk, b_skip1, b_skip0 = mode_prices(b, b, bxi, byi)
        l_k, a_k = l_blk[:, K_KIND], a_blk[:, K_KIND]
        b_common = b_skip0 + part_size_2nx2n_bits(cbflat)
        b_inter = b_common + pred_mode_bits(cbflat, torch.zeros_like(b))

        # intra prediction: exact, from committed recon
        iref = torch.where(none_y[b, None], mid, st["rec_y"][sub_y[b]])
        iref_f = filter_reference_batched(iref, 8, bd, strong=False)
        im = imode[b]
        ipred = predict_one_mode(iref, iref_f, im, 8, True, bd)
        irefu = torch.where(none_c[b, None], mid, st["rec_u"][sub_u[b]])
        irefv = torch.where(none_c[b, None], mid, st["rec_v"][sub_u[b]])
        irefc = torch.cat([irefu, irefv])
        cp2 = predict_one_mode(irefc, irefc, two(im), 4, False, bd)
        isel = _intra_scan_sel(im)

        mrd = merge_rd(org, orgu, orgv, x0, y0, 8, 3, nbv, nbp, t8, b,
                       b_skip1, b_inter, extra_y=ipred, extra_c=cp2,
                       sel_y=isel, sel_c=two(isel))
        cost_skip, cost_merge = mrd["cost_skip"], mrd["cost_merge"]
        cbf_m = mrd["cbf_m"]
        (lev_iy, rec_iy, d_iy, b_iy, levC2, recC2, dC2,
         bC2) = mrd["extra"]
        lev_iu, lev_iv = levC2[:B], levC2[B:]

        aref, amx, amy = rself[b], mvxf[b], mvyf[b]
        mvpi, mvdx, mvdy, bits_mvd, b_refa, amot = amvp_cu(
            nbv, nbp, aref, amx, amy, t8, b, lxf[b] if is_b else None,
            log2_ctu - 3)
        cost_amvp = dist_a[b] + lam * (
            b_inter + merge_flag_bits(cbflat, torch.zeros_like(b))
            + mvp_idx_bits(cbflat, mvpi) + bits_mvd + b_refa
            + root_cbf_bits(cbf_a8[0][b], cbf_a8[1][b], cbf_a8[2][b])
            + bits_a_lev[b])

        inter_best = torch.minimum(cost_skip,
                                   torch.minimum(cost_merge, cost_amvp))
        lmode = torch.where((bxi > 0) & (l_k == 3), imode[bL], 1)
        am_ok = (byi > 0) & ((y0 & ((1 << log2_ctu) - 1)) != 0)
        amode = torch.where(am_ok & (a_k == 3), imode[bA], 1)
        b_icbf = cbf_chroma_bits(cbflat, any_nz(lev_iu, B)) \
            + cbf_chroma_bits(cbflat, any_nz(lev_iv, B)) \
            + cbf_luma_bits(cbflat, any_nz(lev_iy, B))
        cost_intra = torch.where(
            inter_best <= INTRA_GATE * lam, BIG,
            d_iy + dC2[:B] + dC2[B:]
            + lam * (b_common
                     + pred_mode_bits(cbflat, torch.ones_like(b))
                     + intra_mode_mpm_bits(cbflat, im, lmode, amode)
                     + chroma_dm_bits(cbflat) + b_icbf
                     + b_iy + bC2[:B] + bC2[B:]))

        costs = torch.stack([cost_skip, cost_merge, cost_amvp, cost_intra],
                            1)
        choice = costs.argmin(1).to(torch.int32)
        m_zero = ~(cbf_m[0] | cbf_m[1] | cbf_m[2])
        choice = torch.where((choice == 1) & m_zero, 0, choice)
        mi = torch.where(choice == 0, mrd["mi_skip"], mrd["mi_merge"])

        def pick4(s, m, a, i):
            c = choice.reshape((-1,) + (1,) * (s.dim() - 1))
            return torch.where(c == 0, s, torch.where(
                c == 1, m, torch.where(c == 2, a, i)))

        f96 = lambda a8, c4a, c4b: torch.cat(
            [a8.reshape(B, 64), c4a.reshape(B, 16), c4b.reshape(B, 16)], 1)
        zero = torch.zeros_like(amx)
        mot = motion_cols(pick4, mrd, amot, zero)
        o_blk = torch.stack(
            [choice, mi, mvdx, mvdy, mvpi] + mot[:4] + [
                zero,
                pick4(torch.zeros((B,), dtype=torch.bool, device=dev),
                      cbf_m[0], any_nz(lev_ay[b], B),
                      any_nz(lev_iy, B)).to(torch.int32)] + mot[4:],
            1).to(torch.int32)
        commit(x0, y0, 8, valid,
               (pick4(mrd["pred_sk_y"], mrd["rec_my"], rec_ay[b], rec_iy),
                pick4(mrd["pred_sk_u"], mrd["rec_mu"], rec_au[b],
                      recC2[:B]),
                pick4(mrd["pred_sk_v"], mrd["rec_mv"], rec_av[b],
                      recC2[B:])),
               torch.where(valid, b, P),
               dict(blk=o_blk,
                    levs=pick4(torch.zeros((B, 96), **i32),
                               f96(mrd["lev_my"], mrd["lev_mu"],
                                   mrd["lev_mv"]),
                               lev_a96[b], f96(lev_iy, lev_iu, lev_iv)),
                    tsf=pick4(torch.zeros((B,), **i32), mrd["ts_m"],
                              ts_a[b], mrd["ts_extra"])))
        return costs.amin(1)

    def finish_state():
        out = {k: v[:-1] for k, v in st.items()}
        out["imode"] = imode
        return out

    if levels == 1:
        for blk in st8["lv_blk"]:
            cell_step(blk, blk >= 0)
        return finish_state()

    def hoisted_amvp(mvs, n, log2, gw_, gh_, orgs):
        """Per-region AMVP prediction + residual at CU size n; mvs =
        (mvx, mvy, ref[, list])."""
        mx, my, rr = (a.reshape(-1) for a in mvs[:3])
        lx = mvs[3].reshape(-1) if is_b else None
        ru = union_idx(rr, lx)
        q = ar(gw_ * gh_)
        qy, qx = q // gw_, q % gw_
        pa = mc_luma_batch_refs(refs_y, ru, qx * n, qy * n, mx, my, n, n,
                                bd)
        pau = mc_chroma_batch_refs(refs_u, ru, qx * (n // 2), qy * (n // 2),
                                   mx, my, n // 2, n // 2, bd)
        pav = mc_chroma_batch_refs(refs_v, ru, qx * (n // 2), qy * (n // 2),
                                   mx, my, n // 2, n // 2, bd)
        ly, ry, dy_, by_ = code(orgs[0], pa, qp, log2, bd, lam, cbflat,
                                True, sdh=sdh)
        lu, ru_, du, bu = code(orgs[1], pau, qpc, log2 - 1, bd, lam_c,
                               cbflat, False, wchroma, sdh=sdh)
        lv, rv, dv, bv = code(orgs[2], pav, qpc, log2 - 1, bd, lam_c,
                              cbflat, False, wchroma, sdh=sdh)
        m = gw_ * gh_
        return dict(mx=mx, my=my, r=rr, lx=lx, rec=(ry, ru_, rv),
                    dist=dy_ + du + dv, bits=by_ + bu + bv,
                    cbf=(any_nz(ly, m), any_nz(lu, m), any_nz(lv, m)),
                    cbfy=any_nz(ly, m),
                    lev=torch.cat([ly.reshape(m, -1), lu.reshape(m, -1),
                                   lv.reshape(m, -1)], 1))

    def large_cu(g, gx, gy, corner, n, log2, orgs, nb_idx, nb_avail, tlev,
                 hoist):
        """One n x n inter CU trial (skip / merge / AMVP, one TU) per
        lane from the committed state outside the region; returns
        (cost without split bit, choice, o_blk fields, outputs)."""
        B = g.shape[0]
        org, orgu, orgv = orgs[0][g], orgs[1][g], orgs[2][g]
        nbv, nbp = neighbours(nb_idx, nb_avail)
        l_blk, a_blk, b_skip1, b_skip0 = mode_prices(g, corner, gx, gy)
        b_inter = b_skip0 + part_size_2nx2n_bits(cbflat) \
            + pred_mode_bits(cbflat, torch.zeros_like(g))
        mrd = merge_rd(org, orgu, orgv, gx * n, gy * n, n, log2, nbv, nbp,
                       tlev, g, b_skip1, b_inter)
        aref, amx, amy = hoist["r"][g], hoist["mx"][g], hoist["my"][g]
        mvpi, mvdx, mvdy, bits_mvd, b_refa, amot = amvp_cu(
            nbv, nbp, aref, amx, amy, tlev, g,
            hoist["lx"][g] if is_b else None, log2_ctu - log2)
        cost_amvp = hoist["dist"][g] + lam * (
            b_inter + merge_flag_bits(cbflat, torch.zeros_like(g))
            + mvp_idx_bits(cbflat, mvpi) + bits_mvd + b_refa
            + root_cbf_bits(hoist["cbf"][0][g], hoist["cbf"][1][g],
                            hoist["cbf"][2][g])
            + hoist["bits"][g])
        costs = torch.stack([mrd["cost_skip"], mrd["cost_merge"],
                             cost_amvp], 1)
        c = costs.argmin(1).to(torch.int32)
        cbf_m = mrd["cbf_m"]
        m_zero = ~(cbf_m[0] | cbf_m[1] | cbf_m[2])
        c = torch.where((c == 1) & m_zero, 0, c)
        mi = torch.where(c == 0, mrd["mi_skip"], mrd["mi_merge"])

        def pick3(s, m, a, _=None):
            cc = c.reshape((-1,) + (1,) * (s.dim() - 1))
            return torch.where(cc == 0, s, torch.where(cc == 1, m, a))

        nn2 = n * n
        pack = torch.cat([mrd["lev_my"].reshape(B, nn2),
                          mrd["lev_mu"].reshape(B, nn2 // 4),
                          mrd["lev_mv"].reshape(B, nn2 // 4)], 1)
        o_lev = pick3(torch.zeros((B, nn2 * 3 // 2), **i32), pack,
                      hoist["lev"][g]).reshape(B, nn2 // 64, 96)
        rec = tuple(pick3(s, m, a[g]) for s, m, a in zip(
            (mrd["pred_sk_y"], mrd["pred_sk_u"], mrd["pred_sk_v"]),
            (mrd["rec_my"], mrd["rec_mu"], mrd["rec_mv"]), hoist["rec"]))
        mot = motion_cols(pick3, mrd, amot, None)
        o_blk = torch.stack(
            [c, mi, mvdx, mvdy, mvpi] + mot[:4] + [
                torch.full_like(c, log2 - 3),
                pick3(torch.zeros((B,), dtype=torch.bool, device=dev),
                      cbf_m[0], hoist["cbfy"][g]).to(torch.int32)] + mot[4:],
            1).to(torch.int32)
        return costs.amin(1), l_blk, a_blk, o_blk, o_lev, rec

    # ---- 16 level: per 16x16 region, four 8x8 CUs inside the scan,
    # then ONE 16x16 inter CU trial that overwrites where it wins (the
    # CU16 candidates read only state outside the region)
    gw, gh = bw // 2, bh // 2
    lv16, cells16, nb16_ok, nb16_cell = st8["sched16"]
    orgs16 = (_blockify(org_y, 16), _blockify(org_u, 8),
              _blockify(org_v, 8))
    t16 = t_level(16, mv16[2].reshape(-1)) if tmvp else None
    h16 = hoisted_amvp(mv16, 16, 4, gw, gh, orgs16)

    def split_bits(val, l_blk, a_blk, gx, gy, below):
        inc = ((gx > 0) & (l_blk[:, K_SZ] < below)).to(torch.int32) \
            + ((gy > 0) & (a_blk[:, K_SZ] < below)).to(torch.int32)
        return lam * split_flag_bits(cbflat, torch.full_like(gx, val), inc)

    def region16(blk16, valid):
        g = torch.where(valid, blk16, 0)
        B = blk16.shape[0]
        c4 = cells16[g]                                   # (B, 4)
        cost8 = torch.zeros((B,), dtype=torch.float32, device=dev)
        for j in range(4):
            cost8 = cost8 + cell_step(c4[:, j], valid)
        gyb, gxb = g // gw, g % gw
        cost16, l_blk, a_blk, o_blk, o_lev, rec = large_cu(
            g, gxb, gyb, (gyb * 2) * bw + gxb * 2, 16, 4, orgs16,
            nb16_cell[g], nb16_ok[g], t16, h16)
        # split_cu_flag at the 16 depth (ctx from neighbour depths)
        cost16 = cost16 + split_bits(0, l_blk, a_blk, gxb, gyb, 1)
        cost8 = cost8 + split_bits(1, l_blk, a_blk, gxb, gyb, 1)
        use16 = valid & (cost16 < cost8)
        commit(gxb * 16, gyb * 16, 16, use16, rec,
               torch.where(use16[:, None], c4, P),
               dict(blk=o_blk[:, None, :], levs=o_lev, tsf=0))
        return torch.where(use16, cost16, cost8)

    if levels == 2:
        for blk16 in lv16:
            region16(blk16, blk16 >= 0)
        return finish_state()

    # ---- 32 level (padded ceil grid: partial regions carry their inside
    # 16-cells but never form a 32x32 CU)
    lv32, cells16_32, cells8_32, nb32_ok, nb32_cell, full32 = st8["sched32"]
    qw, qh = (gw + 1) // 2, (gh + 1) // 2
    orgs32 = (_blockify(_edge_pad(org_y, qh * 32, qw * 32), 32),
              _blockify(_edge_pad(org_u, qh * 16, qw * 16), 16),
              _blockify(_edge_pad(org_v, qh * 16, qw * 16), 16))
    t32 = t_level(32, mv32[2].reshape(-1), gw=qw, gh=qh) if tmvp else None
    h32 = hoisted_amvp(mv32, 32, 5, qw, qh, orgs32)

    def step32(blk32):
        valid = blk32 >= 0
        g = torch.where(valid, blk32, 0)
        B = blk32.shape[0]
        c16b = cells16_32[g]                              # (B, 4)
        cost_sub = torch.zeros((B,), dtype=torch.float32, device=dev)
        for j in range(4):
            cells = c16b[:, j]
            cv = valid & (cells >= 0)
            cc = region16(torch.where(cv, cells, 0), cv)
            cost_sub = cost_sub + torch.where(cv, cc, 0.0)
        qyb, qxb = g // qw, g % qw
        cost32, l_blk, a_blk, o_blk, o_lev, rec = large_cu(
            g, qxb, qyb, (qyb * 4) * bw + qxb * 4, 32, 5, orgs32,
            nb32_cell[g], nb32_ok[g], t32, h32)
        cost32 = cost32 + split_bits(0, l_blk, a_blk, qxb, qyb, 2)
        cost_sub = cost_sub + split_bits(1, l_blk, a_blk, qxb, qyb, 2)
        use32 = valid & full32[g] & (cost32 < cost_sub)
        commit(qxb * 32, qyb * 32, 32, use32, rec,
               torch.where(use32[:, None], cells8_32[g], P),
               dict(blk=o_blk[:, None, :], levs=o_lev, tsf=0))

    for blk32 in lv32:
        step32(blk32)
    return finish_state()


# ---------------------------------------------------------------------------
# K23 and K26: the walkers' arguments (csrc/pwalk.cuh `Args`, in
# `args_from`'s order; K26's csrc/bwalk.cuh `Args` appends the B slice's)
# and their launches

_PW_CTX = ("SKIP_FLAG", "MERGE_FLAG", "MERGE_IDX", "PRED_MODE", "PART_SIZE",
           "QT_CBF_LUMA", "QT_CBF_CHROMA", "QT_ROOT_CBF", "MVP_IDX", "MVD",
           "REF_PIC", "SPLIT_FLAG", "CHROMA_PRED_MODE", "INTRA_PRED_MODE",
           "TRANSFORMSKIP_FLAG")
_PW_STATIC: dict = {}
_HOIST_KEYS = ("ref", "mvx", "mvy", "cbf", "rec_y", "rec_u", "rec_v", "lev",
               "ts", "dist", "bits")


def _pw_static(w: int, h: int, log2_ctu: int, device):
    """_p_static as int32 tensors on `device` (K23 reads them), one
    upload per geometry."""
    key = (w, h, log2_ctu, str(device))
    t = _PW_STATIC.get(key)
    if t is None:
        i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)) \
            .to(device).contiguous()
        st = _p_static(w, h, log2_ctu)
        t = {k: i32(st[k]) for k in ("lv_blk", "nb_ok", "nb_flat")}
        t["g8"], t["g4"] = (tuple(i32(a) for a in st[g])
                            for g in ("g8", "g4"))
        if st["sched32"] is not None:
            t.update(zip(("lv16", "cells16", "nb16_ok", "nb16_cell"),
                         (i32(a) for a in st["sched16"])))
            t.update(zip(("lv32", "c16_32", "c8_32", "nb32_ok", "nb32_cell",
                          "full32"), (i32(a) for a in st["sched32"])))
        _PW_STATIC[key] = t
    return t


def _k23_level(scratch, ptrs, ints, flts, level):
    kernels.launch("p_walk", "hm_p_walk", scratch,
                   *(x for arr in (ptrs, ints, flts)
                     for x in (ctypes.addressof(arr), len(arr))), level)


def _k26_level(scratch, ptrs, ints, flts, level):
    kernels.launch("b_walk", "hm_b_walk", scratch,
                   *(x for arr in (ptrs, ints, flts)
                     for x in (ctypes.addressof(arr), len(arr))), level)


def pframe_walk(org_y, org_u, org_v, refs_y, refs_u, refs_v, mv_x, mv_y,
                mv_ref, ref_pocs, cur_poc: int, mv16=None, mv32=None,
                qp: int = 32, qpc: int = 32, col=None, col_poc: int = 0,
                cbflat=None, mv_lx=None, ref_pocs_l1=None, *, w: int,
                h: int, num_ref: int, max_merge: int, bd: int = 8,
                qp_factor=0.57, levels: int = 1, tmvp: bool = False,
                log2_ctu: int = 6, sdh: bool = False, rdoq: bool = True,
                n_active=None, ts: bool = False, num_ref_l1: int = 0,
                l0map: tuple = None, l1map: tuple = None, run_level=None):
    """wavefront_pass_plain through the walker.  Before the walk, over
    the whole frame: each grid's AMVP hypothesis (the block's searched MV
    predicted, from its list's reference in a B slice, and its residual
    coded), the open-loop intra mode of every 8x8 block (`rmd`) and, with
    TMVP (P slices), the grids' temporal candidates (`tmvp_grids`); then
    `run_level(scratch, ptrs, ints, flts, level)` once per z-scan level
    of the geometry: K23 in a P slice, K26 in a B slice (num_ref_l1 > 0)
    by default; the CPU tests give it the host build of the lane code.
    Arguments and result as wavefront_pass_plain's (levels 1 or 3)."""
    from hmtpu_torch.encoder.iframe_dev import _dev_static as i_static
    from hmtpu_torch.encoder.iframe_dev import _iw_tables, walk_args

    if levels not in (1, 3):
        raise ValueError(f"pframe_walk: levels 1 or 3, got {levels}")
    is_b = num_ref_l1 > 0
    if is_b and (ts or tmvp or n_active is not None):
        raise ValueError("pframe_walk: a B slice has no transform skip, "
                         "no TMVP and no n_active")
    if run_level is None:
        run_level = _k26_level if is_b else _k23_level
    dev = org_y.device
    maps = _list_maps(l0map, l1map, dev) if is_b else None
    sd = _pw_static(w, h, log2_ctu, dev)
    tabs = _iw_tables(dev)
    bw, bh = w // 8, h // 8
    P = bw * bh
    lam_, lam_sqrt_, wchroma_, lam_c_ = frame_lambdas(qp, qpc, qp_factor)
    lam, wchroma, lam_c = (_scalar(v, dev) for v in (lam_, wchroma_, lam_c_))
    i32 = dict(dtype=torch.int32, device=dev)
    ic = lambda a: a.to(torch.int32).contiguous()
    ref_pocs_t = torch.tensor(list(ref_pocs), **i32)
    refs = tuple(ic(r) for r in (refs_y, refs_u, refs_v))

    def hypothesis(mx, my, rr, n, gw, gh, orgs, with_ts=False, lx=None):
        """The AMVP hypothesis of every block of an n-grid (phase 1a of
        the plain pass at n = 8, its hoisted 16 and 32 levels); in a B
        slice each block's reference is rr of its list lx."""
        mx, my, rr = (a.reshape(-1) for a in (mx, my, rr))
        uidx = _union_idx(rr, None if lx is None else lx.reshape(-1), maps)
        m, log2 = gw * gh, n.bit_length() - 1
        pa, pu, pv = mc_yuv(*refs, uidx, gw, mx, my, n, bd)
        # K1's level forms around K10 (a K10 launch a plane, and a TS
        # plane's TS alternative another): with TS, the chroma pair coded
        # both ways and the cheaper kept inside the inverse
        preds = [pa, pu, pv]
        code = lambda c, k: rdoq_code(
            c, (qp, qpc, qpc)[k], log2 - (k > 0), bd, (lam, lam_c, lam_c)[k],
            cbflat, k == 0, sdh=sdh, trellis=rdoq)
        if not with_ts:
            coefs = fwd_level(orgs, preds, bd)
            levs, deqs, bits = zip(*[code(c, k) for k, c in enumerate(coefs)])
            (ry, ru, rv), _, cbf, dist, bsum = inv_level(
                deqs, levs, preds, orgs, bd, wchroma, bits)
            tsf = None
        else:
            coefs, tcoefs = fwd_level(orgs, preds, bd, ts=True)
            levs, deqs, bits = zip(*[code(c, k) for k, c in enumerate(coefs)])
            tl, tq, tb = zip(*[code(c, 1) for c in tcoefs])
            (ry, ru, rv), _, levk, _, tsf, cbf, dist, bsum = inv_level_ts(
                deqs, levs, bits, tq, tl, tb, preds, orgs,
                ts_flag_pair(cbflat, False), lam_c, bd, wchroma)
            levs = (levs[0], *levk)
        return dict(ref=rr, mvx=mx, mvy=my, cbf=cbf, rec_y=ry, rec_u=ru,
                    rec_v=rv, lev=torch.cat([a.reshape(m, -1) for a in levs],
                                            1),
                    ts=tsf, dist=dist, bits=bsum)

    h8 = hypothesis(mv_x, mv_y, mv_ref, 8, bw, bh,
                    (_blockify(org_y, 8), _blockify(org_u, 4),
                     _blockify(org_v, 4)), with_ts=ts, lx=mv_lx)
    imode = rmd(org_y, i_static(w, h, log2_ctu, dev)["g8"], 8, 1, bd=bd,
                lam_sqrt=lam_sqrt_, sis=False)[:, 0]
    gw, gh = bw // 2, bh // 2
    qw, qh = (gw + 1) // 2, (gh + 1) // 2
    # the grids' temporal candidates in one K24 launch
    grids = [(8, mv_ref.reshape(-1), bw, bh)] + (
        [(16, mv16[2].reshape(-1), gw, gh), (32, mv32[2].reshape(-1), qw, qh)]
        if levels == 3 else [])
    tt = tmvp_grids(col, col_poc, grids, ref_pocs_t, cur_poc, w=w, h=h,
                    log2_ctu=log2_ctu) if tmvp else []
    t8, t16, t32 = tt + [None] * (3 - len(tt))
    h16, h32 = {}, {}
    if levels == 3:
        h16 = hypothesis(*mv16[:3], 16, gw, gh,
                         (_blockify(org_y, 16), _blockify(org_u, 8),
                          _blockify(org_v, 8)),
                         lx=mv16[3] if is_b else None)
        h32 = hypothesis(
            *mv32[:3], 32, qw, qh,
            (_blockify(_edge_pad(org_y, qh * 32, qw * 32), 32),
             _blockify(_edge_pad(org_u, qh * 16, qw * 16), 16),
             _blockify(_edge_pad(org_v, qh * 16, qw * 16), 16)),
            lx=mv32[3] if is_b else None)

    st = dict(
        rec_y=torch.zeros(h * w + 1, **i32),
        rec_u=torch.zeros(h * w // 4 + 1, **i32),
        rec_v=torch.zeros(h * w // 4 + 1, **i32),
        blk=torch.zeros((P + 1, 14), **i32),
        levs=torch.zeros((P + 1, 96), **i32),
        tsf=torch.zeros(P + 1, **i32),
    )
    geom = 32 if levels == 3 else 8
    lv = sd["lv32" if geom == 32 else "lv_blk"]
    # K23 and K26 keep their lanes in shared memory: no device scratch
    scratch = torch.zeros((lv.shape[1], 0), **i32)
    opt = lambda a: None if a is None else ic(a)
    cbflat = cbflat.to(torch.float32).contiguous()
    tensors = [
        *(ic(p) for p in (org_y, org_u, org_v)), *refs,
        *(st[k] for k in ("rec_y", "rec_u", "rec_v", "blk", "levs", "tsf")),
        ic(imode), sd["nb_ok"], sd["nb_flat"], *sd["g8"], *sd["g4"],
        opt(t8), opt(t16), opt(t32), lv,
        *(sd.get(k) for k in ("cells16", "nb16_ok", "nb16_cell", "c16_32",
                              "c8_32", "nb32_ok", "nb32_cell", "full32")),
        ref_pocs_t, tabs["mats"], cbflat, tabs["tabs_i"], tabs["tabs_f"],
        scratch,
        *(opt(hs.get(k)) if k not in ("dist", "bits") or not hs
          else hs[k].to(torch.float32).contiguous()
          for hs in (h8, h16, h32) for k in _HOIST_KEYS)]
    cmax0 = 0 if num_ref <= 1 else (
        num_ref - 1 if n_active is None else max(n_active - 1, 0))
    ints = [w, h, bd, log2_ctu, geom, lv.shape[1], int(sdh), int(ts),
            int(rdoq), refs[0].shape[0], num_ref, max_merge,
            num_ref if n_active is None else n_active, cmax0, int(cur_poc),
            0] + [OFF[c] for c in _PW_CTX]
    if is_b:
        # K26's pointers after K23's: the list maps, the list-1 POCs, each
        # grid's lists
        tensors += [*(ic(m) for m in maps),
                    torch.tensor(list(ref_pocs_l1), **i32),
                    *(None if x is None else ic(x.reshape(-1)) for x in (
                        mv_lx, mv16[3] if levels == 3 else None,
                        mv32[3] if levels == 3 else None))]
    args = walk_args(tensors, ints, tabs["tab_ctx"], qp, qpc, bd,
                     (lam_, lam_c_, wchroma_))
    if is_b:
        # and its ints after K23's (which end with the coding tables'):
        # list 1's ref_idx cMax, INTER_DIR's context offset
        b_ints = (*args[1], num_ref_l1, max(num_ref_l1 - 1, 0),
                  OFF["INTER_DIR"])
        args = (args[0], (ctypes.c_int * len(b_ints))(*b_ints), args[2])
    for level in range(lv.shape[0]):
        run_level(scratch, *args, level)
    out = {k: v[:-1] for k, v in st.items()}
    out["imode"] = imode
    return out


def full_pframe_pass(org_y, org_u, org_v, refs_y, refs_u, refs_v, nn,
                     ref_pocs, cur_poc: int, qp: int = 32, qpc: int = 32,
                     col=None, col_poc: int = 0, cbflat=None,
                     n_active=None, *, w: int, h: int, num_ref: int,
                     max_merge: int, bd: int, srange: int, subpel: str,
                     deblock: bool = False, sao: bool = False,
                     ctu: int = 64, cb_off: int = 0, cr_off: int = 0,
                     qp_factor=0.57, tmvp: bool = False, sdh: bool = False,
                     rdoq: bool = True, decision: str = "scan",
                     ts: bool = False, ref_pocs_l1=None,
                     num_ref_l1: int = 0, l0map: tuple = None,
                     l1map: tuple = None):
    """ME + sub-pel + wavefront decision + in-loop filters, with the
    reference's compact output dtypes.  P slices: the L0 stack is padded
    to num_ref; `n_active` is the real count (padded references never
    win the ME selection).  B slices (num_ref_l1 > 0): refs_* hold the
    union of both lists (l0map / l1map index it per list), and integer
    ME searches every reference of both lists, keeping the best (list,
    ref, MV) per block for the AMVP candidate (bi candidates enter
    through the merge list).  Returns (state dict, the int32
    reconstruction planes on the device for the DPB)."""
    from hmtpu_torch.models.nnfme import predict_offsets_levels
    from hmtpu_torch.search.me import (
        frac_refine_levels,
        integer_me,
        integer_me_levels,
        regularize_mv_field,
        satd_gate_levels,
    )

    if decision != "scan":
        raise NotImplementedError(
            f"decision={decision!r}: the Jacobi decision is not ported")
    dev = org_y.device
    bw, bh = w // 8, h // 8
    is_b = num_ref_l1 > 0
    if n_active is None:
        n_active = num_ref
    lam_sqrt_ = frame_lambdas(qp, qpc, qp_factor)[1]
    lam_sqrt = _scalar(lam_sqrt_, dev)
    # SAO's lambda, on the device before the filters run
    lam_sao = _scalar(frame_lambdas(qp, qp, qp_factor)[0], dev) \
        if sao else None

    # (list, ref within the list, union index) of every searched ref
    ref_lists = [(0, r, u) for r, u in enumerate(
        l0map if is_b else range(num_ref))]
    if is_b:
        ref_lists += [(1, r, u) for r, u in enumerate(l1map)]
    lx_tab = torch.tensor([m[0] for m in ref_lists], dtype=torch.int32,
                          device=dev)
    r_tab = torch.tensor([m[1] for m in ref_lists], dtype=torch.int32,
                         device=dev)

    def ref_cost(sad, lx, r):
        """SAD + ref-idx signalling bits; padded L0 refs never win."""
        nr = num_ref if lx == 0 else num_ref_l1
        refbits = 0.0 if nr == 1 else float(1 + min(r, nr - 2))
        cost = sad.to(torch.float32) + lam_sqrt * refbits
        return cost + BIG if lx == 0 and r >= n_active else cost

    def pick_best_ref(entries):
        """argmin over the per-(list, ref) candidates of one level (the
        first wins ties); returns (mvx, mvy, ref within its list, list,
        stencil)."""
        sel = torch.stack([e[2] for e in entries]).argmin(0)
        mvs = torch.stack([torch.stack(e[0]) for e in entries])  # (R,2,..)
        mvsel = torch.gather(mvs, 0, sel[None, None].expand(
            (1, 2) + sel.shape))[0]
        stens = torch.stack([e[1] for e in entries])         # (R,..,3,3)
        sten = torch.gather(stens, 0, sel[None, :, :, None, None].expand(
            (1,) + stens.shape[1:]))[0]
        return mvsel[0], mvsel[1], r_tab[sel], lx_tab[sel], sten

    two_level = w % 16 == 0 and h % 16 == 0
    if two_level:
        qw0, qh0 = (bw // 2 + 1) // 2, (bh // 2 + 1) // 2
        acc = {8: [], 16: [], 32: []}
        for lx, r, u in ref_lists:
            lev = integer_me_levels(refs_y[u], org_y, srange, lam_sqrt_,
                                    qh0, qw0, bd)
            for n, (mv, sten, sad) in lev.items():
                acc[n].append((mv, sten, ref_cost(sad, lx, r)))
        me_out = {n: pick_best_ref(e) for n, e in acc.items()}
        mvx, mvy, rsel, lxsel, stencil = me_out[8]
    else:
        z = torch.zeros((bh, bw), dtype=torch.int32, device=dev)
        entries = []
        for lx, r, u in ref_lists:
            mv, sten, sad = integer_me(refs_y[u], org_y, 8, srange,
                                       lam_sqrt_, z, z, bd)
            entries.append((mv, sten, ref_cost(sad, lx, r)))
        mvx, mvy, rsel, lxsel, stencil = pick_best_ref(entries)

    # coherence pass (P slices): trade per-block SAD optimality for a
    # mergeable motion field
    if not is_b:
        mvx, mvy, rsel = regularize_mv_field(refs_y, org_y, mvx, mvy, rsel,
                                             lam_sqrt, iters=3)

    maps = _list_maps(l0map, l1map, dev) if is_b else None
    union_idx = lambda rr, ll: _union_idx(rr, ll, maps)

    # NN-FME: every level's offsets from its ME stencils in one K6 launch
    nn_offs = None
    if subpel == "nn":
        stens = [stencil] + ([me_out[16][4], me_out[32][4]] if two_level
                             else [])
        nn_offs = [o for _, o in predict_offsets_levels(
            nn, stens, (8, 16, 32)[:len(stens)])]

    # the levels' integer fields (n-grid) and union reference indices
    levels = [(mvx, mvy, union_idx(rsel, lxsel), 8)]
    if two_level:
        levels += [(*me_out[n][:2], union_idx(*me_out[n][2:4]), n)
                   for n in (16, 32)]
    if subpel == "nn":
        # NN-FME: each level's offsets behind the RD gate, which keeps the
        # NN MV only where its SATD beats the integer MV's (HM's
        # refinement keeps the best point including the integer centre,
        # TEncSearch.cpp:1591): K7 a level for both predictions, then the
        # three levels' gate in one K8 launch
        gate = []
        for (mx, my, rr, n), offs in zip(levels, nn_offs):
            gw_ = mx.shape[1]
            qx = torch.stack([mx.reshape(-1) * 4 + offs[:, 0],
                              mx.reshape(-1) * 4])
            qy = torch.stack([my.reshape(-1) * 4 + offs[:, 1],
                              my.reshape(-1) * 4])
            gate.append((mc_luma2(refs_y, rr.reshape(-1), gw_, qx, qy, n,
                                  bd), qx, qy, n, gw_))
        quarter = [(gx.reshape(mx.shape), gy.reshape(mx.shape))
                   for (gx, gy), (mx, _, _, _) in zip(
                       satd_gate_levels(org_y, gate), levels)]
    elif subpel == "dctif":
        # HM's DCT-IF search (K9): every level in one launch, the original
        # read in place (the 32 level's rows and columns clamped to it: the
        # edge replication), against the unpadded references, whose clamped
        # reads are the edge replication too
        quarter = frac_refine_levels(refs_y, org_y, levels, bd)
    else:
        quarter = [(mx * 4, my * 4) for mx, my, _, _ in levels]

    mvq_x, mvq_y = quarter[0]
    mv16 = mv32 = None
    if two_level:
        r16, lx16 = me_out[16][2:4]
        mv16 = quarter[1] + (r16,) + ((lx16,) if is_b else ())
        r32, lx32 = me_out[32][2:4]
        mv32 = quarter[2] + (r32,) + ((lx32,) if is_b else ())

    st = wavefront_pass(
        org_y, org_u, org_v, refs_y, refs_u, refs_v, mvq_x, mvq_y, rsel,
        ref_pocs, cur_poc, mv16=mv16, mv32=mv32, qp=qp, qpc=qpc, col=col,
        col_poc=col_poc, cbflat=cbflat, mv_lx=lxsel if is_b else None,
        ref_pocs_l1=ref_pocs_l1, w=w, h=h, num_ref=num_ref,
        max_merge=max_merge, bd=bd, qp_factor=qp_factor,
        levels=3 if two_level else 1, tmvp=tmvp,
        log2_ctu=ctu.bit_length() - 1, sdh=sdh, rdoq=rdoq,
        n_active=None if is_b else n_active, ts=ts and not is_b,
        num_ref_l1=num_ref_l1, l0map=l0map, l1map=l1map)

    # ---- in-loop filters on the device (8.7.2 deblock, 8.7.3 SAO)
    if deblock or sao:
        if deblock:
            # one K3 launch: the 8x8 state read in place
            rec_y, rec_u, rec_v = deblock_state(
                st["rec_y"], st["rec_u"], st["rec_v"], st["blk"], qp, bd,
                h=h, w=w, ref_pocs=ref_pocs,
                ref_pocs_l1=ref_pocs_l1 if is_b else (), num_ref=num_ref,
                num_ref_l1=num_ref_l1, cb_qp_off=cb_off, cr_qp_off=cr_off)
        else:
            rec_y = st["rec_y"].reshape(h, w)
            rec_u = st["rec_u"].reshape(h // 2, w // 2)
            rec_v = st["rec_v"].reshape(h // 2, w // 2)
        if sao:
            rec_y, rec_u, rec_v, sao_params = sao_frame_dev(
                org_y, rec_y, org_u, rec_u, org_v, rec_v, ctu, lam_sao, bd)
            st["sao"] = sao_params
        st["rec_y"] = rec_y.reshape(-1)
        st["rec_u"] = rec_u.reshape(-1)
        st["rec_v"] = rec_v.reshape(-1)

    rec_t = torch.uint8 if bd == 8 else torch.int16
    small = dict(rec_y=rec_t, rec_u=rec_t, rec_v=rec_t, blk=torch.int16,
                 levs=torch.int16, imode=torch.int8, sao=torch.int8,
                 tsf=torch.int8)
    dev_planes = (st["rec_y"].reshape(h, w),
                  st["rec_u"].reshape(h // 2, w // 2),
                  st["rec_v"].reshape(h // 2, w // 2))
    return {k: v.to(small[k]) for k, v in st.items()}, dev_planes


class PFrameDeviceEncoder(PFrameEncoder):
    """P- and B-slice encoder: the decision pass on the device
    (`launch`), the host side (`finish`) and the slice writer
    (`_entropy_pass`: the native engine for P slices, the Python walk
    for B slices)."""

    def __init__(self, *a, qp_factor: float = 0.57, tmvp: bool = True,
                 ctx_states=None, rdoq: bool = True,
                 decision: str = "scan", pad_refs: int = 0,
                 device=None, **kw):
        super().__init__(*a, **kw)
        self.qp_factor = qp_factor
        self.tmvp = tmvp
        self.rdoq = rdoq
        self.decision = decision
        # pad the L0 stack to this many refs (0 = no padding), as the
        # reference does to keep one compiled variant
        self.pad_refs = pad_refs
        # context states pricing the decision pass (harvested from a
        # previous frame's real entropy coding, or None -> slice init)
        self.ctx_states = ctx_states
        self.final_ctx = None
        self.device = device

    def launch(self, frame: Frame, qp: int, refs: list[Frame],
               ref_pocs: list[int], poc: int, sh: SliceHeader,
               refs_l1=None, ref_pocs_l1=None):
        """Run the frame's device pass; returns the context for finish().
        Reference frames carrying `.dev` (device planes from an earlier
        pass) are used in place: the DPB stays on the device.  For a B
        slice the two lists are deduped by POC into one union stack;
        l0map / l1map index it per list."""
        sps = self.sps
        w, h = sps.pic_width, sps.pic_height
        dev = self.device
        qpc = chroma_qp_from_luma(qp + self.pps.cb_qp_offset)

        def plane(r, i, host):
            d = getattr(r, "dev", None)
            return d[i] if d is not None else torch.as_tensor(
                np.asarray(host, np.int32)).to(dev)

        is_b = sh.slice_type == SliceType.B and bool(ref_pocs_l1)
        l0map = l1map = None
        num_ref_l1 = 0
        if is_b:
            union_pocs, union_refs = [], []
            for p, r in zip(list(ref_pocs) + list(ref_pocs_l1),
                            list(refs) + list(refs_l1)):
                if p not in union_pocs:
                    union_pocs.append(p)
                    union_refs.append(r)
            l0map = tuple(union_pocs.index(p) for p in ref_pocs)
            l1map = tuple(union_pocs.index(p) for p in ref_pocs_l1)
            num_ref_l1 = len(ref_pocs_l1)
        else:
            union_refs = list(refs)
        n_active = len(refs)
        ref_pocs = list(ref_pocs)
        if not is_b and self.pad_refs > n_active:
            union_refs += [union_refs[-1]] * (self.pad_refs - n_active)
            ref_pocs += [ref_pocs[-1]] * (self.pad_refs - n_active)
        refs_y = torch.stack([plane(r, 0, r.y) for r in union_refs])
        refs_u = torch.stack([plane(r, 1, r.u) for r in union_refs])
        refs_v = torch.stack([plane(r, 2, r.v) for r in union_refs])

        deblock_on = not self.pps.deblocking_filter_disabled
        sao_on = bool(sps.sao_enabled)
        # collocated motion for TMVP: the device tensors attached to
        # reference 0 by its own pass (col pic = RefPicList0[0]); an IDR
        # col pic has no motion, so the candidate never exists
        use_tmvp = self.tmvp and sh.temporal_mvp and not is_b
        col_in = getattr(refs[0], "dev_col", None) if use_tmvp else None
        if col_in is not None:
            col, col_poc = col_in
        elif use_tmvp:
            z = torch.zeros((h // 8, w // 8), dtype=torch.int32, device=dev)
            col, col_poc = (z, z, z.to(torch.bool), z), 0
        else:
            col, col_poc = None, 0
        ctx0 = self.ctx_states if self.ctx_states is not None \
            else make_contexts(sh.slice_type, qp)
        cbflat = torch.as_tensor(ctx_bits_table(ctx0).reshape(-1)).to(dev)
        st, dev_planes = full_pframe_pass(
            torch.as_tensor(np.asarray(frame.y, np.int32)).to(dev),
            torch.as_tensor(np.asarray(frame.u, np.int32)).to(dev),
            torch.as_tensor(np.asarray(frame.v, np.int32)).to(dev),
            refs_y, refs_u, refs_v, self.nn_params, ref_pocs, poc, qp, qpc,
            col, col_poc, cbflat, n_active, w=w, h=h,
            num_ref=len(refs) if is_b else len(union_refs),
            max_merge=sh.max_num_merge_cand,
            bd=self.bd, srange=self.search_range, subpel=self.subpel,
            deblock=deblock_on, sao=sao_on, ctu=sps.ctu_size,
            cb_off=self.pps.cb_qp_offset, cr_off=self.pps.cr_qp_offset,
            qp_factor=self.qp_factor, tmvp=use_tmvp,
            sdh=bool(self.pps.sign_data_hiding), rdoq=self.rdoq,
            decision=self.decision,
            ts=bool(self.pps.transform_skip_enabled),
            ref_pocs_l1=list(ref_pocs_l1) if is_b else None,
            num_ref_l1=num_ref_l1, l0map=l0map, l1map=l1map)
        # this frame's L0 motion on the 8x8 grid, kept on the device as
        # the next frame's collocated field
        bw, bh = w // 8, h // 8
        blk = st["blk"].to(torch.int32)
        pocs_t = torch.tensor(ref_pocs, dtype=torch.int32, device=dev)
        col_out = ((blk[:, K_MVX].reshape(bh, bw),
                    blk[:, K_MVY].reshape(bh, bw),
                    ((blk[:, K_DIR] & 1) > 0).reshape(bh, bw),
                    pocs_t[torch.clamp(blk[:, K_REF], 0, len(refs) - 1)
                           .to(torch.int64)].reshape(bh, bw)), poc)
        return dict(st=st, dev=dev_planes, sao_on=sao_on,
                    deblock_on=deblock_on, ref_pocs=list(ref_pocs),
                    poc=poc, num_ref=len(refs),
                    max_merge=sh.max_num_merge_cand, col_out=col_out,
                    col_ref=refs[0], tmvp=use_tmvp,
                    ref_pocs_l1=list(ref_pocs_l1) if is_b else [],
                    num_ref_l1=num_ref_l1)

    def finish(self, ctx):
        """Pull the decision state and build the host-side outputs:
        (recon, motion field, decisions, (modes, skip map, intra map))."""
        sps = self.sps
        w, h = sps.pic_width, sps.pic_height
        bd = self.bd
        bw, bh = w // 8, h // 8
        sao_on = ctx["sao_on"]

        st = {k: v.cpu().numpy().astype(np.int32)
              for k, v in ctx["st"].items()}
        # the copy waits for the device pass to end
        self.t_fetched = time.time()
        self.post_done = ctx["deblock_on"] or sao_on
        self._sao_packed = st["sao"].reshape(-1, 21) if sao_on else None
        rec_y = st["rec_y"].reshape(h, w)
        rec_u = st["rec_u"].reshape(h // 2, w // 2)
        rec_v = st["rec_v"].reshape(h // 2, w // 2)
        blk = st["blk"].reshape(bh, bw, 14)
        kind, mi, mvdx, mvdy, mvpi = (blk[..., k] for k in range(5))
        fdir = blk[..., K_DIR]
        fmvx, fmvy, fref = blk[..., K_MVX], blk[..., K_MVY], blk[..., K_REF]
        fmvx1, fmvy1, fref1 = (blk[..., K_MVX1], blk[..., K_MVY1],
                               blk[..., K_REF1])
        cusz = blk[..., K_SZ]
        is_b = ctx["num_ref_l1"] > 0
        imode = st["imode"].reshape(bh, bw)
        tsf = st["tsf"].reshape(bh, bw)
        DBG_COUNTERS["ldp_ts_tbs"] += int((tsf & 1).sum()
                                          + ((tsf >> 1) & 1).sum())
        levs = st["levs"].reshape(bh, bw, 96)
        levy = levs[..., :64].reshape(bh, bw, 8, 8)
        levcb = levs[..., 64:80].reshape(bh, bw, 4, 4)
        levcr = levs[..., 80:96].reshape(bh, bw, 4, 4)
        # unpack 16x16-CU level tensors (z-order cell packing)
        gw, gh = bw // 2, bh // 2
        lev16y = np.zeros((gh, gw, 16, 16), np.int32)
        lev16cb = np.zeros((gh, gw, 8, 8), np.int32)
        lev16cr = np.zeros((gh, gw, 8, 8), np.int32)
        if gw and gh:
            l2 = levs[:gh * 2, :gw * 2].reshape(gh, 2, gw, 2, 96) \
                .transpose(0, 2, 1, 3, 4)
            flat = np.concatenate(
                [l2[:, :, 0, 0], l2[:, :, 0, 1],
                 l2[:, :, 1, 0], l2[:, :, 1, 1]], axis=-1)  # (gh,gw,384)
            lev16y = flat[..., :256].reshape(gh, gw, 16, 16)
            lev16cb = flat[..., 256:320].reshape(gh, gw, 8, 8)
            lev16cr = flat[..., 320:384].reshape(gh, gw, 8, 8)
        # unpack 32x32-CU level tensors (z-order over the 16 cells)
        qw, qh = bw // 4, bh // 4
        lev32y = np.zeros((qh, qw, 32, 32), np.int32)
        lev32cb = np.zeros((qh, qw, 16, 16), np.int32)
        lev32cr = np.zeros((qh, qw, 16, 16), np.int32)
        if qw and qh:
            l4 = levs[:qh * 4, :qw * 4].reshape(qh, 4, qw, 4, 96) \
                .transpose(0, 2, 1, 3, 4)              # (qh,qw,4r,4c,96)
            zord = ((0, 0), (0, 1), (1, 0), (1, 1),
                    (0, 2), (0, 3), (1, 2), (1, 3),
                    (2, 0), (2, 1), (3, 0), (3, 1),
                    (2, 2), (2, 3), (3, 2), (3, 3))
            flat4 = np.concatenate([l4[:, :, r, c] for r, c in zord],
                                   axis=-1)            # (qh,qw,1536)
            lev32y = flat4[..., :1024].reshape(qh, qw, 32, 32)
            lev32cb = flat4[..., 1024:1280].reshape(qh, qw, 16, 16)
            lev32cr = flat4[..., 1280:1536].reshape(qh, qw, 16, 16)

        # motion field (4x4 granularity) for later frames
        field = PicMotion.create(w, h)
        rep = lambda a: np.repeat(np.repeat(a, 2, 0), 2, 1)
        u0m, u1m = (fdir & 1) > 0, (fdir & 2) > 0
        field.inter_dir[:] = rep(fdir)
        field.mv[0, ..., 0] = rep(np.where(u0m, fmvx, 0))
        field.mv[0, ..., 1] = rep(np.where(u0m, fmvy, 0))
        field.ref_idx[0] = rep(np.where(u0m, fref, -1))
        if is_b:
            field.mv[1, ..., 0] = rep(np.where(u1m, fmvx1, 0))
            field.mv[1, ..., 1] = rep(np.where(u1m, fmvy1, 0))
            field.ref_idx[1] = rep(np.where(u1m, fref1, -1))

        # ---- skip-region collapse: merge uniform all-skip regions into
        # one large skip CU.  A pure entropy-level transform -- same-MV
        # MC is identical at any block size, so the reconstruction and
        # the motion field are untouched; only split/skip syntax and
        # the CU-level merge index change.
        depth8 = np.full((bh, bw), sps.log2_ctu_size - 3, dtype=np.int32)
        depth8[cusz == 1] = sps.log2_ctu_size - 4
        depth8[cusz == 2] = sps.log2_ctu_size - 5
        col_np = getattr(ctx["col_ref"], "col_np", None) \
            if ctx["tmvp"] else None
        mctx = MotionCtx(field, w, h, sps.log2_ctu_size, ctx["ref_pocs"],
                         ctx["ref_pocs_l1"], cur_poc=ctx["poc"], col=col_np)
        max_merge = ctx["max_merge"]
        num_ref = ctx["num_ref"]
        num_ref_l1 = ctx["num_ref_l1"]
        uni = lambda a, cy, cx, nc: (a[cy:cy + nc, cx:cx + nc]
                                     == a[cy, cx]).all()

        def collapse(x0, y0, log2):
            size = 1 << log2
            cy, cx = y0 // 8, x0 // 8
            if log2 == 4 and cusz[cy, cx] >= 1:
                return                      # already a 16x16+ CU
            if log2 == 5 and cusz[cy, cx] == 2:
                return                      # already a 32x32 CU
            if x0 + size <= w and y0 + size <= h and log2 > 3:
                nc = size // 8
                if (kind[cy:cy + nc, cx:cx + nc] == 0).all() and all(
                        uni(a, cy, cx, nc) for a in (fmvx, fmvy, fref, fdir,
                                                     fmvx1, fmvy1, fref1)):
                    wdir = int(fdir[cy, cx])
                    want = ((int(fmvx[cy, cx]), int(fmvy[cy, cx])),
                            (int(fmvx1[cy, cx]), int(fmvy1[cy, cx])))
                    wref = (int(fref[cy, cx]), int(fref1[cy, cx]))
                    cands = merge_candidates(mctx, x0, y0, size, size,
                                             max_merge, num_ref, is_b,
                                             num_ref_l1)
                    for ci, c in enumerate(cands):
                        if c.inter_dir != wdir or any(
                                (wdir >> lx) & 1 and (
                                    c.mv[lx] != want[lx]
                                    or c.ref_idx[lx] != wref[lx])
                                for lx in (0, 1)):
                            continue
                        depth8[cy:cy + nc, cx:cx + nc] = \
                            sps.log2_ctu_size - log2
                        mi[cy, cx] = ci
                        return
            if log2 > 3:
                half = size >> 1
                for dy, dx in ((0, 0), (0, half), (half, 0), (half, half)):
                    if x0 + dx < w and y0 + dy < h:
                        collapse(x0 + dx, y0 + dy, log2 - 1)

        ctu_sz = sps.ctu_size
        for cty in range(0, h, ctu_sz):
            for ctxx in range(0, w, ctu_sz):
                collapse(ctxx, cty, sps.log2_ctu_size)

        def quadrant_clean(cy, cx):
            """A 32x32 quadrant (corner cell cy,cx) is representable as
            one 32x32 TB of a 64 CU: either it IS a committed 32x32 CU
            or it carries no coefficients at all."""
            if cusz[cy, cx] == 2:
                return True
            for dy in range(4):
                for dx in range(4):
                    yy, xx = cy + dy, cx + dx
                    if cusz[yy, xx] == 0:
                        if levy[yy, xx].any() or levcb[yy, xx].any() \
                                or levcr[yy, xx].any():
                            return False
                    elif dy % 2 == 0 and dx % 2 == 0:   # 16-CU corner
                        gy, gx = yy // 2, xx // 2
                        if lev16y[gy, gx].any() or lev16cb[gy, gx].any() \
                                or lev16cr[gy, gx].any():
                            return False
            return True

        def collapse64_residual(x0, y0):
            """Re-signal a uniform-motion inter CTU as ONE 64x64 CU with
            four 32x32 TBs (transform_tree split inferred, 7.3.8.8): the
            quadrant coefficients and the motion field are unchanged, so
            the reconstruction (and deblocking) are untouched.  P slices
            only."""
            if is_b or x0 + 64 > w or y0 + 64 > h:
                return
            cy, cx = y0 // 8, x0 // 8
            ks = kind[cy:cy + 8, cx:cx + 8]
            if (ks == 0).all() or (ks >= 3).any():
                return                    # all-skip handled above
            if not all(uni(a, cy, cx, 8) for a in (fdir, fmvx, fmvy, fref)) \
                    or fdir[cy, cx] != 1:
                return
            for qy in (0, 4):
                for qx in (0, 4):
                    if not quadrant_clean(cy + qy, cx + qx):
                        return
            mvq = (int(fmvx[cy, cx]), int(fmvy[cy, cx]))
            refq = int(fref[cy, cx])
            cands = merge_candidates(mctx, x0, y0, 64, 64, max_merge,
                                     num_ref, False, 0)
            sig = None
            for ci, c in enumerate(cands):
                if c.inter_dir == 1 and c.mv[0] == mvq \
                        and c.ref_idx[0] == refq:
                    sig = ("merge", ci)
                    break
            if sig is None:
                # AMVP fallback pays mvd bits; only profitable when the
                # children were paying them too
                if not (ks == 2).any():
                    return
                amvp = amvp_candidates(mctx, x0, y0, 64, 64, 0, refq)
                bl = lambda v: abs(v).bit_length()
                costs = [2 * bl(mvq[0] - p[0]) + 2 * bl(mvq[1] - p[1])
                         for p in amvp]
                pi = 0 if costs[0] <= costs[1] else 1
                sig = ("amvp", pi, mvq[0] - amvp[pi][0],
                       mvq[1] - amvp[pi][1])
            # quadrants that are not committed 32x32 CUs carry no
            # coefficients, but their lev32 unpack is another CU size's
            # data: zero it so the writer reads true all-zero TBs
            for qy in (0, 4):
                for qx in (0, 4):
                    if cusz[cy + qy, cx + qx] != 2:
                        q = ((cy + qy) // 4, (cx + qx) // 4)
                        lev32y[q][:] = 0
                        lev32cb[q][:] = 0
                        lev32cr[q][:] = 0
            depth8[cy:cy + 8, cx:cx + 8] = sps.log2_ctu_size - 6
            cusz[cy:cy + 8, cx:cx + 8] = 3
            if sig[0] == "merge":
                kind[cy:cy + 8, cx:cx + 8] = 1
                mi[cy, cx] = sig[1]
                DBG_COUNTERS["cu64_merge"] += 1
            else:
                kind[cy:cy + 8, cx:cx + 8] = 2
                mvpi[cy, cx] = sig[1]
                mvdx[cy, cx] = sig[2]
                mvdy[cy, cx] = sig[3]
                DBG_COUNTERS["cu64_amvp"] += 1

        if sps.ctu_size == 64:
            for cty in range(0, h, 64):
                for ctxx in range(0, w, 64):
                    collapse64_residual(ctxx, cty)
        self._depth8 = depth8

        decisions = _decisions(kind, mi, mvdx, mvdy, mvpi, fmvx, fmvy, fref,
                               cusz, imode, tsf, levy, levcb, levcr, lev16y,
                               lev16cb, lev16cr, lev32y, lev32cb, lev32cr,
                               (fdir, fmvx1, fmvy1, fref1) if is_b else None)
        DBG_COUNTERS["ra_bi_cus"] += sum(
            d.kind != "intra" and d.inter_dir == 3
            for d in decisions.values())
        modes = np.where(kind == 3, imode, -1).astype(np.int32)
        skip_map = (kind == 0).astype(np.int32)
        intra_map = (kind == 3).astype(np.int32)
        recon = Frame(rec_y, rec_u, rec_v, bd)
        recon.dev = ctx["dev"]        # device-resident DPB planes
        # host copy of this frame's motion for the NEXT frame's host
        # passes (collapse + decoder-parity candidate derivation)
        recon.col_np = dict(
            mvx=fmvx, mvy=fmvy, ok=(fdir & 1) > 0,
            refpoc=np.asarray(ctx["ref_pocs"], np.int32)[
                np.clip(fref, 0, ctx["num_ref"] - 1)],
            poc=ctx["poc"])
        # the native slice writer speaks P syntax; B slices take the
        # Python walk in _entropy_pass
        self._nat = None if is_b else dict(
            kind=kind, mi=mi, mvdx=mvdx, mvdy=mvdy, mvpi=mvpi, refi=fref,
            imode=imode, levy=levy, levcb=levcb, levcr=levcr,
            lev16y=lev16y, lev16cb=lev16cb, lev16cr=lev16cr,
            lev32y=lev32y, lev32cb=lev32cb, lev32cr=lev32cr, tsf=tsf)
        return recon, field, decisions, (modes, skip_map, intra_map)

    def _entropy_pass(self, qp, modes, skip_map, intra_map, decisions,
                      sh: SliceHeader, sao=None) -> bytes:
        """P slices: whole-slice serialisation in one native call from
        the decision tensors (the native engine is required); sao =
        ("packed", (n_ctu, 21) params) or None.  B slices: the Python
        slice walk over the decisions; sao = (grid, luma, chroma) or
        None."""
        from hmtpu_torch.entropy.recorder import encode_pslice_native

        if self._nat is None:
            return super()._entropy_pass(qp, modes, skip_map, intra_map,
                                         decisions, sh, sao=sao,
                                         depth8=self._depth8)
        sps = self.sps
        nat = self._nat
        sao_packed, sl, sc = None, 0, 0
        if sao is not None:
            sao_packed, sl, sc = sao[1], 1, 1
        geom = dict(w=sps.pic_width, h=sps.pic_height, ctu=sps.ctu_size,
                    max_merge=sh.max_num_merge_cand,
                    num_ref=sh.num_ref_idx_l0,
                    sdh=int(self.pps.sign_data_hiding),
                    sao_luma=int(sl), sao_chroma=int(sc), bd=self.bd,
                    wpp=int(self.pps.entropy_coding_sync_enabled),
                    ts=int(self.pps.transform_skip_enabled))
        ctx = make_contexts(sh.slice_type, qp)
        res = encode_pslice_native(
            ctx, geom, nat["kind"], nat["mi"], nat["mvdx"], nat["mvdy"],
            nat["mvpi"], nat["refi"], nat["imode"], nat["levy"],
            nat["levcb"], nat["levcr"], nat["lev16y"], nat["lev16cb"],
            nat["lev16cr"], nat["lev32y"], nat["lev32cb"], nat["lev32cr"],
            self._depth8, sao_packed, tsf=nat["tsf"])
        if res is None:
            raise RuntimeError("hmtpu_torch: the native CABAC engine "
                               "(native/entropy.cpp) could not be built; "
                               "P slices need it")
        # the native engine adapts ctx in place: harvest the post-frame
        # states to price the NEXT same-position frame's RDO
        self.final_ctx = ctx
        return res[0]


def _decisions(kind, mi, mvdx, mvdy, mvpi, fmvx, fmvy, fref, cusz, imode,
               tsf, levy, levcb, levcr, lev16y, lev16cb, lev16cr, lev32y,
               lev32cb, lev32cr, bfields=None) -> dict:
    """The per-CU decision records (PuDec) keyed by CU origin.  B
    slices: bfields = (dir, mvx1, mvy1, ref1) adds inter_pred_idc and
    the list-1 motion (and, for AMVP on list 1, its mvd and mvp index:
    the CU's one mvd belongs to the list it uses)."""

    def b_kw(byi, bxi, k):
        if bfields is None:
            return {}
        fdir, fmvx1, fmvy1, fref1 = bfields
        d = int(fdir[byi, bxi])
        kw = dict(inter_dir=d)
        if d & 2:
            kw["mv_l1"] = (int(fmvx1[byi, bxi]), int(fmvy1[byi, bxi]))
            kw["ref_idx_l1"] = int(fref1[byi, bxi])
            if k == 2:
                kw["mvd_l1"] = (int(mvdx[byi, bxi]), int(mvdy[byi, bxi]))
                kw["mvp_idx_l1"] = int(mvpi[byi, bxi])
        return kw

    bh, bw = kind.shape
    ts_cb, ts_cr = (tsf & 1), ((tsf >> 1) & 1)
    decisions: dict[tuple, PuDec] = {}
    for byi in range(bh):
        for bxi in range(bw):
            k = int(kind[byi, bxi])
            sz = int(cusz[byi, bxi])
            key = (bxi * 8, byi * 8)
            step = (1, 2, 4, 8)[sz]
            if byi % step or bxi % step:
                continue                    # covered by a larger CU
            mv = (int(fmvx[byi, bxi]), int(fmvy[byi, bxi]))
            common = dict(log2=3 + sz, mv=mv, ref_idx=int(fref[byi, bxi]))
            amvp = dict(mvd=(int(mvdx[byi, bxi]), int(mvdy[byi, bxi])),
                        mvp_idx=int(mvpi[byi, bxi]))
            if sz == 3:
                qyi, qxi = byi // 4, bxi // 4
                ly64 = np.zeros((64, 64), np.int32)
                lcb64 = np.zeros((32, 32), np.int32)
                lcr64 = np.zeros((32, 32), np.int32)
                for oy in (0, 1):
                    for ox in (0, 1):
                        q = (qyi + oy, qxi + ox)
                        ly64[oy * 32:oy * 32 + 32,
                             ox * 32:ox * 32 + 32] = lev32y[q]
                        lcb64[oy * 16:oy * 16 + 16,
                              ox * 16:ox * 16 + 16] = lev32cb[q]
                        lcr64[oy * 16:oy * 16 + 16,
                              ox * 16:ox * 16 + 16] = lev32cr[q]
                levs = dict(lev_y=ly64, lev_cb=lcb64, lev_cr=lcr64)
            elif sz == 2:
                q = (byi // 4, bxi // 4)
                levs = dict(lev_y=lev32y[q], lev_cb=lev32cb[q],
                            lev_cr=lev32cr[q])
            elif sz == 1:
                q = (byi // 2, bxi // 2)
                levs = dict(lev_y=lev16y[q], lev_cb=lev16cb[q],
                            lev_cr=lev16cr[q])
            else:
                levs = dict(lev_y=levy[byi, bxi], lev_cb=levcb[byi, bxi],
                            lev_cr=levcr[byi, bxi],
                            ts_cb=int(ts_cb[byi, bxi]),
                            ts_cr=int(ts_cr[byi, bxi]))
            mrg = int(mi[byi, bxi])
            if sz < 3:
                common.update(b_kw(byi, bxi, k))
            if k == 0:
                decisions[key] = PuDec("skip", merge_idx=mrg, **common)
            elif k == 1:
                decisions[key] = PuDec("merge", merge_idx=mrg, **common,
                                       **levs)
            elif k == 2:
                decisions[key] = PuDec("amvp", **amvp, **common, **levs)
            else:
                levs.pop("ts_cb", None)
                decisions[key] = PuDec(
                    "intra", intra_mode=int(imode[byi, bxi]),
                    lev_y=levs["lev_y"], lev_cb=levs["lev_cb"],
                    lev_cr=levs["lev_cr"], ts_cb=int(ts_cb[byi, bxi]),
                    ts_cr=int(ts_cr[byi, bxi]))
    return decisions
