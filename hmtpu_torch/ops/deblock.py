"""In-loop deblocking filter (H.265 8.7.2): the port of
hmtpu/ops/deblock.py `deblock_frame_dev` :471 with `_bs_dev` :452,
`_luma_edges_dev` :294 and `_chroma_edges_dev` :374, and of the P / B /
I passes' inputs to it (hmtpu/encoder/pframe_dev.py:1797-1832).

Two forms, each a wrapper and a plain version:

- `deblock_frame_dev` keeps hmtpu's signature (the 4x4 maps);
- `deblock_state` takes a pass's 8x8 cell state as it is (P / B: `blk`
  and the lists' POCs; I: the CU sizes) and derives the maps and the
  CU-interior masks itself; its plain version is the passes' glue that
  built the maps (`state_inputs`) followed by `deblock_frame_plain`.

On CUDA tensors each launches kernel K3 (csrc/deblock.cu over
deblock.cuh) once: a block a tile, vertical edges then horizontal ones
behind the block's barrier, new output planes.  On CPU tensors it runs
the plain PyTorch version: dense boundary strengths, then
reshape-and-mask filtering of every edge patch, as in hmtpu.

The picture is filtered on the 8x8 luma grid; chroma (4:2:0) on the
8x8 chroma-sample grid, BS==2 (intra) edges only.
"""
from __future__ import annotations

import numpy as np
import torch

from hmtpu_torch import kernels
from hmtpu_torch.common.constants import (
    K_CBFY,
    K_DIR,
    K_MVX,
    K_MVX1,
    K_MVY,
    K_MVY1,
    K_REF,
    K_REF1,
    K_SZ,
)
from hmtpu_torch.common.spec_tables import CHROMA_QP_TABLE

MAX_REFS = 16     # POCs a list the state form passes by value

# Table 8-12: beta' (Q 0..51) and tC' (Q 0..53)
BETA_TABLE = np.array(
    [0] * 16 + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22,
                24, 26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50,
                52, 54, 56, 58, 60, 62, 64], dtype=np.int32)
TC_TABLE = np.array(
    [0] * 18 + [1] * 9 + [2] * 4 + [3] * 4 + [4] * 3 + [5] * 2 + [6] * 2
    + [7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24], dtype=np.int32)
assert BETA_TABLE.size == 52 and TC_TABLE.size == 54


def _clip(v, lo, hi):
    return max(lo, min(hi, v))


def _chroma_tc(qp: int, off: int, bd: int, tc_off: int) -> int:
    qp_c = int(CHROMA_QP_TABLE[_clip(qp + off, 0, 63)])
    return int(TC_TABLE[_clip(qp_c + 2 + (tc_off << 1), 0, 53)]) << (bd - 8)


# ---------------------------------------------------------------------------
# plain PyTorch version

def _luma_edges_plain(pl, bs, qp: int, bd: int, beta_off: int,
                      tc_off: int):
    """Filter all internal vertical luma edges of `pl` (H, W) given BS
    (H/4, W/8); call on the transposed plane for horizontal edges."""
    h, w = pl.shape
    ne = w // 8 - 1
    ns = h // 4
    if ne <= 0:
        return pl
    bsv = bs[:, :ne]
    tc_tab = torch.as_tensor(TC_TABLE, device=pl.device)
    tc_q = torch.clamp(qp + 2 * (bsv - 1) + (tc_off << 1), 0, 53)
    beta = int(BETA_TABLE[_clip(qp + (beta_off << 1), 0, 51)]) << (bd - 8)
    tc = (tc_tab[tc_q] << (bd - 8)).to(torch.int32)[:, :, None]
    maxv = (1 << bd) - 1

    # (ns, 4, ne, 8) -> (ns, ne, 4, 8) patches around each edge
    seg = pl[:, 4:4 + ne * 8].reshape(ns, 4, ne, 8).permute(0, 2, 1, 3) \
        .to(torch.int32)
    p3, p2, p1, p0 = (seg[..., i] for i in range(4))
    q0, q1, q2, q3 = (seg[..., i] for i in range(4, 8))

    dp = (p2 - 2 * p1 + p0).abs()                # (ns, ne, 4)
    dq = (q2 - 2 * q1 + q0).abs()
    dp03 = dp[..., 0] + dp[..., 3]
    dq03 = dq[..., 0] + dq[..., 3]
    d = dp03 + dq03
    on = (d < beta) & (bsv > 0)

    def dsam(i):
        return ((2 * (dp[..., i] + dq[..., i]) < (beta >> 2))
                & ((p3[..., i] - p0[..., i]).abs()
                   + (q0[..., i] - q3[..., i]).abs() < (beta >> 3))
                & ((p0[..., i] - q0[..., i]).abs()
                   < ((5 * tc[..., 0] + 1) >> 1)))

    strong = (on & dsam(0) & dsam(3))[..., None]  # (ns, ne, 1)
    weak = on[..., None] & ~strong

    t2 = 2 * tc
    sp0 = torch.clamp((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                      p0 - t2, p0 + t2)
    sp1 = torch.clamp((p2 + p1 + p0 + q0 + 2) >> 2, p1 - t2, p1 + t2)
    sp2 = torch.clamp((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                      p2 - t2, p2 + t2)
    sq0 = torch.clamp((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                      q0 - t2, q0 + t2)
    sq1 = torch.clamp((q2 + q1 + q0 + p0 + 2) >> 2, q1 - t2, q1 + t2)
    sq2 = torch.clamp((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3,
                      q2 - t2, q2 + t2)

    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    do_line = weak & (delta.abs() < 10 * tc)
    dcl = torch.clamp(delta, -tc, tc)
    wp0 = torch.clamp(p0 + dcl, 0, maxv)
    wq0 = torch.clamp(q0 - dcl, 0, maxv)
    side = (beta + (beta >> 1)) >> 3
    tch = tc >> 1
    filt_p = (dp03 < side)[..., None] & do_line
    filt_q = (dq03 < side)[..., None] & do_line
    dp1 = torch.clamp((((p2 + p0 + 1) >> 1) - p1 + dcl) >> 1, -tch, tch)
    dq1 = torch.clamp((((q2 + q0 + 1) >> 1) - q1 - dcl) >> 1, -tch, tch)

    o_p2 = torch.where(strong, sp2, p2)
    o_p1 = torch.where(strong, sp1, torch.where(
        filt_p, torch.clamp(p1 + dp1, 0, maxv), p1))
    o_p0 = torch.where(strong, sp0, torch.where(do_line, wp0, p0))
    o_q0 = torch.where(strong, sq0, torch.where(do_line, wq0, q0))
    o_q1 = torch.where(strong, sq1, torch.where(
        filt_q, torch.clamp(q1 + dq1, 0, maxv), q1))
    o_q2 = torch.where(strong, sq2, q2)

    out = torch.stack([p3, o_p2, o_p1, o_p0, o_q0, o_q1, o_q2, q3], -1)
    mid = out.permute(0, 2, 1, 3).reshape(ns * 4, ne * 8).to(pl.dtype)
    return torch.cat([pl[:, :4], mid, pl[:, 4 + ne * 8:]], 1)


def _chroma_edges_plain(pl, bs2, tc: int, bd: int):
    """Chroma vertical edges: bs2 bool (H/4, W/8) on the chroma 8-grid;
    returns the filtered plane.  Transpose for horizontal."""
    h, w = pl.shape
    # interior 8-grid edges: the edge at x needs q1 at x+1 <= w-1
    ne = max((w - 2) // 8, 0)
    ns = h // 4
    if ne == 0:
        return pl
    on = bs2[:, :ne, None]
    maxv = (1 << bd) - 1
    pad = max(6 + ne * 8 - w, 0)
    plp = torch.cat([pl, pl[:, -1:].expand(h, pad)], 1) if pad else pl
    seg = plp[:, 6:6 + ne * 8].reshape(ns, 4, ne, 8).permute(0, 2, 1, 3) \
        .to(torch.int32)
    p1, p0, q0, q1 = (seg[..., i] for i in range(4))
    delta = torch.clamp((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
    o_p0 = torch.where(on, torch.clamp(p0 + delta, 0, maxv), p0)
    o_q0 = torch.where(on, torch.clamp(q0 - delta, 0, maxv), q0)
    out = seg.clone()
    out[..., 1] = o_p0
    out[..., 2] = o_q0
    mid = out.permute(0, 2, 1, 3).reshape(ns * 4, ne * 8).to(pl.dtype)
    return torch.cat([plp[:, :6], mid, plp[:, 6 + ne * 8:]], 1)[:, :w]


def _motion_bs_plain(pmx, pmy, pr, qmx, qmy, qr):
    """8.7.2.4 motion-difference test; inputs (2, ...) over the lists,
    -1 ref = unused."""
    big = 1 << 20
    pu0, pu1 = pr[0] >= 0, pr[1] >= 0
    qu0, qu1 = qr[0] >= 0, qr[1] >= 0
    cnt_p = pu0.to(torch.int32) + pu1.to(torch.int32)
    cnt_q = qu0.to(torch.int32) + qu1.to(torch.int32)
    p_lo = torch.minimum(torch.where(pu0, pr[0], big),
                         torch.where(pu1, pr[1], big))
    p_hi = torch.maximum(torch.where(pu0, pr[0], -big),
                         torch.where(pu1, pr[1], -big))
    q_lo = torch.minimum(torch.where(qu0, qr[0], big),
                         torch.where(qu1, qr[1], big))
    q_hi = torch.maximum(torch.where(qu0, qr[0], -big),
                         torch.where(qu1, qr[1], -big))
    diff_set = (cnt_p != cnt_q) | (p_lo != q_lo) | (p_hi != q_hi)

    def far(ax, ay, bx, by):
        return ((ax - bx).abs() >= 4) | ((ay - by).abs() >= 4)

    pux = torch.where(pu0, pmx[0], pmx[1])
    puy = torch.where(pu0, pmy[0], pmy[1])
    qux = torch.where(qu0, qmx[0], qmx[1])
    quy = torch.where(qu0, qmy[0], qmy[1])
    far_single = far(pux, puy, qux, quy)
    p_is_lo = pu0 & (pr[0] == p_lo)
    q_is_lo = qu0 & (qr[0] == q_lo)
    plx = torch.where(p_is_lo, pmx[0], pmx[1])
    ply = torch.where(p_is_lo, pmy[0], pmy[1])
    phx = torch.where(p_is_lo, pmx[1], pmx[0])
    phy = torch.where(p_is_lo, pmy[1], pmy[0])
    qlx = torch.where(q_is_lo, qmx[0], qmx[1])
    qly = torch.where(q_is_lo, qmy[0], qmy[1])
    qhx = torch.where(q_is_lo, qmx[1], qmx[0])
    qhy = torch.where(q_is_lo, qmy[1], qmy[0])
    far_matched = far(plx, ply, qlx, qly) | far(phx, phy, qhx, qhy)
    far_same = (far(pmx[0], pmy[0], qmx[0], qmy[0])
                | far(pmx[1], pmy[1], qmx[1], qmy[1])) \
        & (far(pmx[0], pmy[0], qmx[1], qmy[1])
           | far(pmx[1], pmy[1], qmx[0], qmy[0]))
    both_two = (cnt_p == 2) & (cnt_q == 2)
    mv_far = torch.where(both_two,
                         torch.where(p_lo == p_hi, far_same, far_matched),
                         far_single)
    return diff_set | mv_far


def _bs_plain(intra4, cbf4, mv_x, mv_y, ref_poc, vertical: bool):
    if vertical:
        sel_p, sel_q = np.s_[..., :, 1::2], np.s_[..., :, 2::2]
    else:
        sel_p, sel_q = np.s_[..., 1::2, :], np.s_[..., 2::2, :]
    qi = intra4[sel_q]
    sh = qi.shape
    crop = (np.s_[: sh[0], : sh[1]], np.s_[:, : sh[0], : sh[1]])
    pi = intra4[sel_p][crop[0]]
    pc = cbf4[sel_p][crop[0]]
    qc = cbf4[sel_q]
    pmx, qmx = mv_x[sel_p][crop[1]], mv_x[sel_q]
    pmy, qmy = mv_y[sel_p][crop[1]], mv_y[sel_q]
    pr, qr = ref_poc[sel_p][crop[1]], ref_poc[sel_q]
    any_intra = pi | qi
    cond1 = pc | qc | _motion_bs_plain(pmx, pmy, pr, qmx, qmy, qr)
    return torch.where(any_intra, 2, torch.where(cond1, 1, 0))


def deblock_frame_plain(rec_y, rec_u, rec_v, intra4, cbf4, mv_x, mv_y,
                        ref_poc, qp: int, bd: int = 8, beta_off: int = 0,
                        tc_off: int = 0, cb_qp_off: int = 0,
                        cr_qp_off: int = 0, int_v=None, int_h=None):
    intra4, cbf4 = intra4.to(torch.bool), cbf4.to(torch.bool)
    bs_v = _bs_plain(intra4, cbf4, mv_x, mv_y, ref_poc, True)
    bs_h = _bs_plain(intra4, cbf4, mv_x, mv_y, ref_poc, False)
    if int_v is not None:
        m = (~int_v.to(torch.bool)).repeat_interleave(2, 0)
        bs_v = bs_v * m[: bs_v.shape[0], : bs_v.shape[1]]
    if int_h is not None:
        m = (~int_h.to(torch.bool)).repeat_interleave(2, 1)
        bs_h = bs_h * m[: bs_h.shape[0], : bs_h.shape[1]]
    rec_y = _luma_edges_plain(rec_y, bs_v, qp, bd, beta_off, tc_off)
    rec_y = _luma_edges_plain(rec_y.T, bs_h.T, qp, bd, beta_off,
                              tc_off).T
    out = []
    for off, pl in ((cb_qp_off, rec_u), (cr_qp_off, rec_v)):
        tc = _chroma_tc(qp, off, bd, tc_off)
        v2 = bs_v[0::2, 1::2] == 2
        h2 = bs_h[1::2, 0::2] == 2
        pl = _chroma_edges_plain(pl, v2, tc, bd)
        pl = _chroma_edges_plain(pl.T, h2.T, tc, bd).T
        out.append(pl)
    return rec_y.contiguous(), out[0].contiguous(), out[1].contiguous()


# ---------------------------------------------------------------------------
# the state form's inputs: the passes' glue

def interior_masks(cusz8):
    """(int_v, int_h) of a (bh, bw) grid of CU sizes (0 8x8, 1 16x16, 2
    32x32): 8-pel edges interior to a 16x16 / 32x32 CU are no boundaries
    (CUs are size-aligned, so the left / upper cell's size and the edge's
    parity tell them)."""
    bh, bw = cusz8.shape
    dev = cusz8.device
    ev = torch.arange(bw - 1, device=dev)
    int_v = ((cusz8[:, :-1] == 1) & ((ev % 2) == 0)[None, :]) \
        | ((cusz8[:, :-1] == 2) & ((ev % 4) != 3)[None, :])
    eh = torch.arange(bh - 1, device=dev)
    int_h = ((cusz8[:-1, :] == 1) & ((eh % 2) == 0)[:, None]) \
        | ((cusz8[:-1, :] == 2) & ((eh % 4) != 3)[:, None])
    return int_v, int_h


def state_inputs(h: int, w: int, blk=None, ref_pocs=(), ref_pocs_l1=(),
                 num_ref=None, num_ref_l1=None, cusz=None, cbfy=None):
    """`deblock_frame_dev`'s inputs from a pass's 8x8 cell state, as the
    passes build them: (intra4, cbf4, mv_x4, mv_y4, refpoc4, int_v,
    int_h).  P / B: `blk` (bh * bw, 14), the lists' POCs (a list's MV
    counts where K_DIR has its bit; its POC is looked up at clamp(ref, 0,
    n - 1), -1 where the list is unused; no list 1 in a P slice: num_ref_l1
    0).  I (blk None): every cell intra, `cbfy` and `cusz` (bh * bw,)."""
    bw, bh = w // 8, h // 8
    rep4 = lambda a: a.reshape(bh, bw).repeat_interleave(2, 0) \
        .repeat_interleave(2, 1)
    if blk is None:
        dev = cusz.device
        intra4 = torch.ones((h // 4, w // 4), dtype=torch.bool, device=dev)
        cbf4 = rep4(cbfy > 0)
        mv4 = torch.zeros((2, h // 4, w // 4), dtype=torch.int32,
                          device=dev)
        refpoc4 = torch.full((2, h // 4, w // 4), -1, dtype=torch.int32,
                             device=dev)
        return (intra4, cbf4, mv4, mv4, refpoc4) \
            + interior_masks(cusz.reshape(bh, bw))
    dev = blk.device
    num_ref = len(ref_pocs) if num_ref is None else num_ref
    num_ref_l1 = len(ref_pocs_l1) if num_ref_l1 is None else num_ref_l1
    dirf = blk[:, K_DIR]
    u0f, u1f = (dirf & 1) > 0, (dirf & 2) > 0
    # 8.7.2.4: the cbf condition counts luma coefficients only
    pocs = lambda pl, col_, nr: torch.tensor(
        list(pl), dtype=torch.int32, device=dev)[torch.clamp(
            blk[:, col_], 0, nr - 1).to(torch.int64)]
    rp0 = torch.where(u0f, pocs(ref_pocs, K_REF, num_ref), -1)
    rp1 = torch.where(u1f, pocs(ref_pocs_l1, K_REF1, num_ref_l1), -1) \
        if num_ref_l1 > 0 else torch.full_like(dirf, -1)
    mv_x4 = torch.stack([rep4(torch.where(u0f, blk[:, K_MVX], 0)),
                         rep4(torch.where(u1f, blk[:, K_MVX1], 0))])
    mv_y4 = torch.stack([rep4(torch.where(u0f, blk[:, K_MVY], 0)),
                         rep4(torch.where(u1f, blk[:, K_MVY1], 0))])
    refpoc4 = torch.stack([rep4(rp0), rep4(rp1)])
    return (rep4(dirf == 0), rep4(blk[:, K_CBFY] > 0), mv_x4, mv_y4,
            refpoc4) + interior_masks(blk[:, K_SZ].reshape(bh, bw))


def deblock_state_plain(rec_y, rec_u, rec_v, blk, qp: int, bd: int = 8, *,
                        h: int, w: int, ref_pocs=(), ref_pocs_l1=(),
                        num_ref=None, num_ref_l1=None, cusz=None,
                        cbfy=None, beta_off: int = 0, tc_off: int = 0,
                        cb_qp_off: int = 0, cr_qp_off: int = 0):
    """Plain version of K3's state form: `state_inputs`, then
    `deblock_frame_plain`.  Planes flat or (H, W) / (H/2, W/2); returns
    the filtered (y, u, v) planes, (H, W) and (H/2, W/2)."""
    intra4, cbf4, mx, my, rp, int_v, int_h = state_inputs(
        h, w, blk, ref_pocs, ref_pocs_l1, num_ref, num_ref_l1, cusz, cbfy)
    return deblock_frame_plain(
        rec_y.reshape(h, w), rec_u.reshape(h // 2, w // 2),
        rec_v.reshape(h // 2, w // 2), intra4, cbf4, mx, my, rp, qp, bd,
        beta_off, tc_off, cb_qp_off, cr_qp_off, int_v, int_h)


# ---------------------------------------------------------------------------
# wrappers: kernel K3 on the card, the plain versions on the CPU

def _check(h: int, w: int, bd: int):
    if h < 8 or w < 8 or h % 8 or w % 8 or not 8 <= bd <= 12:
        raise ValueError(f"deblock: picture sides multiples of 8 and a bit "
                         f"depth of 8-12, got {h}x{w}, {bd} bits")


def _outputs(h: int, w: int, dev):
    return (torch.empty((h, w), dtype=torch.int32, device=dev),
            torch.empty((h // 2, w // 2), dtype=torch.int32, device=dev),
            torch.empty((h // 2, w // 2), dtype=torch.int32, device=dev))


def deblock_frame_dev(rec_y, rec_u, rec_v, intra4, cbf4, mv_x, mv_y,
                      ref_poc, qp: int, bd: int = 8, beta_off: int = 0,
                      tc_off: int = 0, cb_qp_off: int = 0,
                      cr_qp_off: int = 0, int_v=None, int_h=None):
    """Deblock one picture.  Planes (H, W) / (H/2, W/2) int32; intra4 /
    cbf4 (H/4, W/4); mv_x / mv_y / ref_poc (2, H/4, W/4) int32 (-1 ref =
    list unused).  int_v/int_h (optional bool masks over the 8-cell
    grid) mark 8-pel edges interior to a larger CU/TU: int_v[cy, j] =
    the edge between cell columns j and j+1 is interior.  Returns the
    filtered (y, u, v), new planes."""
    qp = int(qp)
    if not rec_y.is_cuda:
        return deblock_frame_plain(rec_y, rec_u, rec_v, intra4, cbf4,
                                   mv_x, mv_y, ref_poc, qp, bd, beta_off,
                                   tc_off, cb_qp_off, cr_qp_off, int_v,
                                   int_h)
    h, w = rec_y.shape
    _check(h, w, bd)
    dev = rec_y.get_device()
    ts = [kernels.ready(t) for t in (rec_y, rec_u, rec_v, intra4, cbf4,
                                     mv_x, mv_y, ref_poc)]
    masks = [None if a is None else kernels.ready(a) for a in (int_v, int_h)]
    outs = _outputs(h, w, rec_y.device)
    kernels.launch_checked(
        "deblock", "hm_deblock_map", dev,
        *(t.data_ptr() for t in ts[:3]), *(o.data_ptr() for o in outs),
        *(t.data_ptr() for t in ts[3:]),
        *(None if a is None else a.data_ptr() for a in masks), h, w, qp, bd,
        beta_off, tc_off, _chroma_tc(qp, cb_qp_off, bd, tc_off),
        _chroma_tc(qp, cr_qp_off, bd, tc_off))
    return outs


def deblock_state(rec_y, rec_u, rec_v, blk, qp: int, bd: int = 8, *,
                  h: int, w: int, ref_pocs=(), ref_pocs_l1=(), num_ref=None,
                  num_ref_l1=None, cusz=None, cbfy=None, beta_off: int = 0,
                  tc_off: int = 0, cb_qp_off: int = 0, cr_qp_off: int = 0):
    """Deblock one picture from its pass's 8x8 cell state: a P / B pass's
    `blk` (bh * bw, 14) with the lists' POCs (`num_ref` / `num_ref_l1`
    entries of `ref_pocs` / `ref_pocs_l1`, at most 16 each; num_ref_l1 0
    in a P slice), or an I pass's `cusz` and `cbfy` (bh * bw,) with `blk`
    None.  Planes flat or (H, W) / (H/2, W/2).  Returns the filtered (y,
    u, v), new (H, W) and (H/2, W/2) planes.  One K3 launch on CUDA
    tensors (the state read in place, the POCs passed by value), the
    plain version on CPU ones."""
    qp = int(qp)
    if not rec_y.is_cuda:
        return deblock_state_plain(
            rec_y, rec_u, rec_v, blk, qp, bd, h=h, w=w, ref_pocs=ref_pocs,
            ref_pocs_l1=ref_pocs_l1, num_ref=num_ref, num_ref_l1=num_ref_l1,
            cusz=cusz, cbfy=cbfy, beta_off=beta_off, tc_off=tc_off,
            cb_qp_off=cb_qp_off, cr_qp_off=cr_qp_off)
    _check(h, w, bd)
    ncell = (h // 8) * (w // 8)
    dev = rec_y.get_device()
    planes = [kernels.ready(t) for t in (rec_y, rec_u, rec_v)]
    if [p.numel() for p in planes] != [h * w, h * w // 4, h * w // 4]:
        raise ValueError(f"deblock: planes of {h}x{w} samples, got "
                         f"{[tuple(p.shape) for p in planes]}")
    pocs = np.zeros(2 + 2 * MAX_REFS, np.int32)
    if blk is None:
        if cusz is None or cbfy is None or cusz.numel() != ncell \
                or cbfy.numel() != ncell:
            raise ValueError(f"deblock: an I state's cusz and cbfy of "
                             f"{ncell} cells")
        sz, cbf = kernels.ready(cusz), kernels.ready(cbfy)
        cols = [None] * 7 + [cbf.data_ptr(), sz.data_ptr()]
        stride = 1
    else:
        b = kernels.ready(blk)
        nr = len(ref_pocs) if num_ref is None else int(num_ref)
        nr1 = len(ref_pocs_l1) if num_ref_l1 is None else int(num_ref_l1)
        if b.dim() != 2 or b.shape[0] != ncell or b.shape[1] <= K_REF1 \
                or not 1 <= nr <= min(len(ref_pocs), MAX_REFS) \
                or not 0 <= nr1 <= min(len(ref_pocs_l1), MAX_REFS):
            raise ValueError(f"deblock: a state of {ncell} cells and 1-16 "
                             f"list 0 and 0-16 list 1 POCs, got "
                             f"{tuple(b.shape)}, {nr} and {nr1}")
        stride = b.shape[1]
        base = b.data_ptr()
        cols = [base + 4 * c for c in (K_DIR, K_MVX, K_MVY, K_REF, K_MVX1,
                                       K_MVY1, K_REF1, K_CBFY, K_SZ)]
        pocs[:2] = nr, nr1
        pocs[2:2 + nr] = [int(p) for p in list(ref_pocs)[:nr]]
        pocs[2 + MAX_REFS:2 + MAX_REFS + nr1] = \
            [int(p) for p in list(ref_pocs_l1)[:nr1]]
    outs = _outputs(h, w, rec_y.device)
    kernels.launch_checked(
        "deblock", "hm_deblock_state", dev,
        *(p.data_ptr() for p in planes), *(o.data_ptr() for o in outs),
        *cols, stride, pocs.ctypes.data, h, w, qp, bd, beta_off, tc_off,
        _chroma_tc(qp, cb_qp_off, bd, tc_off),
        _chroma_tc(qp, cr_qp_off, bd, tc_off))
    return outs
