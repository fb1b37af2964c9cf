"""In-loop deblocking filter (H.265 8.7.2): the port of
hmtpu/ops/deblock.py `deblock_frame_dev` :471 with `_bs_dev` :452,
`_luma_edges_dev` :294 and `_chroma_edges_dev` :374.

`deblock_frame_dev` keeps hmtpu's signature.  On CUDA tensors it
launches kernel K3 (csrc/deblock.cu) twice: all vertical edges, then
all horizontal edges, each launch deriving the boundary strengths and
filtering luma and both chroma planes.  On CPU tensors it runs the
plain PyTorch version beside it: dense boundary strengths, then
reshape-and-mask filtering of every edge patch, as in hmtpu.

The picture is filtered on the 8x8 luma grid; chroma (4:2:0) on the
8x8 chroma-sample grid, BS==2 (intra) edges only.
"""
from __future__ import annotations

import numpy as np
import torch

from hmtpu_torch import kernels
from hmtpu_torch.common.spec_tables import CHROMA_QP_TABLE

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
# wrapper: kernel K3 on the card, the plain version on the CPU

def deblock_frame_dev(rec_y, rec_u, rec_v, intra4, cbf4, mv_x, mv_y,
                      ref_poc, qp: int, bd: int = 8, beta_off: int = 0,
                      tc_off: int = 0, cb_qp_off: int = 0,
                      cr_qp_off: int = 0, int_v=None, int_h=None):
    """Deblock one picture.  Planes (H, W) / (H/2, W/2) int32; intra4 /
    cbf4 (H/4, W/4); mv_x / mv_y / ref_poc (2, H/4, W/4) int32 (-1 ref =
    list unused).  int_v/int_h (optional bool masks over the 8-cell
    grid) mark 8-pel edges interior to a larger CU/TU: int_v[cy, j] =
    the edge between cell columns j and j+1 is interior.  Returns the
    filtered (y, u, v)."""
    qp = int(qp)
    if not rec_y.is_cuda:
        return deblock_frame_plain(rec_y, rec_u, rec_v, intra4, cbf4,
                                   mv_x, mv_y, ref_poc, qp, bd, beta_off,
                                   tc_off, cb_qp_off, cr_qp_off, int_v,
                                   int_h)
    h, w = rec_y.shape
    i32 = lambda a: a.to(torch.int32).contiguous()
    y, u, v = (i32(p).clone() for p in (rec_y, rec_u, rec_v))
    meta = [i32(a) for a in (intra4, cbf4, mv_x, mv_y, ref_poc)]
    masks = [None if a is None else i32(a) for a in (int_v, int_h)]
    tc_cb = _chroma_tc(qp, cb_qp_off, bd, tc_off)
    tc_cr = _chroma_tc(qp, cr_qp_off, bd, tc_off)
    for d in (0, 1):
        kernels.launch("deblock", "hm_deblock_edges", y, u, v, *meta,
                       masks[d], h, w, d, qp, tc_cb, tc_cr, bd, beta_off,
                       tc_off)
    return y, u, v
