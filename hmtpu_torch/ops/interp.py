"""Fractional-sample interpolation (DCT-IF) for motion compensation: the
port of hmtpu/ops/interp.py (`_mc_batch_jax` :173 through the batch
wrappers `mc_luma_batch` :304, `mc_chroma_batch` :312,
`mc_luma_batch_refs` :318 and `mc_chroma_batch_refs` :326; the
intermediate-precision `_mc_batch_jax_i` :227 through
`mc_luma_batch_refs_i` :281 and `mc_chroma_batch_refs_i` :288; and
`bi_average_t` :295).

On a CUDA tensor the wrappers launch the hand-written kernels (K7 and
K11 in csrc/mc_dctif.cu, K12 in csrc/bi_pred.cu); on a CPU tensor they
run the plain PyTorch versions beside them (`mc_batch_plain`,
`mc_batch_i_plain`, `bi_pred_plain`), the reference's gather + two
separable FIR passes with the same rounding points.

Precision model (H.265 8.5.4.2.2.1) for bit depth B, headroom 14 - B:
  hor pass (not last): t = (sum c_i*s_i - (8192 << (B-8))) >> (B-8)
  ver pass (last):     r = clip((sum c_i*t_i + (1<<11) + (8192<<6)) >> 12)
  single pass:         r = clip((sum c_i*s_i + 32) >> 6)
Reference taps are clamped to the picture (HM's margin replication).
The intermediate-precision forms (the B-slice hypotheses) keep HM's
is_last=False scaling and no clip:
  copy:           (s << headroom) - 8192
  H-only, V-only: (sum c_i*s_i - (8192 << (B-8))) >> (B-8)
  both:           (sum c_i*t_i) >> 6
and the bi-prediction average (TComYuv::addAvg) is
  clip((i0 + i1 + (1 << (14-B)) + 2*8192) >> (15 - B)).
"""
from __future__ import annotations

import numpy as np
import torch

from hmtpu_torch import kernels

# Luma 8-tap DCT-IF, quarter-pel phases 0..3 (H.265 Table 8-11).
LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)

# Chroma 4-tap DCT-IF, eighth-pel phases 0..7 (H.265 Table 8-12).
CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int32)

NTAPS_LUMA = 8
NTAPS_CHROMA = 4
IF_FILTER_PREC = 6
IF_INTERNAL_PREC = 14
IF_INTERNAL_OFFS = 1 << (IF_INTERNAL_PREC - 1)

_FILT: dict = {}


def _filters(ntaps: int, device):
    key = (ntaps, str(device))
    f = _FILT.get(key)
    if f is None:
        f = torch.as_tensor(LUMA_FILTERS if ntaps == NTAPS_LUMA
                            else CHROMA_FILTERS).to(device)
        _FILT[key] = f
    return f


def _fir(refs, ridx, xs0, ys0, mvx_q, mvy_q, n_w: int, n_h: int,
         chroma: bool, bd: int):
    """The reference's gather + two separable FIR passes: B blocks of
    n_h x n_w from the (R, H, W) stack, block i from refs[ridx[i]] at
    (xs0, ys0) displaced by the quarter-pel (luma) MV, which chroma
    reads as eighth-pel.  Returns (patch, hor sums, ver sums, phase x,
    phase y, half) for the two finishing rules."""
    ntaps = NTAPS_CHROMA if chroma else NTAPS_LUMA
    sh, msk = (3, 7) if chroma else (2, 3)
    xs = xs0 + (mvx_q >> sh)                    # >> floors (negative MVs)
    ys = ys0 + (mvy_q >> sh)
    fxs, fys = mvx_q & msk, mvy_q & msk
    dev = refs.device
    half = ntaps // 2 - 1
    h, w = refs.shape[-2:]
    filt = _filters(ntaps, dev)

    py = ys[:, None] + torch.arange(-half, n_h + ntaps - 1 - half,
                                    device=dev)[None, :]
    px = xs[:, None] + torch.arange(-half, n_w + ntaps - 1 - half,
                                    device=dev)[None, :]
    cy = torch.clamp(py, 0, h - 1)[:, :, None]
    cx = torch.clamp(px, 0, w - 1)[:, None, :]
    patch = refs[ridx.to(torch.int64)[:, None, None], cy.to(torch.int64),
                 cx.to(torch.int64)].to(torch.int32)

    fx = filt[fxs.to(torch.int64)]                 # (B, ntaps)
    fy = filt[fys.to(torch.int64)]
    hw = torch.stack([patch[:, :, k:k + n_w] for k in range(ntaps)], -1)
    acc = (hw * fx[:, None, None, :]).sum(-1, dtype=torch.int32)
    shift1 = bd - 8
    both = (fxs != 0) & (fys != 0)
    tmp = torch.where(both[:, None, None],
                      (acc - (IF_INTERNAL_OFFS << shift1)) >> shift1, acc)
    vw = torch.stack([tmp[:, k:k + n_h, :] for k in range(ntaps)], -1)
    acc2 = (vw * fy[:, None, None, :]).sum(-1, dtype=torch.int32)
    return patch, acc, acc2, fxs, fys, half


def _select(fxs, fys, res_copy, res_single_h, res_single_v, res_both):
    sel = lambda m: m[:, None, None]
    return torch.where(
        sel((fxs == 0) & (fys == 0)), res_copy,
        torch.where(sel((fys == 0) & (fxs != 0)), res_single_h,
                    torch.where(sel((fxs == 0) & (fys != 0)),
                                res_single_v, res_both)))


def mc_batch_plain(refs, ridx, xs0, ys0, mvx_q, mvy_q, n_w: int, n_h: int,
                   chroma: bool, bd: int = 8):
    """Plain version of K7: the structure of `_mc_batch_jax`, one
    clamped patch gather, the horizontal FIR over every patch row, the
    vertical FIR over its output, and a select among copy / H-only /
    V-only / both."""
    patch, acc, acc2, fxs, fys, half = _fir(refs, ridx, xs0, ys0, mvx_q,
                                            mvy_q, n_w, n_h, chroma, bd)
    headroom = IF_INTERNAL_PREC - bd
    shift2 = IF_FILTER_PREC + headroom
    off2 = (1 << (shift2 - 1)) + (IF_INTERNAL_OFFS << IF_FILTER_PREC)
    res_both = (acc2 + off2) >> shift2
    # fx == 0: the horizontal pass used phase 0 (x64), so
    # (64 * (S + 32)) >> 12 == (S + 32) >> 6 exactly
    res_single_v = (acc2 + (32 << IF_FILTER_PREC)) >> (2 * IF_FILTER_PREC)
    res_single_h = (acc[:, half:half + n_h, :] + 32) >> IF_FILTER_PREC
    res_copy = patch[:, half:half + n_h, half:half + n_w]
    out = _select(fxs, fys, res_copy, res_single_h, res_single_v, res_both)
    return torch.clamp(out, 0, (1 << bd) - 1)


def mc_batch_i_plain(refs, ridx, xs0, ys0, mvx_q, mvy_q, n_w: int,
                     n_h: int, chroma: bool, bd: int = 8):
    """Plain version of K11: `_mc_batch_jax_i`, the same gather and FIR
    passes as K7's plain version with HM's is_last=False rules, int32
    and unclipped."""
    patch, acc, acc2, fxs, fys, half = _fir(refs, ridx, xs0, ys0, mvx_q,
                                            mvy_q, n_w, n_h, chroma, bd)
    shift1 = bd - 8
    res_both = acc2 >> IF_FILTER_PREC
    # ver-only: the horizontal pass was phase 0 (x64)
    res_single_v = ((acc2 >> IF_FILTER_PREC)
                    - (IF_INTERNAL_OFFS << shift1)) >> shift1
    res_single_h = (acc[:, half:half + n_h, :]
                    - (IF_INTERNAL_OFFS << shift1)) >> shift1
    res_copy = (patch[:, half:half + n_h, half:half + n_w]
                << (IF_INTERNAL_PREC - bd)) - IF_INTERNAL_OFFS
    return _select(fxs, fys, res_copy, res_single_h, res_single_v, res_both)


def mc_batch(refs, ridx, xs0, ys0, mvx_q, mvy_q, n_w: int, n_h: int,
             chroma: bool, bd: int = 8, inter: bool = False):
    """K7 (final samples) or, with inter=True, K11 (the unclipped
    intermediate-precision hypothesis) on a CUDA stack; their plain
    versions on a CPU one."""
    if not refs.is_cuda:
        plain = mc_batch_i_plain if inter else mc_batch_plain
        return plain(refs, ridx, xs0, ys0, mvx_q, mvy_q, n_w, n_h, chroma,
                     bd)
    name = "mc_dctif_i" if inter else "mc_dctif"
    if refs.dim() != 3:
        raise ValueError(f"{name}: refs must be (R, H, W), got "
                         f"{tuple(refs.shape)}")
    if n_w > 64 or n_h > 64:
        raise ValueError(f"{name}: blocks up to 64x64, got {n_h}x{n_w}")
    i32 = lambda a: a.to(torch.int32).contiguous()
    refs = i32(refs)
    B = int(ridx.shape[0])
    out = torch.empty((B, n_h, n_w), dtype=torch.int32, device=refs.device)
    if B:
        r, h, w = refs.shape
        kernels.launch(name, "hm_" + name, refs, i32(ridx), i32(xs0),
                       i32(ys0), i32(mvx_q), i32(mvy_q), out, B, r, h, w,
                       n_w, n_h, int(chroma), bd)
    return out


def mc_luma_batch_refs(refs, ridx, xs0, ys0, mvx_q, mvy_q, n_w, n_h, bd=8):
    """Batched luma MC over stacked reference planes (R, H, W): each
    block selects its reference with ridx (B,); quarter-pel MVs."""
    return mc_batch(refs, ridx, xs0, ys0, mvx_q, mvy_q, n_w, n_h, False, bd)


def mc_chroma_batch_refs(refs, ridx, xs0, ys0, mvx_q, mvy_q, n_w, n_h,
                         bd=8):
    """Batched 4:2:0 chroma MC: the luma quarter-pel MV is eighth-pel in
    chroma coordinates (8.5.4.2.1)."""
    return mc_batch(refs, ridx, xs0, ys0, mvx_q, mvy_q, n_w, n_h, True, bd)


def mc_luma_batch(plane, xs0, ys0, mvx_q, mvy_q, n_w, n_h, bd=8):
    """Batched luma MC of B blocks from one (H, W) plane."""
    return mc_luma_batch_refs(plane[None], torch.zeros_like(xs0), xs0, ys0,
                              mvx_q, mvy_q, n_w, n_h, bd)


def mc_chroma_batch(plane, xs0, ys0, mvx_q, mvy_q, n_w, n_h, bd=8):
    return mc_chroma_batch_refs(plane[None], torch.zeros_like(xs0), xs0,
                                ys0, mvx_q, mvy_q, n_w, n_h, bd)


def mc_luma_batch_refs_i(refs, ridx, xs0, ys0, mvx_q, mvy_q, n_w, n_h,
                         bd=8):
    """Luma hypotheses at intermediate precision (int32, unclipped) from
    the stacked references: K11."""
    return mc_batch(refs, ridx, xs0, ys0, mvx_q, mvy_q, n_w, n_h, False, bd,
                    inter=True)


def mc_chroma_batch_refs_i(refs, ridx, xs0, ys0, mvx_q, mvy_q, n_w, n_h,
                           bd=8):
    """4:2:0 chroma hypotheses at intermediate precision: K11."""
    return mc_batch(refs, ridx, xs0, ys0, mvx_q, mvy_q, n_w, n_h, True, bd,
                    inter=True)


def bi_pred_plain(i0, i1, cdir, bd: int = 8):
    """Plain version of K12: per hypothesis pair, the bi-average where
    cdir == 3, else the approximate final samples of the hypothesis in
    use (list 0 where cdir & 1): clip((i + 8192 + 2^(h-1)) >> h), h the
    headroom.  i0, i1 (N, ...) int32; cdir (N,)."""
    shift = IF_INTERNAL_PREC + 1 - bd
    off = (1 << (shift - 1)) + 2 * IF_INTERNAL_OFFS
    headroom = IF_INTERNAL_PREC - bd
    maxv = (1 << bd) - 1
    c = cdir.reshape((-1,) + (1,) * (i0.dim() - 1))
    bi = torch.clamp((i0 + i1 + off) >> shift, 0, maxv)
    uni = torch.where((c & 1) > 0, i0, i1)
    apx = torch.clamp((uni + IF_INTERNAL_OFFS + (1 << (headroom - 1)))
                      >> headroom, 0, maxv)
    return torch.where(c == 3, bi, apx)


def bi_pred(i0, i1, cdir, bd: int = 8):
    """K12 on CUDA tensors, its plain version on CPU ones: the fused
    bi-average and merge-screening select of the B-slice pass."""
    if not i0.is_cuda:
        return bi_pred_plain(i0, i1, cdir, bd)
    if i0.shape != i1.shape or cdir.shape != i0.shape[:1]:
        raise ValueError(f"bi_pred: shapes {tuple(i0.shape)}, "
                         f"{tuple(i1.shape)}, {tuple(cdir.shape)}")
    i32 = lambda a: a.to(torch.int32).contiguous()
    out = torch.empty(i0.shape, dtype=torch.int32, device=i0.device)
    n = int(i0.shape[0])
    if n and i0.numel():
        kernels.launch("bi_pred", "hm_bi_pred", i32(i0), i32(i1), i32(cdir),
                       out, n, i0.numel() // n, bd)
    return out


def bi_average_t(p0, p1, bd: int = 8):
    """The bi-prediction average of two hypothesis batches (TComYuv::
    addAvg): K12 with every pair bi."""
    cdir = torch.full(p0.shape[:1], 3, dtype=torch.int32, device=p0.device)
    return bi_pred(p0, p1, cdir, bd)
