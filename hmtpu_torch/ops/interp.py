"""Fractional-sample interpolation (DCT-IF) for motion compensation: the
port of hmtpu/ops/interp.py (`_mc_batch_jax` :173 through the batch
wrappers `mc_luma_batch` :304, `mc_chroma_batch` :312,
`mc_luma_batch_refs` :318 and `mc_chroma_batch_refs` :326).

On a CUDA tensor the wrappers launch the hand-written kernel K7
(csrc/mc_dctif.cu); on a CPU tensor they run the plain PyTorch version
beside it (`mc_batch_plain`), the reference's gather + two separable
FIR passes with the same rounding points.

Precision model (H.265 8.5.4.2.2.1) for bit depth B, headroom 14 - B:
  hor pass (not last): t = (sum c_i*s_i - (8192 << (B-8))) >> (B-8)
  ver pass (last):     r = clip((sum c_i*t_i + (1<<11) + (8192<<6)) >> 12)
  single pass:         r = clip((sum c_i*s_i + 32) >> 6)
Reference taps are clamped to the picture (HM's margin replication).
The intermediate-precision forms and the bi-prediction average serve B
slices only and come with the random-access slice of the port.
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


def mc_batch_plain(refs, ridx, xs0, ys0, mvx_q, mvy_q, n_w: int, n_h: int,
                   chroma: bool, bd: int = 8):
    """Plain version of K7: B blocks of n_h x n_w from the (R, H, W)
    reference stack, block i from refs[ridx[i]] at (xs0, ys0) displaced
    by the quarter-pel (luma) MV, which chroma reads as eighth-pel.
    The structure of `_mc_batch_jax`: one clamped patch gather, the
    horizontal FIR over every patch row, the vertical FIR over its
    output, and a select among copy / H-only / V-only / both."""
    ntaps = NTAPS_CHROMA if chroma else NTAPS_LUMA
    sh, msk = (3, 7) if chroma else (2, 3)
    xs = xs0 + (mvx_q >> sh)                    # >> floors (negative MVs)
    ys = ys0 + (mvy_q >> sh)
    fxs, fys = mvx_q & msk, mvy_q & msk
    dev = refs.device
    half = ntaps // 2 - 1
    headroom = IF_INTERNAL_PREC - bd
    maxv = (1 << bd) - 1
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

    single_h = (fys == 0) & (fxs != 0)
    single_v = (fxs == 0) & (fys != 0)
    copy = (fxs == 0) & (fys == 0)
    shift2 = IF_FILTER_PREC + headroom
    off2 = (1 << (shift2 - 1)) + (IF_INTERNAL_OFFS << IF_FILTER_PREC)
    res_both = (acc2 + off2) >> shift2
    # fx == 0: the horizontal pass used phase 0 (x64), so
    # (64 * (S + 32)) >> 12 == (S + 32) >> 6 exactly
    res_single_v = (acc2 + (32 << IF_FILTER_PREC)) >> (2 * IF_FILTER_PREC)
    res_single_h = (acc[:, half:half + n_h, :] + 32) >> IF_FILTER_PREC
    res_copy = patch[:, half:half + n_h, half:half + n_w]
    sel = lambda m: m[:, None, None]
    out = torch.where(sel(copy), res_copy,
                      torch.where(sel(single_h), res_single_h,
                                  torch.where(sel(single_v), res_single_v,
                                              res_both)))
    return torch.clamp(out, 0, maxv)


def mc_batch(refs, ridx, xs0, ys0, mvx_q, mvy_q, n_w: int, n_h: int,
             chroma: bool, bd: int = 8):
    """K7 on a CUDA stack, its plain version on a CPU one."""
    if not refs.is_cuda:
        return mc_batch_plain(refs, ridx, xs0, ys0, mvx_q, mvy_q, n_w, n_h,
                              chroma, bd)
    if refs.dim() != 3:
        raise ValueError(f"mc_dctif: refs must be (R, H, W), got "
                         f"{tuple(refs.shape)}")
    if n_w > 64 or n_h > 64:
        raise ValueError(f"mc_dctif: blocks up to 64x64, got "
                         f"{n_h}x{n_w}")
    i32 = lambda a: a.to(torch.int32).contiguous()
    refs = i32(refs)
    B = int(ridx.shape[0])
    out = torch.empty((B, n_h, n_w), dtype=torch.int32, device=refs.device)
    if B:
        r, h, w = refs.shape
        kernels.launch("mc_dctif", "hm_mc_dctif", refs, i32(ridx),
                       i32(xs0), i32(ys0), i32(mvx_q), i32(mvy_q), out,
                       B, r, h, w, n_w, n_h, int(chroma), bd)
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
