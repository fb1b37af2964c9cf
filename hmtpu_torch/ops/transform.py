"""Core transform: batched integer DCT/DST (H.265 8.6.4) and their
inverses, bit-exact with the reference's partialButterfly* kernels
(TComTrQuant.cpp:388+, xT :1952).

`forward_transform` / `inverse_transform` keep hmtpu's signatures
(hmtpu/ops/transform.py:38,58).  On a CUDA tensor they launch the
hand-written kernel K1 (csrc/transform.cu); on a CPU tensor they run the
plain PyTorch version beside it (`*_plain`), which is the same two-stage
integer matrix product with the same rounding points.  K1's level forms
(`fwd_level`, `inv_level`, `inv_level_ts`) are the P and B passes'
coding step around K10, a level's three planes (or one plane) a launch;
their TS mode is the transform-skip pair (hmtpu's `transform_skip_fwd`
/ `transform_skip_inv` :84,89, whose plain versions are
`transform_skip_fwd_plain` / `transform_skip_inv_plain`, with
`_code_ts_sel`'s pick in the inverse).

All arithmetic is integer with arithmetic right shifts; intermediate
clipping follows the spec's 16-bit dynamic range.  The sums fit in
int32: |sum| <= N * 90 * 2^15 < 2^31 for N <= 32.
"""
from __future__ import annotations

import ctypes

import torch

from hmtpu_torch import kernels
from hmtpu_torch.common import spec_tables as st

MAX_TR_DYNAMIC_RANGE = 15
TRANSFORM_MATRIX_SHIFT = 6
COEFF_MIN = -(1 << 15)
COEFF_MAX = (1 << 15) - 1

_MATS: dict = {}


def matrix(size: int, use_dst: bool, device) -> torch.Tensor:
    """The (size, size) int32 transform matrix on `device` (cached)."""
    dst = bool(use_dst and size == 4)
    key = (size, dst, str(device))
    m = _MATS.get(key)
    if m is None:
        m = torch.as_tensor(st.DST4 if dst else st.DCT[size],
                            dtype=torch.int32).to(device).contiguous()
        _MATS[key] = m
    return m


def _shifts_fwd(size: int, bit_depth: int):
    log2 = int(size).bit_length() - 1
    return (log2 + bit_depth + TRANSFORM_MATRIX_SHIFT
            - MAX_TR_DYNAMIC_RANGE, log2 + TRANSFORM_MATRIX_SHIFT)


def _shifts_inv(bit_depth: int):
    return (TRANSFORM_MATRIX_SHIFT + 1,
            (TRANSFORM_MATRIX_SHIFT + MAX_TR_DYNAMIC_RANGE - 1) - bit_depth)


def _rshift_round(x, shift: int):
    return (x + (1 << (shift - 1))) >> shift if shift > 0 else x << (-shift)


def _imm(a, b):
    """Integer matrix product a @ b over the last two axes, int64
    accumulation (exact; works on every device, unlike integer matmul)."""
    return (a.to(torch.int64)[..., :, :, None]
            * b.to(torch.int64)[..., None, :, :]).sum(-2)


def forward_transform_plain(residual, size: int, bit_depth: int = 8,
                            use_dst: bool = False):
    t = matrix(size, use_dst, residual.device)
    shift1, shift2 = _shifts_fwd(size, bit_depth)
    # stage 1 (horizontal): tmp[i, j] = sum_k T[i, k] * res[j, k]
    tmp = _rshift_round(_imm(t, residual.transpose(-1, -2)), shift1)
    # stage 2 (vertical): coeff[i, j] = sum_k T[i, k] * tmp[j, k]
    coeff = _imm(t, tmp.transpose(-1, -2))
    return _rshift_round(coeff, shift2).to(torch.int32)


def inverse_transform_plain(coeff, size: int, bit_depth: int = 8,
                            use_dst: bool = False):
    t = matrix(size, use_dst, coeff.device)
    shift1, shift2 = _shifts_inv(bit_depth)
    # stage 1 (columns): tmp[i, j] = sum_k T[k, i] * coeff[k, j]
    tmp = _imm(t.transpose(0, 1), coeff)
    tmp = torch.clamp(_rshift_round(tmp, shift1), COEFF_MIN, COEFF_MAX)
    # stage 2 (rows): r[i, j] = sum_k tmp[i, k] * T[k, j]
    res = _imm(tmp, t)
    return torch.clamp(_rshift_round(res, shift2), COEFF_MIN,
                       COEFF_MAX).to(torch.int32)


def _launch(kernel: str, fn: str, x, size, use_dst, shift1, shift2):
    if x.shape[-1] != size or x.shape[-2] != size:
        raise ValueError(f"expected (..., {size}, {size}), got "
                         f"{tuple(x.shape)}")
    x = x.contiguous()
    out = torch.empty_like(x)
    nb = x.numel() // (size * size)
    if nb:
        kernels.launch(kernel, fn, x, matrix(size, use_dst, x.device), out,
                       nb, size, shift1, shift2)
    return out


def forward_transform(residual, size: int, bit_depth: int = 8,
                      use_dst: bool = False):
    """residual: (..., size, size) int32 -> coefficients, same shape.

    Two-stage integer transform: rows first (shift1), then columns
    (shift2), matching xT/partialButterfly rounding exactly."""
    if residual.is_cuda:
        return _launch("int_transform_fwd", "hm_int_transform_fwd",
                       residual, size, use_dst,
                       *_shifts_fwd(size, bit_depth))
    return forward_transform_plain(residual, size, bit_depth, use_dst)


def inverse_transform(coeff, size: int, bit_depth: int = 8,
                      use_dst: bool = False):
    """coefficients -> residual, spec 8.6.4.2 rounding/clipping."""
    if coeff.is_cuda:
        return _launch("int_transform_inv", "hm_int_transform_inv",
                       coeff, size, use_dst, *_shifts_inv(bit_depth))
    return inverse_transform_plain(coeff, size, bit_depth, use_dst)


# ---------------------------------------------------------------------------
# K1's level forms: the coding step of hmtpu/encoder/pframe_dev.py:188
# `_code` around K10 (residual -> transform; dequantised coefficients ->
# inverse -> reconstruction and SSE) for one plane, or for a CU level's
# three planes (luma n x n, chroma n/2 x n/2, the same blocks) with the
# combine of `hypothesis` (cbf, distortion, rate).  One launch each on
# CUDA tensors; on CPU tensors the plain versions, which are that
# composition of torch operations.  `use_dst` takes the 4x4 DST on the
# first plane (a one-plane luma call at n = 4).

def ts_planes(planes: int):
    """The planes of a level form's TS pair: the one plane, or the chroma
    pair of three."""
    return (0,) if planes == 1 else (1, 2)


def fwd_level_plain(orgs, preds, bit_depth: int = 8, use_dst: bool = False,
                    ts: bool = False):
    """[forward_transform_plain(org - pred)] a plane, and with ts
    [transform_skip_fwd_plain(org - pred)] a TS plane."""
    coefs = [forward_transform_plain(o - p, o.shape[-1], bit_depth,
                                     use_dst and k == 0)
             for k, (o, p) in enumerate(zip(orgs, preds))]
    if not ts:
        return coefs
    return coefs, [transform_skip_fwd_plain(orgs[k] - preds[k], 4,
                                            bit_depth)
                   for k in ts_planes(len(orgs))]


def _recon_plain(r, p, o, bit_depth: int, w):
    """clip(p + r) and its float32 SSE against o, times w where given."""
    rec = torch.clamp(p + r, 0, (1 << bit_depth) - 1)
    sse = ((o - rec) ** 2).sum((-1, -2)).to(torch.float32)
    if w is not None:
        sse = sse * w               # HM's chroma distortion weight
    return rec, sse


def _weight(dw, planes: int, k: int):
    return dw if dw is not None and (planes == 1 or k > 0) else None


def _nz(lev):
    return (lev.reshape(lev.shape[0], -1) != 0).any(1)


def inv_level_plain(deqs, levs, preds, orgs, bit_depth: int = 8, dw=None,
                    bits=None, use_dst: bool = False):
    """Plain version of `inv_level`: (recs, sses, cbf, dist, bitsum)."""
    recs, sses = [], []
    for k, (d, p, o) in enumerate(zip(deqs, preds, orgs)):
        r = inverse_transform_plain(d, d.shape[-1], bit_depth,
                                    use_dst and k == 0)
        rec, sse = _recon_plain(r, p, o, bit_depth,
                                _weight(dw, len(deqs), k))
        recs.append(rec)
        sses.append(sse)
    if len(deqs) != 3:
        return recs, sses, None, None, None
    nz = lambda lev: _nz(lev).to(torch.int32)
    cbf = nz(levs[0]) | (nz(levs[1]) << 1) | (nz(levs[2]) << 2)
    return (recs, sses, cbf, sses[0] + sses[1] + sses[2],
            bits[0] + bits[1] + bits[2])


def inv_level_ts_plain(deqs, levs, bits, tdeqs, tlevs, tbits, preds, orgs,
                       flag, lam, bit_depth: int = 8, dw=None,
                       use_dst: bool = False):
    """Plain version of `inv_level_ts`: hmtpu's `_code_ts_sel` pick
    (hmtpu/encoder/pframe_dev.py:223) on each TS plane."""
    P = len(deqs)
    recs, sses, _, _, _ = inv_level_plain(deqs, levs, preds, orgs,
                                          bit_depth, dw, bits, use_dst)
    levk, bitk, ts = [], [], 0
    for i, k in enumerate(ts_planes(P)):
        rec1, d1 = _recon_plain(
            transform_skip_inv_plain(tdeqs[i], 4, bit_depth), preds[k],
            orgs[k], bit_depth, _weight(dw, P, k))
        nz0, nz1 = _nz(levs[k]), _nz(tlevs[i])
        # the flag exists only where the TB is coded (cbf = 1)
        b0 = bits[k] + torch.where(nz0, flag[0], 0.0)
        b1 = tbits[i] + torch.where(nz1, flag[1], 0.0)
        use = nz1 & (d1 + lam * b1 < sses[k] + lam * b0)
        u3 = use[:, None, None]
        recs[k] = torch.where(u3, rec1, recs[k])
        sses[k] = torch.where(use, d1, sses[k])
        levk.append(torch.where(u3, tlevs[i], levs[k]))
        bitk.append(torch.where(use, b1, b0))
        ts = ts | (use.to(torch.int32) << i)
    if P != 3:
        return recs, sses, levk, bitk, ts, None, None, None
    nz = lambda lev: _nz(lev).to(torch.int32)
    cbf = nz(levs[0]) | (nz(levk[0]) << 1) | (nz(levk[1]) << 2)
    return (recs, sses, levk, bitk, ts, cbf, sses[0] + sses[1] + sses[2],
            bits[0] + bitk[0] + bitk[1])


def _level_geometry(planes, what):
    """(blocks m, n0, n1) of a level form's planes: 1, or 3 holding the
    same m blocks with chroma (n1) half the luma size (n0)."""
    if len(planes) not in (1, 3):
        raise ValueError(f"{what}: 1 or 3 planes, got {len(planes)}")
    n0 = planes[0].shape[-1]
    n1 = planes[1].shape[-1] if len(planes) == 3 else 0
    m = planes[0].numel() // (n0 * n0)
    for k, t in enumerate(planes):
        n = n1 if k else n0
        if t.dim() < 2 or t.shape[-2] != n or t.shape[-1] != n \
                or t.numel() != m * n * n or (k and 2 * n1 != n0):
            raise ValueError(f"{what}: plane {k} of shape {tuple(t.shape)}; "
                             f"the planes must hold the same blocks, chroma "
                             f"half the luma size")
    return m, n0, n1


def _ptrs(ts, dev: int):
    """The data pointers of tensors on CUDA device dev, padded with nulls
    to three planes (the level kernels' arguments)."""
    for t in ts:
        if t.get_device() != dev:
            raise ValueError(f"level form: a tensor on {t.device}, the "
                             f"first on cuda:{dev}")
    return [t.data_ptr() for t in ts] + [None] * (3 - len(ts))


def _mode(bit_depth: int, use_dst: bool, ts: bool = False) -> int:
    return int(bit_depth) | int(bool(use_dst)) << 8 | int(bool(ts)) << 9


def _ts_geometry(geo, planes: int, what: str):
    """A TS pair's planes must be 4x4: the one plane's, or the chroma's
    of three."""
    if (geo[1] if planes == 1 else geo[2]) != 4:
        raise ValueError(f"{what}: the transform-skip pair takes 4x4 TBs "
                         f"(the one plane, or the chroma of an 8x8 level)")


# The level forms' calls run in the P pass's prelude, which the host
# bounds: the wrappers check and ready their tensors here and pass the
# pointers to kernels.launch_checked without launch's second look.

def fwd_level(orgs, preds, bit_depth: int = 8, use_dst: bool = False,
              ts: bool = False):
    """A level's (or one plane's) residuals transformed: orgs and preds
    [(..., n, n)] a plane, int -> [coefficients (..., n, n) int32] a
    plane; with ts, (those, [the TS coefficients, the residual shifted]
    a TS plane: `ts_planes`).  K1's forward level form on CUDA tensors
    (one launch)."""
    if not orgs[0].is_cuda:
        return fwd_level_plain(orgs, preds, bit_depth, use_dst, ts)
    geo = _level_geometry(orgs, "fwd_level")
    if len(preds) != len(orgs) or _level_geometry(preds, "fwd_level") != geo:
        raise ValueError("fwd_level: orgs and preds hold other blocks")
    if ts:
        _ts_geometry(geo, len(orgs), "fwd_level")
    dev = orgs[0].get_device()
    o = [kernels.ready(t) for t in orgs]
    p = [kernels.ready(t) for t in preds]
    coefs = [torch.empty_like(t) for t in o]
    tk = ts_planes(len(o)) if ts else ()
    tcoefs = [torch.empty_like(o[k]) for k in tk]
    tptr = [None] * 3
    for k, t in zip(tk, tcoefs):
        tptr[k] = t.data_ptr()
    if geo[0]:
        kernels.launch_checked("int_transform_fwd", "hm_fwd_level", dev,
                               *_ptrs(o, dev), *_ptrs(p, dev),
                               *_ptrs(coefs, dev), *tptr, *geo, len(o),
                               _mode(bit_depth, use_dst, ts))
    return (coefs, tcoefs) if ts else coefs


def _scalar_on(x, dev: int, like):
    """x as a float32 0-d tensor on CUDA device dev (as it is where it is
    one already)."""
    if isinstance(x, torch.Tensor) and x.dtype is torch.float32 \
            and x.get_device() == dev:
        return x
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


def _inv_launch(deqs, levs, preds, orgs, bit_depth, dw, bits, use_dst,
                tsa=None):
    """K1's inverse level form, with the TS pair where tsa = (tdeqs,
    tlevs, tbits, flag, lam): (recs, sses, cbf, dist, bitsum, levk, bitk,
    ts), None where the call has no such output."""
    what = "inv_level_ts" if tsa is not None else "inv_level"
    geo = _level_geometry(deqs, what)
    np_ = len(deqs)
    for x in (levs, preds, orgs):
        if len(x) != np_ or _level_geometry(x, what) != geo:
            raise ValueError(f"{what}: the planes hold other blocks")
    three = np_ == 3
    if (three or tsa is not None) and (bits is None or len(bits) != np_):
        raise ValueError(f"{what}: three planes and the TS pair need K10's "
                         f"bits of each plane")
    dev = deqs[0].get_device()
    d, lv, p, o = ([kernels.ready(t) for t in x]
                   for x in (deqs, levs, preds, orgs))
    recs = [torch.empty_like(t) for t in p]
    lead = p[0].shape[:-2]
    # each plane's SSE, then dist and bitsum (three planes)
    fl = torch.empty((5,) + tuple(lead), dtype=torch.float32,
                     device=p[0].device).unbind(0)
    sses = [f if f.shape == t.shape[:-2] else f.view(t.shape[:-2])
            for f, t in zip(fl, p)]
    cbf = torch.empty(lead, dtype=torch.int32, device=p[0].device) \
        if three else None
    bt = [kernels.ready(b, torch.float32) for b in bits] \
        if three or tsa is not None else []
    if dw is not None:
        dw = _scalar_on(dw, dev, p[0])
    ext = levk = bitk = ts = None
    if tsa is not None:
        tdeqs, tlevs, tbits, flag, lam = tsa
        _ts_geometry(geo, np_, what)
        tk = ts_planes(np_)
        if not len(tdeqs) == len(tlevs) == len(tbits) == len(tk):
            raise ValueError(f"{what}: one TS alternative a TS plane")
        if flag.dtype is not torch.float32 or flag.numel() != 2 \
                or not flag.is_contiguous() or flag.get_device() != dev:
            raise ValueError(f"{what}: the flag's two float32 prices on "
                             f"cuda:{dev}")
        levk = [torch.empty_like(lv[k]) for k in tk]
        bitk = [torch.empty(p[k].shape[:-2], dtype=torch.float32,
                            device=p[0].device) for k in tk]
        ts = torch.empty(lead, dtype=torch.int32, device=p[0].device)
        lam = _scalar_on(lam, dev, p[0])
        ptr, kept = [None] * 18, []   # kept: the inputs to the launch
        for i, k in enumerate(tk):
            if tdeqs[i].shape != lv[k].shape or tlevs[i].shape != \
                    lv[k].shape or tbits[i].numel() != geo[0]:
                raise ValueError(f"{what}: a TS alternative of another "
                                 f"shape than its plane")
            kept += [kernels.ready(tdeqs[i]), kernels.ready(tlevs[i]),
                     kernels.ready(tbits[i], torch.float32)]
            for base, t in zip((0, 3, 6, 11, 14), kept[-3:] + [levk[i],
                                                             bitk[i]]):
                ptr[base + k] = _ptrs([t], dev)[0]
        ptr[9], ptr[10], ptr[17] = flag.data_ptr(), lam.data_ptr(), \
            ts.data_ptr()
        ext = (ctypes.c_void_p * 18)(*ptr)
    if geo[0]:
        kernels.launch_checked(
            "int_transform_inv", "hm_inv_level", dev, *_ptrs(d, dev),
            *_ptrs(lv, dev), *_ptrs(p, dev), *_ptrs(o, dev),
            *_ptrs(bt, dev), None if dw is None else dw.data_ptr(),
            *_ptrs(recs, dev), *_ptrs(sses, dev),
            *((cbf.data_ptr(), fl[3].data_ptr(), fl[4].data_ptr())
              if three else (None,) * 3),
            None if ext is None else ctypes.addressof(ext),
            *geo, np_, _mode(bit_depth, use_dst, tsa is not None))
    if not three:
        return recs, sses, None, None, None, levk, bitk, ts
    return recs, sses, cbf, fl[3], fl[4], levk, bitk, ts


def inv_level(deqs, levs, preds, orgs, bit_depth: int = 8, dw=None,
              bits=None, use_dst: bool = False):
    """The reconstruction of a level's (or one plane's) coded TBs: deqs
    (K10's dequantised coefficients), levs (its levels), preds and orgs
    [(..., n, n)] a plane -> (recs [clip(pred + r, 0, 2^bd - 1)] a plane,
    sses [the float32 SSE of each TB, times dw (a float32 0-d tensor) on
    the chroma planes, or on the one plane, where dw is given] a plane,
    and, three planes, cbf (bit k: plane k has a nonzero level), dist =
    (dy + du) + dv and bitsum = (by + bu) + bv of K10's bits [(...,)] a
    plane; else None three times).  K1's inverse level form on CUDA
    tensors (one launch)."""
    if not deqs[0].is_cuda:
        return inv_level_plain(deqs, levs, preds, orgs, bit_depth, dw, bits,
                               use_dst)
    return _inv_launch(deqs, levs, preds, orgs, bit_depth, dw, bits,
                       use_dst)[:5]


def inv_level_ts(deqs, levs, bits, tdeqs, tlevs, tbits, preds, orgs, flag,
                 lam, bit_depth: int = 8, dw=None, use_dst: bool = False):
    """`inv_level` with the transform-skip pair of its 4x4 planes
    (`ts_planes`: the one plane, or the chroma pair of an 8x8 level):
    tdeqs, tlevs and tbits are K10's coding of `fwd_level(ts=True)`'s TS
    coefficients, a TS plane each; flag the (2,) float32 prices of
    transform_skip_flag 0 and 1 (`ratebits.ts_flag_pair`), lam the TS
    planes' lambda (a float32 0-d tensor).  Each TS plane's TB keeps its
    TS alternative where that is coded (cbf 1) and strictly cheaper, each
    priced with the flag where coded: nz1 & (d1 + lam bits1 < d0 + lam
    bits0).  Returns (recs, sses (the kept distortion on a TS plane),
    levk and bitk [the kept levels and rate, the flag included] a TS
    plane, ts (int32, bit i: the i-th TS plane kept TS), and, three
    planes, cbf, dist and bitsum of the kept alternatives; else None three
    times).  K1's inverse level form in its TS mode on CUDA tensors (one
    launch)."""
    if not deqs[0].is_cuda:
        return inv_level_ts_plain(deqs, levs, bits, tdeqs, tlevs, tbits,
                                  preds, orgs, flag, lam, bit_depth, dw,
                                  use_dst)
    recs, sses, cbf, dist, bsum, levk, bitk, ts = _inv_launch(
        deqs, levs, preds, orgs, bit_depth, dw, bits, use_dst,
        (tdeqs, tlevs, tbits, flag, lam))
    return recs, sses, levk, bitk, ts, cbf, dist, bsum


# ---------------------------------------------------------------------------
# transform skip (8.6.4.2 transform_skip_flag branch; the encoder twin of
# TComTrQuant xTransformSkip / xITransformSkip): the "transform" is a
# shift to the coefficient scale, quant and dequant are unchanged.
# Main profile: 4x4 only.  The plain versions of the level forms' TS
# mode.

def ts_shift(size: int, bit_depth: int) -> int:
    return MAX_TR_DYNAMIC_RANGE - bit_depth - (size.bit_length() - 1)


def _ts_inv_shifts(size: int, bit_depth: int):
    """(left shift 5 + log2 nTbS, bdShift) of the inverse."""
    return 5 + (size.bit_length() - 1), 20 - bit_depth


def transform_skip_fwd_plain(residual, size: int, bit_depth: int = 8):
    return residual << ts_shift(size, bit_depth)


def transform_skip_inv_plain(coeff, size: int, bit_depth: int = 8):
    up, bd_shift = _ts_inv_shifts(size, bit_depth)
    out = ((coeff << up) + (1 << (bd_shift - 1))) >> bd_shift
    return torch.clamp(out, COEFF_MIN, COEFF_MAX).to(torch.int32)
