"""Core transform: batched integer DCT/DST (H.265 8.6.4) and their
inverses, bit-exact with the reference's partialButterfly* kernels
(TComTrQuant.cpp:388+, xT :1952).

`forward_transform` / `inverse_transform` keep hmtpu's signatures
(hmtpu/ops/transform.py:38,58), and so do the transform-skip pair
`transform_skip_fwd` / `transform_skip_inv` (:84,89).  On a CUDA tensor
they launch the hand-written kernel K1 (csrc/transform.cu; the skip pair
its TS mode); on a CPU tensor they run the plain PyTorch version beside
it (`*_plain`), which is the same two-stage integer matrix product (or
shift) with the same rounding points.  K1's level forms (`fwd_level`,
`inv_level`) are the P and B passes' coding step around K10, a level's
three planes (or one plane) a launch.

All arithmetic is integer with arithmetic right shifts; intermediate
clipping follows the spec's 16-bit dynamic range.  The sums fit in
int32: |sum| <= N * 90 * 2^15 < 2^31 for N <= 32.
"""
from __future__ import annotations

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

def fwd_level_plain(orgs, preds, bit_depth: int = 8, use_dst: bool = False):
    """[forward_transform_plain(org - pred)] a plane."""
    return [forward_transform_plain(o - p, o.shape[-1], bit_depth,
                                    use_dst and k == 0)
            for k, (o, p) in enumerate(zip(orgs, preds))]


def inv_level_plain(deqs, levs, preds, orgs, bit_depth: int = 8, dw=None,
                    bits=None, use_dst: bool = False):
    """Plain version of `inv_level`: (recs, sses, cbf, dist, bitsum)."""
    recs, sses = [], []
    for k, (d, p, o) in enumerate(zip(deqs, preds, orgs)):
        r = inverse_transform_plain(d, d.shape[-1], bit_depth,
                                    use_dst and k == 0)
        rec = torch.clamp(p + r, 0, (1 << bit_depth) - 1)
        sse = ((o - rec) ** 2).sum((-1, -2)).to(torch.float32)
        if dw is not None and (len(deqs) == 1 or k > 0):
            sse = sse * dw          # HM's chroma distortion weight
        recs.append(rec)
        sses.append(sse)
    if len(deqs) != 3:
        return recs, sses, None, None, None
    m = sses[0].numel()
    nz = lambda lev: (lev.reshape(m, -1) != 0).any(1).to(torch.int32)
    cbf = nz(levs[0]) | (nz(levs[1]) << 1) | (nz(levs[2]) << 2)
    return (recs, sses, cbf, sses[0] + sses[1] + sses[2],
            bits[0] + bits[1] + bits[2])


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


def _mode(bit_depth: int, use_dst: bool) -> int:
    return int(bit_depth) | int(bool(use_dst)) << 8


# The level forms' calls run in the P pass's prelude, which the host
# bounds: the wrappers check and ready their tensors here and pass the
# pointers to kernels.launch_checked (K1-TS's way) without launch's
# second look.

def fwd_level(orgs, preds, bit_depth: int = 8, use_dst: bool = False):
    """A level's (or one plane's) residuals transformed: orgs and preds
    [(..., n, n)] a plane, int -> [coefficients (..., n, n) int32] a
    plane.  K1's forward level form on CUDA tensors (one launch)."""
    if not orgs[0].is_cuda:
        return fwd_level_plain(orgs, preds, bit_depth, use_dst)
    geo = _level_geometry(orgs, "fwd_level")
    if len(preds) != len(orgs) or _level_geometry(preds, "fwd_level") != geo:
        raise ValueError("fwd_level: orgs and preds hold other blocks")
    dev = orgs[0].get_device()
    o = [kernels.ready(t) for t in orgs]
    p = [kernels.ready(t) for t in preds]
    coefs = [torch.empty_like(t) for t in o]
    if geo[0]:
        kernels.launch_checked("int_transform_fwd", "hm_fwd_level", dev,
                               *_ptrs(o, dev), *_ptrs(p, dev),
                               *_ptrs(coefs, dev), *geo, len(o),
                               _mode(bit_depth, use_dst))
    return coefs


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
    geo = _level_geometry(deqs, "inv_level")
    np_ = len(deqs)
    for x in (levs, preds, orgs):
        if len(x) != np_ or _level_geometry(x, "inv_level") != geo:
            raise ValueError("inv_level: the planes hold other blocks")
    three = np_ == 3
    if three and (bits is None or len(bits) != 3):
        raise ValueError("inv_level: three planes need K10's bits of each")
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
    bt = [kernels.ready(b, torch.float32) for b in bits] if three else []
    if dw is not None and not (isinstance(dw, torch.Tensor)
                               and dw.dtype is torch.float32
                               and dw.get_device() == dev):
        dw = torch.tensor(float(dw), dtype=torch.float32, device=p[0].device)
    if geo[0]:
        kernels.launch_checked(
            "int_transform_inv", "hm_inv_level", dev, *_ptrs(d, dev),
            *_ptrs(lv, dev), *_ptrs(p, dev), *_ptrs(o, dev),
            *_ptrs(bt, dev), None if dw is None else dw.data_ptr(),
            *_ptrs(recs, dev), *_ptrs(sses, dev),
            *((cbf.data_ptr(), fl[3].data_ptr(), fl[4].data_ptr())
              if three else (None,) * 3),
            *geo, np_, _mode(bit_depth, use_dst))
    if not three:
        return recs, sses, None, None, None
    return recs, sses, cbf, fl[3], fl[4]


# ---------------------------------------------------------------------------
# transform skip (8.6.4.2 transform_skip_flag branch; the encoder twin of
# TComTrQuant xTransformSkip / xITransformSkip): the "transform" is a
# shift to the coefficient scale, quant and dequant are unchanged.
# Main profile: 4x4 only.

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


def _launch_ts(x, mode: int):
    """K1's TS mode (mode: inverse | s1 << 1 | s2 << 8) on CUDA tensor x,
    elementwise like the plain version (any shape).  At the main path's
    shapes the call's time is its host time: an int32 contiguous input
    goes in as it is, the shifts travel as one int, and the tensors, made
    int32 and contiguous here (the output like the input), go to the
    kernel without kernels.launch's second look."""
    if x.dtype is not torch.int32 or not x.is_contiguous():
        x = x.to(torch.int32).contiguous()
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        kernels.launch_checked("transform_skip", "hm_transform_skip",
                               x.get_device(), x.data_ptr(), out.data_ptr(),
                               n, mode)
    return out


def transform_skip_fwd(residual, size: int, bit_depth: int = 8):
    """residual -> coefficient-scale values (Main profile: 4x4 only)."""
    if residual.is_cuda:
        return _launch_ts(residual, ts_shift(size, bit_depth) << 1)
    return transform_skip_fwd_plain(residual, size, bit_depth)


def transform_skip_inv(coeff, size: int, bit_depth: int = 8):
    """dequantised coefficients -> residual: r = d << (5 + log2 nTbS)
    (= 7 for the Main-profile 4x4 case), then the common bdShift
    rounding stage (spec 8.6.4.2), clipped to 16 bits."""
    if coeff.is_cuda:
        up, bd_shift = _ts_inv_shifts(size, bit_depth)
        return _launch_ts(coeff, 1 | up << 1 | bd_shift << 8)
    return transform_skip_inv_plain(coeff, size, bit_depth)
