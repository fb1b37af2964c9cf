"""Core transform: batched integer DCT/DST (H.265 8.6.4) and their
inverses, bit-exact with the reference's partialButterfly* kernels
(TComTrQuant.cpp:388+, xT :1952).

`forward_transform` / `inverse_transform` keep hmtpu's signatures
(hmtpu/ops/transform.py:38,58), and so do the transform-skip pair
`transform_skip_fwd` / `transform_skip_inv` (:84,89).  On a CUDA tensor
they launch the hand-written kernel K1 (csrc/transform.cu; the skip pair
its TS mode); on a CPU tensor they run the plain PyTorch version beside
it (`*_plain`), which is the same two-stage integer matrix product (or
shift) with the same rounding points.

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
