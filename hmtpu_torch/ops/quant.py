"""Scalar quantisation / inverse quantisation (H.265 8.6.3), bit-exact
with the reference's TComTrQuant::xQuant (:1126) / xDeQuant paths with
flat (default) scaling lists.

Batched over TU stacks: all shapes (..., N, N) int32.  The port of
hmtpu/ops/quant.py `quantize_t` :78 and `dequantize_t` :91; qp is a
host integer here (one value per frame), so the shift cases resolve on
the host.  RDOQ lives in ops/rdoq.py.  On a CUDA tensor both launch
K10 (csrc/rdoq.cu, through ops/rdoq.py `k10`); on a CPU tensor they run
the plain versions here.
"""
from __future__ import annotations

import torch

from hmtpu_torch.common import spec_tables as st

QUANT_SHIFT = 14
IQUANT_SHIFT = 6
MAX_TR_DYNAMIC_RANGE = 15
COEFF_MIN = -(1 << 15)
COEFF_MAX = (1 << 15) - 1

_QUANT_SCALES = tuple(int(x) for x in st.QUANT_SCALES)
_INV_QUANT_SCALES = tuple(int(x) for x in st.INV_QUANT_SCALES)


def transform_shift(log2_size: int, bit_depth: int) -> int:
    return MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size


def quantize_t(coeff, qp: int, log2_size: int, bit_depth: int = 8,
               is_intra: bool = True):
    """Forward quant with HM's deadzone offsets (171/512 intra, 85/512
    inter); Qp' = qp + 6*(bd-8) (8.6.1)."""
    if coeff.is_cuda:
        from hmtpu_torch.ops.rdoq import _quant_params, k10

        qbits = _quant_params(qp, log2_size, bit_depth)[0]
        return k10(coeff, log2_size, True, qp=qp, bd=bit_depth,
                   add=(171 if is_intra else 85) << (qbits - 9))[0]
    return quantize_t_plain(coeff, qp, log2_size, bit_depth, is_intra)


def quantize_t_plain(coeff, qp: int, log2_size: int, bit_depth: int = 8,
                     is_intra: bool = True):
    qp = int(qp) + 6 * (bit_depth - 8)
    per, rem = qp // 6, qp % 6
    qbits = QUANT_SHIFT + per + transform_shift(log2_size, bit_depth)
    add = (171 if is_intra else 85) << (qbits - 9)
    # int32 safe: |coeff| <= 2^15, scale < 2^15 -> product < 2^30
    mag = (coeff.abs() * _QUANT_SCALES[rem] + add) >> qbits
    mag = torch.clamp(mag, max=COEFF_MAX).to(torch.int32)
    return torch.where(coeff < 0, -mag, mag)


def dequant_params(qp: int, log2_size: int, bit_depth: int = 8):
    """(inverse scale, right shift) of the dequantiser; a negative shift
    is a left shift."""
    qp = int(qp) + 6 * (bit_depth - 8)
    per, rem = qp // 6, qp % 6
    shift = IQUANT_SHIFT - transform_shift(log2_size, bit_depth)
    return _INV_QUANT_SCALES[rem], shift - per


def dequantize_t(level, qp: int, log2_size: int, bit_depth: int = 8):
    """Inverse quant (flat scaling list), spec 8.6.3 clip to 16-bit."""
    if level.is_cuda:
        from hmtpu_torch.ops.rdoq import k10

        return k10(level, log2_size, True, qp=qp, bd=bit_depth,
                   lev_in=True, want=("deq",))[0]
    return dequantize_t_plain(level, qp, log2_size, bit_depth)


def dequantize_t_plain(level, qp: int, log2_size: int, bit_depth: int = 8):
    iscale, s = dequant_params(qp, log2_size, bit_depth)
    prod = level * iscale  # |lv| <= 2^15, g <= 72
    if s > 0:
        out = (prod + (1 << (s - 1))) >> s
    else:
        # bits shifted out are zero; the pre-clamp keeps int32 while
        # preserving the final 16-bit clip
        out = torch.clamp(prod, -(1 << 26), 1 << 26) << (-s)
    return torch.clamp(out, COEFF_MIN, COEFF_MAX).to(torch.int32)
