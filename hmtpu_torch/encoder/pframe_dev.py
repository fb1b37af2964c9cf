"""The residual coder shared by the device passes: the port of
`_intra_scan_sel` :179 and `_code` :188 of hmtpu/encoder/pframe_dev.py,
the two pieces the I pass (encoder/iframe_dev.py) imports from there.

The P-slice pass itself (ME, NN-FME, MC, merge/AMVP and its wavefront)
comes with the low-delay-P slice of the port.
"""
from __future__ import annotations

import torch

from hmtpu_torch.ops.quant import dequantize_t, quantize_t
from hmtpu_torch.ops.ratebits import tb_bits
from hmtpu_torch.ops.rdoq import rdoq_tb
from hmtpu_torch.ops.transform import forward_transform, inverse_transform


def _intra_scan_sel(m):
    """Vectorised intra_scan_idx (7.4.9.11) for the sizes where the
    coding scan is mode-dependent (4x4/8x8 luma, 4x4 chroma):
    2=vertical for modes 6-14, 1=horizontal for 22-30, else diag."""
    return torch.where((m >= 6) & (m <= 14), 2,
                       torch.where((m >= 22) & (m <= 30), 1, 0)) \
        .to(torch.int32)


def _code(org, pred, qp: int, log2: int, bd: int, lam=None, cbflat=None,
          is_luma=True, dw=None, sdh: bool = False, scan_sel=None,
          use_dst: bool = False, rdoq: bool = True):
    """transform -> quant (RDOQ when lam is given) -> dequant -> inverse
    -> clip; returns (lev, rec, sse, bits).

    Bits are the CABAC-state-aware estimate of ops/ratebits.py; 0.0 for
    an all-zero TB (cbf priced at CU level).  dw is HM's chroma
    distortion weight applied to the returned SSE (chroma callers pass
    lam = lambda/dw).  lam and dw are float32 0-d tensors."""
    n = 1 << log2
    resi = org - pred
    coef = forward_transform(resi, n, bd, use_dst=use_dst)
    if lam is not None:
        lev = rdoq_tb(coef, qp, log2, bd, lam, cbflat, is_luma,
                      sdh=sdh, scan_sel=scan_sel, trellis=rdoq)
    else:
        lev = quantize_t(coef, qp, log2, bd, False)
    deq = dequantize_t(lev, qp, log2, bd)
    r = inverse_transform(deq, n, bd, use_dst=use_dst)
    rec = torch.clamp(pred + r, 0, (1 << bd) - 1)
    sse = ((org - rec) ** 2).sum((-1, -2)).to(torch.float32)
    if dw is not None:
        sse = sse * dw          # HM chroma distortion weight
    return lev, rec, sse, tb_bits(lev, cbflat, log2, is_luma, 0, sdh)
