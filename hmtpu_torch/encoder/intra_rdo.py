"""The parts of hmtpu/encoder/intra_rdo.py that the device passes use:
the rough-mode-decision mode bits `_MODE_BITS`, the 8x8-Hadamard SATD
`_satd` :78 and the leaf record `LeafDecision` :47; and the rough mode
decision itself (`rmd`, hmtpu/encoder/iframe_dev.py:133-175 with
`_satd4` :94), which the I pass and the P pass's open-loop intra mode
share.

`rmd` launches the fused kernel K22 (csrc/i_rmd.cu) on CUDA tensors and
runs `rmd_plain` on CPU ones.  The Hadamard transforms of the plain
version are written as butterflies (H_8 = H_2 x H_2 x H_2), which keeps
them in exact integer arithmetic on every device: PyTorch has no integer
matrix product on CUDA.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hmtpu_torch import kernels
from hmtpu_torch.ops.intra_pred import (
    filter_reference_batched,
    predict_all_modes,
)

SIZES = (8, 16, 32)

_MODE_BITS = np.full(35, 5.0, dtype=np.float32)
_MODE_BITS[0] = _MODE_BITS[1] = 2.5
_MODE_BITS[10] = _MODE_BITS[26] = 3.5


@dataclass
class LeafDecision:
    """One chosen intra CU (leaf of the coding quadtree).

    modes4: for an 8x8 CU with part NxN, the four 4x4 PU luma modes
    in z-order (lev_y then holds the four 4x4 TBs in their quadrant
    positions); None = part 2Nx2N."""
    mode: int
    log2: int
    lev_y: np.ndarray
    lev_cb: np.ndarray
    lev_cr: np.ndarray
    modes4: tuple | None = None
    # transform_skip_flag per 4x4 TB: four NxN luma PU flags in z-order
    # + the 4x4 chroma TB pair of an 8x8 CU; all zero unless the PPS
    # enables transform skip
    ts_y4: tuple = (0, 0, 0, 0)
    ts_cb: int = 0
    ts_cr: int = 0


def _butterfly(x, dim: int):
    """Unnormalised Walsh-Hadamard transform (Sylvester order) of a
    power-of-two axis, as add/subtract stages."""
    n = x.shape[dim]
    x = x.movedim(dim, -1)
    lead = x.shape[:-1]
    h = 1
    while h < n:
        y = x.reshape(lead + (n // (2 * h), 2, h))
        a, b = y[..., 0, :], y[..., 1, :]
        x = torch.stack([a + b, a - b], -2).reshape(lead + (n,))
        h *= 2
    return x.movedim(-1, dim)


def hadamard2d(resi):
    """H r H^T over the last two axes (H symmetric Sylvester)."""
    return _butterfly(_butterfly(resi, -1), -2)


def _satd(resi):
    """(..., N, N) -> (...,) 8x8-Hadamard SATD (HM TComRdCost.cpp:303
    xCalcHADs8x8 semantics: per-tile (sum|coef| + 2) >> 2)."""
    n = resi.shape[-1]
    t = n // 8
    r = resi.reshape(resi.shape[:-2] + (t, 8, t, 8)).transpose(-3, -2)
    per_tile = (hadamard2d(r).abs().sum((-1, -2)) + 2) >> 2
    return per_tile.sum((-1, -2))


def _satd4(resi):
    """4x4 Hadamard SATD (xCalcHADs4x4 semantics, heuristic use)."""
    return (hadamard2d(resi).abs().sum((-1, -2)) + 1) >> 1


def _blockify(plane, n):
    h, w = plane.shape
    return plane.reshape(h // n, n, w // n, n).transpose(1, 2) \
        .reshape(-1, n, n)


def rmd(plane, gmap, n: int, k: int, *, bd: int, lam_sqrt, sis: bool):
    """Open-loop rough mode decision: the k best intra modes (ties to the
    lower mode) of every n x n block of `plane` ((H, W) int32) by SATD +
    sqrt(lambda) x flat mode bits, from source-sample reference lines.
    gmap = (sub (P, 4n+1), none (P,)) is the block size's substituted
    gather (search/wavefront.py static_ref_gather), int32 as
    iframe_dev._dev_static holds it; lam_sqrt a host float32; sis the
    strong 32x32 smoothing.  (P, k) int32: K22 on CUDA tensors, the plain
    version on CPU ones."""
    if not plane.is_cuda:
        return rmd_plain(plane, gmap, n, k, bd=bd, lam_sqrt=lam_sqrt, sis=sis)
    sub, none = gmap
    if any(t.dtype != torch.int32 or not t.is_contiguous() for t in gmap):
        raise ValueError("rmd: the gather maps must be contiguous int32 "
                         "(iframe_dev._dev_static)")
    h, w = plane.shape
    nb = (h // n) * (w // n)
    if tuple(sub.shape) != (nb, 4 * n + 1) or tuple(none.shape) != (nb,):
        raise ValueError(f"rmd: gather maps {tuple(sub.shape)} / "
                         f"{tuple(none.shape)} for {nb} blocks of {n}")
    out = torch.empty((nb, k), dtype=torch.int32, device=plane.device)
    if nb:
        kernels.launch("i_rmd", "hm_i_rmd", plane.to(torch.int32).contiguous(),
                       sub, none, out, nb, w, n, bd, int(bool(sis)), k,
                       float(np.float32(lam_sqrt)))
    return out


def rmd_plain(plane, gmap, n: int, k: int, *, bd: int, lam_sqrt, sis: bool):
    """The plain version of K22: all 35 modes predicted, their SATD, a
    stable sort of SATD + lam_sqrt x mode bits."""
    sub, none = gmap
    dev = plane.device
    oref = torch.where(none.bool()[:, None], 1 << (bd - 1),
                       plane.reshape(-1)[sub.long()])
    oref_f = filter_reference_batched(oref, n, bd, strong=sis)
    preds = predict_all_modes(oref, oref_f, n, True, bd)
    dist = (_satd4 if n == 4 else _satd)(_blockify(plane, n)[:, None]
                                         - preds)
    mb = torch.as_tensor(_MODE_BITS, device=dev)
    ls = torch.as_tensor(np.float32(lam_sqrt), device=dev)
    rd = dist.to(torch.float32) + ls * mb[None]
    return torch.sort(rd, dim=1, stable=True).indices[:, :k] \
        .to(torch.int32)                                   # (P, k)
