"""The parts of hmtpu/encoder/intra_rdo.py that the device I pass uses:
the rough-mode-decision mode bits `_MODE_BITS`, the 8x8-Hadamard SATD
`_satd` :78 and the leaf record `LeafDecision` :47.

The Hadamard transforms are written as butterflies (H_8 = H_2 x H_2 x
H_2), which keeps them in exact integer arithmetic on every device:
PyTorch has no integer matrix product on CUDA.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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
