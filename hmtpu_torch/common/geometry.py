"""Block geometry: z-scan coding order, neighbour availability and MPM
derivation helpers shared by encoder and decoder.

Capability parity with the neighbour/availability machinery of
TComDataCU.cpp (z-scan addressing, getPULeft/getPUAbove) re-expressed as
pure functions over (x, y) pixel coordinates for a uniform minimum-CU
grid — the decoder-visible rules of H.265 6.4.1 (z-scan availability).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from hmtpu_torch.common.constants import DC_IDX, PLANAR_IDX, VER_IDX


def morton(bx: int, by: int) -> int:
    """Z-scan index of a block within its CTU (bit interleave)."""
    z = 0
    for bit in range(8):
        z |= ((bx >> bit) & 1) << (2 * bit)
        z |= ((by >> bit) & 1) << (2 * bit + 1)
    return z


def coded_before(xa: int, ya: int, xb: int, yb: int, log2_ctu: int,
                 pic_w_ctus: int) -> bool:
    """True if the block containing pixel (xa, ya) is decoded before the
    block at (xb, yb), under raster CTU order + z-scan within a CTU."""
    ctu_a = (ya >> log2_ctu) * pic_w_ctus + (xa >> log2_ctu)
    ctu_b = (yb >> log2_ctu) * pic_w_ctus + (xb >> log2_ctu)
    if ctu_a != ctu_b:
        return ctu_a < ctu_b
    mask = (1 << log2_ctu) - 1
    return morton((xa & mask) >> 2, (ya & mask) >> 2) < \
        morton((xb & mask) >> 2, (yb & mask) >> 2)


def _morton_vec(bx: np.ndarray, by: np.ndarray) -> np.ndarray:
    z = np.zeros_like(bx)
    for bit in range(8):
        z |= ((bx >> bit) & 1) << (2 * bit)
        z |= ((by >> bit) & 1) << (2 * bit + 1)
    return z


@lru_cache(maxsize=1 << 16)
def ref_availability(x: int, y: int, n: int, pic_w: int, pic_h: int,
                     log2_ctu: int) -> np.ndarray:
    """Availability mask over the 4N+1 reference-sample line (layout of
    ops/intra_ref.py) for an NxN block at luma/chroma position (x, y) in
    a picture of the given size.  Coordinates and n are in the plane's
    own sample units; log2_ctu is likewise plane-local.  Cached: purely
    geometric, reused every frame.  Treat the result as read-only."""
    pic_w_ctus = (pic_w + (1 << log2_ctu) - 1) >> log2_ctu

    # sample coordinates in line layout order
    sx = np.empty(4 * n + 1, dtype=np.int64)
    sy = np.empty(4 * n + 1, dtype=np.int64)
    j = np.arange(2 * n)
    sx[: 2 * n] = x - 1            # left col, bottom..top
    sy[: 2 * n] = y + (2 * n - 1 - j)
    sx[2 * n] = x - 1              # corner
    sy[2 * n] = y - 1
    sx[2 * n + 1:] = x + j         # top row
    sy[2 * n + 1:] = y - 1

    inside = (sx >= 0) & (sy >= 0) & (sx < pic_w) & (sy < pic_h)
    sxc = np.clip(sx, 0, None)
    syc = np.clip(sy, 0, None)
    ctu_a = (syc >> log2_ctu) * pic_w_ctus + (sxc >> log2_ctu)
    ctu_b = (y >> log2_ctu) * pic_w_ctus + (x >> log2_ctu)
    mask = (1 << log2_ctu) - 1
    za = _morton_vec((sxc & mask) >> 2, (syc & mask) >> 2)
    zb = morton((x & mask) >> 2, (y & mask) >> 2)
    before = np.where(ctu_a != ctu_b, ctu_a < ctu_b, za < zb)
    return inside & before


def mpm_list(left_mode: int, above_mode: int) -> list[int]:
    """candModeList derivation (H.265 8.4.2); pass DC for unavailable
    neighbours."""
    a, b = left_mode, above_mode
    if a == b:
        if a < 2:
            return [PLANAR_IDX, DC_IDX, VER_IDX]
        return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
    lst = [a, b]
    if PLANAR_IDX not in lst:
        lst.append(PLANAR_IDX)
    elif DC_IDX not in lst:
        lst.append(DC_IDX)
    else:
        lst.append(VER_IDX)
    return lst


def encode_rem_mode(mode: int, mpms: list[int]) -> int:
    rem = mode
    for m in sorted(mpms, reverse=True):
        if mode > m:
            rem -= 1
    return rem


def decode_rem_mode(rem: int, mpms: list[int]) -> int:
    mode = rem
    for m in sorted(mpms):
        if mode >= m:
            mode += 1
    return mode
