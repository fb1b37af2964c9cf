"""Coefficient scan orders (H.265 6.5.3/6.5.4), generated programmatically.

Parity with the reference's ScanGenerator (TComRom.cpp:92-168), but
emitted as flat numpy index arrays ready for vectorised gather: for each
(log2W, scanIdx) we precompute the raster indices of coefficients in
coded-scan order, grouped in 4x4 coefficient groups.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

SCAN_DIAG = 0
SCAN_HOR = 1
SCAN_VER = 2


def _diag_scan(w: int, h: int) -> list[tuple[int, int]]:
    """Up-right diagonal scan: (x, y) pairs in scan order."""
    out = []
    x = y = 0
    while True:
        while y >= 0:
            if x < w and y < h:
                out.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
        if len(out) == w * h:
            return out


def _hor_scan(w: int, h: int) -> list[tuple[int, int]]:
    return [(x, y) for y in range(h) for x in range(w)]


def _ver_scan(w: int, h: int) -> list[tuple[int, int]]:
    return [(x, y) for x in range(w) for y in range(h)]


_SCANS = {SCAN_DIAG: _diag_scan, SCAN_HOR: _hor_scan, SCAN_VER: _ver_scan}


@lru_cache(maxsize=None)
def scan_order(log2_size: int, scan_idx: int) -> np.ndarray:
    """Raster indices of an NxN TB's coefficients in scan order, grouped
    by 4x4 coefficient groups (scan over CGs, then within-CG scan, both
    with the same pattern).  Shape: (numCG, 16)."""
    size = 1 << log2_size
    if size == 4:
        cg_positions = [(0, 0)]
    else:
        cgs = size >> 2
        cg_positions = _SCANS[scan_idx](cgs, cgs)
    within = _SCANS[scan_idx](4, 4)
    out = np.empty((len(cg_positions), 16), dtype=np.int32)
    for ci, (cgx, cgy) in enumerate(cg_positions):
        for pi, (px, py) in enumerate(within):
            x = (cgx << 2) + px
            y = (cgy << 2) + py
            out[ci, pi] = y * size + x
    return out


@lru_cache(maxsize=None)
def cg_scan_order(log2_size: int, scan_idx: int) -> np.ndarray:
    """Raster CG indices in scan order for an NxN TB."""
    size = 1 << log2_size
    if size == 4:
        return np.zeros(1, dtype=np.int32)
    cgs = size >> 2
    pos = _SCANS[scan_idx](cgs, cgs)
    return np.array([y * cgs + x for x, y in pos], dtype=np.int32)


def intra_scan_idx(intra_mode: int, log2_size: int, is_luma: bool) -> int:
    """Mode-dependent coefficient scanning (H.265 7.4.9.11): hor/ver
    scans for near-vertical/near-horizontal intra modes on 4x4 and 8x8
    luma TBs (and 4x4 chroma in 4:2:0)."""
    if log2_size > 3 or (not is_luma and log2_size > 2):
        return SCAN_DIAG
    if 6 <= intra_mode <= 14:
        return SCAN_VER
    if 22 <= intra_mode <= 30:
        return SCAN_HOR
    return SCAN_DIAG
