"""Intra prediction tables (H.265 Tables 8-5, 8-6) and the reference
filtering decision of 8.4.4.2.3, copied from hmtpu/ops/intra_ref.py.

The neighbour reference samples of an NxN block are carried as a 1-D
line of length 4N+1 laid out bottom-left -> top-right:

    ref[0 .. 2N-1]  = left column bottom-to-top  = p[-1][2N-1 .. 0]
    ref[2N]         = corner                     = p[-1][-1]
    ref[2N+1..4N]   = top row left-to-right      = p[0 .. 2N-1][-1]
"""
from __future__ import annotations

import numpy as np

# intraPredAngle, modes 2..34 (H.265 Table 8-5)
ANGLES = np.array([32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17,
                   -21, -26, -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5,
                   9, 13, 17, 21, 26, 32], dtype=np.int32)
# invAngle for angles -2..-32 (Table 8-6), indexed by mode 11..25
INV_ANGLES = {-2: -4096, -5: -1638, -9: -910, -13: -630, -17: -482,
              -21: -390, -26: -315, -32: -256}


def should_filter(mode: int, n: int, is_luma: bool) -> bool:
    """Filtering decision of 8.4.4.2.3 (planar filters via the
    minDist test since min(|0-26|,|0-10|)=10 exceeds every threshold)."""
    if not is_luma:
        return False
    if mode == 1:  # DC
        return False
    if n == 4:
        return False
    min_dist = min(abs(mode - 26), abs(mode - 10))
    thres = {8: 7, 16: 1, 32: 0}[n]
    return min_dist > thres
