"""P-slice encoder state and decision record: the part of
hmtpu/encoder/pframe.py (`PuDec` :57, `PFrameEncoder.__init__` :117)
that the device P encoder (encoder/pframe_dev.py) inherits.

The host-loop encoder (`analyze` :170, `_encode_block` :303) and its
Python slice walk (`_entropy_pass` :535) are not ported: the port runs
the device wavefront pass only (`wavefront=False` raises) and writes P
slices with the native CABAC engine (native/entropy.cpp).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hmtpu_torch.common.params import Pps, Sps


@dataclass
class PuDec:
    kind: str                      # 'skip' | 'merge' | 'amvp' | 'intra'
    log2: int = 3                  # CU size (8x8 .. 64x64)
    merge_idx: int = 0
    mv: tuple = (0, 0)             # final quarter-pel MV (L0)
    mvd: tuple = (0, 0)
    mvp_idx: int = 0
    ref_idx: int = 0
    intra_mode: int = -1
    # B slices (AMVP): 1 = L0, 2 = L1, 3 = BI; L1 motion fields
    inter_dir: int = 1
    mv_l1: tuple = (0, 0)
    mvd_l1: tuple = (0, 0)
    mvp_idx_l1: int = 0
    ref_idx_l1: int = 0
    lev_y: np.ndarray | None = None
    lev_cb: np.ndarray | None = None
    lev_cr: np.ndarray | None = None
    # transform_skip_flag per 4x4 chroma TB (PPS TransformSkip on)
    ts_cb: int = 0
    ts_cr: int = 0

    @property
    def coded(self) -> bool:
        return any(l is not None and l.any()
                   for l in (self.lev_y, self.lev_cb, self.lev_cr))


class PFrameEncoder:
    """One P slice: its parameter sets and search options."""

    def __init__(self, sps: Sps, pps: Pps, subpel: str = "nn",
                 nn_params=None, search_range: int = 16):
        self.sps, self.pps = sps, pps
        self.bd = sps.bit_depth_luma
        self.subpel = subpel
        self.nn_params = nn_params
        self.search_range = search_range
        self._sdh = bool(pps.sign_data_hiding)
