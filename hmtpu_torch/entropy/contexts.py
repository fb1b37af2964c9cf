"""Flat CABAC context-model layout and per-slice initialisation.

Mirrors the *capability* of the reference's ContextModel3DBuffer setup in
TEncSbac/TDecSbac (one ContextModel array per syntax element) with a
single flat numpy uint8 array of packed states and named offsets, which
keeps the hot Python/C++ entropy loop free of object indirection.

initType mapping follows ContextTables.h ordering: 0 = B, 1 = P, 2 = I.
"""
from __future__ import annotations

import numpy as np

from hmtpu_torch.common import spec_tables as st
from hmtpu_torch.common.constants import SliceType
from hmtpu_torch.entropy.cabac import init_state

# (layout name, CTX_INIT source table, offset within source, count)
_LAYOUT = [
    ("SPLIT_FLAG", "SPLIT_FLAG", 0, 3),
    ("SKIP_FLAG", "SKIP_FLAG", 0, 3),
    ("MERGE_FLAG", "MERGE_FLAG_EXT", 0, 1),
    ("MERGE_IDX", "MERGE_IDX_EXT", 0, 1),
    ("PART_SIZE", "PART_SIZE", 0, 4),
    ("PRED_MODE", "PRED_MODE", 0, 1),
    ("INTRA_PRED_MODE", "INTRA_PRED_MODE", 0, 1),
    ("CHROMA_PRED_MODE", "CHROMA_PRED_MODE", 0, 2),
    ("INTER_DIR", "INTER_DIR", 0, 5),
    ("MVD", "MVD", 0, 2),
    ("REF_PIC", "REF_PIC", 0, 2),
    ("DQP", "DQP", 0, 3),
    ("QT_CBF_LUMA", "QT_CBF", 0, 5),
    ("QT_CBF_CHROMA", "QT_CBF", 5, 5),
    ("QT_ROOT_CBF", "QT_ROOT_CBF", 0, 1),
    ("SIG_CG_FLAG", "SIG_CG_FLAG", 0, 4),
    ("SIG_FLAG", "SIG_FLAG", 0, 44),
    ("LAST_X", "LAST", 0, 15),
    ("LAST_X_C", "LAST", 15, 15),
    ("LAST_Y", "LAST", 0, 15),
    ("LAST_Y_C", "LAST", 15, 15),
    ("ONE_FLAG", "ONE_FLAG", 0, 24),
    ("ABS_FLAG", "ABS_FLAG", 0, 6),
    ("MVP_IDX", "MVP_IDX", 0, 1),
    ("TRANS_SUBDIV_FLAG", "TRANS_SUBDIV_FLAG", 0, 3),
    ("SAO_MERGE_FLAG", "SAO_MERGE_FLAG", 0, 1),
    ("SAO_TYPE_IDX", "SAO_TYPE_IDX", 0, 1),
    ("TRANSFORMSKIP_FLAG", "TRANSFORMSKIP_FLAG", 0, 2),
    ("CU_TRANSQUANT_BYPASS_FLAG", "CU_TRANSQUANT_BYPASS_FLAG", 0, 1),
]

OFF = {}
NUM_CTX = 0
for _name, _src, _soff, _cnt in _LAYOUT:
    OFF[_name] = NUM_CTX
    NUM_CTX += _cnt


def _init_type(slice_type: SliceType, cabac_init_flag: bool = False) -> int:
    if slice_type == SliceType.I:
        return 2
    if slice_type == SliceType.P:
        return 0 if cabac_init_flag else 1
    return 1 if cabac_init_flag else 0


def make_contexts(slice_type: SliceType, qp: int,
                  cabac_init_flag: bool = False) -> np.ndarray:
    """Build the packed-state context array for one slice (9.3.2.2)."""
    it = _init_type(slice_type, cabac_init_flag)
    ctx = np.zeros(NUM_CTX, dtype=np.uint8)
    pos = 0
    for name, src, soff, cnt in _LAYOUT:
        vals = st.CTX_INIT[src][it][soff:soff + cnt]
        for i, v in enumerate(vals):
            ctx[pos + i] = init_state(v, qp)
        pos += cnt
    return ctx


# --- sig_coeff_flag 4x4 position-context map (9.3.4.2.5) ------------------
CTX_IDX_MAP_4x4 = np.array(
    [0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8], dtype=np.int32)
