"""Core HEVC constants (mirrors the constant surface of the reference's
CommonDef.h / TypeDef.h, e.g. MAX_CU_SIZE at CommonDef.h:221).

Everything here is a number fixed by ITU-T H.265 or by the encoder
configuration envelope we support; nothing is tuned.
"""
from enum import IntEnum

# --- block geometry -------------------------------------------------------
MAX_CU_SIZE = 64          # CTU luma size upper bound (CommonDef.h:221)
MAX_CU_DEPTH = 4          # 64 -> 8 quadtree depth range we code
MIN_CU_SIZE = 8
MIN_TU_SIZE = 4
MAX_TU_SIZE = 32
MAX_NUM_REF = 16          # CommonDef.h:125

# --- bit depth / dynamic range -------------------------------------------
MAX_TR_DYNAMIC_RANGE = 15  # Main/Main10 profile extended_precision off
QUANT_SHIFT = 14           # forward quant scale precision
IQUANT_SHIFT = 6
SCALE_BITS = 15            # transform matrix precision (2^6 * 2^... )
TRANSFORM_MATRIX_SHIFT = 6

# --- QP -------------------------------------------------------------------
MAX_QP = 51
QP_BD_OFFSET_PER_BIT = 6   # qp bd offset = 6*(bitDepth-8)

# --- slice / picture types -----------------------------------------------
class SliceType(IntEnum):
    B = 0
    P = 1
    I = 2

# NAL unit types (H.265 Table 7-1)
class NalUnitType(IntEnum):
    TRAIL_N = 0
    TRAIL_R = 1
    TSA_N = 2
    TSA_R = 3
    STSA_N = 4
    STSA_R = 5
    RADL_N = 6
    RADL_R = 7
    RASL_N = 8
    RASL_R = 9
    BLA_W_LP = 16
    BLA_W_RADL = 17
    BLA_N_LP = 18
    IDR_W_RADL = 19
    IDR_N_LP = 20
    CRA_NUT = 21
    VPS_NUT = 32
    SPS_NUT = 33
    PPS_NUT = 34
    AUD_NUT = 35
    EOS_NUT = 36
    EOB_NUT = 37
    FD_NUT = 38
    PREFIX_SEI_NUT = 39
    SUFFIX_SEI_NUT = 40

# intra prediction
PLANAR_IDX = 0
DC_IDX = 1
HOR_IDX = 10
VER_IDX = 26
NUM_INTRA_MODE = 35
DM_CHROMA_IDX = 36

# Chroma formats
class ChromaFormat(IntEnum):
    C400 = 0
    C420 = 1
    C422 = 2
    C444 = 3

# merge
MRG_MAX_NUM_CANDS = 5

# the P / B passes' per-8x8-cell state columns (`blk`): kind, merge index,
# MVD, MVP index, inter direction (bit 0 list 0, bit 1 list 1; 0 intra),
# list 0's MV and reference, CU size, luma cbf, list 1's MV and reference
(K_KIND, K_MI, K_MVDX, K_MVDY, K_MVPI, K_DIR, K_MVX, K_MVY, K_REF, K_SZ,
 K_CBFY, K_MVX1, K_MVY1, K_REF1) = range(14)

# SEI payload types we emit (H.265 Annex D)
SEI_ACTIVE_PARAMETER_SETS = 129
SEI_DECODED_PICTURE_HASH = 132


def clip3(lo, hi, x):
    return max(lo, min(hi, x))
