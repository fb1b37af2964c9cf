"""ITU-T H.265 (HEVC) normative constant tables.

Every number in this module is fixed by the standard (or, for the CABAC
state machine, by Rec. H.265 Tables 9-46/9-47) and is identical in every
conforming implementation.  Matrices are *constructed* from the spec's
distinct coefficient lists rather than written out, and each
construction is unit-tested against independent properties
(orthogonality, strided-subsampling, known rows).

Reference-parity pointers: TComRom.cpp:457-487 (transform matrices),
TComRom.cpp:354-361 (quant scales), TComCABACTables.cpp:43 (LPS table),
ContextModel.cpp:67-91 (state transitions), ContextTables.h:165+
(context initialisation values, Tables 9-5..9-32).
"""
import numpy as np

# ---------------------------------------------------------------------------
# Core transform matrices (H.265 8.6.4.2).
# Distinct coefficients of the order-32 integer DCT, indexed by angle
# k*pi/64; entries deviate from round(64*sqrt(2,)*cos(.)) where the
# standard hand-tuned them, so the list itself is normative.
_DCT_COEF = {0: 64, 16: 64}
for _k, _v in zip(range(1, 32, 2),
                  (90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4)):
    _DCT_COEF[_k] = _v
for _k, _v in zip(range(2, 31, 4), (90, 87, 80, 70, 57, 43, 25, 9)):
    _DCT_COEF[_k] = _v
for _k, _v in zip(range(4, 29, 8), (89, 75, 50, 18)):
    _DCT_COEF[_k] = _v
_DCT_COEF[8], _DCT_COEF[24] = 83, 36


def _build_dct32() -> np.ndarray:
    m = np.zeros((32, 32), dtype=np.int32)
    for i in range(32,):
        for j in range(32,):
            if i == 0:
                m[i, j] = 64
                continue
            a = (i * (2 * j + 1)) % 128
            if a > 64:
                a = 128 - a
            m[i, j] = _DCT_COEF[a] if a <= 32 else -_DCT_COEF[64 - a]
    return m


DCT32 = _build_dct32()
DCT16 = np.ascontiguousarray(DCT32[::2, :16])
DCT8 = np.ascontiguousarray(DCT32[::4, :8])
DCT4 = np.ascontiguousarray(DCT32[::8, :4])
DCT = {4: DCT4, 8: DCT8, 16: DCT16, 32: DCT32}

# 4x4 DST-VII for intra luma 4x4 TUs (H.265 8.6.4.1)
DST4 = np.array([
    (29, 55, 74, 84),
    (74, 74, 0, -74),
    (84, -29, -74, 55),
    (55, -84, 74, -29),
], dtype=np.int32)

# ---------------------------------------------------------------------------
# Quantisation (H.265 8.6.3): f[qp%6] forward scale, g[qp%6] inverse scale
QUANT_SCALES = np.array((26214, 23302, 20560, 18396, 16384, 14564), dtype=np.int64)
INV_QUANT_SCALES = np.array((40, 45, 51, 57, 64, 72), dtype=np.int64)


CHROMA_QP_TABLE = None  # built below


def chroma_qp_from_luma(qp: int, chroma_format_420: bool = True) -> int:
    """H.265 Table 8-10 chroma QP mapping (4:2:0); identity-with-clip
    otherwise."""
    qp = max(0, qp)
    if not chroma_format_420:
        return min(qp, 51)
    if qp < 30:
        return qp
    if qp > 43:
        return qp - 6
    return (29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37)[qp - 30]


# ---------------------------------------------------------------------------
# CABAC arithmetic-coder state machine (H.265 9.3.4.3, Tables 9-46/9-47)

RANGE_TAB_LPS = np.array((
    (128, 176, 208, 240),
    (128, 167, 197, 227),
    (128, 158, 187, 216),
    (123, 150, 178, 205),
    (116, 142, 169, 195),
    (111, 135, 160, 185),
    (105, 128, 152, 175),
    (100, 122, 144, 166),
    (95, 116, 137, 158),
    (90, 110, 130, 150),
    (85, 104, 123, 142),
    (81, 99, 117, 135),
    (77, 94, 111, 128),
    (73, 89, 105, 122),
    (69, 85, 100, 116),
    (66, 80, 95, 110),
    (62, 76, 90, 104),
    (59, 72, 86, 99),
    (56, 69, 81, 94),
    (53, 65, 77, 89),
    (51, 62, 73, 85),
    (48, 59, 69, 80),
    (46, 56, 66, 76),
    (43, 53, 63, 72),
    (41, 50, 59, 69),
    (39, 48, 56, 65),
    (37, 45, 54, 62),
    (35, 43, 51, 59),
    (33, 41, 48, 56),
    (32, 39, 46, 53),
    (30, 37, 43, 50),
    (29, 35, 41, 48),
    (27, 33, 39, 45),
    (26, 31, 37, 43),
    (24, 30, 35, 41),
    (23, 28, 33, 39),
    (22, 27, 32, 37),
    (21, 26, 30, 35),
    (20, 24, 29, 33),
    (19, 23, 27, 31),
    (18, 22, 26, 30),
    (17, 21, 25, 28),
    (16, 20, 23, 27),
    (15, 19, 22, 25),
    (14, 18, 21, 24),
    (14, 17, 20, 23),
    (13, 16, 19, 22),
    (12, 15, 18, 21),
    (12, 14, 17, 20),
    (11, 14, 16, 19),
    (11, 13, 15, 18),
    (10, 12, 15, 17),
    (10, 12, 14, 16),
    (9, 11, 13, 15),
    (9, 11, 12, 14),
    (8, 10, 12, 14),
    (8, 9, 11, 13),
    (7, 9, 11, 12),
    (7, 9, 10, 12),
    (7, 8, 10, 11),
    (6, 8, 9, 11),
    (6, 7, 9, 10),
    (6, 7, 8, 9),
    (2, 2, 2, 2),
), dtype=np.uint8)

TRANS_IDX_LPS = np.array((0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12, 13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24, 24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33, 33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63), dtype=np.uint8)
TRANS_IDX_MPS = np.array([min(s + 1, 62) for s in range(63,)] + [63], dtype=np.uint8)

# renorm shift amount by (range>>3)&0x1F  (ContextModel renorm table);
# closed form: 6 - bit_length(i), 6 at i==0
RENORM_TABLE = np.array([6] + [6 - int(i).bit_length() for i in range(1, 32)],
                        dtype=np.uint8)

# ---------------------------------------------------------------------------
# Context-model initialisation values (Tables 9-5..9-32), indexed by
# initType (0: B, 1: P, 2: I as in HM's ContextTables.h slice ordering).
CNU = 154  # "context not used" placeholder
CTX_INIT = {

    'CU_TRANSQUANT_BYPASS_FLAG': (
        (154,),
        (154,),
        (154,),
    ),
    'SPLIT_FLAG': (
        (107, 139, 126),
        (107, 139, 126),
        (139, 141, 157),
    ),
    'SKIP_FLAG': (
        (197, 185, 201),
        (197, 185, 201),
        (154, 154, 154),
    ),
    'MERGE_FLAG_EXT': (
        (154,),
        (110,),
        (154,),
    ),
    'MERGE_IDX_EXT': (
        (137,),
        (122,),
        (154,),
    ),
    'PART_SIZE': (
        (154, 139, 154, 154),
        (154, 139, 154, 154),
        (184, 154, 154, 154),
    ),
    'PRED_MODE': (
        (134,),
        (149,),
        (154,),
    ),
    'INTRA_PRED_MODE': (
        (183,),
        (154,),
        (184,),
    ),
    'CHROMA_PRED_MODE': (
        (152, 139),
        (152, 139),
        (63, 139),
    ),
    'INTER_DIR': (
        (95, 79, 63, 31, 31),
        (95, 79, 63, 31, 31),
        (154, 154, 154, 154, 154),
    ),
    'MVD': (
        (169, 198),
        (140, 198),
        (154, 154),
    ),
    'REF_PIC': (
        (153, 153),
        (153, 153),
        (154, 154),
    ),
    'DQP': (
        (154, 154, 154),
        (154, 154, 154),
        (154, 154, 154),
    ),
    'CHROMA_QP_ADJ_FLAG': (
        (154,),
        (154,),
        (154,),
    ),
    'CHROMA_QP_ADJ_IDC': (
        (154,),
        (154,),
        (154,),
    ),
    'QT_CBF': (
        (153, 111, 154, 154, 154, 149, 92, 167, 154, 154),
        (153, 111, 154, 154, 154, 149, 107, 167, 154, 154),
        (111, 141, 154, 154, 154, 94, 138, 182, 154, 154),
    ),
    'QT_ROOT_CBF': (
        (79,),
        (79,),
        (154,),
    ),
    'LAST': (
        (125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79, 108, 123, 93, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154),
        (125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94, 108, 123, 108, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154),
        (110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79, 108, 123, 63, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154),
    ),
    'SIG_CG_FLAG': (
        (121, 140, 61, 154),
        (121, 140, 61, 154),
        (91, 171, 134, 141),
    ),
    'SIG_FLAG': (
        (170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 140, 170, 153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140, 151, 183, 140, 140),
        (155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 140, 170, 153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140, 151, 183, 140, 140),
        (111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 141, 140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139, 111, 111),
    ),
    'ONE_FLAG': (
        (154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 122, 169, 208, 166, 167, 154, 152, 167, 182),
        (154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 137, 169, 194, 166, 167, 154, 167, 137, 182),
        (140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107, 122, 152, 140, 179, 166, 182, 140, 227, 122, 197),
    ),
    'ABS_FLAG': (
        (107, 167, 91, 107, 107, 167),
        (107, 167, 91, 122, 107, 167),
        (138, 153, 136, 167, 152, 152),
    ),
    'MVP_IDX': (
        (168,),
        (168,),
        (154,),
    ),
    'SAO_MERGE_FLAG': (
        (153,),
        (153,),
        (153,),
    ),
    'SAO_TYPE_IDX': (
        (160,),
        (185,),
        (200,),
    ),
    'TRANS_SUBDIV_FLAG': (
        (224, 167, 122),
        (124, 138, 94),
        (153, 138, 138),
    ),
    'TRANSFORMSKIP_FLAG': (
        (139, 139),
        (139, 139),
        (139, 139),
    ),
    'EXPLICIT_RDPCM_FLAG': (
        (139, 139),
        (139, 139),
        (154, 154),
    ),
    'EXPLICIT_RDPCM_DIR': (
        (139, 139),
        (139, 139),
        (154, 154),
    ),
    'CROSS_COMPONENT_PREDICTION': (
        (154, 154, 154, 154, 154, 154, 154, 154, 154, 154),
        (154, 154, 154, 154, 154, 154, 154, 154, 154, 154),
        (154, 154, 154, 154, 154, 154, 154, 154, 154, 154),
    ),
}

# encoder fast-RMD candidate counts by log2(size) (TComRom.cpp:547+)
INTRA_NUM_MODES_FAST = (3, 2, 2, 8, 4, 4, 8, 8, 8, 3)  # indexed by CU depth (64..4)


import numpy as _np

CHROMA_QP_TABLE = _np.asarray(
    [chroma_qp_from_luma(q) for q in range(64)], _np.int32)
