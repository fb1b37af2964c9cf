"""Float32 lambda arithmetic, value for value as the reference pass
computes it.

hmtpu derives lambda, the chroma weight and the RDOQ scale inside its
jitted pass with float32 `power` and `exp2`, whose CPU build is a
polynomial approximation: 2^((qp-12)/3) and even 2^k for integer k come
out a few ulps away from the correctly rounded value, and those ulps
move RD decisions.  The port does not recompute them; it reads them
from these tables (tests/test_torch_ops.py checks every entry against
the reference).  Everything after the table lookup is IEEE float32
multiply, divide and sqrt, which round the same on every device, and
is done here on the host so that the card and the CPU start from the
same four numbers.
"""
from __future__ import annotations

import numpy as np


def _f32(*hexes: str) -> np.ndarray:
    return np.array([float.fromhex(x) for x in hexes], np.float32)


# power(2, (qp - 12) / 3) for qp = 0..51
_POW2_QP = _f32(
    "0x1.0000000000000p-4", "0x1.428a2e0000000p-4", "0x1.965fe80000000p-4",
    "0x1.0000000000000p-3", "0x1.428a2e0000000p-3", "0x1.965fe80000000p-3",
    "0x1.0000000000000p-2", "0x1.428a2e0000000p-2", "0x1.965fea0000000p-2",
    "0x1.0000000000000p-1", "0x1.428a300000000p-1", "0x1.965fea0000000p-1",
    "0x1.0000000000000p+0", "0x1.428a300000000p+0", "0x1.965fea0000000p+0",
    "0x1.0000000000000p+1", "0x1.428a300000000p+1", "0x1.965fec0000000p+1",
    "0x1.0000000000000p+2", "0x1.428a320000000p+2", "0x1.965fec0000000p+2",
    "0x1.0000000000000p+3", "0x1.428a320000000p+3", "0x1.965fec0000000p+3",
    "0x1.0000000000000p+4", "0x1.428a320000000p+4", "0x1.965ff00000000p+4",
    "0x1.0000000000000p+5", "0x1.428a320000000p+5", "0x1.965ff00000000p+5",
    "0x1.0000000000000p+6", "0x1.428a320000000p+6", "0x1.965ff00000000p+6",
    "0x1.0000000000000p+7", "0x1.428a320000000p+7", "0x1.965ff00000000p+7",
    "0x1.0000000000000p+8", "0x1.428a380000000p+8", "0x1.965ff00000000p+8",
    "0x1.0000000000000p+9", "0x1.428a380000000p+9", "0x1.965ff00000000p+9",
    "0x1.0000000000000p+10", "0x1.428a380000000p+10",
    "0x1.965ff00000000p+10", "0x1.0000000000000p+11",
    "0x1.428a380000000p+11", "0x1.965ff00000000p+11",
    "0x1.0000000000000p+12", "0x1.428a380000000p+12",
    "0x1.965ff00000000p+12", "0x1.0000000000000p+13",)

# exp2(d / 3) for d = -24..24
_EXP2_THIRD = _f32(
    "0x1.0000000000000p-8", "0x1.428a300000000p-8", "0x1.965fea0000000p-8",
    "0x1.0000000000000p-7", "0x1.428a300000000p-7", "0x1.965fea0000000p-7",
    "0x1.0000000000000p-6", "0x1.428a300000000p-6", "0x1.965fea0000000p-6",
    "0x1.0000000000000p-5", "0x1.428a300000000p-5", "0x1.965fea0000000p-5",
    "0x1.0000000000000p-4", "0x1.428a300000000p-4", "0x1.965fea0000000p-4",
    "0x1.0000000000000p-3", "0x1.428a300000000p-3", "0x1.965fea0000000p-3",
    "0x1.0000000000000p-2", "0x1.428a300000000p-2", "0x1.965fea0000000p-2",
    "0x1.0000000000000p-1", "0x1.428a300000000p-1", "0x1.965fea0000000p-1",
    "0x1.0000000000000p+0", "0x1.428a300000000p+0", "0x1.965fea0000000p+0",
    "0x1.0000000000000p+1", "0x1.428a300000000p+1", "0x1.965fea0000000p+1",
    "0x1.0000000000000p+2", "0x1.428a300000000p+2", "0x1.965fea0000000p+2",
    "0x1.0000000000000p+3", "0x1.428a300000000p+3", "0x1.965fea0000000p+3",
    "0x1.0000000000000p+4", "0x1.428a300000000p+4", "0x1.965fea0000000p+4",
    "0x1.0000000000000p+5", "0x1.428a300000000p+5", "0x1.965fea0000000p+5",
    "0x1.0000000000000p+6", "0x1.428a300000000p+6", "0x1.965fea0000000p+6",
    "0x1.0000000000000p+7", "0x1.428a300000000p+7", "0x1.965fea0000000p+7",
    "0x1.0000000000000p+8",)

# exp2(k) for k = 0..47 (the RDOQ quantiser step 2^qbits)
_EXP2_INT = _f32(
    "0x1.0000000000000p+0", "0x1.0000000000000p+1", "0x1.0000000000000p+2",
    "0x1.0000000000000p+3", "0x1.0000000000000p+4", "0x1.0000000000000p+5",
    "0x1.0000000000000p+6", "0x1.0000000000000p+7", "0x1.0000000000000p+8",
    "0x1.0000000000000p+9", "0x1.0000000000000p+10", "0x1.0000000000000p+11",
    "0x1.0000000000000p+12", "0x1.0000080000000p+13",
    "0x1.0000000000000p+14", "0x1.fffff00000000p+14",
    "0x1.0000000000000p+16", "0x1.0000080000000p+17",
    "0x1.0000000000000p+18", "0x1.fffff20000000p+18",
    "0x1.0000000000000p+20", "0x1.0000080000000p+21",
    "0x1.0000000000000p+22", "0x1.fffff20000000p+22",
    "0x1.0000000000000p+24", "0x1.0000080000000p+25",
    "0x1.0000100000000p+26", "0x1.fffff20000000p+26",
    "0x1.0000000000000p+28", "0x1.0000080000000p+29",
    "0x1.ffffe20000000p+29", "0x1.fffff20000000p+30",
    "0x1.0000020000000p+32", "0x1.00000a0000000p+33",
    "0x1.0000120000000p+34", "0x1.fffff20000000p+34",
    "0x1.0000020000000p+36", "0x1.00000a0000000p+37",
    "0x1.ffffe20000000p+37", "0x1.fffff20000000p+38",
    "0x1.0000020000000p+40", "0x1.00000a0000000p+41",
    "0x1.0000120000000p+42", "0x1.fffff20000000p+42",
    "0x1.0000020000000p+44", "0x1.00000a0000000p+45",
    "0x1.ffffe20000000p+45", "0x1.00001a0000000p+47",)


def pow2_qp(qp: int) -> np.float32:
    return _POW2_QP[int(qp)]


def exp2_int(k: int) -> np.float32:
    return _EXP2_INT[int(k)]


def frame_lambdas(qp: int, qpc: int, qp_factor: float):
    """(lam, sqrt(lam), chroma weight, lam / chroma weight), float32, in
    the reference's order: lam = f32(qp_factor) * 2^((qp-12)/3) and
    wchroma = 2^((qp - qpc) / 3).  The reference's compiler rewrites
    lam / exp2(x) as lam * exp2(-x), so the chroma lambda is that
    product, not the quotient (they differ by an ulp for some QPs)."""
    lam = np.float32(qp_factor) * pow2_qp(qp)
    d = int(qp) - int(qpc)
    return lam, np.sqrt(lam), _EXP2_THIRD[d + 24], lam * _EXP2_THIRD[24 - d]
