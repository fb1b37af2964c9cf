"""Seeded inputs of K1's level forms, shared by the CPU tests of their
lane code (tests/test_torch_code_lanes.py) and the card's tests
(tests/test_torch_gpu.py, which imports nothing of JAX)."""
import numpy as np


def planes(rng, m, sizes, bd):
    """org, pred, deq and lev of each plane: the first TBs at the
    residual's extremes (+-(2^bd - 1)) and the coefficients' (-2^15,
    2^15 - 1), one all-zero TB, the rest random with sparse levels."""
    vmax = (1 << bd) - 1
    out = []
    for n in sizes:
        org = rng.randint(0, vmax + 1, (m, n, n)).astype(np.int32)
        pred = np.clip(org + rng.randint(-60, 61, (m, n, n)), 0,
                       vmax).astype(np.int32)
        org[0], pred[0] = vmax, 0
        org[1 % m], pred[1 % m] = 0, vmax
        lev = (rng.randint(-40, 41, (m, n, n))
               * (rng.rand(m, n, n) < 0.15)).astype(np.int32)
        deq = np.clip(lev * rng.randint(20, 900, (m, 1, 1)), -(1 << 15),
                      (1 << 15) - 1).astype(np.int32)
        deq[0, 0, :] = (1 << 15) - 1
        deq[0, 1, :] = -(1 << 15)
        lev[0, :2, :] = 7
        lev[2 % m], deq[2 % m] = 0, 0
        out.append((org, pred, deq, lev))
    return out


def ts_alt(rng, plane, bd):
    """A TS plane's second alternative (K10's levels and dequantised
    values of its TS coefficients: the first TB at the 16-bit clip, a
    TB coded in neither), rates of both, and four TBs whose costs tie:
    levels on both sides but nothing dequantised, the same
    reconstruction, and rates (with the flag's prices 0.5 and 1) equal,
    so d1 + lam b1 == d0 + lam b0 and the DCT alternative must stay."""
    org, pred, deq, lev = plane
    m = len(org)
    tlev = (rng.randint(-40, 41, org.shape)
            * (rng.rand(*org.shape) < 0.3)).astype(np.int32)
    tdeq = np.clip(tlev * rng.randint(20, 900, (m, 1, 1)), -(1 << 15),
                   (1 << 15) - 1).astype(np.int32)
    tdeq[0, 0, :] = (1 << 15) - 1
    tdeq[0, 1, :] = -(1 << 15)
    tlev[0, :2, :] = 5
    bits = (rng.randint(0, 3000, m) * np.float32(0.03125)).astype(np.float32)
    tbits = (rng.randint(0, 3000, m) * np.float32(0.03125)).astype(np.float32)
    tlev[2 % m], tdeq[2 % m] = 0, 0
    for t in range(3, min(7, m)):
        deq[t], tdeq[t] = 0, 0
        lev[t], tlev[t] = 1, 2
        bits[t], tbits[t] = np.float32(10.5), np.float32(10.0)
    return tdeq, tlev, bits, tbits


FLAG = np.array([0.5, 1.0], np.float32)
