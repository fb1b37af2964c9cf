"""Fractional-bit cost tables for CABAC-state-aware rate estimation.

Capability parity with the reference's RD bit counter
(TEncBinCoderCABACCounter.cpp:69-144, ContextModel::getEntropyBits
ContextModel.h:79): during mode decision HM prices every context-coded
bin as entropyBits[state ^ bin] (Q15 fixed point) instead of running
the arithmetic engine.  Here the same pricing drives the *device*
decision pass: `ctx_bits_table` turns a packed context-state vector
into a dense (NUM_CTX, 2) float32 bits table the wavefront kernels
gather from.

The encoder harvests the adapted context states after each frame's
real entropy pass and prices the next frame's decisions with them
(HM instead snapshots its RD coder per depth, TEncTop.cpp:117-138 —
a same-frame approximation; cross-frame steady state is the batched
equivalent).
"""
from __future__ import annotations

import numpy as np

# Q15 fractional-bit table indexed by (packed_state ^ bin); the
# FAST_BIT_EST variant of ContextModel::m_entropyBits
# (ContextModel.cpp:106, "corrected table").  Entry 2k   = cost of
# coding the MPS in probability state k, entry 2k+1 = cost of the LPS.
ENTROPY_BITS = np.array([
    0x07b23, 0x085f9, 0x074a0, 0x08cbc, 0x06ee4, 0x09354, 0x067f4,
    0x09c1b, 0x060b0, 0x0a62a, 0x05a9c, 0x0af5b, 0x0548d, 0x0b955,
    0x04f56, 0x0c2a9, 0x04a87, 0x0cbf7, 0x045d6, 0x0d5c3, 0x04144,
    0x0e01b, 0x03d88, 0x0e937, 0x039e0, 0x0f2cd, 0x03663, 0x0fc9e,
    0x03347, 0x10600, 0x03050, 0x10f95, 0x02d4d, 0x11a02, 0x02ad3,
    0x12333, 0x0286e, 0x12cad, 0x02604, 0x136df, 0x02425, 0x13f48,
    0x021f4, 0x149c4, 0x0203e, 0x1527b, 0x01e4d, 0x15d00, 0x01c99,
    0x166de, 0x01b18, 0x17017, 0x019a5, 0x17988, 0x01841, 0x18327,
    0x016df, 0x18d50, 0x015d9, 0x19547, 0x0147c, 0x1a083, 0x0138e,
    0x1a8a3, 0x01251, 0x1b418, 0x01166, 0x1bd27, 0x01068, 0x1c77b,
    0x00f7f, 0x1d18e, 0x00eda, 0x1d91a, 0x00e19, 0x1e254, 0x00d4f,
    0x1ec9a, 0x00c90, 0x1f6e0, 0x00c01, 0x1fef8, 0x00b5f, 0x208b1,
    0x00ab6, 0x21362, 0x00a15, 0x21e46, 0x00988, 0x2285d, 0x00934,
    0x22ea8, 0x008a8, 0x239b2, 0x0081d, 0x24577, 0x007c9, 0x24ce6,
    0x00763, 0x25663, 0x00710, 0x25e8f, 0x006a0, 0x26a26, 0x00672,
    0x26f23, 0x005e8, 0x27ef8, 0x005ba, 0x284b5, 0x0055e, 0x29057,
    0x0050c, 0x29bab, 0x004c1, 0x2a674, 0x004a7, 0x2aa5e, 0x0046f,
    0x2b32f, 0x0041f, 0x2c0ad, 0x003e7, 0x2ca8d, 0x003ba, 0x2d323,
    0x0010c, 0x3bfbb,
], dtype=np.int64)


def bits_of(packed_state: int, bin_val: int) -> float:
    """Fractional bits for coding `bin_val` in the given packed state."""
    return float(ENTROPY_BITS[packed_state ^ bin_val]) / 32768.0


def ctx_bits_table(ctx: np.ndarray) -> np.ndarray:
    """Packed context-state vector -> (NUM_CTX, 2) float32 bits table;
    column v is the cost of coding bin value v in that context."""
    s = ctx.astype(np.int64)
    return (np.stack([ENTROPY_BITS[s ^ 0], ENTROPY_BITS[s ^ 1]], axis=1)
            .astype(np.float32) / np.float32(32768.0))
