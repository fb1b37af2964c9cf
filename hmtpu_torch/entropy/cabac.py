"""CABAC binary arithmetic coder (H.265 9.3.4.3) — encoder and decoder.

Capability parity with TEncBinCoderCABAC.cpp:69-440 and
TDecBinCoderCABAC.cpp:60-210 of the reference; the engine flow
(range/low registers, renormalisation via the leading-zero table,
buffered-byte carry resolution) follows the standard.  This Python
engine is the correctness reference; the production entropy tail is the
C++ engine in native/ (same algorithm, validated bin-for-bin against
this one).

Context state is packed as (pStateIdx << 1) | valMps in a uint8, with
128-entry packed transition tables derived from spec Tables 9-46/9-47.
"""
from __future__ import annotations

import numpy as np

from hmtpu_torch.common import spec_tables as st

# packed state transition tables
NEXT_STATE_MPS = np.zeros(128, dtype=np.uint8)
NEXT_STATE_LPS = np.zeros(128, dtype=np.uint8)
for _p in range(128):
    _s, _m = _p >> 1, _p & 1
    NEXT_STATE_MPS[_p] = (int(st.TRANS_IDX_MPS[_s]) << 1) | _m
    _nm = 1 - _m if _s == 0 else _m
    NEXT_STATE_LPS[_p] = (int(st.TRANS_IDX_LPS[_s]) << 1) | _nm

_LPS_TABLE = st.RANGE_TAB_LPS.astype(np.int32)
_RENORM = st.RENORM_TABLE.astype(np.int32)


def init_state(init_value: int, qp: int) -> int:
    """Context initialisation (9.3.2.2) -> packed state."""
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    pre = min(max(1, ((slope * min(max(0, qp), 51)) >> 4) + offset), 126)
    if pre <= 63:
        return ((63 - pre) << 1) | 0
    return ((pre - 64) << 1) | 1


# symbol-level trace hook (utils/trace.py, the ENC_DEC_TRACE twin);
# None = off, zero overhead beyond the branch
TRACE = None


class CabacEncoder:
    """Binary arithmetic encoder writing bytes into a BitWriter."""

    __slots__ = ("low", "range", "bits_left", "num_buffered",
                 "buffered_byte", "bw")

    def __init__(self, bit_writer):
        self.bw = bit_writer
        self.start()

    def start(self) -> None:
        self.low = 0
        self.range = 510
        self.bits_left = 23
        self.num_buffered = 0
        self.buffered_byte = 0xFF

    # -- core ---------------------------------------------------------------
    def encode_bin(self, ctx: np.ndarray, idx: int, bin_val: int) -> None:
        if TRACE is not None:
            TRACE.ctx_bin(idx, bin_val)
        state = int(ctx[idx])
        lps = int(_LPS_TABLE[state >> 1, (self.range >> 6) & 3])
        self.range -= lps
        if bin_val != (state & 1):
            num_bits = int(_RENORM[lps >> 3])
            self.low = (self.low + self.range) << num_bits
            self.range = lps << num_bits
            ctx[idx] = NEXT_STATE_LPS[state]
            self.bits_left -= num_bits
            self._test_write()
        else:
            ctx[idx] = NEXT_STATE_MPS[state]
            if self.range < 256:
                self.low <<= 1
                self.range <<= 1
                self.bits_left -= 1
                self._test_write()

    def encode_bin_ep(self, bin_val: int) -> None:
        if TRACE is not None:
            TRACE.ep(bin_val, 1)
        if self.range == 256:
            self.encode_aligned_bins_ep(bin_val, 1)
            return
        self.low <<= 1
        if bin_val:
            self.low += self.range
        self.bits_left -= 1
        self._test_write()

    def encode_bins_ep(self, value: int, num_bins: int) -> None:
        if TRACE is not None:
            TRACE.ep(value, num_bins)
        if self.range == 256:
            self.encode_aligned_bins_ep(value, num_bins)
            return
        while num_bins > 8:
            num_bins -= 8
            pattern = value >> num_bins
            self.low = (self.low << 8) + self.range * pattern
            value -= pattern << num_bins
            self.bits_left -= 8
            self._test_write()
        self.low = (self.low << num_bins) + self.range * value
        self.bits_left -= num_bins
        self._test_write()

    def align(self) -> None:
        self.range = 256

    def encode_aligned_bins_ep(self, value: int, num_bins: int) -> None:
        assert self.range == 256
        remaining = num_bins
        while remaining > 0:
            take = min(remaining, 8)
            mask = (1 << take) - 1
            bins = (value >> (remaining - take)) & mask
            self.low = (self.low << take) + (bins << 8)
            remaining -= take
            self.bits_left -= take
            self._test_write()

    def encode_bin_trm(self, bin_val: int) -> None:
        if TRACE is not None:
            TRACE.trm(bin_val)
        self.range -= 2
        if bin_val:
            self.low += self.range
            self.low <<= 7
            self.range = 2 << 7
            self.bits_left -= 7
        elif self.range >= 256:
            return
        else:
            self.low <<= 1
            self.range <<= 1
            self.bits_left -= 1
        self._test_write()

    # -- flush --------------------------------------------------------------
    def finish(self) -> None:
        if self.low >> (32 - self.bits_left):
            self.bw.write_byte(self.buffered_byte + 1)
            while self.num_buffered > 1:
                self.bw.write_byte(0x00)
                self.num_buffered -= 1
            self.low -= 1 << (32 - self.bits_left)
        else:
            if self.num_buffered > 0:
                self.bw.write_byte(self.buffered_byte)
            while self.num_buffered > 1:
                self.bw.write_byte(0xFF)
                self.num_buffered -= 1
        self.bw.write((self.low >> 8) & ((1 << (24 - self.bits_left)) - 1),
                      24 - self.bits_left)

    def flush_terminate(self) -> None:
        """encodeBinTrm(1) + finish + stop bit + align (end of slice)."""
        self.encode_bin_trm(1)
        self.finish()
        self.bw.write(1, 1)
        self.bw.align_zero()
        self.start()

    # -- internals ----------------------------------------------------------
    def _test_write(self) -> None:
        if self.bits_left < 12:
            lead = self.low >> (24 - self.bits_left)
            self.bits_left += 8
            self.low &= 0xFFFFFFFF >> self.bits_left
            if lead == 0xFF:
                self.num_buffered += 1
            elif self.num_buffered > 0:
                carry = lead >> 8
                self.bw.write_byte((self.buffered_byte + carry) & 0xFF)
                fill = (0xFF + carry) & 0xFF
                while self.num_buffered > 1:
                    self.bw.write_byte(fill)
                    self.num_buffered -= 1
                self.buffered_byte = lead & 0xFF
                self.num_buffered = 1
            else:
                self.num_buffered = 1
                self.buffered_byte = lead


class CabacDecoder:
    """Binary arithmetic decoder over an RBSP byte buffer."""

    __slots__ = ("data", "pos", "range", "value", "bits_needed")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.start()

    def _read_byte(self) -> int:
        if self.pos < len(self.data):
            b = self.data[self.pos]
            self.pos += 1
            return b
        return 0

    def start(self) -> None:
        self.range = 510
        self.bits_needed = -8
        self.value = (self._read_byte() << 8) | self._read_byte()

    def decode_bin(self, ctx: np.ndarray, idx: int) -> int:
        state = int(ctx[idx])
        lps = int(_LPS_TABLE[state >> 1, (self.range >> 6) & 3])
        self.range -= lps
        scaled = self.range << 7
        if self.value < scaled:
            bin_val = state & 1
            ctx[idx] = NEXT_STATE_MPS[state]
            if scaled < (256 << 7):
                self.range = scaled >> 6
                self.value += self.value
                self.bits_needed += 1
                if self.bits_needed == 0:
                    self.bits_needed = -8
                    self.value += self._read_byte()
        else:
            bin_val = 1 - (state & 1)
            num_bits = int(_RENORM[lps >> 3])
            self.value = (self.value - scaled) << num_bits
            self.range = lps << num_bits
            ctx[idx] = NEXT_STATE_LPS[state]
            self.bits_needed += num_bits
            if self.bits_needed >= 0:
                self.value += self._read_byte() << self.bits_needed
                self.bits_needed -= 8
        if TRACE is not None:
            TRACE.ctx_bin(idx, bin_val)
        return bin_val

    def decode_bin_ep(self) -> int:
        if self.range == 256:
            out = self.decode_aligned_bins_ep(1)
        else:
            self.value += self.value
            self.bits_needed += 1
            if self.bits_needed >= 0:
                self.bits_needed = -8
                self.value += self._read_byte()
            scaled = self.range << 7
            if self.value >= scaled:
                self.value -= scaled
                out = 1
            else:
                out = 0
        if TRACE is not None:
            TRACE.ep(out, 1)
        return out

    def decode_bins_ep(self, num_bins: int) -> int:
        if self.range == 256:
            out = self.decode_aligned_bins_ep(num_bins)
            if TRACE is not None:
                TRACE.ep(out, num_bins)
            return out
        value = 0
        while num_bins > 8:
            self.value = ((self.value << 8)
                          + (self._read_byte() << (8 + self.bits_needed)))
            scaled = self.range << 15
            for _ in range(8):
                value += value
                scaled >>= 1
                if self.value >= scaled:
                    value += 1
                    self.value -= scaled
            num_bins -= 8
        self.bits_needed += num_bins
        self.value <<= num_bins
        if self.bits_needed >= 0:
            self.value += self._read_byte() << self.bits_needed
            self.bits_needed -= 8
        scaled = self.range << (num_bins + 7)
        for _ in range(num_bins):
            value += value
            scaled >>= 1
            if self.value >= scaled:
                value += 1
                self.value -= scaled
        if TRACE is not None:
            TRACE.ep(value, num_bins)
        return value

    def align(self) -> None:
        self.range = 256

    def decode_aligned_bins_ep(self, num_bins: int) -> int:
        # with range 256 the bins are simply the next-most-significant
        # bits of the MSB-aligned 16-bit value buffer
        assert self.range == 256
        value = 0
        remaining = num_bins
        while remaining > 0:
            take = min(remaining, 8)
            mask = (1 << take) - 1
            new_bins = (self.value >> (15 - take)) & mask
            value = (value << take) | new_bins
            self.value = (self.value << take) & 0x7FFF
            remaining -= take
            self.bits_needed += take
            if self.bits_needed >= 0:
                self.value |= self._read_byte() << self.bits_needed
                self.bits_needed -= 8
        return value

    def decode_bin_trm(self) -> int:
        self.range -= 2
        scaled = self.range << 7
        if self.value >= scaled:
            if TRACE is not None:
                TRACE.trm(1)
            return 1
        if scaled < (256 << 7):
            self.range = scaled >> 6
            self.value += self.value
            self.bits_needed += 1
            if self.bits_needed == 0:
                self.bits_needed = -8
                self.value += self._read_byte()
        if TRACE is not None:
            TRACE.trm(0)
        return 0
