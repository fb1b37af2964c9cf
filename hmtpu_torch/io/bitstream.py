"""Raw bitstream assembly: bit writer/reader, Exp-Golomb codes, RBSP
emulation handling.

Capability parity with the reference's TComBitStream.cpp:1-412 and
SyntaxElementWriter.h:68 (ue(v)/se(v) writers), re-designed as a small
byte-array builder.  This layer is host-side by design: bit packing is
the serial tail of the codec and never touches the TPU.  The hot caller
(CABAC) batches its output and flushes bytes in chunks.
"""
from __future__ import annotations


class BitWriter:
    """MSB-first bit writer producing an RBSP byte string."""

    __slots__ = ("_bytes", "_held", "_held_bits")

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._held = 0          # bits not yet flushed to a full byte
        self._held_bits = 0     # number of valid bits in _held (0..7)

    # -- primitive ---------------------------------------------------------
    def write(self, value: int, num_bits: int) -> None:
        if num_bits == 0:
            return
        assert num_bits <= 64 and 0 <= value < (1 << num_bits), (value, num_bits)
        acc = (self._held << num_bits) | value
        total = self._held_bits + num_bits
        while total >= 8:
            total -= 8
            self._bytes.append((acc >> total) & 0xFF)
        self._held = acc & ((1 << total) - 1)
        self._held_bits = total

    def write_byte(self, byte: int) -> None:
        if self._held_bits == 0:
            self._bytes.append(byte & 0xFF)
        else:
            self.write(byte, 8)

    def write_bytes(self, data: bytes) -> None:
        if self._held_bits == 0:
            self._bytes.extend(data)
        else:
            for b in data:
                self.write(b, 8)

    # -- Exp-Golomb --------------------------------------------------------
    def write_ue(self, value: int) -> None:
        assert value >= 0
        code = value + 1
        length = code.bit_length()
        self.write(0, length - 1)
        self.write(code, length)

    def write_se(self, value: int) -> None:
        # H.265 9.2: positive -> odd codeNum, negative -> even
        self.write_ue(2 * value - 1 if value > 0 else -2 * value)

    def write_flag(self, flag) -> None:
        self.write(1 if flag else 0, 1)

    # -- alignment / trailing ---------------------------------------------
    @property
    def bit_position(self) -> int:
        return len(self._bytes) * 8 + self._held_bits

    def is_byte_aligned(self) -> bool:
        return self._held_bits == 0

    def write_rbsp_trailing_bits(self) -> None:
        """rbsp_stop_one_bit + alignment zeros (H.265 7.3.2.11)."""
        self.write(1, 1)
        self.align_zero()

    def write_byte_alignment(self) -> None:
        """alignment_bit_equal_to_one then zeros (slice-header end)."""
        self.write(1, 1)
        self.align_zero()

    def align_zero(self) -> None:
        if self._held_bits:
            self.write(0, 8 - self._held_bits)

    def get_bytes(self) -> bytes:
        assert self._held_bits == 0, "stream not byte aligned"
        return bytes(self._bytes)


def insert_emulation_prevention(rbsp: bytes) -> bytes:
    """RBSP -> EBSP: insert emulation_prevention_three_byte (H.265 7.4.2,
    reference NALwrite.cpp:73-101)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    # a NAL payload may not end with a 0x00 run that could collide with the
    # start code; trailing-bits guarantee ends with 0x80-aligned byte, but a
    # cabac_zero_word-free stream can still end in 0x00 (HM appends 0x03).
    if out and out[-1] == 0 and zeros >= 1:
        out.append(3)
    return bytes(out)


def strip_emulation_prevention(ebsp: bytes) -> bytes:
    """EBSP -> RBSP for the decoder path."""
    return strip_emulation_prevention_positions(ebsp)[0]


def strip_emulation_prevention_positions(ebsp: bytes):
    """EBSP -> (RBSP, EBSP positions of the removed 0x03 bytes).
    The positions let entry_point_offset values (which count emulation
    bytes, 7.4.7.1) be mapped back to RBSP offsets the way the
    reference does (TDecCAVLC.cpp:1485-1516)."""
    out = bytearray()
    eps = []
    zeros = 0
    i = 0
    n = len(ebsp)
    while i < n:
        b = ebsp[i]
        if zeros >= 2 and b == 3 and i + 1 <= n:
            eps.append(i)
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out), eps


def count_emulations(span: bytes) -> int:
    """Emulation-prevention bytes the NAL writer will insert inside
    this span (TComOutputBitstream::countStartCodeEmulations).  Valid
    per-substream because every substream ends in a nonzero
    stop-bit byte, so patterns never straddle a boundary."""
    cnt = 0
    zeros = 0
    for b in span:
        if zeros >= 2 and b <= 3:
            cnt += 1
            zeros = 0
        zeros = zeros + 1 if b == 0 else 0
    return cnt


class BitReader:
    """MSB-first bit reader over an RBSP byte string (decoder oracle)."""

    __slots__ = ("_data", "_pos")

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # bit position

    def read(self, num_bits: int) -> int:
        v = 0
        pos = self._pos
        data = self._data
        for _ in range(num_bits):
            byte = data[pos >> 3]
            v = (v << 1) | ((byte >> (7 - (pos & 7))) & 1)
            pos += 1
        self._pos = pos
        return v

    def read_flag(self) -> int:
        return self.read(1)

    def read_ue(self) -> int:
        zeros = 0
        while self.read(1) == 0:
            zeros += 1
        if zeros == 0:
            return 0
        return (1 << zeros) - 1 + self.read(zeros)

    def read_se(self) -> int:
        k = self.read_ue()
        return (k + 1) // 2 if k % 2 == 1 else -(k // 2)

    def byte_align(self) -> None:
        self._pos = (self._pos + 7) & ~7

    @property
    def bit_position(self) -> int:
        return self._pos

    def more_rbsp_data(self) -> bool:
        # crude: true if any bit set after current position before the final
        # rbsp_stop_one_bit
        total = len(self._data) * 8
        if self._pos >= total:
            return False
        # find last set bit (the stop bit)
        for byte_idx in range(len(self._data) - 1, -1, -1):
            b = self._data[byte_idx]
            if b:
                last_one = byte_idx * 8 + (7 - (b.bit_length() - 1))
                # bit_length gives MSB position; last set bit from MSB side:
                for bit in range(7, -1, -1):
                    if b & (1 << bit):
                        last_one = byte_idx * 8 + (7 - bit)
                return self._pos < last_one
        return False
