"""NAL unit assembly and Annex-B byte-stream writing.

Capability parity with NALwrite.cpp:45-125 and AnnexBwrite.h:53 of the
reference: 2-byte NAL header, RBSP->EBSP emulation prevention, start
codes (4-byte for parameter sets and the first NAL of an access unit,
3-byte otherwise).
"""
from __future__ import annotations

from dataclasses import dataclass

from hmtpu_torch.common.constants import NalUnitType
from hmtpu_torch.io.bitstream import insert_emulation_prevention


@dataclass
class NalUnit:
    nal_type: NalUnitType
    rbsp: bytes
    temporal_id: int = 0  # nuh_temporal_id_plus1 - 1
    layer_id: int = 0

    def header_bytes(self) -> bytes:
        b0 = (0 << 7) | (int(self.nal_type) << 1) | ((self.layer_id >> 5) & 1)
        b1 = ((self.layer_id & 0x1F) << 3) | (self.temporal_id + 1)
        return bytes((b0, b1))

    def to_bytes(self) -> bytes:
        return self.header_bytes() + insert_emulation_prevention(self.rbsp)


_LONG_START_TYPES = frozenset(
    {NalUnitType.VPS_NUT, NalUnitType.SPS_NUT, NalUnitType.PPS_NUT}
)


def write_annexb(nal_units: list[NalUnit]) -> bytes:
    """Serialize one access unit's NALs to an Annex-B chunk."""
    out = bytearray()
    for i, nal in enumerate(nal_units):
        long_start = i == 0 or nal.nal_type in _LONG_START_TYPES
        out.extend(b"\x00\x00\x00\x01" if long_start else b"\x00\x00\x01")
        out.extend(nal.to_bytes())
    return bytes(out)


def split_annexb(data: bytes) -> list[bytes]:
    """Split an Annex-B stream into raw NAL byte strings (decoder side,
    parity with AnnexBread.cpp)."""
    nals = []
    i = 0
    n = len(data)
    # find first start code
    starts = []
    while i + 2 < n:
        if data[i] == 0 and data[i + 1] == 0 and data[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for idx, s in enumerate(starts):
        e = starts[idx + 1] - 3 if idx + 1 < len(starts) else n
        # strip trailing zero_bytes that belong to the next start code
        while e > s and data[e - 1] == 0 and idx + 1 < len(starts):
            e -= 1
        nals.append(data[s:e])
    return nals
