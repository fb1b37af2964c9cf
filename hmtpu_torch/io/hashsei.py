"""Decoded-picture-hash computation and SEI payload assembly.

Capability parity with TComPicYuvMD5.cpp:185 (calcMD5) and the
decoded_picture_hash SEI of SEIwrite.cpp / SEI.h:125.  MD5 is computed
per colour plane over samples in raster order, one byte per sample for
bit depth <= 8, else two bytes little-endian (H.265 D.3.19).
"""
from __future__ import annotations

import hashlib

import numpy as np

from hmtpu_torch.common.constants import SEI_DECODED_PICTURE_HASH, NalUnitType
from hmtpu_torch.io.bitstream import BitWriter
from hmtpu_torch.io.nal import NalUnit


def plane_md5(plane: np.ndarray, bit_depth: int) -> bytes:
    if bit_depth <= 8:
        data = plane.astype(np.uint8).tobytes()
    else:
        data = plane.astype("<u2").tobytes()
    return hashlib.md5(data).digest()


def picture_md5(planes, bit_depths) -> list[bytes]:
    return [plane_md5(p, d) for p, d in zip(planes, bit_depths)]


def make_hash_sei_nal(digests: list[bytes], temporal_id: int = 0) -> NalUnit:
    """Build the suffix-SEI NAL carrying hash_type=0 (MD5) digests."""
    payload = bytes([0]) + b"".join(digests)  # hash_type + per-plane MD5
    bw = BitWriter()
    # SEI message: last_payload_type / last_payload_size as 0xFF-chained bytes
    ptype = SEI_DECODED_PICTURE_HASH
    while ptype >= 255:
        bw.write_byte(255)
        ptype -= 255
    bw.write_byte(ptype)
    psize = len(payload)
    while psize >= 255:
        bw.write_byte(255)
        psize -= 255
    bw.write_byte(psize)
    bw.write_bytes(payload)
    bw.write_rbsp_trailing_bits()
    return NalUnit(NalUnitType.SUFFIX_SEI_NUT, bw.get_bytes(), temporal_id)


def parse_sei_messages(rbsp: bytes) -> list[tuple[int, bytes]]:
    """Minimal SEI parser for the decoder oracle: returns
    (payload_type, payload_bytes) pairs."""
    out = []
    i = 0
    while i < len(rbsp):
        if rbsp[i] == 0x80:  # rbsp_stop bit byte
            break
        ptype = 0
        while rbsp[i] == 255:
            ptype += 255
            i += 1
        ptype += rbsp[i]
        i += 1
        psize = 0
        while rbsp[i] == 255:
            psize += 255
            i += 1
        psize += rbsp[i]
        i += 1
        out.append((ptype, rbsp[i : i + psize]))
        i += psize
    return out
