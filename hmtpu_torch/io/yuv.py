"""Planar YUV file I/O.

Capability parity with the reference's TVideoIOYuv.cpp:120-188 (open /
read / write / skipFrames, 8/10/16-bit, MSB-extension, bit-depth
conversion).  Frames are numpy int32 planes (the codec's internal Pel
type); device transfer happens in the encoder's frame pipeline, not
here.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hmtpu_torch.common.constants import ChromaFormat


_SUBSAMPLE = {
    ChromaFormat.C400: (0, 0),
    ChromaFormat.C420: (2, 2),
    ChromaFormat.C422: (2, 1),
    ChromaFormat.C444: (1, 1),
}


@dataclass
class Frame:
    """One picture: luma + two chroma planes, int32, full range of the
    coded bit depth."""

    y: np.ndarray
    u: np.ndarray | None
    v: np.ndarray | None
    bit_depth: int = 8

    @property
    def width(self) -> int:
        return self.y.shape[1]

    @property
    def height(self) -> int:
        return self.y.shape[0]

    def planes(self):
        return [p for p in (self.y, self.u, self.v) if p is not None]


def frame_bytes(width: int, height: int, chroma: ChromaFormat, file_bit_depth: int) -> int:
    sx, sy = _SUBSAMPLE[chroma]
    nbytes = 1 if file_bit_depth <= 8 else 2
    luma = width * height
    chroma_px = 0 if chroma == ChromaFormat.C400 else 2 * (width // sx) * (height // sy)
    return (luma + chroma_px) * nbytes


class YuvReader:
    def __init__(self, path: str, width: int, height: int,
                 chroma: ChromaFormat = ChromaFormat.C420,
                 file_bit_depth: int = 8, internal_bit_depth: int = 8):
        self.path = path
        self.width = width
        self.height = height
        self.chroma = chroma
        self.file_bit_depth = file_bit_depth
        self.internal_bit_depth = internal_bit_depth
        self._f = open(path, "rb")

    def close(self) -> None:
        self._f.close()

    def skip_frames(self, n: int) -> None:
        self._f.seek(
            n * frame_bytes(self.width, self.height, self.chroma, self.file_bit_depth),
            1,
        )

    def _read_plane(self, w: int, h: int) -> np.ndarray | None:
        nbytes = 1 if self.file_bit_depth <= 8 else 2
        raw = self._f.read(w * h * nbytes)
        if len(raw) < w * h * nbytes:
            return None
        dt = np.uint8 if nbytes == 1 else np.dtype("<u2")
        plane = np.frombuffer(raw, dtype=dt).reshape(h, w).astype(np.int32)
        shift = self.internal_bit_depth - self.file_bit_depth
        if shift > 0:
            plane <<= shift
        elif shift < 0:
            plane = (plane + (1 << (-shift - 1))) >> (-shift)
        return plane

    def read_frame(self) -> Frame | None:
        y = self._read_plane(self.width, self.height)
        if y is None:
            return None
        if self.chroma == ChromaFormat.C400:
            return Frame(y, None, None, self.internal_bit_depth)
        sx, sy = _SUBSAMPLE[self.chroma]
        u = self._read_plane(self.width // sx, self.height // sy)
        v = self._read_plane(self.width // sx, self.height // sy)
        if u is None or v is None:
            return None
        return Frame(y, u, v, self.internal_bit_depth)


class YuvWriter:
    def __init__(self, path: str, file_bit_depth: int = 8):
        self.path = path
        self.file_bit_depth = file_bit_depth
        self._f = open(path, "wb")

    def close(self) -> None:
        self._f.close()

    def write_frame(self, frame: Frame) -> None:
        shift = frame.bit_depth - self.file_bit_depth
        for plane in frame.planes():
            p = plane
            if shift > 0:
                p = np.minimum(
                    (p + (1 << (shift - 1))) >> shift,
                    (1 << self.file_bit_depth) - 1,
                )
            elif shift < 0:
                p = p << (-shift)
            if self.file_bit_depth <= 8:
                self._f.write(p.astype(np.uint8).tobytes())
            else:
                self._f.write(p.astype("<u2").tobytes())
