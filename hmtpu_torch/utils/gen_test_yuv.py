"""Deterministic synthetic test clip generator (BlowingBubbles-class
content: moving gradient field + travelling blob + film grain), a copy
of tools/gen_test_yuv.py: the clip the NN-FME trainer extracts from
when it is given no YUV file (apps/train_nnfme.py), the same numbers as
the repo's tests, bench and HM baseline use.
"""
from __future__ import annotations

import numpy as np


def synth_clip(width: int = 416, height: int = 240, frames: int = 50,
               seed: int = 42):
    """Yields (y, u, v) uint8 planes per frame."""
    rng = np.random.RandomState(seed)
    xx, yy = np.meshgrid(np.arange(width), np.arange(height))
    for t in range(frames):
        y = (128 + 60 * np.sin(xx / 23.0 + t * 0.3) * np.cos(yy / 17.0)
             + 40 * np.exp(-(((xx - (100 + 3 * t)) ** 2
                              + (yy - height // 2) ** 2) / 1800.0))
             + rng.randn(height, width) * 3)
        u = 128 + 30 * np.sin((xx[::2, ::2] + t * 4) / 31.0)
        v = 128 + 30 * np.cos((yy[::2, ::2] - t * 3) / 29.0)
        yield (np.clip(y, 0, 255).astype(np.uint8),
               np.clip(u, 0, 255).astype(np.uint8),
               np.clip(v, 0, 255).astype(np.uint8))


def write_clip(path: str, width: int = 416, height: int = 240,
               frames: int = 50, seed: int = 42) -> str:
    with open(path, "wb") as f:
        for y, u, v in synth_clip(width, height, frames, seed):
            f.write(y.tobytes())
            f.write(u.tobytes())
            f.write(v.tobytes())
    return path


if __name__ == "__main__":
    import sys

    out = sys.argv[1] if len(sys.argv) > 1 else "hmtpu_test.yuv"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 50
    write_clip(out, frames=n)
    print(f"wrote {out} ({n} frames 416x240 yuv420p8)")
