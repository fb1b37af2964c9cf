"""Seconds per frame of two 416x240 encodes on the card, for comparing
two trees of the port on one card in one run:

  ldp   LDP QP 22 with NN-FME, search range 64 (the main path): I + P;
  ldp_dctif  LDP QP 22 with HM's DCT-IF sub-pel search and transform
        skip, search range 64: I + P;
  ra10  random access at Main10, QP 32, DCT-IF, search range 64, on the
        first 3 frames (the IDR and two B pictures);
  ai    all-intra QP 32 with transform skip on the first frame.

    PYTHONPATH=<checkout of the port> python scripts/frame_times.py

Each frame's seconds come from `Encoder.results` (the device pass of a P
or B frame beside them), after a warm-up encode of a 64x64 clip; prints
one JSON object per encode, with the number of hand kernels the tree has.
Uses only the encoder's public entry points, so it runs against earlier
trees of the port too.  Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch


def _encode(frames, device="cuda", **cfg):
    from hmtpu_torch.encoder.top import Encoder, EncoderConfig
    from hmtpu_torch.io.yuv import Frame

    frames = list(frames)
    bd = cfg.get("bit_depth", 8)
    h, w = frames[0][0].shape
    enc = Encoder(EncoderConfig(width=w, height=h, **cfg), device=device)
    t0 = time.time()
    bs = enc.encode_sequence([
        Frame(*(np.asarray(p, np.int32) << (bd - 8) for p in f), bd)
        for f in frames])
    if device != "cpu":
        torch.cuda.synchronize()
    return bs, time.time() - t0, enc.results


def main() -> int:
    if not torch.cuda.is_available():
        print("frame_times: no CUDA device", file=sys.stderr)
        return 2
    from hmtpu_torch import kernels
    from hmtpu_torch.utils.gen_test_yuv import synth_clip

    kernels.build_all()
    clip = list(synth_clip(416, 240, 3, seed=42))
    _encode(synth_clip(64, 64, 2, seed=3), qp=22, gop="ldp", subpel="nn",
            search_range=8)
    runs = (("ldp", clip[:2], dict(qp=22, gop="ldp", subpel="nn",
                                   search_range=64)),
            ("ldp_dctif", clip[:2], dict(qp=22, gop="ldp", subpel="dctif",
                                         transform_skip=True,
                                         search_range=64)),
            ("ra10", clip, dict(qp=32, gop="ra", subpel="dctif",
                                search_range=64, bit_depth=10)),
            ("ai", clip[:1], dict(qp=32, gop="ai", subpel="none",
                                  transform_skip=True)))
    for name, frames, cfg in runs:
        bs, dt, res = _encode(frames, **cfg)
        print(json.dumps({
            "config": name, "kernels": len(kernels.KERNELS),
            "bytes": len(bs), "seconds": dt,
            "frames": [{"poc": r.poc, "type": r.slice_type,
                        "seconds": r.seconds,
                        "device_seconds": getattr(r, "device_seconds",
                                                  None)}
                       for r in res]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
