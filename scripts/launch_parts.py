"""What one call of K1's transform-skip mode costs on the host, piece by
piece, at the shape the main path times it, (3120, 4, 4) int32:

  raw_stream     `torch._C._cuda_getCurrentRawStream(0)`, the stream
                 handle `kernels.launch_checked` reads
  ctypes_call    the bound C function alone (the launch)
  whole_call     `transform_skip_fwd`, as the encoder calls it
  torch_shift    `x << 7`, the one PyTorch call computing the same

Each is timed on the host clock over 200 calls after 20 of warm-up, with
a device sync before the clock stops; prints one line each, then one
JSON object.

    PYTHONPATH=. python scripts/launch_parts.py

Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import sys
import time

import torch

ITERS, WARM = 200, 20


def per_call_us(fn) -> float:
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / ITERS * 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print("launch_parts: no CUDA device", file=sys.stderr)
        return 2
    from hmtpu_torch import kernels
    from hmtpu_torch.ops import transform

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(1)
    x = torch.randint(-255, 256, (3120, 4, 4), generator=g,
                      dtype=torch.int32).to(dev)
    out = torch.empty_like(x)
    s1 = transform.ts_shift(4, 8)
    transform.transform_skip_fwd(x, 4)        # builds and loads
    fn = kernels._lib("transform").hm_transform_skip
    stream = torch._C._cuda_getCurrentRawStream(0)
    xp, op = x.data_ptr(), out.data_ptr()
    parts = {
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "ctypes_call": lambda: fn(xp, op, x.numel(), s1 << 1, stream),
        "whole_call": lambda: transform.transform_skip_fwd(x, 4),
        "torch_shift": lambda: x << s1,
    }
    res = {k: per_call_us(f) for k, f in parts.items()}
    for k, us in res.items():
        print(f"launch_parts {k}: {us:.2f} us a call", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "us_per_call": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
