"""Device selection.  Entry points take an explicit device, "cuda" by
default; there is no fallback: a missing card raises, and the CPU runs
only when the caller asks for it (the plain PyTorch path)."""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hmtpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    elif d.type != "cpu":
        raise ValueError(f"hmtpu_torch runs on cuda or cpu, not {d}")
    return d
