"""Carry numeric state between hmtpu and this package.

The all-intra path has no learned weights; what crosses over is numeric
state: an hmtpu state dict (the `iframe_pass` state, or the `cbflat`
bits table) in, and the port's state dict out.  The tests use this to
feed both sides the same mid-pass state.  The NN-FME weights
(hmtpu/models/weights/qp*.npz) join this module with the low-delay-P
slice.
"""
from __future__ import annotations

import numpy as np
import torch

from hmtpu_torch.device import resolve


def state_from_numpy(d, device="cuda"):
    """A dict of arrays (numpy, or anything np.asarray takes), or one
    array, -> the same as torch tensors on `device`, dtypes kept."""
    dev = resolve(device)
    conv = lambda a: torch.from_numpy(np.array(a, order="C")).to(dev)
    if isinstance(d, dict):
        return {k: conv(np.asarray(v)) for k, v in d.items()}
    return conv(np.asarray(d))


def state_to_numpy(d):
    """The inverse of state_from_numpy: tensors -> numpy arrays."""
    if isinstance(d, dict):
        return {k: v.detach().cpu().numpy() for k, v in d.items()}
    return d.detach().cpu().numpy()
