"""Carry numeric state between hmtpu and this package.

What crosses over is numeric state -- an hmtpu state dict (the
`iframe_pass` / `full_pframe_pass` state, or the `cbflat` bits table)
in, and the port's state dict out -- and the NN-FME weights: the fields
of an hmtpu `NnFmeParams` as numpy arrays in, the port's `NnFmeParams`
out.  The tests use this to feed both sides the same state and the
same (in-repo or random) weights.
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


def nnfme_params_from_numpy(d, device="cuda"):
    """The fields of an hmtpu `NnFmeParams` (a mapping, or the
    NamedTuple itself, of numpy-convertible arrays) -> the port's
    `NnFmeParams` on `device` (float32)."""
    from hmtpu_torch.models.nnfme import PACK_ORDER, params_from_arrays

    if hasattr(d, "_asdict"):
        d = d._asdict()
    return params_from_arrays({k: np.asarray(d[k]) for k in PACK_ORDER},
                              resolve(device))
