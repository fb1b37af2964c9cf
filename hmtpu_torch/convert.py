"""Carry numeric state between hmtpu and this package.

What crosses over is numeric state -- an hmtpu state dict (the
`iframe_pass` / `full_pframe_pass` state, or the `cbflat` bits table)
in, and the port's state dict out -- the NN-FME weights (the fields of
an hmtpu `NnFmeParams` as numpy arrays in, the port's `NnFmeParams`
out), and the trainer's optimizer state (optax's `ScaleByAdamState`
`mu`, `nu`, `count` in, the port's packed `AdamState` out).  The tests
use this to feed both sides the same state, the same (in-repo or
random) weights, and the same point of a training run.
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


def adam_state_from_numpy(opt_state, device="cuda", steps: int = 0):
    """optax.adam's state (the tuple `optax.adam(lr).init` / `update`
    give, or its ScaleByAdamState) with `mu` and `nu` NnFmeParams-shaped
    (NamedTuples or mappings of numpy-convertible arrays) -> the port's
    `AdamState`: the moments packed in PACK_ORDER on `device` (float32),
    `count` a host int and its device copy, the bias corrections' table
    ready for `steps` more updates."""
    from hmtpu_torch.models.nnfme import PACK_ORDER
    from hmtpu_torch.models.train import adam_state

    st = opt_state if hasattr(opt_state, "mu") \
        else next(s for s in opt_state if hasattr(s, "mu"))
    dev = resolve(device)

    def pack(t):
        d = t._asdict() if hasattr(t, "_asdict") else t
        return torch.from_numpy(np.concatenate(
            [np.asarray(d[k], np.float32).reshape(-1) for k in PACK_ORDER])
        ).to(dev)

    return adam_state(pack(st.mu), pack(st.nu), int(np.asarray(st.count)),
                      steps)
