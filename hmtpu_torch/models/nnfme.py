"""NN-FME: the per-QP MLP that replaces DCT-IF fractional-pel motion
search (the fork's contribution), the port of hmtpu/models/nnfme.py
(`NnFmeParams` :34, the row tables :52-61, `load_npz` :105, `forward`
:127, `predict_offsets` :143).

Architecture (TEncSearch.cpp:85-131 of the reference):
  x = (costs9 - mean) / std * gin
  e0 = emb_h[row(height)], e1 = emb_w[row(width)]     (8x4 tables)
  h1 = relu(W1 @ [e0,e1,x] + b1) * g1 + beta1          (22)
  h2 = relu(W2 @ h1 + b2) * g2 + beta2                 (20)
  logits = W3 @ h2 + b3                                (49)
  class -> quarter-pel offsets: qx = cls%7-3, qy = cls//7-3
Cost stencil order: [TL, T, TR, L, C, R, BL, B, BR].

On CUDA tensors `forward` / `predict_offsets` launch the hand-written
kernel K6 (csrc/nnfme.cu); on CPU tensors they run the plain version
`forward_plain`.  Both sum every dot product in ascending k order with
one rounded float32 multiply and one rounded add per term (no FMA), so
the card and the CPU give the same bits.  hmtpu's XLA dot sums in
another order: logits agree with it to about 1e-4 (absolute), and the
class agrees wherever the top two logits are further apart than that.

Training (hmtpu/models/train.py, dataset.py) is not ported yet
(ROADMAP.md A19); the weights are the in-repo per-QP files under
models/weights/.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from hmtpu_torch import kernels

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "weights")


class NnFmeParams(NamedTuple):
    emb_h: torch.Tensor      # (8, 4)
    emb_w: torch.Tensor      # (8, 4)
    w1: torch.Tensor         # (22, 17)
    b1: torch.Tensor         # (22,)
    g1: torch.Tensor         # (22,)
    beta1: torch.Tensor      # (22,)
    w2: torch.Tensor         # (20, 22)
    b2: torch.Tensor         # (20,)
    g2: torch.Tensor         # (20,)
    beta2: torch.Tensor      # (20,)
    w3: torch.Tensor         # (49, 20)
    b3: torch.Tensor         # (49,)
    gin: torch.Tensor        # (9,) input BN scale
    mean: torch.Tensor       # (9,)
    std: torch.Tensor        # (9,)
    packed: torch.Tensor     # the fields above as one float32 vector in
                             # PACK_ORDER, K6's layout (made once)


# size -> embedding row; the height table's 16-before-12 quirk is the
# reference's (TEncSearch.cpp:93-113) and must be preserved for parity
_H_ROWS = {4: 1, 8: 2, 16: 3, 12: 4, 24: 5, 32: 6, 64: 7}
_W_ROWS = {4: 1, 8: 2, 12: 3, 16: 4, 24: 5, 32: 6, 64: 7}
_SIZE_LUT_H = np.zeros(65, dtype=np.int32)
_SIZE_LUT_W = np.zeros(65, dtype=np.int32)
for _s, _r in _H_ROWS.items():
    _SIZE_LUT_H[_s] = _r
for _s, _r in _W_ROWS.items():
    _SIZE_LUT_W[_s] = _r

# the order K6 reads the parameters in (csrc/nnfme.cu)
PACK_ORDER = ("mean", "std", "gin", "emb_h", "emb_w", "w1", "b1", "g1",
              "beta1", "w2", "b2", "g2", "beta2", "w3", "b3")
PACK_SIZE = 9 * 3 + 32 * 2 + 22 * 17 + 22 * 3 + 20 * 22 + 20 * 3 \
    + 49 * 20 + 49


def params_from_arrays(d, device) -> NnFmeParams:
    """NnFmeParams from a mapping of field name -> array (float32)."""
    t = {k: torch.from_numpy(np.array(d[k], np.float32)).to(device)
         for k in PACK_ORDER}
    packed = torch.cat([t[k].reshape(-1) for k in PACK_ORDER])
    if packed.numel() != PACK_SIZE:
        raise ValueError(f"nnfme: {packed.numel()} parameters, expected "
                         f"{PACK_SIZE}")
    return NnFmeParams(**t, packed=packed)


def load_npz(path: str, device="cpu") -> NnFmeParams:
    with np.load(path) as z:
        return params_from_arrays(z, device)


_LUTS: dict = {}


def _luts(device):
    lut = _LUTS.get(str(device))
    if lut is None:
        lut = _LUTS[str(device)] = (
            torch.as_tensor(_SIZE_LUT_H).to(device),
            torch.as_tensor(_SIZE_LUT_W).to(device))
    return lut


def _dense(a, w, b):
    """a @ w.T + b with every product and sum rounded to float32 in
    ascending k order (the order K6 uses)."""
    acc = torch.zeros((a.shape[0], w.shape[0]), dtype=torch.float32,
                      device=a.device)
    for k in range(a.shape[1]):
        acc = acc + a[:, k:k + 1] * w[:, k][None, :]
    return acc + b


def forward_plain(params: NnFmeParams, costs9, heights, widths):
    """Plain version of K6's logits: (B, 9) float32 costs, (B,) int pel
    sizes -> (B, 49) float32 logits."""
    lut_h, lut_w = _luts(costs9.device)
    x = (costs9 - params.mean) / params.std * params.gin
    e0 = params.emb_h[lut_h[heights.to(torch.int64)].to(torch.int64)]
    e1 = params.emb_w[lut_w[widths.to(torch.int64)].to(torch.int64)]
    feat = torch.cat([e0, e1, x], -1)                     # (B, 17)
    h1 = torch.clamp(_dense(feat, params.w1, params.b1), min=0.0)
    h1 = h1 * params.g1 + params.beta1
    h2 = torch.clamp(_dense(h1, params.w2, params.b2), min=0.0)
    h2 = h2 * params.g2 + params.beta2
    return _dense(h2, params.w3, params.b3)


def _classes(logits):
    cls = logits.argmax(-1).to(torch.int32)               # first on ties
    offs = torch.stack([cls % 7 - 3, cls // 7 - 3], -1).to(torch.int32)
    return cls, offs


def _launch(params, costs9, heights, widths, want_logits):
    """K6: (logits (B, 49) or None, classes (B,), offsets (B, 2)) on the
    card; the kernel writes the logits only when they are wanted."""
    B = int(costs9.shape[0])
    dev = costs9.device
    logits = torch.empty((B, 49), dtype=torch.float32, device=dev) \
        if want_logits else None
    cls = torch.empty((B,), dtype=torch.int32, device=dev)
    offs = torch.empty((B, 2), dtype=torch.int32, device=dev)
    if B:
        kernels.launch("nnfme", "hm_nnfme",
                       params.packed,
                       costs9.to(torch.float32).contiguous(),
                       heights.to(torch.int32).contiguous(),
                       widths.to(torch.int32).contiguous(),
                       logits, cls, offs, B)
    return logits, cls, offs


def forward(params: NnFmeParams, costs9, heights, widths):
    """(B, 9) float32 costs [TL,T,TR,L,C,R,BL,B,BR], (B,) pel sizes ->
    (B, 49) logits: K6 on CUDA tensors, the plain version on CPU ones."""
    if costs9.is_cuda:
        return _launch(params, costs9, heights, widths, True)[0]
    return forward_plain(params, costs9, heights, widths)


def predict_offsets(params: NnFmeParams, costs9, heights, widths):
    """-> (classes (B,), quarter-pel offsets (B, 2) [x, y]) int32."""
    if costs9.is_cuda:
        _, cls, offs = _launch(params, costs9, heights, widths, False)
        return cls, offs
    return _classes(forward_plain(params, costs9, heights, widths))
