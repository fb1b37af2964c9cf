"""NN-FME: the per-QP MLP that replaces DCT-IF fractional-pel motion
search (the fork's contribution), the port of hmtpu/models/nnfme.py
(`NnFmeParams` :34, the row tables :52-61, `save_npz` :100, `load_npz`
:105, `init_random` :111, `forward` :127, `predict_offsets` :143,
`class_of_offsets` :153).

Architecture (TEncSearch.cpp:85-131 of the reference):
  x = (costs9 - mean) / std * gin
  e0 = emb_h[row(height)], e1 = emb_w[row(width)]     (8x4 tables)
  h1 = relu(W1 @ [e0,e1,x] + b1) * g1 + beta1          (22)
  h2 = relu(W2 @ h1 + b2) * g2 + beta2                 (20)
  logits = W3 @ h2 + b3                                (49)
  class -> quarter-pel offsets: qx = cls%7-3, qy = cls//7-3
Cost stencil order: [TL, T, TR, L, C, R, BL, B, BR].

On CUDA tensors `forward` / `predict_offsets` (one level's float32
costs, per-row sizes) and `predict_offsets_levels` (the P pass's call:
up to three levels' int32 stencils and pel sizes) launch the
hand-written kernel K6 (csrc/nnfme.cu), once a call; on CPU tensors
they run the plain version (`forward_plain`, `_classes`,
`predict_offsets_levels_plain`).  Both sum every dot product in ascending k order with
one rounded float32 multiply and one rounded add per term (no FMA), so
the card and the CPU give the same bits.  hmtpu's XLA dot sums in
another order: logits agree with it to about 1e-4 (absolute), and the
class agrees wherever the top two logits are further apart than that.

The encoder loads the per-QP files under models/weights/ (or those of
`EncoderConfig.nn_weights_dir`); models/dataset.py and models/train.py
make new ones (python -m hmtpu_torch.apps.train_nnfme).  `NnFme` is the
trainable form: the fields packed into one `nn.Parameter`.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from hmtpu_torch import kernels
from hmtpu_torch.device import resolve

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


_SHAPES = {"mean": (9,), "std": (9,), "gin": (9,), "emb_h": (8, 4),
           "emb_w": (8, 4), "w1": (22, 17), "b1": (22,), "g1": (22,),
           "beta1": (22,), "w2": (20, 22), "b2": (20,), "g2": (20,),
           "beta2": (20,), "w3": (49, 20), "b3": (49,)}


def params_from_packed(packed) -> NnFmeParams:
    """NnFmeParams whose fields are views of one packed (PACK_SIZE,)
    float32 vector."""
    if tuple(packed.shape) != (PACK_SIZE,):
        raise ValueError(f"nnfme: packed parameters must be ({PACK_SIZE},),"
                         f" got {tuple(packed.shape)}")
    fields, o = {}, 0
    for k in PACK_ORDER:
        n = int(np.prod(_SHAPES[k]))
        fields[k] = packed[o:o + n].view(_SHAPES[k])
        o += n
    return NnFmeParams(**fields, packed=packed)


def load_npz(path: str, device="cuda") -> NnFmeParams:
    """A qp*.npz weight file (this package's or hmtpu's) on `device`
    (the card unless the caller asks for the CPU)."""
    with np.load(path) as z:
        return params_from_arrays(z, resolve(device))


def save_npz(path: str, params: NnFmeParams) -> None:
    """The 15 fields as float32 arrays by name, hmtpu's layout: the file
    loads in both packages."""
    np.savez(path, **{k: getattr(params, k).detach().cpu().numpy()
                      .astype(np.float32) for k in PACK_ORDER})


def init_random(generator: torch.Generator, device="cuda") -> NnFmeParams:
    """hmtpu's random init (normal x 0.1 embeddings, glorot-uniform
    weights, zero biases, unit BN scales, mean 5e4, std 1.5e5), drawn on
    the CPU from `generator` and then moved to `device`, so the card and
    the CPU start from the same numbers.  torch's generator is not
    jax.random: the same seed gives other numbers than hmtpu's."""
    def glorot(shape):
        # jax.nn.initializers.glorot_uniform: fan_in = shape[-2],
        # fan_out = shape[-1], limit sqrt(6 / (fan_in + fan_out))
        limit = float(np.sqrt(6.0 / (shape[-2] + shape[-1])))
        return torch.empty(shape).uniform_(-1.0, 1.0,
                                           generator=generator) * limit

    f = {
        "emb_h": torch.randn((8, 4), generator=generator) * 0.1,
        "emb_w": torch.randn((8, 4), generator=generator) * 0.1,
        "w1": glorot((22, 17)), "b1": torch.zeros(22),
        "g1": torch.ones(22), "beta1": torch.zeros(22),
        "w2": glorot((20, 22)), "b2": torch.zeros(20),
        "g2": torch.ones(20), "beta2": torch.zeros(20),
        "w3": glorot((49, 20)), "b3": torch.zeros(49),
        "gin": torch.ones(9),
        "mean": torch.full((9,), 5e4), "std": torch.full((9,), 1.5e5),
    }
    return params_from_arrays({k: v.numpy() for k, v in f.items()},
                              resolve(device))


class NnFme(torch.nn.Module):
    """The trainable NN-FME MLP: its 15 fields packed into one float32
    `nn.Parameter` (PACK_ORDER, K6's layout, which K14-K16 read too)."""

    def __init__(self, params: NnFmeParams):
        super().__init__()
        self.packed = torch.nn.Parameter(params.packed.detach().clone())

    def params(self) -> NnFmeParams:
        """The fields as views of the parameter (detached)."""
        return params_from_packed(self.packed.detach())


def class_of_offsets(qx, qy):
    """Ground-truth class from the true quarter-pel offsets (dataset
    extraction; the inverse of cls -> (cls % 7 - 3, cls // 7 - 3))."""
    return (qy + 3) * 7 + (qx + 3)


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


def forward_parts(params: NnFmeParams, costs9, heights, widths):
    """The plain forward with what the training kernels keep: a dict of
    the size-table rows `rh`, `rw` (B,), the standardisation's `u` =
    costs - mean and `v` = u / std (B, 9), the features `feat` (B, 17),
    the pre-activations `z1` (B, 22) and `z2` (B, 20), the activations
    `a1` = relu(z1), `a2`, `h1` = a1 g1 + beta1, `h2`, and the `logits`
    (B, 49); each operation rounded as K6 rounds it."""
    lut_h, lut_w = _luts(costs9.device)
    rh = lut_h[torch.clamp(heights.to(torch.int64), 0, 64)].to(torch.int64)
    rw = lut_w[torch.clamp(widths.to(torch.int64), 0, 64)].to(torch.int64)
    u = costs9 - params.mean
    v = u / params.std
    feat = torch.cat([params.emb_h[rh], params.emb_w[rw], v * params.gin],
                     -1)                                   # (B, 17)
    z1 = _dense(feat, params.w1, params.b1)
    a1 = torch.clamp(z1, min=0.0)
    h1 = a1 * params.g1 + params.beta1
    z2 = _dense(h1, params.w2, params.b2)
    a2 = torch.clamp(z2, min=0.0)
    h2 = a2 * params.g2 + params.beta2
    return dict(rh=rh, rw=rw, u=u, v=v, feat=feat, z1=z1, a1=a1, h1=h1,
                z2=z2, a2=a2, h2=h2,
                logits=_dense(h2, params.w3, params.b3))


def forward_plain(params: NnFmeParams, costs9, heights, widths):
    """Plain version of K6's logits: (B, 9) float32 costs, (B,) int pel
    sizes -> (B, 49) float32 logits."""
    return forward_parts(params, costs9, heights, widths)["logits"]


def _classes(logits):
    cls = logits.argmax(-1).to(torch.int32)               # first on ties
    offs = torch.stack([cls % 7 - 3, cls // 7 - 3], -1).to(torch.int32)
    return cls, offs


def _launch(params, costs, sizes, heights, widths, want_logits):
    """K6 over the rows of up to three levels (costs: each level's (B_l,
    9) float32 costs or its int32 stencils, (..., 3, 3)), each level's pel
    size or, for one level, per-row heights and widths: (logits (B, 49)
    or None, classes (B,), offsets (B, 2)) of the levels' rows in turn;
    the kernel writes the logits only when they are wanted.  The P pass
    calls it once a frame in a host-bound stretch, so the tensors are
    checked here and go to kernels.launch_checked as pointers."""
    dt = costs[0].dtype
    if dt is not torch.float32 and dt is not torch.int32 or any(
            c.dtype is not dt or c.numel() % 9 for c in costs):
        raise ValueError(f"nnfme: costs must be float32 or int32 rows of "
                         f"9, one type for all levels; got "
                         f"{[(c.dtype, tuple(c.shape)) for c in costs]}")
    cs = [c.contiguous() for c in costs]
    hw = [heights.contiguous(), widths.contiguous()] \
        if heights is not None else []
    dev = cs[0].get_device()
    if any(t.get_device() != dev for t in cs + hw + [params.packed]):
        raise ValueError("nnfme: the weights, costs and sizes must lie on "
                         "one CUDA device")
    rows = [c.numel() // 9 for c in cs]
    B = sum(rows)
    out = lambda shape, t: torch.empty(shape, dtype=t, device=cs[0].device)
    logits = out((B, 49), torch.float32) if want_logits else None
    cls, offs = out((B,), torch.int32), out((B, 2), torch.int32)
    if B:
        pad = 3 - len(cs)
        kernels.launch_checked(
            "nnfme", "hm_nnfme", dev, params.packed.data_ptr(),
            *(c.data_ptr() for c in cs), *(None,) * pad,
            *((t.data_ptr() for t in hw) if hw else (None, None)),
            None if logits is None else logits.data_ptr(), cls.data_ptr(),
            offs.data_ptr(), *rows, *(0,) * pad, *sizes, *(0,) * pad,
            len(cs), int(dt is torch.float32))
    return logits, cls, offs


def _launch1(params, costs9, heights, widths, want_logits):
    """K6 on one level's float32 costs with per-row sizes."""
    return _launch(params, [costs9.to(torch.float32)], [0],
                   heights.to(torch.int32).contiguous(),
                   widths.to(torch.int32).contiguous(), want_logits)


def forward(params: NnFmeParams, costs9, heights, widths):
    """(B, 9) float32 costs [TL,T,TR,L,C,R,BL,B,BR], (B,) pel sizes ->
    (B, 49) logits: K6 on CUDA tensors, the plain version on CPU ones."""
    if costs9.is_cuda:
        return _launch1(params, costs9, heights, widths, True)[0]
    return forward_plain(params, costs9, heights, widths)


def predict_offsets(params: NnFmeParams, costs9, heights, widths):
    """-> (classes (B,), quarter-pel offsets (B, 2) [x, y]) int32."""
    if costs9.is_cuda:
        _, cls, offs = _launch1(params, costs9, heights, widths, False)
        return cls, offs
    return _classes(forward_plain(params, costs9, heights, widths))


def predict_offsets_levels_plain(params: NnFmeParams, stencils, sizes):
    """Plain version of K6's level form: each level's stencils cast to
    float32 rows of 9, its pel size for every row, then `forward_plain`
    and `_classes`, a level at a time."""
    out = []
    for st, n in zip(stencils, sizes):
        st9 = st.reshape(-1, 9).to(torch.float32)
        sz = torch.full((st9.shape[0],), n, dtype=torch.int32,
                        device=st9.device)
        out.append(_classes(forward_plain(params, st9, sz, sz)))
    return out


def predict_offsets_levels(params: NnFmeParams, stencils, sizes):
    """The sub-pel offsets of up to three CU levels in one call: each
    level's int32 cost stencils as ME gives them ((..., 3, 3)) and its
    pel size (square PUs) -> [(classes (B_l,), offsets (B_l, 2))] a
    level.  One K6 launch on CUDA tensors, the plain version on CPU
    ones."""
    if not 1 <= len(stencils) == len(sizes) <= 3:
        raise ValueError(f"nnfme: 1-3 levels with a size each, got "
                         f"{len(stencils)} and {len(sizes)}")
    if not stencils[0].is_cuda:
        return predict_offsets_levels_plain(params, stencils, sizes)
    _, cls, offs = _launch(params, list(stencils), [int(n) for n in sizes],
                           None, None, False)
    rows = [s.numel() // 9 for s in stencils]
    return list(zip(cls.split(rows), offs.split(rows)))
