"""NN-FME training loop, the port of hmtpu/models/train.py (`TrainState`
:22, `loss_fn` :38, `train_step` :46, `standardize_fit` :57, `train`
:62): the 17->22->20->49 MLP, 49-way softmax cross-entropy, Adam at lr
3e-3, batch 1024.  optax's Adam state is `AdamState`; the optimizer has
no object of its own (the update is the tail of the step's backward).

Three hand-written kernels carry one step on the card, in two launches
(csrc/nnfme_train.cu):

  K14 nnfme_fwd  `loss_fwd`: the forward, each row's cross-entropy and
      hit, the mean loss and accuracy, and for the backward the logits'
      gradient and the two pre-activations;
  K15 nnfme_bwd  `loss_bwd`: the gradient of all 2060 packed parameters,
      summed over the batch in a fixed order (the same bits every run);
  K16 adam       optax.adam's update, in place, as the tail of K15's
      launch (`loss_bwd_adam`): the lane that finishes a parameter's
      gradient updates it and its moments.

`train_step` is K14 then K15 with its tail, after the batch's four
gathers: six launches.  Adam's step count lives on the device beside the
moments (`AdamState.dcount`; the host's `count` mirrors it), and the
bias corrections 1 - b^k are read there from a table built once a run
(`AdamState.bc`), so a step passes no host value that changes from step
to step: every argument of its launches is the same each step.
`NnFmeLoss` is the autograd.Function around K14 (forward) and K15
(backward, the gradient alone).  On CPU tensors each wrapper runs its
plain version (`*_plain`), which repeats the kernel's operations in the
same order.  The parameters, Adam's moments and the data live on the
device; a step gathers its batch with a device index tensor and never
waits for the card.  The parameters and moments are updated in place.

The batch sums' order: K14's loss and hit and K15's gradient are summed
over blocks of KROWS = 8 rows, each in ascending row order from 0
(`_block_sums`), then over the blocks in ascending order from 0
(`_col_sum`), on the card and in the plain versions alike (64-row
blocks before K14 and K15 put a row on a warp and 128 blocks on the
card at batch 1024).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hmtpu_torch import kernels
from hmtpu_torch.device import resolve
from hmtpu_torch.models.nnfme import (PACK_ORDER, PACK_SIZE, NnFme,
                                      NnFmeParams, forward_parts,
                                      init_random, params_from_packed)

# batch rows per thread block of K14 and K15 (csrc/nnfme_train.cuh
# KROWS, a row a warp); the plain versions sum a block's rows, then the
# blocks, in the same order
KROWS = 8
B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamState(NamedTuple):
    """optax's ScaleByAdamState: the moments as packed (PACK_SIZE,)
    float32 tensors, `count` the number of updates made (a host int),
    `dcount` the same count as a (1,) int32 tensor beside the moments
    (the one K15's tail reads and increments), and `bc` the bias
    corrections of updates 1..N, an (N, 2) float32 tensor of 1 - b1^k
    and 1 - b2^k (`bias_corrections`): an update past N is an error."""
    mu: torch.Tensor
    nu: torch.Tensor
    count: int
    dcount: torch.Tensor
    bc: torch.Tensor


class TrainState(NamedTuple):
    model: NnFme
    opt_state: AdamState
    step: int


def bias_corrections(n: int, device) -> torch.Tensor:
    """(n, 2) float32: row k - 1 holds 1 - b1^k and 1 - b2^k, numpy's
    float32 power as `_adam_scalars` computes them (a scalar each: the
    same bits as optax's float32 update)."""
    f = np.float32
    t = np.array([(f(1) - f(B1) ** f(k), f(1) - f(B2) ** f(k))
                  for k in range(1, n + 1)], np.float32).reshape(n, 2)
    return torch.as_tensor(t).to(device)


def adam_state(mu, nu, count: int, steps: int) -> AdamState:
    """The Adam state with moments mu, nu after `count` updates, ready
    for `steps` more (its table runs to update count + steps)."""
    return AdamState(mu, nu, count,
                     torch.tensor([count], dtype=torch.int32,
                                  device=mu.device),
                     bias_corrections(count + steps, mu.device))


def init_train_state(params: NnFmeParams, steps: int = 0) -> TrainState:
    """The model from `params` (on their device), zero moments, ready for
    `steps` updates."""
    model = NnFme(params)
    z = torch.zeros_like(params.packed)
    return TrainState(model, adam_state(z, z.clone(), 0, steps), 0)


# ---------------------------------------------------------------------------
# the plain versions' fixed summation order

def _block_sums(x):
    """(B, n) -> (ceil(B / KROWS), n): each block of KROWS rows summed in
    ascending row order from 0 (missing rows of the last block add 0)."""
    B = x.shape[0]
    nb = -(-B // KROWS)
    xp = torch.zeros((nb * KROWS, x.shape[1]), dtype=torch.float32,
                     device=x.device)
    xp[:B] = x
    xp = xp.reshape(nb, KROWS, -1)
    acc = torch.zeros((nb, xp.shape[2]), dtype=torch.float32,
                      device=x.device)
    for r in range(KROWS):
        acc = acc + xp[:, r]
    return acc


def _div(a, b: float):
    """a / b correctly rounded on every device (torch's CUDA division by
    a Python number multiplies by its reciprocal)."""
    return a / torch.full_like(a, b)


def _sqrt(a):
    """float32 square root correctly rounded on every device, as K16's
    `__fsqrt_rn` (torch's CPU sqrt is not: it differs from the card's in
    the last bit): the float64 root rounded to float32, then moved to its
    neighbour where the exact float64 test of the midpoint between them
    says so (squares of 25-bit midpoints are exact in float64)."""
    ad = a.double()
    y = torch.sqrt(ad).to(torch.float32)
    for step, wrong in ((float("inf"), lambda m: m * m < ad),
                        (0.0, lambda m: m * m > ad)):
        nb = torch.nextafter(y, torch.full_like(y, step))
        y = torch.where(wrong((y.double() + nb.double()) * 0.5), nb, y)
    return y


def _col_sum(part, div=None):
    """The blocks' partials summed in ascending block order from 0, then
    divided by `div` when given."""
    acc = torch.zeros(part.shape[1], dtype=torch.float32, device=part.device)
    for b in range(part.shape[0]):
        acc = acc + part[b]
    return _div(acc, div) if div else acc


def _dense_t(d, w):
    """d @ w with every product and sum rounded in ascending j order:
    (B, J) x (J, K) -> (B, K)."""
    acc = torch.zeros((d.shape[0], w.shape[1]), dtype=torch.float32,
                      device=d.device)
    for j in range(d.shape[1]):
        acc = acc + d[:, j:j + 1] * w[j][None, :]
    return acc


def _drelu(z):
    """d maximum(z, 0) / dz as JAX takes it: 0.5 at exactly 0."""
    return torch.where(z > 0, 1.0, torch.where(z == 0, 0.5, 0.0)) \
        .to(torch.float32)


def _inv(B: int) -> float:
    return float(np.float32(1.0) / np.float32(B))


# K14's and K15's partials: one float32 scratch tensor a device, kept
# between calls and grown when a call needs more (the kernels run on one
# stream, so a call has used its partials before the next call writes)
_SCRATCH: dict = {}


def _scratch(dev, n: int):
    t = _SCRATCH.get(dev)
    if t is None or t.numel() < n:
        t = _SCRATCH[dev] = torch.empty(n, dtype=torch.float32, device=dev)
    return t


# ---------------------------------------------------------------------------
# the exp and log of K14 and its plain version: Cephes' expf / logf with
# every operation rounded on its own (csrc/nnfme_train.cuh hm_expf /
# hm_logf do the same operations), so that the card and the CPU agree bit
# for bit, where torch's exp / log on the CPU and on the card differ in
# the last bit

_f32 = lambda v: float(np.float32(v))
_LOG2E, _LN2_HI, _LN2_LO = (_f32(1.44269504088896341), _f32(0.693359375),
                            _f32(-2.12194440e-4))
_EXP_P = tuple(_f32(v) for v in (1.9875691500e-4, 1.3981999507e-3,
                                 8.3334519073e-3, 4.1665795894e-2,
                                 1.6666665459e-1, 5.0000001201e-1))
_LOG_P = tuple(_f32(v) for v in (7.0376836292e-2, -1.1514610310e-1,
                                 1.1676998740e-1, -1.2420140846e-1,
                                 1.4249322787e-1, -1.6668057665e-1,
                                 2.0000714765e-1, -2.4999993993e-1,
                                 3.3333331174e-1))
_SQRT_HALF = _f32(0.707106781186547524)


def exp_f32(x):
    """e^x of float32 x <= 88: x = k ln2 + r, a degree-7 polynomial in r,
    times 2^k from its bits; 0 below x = -87."""
    k = torch.floor(x * _LOG2E + 0.5)
    r = (x - k * _LN2_HI) - k * _LN2_LO
    z = r * r
    y = r * _EXP_P[0] + _EXP_P[1]
    for c in _EXP_P[2:]:
        y = y * r + c
    y = (y * z + r) + 1.0
    k = torch.clamp(k, -126.0, 127.0).to(torch.int32)
    y = y * ((k + 127) << 23).view(torch.float32)
    return torch.where(x < -87.0, 0.0, y)


def log_f32(x):
    """log x of positive normal float32 x: x = m 2^e with m in
    [sqrt(1/2), sqrt(2)), a degree-9 polynomial in m - 1, plus e ln2."""
    b = x.contiguous().view(torch.int32)
    m = ((b & 0x007fffff) | 0x3f000000).view(torch.float32)
    low = m < _SQRT_HALF
    e = ((b >> 23) - 126 - low.to(torch.int32)).to(torch.float32)
    m = torch.where(low, (m + m) - 1.0, m - 1.0)
    z = m * m
    y = m * _LOG_P[0] + _LOG_P[1]
    for c in _LOG_P[2:]:
        y = y * m + c
    y = (y * m) * z
    y = y + e * _LN2_LO
    y = y + z * -0.5
    return (m + y) + e * _LN2_HI


# ---------------------------------------------------------------------------
# K14: forward, loss and the logits' gradient

def loss_fwd_plain(packed, costs9, heights, widths, labels,
                   want_grad: bool = True):
    """Plain version of K14; same return value as `loss_fwd`."""
    B = int(costs9.shape[0])
    f = forward_parts(params_from_packed(packed), costs9, heights, widths)
    lg = f["logits"]
    best = lg.argmax(-1)                                  # first on ties
    m = lg.gather(1, best[:, None])[:, 0]
    e = exp_f32(lg - m[:, None])
    s = torch.zeros(B, dtype=torch.float32, device=lg.device)
    for j in range(49):
        s = s + e[:, j]
    y = torch.clamp(labels.to(torch.int64), 0, 48)
    loss = (log_f32(s) + m) - lg.gather(1, y[:, None])[:, 0]
    hit = (best == y).to(torch.float32)
    out = _col_sum(_block_sums(torch.stack([loss, hit], 1)), float(B))
    if not want_grad:
        return out, None
    inv_b = _inv(B)
    dl = e * (torch.tensor(inv_b, dtype=torch.float32, device=lg.device)
              / s)[:, None]
    ar = torch.arange(B, device=lg.device)
    dl[ar, y] = dl[ar, y] - inv_b
    return out, (f["z1"], f["z2"], dl)


def loss_fwd(packed, costs9, heights, widths, labels,
             want_grad: bool = True):
    """The mean softmax cross-entropy and the accuracy of the MLP on a
    batch (loss_fn's two values), as one (2,) float32 tensor, and for the
    backward (z1 (B, 22), z2 (B, 20), d mean loss / d logits (B, 49)), or
    None when not `want_grad`.  K14 on CUDA tensors, the plain version on
    CPU ones."""
    if not costs9.is_cuda:
        return loss_fwd_plain(packed, costs9, heights, widths, labels,
                              want_grad)
    B = int(costs9.shape[0])
    if B == 0 or tuple(costs9.shape) != (B, 9) \
            or tuple(packed.shape) != (PACK_SIZE,):
        raise ValueError(f"nnfme_fwd: expected (B, 9) costs, B > 0, and "
                         f"({PACK_SIZE},) parameters, got "
                         f"{tuple(costs9.shape)} / {tuple(packed.shape)}")
    dev = costs9.device
    e = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    i32 = lambda a: a.to(torch.int32).contiguous()
    out = e(2)
    saved = (e(B, 22), e(B, 20), e(B, 49)) if want_grad else None
    kernels.launch("nnfme_fwd", "hm_nnfme_fwd", packed.detach(),
                   costs9.to(torch.float32).contiguous(), i32(heights),
                   i32(widths), i32(labels), *(saved or (None,) * 3),
                   _scratch(dev, 2 * -(-B // KROWS)), out, B, _inv(B))
    return out, saved


def loss_fn(params: NnFmeParams, costs9, heights, widths, labels):
    """(mean softmax cross-entropy, accuracy) of the MLP on a batch, as
    device scalars: K14 without the backward's tensors."""
    with torch.no_grad():
        out, _ = loss_fwd(params.packed, costs9, heights, widths, labels,
                          want_grad=False)
    return out[0], out[1]


# ---------------------------------------------------------------------------
# K15: the backward and the batch reduction

def row_grads_plain(packed, costs9, heights, widths, z1, z2, dl, gscale):
    """Each row's share of the gradient, (B, PACK_SIZE) in PACK_ORDER,
    every product and sum rounded as K15 rounds it."""
    p = params_from_packed(packed)
    f = forward_parts(p, costs9, heights, widths)
    u, v, feat = f["u"], f["v"], f["feat"]
    a1, a2 = torch.clamp(z1, min=0.0), torch.clamp(z2, min=0.0)
    h1, h2 = a1 * p.g1 + p.beta1, a2 * p.g2 + p.beta2
    dl = dl * gscale
    dh2 = _dense_t(dl, p.w3)
    dz2 = (dh2 * p.g2) * _drelu(z2)
    dh1 = _dense_t(dz2, p.w2)
    dz1 = (dh1 * p.g1) * _drelu(z1)
    df = _dense_t(dz1, p.w1)
    dx = df[:, 8:]
    dv = dx * p.gin
    emb = lambda rows, d: torch.where(
        rows[:, None, None] == torch.arange(8, device=d.device)[None, :, None],
        d[:, None, :], 0.0)
    outer = lambda a, b: (a[:, :, None] * b[:, None, :]).reshape(a.shape[0],
                                                                   -1)
    g = {"mean": -(dv / p.std),
         "std": -((dv * (1.0 / (p.std * p.std))) * u),
         "gin": dx * v,
         "emb_h": emb(f["rh"], df[:, 0:4]), "emb_w": emb(f["rw"], df[:, 4:8]),
         "w1": outer(dz1, feat), "b1": dz1, "g1": dh1 * a1, "beta1": dh1,
         "w2": outer(dz2, h1), "b2": dz2, "g2": dh2 * a2, "beta2": dh2,
         "w3": outer(dl, h2), "b3": dl}
    return torch.cat([g[k].reshape(g[k].shape[0], -1) for k in PACK_ORDER],
                     1)


def loss_bwd_plain(packed, costs9, heights, widths, z1, z2, dl, gscale):
    """Plain version of K15."""
    return _col_sum(_block_sums(row_grads_plain(
        packed, costs9, heights, widths, z1, z2, dl, gscale)))


def _bwd_launch(packed, costs9, heights, widths, z1, z2, dl, gscale,
                opt=None, lr: float = 0.0):
    """K15's launch, with K16 as its tail where `opt` is given."""
    B = int(costs9.shape[0])
    if B == 0 or tuple(dl.shape) != (B, 49):
        raise ValueError(f"nnfme_bwd: expected (B, 49) d-logits, B > 0, got"
                         f" {tuple(dl.shape)}")
    dev = costs9.device
    grad = torch.empty(PACK_SIZE, dtype=torch.float32, device=dev)
    i32 = lambda a: a.to(torch.int32).contiguous()
    upd = (opt.mu, opt.nu, opt.dcount, opt.bc, int(opt.bc.shape[0]),
           *_adam_consts(lr)) if opt is not None else (None,) * 4 + (0,) \
        + (0.0,) * 6
    kernels.launch("nnfme_bwd", "hm_nnfme_bwd", packed.detach(),
                   costs9.to(torch.float32).contiguous(), i32(heights),
                   i32(widths), z1, z2, dl,
                   gscale.to(torch.float32).contiguous(),
                   _scratch(dev, -(-B // KROWS) * PACK_SIZE), grad, B, *upd)
    return grad


def loss_bwd(packed, costs9, heights, widths, z1, z2, dl, gscale):
    """The gradient of the mean loss (scaled by the (1,) cotangent
    `gscale`) with respect to all PACK_SIZE parameters, from K14's saved
    tensors: K15 on CUDA tensors, the plain version on CPU ones."""
    if not costs9.is_cuda:
        return loss_bwd_plain(packed, costs9, heights, widths, z1, z2, dl,
                              gscale)
    return _bwd_launch(packed, costs9, heights, widths, z1, z2, dl, gscale)


class NnFmeLoss(torch.autograd.Function):
    """[mean cross-entropy, accuracy] of the MLP on a batch as one (2,)
    tensor, differentiable in the packed parameters (the accuracy's
    cotangent is ignored): K14 forward, K15 backward."""

    @staticmethod
    def forward(ctx, packed, costs9, heights, widths, labels):
        out, saved = loss_fwd(packed, costs9, heights, widths, labels)
        ctx.save_for_backward(packed, costs9, heights, widths, *saved)
        return out

    @staticmethod
    def backward(ctx, gout):
        packed, costs9, heights, widths, z1, z2, dl = ctx.saved_tensors
        grad = loss_bwd(packed, costs9, heights, widths, z1, z2, dl,
                        gout[:1])
        return grad, None, None, None, None


# ---------------------------------------------------------------------------
# K16: optax.adam's update, K15's tail

def _adam_consts(lr: float):
    """float32 b1, 1 - b1, b2, 1 - b2, eps and -lr as Python floats: the
    update's arguments that are the same every step."""
    f = np.float32
    return [float(x) for x in (f(B1), f(1 - B1), f(B2), f(1 - B2), f(EPS),
                               f(-lr))]


def _adam_scalars(count: int, lr: float):
    """float32 b1, 1 - b1, b2, 1 - b2, the bias corrections 1 - b^count
    (numpy's float32 power), eps and -lr, as Python floats."""
    f = np.float32
    return [float(x) for x in (
        f(B1), f(1 - B1), f(B2), f(1 - B2),
        f(1) - f(B1) ** f(count), f(1) - f(B2) ** f(count), f(EPS),
        f(-lr))]


def adam_update_plain(p, g, mu, nu, count: int, lr: float) -> None:
    """Plain version of K16 (in place)."""
    b1, omb1, b2, omb2, bc1, bc2, eps, neg_lr = _adam_scalars(count, lr)
    m = omb1 * g + b1 * mu
    v = omb2 * (g * g) + b2 * nu
    mu.copy_(m)
    nu.copy_(v)
    p.copy_(p + neg_lr * (_div(m, bc1) / (_sqrt(_div(v, bc2)) + eps)))


def loss_bwd_adam_plain(packed, costs9, heights, widths, z1, z2, dl,
                        gscale, opt: AdamState, lr: float):
    """Plain version of K15 with K16 as its tail: `loss_bwd_plain`, then
    `adam_update_plain` of update opt.count + 1, and opt.dcount + 1."""
    grad = loss_bwd_plain(packed, costs9, heights, widths, z1, z2, dl,
                          gscale)
    adam_update_plain(packed, grad, opt.mu, opt.nu, opt.count + 1, lr)
    opt.dcount.add_(1)
    return grad


def loss_bwd_adam(packed, costs9, heights, widths, z1, z2, dl, gscale,
                  opt: AdamState, lr: float):
    """`loss_bwd`'s gradient (returned) and the Adam update it feeds:
    `packed`, opt.mu and opt.nu updated in place with update opt.count +
    1's bias corrections from opt.bc, opt.dcount incremented (the host's
    opt.count is the caller's to advance).  K15 with K16 as its tail on
    CUDA tensors (one launch), the plain version on CPU ones."""
    n = int(packed.numel())
    if not (opt.mu.numel() == opt.nu.numel() == n):
        raise ValueError("adam: parameters and moments must match")
    if opt.count >= opt.bc.shape[0]:
        raise ValueError(f"adam: update {opt.count + 1} is past the bias "
                         f"corrections' table of {opt.bc.shape[0]} (the "
                         f"run's step count)")
    if not costs9.is_cuda:
        return loss_bwd_adam_plain(packed, costs9, heights, widths, z1, z2,
                                   dl, gscale, opt, lr)
    return _bwd_launch(packed, costs9, heights, widths, z1, z2, dl, gscale,
                       opt, lr)


# ---------------------------------------------------------------------------
# the loop

# the mean loss's cotangent, 1: made once a device (a copy from the host
# would sync a step)
_ONE: dict = {}


def _loss_cotangent(dev):
    t = _ONE.get(dev)
    if t is None:
        t = _ONE[dev] = torch.ones(1, dtype=torch.float32, device=dev)
    return t


def train_step(state: TrainState, costs9, heights, widths, labels,
               lr: float = 3e-3):
    """One optimizer step on a batch, K14 then K15 with K16 as its tail:
    returns (the state, updated in place, with step + 1 and the Adam
    count + 1; mean loss; accuracy), the two numbers as device
    scalars."""
    packed = state.model.packed
    opt = state.opt_state
    with torch.no_grad():
        out, saved = loss_fwd(packed, costs9, heights, widths, labels)
        loss_bwd_adam(packed, costs9, heights, widths, *saved,
                      _loss_cotangent(out.device), opt, lr)
    return (TrainState(state.model, opt._replace(count=opt.count + 1),
                       state.step + 1), out[0], out[1])


def standardize_fit(costs9: np.ndarray):
    """Per-feature mean/std (the notebook's sklearn mapper export)."""
    return costs9.mean(axis=0), costs9.std(axis=0) + 1e-8


def train(costs9: np.ndarray, heights: np.ndarray, widths: np.ndarray,
          labels: np.ndarray, epochs: int = 200, batch_size: int = 1024,
          lr: float = 3e-3, val_split: float = 0.2, seed: int = 0,
          log_every: int = 0, device="cuda",
          init: NnFmeParams | None = None, losses: list | None = None):
    """Returns (params with the fitted mean/std folded in and trained,
    validation accuracy).  hmtpu's batches: numpy RandomState(seed)
    permutations, the last partial batch kept, the validation 20 % from
    the same permutation.  `init`: the starting parameters (e.g. hmtpu's
    init carried across), else the port's init from `seed`.  `losses`
    collects each step's loss (a device scalar)."""
    dev = resolve(device)
    rng = np.random.RandomState(seed)
    n = len(labels)
    perm = rng.permutation(n)
    n_val = max(1, int(n * val_split))
    vi, ti = perm[:n_val], perm[n_val:]
    mean, std = standardize_fit(costs9[ti])

    if init is None:
        init = init_random(torch.Generator().manual_seed(seed), dev)
    start = params_from_packed(init.packed.detach().to(dev).clone())
    start.mean.copy_(torch.as_tensor(np.asarray(mean, np.float32)))
    start.std.copy_(torch.as_tensor(np.asarray(std, np.float32)))
    state = init_train_state(start, epochs * -(-len(ti) // batch_size))

    c9 = torch.as_tensor(np.asarray(costs9, np.float32)).to(dev)
    hh = torch.as_tensor(np.asarray(heights, np.int32)).to(dev)
    ww = torch.as_tensor(np.asarray(widths, np.int32)).to(dev)
    ll = torch.as_tensor(np.asarray(labels, np.int32)).to(dev)
    vt = torch.as_tensor(vi).to(dev)

    def val_acc():
        return float(loss_fn(state.model.params(), c9[vt], hh[vt], ww[vt],
                             ll[vt])[1])

    for ep in range(epochs):
        order = torch.as_tensor(rng.permutation(ti)).to(dev)
        for s in range(0, len(ti), batch_size):
            b = order[s:s + batch_size]
            state, loss, _ = train_step(state, c9[b], hh[b], ww[b], ll[b],
                                        lr=lr)
            if losses is not None:
                losses.append(loss)
        if log_every and (ep + 1) % log_every == 0:
            print(f"epoch {ep + 1}: val acc {val_acc():.4f}")
    return state.model.params(), val_acc()
