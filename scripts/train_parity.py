"""Where the NN-FME trainer's card and CPU runs part: the same batch
through each stage of one training step (K14-K16's plain versions) on
the card and on the CPU, each stage fed the CPU's inputs so that a
difference belongs to that stage alone.  Prints per stage the values
that differ and the largest relative difference, then the first stage
that differs (or that none does); then the trainer's own run (its
clip, QP 22) step by step on both devices, and at the first step that
differs, that step's inputs through K14-K16 and their plain versions,
and each operation of the plain Adam.

    PYTHONPATH=. python scripts/train_parity.py    # from the repo's root

A batch of 1024 seeded records and the trainer's first 50 steps.  Needs
a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import sys

import numpy as np
import torch


def _batch(rows: int, seed: int):
    """Seeded records shaped like the trainer's (costs of a QP-22 clip
    at sizes 8/16/32, 49 classes)."""
    rng = np.random.RandomState(seed)
    base = rng.randint(200, 6000, (rows, 1))
    c9 = (base + rng.randint(0, 900, (rows, 9))).astype(np.float32)
    hw = [rng.choice([8, 16, 32], rows).astype(np.int32) for _ in range(2)]
    return c9, hw[0], hw[1], rng.randint(0, 49, rows).astype(np.int32)


def _diff(a, b):
    """(differing values, values, max relative difference) of two float
    tensors, or of tuples of them."""
    if isinstance(a, (tuple, list)):
        parts = [_diff(x, y) for x, y in zip(a, b)]
        return (sum(p[0] for p in parts), sum(p[1] for p in parts),
                max(p[2] for p in parts))
    a, b = a.detach().cpu(), b.detach().cpu()
    if not a.is_floating_point():
        return int((a != b).sum()), a.numel(), float((a != b).any())
    ne = a.view(torch.int32) != b.view(torch.int32)
    scale = float(b.abs().max()) or 1.0
    return (int(ne.sum()), a.numel(),
            float((a.double() - b.double()).abs().max()) / scale)


def stages(rows: int, seed: int, dev):
    """[(stage, differing, values, max relative difference)]."""
    from hmtpu_torch.models import nnfme, train

    c9, hh, ww, ll = _batch(rows, seed)
    params = nnfme.init_random(torch.Generator().manual_seed(seed), "cpu")
    params.mean.copy_(torch.as_tensor(c9.mean(0)))
    params.std.copy_(torch.as_tensor(c9.std(0) + np.float32(1e-8)))
    cpu = dict(packed=params.packed, c9=torch.as_tensor(c9),
               hh=torch.as_tensor(hh), ww=torch.as_tensor(ww),
               ll=torch.as_tensor(ll))
    card = {k: v.to(dev) for k, v in cpu.items()}
    out = []

    def stage(name, fn, *keys):
        """fn on the CPU's inputs and on the same inputs on the card."""
        a = fn(*[cpu[k] for k in keys])
        b = fn(*[card[k] if k in card else cpu[k].to(dev) for k in keys])
        torch.cuda.synchronize()
        out.append((name,) + _diff(b, a))
        return a

    f = stage("forward (features, dense layers, logits)",
              lambda p, c, h, w: tuple(nnfme.forward_parts(
                  nnfme.params_from_packed(p), c, h, w)[k]
                  for k in ("v", "feat", "z1", "h1", "z2", "h2", "logits")),
              "packed", "c9", "hh", "ww")
    cpu["lg"] = f[-1]
    best = cpu["lg"].argmax(-1)
    cpu["x"] = cpu["lg"] - cpu["lg"].gather(1, best[:, None])
    e = stage("exp (torch.exp of logits - max)", torch.exp, "x")
    cpu["s"] = e.sum(1)
    stage("log (torch.log of the exp sums)", torch.log, "s")
    stage("exp_f32 (K14's exp) of logits - max", train.exp_f32, "x")
    stage("log_f32 (K14's log) of the exp sums", train.log_f32, "s")
    saved = stage("K14's plain version (loss, accuracy; z1, z2, d-logits)",
                  lambda p, c, h, w, y: (lambda o: (o[0],) + o[1])(
                      train.loss_fwd_plain(p, c, h, w, y)),
                  "packed", "c9", "hh", "ww", "ll")
    cpu["z1"], cpu["z2"], cpu["dl"] = saved[1:]
    cpu["one"] = torch.ones(1)
    g = stage("K15's plain version (the gradient)", train.loss_bwd_plain,
              "packed", "c9", "hh", "ww", "z1", "z2", "dl", "one")
    cpu["g"] = g

    def adam(p, g):
        p, mu, nu = p.clone(), torch.zeros_like(p), torch.zeros_like(p)
        train.adam_update_plain(p, g, mu, nu, 1, 3e-3)
        return p, mu, nu

    stage("K16's plain version (Adam)", adam, "packed", "g")
    cpu["v"] = torch.as_tensor(np.random.RandomState(seed).rand(1 << 20)
                               .astype(np.float32)) * 1e-5
    stage("sqrt (torch.sqrt of Adam-sized second moments)", torch.sqrt, "v")
    stage("K16's sqrt (_sqrt) of the same", train._sqrt, "v")
    return out


def _record_steps(log):
    """Wrap `train.train_step` so that each step appends (packed before,
    batch, loss, packed after) to `log`; returns the undo."""
    from hmtpu_torch.models import train

    inner = train.train_step

    def step(state, costs9, heights, widths, labels, lr=3e-3):
        opt = state.opt_state
        before = state.model.packed.detach().cpu().clone()
        moments = (opt.mu.cpu().clone(), opt.nu.cpu().clone(), opt.count)
        out = inner(state, costs9, heights, widths, labels, lr=lr)
        log.append((before, tuple(a.cpu() for a in (costs9, heights, widths,
                                                     labels)),
                    out[1].detach().cpu().clone(),
                    out[0].model.packed.detach().cpu().clone(), moments))
        return out

    train.train_step = step
    return lambda: setattr(train, "train_step", inner)


def _adam_parts(p, g, mu, nu, count: int, dev, lr: float = 3e-3):
    """Each operation of `adam_update_plain` on the card and on the CPU,
    fed the CPU's inputs: the values that differ, and the first of them."""
    from hmtpu_torch.models import train

    b1, omb1, b2, omb2, bc1, bc2, eps, neg_lr = train._adam_scalars(count,
                                                                    lr)
    ops = (("g * g", lambda t: t["g"] * t["g"]),
           ("(1 - b2) * g^2", lambda t: omb2 * t["g * g"]),
           ("b2 * nu", lambda t: b2 * t["nu"]),
           ("nu'", lambda t: t["(1 - b2) * g^2"] + t["b2 * nu"]),
           ("(1 - b1) * g", lambda t: omb1 * t["g"]),
           ("b1 * mu", lambda t: b1 * t["mu"]),
           ("mu'", lambda t: t["(1 - b1) * g"] + t["b1 * mu"]),
           ("mu' / bc1", lambda t: train._div(t["mu'"], bc1)),
           ("nu' / bc2", lambda t: train._div(t["nu'"], bc2)),
           ("sqrt", lambda t: torch.sqrt(t["nu' / bc2"])),
           ("sqrt + eps", lambda t: t["sqrt"] + eps),
           ("ratio", lambda t: t["mu' / bc1"] / t["sqrt + eps"]),
           ("-lr * ratio", lambda t: neg_lr * t["ratio"]),
           ("p'", lambda t: t["p"] + t["-lr * ratio"]))
    cpu = dict(p=p, g=g, mu=mu, nu=nu)
    lines = []
    for name, fn in ops:
        want = fn(cpu)
        card = {k: v.to(dev) for k, v in cpu.items()}
        got = fn(card).cpu()
        cpu[name] = want
        ne = (got.view(torch.int32) != want.view(torch.int32)).nonzero()
        if len(ne):
            i = int(ne[0, 0])
            lines.append(f"{name}: {len(ne)} differ, e.g. index {i}: card "
                         f"{float(got[i])!r}, CPU {float(want[i])!r}")
    return lines or ["every operation equal"]


def lockstep(steps: int, dev, qp: int = 22):
    """The trainer's own run (its synthetic 416x240 clip of 24 frames, SR
    16, QP `qp`, batch 1024, seed 0) on the card and on the CPU for
    `steps` steps; at the first step whose loss or update differs, that
    step's inputs (the CPU's) through K14 and K15 with K16 as its tail on
    the card, their plain versions on the card and on the CPU.  Returns printable lines."""
    from hmtpu_torch.io.yuv import Frame
    from hmtpu_torch.models import dataset, train
    from hmtpu_torch.utils.gen_test_yuv import synth_clip

    frames = [Frame(*(np.asarray(p, np.int32) for p in f))
              for f in synth_clip(416, 240, 24)]
    rec = dataset.extract_clip(frames, qp, 16, device=dev)
    n_tr = len(rec[3]) - max(1, int(len(rec[3]) * 0.2))
    epochs = -(-steps // -(-n_tr // 1024))
    logs = []
    for d in ("cpu", dev):
        log = []
        undo = _record_steps(log)
        try:
            train.train(*rec, epochs=epochs, device=d)
        finally:
            undo()
        logs.append(log[:steps])
    cpu, card = logs
    lines = []
    for k, (c, g) in enumerate(zip(cpu, card)):
        same_in = torch.equal(c[0], g[0])
        same_loss = torch.equal(c[2], g[2])
        same_out = torch.equal(c[3], g[3])
        if same_in and same_loss and same_out:
            continue
        lines.append(f"step {k}: parameters in "
                     f"{'equal' if same_in else 'differ'}, loss "
                     f"{'equal' if same_loss else 'differs'} "
                     f"({float(g[2])!r} card, {float(c[2])!r} CPU), "
                     f"parameters out "
                     f"{'equal' if same_out else 'differ'}")
        packed, batch = c[0], c[1]
        on = lambda a: a.to(dev)
        fk, sk = train.loss_fwd(on(packed), *map(on, batch))
        fp, sp = train.loss_fwd_plain(on(packed), *map(on, batch))
        fc, sc = train.loss_fwd_plain(packed, *batch)
        for name, a, b in (("K14 vs its plain version, card", (fk,) + sk,
                            (fp,) + sp),
                           ("K14's plain version, card vs CPU", (fp,) + sp,
                            (fc,) + sc)):
            n_diff, n, rel = _diff(a, b)
            lines.append(f"step {k}: {name}: {n_diff} of {n} differ, max "
                         f"relative {rel:.3e}")
        one = torch.ones(1)
        gk = train.loss_bwd(on(packed), *map(on, batch[:3]), *sk, on(one))
        gp = train.loss_bwd_plain(on(packed), *map(on, batch[:3]), *sp,
                                  on(one))
        gc = train.loss_bwd_plain(packed, *batch[:3], *sc, one)
        for name, a, b in (("K15 vs its plain version, card", gk, gp),
                           ("K15's plain version, card vs CPU", gp, gc)):
            n_diff, n, rel = _diff(a, b)
            lines.append(f"step {k}: {name}: {n_diff} of {n} differ, max "
                         f"relative {rel:.3e}")
        mu, nu, count = c[4]
        upd = {}
        # K15 with K16 as its tail and its plain version, on the card's
        # own K14 outputs; K16's plain version on the CPU's gradient
        for d, fn in (("K15 + K16, card", train.loss_bwd_adam),
                      ("K15 + K16's plain version, card",
                       train.loss_bwd_adam_plain)):
            p_, m_, n_ = (on(a.clone()) for a in (packed, mu, nu))
            fn(p_, *map(on, batch[:3]), *sk, on(one),
               train.adam_state(m_, n_, count, 1), 3e-3)
            upd[d] = (p_, m_, n_)
        for d, dd in (("K16's plain version, card", dev),
                      ("K16's plain version, CPU", "cpu")):
            st = [a.clone().to(dd) for a in (packed, gc, mu, nu)]
            train.adam_update_plain(st[0], st[1], st[2], st[3], count + 1,
                                    3e-3)
            upd[d] = (st[0], st[2], st[3])
        for name, a, b in (("K15 + K16 vs its plain version, card",
                            upd["K15 + K16, card"],
                            upd["K15 + K16's plain version, card"]),
                           ("K16's plain version, card vs CPU",
                            upd["K16's plain version, card"],
                            upd["K16's plain version, CPU"])):
            n_diff, n, rel = _diff(a, b)
            lines.append(f"step {k}: {name}: {n_diff} of {n} differ, max "
                         f"relative {rel:.3e}")
        for ln in _adam_parts(packed, gc, mu, nu, count + 1, dev):
            lines.append(f"step {k}: K16's plain version, card vs CPU: {ln}")
        n_diff, n, rel = _diff(upd["K16's plain version, CPU"][0], c[3])
        lines.append(f"step {k}: the CPU's recorded update vs K16's plain "
                     f"version on its gradient: {n_diff} of {n} differ")
        n_diff, n, rel = _diff(upd["K15 + K16, card"][0], g[3])
        lines.append(f"step {k}: the card's recorded update vs K15 + K16 on "
                     f"the CPU's step inputs: {n_diff} of {n} differ")
        break
    else:
        lines.append(f"all {len(cpu)} steps equal, card vs CPU")
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("train_parity: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    first = None
    for name, n_diff, n, rel in stages(1024, 0, dev):
        print(f"train_parity: {name}: {n_diff} of {n} values differ "
              f"(card vs CPU), max relative difference {rel:.3e}",
              flush=True)
        if n_diff and first is None:
            first = name
    print(f"train_parity: first stage that differs: {first or 'none'}",
          flush=True)
    for ln in lockstep(50, dev):
        print(f"train_parity: the trainer's run: {ln}", flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
