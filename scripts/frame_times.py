"""Seconds per frame of 416x240 encodes on the card, the trainer's
seconds and a few kernel calls' host-bound milliseconds, for comparing
two trees of the port on one card in one run:

  ldp   LDP QP 22 with NN-FME, search range 64 (the main path): I + P,
        encoded REPEAT times, each a new encoder (the first P pass of a
        process also builds the geometry's host tables);
  ldp_dctif  LDP QP 22 with HM's DCT-IF sub-pel search and transform
        skip, search range 64: I + P, REPEAT times;
  ra10  random access at Main10, QP 32, DCT-IF, search range 64, on the
        first 3 frames (the IDR and two B pictures);
  ai    all-intra QP 32 with transform skip on the first frame, twice;
  calls the milliseconds per call (CUDA events around 200 calls, after
        2) of K5's integer ME on one 416x240 reference at search range 64
        (a device-bound call: the clip's second frame against its first;
        at 8 bits and as 10-bit samples)
        and of kernel wrappers whose call is its host time: K1's forward
        transform at (14, 8, 8), K14's loss forward at the trainer's batch
        of 1024 (the clip's first frame pair at search range 16, the
        port's init from seed 0), where the tree launches them alone
        K1-TS at (3120, 4, 4) and K16's Adam step, K25's SAO choice on
        the ldp I frame's
        statistics (kept from the first ldp encode); and of three
        device-bound calls, with their device milliseconds beside them
        (torch.profiler over 50 calls): K10's coding step as the P pass
        calls it at (1560, 8, 8) (the clip's frame 1 less frame 0,
        forward transformed; luma, QP 25, the trellis and SDH), K22's
        rough mode decision as the I pass calls it (the first frame, n =
        8, k = 2) and K13's single-level integer ME at 1920x1080, search
        range 64, with seeded predictors (both of its kernels);
  k1ts_vs_shift  where the tree has K1-TS's own call: it at (3120, 4,
        4) and the one torch shift that computes the same, in turns, five
        rounds of 200 calls each: ms per call;
  train_step  200 `train_step`s at batch 1024 on the trainer's QP-22
        records (the generator's clip at its defaults: 24 frames, search
        range 16; the port's init from seed 0 with the records' mean and
        std; seeded full batches): steps/s from CUDA events, the hand
        kernels' launches a step, the host's ms a step (each call on the
        host clock, not synced: the median over a warm epoch of 29
        steps), then the same steps again under torch.profiler: device
        microseconds and device operations a step, and each kernel's
        microseconds a step (the gap between the step's time and its
        device time is the host's);
  nnfme_train  `train_nnfme.main` at its defaults (416x240, 24 frames,
        QPs 22/27/32/37, 60 epochs, search range 16) into a temporary
        directory: seconds, and the extraction's and the steps' seconds
        and the steps per QP as the tool prints them;
  kernel_times  two more ldp encodes, one more ldp_dctif and one more
        ra10 encode with CUDA events around each launch of K23, K26, K7,
        K8, K4, K25, K6, K1, K10, K3, K19, K9 and K24 (their device
        milliseconds, summed a kernel, and
        their launches) and at the edges of each P and B pass's sub-pel stage
        (from its last K5, K13 or K19 launch to `wavefront_pass`) and of
        the walk's prelude (from `pframe_walk`'s start to its first K23
        or K26 launch: the three levels' AMVP hypotheses with K22 and
        K24), `stages` (the events' own host cost stays out of the timed
        encodes above);
  sao_frame  `sao_frame_dev` of a 416x240 frame (the clip's first frame
        as the original, a reconstruction a few steps off, CTU 64, QP
        22's lambda): ms per call (CUDA events around 200 calls), and
        under torch.profiler (50 calls) the device milliseconds and the
        device operations a call, kernels and copies alike;
  k4_k7  the one-plane and one-form calls of K4 and K7 at chip_smoke.py's
        shapes of their rows: K4's statistics and apply of a 416x240 luma
        plane at CTU 64 (seeded samples 60-199, the original a few steps
        off; and the statistics of the clip's first frame, a few steps
        off), K7 on the 1560 8x8 luma blocks of a 416x240 picture from 4
        seeded references, MVs of every phase reaching past the edges:
        ms per call and device ms (torch.profiler, the kernel's own).

    PYTHONPATH=<checkout of the port> python scripts/frame_times.py
    PYTHONPATH=<checkout> python scripts/frame_times.py --no-train
        # the encodes, kernel_times, sao_frame and the calls only
    PYTHONPATH=<checkout> python scripts/frame_times.py --only-train
        # train_step and nnfme_train only

Each frame's seconds come from `Encoder.results` (the device pass of a P
or B frame beside them), after a warm-up encode of a 64x64 clip; beside
them, the milliseconds of each frame's z-scan pass (`iframe_pass`: K21 on
the card; `wavefront_pass`: K23 in P slices, K26 in B slices), timed with
CUDA events around the call (a device sync before and after it, which
the frames' seconds then include); prints one JSON object per encode,
then one each for the calls, K1-TS against the shift, the training step
and the trainer, each with the number of hand kernels the tree has.
Uses only the port's public entry points, so it runs against earlier
trees of the port too.  Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import inspect
import io
import json
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

REPEAT = 4   # encodes of each LDP configuration a process


class _PassTimes:
    """CUDA-event milliseconds of every iframe_pass and wavefront_pass call
    while in use: `ms` holds (function, milliseconds) in call order."""

    def __enter__(self):
        from hmtpu_torch.encoder import iframe_dev, pframe_dev

        self.ms, self._saved = [], []
        for mod, fn in ((iframe_dev, "iframe_pass"),
                        (pframe_dev, "wavefront_pass")):
            inner = getattr(mod, fn)

            def timed(*a, _inner=inner, _fn=fn, **k):
                b, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                torch.cuda.synchronize()
                b.record()
                out = _inner(*a, **k)
                e.record()
                torch.cuda.synchronize()
                self.ms.append((_fn, b.elapsed_time(e)))
                return out

            setattr(mod, fn, timed)
            self._saved.append((mod, fn, inner))
        return self

    def __exit__(self, *exc):
        for mod, fn, inner in self._saved:
            setattr(mod, fn, inner)


class _KernelTimes:
    """CUDA events around every launch of the kernels named while in use
    (through `kernels.launch_checked`, which every wrapper's launch
    reaches): `ms` holds each kernel's summed milliseconds, `n` its
    launches, once `read` has synced."""

    def __init__(self, names):
        self.names = names

    def __enter__(self):
        from hmtpu_torch import kernels

        self._k, self._inner = kernels, kernels.launch_checked
        self.ev = []

        def timed(kernel, *a):
            if kernel not in self.names:
                return self._inner(kernel, *a)
            b, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            b.record()
            self._inner(kernel, *a)
            e.record()
            self.ev.append((kernel, b, e))

        kernels.launch_checked = timed
        return self

    def __exit__(self, *exc):
        self._k.launch_checked = self._inner

    def read(self):
        torch.cuda.synchronize()
        ms, n = {}, {}
        for k, b, e in self.ev:
            ms[k] = ms.get(k, 0.0) + b.elapsed_time(e)
            n[k] = n.get(k, 0) + 1
        return ms, n


class _StageTimes:
    """CUDA events at the edges of two stages of every P and B pass while
    in use: the sub-pel stage (from the end of the pass's last ME or
    coherence launch, K5, K13 or K19, to `wavefront_pass`'s start: K6
    and the NN gate, or K9) and the walk's prelude (from `pframe_walk`'s
    start to its first K23 or K26 launch: the three levels' AMVP
    hypotheses, K22's RMD, K24's grids).  `read` syncs and gives each
    pass's (sub-pel ms, prelude ms)."""

    ME = ("me_sad", "me_sad1", "mv_regularize")

    def __enter__(self):
        from hmtpu_torch import kernels
        from hmtpu_torch.encoder import pframe_dev

        self._k, self._pd = kernels, pframe_dev
        self._launch = kernels.launch_checked
        self._wf, self._walk = pframe_dev.wavefront_pass, \
            pframe_dev.pframe_walk
        self.marks, self._me, self._open = [], None, None
        ev = lambda: torch.cuda.Event(enable_timing=True)

        def launch(kernel, *a):
            self._launch(kernel, *a)
            if kernel in self.ME:
                self._me = ev()
                self._me.record()
            elif kernel in ("p_walk", "b_walk") and self._open is not None:
                e = ev()
                e.record()
                self.marks[-1] += (self._open, e)
                self._open = None

        def wavefront(*a, **k):
            e = ev()
            e.record()
            self.marks.append((self._me, e))
            return self._wf(*a, **k)

        def walk(*a, **k):
            self._open = ev()
            self._open.record()
            return self._walk(*a, **k)

        kernels.launch_checked = launch
        pframe_dev.wavefront_pass = wavefront
        pframe_dev.pframe_walk = walk
        return self

    def __exit__(self, *exc):
        self._k.launch_checked = self._launch
        self._pd.wavefront_pass = self._wf
        self._pd.pframe_walk = self._walk

    def read(self):
        torch.cuda.synchronize()
        ms = lambda a, b: a.elapsed_time(b) if a is not None else None
        return [{"subpel_ms": ms(m[0], m[1]),
                 "prelude_ms": ms(m[2], m[3]) if len(m) == 4 else None}
                for m in self.marks]


def _sao_frame(clip):
    """`sao_frame_dev` of a 416x240 frame: ms per call, and device ms
    and device operations per call (torch.profiler, every operation)."""
    from torch.profiler import ProfilerActivity, profile

    from hmtpu_torch.common.lambdas import frame_lambdas
    from hmtpu_torch.ops import sao

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(22)
    planes = []
    for p in clip[0]:
        o = np.asarray(p, np.int32)
        r = np.clip(o + rng.randint(-3, 4, o.shape), 0, 255)
        planes += [torch.as_tensor(a.astype(np.int32)).to(dev)
                   for a in (o, r)]
    lam = torch.tensor(frame_lambdas(22, 22, 0.57)[0], dtype=torch.float32,
                       device=dev)
    call = lambda: sao.sao_frame_dev(*planes, 64, lam, 8)
    ms = _time_call(call)
    iters = 50
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0)) > 0]
    dms = sum(getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0))
              for e in evs) / 1e3 / iters
    return {"ms": ms, "device_ms": dms,
            "device_ops": sum(e.count for e in evs) / iters,
            "by_op": {e.key[:60]: e.count / iters for e in evs}}


def _k4_k7(clip):
    """{label: (ms per call, device ms)} of the one-plane and one-form
    calls of K4 and K7 at chip_smoke.py's row shapes."""
    from hmtpu_torch.ops import interp, sao

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(4)
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(dev)
    h, w = 240, 416
    y = rng.randint(60, 200, (h, w))
    org, rec = t32(np.clip(y + rng.randint(-6, 7, (h, w)), 0, 255)), t32(y)
    c = np.asarray(clip[0][0], np.int32)
    corg = t32(c)
    crec = t32(np.clip(c + rng.randint(-3, 4, c.shape), 0, 255))
    params = t32(np.stack(
        [rng.randint(0, 3, (4, 7)), rng.randint(0, 4, (4, 7)),
         rng.randint(0, 29, (4, 7))]
        + [rng.randint(-7, 8, (4, 7)) for _ in range(4)], -1))
    refs = t32(rng.randint(0, 256, (4, h, w)))
    q = np.arange((h // 8) * (w // 8))
    span = 4 * (8 + 24)
    args = [t32(a) for a in (rng.randint(0, 4, q.size), (q % (w // 8)) * 8,
                             (q // (w // 8)) * 8,
                             rng.randint(-span, span, q.size),
                             rng.randint(-span, span, q.size))]
    calls = {
        "K4 sao_stats (240x416 luma, CTU 64, random samples)": (
            lambda: sao._sao_stats(org, rec, 64, 8), "stats_kernel"),
        "K4 sao_stats (the clip's luma, CTU 64)": (
            lambda: sao._sao_stats(corg, crec, 64, 8), "stats_kernel"),
        "K4 apply_sao_dev (240x416 luma, CTU 64)": (
            lambda: sao.apply_sao_dev(rec, params, 64, 8), "apply_kernel"),
        "K7 mc_batch (1560 luma 8x8, 4 references)": (
            lambda: interp.mc_batch(refs, *args, 8, 8, False), "mc_kernel"),
    }
    return {k: (_time_call(f), _device_ms(f, fn))
            for k, (f, fn) in calls.items()}


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


def _keep_first(mod, fn, kept):
    """Wraps mod.fn until restored: the first call's arguments are copied
    into `kept` as (args, kwargs); returns the restore function."""
    inner = getattr(mod, fn)

    def wrap(*a, **k):
        if not kept:
            kept.append(tuple(
                x.clone() if isinstance(x, torch.Tensor) else x for x in a))
            kept.append(dict(k))
        return inner(*a, **k)

    setattr(mod, fn, wrap)
    return lambda: setattr(mod, fn, inner)


def _time_call(fn, iters=200, warm=2) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _device_ms(fn, name, iters=50):
    """Device milliseconds per call of fn in CUDA functions whose name
    holds `name` (torch.profiler), or None where the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [getattr(e, "self_device_time_total",
                  getattr(e, "self_cuda_time_total", 0.0))
          for e in prof.key_averages() if name in e.key]
    return sum(us) / 1e3 / iters if us else None


def _coding_calls(clip, dev):
    """{label: (call, CUDA function name)} of K10 and K22 at the main
    path's shapes."""
    from hmtpu_torch.common.constants import SliceType
    from hmtpu_torch.common.lambdas import frame_lambdas
    from hmtpu_torch.encoder import iframe_dev
    from hmtpu_torch.encoder.intra_rdo import rmd
    from hmtpu_torch.entropy.contexts import make_contexts
    from hmtpu_torch.entropy.fracbits import ctx_bits_table
    from hmtpu_torch.ops import rdoq, transform

    rng = np.random.RandomState(10)
    y1, y0 = (torch.as_tensor(np.asarray(f[0], np.int32)).to(dev)
              for f in (clip[1], clip[0]))
    res = (y1 - y0).reshape(30, 8, 52, 8).transpose(1, 2).reshape(-1, 8, 8)
    coef = transform.forward_transform(res.contiguous(), 8)
    cb = torch.as_tensor(ctx_bits_table(make_contexts(SliceType.P, 22))
                         .reshape(-1)).to(dev)
    lam = torch.tensor(frame_lambdas(25, 25, 0.4624)[0],
                       dtype=torch.float32, device=dev)
    sel = torch.as_tensor(rng.randint(0, 3, coef.shape[0])
                          .astype(np.int32)).to(dev)
    g8 = iframe_dev._dev_static(416, 240, 6, dev)["g8"]
    lam_sqrt = frame_lambdas(32, 32, 0.57)[1]
    return {
        "K10 rdoq_code ((1560, 8, 8) luma, trellis + SDH)": (
            lambda: rdoq.rdoq_code(coef, 25, 3, 8, lam, cb, True, sdh=True,
                                   scan_sel=sel, trellis=True),
            "rdoq_kernel"),
        "K22 rmd (416x240, n = 8, k = 2)": (
            lambda: rmd(y0, g8, 8, 2, bd=8, lam_sqrt=lam_sqrt, sis=True),
            "rmd_kernel"),
    }


def _me1_call(dev):
    """{label: (call, CUDA function name)} of K13 at the size the 1080p
    extraction gives it: the generator's 1920x1080 clip, its second frame
    against its first, search range 64, seeded quarter-pel predictors,
    8 bits."""
    from hmtpu_torch.search import me
    from hmtpu_torch.utils.gen_test_yuv import synth_clip

    rng = np.random.RandomState(13)
    hd = list(synth_clip(1920, 1080, 2, seed=42))
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(dev)
    org, ref = t32(hd[1][0]), t32(hd[0][0])
    px, py = (t32(rng.randint(-64, 65, (135, 240))) for _ in range(2))
    lam = np.float32(np.sqrt(0.57 * 2.0 ** ((22 - 12) / 3.0)))
    # trees whose K13 takes no bit depth stage int32 samples
    bd = (8,) if "bd" in inspect.signature(me.integer_me).parameters else ()
    return {"K13 integer_me (1080x1920, SR 64, predictors)": (
        lambda: me.integer_me(ref, org, 8, 64, lam, px, py, *bd), "me1_")}


def _calls(clip, sao_call):
    """The `calls` line's milliseconds per call, by wrapper, and the
    device milliseconds of the device-bound ones."""
    from hmtpu_torch.io.yuv import Frame
    from hmtpu_torch.models import dataset, nnfme, train
    from hmtpu_torch.ops import sao, transform
    from hmtpu_torch.search import me

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(5)
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(dev)
    res = t32(rng.randint(-255, 256, (14, 8, 8)))
    ts = t32(rng.randint(-255, 256, (3120, 4, 4)))
    c9, hh, ww, ll = dataset.extract_clip(
        [Frame(*(np.asarray(p, np.int32) for p in f)) for f in clip[:2]],
        22, 16, device=dev)
    nb = 1024
    mean, std = train.standardize_fit(c9[:nb])
    init = nnfme.init_random(torch.Generator().manual_seed(0), dev)
    fields = {k: getattr(init, k).cpu().numpy() for k in nnfme.PACK_ORDER}
    fields.update(mean=mean, std=std)
    pk = nnfme.params_from_arrays(fields, dev).packed
    c9, hh, ww, ll = (torch.as_tensor(a[:nb]).to(dev)
                      for a in (c9, hh, ww, ll))
    n = nnfme.PACK_SIZE
    p, g, mu, nu = (torch.as_tensor(rng.randn(n) * 1e-3,
                                    dtype=torch.float32).to(dev)
                    for _ in range(4))
    nu.abs_()
    sa, sk = sao_call
    org, ref = (t32(f[0]) for f in (clip[1], clip[0]))
    lam = np.float32(7.1)
    # 10-bit samples: the clip << 2 (K5 takes their bit depth; trees whose
    # K5 takes none stage int32 samples of any depth)
    bd10 = {"bd": 10} if "bd" in inspect.signature(
        me.integer_me_levels).parameters else {}
    calls = {
        "K5 integer_me_levels (416x240, SR 64, one reference)":
            lambda: me.integer_me_levels(ref, org, 64, lam, 8, 13),
        "K5 integer_me_levels (the same, 10 bits)":
            lambda: me.integer_me_levels(ref << 2, org << 2, 64, lam * 4, 8,
                                         13, **bd10),
        "K1 forward_transform (14, 8, 8)":
            lambda: transform.forward_transform(res, 8),
        "K14 loss_fwd (batch 1024)":
            lambda: train.loss_fwd(pk, c9, hh, ww, ll),
        "K25 choose_params (ldp I frame)":
            lambda: sao.choose_params(*sa, **sk),
    }
    # the trees before K16 and K1-TS ran inside K15 and K1's level forms
    if hasattr(transform, "transform_skip_fwd"):
        calls["K1-TS transform_skip_fwd (3120, 4, 4)"] = \
            lambda: transform.transform_skip_fwd(ts, 4)
    if hasattr(train, "adam_update"):
        calls[f"K16 adam_update ({n})"] = \
            lambda: train.adam_update(p, g, mu, nu, 7, 3e-3)
    coding = _coding_calls(clip, dev)
    coding.update(_me1_call(dev))
    calls.update({k: f for k, (f, _) in coding.items()})
    return ({k: _time_call(f) for k, f in calls.items()},
            {k: _device_ms(f, fn) for k, (f, fn) in coding.items()})


def _k1ts_vs_shift(rounds=5):
    """K1-TS and the torch shift, in turns: ms per call, a list each
    (where the tree has K1-TS's own call)."""
    from hmtpu_torch.ops import transform

    if not hasattr(transform, "transform_skip_fwd"):
        return {}
    rng = np.random.RandomState(7)
    ts = torch.as_tensor(rng.randint(-255, 256, (3120, 4, 4)).astype(
        np.int32)).to(torch.device("cuda", 0))
    sh = transform.ts_shift(4, 8)
    got = {"k1ts_ms": [], "shift_ms": []}
    for _ in range(rounds):
        got["k1ts_ms"].append(_time_call(
            lambda: transform.transform_skip_fwd(ts, 4)))
        got["shift_ms"].append(_time_call(lambda: ts << sh))
    return got


def _init_state(train, params, steps):
    """`train.init_train_state` with a bias-correction table of `steps`
    entries, where the tree's trainer takes one."""
    if "steps" in inspect.signature(train.init_train_state).parameters:
        return train.init_train_state(params, steps=steps)
    return train.init_train_state(params)


def _train_step_times(steps=200, warm=5, epoch=29):
    """The trainer's step on its QP-22 records: steps/s (CUDA events),
    hand-kernel launches a step (the launch counters), the host's ms a
    step (each `train_step` call alone on the host clock, not synced, the
    median over a warm epoch of `epoch` steps: the trainer's at its
    defaults), device us and operations a step and each kernel's us a
    step (torch.profiler, over the same number of steps run again)."""
    from torch.profiler import ProfilerActivity, profile

    from hmtpu_torch import kernels
    from hmtpu_torch.io.yuv import Frame
    from hmtpu_torch.models import dataset, nnfme, train
    from hmtpu_torch.utils.gen_test_yuv import synth_clip

    dev = torch.device("cuda", 0)
    frames = [Frame(*(np.asarray(p, np.int32) for p in f))
              for f in synth_clip(416, 240, 24)]
    c9, hh, ww, ll = dataset.extract_clip(frames, 22, 16, device=dev)
    mean, std = train.standardize_fit(c9)
    init = nnfme.init_random(torch.Generator().manual_seed(0), dev)
    fields = {k: getattr(init, k).cpu().numpy() for k in nnfme.PACK_ORDER}
    fields.update(mean=mean, std=std)
    state = [_init_state(train, nnfme.params_from_arrays(fields, dev),
                         warm + 2 * steps + epoch)]
    rng = np.random.RandomState(0)
    idx = torch.as_tensor(np.stack([rng.permutation(len(ll))[:1024]
                                    for _ in range(steps)])).to(dev)
    data = [torch.as_tensor(a).to(dev) for a in (c9, hh, ww, ll)]
    host = []

    def run(n, clock=False):
        for k in range(n):
            b = idx[k % steps]
            t0 = time.perf_counter()
            state[0] = train.train_step(state[0], *(a[b] for a in data))[0]
            if clock:
                host.append((time.perf_counter() - t0) * 1e3)

    run(warm)
    torch.cuda.synchronize()
    run(epoch, clock=True)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    before = dict(kernels.COUNTS)
    a.record()
    run(steps)
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b)
    launched = {k: (v - before[k]) / steps for k, v in kernels.COUNTS.items()
                if v != before[k]}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    on_dev = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)) > 0]
    us = {e.key: getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)) / steps
          for e in on_dev}
    return {"rows": len(ll), "batch": 1024, "steps": steps,
            "steps_per_s": steps / (ms / 1e3), "ms_per_step": ms / steps,
            "host_ms_per_step_median": float(np.median(host)),
            "host_ms_per_step": host,
            "hand_launches_per_step": launched,
            "device_us_per_step": sum(us.values()),
            "device_ops_per_step": sum(e.count for e in on_dev) / steps,
            "device_ops_by_kernel": {e.key[:60]: e.count / steps
                                     for e in on_dev},
            "device_us_by_kernel": us}


def _trainer_split(out: str):
    """Per QP (extraction s, steps, steps' s) from train_nnfme's lines."""
    return {qp: {"extraction_s": float(e), "steps": int(n),
                 "steps_s": float(t)}
            for qp, e, n, t in re.findall(
                r"QP(\d+): extraction ([\d.]+) s .*?, (\d+) steps in "
                r"([\d.]+) s", out)}


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--no-train", action="store_true",
                    help="leave out train_step and nnfme_train")
    ap.add_argument("--only-train", action="store_true",
                    help="train_step and nnfme_train alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("frame_times: no CUDA device", file=sys.stderr)
        return 2
    from hmtpu_torch import kernels

    kernels.build_all()
    nk = len(kernels.KERNELS)
    if not args.only_train:
        _encodes_and_calls(nk)
    if args.no_train:
        return 0
    _trainer(nk)
    return 0


def _encodes_and_calls(nk: int) -> None:
    from hmtpu_torch.ops import sao
    from hmtpu_torch.utils.gen_test_yuv import synth_clip

    clip = list(synth_clip(416, 240, 3, seed=42))
    _encode(synth_clip(64, 64, 2, seed=3), qp=22, gop="ldp", subpel="nn",
            search_range=8)
    ldp = dict(qp=22, gop="ldp", subpel="nn", search_range=64)
    runs = ([("ldp", clip[:2], ldp)] * REPEAT
            + [("ldp_dctif", clip[:2], dict(qp=22, gop="ldp",
                                            subpel="dctif",
                                            transform_skip=True,
                                            search_range=64))] * REPEAT
            + [("ra10", clip, dict(qp=32, gop="ra", subpel="dctif",
                                   search_range=64, bit_depth=10))]
            + [("ai", clip[:1], dict(qp=32, gop="ai", subpel="none",
                                     transform_skip=True))] * 2)
    sao_call = []
    restore = _keep_first(sao, "choose_params", sao_call)
    try:
        for name, frames, cfg in runs:
            with _PassTimes() as pt:
                bs, dt, res = _encode(frames, **cfg)
            restore()
            print(json.dumps({
                "config": name, "kernels": nk,
                "bytes": len(bs), "seconds": dt,
                "frames": [{"poc": r.poc, "type": r.slice_type,
                            "seconds": r.seconds,
                            "device_seconds": getattr(r, "device_seconds",
                                                      None)}
                           for r in res],
                "passes": [{"fn": fn, "ms": ms} for fn, ms in pt.ms]}),
                flush=True)
    finally:
        restore()
    kt_names = ("p_walk", "b_walk", "mc_dctif", "satd8", "sao_stats",
                "sao_apply", "sao_choose", "nnfme", "int_transform_fwd",
                "int_transform_inv", "rdoq", "deblock", "mv_regularize",
                "frac_refine", "tmvp_grid")
    for name, frames, cfg in (runs[0], runs[0], runs[REPEAT],
                              runs[2 * REPEAT]):
        with _KernelTimes(kt_names) as kt, _StageTimes() as stg:
            bs, dt, res = _encode(frames, **cfg)
        kms, kn = kt.read()
        print(json.dumps({"config": "kernel_times", "of": name,
                          "kernels": nk, "bytes": len(bs),
                          "frames": [r.slice_type for r in res],
                          "ms": kms, "launches": kn,
                          "stages": stg.read()}), flush=True)
    print(json.dumps({"config": "sao_frame", "kernels": nk,
                      **_sao_frame(clip)}), flush=True)
    print(json.dumps({"config": "k4_k7", "kernels": nk,
                      "ms_device_ms": _k4_k7(clip)}), flush=True)
    ms, dms = _calls(clip, sao_call)
    print(json.dumps({"config": "calls", "kernels": nk, "ms_per_call": ms,
                      "device_ms_per_call": dms}), flush=True)
    print(json.dumps({"config": "k1ts_vs_shift", "kernels": nk,
                      **_k1ts_vs_shift()}), flush=True)


def _trainer(nk: int) -> None:
    from hmtpu_torch.apps import train_nnfme

    print(json.dumps({"config": "train_step", "kernels": nk,
                      **_train_step_times()}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            train_nnfme.main(["--out", os.path.join(tmp, "w")])
        torch.cuda.synchronize()
        dt = time.time() - t0
    split = _trainer_split(buf.getvalue())
    print(json.dumps({"config": "nnfme_train", "kernels": nk,
                      "seconds": dt, "per_qp": split,
                      "extraction_s": sum(v["extraction_s"]
                                          for v in split.values()),
                      "steps_s": sum(v["steps_s"] for v in split.values()),
                      "steps": sum(v["steps"] for v in split.values())}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
