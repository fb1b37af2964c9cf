"""K1's and K6's calls at the shapes the 416x240 P pass gives them, and
the device operations of one P pass's walk, on the card, for comparing
two trees of the port in one run:

  k1     K1's forward and inverse transform (`forward_transform`,
         `inverse_transform`) at the nine shapes of the P pass's
         `_code` calls: each level's luma and two chroma planes, (1560,
         8, 8) with (1560, 4, 4) x 2, (390, 16, 16) with (390, 8, 8) x 2,
         (104, 32, 32) with (104, 16, 16) x 2 (seeded residuals and
         dequantised coefficients); where the tree has them, K1's level
         forms (`transform.fwd_level`, `inv_level`: a level's three
         planes in one launch, the residual, reconstruction, SSE, cbf,
         distortion and rate combine inside) at the three levels;
  k6     K6 (`nnfme.predict_offsets`) on each level's stencils of the
         clip's second frame against its first (K5 at search range 64,
         the QP-22 weights): 1560, 390 and 104 rows; where the tree has
         it, the three levels in one launch
         (`nnfme.predict_offsets_levels`);
  walk   `wavefront_pass` of the ldp P frame (416x240, QP 22, NN-FME,
         search range 64; its arguments kept from an encode) run again
         under torch.profiler: the device milliseconds and operations of
         the call, split into the hand kernels' and the rest (torch's
         own: the glue), by CUDA function; and CUDA events from the
         call's start to its first K23 launch (the prelude: the AMVP
         hypotheses of the three levels, K22's RMD, K24's grids);
  gate   the NN-FME gate of that P frame's pass (`full_pframe_pass`, its
         arguments kept from the same encode): the host milliseconds
         from K6's return to `wavefront_pass`'s entry (the three levels'
         sub-pel stage) and CUDA events over the same stretch, over 10
         passes; every call of the stretch (K7 `mc_luma2`, K8
         `satd_batch`, `satd_gate_levels` where the tree has it,
         `_blockify`, `_edge_pad`) replayed alone on its captured inputs,
         level by level, with the gate's compare and `torch.where`s:
         each one's ms, device ms and device operations a call; and the
         hand kernels' launches a pass;
  k25    K25 (`sao.choose_params`) on seeded statistic rows of 416x240
         (28 CTUs) and 1920x1080 (510 CTUs) at CTU 64, 8 bits, QP 22's
         lambda;
  dbk    the deblocking stretch of three pictures' passes, from the
         z-scan pass's return (`iframe_pass`, `wavefront_pass`) to
         `sao_frame_dev`'s entry: ldp's I and P frames (416x240, QP 22,
         NN-FME, search range 64) and ra10's POC 8 B frame (416x240
         Main10, QP 32, DCT-IF; its arguments kept from a 9-frame
         encode): host ms and CUDA-event ms over 10 passes, then one
         pass with torch.profiler running over the stretch alone: its
         top-level torch operations, device operations and device ms,
         K3's launches and device ms; and the same stretch on a seeded
         1920x1080 P state (chip_smoke.py's `seeded_p_state`:
         `deblock.deblock_state` where the tree has it, else the P
         pass's glue, copied here, and `deblock_frame_dev`);
  k19    K19 (`me.regularize_mv_field`, 3 rounds) on ldp's P-frame field
         (kept from the same encode: 30x52 cells, 4 references) and on
         a seeded 1920x1080 field (chip_smoke.py's `seeded_field`:
         135x240 cells, 4 references): ms a
         call (the host's, with its glue), its device operations and
         ms, and K19's launches and device ms a launch;
  k9     K9 on the captured calls of ldp_dctif's P pass (the LDP cfg
         with --SubPel=dctif through the CLI, 416x240, QP 22) and ra10's
         POC 8 B pass: each level's `frac_refine_batch`, or where the
         tree has it the levels form `frac_refine_levels` (in one call,
         and each level alone), replayed: ms, device ms and launches a
         call; the extraction's 1920x1080 call (32,400 8x8 blocks, the
         single-level ME's integer MVs of the HD clip's second frame):
         the one-call form, and the levels form's 8 level over the plane
         where it exists; and the DCT-IF stretch of both passes, from
         the last `_union_idx` return of the pass's levels to the last
         K9 return: host ms and CUDA-event ms over 10 passes (the device
         synced at both marks), then one pass with torch.profiler over
         the stretch alone (torch and device operations, device ms, K9's
         launches and device ms);
  k24    K24 on ldp's P pass: each captured `tmvp_grid` call (or the
         grids form `tmvp_grids`) replayed, and the stretch from `rmd`'s
         return to the first `_blockify` after the last K24 call,
         measured as k9's;
  ts     ldp_dctif's 8-level AMVP hypothesis with the chroma pair's
         transform-skip trial (`hypothesis(with_ts=True)`), from its
         first `_union_idx` entry to the next `rmd` entry, measured as
         k9's stretch (K1's and K10's launches by CUDA function).

Each call's "ms" is chip_smoke.py's `time_cuda` (CUDA events around 200
calls after 2), its "device_ms" chip_smoke.py's `device_ms`
(torch.profiler, the kernel's own time), its bound chip_smoke.py's
`bound_ms` of the bytes the call must move: K1's forward transform 8 B a
sample (the residual in, the coefficients out), its inverse 8 B; the
level forms 12 B a sample forward (org and pred in, coefficients out)
and 20 B inverse (the dequantised coefficients, levels, pred and org in,
the reconstruction out) and the per-block rows.

    PYTHONPATH=<checkout of the port> python scripts/code_step_times.py \
        [--parts k1,k6,walk,gate,k25,dbk,k19,k9,k24,ts]

Prints one JSON object a part (all parts unless --parts names some).
Uses only the port's entry points, so it runs against earlier trees too
(the level forms and the gate's one-launch form only where they exist).
Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

W, H = 416, 240
SRANGE = 64
# (luma n, blocks) of the P pass's three levels at 416x240
LEVELS = ((8, 1560), (16, 390), (32, 104))


def _smoke():
    """chip_smoke.py beside this script, loaded by path (sys.path is left
    as it is, so PYTHONPATH's tree is the one measured)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_lib", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _row(cs, fn, fname, nbytes):
    ms = cs.time_cuda(fn, 200)
    dms = cs.device_ms(fn, fname)
    bms, by = cs.bound_ms(nbytes, 0)
    return {"ms": ms, "device_ms": dms, "bound_ms": bms, "bound_by": by}


def k1_rows(cs, dev):
    from hmtpu_torch.ops import transform

    rng = np.random.RandomState(16)
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(dev)
    out = {}
    for n, m in LEVELS:
        planes = []
        for name, s in (("y", n), ("u", n // 2), ("v", n // 2)):
            org = t32(rng.randint(0, 256, (m, s, s)))
            pred = t32(np.clip(org.cpu().numpy()
                               + rng.randint(-40, 41, (m, s, s)), 0, 255))
            deq = t32(rng.randint(-2000, 2001, (m, s, s))
                      * (rng.rand(m, s, s) < 0.2))
            planes.append((org, pred, deq))
            res = org - pred
            ns = m * s * s
            out[f"fwd {name} ({m}, {s}, {s})"] = _row(
                cs, lambda: transform.forward_transform(res, s),
                "transform_kernel<false>", 8 * ns)
            out[f"inv {name} ({m}, {s}, {s})"] = _row(
                cs, lambda: transform.inverse_transform(deq, s),
                "transform_kernel<true>", 8 * ns)
        if not hasattr(transform, "fwd_level"):
            continue
        orgs, preds, deqs = (list(a) for a in zip(*planes))
        levs = [torch.where(d != 0, 1, 0).to(torch.int32) for d in deqs]
        bits = [t32(rng.randint(0, 200, m)).to(torch.float32)
                for _ in range(3)]
        dw = torch.tensor(1.25, dtype=torch.float32, device=dev)
        ns = m * (n * n + 2 * (n // 2) ** 2)
        out[f"fwd_level {n}"] = _row(
            cs, lambda: transform.fwd_level(orgs, preds, 8),
            "fwd_level_kernel", 12 * ns)
        out[f"inv_level {n}"] = _row(
            cs, lambda: transform.inv_level(deqs, levs, preds, orgs, 8, dw,
                                            bits),
            "inv_level_kernel", 20 * ns + m * 4 * 3 + m * 4 * 6)
    return out


def _stencils(dev):
    from hmtpu_torch.search import me
    from hmtpu_torch.utils.gen_test_yuv import synth_clip

    clip = list(synth_clip(W, H, 2, seed=42))
    org, ref = (torch.as_tensor(np.asarray(f[0], np.int32)).to(dev)
                for f in (clip[1], clip[0]))
    lam = np.float32(np.sqrt(0.57 * 2.0 ** ((25 - 12) / 3.0)))
    qh, qw = (H // 16 + 1) // 2, (W // 16 + 1) // 2
    lev = me.integer_me_levels(ref, org, 64, lam, qh, qw)
    return [lev[n][1] for n, _ in LEVELS]


def k6_rows(cs, dev):
    from hmtpu_torch.models import nnfme

    params = nnfme.load_npz(os.path.join(nnfme.WEIGHTS_DIR, "qp22.npz"), dev)
    stens = _stencils(dev)
    out = {}
    for (n, m), st in zip(LEVELS, stens):
        st9 = st.reshape(-1, 9).to(torch.float32)
        sz = torch.full((m,), n, dtype=torch.int32, device=dev)
        out[f"predict_offsets {n} ({m} rows)"] = _row(
            cs, lambda: nnfme.predict_offsets(params, st9, sz, sz),
            "nnfme_kernel", m * (9 * 4 + 12))
        # as the P pass called it: the stencils' cast and the sizes too
        out[f"subpel call {n} ({m} rows, with the cast and sizes)"] = {
            "ms": cs.time_cuda(lambda: nnfme.predict_offsets(
                params, st.reshape(-1, 9).to(torch.float32),
                *(torch.full((m,), n, dtype=torch.int32, device=dev),) * 2),
                200)}
    if hasattr(nnfme, "predict_offsets_levels"):
        sizes = [n for n, _ in LEVELS]
        rows = sum(m for _, m in LEVELS)
        out[f"predict_offsets_levels ({rows} rows)"] = _row(
            cs, lambda: nnfme.predict_offsets_levels(params, stens, sizes),
            "nnfme_kernel", rows * (9 * 4 + 12))
    return out


HAND = ("transform_kernel", "fwd_level_kernel", "inv_level_kernel",
        "rdoq_kernel", "mc_kernel", "rmd_kernel", "tmvp_kernel",
        "pwalk_kernel", "transform_skip_kernel")


_KEPT: dict = {}


def _keep_args(kept, fns, encode, want=lambda name, a, k: True):
    """Run encode() with each (module, function) of fns wrapped: the
    first call of each for which want(name, args, kwargs) holds has its
    arguments copied into kept[name] as (args, kwargs)."""
    inner = {(m, n): getattr(m, n) for m, n in fns}

    def keeper(m, name):
        def keep(*a, **k):
            if name not in kept and want(name, a, k):
                kept[name] = (tuple(x.clone() if isinstance(x, torch.Tensor)
                                    else x for x in a), dict(k))
            return inner[(m, name)](*a, **k)
        return keep

    for m, n in inner:
        setattr(m, n, keeper(m, n))
    from hmtpu_torch import kernels

    kernels.reset_counts()
    try:
        encode()
    finally:
        for (m, n), f in inner.items():
            setattr(m, n, f)
    kept["launches"] = {k: v for k, v in kernels.COUNTS.items()
                        if k in ("deblock", "mv_regularize")}
    return kept


def _ldp_pass_args(dev):
    """The arguments of the ldp frames' passes (416x240, QP 22, NN-FME,
    search range 64), kept from one encode of the clip's two frames: the
    P frame's `full_pframe_pass`, `wavefront_pass` and
    `regularize_mv_field`, the I frame's `iframe_full_pass`."""
    if _KEPT:
        return _KEPT
    from hmtpu_torch.encoder import iframe_dev, pframe_dev
    from hmtpu_torch.encoder.top import Encoder, EncoderConfig
    from hmtpu_torch.io.yuv import Frame
    from hmtpu_torch.search import me
    from hmtpu_torch.utils.gen_test_yuv import synth_clip

    clip = list(synth_clip(W, H, 2, seed=42))

    def encode():
        enc = Encoder(EncoderConfig(width=W, height=H, qp=22, gop="ldp",
                                    subpel="nn", search_range=SRANGE),
                      device=dev)
        enc.encode_sequence([Frame(*(np.asarray(p, np.int32) for p in f))
                             for f in clip])

    return _keep_args(_KEPT, ((pframe_dev, "full_pframe_pass"),
                              (pframe_dev, "wavefront_pass"),
                              (iframe_dev, "iframe_full_pass"),
                              (me, "regularize_mv_field")), encode)


_KEPT_RA: dict = {}


def _ra_pass_args(dev):
    """The arguments of ra10's first B pass (`full_pframe_pass` of POC 8:
    416x240 Main10, QP 32, DCT-IF, search range 64), kept from a 9-frame
    encode of the clip as 10-bit samples."""
    if _KEPT_RA:
        return _KEPT_RA
    from hmtpu_torch.encoder import pframe_dev
    from hmtpu_torch.encoder.top import Encoder, EncoderConfig
    from hmtpu_torch.io.yuv import Frame
    from hmtpu_torch.utils.gen_test_yuv import synth_clip

    clip = list(synth_clip(W, H, 9, seed=42))

    def encode():
        enc = Encoder(EncoderConfig(width=W, height=H, qp=32, gop="ra",
                                    subpel="dctif", search_range=SRANGE,
                                    bit_depth=10), device=dev)
        enc.encode_sequence([Frame(*(np.asarray(p, np.int32) << 2
                                     for p in f), 10) for f in clip])

    return _keep_args(_KEPT_RA, ((pframe_dev, "full_pframe_pass"),), encode,
                      lambda name, a, k: k.get("num_ref_l1", 0) > 0)


def walk(cs, dev):
    from torch.profiler import ProfilerActivity, profile

    from hmtpu_torch import kernels
    from hmtpu_torch.encoder import pframe_dev

    args, kw = _ldp_pass_args(dev)["wavefront_pass"]
    call = lambda: pframe_dev.wavefront_pass(*args, **kw)
    call()
    # the prelude: CUDA events from the call's start to its first K23
    # launch
    launch = kernels.launch_checked
    marks = []

    def mark(kernel, *a):
        if kernel == "p_walk" and len(marks) == 1:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append(e)
        return launch(kernel, *a)

    pre = []
    kernels.launch_checked = mark
    try:
        for _ in range(10):
            marks.clear()
            torch.cuda.synchronize()
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            marks.append(b)
            call()
            torch.cuda.synchronize()
            pre.append(marks[0].elapsed_time(marks[1]))
    finally:
        kernels.launch_checked = launch
    iters = 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if cs.self_device_us(e) > 0]
    by = {e.key[:70]: (cs.self_device_us(e) / 1e3 / iters, e.count / iters)
          for e in evs}
    hand = {k: v for k, v in by.items() if any(h in k for h in HAND)}
    glue = {k: v for k, v in by.items() if k not in hand}
    tot = lambda d: (sum(v[0] for v in d.values()),
                     sum(v[1] for v in d.values()))
    return {"prelude_ms": pre, "prelude_ms_median": float(np.median(pre)),
            "device_ms_ops": tot(by), "hand_ms_ops": tot(hand),
            "glue_ms_ops": tot(glue),
            "by_function": dict(sorted(by.items(), key=lambda kv: -kv[1][0]))}


def _device_all(cs, fn, iters: int = 20):
    """(device ms, device operations) a call of fn: every CUDA function
    it runs (torch.profiler, device activity)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if cs.self_device_us(e) > 0]
    return (sum(cs.self_device_us(e) for e in evs) / 1e3 / iters,
            sum(e.count for e in evs) / iters)


def gate(cs, dev):
    """The NN-FME gate's stretch of the ldp P pass (see the top)."""
    from hmtpu_torch import kernels
    from hmtpu_torch.encoder import pframe_dev
    from hmtpu_torch.models import nnfme
    from hmtpu_torch.search import me

    args, kw = _ldp_pass_args(dev)["full_pframe_pass"]
    call = lambda: pframe_dev.full_pframe_pass(*args, **kw)
    call()
    torch.cuda.synchronize()
    before = dict(kernels.COUNTS)
    call()
    launches = {k: v - before[k] for k, v in kernels.COUNTS.items()
                if v != before[k]}

    # the stretch: K6's return to wavefront_pass's entry; the calls made
    # in it, with their inputs and outputs
    state = {"on": False, "record": False, "stamps": [], "calls": []}
    mods = {"pframe_dev": pframe_dev, "me": me, "nnfme": nnfme}
    names = [("nnfme", "predict_offsets_levels"),
             ("pframe_dev", "wavefront_pass"), ("pframe_dev", "mc_luma2"),
             ("pframe_dev", "_blockify"), ("pframe_dev", "_edge_pad"),
             ("me", "satd_batch"), ("me", "satd_gate_levels")]
    inner = {n: getattr(mods[m], n) for m, n in names
             if hasattr(mods[m], n)}

    def stamp():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        state["stamps"].append((time.perf_counter(), e))

    def wrap(name):
        f = inner[name]

        def g(*a, **k):
            if name == "wavefront_pass" and state["on"]:
                stamp()
                state["on"] = False
            out = f(*a, **k)
            if name == "predict_offsets_levels":
                stamp()
                state["on"] = True
            elif state["on"] and state["record"] \
                    and name != "wavefront_pass":
                state["calls"].append((name, a, k, out))
            return out
        return g

    for m, n in names:
        if n in inner:
            setattr(mods[m], n, wrap(n))
    host, span = [], []
    try:
        # the first pass records the calls, the next 10 are timed
        for i in range(11):
            state["stamps"].clear()
            state["record"] = i == 0
            call()
            torch.cuda.synchronize()
            if i:
                (h0, e0), (h1, e1) = state["stamps"]
                host.append((h1 - h0) * 1e3)
                span.append(e0.elapsed_time(e1))
    finally:
        for m, n in names:
            if n in inner:
                setattr(mods[m], n, inner[n])
    calls = state["calls"]

    def level_of(name, a, k):
        if name == "mc_luma2":
            return int(a[5])
        if name == "satd_batch":
            return int(a[2])
        if name == "_blockify":
            return int(a[1])
        if name == "_edge_pad":
            return 32
        return 0

    pieces = {}
    for i, (name, a, k, out) in enumerate(calls):
        fn = (lambda f=inner[name], a=a, k=k: f(*a, **k))
        dms, ops = _device_all(cs, fn)
        pieces[f"{i:02d} {name} {level_of(name, a, k)}"] = {
            "ms": cs.time_cuda(fn, 200), "device_ms": dms,
            "device_ops": ops}
    # the gate's compare and the two torch.where of each level (the
    # tree that calls satd_batch twice a level)
    sat = [(a, out) for name, a, k, out in calls if name == "satd_batch"]
    mcs = [a for name, a, k, out in calls if name == "mc_luma2"]
    for lv, (mc, (s_nn, s_int)) in enumerate(zip(mcs, zip(sat[0::2],
                                                         sat[1::2]))):
        def fn(a=s_nn[1], b=s_int[1], qx=mc[3], qy=mc[4]):
            better = a < b
            return (torch.where(better, qx[0], qx[1]),
                    torch.where(better, qy[0], qy[1]))
        dms, ops = _device_all(cs, fn)
        pieces[f"compare and where {int(mc[5])}"] = {
            "ms": cs.time_cuda(fn, 200), "device_ms": dms,
            "device_ops": ops}
    tot = lambda key: sum(v[key] for v in pieces.values())
    return {"host_ms": host, "host_ms_median": float(np.median(host)),
            "events_ms": span, "events_ms_median": float(np.median(span)),
            "pieces": pieces, "pieces_device_ms": tot("device_ms"),
            "pieces_device_ops": tot("device_ops"),
            "launches_a_pass": launches}


def k25(cs, dev):
    """K25 on seeded statistic rows at 28 and 510 CTUs."""
    from hmtpu_torch.common.lambdas import frame_lambdas
    from hmtpu_torch.ops import sao

    rng = np.random.RandomState(25)
    lam = torch.tensor(frame_lambdas(22, 22, 0.57)[0], dtype=torch.float32,
                       device=dev)
    out = {}
    for h, w in ((H, W), (1080, 1920)):
        ny, nx = -(-h // 64), -(-w // 64)
        rows = []
        for _ in range(3):
            cnt = rng.choice([0, 1, 5, 60, 900], (ny * nx, 48))
            s = (rng.randint(-12, 13, cnt.shape) * cnt) // 3
            r = np.empty((ny * nx, 96), np.int32)
            r[:, 0:16], r[:, 16:32] = s[:, :16], cnt[:, :16]
            r[:, 32:64], r[:, 64:96] = s[:, 16:], cnt[:, 16:]
            rows.append(torch.as_tensor(r).to(dev))
        nctu = ny * nx
        fn = lambda: sao.choose_params(*rows, lam, 8, ny, nx)
        row = _row(cs, fn, "sao_choose_kernel", 4 * (3 * 96 + 21) * nctu + 4)
        row["plain_ms"] = cs.time_cuda(
            lambda: sao.choose_params_plain(*rows, lam, 8, ny, nx), 5)
        out[f"{w}x{h} ({nctu} CTUs)"] = row
    return out


def _profile_stats(cs, prof, kernel_fn):
    """From a stopped torch.profiler run: top-level torch operations (CPU
    events with no parent named aten::), every top-level event by name
    (the CUDA runtime's calls among them), device operations and device
    ms, and the launches and device ms of CUDA functions named like
    kernel_fn."""
    from torch.autograd import DeviceType

    top = [e for e in prof.events() if e.device_type == DeviceType.CPU
           and getattr(e, "cpu_parent", None) is None]
    names = {}
    for e in top:
        names[e.name] = names.get(e.name, 0) + 1
    dev = [e for e in prof.key_averages() if cs.self_device_us(e) > 0]
    kern = [e for e in dev if kernel_fn in e.key]
    return {"torch_ops": sum(v for k, v in names.items()
                             if k.startswith("aten::")),
            "top_level_events": dict(sorted(names.items())),
            "device_ops": sum(e.count for e in dev),
            "device_ops_by_name": {e.key[:60]: e.count for e in dev},
            "device_ms": sum(cs.self_device_us(e) for e in dev) / 1e3,
            "kernel_launches": sum(e.count for e in kern),
            "kernel_device_ms": sum(cs.self_device_us(e) for e in kern)
            / 1e3}


def _stretch(cs, call, mod, pass_name, reps=10):
    """The deblocking stretch of call(): from mod.<pass_name>'s return to
    mod.sao_frame_dev's entry.  Host ms and CUDA-event ms over `reps`
    calls (a device sync at the pass's return first: the stretch's own
    host time, not the wait for the pass's queued kernels), and the host
    ms of K3's wrapper as the pass calls it inside the stretch; then one
    call with torch.profiler running over the stretch alone (a device
    sync at both ends)."""
    from torch.profiler import ProfilerActivity, profile

    inner_pass, inner_sao = getattr(mod, pass_name), mod.sao_frame_dev
    # K3's wrapper as the pass calls it (the state form, or the 4x4-map
    # form after the glue): its own host ms inside the stretch
    k3_name = "deblock_state" if hasattr(mod, "deblock_state") \
        else "deblock_frame_dev"
    inner_k3 = getattr(mod, k3_name)
    state = {"prof": None, "marks": [], "k3": []}

    def k3_(*a, **k):
        t = time.perf_counter()
        out = inner_k3(*a, **k)
        state["k3"].append((time.perf_counter() - t) * 1e3)
        return out

    def mark():
        t = time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        state["marks"].append((t, e))

    def pass_(*a, **k):
        out = inner_pass(*a, **k)
        torch.cuda.synchronize()
        if state["prof"] is not None:
            state["prof"].start()
        else:
            mark()
        return out

    def sao_(*a, **k):
        if state["prof"] is not None:
            torch.cuda.synchronize()
            state["prof"].stop()
        else:
            mark()
        return inner_sao(*a, **k)

    setattr(mod, pass_name, pass_)
    mod.sao_frame_dev = sao_
    setattr(mod, k3_name, k3_)
    host, span = [], []
    try:
        call()
        state["k3"].clear()
        for _ in range(reps):
            state["marks"].clear()
            call()
            torch.cuda.synchronize()
            (h0, e0), (h1, e1) = state["marks"]
            host.append((h1 - h0) * 1e3)
            span.append(e0.elapsed_time(e1))
        state["prof"] = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
        call()
        torch.cuda.synchronize()
    finally:
        setattr(mod, pass_name, inner_pass)
        mod.sao_frame_dev = inner_sao
        setattr(mod, k3_name, inner_k3)
    return {"host_ms": host, "host_ms_median": float(np.median(host)),
            "events_ms": span, "events_ms_median": float(np.median(span)),
            f"{k3_name}_host_ms_median": float(np.median(state["k3"][:reps])),
            **_profile_stats(cs, state["prof"], "deblock_kernel")}


def _p_glue(rec_y, rec_u, rec_v, blk, qp, bd, ref_pocs, num_ref, w, h):
    """The P pass's deblocking inputs from its 8x8 state, as
    hmtpu_torch/encoder/pframe_dev.py built them before
    `deblock.deblock_state` (P slices), then `deblock_frame_dev`."""
    from hmtpu_torch.ops.deblock import deblock_frame_dev

    K_DIR, K_MVX, K_MVY, K_REF, K_SZ, K_CBFY = 5, 6, 7, 8, 9, 10
    K_MVX1, K_MVY1 = 11, 12
    dev = blk.device
    bw, bh = w // 8, h // 8
    rep4 = lambda a: a.reshape(bh, bw).repeat_interleave(2, 0) \
        .repeat_interleave(2, 1)
    dirf = blk[:, K_DIR]
    u0f, u1f = (dirf & 1) > 0, (dirf & 2) > 0
    pocs = lambda pl, col_, nr: torch.tensor(
        list(pl), dtype=torch.int32, device=dev)[torch.clamp(
            blk[:, col_], 0, nr - 1).to(torch.int64)]
    rp0 = torch.where(u0f, pocs(ref_pocs, K_REF, num_ref), -1)
    rp1 = torch.full_like(dirf, -1)
    mv_x4 = torch.stack([rep4(torch.where(u0f, blk[:, K_MVX], 0)),
                         rep4(torch.where(u1f, blk[:, K_MVX1], 0))])
    mv_y4 = torch.stack([rep4(torch.where(u0f, blk[:, K_MVY], 0)),
                         rep4(torch.where(u1f, blk[:, K_MVY1], 0))])
    refpoc4 = torch.stack([rep4(rp0), rep4(rp1)])
    cusz8 = blk[:, K_SZ].reshape(bh, bw)
    ev = torch.arange(bw - 1, device=dev)
    int_v = ((cusz8[:, :-1] == 1) & ((ev % 2) == 0)[None, :]) \
        | ((cusz8[:, :-1] == 2) & ((ev % 4) != 3)[None, :])
    eh = torch.arange(bh - 1, device=dev)
    int_h = ((cusz8[:-1, :] == 1) & ((eh % 2) == 0)[:, None]) \
        | ((cusz8[:-1, :] == 2) & ((eh % 4) != 3)[:, None])
    return deblock_frame_dev(
        rec_y, rec_u, rec_v, rep4(dirf == 0), rep4(blk[:, K_CBFY] > 0),
        mv_x4, mv_y4, refpoc4, qp, bd, int_v=int_v, int_h=int_h)


def dbk(cs, dev):
    """Deblocking's stretch of ldp's I and P passes and ra10's POC 8 B
    pass, and at a seeded 1920x1080 P state (see the top)."""
    from hmtpu_torch.encoder import iframe_dev, pframe_dev
    from hmtpu_torch.ops import deblock

    from hmtpu_torch import kernels
    from hmtpu_torch.encoder.top import Encoder, EncoderConfig
    from hmtpu_torch.io.yuv import Frame
    from hmtpu_torch.utils.gen_test_yuv import synth_clip

    kept = _ldp_pass_args(dev)
    ra = _ra_pass_args(dev)
    # K3's and K19's launches an encode: ldp (I + P), ra10 (I + 8 B), and
    # all-intra QP 32 with TS, one 8-bit frame and two 10-bit ones
    launches = {"ldp I + P": kept["launches"],
                "ra10 I + 8 B": ra["launches"]}
    clip = list(synth_clip(W, H, 2, seed=42))
    for label, n, bd in (("ai 1 frame", 1, 8), ("ai 2 frames 10 bits", 2,
                                                 10)):
        kernels.reset_counts()
        Encoder(EncoderConfig(width=W, height=H, qp=32, gop="ai",
                              subpel="none", transform_skip=True,
                              bit_depth=bd), device=dev).encode_sequence(
            [Frame(*(np.asarray(p, np.int32) << (bd - 8) for p in f), bd)
             for f in clip[:n]])
        launches[label] = {k: kernels.COUNTS[k]
                           for k in ("deblock", "mv_regularize")}
    out = {"launches": launches}
    for label, key, src, mod, pname in (
            ("ldp I", "iframe_full_pass", kept, iframe_dev, "iframe_pass"),
            ("ldp P", "full_pframe_pass", kept, pframe_dev,
             "wavefront_pass"),
            ("ra10 POC 8 B", "full_pframe_pass", ra, pframe_dev,
             "wavefront_pass")):
        a, k = src[key]
        fn = iframe_dev.iframe_full_pass if mod is iframe_dev \
            else pframe_dev.full_pframe_pass
        out[label] = _stretch(cs, lambda: fn(*a, **k), mod, pname)
    h, w = 1080, 1920
    y, u, v, blk, (pocs, _) = cs.seeded_p_state(dev, h, w)
    if hasattr(deblock, "deblock_state"):
        fn = lambda: deblock.deblock_state(y, u, v, blk, 27, 8, h=h, w=w,
                                           ref_pocs=pocs)
        form = "deblock_state"
    else:
        fn = lambda: _p_glue(y, u, v, blk, 27, 8, pocs, len(pocs), w, h)
        form = "glue + deblock_frame_dev"
    from torch.profiler import ProfilerActivity, profile

    ms = cs.time_cuda(fn, 50)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out[f"{w}x{h} seeded P state ({form})"] = {
        "ms": ms, "k3_device_ms_20_calls": cs.device_ms(fn,
                                                        "deblock_kernel"),
        **_profile_stats(cs, prof, "deblock_kernel")}
    return out


def k19(cs, dev):
    """K19 at ldp's field and a seeded 1920x1080 one (see the top)."""
    from torch.profiler import ProfilerActivity, profile

    from hmtpu_torch.search import me

    a, k = _ldp_pass_args(dev)["regularize_mv_field"]
    out = {}
    for label, args, kw in (
            (f"ldp field {tuple(a[2].shape)}, {a[0].shape[0]} references",
             a, k),
            ("1920x1080 seeded (135, 240), 4 references",
             cs.seeded_field(dev, 1080, 1920), {"iters": 3})):
        fn = lambda: me.regularize_mv_field(*args, **kw)
        ms = cs.time_cuda(fn, 200)
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        st = _profile_stats(cs, prof, "reg_kernel")
        n = max(st["kernel_launches"], 1)
        out[label] = {"ms": ms, "device_ms_a_call": st["device_ms"] / 20,
                      "device_ops_a_call": st["device_ops"] / 20,
                      "torch_ops_a_call": st["torch_ops"] / 20,
                      "k19_launches_a_call": st["kernel_launches"] / 20,
                      "k19_device_ms_a_launch": st["kernel_device_ms"] / n,
                      "top_level_events_20_calls":
                          st["top_level_events"]}
    return out


_KEPT_DCTIF: dict = {}


def _dctif_pass_args(cs, dev):
    """The arguments of ldp_dctif's P pass (`full_pframe_pass`: the LDP
    cfg with --SubPel=dctif through the CLI, 416x240, QP 22, 2 frames of
    the clip), kept from one encode."""
    if _KEPT_DCTIF:
        return _KEPT_DCTIF
    import tempfile

    from hmtpu_torch.encoder import pframe_dev
    from hmtpu_torch.utils.gen_test_yuv import synth_clip

    clip = list(synth_clip(W, H, 2, seed=42))
    with tempfile.TemporaryDirectory() as d:
        yuv = os.path.join(d, "clip.yuv")
        cs.write_yuv(yuv, clip)
        return _keep_args(_KEPT_DCTIF, ((pframe_dev, "full_pframe_pass"),),
                          lambda: cs.cli_encode(
                              ["-c", cs.LDP_CFG, "--SubPel=dctif", "-q", "22",
                               "-f", "2", "-wdt", str(W), "-hgt", str(H),
                               "-i", yuv, "-b", os.path.join(d, "o.hevc")],
                              dev))


def _events(call, wraps):
    """call() with each (module, function) of wraps wrapped: the
    ("function", "entry" / "return") events in order, and each call's
    arguments (cloned) by function."""
    log, args = [], {}
    inner = {(m, n): getattr(m, n) for m, n in wraps}

    def wrap(m, n):
        def g(*a, **k):
            log.append((n, "entry"))
            args.setdefault(n, []).append((
                tuple(x.clone() if isinstance(x, torch.Tensor) else x
                      for x in a), dict(k)))
            out = inner[(m, n)](*a, **k)
            log.append((n, "return"))
            return out
        return g

    for m, n in inner:
        setattr(m, n, wrap(m, n))
    try:
        call()
        torch.cuda.synchronize()
    finally:
        for (m, n), f in inner.items():
            setattr(m, n, f)
    return log, args


def _nth(log, ev, before=None, after=None):
    """How many times event ev happened in log (up to index `before`),
    or the count of ev up to the first ev after index `after`."""
    if after is not None:
        nxt = next(i for i in range(after, len(log)) if log[i] == ev)
        return sum(1 for e in log[:nxt + 1] if e == ev)
    return sum(1 for e in log[:before] if e == ev)


def _marked_stretch(cs, call, wraps, start, end, kernel_fn, reps=10):
    """The stretch of call() from event `start` to event `end`, each
    (function, "entry" / "return", k): the k-th such event of a call.  At
    each mark the device is synced first, so the host ms are the
    stretch's own.  Host ms and CUDA-event ms over `reps` calls, then one
    call with torch.profiler running over the stretch alone
    (`_profile_stats`)."""
    from torch.profiler import ProfilerActivity, profile

    state = {"prof": None, "marks": [], "seen": {}}
    inner = {(m, n): getattr(m, n) for m, n in wraps}

    def mark(ev):
        k = state["seen"][ev] = state["seen"].get(ev, 0) + 1
        if (ev + (k,)) not in (start, end):
            return
        torch.cuda.synchronize()
        if state["prof"] is not None:
            (state["prof"].start if ev + (k,) == start
             else state["prof"].stop)()
            return
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        state["marks"].append((time.perf_counter(), e))

    def wrap(m, n):
        def g(*a, **k):
            mark((n, "entry"))
            out = inner[(m, n)](*a, **k)
            mark((n, "return"))
            return out
        return g

    for m, n in inner:
        setattr(m, n, wrap(m, n))
    host, span = [], []
    try:
        for _ in range(reps):
            state["marks"].clear()
            state["seen"].clear()
            call()
            torch.cuda.synchronize()
            (h0, e0), (h1, e1) = state["marks"]
            host.append((h1 - h0) * 1e3)
            span.append(e0.elapsed_time(e1))
        state["seen"].clear()
        state["prof"] = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
        call()
        torch.cuda.synchronize()
    finally:
        for (m, n), f in inner.items():
            setattr(m, n, f)
    return {"host_ms": host, "host_ms_median": float(np.median(host)),
            "events_ms": span, "events_ms_median": float(np.median(span)),
            **_profile_stats(cs, state["prof"], kernel_fn)}


def _replays(cs, fn_of, calls, fname):
    """Each captured call replayed alone: ms (CUDA events over 200
    calls), device ms (the kernel's own) and launches a call."""
    from hmtpu_torch import kernels

    out = []
    for label, fn in calls:
        kernel = fn_of
        before = kernels.COUNTS[kernel]
        fn()
        torch.cuda.synchronize()
        out.append({"call": label, "launches": kernels.COUNTS[kernel]
                    - before, "ms": cs.time_cuda(fn, 200),
                    "device_ms": cs.device_ms(fn, fname)})
    return out


def k9(cs, dev):
    """K9 on ldp_dctif's P pass and ra10's POC 8 B pass (each level's
    call, or the levels form's), at the extraction's 1920x1080 shape,
    and the DCT-IF stretch of both passes: from the last union reference
    index of the pass's levels (`_union_idx`) to the last K9 return."""
    from hmtpu_torch.encoder import pframe_dev
    from hmtpu_torch.search import me

    levels_form = hasattr(me, "frac_refine_levels")
    k9_fn = "frac_refine_levels" if levels_form else "frac_refine_batch"
    out = {"form": k9_fn}
    for label, kept in (("ldp_dctif P", _dctif_pass_args(cs, dev)),
                        ("ra10 POC 8 B", _ra_pass_args(dev))):
        a, k = kept["full_pframe_pass"]
        call = lambda: pframe_dev.full_pframe_pass(*a, **k)
        call()
        wraps = ((pframe_dev, "_union_idx"), (me, k9_fn),
                 (pframe_dev, "wavefront_pass"))
        log, args = _events(call, wraps)
        first = log.index((k9_fn, "entry"))
        last = max(i for i, e in enumerate(log) if e == (k9_fn, "return"))
        start = ("_union_idx", "return",
                 _nth(log, ("_union_idx", "return"), before=first))
        end = (k9_fn, "return", _nth(log, (k9_fn, "return"),
                                      before=last + 1))
        f = getattr(me, k9_fn)
        calls = [(f"{k9_fn} " + (
            ", ".join(str(lv[3]) for lv in ca[2]) if levels_form
            else str(ca[6])), (lambda f=f, ca=ca, ck=ck: f(*ca, **ck)))
            for ca, ck in args[k9_fn]]
        if levels_form:
            # and each level alone through the levels form
            ca, ck = args[k9_fn][0]
            calls += [(f"{k9_fn} {lv[3]} alone",
                       lambda lv=lv: f(ca[0], ca[1], [lv], *ca[3:], **ck))
                      for lv in ca[2]]
        out[label] = {
            "calls": _replays(cs, "frac_refine", calls, "frac_"),
            "stretch": _marked_stretch(cs, call, wraps, start, end,
                                       "frac_")}
    # the extraction's call at 1920x1080: the single-level ME's integer
    # MVs of the clip's second frame against its first, 32,400 8x8 blocks
    hd = cs.frames_of(cs.hd_clip()[:2])
    org = torch.as_tensor(hd[1].y).to(dev)
    ref = torch.as_tensor(hd[0].y).to(dev)
    bh, bw = org.shape[0] // 8, org.shape[1] // 8
    lam = np.float32(np.sqrt(0.57 * 2.0 ** ((22 - 12) / 3.0)))
    z = torch.zeros((bh, bw), dtype=torch.int32, device=dev)
    (mvx, mvy), _, _ = me.integer_me(ref, org, 8, 64, lam, z, z, 8)
    q = torch.arange(bh * bw, dtype=torch.int32, device=dev)
    blocks = org.reshape(bh, 8, bw, 8).transpose(1, 2).reshape(-1, 8, 8) \
        .contiguous()
    hd_calls = [("frac_refine_batch (32400, 8, 8)",
                 lambda: me.frac_refine_batch(
                     ref, (q % bw) * 8, (q // bw) * 8, blocks,
                     mvx.reshape(-1), mvy.reshape(-1), 8, 8))]
    if levels_form:
        hd_calls.append(("frac_refine_levels, the 8 level over the plane",
                         lambda: me.frac_refine_levels(
                             ref, org, [(mvx, mvy, z, 8)], 8)))
    out["1920x1080 extraction"] = _replays(cs, "frac_refine", hd_calls,
                                           "frac_")
    return out


def k24(cs, dev):
    """K24 on ldp's P pass: each captured grid call (or the grids form's
    one), and the stretch from K22's `rmd` return to the first
    `_blockify` after the last K24 call (the temporal candidates of the
    three grids)."""
    from hmtpu_torch.encoder import pframe_dev

    grids_form = hasattr(pframe_dev, "tmvp_grids")
    k24_fn = "tmvp_grids" if grids_form else "tmvp_grid"
    a, k = _ldp_pass_args(dev)["full_pframe_pass"]
    call = lambda: pframe_dev.full_pframe_pass(*a, **k)
    call()
    wraps = ((pframe_dev, "rmd"), (pframe_dev, k24_fn),
             (pframe_dev, "_blockify"))
    log, args = _events(call, wraps)
    first = log.index((k24_fn, "entry"))
    last = max(i for i, e in enumerate(log) if e == (k24_fn, "return"))
    start = ("rmd", "return", _nth(log, ("rmd", "return"), before=first))
    end = ("_blockify", "entry", _nth(log, ("_blockify", "entry"),
                                      after=last))
    f = getattr(pframe_dev, k24_fn)
    calls = [(f"{k24_fn} " + (str(ca[2]) if not grids_form else "8, 16, 32"),
              (lambda ca=ca, ck=ck: f(*ca, **ck))) for ca, ck in args[k24_fn]]
    return {"form": k24_fn,
            "calls": _replays(cs, "tmvp_grid", calls, "tmvp_"),
            "stretch": _marked_stretch(cs, call, wraps, start, end,
                                       "tmvp_")}


def ts(cs, dev):
    """ldp_dctif's 8-level AMVP hypothesis with the transform-skip trial
    of its chroma pair (`pframe_walk`'s `hypothesis(with_ts=True)`):
    from the first `_union_idx` entry after `pframe_walk`'s entry to the
    first `rmd` entry after it, measured as k9's stretch; K1's and K10's
    launches in it are the profile's `device_ops_by_name`."""
    from hmtpu_torch.encoder import pframe_dev

    a, k = _dctif_pass_args(cs, dev)["full_pframe_pass"]
    call = lambda: pframe_dev.full_pframe_pass(*a, **k)
    call()
    wraps = ((pframe_dev, "pframe_walk"), (pframe_dev, "_union_idx"),
             (pframe_dev, "rmd"))
    log, _ = _events(call, wraps)
    w0 = log.index(("pframe_walk", "entry"))
    start = ("_union_idx", "entry",
             _nth(log, ("_union_idx", "entry"), after=w0))
    end = ("rmd", "entry", _nth(log, ("rmd", "entry"), after=w0))
    return {"stretch": _marked_stretch(cs, call, wraps, start, end,
                                       "level_kernel")}


PARTS = {"k1": k1_rows, "k6": k6_rows, "walk": walk, "gate": gate,
         "k25": k25, "dbk": dbk, "k19": k19, "k9": k9, "k24": k24, "ts": ts}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated parts, of " + ", ".join(PARTS))
    parts = ap.parse_args().parts.split(",")
    if any(p not in PARTS for p in parts):
        print(f"code_step_times: parts are {list(PARTS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("code_step_times: no CUDA device", file=sys.stderr)
        return 2
    from hmtpu_torch import kernels

    cs = _smoke()
    kernels.build_all()
    dev = torch.device("cuda", 0)
    nk = len(kernels.KERNELS)
    for p in parts:
        print(json.dumps({"part": p, "kernels": nk, **PARTS[p](cs, dev)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
