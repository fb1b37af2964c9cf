"""Drive the PyTorch/CUDA port (hmtpu_torch) end to end on one GPU.

    python3 chip_smoke.py                 # the whole check, one card
    python3 chip_smoke.py --profile DIR   # also trace one 64x64 frame

Phases (any failure exits non-zero, and the result line is printed only
when every phase passed):

  1. device    the card's name and power limit (nvidia-smi);
  2. build     nvcc for every kernel source in hmtpu_torch/csrc, one
               process per source, all started together;
  3. kernels   each kernel against its plain PyTorch version on the same
               seeded inputs at the shapes the main path gives it: they
               must be equal (all four are integer).  Each is timed with
               CUDA events, beside its plain version, the bound for its
               bytes and operations, and for the transform a float64
               torch.matmul yardstick; torch.profiler gives each one's
               own device time;
  4. main      the all-intra encode (416x240, QP 32, CTU 64, RDOQ, SDH,
               deblocking and SAO) of 3 frames of a seeded synthetic
               clip through Encoder.encode_sequence, with every kernel
               count reset before and read after: each must be > 0.
               nvidia-smi samples the card's utilization meanwhile (the
               device's busy share).  With --profile, one 64x64 frame
               under torch.profiler (device operations and their time:
               a 416x240 frame issues too many for the profiler);
  5. parity    the main clip's first frame through the port on the CPU
               (the plain versions) must give the card's first access
               unit byte for byte; likewise a 64x64 clip at QP 22 and 37.

Imports nothing from hmtpu or JAX.  The last line of the output is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet) used for the bound of each kernel:
# device memory 3.35 TB/s; the kernels do int32 ALU work, bounded here
# by the card's non-tensor-core float32 rate of 67 T operations/s
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
W, H, QP, FRAMES = 416, 240, 32, 3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def synth_clip(width, height, frames, seed=42):
    """Seeded synthetic 4:2:0 clip: moving sinusoids, a travelling blob
    and noise (the content class of the repo's HM baseline clip)."""
    rng = np.random.RandomState(seed)
    xx, yy = np.meshgrid(np.arange(width), np.arange(height))
    out = []
    for t in range(frames):
        y = (128 + 60 * np.sin(xx / 23.0 + t * 0.3) * np.cos(yy / 17.0)
             + 40 * np.exp(-(((xx - (100 + 3 * t)) ** 2
                              + (yy - height // 2) ** 2) / 1800.0))
             + rng.randn(height, width) * 3)
        u = 128 + 30 * np.sin((xx[::2, ::2] + t * 4) / 31.0)
        v = 128 + 30 * np.cos((yy[::2, ::2] - t * 3) / 29.0)
        out.append(tuple(np.clip(p, 0, 255).astype(np.uint8)
                         for p in (y, u, v)))
    return out


def time_cuda(fn, iters: int) -> float:
    """Mean milliseconds per call of fn over `iters` calls, CUDA events
    around the loop, after warm-up."""
    for _ in range(2):
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


# the CUDA function each kernel runs, as the profiler names it
DEVICE_FN = {
    "int_transform_fwd": "transform_kernel<false>",
    "int_transform_inv": "transform_kernel<true>",
    "intra_filter": "filter_kernel", "intra_pred": "pred_kernel",
    "deblock": "deblock_kernel", "sao_stats": "stats_kernel",
    "sao_apply": "apply_kernel",
}


def self_device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def device_ms(fn, fname: str, iters: int = 20) -> float:
    """Device milliseconds per call of fn spent in CUDA functions named
    like `fname` (torch.profiler, device activity): the kernel's own time,
    without the host's launch cost that time_cuda sees at small shapes."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if fname in e.key]
    if not evs:
        fail(f"profiler saw no {fname} launch")
    return sum(self_device_us(e) for e in evs) / 1e3 / iters


def bound_ms(nbytes: float, ops: float):
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def kernel_cases(dev):
    """(name, kernel call, plain call, bytes, ops, library call) at the
    main path's shapes, inputs made from a seed."""
    from hmtpu_torch.ops import deblock, intra_pred, sao, transform

    rng = np.random.RandomState(1)
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(dev)
    cases = []

    # K1: one z-scan cell step's luma batch (K=2 candidates x 7 CUs of
    # 8x8); residuals in, coefficients in
    nb, n = 14, 8
    res = t32(rng.randint(-255, 256, (nb, n, n)))
    coef = t32(rng.randint(-2000, 2001, (nb, n, n)))
    mat = transform.matrix(n, False, dev).to(torch.float64)
    io = 2 * nb * n * n * 4
    ops = 4 * nb * n ** 3
    cases.append(("int_transform_fwd",
                  lambda: transform.forward_transform(res, n),
                  lambda: transform.forward_transform_plain(res, n),
                  io, ops,
                  lambda: torch.matmul(mat, torch.matmul(
                      mat, res.to(torch.float64).transpose(-1, -2))
                      .transpose(-1, -2))))
    cases.append(("int_transform_inv",
                  lambda: transform.inverse_transform(coef, n),
                  lambda: transform.inverse_transform_plain(coef, n),
                  io, ops,
                  lambda: torch.matmul(torch.matmul(
                      mat.T, coef.to(torch.float64)), mat)))

    # K2: the rough mode decision at n=8, P = 1560 blocks of 416x240
    p8, n = (W // 8) * (H // 8), 8
    line = 4 * n + 1
    ref = t32(rng.randint(0, 256, (p8, line)))
    reff = intra_pred.filter_reference_plain(ref, n, 8, False)
    cases.append(("intra_filter",
                  lambda: intra_pred.filter_reference_batched(ref, n, 8,
                                                              False),
                  lambda: intra_pred.filter_reference_plain(ref, n, 8,
                                                            False),
                  2 * p8 * line * 4, 4 * p8 * line, None))
    cases.append(("intra_pred",
                  lambda: intra_pred.predict_all_modes(ref, reff, n),
                  lambda: intra_pred.predict_modes_plain(
                      ref, reff, torch.arange(35, device=dev)
                      .expand(p8, 35), n),
                  (2 * p8 * line + p8 * 35 + p8 * 35 * n * n) * 4,
                  5 * p8 * 35 * n * n, None))

    # K3: one 416x240 picture (intra, random cbf and CU sizes)
    y = t32(rng.randint(60, 200, (H, W)))
    u = t32(rng.randint(60, 200, (H // 2, W // 2)))
    v = t32(rng.randint(60, 200, (H // 2, W // 2)))
    intra4 = torch.ones((H // 4, W // 4), dtype=torch.bool, device=dev)
    cbf4 = t32(rng.randint(0, 2, (H // 4, W // 4))).bool()
    mv = torch.zeros((2, H // 4, W // 4), dtype=torch.int32, device=dev)
    rp = torch.full((2, H // 4, W // 4), -1, dtype=torch.int32,
                    device=dev)
    int_v = t32(rng.randint(0, 2, (H // 8, W // 8 - 1))).bool()
    int_h = t32(rng.randint(0, 2, (H // 8 - 1, W // 8))).bool()
    dbk = (y, u, v, intra4, cbf4, mv, mv, rp, QP)
    npx = H * W * 3 // 2
    cases.append(("deblock",
                  lambda: deblock.deblock_frame_dev(*dbk, int_v=int_v,
                                                    int_h=int_h),
                  lambda: deblock.deblock_frame_plain(*dbk, int_v=int_v,
                                                      int_h=int_h),
                  # planes in and out (int32), the motion arrays (int32)
                  # and the intra/cbf/interior masks (bool)
                  2 * npx * 4 + (H // 4) * (W // 4) * (6 * 4 + 2)
                  + int_v.numel() + int_h.numel(),
                  # per 4-line luma segment: ~60 decision + 4 x 6 x 8
                  # filter operations, both directions
                  2 * (H // 4) * (W // 8) * (60 + 4 * 6 * 8), None))

    # K4: the luma plane of one picture, CTU 64
    org = t32(np.clip(y.cpu().numpy() + rng.randint(-6, 7, (H, W)),
                      0, 255))
    nctu = -(-H // 64) * -(-W // 64)
    params = t32(np.stack([rng.randint(0, 3, (4, 7)), rng.randint(0, 4, (4, 7)),
                           rng.randint(0, 29, (4, 7))]
                          + [rng.randint(-7, 8, (4, 7)) for _ in range(4)],
                          -1))
    cases.append(("sao_stats",
                  lambda: sao._sao_stats(org, y, 64, 8),
                  lambda: sao.sao_stats_plain(org, y, 64, 8),
                  (2 * H * W + nctu * 96) * 4, 30 * H * W, None))
    cases.append(("sao_apply",
                  lambda: sao.apply_sao_dev(y, params, 64, 8),
                  lambda: sao.apply_sao_plain(y, params, 64, 8),
                  (2 * H * W + nctu * 7) * 4, 12 * H * W, None))
    return cases


def same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return all(same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and bool((a.to(torch.int64)
                                        == b.to(torch.int64)).all())


def max_err(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(max_err(x, y) for x, y in zip(a, b))
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def encode(frames, qp, device):
    from hmtpu_torch.encoder.top import Encoder, EncoderConfig
    from hmtpu_torch.io.yuv import Frame

    h, w = frames[0][0].shape
    enc = Encoder(EncoderConfig(width=w, height=h, qp=qp, gop="ai",
                                subpel="none"), device=device)
    t0 = time.time()
    bs = enc.encode_sequence([Frame(*f, 8) for f in frames])
    if device != "cpu":
        torch.cuda.synchronize()
    return bs, time.time() - t0, enc.results


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="",
                    help="directory for a torch.profiler table of one "
                         "64x64 frame (optional)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device: this check runs on the card")
    try:
        from hmtpu_torch import kernels
    except ImportError as e:
        fail(f"the hmtpu_torch package is not beside this script ({e})")
    dev = torch.device("cuda", 0)

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # ---- 2. build
    t0 = time.time()
    logs = kernels.build_all()
    print(f"build: {len(logs)} sources in {time.time() - t0:.1f} s",
          flush=True)
    for src, log in logs.items():
        for ln in log.strip().splitlines():
            print(f"  nvcc {src}: {ln}", flush=True)

    # ---- 3. kernels against their plain versions
    rows = {}
    for name, kfn, pfn, nbytes, ops, lib in kernel_cases(dev):
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        if not same(got, want):
            fail(f"{name}: kernel disagrees with its plain version "
                 f"(max abs err {max_err(got, want)})")
        ms = time_cuda(kfn, 200)
        pms = time_cuda(pfn, 20)
        lms = time_cuda(lib, 200) if lib is not None else None
        dms = device_ms(kfn, DEVICE_FN[name])
        bms, by = bound_ms(nbytes, ops)
        src, repl = kernels.KERNELS[name]
        rows[name] = dict(
            name=name, route="cuda", source=f"hmtpu_torch/csrc/{src}.cu",
            replaces=repl, launches=0, max_abs_err=max_err(got, want),
            ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
            library_ms=lms, device_ms=dms)
        print(f"kernel {name}: equal to plain; {ms:.4f} ms per call, "
              f"{dms:.4f} ms on the device (plain {pms:.4f} ms, bound "
              f"{bms:.6f} ms by {by}"
              + (f", float64 matmul {lms:.4f} ms" if lms else "")
              + ")", flush=True)

    # ---- 4. the main path
    clip = synth_clip(W, H, FRAMES, seed=42)
    small = synth_clip(64, 64, 2, seed=3)
    encode(small[:1], QP, dev)          # warm-up: libraries, allocator
    kernels.reset_counts()
    smi_util = subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "500"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        bs, dt, results = encode(clip, QP, dev)
    finally:
        smi_util.terminate()
        util = [float(x) for x in smi_util.communicate(timeout=60)[0].split()
                if x.strip().replace(".", "", 1).isdigit()]
    counts = dict(kernels.COUNTS)
    for name, c in counts.items():
        rows[name]["launches"] = c
        if c <= 0:
            fail(f"{name}: not launched on the main path")
    fps = FRAMES / dt
    kbps = sum(r.bits for r in results) / FRAMES * 50 / 1000.0
    for r in results:
        if not (np.isfinite(r.psnr_y) and r.psnr_y > 30.0):
            fail(f"POC {r.poc}: implausible PSNR-Y {r.psnr_y}")
    print(f"main: 416x240 AI QP{QP}, {FRAMES} frames, {len(bs)} bytes, "
          f"{dt:.3f} s, {fps:.4f} fps, {kbps:.3f} kbps at 50 fps, PSNR "
          + ", ".join(f"POC{r.poc} Y {r.psnr_y:.4f} U {r.psnr_u:.4f} "
                      f"V {r.psnr_v:.4f}" for r in results), flush=True)
    print("main: seconds per frame "
          + ", ".join(f"POC{r.poc} {r.seconds:.3f}" for r in results)
          + (f"; card utilization (nvidia-smi, {len(util)} samples) mean "
             f"{np.mean(util):.2f} %" if util else ""), flush=True)
    print("kernels: " + ", ".join(f"{k} {v}" for k, v in counts.items())
          + f" launches in {FRAMES} frames", flush=True)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(args.profile, exist_ok=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, pdt, _ = encode(small[:1], QP, dev)
        avgs = prof.key_averages()
        on_dev = [e for e in avgs if self_device_us(e) > 0]
        busy = sum(self_device_us(e) for e in on_dev) / 1e3
        nops = sum(e.count for e in on_dev)
        with open(os.path.join(args.profile, "profile_ai_64x64.txt"),
                  "w") as f:
            f.write(avgs.table(sort_by="self_device_time_total",
                               row_limit=40))
        print(f"profile: one 64x64 frame {pdt * 1e3:.1f} ms wall under "
              f"the profiler, {nops} device operations, device busy "
              f"{busy:.1f} ms ({100 * busy / (pdt * 1e3):.2f} %), "
              f"{pdt * 1e6 / max(nops, 1):.2f} us of wall time per device "
              f"operation", flush=True)

    # ---- 5. card against CPU
    cpu_bs, cpu_dt, _ = encode(clip[:1], QP, "cpu")
    if bs[:len(cpu_bs)] != cpu_bs:
        fail("416x240 frame 0: card and CPU access units differ")
    print(f"parity: 416x240 frame 0 card == CPU ({len(cpu_bs)} bytes; "
          f"CPU {cpu_dt:.1f} s)", flush=True)
    for qp in (22, 37):
        a, _, _ = encode(small, qp, dev)
        b, _, _ = encode(small, qp, "cpu")
        if a != b:
            fail(f"64x64 QP{qp}: card and CPU streams differ")
        print(f"parity: 64x64 QP{qp} card == CPU ({len(a)} bytes)",
              flush=True)

    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
