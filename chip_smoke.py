"""Drive the PyTorch/CUDA port (hmtpu_torch) end to end on one GPU.

    python3 chip_smoke.py                 # the whole check, one card
    python3 chip_smoke.py --profile DIR   # also trace 64x64 frames

Phases (any failure exits non-zero, and the result line is printed only
when every phase passed):

  1. device    the card's name and power limit (nvidia-smi);
  2. build     nvcc for every kernel source in hmtpu_torch/csrc, one
               process per source, all started together;
  3. kernels   each kernel (K1-K12 and K1's transform-skip mode) against
               its plain PyTorch version on seeded inputs at the shapes
               the main paths give it: they must be equal (the float32
               outputs of K6 and K10 bit for bit: kernel and plain version
               round in the same order).  Each is timed with CUDA events,
               beside its plain version, the bound for its bytes and
               operations, and for the transform a float64 torch.matmul
               yardstick; torch.profiler gives each one's own device time;
  4. ldp       the main path: the low-delay-P encode with NN-FME
               (416x240, QP 22, GOP QP offsets 3/2/3/1, 4 references,
               search range 64, CTU 64, TMVP, RDOQ, SDH, deblocking and
               SAO) of 2 frames (an I and a P picture) of a seeded
               synthetic clip through Encoder.encode_sequence, every
               kernel count reset before and read after: each of K1-K8
               and K10 must be > 0.  Seconds per frame, and for the P
               frame the device pass apart from the host's finish +
               CABAC; nvidia-smi samples the card's utilization meanwhile;
  5. ldp_dctif the repo's anchor cfg (cfg/encoder_lowdelay_P_main.cfg,
               transform skip on) with HM's DCT-IF sub-pel search
               (--SubPel=dctif; BASELINE config 2) through the port's CLI
               in process, QP 22, 2 frames of the same clip at 416x240,
               counts reset before and read after: K1-K5, K7, K9, K10
               and K1-TS must be > 0;
  6. ra10      the random-access Main10 cfg
               (cfg/encoder_randomaccess_main10.cfg as shipped: QP 32,
               10 bits, GOP 8 of B pictures, search range 64, DCT-IF,
               SAO; BASELINE config 4) through the CLI on 9 frames of the
               clip at 416x240 as 10-bit samples (the 8-bit clip << 2):
               the IDR and one whole GOP, coded as POC 0, 8, 4, 2, 1, 3,
               6, 5, 7.  Counts reset before and read after: K1-K5, K7
               and K9-K12 must be > 0; 8 B slices, and bi-predicted CUs
               (DBG_COUNTERS["ra_bi_cus"]) > 0.  Never left out;
  7. ai        cfg/encoder_intra_main.cfg as shipped (QP 32, transform
               skip on, SDH off) on the clip's first frame through the
               CLI: K1-K4, K10 and K1-TS must be > 0.  When the run has
               passed FULL_AI_BEFORE_S seconds by then, this phase is
               left out (the ldp_dctif I frame ran the same I pass with
               transform skip at full width) and the parity jobs below
               keep the 64x64 all-intra checks.  With --profile, a 64x64
               AI frame (with K10, and with K10's plain version for
               comparison) and a 64x64 LDP I + P pair under
               torch.profiler (device operations and their time: a
               416x240 frame issues too many for the profiler);
  8. parity    the ai phase's stream through the same CLI on the CPU
               (the plain versions, in worker processes) must equal the
               card's byte for byte; likewise 64x64 AI clips of 2 frames
               (transform skip off), 96x64 screen-content AI clips of 2
               frames with transform skip, 64x64 LDP clips of 4 frames
               (NN-FME; DCT-IF sub-pel with transform skip), each at QP
               22 and 37, search range 8, and a 96x64 screen-content LDP
               clip of 4 frames with DCT-IF sub-pel and transform skip at
               QP 27; 64x64 Main10 random-access clips of 9 frames (DCT-IF,
               search range 8) at QP 22 and 37, and an 8-bit one with
               NN-FME at QP 27.  On the screen-content clips some TB must
               have chosen transform skip on the card (the I pass, or the
               P pass), on the RA clips some CU bi-prediction;
  9. tally     meanwhile, untimed: the calls of the plain-torch queue-B
               functions on the ldp phase's encode and on a 2-frame
               416x240 RA Main10 encode (an I and a B picture), and the
               bytes of the tensors they take and give (a bound for
               argument bytes only).

Imports nothing from hmtpu or JAX.  The last line of the output is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet) used for the bound of each kernel:
# device memory 3.35 TB/s; the kernels do int32 or float32 ALU work,
# bounded here by the card's non-tensor-core float32 rate of 67 T
# operations/s
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
W, H = 416, 240
QP_AI, QP_LDP, SRANGE, LDP_FRAMES = 32, 22, 64, 2
ROOT = os.path.dirname(os.path.abspath(__file__))
LDP_CFG = os.path.join(ROOT, "cfg", "encoder_lowdelay_P_main.cfg")
AI_CFG = os.path.join(ROOT, "cfg", "encoder_intra_main.cfg")
RA_CFG = os.path.join(ROOT, "cfg", "encoder_randomaccess_main10.cfg")
RA_FRAMES = 9
# the parity phase's CPU side: worker processes and torch threads each
# (the card's machine has 8 cores; the card's own dispatch takes one)
CPU_WORKERS, CPU_THREADS = 3, 2
# the full-width all-intra phase runs only while the check is within
# this many seconds.  What follows it (the phase itself, the untimed
# tallies and the parity jobs' card side, about 8 + 60 + 100 s; their
# CPU side, 316 s of jobs, runs alongside in CPU_WORKERS processes) took
# about 170 s on the host of the slice's first full run; 1.9 times that
# on a slow host (the spread seen so far) is about 320 s: 800 s leaves
# it inside the 1200 s limit
FULL_AI_BEFORE_S = 800.0


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


def screen_clip(width, height, frames):
    """Screen content where transform skip wins (the seed-11 generator of
    the repo's transform-skip tests): coloured text-like strokes on a
    flat background, drifting so P frames carry chroma residual."""
    rng = np.random.RandomState(11)
    marks = [(rng.randint(0, width // 2 - 8), rng.randint(0, height // 2 - 4),
              rng.randint(3, 8)) for _ in range(40)]
    out = []
    for t in range(frames):
        y = np.full((height, width), 90, np.uint8)
        u = np.full((height // 2, width // 2), 100, np.uint8)
        v = np.full((height // 2, width // 2), 150, np.uint8)
        for x0, y0, ln in marks:
            x = (x0 + t) % (width // 2 - 8)
            u[y0:y0 + 2, x:x + ln] = 230
            v[y0:y0 + 2, x:x + ln] = 40
            y[2 * y0:2 * y0 + 4, 2 * x:2 * x + 2 * ln] = 200
        out.append((y, u, v))
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
    "sao_apply": "apply_kernel", "me_sad": "me_kernel",
    "nnfme": "nnfme_kernel", "mc_dctif": "mc_kernel",
    "satd8": "satd_kernel", "transform_skip": "transform_skip_kernel",
    "frac_refine": "frac_kernel", "rdoq": "rdoq_kernel",
    "mc_dctif_i": "mc_kernel", "bi_pred": "bi_pred_kernel",
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
    """(name, kernel call, plain call, bytes, ops, library call[, more
    (kernel call, plain call) pairs checked but not timed]) at the main
    paths' shapes, inputs made from a seed."""
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

    # K1, TS mode: the 4x4 chroma TBs of phase 1a (2 x 1560), residuals
    # in, coefficients out; a shift per sample (the inverse, checked too,
    # a shift, an add and a shift)
    nts = 2 * (W // 8) * (H // 8)
    rts = t32(rng.randint(-255, 256, (nts, 4, 4)))
    dts = t32(rng.randint(-(1 << 15), 1 << 15, (nts, 4, 4)))
    cases.append(("transform_skip",
                  lambda: transform.transform_skip_fwd(rts, 4),
                  lambda: transform.transform_skip_fwd_plain(rts, 4),
                  2 * nts * 16 * 4, nts * 16,
                  # the same function as one torch shift
                  lambda: rts << transform.ts_shift(4, 8),
                  [(lambda: transform.transform_skip_inv(dts, 4),
                    lambda: transform.transform_skip_inv_plain(dts, 4))]))

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
    dbk = (y, u, v, intra4, cbf4, mv, mv, rp, QP_AI)
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
    return cases + inter_kernel_cases(dev, rng) \
        + slice3_kernel_cases(dev, rng) + slice4_kernel_cases(dev, rng)


def first_p_lambda_sqrt() -> np.float32:
    """sqrt(lambda) of the first P picture of an LDP encode at QP_LDP,
    as the encoder derives it (GOP position 0: QP offset 3, factor
    0.4624 with HM's depth scale)."""
    from hmtpu_torch.common.lambdas import frame_lambdas
    from hmtpu_torch.common.spec_tables import chroma_qp_from_luma
    from hmtpu_torch.encoder.top import gop_depth, lambda_qp_factor

    qp = QP_LDP + 3
    f = lambda_qp_factor(0.4624, qp, gop_depth(1, 4))
    return frame_lambdas(qp, chroma_qp_from_luma(qp), f)[1]


def mc_work(refs, ridx, xs0, ys0, mvx, mvy, n, chroma):
    """(distinct reference samples, filter multiply-adds) that these
    blocks need: a pass's extra taps are read and filtered only where
    that block's phase in its direction is non-zero."""
    ntaps, sh, msk = (4, 3, 7) if chroma else (8, 2, 3)
    half = ntaps // 2 - 1
    _, h, w = refs.shape
    fx, fy = (mvx & msk) != 0, (mvy & msk) != 0
    k = torch.arange(n + ntaps - 1, device=refs.device)[None, :]
    inner = (k >= half) & (k < half + n)
    use_y, use_x = inner | fy[:, None], inner | fx[:, None]
    py = torch.clamp(ys0[:, None] + (mvy[:, None] >> sh) - half + k, 0,
                     h - 1).to(torch.int64)
    px = torch.clamp(xs0[:, None] + (mvx[:, None] >> sh) - half + k, 0,
                     w - 1).to(torch.int64)
    key = ((ridx.to(torch.int64)[:, None, None] * h + py[:, :, None]) * w
           + px[:, None, :])
    samples = int(torch.unique(key[use_y[:, :, None] & use_x[:, None, :]])
                  .numel())
    # H pass over the rows the V pass reads (when both phases are set),
    # then the V pass; one pass of n x n otherwise, none for a copy
    both = int((fx & fy).sum())
    single = int((fx ^ fy).sum())
    macs = (both * ((n + ntaps - 1) * n + n * n) + single * n * n) * ntaps
    return samples, macs


def inter_kernel_cases(dev, rng):
    """K5-K8 at the shapes of the 416x240 P pass."""
    from hmtpu_torch.models import nnfme
    from hmtpu_torch.ops import interp
    from hmtpu_torch.search import me

    t32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(dev)
    flat = lambda d: [t for n in (8, 16, 32)
                      for t in (*d[n][0], d[n][1], d[n][2])]
    clip = synth_clip(W, H, 2, seed=42)
    org, ref = t32(clip[1][0]), t32(clip[0][0])
    lam = first_p_lambda_sqrt()
    qh, qw = (H // 16 + 1) // 2, (W // 16 + 1) // 2
    cases = []

    # K5: the full plane against one reference, search range 64: per
    # displacement and sample a subtract, an absolute value and an add
    nd = (2 * SRANGE + 1) ** 2
    lanes = (H // 8) * (W // 8) + (H // 16) * (W // 16) + qh * qw
    cases.append(("me_sad",
                  lambda: flat(me.integer_me_levels(ref, org, SRANGE, lam,
                                                    qh, qw)),
                  lambda: flat(me.integer_me_levels_plain(ref, org, SRANGE,
                                                          lam, qh, qw)),
                  2 * H * W * 4 + lanes * 12 * 4, 3 * H * W * nd, None))

    # K6: the 1560 8x8 stencils of that search, the QP 22 weights
    sten = me.integer_me_levels_plain(ref, org, SRANGE, lam, qh, qw)[8][1]
    st9 = sten.reshape(-1, 9).to(torch.float32).contiguous()
    nb = st9.shape[0]
    sizes = torch.full((nb,), 8, dtype=torch.int32, device=dev)
    params = nnfme.load_npz(os.path.join(nnfme.WEIGHTS_DIR, "qp22.npz"),
                            dev)
    macs = 17 * 22 + 22 * 20 + 20 * 49
    cases.append(("nnfme",
                  lambda: nnfme.predict_offsets(params, st9, sizes, sizes),
                  lambda: nnfme._classes(nnfme.forward_plain(
                      params, st9, sizes, sizes)),
                  (nb * 9 + nnfme.PACK_SIZE + 2 * nb + nb * 3) * 4,
                  # the products and sums, the biases, ReLU and affine of
                  # the 42 hidden units, the standardisation, the argmax
                  nb * (2 * macs + 91 + 3 * 42 + 3 * 9 + 49), None,
                  # the logits, bit for bit
                  [(lambda: nnfme.forward(params, st9, sizes, sizes),
                    lambda: nnfme.forward_plain(params, st9, sizes,
                                                sizes))]))

    # K7: every block of a level, one of 4 stacked references each, all
    # phases, MVs that reach past the picture edges; luma 8x8 is timed
    def mc_case(chroma, n):
        h, w = (H // 2, W // 2) if chroma else (H, W)
        refs = t32(rng.randint(0, 256, (4, h, w)))
        q = np.arange((h // n) * (w // n))
        span = 4 * (n + 24)
        args = [t32(a) for a in (
            rng.randint(0, 4, q.size), (q % (w // n)) * n,
            (q // (w // n)) * n, rng.randint(-span, span, q.size),
            rng.randint(-span, span, q.size))]
        return (refs, args, lambda: interp.mc_batch(refs, *args, n, n,
                                                     chroma),
                lambda: interp.mc_batch_plain(refs, *args, n, n, chroma))

    refs, args, k, pl = mc_case(False, 8)
    nb = args[0].numel()
    samples, macs = mc_work(refs, *args, 8, False)
    more = [mc_case(c, n)[2:] for c, n in ((False, 16), (False, 32),
                                          (True, 4), (True, 8), (True, 16))]
    # the distinct reference samples, the five index/MV arrays and the
    # output; a multiply and an add per filter tap
    cases.append(("mc_dctif", k, pl, (samples + 5 * nb + nb * 64) * 4,
                  2 * macs, None, more))

    # K8: the gate's org blocks against their predictions; 8x8 is timed
    def satd_case(n):
        nb = (H // n) * (W // n)
        a = rng.randint(0, 256, (nb, n, n))
        b = t32(np.clip(a + rng.randint(-40, 41, a.shape), 0, 255))
        a = t32(a)
        return (nb, lambda: me.satd_batch(a, b, n),
                lambda: me.satd_batch_plain(a, b, n))

    nb, k, pl = satd_case(8)
    cases.append(("satd8", k, pl, (2 * nb * 64 + nb) * 4,
                  # per tile: 64 differences, 2 x 8 rows of 24 butterfly
                  # operations, 64 absolute values and sums
                  nb * (64 + 2 * 8 * 24 + 128), None,
                  [satd_case(n)[1:] for n in (16, 32)]))
    return cases


def frac_work(refs, ridx, xs, ys, org, mvx, mvy, n):
    """(distinct reference samples, operations) of HM's two-stage search
    on these blocks.  Stage 1's half-pel winners come from the plain
    version, so stage 2's filter work is what this data needs: per
    candidate K7's multiply-adds (mc_work), and per 8x8 tile of each
    SATD 64 differences, 2 x 8 rows of 24 butterfly operations, 64
    absolute values and sums."""
    from hmtpu_torch.ops import interp
    from hmtpu_torch.search import me

    _, h, w = refs.shape
    k = torch.arange(n + 8, device=refs.device)[None, :]
    py = torch.clamp(ys[:, None] + mvy[:, None] - 4 + k, 0, h - 1)
    px = torch.clamp(xs[:, None] + mvx[:, None] - 4 + k, 0, w - 1)
    key = ((ridx.to(torch.int64)[:, None, None] * h + py[:, :, None]) * w
           + px[:, None, :])
    samples = int(torch.unique(key).numel())
    offs = torch.as_tensor(me._FRAC_OFFS, device=refs.device)
    cx, cy = mvx * 4, mvy * 4
    ops = 0
    for step in (2, 1):
        costs = []
        for dy, dx in me._FRAC_OFFS:
            qx, qy = cx + int(dx) * step, cy + int(dy) * step
            ops += 2 * mc_work(refs, ridx, xs, ys, qx, qy, n, False)[1]
            costs.append(me.satd_batch_plain(org, interp.mc_batch_plain(
                refs, ridx, xs, ys, qx, qy, n, n, False), n))
        best = torch.stack(costs, 1).argmin(1)
        cx = cx + (offs[best, 1] * step).to(cx.dtype)
        cy = cy + (offs[best, 0] * step).to(cy.dtype)
    ops += 18 * xs.numel() * (n // 8) ** 2 * (64 + 2 * 8 * 24 + 128)
    return samples, ops


def rdoq_work(c, lev, qp, log2):
    """Arithmetic operations K10 does on these TBs with the trellis and
    SDH (the timed case), stage by stage as csrc/rdoq.cu runs them, the
    data-dependent terms counted on this data (table reads, compares and
    the SDH stage's repairs left out, so it is a lower bound):
      load        |x|, two quantiser roundings (4 each), d0 (2): 11 per
                  position;
      last bits   per coordinate 2 x 30 multiply-adds and 2 adds;
      stage 1     the zero level's cost (2) per position; one RD cost
                  (11) and 2 minimums per rounded level > 0, a second RD
                  cost per rounded level >= 2;
      stage 2     2 adds per position, 4 per CG;
      stage 3     11 per position;
      guard       d + lambda * bits of two level sets: 5 per position
                  each;
      tb_bits     3 calls of 122 (last position) + 6 per CG, and 2 (sig
                  and greater-1 bins) per non-zero level of the deadzone
                  and of the final levels;
      dequant     6 per position."""
    from hmtpu_torch.ops import rdoq

    qbits, scale, _, _ = rdoq._quant_params(qp, log2, 8)
    a = c.abs().to(torch.int64)
    m = torch.clamp((a * scale + (1 << (qbits - 1))) >> qbits, max=32767)
    fb = torch.clamp((a * scale + (85 << (qbits - 9))) >> qbits, max=32767)
    nb, npos = c.shape[0], 1 << (2 * log2)
    ncg = npos // 16
    per_tb = (11 + 2 + 2 + 11 + 10 + 6) * npos + 122 * (1 << log2) \
        + 4 * ncg + 3 * (122 + 6 * ncg)
    return int(nb * per_tb + 13 * (m > 0).sum() + 11 * (m >= 2).sum()
               + 2 * (fb > 0).sum() + 2 * (lev != 0).sum())


def slice3_kernel_cases(dev, rng):
    """K9 and K10 at the shapes of the 416x240 P pass."""
    from hmtpu_torch.common.constants import SliceType
    from hmtpu_torch.common.lambdas import frame_lambdas
    from hmtpu_torch.entropy.contexts import make_contexts
    from hmtpu_torch.entropy.fracbits import ctx_bits_table
    from hmtpu_torch.ops import quant, ratebits, rdoq, transform
    from hmtpu_torch.search import me

    t32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(dev)
    clip = synth_clip(W, H, 5, seed=42)
    cases = []

    # K9: every block of a level (1560 8x8, 390 16x16, 104 32x32 of the
    # edge-padded strip) against 4 stacked references, one each, integer
    # MVs that reach past the picture's edges; 8x8 is timed
    refs = t32(np.stack([f[0] for f in clip[:4]]))
    org_p = np.pad(clip[4][0], ((0, 256 - H), (0, W - W)), mode="edge")

    def frac_case(n):
        gw, gh = W // n, -(-H // n)
        q = np.arange(gw * gh)
        blocks = org_p[:gh * n].reshape(gh, n, gw, n).swapaxes(1, 2) \
            .reshape(-1, n, n)
        args = [t32(a) for a in (
            rng.randint(0, 4, q.size), (q % gw) * n, (q // gw) * n)]
        org = t32(blocks)
        mv = [t32(rng.randint(-48, 49, q.size)) for _ in range(2)]
        kfn = lambda: me.frac_refine_batch(refs, args[1], args[2], org,
                                           *mv, n, 8, ridx=args[0])
        pfn = lambda: me.frac_refine_batch_plain(refs, args[1], args[2],
                                                 org, *mv, n, 8,
                                                 ridx=args[0])
        return args, org, mv, kfn, pfn

    args, org, mv, kfn, pfn = frac_case(8)
    nb = org.shape[0]
    samples, ops = frac_work(refs, args[0], args[1], args[2], org, *mv, 8)
    cases.append(("frac_refine", kfn, pfn,
                  # the distinct reference samples, the org blocks, the
                  # five index / MV arrays in and the two MV arrays out
                  (samples + nb * 64 + 7 * nb) * 4, ops, None,
                  [frac_case(n)[3:] for n in (16, 32)]))

    # K10: real residuals (the clip's frame 1 against frame 0, no
    # motion) through the transform (and, at 4x4, transform skip), the
    # port's initial P contexts at QP 22; the timed call is phase 1a's
    # 1560 8x8 luma TBs with the trellis and SDH
    cb = torch.as_tensor(ctx_bits_table(make_contexts(
        SliceType.P, QP_LDP)).reshape(-1)).to(dev)
    qp = QP_LDP + 3
    lam_l, _, _, lam_c = frame_lambdas(qp, qp, 0.4624)

    def coefs(n, luma, ts=False):
        a, b = (clip[1][0], clip[0][0]) if luma else (clip[1][1], clip[0][1])
        h, w = a.shape
        res = (a.astype(np.int32) - b.astype(np.int32))[:h // n * n,
                                                          :w // n * n]
        res = t32(res.reshape(h // n, n, w // n, n).swapaxes(1, 2)
                  .reshape(-1, n, n))
        return transform.transform_skip_fwd(res, n) if ts \
            else transform.forward_transform(res, n)

    def rdoq_case(n, luma, trellis, sdh, ts=False):
        log2 = n.bit_length() - 1
        c = coefs(n, luma, ts)
        lam = torch.tensor(lam_l if luma else lam_c, dtype=torch.float32,
                           device=dev)
        sel = t32(rng.randint(0, 3, c.shape[0])) if n <= 8 else None
        kfn = lambda: rdoq.rdoq_code(c, qp, log2, 8, lam, cb, luma, sdh=sdh,
                                     scan_sel=sel, trellis=trellis)

        def pfn():
            lev = rdoq.rdoq_tb_plain(c, qp, log2, 8, lam, cb, luma, 0, sdh,
                                     sel, trellis)
            return (lev, quant.dequantize_t_plain(lev, qp, log2, 8),
                    ratebits.tb_bits_plain(lev, cb, log2, luma, 0, sdh))
        return c, kfn, pfn

    c8, kfn, pfn = rdoq_case(8, True, True, True)
    ops = rdoq_work(c8, pfn()[0], qp, 3)
    more = [rdoq_case(n, luma, tr, sdh)[1:]
            for n in (4, 8, 16, 32) for luma in (True, False)
            for tr in (True, False) for sdh in (True, False)
            if (n, luma, tr, sdh) != (8, True, True, True)]
    more += [rdoq_case(4, luma, True, True, ts=True)[1:]
             for luma in (True, False)]
    nb = c8.shape[0]
    tabs = rdoq._k10_tables(3, 0, True, dev)
    cases.append(("rdoq", kfn, pfn,
                  # coefficients in, levels and dequantised values out,
                  # the bits, the context table and the scan tables
                  (3 * nb * 64 + nb + cb.numel() + tabs[0].numel()
                   + tabs[1].numel()) * 4,
                  ops, None, more))
    return cases


def ra_lanes() -> int:
    """The widest cell batch of the 416x240 z-scan (lanes of one level
    of block_schedule32): the B of the B pass's merge calls."""
    from hmtpu_torch.search.wavefront import block_schedule32

    return int(block_schedule32(W, H, 6)["lv_blk"].shape[1])


def slice4_kernel_cases(dev, rng):
    """K11 and K12 at the shapes of the 416x240 B pass at 10 bits: one
    cell batch's merge candidates (lanes x 5), each candidate's
    hypotheses from a union stack of 3 references."""
    from hmtpu_torch.ops import interp

    t32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(dev)
    bd, M = 10, 5
    nblk = ra_lanes() * M
    cases = []

    # K11: luma 8x8 is timed; luma 16, 32 and chroma 4, 8, 16 checked
    def mci_case(chroma, n):
        h, w = (H // 2, W // 2) if chroma else (H, W)
        refs = t32(rng.randint(0, 1 << bd, (3, h, w)))
        span = 4 * (n + 24)
        args = [t32(a) for a in (
            rng.randint(0, 3, nblk), rng.randint(0, w // n, nblk) * n,
            rng.randint(0, h // n, nblk) * n, rng.randint(-span, span, nblk),
            rng.randint(-span, span, nblk))]
        return (refs, args,
                lambda: interp.mc_batch(refs, *args, n, n, chroma, bd,
                                        inter=True),
                lambda: interp.mc_batch_i_plain(refs, *args, n, n, chroma,
                                                bd))

    refs, args, k, pl = mci_case(False, 8)
    samples, macs = mc_work(refs, *args, 8, False)
    more = [mci_case(c, n)[2:] for c, n in ((False, 16), (False, 32),
                                          (True, 4), (True, 8), (True, 16))]
    cases.append(("mc_dctif_i", k, pl, (samples + 5 * nblk + nblk * 64) * 4,
                  2 * macs, None, more))

    # K12: the same batch's two hypotheses per candidate and its
    # directions; per sample two adds and a shift (bi) or an add and a
    # shift (uni), a select and a clip: 5 operations counted
    lo, hi = -(8192 + 600), (1 << 14) - 8192 + 600

    def bp_case(nb, n):
        i0, i1 = (t32(rng.randint(lo, hi, (nb, n, n))) for _ in range(2))
        cdir = t32(rng.randint(1, 4, nb))
        return (lambda: interp.bi_pred(i0, i1, cdir, bd),
                lambda: interp.bi_pred_plain(i0, i1, cdir, bd))

    k, pl = bp_case(nblk, 8)
    cases.append(("bi_pred", k, pl, (3 * nblk * 64 + nblk) * 4,
                  5 * nblk * 64, None,
                  [bp_case(nblk, 16), bp_case(nblk, 32),
                   bp_case(2 * nblk // M, 4)]))
    return cases


# the plain-torch device functions of queue B that have no hand kernel yet
# (item, module, function): PlainTally counts their calls in an untimed
# encode and sums the bytes of the tensors their calls take as arguments
# and give back, a bound for argument bytes only (a pass's own reads and
# writes of intermediates are not in it)
PLAIN_FUNCS = (
    ("B4", "hmtpu_torch.search.me", "regularize_mv_field"),
    ("B9 _satd", "hmtpu_torch.encoder.pframe_dev", "_satd"),
    ("B9 _satd", "hmtpu_torch.encoder.iframe_dev", "_satd"),
    ("B10", "hmtpu_torch.encoder.pframe_dev", "merge_candidates_dev"),
    ("B10", "hmtpu_torch.encoder.pframe_dev", "amvp_candidates_dev"),
    ("B10", "hmtpu_torch.encoder.pframe_dev", "temporal_cand_grid_dev"),
    ("B11", "hmtpu_torch.encoder.pframe_dev", "wavefront_pass"),
    ("B15", "hmtpu_torch.encoder.pframe_dev", "merge_candidates_dev_b"),
    ("B15", "hmtpu_torch.encoder.pframe_dev", "amvp_candidates_dev_b"),
    ("B13 _choose_params", "hmtpu_torch.ops.sao", "_choose_params"),
    ("B14", "hmtpu_torch.encoder.iframe_dev", "iframe_pass"),
)


def tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(tensor_bytes(v) for v in x)
    if isinstance(x, dict):
        return sum(tensor_bytes(v) for v in x.values())
    return 0


class PlainTally:
    """Wraps PLAIN_FUNCS while in use: calls and argument bytes per
    item.  The wrappers cost host time, so no timed encode runs under
    it."""

    def __init__(self):
        self.calls, self.bytes, self._saved = {}, {}, []

    def __enter__(self):
        import importlib

        for item, mod, fn in PLAIN_FUNCS:
            m = importlib.import_module(mod)
            inner = getattr(m, fn)

            def wrap(*a, _inner=inner, _item=item, **k):
                out = _inner(*a, **k)
                self.calls[_item] = self.calls.get(_item, 0) + 1
                self.bytes[_item] = self.bytes.get(_item, 0) \
                    + tensor_bytes(a) + tensor_bytes(k) + tensor_bytes(out)
                return out

            setattr(m, fn, wrap)
            self._saved.append((m, fn, inner))
        return self

    def __exit__(self, *exc):
        for m, fn, inner in reversed(self._saved):
            setattr(m, fn, inner)

    def line(self, label):
        return f"plain ({label}): " + "; ".join(
            f"{k} {self.calls[k]} calls, {self.bytes[k]} argument bytes "
            f"in and out, bound {self.bytes[k] / PEAK_BYTES * 1e3:.6f} ms "
            f"(argument bytes only)" for k in sorted(self.calls))


def same(a, b) -> bool:
    """Equal shapes, dtypes and values (floats bit for bit)."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def max_err(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(max_err(x, y) for x, y in zip(a, b))
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def encode(frames, qp, device, gop="ai", srange=16, subpel=None,
           ts=False, bd=8):
    """8-bit frames through Encoder; at bd 10 as 10-bit samples (<< 2)."""
    from hmtpu_torch.encoder.top import Encoder, EncoderConfig
    from hmtpu_torch.io.yuv import Frame

    h, w = frames[0][0].shape
    if subpel is None:
        subpel = "nn" if gop == "ldp" else "none"
    cfg = EncoderConfig(width=w, height=h, qp=qp, gop=gop, subpel=subpel,
                        search_range=srange, transform_skip=ts, bit_depth=bd)
    enc = Encoder(cfg, device=device)
    t0 = time.time()
    bs = enc.encode_sequence([
        Frame(*(np.asarray(p, np.int32) << (bd - 8) for p in f), bd)
        for f in frames])
    if device != "cpu":
        torch.cuda.synchronize()
    return bs, time.time() - t0, enc.results


def write_yuv(path, frames, bd=8):
    """Planar 4:2:0; at bd 10 the 8-bit samples << 2, 16 bits each."""
    with open(path, "wb") as f:
        for planes in frames:
            for p in planes:
                if bd == 8:
                    f.write(np.ascontiguousarray(p, np.uint8).tobytes())
                else:
                    f.write((np.asarray(p, np.uint16) << (bd - 8))
                            .astype("<u2").tobytes())


def cli_encode(args, device):
    """The port's encoder CLI in process; returns (stream, seconds, the
    encoder)."""
    from hmtpu_torch.apps import encoder_app

    t0 = time.time()
    enc = encoder_app.run(args, device=device)
    if enc is None:
        fail(f"encoder_app {' '.join(args)} encoded nothing")
    if device != "cpu":
        torch.cuda.synchronize()
    dt = time.time() - t0
    with open(args[args.index("-b") + 1], "rb") as f:
        return f.read(), dt, enc


def cpu_stream(job):
    """A job's stream and seconds on the CPU (the plain version of every
    kernel); run in a worker.  A job is (frames, qp, gop, search range,
    sub-pel, transform skip, bit depth), or ("cli", args) for the CLI."""
    torch.set_num_threads(CPU_THREADS)
    if job[0] == "cli":
        return cli_encode(job[1], "cpu")[:2]
    return encode(job[0], job[1], "cpu", *job[2:])[:2]


def check_results(results, what):
    for r in results:
        if not (np.isfinite(r.psnr_y) and r.psnr_y > 30.0):
            fail(f"{what} POC {r.poc}: implausible PSNR-Y {r.psnr_y}")


def run_counted(label, fn, names, kernels):
    """Run fn with every kernel count reset before and read after (and
    nvidia-smi sampling the card's utilization meanwhile); each kernel of
    `names` must have launched."""
    kernels.reset_counts()
    smi_util = subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "500"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        out = fn()
    finally:
        smi_util.terminate()
        util = [float(x) for x in smi_util.communicate(timeout=60)[0].split()
                if x.strip().replace(".", "", 1).isdigit()]
    counts = dict(kernels.COUNTS)
    for name in names:
        if counts[name] <= 0:
            fail(f"{name}: not launched on the {label} path")
    print(f"kernels ({label}): " + ", ".join(
        f"{k} {counts[k]}" for k in names), flush=True)
    return out, counts, util


def frame_line(label, results, util, gop8=False):
    parts = []
    for r in results:
        p = f"POC{r.poc} {r.slice_type}" \
            + (f" (GOP position {r.poc % 8})" if gop8 else "") \
            + f" {r.seconds:.3f} s"
        if r.slice_type in ("P", "B"):
            p += (f" (device pass {r.device_seconds:.3f} s, host finish + "
                  f"CABAC {r.host_seconds:.3f} s)")
        parts.append(p)
    print(f"{label}: seconds per frame " + ", ".join(parts)
          + (f"; card utilization (nvidia-smi, {len(util)} samples) mean "
             f"{np.mean(util):.2f} %" if util else ""), flush=True)


def profile_encode(path, label, fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    avgs = prof.key_averages()
    on_dev = [e for e in avgs if self_device_us(e) > 0]
    busy = sum(self_device_us(e) for e in on_dev) / 1e3
    nops = sum(e.count for e in on_dev)
    with open(os.path.join(path, f"profile_{label}.txt"), "w") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=40))
    print(f"profile {label}: {wall * 1e3:.1f} ms wall under the profiler, "
          f"{nops} device operations, device busy {busy:.1f} ms "
          f"({100 * busy / (wall * 1e3):.2f} %), "
          f"{wall * 1e6 / max(nops, 1):.2f} us of wall time per device "
          f"operation", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="",
                    help="directory for torch.profiler tables of a 64x64 "
                         "AI frame and a 64x64 LDP I + P pair (optional)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device: this check runs on the card")
    try:
        from hmtpu_torch import kernels
    except ImportError as e:
        fail(f"the hmtpu_torch package is not beside this script ({e})")
    dev = torch.device("cuda", 0)
    t_start = time.time()

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
    for name, kfn, pfn, nbytes, ops, lib, *more in kernel_cases(dev):
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        err = max_err(got, want)
        if not same(got, want):
            fail(f"{name}: kernel disagrees with its plain version "
                 f"(max abs err {err})")
        for k2, p2 in (more[0] if more else ()):
            g2, w2 = k2(), p2()
            torch.cuda.synchronize()
            err = max(err, max_err(g2, w2))
            if not same(g2, w2):
                w0 = w2[0] if isinstance(w2, (tuple, list)) else w2
                fail(f"{name}: kernel disagrees with its plain version at "
                     f"shape {tuple(w0.shape)} (max abs err {err})")
        ms = time_cuda(kfn, 200)
        pms = time_cuda(pfn, 5)
        lms = time_cuda(lib, 200) if lib is not None else None
        dms = device_ms(kfn, DEVICE_FN[name])
        bms, by = bound_ms(nbytes, ops)
        src, repl = kernels.KERNELS[name]
        rows[name] = dict(
            name=name, route="cuda", source=f"hmtpu_torch/csrc/{src}.cu",
            replaces=repl, launches=0, max_abs_err=err,
            ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
            library_ms=lms, device_ms=dms)
        print(f"kernel {name}: equal to plain; {ms:.4f} ms per call, "
              f"{dms:.4f} ms on the device (plain {pms:.4f} ms, bound "
              f"{bms:.6f} ms by {by}"
              + (f", library call {lms:.4f} ms" if lms else "")
              + ")", flush=True)

    clip = synth_clip(W, H, LDP_FRAMES, seed=42)
    small = synth_clip(64, 64, 4, seed=3)
    encode(small[:1], QP_AI, dev)        # warm-up: libraries, allocator

    # ---- 4. the main path: low-delay P with NN-FME
    ldp_names = [k for k in kernels.KERNELS
                 if k not in ("frac_refine", "transform_skip", "mc_dctif_i",
                              "bi_pred")]
    (bs, dt, results), counts, util = run_counted(
        "ldp", lambda: encode(clip, QP_LDP, dev, "ldp", SRANGE),
        ldp_names, kernels)
    for name in rows:
        rows[name]["launches"] = counts[name]
    check_results(results, "ldp")
    if [r.slice_type for r in results] != ["I"] + ["P"] * (LDP_FRAMES - 1):
        fail(f"ldp: slice types {[r.slice_type for r in results]}")
    kbps = sum(r.bits for r in results) / LDP_FRAMES * 50 / 1000.0
    print(f"ldp: 416x240 LDP QP{QP_LDP} NN-FME SR{SRANGE}, {LDP_FRAMES} "
          f"frames, {len(bs)} bytes, {dt:.3f} s, "
          f"{LDP_FRAMES / dt:.4f} fps, {kbps:.3f} kbps at 50 fps, PSNR "
          + ", ".join(f"POC{r.poc} Y {r.psnr_y:.4f} U {r.psnr_u:.4f} "
                      f"V {r.psnr_v:.4f}" for r in results), flush=True)
    frame_line("ldp", results, util)

    from hmtpu_torch.encoder import pframe_dev

    tmp = tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR)
    yuv = os.path.join(tmp.name, "clip.yuv")
    write_yuv(yuv, clip)
    size = ["-wdt", str(W), "-hgt", str(H), "-i", yuv]

    # ---- 5. the anchor cfg with HM's DCT-IF sub-pel search, via the CLI
    dctif_names = [k for k in kernels.KERNELS
                   if k not in ("nnfme", "satd8", "mc_dctif_i", "bi_pred")]
    pframe_dev.DBG_COUNTERS["ldp_ts_tbs"] = 0
    (d_bs, d_dt, d_enc), d_counts, d_util = run_counted(
        "ldp_dctif", lambda: cli_encode(
            ["-c", LDP_CFG, "--SubPel=dctif", "-q", str(QP_LDP), "-f",
             str(LDP_FRAMES), *size, "-b",
             os.path.join(tmp.name, "ldp_dctif.hevc")], dev),
        dctif_names, kernels)
    for name in ("frac_refine", "transform_skip"):
        rows[name]["launches"] = d_counts[name]
    d_res = d_enc.results
    check_results(d_res, "ldp_dctif")
    if d_enc.cfg.subpel != "dctif" or not d_enc.pps.transform_skip_enabled:
        fail("ldp_dctif: the cfg did not give DCT-IF sub-pel with TS")
    kbps = sum(r.bits for r in d_res) / LDP_FRAMES * 50 / 1000.0
    print(f"ldp_dctif: {os.path.basename(LDP_CFG)} --SubPel=dctif QP"
          f"{QP_LDP} SR{d_enc.cfg.search_range}, 416x240, {LDP_FRAMES} "
          f"frames, {len(d_bs)} bytes, {d_dt:.3f} s, "
          f"{LDP_FRAMES / d_dt:.4f} fps, {kbps:.3f} kbps at 50 fps, "
          f"transform-skip TBs (ldp_ts_tbs) "
          f"{pframe_dev.DBG_COUNTERS['ldp_ts_tbs']}, PSNR "
          + ", ".join(f"POC{r.poc} Y {r.psnr_y:.4f} U {r.psnr_u:.4f} "
                      f"V {r.psnr_v:.4f}" for r in d_res), flush=True)
    frame_line("ldp_dctif", d_res, d_util)

    # ---- 6. random access at Main10 (BASELINE config 4), via the CLI
    ra_clip = synth_clip(W, H, RA_FRAMES, seed=42)
    yuv10 = os.path.join(tmp.name, "clip10.yuv")
    write_yuv(yuv10, ra_clip, 10)
    ra_names = [k for k in kernels.KERNELS
                if k not in ("nnfme", "satd8", "transform_skip")]
    pframe_dev.DBG_COUNTERS["ra_bi_cus"] = 0
    (r_bs, r_dt, r_enc), r_counts, r_util = run_counted(
        "ra10", lambda: cli_encode(
            ["-c", RA_CFG, "--InputBitDepth=10", "-f", str(RA_FRAMES),
             "-wdt", str(W), "-hgt", str(H), "-i", yuv10, "-b",
             os.path.join(tmp.name, "ra10.hevc")], dev),
        ra_names, kernels)
    for name in ("mc_dctif_i", "bi_pred"):
        rows[name]["launches"] = r_counts[name]
    r_res = r_enc.results
    check_results(r_res, "ra10")
    n_bi = pframe_dev.DBG_COUNTERS["ra_bi_cus"]
    order = [r.poc for r in r_res]
    if (r_enc.cfg.gop, r_enc.cfg.bit_depth, r_enc.cfg.subpel) \
            != ("ra", 10, "dctif") or order != [0, 8, 4, 2, 1, 3, 6, 5, 7]:
        fail(f"ra10: the cfg gave gop {r_enc.cfg.gop} bit depth "
             f"{r_enc.cfg.bit_depth} sub-pel {r_enc.cfg.subpel}, coding "
             f"order {order}")
    if [r.slice_type for r in r_res] != ["I"] + ["B"] * 8:
        fail(f"ra10: slice types {[r.slice_type for r in r_res]}")
    if n_bi <= 0:
        fail("ra10: no CU was bi-predicted")
    kbps = sum(r.bits for r in r_res) / RA_FRAMES * 50 / 1000.0
    print(f"ra10: {os.path.basename(RA_CFG)} (QP{r_enc.cfg.qp}, 10 bits, "
          f"SR{r_enc.cfg.search_range}, {r_enc.cfg.subpel}, SAO "
          f"{int(r_enc.cfg.sao)}), 416x240, {RA_FRAMES} frames, "
          f"{len(r_bs)} bytes, {r_dt:.3f} s, {RA_FRAMES / r_dt:.4f} fps, "
          f"{kbps:.3f} kbps at 50 fps, bi-predicted CUs (ra_bi_cus) "
          f"{n_bi}, PSNR "
          + ", ".join(f"POC{r.poc} Y {r.psnr_y:.4f} U {r.psnr_u:.4f} "
                      f"V {r.psnr_v:.4f}" for r in r_res), flush=True)
    frame_line("ra10", r_res, r_util, gop8=True)

    # ---- 7. cfg/encoder_intra_main.cfg as shipped, via the CLI
    ai_args = ["-c", AI_CFG, "-f", "1", *size, "-b",
               os.path.join(tmp.name, "ai.hevc")]
    full_ai = time.time() - t_start < FULL_AI_BEFORE_S
    if full_ai:
        ai_names = [k for k, (src, _) in kernels.KERNELS.items()
                    if src in ("transform", "intra_pred", "deblock", "sao",
                               "rdoq")]
        (ai_bs, ai_dt, ai_enc), _, ai_util = run_counted(
            "ai", lambda: cli_encode(ai_args, dev), ai_names, kernels)
        ai_res = ai_enc.results
        check_results(ai_res, "ai")
        print(f"ai: {os.path.basename(AI_CFG)} (QP{ai_enc.cfg.qp}, "
              f"TS {int(ai_enc.pps.transform_skip_enabled)}, SDH "
              f"{int(ai_enc.pps.sign_data_hiding)}), 416x240, 1 frame, "
              f"{len(ai_bs)} bytes, {ai_dt:.3f} s, {1 / ai_dt:.4f} fps, "
              f"{ai_res[0].bits * 50 / 1000.0:.3f} kbps at 50 fps, PSNR Y "
              f"{ai_res[0].psnr_y:.4f} U {ai_res[0].psnr_u:.4f} V "
              f"{ai_res[0].psnr_v:.4f}", flush=True)
        frame_line("ai", ai_res, ai_util)
    else:
        print(f"ai: the full-width phase is left out (the check had run "
              f"{time.time() - t_start:.1f} s, over {FULL_AI_BEFORE_S} s); "
              f"the ldp_dctif I frame ran the TS I pass at 416x240",
              flush=True)

    if args.profile:
        from hmtpu_torch.ops import quant, ratebits, rdoq

        def plain_rdoq_code(coef, qp, log2, bd, lam, cbflat, is_luma,
                            sdh=False, scan_sel=None, trellis=True):
            lev = rdoq.rdoq_tb_plain(coef, qp, log2, bd, lam, cbflat,
                                     is_luma, 0, sdh, scan_sel, trellis)
            return (lev, quant.dequantize_t_plain(lev, qp, log2, bd),
                    ratebits.tb_bits_plain(lev, cbflat, log2, is_luma, 0,
                                           sdh))

        os.makedirs(args.profile, exist_ok=True)
        profile_encode(args.profile, "ai_64x64",
                       lambda: encode(small[:1], QP_AI, dev))
        # the same frame with K10's plain version in the coding step,
        # for the device-operation count K10 removes (comparison only)
        pframe_dev.rdoq_code = plain_rdoq_code
        try:
            profile_encode(args.profile, "ai_64x64_plain_rdoq",
                           lambda: encode(small[:1], QP_AI, dev))
        finally:
            pframe_dev.rdoq_code = rdoq.rdoq_code
        profile_encode(args.profile, "ldp_64x64_I_P",
                       lambda: encode(small[:2], QP_LDP, dev, "ldp", 8))
        profile_encode(args.profile, "ra_64x64_main10",
                       lambda: encode(synth_clip(64, 64, 9, seed=3), 32,
                                      dev, "ra", 8, "dctif", bd=10))

    # ---- 8. card against CPU: the CPU's streams come from worker
    # processes on the machine's other cores while this one dispatches the
    # same clips to the card.  A job is (content, frames, qp, gop, search
    # range, sub-pel, transform skip, bit depth, the DBG_COUNTERS entry
    # that must be > 0 on the card: transform skip chosen by some TB, or
    # bi-prediction chosen by some CU)
    screen = screen_clip(96, 64, 4)
    small9 = synth_clip(64, 64, RA_FRAMES, seed=3)
    jobs = [("", small[:2], qp, "ai", 16, None, False, 8, None)
            for qp in (22, 37)] \
        + [("screen ", screen[:2], qp, "ai", 16, None, True, 8,
            "intra_ts_tbs") for qp in (22, 37)] \
        + [("", small, qp, "ldp", 8, sp, ts, 8, None)
           for sp, ts in (("nn", False), ("dctif", True))
           for qp in (22, 37)] \
        + [("screen ", screen, 27, "ldp", 8, "dctif", True, 8,
            "ldp_ts_tbs")] \
        + [("Main10 ", small9, qp, "ra", 8, "dctif", False, 10, "ra_bi_cus")
           for qp in (22, 37)] \
        + [("", small9, 27, "ra", 8, "nn", False, 8, "ra_bi_cus")]
    ai_cpu_args = ai_args[:-1] + [os.path.join(tmp.name, "ai_cpu.hevc")]
    cpu_jobs = ([("cli", ai_cpu_args)] if full_ai else []) \
        + [j[1:8] for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            CPU_WORKERS, mp_context=ctx) as pool:
        # the workers take jobs in submission order: the 416x240 AI
        # stream first, then the list from its end (the longer jobs)
        order = ([0] if full_ai else []) + sorted(
            range(len(cpu_jobs) - len(jobs), len(cpu_jobs)), reverse=True)
        futs = {i: pool.submit(cpu_stream, cpu_jobs[i]) for i in order}
        # ---- 9. meanwhile, the calls and argument bytes of the
        # plain-torch queue-B functions on the main path, in an untimed
        # encode of the ldp phase's clip, and of B15's on a 2-frame
        # 416x240 RA Main10 encode (their wrappers cost host time)
        with PlainTally() as tally:
            encode(clip, QP_LDP, dev, "ldp", SRANGE)
        print(tally.line(f"416x240 LDP QP{QP_LDP} I + P, untimed"),
              flush=True)
        with PlainTally() as tally:
            encode(ra_clip[:2], 32, dev, "ra", SRANGE, "dctif", bd=10)
        print(tally.line("416x240 RA Main10 QP32 I + B, untimed"),
              flush=True)
        on_card = []
        for _, f, qp, gop, sr, sp, ts, bd, must in jobs:
            for k in ("ldp_ts_tbs", "intra_ts_tbs", "ra_bi_cus"):
                pframe_dev.DBG_COUNTERS[k] = 0
            on_card.append(encode(f, qp, dev, gop, sr, sp, ts, bd)[:2]
                           + (must and pframe_dev.DBG_COUNTERS[must],))
        cpu = [futs[i].result() for i in range(len(cpu_jobs))]
    labels = [f"{f[0][0].shape[1]}x{f[0][0].shape[0]} {what}{gop.upper()}"
              f"{' ' + sp.upper() if gop in ('ldp', 'ra') else ''}"
              f"{' TS' if ts else ''} QP{qp} {len(f)} frames"
              for what, f, qp, gop, _, sp, ts, _, _ in jobs]
    musts = [j[8] for j in jobs]
    if full_ai:
        on_card = [(ai_bs, ai_dt, None)] + on_card
        labels = [f"416x240 AI {os.path.basename(AI_CFG)} QP{QP_AI} "
                  f"1 frame"] + labels
        musts = [None] + musts
    for what, must, (a, adt, fired), (b, bdt) in zip(labels, musts,
                                                     on_card, cpu):
        if a != b:
            fail(f"{what}: card and CPU streams differ")
        if must and not fired:
            fail(f"{what}: {must} 0 on the card (no TB chose transform "
                 f"skip, or no CU bi-prediction)")
        print(f"parity: {what} card == CPU ({len(a)} bytes; card "
              f"{adt:.1f} s, CPU {bdt:.1f} s"
              + (f"; {must} {fired} on the card" if must else "") + ")",
              flush=True)
    tmp.cleanup()

    print(f"total: {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
