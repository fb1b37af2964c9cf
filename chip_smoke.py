"""Drive the PyTorch/CUDA port (hmtpu_torch) end to end on one GPU.

    python3 chip_smoke.py                 # the whole check, one card
    python3 chip_smoke.py --profile DIR   # also trace 64x64 frames

Phases (any failure exits non-zero, and the result line is printed only
when every phase passed):

  1. device    the card's name and power limit (nvidia-smi);
  2. build     nvcc for every kernel source in hmtpu_torch/csrc, one
               process per source, all started together, and beside them
               K23's and K21's phase-clock builds
               (scripts/pwalk_phases.py, iwalk_phases.py); the registers,
               stack frame and spills ptxas gives K10, K22, the walkers
               K21, K23 and K26, K5's and K13's kernels, K3's two forms,
               K19, K9's two kernels and K24 (with the spills of every
               function of the source; K3, K19, K9 and K24 must have no
               stack frame and no spills);
  3. kernels   each kernel (K1, K3-K15, K1's transform-skip mode inside
               its level forms and K16 inside K15's launch)
               against its plain PyTorch version on seeded inputs at the
               shapes the main paths give it (K1 in its level forms, a
               level's three planes a launch, at the P pass's 8 level,
               timed, and its 16 and 32 levels, each also on one plane,
               the old one-plane forms at (14, 8, 8) checked; K6 in its
               three-level form, 2,054 rows of the 416x240 search's
               stencils, timed, its one-level forms and logits checked),
               and K2 and K17-K26 (after
               phase 11's untimed encodes) on the inputs of the widest
               call of each form captured there: K23 (the P z-scan
               walker, one launch per level) on the ldp phase's P frame
               (timed, its row), ldp_dctif's (TS), a 64x56 frame (8x8
               lanes) and a 64x64 one, each timed beside
               wavefront_pass_plain on the card, every state array equal;
               then the phase build on ldp's P frame, its state equal to
               K23's: one line a phase of a lane (cycles, share of the
               lanes', count);
               K26 (the B z-scan walker, one launch per level) on each of
               the ra10 phase's 8 B frames (416x240, 10 bits; the first
               timed, its row) and on POC 8 and POC 2 of 64x64 and 64x56
               8-bit RA encodes, each against wavefront_pass_plain on the
               card, every state array equal;
               K24 on the three CU grids of ldp's P frame (the 8 grid
               timed) and on seeded collocated fields at those shapes;
               K25 on the ldp frames' SAO statistics; K2 as the plain P
               pass on the card calls it per level lane (the 8x8 luma
               filter and prediction at 8 bits timed; the chroma 4x4 pair
               and the 10-bit forms checked), K17's and K18's P form
               (timed) and B form (from the plain B pass run on the card
               beside K26), K19, K20's one-mode form of the P pass
               (timed) and its I-pass forms (K candidates, four PUs) on
               seeded modes; K21 (the I z-scan walker, one launch per
               level) on the ai phase's frame (timed, its row), the ldp
               phase's I frame, a 64x64 frame (the 32 level) and the
               rext phase's first frame (10 bits), each timed beside
               iframe_pass_plain on the card, every state array equal,
               then its phase build on the ai frame, its state equal to
               K21's: one line a phase of a lane; K22 (the fused RMD) at
               n = 8 (timed, its row), 4, 16 and 32 and in the P pass's form
               (n = 8, k = 1) beside rmd_plain, then on a flat plane and
               16x16 steps (ties among the modes) at each form; K10 at
               every form of the coding step that the encodes capture
               (`_code`'s TB sizes, components, bit depths, trellis and
               SDH) and on contents built to reach the coder's edges
               (tests/test_torch_rdoq_lanes.py: an all-zero TB, DC only,
               C1FLAG, Rice 4, stage 2, the all-zero TB winning stage 3,
               SDH parity fixes) at 8 and 10 bits.  They must be equal (the
               float32 outputs of K6, K10, K14-K16, K18 and K20 bit for
               bit: kernel and plain version round in the same order, K14
               with the exp and log they share; K15 twice, the same
               bits).  K5 is checked besides on ra10's 10-bit planes and
               on a flat plane, where every displacement ties.  K13 is
               timed at 1920x1080, search range 64, and checked at
               416x240 and 64x56 with non-zero predictors, at 64x56 also
               on 10-bit samples (staged as halfwords), and on flat 8-
               and 10-bit planes, where every displacement ties; K14-K16 at
               batch 1024 of the trainer's QP-22 records, K14 and K15 also
               at 1, 32 and 100 rows and K14 at the validation set's 7176
               without the backward's tensors, K15 with K16 as its tail
               (the training step's form, timed; its gradient,
               parameters, moments and device step count, at updates 1,
               2 and the table's last); K1's TS mode on a seeded (3120,
               4, 4) pair (the forward and the pick) and on ldp_dctif's
               captured 8-level hypothesis.  K4 also in its frame
               forms (a 416x240 picture's three planes in one statistics
               and one apply launch, and the same at 1920x1080), K7 in
               its one-launch forms at each level of the P pass (the
               AMVP hypotheses' three planes; the NN gate's two MV sets)
               and the hypotheses' 8 level at 1920x1080, each a row of its
               own (`kernel:form`), K11's forms checked at 10 bits; K8's
               gate form at the P pass's three levels in one launch over
               the 416x240 original (`satd8:gate`), K25 also on seeded
               rows of 1920x1080's 510 CTUs (`sao_choose:1080p`); K3's
               4x4-map form on a seeded 416x240 picture (its row) and its
               state form on a seeded 1920x1080 P state
               (`deblock:1080p`), and after phase 11 on the captured
               calls of the passes (ldp's P picture timed,
               `deblock:state`; ldp's I picture, every ra10 B picture with
               its two lists, and the other encodes' pictures checked);
               K19 (every round in one launch) on ldp's field (timed),
               seeded 416x240, 56x64 and 8x16 fields (1 to 4 rounds)
               checked, and a seeded 1920x1080 field
               (`mv_regularize:1080p`); K9's one-call form at the P
               pass's 8 level (timed), its 16 and 32 levels and 10 bits
               checked, its levels form as the extraction calls it over a
               seeded 1920x1080 plane (32,400 8x8 blocks, timed,
               `frac_refine:1080p`; the one-call form on the same blocks
               checked), and after phase 11 on the captured calls of the
               DCT-IF passes (ldp_dctif's P pass, its three levels in one
               launch, timed, `frac_refine:levels`; every ra10 B pass and
               the small RA encodes' checked); K24's grids form on ldp's
               P frame's three grids (timed, `tmvp_grid:levels`).  Each
               is timed
               with CUDA events, beside its plain version, the bound for
               its bytes and operations, and a library yardstick where one
               PyTorch call computes the same function (a float64
               torch.matmul for the transform, fused torch.optim.Adam for
               K16, which runs inside K15's launch: its row times that
               launch, the tail's share beside it); torch.profiler gives
               each one's own device time;
  4. ldp       the main path: the low-delay-P encode with NN-FME
               (416x240, QP 22, GOP QP offsets 3/2/3/1, 4 references,
               search range 64, CTU 64, TMVP, RDOQ, SDH, deblocking and
               SAO) of 2 frames (an I and a P picture) of a seeded
               synthetic clip through Encoder.encode_sequence, every
               kernel count reset before and read after: each of K1,
               K3-K8, K10, K19 and K21-K25 must be > 0 (the P pass's
               coding, candidates, intra prediction and mode bits run
               inside K23, and no encode launches them); the SAO
               launches a frame (K4, K25, K4: 3), K7's a P pass (at
               most 6: a level's hypotheses and its gate, one launch
               each), K8's (1: the gate's three levels), K6's (1: the
               three levels' offsets), K24's (1: the three grids) and
               K1's (at
               most 3 a direction: a level's three planes a launch), K3's
               (1 a picture: its state form) and K19's (1 a P pass: every
               round in one launch) from
               the counters, and after phase 6 K6's and K1's launches in
               ldp, ldp_dctif and ra10 (K1 at most 24 a direction).  Seconds per frame, and for the P
               frame the device pass apart from the host's finish +
               CABAC; nvidia-smi samples the card's utilization meanwhile;
  5. ldp_dctif the repo's anchor cfg (cfg/encoder_lowdelay_P_main.cfg,
               transform skip on) with HM's DCT-IF sub-pel search
               (--SubPel=dctif; BASELINE config 2) through the port's CLI
               in process, QP 22, 2 frames of the same clip at 416x240,
               counts reset before and read after: K1, K3-K5, K7, K9,
               K10, K19, K21-K25 must be > 0, K8 0, K9 once a P pass
               (the three levels in one launch), K1's level forms three
               times a P pass each way (the 8 level's in their TS mode:
               no launch of K1-TS's own);
  6. ra10      the random-access Main10 cfg
               (cfg/encoder_randomaccess_main10.cfg as shipped: QP 32,
               10 bits, GOP 8 of B pictures, search range 64, DCT-IF,
               SAO; BASELINE config 4) through the CLI on 9 frames of the
               clip at 416x240 as 10-bit samples (the 8-bit clip << 2):
               the IDR and one whole GOP, coded as POC 0, 8, 4, 2, 1, 3,
               6, 5, 7.  Counts reset before and read after: K1, K3-K5,
               K7, K9, K10, K21, K22, K25 and K26 must be > 0 (K8 0),
               K3 once a picture, K9 once a B pass, K26 once per
               z-scan level of each B frame (the B slices' z-scan, with
               K2, K11, K12, K17, K18 and K20's arithmetic inside it); 8 B
               slices, and bi-predicted CUs (DBG_COUNTERS["ra_bi_cus"])
               > 0.  Seconds per B frame beside the card.  Never left out;
  7. ai        cfg/encoder_intra_main.cfg as shipped (QP 32, transform
               skip on, SDH off) on the clip's first frame through the
               CLI: K21, K22, K3 and K4 must be > 0 (the I pass codes,
               predicts and prices inside K21).  When the run
               has passed FULL_AI_BEFORE_S seconds by then, this phase is
               left out (the ldp_dctif I frame ran the same I pass with
               transform skip at full width) and the parity jobs below
               keep the 64x64 all-intra checks.  With --profile, a 64x64
               AI frame, a 64x64 LDP I + P pair (with K10, and with K10's
               plain version in the P pass's coding step for comparison)
               and 9 64x64 RA Main10 frames under torch.profiler (device
               operations and their time: a 416x240 frame issues too many
               for the profiler);
  7b. rext     BASELINE config 5, cfg/encoder_intra_high_throughput_rext.cfg
               as shipped (QP 32, 10 bits, transform skip, SDH, the
               High-Throughput-RExt profile), through the CLI on the
               clip's first 2 frames as 10-bit samples: K21, K22, K3 and
               K4 must be > 0, K8 0, K3 once a picture; seconds per frame
               and the TBs that chose transform skip;
  8. nnfme_train  the NN-FME trainer at tools/train_nnfme.py's defaults
               through `hmtpu_torch.apps.train_nnfme.main` in process
               (416x240 synthetic clip, 24 frames, SR 16, QPs
               22/27/32/37, 60 epochs, batch 1024, lr 3e-3, seed 0) into
               a temporary directory, counts reset before and read after:
               K13, K9, K14 and K15 > 0, K15's launches equal to the
               steps (K16 inside them: no launch of its own), no call of
               a plain version; per QP the
               rows, extraction seconds, steps, training seconds and
               steps/s, the validation accuracy and the majority-class
               share;
  9. hd_extract  extraction alone at 1920x1080 (the clip generator's 4
               frames, QP 22, SR 64): seconds per frame pair; K13, K9 > 0;
 10. parity    the RExt cfg at 96x64 (3 frames, 10-bit samples) through
               the CLI on the card and on the CPU; the ai phase's stream
               through the same CLI on the CPU
               (the plain versions, in worker processes) must equal the
               card's byte for byte; likewise 64x64 AI clips of 2 frames
               (transform skip off), 96x64 screen-content AI clips of 2
               frames with transform skip, 64x64 LDP clips of 4 frames
               (NN-FME; DCT-IF sub-pel with transform skip), each at QP
               22 and 37, search range 8, and a 96x64 screen-content LDP
               clip of 4 frames with DCT-IF sub-pel and transform skip at
               QP 27; 64x64 Main10 random-access clips of 9 frames (DCT-IF,
               search range 8) at QP 22 and 37, and an 8-bit one with
               NN-FME at QP 27; a 64x56 LDP clip of 4 frames (NN-FME, SR 8,
               QP 27: the P pass's single-level ME, K13 > 0 on the card);
               a 64x64 LDP NN-FME clip of 4 frames at QP 22 with the
               freshly trained QP-22 weights.  On the screen-content clips
               some TB must have chosen transform skip on the card (the I
               pass, or the P pass), on the RA clips some CU
               bi-prediction.  In the same workers: the trainer's records
               of frames 0-2 at QP 22 extracted on the CPU must equal the
               card's; its first TRACK_STEPS steps at QP 22 on the CPU
               must give the losses of the card's timed run within
               TRACK_RTOL (0: bit for bit); the first 1920x1080 frame
               pair's records at
               SR 16 must equal the card's;
 11. tally     meanwhile, untimed: the calls of the plain-torch queue-B
               functions on the ldp phase's encode and on a 2-frame
               416x240 RA Main10 encode of the ra10 phase's 9 frames, and
               the bytes of the tensors they take and give (a bound for
               argument bytes only); the ldp encode may call none of the
               plain versions of K21-K25 (wavefront_pass_plain,
               t_level_plain, _choose_params_plain among them), the RA
               encode none of them and no B8 flag helper; the same
               two encodes, untimed ldp_dctif, 64x56 and 64x64 LDP and RA
               encodes, an AI encode of the ai phase's frame and a 64x64
               AI frame capture the inputs of K2, K3's state form, K9's
               levels form, K17-K21, K23, K25 and K26 (Capture), which
               phase 3's last
               checks use; none of
               them may call iframe_pass_plain or rmd_plain.

Imports nothing from hmtpu or JAX.  The last line of the output is
{"ok": true, "device": {...}}.  Every process the check starts (nvcc,
nvidia-smi, the parity workers and multiprocessing's resource tracker)
is stopped before it exits, after a failed phase too.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import signal
import subprocess
import sys
import tempfile
import time
import traceback

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
RX_CFG = os.path.join(ROOT, "cfg", "encoder_intra_high_throughput_rext.cfg")
RX_FRAMES = 2
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
# the NN-FME trainer at tools/train_nnfme.py's defaults (the synthetic
# 416x240 clip of 24 frames, search range 16, QPs 22/27/32/37, 60 epochs
# of batch 1024); its first TRACK_STEPS steps at QP 22 run again on the
# CPU, whose losses must stay within TRACK_RTOL of those of the card's
# timed run: 0, since every operation of a step rounds alike on both
# (K14's exp and log are its own, models/train.py exp_f32 / log_f32, not
# the libraries', which differ in the last bit)
TRAIN_FRAMES, TRAIN_SR, TRAIN_QPS, TRAIN_EPOCHS, TRAIN_BATCH = \
    24, 16, (22, 27, 32, 37), 60, 1024
TRACK_STEPS, TRACK_EPOCHS, TRACK_RTOL = 50, 2, 0.0
# extraction at HM's class-B size: 1920x1080 (1080 = 67.5 x 16: the
# single-level ME), 4 frames, search range 64; one frame pair again on
# the CPU at search range 16 (about 20 s there)
HD_W, HD_H, HD_FRAMES, HD_SR, HD_CPU_SR = 1920, 1080, 4, 64, 16
# the kernels whose P forms run inside K23 on the card: the LDP encodes
# launch none of them (the I pass's forms run inside K21)
P_INSIDE_K23 = ("intra_filter", "intra_pred", "merge_cands", "amvp_rd",
                "mpm_bits")
# the kernels whose B forms run inside K26 on the card, so the ra10 path
# launches none of them: K2's filter and prediction (intra_filter,
# intra_pred), K17's B merge list (merge_cands), K18's B AMVP list and
# pricing (amvp_rd), K20's MPM pricing (mpm_bits), K11's intermediate
# hypotheses (mc_dctif_i) and K12's bi-average and screening (bi_pred)
B_INSIDE_K26 = P_INSIDE_K23 + ("mc_dctif_i", "bi_pred")
# the kernels of the training slice: the encodes at sides that are
# multiples of 16 launch none of them
TRAIN_KERNELS = ("me_sad1", "nnfme_fwd", "nnfme_bwd")
# the kernels that run inside another's launch: (source, the hmtpu
# function they replace, the launch they run in); their rows' launches
# are 0, and they have no counter of their own
INSIDE = {"adam": ("nnfme_train", "hmtpu/models/train.py:51-53",
                   "nnfme_bwd"),
          "transform_skip": ("transform", "hmtpu/ops/transform.py:84,89",
                             "int_transform_fwd, int_transform_inv")}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def stop_children(grace_s: float = 10.0, tracker: bool = True) -> None:
    """Stop every process this one started that still runs: the parity
    workers and nvcc or nvidia-smi after a failed phase, and (with
    `tracker`) multiprocessing's resource tracker, which the worker pool
    starts and which otherwise lives on past this process.  Descendants
    get SIGTERM, then SIGKILL after grace_s seconds; the tracker ignores
    SIGTERM and ends when its pipe closes, which it does only once the
    workers (which hold the pipe too) are gone."""
    from multiprocessing import resource_tracker

    rt = resource_tracker._resource_tracker
    alive = [p for p in _descendants() if p != rt._pid]
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in alive:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.time() + grace_s
        while alive and time.time() < deadline:
            alive = [p for p in alive if not _gone(p)]
            time.sleep(0.05)
        if not alive:
            break
    if tracker:
        rt._stop()
    left = [p for p in _descendants() if p != rt._pid]
    if left:
        print(f"chip_smoke: processes {left} outlived SIGKILL", flush=True)


def _descendants() -> list[int]:
    parent = {}
    for d in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if stat[0] not in ("Z", "X"):
            parent[int(d)] = int(stat[1])
    out, todo = [], [os.getpid()]
    while todo:
        p = todo.pop()
        kids = [c for c, pp in parent.items() if pp == p]
        out += kids
        todo += kids
    return out


def _gone(pid: int) -> bool:
    try:
        if os.waitpid(pid, os.WNOHANG)[0] == pid:
            return True
    except ChildProcessError:
        pass
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X")
    except OSError:
        return True


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


def time_cuda(fn, iters: int, warm: int = 2) -> float:
    """Mean milliseconds per call of fn over `iters` calls, CUDA events
    around the loop, after `warm` calls of warm-up."""
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


# the CUDA function each kernel runs, as the profiler names it
DEVICE_FN = {
    # the one-plane forms, then the level forms
    "int_transform_fwd": ("transform_kernel<false>", "fwd_level_kernel"),
    "int_transform_inv": ("transform_kernel<true>", "inv_level_kernel"),
    "intra_filter": "filter_kernel", "intra_pred": "pred_kernel",
    "deblock": "deblock_kernel", "sao_stats": "stats_kernel",
    "sao_apply": "apply_kernel",
    # the search, then the stencils and outputs
    "me_sad": ("me_kernel", "me_out_kernel"),
    "nnfme": "nnfme_kernel", "mc_dctif": "mc_kernel",
    # the one-call form, then the NN-FME gate's levels
    "satd8": ("satd_kernel", "satd_gate_kernel"),
    # the level forms' TS mode
    "transform_skip": ("fwd_level_kernel", "inv_level_kernel"),
    # the one-call form, then the levels form
    "frac_refine": ("frac_kernel", "frac_levels_kernel"),
    "rdoq": "rdoq_kernel",
    "mc_dctif_i": "mc_kernel", "bi_pred": "bi_pred_kernel",
    "me_sad1": ("me1_kernel", "me1_out_kernel"), "adam": "nnfme_bwd_kernel",
    "nnfme_fwd": "nnfme_fwd_kernel", "nnfme_bwd": "nnfme_bwd_kernel",
    "merge_cands": "merge_kernel", "amvp_rd": "amvp_kernel",
    "mv_regularize": "reg_kernel", "mpm_bits": "mpm_kernel",
    "i_walk": "iwalk_kernel", "i_rmd": "rmd_kernel",
    "p_walk": "pwalk_kernel", "tmvp_grid": "tmvp_grids_kernel",
    "sao_choose": "sao_choose_kernel", "b_walk": "bwalk_kernel",
}


def self_device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def device_ms(fn, fname, iters: int = 20, tries: int = 3) -> float:
    """Device milliseconds per call of fn spent in CUDA functions named
    like `fname` (or any name of a tuple; torch.profiler, device
    activity): the kernel's own time, without the host's launch cost that
    time_cuda sees at small shapes.  The profiler has been seen to miss
    a short kernel's launches in a window (while the parity workers load
    the host), so a window with fewer launches than calls is profiled
    again, up to `tries` times; then the time a launch seen is the call's
    (and a line says so)."""
    from torch.profiler import ProfilerActivity, profile

    names = fname if isinstance(fname, tuple) else (fname,)
    seen = None
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if any(n in e.key for n in names)]
        # every call launches at least once: a window with fewer launches
        # than calls missed some
        n = sum(e.count for e in evs)
        if n >= iters:
            return sum(self_device_us(e) for e in evs) / 1e3 / iters
        if evs and (seen is None or n > seen[0]):
            seen = (n, sum(self_device_us(e) for e in evs) / 1e3)
    if seen is None:
        fail(f"profiler saw no {fname} launch in {tries} windows")
    # the launches seen, each counted as one call
    print(f"device_ms: the profiler saw {seen[0]} {fname} launches of "
          f"{iters} calls in the best of {tries} windows", flush=True)
    return seen[1] / seen[0]


def bound_ms(nbytes: float, ops: float):
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def deblock_work(h, w, ncell):
    """Bytes and operations of K3's state form on an h x w picture: the
    three int32 planes in and out, nine int32 columns of the 8x8 state
    (direction, both lists' MVs and references, luma cbf, CU size) and the
    POC table read once; per 4-line luma segment about 60 decision and 4 x
    6 x 8 filter operations, both directions."""
    npx = h * w * 3 // 2
    return (2 * npx * 4 + 9 * ncell * 4 + 34 * 4,
            2 * (h // 4) * (w // 8) * (60 + 4 * 6 * 8))


def deblock_state_case(name, y, u, v, blk, pocs, qp, bd, more=()):
    """check_kernels' case of K3's state form on a P / B state (`blk`,
    the lists' POCs: (ref_pocs, ref_pocs_l1))."""
    from hmtpu_torch.ops import deblock

    h, w = y.shape
    kw = dict(h=h, w=w, ref_pocs=pocs[0], ref_pocs_l1=pocs[1])
    nb, ops = deblock_work(h, w, (h // 8) * (w // 8))
    return (name, lambda: deblock.deblock_state(y, u, v, blk, qp, bd, **kw),
            lambda: deblock.deblock_state_plain(y, u, v, blk, qp, bd, **kw),
            nb, ops, None, list(more))


def seeded_p_state(dev, h, w, seed=18):
    """A seeded P picture's planes and 8x8 state (`blk`'s 14 columns):
    intra and inter cells, CU sizes 8 / 16 / 32, luma cbf, MVs a few
    quarter samples apart, references 0-3 of 4; returns (y, u, v, blk,
    (ref_pocs, ()))."""
    rng = np.random.RandomState(seed)
    n = (h // 8) * (w // 8)
    blk = np.zeros((n, 14), np.int32)
    blk[:, 5] = rng.choice([0, 1, 1, 1], n)
    blk[:, 6] = rng.randint(-20, 21, n)
    blk[:, 7] = rng.randint(-20, 21, n)
    blk[:, 8] = rng.randint(0, 4, n)
    blk[:, 9] = rng.randint(0, 3, n)
    blk[:, 10] = rng.randint(0, 2, n)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(dev)

    def plane(hh, ww):
        base = 128 + rng.randint(-8, 9, (hh // 8 + 1, ww // 8 + 1))
        return t(np.repeat(np.repeat(base, 8, 0), 8, 1)[:hh, :ww]
                 + rng.randint(-3, 4, (hh, ww)))

    return (plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2),
            t(blk), ([8, 7, 6, 5], ()))


def seeded_field(dev, h, w, seed=19, r=4):
    """A seeded K19 input at h x w: r references a few steps off the
    original, a field of small MVs (neighbours often equal), references
    0 to r-1, lam_sqrt of QP 25 (a float32 on the card)."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(dev)
    org = rng.randint(0, 256, (h, w))
    refs = np.clip(org[None] + rng.randint(-9, 10, (r, h, w)), 0, 255)
    bh, bw = h // 8, w // 8
    lam = torch.tensor(np.float32(np.sqrt(0.57 * 2.0 ** ((25 - 12) / 3.0))),
                       device=dev)
    return (t(refs), t(org), t(rng.choice([-3, 0, 2, 5], (bh, bw))),
            t(rng.choice([-1, 0, 4], (bh, bw))), t(rng.randint(0, r,
                                                              (bh, bw))),
            lam)


def reg_case(name, refs, org, mvx, mvy, ridx, lam, iters, more=()):
    """check_kernels' case of K19 (all rounds in one launch) with
    reg_work's bytes and operations."""
    from hmtpu_torch.search import me

    nb, ops = reg_work(refs, org, mvx, mvy, ridx, lam, iters)
    args = (refs, org, mvx, mvy, ridx, lam, iters)
    return (name, lambda: me.regularize_mv_field(*args),
            lambda: me.regularize_mv_field_plain(*args), nb, ops, None,
            list(more))


def kernel_cases(dev):
    """(name, kernel call, plain call, bytes, ops, library call[, more
    (kernel call, plain call) pairs checked but not timed]) at the main
    paths' shapes, inputs made from a seed."""
    from hmtpu_torch.ops import deblock, sao, transform

    rng = np.random.RandomState(1)
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(dev)
    cases = []

    # K1: its level forms at the P pass's `_code` shapes, a level's three
    # planes a launch (the 8 level's 1560 blocks timed, the 16 and 32
    # levels rows of their own); the old one-plane forms checked beside
    # the 8 level's row at a z-scan cell step's luma batch (14, 8, 8)
    nb, n = 14, 8
    res = t32(rng.randint(-255, 256, (nb, n, n)))
    coef = t32(rng.randint(-2000, 2001, (nb, n, n)))
    old = {"fwd": [(lambda: transform.forward_transform(res, n),
                    lambda: transform.forward_transform_plain(res, n))],
           "inv": [(lambda: transform.inverse_transform(coef, n),
                    lambda: transform.inverse_transform_plain(coef, n))]}
    for lv, m in ((8, (W // 8) * (H // 8)), (16, (W // 16) * (H // 16)),
                  (32, -(-W // 32) * -(-H // 32))):
        tag = "" if lv == 8 else f":level{lv}"
        for case in code_level_cases(dev, rng, lv, m, old if lv == 8
                                     else None):
            cases.append((case[0] + tag,) + case[1:])
    cases += ts_pair_cases(dev, rng, 2 * (W // 8) * (H // 8))

    # K3's 4x4-map form: one 416x240 picture (intra, random cbf and CU
    # sizes); its state form (the passes' call) is checked and timed on
    # the encodes' captured states (`deblock_cases`) and here on a
    # seeded 1920x1080 P state
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

    cases.append(deblock_state_case(
        "deblock:1080p", *seeded_p_state(dev, 1080, 1920), 27, 8))
    # K19: a seeded 1920x1080 field of 135x240 cells, 4 references, 3
    # rounds
    cases.append(reg_case("mv_regularize:1080p",
                          *seeded_field(dev, 1080, 1920), 3))

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
    # K4's frame forms, the main path's: the three planes of a 416x240
    # picture (luma at CTU 64, the chroma pair at 32) in one launch each;
    # then at 1920x1080
    cases += sao_frame_cases(dev, rng, H, W, "frame")
    cases += sao_frame_cases(dev, rng, 1080, 1920, "frame_1080p")
    return cases + inter_kernel_cases(dev, rng) \
        + slice3_kernel_cases(dev, rng) + slice4_kernel_cases(dev, rng) \
        + slice5_kernel_cases(dev, rng)


def code_level_cases(dev, rng, n, m, old=None):
    """K1's level forms at one level of the P pass (m blocks, luma n x n,
    chroma n/2 x n/2, 8 bits; seeded originals, predictions a few steps
    off, sparse levels with their dequantised values, K10-like rates, HM's
    chroma weight at QP 25): `int_transform_fwd` (fwd_level: org and pred
    in, the coefficients out, 12 B a sample) and `int_transform_inv`
    (inv_level: deq, lev, pred and org in, rec out, 20 B a sample, and
    each block's three rates in, its three SSEs, cbf, dist and bits out),
    each also checked on one plane (`_code`'s call: luma, and chroma with
    the weight); `old` adds the one-plane forms' checks by form."""
    from hmtpu_torch.common.lambdas import frame_lambdas
    from hmtpu_torch.ops import transform

    t32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(dev)
    orgs, preds, deqs, levs = [], [], [], []
    for s in (n, n // 2, n // 2):
        o = rng.randint(0, 256, (m, s, s))
        orgs.append(t32(o))
        preds.append(t32(np.clip(o + rng.randint(-20, 21, o.shape), 0,
                                 255)))
        lv = rng.randint(-20, 21, o.shape) * (rng.rand(*o.shape) < 0.1)
        levs.append(t32(lv))
        deqs.append(t32(lv * 300))
    bits = [torch.as_tensor(rng.rand(m).astype(np.float32) * 200).to(dev)
            for _ in range(3)]
    dw = torch.tensor(frame_lambdas(25, 25, 0.4624)[2], dtype=torch.float32,
                      device=dev)
    samples = m * (n * n + 2 * (n // 2) ** 2)
    # the butterflies' multiply-adds (about n a sample a stage) and the
    # SSE's
    ops = 2 * 2 * n * samples
    fwd = lambda k=(0, 1, 2): transform.fwd_level(
        [orgs[i] for i in k], [preds[i] for i in k], 8)
    fwd_p = lambda k=(0, 1, 2): transform.fwd_level_plain(
        [orgs[i] for i in k], [preds[i] for i in k], 8)

    def inv(k=(0, 1, 2), plain=False):
        f = transform.inv_level_plain if plain else transform.inv_level
        pick = lambda a: [a[i] for i in k]
        return f(pick(deqs), pick(levs), pick(preds), pick(orgs), 8,
                 None if k == (0,) else dw,
                 pick(bits) if len(k) == 3 else None)

    one = ((0,), (1,))
    old = old or {}
    return [("int_transform_fwd", fwd, fwd_p, 12 * samples, ops, None,
             [(lambda k=k: fwd(k), lambda k=k: fwd_p(k)) for k in one]
             + old.get("fwd", [])),
            ("int_transform_inv", inv, lambda: inv(plain=True),
             20 * samples + 36 * m, ops + 3 * samples, None,
             [(lambda k=k: inv(k), lambda k=k: inv(k, True)) for k in one]
             + old.get("inv", []))]


def ts_level_work(planes, m, n0, n1):
    """Bytes and operations of K1's level forms in their TS mode (m
    blocks, luma n0 and, three planes, chroma n1; the TS planes the 4x4
    ones): (forward bytes, ops, inverse bytes, ops).  Forward: org and
    pred in, the coefficients out, the TS planes' TS coefficients out;
    the butterflies' multiply-adds (about n a sample a stage) and a shift
    a TS sample.  Inverse: deq, lev, pred, org in and rec out, the TS
    planes' second deq and lev in and kept levels out, per block each
    plane's rate in and SSE out, the TS planes' second rate in and kept
    rate out, the TS word, and (three planes) cbf, dist and bits out,
    the flag's prices and lambda; the butterflies, the SSE, and a TS
    sample's reconstruction and SSE (about 8)."""
    sizes = [n0] + ([n1, n1] if planes == 3 else [])
    samples = sum(m * n * n for n in sizes)
    ts_s = m * 16 * (1 if planes == 1 else 2)
    ntp = 1 if planes == 1 else 2
    ops = sum(2 * 2 * n * m * n * n for n in sizes)
    fwd = (12 * samples + 4 * ts_s, ops + ts_s)
    inv = (20 * samples + 12 * ts_s
           + 4 * m * (2 * planes + 3 * ntp + 1 + (3 if planes == 3 else 0))
           + 12, ops + 3 * samples + 8 * ts_s)
    return fwd + inv


def ts_pair_cases(dev, rng, m):
    """K1's TS mode on a seeded one-plane (m, 4, 4) pair, ldp_dctif's 4x4
    chroma TBs of phase 1a at 416x240 (2 x 1560): `transform_skip` the
    forward (both alternatives' coefficients), `transform_skip:pick` the
    inverse (both reconstructed, priced and the cheaper kept; the DST
    and the chroma weight checked beside it, and ties, which keep the
    DCT alternative)."""
    from hmtpu_torch.common.lambdas import frame_lambdas
    from hmtpu_torch.ops import transform
    from tests.torch_level_data import FLAG, planes, ts_alt

    t32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(dev)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dev)
    pl = planes(rng, m, (4,), 8)
    tdeq, tlev, bits, tbits = ts_alt(rng, pl[0], 8)
    org, pred, deq, lev = (t32(a) for a in pl[0])
    # the chroma lambda of ldp's P frame (QP 25, HM's factor 0.4624)
    lam = torch.tensor(frame_lambdas(25, 25, 0.4624)[3], dtype=torch.float32,
                       device=dev)
    args = ([deq], [lev], [f32(bits)], [t32(tdeq)], [t32(tlev)],
            [f32(tbits)], [pred], [org], f32(FLAG), lam, 8)
    dw = torch.tensor(1.25, dtype=torch.float32, device=dev)
    fb, fo, ib, io = ts_level_work(1, m, 4, 0)
    fwd = lambda dst=False: transform.fwd_level([org], [pred], 8, dst,
                                                ts=True)
    fwd_p = lambda dst=False: transform.fwd_level_plain([org], [pred], 8,
                                                        dst, ts=True)
    inv = lambda *x: transform.inv_level_ts(*args, *x)
    inv_p = lambda *x: transform.inv_level_ts_plain(*args, *x)
    return [("transform_skip", fwd, fwd_p, fb, fo, None,
             [(lambda: fwd(True), lambda: fwd_p(True))]),
            ("transform_skip:pick", inv, inv_p, ib, io, None,
             [(lambda: inv(dw), lambda: inv_p(dw)),
              (lambda: inv(None, True), lambda: inv_p(None, True))])]


def ts_captured_cases(got):
    """K1's TS mode on ldp_dctif's captured 8-level hypothesis (416x240:
    1560 blocks, the chroma pair coded both ways): the forward and the
    inverse, in one row (`transform_skip:ldp_dctif`); the widest
    one-plane pair of the plain passes run on the card beside it
    (`_code_ts_sel`), checked."""
    from hmtpu_torch.ops import transform

    if ("transform_skip", "fwd") not in got \
            or ("transform_skip", "inv") not in got:
        fail("capture: no TS hypothesis in ldp_dctif's encode")
    (_, fa, fk), (m, ia, ik) = (got[("transform_skip", f)]
                                for f in ("fwd", "inv"))
    print(f"capture: transform_skip hypothesis, {m} blocks", flush=True)
    fb, fo, ib, io = ts_level_work(3, m, 8, 4)
    more = []
    for f, fn, fp in (("fwd one plane", transform.fwd_level,
                       transform.fwd_level_plain),
                      ("inv one plane", transform.inv_level_ts,
                       transform.inv_level_ts_plain)):
        if ("transform_skip", f) in got:
            _, a, k = got[("transform_skip", f)]
            more.append((lambda fn=fn, a=a, k=k: fn(*a, **k),
                         lambda fp=fp, a=a, k=k: fp(*a, **k)))
    return [("transform_skip:ldp_dctif",
             lambda: (transform.fwd_level(*fa, **fk),
                      transform.inv_level_ts(*ia, **ik)),
             lambda: (transform.fwd_level_plain(*fa, **fk),
                      transform.inv_level_ts_plain(*ia, **ik)),
             fb + ib, fo + io, None, more)]


def sao_frame_cases(dev, rng, h, w, tag):
    """K4's three-plane statistics and apply of an h x w picture (CTU 64,
    8 bits; seeded planes, a reconstruction a few steps off, random
    parameters of every type) as rows `sao_stats:<tag>`, `sao_apply:<tag>`:
    bytes the planes in (and out) and the rows or parameters, 30 and 12
    operations a sample as the one-plane rows count."""
    from hmtpu_torch.ops import sao

    t32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(dev)
    org, rec = [], []
    for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        o = rng.randint(40, 216, (hh, ww))
        org.append(t32(o))
        rec.append(t32(np.clip(o + rng.randint(-6, 7, (hh, ww)), 0, 255)))
    planes = [a for pair in zip(org, rec) for a in pair]
    ny, nx = -(-h // 64), -(-w // 64)
    params = t32(np.concatenate(
        [rng.randint(0, 3, (ny, nx, 3, 1)), rng.randint(0, 4, (ny, nx, 3, 1)),
         rng.randint(0, 29, (ny, nx, 3, 1)),
         rng.randint(-7, 8, (ny, nx, 3, 4))], -1))
    npx = h * w * 3 // 2
    return [(f"sao_stats:{tag}",
             lambda: sao.sao_stats_frame(*planes, 64, 8),
             lambda: sao.sao_stats_frame_plain(*planes, 64, 8),
             (2 * npx + 3 * ny * nx * 96) * 4, 30 * npx, None),
            (f"sao_apply:{tag}",
             lambda: sao.apply_sao_frame(*rec, params, 64, 8),
             lambda: sao.apply_sao_frame_plain(*rec, params, 64, 8),
             (2 * npx + ny * nx * 3 * 7) * 4, 12 * npx, None)]


def mc_form_case(dev, rng, form, n, h, w, bd=8, inter=False):
    """One launch of K7 (K11 with inter) in `form` "yuv" (the three
    planes of an h x w picture's n-grid, 4 references: the P pass's AMVP
    hypotheses) or "luma2" (its luma blocks under two MV sets: the NN
    gate), every phase, MVs past the edges: (kernel call, plain call,
    bytes, operations).  Bytes: each form's distinct reference samples
    (`mc_work`), the index and MV arrays and the outputs."""
    from hmtpu_torch.ops import interp

    t32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(dev)
    ry = t32(rng.randint(0, 1 << bd, (4, h, w)))
    ru, rv = (t32(rng.randint(0, 1 << bd, (4, h // 2, w // 2)))
              for _ in range(2))
    gw = w // n
    nb = gw * (h // n)
    span = 4 * (n + 24)
    ridx = t32(rng.randint(0, 4, nb))
    mvx, mvy = (t32(rng.randint(-span, span, (2, nb))) for _ in range(2))
    q = torch.arange(nb, device=dev)
    xs, ys = (q % gw) * n, (q // gw) * n
    nc = n // 2
    if form == "yuv":
        work = [mc_work(ry, ridx, xs, ys, mvx[0], mvy[0], n, False)] + [
            mc_work(r, ridx, xs // 2, ys // 2, mvx[0], mvy[0], nc, True)
            for r in (ru, rv)]
        outs, idx = nb * (n * n + 2 * nc * nc), 3 * nb
        kfn = lambda: interp.mc_yuv(ry, ru, rv, ridx, gw, mvx[0], mvy[0], n,
                                    bd, inter)
        pfn = lambda: interp.mc_yuv_plain(ry, ru, rv, ridx, gw, mvx[0],
                                          mvy[0], n, bd, inter)
    else:
        cat = lambda a: torch.cat([a, a])
        work = [mc_work(ry, cat(ridx), cat(xs), cat(ys), mvx.reshape(-1),
                        mvy.reshape(-1), n, False)]
        outs, idx = 2 * nb * n * n, 5 * nb
        kfn = lambda: interp.mc_luma2(ry, ridx, gw, mvx, mvy, n, bd, inter)
        pfn = lambda: interp.mc_luma2_plain(ry, ridx, gw, mvx, mvy, n, bd,
                                            inter)
    samples = sum(wk[0] for wk in work)
    return kfn, pfn, (samples + idx + outs) * 4, 2 * sum(wk[1] for wk in work)


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
    # checked besides: ra10's 10-bit planes (the clip << 2) and a flat
    # plane, where every displacement ties (the first index wins)
    ref10, org10 = ref << 2, org << 2
    lam10 = np.float32(lam * 4)
    flat_p = torch.full((H, W), 90, dtype=torch.int32, device=dev)
    cases.append(("me_sad",
                  lambda: flat(me.integer_me_levels(ref, org, SRANGE, lam,
                                                    qh, qw)),
                  lambda: flat(me.integer_me_levels_plain(ref, org, SRANGE,
                                                          lam, qh, qw)),
                  2 * H * W * 4 + lanes * 12 * 4, 3 * H * W * nd, None,
                  [(lambda: flat(me.integer_me_levels(ref10, org10, SRANGE,
                                                      lam10, qh, qw, 10)),
                    lambda: flat(me.integer_me_levels_plain(
                        ref10, org10, SRANGE, lam10, qh, qw))),
                   (lambda: flat(me.integer_me_levels(flat_p, flat_p, SRANGE,
                                                      np.float32(0.0), qh,
                                                      qw)),
                    lambda: flat(me.integer_me_levels_plain(
                        flat_p, flat_p, SRANGE, np.float32(0.0), qh, qw)))]))

    # K6: the three levels' stencils of that search (1560, 390 and 104
    # PUs: 2,054 rows, one launch), the QP 22 weights; the one-level forms
    # (classes and logits) checked on the 8 level's costs
    stens = [d[1] for d in (me.integer_me_levels_plain(
        ref, org, SRANGE, lam, qh, qw)[n] for n in (8, 16, 32))]
    st9 = stens[0].reshape(-1, 9).to(torch.float32).contiguous()
    nb = sum(st.numel() // 9 for st in stens)
    sizes = torch.full((st9.shape[0],), 8, dtype=torch.int32, device=dev)
    params = nnfme.load_npz(os.path.join(nnfme.WEIGHTS_DIR, "qp22.npz"),
                            dev)
    macs = 17 * 22 + 22 * 20 + 20 * 49
    cases.append(("nnfme",
                  lambda: nnfme.predict_offsets_levels(params, stens,
                                                       (8, 16, 32)),
                  lambda: nnfme.predict_offsets_levels_plain(
                      params, stens, (8, 16, 32)),
                  # the stencils in, the weights, a class and offsets out
                  (nb * 9 + nnfme.PACK_SIZE + nb * 3) * 4,
                  # the products and sums, the biases, ReLU and affine of
                  # the 42 hidden units, the standardisation, the argmax
                  nb * (2 * macs + 91 + 3 * 42 + 3 * 9 + 49), None,
                  # the one-level forms: classes, and the logits bit for bit
                  [(lambda: nnfme.predict_offsets(params, st9, sizes, sizes),
                    lambda: nnfme._classes(nnfme.forward_plain(
                        params, st9, sizes, sizes))),
                   (lambda: nnfme.forward(params, st9, sizes, sizes),
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
    # K7's forms, the main path's: a level's AMVP hypotheses (three planes)
    # and its NN gate (two MV sets) in one launch each, at each level; the
    # hypotheses' 8 level at 1920x1080
    for n in (8, 16, 32):
        for form in ("yuv", "luma2"):
            k, pl, nbytes, ops = mc_form_case(dev, rng, form, n, H, W)
            cases.append((f"mc_dctif:{form}{n}", k, pl, nbytes, ops, None))
    k, pl, nbytes, ops = mc_form_case(dev, rng, "yuv", 8, 1080, 1920)
    cases.append(("mc_dctif:yuv8_1080p", k, pl, nbytes, ops, None))

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
    cases.append(satd_gate_case(dev, rng, org))
    return cases


def satd_gate_case(dev, rng, org):
    """K8's gate form at ldp's three levels (1560 8x8, 390 16x16 and 104
    32x32 blocks, the 32 grid past the picture's edge) over the 416x240
    original: two predictions near each block (equal on a fifth of them,
    where the second MV set stays), seeded quarter-pel MV sets; the row
    `satd8:gate`.  Bytes: the original read once a level, both
    predictions, the MV sets in and the kept MVs out; operations: two
    SATDs a tile (as the satd8 row counts them) and a compare a block."""
    from hmtpu_torch.search import me

    t32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(dev)
    levels, tiles, nbs = [], 0, 0
    for n, gh, gw in ((8, H // 8, W // 8), (16, H // 16, W // 16),
                      (32, (H // 16 + 1) // 2, (W // 16 + 1) // 2)):
        nb = gh * gw
        base = me._grid_blocks(org, n, gw, nb).cpu().numpy()
        p0 = np.clip(base + rng.randint(-20, 21, base.shape), 0, 255)
        p1 = np.clip(base + rng.randint(-20, 21, base.shape), 0, 255)
        same = rng.rand(nb) < 0.2
        p1[same] = p0[same]
        levels.append(((t32(p0), t32(p1)),
                       t32(rng.randint(-300, 301, (2, nb))),
                       t32(rng.randint(-300, 301, (2, nb))), n, gw))
        tiles += nb * (n // 8) ** 2
        nbs += nb
    nbytes = (3 * H * W + 2 * tiles * 64 + 4 * nbs + 2 * nbs) * 4
    return ("satd8:gate", lambda: me.satd_gate_levels(org, levels),
            lambda: me.satd_gate_levels_plain(org, levels), nbytes,
            2 * tiles * (64 + 2 * 8 * 24 + 128) + nbs, None)


def frac_keys(refs, ridx, xs, ys, org, mvx, mvy, n):
    """The work of HM's two-stage search on these blocks, as keys of what
    it must read and compute: (the clamped (n + 8)^2 reference patches'
    samples, the filter outputs, SATD operations).  Stage 1's half-pel
    winners come from the plain version, so stage 2's candidates are this
    data's.  A filter output is one sum of 8 taps, keyed by what it
    equals whichever candidate reads it: a horizontal sum by (reference,
    row, column, phase), read by every candidate with a horizontal phase
    over its n rows, or its n + 7 where its vertical phase is non-zero;
    a vertical one by (reference, position, both phases), one for each
    sample of a candidate with a vertical phase.  So a stage's candidates
    share what HM's half- and quarter-pel planes (xExtDIFUpSamplingH/Q)
    share.  Per 8x8 tile of each distinct candidate (17 a block: stage
    2's centre is stage 1's winner) its SATD takes 64 differences, 2 x 8
    rows of 24 butterfly operations, 64 absolute values and sums."""
    from hmtpu_torch.ops import interp
    from hmtpu_torch.search import me

    _, h, w = refs.shape
    dev = refs.device
    r = ridx.to(torch.int64)
    k = torch.arange(n + 8, device=dev)[None, :]
    py = torch.clamp(ys[:, None] + mvy[:, None] - 4 + k, 0, h - 1)
    px = torch.clamp(xs[:, None] + mvx[:, None] - 4 + k, 0, w - 1)
    patch = ((r[:, None, None] * h + py[:, :, None]) * w
             + px[:, None, :]).reshape(-1)
    # an output's key: reference, row and column (each clamped to where
    # the outputs begin to repeat, offset by 4), horizontal and vertical
    # phases; a horizontal sum has vertical phase 0
    key = lambda row, col, fx, fy: ((((r.view(-1, 1, 1, 1) * (h + 7) + row
                                       + 4) * (w + 7) + col + 4) * 4 + fx)
                                    * 4 + fy)
    i = torch.arange(n, device=dev)
    t = torch.arange(-3, n + 4, device=dev)
    offs = torch.as_tensor(me._FRAC_OFFS, device=dev).to(torch.int64)
    cx, cy = mvx.to(torch.int64) * 4, mvy.to(torch.int64) * 4
    outs = []
    for step in (2, 1):
        qx = cx[:, None] + offs[None, :, 1] * step
        qy = cy[:, None] + offs[None, :, 0] * step
        fx, fy = (qx & 3)[..., None, None], (qy & 3)[..., None, None]
        ix = xs.to(torch.int64)[:, None] + (qx >> 2)
        iy = ys.to(torch.int64)[:, None] + (qy >> 2)
        # horizontal sums: rows (clamped, as the filter reads them) n + 7
        # under a vertical phase, else n; columns clamped where all 8
        # taps read the first or the last column
        rows = torch.clamp(iy[..., None] + t, 0, h - 1)[..., :, None]
        cols = torch.clamp(ix[..., None] + i, -4, w + 2)[..., None, :]
        use = (fx != 0) & ((fy != 0) | ((t >= 0) & (t < n))[:, None])
        hk = key(rows, cols, fx, torch.zeros_like(fy))
        shape = (*qx.shape, n + 7, n)
        outs.append(hk.expand(shape)[use.expand(shape)])
        # vertical sums: each sample of a candidate with a vertical phase
        rows = torch.clamp(iy[..., None] + i, -4, h + 2)[..., :, None]
        cols = torch.where(fx[..., 0] != 0,
                           torch.clamp(ix[..., None] + i, -4, w + 2),
                           torch.clamp(ix[..., None] + i, 0, w - 1))
        shape = (*qx.shape, n, n)
        vk = key(rows, cols[..., None, :], fx, fy)
        outs.append(vk.expand(shape)[(fy != 0).expand(shape)])
        if step == 2:
            costs = [me.satd_batch_plain(org, interp.mc_batch_plain(
                refs, ridx, xs, ys, qx[:, c].to(mvx.dtype),
                qy[:, c].to(mvy.dtype), n, n, False), n) for c in range(9)]
            best = torch.stack(costs, 1).argmin(1)
            cx = cx + offs[best, 1] * step
            cy = cy + offs[best, 0] * step
    satd = 17 * xs.numel() * (n // 8) ** 2 * (64 + 2 * 8 * 24 + 128)
    return patch, torch.cat(outs), satd


def frac_work(refs, ridx, xs, ys, org, mvx, mvy, n):
    """(distinct reference samples, operations) of HM's two-stage search
    on these blocks: `frac_keys`, a multiply and an add a filter tap."""
    patch, outs, satd = frac_keys(refs, ridx, xs, ys, org, mvx, mvy, n)
    return int(patch.unique().numel()), 16 * int(outs.unique().numel()) + satd


def frac_levels_work(refs, org, levels):
    """(bytes, operations) of K9's levels form on these levels, each
    sample and filter output counted once over the three (they share the
    reference): `frac_keys`' distinct reference samples and filter
    outputs, the original's samples (read in place, clamped to the
    plane), three int32 inputs (MVs, reference) and two outputs a
    block."""
    from hmtpu_torch.search import me

    h, w = org.shape
    dev = org.device
    patch, outs, pix = [], [], []
    nbytes = ops = 0
    for mx, my, rr, n in levels:
        gh, gw = mx.shape
        q = torch.arange(gh * gw, device=dev)
        xs, ys = (q % gw) * n, (q // gw) * n
        p, o, satd = frac_keys(refs, rr.reshape(-1), xs, ys,
                               me._grid_blocks(org, n, gw, gh * gw),
                               mx.reshape(-1), my.reshape(-1), n)
        patch.append(p)
        outs.append(o)
        rows = torch.clamp(torch.arange(gh * n, device=dev), max=h - 1)
        cols = torch.clamp(torch.arange(gw * n, device=dev), max=w - 1)
        pix.append((rows[:, None] * w + cols[None, :]).reshape(-1))
        nbytes += gh * gw * 5 * 4
        ops += satd
    nbytes += 4 * (torch.cat(patch).unique().numel()
                   + torch.cat(pix).unique().numel())
    ops += 16 * torch.cat(outs).unique().numel()
    return int(nbytes), int(ops)


def frac_hd_case(dev, rng):
    """K9 as the extraction calls it at 1920x1080: the levels form's 8
    level alone over a seeded plane (32,400 blocks, one reference, integer
    MVs of +-64), timed, the row `frac_refine:1080p`; the one-call form on
    the same blocks checked."""
    from hmtpu_torch.search import me

    t32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(dev)
    clip = hd_clip()
    ref, org = t32(clip[0][0]), t32(clip[1][0])
    bh, bw = HD_H // 8, HD_W // 8
    mvx, mvy = (t32(rng.randint(-64, 65, (bh, bw))) for _ in range(2))
    zero = torch.zeros_like(mvx)
    levels = [(mvx, mvy, zero, 8)]
    q = torch.arange(bh * bw, device=dev)
    blocks = me._grid_blocks(org, 8, bw, bh * bw).contiguous()
    xs, ys = (q % bw) * 8, (q // bw) * 8
    nbytes, ops = frac_levels_work(ref[None], org, levels)
    return ("frac_refine:1080p",
            lambda: me.frac_refine_levels(ref, org, levels, 8),
            lambda: me.frac_refine_levels_plain(ref, org, levels, 8),
            nbytes, ops, None,
            [(lambda: me.frac_refine_batch(ref, xs, ys, blocks,
                                           mvx.reshape(-1), mvy.reshape(-1),
                                           8, 8),
              lambda: me.frac_refine_batch_plain(
                  ref, xs, ys, blocks, mvx.reshape(-1), mvy.reshape(-1), 8,
                  8))])


def frac_form(a, k) -> str:
    """The form of a `frac_refine_levels` call: the plane's size and bit
    depth, and the call's number among those of that size and depth (each
    B pass of an encode its own)."""
    h, w = a[1].shape
    bd = a[3] if len(a) > 3 else k.get("bd", 8)
    key = f"{w}x{h} {bd} bits"
    _FRAC_CALLS[key] = _FRAC_CALLS.get(key, 0) + 1
    return f"{key} call {_FRAC_CALLS[key]}"


_FRAC_CALLS: dict = {}


def frac_levels_cases(got):
    """K9's levels form on the captured calls of the passes: ldp_dctif's
    P pass (its three levels in one launch, timed, `frac_refine:levels`),
    every B pass of the ra10 encode (10 bits) and the small RA encodes'
    checked: check_kernels' cases."""
    from hmtpu_torch.search import me

    forms = sorted(f for k_, f in got if k_ == "frac_refine")
    p_form = f"{W}x{H} 8 bits call 1"
    b_forms = [f for f in forms if f.startswith(f"{W}x{H} 10 bits")]
    if p_form not in forms or len(b_forms) != 8:
        fail(f"capture: K9's levels forms {forms}: no ldp_dctif P pass, or "
             f"not 8 ra10 B passes")
    print(f"capture: frac_refine levels forms {forms}", flush=True)

    def call(fn, form):
        _, a, k = got[("frac_refine", form)]
        return lambda: fn(*a, **k)

    _, a, k = got[("frac_refine", p_form)]
    nbytes, ops = frac_levels_work(a[0], a[1], a[2])
    more = [(call(me.frac_refine_levels, f),
             call(me.frac_refine_levels_plain, f))
            for f in forms if f != p_form]
    return [("frac_refine:levels", call(me.frac_refine_levels, p_form),
             call(me.frac_refine_levels_plain, p_form), nbytes, ops, None,
             more)]


def rdoq_work(c, lev, qp, log2):
    """Arithmetic operations K10 does on these TBs with the trellis and
    SDH (the timed case), stage by stage as csrc/rdoq.cuh runs them, the
    data-dependent terms counted on this data (table reads, compares,
    votes and the SDH stage's repairs left out, so it is a lower bound):
      load        |x|, two quantiser roundings (4 each), d0 (2): 11 per
                  position;
      last bits   the table of the call's size: per coordinate 2 x 30
                  multiply-adds;
      stage 1     the zero level's cost (2) per position; one RD cost
                  (11) and 2 minimums per rounded level > 0, a second RD
                  cost per rounded level >= 2;
      stage 2     2 adds per position, 4 per CG;
      stage 3     11 per position;
      guard       d + lambda * bits of two level sets: 5 per position
                  each;
      tb_bits     3 calls of 10 (the rate's adds) + 6 per CG, and 2 (sig
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
    per_tb = (11 + 2 + 2 + 11 + 10 + 6) * npos + 4 * ncg \
        + 3 * (10 + 6 * ncg)
    return int(nb * per_tb + 120 * (1 << log2) + 13 * (m > 0).sum()
               + 11 * (m >= 2).sum() + 2 * (fb > 0).sum()
               + 2 * (lev != 0).sum())


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
    # and at 10 bits (the clip << 2, its references' low bits set)
    refs10, org10 = refs << 2 | 3, org << 2
    more = [frac_case(n)[3:] for n in (16, 32)] + [
        (lambda: me.frac_refine_batch(refs10, args[1], args[2], org10, *mv,
                                      8, 10, ridx=args[0]),
         lambda: me.frac_refine_batch_plain(refs10, args[1], args[2], org10,
                                            *mv, 8, 10, ridx=args[0]))]
    cases.append(("frac_refine", kfn, pfn,
                  # the distinct reference samples, the org blocks, the
                  # five index / MV arrays in and the two MV arrays out
                  (samples + nb * 64 + 7 * nb) * 4, ops, None, more))
    cases.append(frac_hd_case(dev, rng))

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
        # K1's level forms in their TS mode: the TS coefficients
        return transform.fwd_level([res], [torch.zeros_like(res)], 8,
                                   ts=True)[1][0] if ts \
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
    # and its forms (three planes; two MV sets) at each level, 10 bits
    more += [mc_form_case(dev, rng, form, n, H, W, bd, True)[:2]
             for n in (8, 16, 32) for form in ("yuv", "luma2")]
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


_HD: list = []


def hd_clip():
    """The generator's 1920x1080 clip, HD_FRAMES frames (made once)."""
    if not _HD:
        _HD.extend(synth_clip(HD_W, HD_H, HD_FRAMES, seed=42))
    return _HD


def frames_of(clip):
    from hmtpu_torch.io.yuv import Frame

    return [Frame(*(np.asarray(p, np.int32) for p in f)) for f in clip]


def mlp_work(nb):
    """Multiply-adds of the MLP's three layers for nb rows."""
    return nb * (17 * 22 + 22 * 20 + 20 * 49)


def slice5_kernel_cases(dev, rng):
    """K13 at 1920x1080, search range 64, one reference (checked at
    416x240 and 64x56, search ranges 16 and 64, non-zero predictors, at
    64x56 also on 10-bit samples, and on a flat plane where every
    displacement ties), and
    K14-K16 at batch 1024 of the trainer's QP-22 records (the clip's
    first frame pair at search range 16), from the port's init (seed 0)
    with the rows' fitted mean and std; K14 and K15 checked besides on
    the batch's first 1, 32 and 100 rows (the shapes of a last batch and
    the gpu tests) and K14 without the backward's tensors on 7176 rows
    (the validation set's size at the defaults: the records tiled, their
    costs moved by seeded noise)."""
    from hmtpu_torch.models import dataset, nnfme, train
    from hmtpu_torch.search import me

    t32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(dev)
    lam = np.float32(np.sqrt(0.57 * 2.0 ** ((QP_LDP - 12) / 3.0)))
    cases = []

    def me1_case(clip, sr, bd=8, lam=lam, span=64):
        h, w = clip[0][0].shape
        org, ref = (t32(np.asarray(clip[i][0], np.int64) << (bd - 8))
                    for i in (1, 0))
        px, py = (t32(rng.randint(-span, span + 1, (h // 8, w // 8)))
                  for _ in range(2))
        return (lambda: me.integer_me(ref, org, 8, sr, lam, px, py, bd),
                lambda: me.integer_me_plain(ref, org, 8, sr, lam, px, py))

    kfn, pfn = me1_case(hd_clip()[:2], HD_SR)
    small = synth_clip(64, 56, 2, seed=3)
    flat = [(np.full((56, 64), 90),)] * 2
    more = [me1_case(c, sr) for c in (synth_clip(W, H, 2, seed=42), small)
            for sr in (16, 64)] + [
        me1_case(small, sr, 10) for sr in (16, 64)] + [
        me1_case(flat, 16, bd, np.float32(0.0), 0) for bd in (8, 10)]
    nblk = (HD_H // 8) * (HD_W // 8)
    # two planes and two predictor fields in, 12 int32 per block out; per
    # displacement and sample a subtract, an absolute value and an add
    cases.append(("me_sad1", kfn, pfn,
                  (2 * HD_H * HD_W + 2 * nblk + 12 * nblk) * 4,
                  3 * HD_H * HD_W * (2 * HD_SR + 1) ** 2, None, more))

    c9, hh, ww, ll = dataset.extract_clip(
        frames_of(synth_clip(W, H, 2, seed=42)), 22, TRAIN_SR, device=dev)
    nb = TRAIN_BATCH
    mean, std = train.standardize_fit(c9[:nb])
    init = nnfme.init_random(torch.Generator().manual_seed(0), dev)
    fields = {k: getattr(init, k).cpu().numpy() for k in nnfme.PACK_ORDER}
    fields.update(mean=mean, std=std)
    pk = nnfme.params_from_arrays(fields, dev).packed
    nv = 7176
    tile = lambda a: np.concatenate([a] * -(-nv // len(a)))[:nv]
    vset = (torch.as_tensor((tile(c9) + rng.randint(0, 64, (nv, 9)))
                            .astype(np.float32)).to(dev),
            *(torch.as_tensor(tile(a)).to(dev) for a in (hh, ww, ll)))
    c9, hh, ww, ll = (torch.as_tensor(a[:nb]).to(dev) for a in (c9, hh, ww,
                                                                 ll))
    rows = lambda n: (c9[:n], hh[:n], ww[:n], ll[:n])
    # K14: per row the MLP (a multiply and an add per term, the biases,
    # ReLU and affine of 42 units, the standardisation), the max and
    # argmax, 49 subtractions, exponentials and sums, the log and loss,
    # and 49 d-logits (an exponential again, a multiply): ~4,050
    cases.append(("nnfme_fwd",
                  lambda: train.loss_fwd(pk, c9, hh, ww, ll),
                  lambda: train.loss_fwd_plain(pk, c9, hh, ww, ll),
                  (nb * 12 + nnfme.PACK_SIZE + nb * 91 + 2) * 4,
                  2 * mlp_work(nb) + nb * (3 * 42 + 3 * 9 + 2 * 49
                                           + 5 * 49 + 4), None,
                  [(lambda n=n: train.loss_fwd(pk, *rows(n)),
                    lambda n=n: train.loss_fwd_plain(pk, *rows(n)))
                   for n in (1, 32, 100)]
                  + [(lambda: train.loss_fwd(pk, *vset, want_grad=False)[0],
                      lambda: train.loss_fwd_plain(pk, *vset,
                                                   want_grad=False)[0])]))
    _, saved = train.loss_fwd(pk, c9, hh, ww, ll)
    one = torch.ones(1, dtype=torch.float32, device=dev)
    bwd = lambda: train.loss_bwd(pk, c9, hh, ww, *saved, one)

    def bwd_case(n):
        sv = tuple(s[:n] for s in saved)
        return (lambda: train.loss_bwd(pk, *rows(n)[:3], *sv, one),
                lambda: train.loss_bwd_plain(pk, *rows(n)[:3], *sv, one))

    # K15 with K16 as its tail, the training step's form: on clones of the
    # parameters and seeded moments, from update k (each timed call makes
    # one more: the table has room for them)
    n = nnfme.PACK_SIZE
    base = (torch.as_tensor(rng.randn(n) * 1e-3, dtype=torch.float32)
            .to(dev),
            torch.as_tensor(rng.rand(n) * 1e-5, dtype=torch.float32).to(dev))

    def fused(k=1, plain=False, steps=4096):
        st = [pk.clone(), train.adam_state(base[0].clone(), base[1].clone(),
                                           k - 1, steps)]

        def call():
            f = train.loss_bwd_adam_plain if plain else train.loss_bwd_adam
            g = f(st[0], c9, hh, ww, *saved, one, st[1], 3e-3)
            st[1] = st[1]._replace(count=st[1].count + 1)
            return g, st[0], st[1].mu, st[1].nu, st[1].dcount
        return call

    # per row the three layers back (a multiply and an add per term), the
    # features and activations again, and each parameter's product and
    # sum; then the blocks' partials summed; the tail: per parameter 13
    # operations, p, mu, nu read and written, a table row and the count
    adam_bytes, adam_ops = (6 * n + 2 + 2) * 4, 13 * n
    cases.append(("nnfme_bwd", fused(), fused(plain=True),
                  (nb * (11 + 91) + nnfme.PACK_SIZE + 1
                   + nnfme.PACK_SIZE) * 4 + adam_bytes,
                  2 * mlp_work(nb) + nb * (3 * 9 + 4 * 42 + 2 * 9 * 4)
                  + 2 * nb * nnfme.PACK_SIZE
                  + -(-nb // train.KROWS) * nnfme.PACK_SIZE + adam_ops, None,
                  # updates 2 and the table's last; the gradient alone
                  # (NnFmeLoss.backward's form) at 1024, run to run, and at
                  # 1, 32 and 100 rows
                  [(fused(2), fused(2, True)),
                   (fused(7, steps=1), fused(7, True, 1)),
                   (bwd, lambda: train.loss_bwd_plain(pk, c9, hh, ww,
                                                      *saved, one)),
                   (bwd, bwd)] + [bwd_case(n) for n in (1, 32, 100)]))
    grad = bwd()
    lp = torch.nn.Parameter(pk.clone())
    lp.grad = grad.clone()
    lib = torch.optim.Adam([lp], lr=3e-3, fused=True)
    # K16 as K15's tail: the same launch, its row's bound the update's
    # own (the gradient is not read back), the yardstick fused Adam
    cases.append(("adam", fused(), fused(plain=True), adam_bytes, adam_ops,
                  lib.step))
    return cases


# the plain-torch device functions of queue B that have no hand kernel yet
# (item, module, function): PlainTally counts their calls in an untimed
# encode and sums the bytes of the tensors their calls take as arguments
# and give back, a bound for argument bytes only (a pass's own reads and
# writes of intermediates are not in it)
PLAIN_FUNCS = (
    # the plain versions of K21-K26 (B14, B9, B11's P and B forms, B10,
    # B13): none may run on the card's encode paths
    ("K21 plain", "hmtpu_torch.encoder.iframe_dev", "iframe_pass_plain"),
    ("K22 plain", "hmtpu_torch.encoder.intra_rdo", "rmd_plain"),
    ("K22 plain", "hmtpu_torch.encoder.iframe_dev", "rmd_plain"),
    ("K23 / K26 plain", "hmtpu_torch.encoder.pframe_dev",
     "wavefront_pass_plain"),
    ("K24 plain", "hmtpu_torch.encoder.pframe_dev", "t_level_plain"),
    ("K24 plain", "hmtpu_torch.encoder.pframe_dev", "tmvp_grids_plain"),
    ("K25 plain", "hmtpu_torch.ops.sao", "_choose_params_plain"),
    # and of K1's level forms and K6's level form
    ("K1 plain", "hmtpu_torch.ops.transform", "fwd_level_plain"),
    ("K1 plain", "hmtpu_torch.ops.transform", "inv_level_plain"),
    ("K1 plain", "hmtpu_torch.ops.transform", "inv_level_ts_plain"),
    ("K6 plain", "hmtpu_torch.models.nnfme", "predict_offsets_levels_plain"),
    # and of K8's gate form and one-call form
    ("K8 plain", "hmtpu_torch.search.me", "satd_gate_levels_plain"),
    ("K8 plain", "hmtpu_torch.search.me", "satd_batch_plain"),
    # and of K9's levels form and one-call form
    ("K9 plain", "hmtpu_torch.search.me", "frac_refine_levels_plain"),
    ("K9 plain", "hmtpu_torch.search.me", "frac_refine_batch_plain"),
) + tuple(
    # B8's flag helpers (hmtpu/ops/ratebits.py:305-450), as the passes
    # import them (mvd, ref_idx, inter_dir and the MPM pricing are K18's
    # and K20's; the I pass's are folded into K21, the P pass's into K23
    # and the B pass's into K26: only their plain versions call them)
    ("B8 flags", f"hmtpu_torch.encoder.{mod}", fn)
    for mod, fns in (
        ("pframe_dev", ("cbf_chroma_bits", "cbf_luma_bits", "chroma_dm_bits",
                        "merge_flag_bits", "merge_idx_bits", "mvp_idx_bits",
                        "part_size_2nx2n_bits", "pred_mode_bits",
                        "rqt_root_cbf_bits", "skip_flag_bits",
                        "split_flag_bits")),
        ("iframe_dev", ("cbf_chroma_bits", "cbf_luma_bits", "chroma_dm_bits",
                        "part_size_2nx2n_bits", "part_size_nxn_bits",
                        "split_flag_bits")))
    for fn in fns)


def tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(tensor_bytes(v) for v in x)
    if isinstance(x, dict):
        return sum(tensor_bytes(v) for v in x.values())
    return 0


# the plain versions of the training path's kernels (K13, K9, K14-K16),
# as (item, module, function): none may run on the card's path
TRAIN_PLAIN_FUNCS = (
    ("K13", "hmtpu_torch.search.me", "integer_me_plain"),
    ("K9", "hmtpu_torch.search.me", "frac_refine_levels_plain"),
    ("K9", "hmtpu_torch.search.me", "frac_refine_batch_plain"),
    ("K14", "hmtpu_torch.models.train", "loss_fwd_plain"),
    ("K15", "hmtpu_torch.models.train", "loss_bwd_plain"),
    ("K15 + K16", "hmtpu_torch.models.train", "loss_bwd_adam_plain"),
    ("K16", "hmtpu_torch.models.train", "adam_update_plain"))


class PlainTally:
    """Wraps `funcs` ((item, module, function), PLAIN_FUNCS by default)
    while in use: calls and argument bytes per item.  The wrappers cost
    host time when they are called, so no timed encode runs under it."""

    def __init__(self, funcs=PLAIN_FUNCS):
        self.funcs = funcs
        self.calls, self.bytes, self._saved = {}, {}, []

    def __enter__(self):
        import importlib

        for item, mod, fn in self.funcs:
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


# K2, K17-K21, K23, K25 and K26 are held against their plain versions on inputs
# captured from the passes: (kernel, form (or a function of the call's arguments that
# gives it), module, wrapper as the pass calls it, the lanes of a call's
# arguments); Capture keeps, per form, the arguments of the call with the
# most lanes
CAPTURED = (
    # K2 as the P / B pass calls it per level lane: the intra candidate's
    # reference line filtered (8x8 luma), then predicted with the block's
    # mode (luma n = 8, chroma n = 4); one form per bit depth
    ("intra_filter", lambda a, k: f"bd{a[2]}",
     "hmtpu_torch.encoder.pframe_dev", "filter_reference_batched",
     lambda a, k: a[0].shape[0]),
    ("intra_pred", lambda a, k: f"n{a[3]} bd{a[5]}",
     "hmtpu_torch.encoder.pframe_dev", "predict_one_mode",
     lambda a, k: a[0].shape[0]),
    ("merge_cands", "P", "hmtpu_torch.encoder.pframe_dev",
     "merge_candidates_dev", lambda a, k: a[0].shape[0]),
    ("merge_cands", "B", "hmtpu_torch.encoder.pframe_dev",
     "merge_candidates_dev_b", lambda a, k: a[0].shape[0]),
    ("amvp_rd", "", "hmtpu_torch.encoder.pframe_dev", "amvp_rd",
     lambda a, k: a[2].shape[0]),
    ("mv_regularize", "P", "hmtpu_torch.search.me", "regularize_mv_field",
     lambda a, k: a[2].numel()),
    # K3's state form as the P / B and I passes call it: one form per
    # slice type, picture size, bit depth and (B) reference lists
    ("deblock", lambda a, k: deblock_form(a, k),
     "hmtpu_torch.encoder.pframe_dev", "deblock_state", lambda a, k: 1),
    ("deblock", lambda a, k: deblock_form(a, k),
     "hmtpu_torch.encoder.iframe_dev", "deblock_state", lambda a, k: 1),
    ("mpm_bits", "P", "hmtpu_torch.encoder.pframe_dev",
     "intra_mode_mpm_bits", lambda a, k: a[1].numel()),
    # K21 (and K22 inside it): one form per picture size, QP and TS
    ("i_walk", lambda a, k: f"{k['w']}x{k['h']} QP{a[3]}"
     + (" TS" if k.get("ts") else "")
     + (f" {k['bd']} bits" if k.get("bd", 8) != 8 else ""),
     "hmtpu_torch.encoder.iframe_dev",
     "iframe_pass", lambda a, k: 1),
    # K23 (and K24 inside it): the P pass, one form per picture size and
    # TS; the widest call is the one with the most temporal candidates
    # available.  K26: the B pass, one form per picture size and POC
    ("p_walk", lambda a, k: f"{k['w']}x{k['h']}"
     + (" TS" if k.get("ts") else "")
     + (f" B POC{a[10]}" if k.get("num_ref_l1", 0) else ""),
     "hmtpu_torch.encoder.pframe_dev", "wavefront_pass",
     lambda a, k: 1 + (int(k["col"][2].sum())
                       if k.get("col") is not None else 0)),
    # K1's TS mode: the P pass's TS hypothesis (ldp_dctif's 8 level, three
    # planes), its forward and its inverse, and the one-plane pair of
    # `_code_ts_sel` (the plain passes' calls on the card)
    ("transform_skip", lambda a, k: ("fwd" if len(a[0]) == 3 else
                                     "fwd one plane") if k.get("ts")
     else "no TS", "hmtpu_torch.encoder.pframe_dev", "fwd_level",
     lambda a, k: a[0][0].shape[0]),
    ("transform_skip", lambda a, k: "inv" if len(a[0]) == 3
     else "inv one plane", "hmtpu_torch.encoder.pframe_dev",
     "inv_level_ts", lambda a, k: a[0][0].shape[0]),
    # K9's levels form: every call its own form (the P / B passes of the
    # DCT-IF encodes)
    ("frac_refine", frac_form, "hmtpu_torch.search.me",
     "frac_refine_levels", lambda a, k: 1),
    # K25: the SAO choice of a frame's three planes
    ("sao_choose", lambda a, k: f"{a[6]}x{a[5]} CTUs",
     "hmtpu_torch.ops.sao", "choose_params", lambda a, k: 1),
    # K10: the P / B pass's coding step (`_code`), one form per TB size,
    # component, bit depth, trellis and SDH
    ("rdoq", lambda a, k: f"n{1 << a[2]} {'luma' if a[6] else 'chroma'} "
     f"bd{a[3]}" + (" trellis" if k.get("trellis", True) else " deadzone")
     + (" SDH" if k.get("sdh") else ""),
     "hmtpu_torch.encoder.pframe_dev", "rdoq_code",
     lambda a, k: a[0].numel() >> (2 * a[2])))


def deblock_form(a, k) -> str:
    """The form of a `deblock_state` call: "I", "P" or "B" (with its
    lists' POCs), the picture's size and bit depth."""
    kind = "I" if a[3] is None else ("B" if k.get("num_ref_l1") else "P")
    bd = a[5] if len(a) > 5 else k.get("bd", 8)
    return f"{kind} {k['w']}x{k['h']} {bd} bits" + (
        f" L0 {list(k['ref_pocs'])} L1 {list(k['ref_pocs_l1'])}"
        if kind == "B" else "")


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x


class Capture:
    """Wraps CAPTURED's functions while in use and keeps, per (kernel,
    form), a copy of the arguments of the widest call: `got[(kernel,
    form)] = (lanes, args, kwargs)`.  amvp_rd's form is "B" when the call
    names a list (lx), else "P".  The copies cost host time, so no timed
    encode runs under it."""

    def __init__(self, got=None):
        self.got, self._saved = ({} if got is None else got), []

    def __enter__(self):
        import importlib

        for name, form, mod, fn, lanes in CAPTURED:
            m = importlib.import_module(mod)
            inner = getattr(m, fn)

            def wrap(*a, _inner=inner, _name=name, _form=form, _lanes=lanes,
                     **k):
                f = _form(a, k) if callable(_form) else (
                    _form or ("B" if k.get("lx") is not None else "P"))
                n = _lanes(a, k)
                if n > self.got.get((_name, f), (-1,))[0]:
                    self.got[(_name, f)] = (n, _clone(a), _clone(k))
                return _inner(*a, **k)

            setattr(m, fn, wrap)
            self._saved.append((m, fn, inner))
        return self

    def __exit__(self, *exc):
        for m, fn, inner in reversed(self._saved):
            setattr(m, fn, inner)


def reg_work(refs, org, mvx, mvy, ridx, lam, iters):
    """Bytes K19's rounds must move: per round the original plane, the
    field in and out, and the distinct reference samples of the six
    candidates' 8x8 blocks (from the plain rounds on the same inputs); and
    its operations: per sample of each candidate a difference, an
    absolute value and a sum, and about 20 to price a candidate."""
    from hmtpu_torch.search import me

    r, h, w = refs.shape
    bh, bw = mvx.shape
    dev = refs.device
    ar8 = torch.arange(8, device=dev)
    y0 = (torch.arange(bh, device=dev) * 8)[:, None, None, None]
    x0 = (torch.arange(bw, device=dev) * 8)[None, :, None, None]
    nbytes, field = 0, (mvx, mvy, ridx)
    for _ in range(iters):
        cx, cy, cr = field
        cands = [(cx, cy, cr)] + [
            tuple(torch.roll(a, s, (0, 1)) for a in field)
            for s in ((0, 1), (0, -1), (1, 0), (-1, 0))] + [
            tuple(torch.zeros_like(a) for a in field)]
        seen = torch.zeros(r * h * w, dtype=torch.bool, device=dev)
        for qx, qy, qr in cands:
            yy = torch.clamp(y0 + qy[:, :, None, None] + ar8[:, None], 0,
                             h - 1)
            xx = torch.clamp(x0 + qx[:, :, None, None] + ar8[None, :], 0,
                             w - 1)
            seen[((qr[:, :, None, None].to(torch.int64) * h + yy) * w
                  + xx).reshape(-1)] = True
        nbytes += (int(seen.sum()) + h * w + 6 * bh * bw) * 4
        field = me.regularize_mv_field_plain(refs, org, *field, lam, 1)
    return nbytes, iters * bh * bw * 6 * (64 * 3 + 20)


def predict_one_mode_plain(ref_unfilt, ref_filt, mode, n, is_luma=True,
                           bit_depth=8):
    """predict_one_mode through K2's plain version."""
    from hmtpu_torch.ops import intra_pred

    return intra_pred.predict_modes_plain(ref_unfilt, ref_filt,
                                          mode[:, None], n, is_luma,
                                          bit_depth)[:, 0]


def captured_cases(got):
    """K2 and K17-K20 on the arguments Capture kept: the P forms from the
    plain P pass run on ldp's P frame on the card (timed), the B and
    10-bit forms from the untimed 416x240 RA Main10 encode (checked).  Bytes: each input the function needs
    read once and each output written once; operations: a count per lane
    of its integer steps."""
    from hmtpu_torch.encoder import pframe_dev as pf
    from hmtpu_torch.ops import intra_pred as ip
    from hmtpu_torch.ops import ratebits as rb
    from hmtpu_torch.search import me
    from hmtpu_torch.search import wavefront as wf

    need = (("intra_filter", "bd8"), ("intra_pred", "n8 bd8"),
            ("intra_pred", "n4 bd8"), ("merge_cands", "P"),
            ("merge_cands", "B"), ("amvp_rd", "P"),
            ("amvp_rd", "B"), ("mv_regularize", "P"), ("mpm_bits", "P"))
    missing = [k for k in need if k not in got]
    if missing:
        fail(f"capture: no call of {missing} in the untimed encodes")
    for key in need:
        print(f"capture: {key[0]} {key[1]} form, {got[key][0]} lanes",
              flush=True)

    def call(fn, key):
        _, a, k = got[key]
        return lambda: fn(*a, **k)

    def also(pairs):
        # forms checked beside the timed one, where the encodes made them
        return [(call(kf, key), call(pf_, key)) for kf, pf_, key in pairs
                if key in got]

    cases = []
    # K2: the P pass's 8x8 luma lines, read and written once, about 4
    # operations a sample; the prediction reads both lines and the mode
    # and writes the block, about 5 operations a sample.  The chroma 4x4
    # pair and the 10-bit forms checked
    _, a, k = got[("intra_filter", "bd8")]
    nl, line = a[0].shape
    cases.append((
        "intra_filter", call(ip.filter_reference_batched,
                             ("intra_filter", "bd8")),
        call(ip.filter_reference_plain, ("intra_filter", "bd8")),
        2 * nl * line * 4, 4 * nl * line, None,
        also([(ip.filter_reference_batched, ip.filter_reference_plain,
               ("intra_filter", "bd10"))])))
    _, a, k = got[("intra_pred", "n8 bd8")]
    nl, line = a[0].shape
    cases.append((
        "intra_pred", call(ip.predict_one_mode, ("intra_pred", "n8 bd8")),
        call(predict_one_mode_plain, ("intra_pred", "n8 bd8")),
        (2 * nl * line + nl + nl * 64) * 4, 5 * nl * 64, None,
        also([(ip.predict_one_mode, predict_one_mode_plain,
               ("intra_pred", f)) for f in ("n4 bd8", "n8 bd10",
                                            "n4 bd10")])))
    # K17: per lane 5 neighbour rows in, M candidates out; about 60
    # integer steps (P: the five prunings, six placements, the fill)
    _, a, k = got[("merge_cands", "P")]
    nb, mm = a[0].shape[0], a[5]
    cases.append((
        "merge_cands", call(wf.merge_candidates_dev, ("merge_cands", "P")),
        call(wf.merge_candidates_dev_plain, ("merge_cands", "P")),
        tensor_bytes(a) + tensor_bytes(k) + 3 * nb * mm * 4, 60 * nb, None,
        [(call(wf.merge_candidates_dev_b, ("merge_cands", "B")),
          call(wf.merge_candidates_dev_b_plain, ("merge_cands", "B")))]))
    # K18: the valid flags, the three state columns it reads (mvx, mvy,
    # ref), the lane's reference and MV, the temporal candidate, the POCs
    # and the contexts the P form reads (MVD's two, REF_PIC's first cMax,
    # two float32 each) in; 10 int32 and 2 float32 columns out; about 400
    # steps a lane (scaling five neighbours, the list, two mvd prices,
    # ref_idx)
    _, a, k = got[("amvp_rd", "P")]
    nbv, nbp, num_ref = a[1], a[2], a[8]
    nl = nbp.shape[0]
    na = k.get("n_active")
    cmax = 0 if num_ref <= 1 else (num_ref - 1 if na is None
                                   else max(na - 1, 0))
    amvp_bytes = tensor_bytes((nbv,) + tuple(a[3:])) + tensor_bytes(k) \
        + (2 + min(cmax, 2)) * 2 * 4 + nl * 5 * 3 * 4 + nl * 12 * 4
    cases.append((
        "amvp_rd", call(pf.amvp_rd, ("amvp_rd", "P")),
        call(pf.amvp_rd_plain, ("amvp_rd", "P")), amvp_bytes, 400 * nl,
        None, [(call(pf.amvp_rd, ("amvp_rd", "B")),
                call(pf.amvp_rd_plain, ("amvp_rd", "B")))]))
    # K19 (every round in one launch) on ldp's field: reg_work's bytes
    # and operations of its rounds; seeded fields at 416x240, 56x64 and
    # 8x16 (1 to 4 rounds) checked
    _, a, k = got[("mv_regularize", "P")]
    iters = k.get("iters", a[6] if len(a) > 6 else 3)
    dev = a[0].device
    more = []
    for (h_, w_), it in (((H, W), 3), ((56, 64), 1), ((56, 64), 2),
                         ((8, 16), 4)):
        sf = seeded_field(dev, h_, w_, seed=h_ + w_ + it, r=3)
        more.append((lambda sf=sf, it=it: me.regularize_mv_field(*sf, it),
                     lambda sf=sf, it=it: me.regularize_mv_field_plain(
                         *sf, it)))
    cases.append(reg_case("mv_regularize", *a[:6], iters, more))
    # K20: the modes and the neighbour pairs in, the bits out; about 20
    # steps a lane (the MPM list, three compares, one or two sums).  The P
    # pass's form is timed: the I pass prices its modes inside K21 now, so
    # K20's K-candidate and four-PU forms are checked on seeded modes at
    # that pass's width (7 CUs)
    _, a, k = got[("mpm_bits", "P")]
    n = a[1].numel()
    cb = a[0]
    rng = np.random.RandomState(20)
    pick = lambda shape: torch.as_tensor(rng.choice(
        [0, 1, 2, 10, 18, 26, 34], shape).astype(np.int32)).to(cb.device)
    modes, lm, am, m4 = pick((7, 2)), pick((7, 1)), pick((7, 1)), pick((7, 4))
    cases.append(("mpm_bits", call(rb.intra_mode_mpm_bits, ("mpm_bits", "P")),
                  call(rb.intra_mode_mpm_bits_plain, ("mpm_bits", "P")),
                  tensor_bytes(a[1:]) + n * 4 + 2 * 4, 20 * n, None,
                  [(lambda: rb.intra_mode_mpm_bits(cb, modes, lm, am),
                    lambda: rb.intra_mode_mpm_bits_plain(cb, modes, lm, am)),
                   (lambda: rb.intra_mode_mpm_bits_nxn(cb, m4, lm[:, 0],
                                                       am[:, 0]),
                    lambda: rb.intra_mode_mpm_bits_nxn_plain(
                        cb, m4, lm[:, 0], am[:, 0]))]))
    return cases


def deblock_cases(got):
    """K3's state form on the captured calls: ldp's P picture (timed,
    `deblock:state`), ldp's I picture, and every B picture of the ra10
    encode (two lists, bi-prediction; 10 bits), checked: check_kernels'
    cases."""
    from hmtpu_torch.ops import deblock

    forms = sorted(f for k_, f in got if k_ == "deblock")
    p_form, i_form = f"P {W}x{H} 8 bits", f"I {W}x{H} 8 bits"
    b_forms = [f for f in forms if f.startswith(f"B {W}x{H} 10 bits")]
    if p_form not in forms or i_form not in forms or len(b_forms) < 4:
        fail(f"capture: K3's state forms {forms}: no ldp P or I picture, "
             f"or fewer than 4 ra10 B pictures")
    print(f"capture: deblock state forms {forms}", flush=True)

    def call(fn, form):
        _, a, k = got[("deblock", form)]
        return lambda: fn(*a, **k)

    nb, ops = deblock_work(H, W, (H // 8) * (W // 8))
    more = [(call(deblock.deblock_state, f),
             call(deblock.deblock_state_plain, f))
            for f in forms if f != p_form]
    return [("deblock:state", call(deblock.deblock_state, p_form),
             call(deblock.deblock_state_plain, p_form), nb, ops, None,
             more)]


def walk_work(w, h, ts):
    """Bytes and operations of one K21 pass (all its levels): the source
    planes, the table, the gather maps, schedules and candidates it reads
    once, the state it writes once; operations per coded TB of side n
    (every candidate of every CU is coded, so the count follows the
    geometry): the transform and its inverse, 4 n^3 multiply-adds, and
    about 200 per coefficient for the RDOQ trellis, its pricing and the
    reconstruction."""
    from hmtpu_torch.encoder import iframe_dev as idv

    st = idv._i_static(w, h, 6)
    P, npx = (w // 8) * (h // 8), w * h * 3 // 2
    tables = sum(a.size for v in st.values() if v is not None
                 for a in (v if isinstance(v, tuple) else (v,)))
    nbytes = 4 * (npx + 2 * 186 + tables + 3 * P) + 4 * (npx + P * 104)
    tb = lambda n: 8 * n ** 3 + 200 * n * n
    ts2 = 2 if ts else 1
    cell = 2 * (tb(8) + 2 * ts2 * tb(4)) + 4 * ts2 * tb(4) + 2 * ts2 * tb(4)
    ops = P * cell
    if st["sched16"] is not None:
        ops += (P // 4) * 2 * (tb(16) + 2 * tb(8))
    if st["sched32"] is not None:
        ops += (P // 16) * 2 * (tb(32) + 2 * tb(16))
    return nbytes, ops


def walk_cases(got):
    """K21 on the I passes Capture kept (the 416x240 ai frame, the ldp
    phase's I frame, a 64x64 frame with the 32 level, the rext phase's
    first frame at 10 bits) against
    `iframe_pass_plain` on the card, and K22 against `rmd_plain` at each
    block size on their planes: (name, label, kernel call, plain call,
    bytes, operations).  The first case of each kernel is its row."""
    from hmtpu_torch.common.lambdas import frame_lambdas
    from hmtpu_torch.encoder import iframe_dev as idv
    from hmtpu_torch.encoder.intra_rdo import rmd, rmd_plain

    rext = [f for k, f in got if k == "i_walk" and f.startswith(f"{W}x{H}")
            and f.endswith(" TS 10 bits")]
    forms = (f"{W}x{H} QP{QP_AI} TS", f"{W}x{H} QP{QP_LDP}", "64x64 QP32",
             *rext[:1])
    missing = [f for f in forms if ("i_walk", f) not in got] \
        + ([] if rext else ["the rext frame"])
    if missing:
        fail(f"capture: no I pass of {missing} in the untimed encodes "
             f"(got {sorted(f for k, f in got if k == 'i_walk')})")
    cases = []
    for f in forms:
        _, a, k = got[("i_walk", f)]
        state = lambda d: tuple(d[x] for x in sorted(d))
        cases.append((
            "i_walk", f, lambda a=a, k=k: state(idv.iframe_pass(*a, **k)),
            lambda a=a, k=k: state(idv.iframe_pass_plain(*a, **k)),
            *walk_work(k["w"], k["h"], k.get("ts", False))))
    # K22: the I pass's forms at 416x240 (n = 8, 4, 16) and 64x64 (n = 32),
    # and the P pass's (n = 8, k = 1, no strong smoothing)
    for f, n, k, sis in ((forms[0], 8, 2, True), (forms[0], 4, 1, True),
                         (forms[0], 16, 2, True), (forms[2], 32, 2, True),
                         (forms[1], 8, 1, False)):
        _, a, kw = got[("i_walk", f)]
        plane, qp, qpc = a[0], a[3], a[4]
        hh, ww = plane.shape
        sd = idv._dev_static(ww, hh, 6, plane.device)
        g = sd["g4l" if n == 4 else f"g{n}"]
        args = dict(bd=kw.get("bd", 8), sis=sis, lam_sqrt=frame_lambdas(
            qp, qpc, kw.get("qp_factor", 0.57))[1])
        nb = (hh // n) * (ww // n)
        cases.append((
            "i_rmd", f"{ww}x{hh} n={n} k={k}"
            + ("" if sis else " (P pass)"),
            lambda p=plane, g=g, n=n, k=k, args=args: rmd(p, g, n, k, **args),
            lambda p=plane, g=g, n=n, k=k, args=args: rmd_plain(
                p, g, n, k, **args),
            4 * (hh * ww + nb * (4 * n + 2 + k)), 35 * nb * n * n * 20))
    return cases


P_FORMS = (f"{W}x{H}", f"{W}x{H} TS", "64x56", "64x64")


def rdoq_forms(got) -> None:
    """K10 against its plain version at every form of the coding step
    that the encodes captured (the widest call of each): levels,
    dequantised values and TB rates, bit for bit."""
    from hmtpu_torch.ops import quant, ratebits, rdoq

    forms = sorted(f for k, f in got if k == "rdoq")
    if not forms:
        fail("capture: no call of K10's coding step in the untimed encodes")
    for f in forms:
        nb, a, k = got[("rdoq", f)]
        coef, qp, log2, bd, lam, cb, luma = a[:7]
        sdh = k.get("sdh", False)
        out = rdoq.rdoq_code(*a, **k)
        lev = rdoq.rdoq_tb_plain(coef, qp, log2, bd, lam, cb, luma, 0, sdh,
                                 k.get("scan_sel"), k.get("trellis", True))
        want = (lev, quant.dequantize_t_plain(lev, qp, log2, bd),
                ratebits.tb_bits_plain(lev, cb, log2, luma, 0, sdh))
        torch.cuda.synchronize()
        if not same(out, want):
            fail(f"rdoq ({f}): kernel disagrees with its plain version "
                 f"(max abs err {max_err(out, want)})")
        print(f"kernel rdoq (captured {f}, {nb} TBs): equal to plain",
              flush=True)


def edge_checks(dev) -> None:
    """K10 on the contents that reach the coder's edges
    (tests/test_torch_rdoq_lanes.py `contents`) at every TB size, both
    components, trellis or deadzone, SDH on and off, 8 and 10 bits; K22 at
    each of its forms on a flat plane (every mode ties) and on 16x16
    steps (ties among some modes), 416x240 at 8 and 10 bits; each equal
    to its plain version."""
    from tests.test_torch_rdoq_lanes import QP, _batch, _lam

    from hmtpu_torch.common.constants import SliceType
    from hmtpu_torch.encoder import iframe_dev as idv
    from hmtpu_torch.encoder.intra_rdo import rmd, rmd_plain
    from hmtpu_torch.entropy.contexts import make_contexts
    from hmtpu_torch.entropy.fracbits import ctx_bits_table
    from hmtpu_torch.ops import quant, ratebits, rdoq

    cb = torch.as_tensor(ctx_bits_table(make_contexts(SliceType.P, QP))
                         .reshape(-1)).to(dev)
    rng = np.random.RandomState(12)
    n_cases = 0
    for log2 in (2, 3, 4, 5):
        for bd in (8, 10):
            coef, _ = _batch(log2, bd, 17 * log2 + bd)
            coef = coef.to(dev)
            sel = torch.as_tensor(rng.randint(0, 3, coef.shape[0])
                                  .astype(np.int32)).to(dev) \
                if log2 <= 3 else None
            for luma in (True, False):
                lam = torch.tensor(_lam(luma), device=dev)
                for trellis in (True, False):
                    for sdh in (True, False):
                        out = rdoq.rdoq_code(coef, QP, log2, bd, lam, cb,
                                             luma, sdh=sdh, scan_sel=sel,
                                             trellis=trellis)
                        lev = rdoq.rdoq_tb_plain(coef, QP, log2, bd, lam,
                                                 cb, luma, 0, sdh, sel,
                                                 trellis)
                        want = (lev, quant.dequantize_t_plain(
                            lev, QP, log2, bd), ratebits.tb_bits_plain(
                            lev, cb, log2, luma, 0, sdh))
                        torch.cuda.synchronize()
                        if not same(out, want):
                            fail(f"rdoq: kernel disagrees with its plain "
                                 f"version on the edge contents (n "
                                 f"{1 << log2}, {bd} bits, luma {luma}, "
                                 f"trellis {trellis}, SDH {sdh})")
                        n_cases += 1
    print(f"kernel rdoq: equal to plain on the edge contents ({n_cases} "
          f"forms)", flush=True)
    n_cases = 0
    for bd in (8, 10):
        flat = torch.full((H, W), 1 << (bd - 1), dtype=torch.int32)
        steps = torch.as_tensor((np.kron(rng.randint(0, 4, (H // 16, W // 16)),
                                         np.ones((16, 16), int))
                                 * (40 << (bd - 8))).astype(np.int32))
        for plane in (flat.to(dev), steps.to(dev)):
            # 416x240 (n = 8, 4, 16, the P pass's n = 8), 64x64 (n = 32)
            for n, k, sis in ((8, 2, True), (4, 1, True), (16, 2, True),
                              (32, 2, True), (8, 1, False)):
                p = plane[:64, :64].contiguous() if n == 32 else plane
                hh, ww = p.shape
                g = idv._dev_static(ww, hh, 6, dev)[
                    "g4l" if n == 4 else f"g{n}"]
                kw = dict(bd=bd, lam_sqrt=np.float32(5.7), sis=sis)
                out = rmd(p, g, n, k, **kw)
                want = rmd_plain(p, g, n, k, **kw)
                torch.cuda.synchronize()
                if not same(out, want):
                    fail(f"i_rmd: kernel disagrees with its plain version "
                         f"on a flat or stepped plane (n {n}, k {k}, {bd} "
                         f"bits)")
                n_cases += 1
    print(f"kernel i_rmd: equal to plain on flat and stepped planes "
          f"({n_cases} forms)", flush=True)


def pwalk_work(a, k, st):
    """Bytes and operations of one K23 or K26 pass (all its levels), from
    its arguments and its state: the source planes, the reference stack,
    the per-grid AMVP hypotheses (and, in a B slice, their lists),
    schedules and tables read once, the state written once; operations
    per coded TB of side n as walk_work's, per predicted block 2 x taps
    multiply-adds a sample in each direction.  Counted: in a P slice
    (K23) every CU trial's merge candidates (predicted), its two
    finalists (deadzone-coded) and its winner (recoded); in a B slice
    (K26) one luma hypothesis of every merge candidate (a bi candidate's
    second is not known from the state), the winner's exact prediction
    and its one coding; and the intra coding of the cells that chose
    intra (the cells that priced intra without choosing it are not known
    from the state: left out, so the bound stays a least time)."""
    from hmtpu_torch.encoder import pframe_dev as pf

    w, h, m = k["w"], k["h"], k["max_merge"]
    P, npx = (w // 8) * (h // 8), w * h * 3 // 2
    nref, is_b = a[3].shape[0], k.get("num_ref_l1", 0) > 0
    sd = pf._p_static(w, h, 6)
    tables = sum(np.asarray(a).size for v in sd.values() if v is not None
                 for a in (v if isinstance(v, tuple) else (v,)))
    per = 11 if is_b else 10
    grids = P * (1 + 96 + 96 + per)
    if sd["sched32"] is not None:
        grids += (P // 4) * (384 + 384 + per) \
            + (P // 16) * (1536 + 1536 + per)
    nbytes = 4 * (npx * (1 + nref) + tables + grids) \
        + 4 * (npx + P * (14 + 96 + 1))
    tb = lambda n: 8 * n ** 3 + 200 * n * n
    mc = lambda n: 2 * (16 * n * n) + 2 * 2 * (8 * (n // 2) ** 2)
    ts2 = 2 if k.get("ts") else 1
    if is_b:
        trial = lambda n, c: m * 2 * (16 * n * n) + mc(n) + tb(n) \
            + 2 * tb(n // 2)
    else:
        trial = lambda n, c: m * mc(n) + 2 * (tb(n) + 2 * tb(n // 2)) \
            + tb(n) + 2 * c * tb(n // 2)
    kind = st["blk"][:, pf.K_KIND].cpu().numpy()
    ops = P * trial(8, ts2) + int((kind == 3).sum()) * (tb(8) + 2 * ts2
                                                        * tb(4))
    if sd["sched32"] is not None:
        ops += (P // 4) * trial(16, 1) \
            + int(sd["sched32"][5].sum()) * trial(32, 1)
    return nbytes, ops


def pwalk_cases(got):
    """K23 on the P passes Capture kept (ldp's and ldp_dctif's P frames at
    416x240, a 64x56 frame of geometry 8 and a 64x64 one) against
    `wavefront_pass_plain` on the card: (name, label, kernel call, plain
    call, bytes, operations); the first is its row."""
    from hmtpu_torch.encoder import pframe_dev as pf

    missing = [f for f in P_FORMS if ("p_walk", f) not in got]
    if missing:
        fail(f"capture: no P pass of {missing} in the untimed encodes "
             f"(got {sorted(f for k, f in got if k == 'p_walk')})")
    cases = []
    for f in P_FORMS:
        _, a, k = got[("p_walk", f)]
        state = lambda d: tuple(d[x] for x in sorted(d))
        st = pf.wavefront_pass(*a, **k)
        cases.append((
            "p_walk", f"{f} QP{k['qp']}", lambda a=a, k=k: state(pf.wavefront_pass(*a, **k)),
            lambda a=a, k=k: state(pf.wavefront_pass_plain(*a, **k)),
            *pwalk_work(a, k, st)))
    return cases


# K26's forms: the ra10 phase's 8 B frames (the first is its row), POC 8
# (one reference a list) and POC 2 (three) of 64x64 and 64x56 8-bit RA
# encodes (geometry 32 and 8)
B_FORMS = tuple(f"{W}x{H} B POC{p}" for p in (8, 4, 2, 1, 3, 6, 5, 7)) \
    + tuple(f"{s} B POC{p}" for s in ("64x64", "64x56") for p in (8, 2))


def bwalk_cases(got):
    """K26 on the B passes Capture kept (B_FORMS) against
    `wavefront_pass_plain` on the card: (name, label, kernel call, plain
    call, bytes, operations); the first is its row."""
    from hmtpu_torch.encoder import pframe_dev as pf

    missing = [f for f in B_FORMS if ("p_walk", f) not in got]
    if missing:
        fail(f"capture: no B pass of {missing} in the untimed encodes "
             f"(got {sorted(f for k, f in got if k == 'p_walk')})")
    cases = []
    for f in B_FORMS:
        _, a, k = got[("p_walk", f)]
        state = lambda d: tuple(d[x] for x in sorted(d))
        st = pf.wavefront_pass(*a, **k)
        cases.append((
            "b_walk", f"{f} QP{k['qp']} {k['bd']} bits",
            lambda a=a, k=k: state(pf.wavefront_pass(*a, **k)),
            lambda a=a, k=k: state(pf.wavefront_pass_plain(*a, **k)),
            *pwalk_work(a, k, st)))
    return cases


def p_kernel_cases(got, dev):
    """K24 on the three CU grids of ldp's P frame (timed on the 8 grid;
    its collocated field is the I frame's, which has no motion, so the
    grids are checked again on seeded fields at the same shapes) and in
    its grids form (the three grids in one launch, timed,
    `tmvp_grid:levels`; the seeded field checked), K25 on
    the ldp frames' statistics (luma and the Cb / Cr pair): check_kernels'
    cases."""
    from hmtpu_torch.encoder import pframe_dev as pf
    from hmtpu_torch.ops import sao

    _, a, k = got[("p_walk", P_FORMS[0])]
    w, h, col, col_poc = k["w"], k["h"], k["col"], k["col_poc"]
    pocs = torch.tensor(list(a[9]), dtype=torch.int32, device=dev)
    bw, bh = w // 8, h // 8
    gw, gh = w // 16, h // 16
    grids = ((8, a[8].reshape(-1), bw, bh),
             (16, k["mv16"][2].reshape(-1), gw, gh),
             (32, k["mv32"][2].reshape(-1), (gw + 1) // 2, (gh + 1) // 2))
    rng = np.random.RandomState(24)
    seeded = tuple(torch.as_tensor(x).to(dev) for x in (
        rng.randint(-300, 301, (bh, bw)).astype(np.int32),
        rng.randint(-300, 301, (bh, bw)).astype(np.int32),
        rng.rand(bh, bw) < 0.7,
        (a[10] - 1 - rng.choice([0, 1, 2, 200, -150], (bh, bw)))
        .astype(np.int32)))

    def grid(fn, c, n, aref, gw_, gh_):
        return lambda: fn(c, col_poc if c is col else a[10] - 1, n, aref,
                          pocs, a[10], w=w, h=h, log2_ctu=6, gw=gw_, gh=gh_)

    n, aref, gw8, gh8 = grids[0]
    more = [(grid(pf.tmvp_grid, c, *g), grid(pf.tmvp_grid_plain, c, *g))
            for c in (col, seeded) for g in grids][1:]
    # per block: two collocated rows (4 ints each), the reference and
    # its POC in; 5 ints out; about 40 integer steps
    nb = gw8 * gh8
    cases = [("tmvp_grid", grid(pf.tmvp_grid, col, *grids[0]),
              grid(pf.tmvp_grid_plain, col, *grids[0]),
              4 * (4 * bw * bh + nb + pocs.numel() + 5 * nb), 40 * nb, None,
              more)]
    # the grids form: the pass's three grids in one launch, as
    # pframe_walk calls it (timed), and on the seeded field (checked)
    def grids_of(fn, c):
        gl = [(n_, aref_, gw_, gh_) for n_, aref_, gw_, gh_ in grids]
        return lambda: fn(c, col_poc if c is col else a[10] - 1, gl, pocs,
                          a[10], w=w, h=h, log2_ctu=6)

    nall = sum(g[2] * g[3] for g in grids)
    cases.append(("tmvp_grid:levels", grids_of(pf.tmvp_grids, col),
                  grids_of(pf.tmvp_grids_plain, col),
                  4 * (4 * bw * bh + nall + pocs.numel() + 5 * nall),
                  40 * nall, None,
                  [(grids_of(pf.tmvp_grids, seeded),
                    grids_of(pf.tmvp_grids_plain, seeded))]))
    # K25: per CTU three rows of 96 ints in, 21 out; per plane 48 offset
    # choices of about 12 operations, 29 band runs of 3 and the picks
    if ("sao_choose", f"{-(-w // 64)}x{-(-h // 64)} CTUs") not in got:
        fail(f"capture: no SAO choice in the untimed ldp encode (got "
             f"{sorted(f for k_, f in got if k_ == 'sao_choose')})")
    _, sa, sk = got[("sao_choose", f"{-(-w // 64)}x{-(-h // 64)} CTUs")]
    nctu = sa[5] * sa[6]
    cases.append(("sao_choose", lambda: sao.choose_params(*sa, **sk),
                  lambda: sao.choose_params_plain(*sa, **sk),
                  4 * (3 * 96 + 21) * nctu + 4, 3 * 700 * nctu, None))
    # and on seeded rows of a 1920x1080 frame's 510 CTUs (counts of 0, 1
    # and many samples, sums of both signs), ldp's lambda
    ny, nx = -(-1080 // 64), -(-1920 // 64)
    rows = []
    for _ in range(3):
        cnt = rng.choice([0, 1, 5, 60, 900], (ny * nx, 48))
        sm = (rng.randint(-12, 13, cnt.shape) * cnt) // 3
        r = np.empty((ny * nx, 96), np.int32)
        r[:, 0:16], r[:, 16:32] = sm[:, :16], cnt[:, :16]
        r[:, 32:64], r[:, 64:96] = sm[:, 16:], cnt[:, 16:]
        rows.append(torch.as_tensor(r).to(dev))
    hd = (*rows, sa[3], sa[4], ny, nx)
    cases.append(("sao_choose:1080p", lambda: sao.choose_params(*hd),
                  lambda: sao.choose_params_plain(*hd),
                  4 * (3 * 96 + 21) * ny * nx + 4, 3 * 700 * ny * nx, None))
    return cases


def check_walk(cases, rows, time_all=True) -> None:
    """Each case's kernel against its plain version on the card (equal),
    timed: the kernel over a few calls (only the first case of a kernel
    unless time_all), the plain version once (a 416x240 plain I pass
    takes seconds); the first case of a kernel gives its row."""
    from hmtpu_torch import kernels

    for name, label, kfn, pfn, nbytes, ops in cases:
        got = kfn()
        torch.cuda.synchronize()
        t0 = time.time()
        want = pfn()
        torch.cuda.synchronize()
        pms = (time.time() - t0) * 1e3
        err = max_err(got, want)
        if not same(got, want):
            fail(f"{name} ({label}): kernel disagrees with its plain version "
                 f"(max abs err {err})")
        if name in rows and not time_all:
            print(f"kernel {name} ({label}): equal to plain (plain {pms:.4f} "
                  f"ms, once)", flush=True)
            continue
        iters = 3 if name in ("i_walk", "p_walk", "b_walk") else 50
        ms = time_cuda(kfn, iters, warm=1)
        dms = device_ms(kfn, DEVICE_FN[name], iters=iters)
        bms, by = bound_ms(nbytes, ops)
        print(f"kernel {name} ({label}): equal to plain; {ms:.4f} ms per "
              f"call, {dms:.4f} ms on the device (plain {pms:.4f} ms, once; "
              f"bound {bms:.6f} ms by {by})", flush=True)
        if name not in rows:
            src, repl = kernels.KERNELS[name]
            rows[name] = dict(
                name=name, route="cuda", source=f"hmtpu_torch/csrc/{src}.cu",
                replaces=repl, launches=0, max_abs_err=err, ms=ms,
                plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=None,
                device_ms=dms)


# the kernels whose ptxas figures the build prints: (kernel, source,
# kernel function): K1's level forms, K6, K10, K22, the walkers, K5,
# K13, K14, K15, K4, K7, K11, K8, K25, K3, K19, K9 and K24
PTXAS = (("K1 fwd_level", "transform", "fwd_level_kernel"),
         ("K1 inv_level", "transform", "inv_level_kernel"),
         ("K6 nnfme", "nnfme", "nnfme_kernel"),
         ("K10 rdoq", "rdoq", "rdoq_kernel"),
         ("K22 i_rmd", "i_rmd", "rmd_kernel"),
         ("K21 i_walk", "iwalk", "iwalk_kernel"),
         ("K23 p_walk", "pwalk", "pwalk_kernel"),
         ("K26 b_walk", "bwalk", "bwalk_kernel"),
         ("K5 me_sad, 8 bits", "me_sad", "me_kernelILi4"),
         ("K5 me_sad, 10 bits", "me_sad", "me_kernelILi2"),
         ("K5 me_sad, stencils", "me_sad", "me_out_kernel"),
         ("K13 me_sad1, 8 bits", "me_sad", "me1_kernelILi4"),
         ("K13 me_sad1, 10 bits", "me_sad", "me1_kernelILi2"),
         ("K13 me_sad1, stencils", "me_sad", "me1_out_kernel"),
         ("K14 nnfme_fwd", "nnfme_train", "nnfme_fwd_kernel"),
         ("K15 nnfme_bwd", "nnfme_train", "nnfme_bwd_kernel"),
         ("K4 sao_stats", "sao", "stats_kernel"),
         ("K4 sao_apply", "sao", "apply_kernel"),
         ("K7 mc_dctif", "mc_dctif", "mc_kernelILb0"),
         ("K11 mc_dctif_i", "mc_dctif", "mc_kernelILb1"),
         ("K8 satd8", "satd", "satd_kernel"),
         ("K8 satd8, gate", "satd", "satd_gate_kernel"),
         ("K25 sao_choose", "sao_choose", "sao_choose_kernel"),
         ("K3 deblock, state form", "deblock", "deblock_kernelIN2db8StateSrc"),
         ("K3 deblock, map form", "deblock", "deblock_kernelIN2db6MapSrc"),
         ("K19 mv_regularize", "mv_regularize", "reg_kernel"),
         ("K9 frac_refine, 8x8", "frac_refine", "frac_kernelILi8E"),
         ("K9 frac_refine, 16x16", "frac_refine", "frac_kernelILi16E"),
         ("K9 frac_refine, 32x32", "frac_refine", "frac_kernelILi32E"),
         ("K9 frac_refine, levels", "frac_refine", "frac_levels_kernel"),
         ("K24 tmvp_grid", "tmvp", "tmvp_grids_kernel"))
# of those, the kernels that must build with no stack frame and no spills
PTXAS_CLEAN = ("K3 deblock, state form", "K3 deblock, map form",
               "K19 mv_regularize", "K9 frac_refine, 8x8",
               "K9 frac_refine, 16x16", "K9 frac_refine, 32x32",
               "K9 frac_refine, levels", "K24 tmvp_grid", "K1 fwd_level",
               "K1 inv_level", "K15 nnfme_bwd")


def ptxas_figures(log: str, fn: str) -> str:
    """Registers, stack frame and spills of kernel function `fn` from
    nvcc's -Xptxas -v output (its entry function's lines), and the spill
    bytes of every function of the source (the called functions' too)."""
    import re

    lines = log.splitlines()
    at = [i for i, ln in enumerate(lines)
          if "Compiling entry function" in ln and fn in ln]
    if not at:
        return "no ptxas output (no build log beside the library)"
    frame = used = ""
    for ln in lines[at[0] + 1:at[0] + 6]:
        if "stack frame" in ln and not frame:
            frame = ln.strip()
        if "Used" in ln and "registers" in ln and not used:
            used = ln.split(":", 1)[-1].strip()
    st = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores", log))
    ld = sum(int(v) for v in re.findall(r"(\d+) bytes spill loads", log))
    return (f"{used}; {frame}; every function of the source: {st} bytes "
            f"spill stores, {ld} bytes spill loads")


def load_script(name: str):
    """A module of the repo's scripts/ directory."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same(a, b) -> bool:
    """Equal shapes, dtypes and values (floats bit for bit; None only
    where both are)."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def max_err(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(max_err(x, y) for x, y in zip(a, b))
    if a is None or b is None or a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def encode(frames, qp, device, gop="ai", srange=16, subpel=None,
           ts=False, bd=8, nn_dir=None):
    """8-bit frames through Encoder; at bd 10 as 10-bit samples (<< 2);
    NN-FME weights from nn_dir when given, else the port's own."""
    from hmtpu_torch.encoder.top import Encoder, EncoderConfig
    from hmtpu_torch.io.yuv import Frame

    h, w = frames[0][0].shape
    if subpel is None:
        subpel = "nn" if gop == "ldp" else "none"
    cfg = EncoderConfig(width=w, height=h, qp=qp, gop=gop, subpel=subpel,
                        search_range=srange, transform_skip=ts, bit_depth=bd,
                        nn_weights_dir=nn_dir)
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
    sub-pel, transform skip, bit depth, NN-FME weights directory), or
    ("cli", args) for the CLI; or ("records", clip, qp, search range):
    the extracted records and seconds; or ("track", rows, steps): the
    losses of the trainer's first steps and seconds."""
    torch.set_num_threads(CPU_THREADS)
    t0 = time.time()
    if job[0] == "cli":
        return cli_encode(job[1], "cpu")[:2]
    if job[0] == "records":
        from hmtpu_torch.models import dataset

        _, clip, qp, sr = job
        return (dataset.extract_clip(frames_of(clip), qp, sr, device="cpu"),
                time.time() - t0)
    if job[0] == "track":
        # the port's init from seed 0 for TRACK_EPOCHS epochs: the same
        # first batches as the trainer's run
        from hmtpu_torch.models import train

        losses = []
        train.train(*job[1], epochs=TRACK_EPOCHS, batch_size=TRAIN_BATCH,
                    device="cpu", losses=losses)
        return [float(x) for x in losses[:job[2]]], time.time() - t0
    return encode(job[0], job[1], "cpu", *job[2:])[:2]


def train_steps(n_rows) -> int:
    """`train`'s steps over n_rows records at the trainer's defaults."""
    n_tr = n_rows - max(1, int(n_rows * 0.2))
    return TRAIN_EPOCHS * -(-n_tr // TRAIN_BATCH)


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


def kernel_of(row: str) -> str:
    """The kernel of a row: `name` or `name:form` (a kernel's other form
    or size, timed in a row of its own)."""
    return row.split(":")[0]


def check_kernels(cases, rows) -> None:
    """Each case's kernel against its plain version (equal), timed beside
    its plain version, its bound and its library call; adds its row to
    `rows` (launches 0: the main path's run fills them)."""
    from hmtpu_torch import kernels

    for name, kfn, pfn, nbytes, ops, lib, *more in cases:
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
                w0 = w2
                while isinstance(w0, (tuple, list)):
                    w0 = w0[0]
                fail(f"{name}: kernel disagrees with its plain version at "
                     f"shape {tuple(w0.shape)} (max abs err {err})")
        ms = time_cuda(kfn, 200)
        pms = time_cuda(pfn, 5)
        lms = time_cuda(lib, 200) if lib is not None else None
        dms = device_ms(kfn, DEVICE_FN[kernel_of(name)])
        bms, by = bound_ms(nbytes, ops)
        k = kernel_of(name)
        src, repl = kernels.KERNELS[k] if k in kernels.KERNELS \
            else INSIDE[k][:2]
        rows[name] = dict(
            name=name, route="cuda", source=f"hmtpu_torch/csrc/{src}.cu",
            replaces=repl, launches=0, max_abs_err=err,
            ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
            library_ms=lms, device_ms=dms)
        if k in INSIDE:
            rows[name]["inside"] = INSIDE[k][2]
        print(f"kernel {name}: equal to plain; {ms:.4f} ms per call, "
              f"{dms:.4f} ms on the device (plain {pms:.4f} ms, bound "
              f"{bms:.6f} ms by {by}"
              + (f", library call {lms:.4f} ms" if lms else "")
              + ")", flush=True)


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

    # ---- 2. build (and beside it K23's and K21's phase-clock builds,
    # scripts/pwalk_phases.py and iwalk_phases.py, never the encode path's)
    t0 = time.time()
    phases = load_script("pwalk_phases")
    iphases = load_script("iwalk_phases")
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        ph_job = ex.submit(phases.build_phase_lib)
        iph_job = ex.submit(phases.build_phase_lib, "iwalk")
        logs = kernels.build_all()
        ph_lib, ph_log = ph_job.result()
        iph_lib, iph_log = iph_job.result()
    print(f"build: {len(logs)} sources and K23's and K21's phase builds in "
          f"{time.time() - t0:.1f} s", flush=True)
    for src, log in list(logs.items()) + [("pwalk (phases)", ph_log),
                                          ("iwalk (phases)", iph_log)]:
        for ln in log.strip().splitlines():
            print(f"  nvcc {src}: {ln}", flush=True)
    for name, src, fn in PTXAS:
        fig = ptxas_figures(logs[src], fn)
        print(f"ptxas {name} ({fn}): {fig}", flush=True)
        if name in PTXAS_CLEAN and not (
                "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                "loads" in fig and "every function of the source: 0 bytes "
                "spill stores, 0 bytes spill loads" in fig):
            fail(f"ptxas {name}: a stack frame or spills ({fig})")

    # ---- 3. kernels against their plain versions
    rows = {}
    check_kernels(kernel_cases(dev), rows)
    edge_checks(dev)

    clip = synth_clip(W, H, LDP_FRAMES, seed=42)
    small = synth_clip(64, 64, 4, seed=3)
    encode(small[:1], QP_AI, dev)        # warm-up: libraries, allocator

    # ---- 4. the main path: low-delay P with NN-FME
    ldp_names = [k for k in kernels.KERNELS
                 if k not in ("frac_refine", "mc_dctif_i", "bi_pred",
                              "b_walk") + P_INSIDE_K23 + TRAIN_KERNELS]
    (bs, dt, results), counts, util = run_counted(
        "ldp", lambda: encode(clip, QP_LDP, dev, "ldp", SRANGE),
        ldp_names, kernels)
    for name in rows:
        # K16 and K1's TS mode run inside K15's and K1's launches
        rows[name]["launches"] = counts.get(kernel_of(name), 0)
    check_results(results, "ldp")
    # K4 and K25 a frame, K7 a P pass, from the launch counters
    n_p = LDP_FRAMES - 1
    sao_n = [counts[k] for k in ("sao_stats", "sao_choose", "sao_apply")]
    print(f"ldp: SAO launches a frame {sum(sao_n) / LDP_FRAMES:g} (K4 "
          f"statistics {sao_n[0]}, K25 {sao_n[1]}, K4 apply {sao_n[2]} for "
          f"{LDP_FRAMES} frames); K7 launches a P pass "
          f"{counts['mc_dctif'] / n_p:g} ({counts['mc_dctif']} for {n_p})",
          flush=True)
    print(f"ldp: K8 launches a P pass {counts['satd8'] / n_p:g} (the "
          f"NN-FME gate's three levels in one)", flush=True)
    if sao_n != [LDP_FRAMES] * 3 or counts["mc_dctif"] > 6 * n_p \
            or counts["satd8"] != n_p:
        fail(f"ldp: {sao_n} SAO launches (K4, K25, K4) for {LDP_FRAMES} "
             f"frames, {counts['mc_dctif']} K7 and {counts['satd8']} K8 "
             f"launches for {n_p} P passes")
    # K6 once a P pass (the three levels' offsets), K1's level forms
    # once a level and direction (the hypotheses' coding step)
    k1 = [counts[k] for k in ("int_transform_fwd", "int_transform_inv")]
    if counts["nnfme"] != n_p or max(k1) > 3 * n_p:
        fail(f"ldp: {counts['nnfme']} K6 and {k1} K1 launches (forward, "
             f"inverse) for {n_p} P passes")
    # K3 once a picture (its state form), K19 once a P pass (every
    # round in one launch), K24 once a P pass (the three grids)
    if counts["deblock"] != LDP_FRAMES or counts["mv_regularize"] != n_p \
            or counts["tmvp_grid"] != n_p:
        fail(f"ldp: {counts['deblock']} K3 launches for {LDP_FRAMES} "
             f"pictures, {counts['mv_regularize']} K19 and "
             f"{counts['tmvp_grid']} K24 launches for {n_p} P passes")
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
                   if k not in ("nnfme", "satd8", "mc_dctif_i", "bi_pred",
                                "b_walk") + P_INSIDE_K23 + TRAIN_KERNELS]
    pframe_dev.DBG_COUNTERS["ldp_ts_tbs"] = 0
    (d_bs, d_dt, d_enc), d_counts, d_util = run_counted(
        "ldp_dctif", lambda: cli_encode(
            ["-c", LDP_CFG, "--SubPel=dctif", "-q", str(QP_LDP), "-f",
             str(LDP_FRAMES), *size, "-b",
             os.path.join(tmp.name, "ldp_dctif.hevc")], dev),
        dctif_names, kernels)
    rows["frac_refine"]["launches"] = d_counts["frac_refine"]
    # K9 once a P pass (the three levels in one launch); K1's level forms
    # once a level each way, the 8 level's in their TS mode (the pair
    # coded and picked inside: K1-TS has no launch of its own)
    if d_counts["frac_refine"] != n_p:
        fail(f"ldp_dctif: {d_counts['frac_refine']} K9 launches for {n_p} "
             f"P passes")
    d_k1 = [d_counts[k] for k in ("int_transform_fwd", "int_transform_inv")]
    print(f"ldp_dctif: K1 level-form launches a P pass {d_k1[0] / n_p:g} "
          f"forward, {d_k1[1] / n_p:g} inverse (the TS pair's among them), "
          f"no transform_skip launch: "
          f"{'transform_skip' not in kernels.COUNTS}", flush=True)
    if d_k1 != [3 * n_p] * 2 or "transform_skip" in kernels.COUNTS:
        fail(f"ldp_dctif: {d_k1} K1 level-form launches (forward, inverse) "
             f"for {n_p} P passes, or a transform_skip counter")
    if d_counts["satd8"]:
        fail(f"ldp_dctif: {d_counts['satd8']} K8 launches (the DCT-IF "
             f"search has no NN-FME gate)")
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
                if k not in ("nnfme", "satd8", "mv_regularize", "p_walk",
                             "tmvp_grid")
                + B_INSIDE_K26 + TRAIN_KERNELS]
    ra_args = ["-c", RA_CFG, "--InputBitDepth=10", "-f", str(RA_FRAMES),
               "-wdt", str(W), "-hgt", str(H), "-i", yuv10, "-b"]
    pframe_dev.DBG_COUNTERS["ra_bi_cus"] = 0
    (r_bs, r_dt, r_enc), r_counts, r_util = run_counted(
        "ra10", lambda: cli_encode(
            ra_args + [os.path.join(tmp.name, "ra10.hevc")], dev),
        ra_names, kernels)
    for name in ("mc_dctif_i", "bi_pred"):
        rows[name]["launches"] = r_counts[name]
    if r_counts["satd8"]:
        fail(f"ra10: {r_counts['satd8']} K8 launches (DCT-IF: no NN-FME "
             f"gate)")
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
    from hmtpu_torch.search.wavefront import block_schedule32

    n_levels = int(block_schedule32(W, H, 6)["lv_blk"].shape[0])
    if r_counts["b_walk"] != 8 * n_levels:
        fail(f"ra10: {r_counts['b_walk']} K26 launches for 8 B frames of "
             f"{n_levels} z-scan levels")
    if r_counts["deblock"] != RA_FRAMES:
        fail(f"ra10: {r_counts['deblock']} K3 launches for {RA_FRAMES} "
             f"pictures")
    # K9 once a B pass (the three levels in one launch)
    if r_counts["frac_refine"] != RA_FRAMES - 1:
        fail(f"ra10: {r_counts['frac_refine']} K9 launches for "
             f"{RA_FRAMES - 1} B passes")
    print(f"kernels K9, K24 launches: ldp_dctif K9 {d_counts['frac_refine']}"
          f" ({n_p} P pass), ra10 K9 {r_counts['frac_refine']} "
          f"({RA_FRAMES - 1} B passes); ldp K24 {counts['tmvp_grid']} ({n_p} "
          f"P pass)", flush=True)
    k1 = lambda c: (f"K6 {c['nnfme']}, K1 forward "
                    f"{c['int_transform_fwd']} and inverse "
                    f"{c['int_transform_inv']}")
    print(f"kernels K6, K1 launches: ldp {k1(counts)} ({n_p} P pass); "
          f"ldp_dctif {k1(d_counts)}; ra10 {k1(r_counts)} (8 B frames)",
          flush=True)
    if max(r_counts[k] for k in ("int_transform_fwd",
                                 "int_transform_inv")) > 24:
        fail(f"ra10: {k1(r_counts)} launches for 8 B passes")
    b_secs = [r.seconds for r in r_res if r.slice_type == "B"]
    b_dev = [r.device_seconds for r in r_res if r.slice_type == "B"]
    print(f"ra10: K26 {r_counts['b_walk']} launches ({n_levels} a B frame); "
          f"B frames {min(b_secs):.3f}-{max(b_secs):.3f} s (median "
          f"{np.median(b_secs):.3f} s), device pass {min(b_dev):.3f}-"
          f"{max(b_dev):.3f} s, on {card}", flush=True)

    # ---- 7. cfg/encoder_intra_main.cfg as shipped, via the CLI
    ai_args = ["-c", AI_CFG, "-f", "1", *size, "-b",
               os.path.join(tmp.name, "ai.hevc")]
    full_ai = time.time() - t_start < FULL_AI_BEFORE_S
    if full_ai:
        ai_names = [k for k, (src, _) in kernels.KERNELS.items()
                    if src in ("iwalk", "i_rmd", "deblock", "sao")]
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

    # ---- 7b. BASELINE config 5, the High-Throughput-RExt cfg as shipped
    # (10 bits, TS, SDH), via the CLI on the clip's first frames as 10-bit
    # samples
    rx_args = ["-c", RX_CFG, "--InputBitDepth=10", "-f", str(RX_FRAMES),
               "-wdt", str(W), "-hgt", str(H), "-i", yuv10, "-b",
               os.path.join(tmp.name, "rext.hevc")]
    rx_names = [k for k, (src, _) in kernels.KERNELS.items()
                if src in ("iwalk", "i_rmd", "deblock", "sao")]
    pframe_dev.DBG_COUNTERS["intra_ts_tbs"] = 0
    (rx_bs, rx_dt, rx_enc), rx_counts, rx_util = run_counted(
        "rext", lambda: cli_encode(rx_args, dev), rx_names, kernels)
    rx_res = rx_enc.results
    check_results(rx_res, "rext")
    if rx_counts["satd8"]:
        fail(f"rext: {rx_counts['satd8']} K8 launches in an all-intra run")
    if (rx_enc.cfg.bit_depth, rx_enc.cfg.gop, rx_enc.cfg.profile,
            rx_enc.pps.transform_skip_enabled) \
            != (10, "ai", "high-throughput-rext", True) \
            or [r.slice_type for r in rx_res] != ["I"] * RX_FRAMES:
        fail(f"rext: the cfg gave bit depth {rx_enc.cfg.bit_depth}, gop "
             f"{rx_enc.cfg.gop}, profile {rx_enc.cfg.profile}, TS "
             f"{rx_enc.pps.transform_skip_enabled}, slices "
             f"{[r.slice_type for r in rx_res]}")
    if rx_counts["deblock"] != RX_FRAMES:
        fail(f"rext: {rx_counts['deblock']} K3 launches for {RX_FRAMES} "
             f"pictures")
    print(f"kernels K3, K19 launches: ldp {counts['deblock']}, "
          f"{counts['mv_regularize']} ({LDP_FRAMES} pictures, {n_p} P pass); "
          f"ldp_dctif {d_counts['deblock']}, {d_counts['mv_regularize']}; "
          f"ra10 {r_counts['deblock']}, {r_counts['mv_regularize']} "
          f"({RA_FRAMES} pictures); rext {rx_counts['deblock']}, "
          f"{rx_counts['mv_regularize']} ({RX_FRAMES} pictures)", flush=True)
    print(f"rext: {os.path.basename(RX_CFG)} (QP{rx_enc.cfg.qp}, 10 bits, "
          f"TS, SDH {int(rx_enc.pps.sign_data_hiding)}), {W}x{H}, "
          f"{RX_FRAMES} frames, {len(rx_bs)} bytes, {rx_dt:.3f} s, "
          f"{RX_FRAMES / rx_dt:.4f} fps, "
          f"{sum(r.bits for r in rx_res) / RX_FRAMES * 50 / 1000.0:.3f} "
          f"kbps at 50 fps, transform-skip TBs (intra_ts_tbs) "
          f"{pframe_dev.DBG_COUNTERS['intra_ts_tbs']}, PSNR "
          + ", ".join(f"POC{r.poc} Y {r.psnr_y:.4f} U {r.psnr_u:.4f} "
                      f"V {r.psnr_v:.4f}" for r in rx_res), flush=True)
    frame_line("rext", rx_res, rx_util)

    # ---- 8. the NN-FME trainer at its defaults (tools/train_nnfme.py's),
    # through its entry point in process, into a temporary directory
    from hmtpu_torch.apps import train_nnfme
    from hmtpu_torch.models import dataset

    train_dir = os.path.join(tmp.name, "nnfme")
    csv_dir = os.path.join(tmp.name, "sse")
    train_names = ["me_sad1", "frac_refine", "nnfme_fwd", "nnfme_bwd"]
    train_args = ["--size", f"{W}x{H}", "--frames", str(TRAIN_FRAMES),
                  "--qps", ",".join(str(q) for q in TRAIN_QPS), "--epochs",
                  str(TRAIN_EPOCHS), "--search-range", str(TRAIN_SR),
                  "--out", train_dir, "--csv-dir", csv_dir]
    train_losses = {}
    t0 = time.time()
    with PlainTally(TRAIN_PLAIN_FUNCS) as plain:
        _, t_counts, t_util = run_counted(
            "nnfme_train", lambda: train_nnfme.main(train_args, train_losses),
            train_names, kernels)
    t_train = time.time() - t0
    if plain.calls:
        fail(f"nnfme_train: calls of a plain version on the card's path "
             f"({plain.calls})")
    n_rows = (TRAIN_FRAMES - 1) * (W // 8) * (H // 8)
    steps = len(TRAIN_QPS) * train_steps(n_rows)
    # K15 once a step, with K16 as its tail: K16 has no launch of its own
    if t_counts["nnfme_bwd"] != steps or t_counts["nnfme_fwd"] < steps \
            or "adam" in t_counts:
        fail(f"nnfme_train: {t_counts['nnfme_bwd']} K15 and "
             f"{t_counts['nnfme_fwd']} K14 launches for {steps} steps, or "
             f"a launch counter of K16's own")
    print(f"nnfme_train: K15 launches {t_counts['nnfme_bwd']} for {steps} "
          f"steps (K16 inside each), K14 {t_counts['nnfme_fwd']} (the "
          f"steps and the validations)", flush=True)
    for name in ("me_sad1", "nnfme_fwd", "nnfme_bwd"):
        rows[name]["launches"] = t_counts[name]
    from hmtpu_torch.models import nnfme

    for qp in TRAIN_QPS:
        prm = nnfme.load_npz(os.path.join(train_dir, f"qp{qp}.npz"), dev)
        if not bool(torch.isfinite(prm.packed).all()):
            fail(f"nnfme_train: qp{qp}.npz has a value that is not finite")
    print(f"nnfme_train: {W}x{H}, {TRAIN_FRAMES} frames, SR{TRAIN_SR}, QPs "
          f"{'/'.join(str(q) for q in TRAIN_QPS)}, {TRAIN_EPOCHS} epochs: "
          f"{n_rows} rows and {steps // len(TRAIN_QPS)} steps per QP, "
          f"{t_train:.3f} s in all; no plain-version call; card "
          f"utilization (nvidia-smi, {len(t_util)} samples) mean "
          f"{np.mean(t_util) if t_util else float('nan'):.2f} %", flush=True)
    rows22 = dataset.read_sse_csv(os.path.join(csv_dir, "SSE_22.csv"))
    if len(rows22[3]) != n_rows:
        fail(f"nnfme_train: SSE_22.csv has {len(rows22[3])} rows")
    card_track = [float(x) for x in train_losses[22][:TRACK_STEPS]]

    # ---- 9. extraction at 1920x1080 (the single-level ME at SR 64)
    hd = frames_of(hd_clip())

    def hd_run():
        secs = []
        for i in range(1, len(hd)):
            t0 = time.time()
            dataset.extract_frame_records(hd[i], hd[i - 1], 22, HD_SR,
                                          device=dev)
            secs.append(time.time() - t0)
        return secs

    hd_secs, hd_counts, hd_util = run_counted(
        "hd_extract", hd_run, ["me_sad1", "frac_refine"], kernels)
    rows["frac_refine:1080p"]["launches"] = hd_counts["frac_refine"]
    print(f"hd_extract: {HD_W}x{HD_H}, QP22, SR{HD_SR}, {HD_FRAMES} frames, "
          f"{(HD_W // 8) * (HD_H // 8)} records a pair: seconds per frame "
          f"pair " + ", ".join(f"{t:.4f}" for t in hd_secs), flush=True)
    hd_card = dataset.extract_clip(hd[:2], 22, HD_CPU_SR, device=dev)

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
        profile_encode(args.profile, "ldp_64x64_I_P",
                       lambda: encode(small[:2], QP_LDP, dev, "ldp", 8))
        # the same pair with K10's plain version in the P pass's coding
        # step (the I pass codes inside K21), for the device-operation
        # count K10 removes (comparison only)
        pframe_dev.rdoq_code = plain_rdoq_code
        try:
            profile_encode(args.profile, "ldp_64x64_I_P_plain_rdoq",
                           lambda: encode(small[:2], QP_LDP, dev, "ldp", 8))
        finally:
            pframe_dev.rdoq_code = rdoq.rdoq_code
        profile_encode(args.profile, "ra_64x64_main10",
                       lambda: encode(synth_clip(64, 64, 9, seed=3), 32,
                                      dev, "ra", 8, "dctif", bd=10))

    # ---- 10. card against CPU: the CPU's streams come from worker
    # processes on the machine's other cores while this one dispatches the
    # same clips to the card.  A job is (content, frames, qp, gop, search
    # range, sub-pel, transform skip, bit depth, what must be > 0 on the
    # card: a DBG_COUNTERS entry (transform skip chosen by some TB, or
    # bi-prediction chosen by some CU) or "kernel:" and a kernel's
    # launches, the NN-FME weights directory or None for the port's own)
    screen = screen_clip(96, 64, 4)
    small9 = synth_clip(64, 64, RA_FRAMES, seed=3)
    jobs = [("", small[:2], qp, "ai", 16, None, False, 8, None, None)
            for qp in (22, 37)] \
        + [("screen ", screen[:2], qp, "ai", 16, None, True, 8,
            "intra_ts_tbs", None) for qp in (22, 37)] \
        + [("", small, qp, "ldp", 8, sp, ts, 8, None, None)
           for sp, ts in (("nn", False), ("dctif", True))
           for qp in (22, 37)] \
        + [("screen ", screen, 27, "ldp", 8, "dctif", True, 8,
            "ldp_ts_tbs", None)] \
        + [("Main10 ", small9, qp, "ra", 8, "dctif", False, 10, "ra_bi_cus",
            None) for qp in (22, 37)] \
        + [("", small9, 27, "ra", 8, "nn", False, 8, "ra_bi_cus", None)] \
        + [("", synth_clip(64, 56, 4, seed=3), 27, "ldp", 8, "nn", False, 8,
            "kernel:me_sad1", None)] \
        + [("freshly trained QP22 weights, ", small, 22, "ldp", 8, "nn",
            False, 8, None, train_dir)]
    ai_cpu_args = ai_args[:-1] + [os.path.join(tmp.name, "ai_cpu.hevc")]
    # BASELINE config 5 at tests/test_rext.py's size: 96x64, 3 frames as
    # 10-bit samples, through the CLI
    yuv_rx = os.path.join(tmp.name, "rext96x64.yuv")
    write_yuv(yuv_rx, synth_clip(96, 64, 3, seed=42), 10)
    rx_small = ["-c", RX_CFG, "--InputBitDepth=10", "-f", "3", "-wdt", "96",
                "-hgt", "64", "-i", yuv_rx, "-b"]
    cpu_jobs = [("cli", rx_small + [os.path.join(tmp.name, "rx_cpu.hevc")])] \
        + ([("cli", ai_cpu_args)] if full_ai else []) \
        + [j[1:8] + (j[9],) for j in jobs]
    # the trainer's records and first steps, and one 1920x1080 frame pair
    extra_jobs = {"records": ("records", synth_clip(W, H, 3, seed=42), 22,
                              TRAIN_SR),
                  "track": ("track", rows22, TRACK_STEPS),
                  "hd": ("records", hd_clip()[:2], 22, HD_CPU_SR)}
    ctx = multiprocessing.get_context("spawn")
    pool = concurrent.futures.ProcessPoolExecutor(CPU_WORKERS, mp_context=ctx)
    try:
        # the workers take jobs in submission order: the 416x240 AI
        # stream first, then the 1920x1080 records and the trainer's, then
        # the list from its end (the longer jobs)
        futs = {0: pool.submit(cpu_stream, cpu_jobs[0])}
        if full_ai:
            futs[1] = pool.submit(cpu_stream, cpu_jobs[1])
        extra = {k: pool.submit(cpu_stream, j)
                 for k, j in extra_jobs.items()}
        for i in sorted(range(len(cpu_jobs) - len(jobs), len(cpu_jobs)),
                        reverse=True):
            futs[i] = pool.submit(cpu_stream, cpu_jobs[i])
        # ---- 11. meanwhile, the calls and argument bytes of the
        # plain-torch queue-B functions on the main path, in an untimed
        # encode of the ldp phase's clip, and of B15's on a 2-frame
        # 416x240 RA Main10 encode (their wrappers cost host time)
        # and the inputs of K2's and K17-K20's checks
        with PlainTally() as tally, Capture() as cap:
            encode(clip, QP_LDP, dev, "ldp", SRANGE)
        print(tally.line(f"416x240 LDP QP{QP_LDP} I + P, untimed"),
              flush=True)
        plain_calls = dict(tally.calls)
        bad = {k: v for k, v in plain_calls.items()
               if k.startswith(("K23", "K24", "K25", "K1 ", "K6 ", "K8 "))}
        if bad:
            fail(f"plain versions of K1, K6, K8 or K23-K25 ran on the ldp "
                 f"path: {bad}")
        print("plain: no call of wavefront_pass_plain, t_level_plain, "
              "tmvp_grids_plain, _choose_params_plain, fwd_level_plain, "
              "inv_level_plain, "
              "predict_offsets_levels_plain, satd_gate_levels_plain or "
              "satd_batch_plain in the untimed LDP encode", flush=True)
        # and K23's inputs on ldp_dctif's P frame (TS), a 64x56 frame
        # (geometry 8) and a 64x64 one (its second P frame: TMVP from its
        # predecessor's motion)
        with Capture(cap.got):
            cli_encode(["-c", LDP_CFG, "--SubPel=dctif", "-q", str(QP_LDP),
                        "-f", str(LDP_FRAMES), *size, "-b",
                        os.path.join(tmp.name, "ldp_dctif_c.hevc")], dev)
            encode(synth_clip(64, 56, 3, seed=5), 27, dev, "ldp", 8, "nn")
            encode(small[:3], 27, dev, "ldp", 8, "nn")
        # and K26's inputs: the ra10 phase's B frames (the same CLI run),
        # and 64x64 and 64x56 8-bit RA encodes; no plain version and no B8
        # flag helper may run on their path
        with PlainTally() as tally, Capture(cap.got):
            cli_encode(ra_args + [os.path.join(tmp.name, "ra10_c.hevc")],
                       dev)
            print(tally.line("416x240 RA Main10 QP32 I + 8 B, untimed"),
                  flush=True)
            for w_, h_, seed in ((64, 64, 3), (64, 56, 5)):
                encode(synth_clip(w_, h_, RA_FRAMES, seed=seed), 27, dev,
                       "ra", 8, "dctif")
        if tally.calls:
            fail(f"plain versions or B8 flag helpers ran on the RA path: "
                 f"{tally.calls}")
        print("plain: no call of wavefront_pass_plain, of a B8 flag helper "
              "or of another plain version in the untimed RA encodes",
              flush=True)
        # and K21's inputs on the ai phase's frame, at 64x64 (the 32
        # level) and on the rext phase's first frame (10 bits, TS, SDH)
        with PlainTally() as tally_ai, Capture(cap.got):
            cli_encode(ai_args[:-1] + [os.path.join(tmp.name, "ai_c.hevc")],
                       dev)
            encode(small[:1], QP_AI, dev)
            cli_encode(rx_args[:4] + ["1"] + rx_args[5:-1]
                       + [os.path.join(tmp.name, "rext_c.hevc")], dev)
        for t in (plain_calls, tally.calls, tally_ai.calls):
            bad = {k: v for k, v in t.items() if k.startswith(("K21", "K22"))}
            if bad:
                fail(f"plain versions of K21 / K22 ran on the card: {bad}")
        print("plain: no call of iframe_pass_plain or rmd_plain in the "
              "untimed LDP, RA Main10 and AI encodes", flush=True)
        # ---- 3 (continued). K23 and K26 against wavefront_pass_plain on
        # the card (whose calls of K2, K17, K18 and K20 in their P and B
        # forms are captured meanwhile), K24 and K25 against their plain
        # versions; their launches are the ldp phase's (K26's ra10's)
        with Capture(cap.got):
            check_walk(pwalk_cases(cap.got), rows)
            check_walk(bwalk_cases(cap.got), rows, time_all=False)
        # where K23's time goes on ldp's P pass: the phase-clock build (its
        # state checked against K23's)
        _, a, k = cap.got[("p_walk", P_FORMS[0])]
        phases.print_rows(*phases.profile(ph_lib, a, k))
        check_kernels(p_kernel_cases(cap.got, dev), rows)
        for name in rows:
            if kernel_of(name) in ("p_walk", "tmvp_grid", "sao_choose"):
                rows[name]["launches"] = counts[kernel_of(name)]
        # K9's levels form on ldp_dctif's P pass and the RA B passes; its
        # launches are ldp_dctif's
        check_kernels(frac_levels_cases(cap.got), rows)
        rows["frac_refine:levels"]["launches"] = d_counts["frac_refine"]
        # K1's TS mode on ldp_dctif's hypothesis (inside K1's launches)
        check_kernels(ts_captured_cases(cap.got), rows)
        rows["b_walk"]["launches"] = r_counts["b_walk"]
        print("kernels K23-K26 launches: " + "; ".join(
            f"{name} ldp {counts[name]}, ldp_dctif {d_counts[name]}, ra10 "
            f"{r_counts[name]}" for name in ("p_walk", "tmvp_grid",
                                             "sao_choose", "b_walk")),
              flush=True)
        # K2 and K17-K20 against their plain versions on the captured
        # inputs (the P and B forms from the plain passes above); their
        # launches are ra10's, 0: the encodes run their arithmetic inside
        # K23 and K26
        captured = captured_cases(cap.got)
        check_kernels(captured, rows)
        for name, *_ in captured:
            rows[name]["launches"] = counts[name] if name == "mv_regularize" \
                else r_counts[name]
        # K3's state form on ldp's I and P and ra10's B pictures
        check_kernels(deblock_cases(cap.got), rows)
        rows["deblock:state"]["launches"] = counts["deblock"]
        print("kernels K2, K17-K20 launches: " + "; ".join(
            f"{name} ldp {counts[name]}, ldp_dctif {d_counts[name]}, ra10 "
            f"{r_counts[name]}" for name, *_ in captured), flush=True)
        # K10 at every captured form of the P / B passes' coding step
        rdoq_forms(cap.got)
        # K21 and K22 against iframe_pass_plain and rmd_plain on the card
        check_walk(walk_cases(cap.got), rows)
        # where K21's time goes on the ai frame: the phase-clock build (its
        # state checked against K21's)
        _, a, k = cap.got[("i_walk", f"{W}x{H} QP{QP_AI} TS")]
        iphases.print_rows(f"ai frame, {W}x{H} QP{QP_AI} TS",
                           *iphases.profile(iph_lib, a, k))
        for name in ("i_walk", "i_rmd"):
            rows[name]["launches"] = counts[name]
        print("kernels K21-K22 launches: " + "; ".join(
            f"{name} ldp {counts[name]}, ldp_dctif {d_counts[name]}, ra10 "
            f"{r_counts[name]}, rext {rx_counts[name]}"
            for name in ("i_walk", "i_rmd")), flush=True)
        # the RExt parity clip's card side (its CPU side is a worker job)
        rx_card = cli_encode(rx_small + [os.path.join(tmp.name,
                                                      "rx_card.hevc")], dev)
        on_card = []
        for _, f, qp, gop, sr, sp, ts, bd, must, nn_dir in jobs:
            for k in ("ldp_ts_tbs", "intra_ts_tbs", "ra_bi_cus"):
                pframe_dev.DBG_COUNTERS[k] = 0
            if must and must.startswith("kernel:"):
                kernels.COUNTS[must[7:]] = 0
            out = encode(f, qp, dev, gop, sr, sp, ts, bd, nn_dir)[:2]
            fired = must and (kernels.COUNTS[must[7:]]
                              if must.startswith("kernel:")
                              else pframe_dev.DBG_COUNTERS[must])
            on_card.append(out + (fired,))
        cpu = [futs[i].result() for i in range(len(cpu_jobs))]
        extra = {k: f.result() for k, f in extra.items()}
    finally:
        if sys.exc_info()[0] is not None:
            # a failed phase: the queued jobs are dropped and the workers
            # stopped, not waited for
            pool.shutdown(wait=False, cancel_futures=True)
            stop_children(tracker=False)
        # the pool's queues (and their semaphores) go before stop_children
        # ends the resource tracker
        pool.shutdown()
        del pool
    labels = [f"{f[0][0].shape[1]}x{f[0][0].shape[0]} {what}{gop.upper()}"
              f"{' ' + sp.upper() if gop in ('ldp', 'ra') else ''}"
              f"{' TS' if ts else ''} QP{qp} {len(f)} frames"
              for what, f, qp, gop, _, sp, ts, _, _, _ in jobs]
    musts = [j[8] for j in jobs]
    if full_ai:
        on_card = [(ai_bs, ai_dt, None)] + on_card
        labels = [f"416x240 AI {os.path.basename(AI_CFG)} QP{QP_AI} "
                  f"1 frame"] + labels
        musts = [None] + musts
    on_card = [rx_card[:2] + (None,)] + on_card
    labels = [f"96x64 RExt {os.path.basename(RX_CFG)} 10 bits 3 frames"] \
        + labels
    musts = [None] + musts
    for what, must, (a, adt, fired), (b, bdt) in zip(labels, musts,
                                                     on_card, cpu):
        if a != b:
            fail(f"{what}: card and CPU streams differ")
        if must and not fired:
            fail(f"{what}: {must} 0 on the card (no TB chose transform "
                 f"skip, no CU bi-prediction, or the kernel did not run)")
        print(f"parity: {what} card == CPU ({len(a)} bytes; card "
              f"{adt:.1f} s, CPU {bdt:.1f} s"
              + (f"; {must} {fired} on the card" if must else "") + ")",
              flush=True)
    # the trainer's records, its first steps and the 1920x1080 pair
    (recs, rdt), (cpu_track, tdt), (hd_cpu, hdt) = (
        extra[k] for k in ("records", "track", "hd"))
    n3 = 2 * (W // 8) * (H // 8)
    if not all(np.array_equal(a, b[:n3]) and a.dtype == b.dtype
               for a, b in zip(recs, rows22)):
        fail("nnfme_train: the first 3 frames' records on the CPU differ "
             "from the card's")
    print(f"parity: nnfme_train records of frames 0-2 at QP22 card == CPU "
          f"({n3} rows; CPU {rdt:.1f} s)", flush=True)
    a, b = np.array(card_track), np.array(cpu_track)
    rel = float(np.abs(a - b).max() / np.abs(b).max()) \
        if len(a) == len(b) == TRACK_STEPS else float("inf")
    if not rel <= TRACK_RTOL:
        fail(f"nnfme_train: the CPU's first {TRACK_STEPS} losses do not "
             f"track the card's (max relative difference {rel})")
    print(f"parity: nnfme_train first {TRACK_STEPS} steps at QP22, losses "
          f"{a[0]:.6f} -> {a[-1]:.6f} on the card, max relative difference "
          f"to the CPU's {rel:.3e} (bound {TRACK_RTOL}; CPU {tdt:.1f} s)",
          flush=True)
    if not all(np.array_equal(x, y) and x.dtype == y.dtype
               for x, y in zip(hd_card, hd_cpu)):
        fail("hd_extract: the records of the first frame pair differ "
             "between the card and the CPU")
    print(f"parity: hd_extract {HD_W}x{HD_H} frames 0-1 at QP22 SR"
          f"{HD_CPU_SR} card == CPU ({len(hd_cpu[3])} records; CPU "
          f"{hdt:.1f} s)", flush=True)
    tmp.cleanup()

    print(f"total: {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except BaseException as e:
        # a failed phase: say why, stop what the check started and leave
        # at once (the worker pool's semaphores may still be registered,
        # and multiprocessing's exit hooks would start a new resource
        # tracker to unregister them)
        if not isinstance(e, SystemExit):
            traceback.print_exc()
        stop_children()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(e.code if isinstance(e, SystemExit)
                 and isinstance(e.code, int) else 1)
    stop_children()
