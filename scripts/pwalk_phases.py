"""Where K23 p_walk's time goes: a phase-clock build of csrc/pwalk.cu
(HM_PHASE_CLOCK: clock64() stamps around each phase of a lane, as
csrc/hm_port.cuh says) driven on ldp's 416x240 P pass, one line a phase.

    PYTHONPATH=. python scripts/pwalk_phases.py [--size WxH]

Builds its own library beside the encoder's (never the encode path's),
encodes the first two frames of the synthetic 416x240 clip (LDP QP 22,
NN-FME, search range 64: the main path) to capture the P pass's
arguments, checks that the phase build leaves K23's state, and prints per
phase the cycles (thread 0 of each lane's block, summed over the pass's
lanes), their share of the lanes' cycles and the phase's count.  A CU
trial's phases are split by its size (8: the cells, 16, 32); "barrier
wait" is the cycles the block's last thread spends at barriers, against
the same lanes' cycles.  `chip_smoke.py` prints the same lines from its
own capture.  Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import time

import torch

# pwalk.cuh's phase slots: (phase, CU size) = phase * 3 + log2 - 3, then
# the lane, the 16x16 and 32x32 trials whole; hm_port.cuh's barrier slot
PHASES = ("sources, list", "MC and SSEs (and intra prediction)",
          "screening", "codings (deadzone, recodes, intra)",
          "winner's results", "AMVP", "intra cost", "commit")
N_SLOTS = 48
SLOT_LANE, SLOT_T16, SLOT_T32, SLOT_BAR = 24, 25, 26, N_SLOTS - 1
# hm_port.cuh's coding-step slots (group 0's codings, every size)
SLOT_CODE = 27
CODE_PHASES = ("residual + transform", "K10 set-up", "trellis stage 1",
               "trellis stage 2", "trellis stage 3", "exact-rate guard",
               "sign hiding", "TB rate", "levels + dequantisation",
               "inverse + SSE",
               # rdoq.cuh's sub-steps: every tb_bits call (the guard's and
               # the TB rate's), the trellis' stage 1, the guard's sums,
               # and the stamping thread's barrier wait inside rdoq_tb
               "tb_bits: CG flags and last position",
               "tb_bits: position pass", "tb_bits: sums", "tb_bits: tail",
               "trellis: prelude", "trellis: stage 1 position pass",
               "guard: distortion sums", "barrier wait inside rdoq_tb")


# a walker's source -> its launch function (its phase read-out adds
# "_phases")
WALK_FNS = {"pwalk": "hm_p_walk", "iwalk": "hm_i_walk"}


def build_phase_lib(src: str = "pwalk"):
    """nvcc of csrc/<src>.cu (a walker of WALK_FNS) with HM_PHASE_CLOCK
    into the build directory; (library, nvcc's output: ptxas' registers,
    stack and spills, kept beside the library).  The library's `walk` and
    `phases` are the walker's launch and its phase read-out."""
    from hmtpu_torch import kernels

    h = hashlib.sha256(b"-DHM_PHASE_CLOCK")
    for f in sorted(os.listdir(kernels.CSRC)):
        if f.endswith((".cuh", ".cu")):
            with open(os.path.join(kernels.CSRC, f), "rb") as fh:
                h.update(fh.read())
    so = os.path.join(kernels.BUILD_DIR,
                      f"hmtpu_torch_{src}_phases_{h.hexdigest()[:16]}.so")
    log_path = kernels.build_log_path(so)
    if not os.path.exists(so):
        os.makedirs(kernels.BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        p = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS,
                            "-DHM_PHASE_CLOCK", "-o", tmp,
                            kernels.source_path(src)],
                           capture_output=True, text=True)
        log = p.stdout + p.stderr
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on the phase build:\n{log}")
        with open(log_path, "w") as f:
            f.write(log)
        os.replace(tmp, so)
    log = ""
    if os.path.exists(log_path):
        with open(log_path) as f:
            log = f.read()
    lib = ctypes.CDLL(so)
    lib.walk = getattr(lib, WALK_FNS[src])
    lib.walk.restype = ctypes.c_int
    lib.walk.argtypes = [ctypes.c_void_p] + [
        ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_int, ctypes.c_void_p]
    lib.phases = getattr(lib, WALK_FNS[src] + "_phases")
    lib.phases.restype = ctypes.c_int
    lib.phases.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib, log


def capture_ldp_p(w=416, h=240):
    """(args, kwargs) of the P pass of ldp's first two frames on the card
    (the synthetic clip at w x h)."""
    import numpy as np

    from hmtpu_torch.encoder import pframe_dev
    from hmtpu_torch.encoder.top import Encoder, EncoderConfig
    from hmtpu_torch.io.yuv import Frame
    from hmtpu_torch.utils.gen_test_yuv import synth_clip

    seen = []
    inner = pframe_dev.wavefront_pass

    def record(*a, **k):
        seen.append((a, k))
        return inner(*a, **k)

    pframe_dev.wavefront_pass = record
    try:
        enc = Encoder(EncoderConfig(width=w, height=h, qp=22, gop="ldp",
                                    subpel="nn", search_range=64),
                      device="cuda")
        enc.encode_sequence([Frame(*(np.asarray(p, np.int32) for p in f), 8)
                             for f in synth_clip(w, h, 2, seed=42)])
    finally:
        pframe_dev.wavefront_pass = inner
    if len(seen) != 1:
        raise RuntimeError(f"expected one P pass, got {len(seen)}")
    return seen[0]


def runner(lib, src="pwalk"):
    """The walker's run_level through a library built here."""
    def run_level(scratch, ptrs, ints, flts, level):
        err = lib.walk(
            scratch.data_ptr(),
            *(x for arr in (ptrs, ints, flts)
              for x in (ctypes.addressof(arr), len(arr))), level,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"build of {src}.cu: launch failed with {err}")
    return run_level


def profile(lib, args, kwargs):
    """Run the P pass through the phase build and return its rows
    (label, cycles, share of the lanes' cycles, count), after checking
    that every state array equals K23's."""
    from hmtpu_torch.encoder import pframe_dev

    run_level = runner(lib)

    cyc = (ctypes.c_uint64 * N_SLOTS)()
    cnt = (ctypes.c_uint64 * N_SLOTS)()
    want = pframe_dev.pframe_walk(*args, **kwargs)
    torch.cuda.synchronize()
    t0 = time.time()
    pframe_dev.pframe_walk(*args, **kwargs)
    torch.cuda.synchronize()
    plain_wall = time.time() - t0
    if lib.phases(cyc, cnt):   # zero the sums
        raise RuntimeError("phase build: reading the clocks failed")
    torch.cuda.synchronize()
    t0 = time.time()
    got = pframe_dev.pframe_walk(*args, run_level=run_level, **kwargs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    if lib.phases(cyc, cnt):
        raise RuntimeError("phase build: reading the clocks failed")
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    if bad:
        raise RuntimeError(f"phase build: state differs from K23's in {bad}")
    lane = max(cyc[SLOT_LANE], 1)
    rows = [("lane (thread 0)", cyc[SLOT_LANE], 1.0, cnt[SLOT_LANE])]
    for i, name in enumerate(PHASES):
        for j, n in enumerate((8, 16, 32)):
            k = 3 * i + j
            if cnt[k]:
                rows.append((f"{name} {n}x{n}", cyc[k], cyc[k] / lane,
                             cnt[k]))
    for i, name in enumerate(CODE_PHASES):
        k = SLOT_CODE + i
        if cnt[k]:
            rows.append((f"coding: {name} (group 0)", cyc[k], cyc[k] / lane,
                         cnt[k]))
    for k, name in ((SLOT_T16, "16x16 trial whole"),
                    (SLOT_T32, "32x32 trial whole"),
                    (SLOT_BAR, "barrier wait (last thread)")):
        rows.append((name, cyc[k], cyc[k] / lane, cnt[k]))
    return rows, wall, plain_wall


def print_rows(rows, wall, plain_wall):
    print(f"p_walk phases (ldp P pass: {plain_wall * 1e3:.1f} ms wall with "
          f"K23, {wall * 1e3:.1f} ms with the phase build):", flush=True)
    for label, c, share, n in rows:
        print(f"  phase {label}: {c} cycles, {100 * share:.2f} % of the "
              f"lanes', count {n}", flush=True)


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="416x240")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("pwalk_phases: no CUDA device", file=sys.stderr)
        return 2
    from hmtpu_torch import kernels

    kernels.build_all()
    w, h = (int(v) for v in opt.size.split("x"))
    args, kwargs = capture_ldp_p(w, h)
    lib, log = build_phase_lib()
    for ln in log.strip().splitlines():
        print(f"  nvcc pwalk (phases): {ln}", flush=True)
    print_rows(*profile(lib, args, kwargs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
