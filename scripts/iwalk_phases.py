"""Where K21 i_walk's time goes: a phase-clock build of csrc/iwalk.cu
(HM_PHASE_CLOCK: clock64() stamps around each phase of a lane, as
csrc/hm_port.cuh says) driven on the 416x240 I passes, one line a phase.

    PYTHONPATH=. python scripts/iwalk_phases.py [--size WxH]

Builds its own library beside the encoder's (never the encode path's),
captures the I pass of the all-intra cfg's first frame
(cfg/encoder_intra_main.cfg: QP 32, transform skip, no sign hiding: the
"ai" frame) and of the low-delay P encode's I frame (QP 22), checks that
the phase build leaves K21's state, and prints per phase the cycles
(the stamping thread of each lane's block, summed over the pass's lanes),
their share of the lanes' cycles and the phase's count.  A CU trial's
phases are split by its size (8: the cells, 16, 32); the cells' phases
are stamped by the block's thread 0, the larger trials' by the first
thread of the warps that run them (the whole block before the trials ran
beside their cells); "barrier wait" is the cycles the block's last thread
spends at barriers, against the same lanes' cycles.  `chip_smoke.py`
prints the same lines from its own capture.  Needs a CUDA card; imports
nothing of JAX.
"""
from __future__ import annotations

import ctypes
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import pwalk_phases  # noqa: E402  (the phase build, shared with K23's)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AI_CFG = os.path.join(ROOT, "cfg", "encoder_intra_main.cfg")

# iwalk.cuh's phase slots: (phase, CU size) = phase * 3 + log2 - 3, then
# the lane, the 16x16 and 32x32 trials whole; hm_port.cuh's barrier slot
PHASES = ("sources and lines", "prediction", "coding round",
          "NxN chain", "NxN chroma pair", "picks and costs", "commit",
          "wait for the trial")
N_SLOTS = pwalk_phases.N_SLOTS
SLOT_LANE, SLOT_T16, SLOT_T32 = 24, 25, 26
SLOT_BAR, SLOT_CODE = pwalk_phases.SLOT_BAR, pwalk_phases.SLOT_CODE


def capture_i(w=416, h=240, device="cuda"):
    """{label: (args, kwargs)} of the I passes of the ai frame (through
    the CLI and the AI cfg) and of ldp's I frame, on the card."""
    from hmtpu_torch.apps import encoder_app
    from hmtpu_torch.encoder import iframe_dev
    from hmtpu_torch.encoder.top import Encoder, EncoderConfig
    from hmtpu_torch.io.yuv import Frame
    from hmtpu_torch.utils.gen_test_yuv import synth_clip

    seen = []
    inner = iframe_dev.iframe_pass

    def record(*a, **k):
        seen.append((a, k))
        return inner(*a, **k)

    clip = list(synth_clip(w, h, 1, seed=42))
    iframe_dev.iframe_pass = record
    try:
        with tempfile.TemporaryDirectory() as d:
            yuv = os.path.join(d, "clip.yuv")
            with open(yuv, "wb") as f:
                for p in clip[0]:
                    f.write(np.ascontiguousarray(p, np.uint8).tobytes())
            encoder_app.run(["-c", AI_CFG, "-f", "1", "-wdt", str(w),
                             "-hgt", str(h), "-i", yuv, "-b",
                             os.path.join(d, "ai.hevc")], device=device)
        enc = Encoder(EncoderConfig(width=w, height=h, qp=22, gop="ldp",
                                    subpel="nn", search_range=64),
                      device=device)
        enc.encode_sequence([Frame(*(np.asarray(p, np.int32)
                                     for p in clip[0]), 8)])
    finally:
        iframe_dev.iframe_pass = inner
    if len(seen) != 2:
        raise RuntimeError(f"expected two I passes, got {len(seen)}")
    (a0, k0), (a1, k1) = seen
    return {f"ai frame, {w}x{h} QP{a0[3]}"
            + (" TS" if k0.get("ts") else ""): (a0, k0),
            f"ldp I frame, {w}x{h} QP{a1[3]}": (a1, k1)}


def profile(lib, args, kwargs):
    """Run the I pass through the phase build and return its rows
    (label, cycles, share of the lanes' cycles, count), the phase build's
    and K21's wall milliseconds, after checking that every state array
    equals K21's."""
    from hmtpu_torch.encoder import iframe_dev

    run_level = pwalk_phases.runner(lib, "iwalk")
    cyc = (ctypes.c_uint64 * N_SLOTS)()
    cnt = (ctypes.c_uint64 * N_SLOTS)()
    want = iframe_dev.iframe_walk(*args, **kwargs)
    torch.cuda.synchronize()
    t0 = time.time()
    iframe_dev.iframe_walk(*args, **kwargs)
    torch.cuda.synchronize()
    k21_wall = time.time() - t0
    if lib.phases(cyc, cnt):   # zero the sums
        raise RuntimeError("phase build: reading the clocks failed")
    torch.cuda.synchronize()
    t0 = time.time()
    got = iframe_dev.iframe_walk(*args, run_level=run_level, **kwargs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    if lib.phases(cyc, cnt):
        raise RuntimeError("phase build: reading the clocks failed")
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    if bad:
        raise RuntimeError(f"phase build: state differs from K21's in {bad}")
    lane = max(cyc[SLOT_LANE], 1)
    rows = [("lane (thread 0)", cyc[SLOT_LANE], 1.0, cnt[SLOT_LANE])]
    for i, name in enumerate(PHASES):
        for j, n in enumerate((8, 16, 32)):
            k = 3 * i + j
            if cnt[k]:
                rows.append((f"{name} {n}x{n}", cyc[k], cyc[k] / lane,
                             cnt[k]))
    for i, name in enumerate(pwalk_phases.CODE_PHASES):
        k = SLOT_CODE + i
        if cnt[k]:
            rows.append((f"coding: {name} (thread 0's codings)", cyc[k],
                         cyc[k] / lane, cnt[k]))
    for k, name in ((SLOT_T16, "16x16 region whole (the trial beside "
                               "its cells)"),
                    (SLOT_T32, "32x32 region whole"),
                    (SLOT_BAR, "barrier wait (last thread)")):
        if cnt[k]:
            rows.append((name, cyc[k], cyc[k] / lane, cnt[k]))
    return rows, wall, k21_wall


def print_rows(label, rows, wall, k21_wall):
    print(f"i_walk phases ({label}: {k21_wall * 1e3:.1f} ms wall with "
          f"K21, {wall * 1e3:.1f} ms with the phase build):", flush=True)
    for name, c, share, n in rows:
        print(f"  phase {name}: {c} cycles, {100 * share:.2f} % of the "
              f"lanes', count {n}", flush=True)


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="416x240")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("iwalk_phases: no CUDA device", file=sys.stderr)
        return 2
    from hmtpu_torch import kernels

    kernels.build_all()
    w, h = (int(v) for v in opt.size.split("x"))
    passes = capture_i(w, h)
    lib, log = pwalk_phases.build_phase_lib("iwalk")
    for ln in log.strip().splitlines():
        print(f"  nvcc iwalk (phases): {ln}", flush=True)
    for label, (args, kwargs) in passes.items():
        print_rows(label, *profile(lib, args, kwargs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
