"""Where K14 nnfme_fwd's and K15 nnfme_bwd's time goes: a build of
csrc/nnfme_train.cu with NNT_PHASES (thread 0 of each block stamps the
global timer at each phase boundary; never the trainer's build), run at
the trainer's batch on seeded rows, one line a phase boundary.

    PYTHONPATH=. python scripts/nnfme_phases.py [B ...]   # default 1024

Each line is the latest block's stamp at that boundary, in microseconds
after the earliest block's entry, averaged over 20 launches (after 5):
K14's parameters staged, its rows done, its ticket taken, the last
block's sums done; K15's parameters staged, its rows done, its partial
sums written, the grid barrier passed, the column sums done: for the
gradient alone ("K15") and for a training step's launch, with K16 as
its tail after each column sum ("K15+K16").  The build
goes to the package's build directory beside the trainer's.  Needs a
CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

FWD = ("parameters staged", "rows", "ticket", "sums (last block)")
BWD = ("parameters staged", "rows", "partial sums", "grid barrier",
       "column sums")


def build():
    from hmtpu_torch import kernels

    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    so = os.path.join(kernels.BUILD_DIR, "nnfme_train_phases.so")
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DNNT_PHASES",
                        "-o", so, kernels.source_path("nnfme_train")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hm_nnfme_fwd.argtypes = [p] * 10 + [i, f, p]
    lib.hm_nnfme_bwd.argtypes = [p] * 10 + [i] + [p] * 4 + [i] + [f] * 6 \
        + [p]
    lib.hm_nnfme_stamps.argtypes = [p]
    return lib


def phases(lib, B: int, iters: int = 20, warm: int = 5):
    from hmtpu_torch.models import nnfme, train

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(1)
    c9 = (rng.randint(200, 6000, (B, 1))
          + rng.randint(0, 900, (B, 9))).astype(np.float32)
    d = dict(np.load(f"{nnfme.WEIGHTS_DIR}/qp22.npz"))
    d.update(mean=c9.mean(0), std=c9.std(0) + 1e-8)
    pk = nnfme.params_from_arrays(d, dev).packed.detach()
    t = lambda a: torch.as_tensor(a).to(dev)
    rows = (t(c9), t(rng.choice([8, 16, 32], B).astype(np.int32)),
            t(rng.choice([8, 16, 32], B).astype(np.int32)),
            t(rng.randint(0, 49, B).astype(np.int32)))
    saved = [torch.empty(B, n, device=dev) for n in (22, 20, 49)]
    part = torch.empty(-(-B // train.KROWS) * nnfme.PACK_SIZE, device=dev)
    out = torch.empty(2, device=dev)
    grad = torch.empty(nnfme.PACK_SIZE, device=dev)
    one = torch.ones(1, device=dev)
    # K16's tail: moments, the step count and a table with room for every
    # launch
    n_launch = warm + iters
    opt = train.adam_state(torch.zeros_like(pk), torch.zeros_like(pk), 0,
                           n_launch)
    upd = [opt.mu.data_ptr(), opt.nu.data_ptr(), opt.dcount.data_ptr(),
           opt.bc.data_ptr(), n_launch, *train._adam_consts(3e-3)]
    stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda *a: [x.data_ptr() for x in a]
    host = np.zeros(16 * 4096, np.uint64)
    got = {}
    for it in range(warm + iters):
        stamps = []
        for call in (lambda: lib.hm_nnfme_fwd(*ptr(pk, *rows, *saved, part,
                                                   out), B,
                                              train._inv(B), stream),
                     lambda: lib.hm_nnfme_bwd(*ptr(pk, *rows[:3], *saved, one,
                                                   part, grad), B,
                                              *[None] * 4, 0, *[0.0] * 6,
                                              stream),
                     lambda: lib.hm_nnfme_bwd(*ptr(pk, *rows[:3], *saved, one,
                                                   part, grad), B, *upd,
                                              stream)):
            if call():
                raise RuntimeError("launch failed")
            torch.cuda.synchronize()
            if lib.hm_nnfme_stamps(host.ctypes.data):
                raise RuntimeError("reading the stamps failed")
            stamps.append(host.reshape(16, 4096).astype(np.int64).copy())
        if it < warm:
            continue
        for name, st, k0, names in (("K14", stamps[0], 0, FWD),
                                    ("K15", stamps[1], 8, BWD),
                                    ("K15+K16", stamps[2], 8, BWD)):
            t0 = st[k0][st[k0] > 0].min()
            for k, ph in enumerate(names):
                v = st[k0 + 1 + k]
                got.setdefault((name, ph), []).append(
                    (v[v > 0].max() - t0) / 1e3)
    return {k: float(np.mean(v)) for k, v in got.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("nnfme_phases: no CUDA device", file=sys.stderr)
        return 2
    lib = build()
    for B in [int(a) for a in sys.argv[1:]] or [1024]:
        for (name, ph), us in phases(lib, B).items():
            print(f"B {B} {name} {ph}: {us:.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
