"""Train the per-QP NN-FME MLPs and export runtime weights, the port of
tools/train_nnfme.py (`main` :20): extract the SSE dataset with the
batched integer ME and HM's DCT-IF refinement (models/dataset.py),
train the 17->22->20->49 model (models/train.py), and save qp{N}.npz
files that `Encoder(EncoderConfig(subpel="nn", nn_weights_dir=DIR))`
and hmtpu's `load_npz` both read.

    python -m hmtpu_torch.apps.train_nnfme [--device cuda|cpu] \\
        [--yuv path] [--size WxH] [--frames N] [--qps 22,27,32,37] \\
        [--epochs 60] [--search-range 16] [--out DIR] [--csv-dir DIR]

`--device` is the port's one addition: `cuda` by default, which raises
when there is no card; `cpu` runs every kernel's plain version.  Without
`--yuv` the clip is the repo's synthetic one (utils/gen_test_yuv.py).
The default `--out` is the port's own weights directory, which the
encoder reads by default.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "models", "weights")


def main(argv=None, losses: dict | None = None):
    """Run the CLI on `argv` (sys.argv's by default).  `losses`, when
    given, maps each QP to the list of its training steps' losses (device
    scalars)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--yuv", default=None,
                    help="planar 4:2:0 8-bit input; default: synthetic clip")
    ap.add_argument("--size", default="416x240")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--qps", default="22,27,32,37")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--search-range", type=int, default=16)
    ap.add_argument("--out", default=WEIGHTS_DIR)
    ap.add_argument("--csv-dir", default=None,
                    help="also write SSE_<qp>.csv in the reference layout")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from hmtpu_torch.device import resolve
    from hmtpu_torch.io.yuv import Frame, YuvReader
    from hmtpu_torch.models.dataset import extract_clip, write_sse_csv
    from hmtpu_torch.models.nnfme import save_npz
    from hmtpu_torch.models.train import train

    dev = resolve(args.device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    w, h = (int(v) for v in args.size.split("x"))
    if args.yuv:
        rd = YuvReader(args.yuv, w, h)
        frames = [rd.read_frame() for _ in range(args.frames)]
    else:
        from hmtpu_torch.utils.gen_test_yuv import synth_clip
        frames = [Frame(y.astype(np.int32), u.astype(np.int32),
                        v.astype(np.int32))
                  for y, u, v in synth_clip(w, h, args.frames)]

    os.makedirs(args.out, exist_ok=True)
    for qp in (int(q) for q in args.qps.split(",")):
        t0 = time.time()
        c9, hh, ww, ll = extract_clip(frames, qp, args.search_range,
                                      device=dev)
        sync()
        t_ext = time.time() - t0
        if args.csv_dir:
            os.makedirs(args.csv_dir, exist_ok=True)
            write_sse_csv(os.path.join(args.csv_dir, f"SSE_{qp}.csv"),
                          c9, hh, ww, ll)
        base = np.bincount(ll, minlength=49).max() / len(ll)
        steps: list = []
        if losses is not None:
            losses[qp] = steps
        t0 = time.time()
        params, vacc = train(c9, hh, ww, ll, epochs=args.epochs,
                             log_every=max(1, args.epochs // 4),
                             device=dev, losses=steps)
        t_train = time.time() - t0
        out = os.path.join(args.out, f"qp{qp}.npz")
        save_npz(out, params)
        print(f"QP{qp}: {len(ll)} rows, majority-class {base:.3f}, "
              f"val acc {vacc:.3f} -> {out}")
        print(f"QP{qp}: extraction {t_ext:.3f} s "
              f"({t_ext / max(1, len(frames) - 1):.4f} s per frame pair), "
              f"{len(steps)} steps in {t_train:.3f} s "
              f"({len(steps) / t_train:.1f} steps/s) on {dev}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
