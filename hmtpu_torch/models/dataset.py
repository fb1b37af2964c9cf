"""NN-FME dataset extraction, the port of hmtpu/models/dataset.py
(`extract_frame_records` :21, `extract_clip` :56, `write_sse_csv` :75,
`read_sse_csv` :81): the training data of the fork's offline loop.

Capability parity with the reference's extraction block
(TEncSearch.cpp:4561-4582 writing SSE.csv: 9 integer-ME costs, PU
height/width, the ground-truth class from the standard DCT-IF
fractional search) and DL/Extract_data.sh (the per-QP loop).  Per frame,
the single-level integer ME of every 8x8 block gives its 3x3 cost
stencil (K13 `me_sad1` on the card) and HM's DCT-IF refinement of the
same blocks its label (K9 `frac_refine`'s levels form with the 8 level
alone, the frame read in place); on the CPU both run their plain
versions.  Every output is an integer, so the card, the CPU and hmtpu
give the same records.
"""
from __future__ import annotations

import numpy as np
import torch

from hmtpu_torch.device import resolve
from hmtpu_torch.io.yuv import Frame
from hmtpu_torch.models.nnfme import class_of_offsets
from hmtpu_torch.search.me import frac_refine_levels, integer_me


def extract_frame_records(frame: Frame, ref: Frame, qp: int,
                          search_range: int = 16, bd: int = 8,
                          device="cuda"):
    """One P frame -> (costs9 (B, 9) float32, heights (B,), widths (B,),
    labels (B,) int32) as numpy.  Stencil order [TL,T,TR,L,C,R,BL,B,BR]
    (TEncSearch.cpp:88)."""
    dev = resolve(device)
    h, w = frame.y.shape
    by, bx = h // 8, w // 8
    lam_sqrt = np.float32(np.sqrt(0.57 * 2.0 ** ((qp - 12) / 3.0)))
    org = torch.as_tensor(np.asarray(frame.y, np.int32)).to(dev)
    refy = torch.as_tensor(np.asarray(ref.y, np.int32)).to(dev)
    zeros = torch.zeros((by, bx), dtype=torch.int32, device=dev)
    (mvx, mvy), stencil, _ = integer_me(refy, org, 8, search_range,
                                        lam_sqrt, zeros, zeros, bd)

    # the 8 level of K9's levels form: the frame's luma plane read in place
    ((mvq_x, mvq_y),) = frac_refine_levels(refy, org, [(mvx, mvy, zeros, 8)],
                                           bd)
    labels = class_of_offsets((mvq_x - mvx * 4).reshape(-1),
                              (mvq_y - mvy * 4).reshape(-1))
    costs9 = stencil.reshape(-1, 9).cpu().numpy().astype(np.float32)
    sizes = np.full(costs9.shape[0], 8, np.int32)
    return costs9, sizes, sizes, labels.cpu().numpy().astype(np.int32)


def extract_clip(frames: list[Frame], qp: int, search_range: int = 16,
                 bd: int = 8, device="cuda"):
    """IPPP extraction over a clip: each frame predicts from the
    previous original (the extraction encoder's low-delay use)."""
    cs, hs, ws, ls = [], [], [], []
    for i in range(1, len(frames)):
        c, hh, ww, ll = extract_frame_records(frames[i], frames[i - 1],
                                              qp, search_range, bd, device)
        cs.append(c), hs.append(hh), ws.append(ww), ls.append(ll)
    return (np.concatenate(cs), np.concatenate(hs),
            np.concatenate(ws), np.concatenate(ls))


# -- SSE.csv format parity (DL/Extract_data.sh renames per QP) -------------

_HEADER = ("TL,T,TR,L,C,R,BL,B,BR,Height,Width,class")


def write_sse_csv(path: str, costs9, heights, widths, labels) -> None:
    rows = np.column_stack([costs9, heights, widths, labels])
    np.savetxt(path, rows, delimiter=",", header=_HEADER, comments="",
               fmt=["%.0f"] * 9 + ["%d"] * 3)


def read_sse_csv(path: str):
    data = np.loadtxt(path, delimiter=",", skiprows=1)
    data = np.atleast_2d(data)
    return (data[:, :9].astype(np.float32), data[:, 9].astype(np.int32),
            data[:, 10].astype(np.int32), data[:, 11].astype(np.int32))
