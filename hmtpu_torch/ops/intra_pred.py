"""Batched intra prediction (H.265 8.4.4.2): the port of
hmtpu/ops/intra_pred.py `predict_all_modes` :69, `predict_one_mode`
:149 and `filter_reference_batched` :230.

The public functions keep hmtpu's signatures.  On CUDA tensors they
launch kernel K2 (csrc/intra_pred.cu): `intra_filter` for the [1 2 1]
reference filter and strong smoothing, `intra_pred` for planar, DC and
the 33 angular modes with the luma edge filters, one entry point taking
a per-block mode list (all 35 modes, or one mode per block).  On CPU
tensors they run the plain PyTorch versions beside them, which use
hmtpu's gather tables.

Reference lines are (B, 4N+1) int32 in the layout of ops/intra_ref.py.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from hmtpu_torch import kernels
from hmtpu_torch.ops.intra_ref import ANGLES, INV_ANGLES, should_filter


@lru_cache(maxsize=None)
def _angular_tables(n: int):
    """idx (33,N,N) into the 4N+1 ref line, fact (33,N,N) weights."""
    idx0 = np.zeros((33, n, n), dtype=np.int64)
    idx1 = np.zeros((33, n, n), dtype=np.int64)
    fact = np.zeros((33, n, n), dtype=np.int32)
    for mi, a in enumerate(ANGLES):
        mode = mi + 2
        a = int(a)
        inv = INV_ANGLES.get(a, 0)

        def map_t(t: int) -> int:
            if mode >= 18:
                if t >= 0:
                    return 2 * n + t
                return 2 * n - ((t * inv + 128) >> 8)
            if t >= 0:
                return 2 * n - t
            return 2 * n + ((t * inv + 128) >> 8)

        for y in range(n):
            for x in range(n):
                # main-axis coordinate: rows for >=18, cols for <18
                major, minor = (y, x) if mode >= 18 else (x, y)
                ii = ((major + 1) * a) >> 5
                ff = ((major + 1) * a) & 31
                t = minor + ii + 1
                idx0[mi, y, x] = map_t(t)
                # second tap goes through the same projection map; the
                # only clamp case is t+1 == 2N+1, where the weight is 0
                idx1[mi, y, x] = map_t(min(t + 1, 2 * n))
                fact[mi, y, x] = ff
    return idx0, idx1, fact


@lru_cache(maxsize=None)
def _mode_uses_filtered(n: int, is_luma: bool) -> np.ndarray:
    return np.array([should_filter(m, n, is_luma) for m in range(35)],
                    dtype=bool)


_DEV: dict = {}


def _tables(n: int, is_luma: bool, device):
    key = (n, is_luma, str(device))
    t = _DEV.get(key)
    if t is None:
        idx0, idx1, fact = _angular_tables(n)
        t = tuple(torch.as_tensor(a).to(device) for a in (
            idx0, idx1, fact, _mode_uses_filtered(n, is_luma)))
        _DEV[key] = t
    return t


# ---------------------------------------------------------------------------
# plain PyTorch versions

def filter_reference_plain(ref, n: int, bit_depth: int = 8,
                           strong: bool = True):
    smoothed = ref.clone()
    smoothed[:, 1:-1] = (ref[:, :-2] + 2 * ref[:, 1:-1] + ref[:, 2:]
                         + 2) >> 2
    if not (strong and n == 32):
        return smoothed
    thr = 1 << (bit_depth - 5)
    corner = ref[:, 2 * n]
    topmid = ref[:, 2 * n + 1 + (n - 1)]
    topend = ref[:, 4 * n]
    leftmid = ref[:, 2 * n - 1 - (n - 1)]
    leftend = ref[:, 0]
    bi = ((corner + topend - 2 * topmid).abs() < thr) & \
         ((corner + leftend - 2 * leftmid).abs() < thr)
    ys = torch.arange(2 * n - 1, device=ref.device)
    li = 2 * n - 1 - ys
    lvals = ((63 - ys)[None] * corner[:, None]
             + (ys + 1)[None] * leftend[:, None] + 32) >> 6
    tvals = ((63 - ys)[None] * corner[:, None]
             + (ys + 1)[None] * topend[:, None] + 32) >> 6
    bilin = ref.clone()
    bilin[:, li] = lvals.to(ref.dtype)
    bilin[:, 2 * n + 1 + ys] = tvals.to(ref.dtype)
    return torch.where(bi[:, None], bilin, smoothed)


def predict_modes_plain(ref_unfilt, ref_filt, modes, n: int,
                        is_luma: bool = True, bit_depth: int = 8):
    """(B, 4N+1) x2 refs + (B, M) modes -> (B, M, N, N) int32."""
    dev = ref_unfilt.device
    b, m = modes.shape
    idx0, idx1, fact, use_filt = _tables(n, is_luma, dev)
    line = 4 * n + 1
    refs = torch.stack([ref_unfilt, ref_filt], 1).reshape(b, 2 * line)
    modes = modes.to(torch.int64)

    am = torch.clamp(modes - 2, 0, 32)
    src = use_filt[modes].to(torch.int64)                  # (B, M)
    f0 = idx0[am] + (src * line)[..., None, None]
    f1 = idx1[am] + (src * line)[..., None, None]
    ff = fact[am]
    r0 = torch.gather(refs, 1, f0.reshape(b, -1)).reshape(b, m, n, n)
    r1 = torch.gather(refs, 1, f1.reshape(b, -1)).reshape(b, m, n, n)
    out = ((32 - ff) * r0 + ff * r1 + 16) >> 5

    def left(r, y):                  # p[-1][y]
        return r[:, 2 * n - 1 - y]

    def top(r, x):                   # p[x][-1]
        return r[:, 2 * n + 1 + x]

    ys = torch.arange(n, device=dev)
    xs = ys
    uref = ref_unfilt
    sel = lambda k: (modes == k)[..., None, None]

    if is_luma and n < 32:
        maxv = (1 << bit_depth) - 1
        corner_u = left(uref, -1)[:, None]
        col = torch.clamp(top(uref, 0)[:, None]
                          + ((left(uref, ys) - corner_u) >> 1), 0, maxv)
        o26 = out.clone()
        o26[..., 0] = col[:, None, :]
        out = torch.where(sel(26), o26, out)
        row = torch.clamp(left(uref, 0)[:, None]
                          + ((top(uref, xs) - corner_u) >> 1), 0, maxv)
        o10 = out.clone()
        o10[..., 0, :] = row[:, None, :]
        out = torch.where(sel(10), o10, out)

    # planar (8.4.4.2.4), filtered ref when the size filters
    pref = ref_filt if bool(_mode_uses_filtered(n, is_luma)[0]) \
        else ref_unfilt
    log2n = int(n).bit_length() - 1
    l_col = left(pref, ys)[:, :, None]
    t_row = top(pref, xs)[:, None, :]
    top_n = top(pref, n)[:, None, None]
    left_n = left(pref, n)[:, None, None]
    wx = (n - 1 - xs)[None, None, :]
    wy = (n - 1 - ys)[None, :, None]
    planar = ((wx * l_col + (xs + 1)[None, None, :] * top_n
               + wy * t_row + (ys + 1)[None, :, None] * left_n
               + n) >> (log2n + 1))
    out = torch.where(sel(0), planar[:, None], out)

    # DC (8.4.4.2.5), always unfiltered
    dc = (top(uref, xs).sum(-1) + left(uref, ys).sum(-1) + n) \
        >> (log2n + 1)
    dc_pred = dc[:, None, None].expand(b, n, n).clone()
    if is_luma and n < 32:
        dc_pred[:, 0, :] = (top(uref, xs) + 3 * dc[:, None] + 2) >> 2
        dc_pred[:, :, 0] = (left(uref, ys) + 3 * dc[:, None] + 2) >> 2
        dc_pred[:, 0, 0] = (left(uref, 0) + 2 * dc + top(uref, 0)
                            + 2) >> 2
    out = torch.where(sel(1), dc_pred[:, None], out)
    return out.to(torch.int32)


# ---------------------------------------------------------------------------
# wrappers: kernel K2 on the card, the plain version on the CPU

def filter_reference_batched(ref, n: int, bit_depth: int = 8,
                             strong: bool = True):
    """(B, 4N+1) -> (B, 4N+1) smoothed reference lines; applies the
    strong bilinear filter per-block when eligible (N==32 only)."""
    if not ref.is_cuda:
        return filter_reference_plain(ref, n, bit_depth, strong)
    ref = ref.contiguous()
    if ref.shape[-1] != 4 * n + 1:
        raise ValueError(f"reference lines must be 4N+1 = {4 * n + 1}")
    out = torch.empty_like(ref)
    if ref.shape[0]:
        kernels.launch("intra_filter", "hm_intra_filter", ref, out,
                       ref.shape[0], n, bit_depth, int(bool(strong)))
    return out


def predict_modes(ref_unfilt, ref_filt, modes, n: int,
                  is_luma: bool = True, bit_depth: int = 8):
    """(B, 4N+1) x2 refs + (B, M) int32 modes -> (B, M, N, N): block b
    predicted with each of its modes."""
    if not ref_unfilt.is_cuda:
        return predict_modes_plain(ref_unfilt, ref_filt, modes, n,
                                   is_luma, bit_depth)
    ref_unfilt = ref_unfilt.contiguous()
    ref_filt = ref_filt.contiguous()
    modes = modes.to(torch.int32).contiguous()
    b, m = modes.shape
    if ref_unfilt.shape != (b, 4 * n + 1) or ref_filt.shape != (b, 4 * n + 1):
        raise ValueError("reference lines must be (B, 4N+1)")
    out = torch.empty((b, m, n, n), dtype=torch.int32,
                      device=ref_unfilt.device)
    if b and m:
        kernels.launch("intra_pred", "hm_intra_pred", ref_unfilt,
                       ref_filt, modes, out, b, m, n, int(bool(is_luma)),
                       bit_depth)
    return out


def predict_all_modes(ref_unfilt, ref_filt, n: int, is_luma: bool = True,
                      bit_depth: int = 8):
    """(B, 4N+1) x2 -> (B, 35, N, N) predictions for every intra mode."""
    b = ref_unfilt.shape[0]
    modes = torch.arange(35, dtype=torch.int32,
                         device=ref_unfilt.device).expand(b, 35)
    return predict_modes(ref_unfilt, ref_filt, modes, n, is_luma,
                         bit_depth)


def predict_one_mode(ref_unfilt, ref_filt, mode, n: int,
                     is_luma: bool = True, bit_depth: int = 8):
    """(B, 4N+1) x2 refs + (B,) mode -> (B, N, N): each block predicted
    with its own mode."""
    return predict_modes(ref_unfilt, ref_filt, mode[:, None], n, is_luma,
                         bit_depth)[:, 0]
