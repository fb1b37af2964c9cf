"""Batched integer motion estimation, SATD and the motion-field
coherence pass: the port of hmtpu/search/me.py (`integer_me_sad_volume`
:29, `_bits_of` :63, `_volume_best` :72, `integer_me` :107,
`integer_me_levels` :120, `satd_batch` :159, `_block_sad_int` :178,
`regularize_mv_field` :194, `mv_bits_dev_f` :239, `_FRAC_OFFS` :174,
`frac_refine_batch` :249).

Four hand-written kernels live behind these functions:

  K5 me_sad (csrc/me_sad.cu, over me_sad.cuh)   `integer_me_levels` on
      a CUDA tensor: the full +-srange window of every 8x8 block, summed
      to 16x16 and 32x32 in the same pass, the motion cost added and the
      argmin and 3x3 SAD stencil taken without writing the SAD volume;
  K13 me_sad1 (csrc/me_sad.cu, over me_sad.cuh)  `integer_me` on a
      CUDA tensor: the same search at one level (8x8 blocks, any sides
      that are multiples of 8, 8- or 10-bit samples) with a quarter-pel
      predictor per block in the motion cost;
  K8 satd8 (csrc/satd.cu)      `satd_batch` on a CUDA tensor;
  K9 frac_refine (csrc/frac_refine.cu, over frac_refine.cuh)
      `frac_refine_batch` on a CUDA stack and `frac_refine_levels` (the
      P / B pass's three CU levels in one launch, the original plane read
      in place): HM's two-stage DCT-IF sub-pel search, a warp a block,
      both stages and all 18 candidates inside it.

On CPU tensors they run their plain PyTorch versions (`*_plain`), the
reference's own formulation (the SAD volume, then argmin; the candidate
loop over K7's and K8's plain versions).  The coherence pass is plain
PyTorch on every device.
"""
from __future__ import annotations

import numpy as np
import torch

from hmtpu_torch import kernels
from hmtpu_torch.ops.ratebits import floor_log2


def _edge_index(n: int, r: int, device):
    return torch.clamp(torch.arange(-r, n + r, device=device), 0, n - 1)


def integer_me_sad_volume(ref, org, bsize: int, srange: int):
    """SAD of every aligned bsize x bsize block against every integer
    displacement in [-srange, srange]^2: (D, By, Bx) int32, D row-major
    over (dy, dx).  Reference taps are edge-replicated.  One step per dy
    with every dx at once, as the reference scans."""
    h, w = ref.shape
    r = srange
    side = 2 * r + 1
    dev = ref.device
    padded = ref[_edge_index(h, r, dev)][:, _edge_index(w, r, dev)]
    col_idx = torch.arange(side, device=dev)[:, None] \
        + torch.arange(w, device=dev)[None, :]
    vol = []
    for dy in range(side):
        win = padded[dy:dy + h][:, col_idx]                # (h, side, w)
        ad = (org[:, None, :] - win).abs()
        s = ad.reshape(h // bsize, bsize, side, w // bsize, bsize) \
            .sum((1, 4), dtype=torch.int32)                # (bh, side, bw)
        vol.append(s.transpose(0, 1))
    return torch.stack(vol).reshape(side * side, h // bsize, w // bsize)


def _bits_of(v):
    """Signed Exp-Golomb MV-component bit length (capability of
    TComRdCost::xGetComponentBits): code number v<=0 ? -2v+1 : 2v."""
    code = torch.where(v <= 0, ((-v) << 1) + 1, v << 1)
    return 2 * floor_log2(code) + 1


def _volume_best(vol, srange: int, lambda_sqrt, pred_mv_x, pred_mv_y):
    """argmin + 3x3 stencil over a (D, By, Bx) SAD volume: cost =
    float32(SAD) + float32(bits) * lambda_sqrt, ties to the first index
    in row-major (dy, dx) order; the stencil clamps at the window edge.
    Returns ((mvx, mvy), (By, Bx, 3, 3) stencil, best SAD)."""
    r = srange
    side = 2 * r + 1
    dev = vol.device
    lambda_sqrt = torch.as_tensor(lambda_sqrt, dtype=torch.float32,
                                  device=dev)
    d = torch.arange(side * side, device=dev)
    dy = (d // side - r).to(torch.int32)
    dx = (d % side - r).to(torch.int32)
    mvq_x = (dx * 4)[:, None, None] - pred_mv_x[None]
    mvq_y = (dy * 4)[:, None, None] - pred_mv_y[None]
    mvcost = (_bits_of(mvq_x) + _bits_of(mvq_y)).to(torch.float32) \
        * lambda_sqrt
    cost = vol.to(torch.float32) + mvcost
    by, bx = vol.shape[1], vol.shape[2]
    best = cost.reshape(side * side, -1).argmin(0).reshape(by, bx)
    best_dy = best // side
    best_dx = best % side
    off = torch.arange(-1, 2, device=dev)
    oy = torch.clamp(best_dy[..., None, None] + off[None, None, :, None],
                     0, side - 1)
    ox = torch.clamp(best_dx[..., None, None] + off[None, None, None, :],
                     0, side - 1)
    flat = oy * side + ox                                  # (By, Bx, 3, 3)
    volt = vol.permute(1, 2, 0)
    iy = torch.arange(by, device=dev)[:, None, None, None]
    ix = torch.arange(bx, device=dev)[None, :, None, None]
    stencil = volt[iy, ix, flat]
    best_sad = volt[torch.arange(by, device=dev)[:, None],
                    torch.arange(bx, device=dev)[None, :], best]
    return (((best_dx - r).to(torch.int32), (best_dy - r).to(torch.int32)),
            stencil, best_sad)


# me_sad.cuh's MAX_R: the staged rows of a (region, dy chunk)
ME_MAX_SRANGE = 64


def integer_me_plain(ref, org, bsize: int, srange: int, lambda_sqrt,
                     pred_mv_x, pred_mv_y):
    """Plain version of K13: the SAD volume, then `_volume_best`."""
    vol = integer_me_sad_volume(ref, org, bsize, srange)
    return _volume_best(vol, srange, lambda_sqrt, pred_mv_x, pred_mv_y)


def integer_me(ref, org, bsize: int, srange: int, lambda_sqrt,
               pred_mv_x, pred_mv_y, bd: int = 8):
    """Full-window integer ME for every aligned block of one size, with
    a quarter-pel MV predictor per block (By, Bx) in the motion cost
    (the one-level form: pictures whose sides are not multiples of 16,
    and dataset extraction).  K13 on CUDA planes of bd-bit samples (8 or
    10: K13 stages them as bytes or halfwords; 8x8 blocks, sides
    multiples of 8), the plain version on CPU ones.  Returns ((mvx, mvy)
    full-pel, (By, Bx, 3, 3) SAD stencil, best SAD), int32."""
    if not ref.is_cuda:
        return integer_me_plain(ref, org, bsize, srange, lambda_sqrt,
                                pred_mv_x, pred_mv_y)
    if bd not in (8, 10):
        raise ValueError(f"me_sad1: 8- or 10-bit samples, got bd {bd}")
    h, w = org.shape
    if bsize != 8 or h % 8 or w % 8 or ref.shape != org.shape:
        raise ValueError(f"me_sad1: 8x8 blocks of planes that match and "
                         f"are multiples of 8, got bsize {bsize}, "
                         f"{tuple(ref.shape)} / {tuple(org.shape)}")
    if not 0 <= srange <= ME_MAX_SRANGE:
        raise ValueError(f"me_sad1: search range up to {ME_MAX_SRANGE}, "
                         f"got {srange}")
    bh, bw = h // 8, w // 8
    if tuple(pred_mv_x.shape) != (bh, bw) \
            or tuple(pred_mv_y.shape) != (bh, bw):
        raise ValueError(f"me_sad1: predictors must be ({bh}, {bw})")
    i32 = lambda a: a.to(torch.int32).contiguous()
    # per block: mvx, mvy, best SAD, the 3x3 stencil
    o = torch.empty((bh * bw, 12), dtype=torch.int32, device=ref.device)
    # the chunks' merged (cost, index) keys: 16 uint64 a 32x32 region
    keys = torch.empty((((bh + 3) // 4) * ((bw + 3) // 4), 32),
                       dtype=torch.int32, device=ref.device)
    kernels.launch("me_sad1", "hm_me_sad1", i32(ref), i32(org),
                   i32(pred_mv_x), i32(pred_mv_y), o, keys, h, w, srange,
                   bd, float(lambda_sqrt))
    return ((o[:, 0].reshape(bh, bw), o[:, 1].reshape(bh, bw)),
            o[:, 3:].reshape(bh, bw, 3, 3), o[:, 2].reshape(bh, bw))


def integer_me_levels_plain(ref, org, srange: int, lambda_sqrt,
                            qh: int, qw: int):
    """Plain version of K5: integer ME for the 8/16/32 CU levels from
    ONE 8x8 SAD volume (a larger block's SAD is the sum of its 8x8
    cells'); qh/qw are the padded 32-grid dims, whose strip lanes sum
    zeros.  Returns {8: ((mvx, mvy), stencil, sad), 16: ..., 32: ...}."""
    bh, bw = org.shape[0] // 8, org.shape[1] // 8
    gh, gw = bh // 2, bw // 2
    d = (2 * srange + 1) ** 2
    vol8 = integer_me_sad_volume(ref, org, 8, srange)
    vol16 = vol8.reshape(d, gh, 2, gw, 2).sum((2, 4), dtype=torch.int32)
    vol32 = torch.nn.functional.pad(vol16, (0, qw * 2 - gw, 0, qh * 2 - gh))
    vol32 = vol32.reshape(d, qh, 2, qw, 2).sum((2, 4), dtype=torch.int32)
    z = lambda a, b: torch.zeros((a, b), dtype=torch.int32,
                                 device=ref.device)
    return {
        8: _volume_best(vol8, srange, lambda_sqrt, z(bh, bw), z(bh, bw)),
        16: _volume_best(vol16, srange, lambda_sqrt, z(gh, gw), z(gh, gw)),
        32: _volume_best(vol32, srange, lambda_sqrt, z(qh, qw), z(qh, qw)),
    }


def integer_me_levels(ref, org, srange: int, lambda_sqrt, qh: int, qw: int,
                      bd: int = 8):
    """K5 on CUDA planes, its plain version on CPU ones.  ref, org:
    (H, W) int32 samples of bd bits (8 or 10: K5 stages them as bytes or
    halfwords), H and W multiples of 16; lambda_sqrt a float32 number.
    Same return value as `integer_me_levels_plain`."""
    if not ref.is_cuda:
        return integer_me_levels_plain(ref, org, srange, lambda_sqrt, qh, qw)
    if bd not in (8, 10):
        raise ValueError(f"me_sad: 8- or 10-bit samples, got bd {bd}")
    h, w = org.shape
    if h % 16 or w % 16 or ref.shape != org.shape:
        raise ValueError(f"me_sad: planes must match and be multiples of "
                         f"16, got {tuple(ref.shape)} / {tuple(org.shape)}")
    if not 0 <= srange <= ME_MAX_SRANGE:
        raise ValueError(f"me_sad: search range up to {ME_MAX_SRANGE}, got "
                         f"{srange}")
    bh, bw = h // 8, w // 8
    gh, gw = bh // 2, bw // 2
    if qh != (gh + 1) // 2 or qw != (gw + 1) // 2:
        raise ValueError("me_sad: qh/qw must be the ceil 32-grid")
    i32 = lambda a: a.to(torch.int32).contiguous()
    dev = ref.device
    # per lane: mvx, mvy, best SAD, the 3x3 stencil
    o8 = torch.empty((bh * bw, 12), dtype=torch.int32, device=dev)
    o16 = torch.empty((gh * gw, 12), dtype=torch.int32, device=dev)
    o32 = torch.empty((qh * qw, 12), dtype=torch.int32, device=dev)
    # the chunks' merged (cost, index) keys: 21 uint64 a region
    keys = torch.empty((qh * qw, 42), dtype=torch.int32, device=dev)
    kernels.launch("me_sad", "hm_me_sad_levels", i32(ref), i32(org), o8, o16,
                   o32, keys, h, w, srange, bd, float(lambda_sqrt))

    def unpack(o, a, b):
        return ((o[:, 0].reshape(a, b), o[:, 1].reshape(a, b)),
                o[:, 3:].reshape(a, b, 3, 3), o[:, 2].reshape(a, b))

    return {8: unpack(o8, bh, bw), 16: unpack(o16, gh, gw),
            32: unpack(o32, qh, qw)}


# ---------------------------------------------------------------------------
# SATD (K8)

def hadamard_matrix(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


_H8: dict = {}


def satd_batch_plain(a, b, bsize: int):
    """Plain version of K8: HM's 8x8 Hadamard SATD (xCalcHADs8x8,
    (sum|H D H| + 2) >> 2) summed over the 8x8 tiles of each block."""
    dev = a.device
    h8 = _H8.get(str(dev))
    if h8 is None:
        h8 = _H8[str(dev)] = torch.as_tensor(hadamard_matrix(8)).to(dev)
    d = (a - b).to(torch.int64)
    nb = bsize // 8
    B = d.shape[0]
    d = d.reshape(B, nb, 8, nb, 8).permute(0, 1, 3, 2, 4)
    t = (h8[:, :, None] * d[..., None, :, :]).sum(-2)          # H @ D
    t = (t[..., :, :, None] * h8[None, :, :]).sum(-2)          # (H D) @ H
    s = t.abs().sum((-1, -2))
    return ((s + 2) >> 2).sum((1, 2)).to(torch.int32)


def satd_batch(a, b, bsize: int):
    """(B, n, n) int32 pairs -> (B,) int32 SATD: K8 on CUDA tensors, the
    plain version on CPU ones."""
    if not a.is_cuda:
        return satd_batch_plain(a, b, bsize)
    if bsize % 8 or bsize > 64 or a.shape != b.shape \
            or tuple(a.shape[1:]) != (bsize, bsize):
        raise ValueError(f"satd8: expected (B, {bsize}, {bsize}) pairs, got "
                         f"{tuple(a.shape)} / {tuple(b.shape)}")
    B = int(a.shape[0])
    out = torch.empty((B,), dtype=torch.int32, device=a.device)
    if B:
        kernels.launch("satd8", "hm_satd8", kernels.ready(a),
                       kernels.ready(b), out, B, bsize)
    return out


def _grid_blocks(plane, n: int, gw: int, nb: int):
    """The nb blocks of an n-grid gw cells wide over plane (h, w), block
    i at ((i % gw) n, (i // gw) n): (nb, n, n), the plane edge-padded
    (last row and column replicated) where the grid reaches past it."""
    h, w = plane.shape
    gh = nb // gw
    if (gh * n, gw * n) != (h, w):
        dev = plane.device
        rows = torch.clamp(torch.arange(gh * n, device=dev), max=h - 1)
        cols = torch.clamp(torch.arange(gw * n, device=dev), max=w - 1)
        plane = plane[rows][:, cols]
    return plane.reshape(gh, n, gw, n).transpose(1, 2).reshape(-1, n, n)


def satd_gate_levels_plain(org, levels):
    """Plain version of K8's gate form: each level's original blocks
    (`_grid_blocks`: the blockified plane, edge-padded where the grid
    reaches past it), their SATD against both predictions
    (`satd_batch_plain`) and the first MV set where it is strictly
    lower, as the P pass's NN-FME gate composed them."""
    out = []
    for (p0, p1), mvx, mvy, n, gw in levels:
        blocks = _grid_blocks(org, n, gw, int(mvx.shape[1]))
        better = satd_batch_plain(blocks, p0, n) \
            < satd_batch_plain(blocks, p1, n)
        out.append((torch.where(better, mvx[0], mvx[1]),
                    torch.where(better, mvy[0], mvy[1])))
    return out


def satd_gate_levels(org, levels):
    """The NN-FME gate of up to three CU levels in one call: org the
    (h, w) original plane; levels [((pred0, pred1), mvx, mvy, n, gw)],
    each level's blocks of an n-grid gw cells wide (block i at ((i % gw)
    n, (i // gw) n), read with rows and columns clamped to the plane),
    their two predictions (B, n, n) (`mc_luma2`'s) under the quarter-pel
    MV sets mvx / mvy (2, B).  Returns [(x, y) (B,) a level]: the first
    set's MV where its SATD is strictly below the second's, else the
    second's.  K8 on CUDA tensors (one launch), the plain version on CPU
    ones; on the card the tensors are readied here and go to
    kernels.launch_checked as pointers."""
    if not org.is_cuda:
        return satd_gate_levels_plain(org, levels)
    h, w = org.shape
    if not 1 <= len(levels) <= 3 or w % 8:
        raise ValueError(f"satd8 gate: 1-3 levels over a plane a multiple "
                         f"of 8 wide, got {len(levels)} levels, "
                         f"{tuple(org.shape)}")
    dev = org.get_device()
    org = kernels.ready(org)
    nbs = [int(lv[1].shape[1]) for lv in levels]
    # the levels' (x, y) rows one after another
    out = torch.empty((2 * sum(nbs),), dtype=torch.int32, device=org.device)
    outs = out.split([2 * nb for nb in nbs])
    # the readied inputs live until the launch (a copy freed before it
    # could be handed to the next level's)
    ptrs, geo, keep = [], [], []
    for ((p0, p1), mvx, mvy, n, gw), nb, o in zip(levels, nbs, outs):
        if n % 8 or n > 64 or nb % gw or any(
                tuple(p.shape) != (nb, n, n) for p in (p0, p1)) \
                or tuple(mvx.shape) != (2, nb) \
                or tuple(mvy.shape) != (2, nb):
            raise ValueError(f"satd8 gate: level n {n}, grid width {gw}: "
                             f"predictions {tuple(p0.shape)}, "
                             f"{tuple(p1.shape)}, MVs {tuple(mvx.shape)}, "
                             f"{tuple(mvy.shape)}")
        ts = [kernels.ready(t) for t in (p0, p1, mvx, mvy)]
        if any(t.get_device() != dev for t in ts):
            raise ValueError("satd8 gate: every tensor on the plane's "
                             "CUDA device")
        keep += ts
        ptrs += [t.data_ptr() for t in ts] + [o.data_ptr()]
        geo += [n, gw, nb]
    pad = 3 - len(levels)
    kernels.launch_checked("satd8", "hm_satd_gate", dev, org.data_ptr(),
                           *ptrs, *(None,) * (5 * pad), h, w, len(levels),
                           *geo, *(0,) * (3 * pad))
    return [(o[:nb], o[nb:]) for o, nb in zip(outs, nbs)]


# ---------------------------------------------------------------------------
# motion-field coherence (K19 on the card)

def _block_sad_int(refs, ridx, mvx, mvy, org_blk, bw, bh):
    """SAD of every 8x8 block against its (integer-pel mvx, mvy) into
    its selected reference; shapes (bh, bw), float32 out."""
    _, hh, ww = refs.shape
    dev = refs.device
    ar8 = torch.arange(8, device=dev)
    y0 = torch.arange(bh, device=dev)[:, None] * 8
    x0 = torch.arange(bw, device=dev)[None, :] * 8
    yy = torch.clamp(y0[:, :, None, None] + mvy[:, :, None, None]
                     + ar8[None, None, :, None], 0, hh - 1)
    xx = torch.clamp(x0[:, :, None, None] + mvx[:, :, None, None]
                     + ar8[None, None, None, :], 0, ww - 1)
    pred = refs[ridx.to(torch.int64)[:, :, None, None], yy.to(torch.int64),
                xx.to(torch.int64)]
    return (org_blk - pred).abs().sum((-1, -2)).to(torch.float32)


def mv_bits_dev_f(vx, vy):
    """Full-pel mvd bit estimate (quarter-pel scaled)."""
    def bl(v):
        a = (v * 4).abs()
        return torch.where(a > 0, floor_log2(a) + 1, 0)

    return (2 * bl(vx) + 2 * bl(vy) + 2).to(torch.float32)


def regularize_mv_field(refs, org_y, mvx, mvy, ridx, lam_sqrt,
                        iters: int = 3):
    """The motion-field coherence pass: K19 on CUDA tensors (every Jacobi
    round in one launch, rounds meeting at a grid-wide barrier), the
    plain version on CPU ones; arguments and results as
    `regularize_mv_field_plain`.  On the card the result is a new field
    of int32 tensors (the inputs as they are for iters 0), lam_sqrt read
    from device memory (a float32 scalar tensor on the card is used in
    place)."""
    if not refs.is_cuda:
        return regularize_mv_field_plain(refs, org_y, mvx, mvy, ridx,
                                         lam_sqrt, iters)
    r, h, w = refs.shape
    bh, bw = h // 8, w // 8
    if tuple(org_y.shape) != (h, w) or h % 8 or w % 8 or any(
            tuple(a.shape) != (bh, bw) for a in (mvx, mvy, ridx)):
        raise ValueError(f"mv_regularize: (R, H, W) references, an (H, W) "
                         f"picture with sides multiples of 8 and (H/8, W/8) "
                         f"fields, got {tuple(refs.shape)}, "
                         f"{tuple(org_y.shape)}, {tuple(mvx.shape)}")
    if iters <= 0:
        return mvx, mvy, ridx
    dev = refs.get_device()
    lam = lam_sqrt if isinstance(lam_sqrt, torch.Tensor) \
        and lam_sqrt.dtype is torch.float32 and lam_sqrt.numel() == 1 \
        and lam_sqrt.is_cuda and lam_sqrt.get_device() == dev \
        else torch.tensor(float(lam_sqrt), dtype=torch.float32,
                          device=refs.device)
    ts = [kernels.ready(t) for t in (refs, org_y, mvx, mvy, ridx)]
    if any(t.get_device() != dev for t in ts[1:]):
        raise ValueError("mv_regularize: every tensor on the references' "
                         "CUDA device")
    # the returned field, then the scratch one
    buf = torch.empty((2, 3, bh, bw), dtype=torch.int32, device=refs.device)
    base, plane = buf.data_ptr(), 4 * bh * bw
    kernels.launch_checked(
        "mv_regularize", "hm_mv_regularize", dev,
        *(t.data_ptr() for t in ts), lam.data_ptr(),
        *(base + plane * i for i in range(6)), r, h, w, int(iters))
    return buf[0].unbind(0)


def regularize_mv_field_plain(refs, org_y, mvx, mvy, ridx, lam_sqrt,
                              iters: int = 3):
    """Plain version of K19: the motion-field coherence pass: each block
    re-picks its (mv, ref) among {self, its 4 neighbours, zero} minimising
    SAD + lam_sqrt * bits, where a candidate equal to a current neighbour
    costs 2 bits and another pays its mvd bits against the left
    neighbour.  Jacobi iterations; the neighbour shift wraps around the
    picture edge, as the reference's `roll` does.  mv in full pel,
    (bh, bw)."""
    bh, bw = mvx.shape
    org_blk = org_y.reshape(bh, 8, bw, 8).transpose(1, 2)

    def shift(a, dy, dx):
        return torch.roll(a, (dy, dx), (0, 1))

    for _ in range(iters):
        nbs = [(shift(mvx, dy, dx), shift(mvy, dy, dx),
                shift(ridx, dy, dx))
               for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0))]
        cands = [(mvx, mvy, ridx)] + nbs \
            + [(torch.zeros_like(mvx), torch.zeros_like(mvy),
                torch.zeros_like(ridx))]
        costs = []
        for cx, cy, cr in cands:
            sad = _block_sad_int(refs, cr, cx, cy, org_blk, bw, bh)
            eq = torch.zeros(mvx.shape, dtype=torch.bool, device=mvx.device)
            for nx, ny, nr in nbs:
                eq = eq | ((cx == nx) & (cy == ny) & (cr == nr))
            mvd = mv_bits_dev_f(cx - nbs[1][0], cy - nbs[1][1])
            bits = torch.where(eq, 2.0, mvd + 1.0)
            costs.append(sad + lam_sqrt * bits)
        best = torch.stack(costs).argmin(0)[None]
        mvx = torch.gather(torch.stack([c[0] for c in cands]), 0, best)[0]
        mvy = torch.gather(torch.stack([c[1] for c in cands]), 0, best)[0]
        ridx = torch.gather(torch.stack([c[2] for c in cands]), 0, best)[0]
    return mvx, mvy, ridx


# ---------------------------------------------------------------------------
# DCT-IF fractional refinement (the subpel="dctif" arm)

# (dy, dx) of the 9 candidates of a stage, the centre first
_FRAC_OFFS = np.array([(0, 0), (0, -1), (0, 1), (-1, 0), (1, 0),
                       (-1, -1), (-1, 1), (1, -1), (1, 1)], np.int32)


def frac_refine_batch_plain(refs, xs0, ys0, org_blocks, int_mvx, int_mvy,
                            bsize: int, bd: int = 8, ridx=None):
    """Plain version of K9: nine half-pel candidates around the integer
    MV, then nine quarter-pel candidates around the half-pel winner,
    each priced by SATD against its DCT-IF prediction; the first of
    least cost wins (xPatternSearchFracDIF semantics,
    TEncSearch.cpp:5232-5268).  Returns quarter-pel MVs."""
    from hmtpu_torch.ops.interp import mc_batch_plain

    if refs.dim() == 2:
        refs = refs[None]
    if ridx is None:
        ridx = torch.zeros_like(xs0)
    offs = torch.as_tensor(_FRAC_OFFS, dtype=torch.int64).to(refs.device)

    def stage(mvq_x, mvq_y, step):
        costs = torch.stack([satd_batch_plain(
            org_blocks, mc_batch_plain(
                refs, ridx, xs0, ys0, mvq_x + int(_FRAC_OFFS[k, 1]) * step,
                mvq_y + int(_FRAC_OFFS[k, 0]) * step, bsize, bsize, False,
                bd), bsize) for k in range(9)], 1)            # (B, 9)
        best = costs.argmin(1)
        return (mvq_x + (offs[best, 1] * step).to(mvq_x.dtype),
                mvq_y + (offs[best, 0] * step).to(mvq_y.dtype))

    mv = stage(int_mvx * 4, int_mvy * 4, 2)
    return stage(*mv, 1)


def frac_refine_batch(refs, xs0, ys0, org_blocks, int_mvx, int_mvy,
                      bsize: int, bd: int = 8, ridx=None):
    """HM-shaped two-stage fractional refinement, batched (hmtpu
    me.py:249): `refs` is one (H, W) plane, or a (R, H, W) stack with
    per-block `ridx`; org_blocks (B, n, n), integer MVs (B,).  K9 on a
    CUDA stack, the plain version on a CPU one."""
    if not refs.is_cuda:
        return frac_refine_batch_plain(refs, xs0, ys0, org_blocks, int_mvx,
                                       int_mvy, bsize, bd, ridx)
    if refs.dim() == 2:
        refs = refs[None]
    if bsize not in (8, 16, 32) or tuple(org_blocks.shape[1:]) != \
            (bsize, bsize):
        raise ValueError(f"frac_refine: expected (B, {bsize}, {bsize}) "
                         f"org blocks of 8, 16 or 32, got "
                         f"{tuple(org_blocks.shape)}")
    i32 = lambda a: a.to(torch.int32).contiguous()
    B = int(org_blocks.shape[0])
    if ridx is None:
        ridx = torch.zeros((B,), dtype=torch.int32, device=refs.device)
    out = torch.empty((2, B), dtype=torch.int32, device=refs.device)
    if B:
        r, h, w = refs.shape
        kernels.launch("frac_refine", "hm_frac_refine", i32(refs),
                       i32(ridx), i32(xs0), i32(ys0), i32(org_blocks),
                       i32(int_mvx), i32(int_mvy), out, B, r, h, w, bsize,
                       bd)
    return out[0], out[1]


def frac_refine_levels_plain(refs, org, levels, bd: int = 8):
    """Plain version of K9's levels form: each level's glue as the P / B
    pass composed it (the grid's block positions and its blocks of the
    original, edge-padded where the grid reaches past the plane:
    `_grid_blocks`), then `frac_refine_batch_plain`."""
    out = []
    for mx, my, rr, n in levels:
        gh, gw = mx.shape
        q = torch.arange(gh * gw, device=org.device)
        gx, gy = frac_refine_batch_plain(
            refs, (q % gw) * n, (q // gw) * n,
            _grid_blocks(org, n, gw, gh * gw), mx.reshape(-1),
            my.reshape(-1), n, bd, ridx=rr.reshape(-1))
        out.append((gx.reshape(gh, gw), gy.reshape(gh, gw)))
    return out


def frac_refine_levels(refs, org, levels, bd: int = 8):
    """HM's DCT-IF sub-pel search of up to three CU levels in one call:
    refs the (R, H, W) reference stack (or one (H, W) plane), org the
    (h, w) original luma plane; levels [(int_mvx, int_mvy, ridx, n)],
    each a (gh, gw) n-grid of integer MVs and reference indices (block i
    at ((i % gw) n, (i // gw) n), its original read with rows and columns
    clamped to the plane).  Returns [(x, y) (gh, gw) a level]: the
    quarter-pel MVs.  K9 on CUDA tensors (one launch), the plain version
    on CPU ones; on the card the tensors are readied here and go to
    kernels.launch_checked as pointers."""
    if not org.is_cuda:
        return frac_refine_levels_plain(refs, org, levels, bd)
    if refs.dim() == 2:
        refs = refs[None]
    if not 1 <= len(levels) <= 3 or org.dim() != 2:
        raise ValueError(f"frac_refine levels: 1-3 levels over a plane, "
                         f"got {len(levels)} levels, {tuple(org.shape)}")
    dev = org.get_device()
    refs, org = kernels.ready(refs), kernels.ready(org)
    nbs = [int(lv[0].numel()) for lv in levels]
    # the levels' (x, y) rows one after another
    out = torch.empty((2 * sum(nbs),), dtype=torch.int32, device=org.device)
    outs = out.split([2 * nb for nb in nbs])
    # the readied inputs (copies where a level's are not int32 already)
    # live until the launch: a copy freed before it could be handed to
    # the next level's
    ptrs, geo, keep = [], [], []
    for (mx, my, rr, n), nb, o in zip(levels, nbs, outs):
        if n not in (8, 16, 32) or mx.dim() != 2 or any(
                tuple(t.shape) != tuple(mx.shape) for t in (my, rr)):
            raise ValueError(f"frac_refine levels: level n {n}: MVs and "
                             f"references of one (gh, gw) grid, got "
                             f"{tuple(mx.shape)}, {tuple(my.shape)}, "
                             f"{tuple(rr.shape)}")
        ts = [kernels.ready(t) for t in (mx, my, rr)]
        if any(t.get_device() != dev for t in ts + [refs]):
            raise ValueError("frac_refine levels: every tensor on the "
                             "plane's CUDA device")
        keep += ts
        ptrs += [t.data_ptr() for t in ts] + [o.data_ptr()]
        geo += [n, int(mx.shape[1]), nb]
    pad = 3 - len(levels)
    r, h, w = refs.shape
    kernels.launch_checked("frac_refine", "hm_frac_levels", dev,
                           refs.data_ptr(), org.data_ptr(), *ptrs,
                           *(None,) * (4 * pad), r, h, w, *org.shape,
                           len(levels), bd, *geo, *(0,) * (3 * pad))
    return [(o[:nb].view(lv[0].shape), o[nb:].view(lv[0].shape))
            for o, nb, lv in zip(outs, nbs, levels)]
