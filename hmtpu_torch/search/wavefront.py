"""Static z-scan schedules over the block grid and the device merge /
AMVP candidate derivations: the port of hmtpu/search/wavefront.py
(the numpy builders :44-284, copied, and the device half :285-687).

The z-scan dependency DAG over the uniform 8x8 block grid is levelised
once per geometry: every block of one level can be decided at once,
because all it reads (the committed reconstruction and modes of its
neighbours) was written by earlier levels.  Also here: the per-block
substituted reference-line gather maps (8.4.4.2.2 collapses to a
constant gather because availability is geometric).

Device derivations (plain PyTorch on the pass's device; B10 and B15 in
ROADMAP.md queue their hand kernel, fused into B11's level walker): the
P-slice merge list (8.5.3.1.2 with the temporal candidate), the AMVP
list (8.5.3.1.5/6) with POC-distance scaling (8.5.3.1.3), the
collocated candidate grid (8.5.3.2.8), the MVD bit estimate, and the
B-slice forms: the two-list merge list with the combined
bi-predictive candidates (8.5.3.1.3, `merge_candidates_dev_b`) and the
two-list AMVP list (`amvp_candidates_dev_b`).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# neighbour slot order used throughout: [A1, B1, B0, A0, B2]
# block-grid offsets (dy, dx) of the 8x8 block containing each sample
NB_OFFS = ((0, -1), (-1, 0), (-1, 1), (1, -1), (-1, -1))
SLOT_A1, SLOT_B1, SLOT_B0, SLOT_A0, SLOT_B2 = range(5)


def zscan_map8(bw: int, bh: int, log2_ctu: int) -> np.ndarray:
    """Coding-order index of every 8x8 block: CTU raster order, z-order
    (Morton) inside the CTU (6.4.1 at 8-sample granularity)."""
    c8 = 1 << (log2_ctu - 3)
    ys, xs = np.mgrid[0:bh, 0:bw]
    ctu_x, ctu_y = xs // c8, ys // c8
    n_ctu_x = (bw + c8 - 1) // c8
    base = (ctu_y * n_ctu_x + ctu_x) * c8 * c8
    zx, zy = xs % c8, ys % c8
    z = np.zeros_like(zx)
    for b in range(log2_ctu - 3):
        z |= ((zx >> b) & 1) << (2 * b)
        z |= ((zy >> b) & 1) << (2 * b + 1)
    return base + z


@lru_cache(maxsize=None)
def block_schedule(w: int, h: int, log2_ctu: int):
    """Static wavefront schedule over the 8x8 grid.

    Returns dict of numpy arrays:
      level   (bh, bw)  dependency level of each block
      nb_ok   (bh, bw, 5) z-scan availability of each neighbour slot
      nb_flat (bh, bw, 5) flat block index of each neighbour (clamped)
      lv_blk  (L, Bmax) flat block index per level, -1 padded
    """
    bw, bh = w // 8, h // 8
    z = zscan_map8(bw, bh, log2_ctu)
    nb_ok = np.zeros((bh, bw, 5), dtype=bool)
    nb_flat = np.zeros((bh, bw, 5), dtype=np.int32)
    level = np.zeros((bh, bw), dtype=np.int32)
    order = np.argsort(z.ravel(), kind="stable")
    for f in order:
        y, x = divmod(int(f), bw)
        lv = 0
        for s, (dy, dx) in enumerate(NB_OFFS):
            ny, nx = y + dy, x + dx
            if 0 <= ny < bh and 0 <= nx < bw:
                nb_flat[y, x, s] = ny * bw + nx
                if z[ny, nx] < z[y, x]:
                    nb_ok[y, x, s] = True
                    lv = max(lv, level[ny, nx] + 1)
        level[y, x] = lv

    nlev = int(level.max()) + 1
    counts = np.bincount(level.ravel(), minlength=nlev)
    bmax = int(counts.max())
    lv_blk = np.full((nlev, bmax), -1, dtype=np.int32)
    fill = np.zeros(nlev, dtype=np.int64)
    for f in order:
        y, x = divmod(int(f), bw)
        lv = level[y, x]
        lv_blk[lv, fill[lv]] = f
        fill[lv] += 1
    return dict(level=level, nb_ok=nb_ok, nb_flat=nb_flat, lv_blk=lv_blk)


@lru_cache(maxsize=None)
def block_schedule16(w: int, h: int, log2_ctu: int):
    """Wavefront schedule over the 16x16 grid (the two-level CU
    decision: one 16x16 CU vs four 8x8 CUs per step).

    Returns dict:
      lv_blk  (L, Bmax) flat 16-block index per level, -1 padded
      cells   (P16, 4) flat 8x8-cell indices in z-order per 16-block
      nb_ok   (P16, 5)  z-scan availability of A1,B1,B0,A0,B2 at CU16
      nb_cell (P16, 5)  flat 8x8-cell index holding each neighbour
    """
    bw, bh = w // 8, h // 8
    gw, gh = bw // 2, bh // 2
    z = zscan_map8(gw, gh, log2_ctu - 1)      # 16-blocks z-order
    level = np.zeros((gh, gw), dtype=np.int32)
    nb_ok = np.zeros((gh * gw, 5), dtype=bool)
    nb_cell = np.zeros((gh * gw, 5), dtype=np.int32)
    order = np.argsort(z.ravel(), kind="stable")
    # neighbour sample positions of a 16x16 block at cells
    # (2gy, 2gx): A1=(x-1,y+15), B1=(x+15,y-1), B0=(x+16,y-1),
    # A0=(x-1,y+16), B2=(x-1,y-1) -> cell offsets on the 8-grid
    cell_offs = ((1, -1), (-1, 1), (-1, 2), (2, -1), (-1, -1))
    for f in order:
        gy, gx = divmod(int(f), gw)
        lv = 0
        for s, (dy, dx) in enumerate(NB_OFFS):
            ny, nx = gy + dy, gx + dx
            if 0 <= ny < gh and 0 <= nx < gw and z[ny, nx] < z[gy, gx]:
                lv = max(lv, level[ny, nx] + 1)
        level[gy, gx] = lv
        cy, cx = 2 * gy, 2 * gx
        for s, (dy, dx) in enumerate(cell_offs):
            ny, nx = cy + dy, cx + dx
            if 0 <= ny < bh and 0 <= nx < bw:
                nb_cell[f, s] = ny * bw + nx
                # availability: the neighbouring 16-block is z-earlier
                gny, gnx = ny // 2, nx // 2
                nb_ok[f, s] = z[gny, gnx] < z[gy, gx]
    nlev = int(level.max()) + 1
    counts = np.bincount(level.ravel(), minlength=nlev)
    lv_blk = np.full((nlev, int(counts.max())), -1, dtype=np.int32)
    fill = np.zeros(nlev, dtype=np.int64)
    for f in order:
        gy, gx = divmod(int(f), gw)
        lv = level[gy, gx]
        lv_blk[lv, fill[lv]] = f
        fill[lv] += 1
    cells = np.zeros((gh * gw, 4), dtype=np.int32)
    for f in range(gh * gw):
        gy, gx = divmod(f, gw)
        cy, cx = 2 * gy, 2 * gx
        # z-order within the 16-block: (0,0), (1,0), (0,1), (1,1) in
        # (dx, dy) -> cells TL, TR, BL, BR
        cells[f] = [cy * bw + cx, cy * bw + cx + 1,
                    (cy + 1) * bw + cx, (cy + 1) * bw + cx + 1]
    return dict(lv_blk=lv_blk, cells=cells, nb_ok=nb_ok,
                nb_cell=nb_cell)


@lru_cache(maxsize=None)
def block_schedule32(w: int, h: int, log2_ctu: int):
    """Wavefront schedule over the 32x32 grid (the third CU level:
    one 32x32 inter CU trialled against the committed 16/8 decision).

    The 32-grid is padded up (ceil) so pictures whose height/width is
    a multiple of 16 but not 32 still schedule; partial regions carry
    their inside 16-cells but never form a 32x32 CU (full32 False).

    Returns dict:
      lv_blk  (L, Bmax) flat 32-region index per level, -1 padded
      cells16 (P32, 4)  flat 16-grid indices in z-order, -1 outside
      cells8  (P32, 16) flat 8x8-cell indices in z-order, -1 outside
      nb_ok   (P32, 5)  z-scan availability of A1,B1,B0,A0,B2 at CU32
      nb_cell (P32, 5)  flat 8x8-cell index holding each neighbour
      full32  (P32,)    region lies fully inside the picture
    """
    bw, bh = w // 8, h // 8
    gw, gh = bw // 2, bh // 2                  # 16-grid (exact)
    qw, qh = (gw + 1) // 2, (gh + 1) // 2      # 32-grid (padded)
    z = zscan_map8(qw, qh, log2_ctu - 2)       # 32-blocks z-order
    z8 = zscan_map8(bw, bh, log2_ctu)          # full-resolution z-scan
    level = np.zeros((qh, qw), dtype=np.int32)
    nb_ok = np.zeros((qh * qw, 5), dtype=bool)
    nb_cell = np.zeros((qh * qw, 5), dtype=np.int32)
    full32 = np.zeros(qh * qw, dtype=bool)
    order = np.argsort(z.ravel(), kind="stable")
    # neighbour sample positions of a 32x32 block at 8-cells (cy, cx):
    # A1=(x-1,y+31), B1=(x+31,y-1), B0=(x+32,y-1), A0=(x-1,y+32),
    # B2=(x-1,y-1) -> cell offsets on the 8-grid
    cell_offs = ((3, -1), (-1, 3), (-1, 4), (4, -1), (-1, -1))
    for f in order:
        qy, qx = divmod(int(f), qw)
        lv = 0
        for s, (dy, dx) in enumerate(NB_OFFS):
            ny, nx = qy + dy, qx + dx
            if 0 <= ny < qh and 0 <= nx < qw and z[ny, nx] < z[qy, qx]:
                lv = max(lv, level[ny, nx] + 1)
        level[qy, qx] = lv
        cy, cx = 4 * qy, 4 * qx
        full32[f] = cy + 4 <= bh and cx + 4 <= bw
        for s, (dy, dx) in enumerate(cell_offs):
            ny, nx = cy + dy, cx + dx
            if 0 <= ny < bh and 0 <= nx < bw:
                nb_cell[f, s] = ny * bw + nx
                # available iff the neighbour cell is z-earlier than
                # the region's first sample in the full z-scan
                nb_ok[f, s] = z8[ny, nx] < z8[cy, cx]
    nlev = int(level.max()) + 1
    counts = np.bincount(level.ravel(), minlength=nlev)
    lv_blk = np.full((nlev, int(counts.max())), -1, dtype=np.int32)
    fill = np.zeros(nlev, dtype=np.int64)
    for f in order:
        qy, qx = divmod(int(f), qw)
        lv = level[qy, qx]
        lv_blk[lv, fill[lv]] = f
        fill[lv] += 1
    cells16 = np.full((qh * qw, 4), -1, dtype=np.int32)
    cells8 = np.full((qh * qw, 16), -1, dtype=np.int32)
    for f in range(qh * qw):
        qy, qx = divmod(f, qw)
        gy, gx = 2 * qy, 2 * qx
        for i, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            ny, nx = gy + dy, gx + dx
            if ny < gh and nx < gw:
                cells16[f, i] = ny * gw + nx
                cy, cx = 2 * ny, 2 * nx
                cells8[f, 4 * i:4 * i + 4] = [
                    cy * bw + cx, cy * bw + cx + 1,
                    (cy + 1) * bw + cx, (cy + 1) * bw + cx + 1]
    return dict(lv_blk=lv_blk, cells16=cells16, cells8=cells8,
                nb_ok=nb_ok, nb_cell=nb_cell, full32=full32)


@lru_cache(maxsize=None)
def static_ref_gather(w: int, h: int, log2_ctu: int, n: int):
    """Per-block substituted reference-line gather map.

    For every n x n block of a (h, w) plane: a (4n+1,) index into the
    flat plane such that plane.ravel()[idx] equals
    substitute_unavailable(gather_ref_line(plane, x, y, n), avail)
    whenever at least one reference sample is available.

    Returns (idx (P, 4n+1) int32, none_avail (P,) bool), P raster."""
    from hmtpu_torch.common.geometry import ref_availability

    bw, bh = w // n, h // n
    out = np.zeros((bh * bw, 4 * n + 1), dtype=np.int32)
    none = np.zeros(bh * bw, dtype=bool)
    k = np.arange(4 * n + 1)
    for byi in range(bh):
        for bxi in range(bw):
            x, y = bxi * n, byi * n
            avail = ref_availability(x, y, n, w, h, log2_ctu)
            # raw clamped gather positions (encoder/intra.gather_ref_line)
            ys = np.empty(4 * n + 1, dtype=np.int64)
            xs = np.empty(4 * n + 1, dtype=np.int64)
            ys[: 2 * n] = np.clip(np.arange(2 * n - 1, -1, -1) + y, 0, h - 1)
            xs[: 2 * n] = max(x - 1, 0)
            ys[2 * n] = max(y - 1, 0)
            xs[2 * n] = max(x - 1, 0)
            ys[2 * n + 1:] = max(y - 1, 0)
            xs[2 * n + 1:] = np.clip(np.arange(2 * n) + x, 0, w - 1)
            raw = ys * w + xs
            p = byi * bw + bxi
            if not avail.any():
                none[p] = True
                out[p] = 0
                continue
            # substitution source per entry (8.4.4.2.2): forward fill
            av = avail.copy()
            first = int(np.argmax(av))
            av0 = av.copy()
            av0[0] = True
            src = np.maximum.accumulate(np.where(av0, k, 0))
            if not avail[0]:
                src = np.where(src == 0, first, src)
            out[p] = raw[src]
    return out, none


# ---------------------------------------------------------------------------
# device derivations

def _first(flags, *vals):
    """Select per row the first slot whose flag is set.  flags (B, K);
    vals each (B, K).  Returns (found (B,), picked values...)."""
    found = flags.any(1)
    idx = flags.to(torch.int32).argmax(1)[:, None]
    return (found,) + tuple(torch.gather(v, 1, idx)[:, 0] for v in vals)


def merge_candidates_dev(nb_valid, nb_mvx, nb_mvy, nb_ref,
                         num_ref: int, max_merge: int,
                         t_ok=None, t_mvx=None, t_mvy=None,
                         n_active=None):
    """Vectorised merge list (8.5.3.1.2, P slice).

    nb_* are (B, 5) in slot order [A1, B1, B0, A0, B2]; nb_valid already
    folds z-scan availability AND inter-coded-ness of the neighbour.
    t_* ((B,) or None): the collocated temporal candidate (8.5.3.2.8),
    already scaled to reference 0 -- appended after the spatial
    candidates with refIdx 0, never pruned against them.  n_active (host
    int) bounds the zero-fill's reference indices when the stack is
    padded.  Returns (cand_mvx, cand_mvy, cand_ref) each (B, max_merge)."""
    v = nb_valid

    def same(i, j):
        return v[:, i] & v[:, j] & (nb_mvx[:, i] == nb_mvx[:, j]) \
            & (nb_mvy[:, i] == nb_mvy[:, j]) & (nb_ref[:, i] == nb_ref[:, j])

    incl = [v[:, SLOT_A1],
            v[:, SLOT_B1] & ~same(SLOT_B1, SLOT_A1),
            v[:, SLOT_B0] & ~same(SLOT_B0, SLOT_B1),
            v[:, SLOT_A0] & ~same(SLOT_A0, SLOT_A1)]
    cnt4 = sum(f.to(torch.int32) for f in incl)
    incl.append(v[:, SLOT_B2] & ~same(SLOT_B2, SLOT_A1)
                & ~same(SLOT_B2, SLOT_B1) & (cnt4 < 4))
    mvx_slots, mvy_slots, ref_slots = nb_mvx, nb_mvy, nb_ref
    if t_ok is not None:
        incl.append(t_ok)
        mvx_slots = torch.cat([nb_mvx, t_mvx[:, None]], 1)
        mvy_slots = torch.cat([nb_mvy, t_mvy[:, None]], 1)
        ref_slots = torch.cat([nb_ref, torch.zeros_like(t_mvx)[:, None]], 1)
    incl = torch.stack(incl, 1)                        # (B, 5|6)
    inci = incl.to(torch.int32)
    pos = torch.cumsum(inci, 1) - inci
    # dump lane: excluded slots AND included ones past the list cap
    target = torch.where(incl & (pos < max_merge), pos, max_merge) \
        .to(torch.int64)
    b = nb_mvx.shape[0]
    rows = torch.arange(b, device=nb_mvx.device)[:, None]

    def scatter(vals):
        out = torch.zeros((b, max_merge + 1), dtype=vals.dtype,
                          device=vals.device)
        out[rows, target] = vals
        return out[:, :max_merge]

    cand_mvx = scatter(mvx_slots)
    cand_mvy = scatter(mvy_slots)
    cand_ref = scatter(ref_slots)
    n_spatial = inci.sum(1)                            # (B,)

    k = torch.arange(max_merge, device=nb_mvx.device)[None, :]
    fill = k >= n_spatial[:, None]
    fill_ref = k - n_spatial[:, None]
    # the decoder builds the zero-fill with numRefIdx = the ACTIVE count
    limit = num_ref if n_active is None else n_active
    fill_ref = torch.where(fill_ref < limit, fill_ref, 0)
    cand_mvx = torch.where(fill, 0, cand_mvx)
    cand_mvy = torch.where(fill, 0, cand_mvy)
    cand_ref = torch.where(fill, fill_ref.to(cand_ref.dtype), cand_ref)
    return cand_mvx, cand_mvy, cand_ref


def merge_candidates_dev_b(nb_valid, nb_dir, nb_mvx0, nb_mvy0, nb_ref0,
                           nb_mvx1, nb_mvy1, nb_ref1,
                           ref_pocs_l0, ref_pocs_l1,
                           num_ref_l0: int, num_ref_l1: int,
                           max_merge: int):
    """Vectorised merge list for B slices (8.5.3.1.2): two-list spatial
    candidates with full-motion pruning, combined bi-predictive
    candidates (8.5.3.1.3) in the spec's 12-pair priority order, then
    dir=3 zero fill (the common/motion.py merge_candidates is_b path,
    which the decoder re-derives).

    nb_* are (B, 5) in slot order [A1, B1, B0, A0, B2]; nb_valid folds
    z-scan availability AND inter-ness.  ref_pocs_l* are (R,) POC
    tensors for the combined candidates' identity check.  Returns (dir,
    mvx0, mvy0, ref0, mvx1, mvy1, ref1), each (B, max_merge) int32."""
    v = nb_valid
    u0 = (nb_dir & 1) > 0
    u1 = (nb_dir & 2) > 0

    def same(i, j):
        eq0 = ~(u0[:, i] | u0[:, j]) | (
            u0[:, i] & u0[:, j] & (nb_mvx0[:, i] == nb_mvx0[:, j])
            & (nb_mvy0[:, i] == nb_mvy0[:, j])
            & (nb_ref0[:, i] == nb_ref0[:, j]))
        eq1 = ~(u1[:, i] | u1[:, j]) | (
            u1[:, i] & u1[:, j] & (nb_mvx1[:, i] == nb_mvx1[:, j])
            & (nb_mvy1[:, i] == nb_mvy1[:, j])
            & (nb_ref1[:, i] == nb_ref1[:, j]))
        return v[:, i] & v[:, j] & (nb_dir[:, i] == nb_dir[:, j]) \
            & eq0 & eq1

    incl = [v[:, SLOT_A1],
            v[:, SLOT_B1] & ~same(SLOT_B1, SLOT_A1),
            v[:, SLOT_B0] & ~same(SLOT_B0, SLOT_B1),
            v[:, SLOT_A0] & ~same(SLOT_A0, SLOT_A1)]
    cnt4 = sum(f.to(torch.int32) for f in incl)
    incl.append(v[:, SLOT_B2] & ~same(SLOT_B2, SLOT_A1)
                & ~same(SLOT_B2, SLOT_B1) & (cnt4 < 4))
    incl = torch.stack(incl, 1)                        # (B, 5)
    inci = incl.to(torch.int32)
    pos = torch.cumsum(inci, 1) - inci
    target = torch.where(incl & (pos < max_merge), pos, max_merge) \
        .to(torch.int64)
    b = nb_mvx0.shape[0]
    dev = nb_mvx0.device
    rows = torch.arange(b, device=dev)[:, None]

    def scatter(vals, tgt):
        out = torch.zeros((b, max_merge + 1), dtype=torch.int32, device=dev)
        out[rows, tgt] = vals.to(torch.int32)
        return out[:, :max_merge]

    cdir = scatter(nb_dir, target)
    cx0 = scatter(nb_mvx0, target)
    cy0 = scatter(nb_mvy0, target)
    cr0 = scatter(nb_ref0, target)
    cx1 = scatter(nb_mvx1, target)
    cy1 = scatter(nb_mvy1, target)
    cr1 = scatter(nb_ref1, target)
    n_sp = torch.clamp(inci.sum(1), max=max_merge)     # (B,)

    # combined bi-predictive candidates from pairs of list entries
    PRIORITY = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
                (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2))
    inc_flags, pair_ids = [], []
    for p, (i0, i1) in enumerate(PRIORITY):
        if i0 >= max_merge or i1 >= max_merge:
            inc_flags.append(torch.zeros((b,), dtype=torch.bool,
                                         device=dev))
            pair_ids.append((0, 0))
            continue
        d0, d1 = cdir[:, i0], cdir[:, i1]
        poc0 = ref_pocs_l0[torch.clamp(cr0[:, i0], 0, num_ref_l0 - 1)
                           .to(torch.int64)]
        poc1 = ref_pocs_l1[torch.clamp(cr1[:, i1], 0, num_ref_l1 - 1)
                           .to(torch.int64)]
        dup = (poc0 == poc1) & (cx0[:, i0] == cx1[:, i1]) \
            & (cy0[:, i0] == cy1[:, i1])
        ok = (n_sp > i0) & (n_sp > i1) & (p < n_sp * (n_sp - 1)) \
            & ((d0 & 1) > 0) & ((d1 & 2) > 0) & ~dup
        inc_flags.append(ok)
        pair_ids.append((i0, i1))
    incc = torch.stack(inc_flags, 1)                   # (B, 12)
    incci = incc.to(torch.int32)
    cpos = torch.cumsum(incci, 1) - incci
    slot = n_sp[:, None] + cpos
    tgt_c = torch.where(incc & (slot < max_merge), slot, max_merge) \
        .to(torch.int64)
    g = lambda a, k: torch.stack([a[:, ids[k]] for ids in pair_ids], 1)
    gx0, gy0, gr0 = g(cx0, 0), g(cy0, 0), g(cr0, 0)
    gx1, gy1, gr1 = g(cx1, 1), g(cy1, 1), g(cr1, 1)

    # scatter the combined entries on top (positions past the spatial
    # count; the spare column takes the rest)
    def overlay(cur, vals):
        padded = torch.cat([cur, torch.zeros((b, 1), dtype=torch.int32,
                                             device=dev)], 1)
        padded[rows, tgt_c] = vals
        return padded[:, :max_merge]

    cx0 = overlay(cx0, gx0)
    cy0 = overlay(cy0, gy0)
    cr0 = overlay(cr0, gr0)
    cx1 = overlay(cx1, gx1)
    cy1 = overlay(cy1, gy1)
    cr1 = overlay(cr1, gr1)
    cdir = overlay(cdir, torch.full_like(gx0, 3))
    n_tot = torch.clamp(n_sp + incci.sum(1), max=max_merge)

    # zero-MV fill: dir=3, ref idx cycling 0..min(R0,R1)-1
    num_ref = min(num_ref_l0, num_ref_l1)
    k = torch.arange(max_merge, device=dev)[None, :]
    fill = k >= n_tot[:, None]
    fill_ref = k - n_tot[:, None]
    fill_ref = torch.where(fill_ref < num_ref, fill_ref, 0).to(torch.int32)
    cx0 = torch.where(fill, 0, cx0)
    cy0 = torch.where(fill, 0, cy0)
    cr0 = torch.where(fill, fill_ref, cr0)
    cx1 = torch.where(fill, 0, cx1)
    cy1 = torch.where(fill, 0, cy1)
    cr1 = torch.where(fill, fill_ref, cr1)
    cdir = torch.where(fill, 3, cdir)
    return cdir, cx0, cy0, cr0, cx1, cy1, cr1


def _scale_mv_dev(mvx, mvy, tb, td):
    """8.5.3.1.3 distance scaling, C-truncation division semantics."""
    abs_td = td.abs()
    num = 16384 + (abs_td >> 1)
    tx = torch.where(td > 0, num // torch.clamp(td, min=1),
                     -(num // torch.clamp(abs_td, min=1)))
    dsf = torch.clamp((tb * tx + 32) >> 6, -4096, 4095)

    def s(v):
        p = dsf * v
        m = (p.abs() + 127) >> 8
        return torch.clamp(torch.where(p >= 0, m, -m), -32768, 32767)

    keep = td == tb
    return (torch.where(keep, mvx, s(mvx)).to(torch.int32),
            torch.where(keep, mvy, s(mvy)).to(torch.int32))


def amvp_candidates_dev(nb_valid, nb_mvx, nb_mvy, nb_refpoc,
                        target_poc, cur_poc,
                        t_ok=None, t_mvx=None, t_mvy=None):
    """Vectorised AMVP list (8.5.3.1.5/6), P slice.
    nb_* (B, 5) slot order [A1, B1, B0, A0, B2]; nb_refpoc is the POC
    of the neighbour's L0 reference picture; target_poc the POC of the
    block's own reference, (B,) tensor.  t_* ((B,) or None): the
    collocated candidate already scaled to the block's reference,
    appended unpruned when fewer than two spatial candidates survive.
    Returns (mvp0x, mvp0y, mvp1x, mvp1y) each (B,)."""
    target_poc = target_poc[:, None]
    tb = cur_poc - target_poc
    smvx, smvy = _scale_mv_dev(nb_mvx, nb_mvy, tb, cur_poc - nb_refpoc)
    unscaled_ok = nb_valid & (nb_refpoc == target_poc)
    return _amvp_assemble(nb_valid, unscaled_ok, nb_mvx, nb_mvy,
                          smvx, smvy, t_ok, t_mvx, t_mvy)


def amvp_candidates_dev_b(nb_valid, nb_dir,
                          nb_mvx0, nb_mvy0, nb_poc0,
                          nb_mvx1, nb_mvy1, nb_poc1,
                          lx, target_poc, cur_poc,
                          t_ok=None, t_mvx=None, t_mvy=None):
    """Vectorised AMVP list for B slices: the neighbour candidate may
    come from either of its lists -- same-POC match checked in order
    (LX, LY), then scaled from the first present list (the
    common/motion.py amvp_candidates from_pos, which the decoder
    re-derives).

    nb_poc0/1 are the POCs of each neighbour's list-0/1 references
    ((B, 5), junk where the list is unused); lx the block's target list
    ((B,) in {0, 1}); target_poc the POC of its reference ((B,)).
    Returns (mvp0x, mvp0y, mvp1x, mvp1y)."""
    target_poc = target_poc[:, None]
    lxc = lx[:, None]
    ux = torch.where(lxc == 0, (nb_dir & 1) > 0, (nb_dir & 2) > 0) \
        & nb_valid
    uy = torch.where(lxc == 0, (nb_dir & 2) > 0, (nb_dir & 1) > 0) \
        & nb_valid
    mxx = torch.where(lxc == 0, nb_mvx0, nb_mvx1)
    mxy = torch.where(lxc == 0, nb_mvy0, nb_mvy1)
    pxp = torch.where(lxc == 0, nb_poc0, nb_poc1)
    myx = torch.where(lxc == 0, nb_mvx1, nb_mvx0)
    myy = torch.where(lxc == 0, nb_mvy1, nb_mvy0)
    pyp = torch.where(lxc == 0, nb_poc1, nb_poc0)

    # unscaled: same reference POC, LX first then LY
    hitx = ux & (pxp == target_poc)
    hity = uy & (pyp == target_poc)
    unscaled_ok = hitx | hity
    u_mvx = torch.where(hitx, mxx, myx)
    u_mvy = torch.where(hitx, mxy, myy)

    # the scaled pass: a same-POC match at the slot still wins (from_pos
    # checks it before scaling); else scale the first present list
    pick_poc = torch.where(ux, pxp, pyp)
    pick_x = torch.where(ux, mxx, myx)
    pick_y = torch.where(ux, mxy, myy)
    tb = cur_poc - target_poc
    s_mvx, s_mvy = _scale_mv_dev(pick_x, pick_y, tb, cur_poc - pick_poc)
    s_mvx = torch.where(unscaled_ok, u_mvx, s_mvx)
    s_mvy = torch.where(unscaled_ok, u_mvy, s_mvy)
    return _amvp_assemble(nb_valid, unscaled_ok, u_mvx, u_mvy,
                          s_mvx, s_mvy, t_ok, t_mvx, t_mvy)


def _amvp_assemble(nb_valid, unscaled_ok, nb_mvx, nb_mvy, smvx, smvy,
                   t_ok, t_mvx, t_mvy):
    a_slots = (SLOT_A0, SLOT_A1)
    b_slots = (SLOT_B0, SLOT_B1, SLOT_B2)

    def group(slots, flags, mx, my):
        f = torch.stack([flags[:, s] for s in slots], 1)
        gx = torch.stack([mx[:, s] for s in slots], 1)
        gy = torch.stack([my[:, s] for s in slots], 1)
        return _first(f, gx, gy)

    a_u_found, a_u_x, a_u_y = group(a_slots, unscaled_ok, nb_mvx, nb_mvy)
    a_s_found, a_s_x, a_s_y = group(a_slots, nb_valid, smvx, smvy)
    found_a = a_u_found | a_s_found
    mv_a_x = torch.where(a_u_found, a_u_x, a_s_x)
    mv_a_y = torch.where(a_u_found, a_u_y, a_s_y)
    a_has_inter = nb_valid[:, SLOT_A0] | nb_valid[:, SLOT_A1]

    b_u_found, b_u_x, b_u_y = group(b_slots, unscaled_ok, nb_mvx, nb_mvy)
    b_s_found, b_s_x, b_s_y = group(b_slots, nb_valid, smvx, smvy)

    # isScaledFlagLX == 0: B's same-POC candidate moves into the A slot
    # and B re-derives with scaling allowed (8.5.3.1.6)
    mv_a_x = torch.where(a_has_inter, mv_a_x, b_u_x)
    mv_a_y = torch.where(a_has_inter, mv_a_y, b_u_y)
    found_a2 = torch.where(a_has_inter, found_a, b_u_found)
    mv_b_x = torch.where(a_has_inter, b_u_x, b_s_x)
    mv_b_y = torch.where(a_has_inter, b_u_y, b_s_y)
    found_b = torch.where(a_has_inter, b_u_found, b_s_found)

    dup = found_a2 & found_b & (mv_a_x == mv_b_x) & (mv_a_y == mv_b_y)
    found_b = found_b & ~dup

    # assemble [a?, b?, t?, (0,0)...]
    if t_ok is None:
        t_ok = torch.zeros(nb_valid.shape[:1], dtype=torch.bool,
                           device=nb_valid.device)
        t_mvx = t_mvy = torch.zeros(nb_valid.shape[:1], dtype=torch.int32,
                                    device=nb_valid.device)
    mvp0x = torch.where(found_a2, mv_a_x,
                        torch.where(found_b, mv_b_x,
                                    torch.where(t_ok, t_mvx, 0)))
    mvp0y = torch.where(found_a2, mv_a_y,
                        torch.where(found_b, mv_b_y,
                                    torch.where(t_ok, t_mvy, 0)))
    second_is_b = found_a2 & found_b
    second_is_t = ~second_is_b & (found_a2 | found_b) & t_ok
    mvp1x = torch.where(second_is_b, mv_b_x,
                        torch.where(second_is_t, t_mvx, 0))
    mvp1y = torch.where(second_is_b, mv_b_y,
                        torch.where(second_is_t, t_mvy, 0))
    i32 = lambda a: a.to(torch.int32)
    return i32(mvp0x), i32(mvp0y), i32(mvp1x), i32(mvp1y)


def scale_mv_pair_dev(mvx, mvy, tb, td):
    """Public 8.5.3.1.3 scaling with the temporal-MVP tb/td clipping
    (8.5.3.2.8); identity when td == tb pre-clip like the reference."""
    keep = td == tb
    sx, sy = _scale_mv_dev(mvx, mvy, torch.clamp(tb, -128, 127),
                           torch.clamp(td, -128, 127))
    return (torch.where(keep, mvx, sx).to(torch.int32),
            torch.where(keep, mvy, sy).to(torch.int32))


def temporal_cand_grid_dev(col_mvx, col_mvy, col_ok, col_refpoc,
                           n: int, w: int, h: int, log2_ctu: int,
                           gw: int = None, gh: int = None):
    """Raw collocated candidate for every n x n block of the picture
    (8.5.3.2.8, position derivation only -- scaling is the caller's,
    since merge targets ref 0 while AMVP targets the block's own ref).

    col_* are the collocated picture's motion on the 8x8 block grid
    (bh, bw); the spec's 16x16 compression is the index rounding
    (x >> 4) << 4, i.e. the even 8x8 cell of each 16x16 region.
    Returns (t_ok, t_mvx, t_mvy, t_refpoc), each flat (P,) over the
    n-grid in raster order.  gw/gh override the grid dims for padded
    grids (the 32-level's ceil grid); lanes outside the picture read
    clamped col data and must be masked by the caller."""
    if gw is None:
        gw, gh = w // n, h // n
    bw, bh = w // 8, h // 8
    dev = col_mvx.device
    bidx = torch.arange(gw * gh, device=dev)
    x0 = (bidx % gw) * n
    y0 = (bidx // gw) * n
    ok_f, mx_f = col_ok.reshape(-1), col_mvx.reshape(-1)
    my_f, rp_f = col_mvy.reshape(-1), col_refpoc.reshape(-1)

    def at(xs, ys):
        byi = torch.clamp((ys >> 4) * 2, max=bh - 1)
        bxi = torch.clamp((xs >> 4) * 2, max=bw - 1)
        fl = byi * bw + bxi
        return ok_f[fl], mx_f[fl], my_f[fl], rp_f[fl]

    xbr, ybr = x0 + n, y0 + n
    br_in = (xbr < w) & (ybr < h) \
        & ((y0 >> log2_ctu) == (ybr >> log2_ctu))
    ok_br, mx_br, my_br, rp_br = at(torch.clamp(xbr, max=w - 1),
                                    torch.clamp(ybr, max=h - 1))
    ok_br = ok_br & br_in
    ok_ct, mx_ct, my_ct, rp_ct = at(x0 + n // 2, y0 + n // 2)
    use_br = ok_br
    t_ok = ok_br | ok_ct
    t_mvx = torch.where(use_br, mx_br, mx_ct).to(torch.int32)
    t_mvy = torch.where(use_br, my_br, my_ct).to(torch.int32)
    t_refpoc = torch.where(use_br, rp_br, rp_ct).to(torch.int32)
    return t_ok, t_mvx, t_mvy, t_refpoc


def mv_bits_dev(vx, vy):
    """Signed Exp-Golomb MVD bit estimate matching pframe.mvd_bits_of:
    2*bit_length(|vx|) + 2*bit_length(|vy|) + 2."""
    from hmtpu_torch.ops.ratebits import floor_log2

    def bl(v):
        a = v.abs()
        return torch.where(a > 0, floor_log2(a) + 1, 0)

    return 2 * bl(vx) + 2 * bl(vy) + 2
