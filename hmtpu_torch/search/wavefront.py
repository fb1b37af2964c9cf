"""Static z-scan schedules over the block grid, copied from
hmtpu/search/wavefront.py:44-284 (that module loads jax, so the port
keeps its own copy of the numpy builders).

The z-scan dependency DAG over the uniform 8x8 block grid is levelised
once per geometry: every block of one level can be decided at once,
because all it reads (the committed reconstruction and modes of its
neighbours) was written by earlier levels.  Also here: the per-block
substituted reference-line gather maps (8.4.4.2.2 collapses to a
constant gather because availability is geometric).

The device derivations of that module (merge/AMVP candidates) come with
the P-slice slice of the port.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

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
