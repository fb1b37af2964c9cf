"""Motion data model + merge/AMVP candidate derivation.

Capability parity with the reference's TComDataCU motion derivation
(TComDataCU.cpp getInterMergeCandidates / fillMvpCand / z-scan neighbour
rules, TComDataCU.h:64) re-expressed over a flat per-picture motion
field at 4x4 granularity (the spec's minimum PU grid) instead of HM's
per-CTU z-scan arrays: a frame's field is three dense tensors, which is
what the batched search kernels and the sequential entropy pass both
index directly.

Spec sections implemented: 6.4.1 (z-scan availability), 8.5.3.1.2
(merge list), 8.5.3.1.5-6 (AMVP list + spatial mvp), 8.5.3.2.8
(temporal/collocated mvp: bottom-right-then-center col position at
16x16 compressed granularity, POC-distance scaling; reference
TComDataCU getInterMergeCandidates / xGetColMVP and the motion-field
compression TComMotionInfo.cpp:330 which keeps the top-left 4x4 of
every 16x16 region), 8.5.3.1.3 MV scaling.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

L0, L1 = 0, 1


@dataclass
class PicMotion:
    """Per-picture motion field at 4x4 granularity.

    inter_dir: 0 = intra/unset, bit0 = uses L0, bit1 = uses L1
    mv:        (2, H4, W4, 2) int32 quarter-pel (list, y, x, [mvx, mvy])
    ref_idx:   (2, H4, W4) int32, -1 when unused
    """
    inter_dir: np.ndarray
    mv: np.ndarray
    ref_idx: np.ndarray

    @classmethod
    def create(cls, width: int, height: int) -> "PicMotion":
        h4, w4 = height // 4, width // 4
        return cls(
            inter_dir=np.zeros((h4, w4), dtype=np.int32),
            mv=np.zeros((2, h4, w4, 2), dtype=np.int32),
            ref_idx=np.full((2, h4, w4), -1, dtype=np.int32),
        )

    def set_block(self, x: int, y: int, w: int, h: int, inter_dir: int,
                  mv_l0, ref_l0: int, mv_l1=None, ref_l1: int = -1) -> None:
        y4, x4, h4, w4 = y // 4, x // 4, h // 4, w // 4
        self.inter_dir[y4:y4 + h4, x4:x4 + w4] = inter_dir
        if inter_dir & 1:
            self.mv[L0, y4:y4 + h4, x4:x4 + w4] = mv_l0
            self.ref_idx[L0, y4:y4 + h4, x4:x4 + w4] = ref_l0
        if inter_dir & 2:
            self.mv[L1, y4:y4 + h4, x4:x4 + w4] = mv_l1
            self.ref_idx[L1, y4:y4 + h4, x4:x4 + w4] = ref_l1


def make_zscan_map(width: int, height: int, log2_ctu: int) -> np.ndarray:
    """Coding order index of every 4x4 block (6.4.1 MinTbAddrZs):
    CTU raster order, z-order inside the CTU."""
    w4, h4 = width // 4, height // 4
    c4 = 1 << (log2_ctu - 2)                 # 4x4 blocks per CTU side
    ys, xs = np.mgrid[0:h4, 0:w4]
    ctu_x, ctu_y = xs // c4, ys // c4
    n_ctu_x = (w4 + c4 - 1) // c4
    base = (ctu_y * n_ctu_x + ctu_x) * c4 * c4
    zx, zy = xs % c4, ys % c4
    z = np.zeros_like(zx)
    for b in range(log2_ctu - 2):
        z |= ((zx >> b) & 1) << (2 * b)
        z |= ((zy >> b) & 1) << (2 * b + 1)
    return base + z


@dataclass
class MvCand:
    inter_dir: int
    mv: tuple        # ((mvx0, mvy0), (mvx1, mvy1))
    ref_idx: tuple   # (ref0, ref1)

    def same_motion(self, o: "MvCand") -> bool:
        if self.inter_dir != o.inter_dir:
            return False
        for l in (L0, L1):
            if self.inter_dir & (1 << l):
                if (self.mv[l] != o.mv[l]
                        or self.ref_idx[l] != o.ref_idx[l]):
                    return False
        return True


class MotionCtx:
    """Per-frame context for candidate derivation: motion field + the
    z-scan availability predicate, both of which every PU shares."""

    def __init__(self, field: PicMotion, width: int, height: int,
                 log2_ctu: int, ref_pocs_l0: list, ref_pocs_l1=None,
                 cur_poc: int = 0, col=None):
        self.field = field
        self.w, self.h = width, height
        self.log2_ctu = log2_ctu
        self.zmap = make_zscan_map(width, height, log2_ctu)
        self.ref_pocs = (list(ref_pocs_l0), list(ref_pocs_l1 or []))
        self.cur_poc = cur_poc
        # collocated-picture motion for TMVP (8.5.3.2.8): dict with
        # mvx/mvy/ok/refpoc arrays on the 8x8 block grid + 'poc', or
        # None when slice_temporal_mvp is off / col data unavailable
        self.col = col

    def temporal_mv(self, x: int, y: int, w: int, h: int,
                    target_poc: int):
        """Collocated temporal MV for the PU at (x, y, w, h), scaled to
        the reference at target_poc (8.5.3.2.8).  Bottom-right col
        position first (same CTU row only), center fallback; positions
        read at the 16x16 compressed granularity.  Returns (mvx, mvy)
        or None."""
        c = self.col
        if c is None:
            return None

        def col_at(xs, ys):
            # compressed read: top-left 4x4 of the 16x16 region, which
            # on the 8x8 block grid is cell (2*(y>>4), 2*(x>>4))
            byi, bxi = (ys >> 4) * 2, (xs >> 4) * 2
            if not c["ok"][byi, bxi]:
                return None
            return (int(c["mvx"][byi, bxi]), int(c["mvy"][byi, bxi]),
                    int(c["refpoc"][byi, bxi]))

        got = None
        xbr, ybr = x + w, y + h
        if xbr < self.w and ybr < self.h \
                and (y >> self.log2_ctu) == (ybr >> self.log2_ctu):
            got = col_at(xbr, ybr)
        if got is None:
            got = col_at(x + w // 2, y + h // 2)
        if got is None:
            return None
        mvx, mvy, col_refpoc = got
        tb = int(np.clip(self.cur_poc - target_poc, -128, 127))
        td = int(np.clip(c["poc"] - col_refpoc, -128, 127))
        return _scale_mv((mvx, mvy), tb, td)

    def available(self, x_nb: int, y_nb: int, x_cur: int, y_cur: int) -> bool:
        """Neighbour (x_nb, y_nb) exists and precedes the current block's
        top-left (x_cur, y_cur) in coding order (6.4.1)."""
        if x_nb < 0 or y_nb < 0 or x_nb >= self.w or y_nb >= self.h:
            return False
        return (self.zmap[y_nb // 4, x_nb // 4]
                < self.zmap[y_cur // 4, x_cur // 4])

    def motion_at(self, x: int, y: int) -> MvCand | None:
        f = self.field
        y4, x4 = y // 4, x // 4
        d = int(f.inter_dir[y4, x4])
        if d == 0:
            return None
        return MvCand(d,
                      (tuple(int(v) for v in f.mv[L0, y4, x4]),
                       tuple(int(v) for v in f.mv[L1, y4, x4])),
                      (int(f.ref_idx[L0, y4, x4]),
                       int(f.ref_idx[L1, y4, x4])))


def merge_candidates(ctx: MotionCtx, x: int, y: int, w: int, h: int,
                     max_cand: int, num_ref_l0: int,
                     is_b: bool = False, num_ref_l1: int = 0) -> list[MvCand]:
    """Merge candidate list for one PU (8.5.3.1.2), TMVP off.

    Spatial order A1, B1, B0, A0, (B2 if <4), with the spec's pairwise
    pruning; then (B) combined candidates (skipped: needs two lists);
    then zero-MV fill."""
    cands: list[MvCand] = []

    def grab(xn, yn):
        if not ctx.available(xn, yn, x, y):
            return None
        return ctx.motion_at(xn, yn)

    a1 = grab(x - 1, y + h - 1)
    if a1 is not None:
        cands.append(a1)
    b1 = grab(x + w - 1, y - 1)
    if b1 is not None and not (a1 is not None and b1.same_motion(a1)):
        cands.append(b1)
    b0 = grab(x + w, y - 1)
    if b0 is not None and not (b1 is not None and b0.same_motion(b1)):
        cands.append(b0)
    a0 = grab(x - 1, y + h)
    if a0 is not None and not (a1 is not None and a0.same_motion(a1)):
        cands.append(a0)
    if len(cands) < 4:
        b2 = grab(x - 1, y - 1)
        if b2 is not None \
                and not (a1 is not None and b2.same_motion(a1)) \
                and not (b1 is not None and b2.same_motion(b1)):
            cands.append(b2)

    # temporal (collocated) candidate (8.5.3.2.8): appended after the
    # spatial ones with refIdx fixed to 0, never pruned against them
    if ctx.col is not None and len(cands) < max_cand and not is_b:
        tmv = ctx.temporal_mv(x, y, w, h, ctx.ref_pocs[0][0])
        if tmv is not None:
            cands.append(MvCand(1, (tmv, (0, 0)), (0, -1)))

    # combined bi-predictive candidates (8.5.3.1.3, B slices only)
    if is_b and 1 < len(cands) < max_cand:
        priority = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
                    (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2))
        n_orig = len(cands)
        for i0, i1 in priority[:n_orig * (n_orig - 1)]:
            if len(cands) >= max_cand:
                break
            c0, c1 = cands[i0], cands[i1]
            if not (c0.inter_dir & 1 and c1.inter_dir & 2):
                continue
            poc0 = ctx.ref_pocs[0][c0.ref_idx[0]]
            poc1 = ctx.ref_pocs[1][c1.ref_idx[1]]
            if poc0 == poc1 and c0.mv[0] == c1.mv[1]:
                continue
            cands.append(MvCand(3, (c0.mv[0], c1.mv[1]),
                                (c0.ref_idx[0], c1.ref_idx[1])))

    # zero-MV fill (8.5.3.1.4): cycle ref idx 0..numRef-1
    num_ref = min(num_ref_l0, num_ref_l1) if is_b else num_ref_l0
    zero_idx = 0
    while len(cands) < max_cand:
        r = zero_idx if zero_idx < num_ref else 0
        if is_b:
            cands.append(MvCand(3, ((0, 0), (0, 0)), (r, r)))
        else:
            cands.append(MvCand(1, ((0, 0), (0, 0)), (r, -1)))
        zero_idx += 1
    return cands[:max_cand]


def _scale_mv(mv, tb: int, td: int):
    """8.5.3.1.3 temporal/POC-distance MV scaling.  NB: tx divides by a
    possibly negative td — C truncates toward zero, so mirror that
    (Python // floors).  td/tb clipped to [-128, 127] per
    8.5.3.1.6/8.5.3.2.8."""
    if td == tb:
        return mv
    tb = int(np.clip(tb, -128, 127))
    td = int(np.clip(td, -128, 127))
    num = 16384 + (abs(td) >> 1)
    tx = num // td if td > 0 else -(num // -td)
    dsf = int(np.clip((tb * tx + 32) >> 6, -4096, 4095))
    def s(v):
        p = dsf * v
        return int(np.clip((abs(p) + 127) >> 8 if p >= 0
                           else -((abs(p) + 127) >> 8), -32768, 32767))
    return (s(mv[0]), s(mv[1]))


def amvp_candidates(ctx: MotionCtx, x: int, y: int, w: int, h: int,
                    ref_list: int, ref_idx: int) -> list[tuple]:
    """AMVP list (8.5.3.1.5/6): spatial A then B, scaling when the
    neighbour references a different POC distance; pad to exactly 2."""
    target_poc = ctx.ref_pocs[ref_list][ref_idx]

    def poc_of(cand: MvCand, l: int):
        return ctx.ref_pocs[l][cand.ref_idx[l]]

    def from_pos(xn, yn, allow_scaled: bool):
        if not ctx.available(xn, yn, x, y):
            return None
        c = ctx.motion_at(xn, yn)
        if c is None:
            return None
        # same reference picture first, either list
        for l in (ref_list, 1 - ref_list):
            if c.inter_dir & (1 << l) and poc_of(c, l) == target_poc:
                return c.mv[l]
        if allow_scaled:
            for l in (ref_list, 1 - ref_list):
                if c.inter_dir & (1 << l):
                    tb = ctx.cur_poc - target_poc
                    td = ctx.cur_poc - poc_of(c, l)
                    return _scale_mv(c.mv[l], tb, td)
        return None

    a_positions = [(x - 1, y + h), (x - 1, y + h - 1)]          # A0, A1
    b_positions = [(x + w, y - 1), (x + w - 1, y - 1), (x - 1, y - 1)]

    mv_a = None
    a_has_inter = any(ctx.available(px, py, x, y)
                      and ctx.motion_at(px, py) is not None
                      for px, py in a_positions)
    for px, py in a_positions:
        mv_a = from_pos(px, py, False)
        if mv_a is not None:
            break
    if mv_a is None:
        for px, py in a_positions:
            mv_a = from_pos(px, py, True)
            if mv_a is not None:
                break

    mv_b = None
    for px, py in b_positions:
        mv_b = from_pos(px, py, False)
        if mv_b is not None:
            break
    if not a_has_inter:
        # isScaledFlagLX == 0 (8.5.3.1.6): the same-POC B candidate
        # moves into the A slot and B is re-derived with scaling
        mv_a = mv_b
        mv_b = None
        for px, py in b_positions:
            mv_b = from_pos(px, py, True)
            if mv_b is not None:
                break
    cands = []
    if mv_a is not None:
        cands.append(mv_a)
    if mv_b is not None and mv_b not in cands:
        cands.append(mv_b)
    # temporal candidate (8.5.3.1.6: appended unpruned when < 2)
    if len(cands) < 2 and ctx.col is not None:
        tmv = ctx.temporal_mv(x, y, w, h, target_poc)
        if tmv is not None:
            cands.append(tmv)
    while len(cands) < 2:
        cands.append((0, 0))
    return cands[:2]
