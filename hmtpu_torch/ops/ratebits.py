"""CABAC-aware rate estimation for the RDO decision pass: the port of
hmtpu/ops/ratebits.py (`tb_bits` :161, `ep_eg1_bits` :152 and the CU
flag helpers :305-450, intra and inter, `ts_flag_bits` :313 among
them).

`tb_bits` is the batched, exact-bin-identity reproduction of the
residual_coding() syntax (7.3.8.11, TEncSbac::codeCoeffNxN): every
context-coded bin is priced by a gather from a flat (NUM_CTX*2,)
float32 fractional-bit table (entropy/fracbits.py).

Float sums: every value summed here is a multiple of 2^-15 below 2^20
(table entries are k/32768, bypass counts are integers), so each sum
is accumulated in float64, where it is exact in any order, and rounded
once to float32.  The result is the same on every device, and equal to
hmtpu's float32 sums whenever those are exact (totals below 512 bits).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from hmtpu_torch.common.scan import SCAN_VER, cg_scan_order, scan_order
from hmtpu_torch.entropy.contexts import OFF
from hmtpu_torch.entropy.residual import (
    _group_idx,
    _last_ctx_params,
    _sig_ctx_full,
)

_C1FLAG_NUMBER = 8


@lru_cache(maxsize=None)
def _tb_tables_np(log2: int, scan_idx: int, is_luma: bool):
    size = 1 << log2
    npos = size * size
    cg_w = max(size >> 2, 1)
    ncg = cg_w * cg_w
    scans = scan_order(log2, scan_idx).reshape(-1)     # scan pos -> raster
    cgo = cg_scan_order(log2, scan_idx)                # cg scan -> cg raster
    cg_scan_of_raster = np.empty(ncg, np.int32)
    cg_scan_of_raster[cgo] = np.arange(ncg)

    # scan index of the raster-right / raster-below CG (ncg = padding)
    right = np.full(ncg, ncg, np.int32)
    below = np.full(ncg, ncg, np.int32)
    for ci in range(ncg):
        r = int(cgo[ci])
        x, y = r % cg_w, r // cg_w
        if x + 1 < cg_w:
            right[ci] = cg_scan_of_raster[r + 1]
        if y + 1 < cg_w:
            below[ci] = cg_scan_of_raster[r + cg_w]

    # sig_coeff_flag context per (patt, scan position)
    sig_tab = np.zeros((4, npos), np.int32)
    for patt in range(4):
        for sp in range(npos):
            sig_tab[patt, sp] = _sig_ctx_full(
                patt, int(scans[sp]), size, log2, scan_idx, is_luma)

    # last-position prefix: per coordinate value, counts over the 15
    # local LAST contexts split by bin value, plus the EP suffix length
    goff, gshift = _last_ctx_params(log2, is_luma)
    cmax = (log2 << 1) - 1
    w_cnt = np.zeros((size, 15, 2), np.float32)
    ep_cnt = np.zeros(size, np.float32)
    for c in range(size):
        g = _group_idx(c)
        for b in range(g):
            w_cnt[c, goff + (b >> gshift), 1] += 1
        if g < cmax:
            w_cnt[c, goff + (g >> gshift), 0] += 1
        if g > 3:
            ep_cnt[c] = (g >> 1) - 1

    # last coordinate per scan position (after the VER swap)
    lx = scans % size
    ly = scans // size
    if scan_idx == SCAN_VER:
        lx, ly = ly, lx

    inv_scan = np.empty(npos, np.int64)
    inv_scan[scans] = np.arange(npos)
    return dict(
        size=size, npos=npos, ncg=ncg,
        scans=scans.astype(np.int64), inv_scan=inv_scan,
        right=right.astype(np.int64), below=below.astype(np.int64),
        sig_tab=sig_tab,
        w_cnt=w_cnt, ep_cnt=ep_cnt,
        last_x=lx.astype(np.int64),
        last_y=ly.astype(np.int64),
        ctx_x=OFF["LAST_X" if is_luma else "LAST_X_C"],
        ctx_y=OFF["LAST_Y" if is_luma else "LAST_Y_C"],
        sig_cg_base=OFF["SIG_CG_FLAG"] + (0 if is_luma else 2),
        one_base=OFF["ONE_FLAG"] + (0 if is_luma else 16),
        abs_base=OFF["ABS_FLAG"] + (0 if is_luma else 4),
    )


_DEV_TABLES: dict = {}


def _tb_tables(log2: int, scan_idx: int, is_luma: bool, device):
    """The static tables of one (size, scan, component), as tensors on
    `device` (arrays) and Python ints (context offsets)."""
    key = (log2, scan_idx, is_luma, str(device))
    t = _DEV_TABLES.get(key)
    if t is None:
        t = {k: (torch.as_tensor(v).to(device)
                 if isinstance(v, np.ndarray) else v)
             for k, v in _tb_tables_np(log2, scan_idx, is_luma).items()}
        _DEV_TABLES[key] = t
    return t


def fsum(x, dim):
    """float32 sum over `dim`, accumulated exactly in float64 (see the
    module note)."""
    return x.to(torch.float64).sum(dim=dim).to(torch.float32)


def floor_log2(x):
    """floor(log2(x)) for integer x >= 1 (exact: frexp of a float64)."""
    _, e = torch.frexp(torch.clamp(x, min=1).to(torch.float64))
    return (e - 1).to(torch.int32)


def excl_suffix_count(m):
    """Per position along the last axis, the count of set entries at
    higher indices (the flipped exclusive cumulative sum)."""
    mi = m.to(torch.int32)
    return torch.flip(torch.cumsum(torch.flip(mi, [-1]), -1), [-1]) - mi


def prev_processed_flag(proc, flags):
    """flags[j*] per CG where j* is the NEAREST index j > i with
    proc[j] (False when none): the coder processes CGs last-to-first,
    so "previously processed CG" means the next higher coded index."""
    ncg = proc.shape[-1]
    idxs = torch.arange(ncg, device=proc.device)
    cand = torch.where(proc, idxs, ncg)
    suf = torch.flip(torch.cummin(torch.flip(cand, [-1]), dim=-1).values,
                     [-1])
    nxt = torch.cat([suf[..., 1:],
                     torch.full(suf.shape[:-1] + (1,), ncg,
                                dtype=suf.dtype, device=suf.device)], -1)
    has = nxt < ncg
    g = torch.gather(flags, -1, torch.clamp(nxt, max=ncg - 1))
    return has & g


def ep_eg1_bits(u):
    """EP bit count of k=1 exp-Golomb (MVD remainder binarisation)."""
    pre = floor_log2((u >> 1) + 1)
    return (2 * pre + 2).to(torch.float32)


def _remainder_ep_bits(sym, rice):
    """EP bit count of xWriteCoefRemainExGolomb(sym, rice)."""
    small = sym < (3 << rice)
    b_small = (sym >> rice) + 1 + rice
    t = sym - (3 << rice)
    ln = floor_log2(t + (1 << rice))
    b_big = 4 + 2 * ln - rice
    return torch.where(small, b_small, b_big).to(torch.float32)


def gcb(cbflat, ctx_idx, val):
    """Bits of coding bin `val` in context `ctx_idx` (tensors)."""
    return cbflat[ctx_idx * 2 + val.to(ctx_idx.dtype)]


def last_pos_bits_table(cbflat, t):
    """(size,) x and y prefix+suffix bits of each last coordinate."""
    cb_x = cbflat[t["ctx_x"] * 2:t["ctx_x"] * 2 + 30].reshape(15, 2)
    cb_y = cbflat[t["ctx_y"] * 2:t["ctx_y"] * 2 + 30].reshape(15, 2)
    return cb_x, cb_y


# ---------------------------------------------------------------------------
# the TB estimator

def tb_bits(lev, cbflat, log2: int, is_luma: bool,
            scan_idx: int = 0, sdh: bool = False):
    """Fractional-bit cost of residual_coding() for a batch of TBs.

    lev: (..., size, size) int32 raster levels; cbflat: (NUM_CTX*2,)
    float32 with cbflat[2*ctx+v] = bits of coding v in ctx.  Returns
    (...,) float32; 0.0 for all-zero TBs (the caller prices cbf).  On a
    CUDA tensor it launches K10 on the levels (ops/rdoq.py `k10`)."""
    if lev.is_cuda:
        from hmtpu_torch.ops.rdoq import k10

        return k10(lev, log2, is_luma, scan_idx, cbflat=cbflat, sdh=sdh,
                   lev_in=True, want=("bits",))[0]
    return tb_bits_plain(lev, cbflat, log2, is_luma, scan_idx, sdh)


def tb_bits_plain(lev, cbflat, log2: int, is_luma: bool,
                  scan_idx: int = 0, sdh: bool = False):
    """The plain version of K10's TB rate."""
    dev = lev.device
    t = _tb_tables(log2, scan_idx, is_luma, dev)
    npos, ncg = t["npos"], t["ncg"]
    lead = lev.shape[:-2]
    flat = lev.reshape(lead + (npos,))
    sl = flat[..., t["scans"]]                         # scan-ordered
    a = sl.abs()
    sig = a > 0

    pos_idx = torch.arange(npos, device=dev)
    last_pos = torch.where(sig, pos_idx, -1).amax(-1)  # (...,)
    any_sig = last_pos >= 0
    last_cg = last_pos >> 4

    acg = a.reshape(lead + (ncg, 16))
    scg = acg > 0
    cg_sig = scg.any(-1)                               # (..., ncg)
    ci_idx = torch.arange(ncg, device=dev)

    # ---- last-position prefix
    lp = torch.clamp(last_pos, min=0)
    lx = t["last_x"][lp]
    ly = t["last_y"][lp]
    cb_x, cb_y = last_pos_bits_table(cbflat, t)
    wx = t["w_cnt"][lx]                                # (..., 15, 2)
    wy = t["w_cnt"][ly]
    bits = fsum(wx * cb_x, (-1, -2)) + fsum(wy * cb_y, (-1, -2)) \
        + t["ep_cnt"][lx] + t["ep_cnt"][ly]

    # ---- coded_sub_block_flag (CGs strictly between 0 and last)
    pad = torch.zeros(lead + (1,), dtype=torch.bool, device=dev)
    cg_sig_p = torch.cat([cg_sig, pad], -1)
    r_sig = cg_sig_p[..., t["right"]]
    b_sig = cg_sig_p[..., t["below"]]
    csbf_ctx = t["sig_cg_base"] + (r_sig | b_sig).to(torch.int64)
    csbf_mask = (ci_idx > 0) & (ci_idx < last_cg[..., None])
    bits = bits + fsum(torch.where(csbf_mask, gcb(cbflat, csbf_ctx, cg_sig),
                                   0.0), -1)

    # ---- sig_coeff_flag
    cg_coded = cg_sig | (ci_idx == 0)
    patt = r_sig.to(torch.int64) + 2 * b_sig.to(torch.int64)
    sig_ctx = t["sig_tab"][patt.repeat_interleave(16, -1), pos_idx] \
        .to(torch.int64)
    # DC bin inferred when an explicitly-coded CG has its only
    # significance at position 0
    rest_zero = ~scg[..., 1:].any(-1)                  # (..., ncg)
    dc_skip_cg = (ci_idx > 0) & (ci_idx < last_cg[..., None]) \
        & cg_sig & rest_zero
    in_cg = pos_idx >> 4
    p_in = pos_idx & 15
    sig_mask = (pos_idx < last_pos[..., None]) \
        & cg_coded[..., in_cg] \
        & ~((p_in == 0) & dc_skip_cg[..., in_cg])
    bits = bits + fsum(torch.where(sig_mask, gcb(cbflat, sig_ctx, sig),
                                   0.0), -1)

    # ---- ranks within CG (descending scan order)
    rank = excl_suffix_count(scg)

    # greater1: c1 state machine
    g1 = acg > 1
    sig_grp = scg & (rank < _C1FLAG_NUMBER)
    g1c = g1 & sig_grp
    anyprev_g1 = excl_suffix_count(g1c) > 0
    c1 = torch.where(anyprev_g1, 0, torch.clamp(1 + rank, max=3))
    g1any = g1c.any(-1)                                # (..., ncg)

    # ctx_set: +2 for non-DC luma CG, +1 if the previously *processed
    # coded* CG ended with c1 == 0 (had a greater1)
    proc = cg_coded & (ci_idx <= last_cg[..., None])
    ctx_set = prev_processed_flag(proc, g1any).to(torch.int64)
    if is_luma:
        ctx_set = ctx_set + torch.where(ci_idx > 0, 2, 0)

    one_ctx = t["one_base"] + ctx_set[..., None] * 4 + c1
    bits = bits + fsum(torch.where(sig_grp, gcb(cbflat, one_ctx, g1), 0.0),
                       (-1, -2))

    # greater2: one bin per CG with a coded greater1
    minrank = torch.where(g1c, rank, 99).amin(-1)
    g2val = (g1c & (acg > 2) & (rank == minrank[..., None])).any(-1)
    abs_ctx = t["abs_base"] + ctx_set
    bits = bits + fsum(torch.where(g1any, gcb(cbflat, abs_ctx, g2val), 0.0),
                       -1)

    # ---- signs (EP, minus one when hidden)
    n_cg = scg.sum(-1)                                 # (..., ncg)
    p16 = torch.arange(16, device=dev)
    maxp = torch.where(scg, p16, -1).amax(-1)
    minp = torch.where(scg, p16, 99).amin(-1)
    hide = torch.zeros(lead + (ncg,), dtype=torch.bool, device=dev)
    if sdh:
        hide = (maxp - minp) > 3
    bits = bits + torch.where(n_cg > 0, n_cg - hide.to(n_cg.dtype),
                              0).sum(-1).to(torch.float32)

    # ---- remainders: escape base, then 16-step Rice adaptation
    ge2 = scg & (acg >= 2)
    anyprev_ge2 = excl_suffix_count(ge2) > 0
    base = torch.where(rank < _C1FLAG_NUMBER,
                       torch.where(anyprev_ge2, 2, 3), 1)
    coded_rem = scg & (acg >= base)
    sym = torch.clamp(acg - base, min=0)

    rice = torch.zeros(lead + (ncg,), dtype=torch.int32, device=dev)
    rice_at = []
    for p in range(15, -1, -1):
        rice_at.append(rice)
        c = coded_rem[..., p]
        bump = c & (acg[..., p] > (3 << rice))
        rice = torch.where(bump, torch.clamp(rice + 1, max=4), rice)
    rice_pos = torch.stack(rice_at[::-1], -1)          # (..., ncg, 16)
    bits = bits + fsum(torch.where(coded_rem,
                                   _remainder_ep_bits(sym, rice_pos), 0.0),
                       (-1, -2))

    return torch.where(any_sig, bits, 0.0)


# ---------------------------------------------------------------------------
# CU mode-syntax pricing (the I pass and the P-slice envelope of the
# native slice writer)

def _gc(cbflat, ctx: int, val):
    return cbflat[2 * ctx + val.to(torch.int64)]


def ts_flag_bits(cbflat, val, is_luma: bool):
    """transform_skip_flag (7.3.8.11; one ctx luma, one chroma)."""
    return _gc(cbflat, OFF["TRANSFORMSKIP_FLAG"] + (0 if is_luma else 1),
               val)


def split_flag_bits(cbflat, val, depth_ctx):
    return cbflat[2 * (OFF["SPLIT_FLAG"] + depth_ctx)
                  + val.to(torch.int64)]


def part_size_2nx2n_bits(cbflat):
    return cbflat[2 * OFF["PART_SIZE"] + 1]


def part_size_nxn_bits(cbflat):
    """part_mode = NxN at the minimum CU size (bin 0 on the same ctx)."""
    return cbflat[2 * OFF["PART_SIZE"] + 0]


def cbf_luma_bits(cbflat, val, trafo_depth_is0=True):
    return _gc(cbflat, OFF["QT_CBF_LUMA"] + (1 if trafo_depth_is0 else 0),
               val)


def cbf_chroma_bits(cbflat, val, trafo_depth=0):
    return _gc(cbflat, OFF["QT_CBF_CHROMA"] + trafo_depth, val)


def chroma_dm_bits(cbflat):
    """intra_chroma_pred_mode = DM (single 0 ctx bin)."""
    return cbflat[2 * OFF["CHROMA_PRED_MODE"] + 0]


def intra_mode_mpm_bits(cbflat, mode, lm, am):
    """prev_intra_luma_pred_flag + mpm_idx / rem_intra_luma_pred_mode
    pricing with the 8.4.2 candidate list from neighbour modes."""
    eq = lm == am
    lt2 = lm < 2
    m0 = torch.where(eq & lt2, 0, lm)
    m1 = torch.where(eq, torch.where(lt2, 1, 2 + ((lm + 29) % 32)), am)
    m2_eq = torch.where(lt2, 26, 2 + ((lm - 1) % 32))
    m2_ne = torch.where((lm != 0) & (am != 0), 0,
                        torch.where((lm != 1) & (am != 1), 1, 26))
    m2 = torch.where(eq, m2_eq, m2_ne)
    in0, in1, in2 = mode == m0, mode == m1, mode == m2
    inmpm = in0 | in1 | in2
    idx_gt0 = ~in0
    b_in = cbflat[2 * OFF["INTRA_PRED_MODE"] + 1] + 1.0 \
        + idx_gt0.to(torch.float32)
    b_out = cbflat[2 * OFF["INTRA_PRED_MODE"] + 0] + 5.0
    return torch.where(inmpm, b_in, b_out)


def skip_flag_bits(cbflat, val, ctx_inc):
    """cu_skip_flag; ctx_inc = left_skip + above_skip (9.3.4.2.2)."""
    return cbflat[2 * (OFF["SKIP_FLAG"] + ctx_inc.to(torch.int64))
                  + val.to(torch.int64)]


def merge_idx_bits(cbflat, mi, max_merge: int):
    """merge_idx truncated unary: first bin ctx, rest EP."""
    b = _gc(cbflat, OFF["MERGE_IDX"], mi > 0)
    if max_merge > 1:
        ep = torch.where(mi > 0,
                         (mi - 1) + (mi < max_merge - 1).to(mi.dtype),
                         0).to(torch.float32)
        b = b + ep
    return b


def merge_flag_bits(cbflat, val):
    return _gc(cbflat, OFF["MERGE_FLAG"], val)


def pred_mode_bits(cbflat, is_intra):
    return _gc(cbflat, OFF["PRED_MODE"], is_intra)


def mvp_idx_bits(cbflat, idx):
    return _gc(cbflat, OFF["MVP_IDX"], idx)


def rqt_root_cbf_bits(cbflat, val):
    return _gc(cbflat, OFF["QT_ROOT_CBF"], val)


def ref_idx_bits(cbflat, r, num_ref: int, n_active=None):
    """ref_idx_l0 truncated unary, cMax=num_ref-1; two ctx bins + EP.

    n_active (host int, optional): the real active-ref count when
    num_ref is a padded upper bound (the P-slice ref-stack padding) --
    the writer and decoder code with cMax = n_active-1, so the pricing
    follows it."""
    if num_ref <= 1:
        return torch.zeros(r.shape, dtype=torch.float32, device=r.device)
    cmax = num_ref - 1 if n_active is None else max(n_active - 1, 0)
    zero = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
    b = _gc(cbflat, OFF["REF_PIC"], r > 0) if cmax >= 1 else zero
    if cmax >= 2:
        b = b + torch.where(r > 0, _gc(cbflat, OFF["REF_PIC"] + 1, r > 1),
                            0.0)
        # bins 2.. are EP: one per step, terminator unless at cMax
        ep = torch.clamp(torch.clamp(r, max=cmax) - 2, min=0) \
            + ((r >= 2) & (r < cmax)).to(r.dtype)
        b = b + ep.to(torch.float32)
    return b


def inter_dir_bits(cbflat, inter_dir, depth: int):
    """inter_pred_idc (9.3.3.7): bin0 ctx = CtDepth, bin1 ctx 4 when
    not BI (the 2Nx2N form)."""
    bi = inter_dir == 3
    b = _gc(cbflat, OFF["INTER_DIR"] + depth, bi)
    return b + torch.where(
        bi, 0.0, _gc(cbflat, OFF["INTER_DIR"] + 4, inter_dir == 2))


def mvd_bits(cbflat, mvdx, mvdy):
    """Both components of mvd_coding (7.3.8.9): two ctx bins, EG1
    remainder, EP sign."""
    total = torch.zeros(mvdx.shape, dtype=torch.float32,
                        device=mvdx.device)
    for v in (mvdx, mvdy):
        av = v.abs()
        total = total + _gc(cbflat, OFF["MVD"], av > 0)
        total = total + torch.where(
            av > 0, _gc(cbflat, OFF["MVD"] + 1, av > 1), 0.0)
        total = total + torch.where(av > 1, ep_eg1_bits(av - 2), 0.0)
        total = total + (av > 0).to(torch.float32)      # sign
    return total
