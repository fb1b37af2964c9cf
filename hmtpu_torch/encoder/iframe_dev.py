"""Device-resident all-intra frame encoder: the port of
hmtpu/encoder/iframe_dev.py (`iframe_pass` :114, `iframe_full_pass`
:622, `unpack_iframe_state` :684).  Three-level CU decision (8/16/32),
exact closed-loop reconstruction, RDOQ and CABAC-priced costs, then
deblocking and SAO, all on the tensors' device.

  phase 1: open-loop rough mode decision (RMD) -- all 35 modes
    predicted from source-pixel reference lines per size, SATD + mode
    bits, top-K candidates per block (`rmd`: K22 on the card).

  phase 2: the static z-scan dependency levels in order (the reference's
    `lax.scan`): per 8x8 CU the K candidates and the NxN split are
    predicted from committed reconstruction, coded (RDOQ) and priced; per
    16x16 region one 16x16 CU trial overwrites its four 8x8 CUs where it
    wins; likewise per 32x32 where the picture's width and height are
    multiples of 32.  At 416x240 (h % 32 == 16) the pass runs the 8 and
    16 levels only.  With the PPS's transform skip on, the 4x4 TBs (the
    luma PUs of an NxN CU, the chroma of 8x8 CUs) are coded both ways and
    the cheaper kept (`_code_ts_sel`).

On CUDA tensors `iframe_pass` runs phase 2 as one launch of the walker
kernel K21 (csrc/iwalk.cu) per level, every lane of the level a thread
block that does the whole step (`iframe_walk`).  On CPU tensors it runs
the plain version, `iframe_pass_plain`: a Python loop over the levels,
each step a batch of the level's lanes in torch operations.  Its state
lives in flat tensors with one spare slot at the end: lanes that are
padding in a level write there (the reference sends them to an
out-of-range index, which XLA drops and `index_put_` would not).  The
state is updated in place.  Ties go to the first index everywhere, as in
the reference: a stable sort for the top-K, `argmin`/`argmax` for the
picks.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from hmtpu_torch import kernels
from hmtpu_torch.common.lambdas import frame_lambdas
from hmtpu_torch.encoder.intra_rdo import (
    LeafDecision,
    _blockify,
    rmd,
    rmd_plain,
)
from hmtpu_torch.encoder.pframe_dev import _code, _code_ts_sel, _intra_scan_sel
from hmtpu_torch.entropy.contexts import OFF
from hmtpu_torch.ops.deblock import deblock_state
from hmtpu_torch.ops.intra_pred import (
    filter_reference_batched,
    predict_modes,
    predict_one_mode,
)
from hmtpu_torch.ops.quant import dequant_params
from hmtpu_torch.ops.ratebits import (
    cbf_chroma_bits,
    cbf_luma_bits,
    chroma_dm_bits,
    intra_mode_mpm_bits,
    intra_mode_mpm_bits_nxn,
    part_size_2nx2n_bits,
    part_size_nxn_bits,
    split_flag_bits,
)
from hmtpu_torch.ops.rdoq import _k10_tables, _quant_params
from hmtpu_torch.ops.sao import sao_frame_dev
from hmtpu_torch.ops.transform import matrix
from hmtpu_torch.search.wavefront import (
    block_schedule,
    block_schedule16,
    block_schedule32,
    static_ref_gather,
)

K8 = 2       # full-RD candidates per 8x8 CU
K16 = 2      # per 16x16 / 32x32 CU


@lru_cache(maxsize=None)
def _i_static(w: int, h: int, log2_ctu: int):
    """Schedules + substituted ref-gather maps for every size (numpy)."""
    sched = block_schedule(w, h, log2_ctu)
    out = dict(
        lv_blk=sched["lv_blk"],
        nb_ok=sched["nb_ok"].reshape(-1, 5),
        g8=static_ref_gather(w, h, log2_ctu, 8),
        g4=static_ref_gather(w // 2, h // 2, log2_ctu - 1, 4),
        g4l=static_ref_gather(w, h, log2_ctu, 4),
        sched16=None, sched32=None,
    )
    if w % 16 == 0 and h % 16 == 0:
        s16 = block_schedule16(w, h, log2_ctu)
        out["sched16"] = (s16["lv_blk"], s16["cells"])
        out["g16"] = static_ref_gather(w, h, log2_ctu, 16)
        out["g8c"] = static_ref_gather(w // 2, h // 2, log2_ctu - 1, 8)
        if w % 32 == 0 and h % 32 == 0:
            s32 = block_schedule32(w, h, log2_ctu)
            out["sched32"] = (s32["lv_blk"], s32["cells16"],
                              s32["cells8"])
            out["g32"] = static_ref_gather(w, h, log2_ctu, 32)
            out["g16c"] = static_ref_gather(w // 2, h // 2,
                                            log2_ctu - 1, 16)
    return out


_DEV_STATIC: dict = {}


def _dev_static(w: int, h: int, log2_ctu: int, device):
    """_i_static as int32 tensors on `device`, one upload per geometry:
    the gather maps g* as (sub, none), lv_blk and nb_ok, and where the
    geometry has the level, lv16 / cells16 and lv32 / c16_32 / c8_32.
    The plain pass indexes with them, K21 and K22 read them."""
    key = (w, h, log2_ctu, str(device))
    t = _DEV_STATIC.get(key)
    if t is None:
        i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)) \
            .to(device).contiguous()
        st = _i_static(w, h, log2_ctu)
        t = {k: (i32(v[0]), i32(v[1])) for k, v in st.items()
             if k.startswith("g") and v is not None}
        t["lv_blk"], t["nb_ok"] = i32(st["lv_blk"]), i32(st["nb_ok"])
        if st["sched16"] is not None:
            t["lv16"], t["cells16"] = (i32(a) for a in st["sched16"])
        if st["sched32"] is not None:
            t["lv32"], t["c16_32"], t["c8_32"] = (i32(a)
                                                  for a in st["sched32"])
        _DEV_STATIC[key] = t
    return t


def _scalar(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def iframe_pass_plain(org_y, org_u, org_v, qp: int, qpc: int, cbflat,
                      *, w: int, h: int, bd: int = 8, sis: bool = False,
                      log2_ctu: int = 6,
                      qp_factor=0.57, sdh: bool = False, ts: bool = False):
    """The plain version of K21 (and of K22, through rmd_plain): the
    decision pass as torch operations, one batch of lanes per z-scan level
    and step.  Arguments and result as iframe_pass."""
    dev = org_y.device
    st8 = _dev_static(w, h, log2_ctu, dev)
    bw, bh = w // 8, h // 8
    P = bw * bh
    lam_, lam_sqrt_, wchroma_, lam_c_ = frame_lambdas(qp, qpc, qp_factor)
    lam = _scalar(lam_, dev)
    wchroma, lam_c = _scalar(wchroma_, dev), _scalar(lam_c_, dev)
    mid = 1 << (bd - 1)
    org8 = _blockify(org_y, 8)
    org4u = _blockify(org_u, 4)
    org4v = _blockify(org_v, 4)
    ar = lambda n: torch.arange(n, device=dev)

    # ---- phase 1: RMD top-K per size from source-pixel refs
    def rmd(plane, gmap, n, k):
        return rmd_plain(plane, gmap, n, k, bd=bd, lam_sqrt=lam_sqrt_,
                         sis=sis)

    cand8 = rmd(org_y, st8["g8"], 8, K8)               # (P, K8)
    # NxN 4x4 PU candidates: open-loop top-1 mode per 4x4
    # (TEncCu.cpp:644-650 intra NxN at max depth)
    cand4 = rmd(org_y, st8["g4l"], 4, 1)[:, 0]         # (P4,)
    org4l = _blockify(org_y, 4)
    gw4 = w // 4
    # z-order 4x4 offsets inside an 8x8 CU, made once: a tensor built
    # from a list inside the level loop would copy from the host and
    # wait for the card on every step
    quad_dy = torch.tensor([0, 0, 1, 1], device=dev)
    quad_dx = torch.tensor([0, 1, 0, 1], device=dev)

    i32 = dict(dtype=torch.int32, device=dev)
    st = _new_state(w, h, dev)

    def ref_line(plane, gmap, b):
        sub, none = gmap
        return torch.where(none[b, None] != 0, mid, st[plane][sub[b]])

    def mpm_neighbours(b, bxi, byi, y0):
        bL = torch.where(bxi > 0, b - 1, 0)
        bA = torch.where(byi > 0, b - bw, 0)
        lm = torch.where(bxi > 0, st["imode"][bL], 1)
        am_ok = (byi > 0) & ((y0 & ((1 << log2_ctu) - 1)) != 0)
        am = torch.where(am_ok, st["imode"][bA], 1)
        return lm, am

    def try_modes(b, modes, org, orgu, orgv, gl, gc, n, log2):
        """Full RD of `modes` (B, K) intra candidates against the
        committed state; returns per-candidate parts, k-major (K*B)."""
        B, K = modes.shape
        iref = ref_line("rec_y", gl, b)
        iref_f = filter_reference_batched(iref, n, bd, strong=sis)
        irefc = torch.cat([ref_line("rec_u", gc, b),
                           ref_line("rec_v", gc, b)])
        kmaj = lambda a: a.transpose(0, 1).reshape((K * a.shape[0],)
                                                   + a.shape[2:])
        pred = kmaj(predict_modes(iref, iref_f, modes, n, True, bd))
        c2 = predict_modes(irefc, irefc, torch.cat([modes, modes]),
                           n // 2, False, bd)          # (2B, K, ..)
        cpu, cpv = kmaj(c2[:B]), kmaj(c2[B:])
        repK = lambda a: torch.cat([a] * K)
        # mode-dependent coding scans (7.4.9.11) drive the SDH parity
        # groups: 8x8 luma and 4x4 chroma TBs only
        msel = _intra_scan_sel(modes.T.reshape(-1))     # k-major (K*B,)
        sel_y = msel if log2 == 3 else None
        sel_c = torch.cat([msel, msel]) if log2 - 1 == 2 else None
        levY, recY, dY, bY = _code(repK(org), pred, qp, log2, bd, lam,
                                   cbflat, True, sdh=sdh, scan_sel=sel_y)
        orgs_c = torch.cat([repK(orgu), repK(orgv)])
        if ts and log2 == 3:
            # 4x4 chroma TBs of an 8x8 CU: the transform-skip trial
            levC, recC, dC, bC, ts_c = _code_ts_sel(
                orgs_c, torch.cat([cpu, cpv]), qpc, bd, lam_c, cbflat,
                False, wchroma, sdh=sdh, scan_sel=sel_c)
        else:
            levC, recC, dC, bC = _code(
                orgs_c, torch.cat([cpu, cpv]), qpc, log2 - 1, bd, lam_c,
                cbflat, False, wchroma, sdh=sdh, scan_sel=sel_c)
            ts_c = torch.zeros((2 * B * K,), dtype=torch.bool, device=dev)
        levU, levV = levC[:B * K], levC[B * K:]
        recU, recV = recC[:B * K], recC[B * K:]
        dU, dV = dC[:B * K], dC[B * K:]
        bU, bV = bC[:B * K], bC[B * K:]
        ncb = (n // 2) * (n // 2)
        b_cbf = cbf_chroma_bits(
            cbflat, (levU.reshape(-1, ncb) != 0).any(1)) \
            + cbf_chroma_bits(
                cbflat, (levV.reshape(-1, ncb) != 0).any(1)) \
            + cbf_luma_bits(
                cbflat, (levY.reshape(-1, n * n) != 0).any(1))
        return (pred, levY, recY, dY, bY, levU, recU, dU, bU,
                levV, recV, dV, bV, b_cbf), (ts_c[:B * K], ts_c[B * K:])

    def pick_best(modes, parts, mode_bits, lam_):
        """argmin over the K candidates; returns flat pick indices into
        the k-major (K*B, ...) candidate arrays."""
        B, K = modes.shape
        (_, levY, recY, dY, bY, levU, recU, dU, bU,
         levV, recV, dV, bV, b_cbf) = parts
        cost = (dY + dU + dV).reshape(K, B).T + lam_ * (
            (bY + bU + bV + b_cbf).reshape(K, B).T + mode_bits)
        ki = cost.argmin(1)
        pick = ki * B + ar(B)
        return ki, pick, cost.amin(1)

    def sub_line(vals, avail):
        """8.4.4.2.2 substitution: entry 0 <- first available forward,
        then forward fill; all-unavailable -> mid."""
        first = avail.to(torch.int32).argmax(1)
        v0 = torch.gather(vals, 1, first[:, None])[:, 0]
        v0 = torch.where(avail.any(1), v0, mid)
        e = ar(vals.shape[1])
        src = torch.cummax(torch.where(avail, e, -1), 1).values
        got = torch.gather(vals, 1, src.clamp(min=0))
        return torch.where(src >= 0, got, v0[:, None])

    def nxn_trial(b, bxi, byi, lm, am, orgu, orgv):
        """Intra NxN (four 4x4 luma PUs, TEncCu.cpp:644-650): exact
        sequential reconstruction of the 4 sub-PUs against the
        committed state, assembled from the CU's committed 33-sample
        reference line + internal sub-recons."""
        B = b.shape[0]
        sub_f = ((byi * 2)[:, None] + quad_dy[None]) * gw4 \
            + (bxi * 2)[:, None] + quad_dx[None]
        m4 = cand4[sub_f]                              # (B, 4) z-order
        o4 = org4l[sub_f]                              # (B, 4, 4, 4)
        iref8 = ref_line("rec_y", st8["g8"], b)
        nbo = st8["nb_ok"][b] != 0
        aL, aA, aAR = nbo[:, 0], nbo[:, 1], nbo[:, 2]
        aBL, aC = nbo[:, 3], nbo[:, 4]
        r4 = lambda f: f[:, None].expand(B, 4)
        T = torch.ones((B, 4), dtype=torch.bool, device=dev)
        F = torch.zeros((B, 4), dtype=torch.bool, device=dev)
        T1 = torch.ones((B, 1), dtype=torch.bool, device=dev)
        z4 = torch.zeros((B, 4), **i32)

        def pu(vals, avail, mode, org):
            line = sub_line(vals, avail)
            pred = predict_one_mode(line, line, mode, 4, True, bd)
            if ts:
                return _code_ts_sel(org, pred, qp, bd, lam, cbflat, True,
                                    sdh=sdh, scan_sel=_intra_scan_sel(mode),
                                    use_dst=True)
            return _code(org, pred, qp, 2, bd, lam, cbflat, True,
                         sdh=sdh, scan_sel=_intra_scan_sel(mode),
                         use_dst=True) + (F[:, 0],)

        cat = lambda *a: torch.cat(a, 1)
        # PU0 (x, y): all references external (iref8[8:25])
        lev0, rec0, d0, bb0, tsl0 = pu(
            iref8[:, 8:25],
            cat(r4(aL), r4(aL), aC[:, None], r4(aA), r4(aA)),
            m4[:, 0], o4[:, 0])
        # PU1 (x+4, y): lower-left internal-unavailable, left = PU0's
        # right column, corner/top external
        lev1, rec1, d1, bb1, tsl1 = pu(
            cat(z4, rec0[:, :, 3].flip(1), iref8[:, 20:21],
                iref8[:, 21:29]),
            cat(F, T, aA[:, None], r4(aA), r4(aAR)), m4[:, 1], o4[:, 1])
        # PU2 (x, y+4): left external (lower then upper), top = PU0 +
        # PU1 bottom rows
        lev2, rec2, d2, bb2, tsl2 = pu(
            cat(iref8[:, 4:8], iref8[:, 8:12], iref8[:, 12:13],
                rec0[:, 3, :], rec1[:, 3, :]),
            cat(r4(aBL), r4(aL), aL[:, None], T, T), m4[:, 2], o4[:, 2])
        # PU3 (x+4, y+4): below-left/top-right unavailable, left =
        # PU2's right column, corner = PU0[3,3], top = PU1 bottom row
        lev3, rec3, d3, bb3, tsl3 = pu(
            cat(z4, rec2[:, :, 3].flip(1), rec0[:, 3, 3][:, None],
                rec1[:, 3, :], z4),
            cat(F, T, T1, T, F), m4[:, 3], o4[:, 3])

        # chroma: one 4x4 TB pair, DM mode = PU0's luma mode
        irefc = torch.cat([ref_line("rec_u", st8["g4"], b),
                           ref_line("rec_v", st8["g4"], b)])
        mc = torch.cat([m4[:, 0], m4[:, 0]])
        c2 = predict_one_mode(irefc, irefc, mc, 4, False, bd)
        if ts:
            levC, recC, dC, bC, tsc = _code_ts_sel(
                torch.cat([orgu, orgv]), c2, qpc, bd, lam_c, cbflat, False,
                wchroma, sdh=sdh, scan_sel=_intra_scan_sel(mc))
        else:
            levC, recC, dC, bC = _code(
                torch.cat([orgu, orgv]), c2, qpc, 2, bd, lam_c, cbflat,
                False, wchroma, sdh=sdh, scan_sel=_intra_scan_sel(mc))
            tsc = torch.zeros((2 * B,), dtype=torch.bool, device=dev)
        levCu, levCv = levC[:B], levC[B:]
        recCu, recCv = recC[:B], recC[B:]
        # transform-skip flags: bits 0-3 the luma PUs, 4 cb, 5 cr
        tsf_n = sum(f.to(torch.int32) << k for k, f in enumerate(
            (tsl0, tsl1, tsl2, tsl3, tsc[:B], tsc[B:])))

        # rate: part NxN + 4x(mode + cbf + residual) + chroma; MPM
        # pricing per PU with internal neighbour modes (approximation
        # for the decision only -- the writer derives the exact lists)
        mb = intra_mode_mpm_bits_nxn(cbflat, m4, lm, am)
        nz = [(lv.reshape(B, 16) != 0).any(1)
              for lv in (lev0, lev1, lev2, lev3)]
        b_cbf = sum(cbf_luma_bits(cbflat, z, trafo_depth_is0=False)
                    for z in nz) \
            + cbf_chroma_bits(cbflat, (levCu.reshape(B, 16) != 0).any(1)) \
            + cbf_chroma_bits(cbflat, (levCv.reshape(B, 16) != 0).any(1))
        cost = (d0 + d1 + d2 + d3 + dC[:B] + dC[B:]) + lam * (
            mb + part_size_nxn_bits(cbflat) + chroma_dm_bits(cbflat)
            + b_cbf + bb0 + bb1 + bb2 + bb3 + bC[:B] + bC[B:])
        # assemble the 8x8 products (quadrant placement)
        quad = lambda a, b_, c, d: torch.cat(
            [torch.cat([a, b_], 2), torch.cat([c, d], 2)], 1)
        rec8 = quad(rec0, rec1, rec2, rec3)
        lev8 = quad(lev0, lev1, lev2, lev3)
        cbf_any = (nz[0] | nz[1] | nz[2] | nz[3]).to(torch.int32)
        return (cost, m4, rec8, recCu, recCv, lev8, levCu, levCv,
                cbf_any, tsf_n)

    def plane_index(x0, y0, n, valid, width, spare):
        """(B, n, n) flat indices of the n x n blocks at (x0, y0);
        padding lanes point at the spare slot."""
        yy = y0[:, None] + ar(n)[None, :]
        xx = x0[:, None] + ar(n)[None, :]
        fl = yy[:, :, None] * width + xx[:, None, :]
        return torch.where(valid[:, None, None], fl, spare)

    def commit(fl_y, fl_c, rec, slots, vals):
        """Scatter reconstruction and per-cell decisions into the state
        (in place)."""
        st["rec_y"][fl_y] = rec[0]
        st["rec_u"][fl_c] = rec[1]
        st["rec_v"][fl_c] = rec[2]
        for k, v in vals.items():
            st[k][slots] = v

    def cell_step(blk, valid):
        b = torch.where(valid, blk, 0)
        byi, bxi = b // bw, b % bw
        x0, y0 = bxi * 8, byi * 8
        B = blk.shape[0]
        modes = cand8[b]                                  # (B, K8)
        lm, am = mpm_neighbours(b, bxi, byi, y0)
        mb = intra_mode_mpm_bits(cbflat, modes, lm[:, None],
                                 am[:, None]) \
            + part_size_2nx2n_bits(cbflat) + chroma_dm_bits(cbflat)
        parts, (ts_u, ts_v) = try_modes(b, modes, org8[b], org4u[b],
                                        org4v[b], st8["g8"], st8["g4"], 8, 3)
        ki, pick, cost = pick_best(modes, parts, mb, lam)
        (_, levY, recY, _, _, levU, recU, _, _, levV, recV, _, _,
         _) = parts
        out_y, out_u, out_v = recY[pick], recU[pick], recV[pick]
        o_lev = torch.cat([levY[pick].reshape(B, 64),
                           levU[pick].reshape(B, 16),
                           levV[pick].reshape(B, 16)], 1)
        wmode = torch.gather(modes, 1, ki[:, None])[:, 0]
        cbfy8 = (levY[pick].reshape(B, 64) != 0).any(1).to(torch.int32)
        tsf2 = (ts_u[pick].to(torch.int32) << 4) \
            | (ts_v[pick].to(torch.int32) << 5)

        # ---- NxN trial against the 2Nx2N winner
        (cost_n, m4, rec8n, recCun, recCvn, lev8n, levCun, levCvn,
         cbf_n, tsf_n) = nxn_trial(b, bxi, byi, lm, am, org4u[b], org4v[b])
        use_n = cost_n < cost
        cost = torch.minimum(cost, cost_n)
        w3 = lambda a, bn: torch.where(use_n[:, None, None], bn, a)
        out_y = w3(out_y, rec8n)
        out_u = w3(out_u, recCun)
        out_v = w3(out_v, recCvn)
        o_lev = torch.where(
            use_n[:, None],
            torch.cat([lev8n.reshape(B, 64), levCun.reshape(B, 16),
                       levCvn.reshape(B, 16)], 1), o_lev)
        wmode = torch.where(use_n, m4[:, 0], wmode)
        cbfy8 = torch.where(use_n, cbf_n, cbfy8)
        imode4_o = torch.where(use_n[:, None], m4,
                               wmode[:, None].expand(B, 4))

        commit(plane_index(x0, y0, 8, valid, w, h * w),
               plane_index(bxi * 4, byi * 4, 4, valid, w // 2,
                           h * w // 4),
               (out_y, out_u, out_v), torch.where(valid, b, P),
               dict(imode=wmode, imode4=imode4_o,
                    part=use_n.to(torch.int32), cusz=0, cbfy=cbfy8,
                    levs=o_lev, tsf=torch.where(use_n, tsf_n, tsf2)))
        return cost

    # one step per z-scan dependency level, in order; the CU sizes the
    # picture's geometry allows (16 and 32 need both sides multiples)
    if "lv16" not in st8:
        for blk in st8["lv_blk"]:
            cell_step(blk, blk >= 0)
        return _strip(st)

    # ---- 16 level
    gw = bw // 2
    org16 = _blockify(org_y, 16)
    org8u = _blockify(org_u, 8)
    org8v = _blockify(org_v, 8)
    cand16 = rmd(org_y, st8["g16"], 16, K16)
    lv16, cells16 = st8["lv16"], st8["cells16"]
    one_bit = lambda g: split_flag_bits(cbflat, torch.ones_like(g),
                                        torch.ones_like(g))
    zero_bit = lambda g: split_flag_bits(cbflat, torch.zeros_like(g),
                                         torch.ones_like(g))

    def region16(blk16, valid):
        g = torch.where(valid, blk16, 0)
        B = blk16.shape[0]
        c4 = cells16[g]
        cost8 = torch.zeros((B,), dtype=torch.float32, device=dev)
        for j in range(4):
            cost8 = cost8 + cell_step(c4[:, j], valid)

        gyb, gxb = g // gw, g % gw
        corner = (gyb * 2) * bw + gxb * 2
        modes = cand16[g]
        lm, am = mpm_neighbours(corner, gxb * 2, gyb * 2, gyb * 16)
        mb = intra_mode_mpm_bits(cbflat, modes, lm[:, None],
                                 am[:, None]) + chroma_dm_bits(cbflat)
        parts, _ = try_modes(g, modes, org16[g], org8u[g], org8v[g],
                          st8["g16"], st8["g8c"], 16, 4)
        ki, pick, cost16 = pick_best(modes, parts, mb, lam)
        (_, levY, recY, _, _, levU, recU, _, _, levV, recV, _, _,
         _) = parts
        # neighbour-depth approximation of the split ctxInc
        cost16 = cost16 + lam * zero_bit(g)
        cost8 = cost8 + lam * one_bit(g)
        use16 = valid & (cost16 < cost8)
        wmode = torch.gather(modes, 1, ki[:, None])[:, 0]
        pack = torch.cat([levY[pick].reshape(B, 256),
                          levU[pick].reshape(B, 64),
                          levV[pick].reshape(B, 64)], 1).reshape(B, 4, 96)
        commit(plane_index(gxb * 16, gyb * 16, 16, use16, w, h * w),
               plane_index(gxb * 8, gyb * 8, 8, use16, w // 2,
                           h * w // 4),
               (recY[pick], recU[pick], recV[pick]),
               torch.where(use16[:, None], c4, P),
               dict(imode=wmode[:, None],
                    imode4=wmode[:, None, None].expand(B, 1, 4),
                    part=0, cusz=1,
                    cbfy=(levY[pick].reshape(B, 256) != 0).any(1)
                    .to(torch.int32)[:, None],
                    levs=pack, tsf=0))
        return torch.where(use16, cost16, cost8)

    if "lv32" not in st8:
        for blk16 in lv16:
            region16(blk16, blk16 >= 0)
        return _strip(st)

    # ---- 32 level
    qw = gw // 2
    org32 = _blockify(org_y, 32)
    org16u = _blockify(org_u, 16)
    org16v = _blockify(org_v, 16)
    cand32 = rmd(org_y, st8["g32"], 32, K16)
    lv32, cells16_32, cells8_32 = st8["lv32"], st8["c16_32"], st8["c8_32"]

    def step32(blk32):
        valid = blk32 >= 0
        g = torch.where(valid, blk32, 0)
        B = blk32.shape[0]
        cost_sub = torch.zeros((B,), dtype=torch.float32, device=dev)
        c16 = cells16_32[g]
        for j in range(4):
            cells = c16[:, j]
            cv = valid & (cells >= 0)
            cc = region16(torch.where(cv, cells, 0), cv)
            cost_sub = cost_sub + torch.where(cv, cc, 0.0)

        qyb, qxb = g // qw, g % qw
        corner = (qyb * 4) * bw + qxb * 4
        modes = cand32[g]
        lm, am = mpm_neighbours(corner, qxb * 4, qyb * 4, qyb * 32)
        mb = intra_mode_mpm_bits(cbflat, modes, lm[:, None],
                                 am[:, None]) + chroma_dm_bits(cbflat)
        parts, _ = try_modes(g, modes, org32[g], org16u[g], org16v[g],
                          st8["g32"], st8["g16c"], 32, 5)
        ki, pick, cost32 = pick_best(modes, parts, mb, lam)
        (_, levY, recY, _, _, levU, recU, _, _, levV, recV, _, _,
         _) = parts
        cost32 = cost32 + lam * zero_bit(g)
        cost_sub = cost_sub + lam * one_bit(g)
        use32 = valid & (cost32 < cost_sub)
        wmode = torch.gather(modes, 1, ki[:, None])[:, 0]
        pack = torch.cat([levY[pick].reshape(B, 1024),
                          levU[pick].reshape(B, 256),
                          levV[pick].reshape(B, 256)], 1) \
            .reshape(B, 16, 96)
        commit(plane_index(qxb * 32, qyb * 32, 32, use32, w, h * w),
               plane_index(qxb * 16, qyb * 16, 16, use32, w // 2,
                           h * w // 4),
               (recY[pick], recU[pick], recV[pick]),
               torch.where(use32[:, None], cells8_32[g], P),
               dict(imode=wmode[:, None],
                    imode4=wmode[:, None, None].expand(B, 1, 4),
                    part=0, cusz=2,
                    cbfy=(levY[pick].reshape(B, 1024) != 0).any(1)
                    .to(torch.int32)[:, None],
                    levs=pack, tsf=0))

    for blk32 in lv32:
        step32(blk32)
    return _strip(st)


def _new_state(w: int, h: int, dev):
    """The pass's state, zeroed, with one spare slot per array: the plain
    version's padding lanes write there (K21's do nothing)."""
    i32 = dict(dtype=torch.int32, device=dev)
    P = (w // 8) * (h // 8)
    return dict(
        rec_y=torch.zeros(h * w + 1, **i32),
        rec_u=torch.zeros(h * w // 4 + 1, **i32),
        rec_v=torch.zeros(h * w // 4 + 1, **i32),
        imode=torch.zeros(P + 1, **i32),
        imode4=torch.zeros((P + 1, 4), **i32),
        part=torch.zeros(P + 1, **i32),
        cusz=torch.zeros(P + 1, **i32),
        cbfy=torch.zeros(P + 1, **i32),
        levs=torch.zeros((P + 1, 96), **i32),
        tsf=torch.zeros(P + 1, **i32),
    )


def iframe_pass(org_y, org_u, org_v, qp: int, qpc: int, cbflat,
                *, w: int, h: int, bd: int = 8, sis: bool = False,
                log2_ctu: int = 6,
                qp_factor=0.57, sdh: bool = False, ts: bool = False):
    """Decision pass.  Planes are int32 (H, W) / (H/2, W/2) tensors on
    the pass's device, cbflat the (NUM_CTX*2,) float32 bits table there;
    qp and qpc are host integers.  ts: the 4x4 TBs (the luma PUs of an
    NxN CU, the chroma of 8x8 CUs) get the transform-skip trial.
    Returns the state dict (int32).  On CUDA tensors the RMD is K22 and
    each z-scan level one K21 launch; on CPU tensors the plain version
    runs."""
    if not org_y.is_cuda:
        return iframe_pass_plain(org_y, org_u, org_v, qp, qpc, cbflat, w=w,
                                 h=h, bd=bd, sis=sis, log2_ctu=log2_ctu,
                                 qp_factor=qp_factor, sdh=sdh, ts=ts)
    return iframe_walk(org_y, org_u, org_v, qp, qpc, cbflat, w=w, h=h, bd=bd,
                       sis=sis, log2_ctu=log2_ctu, qp_factor=qp_factor,
                       sdh=sdh, ts=ts)


# ---------------------------------------------------------------------------
# K21: the walker's arguments (csrc/iwalk.cuh `Args`, in `args_from`'s
# order) and its launches

IW_SCRATCH = 0  # ints of a lane's device scratch, iw::SCRATCH (checked)
_IW_CTX = ("QT_CBF_LUMA", "QT_CBF_CHROMA", "PART_SIZE", "CHROMA_PRED_MODE",
           "SPLIT_FLAG", "INTRA_PRED_MODE", "TRANSFORMSKIP_FLAG")
_IW_TB_SETS = ((2, True), (2, False), (3, True), (3, False), (4, True),
               (4, False), (5, True))
_IW_TABLES: dict = {}


def _iw_tables(dev):
    """K21's constant tables on `dev`: the transform matrices and the
    packed K10 tables of every TB size it codes, one upload per device."""
    key = str(dev)
    t = _IW_TABLES.get(key)
    if t is not None:
        return t
    t = {"mats": torch.cat([matrix(n, False, dev).reshape(-1)
                            for n in (4, 8, 16, 32)]
                           + [matrix(4, True, dev).reshape(-1)])
         .contiguous()}
    tabs = [_k10_tables(l2, 0, luma, dev) for l2, luma in _IW_TB_SETS]
    t["tabs_i"] = torch.cat([x[0] for x in tabs]).contiguous()
    t["tabs_f"] = torch.cat([x[1] for x in tabs]).contiguous()
    off_i = np.cumsum([0] + [x[0].numel() for x in tabs])
    off_f = np.cumsum([0] + [x[1].numel() for x in tabs])
    t["tab_ctx"] = [(int(off_i[j]), int(off_f[j]), x[2]["ctx_x"],
                     x[2]["ctx_y"], x[2]["sig_cg_base"], x[2]["one_base"],
                     x[2]["abs_base"]) for j, x in enumerate(tabs)]
    _IW_TABLES[key] = t
    return t


def _iw_args(org, st, cand, sd, cbflat, scratch, *, w, h, bd, log2_ctu,
             geom, qp, qpc, lams, sdh, ts, sis):
    """(pointers, ints, floats) of iw::Args as ctypes arrays."""
    nil = (None, None)
    lv = sd[{8: "lv_blk", 16: "lv16", 32: "lv32"}[geom]]
    tensors = [*org, *(st[k] for k in ("rec_y", "rec_u", "rec_v", "imode",
                                       "imode4", "part", "cusz", "cbfy",
                                       "levs", "tsf")),
               cand.get(8), cand.get(4), cand.get(16), cand.get(32), lv,
               sd["nb_ok"], *sd["g8"], *sd["g4"], *sd.get("g16", nil),
               *sd.get("g8c", nil), *sd.get("g32", nil),
               *sd.get("g16c", nil), sd.get("cells16"), sd.get("c16_32"),
               sd.get("c8_32"), sd["mats"], cbflat, sd["tabs_i"],
               sd["tabs_f"], scratch]
    ints = [w, h, bd, log2_ctu, geom, lv.shape[1], int(sdh), int(ts),
            int(sis), IW_SCRATCH] + [OFF[c] for c in _IW_CTX]
    return walk_args(tensors, ints, sd["tab_ctx"], qp, qpc, bd, lams)


def walk_args(tensors, ints, tab_ctx, qp: int, qpc: int, bd: int, lams):
    """A walker's (pointers, ints, floats) as ctypes arrays: the tensors'
    device pointers (None: null), the given ints, then per K10 table set
    (walk.cuh wk::Coder) its context offsets and quantiser ints, and the
    floats: per set (inv, cscale), then `lams`."""
    ptrs = [0 if x is None else x.data_ptr() for x in tensors]
    ints = list(ints)
    flts = []
    for (l2, luma), ctx in zip(_IW_TB_SETS, tab_ctx):
        q = qp if luma else qpc
        qbits, scale, inv, cscale = _quant_params(q, l2, bd)
        iscale, dq_shift = dequant_params(q, l2, bd)
        ints += [*ctx, scale, qbits, 85 << (qbits - 9), iscale, dq_shift]
        flts += [inv, cscale]
    flts += [float(x) for x in lams]
    return ((ctypes.c_longlong * len(ptrs))(*ptrs),
            (ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(flts))(*flts))


def _k21_level(scratch, ptrs, ints, flts, level):
    kernels.launch("i_walk", "hm_i_walk", scratch,
                   *(x for arr in (ptrs, ints, flts)
                     for x in (ctypes.addressof(arr), len(arr))), level)


def iframe_walk(org_y, org_u, org_v, qp: int, qpc: int, cbflat, *, w: int,
                h: int, bd: int = 8, sis: bool = False, log2_ctu: int = 6,
                qp_factor=0.57, sdh: bool = False, ts: bool = False,
                run_level=_k21_level):
    """iframe_pass through the walker: the RMD candidates of every size
    (`rmd`), then `run_level(scratch, ptrs, ints, flts, level)` once per
    z-scan level of the geometry (K21 by default; the CPU tests give it
    the host build of the lane code)."""
    dev = org_y.device
    sd = {**_dev_static(w, h, log2_ctu, dev), **_iw_tables(dev)}
    lam_, lam_sqrt_, wchroma_, lam_c_ = frame_lambdas(qp, qpc, qp_factor)
    geom = 32 if "lv32" in sd else 16 if "lv16" in sd else 8
    r = lambda g, n, k: rmd(org_y, sd[g], n, k, bd=bd, lam_sqrt=lam_sqrt_,
                            sis=sis)
    cand = {8: r("g8", 8, K8), 4: r("g4l", 4, 1)}
    if geom >= 16:
        cand[16] = r("g16", 16, K16)
    if geom == 32:
        cand[32] = r("g32", 32, K16)
    st = _new_state(w, h, dev)
    lv = sd[{8: "lv_blk", 16: "lv16", 32: "lv32"}[geom]]
    scratch = torch.zeros((lv.shape[1], IW_SCRATCH), dtype=torch.int32,
                          device=dev)
    org = tuple(p.to(torch.int32).contiguous() for p in (org_y, org_u, org_v))
    cbflat = cbflat.to(torch.float32).contiguous()
    args = _iw_args(org, st, cand, sd, cbflat, scratch, w=w, h=h, bd=bd,
                    log2_ctu=log2_ctu, geom=geom, qp=qp, qpc=qpc,
                    lams=(lam_, lam_c_, wchroma_), sdh=sdh, ts=ts, sis=sis)
    for level in range(lv.shape[0]):
        run_level(scratch, *args, level)
    return _strip(st)


def _strip(st):
    """Drop the spare slot of every state array."""
    return {k: v[:-1] for k, v in st.items()}


_SMALL = dict(imode=torch.int8, imode4=torch.int8, part=torch.int8,
              cusz=torch.int8, cbfy=torch.int8, levs=torch.int16,
              sao=torch.int8, tsf=torch.int8)


def iframe_full_pass(org_y, org_u, org_v, qp: int, qpc: int, cbflat,
                     *, w: int, h: int, bd: int = 8, sis: bool = False,
                     log2_ctu: int = 6, deblock: bool = True,
                     sao: bool = True, ctu: int = 64, cb_off: int = 0,
                     cr_off: int = 0, qp_factor=0.57,
                     sdh: bool = False, ts: bool = False):
    """Decision pass + in-loop filters (the I-frame twin of the
    reference's full P pass).  Returns the state narrowed as the
    reference narrows it: rec_* uint8 (uint16 above 8 bits), levs
    int16, the flags and SAO params int8."""
    dev = org_y.device
    # SAO's lambda, on the device before the filters run
    lam_sao = _scalar(frame_lambdas(qp, qp, qp_factor)[0], dev) \
        if sao else None
    st = iframe_pass(org_y, org_u, org_v, qp, qpc, cbflat, w=w, h=h,
                     bd=bd, sis=sis, log2_ctu=log2_ctu,
                     qp_factor=qp_factor, sdh=sdh, ts=ts)
    if deblock or sao:
        if deblock:
            # one K3 launch: the CU sizes read in place, every cell intra
            rec_y, rec_u, rec_v = deblock_state(
                st["rec_y"], st["rec_u"], st["rec_v"], None, qp, bd, h=h,
                w=w, cusz=st["cusz"], cbfy=st["cbfy"], cb_qp_off=cb_off,
                cr_qp_off=cr_off)
        else:
            rec_y = st["rec_y"].reshape(h, w)
            rec_u = st["rec_u"].reshape(h // 2, w // 2)
            rec_v = st["rec_v"].reshape(h // 2, w // 2)
        if sao:
            rec_y, rec_u, rec_v, sao_params = sao_frame_dev(
                org_y, rec_y, org_u, rec_u, org_v, rec_v, ctu, lam_sao, bd)
            st["sao"] = sao_params
        st["rec_y"] = rec_y.reshape(-1)
        st["rec_u"] = rec_u.reshape(-1)
        st["rec_v"] = rec_v.reshape(-1)
    rec_t = torch.uint8 if bd == 8 else torch.int16
    small = dict(_SMALL, rec_y=rec_t, rec_u=rec_t, rec_v=rec_t)
    return {k: v.to(small[k]) for k, v in st.items()}


def unpack_iframe_state(st, w: int, h: int, log2_ctu: int):
    """Host state (numpy) -> (mode8, depth8, decisions dict) in the
    IntraFrameEncoder envelope (z-order cell packing)."""
    bw, bh = w // 8, h // 8
    imode = np.asarray(st["imode"]).reshape(bh, bw)
    part = np.asarray(st["part"]).reshape(bh, bw) \
        if "part" in st else np.zeros((bh, bw), np.int32)
    imode4 = np.asarray(st["imode4"]).reshape(bh, bw, 4) \
        if "imode4" in st else None
    cusz = np.asarray(st["cusz"]).reshape(bh, bw)
    levs = np.asarray(st["levs"]).reshape(bh, bw, 96)
    tsf = np.asarray(st["tsf"]).reshape(bh, bw) \
        if "tsf" in st else None
    depth8 = np.full((bh, bw), log2_ctu - 3, np.int32)
    depth8[cusz == 1] = log2_ctu - 4
    depth8[cusz == 2] = log2_ctu - 5
    decisions = {}
    for byi in range(bh):
        for bxi in range(bw):
            sz = int(cusz[byi, bxi])
            if sz == 1 and (byi % 2 or bxi % 2):
                continue
            if sz == 2 and (byi % 4 or bxi % 4):
                continue
            mode = int(imode[byi, bxi])
            if sz == 0:
                lv = levs[byi, bxi]
                m4 = tuple(int(x) for x in imode4[byi, bxi]) \
                    if (imode4 is not None and part[byi, bxi]) else None
                tf = int(tsf[byi, bxi]) if tsf is not None else 0
                decisions[(bxi * 8, byi * 8)] = LeafDecision(
                    mode, 3, lv[:64].reshape(8, 8),
                    lv[64:80].reshape(4, 4), lv[80:96].reshape(4, 4),
                    modes4=m4,
                    ts_y4=tuple((tf >> p) & 1 for p in range(4)),
                    ts_cb=(tf >> 4) & 1, ts_cr=(tf >> 5) & 1)
            elif sz == 1:
                l2 = levs[byi:byi + 2, bxi:bxi + 2].reshape(4, 96)
                flat = np.concatenate([l2[0], l2[1], l2[2], l2[3]])
                decisions[(bxi * 8, byi * 8)] = LeafDecision(
                    mode, 4, flat[:256].reshape(16, 16),
                    flat[256:320].reshape(8, 8),
                    flat[320:384].reshape(8, 8))
            else:
                zord = ((0, 0), (0, 1), (1, 0), (1, 1),
                        (0, 2), (0, 3), (1, 2), (1, 3),
                        (2, 0), (2, 1), (3, 0), (3, 1),
                        (2, 2), (2, 3), (3, 2), (3, 3))
                flat = np.concatenate(
                    [levs[byi + r, bxi + c] for r, c in zord])
                decisions[(bxi * 8, byi * 8)] = LeafDecision(
                    mode, 5, flat[:1024].reshape(32, 32),
                    flat[1024:1280].reshape(16, 16),
                    flat[1280:1536].reshape(16, 16))
    mode8 = imode.astype(np.int32)
    return mode8, depth8, decisions
