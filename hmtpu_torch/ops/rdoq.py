"""Rate-distortion optimized quantization, batched: the port of
hmtpu/ops/rdoq.py `rdoq_tb` :43 (capability parity with
TComTrQuant::xRateDistOptQuant, TComTrQuant.cpp:2129-2450).

Three vectorised stages over (batch, nCG, 16) tensors: per-coefficient
level choice over {maxAbs, maxAbs-1, 0}; coefficient-group zeroing
against the coded_sub_block_flag rate; last-position optimisation.
An exact-rate guard re-prices the result and plain deadzone
quantisation with `tb_bits` and keeps the per-block winner; the sign
data hiding parity stage runs last.  Context identities come from the
rounded-level significance map, as in hmtpu.

Costs are float32 in hmtpu's order of operations; sums are taken in
float64 and rounded once (ratebits.fsum), so the card and the CPU agree.

On a CUDA tensor `rdoq_tb` launches the hand-written kernel K10
(csrc/rdoq.cu), which runs the same stages and the TB rate in one
launch; `rdoq_code` returns the levels, their dequantisation and their
`tb_bits` price from that one launch (the coding step of both decision
passes).  `tb_bits`, `quantize_t` and `dequantize_t` reach K10 through
`k10` as well.  On a CPU tensor every function runs its plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from hmtpu_torch import kernels
from hmtpu_torch.common.lambdas import exp2_int
from hmtpu_torch.common.scan import _SCANS
from hmtpu_torch.ops.quant import (
    COEFF_MAX,
    QUANT_SHIFT,
    _QUANT_SCALES,
    dequant_params,
    dequantize_t_plain,
    transform_shift,
)
from hmtpu_torch.ops.ratebits import (
    _remainder_ep_bits,
    _tb_tables,
    _tb_tables_np,
    excl_suffix_count,
    fsum,
    gcb,
    last_pos_bits_table,
    prev_processed_flag,
    tb_bits_plain,
)

_C1FLAG = 8
_RANK_TABS: dict = {}


def _scan_rank_table(scan_idx: int, device):
    """(3, 16): within-CG rank under coding scan s of the coefficient at
    static-scan rank j."""
    key = (scan_idx, str(device))
    t = _RANK_TABS.get(key)
    if t is None:
        base = _SCANS[scan_idx](4, 4)
        ptab = np.empty((3, 16), np.int64)
        for s in range(3):
            rk = {p: i for i, p in enumerate(_SCANS[s](4, 4))}
            ptab[s] = [rk[p] for p in base]
        t = torch.as_tensor(ptab).to(device)
        _RANK_TABS[key] = t
    return t


def _quant_params(qp: int, log2: int, bd: int):
    """(qbits, scale, 2^qbits / scale as float32, distortion scale) of
    the integer quantiser at this QP and size."""
    qpp = int(qp) + 6 * (bd - 8)
    per, rem = qpp // 6, qpp % 6
    qbits = QUANT_SHIFT + per + transform_shift(log2, bd)
    scale = _QUANT_SCALES[rem]
    # distortion of coding |level| l: (a - l*2^qbits/scale)^2 scaled to
    # pixel SSE by 2^-2*(15-bd-log2); 2^qbits as the reference rounds it
    inv = float(exp2_int(qbits) / np.float32(scale))
    cscale = float(np.float32(2.0 ** (-2 * (15 - bd - log2))))
    return qbits, scale, inv, cscale


def rdoq_tb(coef, qp: int, log2: int, bd: int, lam, cbflat,
            is_luma: bool, scan_idx: int = 0, sdh: bool = False,
            scan_sel=None, trellis: bool = True):
    """coef: (..., n, n) int32 transform coefficients; returns levels
    (..., n, n) int32.  lam: float32 0-d tensor on coef's device.

    scan_sel: optional (...,) per-TB coding-scan id (0 diag / 1 hor /
    2 ver); only the SDH parity stage needs the true scan."""
    if coef.is_cuda:
        return k10(coef, log2, is_luma, scan_idx, cbflat=cbflat, qp=qp,
                   bd=bd, lam=lam, sdh=sdh, scan_sel=scan_sel,
                   trellis=trellis, want=("lev",))[0]
    return rdoq_tb_plain(coef, qp, log2, bd, lam, cbflat, is_luma,
                         scan_idx, sdh, scan_sel, trellis)


def rdoq_code(coef, qp: int, log2: int, bd: int, lam, cbflat,
              is_luma: bool, sdh: bool = False, scan_sel=None,
              trellis: bool = True):
    """The coding step of `_code`: (levels, dequantised coefficients,
    tb_bits price with the SDH sign rule) of a batch of TBs; one K10
    launch on the card."""
    if coef.is_cuda:
        return k10(coef, log2, is_luma, 0, cbflat=cbflat, qp=qp, bd=bd,
                   lam=lam, sdh=sdh, scan_sel=scan_sel, trellis=trellis,
                   want=("lev", "deq", "bits"))
    lev = rdoq_tb_plain(coef, qp, log2, bd, lam, cbflat, is_luma, 0, sdh,
                        scan_sel, trellis)
    return (lev, dequantize_t_plain(lev, qp, log2, bd),
            tb_bits_plain(lev, cbflat, log2, is_luma, 0, sdh))


# ---------------------------------------------------------------------------
# K10: the launch

_K10_TABS: dict = {}


def _k10_tables(log2: int, scan_idx: int, is_luma: bool, device):
    """The kernel's packed tables of one (size, scan, component): int32
    [scans, sig_tab, right, below, last_x, last_y, scan rank table] and
    float32 [w_cnt, ep_cnt] (the layout of `Tabs` in csrc/rdoq.cu)."""
    key = (log2, scan_idx, is_luma, str(device))
    t = _K10_TABS.get(key)
    if t is None:
        n = _tb_tables_np(log2, scan_idx, is_luma)
        ranks = _scan_rank_table(scan_idx, "cpu").numpy()
        ti = np.concatenate([np.asarray(n[k]).reshape(-1) for k in (
            "scans", "sig_tab", "right", "below", "last_x", "last_y")]
            + [ranks.reshape(-1)]).astype(np.int32)
        tf = np.concatenate([n["w_cnt"].reshape(-1),
                             n["ep_cnt"].reshape(-1)]).astype(np.float32)
        t = (torch.as_tensor(ti).to(device),
             torch.as_tensor(tf).to(device),
             {k: n[k] for k in ("ctx_x", "ctx_y", "sig_cg_base",
                                "one_base", "abs_base")})
        _K10_TABS[key] = t
    return t


_F_LEV_IN, _F_TRELLIS, _F_SDH, _F_LUMA = 1, 2, 4, 8


def k10(x, log2: int, is_luma: bool, scan_idx: int = 0, *, cbflat=None,
        qp: int = 0, bd: int = 8, lam=None, sdh: bool = False,
        scan_sel=None, trellis: bool = False, lev_in: bool = False,
        add=None, want=("lev",)):
    """Launch K10 on a batch of (..., n, n) int32 TBs on the card.  x is
    coefficients (quantised by the trellis when `trellis`, else by the
    deadzone rounding `add`, by default HM's inter 85/512, then the SDH
    parity stage when `sdh`), or levels when `lev_in`.  Returns the
    `want`ed outputs among "lev" (levels), "deq" (their dequantisation
    at qp) and "bits" (their tb_bits price, SDH sign rule when `sdh`)."""
    n = 1 << log2
    if x.shape[-1] != n or x.shape[-2] != n:
        raise ValueError(f"rdoq: expected (..., {n}, {n}), got "
                         f"{tuple(x.shape)}")
    dev = x.device
    lead = x.shape[:-2]
    x = x.to(torch.int32).contiguous()
    nb = x.numel() // (n * n)
    tabs_i, tabs_f, ctx = _k10_tables(log2, scan_idx, is_luma, dev)
    qbits, scale, inv, cscale = _quant_params(qp, log2, bd)
    iscale, dq_shift = dequant_params(qp, log2, bd)
    if add is None:
        add = 85 << (qbits - 9)
    flags = (_F_LEV_IN * lev_in + _F_TRELLIS * (trellis and not lev_in)
             + _F_SDH * sdh + _F_LUMA * is_luma)
    needs_lam = not lev_in and (trellis or sdh)
    if needs_lam:
        lam = torch.as_tensor(lam, dtype=torch.float32,
                              device=dev).reshape(1).contiguous()
    outs = {k: torch.empty(lead + ((n, n) if k != "bits" else ()),
                           dtype=torch.float32 if k == "bits"
                           else torch.int32, device=dev)
            for k in want}
    if nb:
        sel = None if scan_sel is None else \
            scan_sel.to(torch.int32).reshape(-1).contiguous()
        kernels.launch(
            "rdoq", "hm_rdoq", x,
            None if cbflat is None else cbflat.to(torch.float32).contiguous(),
            lam if needs_lam else None, sel, tabs_i, tabs_f,
            outs.get("lev"), outs.get("deq"), outs.get("bits"),
            nb, log2, flags, scale, qbits, add, iscale, dq_shift,
            ctx["ctx_x"], ctx["ctx_y"], ctx["sig_cg_base"],
            ctx["one_base"], ctx["abs_base"], inv, cscale)
    return tuple(outs[k] for k in want)


def rdoq_tb_plain(coef, qp: int, log2: int, bd: int, lam, cbflat,
                  is_luma: bool, scan_idx: int = 0, sdh: bool = False,
                  scan_sel=None, trellis: bool = True):
    """The plain version of K10's quantisation (rdoq_tb's stages)."""
    dev = coef.device
    t = _tb_tables(log2, scan_idx, is_luma, dev)
    npos, ncg = t["npos"], t["ncg"]
    lead = coef.shape[:-2]
    sc = coef.reshape(lead + (npos,))[..., t["scans"]]
    g = lead + (ncg, 16)
    sgn = torch.sign(sc).reshape(g)
    a = sc.abs().reshape(g)

    # ---- quant scaling (integer path of xQuant, round-half start)
    qbits, scale, inv, cscale = _quant_params(qp, log2, bd)
    maxabs = torch.clamp((a * scale + (1 << (qbits - 1))) >> qbits,
                         max=COEFF_MAX).to(torch.int32)
    af = a.to(torch.float32)

    def dist(lv):
        d = af - lv.to(torch.float32) * inv
        return d * d * cscale

    size = 1 << log2

    def to_raster(lv):
        s = lv.reshape(lead + (npos,)) \
            * torch.where(sgn.reshape(lead + (npos,)) < 0, -1, 1)
        return s[..., t["inv_scan"]].reshape(lead + (size, size)) \
            .to(torch.int32)

    def sdh_stage(lv):
        """Sign data hiding parity (xQuant SDH branch): cheapest +-1
        adjustment whenever the hidden-sign parity is violated."""
        ranks16 = torch.arange(16, device=dev)
        if scan_sel is None:
            ranks = ranks16
        else:
            ranks = _scan_rank_table(scan_idx, dev)[
                scan_sel.to(torch.int64)][..., None, :]
        nz = lv != 0
        maxp = torch.where(nz, ranks, -1).amax(-1)
        minp = torch.where(nz, ranks, 99).amin(-1)
        hide = (maxp - minp) > 3
        first_mask = nz & (ranks == minp[..., None])
        first_neg = torch.where(first_mask, (sgn < 0).to(torch.int32),
                                0).sum(-1)
        asum = lv.sum(-1)
        bad = hide & ((asum & 1) != first_neg)
        d_now = dist(lv)
        d_inc = dist(lv + 1) - d_now
        d_dec = torch.where(lv > 1, dist(lv - 1) - d_now, float("inf"))
        in_span = (ranks >= minp[..., None]) & (ranks <= maxp[..., None])
        d_inc = torch.where(in_span & (lv < COEFF_MAX), d_inc,
                            float("inf"))
        d_dec = torch.where(in_span, d_dec, float("inf"))
        dd = torch.minimum(d_inc, d_dec)
        pick = dd.argmin(-1)
        use_inc = torch.gather(d_inc, -1, pick[..., None])[..., 0] \
            <= torch.gather(d_dec, -1, pick[..., None])[..., 0]
        delta = torch.where(use_inc, 1, -1)
        onehot = (pick[..., None] == ranks16).to(torch.int32)
        return lv + onehot * (delta * bad.to(torch.int64))[..., None] \
            .to(torch.int32)

    add_dz = 85 << (qbits - 9)
    fb = torch.clamp((a * scale + add_dz) >> qbits,
                     max=COEFF_MAX).to(torch.int32)
    if not trellis:
        lv = sdh_stage(fb) if sdh else fb
        return to_raster(lv).reshape(coef.shape)

    scg = maxabs > 0
    cg_sig = scg.any(-1)
    ci_idx = torch.arange(ncg, device=dev)
    pos_idx = torch.arange(npos, device=dev)

    # ---- context identities from the rounded significance map
    pad = torch.zeros(lead + (1,), dtype=torch.bool, device=dev)
    cg_sig_p = torch.cat([cg_sig, pad], -1)
    r_sig = cg_sig_p[..., t["right"]]
    b_sig = cg_sig_p[..., t["below"]]
    patt = r_sig.to(torch.int64) + 2 * b_sig.to(torch.int64)
    sig_ctx = t["sig_tab"][patt.repeat_interleave(16, -1), pos_idx] \
        .to(torch.int64).reshape(g)
    sig_b0 = gcb(cbflat, sig_ctx, torch.zeros_like(sig_ctx))
    sig_b1 = gcb(cbflat, sig_ctx, torch.ones_like(sig_ctx))

    # rank among rounded-sig coeffs (descending scan within CG)
    rank = excl_suffix_count(scg)
    g1c = (maxabs > 1) & scg & (rank < _C1FLAG)
    g1any = g1c.any(-1)
    proc = (cg_sig | (ci_idx == 0)).expand(lead + (ncg,))
    ctx_set = prev_processed_flag(proc, g1any).to(torch.int64)
    if is_luma:
        ctx_set = ctx_set + torch.where(ci_idx > 0, 2, 0)
    # c1 from the rounded-level g1 pattern
    anyprev_g1 = excl_suffix_count(g1c) > 0
    c1 = torch.where(anyprev_g1, 0, torch.clamp(1 + rank, max=3))
    one_ctx = t["one_base"] + ctx_set[..., None] * 4 + c1
    abs_ctx = (t["abs_base"] + ctx_set)[..., None].expand(g)

    # escape base + Rice estimate per position (16-step adaptation on
    # the rounded levels, mirroring the coder's in-group rule)
    minr = torch.where((maxabs >= 2) & scg, rank, 99).amin(-1)
    has_g2 = rank == minr[..., None]
    base = torch.where(rank < _C1FLAG, torch.where(has_g2, 3, 2), 1)
    rice = torch.zeros(lead + (ncg,), dtype=torch.int32, device=dev)
    rice_at = []
    for p in range(15, -1, -1):
        rice_at.append(rice)
        c = scg[..., p] & (maxabs[..., p] >= base[..., p])
        bump = c & (maxabs[..., p] > (3 * torch.pow(2, rice)))
        rice = torch.where(bump, torch.clamp(rice + 1, max=4), rice)
    rice_pos = torch.stack(rice_at[::-1], -1)          # (..., ncg, 16)

    def level_rate(lv):
        """Bits of coding |level|=lv (>0), excluding the sig flag."""
        g1 = lv > 1
        r = torch.where(rank < _C1FLAG, gcb(cbflat, one_ctx, g1), 0.0)
        r = r + torch.where(has_g2 & g1 & (rank < _C1FLAG),
                            gcb(cbflat, abs_ctx, lv > 2), 0.0)
        esc = lv >= base
        sym = torch.clamp(lv - base, min=0)
        r = r + torch.where(esc, _remainder_ep_bits(sym, rice_pos), 0.0)
        return r + 1.0                                   # sign EP

    # ---- stage 1: level choice
    d0 = dist(torch.zeros_like(maxabs))
    cand2 = torch.clamp(maxabs - 1, min=0)

    def cost_nz(lv):
        return dist(lv) + lam * (level_rate(lv) + sig_b1)

    c_max = cost_nz(maxabs)
    c_dec = torch.where(cand2 > 0, cost_nz(cand2), float("inf"))
    c_zero = d0 + lam * sig_b0
    lev = torch.where(scg & (c_dec < c_max) & (c_dec < c_zero), cand2,
                      torch.where(scg & (c_zero <= c_max), 0, maxabs))
    chosen_cost = torch.where(
        scg, torch.minimum(c_max, torch.minimum(c_dec, c_zero)), d0)

    # ---- stage 2: CG zeroing
    levflat = lev.reshape(lead + (npos,))
    last_pos_r = torch.where(levflat > 0, pos_idx, -1).amax(-1)
    last_cg_r = last_pos_r >> 4
    csbf_ctx = t["sig_cg_base"] + (r_sig | b_sig).to(torch.int64)
    cg_cost_coded = fsum(chosen_cost, -1) \
        + lam * gcb(cbflat, csbf_ctx, torch.ones_like(csbf_ctx))
    cg_cost_zero = fsum(d0, -1) \
        + lam * gcb(cbflat, csbf_ctx, torch.zeros_like(csbf_ctx))
    can_zero = (ci_idx > 0) & (ci_idx < last_cg_r[..., None])
    zero_cg = can_zero & (cg_cost_zero < cg_cost_coded)
    lev = torch.where(zero_cg[..., None], 0, lev)
    chosen_cost = torch.where(zero_cg[..., None], d0, chosen_cost)

    # ---- stage 3: best last position (sig flag refunded, last-pos
    # prefix paid, suffix zeroed), vs the all-zero block
    levf = lev.reshape(lead + (npos,))
    costf = chosen_cost.reshape(lead + (npos,))
    d0f = d0.reshape(lead + (npos,))
    prefix = (torch.cumsum(costf.to(torch.float64), -1)
              .to(torch.float32) - costf)
    suffix0 = (torch.flip(torch.cumsum(torch.flip(
        d0f.to(torch.float64), [-1]), -1), [-1]).to(torch.float32) - d0f)
    cb_x, cb_y = last_pos_bits_table(cbflat, t)
    lxb = fsum(t["w_cnt"] * cb_x, (-1, -2)) + t["ep_cnt"]
    lyb = fsum(t["w_cnt"] * cb_y, (-1, -2)) + t["ep_cnt"]
    last_bits = lxb[t["last_x"]] + lyb[t["last_y"]]
    cost_as_last = prefix + (costf - lam * sig_b1.reshape(
        lead + (npos,))) + suffix0 + lam * last_bits
    cost_as_last = torch.where(levf > 0, cost_as_last, float("inf"))
    all_zero_cost = fsum(d0f, -1)
    best_last = cost_as_last.argmin(-1)
    best_cost = cost_as_last.amin(-1)
    use_zero = all_zero_cost <= best_cost
    keep = pos_idx <= best_last[..., None]
    levf = torch.where(use_zero[..., None] | ~keep, 0, levf)
    lev = levf.reshape(g)

    # ---- exact-rate guard: re-price the RDOQ result and the plain
    # deadzone quantisation with tb_bits and keep the per-block winner
    def exact_rd(lv):
        d = fsum(dist(lv), (-1, -2))
        b = tb_bits_plain(to_raster(lv), cbflat, log2, is_luma, scan_idx)
        nz = (lv != 0).any(-1).any(-1)
        return d + lam * (b + nz.to(torch.float32))

    use_fb = exact_rd(fb) < exact_rd(lev)
    lev = torch.where(use_fb[..., None, None], fb, lev)

    if sdh:
        lev = sdh_stage(lev)
    return to_raster(lev).reshape(coef.shape)
