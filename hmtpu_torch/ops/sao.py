"""Sample adaptive offset (H.265 8.7.3): the port of hmtpu/ops/sao.py
`sao_frame_dev` :383 with `_sao_stats_dev` :282, `_choose_params_dev`
:305 (with `_offsets_and_delta_dev` :267) and `apply_sao_dev` :358,
plus the host types `CtuSaoParams`, `max_offset` and `grid_from_packed`
that the entropy writer needs.

On CUDA tensors the statistics and the apply step launch kernel K4
(csrc/sao.cu: `sao_stats`, a cluster of blocks a CTU counting with warp
sums, and `sao_apply`, a thread a quad of samples; each takes a frame's
three planes in one launch, `sao_stats_frame` and `apply_sao_frame`, or
one plane), and the per-CTU RD choice of type, class and offsets of all
three planes K25 (csrc/sao_choose.cu, one launch per frame); on CPU
tensors they run the plain PyTorch versions beside them.

Component order per CTU params: 0 = luma, 1 = Cb, 2 = Cr.
Types: 0 = off, 1 = band, 2 = edge.  Params per CTU: (7,) =
[type, eo_class, band_pos, off0..off3], the native writer's layout.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from hmtpu_torch import kernels

# EO class -> (neighbor a dy,dx), (neighbor b dy,dx)
EO_NEIGHBORS = {
    0: ((0, -1), (0, 1)),      # horizontal
    1: ((-1, 0), (1, 0)),      # vertical
    2: ((-1, -1), (1, 1)),     # 135 degree
    3: ((-1, 1), (1, -1)),     # 45 degree
}


def max_offset(bd: int) -> int:
    """saoMaxOffsetQVal = (1 << (Min(bitDepth, 10) - 5)) - 1."""
    return (1 << (min(bd, 10) - 5)) - 1


@dataclass
class CtuSaoParams:
    """Decoded/encoded SAO parameters of one CTU, one component."""
    type_idx: int = 0                       # 0 off, 1 band, 2 edge
    eo_class: int = 0                       # 0..3 (edge)
    band_pos: int = 0                       # 0..31 (band)
    offsets: np.ndarray = field(
        default_factory=lambda: np.zeros(4, dtype=np.int32))


def grid_from_packed(packed: np.ndarray):
    """(nY, nX, 3, 7) int tensor -> [luma, cb, cr]-per-cell grid of
    CtuSaoParams (the host/entropy representation)."""
    ny, nx = packed.shape[:2]
    return [[tuple(CtuSaoParams(int(packed[y, x, c, 0]),
                                int(packed[y, x, c, 1]),
                                int(packed[y, x, c, 2]),
                                np.asarray(packed[y, x, c, 3:],
                                           np.int32))
                   for c in range(3)) for x in range(nx)]
            for y in range(ny)]


# ---------------------------------------------------------------------------
# plain PyTorch versions

def _edge_categories(plane, cls: int):
    """Per-sample edgeIdx after the spec's remap (0 = no offset,
    1..4 = categories); samples with a neighbour outside the picture
    get 0."""
    h, w = plane.shape
    (ady, adx), (bdy, bdx) = EO_NEIGHBORS[cls]
    pad = torch.nn.functional.pad(plane[None, None].to(torch.float32),
                                  (1, 1, 1, 1), mode="replicate")[0, 0] \
        .to(plane.dtype)
    a = pad[1 + ady:1 + ady + h, 1 + adx:1 + adx + w]
    b = pad[1 + bdy:1 + bdy + h, 1 + bdx:1 + bdx + w]
    raw = 2 + torch.sign(plane - a) + torch.sign(plane - b)
    cat = torch.as_tensor([1, 2, 0, 3, 4], dtype=torch.int32,
                          device=plane.device)[raw.to(torch.int64)]
    if adx or bdx:
        cat[:, 0] = 0
        cat[:, -1] = 0
    if ady or bdy:
        cat[0, :] = 0
        cat[-1, :] = 0
    return cat


def _pad_to(a, ctu: int):
    h, w = a.shape
    hh, ww = -(-h // ctu) * ctu, -(-w // ctu) * ctu
    return torch.nn.functional.pad(a, (0, ww - w, 0, hh - h))


def _ctu_reduce(values, mask, ctu: int):
    v = _pad_to(torch.where(mask, values, 0), ctu)
    m = _pad_to(mask.to(torch.int32), ctu)
    hh, ww = v.shape
    v4 = v.reshape(hh // ctu, ctu, ww // ctu, ctu)
    m4 = m.reshape(hh // ctu, ctu, ww // ctu, ctu)
    return (v4.sum((1, 3)).to(torch.int32), m4.sum((1, 3)).to(torch.int32))


def sao_stats_plain(org, rec, ctu: int, bd: int):
    """Per-CTU stats: edge (4 cls x 4 cat) sums/counts and band (32)."""
    diff = org - rec
    es, ec = [], []
    for cls in range(4):
        cat = _edge_categories(rec, cls)
        s, c = zip(*(_ctu_reduce(diff, cat == k, ctu)
                     for k in range(1, 5)))
        es.append(torch.stack(s))
        ec.append(torch.stack(c))
    band = rec >> (bd - 5)
    bs_, bc_ = zip(*(_ctu_reduce(diff, band == b, ctu) for b in range(32)))
    return (torch.stack(es), torch.stack(ec),
            torch.stack(bs_), torch.stack(bc_))     # (4,4,Y,X),(32,Y,X)


def apply_sao_plain(rec, params, ctu: int, bd: int):
    """Dense SAO apply: params (Y, X, 7) per CTU -> filtered plane."""
    h, w = rec.shape
    maxv = (1 << bd) - 1
    dev = rec.device
    cats = torch.stack([_edge_categories(rec, c) for c in range(4)])
    iy = torch.arange(h, device=dev) // ctu
    ix = torch.arange(w, device=dev) // ctu
    px = params[iy[:, None], ix[None, :]].to(torch.int64)  # (H, W, 7)
    typ, cls, bpos = px[..., 0], px[..., 1], px[..., 2]
    offs = px[..., 3:]                                     # (H, W, 4)
    cat = torch.gather(cats, 0, cls[None]).to(torch.int64)[0]
    e_off = torch.where(cat > 0, torch.gather(
        offs, -1, torch.clamp(cat - 1, min=0)[..., None])[..., 0], 0)
    bidx = ((rec.to(torch.int64) >> (bd - 5)) - bpos) & 31
    b_off = torch.where(bidx < 4, torch.gather(
        offs, -1, torch.clamp(bidx, max=3)[..., None])[..., 0], 0)
    delta = torch.where(typ == 2, e_off, torch.where(typ == 1, b_off, 0))
    return torch.clamp(rec + delta, 0, maxv).to(rec.dtype)


# ---------------------------------------------------------------------------
# wrappers: kernel K4 on the card, the plain version on the CPU

def _sao_stats(org, rec, ctu: int, bd: int):
    if not rec.is_cuda:
        return sao_stats_plain(org, rec, ctu, bd)
    h, w = rec.shape
    return stats_views(sao_stats_rows(org, rec, ctu, bd), -(-h // ctu),
                       -(-w // ctu))


def _i32(a):
    return a.to(torch.int32).contiguous()


def _check_ctu(*ctus: int):
    if any(c < 4 or c > 64 or c % 4 for c in ctus):
        raise ValueError(f"sao: CTU sides 4-64, multiples of 4; got {ctus}")


def sao_stats_rows(org, rec, ctu: int, bd: int):
    """The statistics as K4 writes them: (CTUs, 96) int32 rows of edge
    sums and counts (class x category), band sums and counts.  K4 on CUDA
    tensors (one plane), the plain version (rearranged) on CPU ones."""
    if not rec.is_cuda:
        return stats_rows(*sao_stats_plain(org, rec, ctu, bd))
    _check_ctu(ctu)
    h, w = rec.shape
    out = torch.empty((-(-h // ctu) * -(-w // ctu), 96), dtype=torch.int32,
                      device=rec.device)
    kernels.launch("sao_stats", "hm_sao_stats", _i32(org), _i32(rec), None,
                   None, None, None, out, 1, h, w, ctu, 0, 0, 0, bd)
    return out


def sao_stats_frame_plain(org_y, rec_y, org_u, rec_u, org_v, rec_v,
                          ctu: int, bd: int):
    """`sao_stats_frame` through `sao_stats_plain`, plane by plane."""
    return torch.stack([
        stats_rows(*sao_stats_plain(o, r, c, bd))
        for o, r, c in ((org_y, rec_y, ctu), (org_u, rec_u, ctu // 2),
                        (org_v, rec_v, ctu // 2))])


def _frame_check(what, ctu, shapes, params=None):
    """The three planes (luma at ctu, the chroma pair at ctu // 2) have one
    CTU grid, and params (if given) is (Y, X, 3, 7) on it."""
    _check_ctu(ctu, ctu // 2)
    (h, w), (hc, wc), sv = shapes
    grid = (-(-h // ctu), -(-w // ctu))
    if sv != (hc, wc) or grid != (-(-hc // (ctu // 2)),
                                  -(-wc // (ctu // 2))) \
            or (params is not None and tuple(params.shape) != grid + (3, 7)):
        raise ValueError(f"{what}: planes {shapes}"
                         + (f", params {tuple(params.shape)}"
                            if params is not None else "")
                         + f" at CTU {ctu}")
    return h, w, hc, wc, grid[0] * grid[1]


def sao_stats_frame(org_y, rec_y, org_u, rec_u, org_v, rec_v, ctu: int,
                    bd: int):
    """A frame's statistics: (3, CTUs, 96) int32, the rows of luma at
    `ctu` and of the chroma pair at ctu // 2 (`sao_stats_rows`' layout).
    K4 on CUDA tensors (one launch), the plain version on CPU ones."""
    if not rec_y.is_cuda:
        return sao_stats_frame_plain(org_y, rec_y, org_u, rec_u, org_v,
                                     rec_v, ctu, bd)
    shapes = tuple(tuple(r.shape) for r in (rec_y, rec_u, rec_v))
    if shapes != tuple(tuple(o.shape) for o in (org_y, org_u, org_v)):
        raise ValueError("sao_stats_frame: originals and reconstructions "
                         "differ in shape")
    h, w, hc, wc, n = _frame_check("sao_stats_frame", ctu, shapes)
    out = torch.empty((3, n, 96), dtype=torch.int32, device=rec_y.device)
    kernels.launch("sao_stats", "hm_sao_stats", *(_i32(a) for a in (
        org_y, rec_y, org_u, rec_u, org_v, rec_v)), out, 3, h, w, ctu, hc,
        wc, ctu // 2, bd)
    return out


def stats_views(rows, ny: int, nx: int):
    """(CTUs, 96) statistic rows -> (es, ec (4, 4, Y, X), bsum, bcnt
    (32, Y, X)), the plain version's layout."""
    o = rows.reshape(ny, nx, 96)
    es = o[..., 0:16].reshape(ny, nx, 4, 4).permute(2, 3, 0, 1)
    ec = o[..., 16:32].reshape(ny, nx, 4, 4).permute(2, 3, 0, 1)
    return es, ec, o[..., 32:64].permute(2, 0, 1), \
        o[..., 64:96].permute(2, 0, 1)


def stats_rows(es, ec, bsum, bcnt):
    """stats_views' inverse: the plain statistics as K4's rows."""
    ny, nx = bsum.shape[1:]
    f = lambda a, k: a.reshape(k, ny * nx).T
    return torch.cat([f(es, 16), f(ec, 16), f(bsum, 32), f(bcnt, 32)],
                     1).to(torch.int32).contiguous()


def apply_sao_dev(rec, params, ctu: int, bd: int):
    """SAO apply of one plane: params (Y, X, 7) int32 per CTU."""
    if not rec.is_cuda:
        return apply_sao_plain(rec, params, ctu, bd)
    _check_ctu(ctu)
    rec = _i32(rec)
    h, w = rec.shape
    out = torch.empty_like(rec)
    kernels.launch("sao_apply", "hm_sao_apply", rec, None, None,
                   _i32(params), out, None, None, 1, h, w, ctu, 0, 0, 0, bd)
    return out


def apply_sao_frame_plain(rec_y, rec_u, rec_v, params, ctu: int, bd: int):
    """`apply_sao_frame` through `apply_sao_plain`, plane by plane."""
    return tuple(apply_sao_plain(r, params[:, :, k], c, bd)
                 for k, (r, c) in enumerate(((rec_y, ctu), (rec_u, ctu // 2),
                                             (rec_v, ctu // 2))))


def apply_sao_frame(rec_y, rec_u, rec_v, params, ctu: int, bd: int):
    """A frame's SAO apply: params (Y, X, 3, 7) int32 as `choose_params`
    gives them (luma at `ctu`, the chroma pair at ctu // 2).  Returns
    (new_y, new_u, new_v).  K4 on CUDA tensors (one launch, the
    parameters read in place), the plain version on CPU ones."""
    if not rec_y.is_cuda:
        return apply_sao_frame_plain(rec_y, rec_u, rec_v, params, ctu, bd)
    recs = [_i32(r) for r in (rec_y, rec_u, rec_v)]
    h, w, hc, wc, _ = _frame_check(
        "apply_sao_frame", ctu, tuple(tuple(r.shape) for r in recs), params)
    outs = [torch.empty_like(r) for r in recs]
    kernels.launch("sao_apply", "hm_sao_apply", *recs, _i32(params), *outs,
                   3, h, w, ctu, hc, wc, ctu // 2, bd)
    return tuple(outs)


def _offsets_and_delta(e_sum, cnt, sign_constrained, max_off):
    off = torch.where(cnt > 0,
                      torch.round(e_sum / torch.clamp(cnt, min=1)), 0.0)
    off = torch.clamp(off, -max_off, max_off)
    if sign_constrained is not None:
        off = torch.clamp(off, min=0) if sign_constrained > 0 \
            else torch.clamp(off, max=0)
    off = off.to(torch.int32)
    d0 = cnt * off * off - 2 * off * e_sum
    shr = off - torch.sign(off)
    d1 = cnt * shr * shr - 2 * shr * e_sum
    take = d1 < d0
    return torch.where(take, shr, off), torch.where(take, d1, d0)


def _choose_params_plain(es, ec, bsum, bcnt, lam, bd: int, force_type=None,
                         force_cls=None):
    """Plain version of K25: the RD choice per CTU (float32, hmtpu's
    order of operations).
    force_type/cls: Cr under Cb's shared type.  Returns (Y, X, 7)."""
    mo = max_offset(bd)
    esf, ecf = es.to(torch.float32), ec.to(torch.float32)
    # edge candidates: offsets per class (4, 4, Y, X)
    e_off_p, e_del_p = _offsets_and_delta(esf[:, :2], ecf[:, :2], 1, mo)
    e_off_n, e_del_n = _offsets_and_delta(esf[:, 2:], ecf[:, 2:], -1, mo)
    e_off = torch.cat([e_off_p, e_off_n], 1)
    e_delta = (e_del_p[:, 0] + e_del_p[:, 1]) \
        + (e_del_n[:, 0] + e_del_n[:, 1])                   # (4, Y, X)
    e_bits = 6.0 + e_off.abs().sum(1)
    e_cost = e_delta + lam * e_bits
    best_cls = e_cost.argmin(0)                             # (Y, X)
    if force_cls is not None:
        best_cls = force_cls.to(torch.int64)
    e_cost_b = torch.gather(e_cost, 0, best_cls[None])[0]
    e_off_b = torch.gather(e_off, 0, best_cls[None, None].expand(
        1, 4, *best_cls.shape))[0]                          # (4, Y, X)

    # band candidates
    b_off, b_delta = _offsets_and_delta(
        bsum.to(torch.float32), bcnt.to(torch.float32), None, mo)
    runs = torch.stack([((b_delta[p] + b_delta[p + 1]) + b_delta[p + 2])
                        + b_delta[p + 3] for p in range(29)])
    best_pos = runs.argmin(0)                               # (Y, X)
    b_del_b = torch.gather(runs, 0, best_pos[None])[0]
    sel = torch.stack([torch.gather(
        b_off, 0, torch.clamp(best_pos + k, 0, 31)[None])[0]
        for k in range(4)])                                 # (4, Y, X)
    b_bits = 9.0 + (sel.abs() + (sel != 0).to(sel.dtype)).sum(0)
    b_cost = b_del_b + lam * b_bits

    off_cost = torch.zeros_like(b_cost)
    if force_type is None:
        typ = torch.where(
            (e_cost_b < off_cost) & (e_cost_b <= b_cost), 2,
            torch.where(b_cost < off_cost, 1, 0)).to(torch.int32)
    else:
        typ = force_type.to(torch.int32)
    use_edge = typ == 2
    offs = torch.where(use_edge[None], e_off_b, sel)
    offs = torch.where((typ == 0)[None], 0, offs)
    return torch.stack(
        [typ, torch.where(use_edge, best_cls, 0).to(torch.int32),
         torch.where(typ == 1, best_pos, 0).to(torch.int32),
         offs[0].to(torch.int32), offs[1].to(torch.int32),
         offs[2].to(torch.int32), offs[3].to(torch.int32)], -1)


def choose_params_plain(rows_y, rows_u, rows_v, lam, bd: int, ny: int,
                        nx: int):
    """`choose_params` through `_choose_params_plain`, on any device."""
    p = lambda r, **k: _choose_params_plain(*stats_views(r, ny, nx), lam, bd,
                                            **k)
    p_cb = p(rows_u)
    return torch.stack([p(rows_y), p_cb, p(rows_v, force_type=p_cb[..., 0],
                                           force_cls=p_cb[..., 1])], 2)


def choose_params(rows_y, rows_u, rows_v, lam, bd: int, ny: int,
                  nx: int):
    """Every CTU's SAO parameters of the three planes from their
    statistic rows (`sao_stats_rows`), Cr under Cb's type and class: K25
    on CUDA tensors (one launch), the plain version on CPU ones.  lam: a
    float32 0-d tensor.  Returns (Y, X, 3, 7) int32.  On the card the
    tensors are readied here (`kernels.ready`) and go to
    kernels.launch_checked as pointers."""
    if not rows_y.is_cuda:
        return choose_params_plain(rows_y, rows_u, rows_v, lam, bd, ny, nx)
    rows = [kernels.ready(r) for r in (rows_y, rows_u, rows_v)]
    lam = kernels.ready(lam, torch.float32)
    dev = rows[0].get_device()
    if lam.numel() != 1 or any(r.numel() != ny * nx * 96 for r in rows) \
            or any(t.get_device() != dev for t in rows[1:] + [lam]):
        raise ValueError(f"sao_choose: three ({ny * nx}, 96) statistic "
                         f"rows and lambda on one CUDA device, got "
                         f"{[(tuple(r.shape), str(r.device)) for r in rows]}"
                         f" and lambda on {lam.device}")
    out = torch.empty((ny, nx, 3, 7), dtype=torch.int32,
                      device=rows[0].device)
    kernels.launch_checked("sao_choose", "hm_sao_choose", dev,
                           *(r.data_ptr() for r in rows), lam.data_ptr(),
                           out.data_ptr(), ny * nx, max_offset(bd))
    return out


def sao_frame_dev(org_y, rec_y, org_u, rec_u, org_v, rec_v, ctu: int,
                  lam, bd: int):
    """Estimate + apply SAO for a whole picture.  lam: float32 0-d
    tensor on the planes' device.  Returns (new_y, new_u, new_v,
    params (Y, X, 3, 7) int32) with the chroma type/class sharing rule
    (Cr follows Cb).  On the card three launches: K4's statistics of the
    three planes, K25's choice, K4's apply of the three planes."""
    h, w = rec_y.shape
    params = choose_params(
        *sao_stats_frame(org_y, rec_y, org_u, rec_u, org_v, rec_v, ctu, bd),
        lam, bd, -(-h // ctu), -(-w // ctu))
    return apply_sao_frame(rec_y, rec_u, rec_v, params, ctu, bd) + (params,)
