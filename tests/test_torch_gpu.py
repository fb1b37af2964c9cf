"""The hand-written CUDA kernels of hmtpu_torch (K1-K26) against their
plain PyTorch versions, on the card.  Every output must be equal: the
kernels are integer, except NN-FME's (K6), RDOQ's (K10), the trainer's
(K14-K16, K14 with the exp and log its plain version shares, K16 the
tail of K15's launch) and the
rate pieces of K18 and K20, whose kernels and plain versions round every
float32 operation in the same order (K10's float64 sums round once to
float32).  Skips where there is no CUDA card; on the card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(--noconftest: the repo's root conftest loads JAX, which the card's
machine does not need.)  Imports nothing of JAX or hmtpu.
"""
import os

import numpy as np
import pytest
import torch

from hmtpu_torch import kernels
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    return torch.device("cuda", 0)


def _i32(a, dev):
    return torch.as_tensor(np.asarray(a, np.int32)).to(dev)


def _launched(name, fn):
    before = kernels.COUNTS[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.COUNTS[name] > before, f"{name} did not launch"
    return out


@pytest.mark.parametrize("n,dst", [(4, False), (4, True), (8, False),
                                   (16, False), (32, False)])
def test_transform_kernel(dev, n, dst):
    from hmtpu_torch.ops import transform as t

    rng = np.random.RandomState(n)
    for nb in (1, 7, 300):
        res = _i32(rng.randint(-255, 256, (nb, n, n)), dev)
        coef = _i32(rng.randint(-(1 << 15), 1 << 15, (nb, n, n)), dev)
        got = _launched("int_transform_fwd",
                        lambda: t.forward_transform(res, n, use_dst=dst))
        want = t.forward_transform_plain(res, n, use_dst=dst)
        assert torch.equal(got, want)
        got = _launched("int_transform_inv",
                        lambda: t.inverse_transform(coef, n, use_dst=dst))
        want = t.inverse_transform_plain(coef, n, use_dst=dst)
        assert torch.equal(got, want)


# the nine `_code` shapes of a 416x240 P pass: each level's luma and two
# chroma planes (and small counts)
@pytest.mark.parametrize("n,m", [(8, 1560), (16, 390), (32, 104), (8, 3),
                                 (32, 1)])
@pytest.mark.parametrize("bd", [8, 10])
def test_code_level_kernel(dev, n, m, bd):
    """K1's level forms (`fwd_level`, `inv_level`) against their plain
    versions, one launch each: the three planes of a level, and one
    plane (`_code`'s call) with and without the chroma weight."""
    from hmtpu_torch.ops import transform as t

    rng = np.random.RandomState(n + m + bd)
    vmax = (1 << bd) - 1
    orgs, preds, deqs, levs = [], [], [], []
    for s in (n, n // 2, n // 2):
        o = rng.randint(0, vmax + 1, (m, s, s))
        orgs.append(_i32(o, dev))
        preds.append(_i32(np.clip(o + rng.randint(-99, 100, o.shape), 0,
                                  vmax), dev))
        lv = rng.randint(-30, 31, o.shape) * (rng.rand(*o.shape) < 0.2)
        levs.append(_i32(lv, dev))
        deqs.append(_i32(np.clip(lv * 700, -(1 << 15), (1 << 15) - 1), dev))
    bits = [torch.as_tensor(rng.rand(m).astype(np.float32) * 300).to(dev)
            for _ in range(3)]
    dw = torch.tensor(1.2599, dtype=torch.float32, device=dev)

    def same(got, want):
        if isinstance(got, (list, tuple)):
            return len(got) == len(want) and all(map(same, got, want))
        if got is None or want is None:
            return got is None and want is None
        return got.dtype == want.dtype and torch.equal(got, want)

    for k in ((0, 1, 2), (0,), (1,)):
        pick = lambda a: [a[i] for i in k]
        w = dw if k != (0,) else None
        before = dict(kernels.COUNTS)
        got = t.fwd_level(pick(orgs), pick(preds), bd)
        got_i = t.inv_level(pick(deqs), pick(levs), pick(preds), pick(orgs),
                            bd, w, pick(bits) if len(k) == 3 else None)
        torch.cuda.synchronize()
        assert kernels.COUNTS["int_transform_fwd"] \
            == before["int_transform_fwd"] + 1
        assert kernels.COUNTS["int_transform_inv"] \
            == before["int_transform_inv"] + 1
        assert same(got, t.fwd_level_plain(pick(orgs), pick(preds), bd))
        assert same(got_i, t.inv_level_plain(
            pick(deqs), pick(levs), pick(preds), pick(orgs), bd, w,
            pick(bits) if len(k) == 3 else None))


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_intra_kernel(dev, n):
    from hmtpu_torch.ops import intra_pred as ip

    rng = np.random.RandomState(n)
    b, line = 64, 4 * n + 1
    ref = rng.randint(0, 256, (b, line))
    ramp = np.linspace(0, 1, line)[None]
    lo, hi = rng.randint(60, 200, (2, b // 2))
    ref[: b // 2] = np.round(lo[:, None] + (hi - lo)[:, None] * ramp)
    ref = _i32(ref, dev)
    for strong in (False, True):
        got = _launched("intra_filter", lambda: ip.filter_reference_batched(
            ref, n, 8, strong))
        assert torch.equal(got, ip.filter_reference_plain(ref, n, 8, strong))
    reff = got
    modes = _i32(rng.randint(0, 35, (b, 3)), dev)
    for is_luma in (True, False):
        got = _launched("intra_pred", lambda: ip.predict_all_modes(
            ref, reff, n, is_luma))
        want = ip.predict_modes_plain(
            ref, reff, torch.arange(35, device=dev).expand(b, 35), n,
            is_luma)
        assert torch.equal(got, want)
        got = _launched("intra_pred", lambda: ip.predict_modes(
            ref, reff, modes, n, is_luma))
        assert torch.equal(got, ip.predict_modes_plain(ref, reff, modes, n,
                                                       is_luma))


@pytest.mark.parametrize("h,w", [(64, 64), (48, 80), (240, 416),
                                 (1080, 1920)])
def test_deblock_kernel(dev, h, w):
    """K3's 4x4-map form, one launch a picture; at 416x240 and 1920x1080
    also its state form on seeded I, P and B states."""
    from hmtpu_torch.ops import deblock as db

    rng = np.random.RandomState(h + w)

    def blocky(hh, ww):
        base = 128 + rng.randint(-6, 7, (-(-hh // 8), -(-ww // 8)))
        pl = np.repeat(np.repeat(base, 8, 0), 8, 1)[:hh, :ww]
        return _i32(np.clip(pl + rng.randint(-2, 3, (hh, ww)), 0, 255), dev)

    y, u, v = blocky(h, w), blocky(h // 2, w // 2), blocky(h // 2, w // 2)
    h4, w4 = h // 4, w // 4
    meta = (torch.as_tensor(rng.rand(h4, w4) < 0.5).to(dev),
            torch.as_tensor(rng.rand(h4, w4) < 0.5).to(dev),
            _i32(rng.randint(-8, 9, (2, h4, w4)), dev),
            _i32(rng.randint(-8, 9, (2, h4, w4)), dev),
            _i32(rng.randint(-1, 3, (2, h4, w4)), dev))
    masks = dict(int_v=torch.as_tensor(rng.rand(h // 8, w // 8 - 1) < 0.3)
                 .to(dev),
                 int_h=torch.as_tensor(rng.rand(h // 8 - 1, w // 8) < 0.3)
                 .to(dev))
    for qp in (22, 37):
        before = kernels.COUNTS["deblock"]
        got = _launched("deblock", lambda: db.deblock_frame_dev(
            y, u, v, *meta, qp, **masks))
        assert kernels.COUNTS["deblock"] == before + 1
        want = db.deblock_frame_plain(y, u, v, *meta, qp, **masks)
        for g, wnt in zip(got, want):
            assert torch.equal(g, wnt)
        assert not torch.equal(got[0], y)
    if h < 240:
        return
    n = (h // 8) * (w // 8)
    blk = np.zeros((n, 14), np.int32)
    blk[:, db.K_DIR] = rng.choice([0, 1, 2, 3, 3], n)
    for c in (db.K_MVX, db.K_MVY, db.K_MVX1, db.K_MVY1):
        blk[:, c] = rng.choice([-5, -1, 0, 0, 0, 1, 2], n)
    blk[:, db.K_REF] = rng.randint(0, 3, n)
    blk[:, db.K_REF1] = rng.randint(0, 3, n)
    blk[:, db.K_SZ] = rng.randint(0, 3, n)
    blk[:, db.K_CBFY] = rng.choice([0, 0, 0, 1], n)
    pblk = blk.copy()
    pblk[:, db.K_DIR] = np.minimum(pblk[:, db.K_DIR], 1)
    flat = [p.reshape(-1) for p in (y, u, v)]
    states = (
        (None, dict(cusz=_i32(blk[:, db.K_SZ], dev),
                    cbfy=_i32(blk[:, db.K_CBFY], dev))),
        (_i32(pblk, dev), dict(ref_pocs=[8, 6, 5, 4])),
        (_i32(blk, dev), dict(ref_pocs=[8, 4], ref_pocs_l1=[4, 8],
                              cb_qp_off=1, cr_qp_off=-1)))
    for b, kw in states:
        for bd in (8, 10):
            planes = [p << (bd - 8) for p in flat]
            before = kernels.COUNTS["deblock"]
            got = _launched("deblock", lambda: db.deblock_state(
                *planes, b, 32, bd, h=h, w=w, **kw))
            assert kernels.COUNTS["deblock"] == before + 1
            want = db.deblock_state_plain(*planes, b, 32, bd, h=h, w=w, **kw)
            for g, wnt in zip(got, want):
                assert torch.equal(g, wnt)


@pytest.mark.parametrize("h,w,ctu", [(64, 64, 32), (48, 80, 64),
                                     (240, 416, 64), (120, 208, 32)])
def test_sao_kernels(dev, h, w, ctu):
    from hmtpu_torch.ops import sao

    rng = np.random.RandomState(h * w)
    org = rng.randint(0, 256, (h, w))
    rec = _i32(np.clip(org + rng.randint(-6, 7, (h, w)), 0, 255), dev)
    org = _i32(org, dev)
    got = _launched("sao_stats", lambda: sao._sao_stats(org, rec, ctu, 8))
    want = sao.sao_stats_plain(org, rec, ctu, 8)
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    ny, nx = -(-h // ctu), -(-w // ctu)
    params = _i32(np.concatenate(
        [rng.randint(0, 3, (ny, nx, 1)), rng.randint(0, 4, (ny, nx, 1)),
         rng.randint(0, 29, (ny, nx, 1)), rng.randint(-7, 8, (ny, nx, 4))],
        -1), dev)
    got = _launched("sao_apply", lambda: sao.apply_sao_dev(rec, params,
                                                           ctu, 8))
    assert torch.equal(got, sao.apply_sao_plain(rec, params, ctu, 8))


@pytest.mark.parametrize("h,w,ctu,bd", [(64, 64, 32, 8), (48, 80, 64, 8),
                                        (240, 416, 64, 8), (120, 208, 32, 8),
                                        (240, 416, 64, 10)])
def test_sao_frame_kernels(dev, h, w, ctu, bd):
    """K4's three-plane statistics and apply (one launch each) against
    the plain versions plane by plane."""
    from hmtpu_torch.ops import sao

    rng = np.random.RandomState(h + w + bd)
    top = (1 << bd) - 1
    org, rec = [], []
    for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        o = rng.randint(0, top + 1, (hh, ww))
        rec.append(_i32(np.clip(o + rng.randint(-6, 7, (hh, ww)), 0, top),
                        dev))
        org.append(_i32(o, dev))
    planes = [a for pair in zip(org, rec) for a in pair]
    n0 = kernels.COUNTS["sao_stats"]
    got = _launched("sao_stats", lambda: sao.sao_stats_frame(*planes, ctu,
                                                             bd))
    assert kernels.COUNTS["sao_stats"] == n0 + 1
    assert torch.equal(got, sao.sao_stats_frame_plain(*planes, ctu, bd))
    ny, nx = -(-h // ctu), -(-w // ctu)
    mo = sao.max_offset(bd)
    params = _i32(np.concatenate(
        [rng.randint(0, 3, (ny, nx, 3, 1)), rng.randint(0, 4, (ny, nx, 3, 1)),
         rng.randint(0, 32, (ny, nx, 3, 1)),
         rng.randint(-mo, mo + 1, (ny, nx, 3, 4))], -1), dev)
    n0 = kernels.COUNTS["sao_apply"]
    got = _launched("sao_apply", lambda: sao.apply_sao_frame(*rec, params,
                                                             ctu, bd))
    assert kernels.COUNTS["sao_apply"] == n0 + 1
    for g, wnt in zip(got, sao.apply_sao_frame_plain(*rec, params, ctu, bd)):
        assert torch.equal(g, wnt)


def test_encode_card_equals_cpu(dev):
    """A 64x64 picture through the port on the card and on the CPU: the
    same bytes."""
    from hmtpu_torch.encoder.top import Encoder, EncoderConfig
    from hmtpu_torch.io.yuv import Frame

    rng = np.random.RandomState(3)
    y = np.clip(128 + rng.randint(-40, 41, (64, 64)), 0, 255)
    u = np.clip(128 + rng.randint(-10, 11, (32, 32)), 0, 255)
    v = np.clip(128 + rng.randint(-10, 11, (32, 32)), 0, 255)
    frame = Frame(*(a.astype(np.uint8) for a in (y, u, v)), 8)
    out = []
    for d in (dev, "cpu"):
        enc = Encoder(EncoderConfig(width=64, height=64, qp=37, gop="ai",
                                    subpel="none"), device=d)
        out.append(enc.encode_sequence([frame]))
    assert out[0] == out[1]


def _textured(rng, h, w):
    """A smooth picture with texture, and a shifted, noisy copy of it."""
    yy, xx = np.mgrid[0:h, 0:w]
    org = 128 + 50 * np.sin(xx / 7.0) * np.cos(yy / 5.0) \
        + rng.randint(-20, 21, (h, w))
    ref = np.roll(org, (5, -9), (0, 1)) + rng.randint(-4, 5, (h, w))
    return np.clip(org, 0, 255), np.clip(ref, 0, 255)


@pytest.mark.parametrize("h,w,srange", [(64, 64, 8), (48, 80, 8),
                                        (240, 416, 64), (48, 80, 64)])
def test_me_sad_kernel(dev, h, w, srange):
    """K5 against its plain version at 8 and 10 bits (the 10-bit planes
    the 8-bit ones << 2 with noise in the low bits), and on a flat plane
    where every displacement ties (the first index wins)."""
    from hmtpu_torch.search import me

    rng = np.random.RandomState(h + srange)
    org8, ref8 = _textured(rng, h, w)
    qh, qw = (h // 16 + 1) // 2, (w // 16 + 1) // 2

    def check(ref, org, lam, bd):
        got = _launched("me_sad", lambda: me.integer_me_levels(
            ref, org, srange, lam, qh, qw, bd))
        want = me.integer_me_levels_plain(ref, org, srange, lam, qh, qw)
        for n in (8, 16, 32):
            (gx, gy), gst, gsad = got[n]
            (wx, wy), wst, wsad = want[n]
            for g, wnt in ((gx, wx), (gy, wy), (gst, wst), (gsad, wsad)):
                assert torch.equal(g, wnt), (n, bd)
        return got

    for bd in (8, 10):
        org = org8 * (1 << (bd - 8)) + rng.randint(0, 1 << (bd - 8), (h, w))
        ref = ref8 * (1 << (bd - 8))
        for lam in (np.float32(0.0), np.float32(7.3)):
            check(_i32(ref, dev), _i32(org, dev), lam, bd)
        # a flat picture: every displacement ties, the first index wins
        flat = torch.full((h, w), 90 << (bd - 8), dtype=torch.int32,
                          device=dev)
        got = check(flat, flat, np.float32(0.0), bd)
        assert bool((got[32][0][0] == -srange).all())


@pytest.mark.parametrize("qp", [22, 37])
def test_nnfme_kernel(dev, qp):
    from hmtpu_torch.models import nnfme

    rng = np.random.RandomState(qp)
    params = nnfme.load_npz(f"{nnfme.WEIGHTS_DIR}/qp{qp}.npz", dev)
    for nb in (1, 129, 1560):
        base = rng.randint(200, 6000, (nb, 1))
        costs = torch.as_tensor((base + rng.randint(0, 900, (nb, 9)))
                                .astype(np.float32)).to(dev)
        sizes = _i32(rng.choice([8, 12, 16, 24, 32], nb), dev)
        got = _launched("nnfme", lambda: nnfme.forward(params, costs, sizes,
                                                       sizes))
        want = nnfme.forward_plain(params, costs, sizes, sizes)
        assert torch.equal(got, want)
        cls, offs = _launched("nnfme", lambda: nnfme.predict_offsets(
            params, costs, sizes, sizes))
        wc, wo = nnfme._classes(want)
        assert torch.equal(cls, wc) and torch.equal(offs, wo)
    # the P pass's form: three levels' int32 stencils (416x240's 1560,
    # 390 and 104 PUs, and small levels), one launch
    for rows in ((1560, 390, 104), (1, 31, 257), (7,)):
        stens = [_i32(rng.randint(100, 9000, (r, 3, 3))
                      * (4 ** k), dev) for k, r in enumerate(rows)]
        sizes = (8, 16, 32)[:len(rows)]
        before = kernels.COUNTS["nnfme"]
        got = nnfme.predict_offsets_levels(params, stens, sizes)
        torch.cuda.synchronize()
        assert kernels.COUNTS["nnfme"] == before + 1
        want = nnfme.predict_offsets_levels_plain(params, stens, sizes)
        for (gc, go), (wc, wo) in zip(got, want):
            assert torch.equal(gc, wc) and torch.equal(go, wo)


@pytest.mark.parametrize("chroma,n", [(False, 8), (False, 16), (False, 32),
                                      (True, 4), (True, 8), (True, 16)])
def test_mc_dctif_kernel(dev, chroma, n):
    from hmtpu_torch.ops import interp

    rng = np.random.RandomState(n + 50 * chroma)
    h, w = (120, 208) if chroma else (240, 416)
    refs = _i32(rng.randint(0, 256, (4, h, w)), dev)
    nb = (h // n) * (w // n)
    q = np.arange(nb)
    xs, ys = (q % (w // n)) * n, (q // (w // n)) * n
    span = 4 * (n + 24)
    mvx, mvy = rng.randint(-span, span, (2, nb))
    mvx[:64], mvy[:64] = np.arange(64) - 32, (np.arange(64) * 5) % 64 - 32
    args = [_i32(a, dev) for a in (rng.randint(0, 4, nb), xs, ys, mvx, mvy)]
    got = _launched("mc_dctif", lambda: interp.mc_batch(
        refs, *args, n, n, chroma))
    assert torch.equal(got, interp.mc_batch_plain(refs, *args, n, n, chroma))


@pytest.mark.parametrize("chroma,n,bd", [(False, 8, 10), (False, 16, 8),
                                         (False, 32, 10), (True, 4, 10),
                                         (True, 8, 8), (True, 16, 10)])
def test_mc_dctif_i_kernel(dev, chroma, n, bd):
    """K11: the unclipped intermediate-precision hypotheses, every phase,
    MVs past the edges, 8 and 10 bits."""
    from hmtpu_torch.ops import interp

    rng = np.random.RandomState(n + 50 * chroma + bd)
    h, w = (120, 208) if chroma else (240, 416)
    refs = _i32(rng.randint(0, 1 << bd, (4, h, w)), dev)
    nb = (h // n) * (w // n)
    q = np.arange(nb)
    xs, ys = (q % (w // n)) * n, (q // (w // n)) * n
    span = 4 * (n + 24)
    mvx, mvy = rng.randint(-span, span, (2, nb))
    mvx[:64], mvy[:64] = np.arange(64) - 32, (np.arange(64) * 5) % 64 - 32
    args = [_i32(a, dev) for a in (rng.randint(0, 4, nb), xs, ys, mvx, mvy)]
    got = _launched("mc_dctif_i", lambda: interp.mc_batch(
        refs, *args, n, n, chroma, bd, inter=True))
    assert torch.equal(got, interp.mc_batch_i_plain(refs, *args, n, n,
                                                    chroma, bd))


@pytest.mark.parametrize("inter", [False, True])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_mc_forms_kernel(dev, n, bd, inter):
    """K7's (K11's with inter) forms in one launch each: the three planes
    of an n-grid's blocks (the AMVP hypotheses) and the luma blocks under
    two MV sets (the NN gate), at 416x240, every phase, MVs past the
    edges."""
    from hmtpu_torch.ops import interp

    rng = np.random.RandomState(n + bd + 7 * inter)
    name = "mc_dctif_i" if inter else "mc_dctif"
    h, w = 240, 416
    ry = _i32(rng.randint(0, 1 << bd, (4, h, w)), dev)
    ru, rv = (_i32(rng.randint(0, 1 << bd, (4, h // 2, w // 2)), dev)
              for _ in range(2))
    gw = w // n
    nb = gw * (h // n)
    span = 4 * (n + 24)
    mvx, mvy = rng.randint(-span, span, (2, 2, nb))
    mvx[:, :64], mvy[:, :64] = np.arange(64) - 32, \
        (np.arange(64) * 5) % 64 - 32
    ridx, mvx, mvy = (_i32(a, dev) for a in (rng.randint(0, 4, nb), mvx,
                                              mvy))
    n0 = kernels.COUNTS[name]
    got = _launched(name, lambda: interp.mc_yuv(ry, ru, rv, ridx, gw, mvx[0],
                                                 mvy[0], n, bd, inter))
    want = interp.mc_yuv_plain(ry, ru, rv, ridx, gw, mvx[0], mvy[0], n, bd,
                               inter)
    assert all(torch.equal(g, wnt) for g, wnt in zip(got, want))
    got = _launched(name, lambda: interp.mc_luma2(ry, ridx, gw, mvx, mvy, n,
                                                   bd, inter))
    want = interp.mc_luma2_plain(ry, ridx, gw, mvx, mvy, n, bd, inter)
    assert all(torch.equal(g, wnt) for g, wnt in zip(got, want))
    assert kernels.COUNTS[name] == n0 + 2


@pytest.mark.parametrize("bd", [8, 10])
def test_bi_pred_kernel(dev, bd):
    """K12: the bi-average where the pair is bi, else the approximate
    final samples of the hypothesis in use; and with every pair bi."""
    from hmtpu_torch.ops import interp

    rng = np.random.RandomState(bd)
    lo, hi = -(8192 + 600), (1 << 14) - 8192 + 600
    for nb, n in ((1560 * 5, 8), (390 * 5, 16), (3, 4)):
        i0 = _i32(rng.randint(lo, hi, (nb, n, n)), dev)
        i1 = _i32(rng.randint(lo, hi, (nb, n, n)), dev)
        cdir = _i32(rng.randint(1, 4, nb), dev)
        got = _launched("bi_pred", lambda: interp.bi_pred(i0, i1, cdir, bd))
        assert torch.equal(got, interp.bi_pred_plain(i0, i1, cdir, bd))
        bi = torch.full_like(cdir, 3)
        assert torch.equal(
            _launched("bi_pred", lambda: interp.bi_average_t(i0, i1, bd)),
            interp.bi_pred_plain(i0, i1, bi, bd))


@pytest.mark.parametrize("n", [8, 16, 32])
def test_satd_kernel(dev, n):
    from hmtpu_torch.search import me

    rng = np.random.RandomState(n)
    for nb in (1, 390, 1560):
        a = rng.randint(0, 256, (nb, n, n))
        b = _i32(np.clip(a + rng.randint(-40, 41, a.shape), 0, 255), dev)
        a = _i32(a, dev)
        got = _launched("satd8", lambda: me.satd_batch(a, b, n))
        assert torch.equal(got, me.satd_batch_plain(a, b, n))


@pytest.mark.parametrize("h,w", [(240, 416), (48, 80)])
def test_satd_gate_kernel(dev, h, w):
    """K8's gate form at the P pass's three levels of an h x w picture
    (416x240: 1560, 390 and 104 blocks; 80x48's 32 grid reads past the
    plane) in one launch, and at one level, against the plain version;
    equal predictions keep the second MV set."""
    from hmtpu_torch.search import me

    rng = np.random.RandomState(h + w)
    org = _i32(rng.randint(0, 256, (h, w)), dev)
    levels = []
    for n, gh, gw in ((8, h // 8, w // 8), (16, h // 16, w // 16),
                      (32, -(-h // 32), -(-w // 32))):
        nb = gh * gw
        base = me._grid_blocks(org, n, gw, nb).cpu().numpy()
        p0 = np.clip(base + rng.randint(-20, 21, base.shape), 0, 255)
        p1 = np.clip(base + rng.randint(-20, 21, base.shape), 0, 255)
        p1[::5] = p0[::5]
        levels.append(((_i32(p0, dev), _i32(p1, dev)),
                       _i32(rng.randint(-300, 301, (2, nb)), dev),
                       _i32(rng.randint(-300, 301, (2, nb)), dev), n, gw))
    for lv in (levels, levels[:1]):
        got = _launched("satd8", lambda: me.satd_gate_levels(org, lv))
        want = me.satd_gate_levels_plain(org, lv)
        for (gx, gy), (wx, wy) in zip(got, want):
            assert torch.equal(gx, wx) and torch.equal(gy, wy)
    # int64 MV sets: the wrapper's int32 copies of every level must live
    # until the launch (a freed copy handed to the next level's is caught)
    lv64 = [(p, mx.to(torch.int64), my.to(torch.int64), n, gw)
            for p, mx, my, n, gw in levels]
    got = _launched("satd8", lambda: me.satd_gate_levels(org, lv64))
    for (gx, gy), (wx, wy) in zip(got, me.satd_gate_levels_plain(org,
                                                                 levels)):
        assert torch.equal(gx, wx) and torch.equal(gy, wy)


@pytest.mark.parametrize("bd", [8, 10])
def test_transform_skip_kernel(dev, bd):
    """K1's level forms in their TS mode against their plain versions,
    one launch each direction: the one-plane pair (DCT and DST, with and
    without the chroma weight) and an 8x8 level's chroma pair, the TS
    coefficients, the kept reconstruction, levels, distortion, rate with
    the flag, the TS word and the level's cbf, dist and bits; ties keep
    the DCT alternative."""
    from hmtpu_torch.ops import transform as t
    from tests.torch_level_data import FLAG, planes as level_planes, ts_alt

    for planes_n, dst, dw in (((4,), False, None), ((4,), True, None),
                              ((4,), False, 1.25), ((8, 4, 4), False, 1.25)):
        for m in (1, 9, 3120 // len(planes_n)):
            rng = np.random.RandomState(m + bd + dst)
            planes = level_planes(rng, m, planes_n, bd)
            tk = t.ts_planes(len(planes))
            alts = [ts_alt(rng, planes[k], bd) for k in tk]
            orgs, preds, deqs, levs = ([_i32(a, dev) for a in x]
                                       for x in zip(*planes))
            bits = [torch.as_tensor(rng.randint(0, 3000, m).astype(
                np.float32) * np.float32(0.03125)).to(dev) for _ in planes]
            for i, k in enumerate(tk):
                bits[k] = torch.as_tensor(alts[i][2]).to(dev)
            c, tc = _launched("int_transform_fwd", lambda: t.fwd_level(
                orgs, preds, bd, dst, ts=True))
            wc, wtc = t.fwd_level_plain(orgs, preds, bd, dst, ts=True)
            for a, b in zip(c + tc, wc + wtc):
                assert torch.equal(a, b)
            args = (deqs, levs, bits, [_i32(a[0], dev) for a in alts],
                    [_i32(a[1], dev) for a in alts],
                    [torch.as_tensor(a[3]).to(dev) for a in alts], preds,
                    orgs, torch.as_tensor(FLAG).to(dev),
                    torch.tensor(9.5, device=dev), bd,
                    None if dw is None else torch.tensor(dw, device=dev),
                    dst)
            got = _launched("int_transform_inv",
                            lambda: t.inv_level_ts(*args))
            want = t.inv_level_ts_plain(*args)
            for g, w in zip(got, want):
                if w is None:
                    assert g is None
                    continue
                for a, b in zip(g if isinstance(g, list) else [g],
                                w if isinstance(w, list) else [w]):
                    assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("n", [8, 16, 32])
def test_frac_refine_kernel(dev, n):
    from hmtpu_torch.search import me

    rng = np.random.RandomState(n)
    h, w = 240, 416
    refs = _i32(rng.randint(0, 256, (4, h, w)), dev)
    gw, gh = -(-w // n), -(-h // n)
    q = np.arange(gw * gh)
    org = _i32(rng.randint(0, 256, (q.size, n, n)), dev)
    args = [_i32(a, dev) for a in ((q % gw) * n, (q // gw) * n)]
    mv = [_i32(rng.randint(-40, 41, q.size), dev) for _ in range(2)]
    ridx = _i32(rng.randint(0, 4, q.size), dev)
    got = _launched("frac_refine", lambda: me.frac_refine_batch(
        refs, *args, org, *mv, n, 8, ridx=ridx))
    want = me.frac_refine_batch_plain(refs, *args, org, *mv, n, 8,
                                      ridx=ridx)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # 10 bits
    refs10, org10 = refs << 2 | 3, org << 2
    got = _launched("frac_refine", lambda: me.frac_refine_batch(
        refs10, *args, org10, *mv, n, 10, ridx=ridx))
    want = me.frac_refine_batch_plain(refs10, *args, org10, *mv, n, 10,
                                      ridx=ridx)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if n != 8:
        return
    # the levels form, one launch for the three levels: 416x240 and 64x56
    # (the 32 grid's original clamped past the last row), 8 and 10 bits
    for (h, w), bd in (((240, 416), 8), ((240, 416), 10), ((56, 64), 8),
                       ((56, 64), 10)):
        top = (1 << bd) - 1
        refs = _i32(rng.randint(0, top + 1, (3, h, w)), dev)
        org = _i32(np.clip(refs[1].cpu().numpy() + rng.randint(
            -top // 8, top // 8 + 1, (h, w)), 0, top), dev)
        levels = []
        for m, gh, gw in ((8, h // 8, w // 8), (16, h // 16, w // 16),
                          (32, -(-h // 32), -(-w // 32))):
            mk = lambda lo, hi: _i32(rng.randint(lo, hi, (gh, gw)), dev)
            levels.append((mk(-40, 41), mk(-40, 41), mk(0, 3), m))
        want = me.frac_refine_levels_plain(refs, org, levels, bd)
        # and int64 reference indices, as the B pass's union indices come:
        # the wrapper's copies of every level live until the launch
        lv64 = [(mx, my, rr.to(torch.int64), m) for mx, my, rr, m in levels]
        for lv in (levels, lv64):
            before = kernels.COUNTS["frac_refine"]
            got = me.frac_refine_levels(refs, org, lv, bd)
            torch.cuda.synchronize()
            assert kernels.COUNTS["frac_refine"] == before + 1
            for (gx, gy), (wx, wy) in zip(got, want):
                assert torch.equal(gx, wx) and torch.equal(gy, wy)
    # the extraction's 1080p call: 32,400 8x8 blocks of one reference
    h, w = 1080, 1920
    ref = _i32(rng.randint(0, 256, (h, w)), dev)
    q = np.arange((h // 8) * (w // 8))
    args = [_i32(a, dev) for a in ((q % (w // 8)) * 8, (q // (w // 8)) * 8)]
    org = _i32(rng.randint(0, 256, (q.size, 8, 8)), dev)
    mv = [_i32(rng.randint(-64, 65, q.size), dev) for _ in range(2)]
    got = _launched("frac_refine", lambda: me.frac_refine_batch(
        ref, *args, org, *mv, 8, 8))
    want = me.frac_refine_batch_plain(ref, *args, org, *mv, 8, 8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_rdoq_kernel(dev, log2):
    from hmtpu_torch.common.constants import SliceType
    from hmtpu_torch.common.lambdas import frame_lambdas
    from hmtpu_torch.entropy.contexts import make_contexts
    from hmtpu_torch.entropy.fracbits import ctx_bits_table
    from hmtpu_torch.ops import quant, ratebits, rdoq, transform

    n = 1 << log2
    rng = np.random.RandomState(log2)
    res = _i32(rng.randint(-60, 61, (64, n, n)) // rng.randint(
        1, 9, (64, 1, 1)), dev)
    cb = torch.as_tensor(ctx_bits_table(make_contexts(
        SliceType.P, 22)).reshape(-1)).to(dev)
    for ts in (False, True) if n == 4 else (False,):
        coef = transform.transform_skip_fwd_plain(res, n) if ts \
            else transform.forward_transform(res, n)
        for luma in (True, False):
            lam = torch.tensor(frame_lambdas(22, 22, 0.4624)[0 if luma else 3],
                               dtype=torch.float32, device=dev)
            sel = _i32(rng.randint(0, 3, 64), dev) if n <= 8 else None
            for trellis in (True, False):
                for sdh in (True, False):
                    got = _launched("rdoq", lambda: rdoq.rdoq_code(
                        coef, 22, log2, 8, lam, cb, luma, sdh=sdh,
                        scan_sel=sel, trellis=trellis))
                    lev = rdoq.rdoq_tb_plain(coef, 22, log2, 8, lam, cb,
                                             luma, 0, sdh, sel, trellis)
                    assert torch.equal(got[0], lev)
                    assert torch.equal(got[1], quant.dequantize_t_plain(
                        lev, 22, log2))
                    bits = ratebits.tb_bits_plain(lev, cb, log2, luma, 0,
                                                  sdh)
                    assert torch.equal(got[2].view(torch.int32),
                                       bits.view(torch.int32))
            assert torch.equal(
                _launched("rdoq", lambda: quant.quantize_t(coef, 22, log2)),
                quant.quantize_t_plain(coef, 22, log2))
    # the contents that reach the coder's edges (tests/test_torch_rdoq_lanes
    # .py: all-zero, DC only, C1FLAG, Rice 4, stage 2, the all-zero TB
    # winning stage 3, SDH parity fixes), at 8 and 10 bits, QP 27
    from tests.test_torch_rdoq_lanes import QP, _batch, _lam
    cb27 = torch.as_tensor(ctx_bits_table(make_contexts(
        SliceType.P, QP)).reshape(-1)).to(dev)
    for bd in (8, 10):
        coef, _ = _batch(log2, bd, 17 * log2 + bd)
        coef = coef.to(dev)
        sel = _i32(rng.randint(0, 3, coef.shape[0]), dev) if n <= 8 else None
        for luma in (True, False):
            lam = torch.tensor(_lam(luma), device=dev)
            for trellis in (True, False):
                for sdh in (True, False):
                    got = _launched("rdoq", lambda: rdoq.rdoq_code(
                        coef, QP, log2, bd, lam, cb27, luma, sdh=sdh,
                        scan_sel=sel, trellis=trellis))
                    lev = rdoq.rdoq_tb_plain(coef, QP, log2, bd, lam, cb27,
                                             luma, 0, sdh, sel, trellis)
                    assert torch.equal(got[0], lev)
                    assert torch.equal(got[1], quant.dequantize_t_plain(
                        lev, QP, log2, bd))
                    bits = ratebits.tb_bits_plain(lev, cb27, log2, luma, 0,
                                                  sdh)
                    assert torch.equal(got[2].view(torch.int32),
                                       bits.view(torch.int32))


@pytest.mark.parametrize("subpel,ts", [("nn", False), ("dctif", True)])
def test_ldp_encode_card_equals_cpu(dev, subpel, ts):
    """Four 64x64 pictures through the low-delay-P path (NN-FME; or HM's
    DCT-IF search with transform skip) on the card and on the CPU: the
    same bytes."""
    from hmtpu_torch.encoder.top import Encoder, EncoderConfig
    from hmtpu_torch.io.yuv import Frame

    rng = np.random.RandomState(5)
    yy, xx = np.mgrid[0:64, 0:64]
    frames = []
    for t in range(4):
        y = 128 + 60 * np.sin((xx + 2 * t) / 9.0) * np.cos((yy - t) / 7.0) \
            + rng.randint(-3, 4, (64, 64))
        u = np.full((32, 32), 120) + rng.randint(-2, 3, (32, 32))
        v = np.full((32, 32), 136) + rng.randint(-2, 3, (32, 32))
        frames.append(Frame(*(np.clip(a, 0, 255).astype(np.uint8)
                              for a in (y, u, v)), 8))
    out = []
    for d in (dev, "cpu"):
        enc = Encoder(EncoderConfig(width=64, height=64, qp=27, gop="ldp",
                                    subpel=subpel, search_range=8,
                                    transform_skip=ts), device=d)
        out.append(enc.encode_sequence(frames))
    assert out[0] == out[1]


def _screen(w, h, n):
    """Screen content where transform skip wins (the seed-11 generator of
    the repo's transform-skip tests): coloured strokes on a flat
    background, drifting so P frames carry chroma residual."""
    rng = np.random.RandomState(11)
    marks = [(rng.randint(0, w // 2 - 8), rng.randint(0, h // 2 - 4),
              rng.randint(3, 8)) for _ in range(40)]
    out = []
    for t in range(n):
        y = np.full((h, w), 90, np.uint8)
        u = np.full((h // 2, w // 2), 100, np.uint8)
        v = np.full((h // 2, w // 2), 150, np.uint8)
        for x0, y0, ln in marks:
            x = (x0 + t) % (w // 2 - 8)
            u[y0:y0 + 2, x:x + ln] = 230
            v[y0:y0 + 2, x:x + ln] = 40
            y[2 * y0:2 * y0 + 4, 2 * x:2 * x + 2 * ln] = 200
        out.append((y, u, v))
    return out


@pytest.mark.parametrize("gop,counter", [("ai", "intra_ts_tbs"),
                                         ("ldp", "ldp_ts_tbs")])
def test_transform_skip_chosen_card_equals_cpu(dev, gop, counter):
    """Screen content at 64x64 (AI: 2 pictures; LDP with HM's DCT-IF
    search: 4) with transform skip on the card and on the CPU: the same
    bytes, and some TB chose transform skip on the card (LDP: in the
    level forms' TS mode, which launches in every P pass)."""
    from hmtpu_torch.encoder import pframe_dev
    from hmtpu_torch.encoder.top import Encoder, EncoderConfig
    from hmtpu_torch.io.yuv import Frame

    frames = [Frame(*p, 8) for p in _screen(64, 64, 2 if gop == "ai"
                                            else 4)]
    out, fired = [], []
    for d in (dev, "cpu"):
        pframe_dev.DBG_COUNTERS[counter] = 0
        enc = Encoder(EncoderConfig(width=64, height=64, qp=27, gop=gop,
                                    subpel="dctif", search_range=8,
                                    transform_skip=True), device=d)
        before = kernels.COUNTS["int_transform_inv"]
        out.append(enc.encode_sequence(frames))
        fired.append(pframe_dev.DBG_COUNTERS[counter])
        if d == dev and gop == "ldp":
            assert kernels.COUNTS["int_transform_inv"] > before
    assert out[0] == out[1]
    assert fired[0] > 0 and fired[0] == fired[1]


@pytest.mark.parametrize("qp", [22, 37])
def test_ra_main10_card_equals_cpu(dev, qp):
    """Nine 64x64 Main10 pictures through the random-access path (the
    IDR and one GOP of 8 B pictures, HM's DCT-IF search) on the card and
    on the CPU: the same bytes, and bi-predicted CUs on the card."""
    from hmtpu_torch.encoder import pframe_dev
    from hmtpu_torch.encoder.top import Encoder, EncoderConfig
    from hmtpu_torch.io.yuv import Frame

    rng = np.random.RandomState(9)
    yy, xx = np.mgrid[0:64, 0:64]
    frames = []
    for t in range(9):
        y = 512 + 240 * np.sin((xx + 2 * t) / 9.0) * np.cos((yy - t) / 7.0) \
            + rng.randint(-12, 13, (64, 64))
        u = np.full((32, 32), 480) + rng.randint(-8, 9, (32, 32))
        v = np.full((32, 32), 544) + rng.randint(-8, 9, (32, 32))
        frames.append(Frame(*(np.clip(a, 0, 1023).astype(np.int32)
                              for a in (y, u, v)), 10))
    out, bi = [], []
    for d in (dev, "cpu"):
        pframe_dev.DBG_COUNTERS["ra_bi_cus"] = 0
        enc = Encoder(EncoderConfig(width=64, height=64, qp=qp, gop="ra",
                                    bit_depth=10, subpel="dctif",
                                    search_range=8), device=d)
        out.append(enc.encode_sequence(frames))
        bi.append(pframe_dev.DBG_COUNTERS["ra_bi_cus"])
    assert out[0] == out[1]
    assert bi[0] == bi[1]


@pytest.mark.parametrize("h,w,srange,bd", [
    (56, 64, 8, 8), (40, 72, 64, 8), (240, 416, 16, 8), (240, 416, 64, 8),
    (56, 64, 16, 10), (1080, 1920, 64, 8)])
def test_me_sad1_kernel(dev, h, w, srange, bd):
    """K13, the single-level integer ME, against its plain version with
    non-zero quarter-pel predictors, at sides that are not multiples of
    16 or 32 (the regions of the last row and column are partly outside
    the picture), on 8-bit samples (staged as bytes) and 10-bit ones
    (halfwords), and at 1080p SR 64 (the trainer's extraction)."""
    from hmtpu_torch.search import me

    rng = np.random.RandomState(h * w + srange)
    org, ref = (_i32(a.astype(np.int64) << (bd - 8), dev)
                for a in _textured(rng, h, w))
    for lam, span in ((np.float32(0.0), 0), (np.float32(7.3), 64)):
        px, py = (_i32(rng.randint(-span, span + 1, (h // 8, w // 8)), dev)
                  for _ in range(2))
        got = _launched("me_sad1", lambda: me.integer_me(
            ref, org, 8, srange, lam, px, py, bd))
        want = me.integer_me_plain(ref, org, 8, srange, lam, px, py)
        (gx, gy), gst, gsad = got
        (wx, wy), wst, wsad = want
        for g, wnt in ((gx, wx), (gy, wy), (gst, wst), (gsad, wsad)):
            assert g.shape == wnt.shape and torch.equal(g, wnt)
    # a flat picture: every displacement ties, the first index wins
    flat = torch.full((h, w), 90 << (bd - 8), dtype=torch.int32, device=dev)
    z = torch.zeros((h // 8, w // 8), dtype=torch.int32, device=dev)
    (mx, my), _, _ = _launched("me_sad1", lambda: me.integer_me(
        flat, flat, 8, srange, np.float32(0.0), z, z, bd))
    assert bool((mx == -srange).all()) and bool((my == -srange).all())
    # no other depth, and no fallback
    with pytest.raises(ValueError):
        me.integer_me(ref, org, 8, srange, np.float32(0.0), z, z, 12)


def _train_batch(dev, nb, seed):
    """Seeded rows at sizes 8/16/32 and QP-22-like costs, the in-repo
    QP 22 weights with the batch's own mean/std."""
    from hmtpu_torch.models import nnfme

    rng = np.random.RandomState(seed)
    base = rng.randint(200, 6000, (nb, 1))
    c9 = (base + rng.randint(0, 900, (nb, 9))).astype(np.float32)
    d = dict(np.load(f"{nnfme.WEIGHTS_DIR}/qp22.npz"))
    d.update(mean=c9.mean(0), std=c9.std(0) + 1e-8)
    params = nnfme.params_from_arrays(d, dev)
    t = lambda a: torch.as_tensor(a).to(dev)
    return (params, t(c9), t(rng.choice([8, 16, 32], nb).astype(np.int32)),
            t(rng.choice([8, 16, 32], nb).astype(np.int32)),
            t(rng.randint(0, 49, nb).astype(np.int32)))


@pytest.mark.parametrize("nb", [1, 32, 100, 1024])
def test_nnfme_train_kernels(dev, nb):
    """K14, K15 and K15 with K16 as its tail against their plain versions
    on the card: equal (K14's pre-activations are K6's operations, its
    exp and log the plain version's own; K15 and K16 do only correctly
    rounded operations in the plain versions' order), K15's gradient has
    the same bits on every run, and the fused step (one launch) gives
    `loss_bwd_plain` then `adam_update_plain`'s gradient, parameters and
    moments, its device count the host's; updates 1, 2 and the table's
    last, and an update past the table is an error."""
    from hmtpu_torch.models import train

    params, c9, hh, ww, ll = _train_batch(dev, nb, nb)
    p = params.packed
    out, saved = _launched("nnfme_fwd", lambda: train.loss_fwd(
        p, c9, hh, ww, ll))
    wout, wsaved = train.loss_fwd_plain(p, c9, hh, ww, ll)
    assert torch.equal(out, wout)
    for a, b in zip(saved, wsaved):
        assert torch.equal(a, b)
    vout, none = _launched("nnfme_fwd", lambda: train.loss_fwd(
        p, c9, hh, ww, ll, want_grad=False))
    assert none is None and torch.equal(vout, out)

    one = torch.ones(1, dtype=torch.float32, device=dev)
    g1 = _launched("nnfme_bwd", lambda: train.loss_bwd(p, c9, hh, ww,
                                                       *saved, one))
    g2 = train.loss_bwd(p, c9, hh, ww, *saved, one)
    torch.cuda.synchronize()
    assert torch.equal(g1.view(torch.int32), g2.view(torch.int32))
    assert torch.equal(g1, train.loss_bwd_plain(p, c9, hh, ww, *saved, one))

    mu = torch.randn(p.numel(), device=dev) * 1e-3
    nu = torch.rand(p.numel(), device=dev) * 1e-5
    for k in (1, 2, 7):
        opt = train.adam_state(mu.clone(), nu.clone(), k - 1, 8 - k)
        want = train.adam_state(mu.clone(), nu.clone(), k - 1, 8 - k)
        pk, pw = p.clone(), p.clone()
        g = _launched("nnfme_bwd", lambda: train.loss_bwd_adam(
            pk, c9, hh, ww, *saved, one, opt, 3e-3))
        gw = train.loss_bwd_adam_plain(pw, c9, hh, ww, *saved, one, want,
                                       3e-3)
        for a, b in ((g, gw), (g, g1), (pk, pw), (opt.mu, want.mu),
                     (opt.nu, want.nu), (opt.dcount, want.dcount)):
            assert torch.equal(a, b)
        assert int(opt.dcount[0]) == k
    with pytest.raises(ValueError, match="past the bias corrections"):
        train.loss_bwd_adam(pk, c9, hh, ww, *saved, one,
                            opt._replace(count=7), 3e-3)


def test_nnfme_loss_autograd_backward(dev):
    """The autograd.Function's backward (K15 on K14's saved tensors)
    against the plain backward on the same tensors and against the
    plain forward + backward: equal."""
    from hmtpu_torch.models import train

    params, c9, hh, ww, ll = _train_batch(dev, 777, 3)
    packed = params.packed.clone().requires_grad_(True)
    out = train.NnFmeLoss.apply(packed, c9, hh, ww, ll)
    seed = torch.tensor([1.0, 0.0], device=dev)
    g, = torch.autograd.grad(out, packed, grad_outputs=seed)
    _, saved = train.loss_fwd(params.packed, c9, hh, ww, ll)
    one = seed[:1]
    assert torch.equal(g, train.loss_bwd_plain(params.packed, c9, hh, ww,
                                               *saved, one))
    _, psaved = train.loss_fwd_plain(params.packed, c9, hh, ww, ll)
    want = train.loss_bwd_plain(params.packed, c9, hh, ww, *psaved, one)
    assert torch.equal(g, want)


# ---------------------------------------------------------------------------
# K17-K20: the z-scan's candidate and mode-rate derivations; the z-scan's
# lane counts (1560 8x8 cells, 390 16x16 regions of 416x240) and odd ones

def _nb_rows(rng, B, bi):
    """(B, 5) validity and (B, 5, 14) state rows from small alphabets, so
    that pruning, duplicate predictors and equal bits occur."""
    from hmtpu_torch.encoder import pframe_dev as pf

    nbp = np.zeros((B, 5, 14), np.int32)
    ndir = rng.randint(0, 4 if bi else 2, (B, 5))
    nbp[..., pf.K_DIR] = ndir
    for k, alpha in ((pf.K_MVX, [-40, -3, 0, 5, 130]), (pf.K_MVY, [-7, 0, 64]),
                     (pf.K_MVX1, [-9, 0, 5]), (pf.K_MVY1, [0, 3])):
        nbp[..., k] = rng.choice(alpha, (B, 5))
    nbp[..., pf.K_REF] = rng.randint(0, 4, (B, 5))
    nbp[..., pf.K_REF1] = rng.randint(0, 2, (B, 5))
    return (rng.rand(B, 5) < 0.85) & (ndir > 0), nbp


def _cbflat(dev, qp, b_slice):
    from hmtpu_torch.common.constants import SliceType
    from hmtpu_torch.entropy.contexts import make_contexts
    from hmtpu_torch.entropy.fracbits import ctx_bits_table

    st = SliceType.B if b_slice else SliceType.P
    return torch.as_tensor(ctx_bits_table(make_contexts(st, qp))
                           .reshape(-1)).to(dev)


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("B", [1, 3, 257, 1560])
def test_merge_cands_kernel(dev, B):
    from hmtpu_torch.search import wavefront as wf

    rng = np.random.RandomState(B)
    valid, nbp = _nb_rows(rng, B, True)
    v = torch.as_tensor(valid).to(dev)
    col = lambda k: _i32(nbp[..., k], dev)
    tok = torch.as_tensor(rng.rand(B) < 0.5).to(dev)
    tx, ty = (_i32(rng.randint(-4, 5, B), dev) for _ in range(2))
    for mm, kw in ((5, {}), (5, dict(t_ok=tok, t_mvx=tx, t_mvy=ty,
                                     n_active=2)), (3, dict(n_active=4))):
        args = (v, col(6), col(7), col(8), 4, mm)
        got = _launched("merge_cands",
                        lambda: wf.merge_candidates_dev(*args, **kw))
        _same(got, wf.merge_candidates_dev_plain(*args, **kw))
    pocs0, pocs1 = _i32([2, 8, 4], dev), _i32([8, 16], dev)
    for mm in (5, 2):
        args = (v, col(5), col(6), col(7), col(8), col(11), col(12),
                col(13), pocs0, pocs1, 3, 2, mm)
        got = _launched("merge_cands",
                        lambda: wf.merge_candidates_dev_b(*args))
        _same(got, wf.merge_candidates_dev_b_plain(*args))


@pytest.mark.parametrize("B", [1, 3, 257, 1560])
def test_amvp_rd_kernel(dev, B):
    from hmtpu_torch.encoder import pframe_dev as pf

    rng = np.random.RandomState(B + 1)
    for bi in (False, True):
        valid, nbp = _nb_rows(rng, B, bi)
        nbv = torch.as_tensor(valid).to(dev)
        nbp = _i32(nbp, dev)
        aref = _i32(rng.randint(0, 2, B), dev)
        amx = _i32(rng.choice([-40, -3, 0, 5, 130, 3], B), dev)
        amy = _i32(rng.choice([-7, 0, 2, 64], B), dev)
        pocs0 = _i32([7, 6, 3, 2], dev)
        cb = _cbflat(dev, 22 if bi else 37, bi)
        if bi:
            kw = dict(lx=_i32(rng.randint(0, 2, B), dev),
                      ref_pocs_l1=_i32([16, 12], dev), num_ref_l1=2, depth=1)
        else:
            kw = dict(t=(torch.as_tensor(rng.rand(B) < 0.5).to(dev),
                         _i32(rng.randint(-30, 31, B), dev),
                         _i32(rng.randint(-30, 31, B), dev)), n_active=3)
        args = (cb, nbv, nbp, aref, amx, amy, pocs0, 8, 4)
        got = _launched("amvp_rd", lambda: pf.amvp_rd(*args, **kw))
        want = pf.amvp_rd_plain(*args, **kw)
        _same(got[:5], want[:5])
        _same(got[5], want[5])


@pytest.mark.parametrize("h,w", [(240, 416), (56, 64), (8, 16),
                                 (1080, 1920)])
def test_mv_regularize_kernel(dev, h, w):
    from hmtpu_torch.search import me

    rng = np.random.RandomState(h + w)
    org = _i32(rng.randint(0, 256, (h, w)), dev)
    refs = _i32(np.clip(org.cpu().numpy()[None] + rng.randint(-9, 10,
                                                              (3, h, w)),
                        0, 255), dev)
    bh, bw = h // 8, w // 8
    mvx = _i32(rng.choice([-3, 0, 2, 5], (bh, bw)), dev)
    mvy = _i32(rng.choice([-1, 0, 4], (bh, bw)), dev)
    ridx = _i32(rng.randint(0, 3, (bh, bw)), dev)
    lam = torch.tensor(6.25, device=dev)
    for iters in (1, 2, 3, 4):
        before = kernels.COUNTS["mv_regularize"]
        got = me.regularize_mv_field(refs, org, mvx, mvy, ridx, lam,
                                     iters=iters)
        torch.cuda.synchronize()
        # every round in one launch
        assert kernels.COUNTS["mv_regularize"] == before + 1
        _same(got, me.regularize_mv_field_plain(refs, org, mvx, mvy, ridx,
                                                lam, iters=iters))


@pytest.mark.parametrize("B", [1, 3, 257, 1560])
def test_mpm_bits_kernel(dev, B):
    from hmtpu_torch.ops import ratebits as rb

    rng = np.random.RandomState(B + 2)
    cb = _cbflat(dev, 32, False)
    lm = _i32(rng.choice([0, 1, 2, 10, 26, 34], B), dev)
    am = _i32(rng.choice([0, 1, 2, 10, 26, 34], B), dev)
    modes = _i32(rng.randint(0, 35, (B, 35)), dev)
    for args in ((cb, modes, lm[:, None], am[:, None]),
                 (cb, modes[:, 0], lm, am)):
        got = _launched("mpm_bits", lambda: rb.intra_mode_mpm_bits(*args))
        want = rb.intra_mode_mpm_bits_plain(*args)
        assert torch.equal(got, want)
    m4 = _i32(rng.choice([0, 1, 2, 10, 26, 34], (B, 4)), dev)
    got = _launched("mpm_bits",
                    lambda: rb.intra_mode_mpm_bits_nxn(cb, m4, lm, am))
    assert torch.equal(got, rb.intra_mode_mpm_bits_nxn_plain(cb, m4, lm, am))


def _i_pass_inputs(dev, w, h, qp, bd, seed):
    """Planes (card and CPU) of a textured picture, the I slice's
    fractional-bit table, and qpc."""
    from hmtpu_torch.common.constants import SliceType
    from hmtpu_torch.common.spec_tables import chroma_qp_from_luma
    from hmtpu_torch.entropy.contexts import make_contexts
    from hmtpu_torch.entropy.fracbits import ctx_bits_table

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = 128 + 50 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    y[:, : w // 2] += np.kron(rng.randint(-50, 51, (h // 4, w // 4)),
                              np.ones((4, 4)))[:, : w // 2]
    u = 128 + rng.randint(-20, 21, (h // 2, w // 2))
    v = 128 + 30 * np.cos(xx[::2, ::2] / 11.0)
    planes = [np.clip(p, 0, 255).astype(np.int32) << (bd - 8)
              for p in (y, u, v)]
    cb = ctx_bits_table(make_contexts(SliceType.I, qp)).reshape(-1)
    on = lambda d: ([torch.as_tensor(p).to(d) for p in planes]
                    + [torch.as_tensor(cb).to(d)])
    return on(dev), on("cpu"), chroma_qp_from_luma(qp)


@pytest.mark.parametrize("w,h,qp,bd,sdh,ts", [
    (64, 64, 22, 8, False, False), (64, 64, 37, 8, True, True),
    (64, 56, 27, 8, False, False), (80, 48, 32, 8, True, False),
    (96, 64, 27, 10, False, True)])
def test_i_walk_kernel(dev, w, h, qp, bd, sdh, ts):
    """K21 (and K22 for its candidates) against the plain I pass on the
    CPU: every state array equal; one K21 launch per z-scan level."""
    from hmtpu_torch.encoder import iframe_dev as idv

    card, cpu, qpc = _i_pass_inputs(dev, w, h, qp, bd, w + qp)
    kw = dict(w=w, h=h, bd=bd, sis=True, sdh=sdh, ts=ts)
    before = kernels.COUNTS["i_walk"]
    got = _launched("i_rmd", lambda: idv.iframe_pass(*card[:3], qp, qpc,
                                                     card[3], **kw))
    st = idv._i_static(w, h, 6)
    lv = (st["sched32"] or st["sched16"] or (st["lv_blk"],))[0]
    assert kernels.COUNTS["i_walk"] - before == lv.shape[0]
    want = idv.iframe_pass_plain(*cpu[:3], qp, qpc, cpu[3], **kw)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.parametrize("n,k", [(4, 1), (8, 2), (8, 1), (16, 2), (32, 2)])
def test_i_rmd_kernel(dev, n, k):
    from hmtpu_torch.encoder.intra_rdo import rmd, rmd_plain
    from hmtpu_torch.search.wavefront import static_ref_gather

    rng = np.random.RandomState(n * k)
    for bd in (8, 10):
        plane = rng.randint(0, 1 << bd, (64, 96))
        plane[:32] = 1 << (bd - 1)               # flat: every mode ties
        # 16x16 steps: ties among some modes (test_torch_iwalk.py's)
        plane[32:48] = np.kron(rng.randint(0, 4, (1, 6)),
                               np.ones((16, 16), int)) * (40 << (bd - 8))
        sub, none = static_ref_gather(96, 64, 6, n)
        for sis in (False, True):
            kw = dict(bd=bd, lam_sqrt=np.float32(6.5), sis=sis)
            got = _launched("i_rmd", lambda: rmd(
                _i32(plane, dev), (_i32(sub, dev), _i32(none, dev)), n, k,
                **kw))
            want = rmd_plain(torch.as_tensor(plane.astype(np.int32)),
                             (torch.as_tensor(sub).long(),
                              torch.as_tensor(none)), n, k, **kw)
            assert torch.equal(got.cpu(), want)


def test_rext_card_equals_cpu(dev, tmp_path):
    """BASELINE config 5 (the High-Throughput-RExt cfg, 10 bits, TS)
    through the port's CLI at 96x64, 3 frames: card and CPU give the same
    bytes, and the card's I passes ran K21 and K22."""
    from hmtpu_torch.apps import encoder_app
    from hmtpu_torch.utils.gen_test_yuv import synth_clip

    cfg = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "cfg",
        "encoder_intra_high_throughput_rext.cfg")
    yuv = tmp_path / "in10.yuv"
    with open(yuv, "wb") as f:
        for planes in synth_clip(96, 64, 3):
            for p in planes:
                f.write((np.asarray(p, np.uint16) << 2).astype("<u2")
                        .tobytes())
    out = []
    for d in ("cuda", "cpu"):
        before = dict(kernels.COUNTS)
        b = tmp_path / f"{d}.hevc"
        assert encoder_app.main(
            ["-c", cfg, "--InputBitDepth=10", "-f", "3", "-wdt", "96",
             "-hgt", "64", "-i", str(yuv), "-b", str(b)], device=d) == 0
        if d == "cuda":
            assert all(kernels.COUNTS[k] > before[k]
                       for k in ("i_walk", "i_rmd"))
        out.append(b.read_bytes())
    assert out[0] == out[1]


@pytest.mark.parametrize("w,h,qp,subpel,ts,bd", [
    (64, 64, 22, "nn", False, 8), (64, 64, 37, "dctif", True, 8),
    (64, 56, 27, "nn", False, 8), (80, 48, 27, "dctif", False, 8),
    (64, 64, 32, "dctif", False, 10)])
def test_p_walk_kernel(dev, w, h, qp, subpel, ts, bd):
    """K23 (with K24 for the temporal grids) against the plain P pass on
    the card, on the P passes of a 3-frame LDP encode there: every state
    array equal; one K23 launch per z-scan level."""
    from hmtpu_torch.encoder import pframe_dev
    from hmtpu_torch.encoder.top import Encoder, EncoderConfig
    from hmtpu_torch.io.yuv import Frame
    from hmtpu_torch.utils.gen_test_yuv import synth_clip

    seen = []
    inner = pframe_dev.wavefront_pass

    def record(*a, **k):
        before = kernels.COUNTS["p_walk"]
        st = inner(*a, **k)
        torch.cuda.synchronize()
        seen.append((a, k, {x: v.clone() for x, v in st.items()},
                     kernels.COUNTS["p_walk"] - before))
        return st

    pframe_dev.wavefront_pass = record
    try:
        enc = Encoder(EncoderConfig(width=w, height=h, qp=qp, gop="ldp",
                                    subpel=subpel, search_range=8,
                                    transform_skip=ts, bit_depth=bd),
                      device="cuda")
        enc.encode_sequence([Frame(*(np.asarray(p, np.int32) << (bd - 8)
                                     for p in f), bd)
                             for f in synth_clip(w, h, 3)])
    finally:
        pframe_dev.wavefront_pass = inner
    assert len(seen) == 2
    st = pframe_dev._p_static(w, h, 6)
    lv = st["sched32"][0] if st["sched32"] is not None else st["lv_blk"]
    for a, k, got, launches in seen:
        assert launches == lv.shape[0]
        want = pframe_dev.wavefront_pass_plain(*a, **k)
        for x in want:
            assert torch.equal(got[x], want[x]), x


@pytest.mark.parametrize("w,h", [(64, 64), (80, 48), (416, 240)])
def test_tmvp_grid_kernel(dev, w, h):
    """K24 against its plain version (`t_level_plain`) on seeded
    collocated fields, at the 8, 16 and padded 32 grids."""
    from hmtpu_torch.encoder import pframe_dev

    rng = np.random.RandomState(w * h)
    bw, bh = w // 8, h // 8
    col = (rng.randint(-300, 301, (bh, bw)), rng.randint(-300, 301, (bh, bw)),
           rng.rand(bh, bw) < 0.7,
           8 - rng.choice([1, 2, 3, 200, -150], (bh, bw)))
    g16 = (w // 16, h // 16)
    for pocs in ([8, 7, 6, 5], [8, -200, 140, 3]):
        for n, gw, gh in ((8, bw, bh), (16,) + g16,
                          (32, (g16[0] + 1) // 2, (g16[1] + 1) // 2)):
            aref = rng.randint(0, 4, gw * gh)
            run = lambda d: pframe_dev.tmvp_grid(
                tuple(torch.as_tensor(c).to(d) for c in col), 8, n,
                torch.as_tensor(aref.astype(np.int32)).to(d),
                torch.tensor(pocs, dtype=torch.int32, device=d), 9, w=w,
                h=h, log2_ctu=6, gw=gw, gh=gh)
            got = _launched("tmvp_grid", lambda: run(dev))
            assert torch.equal(got.cpu(), run("cpu"))
        # the grids form: the three grids in one launch
        grids = [(n, rng.randint(0, 4, gw * gh).astype(np.int32), gw, gh)
                 for n, gw, gh in ((8, bw, bh), (16,) + g16,
                                   (32, (g16[0] + 1) // 2,
                                    (g16[1] + 1) // 2))]
        run = lambda d: pframe_dev.tmvp_grids(
            tuple(torch.as_tensor(c).to(d) for c in col), 8,
            [(n, torch.as_tensor(a).to(d), gw, gh) for n, a, gw, gh in grids],
            torch.tensor(pocs, dtype=torch.int32, device=d), 9, w=w, h=h,
            log2_ctu=6)
        before = kernels.COUNTS["tmvp_grid"]
        got = run(dev)
        torch.cuda.synchronize()
        assert kernels.COUNTS["tmvp_grid"] == before + 1
        for a, b in zip(got, run("cpu")):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("bd,qp", [(8, 22), (8, 37), (10, 32)])
def test_sao_choose_kernel(dev, bd, qp):
    """K25 against its plain version on seeded statistics of 28 CTUs
    (416x240 at CTU 64) and 510 (1920x1080), Cr under Cb's type and
    class."""
    from hmtpu_torch.common.lambdas import frame_lambdas
    from hmtpu_torch.ops import sao

    rng = np.random.RandomState(bd + qp)
    lam = torch.tensor(frame_lambdas(qp, qp, 0.57)[0], dtype=torch.float32)
    # and 1920x1080's 510 CTUs
    for ny, nx in ((4, 7), (17, 30)):
        rows = []
        for _ in range(3):
            cnt = rng.choice([0, 1, 5, 60, 900], (ny * nx, 48))
            s = (rng.randint(-12, 13, cnt.shape) * cnt << (bd - 8)) // 3
            r = np.empty((ny * nx, 96), np.int32)
            r[:, 0:16], r[:, 16:32] = s[:, :16], cnt[:, :16]
            r[:, 32:64], r[:, 64:96] = s[:, 16:], cnt[:, 16:]
            rows.append(r)
        got = _launched("sao_choose", lambda: sao.choose_params(
            *(_i32(r, dev) for r in rows), lam.to(dev), bd, ny, nx))
        want = sao.choose_params(*(torch.as_tensor(r) for r in rows), lam,
                                 bd, ny, nx)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("w,h,qp,bd,frames,keep,cut", [
    (64, 64, 27, 8, 3, 2, 0), (64, 64, 30, 10, 3, 2, 0),
    (64, 56, 27, 8, 3, 2, 0), (64, 32, 27, 8, 9, 3, 2)])
def test_b_walk_kernel(dev, w, h, qp, bd, frames, keep, cut):
    """K26 against the plain B pass on the card, on the B passes of a
    random-access encode there (DCT-IF, search range 8; the 64x32 clip a
    GOP whose content changes before frame 2, the encode stopped after
    POC 2: lists of three references, L1-only CUs): every state array
    equal; one K26 launch per z-scan level."""
    from hmtpu_torch.encoder import pframe_dev
    from hmtpu_torch.encoder.top import Encoder, EncoderConfig
    from hmtpu_torch.io.yuv import Frame
    from hmtpu_torch.utils.gen_test_yuv import synth_clip

    clip = list(synth_clip(w, h, frames))
    if cut:
        other = list(synth_clip(w, h, frames, seed=7))
        clip = clip[:cut] + [tuple(255 - p for p in f) for f in other[cut:]]
    seen = []
    inner = pframe_dev.wavefront_pass

    class Enough(Exception):
        pass

    def record(*a, **k):
        before = kernels.COUNTS["b_walk"]
        st = inner(*a, **k)
        torch.cuda.synchronize()
        seen.append((a, k, {x: v.clone() for x, v in st.items()},
                     kernels.COUNTS["b_walk"] - before))
        if len(seen) == keep:
            raise Enough
        return st

    pframe_dev.wavefront_pass = record
    try:
        enc = Encoder(EncoderConfig(width=w, height=h, qp=qp, gop="ra",
                                    subpel="dctif", search_range=8,
                                    bit_depth=bd), device="cuda")
        enc.encode_sequence([Frame(*(np.asarray(p, np.int32) << (bd - 8)
                                     for p in f), bd) for f in clip])
    except Enough:
        pass
    finally:
        pframe_dev.wavefront_pass = inner
    assert len(seen) == keep
    st = pframe_dev._p_static(w, h, 6)
    lv = st["sched32"][0] if st["sched32"] is not None else st["lv_blk"]
    for a, k, got, launches in seen:
        assert k["num_ref_l1"] > 0 and launches == lv.shape[0]
        want = pframe_dev.wavefront_pass_plain(*a, **k)
        for x in want:
            assert torch.equal(got[x], want[x]), x
