"""The hand-written CUDA kernels of hmtpu_torch (K1-K12) against their
plain PyTorch versions, on the card.  Every output must be equal: the
kernels are integer, except NN-FME's (K6) and RDOQ's (K10), whose
kernels and plain versions round every float32 operation in the same
order (K10's float64 sums round once to float32).  Skips
where there is no CUDA card; on the card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(--noconftest: the repo's root conftest loads JAX, which the card's
machine does not need.)  Imports nothing of JAX or hmtpu.
"""
import numpy as np
import pytest
import torch

from hmtpu_torch import kernels

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


@pytest.mark.parametrize("h,w", [(64, 64), (48, 80), (240, 416)])
def test_deblock_kernel(dev, h, w):
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
        got = _launched("deblock", lambda: db.deblock_frame_dev(
            y, u, v, *meta, qp, **masks))
        want = db.deblock_frame_plain(y, u, v, *meta, qp, **masks)
        for g, wnt in zip(got, want):
            assert torch.equal(g, wnt)
        assert not torch.equal(got[0], y)


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
    from hmtpu_torch.search import me

    rng = np.random.RandomState(h + srange)
    org, ref = (_i32(a, dev) for a in _textured(rng, h, w))
    qh, qw = (h // 16 + 1) // 2, (w // 16 + 1) // 2
    for lam in (np.float32(0.0), np.float32(7.3)):
        got = _launched("me_sad", lambda: me.integer_me_levels(
            ref, org, srange, lam, qh, qw))
        want = me.integer_me_levels_plain(ref, org, srange, lam, qh, qw)
        for n in (8, 16, 32):
            (gx, gy), gst, gsad = got[n]
            (wx, wy), wst, wsad = want[n]
            for g, wnt in ((gx, wx), (gy, wy), (gst, wst), (gsad, wsad)):
                assert torch.equal(g, wnt), n
    # a flat picture: every displacement ties, the first index wins
    flat = torch.full((h, w), 90, dtype=torch.int32, device=dev)
    got = _launched("me_sad", lambda: me.integer_me_levels(
        flat, flat, srange, np.float32(0.0), qh, qw))
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


def test_transform_skip_kernel(dev):
    from hmtpu_torch.ops import transform as t

    rng = np.random.RandomState(4)
    for nb in (1, 300):
        res = _i32(rng.randint(-255, 256, (nb, 4, 4)), dev)
        deq = _i32(rng.randint(-(1 << 15), 1 << 15, (nb, 4, 4)), dev)
        got = _launched("transform_skip",
                        lambda: t.transform_skip_fwd(res, 4))
        assert torch.equal(got, t.transform_skip_fwd_plain(res, 4))
        got = _launched("transform_skip",
                        lambda: t.transform_skip_inv(deq, 4))
        assert torch.equal(got, t.transform_skip_inv_plain(deq, 4))


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
        coef = transform.transform_skip_fwd(res, n) if ts \
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
    bytes, and some TB chose transform skip on the card."""
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
        out.append(enc.encode_sequence(frames))
        fired.append(pframe_dev.DBG_COUNTERS[counter])
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
