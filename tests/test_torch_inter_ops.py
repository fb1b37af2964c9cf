"""The low-delay-P ops of hmtpu_torch against hmtpu: the same seeded
numpy inputs through the JAX function (on the CPU) and through the port
with CPU tensors, which run each kernel's plain PyTorch version (K5
integer ME, K6 NN-FME, K7 DCT-IF MC, K8 SATD) and the plain-only device
code (the coherence pass, merge / AMVP / temporal candidates, the inter
rate helpers).

Integer outputs must be equal.  The NN-FME logits agree to 1e-4
(absolute: hmtpu's XLA dot sums in another order than the port's
ascending-k loop); `tb_bits` of 32x32 TBs above 512 bits may differ by
the float32 rounding of one partial sum (see the test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmtpu.common.constants import SliceType
from hmtpu.entropy.contexts import make_contexts
from hmtpu.entropy.fracbits import ctx_bits_table
from hmtpu_torch.common import lambdas
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path works on small tensors: one thread is as fast,
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tt(a):
    """numpy -> CPU tensor (int arrays as int32)."""
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        a = a.astype(np.int32)
    return torch.as_tensor(np.ascontiguousarray(a))


def eq(port, ref, msg=""):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref),
                                  err_msg=msg)


def cbflat(qp, st=SliceType.P):
    c = ctx_bits_table(make_contexts(st, qp)).reshape(-1)
    return jnp.asarray(c), torch.as_tensor(c)


def textured(rng, h, w):
    """A smooth picture with texture, and a shifted, noisy copy of it."""
    yy, xx = np.mgrid[0:h, 0:w]
    org = 128 + 50 * np.sin(xx / 7.0) * np.cos(yy / 5.0) \
        + rng.randint(-20, 21, (h, w))
    ref = np.roll(org, (2, -3), (0, 1)) + rng.randint(-4, 5, (h, w))
    return (np.clip(org, 0, 255).astype(np.int32),
            np.clip(ref, 0, 255).astype(np.int32))


# ---------------------------------------------------------------------------
# lambdas of the LDP GOP positions

def test_ldp_lambdas_match_reference():
    """The LDP factors (0.4624 x3, 0.578, with HM's depth scale) for
    every QP: lambda, its root, the chroma weight and chroma lambda as
    the reference's P pass computes them."""
    from hmtpu.encoder import top as jtop
    from hmtpu_torch.encoder import top as ptop

    @jax.jit
    def ref(qp, qpc, f):
        lam = f * jnp.power(2.0, (qp - 12) / 3.0).astype(jnp.float32)
        w = jnp.exp2((qp - qpc).astype(jnp.float32) / 3.0)
        return lam, jnp.sqrt(lam), w, lam / w

    from hmtpu_torch.common.spec_tables import chroma_qp_from_luma
    for qp in range(52):
        qpc = chroma_qp_from_luma(qp)
        for gpos, base in enumerate((0.4624, 0.4624, 0.4624, 0.578)):
            depth = jtop.gop_depth(gpos + 1, 4)
            assert ptop.gop_depth(gpos + 1, 4) == depth
            f = jtop.lambda_qp_factor(base, qp, depth)
            assert ptop.lambda_qp_factor(base, qp, depth) == f
            want = [np.asarray(x) for x in ref(
                jnp.int32(qp), jnp.int32(qpc), jnp.float32(f))]
            got = lambdas.frame_lambdas(qp, qpc, f)
            for g, w in zip(got, want):
                assert g == w, (qp, gpos, g, w)


def test_ldp_reference_lists_match_reference():
    from hmtpu.encoder.top import Encoder as JEncoder
    from hmtpu.encoder.top import EncoderConfig as JConfig
    from hmtpu_torch.encoder.top import Encoder as PEncoder
    from hmtpu_torch.encoder.top import EncoderConfig as PConfig

    j = JEncoder.__new__(JEncoder)
    j.cfg = JConfig(gop="ldp", num_refs=4)
    p = PEncoder(PConfig(width=64, height=64, gop="ldp", subpel="none"),
                 device="cpu")
    avail = set()
    for rel_poc in range(1, 30):
        avail.add(rel_poc - 1)
        want = j._ldp_lists(rel_poc, set(avail))
        assert p._ldp_lists(rel_poc, set(avail)) == want
        avail = want[1] | {rel_poc}


# ---------------------------------------------------------------------------
# K5: integer ME

@pytest.mark.parametrize("h,w", [(64, 64), (48, 80)])
def test_integer_me_levels(h, w):
    from hmtpu.search import me as jme
    from hmtpu_torch.search import me as pme

    rng = np.random.RandomState(h + w)
    org, ref = textured(rng, h, w)
    bh, bw = h // 8, w // 8
    qh, qw = (bh // 2 + 1) // 2, (bw // 2 + 1) // 2
    # 48x80: a padded bottom and right strip on the 32-grid
    assert (qh * 32 > h) == (h == 48) and (qw * 32 > w) == (w == 80)
    lam = lambdas.frame_lambdas(22, 22, 0.4624 * 2.0)[1]
    want = jme.integer_me_levels(jnp.asarray(ref), jnp.asarray(org), 8,
                                 jnp.float32(lam), qh, qw)
    got = pme.integer_me_levels(tt(ref), tt(org), 8, lam, qh, qw)
    for n in (8, 16, 32):
        (jx, jy), jst, jsad = want[n]
        (px, py), pst, psad = got[n]
        eq(px, jx, f"mvx {n}")
        eq(py, jy, f"mvy {n}")
        eq(pst, jst, f"stencil {n}")
        eq(psad, jsad, f"sad {n}")
        assert px.dtype == py.dtype == torch.int32
    assert np.asarray(got[8][0][0]).any()       # the search moved


def test_integer_me_flat_picture_takes_first_index():
    """Every displacement ties (flat picture, no motion cost): the first
    index in row-major (dy, dx) order wins, (-R, -R)."""
    from hmtpu.search import me as jme
    from hmtpu_torch.search import me as pme

    flat = np.full((48, 80), 90, np.int32)
    want = jme.integer_me_levels(jnp.asarray(flat), jnp.asarray(flat), 8,
                                 jnp.float32(0.0), 2, 3)
    got = pme.integer_me_levels(tt(flat), tt(flat), 8, np.float32(0.0), 2, 3)
    for n in (8, 16, 32):
        eq(got[n][0][0], want[n][0][0])
        eq(got[n][0][1], want[n][0][1])
        assert (got[n][0][0] == -8).all() and (got[n][0][1] == -8).all()
        eq(got[n][1], want[n][1])


def test_integer_me_single_level():
    from hmtpu.search import me as jme
    from hmtpu_torch.search import me as pme

    rng = np.random.RandomState(5)
    org, ref = textured(rng, 40, 56)
    pmx = rng.randint(-12, 13, (5, 7)).astype(np.int32)
    pmy = rng.randint(-12, 13, (5, 7)).astype(np.int32)
    want = jme.integer_me(jnp.asarray(ref), jnp.asarray(org), 8, 6,
                          jnp.float32(3.5), jnp.asarray(pmx),
                          jnp.asarray(pmy))
    got = pme.integer_me(tt(ref), tt(org), 8, 6, np.float32(3.5), tt(pmx),
                         tt(pmy))
    eq(got[0][0], want[0][0])
    eq(got[0][1], want[0][1])
    eq(got[1], want[1])
    eq(got[2], want[2])


# ---------------------------------------------------------------------------
# B4: coherence pass

def test_regularize_mv_field():
    """Exact, including the neighbour shift that wraps around the
    picture edge (`roll`)."""
    from hmtpu.search import me as jme
    from hmtpu_torch.search import me as pme

    rng = np.random.RandomState(11)
    h, w = 48, 64
    org, _ = textured(rng, h, w)
    refs = np.stack([textured(rng, h, w)[1] for _ in range(3)])
    bh, bw = h // 8, w // 8
    # a field with a few distinct vectors so that neighbours coincide,
    # and a distinct column at the right edge that the left edge sees
    mvx = rng.choice([-3, 0, 2, 5], (bh, bw)).astype(np.int32)
    mvy = rng.choice([-1, 0, 4], (bh, bw)).astype(np.int32)
    mvx[:, -1] = 7
    ridx = rng.randint(0, 3, (bh, bw)).astype(np.int32)
    lam = np.float32(6.25)
    want = jme.regularize_mv_field(jnp.asarray(refs), jnp.asarray(org),
                                   jnp.asarray(mvx), jnp.asarray(mvy),
                                   jnp.asarray(ridx), jnp.float32(lam))
    got = pme.regularize_mv_field(tt(refs), tt(org), tt(mvx), tt(mvy),
                                  tt(ridx), torch.tensor(lam))
    for g, wv in zip(got, want):
        eq(g, wv)
    assert not np.array_equal(np.asarray(want[0]), mvx)   # it moved


# ---------------------------------------------------------------------------
# K6: NN-FME

def _stencils(rng, n):
    """SAD stencils shaped like ME's: a minimum near the centre."""
    base = rng.randint(200, 6000, (n, 1))
    bowl = np.array([2, 1, 2, 1, 0, 1, 2, 1, 2])[None] \
        * rng.randint(0, 400, (n, 1))
    return (base + bowl + rng.randint(0, 300, (n, 9))).astype(np.float32)


@pytest.mark.parametrize("which", ["qp22", "qp27", "qp32", "qp37",
                                   "random"])
def test_nnfme(which):
    from hmtpu.models import nnfme as jnn
    from hmtpu_torch.convert import nnfme_params_from_numpy
    from hmtpu_torch.models import nnfme as pnn

    rng = np.random.RandomState(len(which) + ord(which[-1]))
    if which == "random":
        jp = jnn.init_random(jax.random.PRNGKey(3))
    else:
        jp = jnn.load_npz(f"hmtpu/models/weights/{which}.npz")
    pp = nnfme_params_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")
    B = 3000
    costs = _stencils(rng, B)
    sizes = rng.choice([8, 12, 16, 24, 32], B).astype(np.int32)
    heights = np.where(rng.rand(B) < 0.8, sizes, 16).astype(np.int32)
    jl = np.asarray(jnn.forward(jp, jnp.asarray(costs),
                                jnp.asarray(heights), jnp.asarray(sizes)))
    pl = pnn.forward(pp, tt(costs), tt(heights), tt(sizes)).numpy()
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-4)
    jc, jo = (np.asarray(a) for a in jnn.predict_offsets(
        jp, jnp.asarray(costs), jnp.asarray(heights), jnp.asarray(sizes)))
    pc, po = (a.numpy() for a in pnn.predict_offsets(
        pp, tt(costs), tt(heights), tt(sizes)))
    assert pc.dtype == po.dtype == np.int32
    # classes agree wherever the top two logits are further apart than
    # the logit tolerance
    top2 = np.sort(jl, 1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2e-4
    assert clear.mean() > 0.99
    eq(pc[clear], jc[clear])
    eq(po[clear], jo[clear])
    eq(po, np.stack([pc % 7 - 3, pc // 7 - 3], 1))


def test_nnfme_weights_ship_with_the_port():
    """The four per-QP weight files are the port's own copies (data
    files under hmtpu_torch/models/weights), equal to hmtpu's."""
    import os

    from hmtpu_torch.models import nnfme as pnn

    for qp in (22, 27, 32, 37):
        a = np.load(os.path.join(pnn.WEIGHTS_DIR, f"qp{qp}.npz"))
        b = np.load(f"hmtpu/models/weights/qp{qp}.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            eq(a[k], b[k])
        assert pnn.load_npz(os.path.join(
            pnn.WEIGHTS_DIR, f"qp{qp}.npz"), "cpu").packed.numel() \
            == pnn.PACK_SIZE


# ---------------------------------------------------------------------------
# K7: DCT-IF motion compensation

@pytest.mark.parametrize("chroma,n", [(False, 8), (False, 16), (False, 32),
                                      (True, 4), (True, 8), (True, 16)])
def test_mc_batch_refs(chroma, n):
    from hmtpu.ops import interp as ji
    from hmtpu_torch.ops import interp as pi

    rng = np.random.RandomState(n + 50 * chroma)
    R, h, w = 3, 40, 56
    refs = rng.randint(0, 256, (R, h, w)).astype(np.int32)
    B = 200
    ridx = rng.randint(0, R, B).astype(np.int32)
    xs = (rng.randint(0, w // n, B) * n).astype(np.int32)
    ys = (rng.randint(0, h // n, B) * n).astype(np.int32)
    # every phase, negative MVs and MVs that reach past the edges
    span = 4 * (n + 24)
    mvx = rng.randint(-span, span, B).astype(np.int32)
    mvy = rng.randint(-span, span, B).astype(np.int32)
    mvx[:64] = np.arange(64) - 32
    mvy[:64] = (np.arange(64) * 5) % 64 - 32
    jf = ji.mc_chroma_batch_refs if chroma else ji.mc_luma_batch_refs
    pf = pi.mc_chroma_batch_refs if chroma else pi.mc_luma_batch_refs
    want = jf(jnp.asarray(refs), jnp.asarray(ridx), jnp.asarray(xs),
              jnp.asarray(ys), jnp.asarray(mvx), jnp.asarray(mvy), n, n, 8)
    got = pf(tt(refs), tt(ridx), tt(xs), tt(ys), tt(mvx), tt(mvy), n, n, 8)
    assert got.dtype == torch.int32 and got.shape == (B, n, n)
    eq(got, want)
    # the one-plane wrappers
    jf1 = ji.mc_chroma_batch if chroma else ji.mc_luma_batch
    pf1 = pi.mc_chroma_batch if chroma else pi.mc_luma_batch
    want1 = jf1(jnp.asarray(refs[1]), jnp.asarray(xs), jnp.asarray(ys),
                jnp.asarray(mvx), jnp.asarray(mvy), n, n, 8)
    eq(pf1(tt(refs[1]), tt(xs), tt(ys), tt(mvx), tt(mvy), n, n, 8), want1)


# ---------------------------------------------------------------------------
# K8: SATD

@pytest.mark.parametrize("n", [8, 16, 32])
def test_satd_batch(n):
    from hmtpu.search import me as jme
    from hmtpu_torch.search import me as pme

    rng = np.random.RandomState(n)
    a = rng.randint(0, 256, (90, n, n)).astype(np.int32)
    b = np.clip(a + rng.randint(-40, 41, a.shape), 0, 255).astype(np.int32)
    b[:5] = rng.randint(0, 256, (5, n, n))
    want = jme.satd_batch(jnp.asarray(a), jnp.asarray(b), n)
    got = pme.satd_batch(tt(a), tt(b), n)
    assert got.dtype == torch.int32
    eq(got, want)


# ---------------------------------------------------------------------------
# B10: merge / AMVP / temporal candidates

def _nb_field(rng, B, nref=4):
    valid = rng.rand(B, 5) < 0.7
    mvx = rng.choice([-9, -4, 0, 3, 12], (B, 5)).astype(np.int32)
    mvy = rng.choice([-6, 0, 2, 7], (B, 5)).astype(np.int32)
    ref = rng.randint(0, nref, (B, 5)).astype(np.int32)
    return valid, mvx, mvy, ref


@pytest.mark.parametrize("tmvp,n_active", [(False, None), (True, 2),
                                           (True, 4)])
def test_merge_candidates(tmvp, n_active):
    from hmtpu.search import wavefront as jw
    from hmtpu_torch.search import wavefront as pw

    rng = np.random.RandomState(3 + int(tmvp) + (n_active or 0))
    B = 600
    v, mx, my, rf = _nb_field(rng, B)
    kw_j, kw_p = {}, {}
    if tmvp:
        tok = rng.rand(B) < 0.6
        tx = rng.randint(-20, 21, B).astype(np.int32)
        ty = rng.randint(-20, 21, B).astype(np.int32)
        kw_j = dict(t_ok=jnp.asarray(tok), t_mvx=jnp.asarray(tx),
                    t_mvy=jnp.asarray(ty))
        kw_p = dict(t_ok=tt(tok), t_mvx=tt(tx), t_mvy=tt(ty))
    for max_merge in (5, 3):
        want = jw.merge_candidates_dev(
            jnp.asarray(v), jnp.asarray(mx), jnp.asarray(my),
            jnp.asarray(rf), 4, max_merge,
            n_active=None if n_active is None else jnp.int32(n_active),
            **kw_j)
        got = pw.merge_candidates_dev(tt(v), tt(mx), tt(my), tt(rf), 4,
                                      max_merge, n_active=n_active, **kw_p)
        for g, wv in zip(got, want):
            eq(g, wv)


@pytest.mark.parametrize("tmvp", [False, True])
def test_amvp_candidates(tmvp):
    from hmtpu.search import wavefront as jw
    from hmtpu_torch.search import wavefront as pw

    rng = np.random.RandomState(21 + tmvp)
    B = 600
    v, mx, my, _ = _nb_field(rng, B)
    pocs = np.array([7, 6, 3, 2], np.int32)
    nb_refpoc = pocs[rng.randint(0, 4, (B, 5))]
    target = pocs[rng.randint(0, 4, B)]
    kw_j, kw_p = {}, {}
    if tmvp:
        tok = rng.rand(B) < 0.5
        tx = rng.randint(-30, 31, B).astype(np.int32)
        ty = rng.randint(-30, 31, B).astype(np.int32)
        kw_j = dict(t_ok=jnp.asarray(tok), t_mvx=jnp.asarray(tx),
                    t_mvy=jnp.asarray(ty))
        kw_p = dict(t_ok=tt(tok), t_mvx=tt(tx), t_mvy=tt(ty))
    want = jw.amvp_candidates_dev(
        jnp.asarray(v), jnp.asarray(mx * 13), jnp.asarray(my * 11),
        jnp.asarray(nb_refpoc), jnp.asarray(target), 8, **kw_j)
    got = pw.amvp_candidates_dev(tt(v), tt(mx * 13), tt(my * 11),
                                 tt(nb_refpoc), tt(target), 8, **kw_p)
    for g, wv in zip(got, want):
        eq(g, wv)


@pytest.mark.parametrize("n,padded", [(8, False), (16, False), (32, True)])
def test_temporal_candidates_and_scaling(n, padded):
    from hmtpu.search import wavefront as jw
    from hmtpu_torch.search import wavefront as pw

    rng = np.random.RandomState(n)
    h, w = 80, 112
    bh, bw = h // 8, w // 8
    cmx = rng.randint(-40, 41, (bh, bw)).astype(np.int32)
    cmy = rng.randint(-40, 41, (bh, bw)).astype(np.int32)
    cok = rng.rand(bh, bw) < 0.7
    crp = rng.choice([0, 1, 2, 5], (bh, bw)).astype(np.int32)
    kw = dict(gw=(w // 16 + 1) // 2, gh=(h // 16 + 1) // 2) if padded \
        else {}
    want = jw.temporal_cand_grid_dev(jnp.asarray(cmx), jnp.asarray(cmy),
                                     jnp.asarray(cok), jnp.asarray(crp), n,
                                     w, h, 6, **kw)
    got = pw.temporal_cand_grid_dev(tt(cmx), tt(cmy), tt(cok), tt(crp), n,
                                    w, h, 6, **kw)
    for g, wv in zip(got, want):
        eq(g, wv)
    # 8.5.3.2.8 scaling from the col distance to the target distances
    td = 6 - np.asarray(want[3])
    for tb in (1, 3, -2):
        wx, wy = jw.scale_mv_pair_dev(want[1], want[2], jnp.int32(tb),
                                      jnp.asarray(td))
        gx, gy = pw.scale_mv_pair_dev(got[1], got[2], torch.tensor(tb),
                                      tt(td))
        eq(gx, wx)
        eq(gy, wy)
    vx = rng.randint(-300, 301, 500).astype(np.int32)
    vy = rng.randint(-300, 301, 500).astype(np.int32)
    eq(pw.mv_bits_dev(tt(vx), tt(vy)),
       jw.mv_bits_dev(jnp.asarray(vx), jnp.asarray(vy)))


# ---------------------------------------------------------------------------
# the inter rate helpers

@pytest.mark.parametrize("qp", [22, 37])
def test_inter_rate_helpers(qp):
    from hmtpu.ops import ratebits as jr
    from hmtpu_torch.ops import ratebits as pr

    jc, pc = cbflat(qp)
    rng = np.random.RandomState(qp)
    B = 400
    v = rng.randint(0, 2, B).astype(np.int32)
    inc = rng.randint(0, 3, B).astype(np.int32)
    eq(pr.skip_flag_bits(pc, tt(v), tt(inc)),
       jr.skip_flag_bits(jc, jnp.asarray(v), jnp.asarray(inc)))
    for f in ("merge_flag_bits", "pred_mode_bits", "mvp_idx_bits",
              "rqt_root_cbf_bits"):
        eq(getattr(pr, f)(pc, tt(v)), getattr(jr, f)(jc, jnp.asarray(v)))
    for mm in (1, 2, 5):
        mi = rng.randint(0, mm, B).astype(np.int32)
        eq(pr.merge_idx_bits(pc, tt(mi), mm),
           jr.merge_idx_bits(jc, jnp.asarray(mi), mm))
    r = rng.randint(0, 4, B).astype(np.int32)
    for nr in (1, 2, 3, 4):
        eq(pr.ref_idx_bits(pc, tt(np.minimum(r, nr - 1)), nr),
           jr.ref_idx_bits(jc, jnp.asarray(np.minimum(r, nr - 1)), nr))
        for na in range(1, nr + 1):
            rr = np.minimum(r, na - 1)
            eq(pr.ref_idx_bits(pc, tt(rr), nr, n_active=na),
               jr.ref_idx_bits(jc, jnp.asarray(rr), nr,
                               n_active=jnp.int32(na)))
    dx = rng.randint(-700, 701, B).astype(np.int32)
    dy = rng.choice([-2, -1, 0, 1, 2, 90], B).astype(np.int32)
    eq(pr.mvd_bits(pc, tt(dx), tt(dy)),
       jr.mvd_bits(jc, jnp.asarray(dx), jnp.asarray(dy)))


# ---------------------------------------------------------------------------
# the rate estimate and RDOQ above 512 bits per TB

@pytest.mark.parametrize("log2", [4, 5])
def test_tb_bits_and_rdoq_above_512_bits(log2):
    """Large inter TBs at QP 22, as the P path prices them.  The port
    sums each part of the estimate exactly (float64, rounded once);
    hmtpu sums in float32, exact only below 512 bits per part.  16x16
    TBs agree exactly however large; 32x32 TBs above ~1000 bits may
    differ by the rounding of one float32 partial sum (measured at most
    2^-10 bits at ~9400 bits).  RDOQ's levels agree."""
    from hmtpu.ops import ratebits as jr
    from hmtpu.ops import rdoq as jq
    from hmtpu_torch.ops import ratebits as pr
    from hmtpu_torch.ops import rdoq as pq

    jc, pc = cbflat(22)
    n = 1 << log2
    rng = np.random.RandomState(log2)
    yy, xx = np.mgrid[0:n, 0:n]
    lev = np.round(rng.randn(48, n, n) * 60 / (1 + 0.3 * (xx + yy))) \
        .astype(np.int32)
    want = np.asarray(jr.tb_bits(jnp.asarray(lev), jc, log2, True, 0, True))
    got = pr.tb_bits(tt(lev), pc, log2, True, 0, True).numpy()
    assert (want > 512).all()
    if log2 == 4:
        eq(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=np.float32(2.0 ** -9))
        # the parts are exact in the port: every value is a multiple of
        # 2^-15, so the float64 sum rounds once to the nearest float32
        assert (np.abs(got - want) <= np.spacing(want) * 2).all()

    lam = lambdas.frame_lambdas(22, 22, 0.4624)[0]
    coef = np.round(rng.randn(24, n, n) * 4000 / (1 + 0.5 * (xx + yy))) \
        .astype(np.int32)
    jl = jq.rdoq_tb(jnp.asarray(coef), jnp.int32(22), log2, 8,
                    jnp.float32(lam), jc, True, sdh=True)
    pl = pq.rdoq_tb(tt(coef), 22, log2, 8, torch.tensor(lam), pc, True,
                    sdh=True)
    assert (np.asarray(jr.tb_bits(jl, jc, log2, True, 0, True)) > 512).any()
    eq(pl, jl)
