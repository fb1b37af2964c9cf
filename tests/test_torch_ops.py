"""hmtpu_torch ops against hmtpu: the same seeded numpy inputs through
the JAX function (on the CPU) and through the port with CPU tensors,
which run each kernel's plain PyTorch version.

Integer outputs (transform, quant, prediction, deblocking, SAO, RDOQ
levels) must be equal.  Float outputs carry their tolerance where they
are compared.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmtpu.common.constants import SliceType
from hmtpu.entropy.contexts import make_contexts
from hmtpu.entropy.fracbits import ctx_bits_table
from hmtpu_torch.common import lambdas
from hmtpu_torch.common.constants import SliceType as TSliceType
from hmtpu_torch.entropy.contexts import make_contexts as t_make_contexts
from hmtpu_torch.entropy.fracbits import ctx_bits_table as t_ctx_bits_table
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


def cbflat_pair(qp):
    """The fractional-bits table from each package's own copy of the
    context tables; the two must be equal."""
    ref = ctx_bits_table(make_contexts(SliceType.I, qp)).reshape(-1)
    port = t_ctx_bits_table(t_make_contexts(TSliceType.I, qp)).reshape(-1)
    np.testing.assert_array_equal(ref, port)
    return jnp.asarray(ref), torch.as_tensor(port)


def coefs(rng, log2, n, mag):
    """Plausible transform coefficients: low-frequency heavy."""
    size = 1 << log2
    yy, xx = np.mgrid[0:size, 0:size]
    c = rng.randn(n, size, size) * mag / (1.0 + 0.6 * (xx + yy))
    return np.round(c).astype(np.int32)


# ---------------------------------------------------------------------------
# float32 lambdas: the port's tables hold the reference's values

def test_lambda_tables_match_reference():
    @jax.jit
    def ref(qp, qpc, f):
        lam = f * jnp.power(2.0, (qp - 12) / 3.0).astype(jnp.float32)
        w = jnp.exp2((qp - qpc).astype(jnp.float32) / 3.0)
        return lam, jnp.sqrt(lam), w, lam / w

    for f in (0.57,):
        for qp in range(52):
            for qpc in range(max(qp - 12, 0), qp + 1):
                want = [np.asarray(x) for x in ref(
                    jnp.int32(qp), jnp.int32(qpc), jnp.float32(f))]
                got = lambdas.frame_lambdas(qp, qpc, f)
                for g, w in zip(got, want):
                    assert g.dtype == np.float32
                    assert g == w, (qp, qpc, g, w)

    exp2 = jax.jit(lambda k: jnp.exp2(k.astype(jnp.float32)))
    for k in range(48):
        assert lambdas.exp2_int(k) == np.asarray(exp2(jnp.int32(k))), k


# ---------------------------------------------------------------------------
# K1: transform

@pytest.mark.parametrize("n,dst", [(4, False), (4, True), (8, False),
                                   (16, False), (32, False)])
@pytest.mark.parametrize("inverse", [False, True])
def test_transform(n, dst, inverse):
    from hmtpu.ops import transform as jt
    from hmtpu_torch.ops import transform as pt

    rng = np.random.RandomState(n + 2 * dst + 4 * inverse)
    if inverse:
        x = rng.randint(-(1 << 15), 1 << 15, (24, n, n))
        want = jt.inverse_transform(jnp.asarray(x, jnp.int32), n,
                                    use_dst=dst)
        got = pt.inverse_transform(tt(x), n, use_dst=dst)
    else:
        x = rng.randint(-255, 256, (24, n, n))
        want = jt.forward_transform(jnp.asarray(x, jnp.int32), n,
                                    use_dst=dst)
        got = pt.forward_transform(tt(x), n, use_dst=dst)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# quant / dequant

@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_quant_dequant(log2):
    from hmtpu.ops import quant as jq
    from hmtpu_torch.ops import quant as pq

    rng = np.random.RandomState(log2)
    c = coefs(rng, log2, 16, 4000.0)
    for qp in (22, 37):
        for intra in (True, False):
            want = jq.quantize_t(jnp.asarray(c), jnp.int32(qp), log2,
                                 8, intra)
            got = pq.quantize_t(tt(c), qp, log2, 8, intra)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        want = jq.dequantize_t(want, jnp.int32(qp), log2, 8)
        got = pq.dequantize_t(got, qp, log2, 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# rate estimation

@pytest.mark.parametrize("log2,is_luma,scan_idx,sdh", [
    (2, False, 0, False), (2, True, 1, True), (3, True, 2, True),
    (3, False, 0, False), (4, True, 0, True), (5, True, 0, False)])
def test_tb_bits(log2, is_luma, scan_idx, sdh):
    from hmtpu.ops.ratebits import tb_bits as j_tb_bits
    from hmtpu.ops.quant import quantize_np
    from hmtpu_torch.ops.ratebits import tb_bits

    rng = np.random.RandomState(10 * log2 + scan_idx)
    lev = quantize_np(coefs(rng, log2, 40, 900.0), 27, log2, 8)
    lev[::7] = 0                               # all-zero TBs cost 0.0
    jcb, pcb = cbflat_pair(27)
    want = np.asarray(jax.jit(partial(
        j_tb_bits, log2=log2, is_luma=is_luma, scan_idx=scan_idx,
        sdh=sdh))(jnp.asarray(lev), jcb))
    got = tb_bits(tt(lev), pcb, log2, is_luma, scan_idx, sdh).numpy()
    assert got.dtype == np.float32 and (got[::7] == 0).all()
    # Every priced bin is a multiple of 2^-15, so a float32 sum is exact
    # while the total stays below 2^9 bits: there the two must be equal.
    # Above it hmtpu's float32 accumulation (in XLA's order) rounds,
    # while the port sums exactly and rounds once: they may differ by
    # the float32 accumulation error of the sum, bounded here by
    # n_terms * 2^-24 relative (n_terms <= 3 * 1024 + 64 per TB).
    small = want < 512
    np.testing.assert_array_equal(got[small], want[small])
    np.testing.assert_allclose(got, want, rtol=(3 * 1024 + 64) * 2.0 ** -24,
                               atol=0)


def test_flag_bits():
    from hmtpu.ops import ratebits as jr
    from hmtpu_torch.ops import ratebits as pr

    jcb, pcb = cbflat_pair(32)
    rng = np.random.RandomState(5)
    mode = rng.randint(0, 35, 64)
    lm, am = rng.randint(0, 35, 64), rng.randint(0, 35, 64)
    am[::3] = lm[::3]
    flag = rng.randint(0, 2, 64).astype(bool)
    ctx = rng.randint(0, 3, 64)
    pairs = [
        (jr.intra_mode_mpm_bits(jcb, jnp.asarray(mode), jnp.asarray(lm),
                                jnp.asarray(am)),
         pr.intra_mode_mpm_bits(pcb, tt(mode), tt(lm), tt(am))),
        (jr.cbf_luma_bits(jcb, jnp.asarray(flag)),
         pr.cbf_luma_bits(pcb, torch.as_tensor(flag))),
        (jr.cbf_luma_bits(jcb, jnp.asarray(flag), False),
         pr.cbf_luma_bits(pcb, torch.as_tensor(flag), False)),
        (jr.cbf_chroma_bits(jcb, jnp.asarray(flag)),
         pr.cbf_chroma_bits(pcb, torch.as_tensor(flag))),
        (jr.split_flag_bits(jcb, jnp.asarray(flag), jnp.asarray(ctx)),
         pr.split_flag_bits(pcb, torch.as_tensor(flag), tt(ctx))),
        (jr.chroma_dm_bits(jcb), pr.chroma_dm_bits(pcb)),
        (jr.part_size_2nx2n_bits(jcb), pr.part_size_2nx2n_bits(pcb)),
        (jr.part_size_nxn_bits(jcb), pr.part_size_nxn_bits(pcb)),
    ]
    # table lookups and sums of at most three entries, exact in float32
    for want, got in pairs:
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# RDOQ

@pytest.mark.parametrize("log2,is_luma,sdh", [
    (2, False, True), (2, True, False), (3, True, True), (3, False, False),
    (4, True, True), (5, True, True)])
def test_rdoq_levels(log2, is_luma, sdh):
    from hmtpu.ops.rdoq import rdoq_tb as j_rdoq
    from hmtpu_torch.ops.rdoq import rdoq_tb

    rng = np.random.RandomState(100 + 10 * log2 + is_luma)
    c = coefs(rng, log2, 32, 600.0 if log2 > 2 else 250.0)
    scan_sel = rng.randint(0, 3, 32) if log2 <= 3 else None
    ref = jax.jit(partial(j_rdoq, log2=log2, bd=8, is_luma=is_luma,
                          sdh=sdh),
                  static_argnames=())
    for qp in (22, 37):
        jcb, pcb = cbflat_pair(qp)
        lam, _, w, lam_c = lambdas.frame_lambdas(qp, qp - 1, 0.57)
        lam = lam if is_luma else lam_c
        kw = {} if scan_sel is None else dict(scan_sel=scan_sel)
        want = np.asarray(ref(
            jnp.asarray(c), jnp.int32(qp), lam=jnp.float32(lam),
            cbflat=jcb, **{k: jnp.asarray(v, jnp.int32)
                           for k, v in kw.items()}))
        got = rdoq_tb(tt(c), qp, log2, 8, torch.tensor(lam), pcb,
                      is_luma, sdh=sdh,
                      **{k: tt(v) for k, v in kw.items()})
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# K2: intra prediction

def _ref_lines(rng, b, n):
    """Reference lines: half random, half smooth ramps (which take the
    strong bilinear filter at n == 32)."""
    line = 4 * n + 1
    out = rng.randint(0, 256, (b, line))
    lo, hi = rng.randint(60, 200, (2, b // 2))
    ramp = np.linspace(0, 1, line)[None]
    out[: b // 2] = np.round(lo[:, None] + (hi - lo)[:, None] * ramp)
    return out.astype(np.int32)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_intra_prediction(n):
    from hmtpu.ops import intra_pred as ji
    from hmtpu_torch.ops import intra_pred as pi

    rng = np.random.RandomState(n)
    b = 12
    ref = _ref_lines(rng, b, n)
    for strong in (False, True):
        want_f = np.asarray(ji.filter_reference_batched(
            jnp.asarray(ref), n, 8, strong))
        got_f = pi.filter_reference_batched(tt(ref), n, 8, strong)
        np.testing.assert_array_equal(got_f.numpy(), want_f)
    if n == 32:             # both outcomes of the bilinear test occur
        assert (want_f != np.asarray(ji.filter_reference_batched(
            jnp.asarray(ref), n, 8, False))).any()
    modes = rng.randint(0, 35, b)
    for is_luma in (True, False):
        want = np.asarray(ji.predict_all_modes(
            jnp.asarray(ref), jnp.asarray(want_f), n, is_luma))
        got = pi.predict_all_modes(tt(ref), tt(want_f), n, is_luma)
        np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(ji.predict_one_mode(
            jnp.asarray(ref), jnp.asarray(want_f), jnp.asarray(modes), n,
            is_luma))
        got = pi.predict_one_mode(tt(ref), tt(want_f), tt(modes), n,
                                  is_luma)
        np.testing.assert_array_equal(got.numpy(), want)


def test_satd():
    from hmtpu.encoder import intra_rdo as jr
    from hmtpu_torch.encoder import intra_rdo as pr

    rng = np.random.RandomState(8)
    for n in (8, 16, 32):
        r = rng.randint(-255, 256, (6, n, n)).astype(np.int32)
        np.testing.assert_array_equal(pr._satd(tt(r)).numpy(),
                                      np.asarray(jr._satd(jnp.asarray(r))))
    from hmtpu.encoder.iframe_dev import _satd4 as j_satd4
    from hmtpu_torch.encoder.intra_rdo import _satd4

    r = rng.randint(-255, 256, (6, 4, 4)).astype(np.int32)
    np.testing.assert_array_equal(_satd4(tt(r)).numpy(),
                                  np.asarray(j_satd4(jnp.asarray(r))))


# ---------------------------------------------------------------------------
# K3: deblocking

def _blocky(rng, h, w, step=8, spread=40, noise=2):
    """A picture of flat 8x8 blocks plus a little noise: edges the
    filter acts on."""
    base = 128 + rng.randint(-spread, spread + 1,
                             (-(-h // step), -(-w // step)))
    pl = np.repeat(np.repeat(base, step, 0), step, 1)[:h, :w]
    pl = pl + rng.randint(-noise, noise + 1, (h, w))
    return np.clip(pl, 0, 255).astype(np.int32)


@pytest.mark.parametrize("h,w", [(64, 64), (48, 80)])
def test_deblock_frame_dev(h, w):
    from hmtpu.ops.deblock import deblock_frame_dev as j_deblock
    from hmtpu_torch.ops.deblock import deblock_frame_dev

    rng = np.random.RandomState(h + w)
    y = _blocky(rng, h, w, spread=6)
    u = _blocky(rng, h // 2, w // 2, spread=6)
    v = _blocky(rng, h // 2, w // 2, spread=6)
    h4, w4 = h // 4, w // 4
    intra4 = rng.rand(h4, w4) < 0.5
    cbf4 = rng.rand(h4, w4) < 0.5
    mvx = rng.randint(-8, 9, (2, h4, w4))
    mvy = rng.randint(-8, 9, (2, h4, w4))
    rpoc = rng.randint(-1, 3, (2, h4, w4))
    int_v = rng.rand(h // 8, w // 8 - 1) < 0.3
    int_h = rng.rand(h // 8 - 1, w // 8) < 0.3
    ref = jax.jit(j_deblock)                   # qp traced, as in the pass
    for qp in (22, 37):
        want = ref(*(jnp.asarray(a, jnp.int32) for a in (y, u, v)),
                   jnp.asarray(intra4), jnp.asarray(cbf4),
                   *(jnp.asarray(a, jnp.int32) for a in (mvx, mvy, rpoc)),
                   jnp.int32(qp), int_v=jnp.asarray(int_v),
                   int_h=jnp.asarray(int_h))
        got = deblock_frame_dev(tt(y), tt(u), tt(v),
                                torch.as_tensor(intra4),
                                torch.as_tensor(cbf4), tt(mvx), tt(mvy),
                                tt(rpoc), qp, int_v=torch.as_tensor(int_v),
                                int_h=torch.as_tensor(int_h))
        for g, wnt, org in zip(got, want, (y, u, v)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
        assert (got[0].numpy() != y).any()


# ---------------------------------------------------------------------------
# K4: SAO

@pytest.mark.parametrize("h,w,ctu", [(64, 64, 32), (48, 80, 64)])
def test_sao_frame_dev(h, w, ctu):
    from hmtpu.ops.sao import sao_frame_dev as j_sao
    from hmtpu_torch.ops.sao import sao_frame_dev

    rng = np.random.RandomState(h * w)
    planes = []
    for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        org = _blocky(rng, hh, ww, step=4, spread=30, noise=6)
        bias = rng.randint(-3, 4, org.shape)
        rec = np.clip(org + bias + (org > 140) * 3, 0, 255)
        planes += [org.astype(np.int32), rec.astype(np.int32)]
    for qp in (22, 37):
        lam = lambdas.frame_lambdas(qp, qp, 0.57)[0]
        want = jax.jit(partial(j_sao, ctu=ctu, bd=8))(
            *(jnp.asarray(p) for p in planes), lam=jnp.float32(lam))
        got = sao_frame_dev(*(tt(p) for p in planes), ctu,
                            torch.tensor(lam), 8)
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
        assert (got[3][..., 0] > 0).any()          # SAO switched on
