"""The third slice's ops of hmtpu_torch against hmtpu on the CPU: the
transform-skip shifts (the plain versions of K1's TS mode), the transform_skip_flag price, the
RDOQ + TB-rate step of `_code` (K10's plain version) on 4x4 TS and DCT
TBs and on larger DCT TBs, and HM's DCT-IF sub-pel search (K9's plain
version).  Inputs are made by numpy from a seed and go through both
packages; each check states its tolerance (all exact)."""
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
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tt(a):
    return torch.as_tensor(np.array(a, np.int32))


def eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_transform_skip_shifts():
    """fwd = resi << ts_shift, inv = rounding bdShift stage with the
    16-bit clip: equal to hmtpu's on every value, the clip included."""
    from hmtpu.ops import transform as jt
    from hmtpu_torch.ops import transform as pt

    assert pt.ts_shift(4, 8) == jt.ts_shift(4, 8) == 5
    assert pt.ts_shift(4, 10) == jt.ts_shift(4, 10)
    rng = np.random.RandomState(0)
    resi = rng.randint(-255, 256, (64, 4, 4)).astype(np.int32)
    # the plain versions of K1's TS mode (its level forms hold the card to
    # them; the level forms' TS coefficients are these shifts)
    eq(pt.transform_skip_fwd_plain(tt(resi), 4, 8),
       jt.transform_skip_fwd(jnp.asarray(resi), 4, 8))
    eq(pt.fwd_level_plain([tt(resi)], [tt(np.zeros_like(resi))], 8,
                          ts=True)[1][0],
       jt.transform_skip_fwd(jnp.asarray(resi), 4, 8))
    deq = rng.randint(-32768, 32768, (64, 4, 4)).astype(np.int32)
    got = pt.transform_skip_inv_plain(tt(deq), 4, 8)
    assert got.dtype == torch.int32
    eq(got, jt.transform_skip_inv(jnp.asarray(deq), 4, 8))


def test_ts_flag_bits():
    from hmtpu.ops import ratebits as jr
    from hmtpu_torch.ops import ratebits as pr

    for st in (SliceType.I, SliceType.P):
        cb = ctx_bits_table(make_contexts(st, 27)).reshape(-1)
        for luma in (True, False):
            v = np.array([0, 1, 1, 0], np.int32)
            eq(pr.ts_flag_bits(torch.as_tensor(cb), tt(v), luma),
               jr.ts_flag_bits(jnp.asarray(cb), jnp.asarray(v), luma))


def _residual(rng, b, n, screen):
    """Camera-like residual (smooth, small) or screen-like residual
    (sparse sharp steps, where transform skip wins)."""
    if screen:
        r = np.zeros((b, n, n), np.int32)
        r[:, rng.randint(0, n, b), :] = rng.randint(-180, 181, (b, 1, n))
        return r
    yy, xx = np.mgrid[0:n, 0:n]
    r = rng.randn(b, n, n) * 30 + 10 * np.sin(xx / 2.0 + yy / 3.0)
    return np.round(r).astype(np.int32)


@pytest.mark.parametrize("log2,ts,is_luma,trellis,sdh", [
    (2, True, False, True, True), (2, True, True, True, False),
    (2, True, False, False, True), (2, False, False, True, True),
    (2, False, True, False, False), (3, False, True, True, True),
    (5, False, True, True, True)])
def test_rdoq_code_matches_hmtpu(log2, ts, is_luma, trellis, sdh):
    """The coding step of `_code` (rdoq_tb, dequantize_t and tb_bits of
    the levels with the SDH sign rule): levels and dequantised values
    exact; bits bit for bit below 512 bits, where hmtpu's float32 sums
    are exact, and within queue C's two float32 spacings above."""
    from hmtpu.ops.quant import dequantize_t as j_deq
    from hmtpu.ops.ratebits import tb_bits as j_bits
    from hmtpu.ops.rdoq import rdoq_tb as j_rdoq
    from hmtpu.ops.transform import forward_transform, transform_skip_fwd
    from hmtpu_torch.ops.rdoq import rdoq_code

    n = 1 << log2
    rng = np.random.RandomState(10 * log2 + 2 * ts + is_luma)
    b = 48 if log2 == 2 else 12
    resi = np.concatenate([_residual(rng, b // 2, n, True),
                           _residual(rng, b - b // 2, n, False)])
    coef = np.asarray(transform_skip_fwd(jnp.asarray(resi), n, 8) if ts
                      else forward_transform(jnp.asarray(resi), n, 8,
                                             use_dst=is_luma and n == 4))
    sel = rng.randint(0, 3, b).astype(np.int32) if log2 <= 3 else None
    ref = jax.jit(partial(j_rdoq, log2=log2, bd=8, is_luma=is_luma,
                          sdh=sdh, trellis=trellis))
    for qp in (22, 37):
        cb = ctx_bits_table(make_contexts(SliceType.P, qp)).reshape(-1)
        lam, _, _, lam_c = lambdas.frame_lambdas(qp, qp - 1, 0.4624)
        lam = np.float32(lam if is_luma else lam_c)
        kw = {} if sel is None else dict(scan_sel=jnp.asarray(sel))
        want = np.asarray(ref(jnp.asarray(coef), jnp.int32(qp),
                              lam=jnp.float32(lam), cbflat=jnp.asarray(cb),
                              **kw))
        lev, deq, bits = rdoq_code(
            tt(coef), qp, log2, 8, torch.tensor(lam), torch.as_tensor(cb),
            is_luma, sdh=sdh, trellis=trellis,
            scan_sel=None if sel is None else tt(sel))
        eq(lev, want)
        eq(deq, j_deq(jnp.asarray(want), jnp.int32(qp), log2, 8))
        jb = np.asarray(j_bits(jnp.asarray(want), jnp.asarray(cb), log2,
                               is_luma, 0, sdh))
        if (jb < 512).all():
            eq(bits.numpy().view(np.int32), jb.view(np.int32))
        else:
            # above 512 bits hmtpu's float32 part sums round; the port's
            # are exact (ROADMAP.md queue C): two float32 spacings at most
            assert (np.abs(bits.numpy() - jb) <= 2 * np.spacing(jb)).all()
        assert (want != 0).any()


@pytest.mark.parametrize("n", [8, 16, 32])
def test_frac_refine_batch(n):
    """HM's two-stage DCT-IF search over a 4-reference stack with a
    per-block reference: quarter-pel MVs equal to hmtpu's.  Block 0 is
    flat against a flat reference region, so all 9 candidates of both
    stages tie and the centre (the integer MV) must win."""
    from hmtpu.search.me import frac_refine_batch as j_frac
    from hmtpu_torch.search.me import frac_refine_batch

    rng = np.random.RandomState(n)
    R, h, w = 4, 96, 128
    yy, xx = np.mgrid[0:h, 0:w]
    refs = np.stack([np.clip(128 + 60 * np.sin(xx / (5.0 + r) + yy / 7.0)
                             + rng.randn(h, w) * 4, 0, 255)
                     for r in range(R)]).astype(np.int32)
    refs[:, :48, :48] = 90
    gw, gh = w // n, h // n
    q = np.arange(gw * gh)
    xs, ys = ((q % gw) * n).astype(np.int32), ((q // gw) * n).astype(np.int32)
    ridx = rng.randint(0, R, q.size).astype(np.int32)
    mvx = rng.randint(-6, 7, q.size).astype(np.int32)
    mvy = rng.randint(-6, 7, q.size).astype(np.int32)
    # block 0 stays inside the flat region; the last blocks reach past
    # the picture's edges
    mvx[0] = mvy[0] = 2
    mvx[-3:], mvy[-3:] = 20, 13
    org = np.stack([refs[r, y:y + n, x:x + n]
                    for r, x, y in zip(ridx, xs, ys)])
    org = np.clip(org + rng.randint(-3, 4, org.shape), 0, 255)
    org[0] = 90
    want = j_frac(jnp.asarray(refs), jnp.asarray(xs), jnp.asarray(ys),
                  jnp.asarray(org), jnp.asarray(mvx), jnp.asarray(mvy), n,
                  8, ridx=jnp.asarray(ridx))
    got = frac_refine_batch(tt(refs), tt(xs), tt(ys), tt(org), tt(mvx),
                            tt(mvy), n, 8, ridx=tt(ridx))
    eq(got[0], want[0])
    eq(got[1], want[1])
    assert int(got[0][0]) == 4 * mvx[0] and int(got[1][0]) == 4 * mvy[0]
    # the search moves most blocks off the integer grid
    assert (got[0].numpy() != 4 * mvx).any()
