"""The random-access (B-slice) ops of hmtpu_torch against hmtpu: the same
seeded numpy inputs through the JAX function (on the CPU) and through the
port with CPU tensors, which run each kernel's plain PyTorch version:

  - K11 `mc_dctif_i` (`_mc_batch_jax_i` through `mc_luma_batch_refs_i`
    and `mc_chroma_batch_refs_i`): luma and chroma at bit depths 8 and
    10, every phase (copy, H-only, V-only, both), MVs past the edges;
  - K12 `bi_pred`: `bi_average_t`, and the merge screening select of
    `merge_b_nxn` (bi-average where the candidate is bi, else the
    approximate final samples of the hypothesis in use);
  - the B-slice merge and AMVP candidate lists (B15) over every
    combination of the five neighbours' prediction directions;
  - the random-access coding schedule;
  - the Main10 traps: the 10-bit quantiser (Qp' = qp + 12) reads 2^qbits
    only inside the checked float32 table, and the coding step (K10's
    plain version: RDOQ, dequantisation, TB rate) and SAO (offsets up to
    31) equal hmtpu's at 10 bits.

Every integer output must be equal; the TB rate bit for bit below 512
bits (hmtpu's float32 sums are exact there).
"""
import itertools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


# ---------------------------------------------------------------------------
# K11: intermediate-precision DCT-IF MC

@pytest.mark.parametrize("chroma,n,bd", [(False, 8, 8), (False, 16, 10),
                                         (False, 32, 10), (True, 4, 10),
                                         (True, 8, 8), (True, 16, 10)])
def test_mc_batch_refs_i(chroma, n, bd):
    from hmtpu.ops import interp as ji
    from hmtpu_torch.ops import interp as pi

    rng = np.random.RandomState(n + 50 * chroma + bd)
    R, h, w = 3, 40, 56
    refs = rng.randint(0, 1 << bd, (R, h, w)).astype(np.int32)
    B = 160
    ridx = rng.randint(0, R, B).astype(np.int32)
    xs = (rng.randint(0, w // n, B) * n).astype(np.int32)
    ys = (rng.randint(0, h // n, B) * n).astype(np.int32)
    # every phase pair (copy, H-only, V-only, both), negative MVs and
    # MVs that reach past the edges
    span = 4 * (n + 24)
    mvx = rng.randint(-span, span, B).astype(np.int32)
    mvy = rng.randint(-span, span, B).astype(np.int32)
    ph = 8 if chroma else 4
    grid = np.array([(x, y) for y in range(ph) for x in range(ph)])
    mvx[:len(grid)] = grid[:, 0] - 2 * ph
    mvy[:len(grid)] = grid[:, 1] + ph
    jf = ji.mc_chroma_batch_refs_i if chroma else ji.mc_luma_batch_refs_i
    pf = pi.mc_chroma_batch_refs_i if chroma else pi.mc_luma_batch_refs_i
    want = jf(jnp.asarray(refs), jnp.asarray(ridx), jnp.asarray(xs),
              jnp.asarray(ys), jnp.asarray(mvx), jnp.asarray(mvy), n, n, bd)
    got = pf(tt(refs), tt(ridx), tt(xs), tt(ys), tt(mvx), tt(mvy), n, n, bd)
    assert got.dtype == torch.int32 and got.shape == (B, n, n)
    eq(got, want)
    assert int(got.min()) < 0          # the hypotheses are offset-centred


# ---------------------------------------------------------------------------
# K12: bi-average and the merge screening select

@pytest.mark.parametrize("bd", [8, 10])
def test_bi_pred(bd):
    from hmtpu.ops import interp as ji
    from hmtpu_torch.ops import interp as pi

    rng = np.random.RandomState(bd)
    B, M, n = 40, 5, 8
    lo, hi = -(8192 + 600), (1 << 14) - 8192 + 600   # past both clips
    i0 = rng.randint(lo, hi, (B, M, n, n)).astype(np.int32)
    i1 = rng.randint(lo, hi, (B, M, n, n)).astype(np.int32)
    cdir = rng.randint(1, 4, (B, M)).astype(np.int32)

    # bi_average_t
    eq(pi.bi_average_t(tt(i0[:, 0]), tt(i1[:, 0]), bd),
       ji.bi_average_t(jnp.asarray(i0[:, 0]), jnp.asarray(i1[:, 0]), bd))

    # merge_b_nxn's pred_l (hmtpu/encoder/pframe_dev.py:292, :440-444)
    headroom = 14 - bd

    def apx_uni(i):
        return jnp.clip((i + 8192 + (1 << (headroom - 1))) >> headroom,
                        0, (1 << bd) - 1)

    j0, j1, jd = jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(cdir)
    want = jnp.where((jd == 3)[:, :, None, None],
                     ji.bi_average_t(j0, j1, bd),
                     jnp.where(((jd & 1) > 0)[:, :, None, None],
                               apx_uni(j0), apx_uni(j1)))
    got = pi.bi_pred(tt(i0).reshape(B * M, n, n),
                     tt(i1).reshape(B * M, n, n), tt(cdir).reshape(-1), bd)
    assert got.dtype == torch.int32
    eq(got.reshape(B, M, n, n), want)


# ---------------------------------------------------------------------------
# B15: the two-list merge and AMVP candidates

def _b_field(B):
    """Every combination of the five neighbours' directions (0 = not
    inter or unavailable, 1 = L0, 2 = L1, 3 = bi), each with random
    motion from a small alphabet so that pruning and the combined
    candidates' duplicate check fire."""
    dirs = np.array(list(itertools.product(range(4), repeat=5)), np.int32)
    rng = np.random.RandomState(5)
    reps = -(-B // len(dirs))
    ndir = np.tile(dirs, (reps, 1))[:B]
    sh = ndir.shape
    f = dict(
        valid=ndir > 0, dir=ndir,
        mvx0=rng.choice([-8, 0, 4], sh), mvy0=rng.choice([0, 4], sh),
        ref0=rng.randint(0, 2, sh), mvx1=rng.choice([-8, 0, 4], sh),
        mvy1=rng.choice([0, 4], sh), ref1=rng.randint(0, 2, sh))
    return {k: v.astype(np.int32) if v.dtype != bool else v
            for k, v in f.items()}


@pytest.mark.parametrize("max_merge", [5, 2])
def test_merge_candidates_b(max_merge):
    from hmtpu.search import wavefront as jw
    from hmtpu_torch.search import wavefront as pw

    f = _b_field(2048)
    # list-1 POC 8 equals list-0 entry 1: the combined candidates'
    # identity check fires
    pocs0, pocs1 = np.array([2, 8], np.int32), np.array([8, 16], np.int32)
    args = [f[k] for k in ("valid", "dir", "mvx0", "mvy0", "ref0", "mvx1",
                           "mvy1", "ref1")]
    want = jw.merge_candidates_dev_b(
        *[jnp.asarray(a) for a in args], jnp.asarray(pocs0),
        jnp.asarray(pocs1), 2, 2, max_merge)
    got = pw.merge_candidates_dev_b(*[tt(a) for a in args], tt(pocs0),
                                    tt(pocs1), 2, 2, max_merge)
    for g, wv in zip(got, want):
        assert g.dtype == torch.int32
        eq(g, wv)
    assert (np.asarray(want[0]) == 3).any()


def test_amvp_candidates_b():
    from hmtpu.search import wavefront as jw
    from hmtpu_torch.search import wavefront as pw

    f = _b_field(2048)
    rng = np.random.RandomState(9)
    B = f["dir"].shape[0]
    pocs0, pocs1 = np.array([2, 0], np.int32), np.array([8, 16], np.int32)
    poc0 = pocs0[f["ref0"]]
    poc1 = pocs1[f["ref1"]]
    lx = rng.randint(0, 2, B).astype(np.int32)
    target = np.where(lx == 0, pocs0[rng.randint(0, 2, B)],
                      pocs1[rng.randint(0, 2, B)]).astype(np.int32)
    args = [f["valid"], f["dir"], f["mvx0"] * 13, f["mvy0"] * 11, poc0,
            f["mvx1"] * 7, f["mvy1"] * 5, poc1, lx, target]
    want = jw.amvp_candidates_dev_b(*[jnp.asarray(a) for a in args], 4)
    got = pw.amvp_candidates_dev_b(*[tt(a) for a in args], 4)
    for g, wv in zip(got, want):
        eq(g, wv)


# ---------------------------------------------------------------------------
# the random-access schedule

@pytest.mark.parametrize("n", [1, 5, 9, 17])
def test_ra_schedule(n):
    from hmtpu.encoder.top import Encoder as JEncoder
    from hmtpu.encoder.top import EncoderConfig as JConfig
    from hmtpu_torch.encoder.top import Encoder, EncoderConfig

    want = JEncoder(JConfig(width=96, height=96, gop="ra"))._ra_schedule(n)
    got = Encoder(EncoderConfig(width=96, height=96, gop="ra"),
                  device="cpu")._ra_schedule(n)
    assert got == want


# ---------------------------------------------------------------------------
# Main10: the quantiser, the coding step and SAO at 10 bits

def test_main10_quantiser_steps_inside_the_checked_table():
    """Every 2^qbits the 10-bit quantiser reads (qp 0-51, TBs 4-32) lies
    in `_EXP2_INT`'s range, whose entries tests/test_torch_ops.py holds
    against hmtpu's exp2; qbits are those of hmtpu's rule."""
    from hmtpu_torch.common import lambdas
    from hmtpu_torch.ops import rdoq

    for qp in range(52):
        for log2 in (2, 3, 4, 5):
            qbits = rdoq._quant_params(qp, log2, 10)[0]
            assert qbits == 14 + (qp + 12) // 6 + (15 - 10 - log2)
            assert 0 <= qbits < len(lambdas._EXP2_INT)


@pytest.mark.parametrize("log2,is_luma", [(3, True), (4, False)])
def test_rdoq_code_main10_matches_hmtpu(log2, is_luma):
    from hmtpu.common.constants import SliceType
    from hmtpu.entropy.contexts import make_contexts
    from hmtpu.entropy.fracbits import ctx_bits_table
    from hmtpu.ops.quant import dequantize_t as j_deq
    from hmtpu.ops.ratebits import tb_bits as j_bits
    from hmtpu.ops.rdoq import rdoq_tb as j_rdoq
    from hmtpu.ops.transform import forward_transform
    from hmtpu_torch.common import lambdas
    from hmtpu_torch.ops.rdoq import rdoq_code

    n = 1 << log2
    rng = np.random.RandomState(30 + log2)
    yy, xx = np.mgrid[0:n, 0:n]
    resi = np.round(rng.randn(16, n, n) * 120
                    + 40 * np.sin(xx / 2.0 + yy / 3.0)).astype(np.int32)
    coef = np.asarray(forward_transform(jnp.asarray(resi), n, 10))
    ref = jax.jit(partial(j_rdoq, log2=log2, bd=10, is_luma=is_luma,
                          sdh=True, trellis=True))
    for qp in (22, 37):
        cb = ctx_bits_table(make_contexts(SliceType.B, qp)).reshape(-1)
        lam, _, _, lam_c = lambdas.frame_lambdas(qp, qp - 1, 0.3536)
        lam = np.float32(lam if is_luma else lam_c)
        want = np.asarray(ref(jnp.asarray(coef), jnp.int32(qp),
                              lam=jnp.float32(lam), cbflat=jnp.asarray(cb)))
        lev, deq, bits = rdoq_code(tt(coef), qp, log2, 10, torch.tensor(lam),
                                   torch.as_tensor(cb), is_luma, sdh=True)
        eq(lev, want)
        eq(deq, j_deq(jnp.asarray(want), jnp.int32(qp), log2, 10))
        jb = np.asarray(j_bits(jnp.asarray(want), jnp.asarray(cb), log2,
                               is_luma, 0, True))
        small = jb < 512
        eq(bits.numpy()[small].view(np.int32), jb[small].view(np.int32))
        assert (want != 0).any()


def test_sao_main10_matches_hmtpu():
    """SAO at 10 bits: statistics, the RD choice and the apply equal
    hmtpu's, with offsets past the 8-bit limit of 7 chosen."""
    from hmtpu.ops.sao import sao_frame_dev as j_sao
    from hmtpu_torch.common import lambdas
    from hmtpu_torch.ops.sao import sao_frame_dev

    rng = np.random.RandomState(10)
    planes = []
    for hh, ww in ((64, 64), (32, 32), (32, 32)):
        base = 512 + rng.randint(-160, 161, (hh // 4, ww // 4))
        org = np.repeat(np.repeat(base, 4, 0), 4, 1) \
            + rng.randint(-8, 9, (hh, ww))
        rec = org + rng.randint(-6, 7, org.shape) + (org > 560) * 24
        planes += [np.clip(a, 0, 1023).astype(np.int32) for a in (org, rec)]
    lam = lambdas.frame_lambdas(32, 32, 0.57)[0]
    want = jax.jit(partial(j_sao, ctu=32, bd=10))(
        *(jnp.asarray(p) for p in planes), lam=jnp.float32(lam))
    got = sao_frame_dev(*(tt(p) for p in planes), 32, torch.tensor(lam), 10)
    for g, w in zip(got, want):
        eq(g, w)
    assert int(got[3][..., 3:].abs().max()) > 7
