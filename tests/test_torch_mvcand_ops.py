"""The z-scan's motion-candidate and mode-rate derivations of hmtpu_torch
(K17 merge_cands, K18 amvp_rd, K19 mv_regularize, K20 mpm_bits) against
hmtpu: the same seeded numpy inputs through hmtpu's functions (jnp on
the CPU) and through the port with CPU tensors, which run each kernel's
plain version:

  - `amvp_rd` (K18), P and B, against hmtpu's own composition of
    `amvp_candidates_dev(_b)`, `mvd_bits`, `ref_idx_bits` and
    `inter_dir_bits` (hmtpu/encoder/pframe_dev.py:815-826 and
    `amvp_b_nxn` :487-514);
  - `intra_mode_mpm_bits_nxn` (K20's four-PU form) against hmtpu's sum of
    four `intra_mode_mpm_bits` (hmtpu/encoder/iframe_dev.py:353-356);
  - the traps: equal predictor bits (predictor 0 wins), duplicate
    neighbour motion, the B list's whole 12-pair scan and its dump lane,
    K19's neighbours wrapping at all four picture edges with SAD reads
    clamped there.

Integers must be equal, float32 bits identical.  The lane functions of
`csrc/mvcand.cuh`, which K17 and K18 run, also compile as host C++: with
g++ present they are held against the plain versions here too.
"""
import ctypes
import itertools
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmtpu.common.constants import SliceType
from hmtpu.entropy.contexts import make_contexts
from hmtpu.entropy.fracbits import ctx_bits_table
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "hmtpu_torch", "csrc")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
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
    """Equal values; float32 compared bit for bit."""
    p, r = np.asarray(port), np.asarray(ref)
    if r.dtype == np.float32:
        assert p.dtype == np.float32, msg
        p, r = p.view(np.int32), r.view(np.int32)
    np.testing.assert_array_equal(p, r, err_msg=msg)


def cbflat(qp, st=SliceType.P):
    c = ctx_bits_table(make_contexts(st, qp)).reshape(-1)
    return jnp.asarray(c), torch.as_tensor(c)


def _state_rows(rng, B, bi):
    """(B, 5) validity and (B, 5, 14) state rows (the pass's K_* columns)
    from small alphabets, so that neighbours coincide and predictors tie."""
    from hmtpu_torch.encoder import pframe_dev as pf

    nbp = np.zeros((B, 5, 14), np.int32)
    ndir = rng.randint(0, 4 if bi else 2, (B, 5))
    nbp[..., pf.K_DIR] = ndir
    nbp[..., pf.K_MVX] = rng.choice([-40, -4, 0, 4, 130], (B, 5))
    nbp[..., pf.K_MVY] = rng.choice([-7, 0, 64], (B, 5))
    nbp[..., pf.K_REF] = rng.randint(0, 4, (B, 5))
    nbp[..., pf.K_MVX1] = rng.choice([-9, 0, 5], (B, 5))
    nbp[..., pf.K_MVY1] = rng.choice([0, 3], (B, 5))
    nbp[..., pf.K_REF1] = rng.randint(0, 2, (B, 5))
    return (rng.rand(B, 5) < 0.85) & (ndir > 0), nbp


def _p_traps(nbv, nbp, amx, amy, aref):
    """Lanes 0-7: A1 and B1 valid with MVs 4 left and 4 right of the
    searched MV in the same reference (the two predictors' mvd bits are
    equal); lanes 8-15: all five neighbours with one motion (pruned to one
    candidate; AMVP's B candidate is a duplicate of A's)."""
    from hmtpu_torch.encoder import pframe_dev as pf

    nbv[:16] = False
    nbv[:8, [0, 1]] = True
    nbp[:16, :, pf.K_DIR] = 1
    nbp[:8, 0, pf.K_MVX] = amx[:8] - 4
    nbp[:8, 1, pf.K_MVX] = amx[:8] + 4
    nbp[:8, [0, 1], pf.K_MVY] = amy[:8, None]
    nbp[:8, [0, 1], pf.K_REF] = aref[:8, None]
    nbv[8:16] = True
    nbp[8:16, :, pf.K_MVX] = 12
    nbp[8:16, :, pf.K_MVY] = -4
    nbp[8:16, :, pf.K_REF] = 1


def _hm_amvp_p(jc, nbv, nbp, aref, amx, amy, pocs, cur, num_ref, t, n_active):
    """hmtpu's P-slice AMVP block (hmtpu/encoder/pframe_dev.py:815-826)."""
    from hmtpu.ops import ratebits as jr
    from hmtpu.search import wavefront as jw
    from hmtpu_torch.encoder import pframe_dev as pf

    nbp = jnp.asarray(nbp)
    nmx, nmy, nrf = nbp[..., pf.K_MVX], nbp[..., pf.K_MVY], nbp[..., pf.K_REF]
    pocs, aref = jnp.asarray(pocs), jnp.asarray(aref)
    amx, amy = jnp.asarray(amx), jnp.asarray(amy)
    takw = {} if t is None else dict(t_ok=jnp.asarray(t[0]),
                                     t_mvx=jnp.asarray(t[1]),
                                     t_mvy=jnp.asarray(t[2]))
    p0x, p0y, p1x, p1y = jw.amvp_candidates_dev(
        jnp.asarray(nbv), nmx, nmy, pocs[jnp.clip(nrf, 0, num_ref - 1)],
        pocs[aref], cur, **takw)
    bits0 = jr.mvd_bits(jc, amx - p0x, amy - p0y)
    bits1 = jr.mvd_bits(jc, amx - p1x, amy - p1y)
    use1 = bits1 < bits0
    return (use1.astype(jnp.int32), jnp.where(use1, amx - p1x, amx - p0x),
            jnp.where(use1, amy - p1y, amy - p0y), jnp.minimum(bits0, bits1),
            jr.ref_idx_bits(jc, aref, num_ref, n_active=None
                            if n_active is None else jnp.int32(n_active)),
            bits0, bits1)


@pytest.mark.parametrize("qp,tmvp,n_active", [(22, False, None),
                                              (37, True, 2), (22, True, 4)])
def test_amvp_rd_p_matches_hmtpu(qp, tmvp, n_active):
    from hmtpu_torch.encoder import pframe_dev as pf

    jc, pc = cbflat(qp)
    rng = np.random.RandomState(qp + 3 * tmvp + (n_active or 0))
    B, num_ref, cur = 600, 4, 8
    nbv, nbp = _state_rows(rng, B, False)
    aref = rng.randint(0, n_active or num_ref, B).astype(np.int32)
    amx = rng.choice([-40, -3, 0, 5, 130, 3], B).astype(np.int32)
    amy = rng.choice([-7, 0, 2, 64], B).astype(np.int32)
    _p_traps(nbv, nbp, amx, amy, aref)
    pocs = np.array([7, 6, 3, 2], np.int32)
    t = None
    if tmvp:
        t = (rng.rand(B) < 0.5, rng.randint(-30, 31, B).astype(np.int32),
             rng.randint(-30, 31, B).astype(np.int32))
    want = _hm_amvp_p(jc, nbv, nbp, aref, amx, amy, pocs, cur, num_ref, t,
                      n_active)
    got = pf.amvp_rd(pc, torch.as_tensor(nbv), tt(nbp), tt(aref), tt(amx),
                     tt(amy), tt(pocs), cur, num_ref,
                     t=None if t is None else tuple(
                         torch.as_tensor(np.asarray(a)) for a in t),
                     n_active=n_active)
    for k, (g, w) in enumerate(zip(got[:5], want[:5])):
        eq(g, w, f"output {k}")
    zero = np.zeros(B, np.int32)
    for g, w in zip(got[5], (zero + 1, amx, amy, aref, zero, zero, zero)):
        eq(g, w)
    # the traps fired: equal bits keep predictor 0, duplicates one list
    b0, b1 = np.asarray(want[5]), np.asarray(want[6])
    assert (b0[:8] == b1[:8]).all() and not np.asarray(got[0])[:8].any()
    assert (np.asarray(got[0]) == 1).any()


@pytest.mark.parametrize("qp,depth", [(22, 0), (37, 2)])
def test_amvp_rd_b_matches_hmtpu(qp, depth):
    from hmtpu.ops import ratebits as jr
    from hmtpu.search import wavefront as jw
    from hmtpu_torch.encoder import pframe_dev as pf

    jc, pc = cbflat(qp, SliceType.B)
    rng = np.random.RandomState(40 + qp + depth)
    B, num_ref, num_ref_l1, cur = 2048, 2, 2, 4
    nbv, nbp = _state_rows(rng, B, True)
    pocs0, pocs1 = np.array([2, 0], np.int32), np.array([8, 16], np.int32)
    lx = rng.randint(0, 2, B).astype(np.int32)
    aref = rng.randint(0, 2, B).astype(np.int32)
    amx = rng.choice([-40, -3, 0, 5, 130, 3], B).astype(np.int32)
    amy = rng.choice([-7, 0, 2, 64], B).astype(np.int32)

    # hmtpu's amvp_b_nxn (hmtpu/encoder/pframe_dev.py:487-514)
    j = jnp.asarray
    jp = j(nbp)
    jl, ja, jx, jy = j(lx), j(aref), j(amx), j(amy)
    jp0, jp1 = j(pocs0), j(pocs1)
    tpoc = jnp.where(jl == 0, jp0[jnp.clip(ja, 0, num_ref - 1)],
                     jp1[jnp.clip(ja, 0, num_ref_l1 - 1)])
    p0x, p0y, p1x, p1y = jw.amvp_candidates_dev_b(
        j(nbv), jp[..., pf.K_DIR], jp[..., pf.K_MVX], jp[..., pf.K_MVY],
        jp0[jnp.clip(jp[..., pf.K_REF], 0, num_ref - 1)],
        jp[..., pf.K_MVX1], jp[..., pf.K_MVY1],
        jp1[jnp.clip(jp[..., pf.K_REF1], 0, num_ref_l1 - 1)], jl, tpoc, cur)
    bits0 = jr.mvd_bits(jc, jx - p0x, jy - p0y)
    bits1 = jr.mvd_bits(jc, jx - p1x, jy - p1y)
    use1 = bits1 < bits0
    want = (use1.astype(jnp.int32), jnp.where(use1, jx - p1x, jx - p0x),
            jnp.where(use1, jy - p1y, jy - p0y), jnp.minimum(bits0, bits1),
            jnp.where(jl == 0, jr.ref_idx_bits(jc, ja, num_ref),
                      jr.ref_idx_bits(jc, ja, num_ref_l1))
            + jr.inter_dir_bits(jc, 1 + jl, depth))

    got = pf.amvp_rd(pc, torch.as_tensor(nbv), tt(nbp), tt(aref), tt(amx),
                     tt(amy), tt(pocs0), cur, num_ref, lx=tt(lx),
                     ref_pocs_l1=tt(pocs1), num_ref_l1=num_ref_l1,
                     depth=depth)
    for k, (g, w) in enumerate(zip(got[:5], want)):
        eq(g, w, f"output {k}")
    l0 = lx == 0
    for g, w in zip(got[5], (1 + lx, np.where(l0, amx, 0),
                             np.where(l0, amy, 0), np.where(l0, aref, 0),
                             np.where(l0, 0, amx), np.where(l0, 0, amy),
                             np.where(l0, 0, aref))):
        eq(g, w)
    assert (np.asarray(bits0) == np.asarray(bits1)).any()


def test_mpm_bits_nxn_matches_hmtpu():
    """K20's four-PU form against hmtpu's sum ((a + b) + c) + d, and the
    one-mode form with K candidates per neighbour pair (the I pass's
    broadcast), over MPM hits at every index and misses."""
    from hmtpu.ops import ratebits as jr
    from hmtpu_torch.ops import ratebits as pr

    jc, pc = cbflat(32, SliceType.I)
    rng = np.random.RandomState(5)
    B = 64
    alpha = [0, 1, 2, 10, 26, 33, 34]
    m4 = rng.choice(alpha, (B, 4)).astype(np.int32)
    lm = rng.choice(alpha, B).astype(np.int32)
    am = rng.choice(alpha, B).astype(np.int32)
    am[::3] = lm[::3]
    m4[::5, 1] = m4[::5, 0]
    j = jnp.asarray
    f = jr.intra_mode_mpm_bits
    want = f(jc, j(m4[:, 0]), j(lm), j(am)) \
        + f(jc, j(m4[:, 1]), j(m4[:, 0]), j(am)) \
        + f(jc, j(m4[:, 2]), j(lm), j(m4[:, 0])) \
        + f(jc, j(m4[:, 3]), j(m4[:, 2]), j(m4[:, 1]))
    eq(pr.intra_mode_mpm_bits_nxn(pc, tt(m4), tt(lm), tt(am)), want)
    modes = rng.randint(0, 35, (B, 35)).astype(np.int32)
    eq(pr.intra_mode_mpm_bits(pc, tt(modes), tt(lm)[:, None],
                              tt(am)[:, None]),
       f(jc, j(modes), j(lm)[:, None], j(am)[:, None]))


def _b_lanes():
    """2048 lanes: every combination of the five neighbours' directions
    twice, with motion from a small alphabet (tests/test_torch_bslice_ops'
    field), lanes 0-2 replaced by built cases:
      0: A1 and B1 list-1 only with one motion (B1 pruned), B0 list-1
         only and distinct, A0 list-0 only with A1's (POC, MV), B2 out:
         the list is [A1, B0, A0], pair (2, 0) is a duplicate and (2, 1),
         at priority 5, the one combined candidate;
      1: four bi spatial candidates, all distinct: all 12 pairs qualify,
         the first fills the last entry and the other eleven go to the
         dump lane;
      2: one spatial candidate: no pair, the dir=3 zero fill."""
    dirs = np.array(list(itertools.product(range(4), repeat=5)), np.int32)
    rng = np.random.RandomState(5)
    ndir = np.tile(dirs, (2, 1))
    sh = ndir.shape
    f = dict(dir=ndir, mvx0=rng.choice([-8, 0, 4], sh),
             mvy0=rng.choice([0, 4], sh), ref0=rng.randint(0, 2, sh),
             mvx1=rng.choice([-8, 0, 4], sh), mvy1=rng.choice([0, 4], sh),
             ref1=rng.randint(0, 2, sh))
    f = {k: v.astype(np.int32) for k, v in f.items()}
    # slots [A1, B1, B0, A0, B2]; list-1 POC 8 (ref1 0) is list-0 POC 8
    # (ref0 1)
    f["dir"][0] = [2, 2, 2, 1, 0]
    f["ref1"][0] = [0, 0, 1, 0, 0]
    f["mvx1"][0] = [4, 4, 8, 0, 0]
    f["mvy1"][0] = [0, 0, 0, 0, 0]
    f["ref0"][0] = [0, 0, 0, 1, 0]
    f["mvx0"][0] = [0, 0, 0, 4, 0]
    f["mvy0"][0] = [0, 0, 0, 0, 0]
    f["dir"][1] = [3, 3, 3, 3, 3]
    for k, v in (("mvx0", [1, 2, 3, 5, 6]), ("mvx1", [-1, -2, -3, -5, -6]),
                 ("mvy0", [0] * 5), ("mvy1", [0] * 5), ("ref0", [0] * 5),
                 ("ref1", [1] * 5)):
        f[k][1] = v
    f["dir"][2] = [3, 0, 0, 0, 0]
    f["valid"] = f["dir"] > 0
    return f


@pytest.mark.parametrize("max_merge", [5, 3])
def test_merge_b_pair_scan_matches_hmtpu(max_merge):
    from hmtpu.search import wavefront as jw
    from hmtpu_torch.search import wavefront as pw

    f = _b_lanes()
    pocs0, pocs1 = np.array([2, 8], np.int32), np.array([8, 16], np.int32)
    args = [f[k] for k in ("valid", "dir", "mvx0", "mvy0", "ref0", "mvx1",
                           "mvy1", "ref1")]
    want = jw.merge_candidates_dev_b(
        *[jnp.asarray(a) for a in args], jnp.asarray(pocs0),
        jnp.asarray(pocs1), 2, 2, max_merge)
    got = pw.merge_candidates_dev_b(*[tt(a) for a in args], tt(pocs0),
                                    tt(pocs1), 2, 2, max_merge)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        eq(g, w)
    cdir, cx0, _, cr0, cx1, _, cr1 = (np.asarray(a) for a in want)
    # lane 0: spatial A1, B0, A0 (B1 pruned as A1's twin), then pair (2, 1)
    # = (A0's list 0, B0's list 1)
    n_sp = 3
    if max_merge > n_sp:
        assert (cdir[0, n_sp], cx0[0, n_sp], cr0[0, n_sp], cx1[0, n_sp],
                cr1[0, n_sp]) == (3, 4, 1, 8, 1)
    # lane 1: four bi spatial candidates, then pair (0, 1) if it fits
    assert (cdir[1] == 3).all()
    # lane 2: one spatial candidate, then the zero fill
    assert (cdir[2] == 3).all() and (cx0[2, 1:] == 0).all()


def test_merge_p_duplicates_matches_hmtpu():
    """Five neighbours with one motion (one candidate survives), the
    temporal candidate equal to it (appended unpruned), the zero fill over
    the active references."""
    from hmtpu.search import wavefront as jw
    from hmtpu_torch.search import wavefront as pw

    rng = np.random.RandomState(7)
    B = 600
    v = rng.rand(B, 5) < 0.7
    mx = rng.choice([-9, -4, 0, 3, 12], (B, 5)).astype(np.int32)
    my = rng.choice([-6, 0, 2, 7], (B, 5)).astype(np.int32)
    rf = rng.randint(0, 4, (B, 5)).astype(np.int32)
    v[:50], mx[:50], my[:50], rf[:50] = True, 3, -6, 0
    tok = rng.rand(B) < 0.6
    tx = rng.randint(-20, 21, B).astype(np.int32)
    ty = rng.randint(-20, 21, B).astype(np.int32)
    tok[:25], tx[:25], ty[:25] = True, 3, -6
    for max_merge, n_active in ((5, 2), (5, 4), (2, 3)):
        want = jw.merge_candidates_dev(
            jnp.asarray(v), jnp.asarray(mx), jnp.asarray(my),
            jnp.asarray(rf), 4, max_merge, t_ok=jnp.asarray(tok),
            t_mvx=jnp.asarray(tx), t_mvy=jnp.asarray(ty),
            n_active=jnp.int32(n_active))
        got = pw.merge_candidates_dev(tt(v), tt(mx), tt(my), tt(rf), 4,
                                      max_merge, t_ok=tt(tok), t_mvx=tt(tx),
                                      t_mvy=tt(ty), n_active=n_active)
        for g, w in zip(got, want):
            eq(g, w)
        if max_merge == 5:
            # lane 0: the one spatial candidate, the equal temporal one,
            # then zero MVs over the active references
            assert list(np.asarray(want[0])[0]) == [3, 3, 0, 0, 0]
            assert list(np.asarray(want[2])[0]) == [0, 0] + [
                k if k < n_active else 0 for k in range(3)]


def test_regularize_wraps_at_all_four_edges():
    """Every edge row and column carries its own vector, pointing out of
    the picture: the wrapped neighbours (`roll`) offer the opposite edge's
    vector, and the SAD reads clamp to the picture."""
    from hmtpu.search import me as jme
    from hmtpu_torch.search import me as pme

    rng = np.random.RandomState(11)
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w]
    org = np.clip(128 + 50 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
                  + rng.randint(-20, 21, (h, w)), 0, 255).astype(np.int32)
    refs = np.stack([np.clip(np.roll(org, (dy, dx), (0, 1))
                             + rng.randint(-4, 5, (h, w)), 0, 255)
                     for dy, dx in ((2, -3), (-5, 6), (0, 0))]) \
        .astype(np.int32)
    bh, bw = h // 8, w // 8
    mvx = rng.choice([-3, 0, 2], (bh, bw)).astype(np.int32)
    mvy = rng.choice([-1, 0, 4], (bh, bw)).astype(np.int32)
    ridx = rng.randint(0, 3, (bh, bw)).astype(np.int32)
    mvx[:, 0], mvx[:, -1] = -12, 11        # left and right: out sideways
    mvy[0, :], mvy[-1, :] = -9, 10         # top and bottom: out vertically
    ridx[0, :], ridx[-1, :] = 1, 0
    lam = np.float32(6.25)
    want = jme.regularize_mv_field(jnp.asarray(refs), jnp.asarray(org),
                                   jnp.asarray(mvx), jnp.asarray(mvy),
                                   jnp.asarray(ridx), jnp.float32(lam))
    got = pme.regularize_mv_field(tt(refs), tt(org), tt(mvx), tt(mvy),
                                  tt(ridx), torch.tensor(lam))
    for g, wv in zip(got, want):
        eq(g, wv)
    wx = np.asarray(want[0])
    # some edge block took a vector that only the wrapped neighbour offers
    assert (wx[:, 0] == 11).any() or (wx[:, -1] == -12).any() \
        or (np.asarray(want[1])[0] == 10).any() \
        or (np.asarray(want[1])[-1] == -9).any()


# ---------------------------------------------------------------------------
# the lane functions of csrc/mvcand.cuh, compiled as host C++

_LANES_CPP = r"""
#include "mvcand.cuh"
extern "C" void merge(const int* nb, const int* t, const int* p0,
                      const int* p1, int* out, int B, int C, int M,
                      int limit, int r0, int r1) {
  for (int lane = 0; lane < B; ++lane)
    mvc::merge_lane(nb, t, p0, p1, out, lane, B, C, M, limit, r0, r1);
}
extern "C" void amvp(const int* nbv, const int* nbp, const int* aref,
                     const int* amx, const int* amy, const int* lx,
                     const int* t, const int* p0, const int* p1,
                     const float* tab, int* oi, float* of, const int* g) {
  const mvc::AmvpArgs a{g[0], g[1], g[2], g[3], g[4], g[5], g[6], g[7], g[8],
                        g[9], g[10], g[11], g[12], g[13], g[14], g[15],
                        g[16], g[17]};
  for (int lane = 0; lane < a.B; ++lane)
    mvc::amvp_lane(nbv, nbp, aref, amx, amy, lx, t, p0, p1, tab, oi, of,
                   lane, a);
}
"""


@pytest.fixture(scope="module")
def lanes_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile csrc/mvcand.cuh as host C++")
    d = tmp_path_factory.mktemp("mvcand")
    src, so = d / "lanes.cpp", d / "libmvcand.so"
    src.write_text(_LANES_CPP)
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _ptr(a):
    return None if a is None else ctypes.c_void_p(a.data_ptr())


@pytest.mark.parametrize("form", ["merge_p", "merge_b", "amvp_p", "amvp_b"])
def test_mvcand_lanes_equal_plain(lanes_lib, form):
    """merge_lane / amvp_lane (what K17 / K18 run per thread) against the
    port's plain versions on the same inputs: equal, float32 bit for bit."""
    from hmtpu_torch.encoder import pframe_dev as pf
    from hmtpu_torch.entropy.contexts import OFF
    from hmtpu_torch.search import wavefront as pw

    rng = np.random.RandomState(len(form))
    i32 = lambda a: tt(a).to(torch.int32).contiguous()
    if form == "merge_p":
        B = 600
        v, nbp = _state_rows(rng, B, False)
        cols = [nbp[..., k] for k in (pf.K_MVX, pf.K_MVY, pf.K_REF)]
        t = (rng.rand(B) < 0.5, rng.randint(-4, 5, B), rng.randint(-4, 5, B))
        for mm, n_active, tk in ((5, None, None), (5, 2, t), (3, 4, t)):
            kw = {} if tk is None else dict(
                t_ok=torch.as_tensor(tk[0]), t_mvx=i32(tk[1]),
                t_mvy=i32(tk[2]))
            want = pw.merge_candidates_dev_plain(
                torch.as_tensor(v), *[i32(c) for c in cols], 4, mm,
                n_active=n_active, **kw)
            nb = torch.stack([i32(v)] + [i32(c) for c in cols], -1)
            tp = None if tk is None else torch.stack(
                [i32(a) for a in tk], 1).contiguous()
            out = torch.zeros((3, B, mm), dtype=torch.int32)
            lanes_lib.merge(_ptr(nb), _ptr(tp), None, None, _ptr(out), B, 4,
                            mm, 4 if n_active is None else n_active, 0, 0)
            for g, w in zip(out, want):
                eq(g, w)
    elif form == "merge_b":
        f = _b_lanes()
        args = [f[k] for k in ("valid", "dir", "mvx0", "mvy0", "ref0", "mvx1",
                               "mvy1", "ref1")]
        B = args[0].shape[0]
        for mm, (r0, r1) in ((5, (2, 2)), (2, (2, 1)), (4, (1, 2))):
            p0, p1 = i32([2, 8]), i32([8, 16])
            want = pw.merge_candidates_dev_b_plain(
                torch.as_tensor(args[0]), *[i32(a) for a in args[1:]], p0, p1,
                r0, r1, mm)
            nb = torch.stack([i32(a) for a in args], -1)
            out = torch.zeros((7, B, mm), dtype=torch.int32)
            lanes_lib.merge(_ptr(nb), None, _ptr(p0), _ptr(p1), _ptr(out), B,
                            8, mm, 0, r0, r1)
            for g, w in zip(out, want):
                eq(g, w)
    else:
        bi = form == "amvp_b"
        B = 2048 if bi else 600
        nbv, nbp = _state_rows(rng, B, bi)
        aref = rng.randint(0, 2, B).astype(np.int32)
        amx = rng.choice([-40, -3, 0, 5, 130, 3], B).astype(np.int32)
        amy = rng.choice([-7, 0, 2, 64], B).astype(np.int32)
        if not bi:
            _p_traps(nbv, nbp, amx, amy, aref)
        _, pc = cbflat(22, SliceType.B if bi else SliceType.P)
        p0, p1 = i32([7, 6, 3, 2]), i32([16, 12])
        lx = i32(rng.randint(0, 2, B)) if bi else None
        t = None if bi else (torch.as_tensor(rng.rand(B) < 0.5),
                             i32(rng.randint(-30, 31, B)),
                             i32(rng.randint(-30, 31, B)))
        n_active = None if bi else 3
        depth = 2
        want = pf.amvp_rd_plain(
            pc, torch.as_tensor(nbv), i32(nbp), i32(aref), i32(amx),
            i32(amy), p0, 8, 4, t=t, n_active=n_active, lx=lx,
            ref_pocs_l1=p1 if bi else None, num_ref_l1=2 if bi else 0,
            depth=depth)
        g = i32([B, 14, pf.K_DIR, pf.K_MVX, pf.K_MVY, pf.K_REF, pf.K_MVX1,
                 pf.K_MVY1, pf.K_REF1, 8, 4, 2 if bi else 1, 3 if bi else 2,
                 1, depth, OFF["MVD"], OFF["REF_PIC"], OFF["INTER_DIR"]])
        oi = torch.zeros((10, B), dtype=torch.int32)
        of = torch.zeros((2, B), dtype=torch.float32)
        tp = None if t is None else torch.stack([i32(a) for a in t], 1) \
            .contiguous()
        ins = [i32(a) for a in (nbv, nbp, aref, amx, amy)]   # kept alive
        lanes_lib.amvp(*[_ptr(a) for a in ins], _ptr(lx), _ptr(tp),
                       _ptr(p0), _ptr(p1 if bi else None), _ptr(pc),
                       _ptr(oi), _ptr(of), _ptr(g))
        got = (oi[0], oi[1], oi[2], of[0], of[1]) + tuple(oi[3:])
        for k, (a, b) in enumerate(zip(got, want[:5] + tuple(want[5]))):
            eq(a, b, f"output {k}")
