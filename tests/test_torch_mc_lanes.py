"""K7 mc_dctif's and K11 mc_dctif_i's lane code (csrc/mc_dctif.cuh
`mc_warp`: a block on a warp, the patch gathered a row segment at a time,
the horizontal pass only where its phase is non-zero and only over the
rows the vertical pass reads, the output written in rows; `forms_host`
runs a launch's forms over their blocks) compiled as host C++ with g++
and driven on the CPU against the port's plain versions
(`mc_batch_plain`, `mc_batch_i_plain`), bit for bit: luma 8, 16, 32, 64
and chroma 4, 8, 16 with a position per block, a 12 x 8 block, the P
pass's three-plane form (`mc_yuv`) and the NN gate's two-MV form
(`mc_luma2`) on a level's grid, 8 and 10 bits, MVs past every edge and
every phase.

The host build runs every lane of a `HM_LANES` loop on one thread, in
order or (`lane_reverse`) last lane first, so a lane that read what
another lane of the same loop writes would see it unwritten in one of
the two orders.  A mutated header whose gather clamps the patch's columns
one sample short of the picture's right edge shows that the comparison
catches a wrong edge rule.  The card runs the same functions in the
kernel, which the `gpu` tests of K7 and K11 (tests/test_torch_gpu.py) and
chip_smoke.py hold to the plain versions.  A small case holds the forms'
plain entries (`mc_yuv`, `mc_luma2` on CPU tensors) against hmtpu's
`mc_*_batch_refs` and `mc_*_batch_refs_i`.  Skips only where there is no
g++.
"""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmtpu_torch.kernels import CSRC
from hmtpu_torch.ops import interp
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)

_LANES_CPP = r"""
#include "mc_dctif.cuh"
extern "C" void lane_reverse(int r) { hm::lane_reverse = r; }
extern "C" void forms_host(const int* r0, const int* r1, const int* r2,
                           int* o0, int* o1, int* o2, const int* ridx,
                           const int* xs0, const int* ys0, const int* mvx,
                           const int* mvy, int nb, int nf, int R, int gw,
                           int bd, int inter, const int* geo) {
  const int* refs[3] = {r0, r1, r2};
  int* outs[3] = {o0, o1, o2};
  hm::McForm f[3];
  for (int k = 0; k < nf; ++k)
    f[k] = hm::McForm{refs[k], outs[k], geo[6 * k], geo[6 * k + 1],
                      geo[6 * k + 2], geo[6 * k + 3], geo[6 * k + 4],
                      geo[6 * k + 5]};
  const hm::McBlocks a{ridx, xs0, ys0, mvx, mvy, nb, R, gw, bd};
  if (inter)
    hm::forms_host<true>(f, nf, a);
  else
    hm::forms_host<false>(f, nf, a);
}
"""


def _build(csrc, d):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile csrc/mc_dctif.cuh as host C++")
    src, so = d / "lanes.cpp", d / "liblanes.so"
    src.write_text(_LANES_CPP)
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(csrc), "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lane_reverse.argtypes = [i]
    lib.forms_host.argtypes = [p] * 11 + [i] * 6 + [p]
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(CSRC, tmp_path_factory.mktemp("mc_lanes"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ptr(a):
    return a.ctypes.data if a is not None else None


def _mvs(rng, nb, n, sets=1):
    """MVs of every phase, negative ones and ones reaching past the
    picture's edges (the first 64 of each set walk every phase pair)."""
    span = 4 * (n + 24)
    mv = rng.randint(-span, span, (2, sets, nb)).astype(np.int32)
    k = min(nb, 64)
    mv[0, :, :k] = np.arange(k) - 32
    mv[1, :, :k] = (np.arange(k) * 5) % 64 - 32
    return mv[0], mv[1]


def _host(lib, forms, ridx, mvx, mvy, bd, inter, reverse, gw=0, xs=None,
          ys=None):
    """forms: (refs (R, H, W), nw, nh, chroma, MV set); returns each
    form's (B, nh, nw)."""
    nb = len(ridx)
    outs = [np.full((nb, f[2], f[1]), -(1 << 30), np.int32) for f in forms]
    geo = np.array([[r.shape[1], r.shape[2], nw, nh, int(c), s]
                    for r, nw, nh, c, s in forms], np.int32).reshape(-1)
    pad = [None] * (3 - len(forms))
    lib.lane_reverse(int(reverse))
    try:
        lib.forms_host(*[_ptr(f[0]) for f in forms], *pad,
                       *[_ptr(o) for o in outs], *pad, _ptr(ridx), _ptr(xs),
                       _ptr(ys), _ptr(mvx), _ptr(mvy), nb, len(forms),
                       forms[0][0].shape[0], gw, bd, int(inter), _ptr(geo))
    finally:
        lib.lane_reverse(0)
    return outs


def _plain(refs, ridx, xs, ys, mvx, mvy, nw, nh, chroma, bd, inter):
    t = torch.as_tensor
    f = interp.mc_batch_i_plain if inter else interp.mc_batch_plain
    return f(t(refs), t(ridx), t(xs), t(ys), t(mvx), t(mvy), nw, nh, chroma,
             bd).numpy()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("inter", [False, True])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("chroma,nw,nh", [
    (False, 8, 8), (False, 16, 16), (False, 32, 32), (False, 64, 64),
    (False, 12, 8), (True, 4, 4), (True, 8, 8), (True, 16, 16)])
def test_host_positions_equal_plain(lib, chroma, nw, nh, bd, inter, reverse):
    """The one-form call with a position per block (`mc_batch`'s)."""
    rng = np.random.RandomState(nw * 7 + nh + 50 * chroma + bd)
    R, h, w = 3, 48, 80
    refs = rng.randint(0, 1 << bd, (R, h, w)).astype(np.int32)
    nb = 96
    ridx = rng.randint(0, R, nb).astype(np.int32)
    xs = (rng.randint(0, -(-w // nw), nb) * nw).astype(np.int32)
    ys = (rng.randint(0, -(-h // nh), nb) * nh).astype(np.int32)
    (mvx,), (mvy,) = _mvs(rng, nb, max(nw, nh))
    got, = _host(lib, [(refs, nw, nh, chroma, 0)], ridx, mvx, mvy, bd, inter,
                 reverse, xs=xs, ys=ys)
    want = _plain(refs, ridx, xs, ys, mvx, mvy, nw, nh, chroma, bd, inter)
    np.testing.assert_array_equal(got, want)


def _planes(rng, n, bd, R=4, gw=7, gh=5):
    h, w = gh * n, gw * n
    ry = rng.randint(0, 1 << bd, (R, h, w)).astype(np.int32)
    ru, rv = (rng.randint(0, 1 << bd, (R, h // 2, w // 2)).astype(np.int32)
              for _ in range(2))
    return ry, ru, rv, rng.randint(0, R, gw * gh).astype(np.int32), gw


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("inter", [False, True])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_host_forms_equal_plain(lib, n, bd, inter, reverse):
    """The P pass's three-plane form and the NN gate's two-MV form on an
    n-grid, against `mc_yuv_plain` and `mc_luma2_plain`."""
    rng = np.random.RandomState(n + bd + 3 * inter)
    ry, ru, rv, ridx, gw = _planes(rng, n, bd)
    nb = len(ridx)
    mvx, mvy = _mvs(rng, nb, n, sets=2)
    t = torch.as_tensor
    got = _host(lib, [(ry, n, n, False, 0), (ru, n // 2, n // 2, True, 0),
                      (rv, n // 2, n // 2, True, 0)], ridx, mvx, mvy, bd,
                inter, reverse, gw=gw)
    want = interp.mc_yuv_plain(t(ry), t(ru), t(rv), t(ridx), gw, t(mvx[0]),
                               t(mvy[0]), n, bd, inter)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g, wnt.numpy())
    got = _host(lib, [(ry, n, n, False, 0), (ry, n, n, False, 1)], ridx, mvx,
                mvy, bd, inter, reverse, gw=gw)
    want = interp.mc_luma2_plain(t(ry), t(ridx), gw, t(mvx), t(mvy), n, bd,
                                 inter)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g, wnt.numpy())


def test_host_wrong_edge_rule_is_caught(lib, tmp_path):
    """A copy of the header whose warp gather clamps the patch's columns
    to W - 2 must disagree with the plain version, lanes in order and
    reversed, where the header as it is agrees."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "mc_dctif.cuh"
    text = p.read_text()
    good = "const int* src = plane + iclamp(x - half + col, 0, W - 1);"
    assert text.count(good) == 1
    p.write_text(text.replace(good, good.replace("W - 1", "W - 2")))
    (tmp_path / "b").mkdir()
    mut = _build(csrc, tmp_path / "b")
    rng = np.random.RandomState(1)
    ry, ru, rv, ridx, gw = _planes(rng, 8, 8)
    mvx, mvy = _mvs(rng, len(ridx), 8)
    t = torch.as_tensor
    want = interp.mc_yuv_plain(t(ry), t(ru), t(rv), t(ridx), gw, t(mvx[0]),
                               t(mvy[0]), 8)
    forms = [(ry, 8, 8, False, 0), (ru, 4, 4, True, 0), (rv, 4, 4, True, 0)]
    for reverse in (False, True):
        got = _host(lib, forms, ridx, mvx, mvy, 8, False, reverse, gw=gw)
        assert all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))
        bad = _host(mut, forms, ridx, mvx, mvy, 8, False, reverse, gw=gw)
        assert not all(np.array_equal(g, w.numpy())
                       for g, w in zip(bad, want)), reverse


@pytest.mark.parametrize("inter", [False, True])
@pytest.mark.parametrize("n", [8, 16])
def test_forms_plain_equal_hmtpu(n, inter):
    """`mc_yuv` and `mc_luma2` on CPU tensors (the forms' plain entries)
    against hmtpu/ops/interp.py `mc_luma_batch_refs` and
    `mc_chroma_batch_refs` (`_i` with inter) plane by plane and MV set by
    MV set, at test_mc_batch_refs' reference size (3 x 40 x 56)."""
    from hmtpu.ops import interp as ji

    rng = np.random.RandomState(n + 10 * inter)
    R, h, w = 3, 40, 56
    ry = rng.randint(0, 256, (R, h, w)).astype(np.int32)
    ru, rv = (rng.randint(0, 256, (R, h // 2, w // 2)).astype(np.int32)
              for _ in range(2))
    gw, gh = w // n, h // n
    nb = gw * gh
    ridx = rng.randint(0, R, nb).astype(np.int32)
    mvx, mvy = _mvs(rng, nb, n, sets=2)
    q = np.arange(nb)
    xs, ys = ((q % gw) * n).astype(np.int32), ((q // gw) * n).astype(np.int32)
    t = torch.as_tensor
    yuv = interp.mc_yuv(t(ry), t(ru), t(rv), t(ridx), gw, t(mvx[0]),
                        t(mvy[0]), n, 8, inter)
    luma2 = interp.mc_luma2(t(ry), t(ridx), gw, t(mvx), t(mvy), n, 8, inter)
    jl = ji.mc_luma_batch_refs_i if inter else ji.mc_luma_batch_refs
    jc = ji.mc_chroma_batch_refs_i if inter else ji.mc_chroma_batch_refs
    j = jnp.asarray
    nc = n // 2
    want = [jl(j(ry), j(ridx), j(xs), j(ys), j(mvx[0]), j(mvy[0]), n, n, 8),
            jc(j(ru), j(ridx), j(xs // 2), j(ys // 2), j(mvx[0]), j(mvy[0]),
               nc, nc, 8),
            jc(j(rv), j(ridx), j(xs // 2), j(ys // 2), j(mvx[0]), j(mvy[0]),
               nc, nc, 8)]
    for g, wnt in zip(yuv, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    for k in range(2):
        np.testing.assert_array_equal(
            luma2[k].numpy(), np.asarray(jl(j(ry), j(ridx), j(xs), j(ys),
                                            j(mvx[k]), j(mvy[k]), n, n, 8)))
