"""K4 sao's lane code (csrc/sao.cuh: a CTU's strips on the warps of a
block, 32 samples a warp step counted with warp sums and ballots, the
bands a group of equal bands at a time; the apply a quad of samples a
thread) compiled as host C++ with g++ and driven on the CPU against the
port's plain versions (`sao_stats_plain`, `apply_sao_plain`), bit for
bit: one plane and a frame's three, 64x64 and 48x80 (partial CTUs),
CTU 32 and 64, 8 and 10 bits, and a plane whose width is not a multiple
of 4 (the apply's and the staging's scalar path).

The host build runs every lane of a `HM_LANES` loop on one thread, in
order or (`lane_reverse`) last lane first, and the apply's quads in order
or last first, so a lane that read what another lane of the same loop
writes would see it unwritten in one of the two orders.  A mutated header
where a sample on the picture's right column takes a horizontal edge
category (its neighbour outside the picture read from the staged halo)
shows that the comparison catches a wrong edge rule.  The card runs the
same functions in the kernels, which the `gpu` tests of K4
(tests/test_torch_gpu.py) and chip_smoke.py hold to the plain versions.
A small case holds the three-plane plain entries (`sao_stats_frame`,
`apply_sao_frame` on CPU tensors) against hmtpu's per-plane functions.
Skips only where there is no g++.
"""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmtpu_torch.kernels import CSRC
from hmtpu_torch.ops import sao
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)

_LANES_CPP = r"""
#include "sao.cuh"
extern "C" void lane_reverse(int r) { hm::lane_reverse = r; }
static int planes(sao::Plane* p, const int* const* org, const int* const* rec,
                  int* const* out, int np, int h, int w, int ctu, int hc,
                  int wc, int ctuc) {
  for (int i = 0; i < np; ++i)
    p[i] = sao::Plane{org ? org[i] : nullptr, rec[i], out ? out[i] : nullptr,
                      i ? hc : h, i ? wc : w, i ? ctuc : ctu};
  return np;
}
extern "C" void stats_host(const int* o0, const int* r0, const int* o1,
                           const int* r1, const int* o2, const int* r2,
                           int* out, int np, int h, int w, int ctu, int hc,
                           int wc, int ctuc, int bd) {
  const int* org[3] = {o0, o1, o2};
  const int* rec[3] = {r0, r1, r2};
  sao::Plane p[3];
  sao::stats_host(p, planes(p, org, rec, nullptr, np, h, w, ctu, hc, wc,
                            ctuc), bd, out);
}
extern "C" void apply_host(const int* r0, const int* r1, const int* r2,
                           const int* params, int* d0, int* d1, int* d2,
                           int np, int h, int w, int ctu, int hc, int wc,
                           int ctuc, int bd, int reverse) {
  const int* rec[3] = {r0, r1, r2};
  int* out[3] = {d0, d1, d2};
  sao::Plane p[3];
  sao::apply_host(p, planes(p, nullptr, rec, out, np, h, w, ctu, hc, wc,
                            ctuc), params, bd, reverse);
}
"""


def _build(csrc, d):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile csrc/sao.cuh as host C++")
    src, so = d / "lanes.cpp", d / "liblanes.so"
    src.write_text(_LANES_CPP)
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(csrc), "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lane_reverse.argtypes = [i]
    lib.stats_host.argtypes = [p] * 7 + [i] * 8
    lib.apply_host.argtypes = [p] * 7 + [i] * 9
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(CSRC, tmp_path_factory.mktemp("sao_lanes"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plane(rng, h, w, bd):
    """An original of flat 4x4 blocks with a little noise (equal
    neighbours: category 0 and every edge shape) over the whole range of
    bands, and a reconstruction off by a few steps."""
    top = (1 << bd) - 1
    base = rng.randint(0, top + 1, (-(-h // 4), -(-w // 4)))
    org = np.repeat(np.repeat(base, 4, 0), 4, 1)[:h, :w]
    org = np.clip(org + rng.randint(-1, 2, (h, w)) * (rng.rand(h, w) < 0.3),
                  0, top)
    rec = np.clip(org + rng.randint(-3 << (bd - 8), 4 << (bd - 8), (h, w)),
                  0, top)
    return org.astype(np.int32), rec.astype(np.int32)


def _params(rng, ny, nx, np_, bd):
    """Random parameters, the types in turn (off, band, edge) over the
    CTUs and planes."""
    mo = sao.max_offset(bd)
    typ = (np.arange(ny * nx * np_) + rng.randint(3)) % 3
    return np.concatenate(
        [typ.reshape(ny, nx, np_, 1), rng.randint(0, 4, (ny, nx, np_, 1)),
         rng.randint(0, 32, (ny, nx, np_, 1)),
         rng.randint(-mo, mo + 1, (ny, nx, np_, 4))], -1).astype(np.int32)


def _ptr(a):
    return a.ctypes.data if a is not None else None


def _case(h, w, ctu, bd, seed):
    """A frame's three planes (luma h x w, chroma h/2 x w/2), originals
    and reconstructions."""
    rng = np.random.RandomState(seed)
    return [_plane(rng, hh, ww, bd)
            for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2))], rng


def _geom(planes, ctu):
    (h, w), (hc, wc) = planes[0][0].shape, planes[-1][0].shape
    return h, w, ctu, hc, wc, ctu // 2


def _host_stats(lib, planes, ctu, bd, reverse):
    n = -(-planes[0][0].shape[0] // ctu) * -(-planes[0][0].shape[1] // ctu)
    out = np.full((len(planes), n, 96), -12345, np.int32)
    ptrs = [_ptr(a) for o, r in planes for a in (o, r)]
    ptrs += [None] * (6 - len(ptrs))
    lib.lane_reverse(int(reverse))
    try:
        lib.stats_host(*ptrs, _ptr(out), len(planes), *_geom(planes, ctu),
                       bd)
    finally:
        lib.lane_reverse(0)
    return out


def _host_apply(lib, planes, params, ctu, bd, reverse):
    outs = [np.full_like(r, -1) for _, r in planes]
    recs = [_ptr(r) for _, r in planes] + [None] * (3 - len(planes))
    dsts = [_ptr(o) for o in outs] + [None] * (3 - len(planes))
    lib.apply_host(*recs, _ptr(params), *dsts, len(planes),
                   *_geom(planes, ctu), bd, int(reverse))
    return outs


def _plain_stats(planes, ctu, bd):
    t = torch.as_tensor
    return np.stack([sao.stats_rows(*sao.sao_stats_plain(
        t(o), t(r), ctu if k == 0 else ctu // 2, bd)).numpy()
        for k, (o, r) in enumerate(planes)])


def _plain_apply(planes, params, ctu, bd):
    return [sao.apply_sao_plain(torch.as_tensor(r),
                                torch.as_tensor(params[:, :, k]),
                                ctu if k == 0 else ctu // 2, bd).numpy()
            for k, (_, r) in enumerate(planes)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h,w,ctu", [(64, 64, 32), (64, 64, 64),
                                     (48, 80, 64), (48, 80, 32)])
def test_host_stats_equal_plain(lib, h, w, ctu, bd, reverse):
    planes, _ = _case(h, w, ctu, bd, seed=h * w + ctu + bd)
    got = _host_stats(lib, planes, ctu, bd, reverse)
    want = _plain_stats(planes, ctu, bd)
    np.testing.assert_array_equal(got, want)
    # every edge category and many bands were counted
    assert (want[:, :, 16:32].sum((0, 1)) > 0).all()
    assert (want[:, :, 64:96].sum((0, 1)) > 0).sum() >= 24
    # one plane alone
    np.testing.assert_array_equal(
        _host_stats(lib, planes[1:2], ctu // 2, bd, reverse)[0], want[1])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h,w,ctu", [(64, 64, 32), (64, 64, 64),
                                     (48, 80, 64), (48, 80, 32)])
def test_host_apply_equal_plain(lib, h, w, ctu, bd, reverse):
    planes, rng = _case(h, w, ctu, bd, seed=h + w + ctu + bd)
    params = _params(rng, -(-h // ctu), -(-w // ctu), 3, bd)
    got = _host_apply(lib, planes, params, ctu, bd, reverse)
    want = _plain_apply(planes, params, ctu, bd)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g, wnt)
    assert any((g != r).any() for g, (_, r) in zip(got, planes))
    got1 = _host_apply(lib, planes[:1], np.ascontiguousarray(params[:, :, :1]),
                       ctu, bd, reverse)
    np.testing.assert_array_equal(got1[0], want[0])


@pytest.mark.parametrize("reverse", [False, True])
def test_host_width_not_multiple_of_4(lib, reverse):
    """One plane 30 x 70 at CTU 32: the staging's and the apply's scalar
    path, the ragged last quad of each row masked."""
    rng = np.random.RandomState(70)
    planes = [_plane(rng, 30, 70, 8)]
    got = _host_stats(lib, planes, 32, 8, reverse)
    np.testing.assert_array_equal(got, _plain_stats(planes, 32, 8))
    params = _params(rng, 1, 3, 1, 8)
    got = _host_apply(lib, planes, params, 32, 8, reverse)
    np.testing.assert_array_equal(got[0],
                                  _plain_apply(planes, params, 32, 8)[0])


def test_host_stats_wrong_edge_rule_is_caught(lib, tmp_path):
    """A copy of the header whose horizontal classes count the picture's
    last column (its right neighbour read from the staged halo, which
    repeats the sample) must disagree with the plain version, lanes in
    order and reversed, where the header as it is agrees."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "sao.cuh"
    text = p.read_text()
    good = "const bool in_x = gx > 0 && gx < w - 1,"
    assert text.count(good) == 1
    p.write_text(text.replace(good, "const bool in_x = gx > 0 && gx < w,"))
    (tmp_path / "b").mkdir()
    mut = _build(csrc, tmp_path / "b")
    planes, _ = _case(48, 80, 64, 8, seed=9)
    want = _plain_stats(planes, 64, 8)
    for reverse in (False, True):
        np.testing.assert_array_equal(
            _host_stats(lib, planes, 64, 8, reverse), want)
        assert not np.array_equal(_host_stats(mut, planes, 64, 8, reverse),
                                  want), reverse


@pytest.mark.parametrize("h,w,ctu", [(64, 64, 32), (48, 80, 64)])
def test_frame_plain_equals_hmtpu(h, w, ctu):
    """`sao_stats_frame` and `apply_sao_frame` on CPU tensors (the three-
    plane plain entries) against hmtpu/ops/sao.py `_sao_stats_dev` and
    `apply_sao_dev` plane by plane, at test_sao_frame_dev's sizes."""
    from hmtpu.ops import sao as jsao

    planes, rng = _case(h, w, ctu, 8, seed=h * w)
    t = torch.as_tensor
    got = sao.sao_stats_frame(*(t(a) for o, r in planes for a in (o, r)),
                              ctu, 8)
    assert got.shape == (3, -(-h // ctu) * -(-w // ctu), 96)
    params = _params(rng, -(-h // ctu), -(-w // ctu), 3, 8)
    new = sao.apply_sao_frame(*(t(r) for _, r in planes), t(params), ctu, 8)
    for k, (o, r) in enumerate(planes):
        c = ctu if k == 0 else ctu // 2
        want = jsao._sao_stats_dev(jnp, jnp.asarray(o), jnp.asarray(r), c, 8)
        want = sao.stats_rows(*(t(np.array(a)) for a in want))
        np.testing.assert_array_equal(got[k].numpy(), want.numpy())
        np.testing.assert_array_equal(
            new[k].numpy(), np.asarray(jsao.apply_sao_dev(
                jnp, jnp.asarray(r), jnp.asarray(params[:, :, k]), c, 8)))
