"""K8 satd8's lane code (csrc/satd.cuh: eight lanes an 8x8 tile, a row a
lane, the row butterflies in registers and the column butterflies and
sums across the lanes; four tiles a warp) compiled as host C++ with g++
and driven on the CPU against the port's plain versions, bit for bit:
the one-call form against `satd_batch_plain` at n = 8, 16, 32 and 64,
and the NN-FME gate form (a level's original blocks read in place from
the plane, rows and columns clamped past its edge, against two
predictions; the first MV set kept only where its SATD is strictly
lower) against `satd_gate_levels_plain` at the P pass's three levels of
64x64 and 80x48 pictures (the 32 level of 80x48 reads past the plane),
with both predictions equal on some blocks, where the integer MV (the
second set) stays.

The host build runs every lane of a `HM_LANES` loop on one thread, in
order or (`lane_reverse`) last lane first.  A mutated header whose gate
keeps the first set on equal SATDs (<= for <) must disagree.  One case
holds the plain gate to hmtpu's composition (`hmtpu.search.me.satd_batch`
twice and a where, as its P pass's `nn_gate` does) at the (90, 8, 8)
shape tests/test_torch_inter_ops.py already compiles.  The card runs the
same functions in the kernels, which the `gpu` tests of K8
(tests/test_torch_gpu.py) and chip_smoke.py hold to the plain versions.
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
from hmtpu_torch.search import me
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)

_LANES_CPP = r"""
#include "satd.cuh"
extern "C" void lane_reverse(int r) { hm::lane_reverse = r; }
// the one-call form: a, b (nb, n, n) -> out (nb,)
extern "C" void satd_host(const int* a, const int* b, int* out, int nb,
                          int n) {
  satd::job_host(satd::Job{a, 0, 0, {b, nullptr}, 1, n, 0, nb, nullptr,
                           nullptr, out});
}
// one gate level over the (oh, ow) plane
extern "C" void gate_host(const int* org, int oh, int ow, const int* p0,
                          const int* p1, const int* mvx, const int* mvy,
                          int* out, int n, int gw, int nb) {
  satd::job_host(satd::Job{org, oh, ow, {p0, p1}, 2, n, gw, nb, mvx, mvy,
                           out});
}
"""


def _build(csrc, d):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile csrc/satd.cuh as host C++")
    src, so = d / "lanes.cpp", d / "liblanes.so"
    src.write_text(_LANES_CPP)
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(csrc), "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lane_reverse.argtypes = [i]
    lib.satd_host.argtypes = [p, p, p, i, i]
    lib.gate_host.argtypes = [p, i, i, p, p, p, p, p, i, i, i]
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(CSRC, tmp_path_factory.mktemp("satd_lanes"))


def _i32(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.int32))


def _reversed(lib, reverse, fn):
    lib.lane_reverse(int(reverse))
    try:
        return fn()
    finally:
        lib.lane_reverse(0)


def _satd_host(lib, a, b, n, reverse):
    out = torch.full((a.shape[0],), -1, dtype=torch.int32)
    _reversed(lib, reverse, lambda: lib.satd_host(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], n))
    return out


def _gate_host(lib, org, levels, reverse):
    h, w = org.shape
    outs = []
    for (p0, p1), mvx, mvy, n, gw in levels:
        nb = mvx.shape[1]
        o = torch.full((2, nb), -99, dtype=torch.int32)
        _reversed(lib, reverse, lambda: lib.gate_host(
            org.data_ptr(), h, w, p0.data_ptr(), p1.data_ptr(),
            mvx.data_ptr(), mvy.data_ptr(), o.data_ptr(), n, gw, nb))
        outs.append((o[0], o[1]))
    return outs


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_tiles_equal_plain(lib, n, reverse):
    """The one-call form: 10-bit pairs close and far apart (the
    butterflies' largest sums), 37 blocks (a warp's last four 8x8 blocks
    partly empty)."""
    rng = np.random.RandomState(n)
    a = rng.randint(0, 1024, (37, n, n))
    b = np.clip(a + rng.randint(-60, 61, a.shape), 0, 1023)
    b[:3] = 1023 - a[:3]
    a, b = _i32(a), _i32(b)
    np.testing.assert_array_equal(_satd_host(lib, a, b, n, reverse),
                                  me.satd_batch_plain(a, b, n))


def _gate_levels(rng, h, w, ties=0.2):
    """The P pass's three levels of an h x w picture (sides multiples of
    16; the 32 grid the ceil one): a textured plane, each level's two
    predictions near it (equal on about `ties` of the blocks) and its MV
    sets."""
    yy, xx = np.mgrid[0:h, 0:w]
    org = _i32(np.clip(128 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
                       + rng.randint(-25, 26, (h, w)), 0, 255))
    levels = []
    for n, gh, gw in ((8, h // 8, w // 8), (16, h // 16, w // 16),
                      (32, -(-h // 32), -(-w // 32))):
        nb = gh * gw
        base = rng.randint(0, 256, (nb, n, n))
        p0 = np.clip(base + rng.randint(-30, 31, base.shape), 0, 255)
        p1 = np.clip(base + rng.randint(-30, 31, base.shape), 0, 255)
        same = rng.rand(nb) < ties
        p1[same] = p0[same]
        mvx = rng.randint(-256, 257, (2, nb))
        mvy = rng.randint(-256, 257, (2, nb))
        levels.append(((_i32(p0), _i32(p1)), _i32(mvx), _i32(mvy), n, gw))
    return org, levels


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("h,w", [(64, 64), (48, 80)])
def test_gate_equal_plain(lib, h, w, reverse):
    """The gate at three levels: each level's (x, y) equal to the plain
    version's; blocks with equal predictions keep the second set."""
    rng = np.random.RandomState(h + w)
    org, levels = _gate_levels(rng, h, w)
    got = _gate_host(lib, org, levels, reverse)
    want = me.satd_gate_levels_plain(org, levels)
    kept = 0
    for (gx, gy), (wx, wy), ((p0, p1), mvx, mvy, n, gw) in zip(
            got, want, levels):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        tie = (p0 == p1).flatten(1).all(1)
        assert torch.equal(gx[tie], mvx[1][tie])
        kept += int((gx == mvx[0]).sum())
    assert kept > 0
    # the CPU entry is the plain version
    for a, b in zip(me.satd_gate_levels(org, levels), want):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_gate_tie_mutation_is_caught(lib, tmp_path):
    """A copy of the header whose gate keeps the first MV set on equal
    SATDs (<= for <) picks other MVs where the predictions are equal."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "satd.cuh"
    text = p.read_text()
    good = "acc[0][j] < acc[1][j]"
    assert text.count(good) == 1
    p.write_text(text.replace(good, good.replace("<", "<=")))
    (tmp_path / "b").mkdir()
    mut = _build(csrc, tmp_path / "b")
    rng = np.random.RandomState(7)
    org, levels = _gate_levels(rng, 48, 80, ties=0.5)
    want = me.satd_gate_levels_plain(org, levels)
    for reverse in (False, True):
        for (gx, gy), (wx, _) in zip(_gate_host(lib, org, levels, reverse),
                                     want):
            np.testing.assert_array_equal(gx, wx)
        assert any(not torch.equal(gx, wx) for (gx, _), (wx, _) in zip(
            _gate_host(mut, org, levels, reverse), want)), reverse


def test_gate_equals_hmtpu():
    """The plain gate at one 8 level of 90 blocks (an 80x72 plane) equal
    to hmtpu's composition: its `satd_batch` of the blockified original
    against each prediction, and a where on the strict compare."""
    from hmtpu.search import me as jme

    rng = np.random.RandomState(90)
    org, levels = _gate_levels(rng, 72, 80)
    (p0, p1), mvx, mvy, n, gw = levels[0]
    assert p0.shape == (90, 8, 8)
    blocks = org.reshape(9, 8, 10, 8).transpose(1, 2).reshape(-1, 8, 8)
    j = lambda t: jnp.asarray(t.numpy())
    better = jme.satd_batch(j(blocks), j(p0), 8) \
        < jme.satd_batch(j(blocks), j(p1), 8)
    want = [np.asarray(jnp.where(better, j(m)[0], j(m)[1]))
            for m in (mvx, mvy)]
    got = me.satd_gate_levels_plain(org, levels[:1])[0]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
