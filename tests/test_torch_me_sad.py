"""K5 me_sad's and K13 me_sad1's arithmetic (csrc/me_sad.cuh: the packed
window, the eight-displacement units with their packed sums of absolute
differences, K5's 16x16 and region sums, K13's per-cell predictors in
the cost, the (cost, index) keys merged over the dy chunks, the
stencils) compiled as host C++ with g++ and driven on the CPU against
the port's plain versions (`integer_me_levels_plain`,
`integer_me_plain`) and hmtpu's `integer_me_levels` / `integer_me`, on
the same seeded numpy planes, output for output (integers, so equal).

The host build runs the kernels' units chunk by chunk on one thread
(`me::levels_host`, `me::level1_host`, with the shim's forms of the
packed absolute differences and the funnel shift); the card runs the
same functions in the kernels, which the `gpu` tests of K5 and K13
(tests/test_torch_gpu.py) hold against the plain versions.  Built with -ffp-contract=off, so the cost's
product and sum round on their own as nvcc's __fmul_rn / __fadd_rn do.
Skips only where there is no g++.
"""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmtpu.search import me as jme
from hmtpu_torch.common import lambdas
from hmtpu_torch.kernels import CSRC
from hmtpu_torch.search import me as pme
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)

_LANES_CPP = r"""
#include "me_sad.cuh"
extern "C" int me_levels_host(const int* ref, const int* org, int* out8,
                              int* out16, int* out32, int H, int W, int R,
                              int bd, float lam) {
  if (H % 16 || W % 16 || R < 0 || R > me::MAX_R || (bd != 8 && bd != 10))
    return 1;
  if (bd == 8)
    me::levels_host<4>(ref, org, out8, out16, out32, H, W, R, lam);
  else
    me::levels_host<2>(ref, org, out8, out16, out32, H, W, R, lam);
  return 0;
}
extern "C" int me_level1_host(const int* ref, const int* org, const int* pmx,
                              const int* pmy, int* out, int H, int W, int R,
                              int bd, float lam) {
  if (H % 8 || W % 8 || R < 0 || R > me::MAX_R || (bd != 8 && bd != 10))
    return 1;
  if (bd == 8)
    me::level1_host<4>(ref, org, pmx, pmy, out, H, W, R, lam);
  else
    me::level1_host<2>(ref, org, pmx, pmy, out, H, W, R, lam);
  return 0;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile csrc/me_sad.cuh as host C++")
    d = tmp_path_factory.mktemp("me_sad")
    src, so = d / "me.cpp", d / "libme.so"
    src.write_text(_LANES_CPP)
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(CSRC), "-o", str(so), str(src)],
                   check=True, capture_output=True)
    return _load(so)


def _load(so):
    lib = ctypes.CDLL(str(so))
    lib.me_levels_host.argtypes = [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 4 + [ctypes.c_float]
    lib.me_level1_host.argtypes = lib.me_levels_host.argtypes
    return lib


def _host_levels(lib, ref, org, srange, lam, bd):
    """The host build's outputs in the plain version's form."""
    h, w = org.shape
    bh, bw = h // 8, w // 8
    gh, gw = bh // 2, bw // 2
    qh, qw = (gh + 1) // 2, (gw + 1) // 2
    r32 = np.ascontiguousarray(ref, np.int32)
    o32 = np.ascontiguousarray(org, np.int32)
    outs = [np.full((a * b, 12), -7777, np.int32)
            for a, b in ((bh, bw), (gh, gw), (qh, qw))]
    assert lib.me_levels_host(r32.ctypes.data, o32.ctypes.data,
                              *(o.ctypes.data for o in outs), h, w, srange,
                              bd, float(lam)) == 0
    return {n: ((o[:, 0].reshape(a, b), o[:, 1].reshape(a, b)),
                o[:, 3:].reshape(a, b, 3, 3), o[:, 2].reshape(a, b))
            for n, o, (a, b) in zip((8, 16, 32), outs,
                                    ((bh, bw), (gh, gw), (qh, qw)))}


def _planes(rng, h, w, bd, content):
    """A textured picture and a shifted, noisy copy of it (the reference),
    or a flat picture, as bd-bit samples."""
    if content == "flat":
        p = np.full((h, w), 90 << (bd - 8), np.int64)
        return p, p.copy()
    yy, xx = np.mgrid[0:h, 0:w]
    org = 128 + 60 * np.sin(xx / 6.0) * np.cos(yy / 4.0) \
        + rng.randint(-25, 26, (h, w))
    ref = np.roll(org, (3, -5), (0, 1)) + rng.randint(-6, 7, (h, w))
    top = (1 << bd) - 1
    return (np.clip(org * (1 << (bd - 8)) + rng.randint(0, 1 << (bd - 8),
                                                        (h, w)), 0, top),
            np.clip(ref * (1 << (bd - 8)), 0, top))


def _flatten(d):
    return [np.asarray(x) for n in (8, 16, 32)
            for x in (*d[n][0], d[n][1], d[n][2])]


# (h, w, search range, bit depth, content); 48x80 has a padded bottom
# and right strip on the 32-grid; SR 16 makes three dx units a row, SR 8
# two and a third that is one displacement wide
CASES = [(64, 64, 8, 8, "textured"), (48, 80, 16, 8, "textured"),
         (64, 64, 16, 10, "textured"), (48, 80, 8, 10, "textured"),
         (48, 80, 16, 8, "flat"), (64, 64, 8, 10, "flat")]


@pytest.mark.parametrize("h,w,srange,bd,content", CASES)
def test_me_sad_host_equals_plain_and_hmtpu(lib, h, w, srange, bd,
                                            content):
    rng = np.random.RandomState(h + w + srange + bd)
    org, ref = _planes(rng, h, w, bd, content)
    qh, qw = (h // 16 + 1) // 2, (w // 16 + 1) // 2
    lams = (np.float32(0.0),) if content == "flat" else (
        np.float32(0.0), np.float32(lambdas.frame_lambdas(
            22, 22, 0.4624 * 2.0)[1] * (1 << (bd - 8))))
    for lam in lams:
        got = _flatten(_host_levels(lib, ref, org, srange, lam, bd))
        t = lambda a: torch.as_tensor(np.asarray(a, np.int32))
        plain = _flatten(pme.integer_me_levels_plain(t(ref), t(org), srange,
                                                     lam, qh, qw))
        ref_j = _flatten(jme.integer_me_levels(
            jnp.asarray(ref, jnp.int32), jnp.asarray(org, jnp.int32),
            srange, jnp.float32(lam), qh, qw))
        for g, p, j in zip(got, plain, ref_j):
            np.testing.assert_array_equal(g, p)
            np.testing.assert_array_equal(p, j)
    if content == "flat":
        # every displacement ties: the first index, (-R, -R), at each level
        assert all((x == -srange).all() for x in got[0::4] + got[1::4])
    else:
        assert got[0].any()           # the search moved


def test_me_sad_host_mutation_is_caught(lib, tmp_path):
    """Copies of the header with a unit that skips its last displacement
    (8 bits) and with the 10-bit funnel shift by a byte instead of a
    halfword must disagree with the plain version: the comparison sees
    the units' layout and the packed arithmetic of both depths."""
    cxx = shutil.which("g++")
    for k, (good, bad, bd) in enumerate((
            ("for (int j = 0; j < 8; ++j)\n    HM_UNROLL\n    for (int k",
             "for (int j = 0; j < 7; ++j)\n    HM_UNROLL\n    for (int k", 8),
            ("(b % P) * (32 / P))", "(b % P) * 8)", 10))):
        d = tmp_path / str(k)
        csrc = d / "csrc"
        shutil.copytree(CSRC, csrc)
        p = csrc / "me_sad.cuh"
        text = p.read_text()
        assert text.count(good) == 1
        p.write_text(text.replace(good, bad))
        (d / "me.cpp").write_text(_LANES_CPP)
        subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off",
                        "-shared", "-fPIC", "-I", str(csrc), "-o",
                        str(d / "libme.so"), str(d / "me.cpp")],
                       check=True, capture_output=True)
        mut = _load(d / "libme.so")
        org, ref = _planes(np.random.RandomState(5), 64, 64, bd, "textured")
        lam = np.float32(7.5)
        got = _flatten(_host_levels(mut, ref, org, 8, lam, bd))
        t = lambda a: torch.as_tensor(np.asarray(a, np.int32))
        want = _flatten(pme.integer_me_levels_plain(t(ref), t(org), 8, lam,
                                                    2, 2))
        assert any(not np.array_equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# K13: the single level, a quarter-pel predictor per cell

def _host_level1(lib, ref, org, pmx, pmy, srange, lam, bd):
    """The host build's K13 outputs in the plain version's form."""
    h, w = org.shape
    bh, bw = h // 8, w // 8
    arrs = [np.ascontiguousarray(a, np.int32) for a in (ref, org, pmx, pmy)]
    out = np.full((bh * bw, 12), -7777, np.int32)
    assert lib.me_level1_host(*(a.ctypes.data for a in arrs),
                              out.ctypes.data, h, w, srange, bd,
                              float(lam)) == 0
    return ((out[:, 0].reshape(bh, bw), out[:, 1].reshape(bh, bw)),
            out[:, 3:].reshape(bh, bw, 3, 3), out[:, 2].reshape(bh, bw))


def _flat1(d):
    return [np.asarray(x) for x in (*d[0], d[1], d[2])]


# (h, w, bit depth, content): sides that are not multiples of 16 or 32
# (56 rows: the last region row holds three cell rows; 80 columns: the
# last region column two), SR 16 (three dx units a row, the last one
# displacement wide), as hmtpu's own dataset test compiles integer_me
# at 56x64
CASES1 = [(56, 64, 8, "textured"), (56, 64, 10, "textured"),
          (48, 80, 8, "textured"), (48, 80, 10, "textured"),
          (56, 64, 8, "flat"), (48, 80, 10, "flat")]


@pytest.mark.parametrize("h,w,bd,content", CASES1)
def test_me_sad1_host_equals_plain_and_hmtpu(lib, h, w, bd, content):
    srange = 16
    rng = np.random.RandomState(3 * h + w + bd)
    org, ref = _planes(rng, h, w, bd, content)
    bh, bw = h // 8, w // 8
    zero = np.zeros((bh, bw), np.int32)
    pm = [rng.randint(-70, 71, (bh, bw)).astype(np.int32) for _ in range(2)]
    lam1 = np.float32(lambdas.frame_lambdas(27, 27, 0.4624 * 2.0)[1]
                      * (1 << (bd - 8)))
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32))
    for lam, (px, py) in ((np.float32(0.0), (zero, zero)), (lam1, pm),
                          (np.float32(0.5), pm)):
        got = _flat1(_host_level1(lib, ref, org, px, py, srange, lam, bd))
        plain = _flat1(pme.integer_me_plain(t(ref), t(org), 8, srange, lam,
                                            t(px), t(py)))
        ref_j = _flat1(jme.integer_me(
            jnp.asarray(ref, jnp.int32), jnp.asarray(org, jnp.int32), 8,
            srange, jnp.float32(lam), jnp.asarray(px), jnp.asarray(py)))
        for g, p, j in zip(got, plain, ref_j):
            np.testing.assert_array_equal(g, p)
            np.testing.assert_array_equal(p, j)
        if content == "flat" and lam == 0:
            # every displacement ties: the first index, (-R, -R)
            assert (got[0] == -srange).all() and (got[1] == -srange).all()
    if content != "flat":
        assert got[0].any() and got[1].any()      # the search moved


def test_me_sad1_host_mutation_is_caught(lib, tmp_path):
    """A copy of the header whose MV bits drop the cell's predictor must
    disagree with the plain version where the predictors are not zero:
    the comparison above sees each cell's own predictor in its cost."""
    cxx = shutil.which("g++")
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "me_sad.cuh"
    text = p.read_text()
    good = "return bits_of((di - R) * 4 - p);"
    assert text.count(good) == 1
    p.write_text(text.replace(good, "return bits_of((di - R) * 4);"))
    (tmp_path / "me.cpp").write_text(_LANES_CPP)
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(csrc), "-o", str(tmp_path / "m.so"),
                    str(tmp_path / "me.cpp")], check=True,
                   capture_output=True)
    mut = _load(tmp_path / "m.so")
    rng = np.random.RandomState(9)
    org, ref = _planes(rng, 56, 64, 8, "textured")
    pm = [rng.randint(-70, 71, (7, 8)).astype(np.int32) for _ in range(2)]
    lam = np.float32(60.0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32))
    want = _flat1(pme.integer_me_plain(t(ref), t(org), 8, 16, lam, t(pm[0]),
                                       t(pm[1])))
    got = _flat1(_host_level1(lib, ref, org, *pm, 16, lam, 8))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    bad = _flat1(_host_level1(mut, ref, org, *pm, 16, lam, 8))
    assert any(not np.array_equal(g, w) for g, w in zip(bad, want))
