"""K25 sao_choose's lane code (csrc/sao_choose.cuh: a (CTU, plane) on a
warp, lane b band b's offset and, below 16, edge class b >> 2's category
b & 3; the classes' costs, the band runs and both argmins by shuffles;
Cr's decision under Cb's type and class) compiled as host C++ with g++
and driven on the CPU against the port's plain version
(`choose_params_plain`), bit for bit: seeded statistic rows of 28 CTUs at
8 and 10 bits, and rows built for each tie of the plain version's rules
(two edge classes of equal cost: the first; edge equal to band: edge;
equal band runs: the first position; quotients of x.5: half to even) and
for Cr forced by Cb's choice.  One case holds the plain version to
hmtpu's `_choose_params_dev`.

The host build runs every lane of a `HM_LANES` loop on one thread, in
order or (`lane_reverse`) last lane first, and is built with
-ffp-contract=off, so every float32 operation rounds on its own as
nvcc's __fmul_rn / __fadd_rn / __fdiv_rn do.  A mutated header whose
band argmin takes the last of tied runs must disagree.  The card runs
the same functions in the kernel, which the `gpu` test of K25
(tests/test_torch_gpu.py) and chip_smoke.py hold to the plain version.
Skips only where there is no g++.
"""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmtpu_torch.common.lambdas import frame_lambdas
from hmtpu_torch.kernels import CSRC
from hmtpu_torch.ops import sao
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)

_LANES_CPP = r"""
#include "sao_choose.cuh"
extern "C" void lane_reverse(int r) { hm::lane_reverse = r; }
extern "C" void choose_host(const int* st_y, const int* st_u,
                            const int* st_v, float lam, int mo, int* out,
                            int nctu) {
  saoc::choose_host(st_y, st_u, st_v, lam, mo, out, nctu);
}
"""

NY, NX = 4, 7          # 416x240 at CTU 64: 28 CTUs


def _build(csrc, d):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile csrc/sao_choose.cuh as host C++")
    src, so = d / "lanes.cpp", d / "liblanes.so"
    src.write_text(_LANES_CPP)
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(csrc), "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lane_reverse.argtypes = [i]
    lib.choose_host.argtypes = [p, p, p, ctypes.c_float, i, p, i]
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(CSRC, tmp_path_factory.mktemp("sao_choose_lanes"))


def _host(lib, rows, lam, bd, reverse, ny=NY, nx=NX):
    out = torch.full((ny, nx, 3, 7), -99, dtype=torch.int32)
    lib.lane_reverse(int(reverse))
    try:
        lib.choose_host(*(r.data_ptr() for r in rows), float(lam),
                        sao.max_offset(bd), out.data_ptr(), ny * nx)
    finally:
        lib.lane_reverse(0)
    return out


def _lam(qp):
    return torch.tensor(frame_lambdas(qp, qp, 0.57)[0], dtype=torch.float32)


def _seeded(rng, bd, n=NY * NX):
    """Three planes' rows of n CTUs: counts of 0, 1 and many samples,
    sums of both signs around the offsets' clip."""
    rows = []
    for _ in range(3):
        cnt = rng.choice([0, 1, 2, 5, 60, 900], (n, 48))
        s = (rng.randint(-12, 13, cnt.shape) * cnt << (bd - 8)) // 3
        r = np.empty((n, 96), np.int32)
        r[:, 0:16], r[:, 16:32] = s[:, :16], cnt[:, :16]
        r[:, 32:64], r[:, 64:96] = s[:, 16:], cnt[:, 16:]
        rows.append(torch.as_tensor(r))
    return rows


def _row(edge=(), band=()):
    """One CTU's row from {(class, category): (sum, count)} and {band:
    (sum, count)}; everything else no samples."""
    r = np.zeros(96, np.int32)
    for (c, k), (s, n) in dict(edge).items():
        r[c * 4 + k], r[16 + c * 4 + k] = s, n
    for b, (s, n) in dict(band).items():
        r[32 + b], r[64 + b] = s, n
    return r


# class 0's offsets (2, 1, -1, -1) change the distortion by -70 with 11
# bits, as band 0's offset 1 (sum 70 over 70 samples) does with its 11
_EDGE0 = {(0, 0): (20, 10), (0, 1): (10, 10), (0, 2): (-10, 10),
          (0, 3): (-10, 10)}
_TIES = {
    # classes 1 and 2 equal and best, band empty: edge, class 1
    "classes": _row(edge={(c, k): v for c in (1, 2)
                          for (_, k), v in _EDGE0.items()}),
    # edge class 0 against band 0 at equal cost: edge
    "edge_band": _row(edge=_EDGE0, band={0: (70, 70)}),
    # bands 3 and 10 alike, the rest empty: runs 0-3 and 7-10 tie, the
    # first (position 0) wins
    "band_runs": _row(band={3: (60, 20), 10: (60, 20)}),
    # quotients 2.5, 3.5, -2.5 and -1.5: 2, 4, -2, -2
    "halves": _row(edge={(0, 0): (5, 2), (0, 2): (-5, 2)},
                   band={12: (5, 2), 13: (7, 2), 14: (-5, 2),
                         15: (-3, 2)}),
}
_WANT = {"classes": (2, 1), "edge_band": (2, 0), "band_runs": (1, 0),
         "halves": None}


def _tie_rows(case):
    """The case's row on every plane of one CTU (Cr's type and class then
    Cb's own)."""
    r = torch.as_tensor(_TIES[case][None])
    return [r, r.clone(), r.clone()]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bd,qp", [(8, 22), (8, 37), (10, 32)])
def test_seeded_rows_equal_plain(lib, bd, qp, reverse):
    rng = np.random.RandomState(bd * qp)
    rows = _seeded(rng, bd)
    rows[0][:2] = 0        # CTUs without samples: SAO off
    lam = _lam(qp)
    want = sao.choose_params_plain(*rows, lam, bd, NY, NX)
    np.testing.assert_array_equal(_host(lib, rows, lam, bd, reverse), want)
    assert set(want[..., 0].reshape(-1).tolist()) == {0, 1, 2}
    # the CPU entry is the plain version
    assert torch.equal(sao.choose_params(*rows, lam, bd, NY, NX), want)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("case", list(_TIES))
def test_ties_equal_plain(lib, case, reverse):
    """Each tie of the plain version's rules, as it resolves them."""
    lam = torch.tensor(1.5, dtype=torch.float32)
    rows = _tie_rows(case)
    want = sao.choose_params_plain(*rows, lam, 8, 1, 1)
    got = _host(lib, rows, lam, 8, reverse, 1, 1)
    np.testing.assert_array_equal(got, want)
    typ, cls, pos = (int(want[0, 0, 0, k]) for k in range(3))
    if _WANT[case] is not None:
        assert (typ, cls if typ == 2 else pos) == _WANT[case]
    if case == "halves":
        # band 12's run: 2.5 -> 2, 3.5 -> 4, -2.5 -> -2, -1.5 -> -2
        assert (typ, pos) == (1, 12)
        assert want[0, 0, 0, 3:].tolist() == [2, 4, -2, -2]


@pytest.mark.parametrize("reverse", [False, True])
def test_cr_follows_cb(lib, reverse):
    """Cb's rows pick edge class 3, Cr's alone would pick band: Cr takes
    edge class 3 with its own class-3 offsets, on every CTU."""
    lam = torch.tensor(1.5, dtype=torch.float32)
    cb = _row(edge={(3, k[1]): v for k, v in _EDGE0.items()})
    cr = _row(edge={(3, 0): (9, 3), (3, 3): (-6, 3)}, band={5: (90, 30)})
    n = 3
    y = _row(band={7: (40, 10)})
    rows = [torch.as_tensor(np.stack([r] * n)) for r in (y, cb, cr)]
    want = sao.choose_params_plain(*rows, lam, 8, 1, n)
    got = _host(lib, rows, lam, 8, reverse, 1, n)
    np.testing.assert_array_equal(got, want)
    assert want[0, :, 1, :2].tolist() == [[2, 3]] * n
    assert want[0, :, 2, :2].tolist() == [[2, 3]] * n
    assert want[0, :, 2, 3:].tolist() == [[3, 0, 0, -2]] * n
    alone = sao._choose_params_plain(*sao.stats_views(rows[2], 1, n), lam, 8)
    assert alone[0, :, 0].tolist() == [1] * n


def test_plain_equals_hmtpu():
    """The plain version against hmtpu's `_choose_params_dev` on seeded
    rows, Cr under Cb's type and class."""
    from hmtpu.ops import sao as j_sao

    rng = np.random.RandomState(25)
    rows = _seeded(rng, 8)
    lam = _lam(27)
    want = sao.choose_params_plain(*rows, lam, 8, NY, NX)
    jp = lambda r, **k: np.asarray(j_sao._choose_params_dev(
        jnp, *(jnp.asarray(a.numpy()) for a in sao.stats_views(r, NY, NX)),
        jnp.float32(lam), 8, **k))
    j_cb = jp(rows[1])
    ref = np.stack([jp(rows[0]), j_cb, jp(
        rows[2], force_type=jnp.asarray(j_cb[..., 0]),
        force_cls=jnp.asarray(j_cb[..., 1]))], 2)
    np.testing.assert_array_equal(want.numpy(), ref)


def test_band_tie_mutation_is_caught(lib, tmp_path):
    """A copy of the header whose band argmin takes the last of tied
    runs picks position 10 on the equal runs, where the plain version
    (and the header as it is) picks 0."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "sao_choose.cuh"
    text = p.read_text()
    good = "hm::lane_argmin(key, idx, run_b, c.pos);"
    assert text.count(good) == 1 and text.count("idx[j] = j;") == 1
    p.write_text(text.replace("idx[j] = j;", "idx[j] = 31 - j;").replace(
        good, good + " c.pos = 31 - c.pos;"))
    (tmp_path / "b").mkdir()
    mut = _build(csrc, tmp_path / "b")
    lam = torch.tensor(1.5, dtype=torch.float32)
    rows = _tie_rows("band_runs")
    want = sao.choose_params_plain(*rows, lam, 8, 1, 1)
    assert int(want[0, 0, 0, 2]) == 0
    for reverse in (False, True):
        np.testing.assert_array_equal(
            _host(lib, rows, lam, 8, reverse, 1, 1), want)
        got = _host(mut, rows, lam, 8, reverse, 1, 1)
        assert int(got[0, 0, 0, 0]) == 1 and int(got[0, 0, 0, 2]) == 10, \
            reverse
