"""K9 frac_refine's lane code (csrc/frac_refine.cuh: a warp a PU, the
patch and a column of candidates' horizontal sums in the warp's shared
memory, a lane a column of an 8x8 tile, an 8x8 PU's three candidates of a
column side by side, the stage's pick by `hm::lane_argmin`) compiled as
host C++ with g++ and driven on the CPU against the port's plain versions,
bit for bit: the one-call form against `frac_refine_batch_plain` at n = 8,
16 and 32, 8 and 10 bits, on 64x64 and 80x48 references with integer MVs
of +-48 (every candidate's patch reaches past some edge), and the levels
form (the launch's indexing over up to three levels, each level's
original read in place with rows and columns clamped to the plane)
against `frac_refine_levels_plain` at 64x56, where the 32 level's
original reaches past the plane's last row.

The host build runs every lane of a `HM_LANES` loop on one thread, in
order or (`lane_reverse`) last lane first.  A flat block on a flat
reference prices every candidate alike, so the centre must win both
stages.  Two mutated headers must disagree: the argmin keeping the last
equal cost, and the intermediate offset and shift applied where only the
horizontal phase is non-zero.  One case holds the plain levels form to
hmtpu's composition (three calls of `hmtpu.search.me.frac_refine_batch`
on the edge-padded original, hmtpu/encoder/pframe_dev.py:1667-1745).
The card runs the same functions in the kernels, which the `gpu` test of
K9 (tests/test_torch_gpu.py) and chip_smoke.py hold to the plain
versions.  Skips only where there is no g++.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hmtpu_torch.kernels import CSRC
from hmtpu_torch.search import me
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)

_LANES_CPP = r"""
#include "frac_refine.cuh"
extern "C" void lane_reverse(int r) { hm::lane_reverse = r; }
// the one-call form: org (nb, n, n) at xs0 / ys0 -> out (2, nb)
extern "C" void frac_host(const int* refs, int R, int H, int W,
                          const int* org, const int* xs0, const int* ys0,
                          const int* ridx, const int* mvx, const int* mvy,
                          int* out, int n, int nb, int bd) {
  frac::job_host(frac::Job{refs, R, H, W, org, 0, 0, xs0, ys0, ridx, mvx,
                           mvy, out, n, 0, nb, bd});
}
// the levels form over the (oh, ow) plane: nlev levels' grids (n, gw,
// nb), MVs, references and outputs one after another
extern "C" void levels_host(const int* refs, int R, int H, int W,
                            const int* org, int oh, int ow, int nlev,
                            const int* geo, const int* const* mvx,
                            const int* const* mvy, const int* const* ridx,
                            int* const* out, int bd) {
  frac::Levels g{};
  for (int l = 0; l < nlev; ++l) {
    g.lv[l] = frac::Job{refs, R, H, W, org, oh, ow, nullptr, nullptr,
                        ridx[l], mvx[l], mvy[l], out[l], geo[3 * l],
                        geo[3 * l + 1], geo[3 * l + 2], bd};
    g.nb[l] = geo[3 * l + 2];
  }
  frac::levels_host(g);
}
"""


def _build(csrc, d):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile csrc/frac_refine.cuh as host C++")
    src, so = d / "lanes.cpp", d / "liblanes.so"
    src.write_text(_LANES_CPP)
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(csrc), "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lane_reverse.argtypes = [i]
    lib.frac_host.argtypes = [p, i, i, i] + [p] * 7 + [i, i, i]
    lib.levels_host.argtypes = [p, i, i, i, p, i, i, i] + [p] * 5 + [i]
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(CSRC, tmp_path_factory.mktemp("frac_lanes"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    # the plain versions' small operations beside the other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _i32(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.int32))


def _reversed(lib, reverse, fn):
    lib.lane_reverse(int(reverse))
    try:
        return fn()
    finally:
        lib.lane_reverse(0)


def _frac_host(lib, refs, org, xs, ys, ridx, mvx, mvy, n, bd, reverse):
    nb = org.shape[0]
    out = torch.full((2, nb), -99, dtype=torch.int32)
    r, h, w = refs.shape
    _reversed(lib, reverse, lambda: lib.frac_host(
        refs.data_ptr(), r, h, w, org.data_ptr(), xs.data_ptr(),
        ys.data_ptr(), ridx.data_ptr(), mvx.data_ptr(), mvy.data_ptr(),
        out.data_ptr(), n, nb, bd))
    return out[0], out[1]


def _levels_host(lib, refs, org, levels, bd, reverse):
    outs = [torch.full((2, lv[0].numel()), -99, dtype=torch.int32)
            for lv in levels]
    geo = _i32([[n, mx.shape[1], mx.numel()] for mx, _, _, n in levels])
    arr = lambda ts: (ctypes.c_void_p * 3)(*[t.data_ptr() for t in ts])
    r, h, w = refs.shape
    _reversed(lib, reverse, lambda: lib.levels_host(
        refs.data_ptr(), r, h, w, org.data_ptr(), *org.shape, len(levels),
        geo.data_ptr(), arr([lv[0] for lv in levels]),
        arr([lv[1] for lv in levels]), arr([lv[2] for lv in levels]),
        arr(outs), bd))
    return [(o[0].view(lv[0].shape), o[1].view(lv[0].shape))
            for o, lv in zip(outs, levels)]


def _planes(rng, r, h, w, bd):
    """r textured reference planes and the original of an h x w picture
    (the first reference moved and noisy), bd-bit samples."""
    yy, xx = np.mgrid[0:h + 8, 0:w + 8]
    top = (1 << bd) - 1
    base = (1 << (bd - 1)) + (top // 4) * np.sin(xx / 3.7) * np.cos(yy / 5.3)
    refs = [np.clip(base[k % 3:k % 3 + h, k:k + w]
                    + rng.randint(-top // 16, top // 16 + 1, (h, w)), 0, top)
            for k in range(r)]
    org = np.clip(base[2:2 + h, 3:3 + w]
                  + rng.randint(-top // 20, top // 20 + 1, (h, w)), 0, top)
    return _i32(np.stack(refs)), _i32(org)


def _one_call(rng, refs, org, n):
    """Every n x n block of the picture (the last row and column of
    blocks where they fit), a seeded reference and integer MV (+-48) each."""
    _, h, w = refs.shape
    gh, gw = h // n, w // n
    q = np.arange(gh * gw)
    xs, ys = _i32((q % gw) * n), _i32((q // gw) * n)
    blocks = org[:gh * n, :gw * n].reshape(gh, n, gw, n).transpose(1, 2) \
        .reshape(-1, n, n).contiguous()
    ridx = _i32(rng.randint(0, refs.shape[0], q.size))
    mvx, mvy = (_i32(rng.randint(-48, 49, q.size)) for _ in range(2))
    return blocks, xs, ys, ridx, mvx, mvy


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_one_call_equals_plain(lib, n, bd):
    """The one-call form on 64x64 and 80x48 pictures, lanes in order and
    reversed: the quarter-pel MVs equal the plain version's; some blocks
    leave the integer MV."""
    rng = np.random.RandomState(n + bd)
    moved = 0
    for h, w in ((64, 64), (48, 80)):
        refs, org = _planes(rng, 3, h, w, bd)
        blocks, xs, ys, ridx, mvx, mvy = _one_call(rng, refs, org, n)
        want = me.frac_refine_batch_plain(refs, xs, ys, blocks, mvx, mvy, n,
                                          bd, ridx=ridx)
        for reverse in (False, True):
            got = _frac_host(lib, refs, blocks, xs, ys, ridx, mvx, mvy, n, bd,
                             reverse)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        moved += int(((want[0] != 4 * mvx) | (want[1] != 4 * mvy)).sum())
    assert moved > 0
    # the CPU entry is the plain version
    got = me.frac_refine_batch(refs, xs, ys, blocks, mvx, mvy, n, bd,
                               ridx=ridx)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _flat_case(n):
    refs = torch.full((2, 48, 64), 77, dtype=torch.int32)
    org = torch.full((4, n, n), 77, dtype=torch.int32)
    xs, ys = _i32([0, 16, 32, 32]), _i32([0, 16, 0, 16])
    mv = [_i32([0, -20, 7, 3]), _i32([0, 5, -30, 9])]
    return refs, org, xs, ys, _i32([0, 1, 1, 0]), mv


@pytest.mark.parametrize("n", [8, 16, 32])
def test_flat_centre_wins(lib, n):
    """A flat block on a flat reference: all 18 candidates cost 0, so the
    centre wins both stages and the MV stays 4 * int_mv."""
    refs, org, xs, ys, ridx, (mvx, mvy) = _flat_case(n)
    for reverse in (False, True):
        got = _frac_host(lib, refs, org, xs, ys, ridx, mvx, mvy, n, 8,
                         reverse)
        assert torch.equal(got[0], 4 * mvx) and torch.equal(got[1], 4 * mvy)
    want = me.frac_refine_batch_plain(refs, xs, ys, org, mvx, mvy, n, 8,
                                      ridx=ridx)
    assert torch.equal(want[0], 4 * mvx) and torch.equal(want[1], 4 * mvy)


def _levels(rng, refs, h, w):
    """The 8, 16 and ceil 32 grids of an h x w picture, seeded integer MVs
    (+-48) and references each."""
    out = []
    for n, gh, gw in ((8, h // 8, w // 8), (16, h // 16, w // 16),
                      (32, -(-h // 32), -(-w // 32))):
        mk = lambda lo, hi: _i32(rng.randint(lo, hi, (gh, gw)))
        out.append((mk(-48, 49), mk(-48, 49), mk(0, refs.shape[0]), n))
    return out


@pytest.mark.parametrize("bd", [8, 10])
def test_levels_equal_plain(lib, bd):
    """The levels form at 64x56 (the 16 grid 3 rows, the 32 grid 2 rows,
    its original clamped past the last row), lanes in order and reversed,
    and two levels of the three."""
    rng = np.random.RandomState(56 + bd)
    refs, org = _planes(rng, 4, 56, 64, bd)
    levels = _levels(rng, refs, 56, 64)
    want = me.frac_refine_levels_plain(refs, org, levels, bd)
    for reverse in (False, True):
        got = _levels_host(lib, refs, org, levels, bd, reverse)
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    got = _levels_host(lib, refs, org, levels[1:], bd, False)
    for (gx, gy), (wx, wy) in zip(got, want[1:]):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    # the CPU entry is the plain version
    for a, b in zip(me.frac_refine_levels(refs, org, levels, bd), want):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def _mutant(tmp_path, name, good, bad):
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / name
    text = p.read_text()
    assert text.count(good) == 1, good
    p.write_text(text.replace(good, bad))
    (tmp_path / "b").mkdir()
    return _build(csrc, tmp_path / "b")


def test_argmin_tie_mutation_is_caught(lib, tmp_path):
    """A copy of hm_port.cuh whose argmin keeps the last equal cost picks
    the last candidate of the flat case, not the centre."""
    good = """  for (int j = 1; j < W; ++j)
    if (x[j] < v || (x[j] == v && key[j] < k)) {
      v = x[j];
      k = key[j];
    }
}
#endif"""
    mut = _mutant(tmp_path, "hm_port.cuh", good,
                  good.replace("key[j] < k", "key[j] > k"))
    refs, org, xs, ys, ridx, (mvx, mvy) = _flat_case(8)
    for reverse in (False, True):
        got = _frac_host(mut, refs, org, xs, ys, ridx, mvx, mvy, 8, 8,
                         reverse)
        assert not torch.equal(got[0], 4 * mvx), reverse


def test_honly_shift_mutation_is_caught(lib, tmp_path):
    """A copy of the header that offsets and shifts the horizontal sums
    where only the horizontal phase is non-zero (the intermediate's rule
    for both phases) gives other MVs at 10 bits; the header as it is
    gives the plain version's."""
    mut = _mutant(tmp_path, "frac_refine.cuh",
                  "const bool both = fx != 0 && fy[j] != 0;",
                  "const bool both = fx != 0;")
    rng = np.random.RandomState(10)
    refs, org = _planes(rng, 3, 48, 80, 10)
    blocks, xs, ys, ridx, mvx, mvy = _one_call(rng, refs, org, 8)
    want = me.frac_refine_batch_plain(refs, xs, ys, blocks, mvx, mvy, 8, 10,
                                      ridx=ridx)
    for reverse in (False, True):
        got = _frac_host(lib, refs, blocks, xs, ys, ridx, mvx, mvy, 8, 10,
                         reverse)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        got = _frac_host(mut, refs, blocks, xs, ys, ridx, mvx, mvy, 8, 10,
                         reverse)
        assert not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])), reverse


def test_levels_plain_equals_hmtpu():
    """The plain levels form at a 64x48 picture's three levels (8, 16 and
    the ceil 32 grid, whose original hmtpu edge-pads with jnp.pad) equal
    to hmtpu's three `frac_refine_batch` calls as its P pass makes them,
    with a tolerance of 0."""
    import jax.numpy as jnp

    from hmtpu.search import me as jme

    rng = np.random.RandomState(48)
    h, w = 48, 64
    refs, org = _planes(rng, 2, h, w, 8)
    levels = _levels(rng, refs, h, w)
    got = me.frac_refine_levels_plain(refs, org, levels, 8)
    j = lambda t: jnp.asarray(t.numpy())
    for (mx, my, rr, n), (gx, gy) in zip(levels, got):
        gh, gw = mx.shape
        orgp = jnp.pad(j(org), ((0, gh * n - h), (0, gw * n - w)),
                       mode="edge")
        blocks = orgp.reshape(gh, n, gw, n).transpose(0, 2, 1, 3) \
            .reshape(-1, n, n)
        ys0, xs0 = np.mgrid[0:gh, 0:gw] * n
        qx, qy = jme.frac_refine_batch(
            j(refs), jnp.asarray(xs0.reshape(-1)), jnp.asarray(
                ys0.reshape(-1)), blocks, j(mx).reshape(-1),
            j(my).reshape(-1), n, 8, ridx=j(rr).reshape(-1))
        np.testing.assert_array_equal(np.asarray(qx).reshape(gh, gw), gx)
        np.testing.assert_array_equal(np.asarray(qy).reshape(gh, gw), gy)
