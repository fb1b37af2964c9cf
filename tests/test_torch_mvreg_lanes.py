"""K19 mv_regularize's lane code (csrc/mv_regularize.cuh: a cell on a
warp, two samples a lane, the six candidates' SADs as six partial sums
reduced by warp sums, lanes 0-5 pricing a candidate each and
`lane_argmin` picking the winner; every round reading the field the round
before wrote and writing a buffer of its own) compiled as host C++ with
g++ and driven on the CPU against `regularize_mv_field_plain`, bit for
bit, at 48x64, 56x64 and 8x16 for 1 to 4 rounds (the returned field
written by the last round whatever the buffers' parity), on fields whose
neighbours coincide with a distinct column at the right edge (which the
left edge sees through the wrap-around), as
tests/test_torch_inter_ops.py builds them.

The host build runs a round's cells in turn and a cell's lanes in a loop,
in order or (`lane_reverse`) last lane first.  Two mutated headers must
disagree: one whose winner is the last of equal costs (`<=` for `<` in
the argmin), on flat planes where distinct candidates tie, and one whose
rounds read the buffer they write.  The card runs the same functions in
the kernel (all rounds in one cooperative launch, a grid barrier between
rounds), which the `gpu` test of K19 (tests/test_torch_gpu.py) and
chip_smoke.py hold to the plain version.  Skips only where there is no
g++.
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
#include "mv_regularize.cuh"
extern "C" void lane_reverse(int r) { hm::lane_reverse = r; }
extern "C" void rounds_host(const int* refs, const int* org,
                            const float* lam, const int* ix, const int* iy,
                            const int* ir, int* ox, int* oy, int* orr,
                            int* tx, int* ty, int* tr, int R, int H, int W,
                            int iters) {
  mvr::Args a{refs, org, lam, {ix, iy, ir}, {ox, oy, orr}, {tx, ty, tr},
              R, H, W, H / 8, W / 8, iters};
  mvr::rounds_host(a);
}
"""


def _build(csrc, d):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile csrc/mv_regularize.cuh as host "
                    "C++")
    src, so = d / "lanes.cpp", d / "liblanes.so"
    src.write_text(_LANES_CPP)
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(csrc), "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lane_reverse.argtypes = [i]
    lib.rounds_host.argtypes = [p] * 12 + [i] * 4
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(CSRC, tmp_path_factory.mktemp("mvreg_lanes"))


def _i32(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.int32))


def _host(lib, refs, org, mvx, mvy, ridx, lam, iters, reverse):
    r, h, w = refs.shape
    lam_t = torch.tensor([lam], dtype=torch.float32)
    out = torch.full((3,) + tuple(mvx.shape), -99, dtype=torch.int32)
    tmp = torch.zeros_like(out)
    lib.lane_reverse(int(reverse))
    try:
        lib.rounds_host(refs.data_ptr(), org.data_ptr(), lam_t.data_ptr(),
                        mvx.data_ptr(), mvy.data_ptr(), ridx.data_ptr(),
                        *(out[i].data_ptr() for i in range(3)),
                        *(tmp[i].data_ptr() for i in range(3)), r, h, w,
                        iters)
    finally:
        lib.lane_reverse(0)
    return tuple(out)


def _inputs(rng, h, w, flat=False):
    """A textured picture and three references (a shifted, noisy copy and
    two more), or flat planes (every candidate's SAD equal); a field of a
    few distinct vectors (neighbours coincide) with a distinct column at
    the right edge; references 0-2."""
    yy, xx = np.mgrid[0:h, 0:w]
    if flat:
        org = np.full((h, w), 100)
        refs = np.full((3, h, w), 103)
    else:
        org = np.clip(128 + 50 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
                      + rng.randint(-20, 21, (h, w)), 0, 255)
        refs = np.stack([np.clip(np.roll(org, s, (0, 1))
                                 + rng.randint(-4, 5, (h, w)), 0, 255)
                         for s in ((2, -3), (-1, 4), (0, 0))])
    bh, bw = h // 8, w // 8
    mvx = rng.choice([-3, 0, 2, 5], (bh, bw))
    mvy = rng.choice([-1, 0, 4], (bh, bw))
    mvx[:, -1] = 7
    ridx = rng.randint(0, 3, (bh, bw))
    return [_i32(a) for a in (refs, org, mvx, mvy, ridx)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("h,w", [(48, 64), (56, 64), (8, 16)])
def test_rounds_equal_plain(lib, h, w, reverse):
    """1 to 4 rounds: the field equal to the plain version's, and moved
    from the input."""
    rng = np.random.RandomState(h + w)
    refs, org, mvx, mvy, ridx = _inputs(rng, h, w)
    lam = np.float32(6.25)
    for iters in (1, 2, 3, 4):
        want = me.regularize_mv_field_plain(refs, org, mvx, mvy, ridx,
                                            torch.tensor(lam), iters)
        got = _host(lib, refs, org, mvx, mvy, ridx, lam, iters, reverse)
        for g, wv in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), wv.numpy())
        assert not all(torch.equal(g, a) for g, a in zip(got,
                                                         (mvx, mvy, ridx)))
    # the CPU entry is the plain version (4 rounds)
    for g, wv in zip(me.regularize_mv_field(refs, org, mvx, mvy, ridx,
                                            torch.tensor(lam), 4), want):
        assert torch.equal(g, wv)


def _mutant(tmp_path, good, bad):
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "mv_regularize.cuh"
    text = p.read_text()
    assert text.count(good) == 1, good
    p.write_text(text.replace(good, bad))
    (tmp_path / "b").mkdir()
    return _build(csrc, tmp_path / "b")


def test_tie_mutation_is_caught(lib, tmp_path):
    """Flat planes: every candidate's SAD is equal, so distinct candidates
    of equal bits tie; a copy of the lanes' argmin (hm_port.cuh's
    `lane_argmin`, host form) that keeps the last of equal costs (`<=`
    for `<`) picks other vectors."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "hm_port.cuh"
    text = p.read_text()
    good = "    if (x[j] < v || (x[j] == v && key[j] < k)) {"
    assert text.count(good) == 1
    p.write_text(text.replace(good, "    if (x[j] <= v) {"))
    (tmp_path / "b").mkdir()
    mut = _build(csrc, tmp_path / "b")
    rng = np.random.RandomState(5)
    refs, org, mvx, mvy, ridx = _inputs(rng, 48, 64, flat=True)
    lam = np.float32(6.25)
    want = me.regularize_mv_field_plain(refs, org, mvx, mvy, ridx,
                                        torch.tensor(lam), 3)
    for reverse in (False, True):
        got = _host(lib, refs, org, mvx, mvy, ridx, lam, 3, reverse)
        assert all(torch.equal(g, wv) for g, wv in zip(got, want))
        got = _host(mut, refs, org, mvx, mvy, ridx, lam, 3, reverse)
        assert not all(torch.equal(g, wv) for g, wv in zip(got, want))


def test_round_reading_its_own_buffer_is_caught(lib, tmp_path):
    """A copy of the header whose rounds read the buffer they write (not
    the one the round before wrote) disagrees for 2 to 4 rounds."""
    mut = _mutant(tmp_path, "return k == 0 ? a.in[c] : dst(a, k - 1, c);",
                  "return k == 0 ? a.in[c] : dst(a, k, c);")
    rng = np.random.RandomState(56)
    refs, org, mvx, mvy, ridx = _inputs(rng, 56, 64)
    lam = np.float32(6.25)
    for iters in (2, 3, 4):
        want = me.regularize_mv_field_plain(refs, org, mvx, mvy, ridx,
                                            torch.tensor(lam), iters)
        got = _host(mut, refs, org, mvx, mvy, ridx, lam, iters, False)
        assert not all(torch.equal(g, wv) for g, wv in zip(got, want)), \
            iters
