"""K6 nnfme's lane code (csrc/nnfme.cuh `infer_row`: a row on a warp,
one output unit a lane, the first-index argmax as a warp argmin; the
rows of up to three CU levels in one launch, each level's int32 stencils
converted as `.to(torch.float32)` does and its rows sized by the level)
compiled as host C++ with g++ and driven on the CPU against the port's
plain version (`forward_plain` and `_classes`, a level at a time, as
`predict_offsets_levels_plain` composes them), bit for bit: the logits,
the classes and the offsets, at 1, 31 and 257 rows a level, at one level
(float32 costs with per-row sizes, and int32 stencils with the level's
size), and on weights built so that logits tie (the first index wins).

The host build runs every lane of a `HM_LANES` loop on one thread, in
order or (`lane_reverse`) last lane first.  Built with -ffp-contract=off,
so every product and sum rounds on its own as nvcc's __fmul_rn /
__fadd_rn do.  A mutated header whose argmax lets the upper logit of a
lane win a tie must disagree on the tied weights.  The card runs the
same functions in the kernel, which the `gpu` test of K6
(tests/test_torch_gpu.py) and chip_smoke.py hold to the plain version.
Skips only where there is no g++.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hmtpu_torch.kernels import CSRC
from hmtpu_torch.models import nnfme
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)

_LANES_CPP = r"""
#include "nnfme.cuh"
extern "C" void lane_reverse(int r) { hm::lane_reverse = r; }
extern "C" void infer_host(const float* pack, const void* c0, const void* c1,
                           const void* c2, const int* h, const int* w,
                           float* logits, int* cls, int* offs, int r0, int r1,
                           int r2, int s0, int s1, int s2, int nlev,
                           int f32) {
  const nnfme::Levels a{{c0, c1, c2}, {r0, r1, r2}, {s0, s1, s2}, nlev, f32,
                        h, w, logits, cls, offs};
  nnfme::infer_host(pack, a);
}
"""


def _build(csrc, d):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile csrc/nnfme.cuh as host C++")
    src, so = d / "lanes.cpp", d / "liblanes.so"
    src.write_text(_LANES_CPP)
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(csrc), "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lane_reverse.argtypes = [i]
    lib.infer_host.argtypes = [p] * 9 + [i] * 8
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(CSRC, tmp_path_factory.mktemp("nnfme_infer_lanes"))


def _ptr(a):
    return a.ctypes.data if a is not None else None


def _params(tied=False):
    """The in-repo QP-22 weights; `tied`: units 8, 20 and 40 given one
    weight row and a bias far above the others', so every row's logits
    8, 20 and 40 tie as its largest (8 and 40 on one lane)."""
    d = dict(np.load(f"{nnfme.WEIGHTS_DIR}/qp22.npz"))
    if tied:
        w3, b3 = d["w3"].copy(), d["b3"].copy()
        for j in (20, 40):
            w3[j] = w3[8]
        b3[[8, 20, 40]] = 1e12
        d.update(w3=w3, b3=b3)
    return nnfme.params_from_arrays(d, "cpu")


def _stencils(rng, rows, n):
    """ME-like int32 stencils of `rows` PUs of size n (a few above 2^24,
    where the float32 conversion rounds)."""
    base = rng.randint(50, 40000, (rows, 1)) * (n // 8) ** 2
    st = (base + rng.randint(0, 3000, (rows, 9))).astype(np.int32)
    st[::7, 4] = (1 << 24) + 2 * rng.randint(0, 1000, len(st[::7])) + 1
    return st.reshape(rows, 3, 3)


def _host(lib, params, costs, sizes, reverse, heights=None, widths=None):
    rows = [c.size // 9 for c in costs]
    B = sum(rows)
    logits = np.full((B, 49), np.nan, np.float32)
    cls = np.full(B, -99, np.int32)
    offs = np.full((B, 2), -99, np.int32)
    pk = params.packed.numpy()
    pad = 3 - len(costs)
    lib.lane_reverse(int(reverse))
    try:
        lib.infer_host(_ptr(pk), *(_ptr(c) for c in costs), *(None,) * pad,
                       _ptr(heights), _ptr(widths), _ptr(logits), _ptr(cls),
                       _ptr(offs), *rows, *(0,) * pad, *sizes,
                       *(0,) * pad, len(costs),
                       int(costs[0].dtype == np.float32))
    finally:
        lib.lane_reverse(0)
    return logits, cls, offs


def _same_bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def _plain_levels(params, stens, sizes):
    """The plain version, logits included: a level at a time."""
    logits, cls, offs = [], [], []
    for st, n in zip(stens, sizes):
        st9 = torch.as_tensor(st).reshape(-1, 9).to(torch.float32)
        sz = torch.full((st9.shape[0],), n, dtype=torch.int32)
        lg = nnfme.forward_plain(params, st9, sz, sz)
        c, o = nnfme._classes(lg)
        logits.append(lg.numpy())
        cls.append(c.numpy())
        offs.append(o.numpy())
    return (np.concatenate(logits), np.concatenate(cls),
            np.concatenate(offs))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("rows", [1, 31, 257])
def test_three_levels_equal_plain(lib, rows, reverse):
    """The P pass's form: three levels' int32 stencils (8, 16, 32) of
    `rows` rows each, against the plain version a level at a time."""
    rng = np.random.RandomState(rows)
    params = _params()
    sizes = (8, 16, 32)
    stens = [_stencils(rng, rows, n) for n in sizes]
    got = _host(lib, params, stens, sizes, reverse)
    want = _plain_levels(params, stens, sizes)
    assert _same_bits(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    # and the plain level entry gives the same classes and offsets
    plain = nnfme.predict_offsets_levels(
        params, [torch.as_tensor(s) for s in stens], sizes)
    np.testing.assert_array_equal(
        np.concatenate([c.numpy() for c, _ in plain]), want[1])
    np.testing.assert_array_equal(
        np.concatenate([o.numpy() for _, o in plain]), want[2])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("form", ["int32", "float32"])
def test_one_level_equal_plain(lib, form, reverse):
    """One level: its int32 stencils at size 16 (the single-level P
    pass), or float32 costs with per-row heights and widths of every
    table row (`forward` / `predict_offsets`)."""
    rng = np.random.RandomState(3)
    params = _params()
    st = _stencils(rng, 100, 16)
    if form == "int32":
        got = _host(lib, params, [st], (16,), reverse)
        want = _plain_levels(params, [st], (16,))
    else:
        c9 = st.reshape(-1, 9).astype(np.float32)
        hs = rng.choice([4, 8, 12, 16, 20, 24, 32, 64], 100).astype(np.int32)
        ws = rng.choice([4, 8, 12, 16, 20, 24, 32, 64], 100).astype(np.int32)
        got = _host(lib, params, [c9], (0,), reverse, hs, ws)
        lg = nnfme.forward_plain(params, *map(torch.as_tensor, (c9, hs, ws)))
        want = (lg.numpy(),) + tuple(a.numpy() for a in nnfme._classes(lg))
    assert _same_bits(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("reverse", [False, True])
def test_tied_logits_first_index(lib, reverse):
    """Logits 8, 20 and 40 tie as the largest on every row: class 8, as
    the plain version's argmax gives (the first index)."""
    rng = np.random.RandomState(4)
    params = _params(tied=True)
    stens = [_stencils(rng, 33, n) for n in (8, 16, 32)]
    got = _host(lib, params, stens, (8, 16, 32), reverse)
    want = _plain_levels(params, stens, (8, 16, 32))
    assert (got[0][:, 8] == got[0][:, 40]).all()
    assert (got[0][:, 8] == got[0][:, 20]).all()
    assert (want[1] == 8).all()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_tie_rule_mutation_is_caught(lib, tmp_path):
    """A copy of the header whose argmax lets a lane's upper logit win a
    tie (>= for >) gives another class on the tied weights, where the header
    as it is gives the plain version's 8."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "nnfme.cuh"
    text = p.read_text()
    good = "const bool up = j < 17 && hi[j] > lo[j];"
    assert text.count(good) == 1
    p.write_text(text.replace(good, good.replace(">", ">=")))
    (tmp_path / "b").mkdir()
    mut = _build(csrc, tmp_path / "b")
    rng = np.random.RandomState(5)
    params = _params(tied=True)
    stens = [_stencils(rng, 9, 8)]
    want = _plain_levels(params, stens, (8,))[1]
    for reverse in (False, True):
        np.testing.assert_array_equal(
            _host(lib, params, stens, (8,), reverse)[1], want)
        assert not np.array_equal(
            _host(mut, params, stens, (8,), reverse)[1], want), reverse
