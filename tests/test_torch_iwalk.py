"""The lane code of K21 i_walk (csrc/iwalk.cuh, the I z-scan walker) and
K22 i_rmd (csrc/i_rmd.cuh, the fused rough mode decision), compiled as
host C++ with g++ and driven on the CPU, against their plain versions
(`iframe_pass_plain`, `rmd_plain`), bit for bit.  The plain versions are
held against hmtpu in tests/test_torch_encode.py and test_torch_ops.py.

The walker runs through `iframe_walk`, the same wrapper that launches K21
on the card, one call of the host build per z-scan level; its task loops
run in order or (`iw_task_reverse`) last task first with the larger
trials before their cells, which the card's groups and teams may do.
The headers are built with -ffp-contract=off, so every float32
operation rounds on its own as nvcc's __fadd_rn / __fmul_rn do.  Skips
only where there is no g++.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hmtpu_torch.common.constants import SliceType
from hmtpu_torch.common.spec_tables import chroma_qp_from_luma
from hmtpu_torch.encoder import iframe_dev
from hmtpu_torch.encoder.intra_rdo import rmd_plain
from hmtpu_torch.entropy.contexts import make_contexts
from hmtpu_torch.entropy.fracbits import ctx_bits_table
from hmtpu_torch.kernels import CSRC
from hmtpu_torch.search.wavefront import static_ref_gather
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)
from tools.gen_test_yuv import synth_clip

_LANES_CPP = r"""
#include <vector>
#include "iwalk.cuh"
#include "i_rmd.cuh"
// one z-scan level of K21: every lane in turn, one thread each
extern "C" int iw_level(const void* scratch, const void* p, int np,
                        const void* v, int nv, const void* f, int nf,
                        int level) {
  if (np != iw::N_PTRS || nv != iw::N_INTS || nf != iw::N_FLTS) return 1;
  iw::Args a = iw::args_from((const long long*)p, (const int*)v,
                             (const float*)f);
  if (a.scratch != scratch || a.scratch_ints != iw::SCRATCH) return 1;
  std::vector<double> sm(iw::smem_bytes(a.geom) / sizeof(double) + 1);
  for (int lane = 0; lane < a.bmax; ++lane)
    iw::walk_lane(a, level, lane, 0, 1, sm.data());
  return 0;
}
// every task loop of the walk last task first, the larger trials before
// their cells (1), or in order (0)
extern "C" void iw_task_reverse(int r) { iw::task_reverse = r; }
// K22 over nb blocks
extern "C" void rmd_host(const int* plane, const int* sub, const int* none,
                         int* out, int nb, int w, int n, int bd, int strong,
                         int k, float lam_sqrt) {
  rmd::Args a{plane, sub, none, out, w, n, bd, strong, k, lam_sqrt};
  std::vector<int> sm(rmd::R_INTS);
  for (int b = 0; b < nb; ++b) rmd::rmd_block(a, b, 0, 1, sm.data());
}
"""


def _build(d, csrc):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile csrc/iwalk.cuh as host C++")
    src, so = d / "lanes.cpp", d / "liblanes.so"
    src.write_text(_LANES_CPP)
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(csrc), "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.iw_level.argtypes = [ctypes.c_void_p] \
        + [ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_int]
    lib.iw_task_reverse.argtypes = [ctypes.c_int]
    lib.rmd_host.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_float]
    return lib


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("iwalk"), CSRC)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runner(lib):
    def run_level(scratch, ptrs, ints, flts, level):
        assert lib.iw_level(scratch.data_ptr(),
                            *(x for a in (ptrs, ints, flts)
                              for x in (ctypes.addressof(a), len(a))),
                            level) == 0
    return run_level


def _textured(w, h, seed):
    """The repo's synthetic clip with 4x4-grained texture on the left half
    (tests/test_torch_encode.py's), so NxN parts occur beside larger CUs."""
    rng = np.random.RandomState(seed)
    y, u, v = next(iter(synth_clip(w, h, 1, seed=seed)))
    tex = np.kron(rng.randint(-50, 51, (h // 4, w // 4)), np.ones((4, 4), int))
    y = y.astype(int)
    y[:, : w // 2] += tex[:, : w // 2]
    return np.clip(y, 0, 255), u, v


def _screen(w, h):
    """Text-like strokes on a flat background (the transform-skip tests'
    seed-7 content) with coloured chroma marks."""
    rng = np.random.RandomState(7)
    y = np.full((h, w), 40, np.int64)
    u = np.full((h // 2, w // 2), 110, np.int64)
    v = np.full((h // 2, w // 2), 140, np.int64)
    for _ in range(30):
        x0, y0 = rng.randint(0, w - 8), rng.randint(0, h - 8)
        y[y0:y0 + 2, x0:x0 + rng.randint(3, 8)] = 220
        u[y0 // 2, x0 // 2:x0 // 2 + 3] = 230
    return y, u, v


# (w, h, qp, bit depth, sdh, ts, content, CU sizes that must occur)
CASES = {
    "64x64-qp22": (64, 64, 22, 8, False, False, "textured", {0, 2}),
    "64x64-qp37-sdh": (64, 64, 37, 8, True, False, "textured", {0, 2}),
    "64x56-8only": (64, 56, 27, 8, False, False, "textured", {0}),
    "80x48-16only": (80, 48, 27, 8, True, False, "textured", {0, 1}),
    "96x64-10bit-ts": (96, 64, 27, 10, False, True, "screen", {0}),
}


def _pass_inputs(name):
    w, h, qp, bd, sdh, ts, content, _ = CASES[name]
    y, u, v = _textured(w, h, qp) if content == "textured" \
        else _screen(w, h)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32) << (bd - 8))
    cb = torch.as_tensor(ctx_bits_table(make_contexts(SliceType.I, qp))
                         .reshape(-1))
    return (t(y), t(u), t(v), qp, chroma_qp_from_luma(qp), cb), \
        dict(w=w, h=h, bd=bd, sis=True, qp_factor=0.57, sdh=sdh, ts=ts)


@pytest.mark.parametrize("name", sorted(CASES))
def test_walker_equals_plain_pass(lanes, name):
    args, kw = _pass_inputs(name)
    want = iframe_dev.iframe_pass_plain(*args, **kw)
    got = iframe_dev.iframe_walk(*args, run_level=_runner(lanes), **kw)
    assert set(got) == set(want)
    for k in sorted(want):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    # the decisions the case is there for: the CU sizes, NxN parts, and
    # transform skip chosen by some TB where it is on
    assert CASES[name][7] <= set(want["cusz"].tolist())
    assert want["part"].any()
    if kw["ts"]:
        assert (want["tsf"] != 0).any()


def test_walker_mutation_is_caught(tmp_path):
    """A copy of the headers with the 16x16 / 32x32 levels' slab order
    broken (each slab written to its neighbour's cell) must disagree with
    the plain pass: the comparison above sees the `levs` packing."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "iwalk.cuh"
    text = p.read_text()
    good = "a.levs[cells[e / 96] * 96 + e % 96] = v;"
    assert text.count(good) == 1
    bad = "a.levs[cells[(e / 96) ^ 1] * 96 + e % 96] = v;"
    p.write_text(text.replace(good, bad))
    lib = _build(tmp_path, csrc)
    args, kw = _pass_inputs("64x64-qp22")
    want = iframe_dev.iframe_pass_plain(*args, **kw)
    got = iframe_dev.iframe_walk(*args, run_level=_runner(lib), **kw)
    assert not torch.equal(got["levs"], want["levs"])
    assert all(torch.equal(got[k], want[k]) for k in want if k != "levs")


def _walk_order(lib, name, reverse):
    """Every state array of the case's pass through the host build with
    its task loops in order, or last task first with the 16x16 and 32x32
    trials before their cells: (got, want)."""
    args, kw = _pass_inputs(name)
    want = iframe_dev.iframe_pass_plain(*args, **kw)
    lib.iw_task_reverse(int(reverse))
    try:
        got = iframe_dev.iframe_walk(*args, run_level=_runner(lib), **kw)
    finally:
        lib.iw_task_reverse(0)
    return got, want


@pytest.mark.parametrize("name", sorted(CASES))
def test_walker_tasks_in_reverse_order(lanes, name):
    """K21 runs a cell's codings side by side (the candidates', their TS
    alternatives, the NxN chroma pair's, the NxN chain's two halves) and
    the 16x16 and 32x32 trials beside their cells: with every round's
    tasks run last task first and each trial before its cells, the host
    build must still give the plain pass's state, bit for bit, so no task
    reads what another task of its round, or a trial what its cells,
    write."""
    got, want = _walk_order(lanes, name, True)
    assert set(got) == set(want)
    for key in sorted(want):
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(),
                                      err_msg=key)


def test_walker_cross_task_read_is_caught(tmp_path):
    """A copy of the headers in which a candidate's chroma U task codes
    from a copy of its prediction that the candidate's luma task makes:
    right when the tasks run in order (heaviest first, as one thread runs
    them), a race between groups on the card.  The reversed order must
    disagree with the plain pass."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "iwalk.cuh"
    text = p.read_text()
    edits = (("m.ly + 64 * t, m.ry + 64 * t);",
              "m.ly + 64 * t, m.ry + 64 * t);\n"
              "    for (int e = L.tid; e < 16; e += L.nt)\n"
              "      (t ? m.r4t : m.l4t)[e] = m.pu[16 * t + e];"),
             ("(v ? m.pv : m.pu) + o, lev + o,",
              "v ? m.pv + o : (k ? m.r4t : m.l4t), lev + o,"))
    for good, bad in edits:
        assert text.count(good) == 1
        text = text.replace(good, bad)
    p.write_text(text)
    lib = _build(tmp_path, csrc)
    got, want = _walk_order(lib, "64x56-8only", False)
    assert all(torch.equal(got[k], want[k]) for k in want)
    got, want = _walk_order(lib, "64x56-8only", True)
    assert any(not torch.equal(got[k], want[k]) for k in want)


def _rmd_plane(content, bd, rng, w=64, h=64):
    if content == "random":
        p = rng.randint(0, 1 << bd, (h, w))
    elif content == "flat":          # every mode ties on SATD 0
        p = np.full((h, w), 1 << (bd - 1))
    else:                            # 16x16 steps: ties among modes
        p = np.kron(rng.randint(0, 4, (h // 16, w // 16)),
                    np.ones((16, 16), int)) * (40 << (bd - 8))
    return torch.as_tensor(p.astype(np.int32))


@pytest.mark.parametrize("n,k", [(4, 1), (8, 2), (8, 1), (16, 2), (32, 2)])
@pytest.mark.parametrize("content", ["random", "flat", "steps"])
def test_rmd_lane_equals_plain(lanes, n, k, content):
    rng = np.random.RandomState(n + k)
    for bd in (8, 10):
        plane = _rmd_plane(content, bd, rng)
        h, w = plane.shape
        sub, none = static_ref_gather(w, h, 6, n)
        nb = (h // n) * (w // n)
        lam = np.float32(5.7 if bd == 8 else 23.1)
        for sis in (False, True):
            want = rmd_plain(plane, (torch.as_tensor(sub).long(),
                                     torch.as_tensor(none)), n, k, bd=bd,
                             lam_sqrt=lam, sis=sis)
            got = torch.zeros((nb, k), dtype=torch.int32)
            s32 = torch.as_tensor(sub.astype(np.int32))
            n32 = torch.as_tensor(none.astype(np.int32))
            lanes.rmd_host(plane.data_ptr(), s32.data_ptr(), n32.data_ptr(),
                           got.data_ptr(), nb, w, n, bd, int(sis), k,
                           float(lam))
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    if content == "flat":
        # the tie: planar and DC (2.5 bits each), in that order
        assert (want[:, 0] == 0).all()
        if k == 2:
            assert (want[:, 1] == 1).all()
