"""The lane code of K26 b_walk (csrc/bwalk.cuh, the B z-scan walker) and
K12's sample arithmetic (csrc/bi_pred.cuh, which K26 runs too), compiled
as host C++ with g++ and driven on the CPU against their plain versions
(`wavefront_pass_plain` in B slices, `bi_pred_plain`), bit for bit.

The walker runs through `pframe_walk`, the same wrapper that launches K26
on the card, one call of the host build per z-scan level, on the
arguments the port's own CPU random-access encodes give `wavefront_pass`
(whose plain B pass is held against hmtpu in tests/test_torch_ra_e2e.py),
and must reproduce every state array the plain pass returned there, also
with every round's tasks run last task first and each 16x16 / 32x32
trial before its cells (`bw::task_reverse`), which shows that no task
reads another's outputs; mutated copies of the headers show that the
comparisons see the B winner's prediction and a task reading another's
slot.  No hmtpu pass runs here.  The headers are built with -ffp-contract=off, so
every float32 operation rounds on its own as nvcc's __fadd_rn / __fmul_rn
do.  Skips only where there is no g++.
"""
import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hmtpu_torch.encoder import pframe_dev
from hmtpu_torch.encoder.top import Encoder, EncoderConfig
from hmtpu_torch.io.yuv import Frame
from hmtpu_torch.kernels import CSRC
from hmtpu_torch.ops import interp
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)
from tools.gen_test_yuv import synth_clip

_LANES_CPP = r"""
#include <vector>
#include "bi_pred.cuh"
#include "bwalk.cuh"
// one z-scan level of K26: every lane in turn, one thread each
extern "C" int bw_level(const void* scratch, const void* p, int np,
                        const void* v, int nv, const void* f, int nf,
                        int level) {
  if (np != bw::N_PTRS || nv != bw::N_INTS || nf != bw::N_FLTS) return 1;
  const bw::Args b = bw::args_from((const long long*)p, (const int*)v,
                                   (const float*)f);
  if (b.p.scratch != scratch || b.p.scratch_ints != bw::SCRATCH) return 1;
  std::vector<double> sm(bw::smem_bytes(32) / sizeof(double) + 1);
  for (int lane = 0; lane < b.p.bmax; ++lane)
    bw::walk_lane(b, level, lane, 0, 1, sm.data());
  return 0;
}
// every task loop of the walk last task first, and each 16x16 / 32x32
// trial before its cells (1), or in order (0)
extern "C" void bw_task_reverse(int r) { bw::task_reverse = r; }
// K12 over n pairs of S samples
extern "C" void bi_pred_host(const int* i0, const int* i1, const int* cdir,
                             int* out, int n, int S, int bd) {
  for (long long k = 0; k < (long long)n * S; ++k)
    out[k] = hm::bi_pred_sample(i0[k], i1[k], cdir[k / S], bd);
}
"""


def _build(d, csrc):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile csrc/bwalk.cuh as host C++")
    src, so = d / "lanes.cpp", d / "liblanes.so"
    src.write_text(_LANES_CPP)
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(csrc), "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.bw_level.argtypes = [ctypes.c_void_p] \
        + [ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_int]
    lib.bi_pred_host.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    lib.bw_task_reverse.argtypes = [ctypes.c_int]
    return lib


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("bwalk"), CSRC)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runner(lib):
    def run_level(scratch, ptrs, ints, flts, level):
        assert lib.bw_level(scratch.data_ptr(),
                            *(x for a in (ptrs, ints, flts)
                              for x in (ctypes.addressof(a), len(a))),
                            level) == 0
    return run_level


# (w, h, qp, bit depth, frames, B passes kept, scene cut): random access
# with DCT-IF at search range 8.  With 3 frames the B pictures follow one
# another (one reference a list); the 64x32 clip is a whole GOP whose
# content changes before frame 2 (the later frames another clip,
# inverted), so POC 2, the third B pass, has three references a list and
# takes POC 4 as list 1's first (L1-only CUs); the encode stops there.
# The 10-bit case is the clip << 2 (tests/test_main10.py's rule)
CASES = {
    "64x64-10bit": (64, 64, 30, 10, 3, 2, 0),
    "64x56-8bit": (64, 56, 27, 8, 3, 2, 0),
    "64x32-cut-l1": (64, 32, 27, 8, 9, 3, 2),
}


class _Enough(Exception):
    pass


@functools.lru_cache(maxsize=None)
def _captured(name):
    """The B passes of the case's CPU RA encode: per pass (args, kwargs,
    state) of `wavefront_pass` (the plain pass)."""
    w, h, qp, bd, n, keep, cut = CASES[name]
    clip = list(synth_clip(w, h, n))
    if cut:
        other = list(synth_clip(w, h, n, seed=7))
        clip = clip[:cut] + [tuple(255 - p for p in f) for f in other[cut:]]
    seen = []
    inner = pframe_dev.wavefront_pass

    def record(*a, **k):
        st = inner(*a, **k)
        # a copy: the caller filters the reconstruction into the dict
        seen.append((a, k, {x: v.clone() for x, v in st.items()}))
        if len(seen) == keep:
            raise _Enough
        return st

    pframe_dev.wavefront_pass = record
    try:
        enc = Encoder(EncoderConfig(width=w, height=h, qp=qp, gop="ra",
                                    subpel="dctif", search_range=8,
                                    bit_depth=bd), device="cpu")
        enc.encode_sequence([Frame(*(p.astype(np.int32) << (bd - 8)
                                     for p in f), bd) for f in clip])
    except _Enough:
        pass
    finally:
        pframe_dev.wavefront_pass = inner
    return seen


def _walk(lib, a, k):
    return pframe_dev.pframe_walk(*a, run_level=_runner(lib), **k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_walker_equals_plain_pass(lanes, name):
    w, h, _, bd, _, keep, cut = CASES[name]
    seen = _captured(name)
    assert len(seen) == keep
    dirs, l1_amvp, sizes, refs = set(), 0, set(), 0
    for a, k, want in seen:
        assert k["num_ref_l1"] > 0 and k["bd"] == bd
        got = _walk(lanes, a, k)
        assert set(got) == set(want)
        for key in sorted(want):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key].numpy(),
                                          want[key].numpy(), err_msg=key)
        blk = want["blk"]
        kind, d = blk[:, pframe_dev.K_KIND], blk[:, pframe_dev.K_DIR]
        dirs |= set(d.tolist())
        l1_amvp += int(((kind == 2) & (d == 2)).sum())
        sizes |= set(blk[:, pframe_dev.K_SZ].tolist())
        refs = max(refs, k["num_ref"], k["num_ref_l1"])
    # what each case is there for: bi-predicted CUs, 16x16 / 32x32 CUs
    # where the geometry has them, L1-only AMVP CUs with lists of two or
    # more references after the scene cut
    if w % 16 == 0 and h % 16 == 0:
        assert seen[0][1]["levels"] == 3 and sizes & {1, 2}
    else:
        assert seen[0][1]["levels"] == 1
    if cut:
        assert refs >= 2 and l1_amvp > 0 and 2 in dirs
    else:
        assert 3 in dirs


def test_walker_mutation_is_caught(tmp_path):
    """A copy of the headers where a bi merge winner's chroma prediction
    averages list 1's hypothesis with itself must disagree with the plain
    pass on the chroma reconstruction: the comparison above sees the B
    winner's exact prediction."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "bwalk.cuh"
    text = p.read_text()
    good = "pred[e] = bi_pred_sample(gm.h0[e], gm.h1[e], 3, a.bd);"
    assert text.count(good) == 1
    p.write_text(text.replace(
        good, "pred[e] = bi_pred_sample(p ? gm.h1[e] : gm.h0[e], gm.h1[e], "
              "3, a.bd);"))
    lib = _build(tmp_path, csrc)
    differs = []
    for a, k, want in _captured("64x56-8bit"):
        got = _walk(lib, a, k)
        differs.append(any(not torch.equal(got[x], want[x])
                           for x in ("rec_u", "rec_v")))
    assert any(differs)


def _walk_order(lib, name, reverse):
    """Every state array of the case's passes through the host build with
    its task loops in order or last task first (and each larger trial
    before its cells): (got, want) pairs."""
    lib.bw_task_reverse(int(reverse))
    try:
        return [(_walk(lib, a, k), want) for a, k, want in _captured(name)]
    finally:
        lib.bw_task_reverse(0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_walker_tasks_in_reverse_order(lanes, name):
    """K26 runs a CU trial's independent items side by side (the merge
    candidates' hypotheses and screening with the intra arm's
    predictions; the winner's planes with the intra arm's codings) and
    each 16x16 / 32x32 trial beside its cells: with every round's tasks
    run last task first and each trial before its cells, the host build
    must still give the plain pass's state, bit for bit, so no task reads
    what another task of its round writes, nor a trial what its cells
    commit."""
    for got, want in _walk_order(lanes, name, True):
        for key in sorted(want):
            np.testing.assert_array_equal(got[key].numpy(),
                                          want[key].numpy(), err_msg=key)


def test_walker_cross_task_read_is_caught(tmp_path):
    """A copy of the headers in which the merge winner's chroma tasks read
    the winner's index from a slot its luma task writes: right when the
    tasks run in order (heaviest first, as one thread runs them), a race
    between groups on the card.  The reversed order must disagree with
    the plain pass."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "bwalk.cuh"
    text = p.read_text()
    good = "const int c = mg.mi, dir = mg.c[0][c], k = p ? n / 2 : n;"
    assert text.count(good) == 1
    p.write_text(text.replace(
        good, "const int c = p ? iclamp(m.p.rnz[NTASK - 1], 0, MAXM - 1) "
              ": mg.mi, dir = mg.c[0][c], k = p ? n / 2 : n;\n"
              "  if (L.tid == 0 && p == 0) m.p.rnz[NTASK - 1] = c;"))
    lib = _build(tmp_path, csrc)
    name = "64x64-10bit"
    for got, want in _walk_order(lib, name, False):
        assert all(torch.equal(got[x], want[x]) for x in want)
    assert any(not torch.equal(got[x], want[x])
               for got, want in _walk_order(lib, name, True) for x in want)


@pytest.mark.parametrize("bd", [8, 10])
def test_bi_pred_lane_equals_plain(lanes, bd):
    """bi_pred.cuh's sample against K12's plain version: hypotheses around
    both ends of the clip, every direction."""
    rng = np.random.RandomState(bd)
    n, S = 300, 64
    lo, hi = -(8192 + 900), (1 << 14) - 8192 + 900
    i0, i1 = (torch.as_tensor(rng.randint(lo, hi, (n, 8, 8))
                              .astype(np.int32)) for _ in range(2))
    cdir = torch.as_tensor(rng.randint(1, 4, n).astype(np.int32))
    want = interp.bi_pred_plain(i0, i1, cdir, bd)
    got = torch.zeros((n, 8, 8), dtype=torch.int32)
    lanes.bi_pred_host(i0.data_ptr(), i1.data_ptr(), cdir.data_ptr(),
                       got.data_ptr(), n, S, bd)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert {0, (1 << bd) - 1} <= set(want.reshape(-1).tolist())
