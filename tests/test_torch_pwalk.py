"""The lane code of K23 p_walk (csrc/pwalk.cuh, the P z-scan walker), K24
tmvp_grid (csrc/tmvp.cuh, the temporal candidates of a CU grid) and K25
sao_choose (csrc/sao_choose.cuh, the SAO parameter choice), compiled as
host C++ with g++ and driven on the CPU against their plain versions
(`wavefront_pass_plain`, `t_level_plain`, `choose_params`), bit for bit;
K24 also in its grids form (the pass's three grids in one launch) against
`tmvp_grids_plain`, blocks in order and reversed.

The walker runs through `pframe_walk`, the same wrapper that launches K23
on the card, one call of the host build per z-scan level, on the
arguments the port's own CPU encodes give `wavefront_pass` (whose plain
pass is held against hmtpu in tests/test_torch_inter_e2e.py), and must
reproduce every state array the plain pass returned there.  No hmtpu
pass runs here.  The plain versions of K24 and K25 are held against
hmtpu's (`temporal_cand_grid_dev` / `scale_mv_pair_dev` as composed by
the pass, `_choose_params_dev`) on the same numpy inputs.  The headers
are built with -ffp-contract=off, so every float32 operation rounds on
its own as nvcc's __fadd_rn / __fmul_rn do.  Skips only where there is
no g++.
"""
import ctypes
import functools
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmtpu.ops import sao as j_sao
from hmtpu.search import wavefront as j_wf
from hmtpu_torch.common.lambdas import frame_lambdas
from hmtpu_torch.encoder import pframe_dev
from hmtpu_torch.encoder.top import Encoder, EncoderConfig
from hmtpu_torch.io.yuv import Frame
from hmtpu_torch.kernels import CSRC
from hmtpu_torch.ops import sao
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)
from tools.gen_test_yuv import synth_clip

_LANES_CPP = r"""
#include <vector>
#include "pwalk.cuh"
#include "sao_choose.cuh"
#include "tmvp.cuh"
// one z-scan level of K23: every lane in turn, one thread each
extern "C" int pw_level(const void* scratch, const void* p, int np,
                        const void* v, int nv, const void* f, int nf,
                        int level) {
  if (np != pw::N_PTRS || nv != pw::N_INTS || nf != pw::N_FLTS) return 1;
  pw::Args a = pw::args_from((const long long*)p, (const int*)v,
                             (const float*)f);
  if (a.scratch != scratch || a.scratch_ints != 0) return 1;
  std::vector<double> sm(pw::SMEM_BYTES / sizeof(double) + 1);
  for (int lane = 0; lane < a.bmax; ++lane)
    pw::walk_lane(a, level, lane, 0, 1, sm.data());
  return 0;
}
// every task loop of the walk last task first (1) or in order (0)
extern "C" void pw_task_reverse(int r) { pw::task_reverse = r; }
// K24 over one grid
extern "C" void tmvp_host(const int* mvx, const int* mvy, const int* ok,
                          const int* poc, const int* aref, const int* pocs,
                          int* out, int n, int gw, int gh, int w, int h,
                          int log2_ctu, int cur_poc, int col_pic_poc, int R) {
  const tmvp::Args a{mvx, mvy, ok, poc, aref, pocs, out, n, gw, gh, w, h,
                     log2_ctu, cur_poc, col_pic_poc, R};
  for (int i = 0; i < gw * gh; ++i) tmvp::tmvp_lane(a, i);
}
// K24's grids form: ngrids grids (n, gw, gh) in one job, their (5, P)
// outputs one after another, blocks in order or last first
extern "C" void tmvp_grids_host(const int* mvx, const int* mvy,
                                const int* ok, const int* poc,
                                const int* pocs, int* out,
                                const int* const* aref, const int* geo,
                                int ngrids, int w, int h, int log2_ctu,
                                int cur_poc, int col_pic_poc, int R,
                                int reverse) {
  tmvp::Grids a{};
  int total = 0;
  for (int l = 0; l < ngrids; ++l) {
    a.g[l] = tmvp::Args{mvx, mvy, ok, poc, aref[l], pocs, out + 5 * total,
                        geo[3 * l], geo[3 * l + 1], geo[3 * l + 2], w, h,
                        log2_ctu, cur_poc, col_pic_poc, R};
    a.p[l] = geo[3 * l + 1] * geo[3 * l + 2];
    total += a.p[l];
  }
  hm::lane_reverse = reverse;
  tmvp::grids_host(a);
  hm::lane_reverse = 0;
}
// K25 over nctu CTUs
extern "C" void sao_host(const int* st_y, const int* st_u, const int* st_v,
                         float lam, int mo, int* out, int nctu) {
  saoc::choose_host(st_y, st_u, st_v, lam, mo, out, nctu);
}
"""


def _build(d, csrc):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile csrc/pwalk.cuh as host C++")
    src, so = d / "lanes.cpp", d / "liblanes.so"
    src.write_text(_LANES_CPP)
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(csrc), "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.pw_level.argtypes = [ctypes.c_void_p] \
        + [ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_int]
    lib.pw_task_reverse.argtypes = [ctypes.c_int]
    lib.tmvp_host.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
    lib.tmvp_grids_host.argtypes = [ctypes.c_void_p] * 8 \
        + [ctypes.c_int] * 8
    lib.sao_host.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    return lib


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("pwalk"), CSRC)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runner(lib):
    def run_level(scratch, ptrs, ints, flts, level):
        assert lib.pw_level(scratch.data_ptr(),
                            *(x for a in (ptrs, ints, flts)
                              for x in (ctypes.addressof(a), len(a))),
                            level) == 0
    return run_level


def _screen_chroma(w, h, n):
    """tests/test_torch_inter_e2e.py's chroma screen content (seed 11):
    coloured strokes drifting on a flat background."""
    rng = np.random.RandomState(11)
    marks = [(rng.randint(0, w // 2 - 8), rng.randint(0, h // 2 - 4),
              rng.randint(3, 8)) for _ in range(40)]
    out = []
    for t in range(n):
        y = np.full((h, w), 90, np.int32)
        u = np.full((h // 2, w // 2), 100, np.int32)
        v = np.full((h // 2, w // 2), 150, np.int32)
        for x0, y0, ln in marks:
            x = (x0 + t) % (w // 2 - 8)
            u[y0:y0 + 2, x:x + ln] = 230
            v[y0:y0 + 2, x:x + ln] = 40
            y[2 * y0:2 * y0 + 4, 2 * x:2 * x + 2 * ln] = 200
        out.append((y, u, v))
    return out


# (w, h, qp, subpel, transform skip, content, bit depth): 3 frames, so
# the second P frame has its predecessor's motion as the collocated
# field; the first has one active reference of the 4 the LDP config pads
# to.  The 10-bit case is the clip << 2 (tests/test_main10.py's rule)
CASES = {
    "64x64-nn-qp22": (64, 64, 22, "nn", False, "clip", 8),
    "64x64-nn-qp37": (64, 64, 37, "nn", False, "clip", 8),
    "64x64-dctif-ts-qp22": (64, 64, 22, "dctif", True, "clip", 8),
    "64x64-dctif-ts-qp37": (64, 64, 37, "dctif", True, "clip", 8),
    "64x56-8only": (64, 56, 27, "nn", False, "clip", 8),
    "80x48-partial32": (80, 48, 27, "dctif", False, "clip", 8),
    "64x64-ts-screen": (64, 64, 27, "none", True, "screen", 8),
    "64x64-10bit": (64, 64, 32, "dctif", False, "clip", 10),
}


@functools.lru_cache(maxsize=None)
def _captured(name):
    """The P passes of a 3-frame LDP encode of the case on the CPU: per
    frame (args, kwargs, state) of `wavefront_pass` (the plain pass)."""
    w, h, qp, subpel, ts, content, bd = CASES[name]
    planes = _screen_chroma(w, h, 3) if content == "screen" else [
        tuple(p.astype(np.int32) << (bd - 8) for p in f)
        for f in synth_clip(w, h, 3)]
    seen = []
    inner = pframe_dev.wavefront_pass

    def record(*a, **k):
        st = inner(*a, **k)
        # a copy: the caller filters the reconstruction into the dict
        seen.append((a, k, {x: v.clone() for x, v in st.items()}))
        return st

    pframe_dev.wavefront_pass = record
    try:
        enc = Encoder(EncoderConfig(width=w, height=h, qp=qp, gop="ldp",
                                    subpel=subpel, search_range=8,
                                    transform_skip=ts, bit_depth=bd),
                      device="cpu")
        enc.encode_sequence([Frame(*p, bd) for p in planes])
    finally:
        pframe_dev.wavefront_pass = inner
    return seen


_P_ONLY = ("mv_lx", "ref_pocs_l1", "num_ref_l1", "l0map", "l1map")


def _walk(lib, a, k):
    return pframe_dev.pframe_walk(
        *a, run_level=_runner(lib),
        **{x: v for x, v in k.items() if x not in _P_ONLY})


@pytest.mark.parametrize("name", sorted(CASES))
def test_walker_equals_plain_pass(lanes, name):
    seen = _captured(name)
    assert len(seen) == 2
    kinds, sizes, ts_tbs = set(), set(), 0
    for a, k, want in seen:
        got = _walk(lanes, a, k)
        assert set(got) == set(want)
        for key in sorted(want):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key].numpy(),
                                          want[key].numpy(), err_msg=key)
        kinds |= set(want["blk"][:, pframe_dev.K_KIND].tolist())
        sizes |= set(want["blk"][:, pframe_dev.K_SZ].tolist())
        ts_tbs += int((want["tsf"] != 0).sum())
    # the decisions the cases are there for: merge and AMVP CUs, larger
    # CUs where the geometry has them, the padded first frame
    assert {1, 2} <= kinds or {0, 1} <= kinds
    assert seen[0][1]["n_active"] < seen[0][1]["num_ref"]
    assert seen[1][1]["tmvp"] and seen[1][1]["col"] is not None
    assert seen[0][1]["bd"] == CASES[name][6]
    if CASES[name][0] % 16 == 0 and CASES[name][1] % 16 == 0:
        assert sizes & {1, 2}
    if CASES[name][5] == "screen":
        assert ts_tbs > 0, "no chroma TB chose transform skip"


def test_walker_mutation_is_caught(tmp_path):
    """A copy of the headers with the 16x16 / 32x32 trials' slab order
    broken (each slab written to its neighbour's cell) must disagree with
    the plain pass: the comparison above sees the `levs` packing."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "pwalk.cuh"
    text = p.read_text()
    good = "a.levs[cells[e / 96] * 96 + e % 96] = v;"
    assert text.count(good) == 1
    p.write_text(text.replace(
        good, "a.levs[cells[(e / 96) ^ 1] * 96 + e % 96] = v;"))
    lib = _build(tmp_path, csrc)
    differs = []
    for a, k, want in _captured("64x64-nn-qp22"):
        got = _walk(lib, a, k)
        assert all(torch.equal(got[x], want[x]) for x in want
                   if x != "levs")
        differs.append(not torch.equal(got["levs"], want["levs"]))
    assert any(differs)


def _walk_order(lib, name, reverse):
    """Every state array of the case's passes through the host build with
    its task loops in order or last task first: (got, want) pairs."""
    lib.pw_task_reverse(int(reverse))
    try:
        return [(_walk(lib, a, k), want) for a, k, want in _captured(name)]
    finally:
        lib.pw_task_reverse(0)


# geometry 32 with the transform-skip trials, and geometry 8
_ORDER_CASES = ("64x64-ts-screen", "64x56-8only")


@pytest.mark.parametrize("name", _ORDER_CASES)
def test_walker_tasks_in_reverse_order(lanes, name):
    """K23 runs a CU trial's independent items side by side (the
    candidates' MC, the finalists' and the intra arm's codings, the
    winner's recode): with every round's tasks run last task first, the
    host build must still give the plain pass's state, bit for bit, so no
    task reads what another task of its round writes."""
    for got, want in _walk_order(lanes, name, True):
        for key in sorted(want):
            np.testing.assert_array_equal(got[key].numpy(),
                                          want[key].numpy(), err_msg=key)


def test_walker_cross_task_read_is_caught(tmp_path):
    """A copy of the headers in which a finalist's chroma recode tasks
    read its candidate's index from a slot its luma recode task writes:
    right when the tasks run in order (heaviest first, as one thread runs
    them), a race between groups on the card.  The reversed order must
    disagree with the plain pass."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "pwalk.cuh"
    text = p.read_text()
    edits = (("m.py + c * nn, m.ly + bf * nn, m.ry + bf * nn, tr);",
              "m.py + c * nn, m.ly + bf * nn, m.ry + bf * nn, tr);\n"
              "    if (L.tid == 0) m.rnz[NTASK - 1 - f] = c;"),
             ("(u ? m.pu : m.pv) + c * ncc,",
              "(u ? m.pu : m.pv) + iclamp(m.rnz[NTASK - 1 - f], 0, MAXM - 1)"
              " * ncc,"))
    for good, bad in edits:
        assert text.count(good) == 1
        text = text.replace(good, bad)
    p.write_text(text)
    lib = _build(tmp_path, csrc)
    name = _ORDER_CASES[0]
    for got, want in _walk_order(lib, name, False):
        assert all(torch.equal(got[x], want[x]) for x in want)
    assert any(not torch.equal(got[x], want[x])
               for got, want in _walk_order(lib, name, True) for x in want)


# ---------------------------------------------------------------------------
# K24

def _col_field(rng, bh, bw, col_pic_poc):
    mvx = rng.randint(-300, 301, (bh, bw))
    mvy = rng.randint(-300, 301, (bh, bw))
    ok = rng.rand(bh, bw) < 0.7
    poc = col_pic_poc - rng.choice([1, 2, 3, 200, -150], (bh, bw))
    return mvx, mvy, ok, poc


@pytest.mark.parametrize("w,h", [(64, 64), (80, 48), (416, 240)])
def test_tmvp_lane_equals_plain(lanes, w, h):
    rng = np.random.RandomState(w + h)
    bw, bh = w // 8, h // 8
    cur, col_pic = 9, 8
    oks = []
    for ref_pocs in ([8, 7, 6, 5], [8, 8, 8, 8], [8, -200, 140, 3]):
        col = _col_field(rng, bh, bw, col_pic)
        t_col = tuple(torch.as_tensor(c) for c in col)
        pocs = torch.tensor(ref_pocs, dtype=torch.int32)
        gw16, gh16 = w // 16, h // 16
        grids = [(8, bw, bh), (16, gw16, gh16),
                 (32, (gw16 + 1) // 2, (gh16 + 1) // 2)]
        for n, gw, gh in grids:
            aref = torch.as_tensor(rng.randint(0, 4, gw * gh)
                                   .astype(np.int32))
            want = pframe_dev.tmvp_grid(t_col, col_pic, n, aref, pocs, cur,
                                        w=w, h=h, log2_ctu=6, gw=gw, gh=gh)
            i32 = [np.ascontiguousarray(c, np.int32) for c in col]
            got = np.zeros((5, gw * gh), np.int32)
            lanes.tmvp_host(*(c.ctypes.data for c in i32),
                            aref.data_ptr(), pocs.data_ptr(),
                            got.ctypes.data, n, gw, gh, w, h, 6, cur,
                            col_pic, 4)
            np.testing.assert_array_equal(got, want.numpy())
            oks += want[0].tolist()

            # the plain composition against hmtpu's functions
            jt = j_wf.temporal_cand_grid_dev(
                *(jnp.asarray(c) for c in col), n, w, h, 6, gw=gw, gh=gh)
            td = col_pic - jt[3]
            jp = jnp.asarray(np.asarray(ref_pocs, np.int32))
            jm = j_wf.scale_mv_pair_dev(jt[1], jt[2], cur - jp[0], td)
            ja = j_wf.scale_mv_pair_dev(jt[1], jt[2],
                                        cur - jp[aref.numpy()], td)
            np.testing.assert_array_equal(
                want.numpy(), np.stack([np.asarray(jt[0], np.int32),
                                        *(np.asarray(x) for x in jm),
                                        *(np.asarray(x) for x in ja)]))
    assert set(oks) == {0, 1}


def _tmvp_grids(w, h, rng):
    """The P pass's three grids of an h x w picture (the 32 grid the ceil
    one), seeded references each: [(n, aref, gw, gh)]."""
    g16 = (w // 16, h // 16)
    return [(n, torch.as_tensor(rng.randint(0, 4, gw * gh).astype(np.int32)),
             gw, gh)
            for n, gw, gh in ((8, w // 8, h // 8), (16,) + g16,
                              (32, (g16[0] + 1) // 2, (g16[1] + 1) // 2))]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("w,h", [(64, 64), (80, 48), (64, 56)])
def test_tmvp_grids_lane_equals_plain(lanes, w, h, reverse):
    """K24's grids form (one job over the pass's three grids, the grid
    chosen by comparisons; at 64x56 the 32 grid's last row is past the
    picture) equal to `tmvp_grids_plain`, blocks in order and reversed,
    and the plain form equal to `t_level_plain` grid by grid."""
    rng = np.random.RandomState(w * h + reverse)
    cur, col_pic = 9, 8
    col = _col_field(rng, h // 8, w // 8, col_pic)
    t_col = tuple(torch.as_tensor(c) for c in col)
    for ref_pocs in ([8, 7, 6, 5], [8, -200, 140, 3]):
        pocs = torch.tensor(ref_pocs, dtype=torch.int32)
        grids = _tmvp_grids(w, h, rng)
        want = pframe_dev.tmvp_grids_plain(t_col, col_pic, grids, pocs, cur,
                                           w=w, h=h, log2_ctu=6)
        for (n, aref, gw, gh), t in zip(grids, want):
            lv = pframe_dev.t_level_plain(t_col, col_pic, n, aref, pocs, cur,
                                          w=w, h=h, log2_ctu=6, gw=gw, gh=gh)
            assert torch.equal(t, torch.stack([a.to(torch.int32)
                                               for a in lv]))
        # the CPU entry is the plain version
        assert all(torch.equal(a, b) for a, b in zip(pframe_dev.tmvp_grids(
            t_col, col_pic, grids, pocs, cur, w=w, h=h, log2_ctu=6), want))
        for k in (3, 2):
            i32 = [np.ascontiguousarray(c, np.int32) for c in col]
            total = sum(gw * gh for _, _, gw, gh in grids[:k])
            got = np.full(5 * total, -7, np.int32)
            geo = np.asarray([[n, gw, gh] for n, _, gw, gh in grids[:k]],
                             np.int32)
            arefs = (ctypes.c_void_p * 3)(*[a.data_ptr()
                                            for _, a, _, _ in grids[:k]])
            lanes.tmvp_grids_host(*(c.ctypes.data for c in i32),
                                  pocs.data_ptr(), got.ctypes.data, arefs,
                                  geo.ctypes.data, k, w, h, 6, cur, col_pic,
                                  4, int(reverse))
            np.testing.assert_array_equal(
                got, np.concatenate([t.numpy().reshape(-1)
                                     for t in want[:k]]))


# ---------------------------------------------------------------------------
# K25

def _stats(rng, ny, nx, bd):
    """Seeded per-CTU statistics with zero and one-sample counts, and
    sums of both signs around the offsets' clip."""
    s = 1 << (bd - 8)
    ec = rng.choice([0, 1, 3, 40, 900], (4, 4, ny, nx))
    es = (rng.randint(-9, 10, (4, 4, ny, nx)) * ec * s) // 2
    bcnt = rng.choice([0, 1, 5, 60, 700], (32, ny, nx))
    bsum = (rng.randint(-12, 13, (32, ny, nx)) * bcnt * s) // 3
    return [torch.as_tensor(a.astype(np.int32)) for a in (es, ec, bsum,
                                                          bcnt)]


@pytest.mark.parametrize("bd,qp", [(8, 22), (8, 37), (10, 32)])
def test_sao_choose_lane_equals_plain(lanes, bd, qp):
    rng = np.random.RandomState(bd * qp)
    ny, nx = 3, 5
    lam = torch.tensor(frame_lambdas(qp, qp, 0.57)[0], dtype=torch.float32)
    planes = [_stats(rng, ny, nx, bd) for _ in range(3)]
    for a in planes[0]:
        a[..., 0, 0] = 0          # a CTU without samples: SAO off
    rows = [sao.stats_rows(*p) for p in planes]
    for r, p in zip(rows, planes):
        assert all(torch.equal(a, b) for a, b in zip(
            sao.stats_views(r, ny, nx), p))
    want = sao.choose_params(*rows, lam, bd, ny, nx)
    got = torch.zeros((ny, nx, 3, 7), dtype=torch.int32)
    lanes.sao_host(*(r.data_ptr() for r in rows), float(lam),
                   sao.max_offset(bd), got.data_ptr(), ny * nx)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert set(want[..., 0].reshape(-1).tolist()) == {0, 1, 2}

    # the plain version against hmtpu's, Cr under Cb's type and class
    jp = lambda p, **k: np.asarray(j_sao._choose_params_dev(
        jnp, *(jnp.asarray(a.numpy()) for a in p), jnp.float32(lam), bd,
        **k))
    j_cb = jp(planes[1])
    ref = np.stack([jp(planes[0]), j_cb, jp(
        planes[2], force_type=jnp.asarray(j_cb[..., 0]),
        force_cls=jnp.asarray(j_cb[..., 1]))], 2)
    np.testing.assert_array_equal(want.numpy(), ref)
