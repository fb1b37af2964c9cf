"""K3 deblock's lane code (csrc/deblock.cuh: a block a tile whose borders
lie 4 samples off the 8-grid, vertical edges then horizontal ones in the
tile, a 4-line luma or chroma segment on four lanes, a line a lane)
compiled as host C++ with g++ and driven on the CPU against the port's
plain versions, bit for bit:

- the state form (the passes' 8x8 cell state read in place: P and B
  `blk` columns with the lists' POCs, or an I pass's CU sizes) against
  `deblock_state_plain` (the passes' glue, `state_inputs`, then
  `deblock_frame_plain`) for I, P and B states at 64x64, 64x56 and 80x48
  (the last two with partial chroma tiles), 8 and 10 bits;
- the 4x4-map form against `deblock_frame_plain` on
  tests/test_torch_ops.py's `_blocky` pictures.

The host build runs a tile's tasks and each task's lanes on one thread,
in order or (`lane_reverse`) last first.  A mutated header that filters
chroma where the co-located luma BS is 1 must disagree.  One case holds
the plain state form to hmtpu's composition at 64x64: its P pass's
`rep4` glue (hmtpu/encoder/pframe_dev.py:1797-1832, copied here) and
`hmtpu.ops.deblock.deblock_frame_dev`.  The card runs the same functions
in the kernel, which the `gpu` tests of K3 (tests/test_torch_gpu.py) and
chip_smoke.py hold to the plain versions.  Skips only where there is no
g++.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hmtpu_torch.kernels import CSRC
from hmtpu_torch.ops import deblock as db
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)

_LANES_CPP = r"""
#include "deblock.cuh"
extern "C" void lane_reverse(int r) { hm::lane_reverse = r; }
static db::Planes planes(const int* y, const int* u, const int* v, int* oy,
                         int* ou, int* ov) {
  return db::Planes{{y, u, v}, {oy, ou, ov}};
}
// the 4x4-map form
extern "C" void map_host(const int* y, const int* u, const int* v, int* oy,
                         int* ou, int* ov, const int* intra4,
                         const int* cbf4, const int* mvx, const int* mvy,
                         const int* refpoc, const int* mask_v,
                         const int* mask_h, const int* par) {
  const db::Par q{par[0], par[1], par[2], par[3],
                  par[4], par[5], par[6], par[7]};
  db::MapSrc m{intra4, cbf4, mvx, mvy, refpoc, mask_v, mask_h,
               q.h / 4, q.w / 4, q.w / 8};
  db::frame_host(m, planes(y, u, v, oy, ou, ov), q);
}
// the state form: cols = dir, mvx, mvy, ref, mvx1, mvy1, ref1, cbf, sz
// (the first seven null in an I state); pocs = nr0, nr1, 16 + 16 POCs
extern "C" void state_host(const int* y, const int* u, const int* v,
                           int* oy, int* ou, int* ov, const int** cols,
                           int stride, const int* pocs, const int* par) {
  const db::Par q{par[0], par[1], par[2], par[3],
                  par[4], par[5], par[6], par[7]};
  db::StateSrc m;
  m.dir = cols[0];
  m.mvx = cols[1];
  m.mvy = cols[2];
  m.ref = cols[3];
  m.mvx1 = cols[4];
  m.mvy1 = cols[5];
  m.ref1 = cols[6];
  m.cbf = cols[7];
  m.sz = cols[8];
  m.stride = stride;
  m.bw = q.w / 8;
  m.nr0 = pocs[0];
  m.nr1 = pocs[1];
  for (int i = 0; i < 16; ++i) {
    m.poc0[i] = pocs[2 + i];
    m.poc1[i] = pocs[18 + i];
  }
  db::frame_host(m, planes(y, u, v, oy, ou, ov), q);
}
"""


def _build(csrc, d):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile csrc/deblock.cuh as host C++")
    src, so = d / "lanes.cpp", d / "liblanes.so"
    src.write_text(_LANES_CPP)
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(csrc), "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lane_reverse.argtypes = [i]
    lib.map_host.argtypes = [p] * 14
    lib.state_host.argtypes = [p] * 7 + [i, p, p]
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(CSRC, tmp_path_factory.mktemp("deblock_lanes"))


def _i32(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.int32))


def _blocky(rng, h, w, step=8, spread=40, noise=2):
    """tests/test_torch_ops.py's picture of flat 8x8 blocks plus a little
    noise: edges the filter acts on."""
    base = 128 + rng.randint(-spread, spread + 1,
                             (-(-h // step), -(-w // step)))
    pl = np.repeat(np.repeat(base, step, 0), step, 1)[:h, :w]
    pl = pl + rng.randint(-noise, noise + 1, (h, w))
    return np.clip(pl, 0, 255).astype(np.int32)


def _par(h, w, qp, bd, cb_off=0, cr_off=0, beta_off=0, tc_off=0):
    return _i32([h, w, qp, bd, beta_off, tc_off,
                 db._chroma_tc(qp, cb_off, bd, tc_off),
                 db._chroma_tc(qp, cr_off, bd, tc_off)])


def _run(lib, reverse, planes, call):
    outs = [torch.full_like(p, -7) for p in planes]
    lib.lane_reverse(int(reverse))
    try:
        call(*(p.data_ptr() for p in planes), *(o.data_ptr() for o in outs))
    finally:
        lib.lane_reverse(0)
    return outs


def _state_host(lib, reverse, planes, blk, h, w, qp, bd, ref_pocs=(),
                ref_pocs_l1=(), cusz=None, cbfy=None, **offs):
    if blk is None:
        keep = [_i32(cbfy), _i32(cusz)]
        cols = [None] * 7 + [t.data_ptr() for t in keep]
        stride = 1
    else:
        keep = [_i32(blk)]
        base = keep[0].data_ptr()
        cols = [base + 4 * c for c in (db.K_DIR, db.K_MVX, db.K_MVY,
                                       db.K_REF, db.K_MVX1, db.K_MVY1,
                                       db.K_REF1, db.K_CBFY, db.K_SZ)]
        stride = blk.shape[1]
    pocs = np.zeros(34, np.int32)
    pocs[:2] = len(ref_pocs), len(ref_pocs_l1)
    pocs[2:2 + len(ref_pocs)] = ref_pocs
    pocs[18:18 + len(ref_pocs_l1)] = ref_pocs_l1
    arr = (ctypes.c_void_p * 9)(*cols)
    par = _par(h, w, qp, bd, **offs)
    return _run(lib, reverse, planes, lambda *pp: lib.state_host(
        *pp, arr, stride, pocs.ctypes.data, par.data_ptr()))


def _planes(rng, h, w, bd):
    sh = bd - 8
    return [_i32(_blocky(rng, hh, ww, spread=6) << sh)
            for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]


def _state(rng, h, w, kind):
    """A seeded 8x8 state: P (directions 0 and 1), B (0-3) or I (the CU
    sizes and luma cbf alone).  The motion is drawn a 16x16 region at a
    time, then the directions and references drawn again for a third of
    the cells and the MVs for a tenth, so neighbours share their motion
    or differ by a few quarter samples, a list or a reference (the
    motion BS both ways, and its POC lookups); reference indices run
    past the lists' ends (clamped)."""
    bh, bw = h // 8, w // 8
    n = bh * bw
    if kind == "I":
        return None, dict(cusz=_i32(rng.randint(0, 3, n)),
                          cbfy=_i32(rng.randint(0, 2, n)))

    def draw(choices, share=0.35):
        coarse = rng.choice(choices, (-(-bh // 2), -(-bw // 2)))
        v = np.repeat(np.repeat(coarse, 2, 0), 2, 1)[:bh, :bw].reshape(-1)
        again = rng.rand(n) < share
        v[again] = rng.choice(choices, int(again.sum()))
        return v

    nr, nr1 = (4, 2) if kind == "P" else (2, 2)
    blk = np.zeros((n, 14), np.int32)
    blk[:, db.K_DIR] = draw([0, 1, 1, 1, 1, 1] if kind == "P"
                            else [0, 0, 1, 1, 2, 2, 3, 3])
    for c in (db.K_MVX, db.K_MVY, db.K_MVX1, db.K_MVY1):
        blk[:, c] = draw([-5, -1, 0, 0, 0, 1, 2], 0.1)
    blk[:, db.K_REF] = draw(list(range(nr + 1)))
    blk[:, db.K_REF1] = draw(list(range(nr1 + 1)))
    blk[:, db.K_SZ] = rng.randint(0, 3, n)
    blk[:, db.K_CBFY] = rng.choice([0, 0, 0, 1], n)
    if kind == "P":
        return _i32(blk), dict(ref_pocs=[8, 6, 5, 4][:nr])
    # random access's lists: list 0 the past picture first, list 1 the
    # future one (the same two POCs): one picture through either list, and
    # bi-predicted sides with their lists swapped
    return _i32(blk), dict(ref_pocs=[8, 4], ref_pocs_l1=[4, 8])


def _same(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind,h,w,bd,qp", [
    ("I", 64, 64, 8, 32), ("P", 64, 64, 8, 27), ("B", 64, 64, 10, 32),
    ("I", 64, 56, 10, 37), ("P", 64, 56, 8, 37), ("B", 64, 56, 8, 22),
    ("I", 80, 48, 8, 22), ("P", 80, 48, 10, 32), ("B", 80, 48, 8, 37)])
def test_state_form_equals_plain(lib, kind, h, w, bd, qp, reverse):
    """The state form's host build against `deblock_state_plain`: every
    sample of the three planes; the luma and (for the intra cells) the
    chroma planes change."""
    rng = np.random.RandomState(h * w + bd + qp)
    planes = _planes(rng, h, w, bd)
    blk, kw = _state(rng, h, w, kind)
    offs = dict(cb_qp_off=1, cr_qp_off=-2) if kind == "B" else {}
    want = db.deblock_state_plain(*planes, blk, qp, bd, h=h, w=w, **kw,
                                  **offs)
    host_offs = dict(cb_off=1, cr_off=-2) if kind == "B" else {}
    got = _state_host(lib, reverse, planes, blk, h, w, qp, bd, **kw,
                      **host_offs)
    _same(got, want)
    assert all((g != p).any() for g, p in zip(got, planes))
    # the CPU entry is the plain version
    _same(db.deblock_state(*planes, blk, qp, bd, h=h, w=w, **kw, **offs),
          want)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("h,w,masks", [(64, 64, True), (48, 80, True),
                                       (64, 56, False)])
def test_map_form_equals_plain(lib, h, w, masks, reverse):
    """The 4x4-map form's host build against `deblock_frame_plain` on
    test_torch_ops.py's pictures and maps, with and without the
    CU-interior masks, QPs 22 and 37."""
    rng = np.random.RandomState(h + w)
    planes = _planes(rng, h, w, 8)
    h4, w4 = h // 4, w // 4
    meta = [_i32(rng.rand(h4, w4) < 0.5), _i32(rng.rand(h4, w4) < 0.5),
            _i32(rng.randint(-8, 9, (2, h4, w4))),
            _i32(rng.randint(-8, 9, (2, h4, w4))),
            _i32(rng.randint(-1, 3, (2, h4, w4)))]
    mk = [_i32(rng.rand(h // 8, w // 8 - 1) < 0.3),
          _i32(rng.rand(h // 8 - 1, w // 8) < 0.3)] if masks else [None] * 2
    for qp in (22, 37):
        want = db.deblock_frame_plain(*planes, *meta, qp, int_v=mk[0],
                                      int_h=mk[1])
        par = _par(h, w, qp, 8)
        got = _run(lib, reverse, planes, lambda *pp: lib.map_host(
            *pp, *(t.data_ptr() for t in meta),
            *(None if t is None else t.data_ptr() for t in mk),
            par.data_ptr()))
        _same(got, want)
        assert (got[0] != planes[0]).any()


def test_chroma_at_bs1_mutation_is_caught(lib, tmp_path):
    """A copy of the header that filters chroma where the co-located luma
    BS is 1 (not only 2) disagrees on a P state."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "deblock.cuh"
    text = p.read_text()
    good = "return lbs == 2 ? 2 : 0;"
    assert text.count(good) == 1
    p.write_text(text.replace(good, "return lbs >= 1 ? 2 : 0;"))
    (tmp_path / "b").mkdir()
    mut = _build(csrc, tmp_path / "b")
    rng = np.random.RandomState(3)
    h, w, qp = 64, 64, 37
    planes = _planes(rng, h, w, 8)
    blk, kw = _state(rng, h, w, "P")
    want = db.deblock_state_plain(*planes, blk, qp, 8, h=h, w=w, **kw)
    for reverse in (False, True):
        _same(_state_host(lib, reverse, planes, blk, h, w, qp, 8, **kw),
              want)
        got = _state_host(mut, reverse, planes, blk, h, w, qp, 8, **kw)
        assert torch.equal(got[0], want[0])
        assert not (torch.equal(got[1], want[1])
                    and torch.equal(got[2], want[2])), reverse


def test_state_plain_equals_hmtpu():
    """The plain state form of a 64x64 B state (two lists, bi-predicted
    cells, reference indices past the lists' ends) equal to hmtpu's
    composition: its P / B pass's rep4 glue and `deblock_frame_dev`."""
    import jax
    import jax.numpy as jnp

    from hmtpu.ops.deblock import deblock_frame_dev as j_deblock

    rng = np.random.RandomState(64)
    h, w, qp, bd = 64, 64, 32, 8
    planes = _planes(rng, h, w, bd)
    blk, kw = _state(rng, h, w, "B")
    ref_pocs, ref_pocs_l1 = kw["ref_pocs"], kw["ref_pocs_l1"]
    num_ref, num_ref_l1 = len(ref_pocs), len(ref_pocs_l1)
    bh, bw = h // 8, w // 8
    # hmtpu/encoder/pframe_dev.py:1797-1832
    b = jnp.asarray(blk.numpy())
    rep4 = lambda a: jnp.repeat(jnp.repeat(a.reshape(bh, bw), 2, 0), 2, 1)
    dirf = b[:, 5]
    intra4 = rep4(dirf == 0)
    cbf4 = rep4(b[:, 10] > 0)
    u0f, u1f = (dirf & 1) > 0, (dirf & 2) > 0
    mv_x4 = jnp.stack([rep4(jnp.where(u0f, b[:, 6], 0)),
                       rep4(jnp.where(u1f, b[:, 11], 0))])
    mv_y4 = jnp.stack([rep4(jnp.where(u0f, b[:, 7], 0)),
                       rep4(jnp.where(u1f, b[:, 12], 0))])
    rp0 = rep4(jnp.where(u0f, jnp.asarray(ref_pocs, jnp.int32)[
        jnp.clip(b[:, 8], 0, num_ref - 1)], -1))
    rp1 = rep4(jnp.where(u1f, jnp.asarray(ref_pocs_l1, jnp.int32)[
        jnp.clip(b[:, 13], 0, num_ref_l1 - 1)], -1))
    refpoc4 = jnp.stack([rp0, rp1])
    cusz8 = b[:, 9].reshape(bh, bw)
    ev = jnp.arange(bw - 1)
    int_v = ((cusz8[:, :-1] == 1) & ((ev % 2) == 0)[None, :]) \
        | ((cusz8[:, :-1] == 2) & ((ev % 4) != 3)[None, :])
    eh = jnp.arange(bh - 1)
    int_h = ((cusz8[:-1, :] == 1) & ((eh % 2) == 0)[:, None]) \
        | ((cusz8[:-1, :] == 2) & ((eh % 4) != 3)[:, None])
    want = jax.jit(j_deblock)(
        *(jnp.asarray(p.numpy()) for p in planes), intra4, cbf4, mv_x4,
        mv_y4, refpoc4, jnp.int32(qp), int_v=int_v, int_h=int_h)
    got = db.deblock_state_plain(*planes, blk, qp, bd, h=h, w=w, **kw)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    assert (got[1] != planes[1]).any()
