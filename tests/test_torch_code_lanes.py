"""K1's level forms (csrc/transform.cuh "K1's level forms": a TB on n
lanes of a warp, a row or column a lane, HM's even/odd partial
butterflies, the two stages through the warp's padded tile; a thread
block of a level's three planes, the inverse's per-block combine behind
its barrier) compiled as host C++ with g++ and driven on the CPU against
the port's plain versions (`fwd_level_plain`, `inv_level_plain`: the
composition `_code` and `hypothesis` ran), bit for bit: the
coefficients; the reconstruction, each TB's SSE, and each block's cbf,
distortion and rate, at n = 8, 16 and 32 with their chroma, at 8 and 10
bits, with residuals at +-(2^bd - 1) and coefficients at the 16-bit
clip, a ragged last thread block, one-plane calls at n = 4 (DCT and
DST) to 32 with and without the chroma weight, and a 10-bit 32x32 TB
whose SSE is 1023^2 * 1024, just under 2^30; and their TS mode, the
transform-skip pair of the 4x4 planes (one plane, DCT or DST, with and
without the weight; an 8x8 level's chroma pair) against
`fwd_level_plain(ts=True)` and `inv_level_ts_plain`: the TS
coefficients, and the pick's kept reconstruction, levels, distortion,
rate with the flag, TS word and the level's cbf, dist and bits, at 8
and 10 bits, with ties that must keep the DCT alternative.

The host build runs every lane of a `HM_LANES` loop on one thread, in
order or (`lane_reverse`) last lane first.  A mutated header whose
forward second stage reads the tile's column where it should read its
row must disagree, and so must one whose pick keeps TS on a tie.  The plain
level functions are held besides to hmtpu's `_code` on the CPU (the
transform, the reconstruction and the SSE around its own quantisation)
at a 64x64 picture's three levels, and the plain TS pair (through the
port's `_code_ts_sel`) to hmtpu's `_code_ts_sel` at its 8 level's
chroma.
The card runs the same functions in the kernels, which the `gpu` test
of K1's level forms (tests/test_torch_gpu.py) and chip_smoke.py hold to
the plain versions.  Skips only where there is no g++.
"""
import ctypes
import shutil
import subprocess
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmtpu_torch.kernels import CSRC
from hmtpu_torch.ops import transform
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)
from tests.torch_level_data import FLAG as _FLAG
from tests.torch_level_data import planes as _planes
from tests.torch_level_data import ts_alt as _ts_alt

_LANES_CPP = r"""
#include "transform.cuh"
extern "C" void lane_reverse(int r) { hm::lane_reverse = r; }
extern "C" void fwd_host(const int* const* org, const int* const* pred,
                         int* const* coef, int* const* tcoef, int m, int n0,
                         int n1, int planes, int mode) {
  hm::LevelArgs a{};
  for (int k = 0; k < 3; ++k) {
    a.org[k] = org[k];
    a.pred[k] = pred[k];
    a.coef[k] = coef[k];
    a.tcoef[k] = tcoef[k];
  }
  a.m = m, a.n0 = n0, a.n1 = n1, a.planes = planes, a.mode = mode;
  hm::level_host<false>(a);
}
extern "C" void inv_host(const int* const* deq, const int* const* lev,
                         const int* const* pred, const int* const* org,
                         const float* const* bits, const float* dw,
                         int* const* rec, float* const* sse, int* cbf,
                         float* dist, float* bitsum, const void* const* ts,
                         int m, int n0, int n1, int planes, int mode) {
  hm::LevelArgs a{};
  for (int k = 0; k < 3; ++k) {
    a.deq[k] = deq[k];
    a.lev[k] = lev[k];
    a.pred[k] = pred[k];
    a.org[k] = org[k];
    a.bits[k] = bits[k];
    a.rec[k] = rec[k];
    a.sse[k] = sse[k];
  }
  a.dw = dw, a.cbf = cbf, a.dist = dist, a.bitsum = bitsum;
  if (ts != nullptr) {  // transform.cu hm_inv_level's table
    for (int k = 0; k < 3; ++k) {
      a.tdeq[k] = (const int*)ts[k];
      a.tlev[k] = (const int*)ts[3 + k];
      a.tbits[k] = (const float*)ts[6 + k];
      a.levk[k] = (int*)ts[11 + k];
      a.bitk[k] = (float*)ts[14 + k];
    }
    a.tsflag = (const float*)ts[9];
    a.lam = (const float*)ts[10];
    a.ts = (int*)ts[17];
  }
  a.m = m, a.n0 = n0, a.n1 = n1, a.planes = planes, a.mode = mode;
  hm::level_host<true>(a);
}
"""


def _build(csrc, d):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile csrc/transform.cuh as host C++")
    src, so = d / "lanes.cpp", d / "liblanes.so"
    src.write_text(_LANES_CPP)
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(csrc), "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lane_reverse.argtypes = [i]
    lib.fwd_host.argtypes = [p] * 4 + [i] * 5
    lib.inv_host.argtypes = [p] * 12 + [i] * 5
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(CSRC, tmp_path_factory.mktemp("code_lanes"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ptrs(arrays):
    """A host array of three data pointers (null past the planes)."""
    vals = [a.ctypes.data if a is not None else 0 for a in arrays]
    vals += [0] * (3 - len(vals))
    return (ctypes.c_void_p * 3)(*vals)


def _mode(bd, dst, ts=False):
    return bd | int(dst) << 8 | int(ts) << 9


def _host_fwd(lib, orgs, preds, bd, dst, reverse, ts=False):
    coefs = [np.full(o.shape, -(1 << 30), np.int32) for o in orgs]
    tk = transform.ts_planes(len(orgs)) if ts else ()
    tcoefs = [np.full(orgs[k].shape, -(1 << 30), np.int32) for k in tk]
    tptr = [None] * 3
    for k, t in zip(tk, tcoefs):
        tptr[k] = t
    n1 = orgs[1].shape[-1] if len(orgs) == 3 else 0
    lib.lane_reverse(int(reverse))
    try:
        lib.fwd_host(_ptrs(orgs), _ptrs(preds), _ptrs(coefs), _ptrs(tptr),
                     len(orgs[0]), orgs[0].shape[-1], n1, len(orgs),
                     _mode(bd, dst, ts))
    finally:
        lib.lane_reverse(0)
    return (coefs, tcoefs) if ts else coefs


def _host_inv(lib, deqs, levs, preds, orgs, bits, dw, bd, dst, reverse):
    m = len(deqs[0])
    recs = [np.full(p.shape, -(1 << 30), np.int32) for p in preds]
    sses = [np.full(m, np.nan, np.float32) for _ in deqs]
    three = len(deqs) == 3
    cbf, dist, bsum = ((np.full(m, -1, np.int32), np.full(m, np.nan, np.float32),
                        np.full(m, np.nan, np.float32)) if three
                       else (None,) * 3)
    dwa = None if dw is None else np.array([dw], np.float32)
    lib.lane_reverse(int(reverse))
    try:
        lib.inv_host(_ptrs(deqs), _ptrs(levs), _ptrs(preds), _ptrs(orgs),
                     _ptrs(bits if three else []),
                     None if dwa is None else dwa.ctypes.data, _ptrs(recs),
                     _ptrs(sses), *(None if a is None else a.ctypes.data
                                    for a in (cbf, dist, bsum)), None,
                     m, deqs[0].shape[-1],
                     deqs[1].shape[-1] if three else 0, len(deqs),
                     _mode(bd, dst))
    finally:
        lib.lane_reverse(0)
    return recs, sses, cbf, dist, bsum


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32 or b.dtype == np.float32:
        a, b = a.astype(np.float32).view(np.int32), \
            b.astype(np.float32).view(np.int32)
    return a.shape == b.shape and np.array_equal(a, b)


def _plain_fwd(orgs, preds, bd, dst):
    t = lambda a: torch.as_tensor(a)
    return [c.numpy() for c in transform.fwd_level_plain(
        [t(o) for o in orgs], [t(p) for p in preds], bd, dst)]


def _plain_inv(deqs, levs, preds, orgs, bits, dw, bd, dst):
    t = lambda a: torch.as_tensor(a)
    recs, sses, cbf, dist, bsum = transform.inv_level_plain(
        [t(a) for a in deqs], [t(a) for a in levs], [t(a) for a in preds],
        [t(a) for a in orgs], bd,
        None if dw is None else torch.tensor(dw, dtype=torch.float32),
        None if bits is None else [t(b) for b in bits], dst)
    conv = lambda x: None if x is None else x.numpy()
    return ([r.numpy() for r in recs], [s.numpy() for s in sses], conv(cbf),
            conv(dist), conv(bsum))


def _check(lib, planes, bd, dst, dw, reverse, bits=None):
    orgs, preds, deqs, levs = (list(a) for a in zip(*planes))
    got = _host_fwd(lib, orgs, preds, bd, dst, reverse)
    want = _plain_fwd(orgs, preds, bd, dst)
    for k, (g, w) in enumerate(zip(got, want)):
        assert _same_bits(g, w), f"coef of plane {k}"
    got = _host_inv(lib, deqs, levs, preds, orgs, bits, dw, bd, dst, reverse)
    want = _plain_inv(deqs, levs, preds, orgs, bits, dw, bd, dst)
    for name, g, w in zip(("rec", "sse"), got[:2], want[:2]):
        for k, (a, b) in enumerate(zip(g, w)):
            assert _same_bits(a, b), f"{name} of plane {k}"
    for name, a, b in zip(("cbf", "dist", "bits"), got[2:], want[2:]):
        assert (a is None and b is None) or _same_bits(a, b), name
    return got


# m = 37: a ragged last thread block at every n (4, 2 and 1 blocks a
# thread block at n = 8, 16, 32)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_level_forms_equal_plain(lib, n, bd, reverse):
    rng = np.random.RandomState(n * 100 + bd)
    m = 37
    planes = _planes(rng, m, (n, n // 2, n // 2), bd)
    bits = [rng.randint(0, 3000, m).astype(np.float32) * np.float32(0.03125)
            for _ in range(3)]
    dw = float(np.float32(2.0 ** (1 / 3)))
    recs, sses, cbf, dist, bsum = _check(lib, planes, bd, False, dw, reverse,
                                         bits)
    assert (cbf == 7).sum() > 0 and cbf[2] == 0
    assert recs[0][0].max() == (1 << bd) - 1


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n,dst,dw", [(4, True, None), (4, False, 1.25),
                                      (8, False, None), (16, False, 1.25),
                                      (32, False, None)])
def test_one_plane_equal_plain(lib, n, dst, dw, reverse):
    """`_code`'s one-plane call: luma (the 4x4 DST too) or chroma with
    its distortion weight."""
    rng = np.random.RandomState(n + 7 * dst)
    _check(lib, _planes(rng, 21, (n,), 10 if n == 16 else 8), 10
           if n == 16 else 8, dst, dw, reverse)


@pytest.mark.parametrize("reverse", [False, True])
def test_sse_near_2_30(lib, reverse):
    """A 10-bit 32x32 TB reconstructed 1023 from its original everywhere:
    SSE 1023^2 * 1024 = 1,071,645,696, exact in the int32 sum and its one
    float32 conversion."""
    org = np.zeros((2, 32, 32), np.int32)
    pred = np.full((2, 32, 32), 1023, np.int32)
    zero = np.zeros((2, 32, 32), np.int32)
    got = _check(lib, [(org, pred, zero, zero)], 10, False, None, reverse)
    assert got[1][0][0] == np.float32(1023 ** 2 * 1024) and \
        1023 ** 2 * 1024 < 1 << 30 < 1 << 31


def test_transpose_mutation_is_caught(lib, tmp_path):
    """A copy of the header whose forward second stage reads column r of
    the tile (stage 1's output as it lies) where it should read row r
    must disagree with the plain version, lanes in order and reversed,
    where the header as it is agrees."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "transform.cuh"
    text = p.read_text()
    good = ("      const int* t = sm + (l / N) * N * (N + 1) + j.r * (N + 1);\n"
            "      int x[N], y[N];\n"
            "      HM_UNROLL\n"
            "      for (int k = 0; k < N; ++k) x[k] = t[k];\n"
            "      tr_1d<N>(x, y, false, level_dst(a, j));")
    bad = ("      const int* t = sm + (l / N) * N * (N + 1) + j.r;\n"
           "      int x[N], y[N];\n"
           "      HM_UNROLL\n"
           "      for (int k = 0; k < N; ++k) x[k] = t[k * (N + 1)];\n"
           "      tr_1d<N>(x, y, false, level_dst(a, j));")
    assert text.count(good) == 1
    p.write_text(text.replace(good, bad))
    (tmp_path / "b").mkdir()
    mut = _build(csrc, tmp_path / "b")
    rng = np.random.RandomState(9)
    planes = _planes(rng, 5, (8, 4, 4), 8)
    orgs, preds = [a[0] for a in planes], [a[1] for a in planes]
    want = _plain_fwd(orgs, preds, 8, False)
    for reverse in (False, True):
        assert all(_same_bits(g, w) for g, w in zip(
            _host_fwd(lib, orgs, preds, 8, False, reverse), want))
        assert not all(_same_bits(g, w) for g, w in zip(
            _host_fwd(mut, orgs, preds, 8, False, reverse), want)), reverse


@pytest.mark.parametrize("bd", [8, 10])
def test_plain_levels_match_hmtpu_code(bd):
    """The plain level functions against hmtpu's `_code` (its deadzone
    quantisation: lam None) on the CPU at a 64x64 picture's three levels
    (the P pass's 8, 16 and 32 grids of tests/test_torch_inter_e2e.py's
    64x64 clips, QP 27): the coefficients, each plane's reconstruction
    and SSE (chroma times HM's weight), and `hypothesis`'s cbf, dist and
    bits, exact."""
    from hmtpu.common.constants import SliceType
    from hmtpu.encoder.pframe_dev import _code as j_code
    from hmtpu.entropy.contexts import make_contexts
    from hmtpu.entropy.fracbits import ctx_bits_table
    from hmtpu.ops.quant import dequantize_t as j_deq
    from hmtpu.ops.transform import forward_transform as j_fwd
    from hmtpu_torch.common.lambdas import frame_lambdas
    from hmtpu_torch.utils.gen_test_yuv import synth_clip

    clip = list(synth_clip(64, 64, 2, seed=3))
    sh = bd - 8
    cur = [np.asarray(p, np.int32) << sh for p in clip[1]]
    ref = [np.asarray(p, np.int32) << sh for p in clip[0]]
    qp = 27
    cb = ctx_bits_table(make_contexts(SliceType.P, qp)).reshape(-1)
    dw = np.float32(frame_lambdas(qp, qp, 0.57)[2])

    def blocks(plane, n):
        h, w = plane.shape
        return plane.reshape(h // n, n, w // n, n).transpose(0, 2, 1, 3) \
            .reshape(-1, n, n)

    for n in (8, 16, 32):
        # the prediction: the reference moved a sample or two right
        orgs = [blocks(cur[k], n if k == 0 else n // 2) for k in range(3)]
        preds = [blocks(np.roll(ref[k], 2 - k, 1), n if k == 0 else n // 2)
                 for k in range(3)]
        coefs = transform.fwd_level_plain(
            [torch.as_tensor(a) for a in orgs],
            [torch.as_tensor(a) for a in preds], bd)
        outs = []
        for k in range(3):
            nk = n if k == 0 else n // 2
            np.testing.assert_array_equal(
                coefs[k].numpy(),
                np.asarray(j_fwd(jnp.asarray(orgs[k] - preds[k]), nk, bd)))
            code = jax.jit(partial(j_code, qp=qp, log2=nk.bit_length() - 1,
                                   bd=bd, lam=None, is_luma=k == 0))
            outs.append([np.asarray(x) for x in code(
                jnp.asarray(orgs[k]), jnp.asarray(preds[k]),
                cbflat=jnp.asarray(cb),
                dw=None if k == 0 else jnp.float32(dw))])
        levs, recs, sses, bits = (list(a) for a in zip(*outs))
        # hmtpu's levels, dequantised as its _code did them
        deqs = [np.asarray(j_deq(jnp.asarray(levs[k]), jnp.int32(qp),
                                 (n if k == 0 else n // 2).bit_length() - 1,
                                 bd)) for k in range(3)]
        t = lambda xs: [torch.as_tensor(np.array(x)) for x in xs]
        got = transform.inv_level_plain(t(deqs), t(levs), t(preds), t(orgs),
                                        bd, torch.tensor(dw), t(bits))
        for k in range(3):
            np.testing.assert_array_equal(got[0][k].numpy(), recs[k])
            assert _same_bits(got[1][k].numpy(), sses[k]), (n, k)
        m = len(orgs[0])
        nz = [(levs[k].reshape(m, -1) != 0).any(1).astype(np.int32)
              for k in range(3)]
        np.testing.assert_array_equal(got[2].numpy(),
                                      nz[0] | nz[1] << 1 | nz[2] << 2)
        assert _same_bits(got[3].numpy(),
                          np.asarray(jnp.asarray(sses[0]) + sses[1]
                                     + sses[2]))
        assert _same_bits(got[4].numpy(),
                          np.asarray(jnp.asarray(bits[0]) + bits[1]
                                     + bits[2]))
        assert got[2].numpy().max() > 0


# ---------------------------------------------------------------------------
# the TS mode: the transform-skip pair of the 4x4 planes

def _host_inv_ts(lib, deqs, levs, bits, tdeqs, tlevs, tbits, preds, orgs,
                 lam, dw, bd, dst, reverse):
    """The host build's inverse in TS mode: (recs, sses, levk, bitk, ts,
    cbf, dist, bitsum) as `inv_level_ts_plain` returns them."""
    m, P = len(deqs[0]), len(deqs)
    tk = transform.ts_planes(P)
    recs = [np.full(p.shape, -(1 << 30), np.int32) for p in preds]
    sses = [np.full(m, np.nan, np.float32) for _ in deqs]
    levk = [np.full(levs[k].shape, -(1 << 30), np.int32) for k in tk]
    bitk = [np.full(m, np.nan, np.float32) for _ in tk]
    ts = np.full(m, -1, np.int32)
    three = P == 3
    cbf, dist, bsum = ((np.full(m, -1, np.int32),
                        np.full(m, np.nan, np.float32),
                        np.full(m, np.nan, np.float32)) if three
                       else (None,) * 3)
    lama = np.array([lam], np.float32)
    dwa = None if dw is None else np.array([dw], np.float32)
    ext = [None] * 18
    for i, k in enumerate(tk):
        ext[k], ext[3 + k], ext[6 + k] = tdeqs[i], tlevs[i], tbits[i]
        ext[11 + k], ext[14 + k] = levk[i], bitk[i]
    ext[9], ext[10], ext[17] = _FLAG, lama, ts
    tab = (ctypes.c_void_p * 18)(*[0 if a is None else a.ctypes.data
                                   for a in ext])
    lib.lane_reverse(int(reverse))
    try:
        lib.inv_host(_ptrs(deqs), _ptrs(levs), _ptrs(preds), _ptrs(orgs),
                     _ptrs(bits), None if dwa is None else dwa.ctypes.data,
                     _ptrs(recs), _ptrs(sses),
                     *(None if a is None else a.ctypes.data
                       for a in (cbf, dist, bsum)), ctypes.addressof(tab),
                     m, deqs[0].shape[-1], deqs[1].shape[-1] if three else 0,
                     P, _mode(bd, dst, True))
    finally:
        lib.lane_reverse(0)
    return recs, sses, levk, bitk, ts, cbf, dist, bsum


def _plain_inv_ts(deqs, levs, bits, tdeqs, tlevs, tbits, preds, orgs, lam,
                  dw, bd, dst):
    t = lambda xs: [torch.as_tensor(a) for a in xs]
    out = transform.inv_level_ts_plain(
        t(deqs), t(levs), t(bits), t(tdeqs), t(tlevs), t(tbits), t(preds),
        t(orgs), torch.as_tensor(_FLAG), torch.tensor(lam,
                                                      dtype=torch.float32),
        bd, None if dw is None else torch.tensor(dw, dtype=torch.float32),
        dst)
    conv = lambda x: None if x is None else (
        [a.numpy() for a in x] if isinstance(x, list) else
        np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x))
    return [conv(x) for x in out]


def _check_ts(lib, planes, bd, dst, dw, lam, reverse, rng):
    orgs, preds, deqs, levs = (list(a) for a in zip(*planes))
    tk = transform.ts_planes(len(orgs))
    got_c, got_t = _host_fwd(lib, orgs, preds, bd, dst, reverse, ts=True)
    t = lambda xs: [torch.as_tensor(a) for a in xs]
    want_c, want_t = transform.fwd_level_plain(t(orgs), t(preds), bd, dst,
                                               ts=True)
    for k, (g, w) in enumerate(zip(got_c + got_t, want_c + want_t)):
        assert _same_bits(g, w.numpy()), f"coefficients {k}"
    alts = [_ts_alt(rng, planes[k], bd) for k in tk]
    bits = [rng.randint(0, 3000, len(orgs[0])).astype(np.float32)
            * np.float32(0.03125) for _ in orgs]
    for i, k in enumerate(tk):
        bits[k] = alts[i][2]
    args = (deqs, levs, bits, [a[0] for a in alts], [a[1] for a in alts],
            [a[3] for a in alts], preds, orgs, lam, dw, bd, dst)
    got = _host_inv_ts(lib, *args, reverse)
    want = _plain_inv_ts(*args)
    names = ("rec", "sse", "levk", "bitk", "ts", "cbf", "dist", "bits")
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
        elif isinstance(w, list):
            for k, (a, b) in enumerate(zip(g, w)):
                assert _same_bits(a, b), f"{name} {k}"
        else:
            assert _same_bits(g, w), name
    return got, alts


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("dst,dw", [(False, None), (True, None),
                                    (False, 1.25), (True, 1.25)])
def test_ts_pair_one_plane_equal_plain(lib, dst, dw, bd, reverse):
    """`_code_ts_sel`'s one-plane pair (the I pass's NxN luma PUs with
    the DST, its 4x4 chroma with the weight): both alternatives, both
    picks, and the ties (TBs 3-6) keep the DCT alternative."""
    rng = np.random.RandomState(40 + bd + 2 * dst + (dw is not None))
    planes = _planes(rng, 37, (4,), bd)
    lam = float(np.float32(rng.uniform(2, 60)))
    (recs, sses, levk, bitk, ts, *_), alts = _check_ts(
        lib, planes, bd, dst, dw, lam, reverse, rng)
    assert 0 < (ts & 1).sum() < 37 and not (ts[3:7] & 1).any()
    np.testing.assert_array_equal(levk[0][3:7], planes[0][3][3:7])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bd", [8, 10])
def test_ts_pair_chroma_equal_plain(lib, bd, reverse):
    """`hypothesis(with_ts=True)`'s 8 level: luma 8x8, the chroma pair
    coded both ways in one launch each, the level's cbf, dist and bits
    from the kept alternatives; both chroma planes keep TS somewhere."""
    rng = np.random.RandomState(60 + bd)
    planes = _planes(rng, 37, (8, 4, 4), bd)
    (recs, sses, levk, bitk, ts, cbf, dist, bsum), _ = _check_ts(
        lib, planes, bd, False, float(np.float32(2.0 ** (1 / 3))),
        float(np.float32(9.5)), reverse, rng)
    assert (ts & 1).any() and (ts & 2).any() and (ts != 3).any()


def test_ts_pick_on_tie_is_caught(lib, tmp_path):
    """A copy of the header whose pick keeps TS where the two costs tie
    must disagree with the plain version, lanes in order and reversed,
    where the header as it is agrees."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "transform.cuh"
    text = p.read_text()
    good = "const bool use = z1 != 0 && HM_FADD(d1, HM_FMUL(lam, b1)) <\n"
    assert text.count(good) == 1
    p.write_text(text.replace(good, good.replace(" <\n", " <=\n")))
    (tmp_path / "b").mkdir()
    mut = _build(csrc, tmp_path / "b")
    for reverse in (False, True):
        rng = np.random.RandomState(61)
        planes = _planes(rng, 9, (4,), 8)
        _check_ts(lib, planes, 8, False, None, 7.0, reverse, rng)
        rng = np.random.RandomState(61)
        planes = _planes(rng, 9, (4,), 8)
        with pytest.raises(AssertionError):
            _check_ts(mut, planes, 8, False, None, 7.0, reverse, rng)


@pytest.mark.parametrize("bd", [8, 10])
def test_plain_ts_pair_matches_hmtpu_code_ts_sel(bd):
    """The port's `_code_ts_sel` on the CPU (`fwd_level_plain(ts=True)`,
    K10's plain coding of both alternatives, `inv_level_ts_plain`)
    against hmtpu's at the 8 level's chroma of
    `test_plain_levels_match_hmtpu_code`'s 64x64 picture, its chroma
    marked with text-like strokes where transform skip wins (QP 27, RDOQ
    with SDH, HM's chroma weight): levels, reconstruction, distortion,
    rate with the flag and the pick, exact."""
    from hmtpu.common.constants import SliceType
    from hmtpu.encoder.pframe_dev import _code_ts_sel as j_sel
    from hmtpu.entropy.contexts import make_contexts
    from hmtpu.entropy.fracbits import ctx_bits_table
    from hmtpu_torch.common.lambdas import frame_lambdas
    from hmtpu_torch.encoder.pframe_dev import _code_ts_sel as p_sel
    from hmtpu_torch.utils.gen_test_yuv import synth_clip

    clip = list(synth_clip(64, 64, 2, seed=3))
    sh = bd - 8
    cur = [np.asarray(p, np.int32) << sh for p in clip[1]]
    ref = [np.asarray(p, np.int32) << sh for p in clip[0]]
    rng = np.random.RandomState(11)
    for k in (1, 2):
        cur[k][rng.rand(*cur[k].shape) < 0.08] = 230 << sh
    qp = 27
    cb = ctx_bits_table(make_contexts(SliceType.P, qp)).reshape(-1)
    _, _, dw, lam_c = (np.float32(v) for v in frame_lambdas(qp, qp, 0.57))

    def blocks(plane):
        h, w = plane.shape
        return plane.reshape(h // 4, 4, w // 4, 4).transpose(0, 2, 1, 3) \
            .reshape(-1, 4, 4)

    org = np.concatenate([blocks(cur[k]) for k in (1, 2)])
    pred = np.concatenate([blocks(np.roll(ref[k], 2 - k, 1))
                           for k in (1, 2)])
    want = jax.jit(partial(j_sel, bd=bd, is_luma=False, sdh=True))(
        jnp.asarray(org), jnp.asarray(pred), qp=jnp.int32(qp),
        lam=jnp.float32(lam_c), cbflat=jnp.asarray(cb), dw=jnp.float32(dw))
    got = p_sel(torch.as_tensor(org), torch.as_tensor(pred), qp, bd,
                torch.tensor(lam_c), torch.as_tensor(cb), False,
                torch.tensor(dw), sdh=True)
    for name, a, b in zip(("lev", "rec", "sse", "bits", "use_ts"), got,
                          want):
        assert _same_bits(a.numpy(), np.asarray(b)), name
    assert 0 < int(got[4].sum()) < len(org)
