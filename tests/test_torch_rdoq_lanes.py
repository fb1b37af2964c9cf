"""The lane code of K10 rdoq (csrc/rdoq.cuh: one lane per coefficient
position, the context state from votes over a CG's lanes) and of K22
i_rmd (csrc/i_rmd.cuh: a (mode, tile) on a warp's lanes), compiled as
host C++ with g++ and driven on the CPU against the plain versions,
bit for bit: `rdoq_tb_plain`, `tb_bits_plain` and `dequantize_t_plain`
for K10 (`rdoq_host`: every TB of a batch through `rdoq_tb` with one
thread), `rmd_plain` for K22.  The plain versions are held against hmtpu
in tests/test_torch_ops.py and test_torch_inter_ops.py.

The host build runs a CG's 16 lanes (a warp's 32) in a loop, in order
or (`lane_reverse`) last lane first, so a lane that reads what another
lane of the same step writes is caught.  The contents reach the coder's
edges: an all-zero TB, DC only, more than C1FLAG significant positions
in a CG, levels whose Rice parameter reaches 4, a CG that stage 2
zeroes, the all-zero TB winning stage 3, an SDH parity fix; the two
trellis edges are shown reached by copies of the header with the stage
switched off, which the comparison must catch.  Built with
-ffp-contract=off, so every float32 operation rounds on its own as
nvcc's __fadd_rn / __fmul_rn do.  Skips only where there is no g++.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hmtpu_torch.common.constants import SliceType
from hmtpu_torch.common.lambdas import frame_lambdas
from hmtpu_torch.encoder.intra_rdo import rmd_plain
from hmtpu_torch.entropy.contexts import make_contexts
from hmtpu_torch.entropy.fracbits import ctx_bits_table
from hmtpu_torch.kernels import CSRC
from hmtpu_torch.ops import quant, ratebits, rdoq
from hmtpu_torch.search.wavefront import static_ref_gather
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)

_LANES_CPP = r"""
#include <vector>
#include "rdoq.cuh"
#include "i_rmd.cuh"
// HM_LANES last lane first (1) or in order (0)
extern "C" void lane_reverse(int r) { hm::lane_reverse = r; }
// K10 over nb TBs of a batch, one thread, its last-position table built
// first as each block of the kernel builds it
extern "C" void rdoq_host(const int* x, const float* cb, float lam,
                          const int* scan_sel, const int* tabs_i,
                          const float* tabs_f, int* lev_out, int* deq_out,
                          float* bits_out, int nb, int log2, int flags,
                          int scale, int qbits, int add, int iscale,
                          int dq_shift, int ctx_x, int ctx_y,
                          int sig_cg_base, int one_base, int abs_base,
                          float inv, float cscale) {
  const int size = 1 << log2, npos = size * size;
  std::vector<float> lpb(2 * size);
  hm::rdoq_last_bits(cb, tabs_f, ctx_x, ctx_y, size, lpb.data(), 0, 1);
  hm::RdoqCfg c{cb, tabs_i, tabs_f, lpb.data(), log2, flags, scale,
                qbits, add, iscale, dq_shift, ctx_x, ctx_y, sig_cg_base,
                one_base, abs_base, inv, cscale};
  std::vector<double> sm(hm::rdoq_smem_bytes(log2) / sizeof(double) + 1);
  hm::RdoqSmem S = hm::rdoq_smem(sm.data(), npos);
  for (int b = 0; b < nb; ++b) {
    const size_t o = (size_t)b * npos;
    const float bits = hm::rdoq_tb(
        c, lam, scan_sel ? scan_sel[b] : -1, x + o,
        lev_out ? lev_out + o : nullptr, deq_out ? deq_out + o : nullptr,
        bits_out != nullptr, S, 0, 1);
    if (bits_out) bits_out[b] = bits;
  }
}
// K22 over nb blocks
extern "C" void rmd_host(const int* plane, const int* sub, const int* none,
                         int* out, int nb, int w, int n, int bd, int strong,
                         int k, float lam_sqrt) {
  rmd::Args a{plane, sub, none, out, w, n, bd, strong, k, lam_sqrt};
  std::vector<int> sm(rmd::R_INTS);
  for (int b = 0; b < nb; ++b) rmd::rmd_block(a, b, 0, 1, sm.data());
}
"""

QP = 27


def _build(d, csrc):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile csrc/rdoq.cuh as host C++")
    src, so = d / "lanes.cpp", d / "librdoqlanes.so"
    src.write_text(_LANES_CPP)
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(csrc), "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.lane_reverse.argtypes = [ctypes.c_int]
    lib.rdoq_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_float] + [ctypes.c_void_p] * 6 \
        + [ctypes.c_int] * 13 + [ctypes.c_float] * 2
    lib.rmd_host.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_float]
    return lib


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("rdoq_lanes"), CSRC)


def _cb(qp=QP):
    return torch.as_tensor(ctx_bits_table(make_contexts(SliceType.P, qp))
                           .reshape(-1))


def _lam(luma, qp=QP):
    return np.float32(frame_lambdas(qp, qp, 0.4624)[0 if luma else 3])


def _ptr(t):
    return None if t is None else t.data_ptr()


def host_k10(lib, x, log2, luma, scan_idx, *, cb, bd, lam, sdh, scan_sel,
             trellis, lev_in=False, reverse=False, qp=QP):
    """(levels, dequantised, TB rates) of the host build on a batch of
    (B, n, n) int32 TBs: K10's arguments as ops/rdoq.py `k10` passes
    them."""
    n = 1 << log2
    tabs_i, tabs_f, ctx = rdoq._k10_tables(log2, scan_idx, luma, "cpu")
    qbits, scale, inv, cscale = rdoq._quant_params(qp, log2, bd)
    iscale, dq_shift = quant.dequant_params(qp, log2, bd)
    flags = (1 * lev_in + 2 * (trellis and not lev_in) + 4 * sdh
             + 8 * luma)
    x = x.to(torch.int32).reshape(-1, n, n).contiguous()
    nb = x.shape[0]
    lev = torch.empty_like(x)
    deq = torch.empty_like(x)
    bits = torch.empty(nb, dtype=torch.float32)
    sel = None if scan_sel is None else scan_sel.to(torch.int32).contiguous()
    lib.lane_reverse(int(reverse))
    try:
        lib.rdoq_host(x.data_ptr(), cb.data_ptr(), float(lam), _ptr(sel),
                      tabs_i.data_ptr(), tabs_f.data_ptr(), lev.data_ptr(),
                      deq.data_ptr(), bits.data_ptr(), nb, log2, flags, scale,
                      qbits, 85 << (qbits - 9), iscale, dq_shift,
                      ctx["ctx_x"], ctx["ctx_y"], ctx["sig_cg_base"],
                      ctx["one_base"], ctx["abs_base"], inv, cscale)
    finally:
        lib.lane_reverse(0)
    return lev, deq, bits


def contents(log2, bd, seed, qp=QP):
    """{edge: (B, n, n) int32 coefficients} reaching the coder's edges
    (module note), by seeded construction in units of the quantiser's
    step."""
    n = 1 << log2
    rng = np.random.RandomState(seed)
    step = rdoq._quant_params(qp, log2, bd)[2]
    sgn = lambda *s: rng.choice([-1, 1], s or (1,))

    def tb():
        return np.zeros((n, n))

    out = {"zero": [tb()]}
    d = tb()
    d[0, 0] = 6.3 * step
    out["dc"] = [d]
    c1 = []
    for _ in range(3):   # every position of the top-left CG significant
        d = tb()
        d[:4, :4] = rng.uniform(0.9, 2.4, (4, 4)) * step * sgn(4, 4)
        c1.append(d)
    out["c1flag"] = c1
    r4 = []
    for _ in range(2):   # levels past 3 << 3: the Rice parameter reaches 4
        d = tb()
        d[:4, :4] = rng.uniform(30, 70, (4, 4)) * step * sgn(4, 4)
        r4.append(d)
    out["rice4"] = r4
    if n >= 8:
        # a strong first and last CG, and between them a CG whose one
        # small level (maxAbs 1) sweeps across stage 2's window: kept by
        # stage 1, dearer than the CG's flag saves
        s2 = []
        for i, f in enumerate(np.linspace(0.5, 1.2, 24)):
            d = tb()
            d[:4, :4] = rng.uniform(1.5, 4.5, (4, 4)) * step * sgn(4, 4)
            d[n - 4 + rng.randint(4), n - 4 + rng.randint(4)] = 3.3 * step
            for _ in range(1 + i % 2):
                d[rng.randint(4), 4 + rng.randint(4)] = f * step * sgn()[0]
            s2.append(d)
        out["stage2"] = s2
    # a lone level 1 far from DC (its last-position bits dear; near DC at
    # n = 4), which the deadzone keeps too: the all-zero TB wins stage 3
    # and then the guard
    zw = []
    for f in np.linspace(0.85, 1.6, 16):
        d = tb()
        lo = n - 3 if n >= 8 else 1
        d[rng.randint(lo, n), rng.randint(lo, n)] = f * step * sgn()[0]
        zw.append(d)
    out["zero_wins"] = zw
    sd = []   # dense CGs of mixed signs: some break the hidden sign's parity
    for _ in range(6):
        d = tb()
        d[:4, :4] = rng.uniform(0.7, 3.6, (4, 4)) * step * sgn(4, 4)
        if n >= 8:
            d[4:8, :4] = rng.uniform(0.7, 2.6, (4, 4)) * step * sgn(4, 4)
        sd.append(d)
    out["sdh"] = sd
    rnd = []   # residual-like: larger at low frequencies
    yy, xx = np.mgrid[0:n, 0:n]
    for _ in range(4):
        rnd.append(rng.laplace(0, 4 * step / (1 + xx + yy)))
    out["random"] = rnd
    lim = (1 << 15) - 1
    return {k: torch.as_tensor(np.clip(np.rint(np.stack(v)), -lim, lim)
                               .astype(np.int32)) for k, v in out.items()}


def _batch(log2, bd, seed):
    c = contents(log2, bd, seed)
    names = [k for k in c for _ in range(c[k].shape[0])]
    return torch.cat(list(c.values())), names


MODES = {"trellis+sdh": (True, True), "trellis": (True, False),
         "deadzone+sdh": (False, True), "deadzone": (False, False)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_rdoq_lanes_equal_plain(lanes, log2, luma, bd, mode):
    """K10's lane code against rdoq_tb_plain (levels), dequantize_t_plain
    and tb_bits_plain (the rate, SDH's sign rule where on), for scans 0,
    1 and 2, the lanes in order and reversed; then given the plain
    levels (F_LEV_IN), their price and dequantisation."""
    trellis, sdh = MODES[mode]
    coef, _ = _batch(log2, bd, 17 * log2 + bd + luma)
    cb, lam = _cb(), _lam(luma)
    rng = np.random.RandomState(log2 + bd)
    for scan_idx in (0, 1, 2):
        sel = torch.as_tensor(rng.randint(0, 3, coef.shape[0])) \
            if sdh and log2 <= 3 else None
        want = rdoq.rdoq_tb_plain(coef, QP, log2, bd, torch.tensor(lam), cb,
                                  luma, scan_idx, sdh, sel, trellis)
        want_deq = quant.dequantize_t_plain(want, QP, log2, bd)
        want_bits = ratebits.tb_bits_plain(want, cb, log2, luma, scan_idx,
                                           sdh)
        for reverse in (False, True):
            lev, deq, bits = host_k10(
                lanes, coef, log2, luma, scan_idx, cb=cb, bd=bd, lam=lam,
                sdh=sdh, scan_sel=sel, trellis=trellis, reverse=reverse)
            assert torch.equal(lev, want), (scan_idx, reverse)
            assert torch.equal(deq, want_deq), (scan_idx, reverse)
            assert torch.equal(bits.view(torch.int32),
                               want_bits.view(torch.int32)), (scan_idx,
                                                               reverse)
        _, deq, bits = host_k10(lanes, want, log2, luma, scan_idx, cb=cb,
                                bd=bd, lam=lam, sdh=sdh, scan_sel=None,
                                trellis=False, lev_in=True)
        assert torch.equal(deq, want_deq)
        assert torch.equal(bits.view(torch.int32),
                           want_bits.view(torch.int32))


def _scan_levels(lev, log2, scan_idx=0):
    t = ratebits._tb_tables_np(log2, scan_idx, True)
    return lev.reshape(lev.shape[0], -1)[:, t["scans"]].abs() \
        .reshape(lev.shape[0], -1, 16)


def _rice_peak(cg):
    """The coder's largest Rice parameter over one CG's |levels| (scan
    order), walking it from the last position (ratebits' rule)."""
    rank = ge2 = rice = peak = 0
    for a in reversed(cg.tolist()):
        if a == 0:
            continue
        base = (2 if ge2 else 3) if rank < 8 else 1
        if a >= base and a > (3 << rice):
            rice = min(rice + 1, 4)
        peak = max(peak, rice)
        ge2 += a >= 2
        rank += 1
    return peak


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_rdoq_contents_reach_their_edges(log2):
    """What the batch's contents are there for, seen in the plain
    version's levels: the all-zero TB (rate 0), DC only, a CG of more than
    C1FLAG significant positions, a Rice parameter of 4, an SDH parity
    fix (levels with SDH differ from those without)."""
    coef, names = _batch(log2, 8, 5)
    cb, lam = _cb(), torch.tensor(_lam(True))
    pick = lambda k: torch.tensor([i for i, m in enumerate(names) if m == k])
    for trellis in (True, False):
        lev = rdoq.rdoq_tb_plain(coef, QP, log2, 8, lam, cb, True, 0, False,
                                 None, trellis)
        bits = ratebits.tb_bits_plain(lev, cb, log2, True, 0, False)
        assert (lev[pick("zero")] == 0).all() and (bits[pick("zero")] == 0).all()
        dc = lev[pick("dc")].reshape(-1, 1 << (2 * log2))
        assert (dc[:, 0] != 0).all() and (dc[:, 1:] == 0).all()
        s = _scan_levels(lev[pick("c1flag")], log2)
        assert ((s > 0).sum(-1) > 8).any()
        s = _scan_levels(lev[pick("rice4")], log2)
        assert max(_rice_peak(cg) for t in s for cg in t) == 4
        hid = rdoq.rdoq_tb_plain(coef, QP, log2, 8, lam, cb, True, 0, True,
                                 None, trellis)
        i = pick("sdh")
        assert (hid[i] != lev[i]).any()


# header copies with a trellis stage switched off: (edge, text, mutant)
MUTANTS = {
    "stage2": ("      last_cg > 1 ? flag_bits(F.zf, ncg)",
               "      false ? flag_bits(F.zf, ncg)"),
    "zero_wins": ("const bool use_zero = F.all_zero <= best;",
                  "const bool use_zero = false;"),
}


@pytest.mark.parametrize("edge", sorted(MUTANTS))
def test_rdoq_trellis_edges_are_reached(tmp_path, edge):
    """A copy of rdoq.cuh with stage 2's zeroing (or stage 3's all-zero
    choice) switched off must disagree with the plain version on the
    contents built to reach that edge, and only there."""
    good, bad = MUTANTS[edge]
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "rdoq.cuh"
    text = p.read_text()
    assert text.count(good) == 1
    p.write_text(text.replace(good, bad))
    lib = _build(tmp_path, csrc)
    cb, lam = _cb(), _lam(True)
    hit = 0
    for log2 in (4, 5):
        coef, names = _batch(log2, 8, 9 + log2)
        want = rdoq.rdoq_tb_plain(coef, QP, log2, 8, torch.tensor(lam), cb,
                                  True, 0, False, None, True)
        lev, _, _ = host_k10(lib, coef, log2, True, 0, cb=cb, bd=8, lam=lam,
                             sdh=False, scan_sel=None, trellis=True)
        diff = {names[i] for i in range(len(names))
                if not torch.equal(lev[i], want[i])}
        assert diff <= {edge, "random", "sdh"}, diff
        hit += edge in diff
    assert hit == 2


@pytest.mark.parametrize("n,k", [(4, 1), (8, 2), (16, 2), (32, 2)])
def test_rmd_lanes_reversed(lanes, n, k):
    """K22's lane code with each warp's lanes run last first equals
    rmd_plain (the in-order runs are tests/test_torch_iwalk.py's)."""
    rng = np.random.RandomState(3 * n + k)
    for bd in (8, 10):
        plane = torch.as_tensor(rng.randint(0, 1 << bd, (64, 96))
                                .astype(np.int32))
        plane[:16] = 1 << (bd - 1)               # flat: every mode ties
        sub, none = static_ref_gather(96, 64, 6, n)
        nb = (64 // n) * (96 // n)
        lam = np.float32(5.7 if bd == 8 else 23.1)
        want = rmd_plain(plane, (torch.as_tensor(sub).long(),
                                 torch.as_tensor(none)), n, k, bd=bd,
                         lam_sqrt=lam, sis=True)
        got = torch.zeros((nb, k), dtype=torch.int32)
        s32 = torch.as_tensor(sub.astype(np.int32))
        n32 = torch.as_tensor(none.astype(np.int32))
        lanes.lane_reverse(1)
        try:
            lanes.rmd_host(plane.data_ptr(), s32.data_ptr(), n32.data_ptr(),
                           got.data_ptr(), nb, 96, n, bd, 1, k, float(lam))
        finally:
            lanes.lane_reverse(0)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
