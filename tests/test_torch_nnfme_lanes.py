"""K14 nnfme_fwd's and K15 nnfme_bwd's lane code (csrc/nnfme_train.cuh:
a row on a warp, one output unit a lane; a block's rows summed per
parameter; the blocks' partials summed in ascending block order on a
warp) compiled as host C++ with g++ and driven on the CPU against the
port's plain versions (`loss_fwd_plain`, `loss_bwd_plain`), bit for bit:
the mean loss and accuracy, z1, z2, the d-logits and all 2060 gradient
entries; and K15 with K16 as its tail (the lane that finishes a
parameter's gradient updates it and its moments, the bias corrections
read from the table by the step count) against `loss_bwd_adam_plain`
(`loss_bwd_plain`, then `adam_update_plain`): the gradient, parameters,
moments and the count written back.  A mutated header whose tail reads
the table one entry off must disagree.

The host build runs every lane of a `HM_LANES` loop on one thread, in
order or (`lane_reverse`) last lane first, so a lane that read what
another lane of the same loop writes would see it unwritten in one of
the two orders; a mutated header where the second layer's backward
reads the d-units of the row vector in the loop that writes them shows
that the comparison catches that.  Built with -ffp-contract=off, so
every product and sum rounds on its own as nvcc's __fmul_rn / __fadd_rn
do.  The card runs the same functions in the kernels, which the `gpu`
test of K14 and K15 (tests/test_torch_gpu.py) and chip_smoke.py hold to
the plain versions.  Skips only where there is no g++.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hmtpu_torch.kernels import CSRC
from hmtpu_torch.models import nnfme, train
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)

_LANES_CPP = r"""
#include "nnfme_train.cuh"
extern "C" void lane_reverse(int r) { hm::lane_reverse = r; }
extern "C" void fwd_host(const float* pack, const float* costs, const int* h,
                         const int* w, const int* labels, float* z1,
                         float* z2, float* dl, float* part, float* out, int B,
                         float inv_b) {
  nnt::fwd_host(pack, costs, h, w, labels, z1, z2, dl, part, out, B, inv_b);
}
extern "C" void bwd_host(float* pack, const float* costs, const int* h,
                         const int* w, const float* z1, const float* z2,
                         const float* dl, float gsc, float* part, float* grad,
                         int B, float* mu, float* nu, int* count,
                         const float* bc, int ntab, float b1, float omb1,
                         float b2, float omb2, float eps, float neg_lr) {
  nnt::bwd_host(pack, costs, h, w, z1, z2, dl, gsc, part, grad, B, mu, nu,
                count, bc, ntab, b1, omb1, b2, omb2, eps, neg_lr);
}
"""


def _build(csrc, d):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile csrc/nnfme_train.cuh as host C++")
    src, so = d / "lanes.cpp", d / "liblanes.so"
    src.write_text(_LANES_CPP)
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(csrc), "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lane_reverse.argtypes = [i]
    lib.fwd_host.argtypes = [p] * 10 + [i, f]
    lib.bwd_host.argtypes = [p] * 7 + [f, p, p, i] + [p] * 4 + [i] + [f] * 6
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(CSRC, tmp_path_factory.mktemp("nnfme_lanes"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SIZES = [4, 8, 12, 16, 20, 24, 32, 64]   # every table row, and 20 (row 0)


def _batch(B, weights, seed):
    """B seeded rows (QP-22-like costs, every size of the tables, labels
    0-48) and packed parameters: `init`, the port's init from the seed
    with the batch's mean / std and the size-4 embedding rows zeroed, and
    the batch's last row of size 4 with costs equal to the mean, so every
    first-layer pre-activation of that row is exactly 0 (with B = 1 the
    row alone); `qp22`, the in-repo trained QP-22 weights with the
    batch's mean / std."""
    rng = np.random.RandomState(seed)
    base = rng.randint(200, 6000, (B, 1))
    c9 = (base + rng.randint(0, 900, (B, 9))).astype(np.float32)
    hs = rng.choice(_SIZES, B).astype(np.int32)
    ws = rng.choice(_SIZES, B).astype(np.int32)
    lab = rng.randint(0, 49, B).astype(np.int32)
    mean = c9.mean(0).astype(np.float32)
    std = (c9.std(0) + 1e-8).astype(np.float32)
    if weights == "qp22":
        d = dict(np.load(f"{nnfme.WEIGHTS_DIR}/qp22.npz"))
    else:
        p0 = nnfme.init_random(torch.Generator().manual_seed(seed), "cpu")
        d = {k: getattr(p0, k).numpy().copy() for k in nnfme.PACK_ORDER}
        d["emb_h"][1] = 0.0
        d["emb_w"][1] = 0.0
        c9[-1], hs[-1], ws[-1] = mean, 4, 4
    d.update(mean=mean, std=std)
    pk = nnfme.params_from_arrays(d, "cpu").packed.detach().numpy().copy()
    return pk, c9, hs, ws, lab


def _ptr(a):
    return a.ctypes.data if a is not None else None


def _host(lib, pk, c9, hs, ws, lab, want_grad, reverse):
    """The host build's (out, (z1, z2, dl) or None, grad or None)."""
    B = len(lab)
    nb = -(-B // train.KROWS)
    part = np.full(nb * nnfme.PACK_SIZE, np.nan, np.float32)
    out = np.full(2, np.nan, np.float32)
    saved = tuple(np.full((B, n), np.nan, np.float32) for n in (22, 20, 49)) \
        if want_grad else (None,) * 3
    lib.lane_reverse(int(reverse))
    try:
        lib.fwd_host(_ptr(pk), _ptr(c9), _ptr(hs), _ptr(ws), _ptr(lab),
                     *(_ptr(a) for a in saved), _ptr(part), _ptr(out), B,
                     train._inv(B))
        if not want_grad:
            return out, None, None
        grad = np.full(nnfme.PACK_SIZE, np.nan, np.float32)
        lib.bwd_host(_ptr(pk), _ptr(c9), _ptr(hs), _ptr(ws), *map(_ptr, saved),
                     1.0, _ptr(part), _ptr(grad), B, None, None, None, None,
                     0, *[0.0] * 6)
        return out, saved, grad
    finally:
        lib.lane_reverse(0)


def _same_bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def _plain(pk, c9, hs, ws, lab, want_grad=True):
    t = torch.as_tensor
    out, saved = train.loss_fwd_plain(t(pk), t(c9), t(hs), t(ws), t(lab),
                                      want_grad)
    if not want_grad:
        return out.numpy(), None, None
    grad = train.loss_bwd_plain(t(pk), t(c9), t(hs), t(ws), *saved,
                                torch.ones(1))
    return out.numpy(), [s.numpy() for s in saved], grad.numpy()


# batch sizes: 1 (the exact-zero row alone with `init`), 32 (each epoch's
# last batch at the trainer's defaults), 100 (a last block of 4 rows),
# 1024 (a full batch: 128 blocks, the ordered sum in one round of 128)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("weights", ["init", "qp22"])
@pytest.mark.parametrize("B", [1, 32, 100, 1024])
def test_host_lanes_equal_plain(lib, B, weights, reverse):
    pk, c9, hs, ws, lab = _batch(B, weights, seed=B + 7)
    if weights == "init":
        z1 = nnfme.forward_parts(nnfme.params_from_packed(torch.as_tensor(
            pk)), *(torch.as_tensor(a[-1:]) for a in (c9, hs, ws)))["z1"]
        assert bool((z1 == 0).all()), "the last row must hit z1 == 0"
    out, saved, grad = _host(lib, pk, c9, hs, ws, lab, True, reverse)
    wout, wsaved, wgrad = _plain(pk, c9, hs, ws, lab)
    assert _same_bits(out, wout), (out, wout)
    for k, (a, b) in enumerate(zip(saved, wsaved)):
        assert _same_bits(a, b), ("z1", "z2", "dl")[k]
    assert _same_bits(grad, wgrad), np.abs(grad - wgrad).max()
    # the gradient reaches every field it can: a lone row is its batch's
    # mean (no std or gin gradient), and b1 and mean see the zero row's
    # 0.5 of maximum(x, 0) at x == 0
    fields = nnfme.params_from_packed(torch.as_tensor(grad))
    for k in ("b1", "mean") if B == 1 \
            else ("mean", "std", "gin", "w1", "b1", "w2", "w3", "b3"):
        assert np.abs(getattr(fields, k).numpy()).max() > 0, k


@pytest.mark.parametrize("reverse", [False, True])
def test_host_lanes_validation_equals_plain(lib, reverse):
    """K14 without the backward's tensors on the validation set's 7176
    rows (`loss_fn`, 897 blocks: the ordered sum in eight rounds)."""
    pk, c9, hs, ws, lab = _batch(7176, "qp22", seed=11)
    out, _, _ = _host(lib, pk, c9, hs, ws, lab, False, reverse)
    wout, _, _ = _plain(pk, c9, hs, ws, lab, want_grad=False)
    assert _same_bits(out, wout), (out, wout)
    assert 0 < out[1] < 1


def test_host_lanes_race_is_caught(lib, tmp_path):
    """A copy of the header whose second layer's backward runs in the
    loop that writes the third layer's d-units and reads them from the
    row vector (a lane reading another lane's unit before the barrier:
    on the card a shared-memory race) must disagree with the plain
    version, lanes in order and reversed, where the header as it is
    agrees."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "nnfme_train.cuh"
    text = p.read_text()
    for good, bad in (
            ("  }\n  HM_LANES(k, 32) {  // layer 2 back",
             "    // layer 2 back"),
            ("lane_get(dz2, j)", "q[rDz2 + j]")):
        assert text.count(good) == 1, good
        text = text.replace(good, bad)
    p.write_text(text)
    (tmp_path / "b").mkdir()
    mut = _build(csrc, tmp_path / "b")
    pk, c9, hs, ws, lab = _batch(32, "qp22", seed=5)
    _, _, want = _plain(pk, c9, hs, ws, lab)
    for reverse in (False, True):
        assert _same_bits(_host(lib, pk, c9, hs, ws, lab, True, reverse)[2],
                          want)
        assert not _same_bits(_host(mut, pk, c9, hs, ws, lab, True,
                                    reverse)[2], want), reverse


# K16 as K15's tail: a table of N = 1740 updates (a QP's steps at the
# trainer's defaults), the update's number k = 1, 2 and N
_N = 1740
_PLAIN_GRAD: dict = {}


def _step_inputs(B):
    """A batch's inputs to K15 and the plain gradient (kept a batch)."""
    if B not in _PLAIN_GRAD:
        pk, c9, hs, ws, lab = _batch(B, "qp22", seed=B + 3)
        _, saved, grad = _plain(pk, c9, hs, ws, lab)
        _PLAIN_GRAD[B] = (pk, c9, hs, ws, saved, grad)
    return _PLAIN_GRAD[B]


def _moments(k):
    rng = np.random.RandomState(k)
    mu = (rng.randn(nnfme.PACK_SIZE) * 1e-3).astype(np.float32)
    nu = (np.abs(rng.randn(nnfme.PACK_SIZE)) * 1e-5).astype(np.float32)
    return mu, nu


def _host_step(lib, B, k, reverse):
    """The host build's fused step at update k: (grad, params, mu, nu,
    the count written back)."""
    pk, c9, hs, ws, saved, _ = _step_inputs(B)
    p, (mu, nu) = pk.copy(), _moments(k)
    count = np.array([k - 1], np.int32)
    bc = train.bias_corrections(_N, "cpu").numpy()
    part = np.full(-(-B // train.KROWS) * nnfme.PACK_SIZE, np.nan,
                   np.float32)
    grad = np.full(nnfme.PACK_SIZE, np.nan, np.float32)
    lib.lane_reverse(int(reverse))
    try:
        lib.bwd_host(_ptr(p), _ptr(c9), _ptr(hs), _ptr(ws),
                     *map(_ptr, saved), 1.0, _ptr(part), _ptr(grad), B,
                     _ptr(mu), _ptr(nu), _ptr(count), _ptr(bc), _N,
                     *train._adam_consts(3e-3))
    finally:
        lib.lane_reverse(0)
    return grad, p, mu, nu, int(count[0])


def _plain_step(B, k):
    """`loss_bwd_adam_plain` at update k, the same inputs."""
    pk, c9, hs, ws, saved, _ = _step_inputs(B)
    t = torch.as_tensor
    p = t(pk.copy())
    mu, nu = (t(a) for a in _moments(k))
    opt = train.adam_state(mu, nu, k - 1, _N - (k - 1))
    grad = train.loss_bwd_adam_plain(p, t(c9), t(hs), t(ws),
                                     *(t(a) for a in saved), torch.ones(1),
                                     opt, 3e-3)
    return grad.numpy(), p.numpy(), mu.numpy(), nu.numpy(), \
        int(opt.dcount[0])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("k", [1, 2, _N])
@pytest.mark.parametrize("B", [1, 32, 1024])
def test_host_adam_tail_equals_plain(lib, B, k, reverse):
    """K15 with K16 as its tail against `loss_bwd_adam_plain`, bit for
    bit: the gradient, the parameters, both moments, and the step count
    written back (k - 1 in, k out); the gradient is K15's alone."""
    got = _host_step(lib, B, k, reverse)
    want = _plain_step(B, k)
    for name, a, b in zip(("grad", "params", "mu", "nu"), got, want):
        assert _same_bits(a, b), name
    assert got[4] == want[4] == k
    assert _same_bits(got[0], _step_inputs(B)[5])
    # the update reached the parameters (all but those too large for
    # their step to show in float32)
    assert (got[1] != _step_inputs(B)[0]).mean() > 0.9


def test_host_adam_tail_table_off_by_one_is_caught(lib, tmp_path):
    """A copy of the header whose tail reads the bias corrections one
    entry past the step's must disagree with the plain step, lanes in
    order and reversed, where the header as it is agrees."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    p = csrc / "nnfme_train.cuh"
    text = p.read_text()
    for good, bad in (("a.bc1 = bc[2 * count];", "a.bc1 = bc[2 * count + 2];"),
                      ("a.bc2 = bc[2 * count + 1];",
                       "a.bc2 = bc[2 * count + 3];")):
        assert text.count(good) == 1, good
        text = text.replace(good, bad)
    p.write_text(text)
    (tmp_path / "b").mkdir()
    mut = _build(csrc, tmp_path / "b")
    want = _plain_step(32, 2)
    for reverse in (False, True):
        assert _same_bits(_host_step(lib, 32, 2, reverse)[1], want[1])
        got = _host_step(mut, 32, 2, reverse)
        assert _same_bits(got[0], want[0])
        assert not _same_bits(got[1], want[1]), reverse
