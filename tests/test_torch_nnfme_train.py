"""NN-FME dataset extraction and training of hmtpu_torch against hmtpu:
the same seeded numpy inputs through hmtpu (JAX on the CPU) and through
the port with CPU tensors, which run the plain versions of K13
(single-level integer ME), K9 (DCT-IF refinement), K14 (forward and
loss), K15 (backward) and K16 (Adam).  None of these runs hmtpu's
`full_pframe_pass`.

Tolerances, each argued where it is used:
  - extraction records are integers: equal;
  - loss, accuracy and gradients: hmtpu's XLA dots and batch sums run in
    another order than the port's ascending loops, so they agree to
    float32 rounding (1e-6 relative on the loss, 1e-5 of each field's
    largest gradient);
  - Adam's update: the same float32 operations in the same order, but
    XLA's pow for the bias correction differs from numpy's float32 power
    by an ulp now and then: within 1 ulp;
  - a trajectory of 20 steps compounds those roundings (see the test);
  - `train`'s validation accuracy: within 0.01.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hmtpu.io.yuv import Frame as JFrame
from hmtpu.models import dataset as j_dataset
from hmtpu.models import nnfme as j_nnfme
from hmtpu.models import train as j_train
from hmtpu_torch.convert import adam_state_from_numpy, nnfme_params_from_numpy
from hmtpu_torch.io.yuv import Frame as PFrame
from hmtpu_torch.models import dataset as p_dataset
from hmtpu_torch.models import nnfme as p_nnfme
from hmtpu_torch.models import train as p_train
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)
from tools.gen_test_yuv import synth_clip


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path works on small tensors: one thread is as fast,
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(w, h, n):
    return [tuple(p.astype(np.int32) for p in f) for f in synth_clip(w, h, n)]


def _to_port(jp):
    return nnfme_params_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")


def _fields(packed):
    return p_nnfme.params_from_packed(torch.as_tensor(packed))


@pytest.mark.parametrize("w,h", [(64, 64), (64, 56)])
@pytest.mark.parametrize("qp", [22, 37])
def test_extract_frame_records_matches_hmtpu(w, h, qp):
    """K13's and K9's plain versions behind the port's extraction give
    hmtpu's records exactly (64x56: a side that is not a multiple of
    16, where the 32x32 regions of the last row are half outside)."""
    planes = _planes(w, h, 2)
    got = p_dataset.extract_frame_records(PFrame(*planes[1]),
                                          PFrame(*planes[0]), qp, 8,
                                          device="cpu")
    want = j_dataset.extract_frame_records(JFrame(*planes[1]),
                                           JFrame(*planes[0]), qp, 8)
    assert got[0].shape == ((w // 8) * (h // 8), 9)
    for g, wnt in zip(got, want):
        assert g.dtype == wnt.dtype
        np.testing.assert_array_equal(g, wnt)


def _batch():
    """256 rows: the records of a 64x64 and a 64x56 frame pair (8x8
    blocks), seeded costs at sizes 16 and 32, and one row (last) whose
    features are all exactly 0 under `_params` (size 4, costs equal to
    the mean), so every first-layer pre-activation is exactly 0."""
    recs = [p_dataset.extract_frame_records(
        PFrame(*pl[1]), PFrame(*pl[0]), 22, 8, device="cpu")
        for pl in (_planes(64, 64, 2), _planes(64, 56, 2))]
    c9 = np.concatenate([r[0] for r in recs])
    sz = np.concatenate([r[1] for r in recs])
    lab = np.concatenate([r[3] for r in recs])
    rng = np.random.RandomState(5)
    k = 255 - len(lab)
    c9 = np.concatenate([c9, rng.randint(0, 20000, (k, 9))]).astype(np.float32)
    hs = np.concatenate([sz, rng.choice([16, 32], k)]).astype(np.int32)
    ws = np.concatenate([sz, rng.choice([16, 32], k)]).astype(np.int32)
    lab = np.concatenate([lab, rng.randint(0, 49, k)]).astype(np.int32)
    mean, std = j_train.standardize_fit(c9)
    c9 = np.concatenate([c9, mean[None].astype(np.float32)])
    hs, ws = np.append(hs, 4).astype(np.int32), np.append(ws, 4)
    return (c9, hs, ws.astype(np.int32), np.append(lab, 24).astype(np.int32),
            mean, std)


def _params(mean, std):
    """hmtpu's init from seed 1 with fitted mean/std, the size-4
    embedding rows zeroed (the exact-zero row of `_batch`)."""
    jp = j_nnfme.init_random(jax.random.PRNGKey(1))
    return jp._replace(mean=jnp.asarray(mean, jnp.float32),
                       std=jnp.asarray(std, jnp.float32),
                       emb_h=jp.emb_h.at[1].set(0.0),
                       emb_w=jp.emb_w.at[1].set(0.0))


def _port_loss_grad(pp, c9, hs, ws, lab):
    packed = pp.packed.clone().requires_grad_(True)
    out = p_train.NnFmeLoss.apply(packed, *(torch.as_tensor(a) for a in
                                            (c9, hs, ws, lab)))
    g, = torch.autograd.grad(out, packed,
                             grad_outputs=torch.tensor([1.0, 0.0]))
    return out.detach().numpy(), _fields(g)


def test_loss_and_gradients_match_jax():
    """loss_fn's value and accuracy, and the gradient of all 15 fields
    (mean, std and gin included), against jax.value_and_grad, on the
    whole batch and on the exact-zero row alone, where the whole
    gradient below the first layer passes JAX's 0.5 of maximum(x, 0)
    at x == 0 (torch's relu would pass 0)."""
    c9, hs, ws, lab, mean, std = _batch()
    jp = _params(mean, std)
    pp = _to_port(jp)
    z1 = p_nnfme.forward_parts(pp, *(torch.as_tensor(a) for a in
                                     (c9[-1:], hs[-1:], ws[-1:])))["z1"]
    assert bool((z1 == 0).all()), "the last row must hit z1 == 0 exactly"
    for rows in (slice(None), slice(-1, None)):
        args = (c9[rows], hs[rows], ws[rows], lab[rows])
        (jl, ja), jg = jax.value_and_grad(j_train.loss_fn, has_aux=True)(
            jp, *(jnp.asarray(a) for a in args))
        out, pg = _port_loss_grad(pp, *args)
        # the loss: 49 exps and a batch mean summed in another order
        np.testing.assert_allclose(out[0], float(jl), rtol=1e-6)
        assert out[1] == float(ja)
        pl, pa = p_train.loss_fn(pp, *(torch.as_tensor(a) for a in args))
        assert float(pl) == out[0] and float(pa) == out[1]
        for k in p_nnfme.PACK_ORDER:
            a, b = np.asarray(getattr(jg, k)), getattr(pg, k).numpy()
            scale = float(np.abs(a).max())
            # the lone zero row's features are 0 (no w1, std or gin
            # gradient), but b1 and mean see the 0.5
            must = ("b1", "mean") if rows.start == -1 \
                else set(p_nnfme.PACK_ORDER) - {"emb_h", "emb_w"}
            assert scale > 0 or k not in must, k
            # float32 sums of up to 256 rows in another order: observed
            # under 5e-7 of the field's largest entry, bound 20 times that
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * scale,
                                       err_msg=k)


@pytest.mark.parametrize("form", ["update", "fused"])
@pytest.mark.parametrize("start", [0, 57])
def test_adam_updates_match_optax(start, form):
    """One and three Adam updates from the same gradients and state:
    optax's (the state carried across by convert.adam_state_from_numpy;
    `start` updates already made, with seeded moments) against K16's
    plain version, parameters and both moments within 1 ulp: `update`
    the update alone (`adam_update_plain`) on seeded gradients, `fused`
    the plain version of K15 with K16 as its tail (`loss_bwd_adam_plain`)
    on a seeded batch of 32 records, optax given the gradient it
    returns; its device count follows the host's."""
    rng = np.random.RandomState(start + 3)
    jp = j_nnfme.init_random(jax.random.PRNGKey(2))
    opt = optax.adam(3e-3)
    st = opt.init(jp)
    if start:
        mom = lambda s: jax.tree.map(
            lambda a: jnp.asarray(rng.randn(*a.shape) * s, jnp.float32), jp)
        st = (st[0]._replace(count=jnp.int32(start), mu=mom(1e-3),
                             nu=jax.tree.map(jnp.abs, mom(1e-5))),) + st[1:]
    pp = _to_port(jp)
    pstate = adam_state_from_numpy(st, "cpu", steps=3)
    assert pstate.count == start and int(pstate.dcount[0]) == start
    p, mu, nu = pp.packed.clone(), pstate.mu.clone(), pstate.nu.clone()
    pstate = pstate._replace(mu=mu, nu=nu)
    t = torch.as_tensor
    batch = [t(a) for a in (
        (rng.randint(200, 6000, (32, 1)) + rng.randint(0, 900, (32, 9)))
        .astype(np.float32), rng.choice([8, 16, 32], 32).astype(np.int32),
        rng.choice([8, 16, 32], 32).astype(np.int32),
        rng.randint(0, 49, 32).astype(np.int32))]
    for i in range(3):
        if form == "update":
            g = jax.tree.map(lambda a: jnp.asarray(
                rng.randn(*a.shape) * 10.0 ** rng.randint(-6, -1),
                jnp.float32), jp)
            p_train.adam_update_plain(p, _to_port(g).packed, mu, nu,
                                      start + i + 1, 3e-3)
        else:
            _, saved = p_train.loss_fwd_plain(p, *batch)
            pg = p_train.loss_bwd_adam_plain(p, *batch[:3], *saved,
                                             torch.ones(1), pstate, 3e-3)
            pstate = pstate._replace(count=pstate.count + 1)
            assert int(pstate.dcount[0]) == pstate.count == start + i + 1
            g = j_nnfme.NnFmeParams(**{k: jnp.asarray(getattr(
                _fields(pg), k).numpy()) for k in p_nnfme.PACK_ORDER})
        up, st = opt.update(g, st, jp)
        jp = optax.apply_updates(jp, up)
        if i in (0, 2):
            for k in p_nnfme.PACK_ORDER:
                for port, ref in ((_fields(p), jp), (_fields(mu), st[0].mu),
                                  (_fields(nu), st[0].nu)):
                    np.testing.assert_array_max_ulp(
                        getattr(port, k).numpy(),
                        np.asarray(getattr(ref, k)), maxulp=1)


def _records(w, h, n, qp):
    planes = _planes(w, h, n)
    return p_dataset.extract_clip([PFrame(*p) for p in planes], qp, 8,
                                  device="cpu")


def test_train_steps_track_hmtpu():
    """20 train_steps from hmtpu's init_train_state (params and Adam
    state carried across) on the same batches of 128: the port's losses
    and final parameters track hmtpu's.  Each step's gradient differs
    from hmtpu's by float32 rounding (the test above) and the next steps
    start from parameters an ulp or two apart; observed: losses within
    2e-7 (relative), parameters within 2e-7 (absolute, fields of 0.06 to
    275).  Bounds: 1e-5 on the loss, 1e-5 of each field's largest value
    plus 1e-6 per parameter (an Adam step is lr = 3e-3: a step taken in
    the other direction would show)."""
    c9, hs, ws, lab = _records(64, 64, 6, 27)
    c9 = np.concatenate([c9, c9 + 7.0]).astype(np.float32)
    hs, ws, lab = (np.concatenate([a, a]) for a in (hs, ws, lab))
    mean, std = j_train.standardize_fit(c9)
    js = j_train.init_train_state(jax.random.PRNGKey(0))
    js = js._replace(params=js.params._replace(
        mean=jnp.asarray(mean, jnp.float32),
        std=jnp.asarray(std, jnp.float32)))
    ps = p_train.init_train_state(_to_port(js.params))
    ps = ps._replace(opt_state=adam_state_from_numpy(js.opt_state, "cpu",
                                                     steps=20))
    rng = np.random.RandomState(9)
    jl, pl = [], []
    for _ in range(20):
        b = rng.permutation(len(lab))[:128]
        js, loss, _ = j_train.train_step(js, *(jnp.asarray(a[b]) for a in
                                               (c9, hs, ws, lab)))
        ps, ploss, _ = p_train.train_step(ps, *(torch.as_tensor(a[b]) for a
                                                in (c9, hs, ws, lab)))
        jl.append(float(loss)), pl.append(float(ploss))
    assert ps.step == 20 and ps.opt_state.count == 20
    assert int(ps.opt_state.dcount[0]) == 20
    # the table holds the run's 20 updates: a 21st is an error
    with pytest.raises(ValueError, match="past the bias corrections"):
        p_train.train_step(ps, *(torch.as_tensor(a[:128]) for a in
                                 (c9, hs, ws, lab)))
    assert jl[-1] < jl[0]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    got = ps.model.params()
    for k in p_nnfme.PACK_ORDER:
        a = np.asarray(getattr(js.params, k))
        np.testing.assert_allclose(
            getattr(got, k).detach().numpy(), a, rtol=0,
            atol=1e-6 + 1e-5 * float(np.abs(a).max()), err_msg=k)


def test_train_matches_hmtpu():
    """`train` on 2048 records (128x128, 9 frames, QP 27) for 3 epochs,
    batch 1024 (a last partial batch each epoch), from hmtpu's init:
    the validation accuracy within 0.01 of hmtpu's, and the mean and std
    (fitted by hmtpu's numpy, then trained) moved from the fit as
    hmtpu's did."""
    c9, hs, ws, lab = _records(128, 128, 9, 27)
    assert len(lab) == 2048
    jparams, jacc = j_train.train(c9, hs, ws, lab, epochs=3, seed=0)
    init = _to_port(j_nnfme.init_random(jax.random.PRNGKey(0)))
    losses = []
    pparams, pacc = p_train.train(c9, hs, ws, lab, epochs=3, seed=0,
                                  device="cpu", init=init, losses=losses)
    assert len(losses) == 3 * 2
    assert abs(pacc - jacc) <= 0.01, (pacc, jacc)
    mean, std = j_train.standardize_fit(c9[np.random.RandomState(0)
                                           .permutation(2048)[409:]])
    assert mean.dtype == std.dtype == np.float32
    # the trained mean / std moved from the fitted values, by about lr
    for k, fit in (("mean", mean), ("std", std)):
        a = getattr(pparams, k).detach().numpy()
        assert 0 < np.abs(a - fit).max() < 0.1, k
        np.testing.assert_allclose(a, np.asarray(getattr(jparams, k)),
                                   rtol=1e-6)


def test_train_cli_writes_weights_both_packages_load(tmp_path):
    """`python -m hmtpu_torch.apps.train_nnfme --device cpu` on a 64x64
    clip of 3 frames at QP 27 for 2 epochs: qp27.npz loads in the port
    and in hmtpu (the same 15 fields), drives the port's NN-FME encoder,
    and SSE_27.csv equals hmtpu's write_sse_csv of hmtpu's own records
    (search range 16, the tool's default) byte for byte."""
    from hmtpu_torch.apps import train_nnfme

    out, csv = tmp_path / "w", tmp_path / "csv"
    assert train_nnfme.main(["--device", "cpu", "--size", "64x64",
                             "--frames", "3", "--qps", "27", "--epochs", "2",
                             "--out", str(out), "--csv-dir", str(csv)]) == 0
    path = str(out / "qp27.npz")
    mine = p_nnfme.load_npz(path, "cpu")
    theirs = j_nnfme.load_npz(path)
    for k in p_nnfme.PACK_ORDER:
        np.testing.assert_array_equal(getattr(mine, k).numpy(),
                                      np.asarray(getattr(theirs, k)))
    with np.load(path) as z:
        assert sorted(z.files) == sorted(j_nnfme.NnFmeParams._fields)
        assert all(z[k].dtype == np.float32 for k in z.files)

    planes = _planes(64, 64, 3)
    recs = j_dataset.extract_clip([JFrame(*p) for p in planes], 27, 16)
    j_dataset.write_sse_csv(str(tmp_path / "ref.csv"), *recs)
    assert (csv / "SSE_27.csv").read_bytes() == \
        (tmp_path / "ref.csv").read_bytes()
    back = p_dataset.read_sse_csv(str(csv / "SSE_27.csv"))
    for a, b in zip(back, recs):
        np.testing.assert_array_equal(a, b)

    from hmtpu_torch.encoder.top import Encoder, EncoderConfig
    enc = Encoder(EncoderConfig(width=64, height=64, qp=27, gop="ldp",
                                subpel="nn", nn_weights_dir=str(out)),
                  device="cpu")
    assert all(bool((a == b).all()) for a, b in zip(enc.nn_params, mine))
