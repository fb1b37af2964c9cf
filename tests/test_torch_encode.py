"""The all-intra slice of hmtpu_torch against hmtpu: the same seeded
clip through `Encoder(gop="ai")` of both packages, the port on the CPU.
At 64x64 the I pass runs all three CU levels (8, 16, 32); at 80x48, as
at 416x240, the 8 and 16 levels only, with partial CTUs.

Each case is one test that checks, in order: the `iframe_full_pass`
state of the first picture (every array, dtype and value), the Annex-B
stream byte for byte, and hmtpu's own decoder on the port's stream with
every picture hash matching.  hmtpu's encoder runs in a child process
for each case (tests/hmtpu_xla.py).
"""
import numpy as np
import pytest
import torch

from hmtpu.decoder.core import Decoder
from hmtpu.encoder import iframe_dev as j_iframe_dev
from hmtpu_torch.convert import state_from_numpy, state_to_numpy
from hmtpu_torch.encoder import iframe_dev as p_iframe_dev
from hmtpu_torch.encoder.top import Encoder as PEncoder
from hmtpu_torch.encoder.top import EncoderConfig as PConfig
from hmtpu_torch.io.yuv import Frame as PFrame
from tests import hmtpu_xla
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


def clip(w, h, frames, seed):
    """The repo's synthetic clip with 4x4-grained texture on the left
    half, so that 8x8 CUs and NxN parts are chosen beside larger CUs."""
    rng = np.random.RandomState(seed)
    out = []
    for y, u, v in synth_clip(w, h, frames, seed=seed):
        tex = np.kron(rng.randint(-50, 51, (h // 4, w // 4)),
                      np.ones((4, 4), int))
        y = y.astype(int)
        y[:, : w // 2] += tex[:, : w // 2]
        out.append((np.clip(y, 0, 255).astype(np.uint8), u, v))
    return out


def _encode_port(frames, qp, opts):
    """Encode `frames` with the port; return (stream, first picture's
    pass state as numpy, results).  The state is read by wrapping
    iframe_full_pass, which the frame encoder looks up at call time."""
    seen = []
    inner = p_iframe_dev.iframe_full_pass

    def record(*a, **k):
        st = inner(*a, **k)
        seen.append(st)
        return st

    p_iframe_dev.iframe_full_pass = record
    try:
        enc = PEncoder(PConfig(**_cfg(frames, qp, opts)), device="cpu")
        bs = enc.encode_sequence([PFrame(*f, 8) for f in frames])
    finally:
        p_iframe_dev.iframe_full_pass = inner
    return bs, state_to_numpy(seen[0]), enc.results


def _cfg(frames, qp, opts):
    h, w = frames[0][0].shape
    return dict(width=w, height=h, qp=qp, gop="ai", subpel="none", **opts)


# 64x64 QP 37 also turns on the prefix SEI messages, HRD signalling and
# the RExt profile (host code only: the pass and its compile are the same)
@pytest.mark.parametrize("w,h,frames,qp,opts,sizes", [
    (64, 64, 2, 22, {}, {0, 2}),
    (64, 64, 2, 37, dict(sei_active_parameter_sets=True,
                         sei_recovery_point=True, sei_buffering_period=True,
                         profile="main-rext"), {0, 2}),
    (80, 48, 1, 27, {}, {0, 1})])
def test_ai_slice_matches_hmtpu(w, h, frames, qp, opts, sizes):
    clip_ = clip(w, h, frames, qp)
    j_bs, j_sts, _ = hmtpu_xla.encode(_cfg(clip_, qp, opts), clip_,
                                        record="iframe_dev.iframe_full_pass")
    j_st = j_sts[0]
    p_bs, p_st, p_res = _encode_port(clip_, qp, opts)

    # the pass state: 8x8 CUs with NxN parts and the larger CU sizes
    # (cusz 1: 16x16, 2: 32x32) occur, and every array agrees
    assert sizes <= set(j_st["cusz"].tolist()) and j_st["part"].any()
    assert set(p_st) == set(j_st)
    for k in sorted(j_st):
        assert p_st[k].dtype == j_st[k].dtype, k
        np.testing.assert_array_equal(p_st[k], j_st[k], err_msg=k)

    # the state crosses between the packages through convert.py, and
    # the port's unpacking gives hmtpu's decisions
    back = state_to_numpy(state_from_numpy(j_st, "cpu"))
    for k in j_st:
        np.testing.assert_array_equal(back[k], j_st[k])
    j_un = j_iframe_dev.unpack_iframe_state(j_st, w, h, 6)
    p_un = p_iframe_dev.unpack_iframe_state(back, w, h, 6)
    np.testing.assert_array_equal(p_un[0], j_un[0])
    np.testing.assert_array_equal(p_un[1], j_un[1])
    assert sorted(p_un[2]) == sorted(j_un[2])

    assert p_bs == j_bs
    pics = Decoder().decode_annexb(p_bs)
    assert len(pics) == frames
    assert all(p.hash_ok is True for p in pics)
    assert all(r.psnr_y > 30 for r in p_res)
