"""The low-delay-P slice of hmtpu_torch against hmtpu: the same clip
through `Encoder(gop="ldp", subpel="nn")` of both packages, the port on
the CPU (every kernel's plain version), at the geometry and config of
hmtpu's own LDP test (tests/test_inter_e2e.py: 64x64, 3 frames of
`synth_clip`, QP 32, search range 8), so that hmtpu's XLA compile of
`full_pframe_pass` is the one that test makes (and its persistent
cache entry can serve it).

One test checks, in order: frame 1's `full_pframe_pass` state (every
array, dtype and value), the Annex-B stream byte for byte, and hmtpu's
own decoder on the port's stream with every picture hash matching.
"""
import numpy as np
import pytest
import torch

from hmtpu.decoder.core import Decoder
from hmtpu.encoder import pframe_dev as j_pframe_dev
from hmtpu.encoder.top import Encoder as JEncoder
from hmtpu.encoder.top import EncoderConfig as JConfig
from hmtpu.io.yuv import Frame as JFrame
from hmtpu_torch.convert import state_to_numpy
from hmtpu_torch.encoder import pframe_dev as p_pframe_dev
from hmtpu_torch.encoder.top import Encoder as PEncoder
from hmtpu_torch.encoder.top import EncoderConfig as PConfig
from hmtpu_torch.io.yuv import Frame as PFrame
from tools.gen_test_yuv import synth_clip

W, H, FRAMES, QP = 64, 64, 3, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path works on small tensors: one thread is as fast,
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _encode(mod, encoder, config, frame_t, to_numpy, **kw):
    """Encode the clip; return (stream, the P passes' states as numpy,
    results).  The states are read by wrapping the module's
    full_pframe_pass, which the P-frame encoder looks up at call time."""
    seen = []
    inner = mod.full_pframe_pass

    def record(*a, **k):
        out = inner(*a, **k)
        seen.append(to_numpy(out[0]))
        return out

    mod.full_pframe_pass = record
    try:
        frames = [frame_t(y.astype(np.int32), u.astype(np.int32),
                          v.astype(np.int32))
                  for y, u, v in synth_clip(W, H, FRAMES)]
        enc = encoder(config(width=W, height=H, qp=QP, gop="ldp",
                             subpel="nn", search_range=8), **kw)
        bs = enc.encode_sequence(frames)
    finally:
        mod.full_pframe_pass = inner
    return bs, seen, enc.results


def test_ldp_nn_slice_matches_hmtpu():
    j_bs, j_st, _ = _encode(j_pframe_dev, JEncoder, JConfig, JFrame,
                            lambda st: {k: np.asarray(v)
                                        for k, v in st.items()})
    p_bs, p_st, p_res = _encode(p_pframe_dev, PEncoder, PConfig, PFrame,
                                state_to_numpy, device="cpu")

    # frame 1's pass state: every array, dtype and value
    assert len(p_st) == len(j_st) == FRAMES - 1
    j1, p1 = j_st[0], p_st[0]
    assert set(p1) == set(j1)
    for k in sorted(j1):
        assert p1[k].dtype == j1[k].dtype, k
        np.testing.assert_array_equal(p1[k], j1[k], err_msg=k)

    assert p_bs == j_bs
    pics = Decoder().decode_annexb(p_bs)
    assert [p.poc for p in pics] == list(range(FRAMES))
    assert all(p.hash_ok is True for p in pics)
    assert [r.slice_type for r in p_res] == ["I", "P", "P"]
    assert all(r.psnr_y > 25 for r in p_res)
    # the P pictures predict from their references: far fewer bits
    assert all(r.bits < p_res[0].bits // 2 for r in p_res[1:])
