"""The low-delay-P slice of hmtpu_torch against hmtpu: the same clip
through `Encoder(gop="ldp")` of both packages, the port on the CPU
(every kernel's plain version), at the geometry and config of hmtpu's
own LDP tests, so that hmtpu's XLA compile of `full_pframe_pass` is the
one those tests make (and its persistent cache entry can serve it):

  - NN-FME and HM's DCT-IF sub-pel search (tests/test_inter_e2e.py
    `test_ldp_encode_decode_hash`: 64x64, 3 frames of `synth_clip`,
    QP 32, search range 8): frame 1's `full_pframe_pass` state (every
    array, dtype and value), the Annex-B stream byte for byte, and
    hmtpu's own decoder on the port's stream with every picture hash
    matching;
  - transform skip on the 4x4 chroma TBs (tests/test_transform_skip.py
    `test_ts_ldp_decode_and_flags_fire`: 96x64, QP 27, no sub-pel, 4
    frames of chroma screen content): the stream byte for byte, the
    hashes, and TS chosen by some TB;
  - a 64x56 picture (2 frames, NN-FME, QP 32, search range 8), whose
    height is not a multiple of 16: the P pass takes the single-level
    integer ME (K13's plain version here); the stream byte for byte and
    the hashes.  hmtpu compiles this geometry once.

hmtpu's encoder runs in a child process for each test
(tests/hmtpu_xla.py).
"""
import numpy as np
import pytest
import torch

from hmtpu.decoder.core import Decoder
from hmtpu_torch.convert import state_to_numpy
from hmtpu_torch.encoder import pframe_dev as p_pframe_dev
from hmtpu_torch.encoder.top import Encoder as PEncoder
from hmtpu_torch.encoder.top import EncoderConfig as PConfig
from hmtpu_torch.io.yuv import Frame as PFrame
from tests import hmtpu_xla
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)
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


def _encode_port(cfg, planes):
    """Encode `planes` with the port; return (stream, the P passes'
    states as numpy, results).  The states are read by wrapping
    full_pframe_pass, which the P-frame encoder looks up at call time."""
    seen = []
    inner = p_pframe_dev.full_pframe_pass

    def record(*a, **k):
        out = inner(*a, **k)
        seen.append(state_to_numpy(out[0]))
        return out

    p_pframe_dev.full_pframe_pass = record
    try:
        enc = PEncoder(PConfig(**cfg), device="cpu")
        bs = enc.encode_sequence([PFrame(*p) for p in planes])
    finally:
        p_pframe_dev.full_pframe_pass = inner
    return bs, seen, enc.results


@pytest.mark.parametrize("subpel", ["nn", "dctif"])
def test_ldp_nn_slice_matches_hmtpu(subpel):
    planes = [tuple(p.astype(np.int32) for p in f)
              for f in synth_clip(W, H, FRAMES)]
    cfg = dict(width=W, height=H, qp=QP, gop="ldp", subpel=subpel,
               search_range=8)
    j_bs, j_st, _ = hmtpu_xla.encode(
        cfg, planes, record="pframe_dev.full_pframe_pass")
    p_bs, p_st, p_res = _encode_port(cfg, planes)

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


def _screenish_chroma(w, h, n):
    """tests/test_transform_skip.py's chroma screen content (seed 11):
    coloured text-like strokes on a flat background, drifting so P
    frames carry chroma residual; planes as numpy (y, u, v)."""
    rng = np.random.RandomState(11)
    marks = [(rng.randint(0, w // 2 - 8), rng.randint(0, h // 2 - 4),
              rng.randint(3, 8)) for _ in range(40)]
    out = []
    for t in range(n):
        y = np.full((h, w), 90, np.uint8)
        u = np.full((h // 2, w // 2), 100, np.uint8)
        v = np.full((h // 2, w // 2), 150, np.uint8)
        for x0, y0, ln in marks:
            x = (x0 + t) % (w // 2 - 8)
            u[y0:y0 + 2, x:x + ln] = 230
            v[y0:y0 + 2, x:x + ln] = 40
            y[2 * y0:2 * y0 + 4, 2 * x:2 * x + 2 * ln] = 200
        out.append(tuple(p.astype(np.int32) for p in (y, u, v)))
    return out


def test_ldp_transform_skip_matches_hmtpu():
    planes = _screenish_chroma(96, 64, 4)
    cfg = dict(width=96, height=64, qp=27, gop="ldp", subpel="none",
               transform_skip=True)
    j_bs, _, _ = hmtpu_xla.encode(cfg, planes)
    p_pframe_dev.DBG_COUNTERS["ldp_ts_tbs"] = 0
    p_enc = PEncoder(PConfig(**cfg), device="cpu")
    assert p_enc.pps.transform_skip_enabled
    p_bs = p_enc.encode_sequence([PFrame(*p) for p in planes])
    assert p_pframe_dev.DBG_COUNTERS["ldp_ts_tbs"] > 0, \
        "no chroma TB chose transform skip on chroma screen content"
    assert p_bs == j_bs
    pics = Decoder().decode_annexb(p_bs)
    assert [p.poc for p in pics] == list(range(4))
    assert all(p.hash_ok is True for p in pics)


def test_ldp_single_level_me_matches_hmtpu():
    planes = [tuple(p.astype(np.int32) for p in f)
              for f in synth_clip(64, 56, 2)]
    cfg = dict(width=64, height=56, qp=QP, gop="ldp", subpel="nn",
               search_range=8)
    j_bs, _, _ = hmtpu_xla.encode(cfg, planes)
    p_enc = PEncoder(PConfig(**cfg), device="cpu")
    p_bs = p_enc.encode_sequence([PFrame(*p) for p in planes])
    assert [r.slice_type for r in p_enc.results] == ["I", "P"]
    assert p_bs == j_bs
    pics = Decoder().decode_annexb(p_bs)
    assert [p.poc for p in pics] == [0, 1]
    assert all(p.hash_ok is True for p in pics)
