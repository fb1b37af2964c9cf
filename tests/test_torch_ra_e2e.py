"""The random-access slice of hmtpu_torch and its Main10 glue against
hmtpu: the same clip through `Encoder` of both packages, the port on
the CPU (every kernel's plain version), at the geometry and config of
hmtpu's own tests, so that hmtpu's XLA compiles are the ones those
tests make (and the persistent compile cache can serve them):

  - RA at Main10 (tests/test_main10.py `test_main10_intree[ra]`: 96x96,
    9 frames, QP 30, DCT-IF, `_frames10`): the stream byte for byte,
    hmtpu's decoder on it (POCs 0-8, every hash matching), B slices with
    bi-predicted CUs;
  - all-intra at Main10 (`test_main10_intree[ai]`'s config, 2 frames):
    the stream byte for byte and the hashes;
  - RA at 8 bits (tests/test_bframes.py `test_ra_e2e_intree`: 96x96, 10
    frames, QP 30, DCT-IF), marked slow: tier-1 leaves it out.

One test per config: two RA configs compiled in one process trip
XLA:CPU's multi-compile abort (tests/test_bframes.py:79-83).
"""
import numpy as np
import pytest
import torch

from hmtpu.decoder.core import Decoder
from hmtpu.encoder.top import Encoder as JEncoder
from hmtpu.encoder.top import EncoderConfig as JConfig
from hmtpu.io.yuv import Frame as JFrame
from hmtpu_torch.encoder import pframe_dev as p_pframe_dev
from hmtpu_torch.encoder.top import Encoder as PEncoder
from hmtpu_torch.encoder.top import EncoderConfig as PConfig
from hmtpu_torch.io.yuv import Frame as PFrame
from tools.gen_test_yuv import synth_clip


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path works on small tensors: one thread is as fast,
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(w, h, n, seed, bd):
    """tests/test_main10.py `_frames10` (seed 21, << 2) at bd 10, and
    tests/test_bframes.py `_frames` (seed 13) at bd 8."""
    sh = bd - 8
    return [tuple(p.astype(np.int32) << sh for p in f)
            for f in synth_clip(w, h, n, seed=seed)]


def _both(cfg, planes, bd):
    j_enc = JEncoder(JConfig(**cfg))
    j_bs = j_enc.encode_sequence([JFrame(*p, bd) for p in planes])
    p_pframe_dev.DBG_COUNTERS["ra_bi_cus"] = 0
    p_enc = PEncoder(PConfig(**cfg), device="cpu")
    p_bs = p_enc.encode_sequence([PFrame(*p, bd) for p in planes])
    return j_bs, p_bs, j_enc, p_enc


def _check_ra(cfg, n, seed, bd):
    j_bs, p_bs, j_enc, p_enc = _both(cfg, _planes(96, 96, n, seed, bd), bd)
    assert p_bs == j_bs
    pics = Decoder().decode_annexb(p_bs)
    assert sorted(p.poc for p in pics) == list(range(n))
    assert all(p.hash_ok is True for p in pics)
    types = [r.slice_type for r in p_enc.results]
    assert types == [r.slice_type for r in j_enc.results]
    assert types[0] == "I" and types[1:] == ["B"] * (n - 1)
    assert p_pframe_dev.DBG_COUNTERS["ra_bi_cus"] > 0
    assert p_enc.sps.max_num_reorder_pics == 4


def test_ra_main10_matches_hmtpu():
    _check_ra(dict(width=96, height=96, qp=30, gop="ra", subpel="dctif",
                   bit_depth=10), 9, 21, 10)


def test_ai_main10_matches_hmtpu():
    cfg = dict(width=96, height=96, qp=30, gop="ai", subpel="dctif",
               bit_depth=10)
    j_bs, p_bs, _, p_enc = _both(cfg, _planes(96, 96, 2, 21, 10), 10)
    assert p_enc.sps.ptl.general_profile_idc == 2
    assert p_bs == j_bs
    pics = Decoder().decode_annexb(p_bs)
    assert len(pics) == 2 and all(p.hash_ok is True for p in pics)


@pytest.mark.slow
def test_ra_8bit_matches_hmtpu():
    _check_ra(dict(width=96, height=96, qp=30, gop="ra", subpel="dctif"),
              10, 13, 8)
