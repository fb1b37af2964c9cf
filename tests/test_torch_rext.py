"""BASELINE config 5 (cfg/encoder_intra_high_throughput_rext.cfg: 10-bit
all-intra with transform skip, SDH and the High-Throughput-RExt profile,
tier and level) through the port's CLI against hmtpu's, the port on the
CPU, at tests/test_rext.py's geometry: 96x64, 3 frames of the repo's
synthetic clip << 2 as a 10-bit YUV file.  The two streams must be equal
byte for byte, the port's SPS must carry general_profile_idc 5 with the
constraint flags test_rext.py reads, and hmtpu's decoder must match every
picture hash of the port's stream.
"""
import os

import numpy as np
import pytest
import torch

from hmtpu.apps import encoder_app as j_app
from hmtpu.common.constants import NalUnitType
from hmtpu.decoder.core import Decoder
from hmtpu.io.bitstream import BitReader, strip_emulation_prevention
from hmtpu.io.nal import split_annexb
from hmtpu_torch.apps import encoder_app as p_app
from hmtpu_torch.encoder import iframe_dev as p_iframe_dev
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)
from tools.gen_test_yuv import synth_clip

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "cfg", "encoder_intra_high_throughput_rext.cfg")
W, H, FRAMES = 96, 64, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rext_args(tmp_path):
    """The cfg as shipped on the 10-bit clip (16-bit little-endian
    samples): the CLI arguments without -b."""
    yuv = tmp_path / "in10.yuv"
    with open(yuv, "wb") as f:
        for planes in synth_clip(W, H, FRAMES):
            for p in planes:
                f.write((np.asarray(p, np.uint16) << 2).astype("<u2")
                        .tobytes())
    return ["-c", CFG, "--InputBitDepth=10", "-f", str(FRAMES), "-wdt",
            str(W), "-hgt", str(H), "-i", str(yuv)]


def sps_ptl(stream):
    """(general_profile_idc, [max_12bit, max_10bit, max_8bit,
    max_422chroma, max_420chroma, max_monochrome, intra]) of the SPS."""
    for nal in split_annexb(stream):
        if NalUnitType((nal[0] >> 1) & 0x3F) == NalUnitType.SPS_NUT:
            br = BitReader(strip_emulation_prevention(nal[2:]))
            br.read(4), br.read(3), br.read(1)   # vps id, layers, nesting
            br.read(2), br.read(1)               # profile space, tier
            idc = br.read(5)
            br.read(32), br.read(4)              # compatibility, src flags
            return idc, [br.read(1) for _ in range(7)]
    pytest.fail("no SPS found")


def test_rext_cli_matches_hmtpu(tmp_path, monkeypatch):
    args = rext_args(tmp_path)
    seen = []
    inner = p_iframe_dev.iframe_full_pass

    def record(*a, **k):
        st = inner(*a, **k)
        seen.append((k["bd"], k["ts"], k["sdh"]))
        return st

    monkeypatch.setattr(p_iframe_dev, "iframe_full_pass", record)
    assert j_app.main(args + ["-b", str(tmp_path / "j.hevc")]) == 0
    assert p_app.main(args + ["-b", str(tmp_path / "p.hevc")],
                      device="cpu") == 0
    p_bs = (tmp_path / "p.hevc").read_bytes()
    assert p_bs == (tmp_path / "j.hevc").read_bytes()
    # every picture took the 10-bit I pass with transform skip and SDH
    assert seen == [(10, True, True)] * FRAMES

    # High-Throughput-RExt (idc 5): 12- and 10-bit allowed, 8-bit not,
    # 4:2:2 / 4:2:0 allowed, not monochrome, intra only
    assert sps_ptl(p_bs) == (5, [1, 1, 0, 1, 1, 0, 1])
    pics = Decoder().decode_annexb(p_bs)
    assert len(pics) == FRAMES
    assert all(p.hash_ok is True for p in pics)
