"""The port's encoder CLI (hmtpu_torch/apps/encoder_app.py) against
hmtpu's (hmtpu/apps/encoder_app.py): the repo's HM cfg files as shipped,
the port on the CPU.

  - all-intra with transform skip (cfg/encoder_intra_main.cfg: QP
    overridden to 27, TransformSkip 1, SignHideFlag 0) on 2 frames of
    tests/test_transform_skip.py's screen content (96x64): the two
    streams byte for byte, the port's ReconFile equal to hmtpu's decoder
    output with every picture hash matching, and TS chosen by some TB;
  - the random-access Main10 cfg (cfg/encoder_randomaccess_main10.cfg,
    BASELINE config 4) resolves to the same EncoderConfig through both
    CLIs (no encode);
  - the options outside the port's slices raise NotImplementedError
    naming their ROADMAP.md item, through the CLI.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from hmtpu.apps import encoder_app as j_app
from hmtpu.decoder.core import Decoder
from hmtpu_torch.apps import encoder_app as p_app
from hmtpu_torch.encoder import iframe_dev as p_iframe_dev

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AI_CFG = os.path.join(ROOT, "cfg", "encoder_intra_main.cfg")
RA_CFG = os.path.join(ROOT, "cfg", "encoder_randomaccess_main10.cfg")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _screenish(w, h, n):
    """tests/test_transform_skip.py's screen content (seed 7): sharp
    text-like strokes where transform skip wins; planes (y, u, v)."""
    rng = np.random.RandomState(7)
    out = []
    for t in range(n):
        y = np.full((h, w), 40, np.uint8)
        for _ in range(30):
            x0, y0 = rng.randint(0, w - 8), rng.randint(0, h - 8)
            y[y0:y0 + 2, x0:x0 + rng.randint(3, 8)] = 220
        y = np.roll(y, t, axis=1)
        u = np.full((h // 2, w // 2), 110, np.uint8)
        v = np.full((h // 2, w // 2), 140, np.uint8)
        out.append((y, u, v))
    return out


def test_ai_transform_skip_cli_matches_hmtpu(tmp_path, monkeypatch):
    yuv = tmp_path / "in.yuv"
    yuv.write_bytes(b"".join(p.tobytes() for f in _screenish(96, 64, 2)
                             for p in f))
    args = ["-c", AI_CFG, "-q", "27", "-f", "2", "-wdt", "96", "-hgt",
            "64", "-i", str(yuv)]

    # the port's I-pass states, to see transform skip chosen
    tsf = []
    inner = p_iframe_dev.iframe_full_pass

    def record(*a, **k):
        st = inner(*a, **k)
        tsf.append(st["tsf"].numpy().copy())
        return st

    monkeypatch.setattr(p_iframe_dev, "iframe_full_pass", record)
    assert j_app.main(args + ["-b", str(tmp_path / "j.hevc")]) == 0
    assert p_app.main(args + ["-b", str(tmp_path / "p.hevc"), "-o",
                              str(tmp_path / "rec.yuv")],
                      device="cpu") == 0
    p_bs = (tmp_path / "p.hevc").read_bytes()
    assert p_bs == (tmp_path / "j.hevc").read_bytes()
    assert len(tsf) == 2 and any((t != 0).any() for t in tsf)

    # every all-intra picture is an IDR (POC 0): decode order
    pics = Decoder().decode_annexb(p_bs)
    assert len(pics) == 2
    assert all(p.hash_ok is True for p in pics)
    rec = np.frombuffer((tmp_path / "rec.yuv").read_bytes(), np.uint8)
    want = np.concatenate([np.asarray(pl).astype(np.uint8).reshape(-1)
                           for p in pics for pl in p.frame.planes()])
    np.testing.assert_array_equal(rec, want)


@pytest.mark.parametrize("extra,item", [
    pytest.param(["-c", AI_CFG, "--InternalBitDepth=12"], "A15",
                 id="extra1-A15"),
    pytest.param(["-c", AI_CFG, "--RateControl=1", "--TargetBitrate=200000"],
                 "A16", id="extra2-A16"),
    pytest.param(["-c", AI_CFG, "--WaveFrontSynchro=1"], "A16",
                 id="extra3-A16")])
def test_cli_options_outside_the_slice_raise(tmp_path, extra, item):
    args = extra + ["-i", str(tmp_path / "none.yuv"), "-b",
                    str(tmp_path / "out.hevc")]
    with pytest.raises(NotImplementedError, match=item):
        p_app.main(args, device="cpu")


def test_cli_device_flag():
    """--device comes off the front of the arguments; the HM options
    after it are parsed as hmtpu's CLI parses them."""
    assert p_app._split_device(["--device", "cpu", "-q", "22"], "cuda") \
        == (["-q", "22"], "cpu")
    assert p_app._split_device(["--device=cuda:0", "-q", "22"], "cpu") \
        == (["-q", "22"], "cuda:0")
    assert p_app._split_device(["-q", "22"], "cuda") == (["-q", "22"],
                                                        "cuda")


def test_ra_main10_cfg_resolves_as_hmtpu(tmp_path, monkeypatch):
    """Both CLIs on the RA Main10 cfg as shipped: each builds its
    EncoderConfig from the cfg's B Frame1-Frame8 rows, InternalBitDepth
    10 and Profile main10; the fields must agree.  The encoder is
    stopped where it is constructed, so nothing is encoded."""
    seen = {}

    class Built(Exception):
        pass

    def capture(name):
        def make(cfg, *a, **k):
            seen[name] = dataclasses.asdict(cfg)
            raise Built
        return make

    monkeypatch.setattr(j_app, "Encoder", capture("j"))
    monkeypatch.setattr(p_app, "Encoder", capture("p"))
    args = ["-c", RA_CFG, "-i", str(tmp_path / "in.yuv"), "-wdt", "416",
            "-hgt", "240", "-f", "9", "-b", str(tmp_path / "out.hevc")]
    for fn in (lambda: j_app.main(args),
               lambda: p_app.main(args, device="cpu")):
        with pytest.raises(Built):
            fn()
    assert seen["p"] == seen["j"]
    cfg = seen["p"]
    assert (cfg["gop"], cfg["bit_depth"], cfg["qp"], cfg["subpel"],
            cfg["search_range"], cfg["sao"]) == ("ra", 10, 32, "dctif", 64,
                                                 True)
