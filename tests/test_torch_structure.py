"""hmtpu_torch's boundaries: it loads neither JAX nor hmtpu, it never
falls back to the CPU on its own, and options outside the all-intra and
low-delay-P slices (DCT-IF or NN-FME sub-pel, transform skip) say which
ROADMAP.md item brings them."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

from hmtpu_torch.device import resolve
from hmtpu_torch.encoder.top import Encoder, EncoderConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code_or_args, cwd=ROOT, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    args = code_or_args if isinstance(code_or_args, list) \
        else ["-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_imports_neither_jax_nor_hmtpu():
    code = """
import importlib, os, pkgutil, sys
import hmtpu_torch
import hmtpu_torch.encoder.top
import chip_smoke
names = [m.name for m in pkgutil.walk_packages(hmtpu_torch.__path__,
                                               "hmtpu_torch.")]
for n in names:
    importlib.import_module(n)
for n in ("hmtpu_torch.search.me", "hmtpu_torch.models.nnfme",
          "hmtpu_torch.ops.interp", "hmtpu_torch.encoder.pframe_dev",
          "hmtpu_torch.common.motion", "hmtpu_torch.entropy.inter_syntax",
          "hmtpu_torch.apps.encoder_app", "hmtpu_torch.apps.options",
          "hmtpu_torch.utils.analyze"):
    assert n in names, n
# the NN-FME weights load from the port's own data files
from hmtpu_torch.encoder.top import Encoder, EncoderConfig
from hmtpu_torch.models import nnfme
for qp in (22, 27, 32, 37):
    p = Encoder._load_nn(EncoderConfig(qp=qp), "cpu")
    ref = nnfme.load_npz(f"{nnfme.WEIGHTS_DIR}/qp{qp}.npz")
    assert all(bool((a == b).all()) for a, b in zip(p, ref))
assert nnfme.WEIGHTS_DIR.startswith(os.path.dirname(hmtpu_torch.__file__))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "hmtpu" or m.startswith("hmtpu."))
print(len(names), bad)
assert not bad, bad
"""
    r = _python(code)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) >= 40


def test_no_card_raises_without_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Encoder(EncoderConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve("cuda")
    assert resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve("meta")


@pytest.mark.parametrize("opt,item", [
    (dict(bit_depth=10), "A15"), (dict(target_kbps=500.0), "A16"),
    (dict(wpp=True), "A16"), (dict(wavefront=False), "ROADMAP.md"),
    (dict(gop="ra"), "A17"),
    (dict(gop="ldp", subpel="nn", decision="jacobi"), "never ported")])
def test_options_outside_the_slice_raise(opt, item):
    with pytest.raises(NotImplementedError, match=item):
        Encoder(EncoderConfig(**opt), device="cpu")


@pytest.mark.parametrize("opt", [
    dict(gop="ldp"), dict(gop="ldp", subpel="none", transform_skip=True),
    dict(gop="ai", transform_skip=True)])
def test_slice_configs_construct(opt):
    """The LDP defaults (DCT-IF sub-pel) and transform skip on both
    paths are in the port: the encoder builds, and the PPS signals TS."""
    enc = Encoder(EncoderConfig(**opt), device="cpu")
    assert enc.pps.transform_skip_enabled == opt.get("transform_skip",
                                                     False)
    assert enc.cfg.subpel == opt.get("subpel", "dctif")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a card, and beside nothing of the repo, the check exits
    non-zero and prints no result line."""
    r = _python(["chip_smoke.py"], env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _python(["chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_kernel_launch_takes_only_int32_cuda_tensors():
    """The launcher checks its tensors before it builds or calls
    anything: only int32 or float32 tensors, contiguous and on one CUDA
    device, reach a kernel; a CPU tensor or another dtype never does."""
    from hmtpu_torch import kernels

    x = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.launch("sao_apply", "hm_sao_apply", x, x, x, 4, 4, 4, 8)
    f = torch.zeros((4, 9), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.launch("nnfme", "hm_nnfme", f, f, x, x, f, x, x, 4)
    with pytest.raises(TypeError, match="int32 or torch.float32"):
        kernels.launch("nnfme", "hm_nnfme", f.double(), f, x, x, f, x, x, 4)
    with pytest.raises(TypeError, match="int32 or torch.float32"):
        kernels.launch("satd8", "hm_satd8", x.long(), x, x, 1, 8)
    assert kernels.COUNTS["sao_apply"] == 0
    assert kernels.COUNTS["nnfme"] == kernels.COUNTS["satd8"] == 0
