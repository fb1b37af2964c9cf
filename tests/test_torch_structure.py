"""hmtpu_torch's boundaries: it loads neither JAX nor hmtpu, it never
falls back to the CPU on its own (the encoder, the NN-FME trainer and
the weight loader), and options outside the all-intra, low-delay-P and
random-access slices (8 and 10 bits) say which ROADMAP.md item brings
them."""
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from hmtpu_torch.device import resolve
from hmtpu_torch.encoder.top import Encoder, EncoderConfig
from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)

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
import torch
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
          "hmtpu_torch.utils.analyze", "hmtpu_torch.encoder.pframe",
          "hmtpu_torch.search.wavefront", "hmtpu_torch.models.dataset",
          "hmtpu_torch.models.train", "hmtpu_torch.apps.train_nnfme",
          "hmtpu_torch.utils.gen_test_yuv"):
    assert n in names, n
# the random-access slice's functions and kernels
from hmtpu_torch import kernels
from hmtpu_torch.ops import interp
from hmtpu_torch.search import wavefront
for f in ("mc_luma_batch_refs_i", "mc_chroma_batch_refs_i", "bi_average_t",
          "bi_pred", "mc_batch_i_plain", "bi_pred_plain"):
    assert callable(getattr(interp, f)), f
for f in ("merge_candidates_dev_b", "amvp_candidates_dev_b"):
    assert callable(getattr(wavefront, f)), f
assert kernels.KERNELS["mc_dctif_i"][0] == "mc_dctif"
assert kernels.KERNELS["bi_pred"][0] == "bi_pred"
# the training slice's functions and kernels
from hmtpu_torch.models import dataset, train
from hmtpu_torch.search import me
for m, fs in ((dataset, ("extract_frame_records", "extract_clip",
                         "write_sse_csv", "read_sse_csv")),
              (train, ("loss_fn", "loss_fwd", "loss_fwd_plain", "loss_bwd",
                       "loss_bwd_plain", "loss_bwd_adam",
                       "loss_bwd_adam_plain", "adam_update_plain",
                       "train_step", "train", "standardize_fit")),
              (me, ("integer_me", "integer_me_plain"))):
    for f in fs:
        assert callable(getattr(m, f)), f
assert issubclass(train.NnFmeLoss, torch.autograd.Function)
assert kernels.KERNELS["me_sad1"][0] == "me_sad"
for k in ("nnfme_fwd", "nnfme_bwd"):
    assert kernels.KERNELS[k][0] == "nnfme_train", k
# K16 runs as K15's tail and K1's TS mode inside its level forms: no
# launch of their own
assert "adam" not in kernels.KERNELS and "transform_skip" not in kernels.KERNELS
# the z-scan derivations' kernels and their plain versions
from hmtpu_torch.encoder import pframe_dev
from hmtpu_torch.ops import ratebits
for m, fs in ((wavefront, ("merge_candidates_dev_plain",
                           "merge_candidates_dev_b_plain")),
              (pframe_dev, ("amvp_rd", "amvp_rd_plain")),
              (me, ("regularize_mv_field", "regularize_mv_field_plain")),
              (ratebits, ("intra_mode_mpm_bits_plain",
                          "intra_mode_mpm_bits_nxn",
                          "intra_mode_mpm_bits_nxn_plain")),
              (train, ("exp_f32", "log_f32"))):
    for f in fs:
        assert callable(getattr(m, f)), f
for k, src in (("merge_cands", "mvcand"), ("amvp_rd", "mvcand"),
               ("mv_regularize", "mv_regularize"), ("mpm_bits", "mode_bits")):
    assert kernels.KERNELS[k][0] == src, k
for src in kernels.SOURCES:
    assert os.path.exists(kernels.source_path(src)), src
# the NN-FME weights load from the port's own data files
from hmtpu_torch.encoder.top import Encoder, EncoderConfig
from hmtpu_torch.models import nnfme
for qp in (22, 27, 32, 37):
    p = Encoder._load_nn(EncoderConfig(qp=qp), "cpu")
    ref = nnfme.load_npz(f"{nnfme.WEIGHTS_DIR}/qp{qp}.npz", "cpu")
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


def test_no_card_raises_without_fallback(monkeypatch, tmp_path):
    from hmtpu_torch.apps import train_nnfme
    from hmtpu_torch.models import nnfme

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Encoder(EncoderConfig())
    # the trainer and the weight loader default to the card too
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_nnfme.main(["--size", "64x64", "--frames", "2", "--qps", "27",
                          "--epochs", "1", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nnfme.load_npz(os.path.join(nnfme.WEIGHTS_DIR, "qp22.npz"))
    assert not os.listdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Encoder(EncoderConfig(gop="ra", bit_depth=10, subpel="dctif"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve("cuda")
    assert resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve("meta")


@pytest.mark.parametrize("opt,item", [
    pytest.param(dict(bit_depth=12), "A15", id="opt0-A15"),
    pytest.param(dict(target_kbps=500.0), "A16", id="opt1-A16"),
    pytest.param(dict(wpp=True), "A16", id="opt2-A16"),
    pytest.param(dict(wavefront=False), "ROADMAP.md", id="opt3-ROADMAP.md"),
    pytest.param(dict(gop="ldp", subpel="nn", decision="jacobi"),
                 "never ported", id="opt5-never ported")])
def test_options_outside_the_slice_raise(opt, item):
    with pytest.raises(NotImplementedError, match=item):
        Encoder(EncoderConfig(**opt), device="cpu")


@pytest.mark.parametrize("opt", [
    dict(gop="ldp"), dict(gop="ldp", subpel="none", transform_skip=True),
    dict(gop="ai", transform_skip=True),
    pytest.param(dict(gop="ra", bit_depth=10), id="ra-main10"),
    pytest.param(dict(gop="ai", bit_depth=10), id="ai-main10")])
def test_slice_configs_construct(opt):
    """The LDP defaults (DCT-IF sub-pel), transform skip on the AI and LDP
    paths, and random access and Main10 are in the port: the encoder
    builds, the PPS signals TS (never in B slices) and the SPS the
    Main10 profile."""
    enc = Encoder(EncoderConfig(**opt), device="cpu")
    assert enc.pps.transform_skip_enabled == opt.get("transform_skip",
                                                     False)
    assert enc.cfg.subpel == opt.get("subpel", "dctif")
    main10 = opt.get("bit_depth", 8) == 10
    assert enc.sps.ptl.general_profile_idc == (2 if main10 else 1)
    assert (enc.sps.max_num_reorder_pics > 0) == (opt["gop"] == "ra")


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


@pytest.mark.parametrize("failed", [False, True])
def test_chip_smoke_stops_what_it_started(failed):
    """The check's worker pool (spawn) leaves nothing running: its
    workers, a job still running in one of them after a failed phase, and
    multiprocessing's resource tracker, which would outlive the check."""
    code = f"""
import concurrent.futures, multiprocessing, time
import chip_smoke
pool = concurrent.futures.ProcessPoolExecutor(
    2, mp_context=multiprocessing.get_context("spawn"))
assert pool.submit(abs, -3).result() == 3
from multiprocessing import resource_tracker
started = chip_smoke._descendants()
assert len(started) >= 2, started   # a worker and the tracker
assert resource_tracker._resource_tracker._pid in started, started
if {failed}:
    pool.submit(time.sleep, 120)
    time.sleep(0.5)
    pool.shutdown(wait=False, cancel_futures=True)
    chip_smoke.stop_children(tracker=False)
pool.shutdown()
del pool
chip_smoke.stop_children()
print("left", chip_smoke._descendants())
"""
    t0 = time.time()
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert "left []" in r.stdout, r.stdout
    assert "leaked" not in r.stderr, r.stderr
    assert time.time() - t0 < 100


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
