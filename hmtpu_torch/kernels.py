"""Build and bind the hand-written CUDA kernels in `csrc/`.

Each source is compiled by nvcc for `sm_90a` into a shared library with
a plain C interface and loaded with ctypes.  Libraries go to the
package's `build/` directory under a name that carries the source hash,
so a changed source (or a changed shared header, `csrc/*.cuh`) rebuilds
and concurrent builders never clash (each writes a private temp file and
renames it into place).

Every exported C function launches its kernel on the stream it is given
and returns the `cudaGetLastError()` code of that launch; `launch`
raises when it is not 0.  Nothing here runs when a module is imported:
the build happens at the first launch, or in `build_all`, which starts
one nvcc per source, all at once.

`COUNTS` holds one launch counter per kernel; each wrapper adds one
where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
# -Xptxas -v: the build log lists each kernel's registers and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# source -> {C function: argument kinds}; "p" pointer (or stream),
# "i" int, "f" float.  The stream is always the last argument.
SOURCES = {
    "transform": {
        "hm_int_transform_fwd": "pppiiiip",
        "hm_int_transform_inv": "pppiiiip",
        "hm_transform_skip": "ppiiiip",
    },
    "intra_pred": {
        "hm_intra_filter": "ppiiiip",
        "hm_intra_pred": "ppppiiiiip",
    },
    "deblock": {
        "hm_deblock_edges": "ppppppppp" "iiiiiiiii" "p",
    },
    "sao": {
        "hm_sao_stats": "pppiiiip",
        "hm_sao_apply": "pppiiiip",
    },
    "me_sad": {
        "hm_me_sad_levels": "pppppiiifp",
    },
    "nnfme": {
        "hm_nnfme": "pppppppip",
    },
    "mc_dctif": {
        "hm_mc_dctif": "ppppppp" "iiiiiiii" "p",
        "hm_mc_dctif_i": "ppppppp" "iiiiiiii" "p",
    },
    "bi_pred": {
        "hm_bi_pred": "pppp" "iii" "p",
    },
    "satd": {
        "hm_satd8": "pppiip",
    },
    "frac_refine": {
        "hm_frac_refine": "ppppppppp" "iiiiii" "p",
    },
    "rdoq": {
        "hm_rdoq": "ppppppppp" "iiiiiiiiiiiii" "ff" "p",
    },
}

# kernel name -> (source, file:line of the hmtpu function it replaces)
KERNELS = {
    "int_transform_fwd": ("transform", "hmtpu/ops/transform.py:38"),
    "int_transform_inv": ("transform", "hmtpu/ops/transform.py:58"),
    "transform_skip": ("transform", "hmtpu/ops/transform.py:84,89"),
    "intra_filter": ("intra_pred", "hmtpu/ops/intra_pred.py:230"),
    "intra_pred": ("intra_pred", "hmtpu/ops/intra_pred.py:69,149"),
    "deblock": ("deblock", "hmtpu/ops/deblock.py:471"),
    "sao_stats": ("sao", "hmtpu/ops/sao.py:282"),
    "sao_apply": ("sao", "hmtpu/ops/sao.py:358"),
    "me_sad": ("me_sad", "hmtpu/search/me.py:29,72,120"),
    "nnfme": ("nnfme", "hmtpu/models/nnfme.py:127,143"),
    "mc_dctif": ("mc_dctif", "hmtpu/ops/interp.py:173"),
    "mc_dctif_i": ("mc_dctif", "hmtpu/ops/interp.py:227"),
    "bi_pred": ("bi_pred", "hmtpu/ops/interp.py:295,"
                           "hmtpu/encoder/pframe_dev.py:292,440"),
    "satd8": ("satd", "hmtpu/search/me.py:159"),
    "frac_refine": ("frac_refine", "hmtpu/search/me.py:249"),
    "rdoq": ("rdoq", "hmtpu/ops/rdoq.py:43,hmtpu/ops/ratebits.py:161,"
                     "hmtpu/ops/quant.py:78,91"),
}
COUNTS = dict.fromkeys(KERNELS, 0)

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def source_path(src: str) -> str:
    return os.path.join(CSRC, f"{src}.cu")


def _so_path(src: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [source_path(src)] + [os.path.join(CSRC, f)
                                      for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"hmtpu_torch_{src}_{tag}.so")


def _nvcc() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return cand


def _start_build(src: str):
    so = _so_path(src)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, so


def _finish_build(src: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, so = job
    out = proc.communicate()[0].decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}.cu:\n{out}")
    os.replace(tmp, so)
    return out


def build_all() -> dict[str, str]:
    """Compile every source that has no library yet, one nvcc each, all
    started together; returns nvcc's output per source."""
    jobs = {src: _start_build(src) for src in SOURCES}
    return {src: _finish_build(src, job) for src, job in jobs.items()}


def _lib(src: str) -> ctypes.CDLL:
    lib = _LIBS.get(src)
    if lib is not None:
        return lib
    _finish_build(src, _start_build(src))
    lib = ctypes.CDLL(_so_path(src))
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    for fn, sig in SOURCES[src].items():
        f = getattr(lib, fn)
        f.restype = ctypes.c_int
        f.argtypes = [kinds[c] for c in sig]
    _LIBS[src] = lib
    return lib


def launch(kernel: str, fn: str, *args) -> None:
    """Call `fn` of the kernel's library on the current stream, raise on
    a refused launch, and count it.  Tensor arguments must be int32 or
    float32, contiguous and on one CUDA device (the wrappers convert);
    they are passed as device pointers, None as a null pointer.  Python
    ints and floats go by value, as the function's signature says."""
    dev = None
    cargs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if a.dtype not in (torch.int32, torch.float32):
                raise TypeError(f"{kernel}: input has dtype {a.dtype}, "
                                f"expected torch.int32 or torch.float32")
            if not a.is_cuda or (dev is not None and a.device != dev):
                raise ValueError(f"{kernel}: inputs must lie on one CUDA "
                                 f"device, got {a.device}")
            if not a.is_contiguous():
                raise ValueError(f"{kernel}: inputs must be contiguous")
            dev = a.device
            a = a.data_ptr()
        cargs.append(a)
    src = KERNELS[kernel][0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(_lib(src), fn)(*cargs, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {err}")
    COUNTS[kernel] += 1
