"""Build and bind the hand-written CUDA kernels in `csrc/`.

Each source is compiled by nvcc for `sm_90a` into a shared library with
a plain C interface and loaded with ctypes.  Libraries go to the
package's `build/` directory under a name that carries the source hash,
so a changed source (or a changed shared header, `csrc/*.cuh`) rebuilds
and concurrent builders never clash (each writes a private temp file and
renames it into place).

Every exported C function launches its kernel on the stream it is given
and returns the `cudaGetLastError()` code of that launch; `launch`
raises when it is not 0.  Python ints go by value (a host array's
address among them, for K21's, K23's and K26's argument arrays).  Nothing here
runs when a module is imported: the build happens at the first launch,
or in `build_all`, which starts one nvcc per source, all at once.

`COUNTS` holds one launch counter per kernel; each wrapper adds one
where it launches its kernel, and nowhere else.

`launch` is on every call's path, and at small shapes its host time is
the call's time: it looks each bound function up once (`_FNS`), reads
the current stream's handle with PyTorch's raw-stream call, checks each
tensor with the cheapest attribute reads (dtype, is_cuda, get_device,
is_contiguous), and calls through `ctypes.PyDLL`, which keeps the GIL
(a launch returns at once) instead of releasing and taking it again.
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
        # a level's planes: org, pred, coef, the TS planes' coefficients;
        # (blocks, luma n, chroma n, planes, bit depth | use_dst << 8 |
        # ts << 9)
        "hm_fwd_level": "ppppppppp" "ppp" "iiiii" "p",
        # deq, lev, pred, org, bits (three each), dw; rec, sse (three
        # each), cbf, dist, bitsum; a host array of the TS pair's
        # pointers (or null); as hm_fwd_level
        "hm_inv_level": "ppppppppppppppp" "p" "ppppppppp" "p" "iiiii" "p",
    },
    "intra_pred": {
        "hm_intra_filter": "ppiiiip",
        "hm_intra_pred": "ppppiiiiip",
    },
    # planes in and out; the 4x4 maps and masks, or the state's columns,
    # their stride and the POCs (a host array); (h, w, qp, bit depth,
    # beta and tC offsets, the chroma tCs)
    "deblock": {
        "hm_deblock_map": "pppppp" "ppppppp" "iiiiiiii" "p",
        "hm_deblock_state": "pppppp" "ppppppppp" "i" "p" "iiiiiiii" "p",
    },
    # one plane or a frame's three: the planes' pointers, then (planes,
    # h, w, ctu, chroma h, w, ctu, bit depth)
    "sao": {
        "hm_sao_stats": "ppppppp" "iiiiiiii" "p",
        "hm_sao_apply": "ppppppp" "iiiiiiii" "p",
    },
    "me_sad": {
        "hm_me_sad_levels": "ppppppiiiifp",
        "hm_me_sad1": "ppppppiiiifp",
    },
    # the weights, up to three levels' costs, per-row heights and widths
    # (or null), the outputs; (rows, pel size) of each level, the levels,
    # float32 costs
    "nnfme": {
        "hm_nnfme": "ppppppppp" "iiiiiiii" "p",
    },
    "mc_dctif": {
        "hm_mc_dctif": "ppppppp" "iiiiiiii" "p",
        "hm_mc_dctif_i": "ppppppp" "iiiiiiii" "p",
        # up to three forms of one grid's blocks: references and outputs,
        # ridx, the MV sets; (blocks, forms, R, grid width, bit depth,
        # inter), then each form's (H, W, n, chroma, MV set)
        "hm_mc_forms": "ppppppppp" "iiiiii" "iiiii" "iiiii" "iiiii" "p",
    },
    "bi_pred": {
        "hm_bi_pred": "pppp" "iii" "p",
    },
    "satd": {
        "hm_satd8": "pppiip",
        # the original plane; each level's two predictions, MV sets and
        # output; (h, w, levels), then each level's (n, grid width, blocks)
        "hm_satd_gate": "p" "ppppp" "ppppp" "ppppp" "iii" "iiiiiiiii" "p",
    },
    # the one-call form: refs, ridx, xs0, ys0, org, the MVs, out; (blocks,
    # R, H, W, n, bit depth).  The levels form: refs, the original plane,
    # each level's MVs, references and output; (R, H, W, plane h, w,
    # levels, bit depth), then each level's (n, grid width, blocks)
    "frac_refine": {
        "hm_frac_refine": "pppppppp" "iiiiii" "p",
        "hm_frac_levels": "pp" "pppp" "pppp" "pppp" "iiiiiii" "iiiiiiiii"
                          "p",
    },
    "rdoq": {
        "hm_rdoq": "ppppppppp" "iiiiiiiiiiiii" "ff" "p",
    },
    "nnfme_train": {
        "hm_nnfme_fwd": "pppppppppp" "if" "p",
        # with K16's tail: mu, nu, the step count, the bias corrections'
        # table and its rows, (b1, 1 - b1, b2, 1 - b2, eps, -lr)
        "hm_nnfme_bwd": "pppppppppp" "i" "pppp" "i" "ffffff" "p",
    },
    "mvcand": {
        "hm_merge_cands": "ppppp" "iiiiii" "p",
        "hm_amvp_rd": "pppppppppppp" "iiiiiiiiiiiiiiiiii" "p",
    },
    # refs, org, the field in, lam_sqrt, the field out, the scratch field;
    # (R, H, W, rounds)
    "mv_regularize": {
        "hm_mv_regularize": "pppppp" "pppppp" "iiii" "p",
    },
    "mode_bits": {
        "hm_mpm_bits": "ppppp" "iii" "p",
        "hm_mpm_bits4": "ppppp" "ii" "p",
    },
    # scratch, then host arrays of the walk's pointers, ints and floats,
    # each with its length
    "iwalk": {
        "hm_i_walk": "p" "pipipi" "i" "p",
    },
    "i_rmd": {
        "hm_i_rmd": "pppp" "iiiiii" "f" "p",
    },
    "pwalk": {
        "hm_p_walk": "p" "pipipi" "i" "p",
    },
    # the collocated field, the references, the POCs, the output; (n, gw,
    # gh, w, h, log2 CTU, POCs, R).  The grids form: the field, the POCs,
    # the output, each grid's references; (grids, each grid's (n, gw,
    # gh), w, h, log2 CTU, POCs, R)
    "tmvp": {
        "hm_tmvp_grid": "ppppppp" "iiiiiiiii" "p",
        "hm_tmvp_grids": "pppppp" "ppp" "i" "iiiiiiiii" "iiiiii" "p",
    },
    "sao_choose": {
        "hm_sao_choose": "ppppp" "ii" "p",
    },
    "bwalk": {
        "hm_b_walk": "p" "pipipi" "i" "p",
    },
}

# kernel name -> (source, file:line of the hmtpu function it replaces)
KERNELS = {
    "int_transform_fwd": ("transform", "hmtpu/ops/transform.py:38,"
                                       "hmtpu/encoder/pframe_dev.py:188"),
    "int_transform_inv": ("transform", "hmtpu/ops/transform.py:58,"
                                       "hmtpu/encoder/pframe_dev.py:188"),
    "intra_filter": ("intra_pred", "hmtpu/ops/intra_pred.py:230"),
    "intra_pred": ("intra_pred", "hmtpu/ops/intra_pred.py:69,149"),
    "deblock": ("deblock", "hmtpu/ops/deblock.py:471,"
                           "hmtpu/encoder/pframe_dev.py:1797-1832"),
    "sao_stats": ("sao", "hmtpu/ops/sao.py:282"),
    "sao_apply": ("sao", "hmtpu/ops/sao.py:358"),
    "me_sad": ("me_sad", "hmtpu/search/me.py:29,72,120"),
    "me_sad1": ("me_sad", "hmtpu/search/me.py:107,29,72"),
    "nnfme": ("nnfme", "hmtpu/models/nnfme.py:127,143"),
    "mc_dctif": ("mc_dctif", "hmtpu/ops/interp.py:173"),
    "mc_dctif_i": ("mc_dctif", "hmtpu/ops/interp.py:227"),
    "bi_pred": ("bi_pred", "hmtpu/ops/interp.py:295,"
                           "hmtpu/encoder/pframe_dev.py:292,440"),
    "satd8": ("satd", "hmtpu/search/me.py:159,"
                      "hmtpu/encoder/pframe_dev.py:1545-1560"),
    "frac_refine": ("frac_refine", "hmtpu/search/me.py:249,"
                                   "hmtpu/encoder/pframe_dev.py:1667-1745"),
    "rdoq": ("rdoq", "hmtpu/ops/rdoq.py:43,hmtpu/ops/ratebits.py:161,"
                     "hmtpu/ops/quant.py:78,91"),
    "nnfme_fwd": ("nnfme_train", "hmtpu/models/train.py:38-43,49"),
    # with K16 adam (hmtpu/models/train.py:51-53) as its tail
    "nnfme_bwd": ("nnfme_train", "hmtpu/models/train.py:49-53"),
    "merge_cands": ("mvcand", "hmtpu/search/wavefront.py:295,357"),
    "amvp_rd": ("mvcand", "hmtpu/encoder/pframe_dev.py:815-826,487-514,"
                          "hmtpu/search/wavefront.py:497,519,"
                          "hmtpu/ops/ratebits.py:439,399,429"),
    "mv_regularize": ("mv_regularize", "hmtpu/search/me.py:194"),
    "mpm_bits": ("mode_bits", "hmtpu/ops/ratebits.py:378,"
                              "hmtpu/encoder/iframe_dev.py:353-356"),
    "i_walk": ("iwalk", "hmtpu/encoder/iframe_dev.py:114,459,480,538,560,"
                        "614"),
    "i_rmd": ("i_rmd", "hmtpu/encoder/iframe_dev.py:102,135,94,"
                       "hmtpu/encoder/intra_rdo.py:78,"
                       "hmtpu/encoder/pframe_dev.py:364-369"),
    "p_walk": ("pwalk", "hmtpu/encoder/pframe_dev.py:255,519,682,1017,1293,"
                        "hmtpu/ops/ratebits.py:305-450"),
    "tmvp_grid": ("tmvp", "hmtpu/search/wavefront.py:634,624,"
                          "hmtpu/encoder/pframe_dev.py:381"),
    "sao_choose": ("sao_choose", "hmtpu/ops/sao.py:305,267"),
    "b_walk": ("bwalk", "hmtpu/encoder/pframe_dev.py:255,411,446,487,732,"
                        "807,879,919,971,987,1065,1121,1177,1241,1263,1338,"
                        "1394,1449,hmtpu/ops/ratebits.py:305-450"),
}
COUNTS = dict.fromkeys(KERNELS, 0)

_LIBS: dict[str, ctypes.PyDLL] = {}
_FNS: dict[str, ctypes._CFuncPtr] = {}
_I32, _F32 = torch.int32, torch.float32
# the current stream's cudaStream_t of a device index; PyTorch's own
# accessor, without the Stream object current_stream builds
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


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


def build_log_path(so: str) -> str:
    """Where nvcc's output (ptxas' registers, stack and spills) is kept
    beside library `so`."""
    return so[:-len(".so")] + ".log"


def _finish_build(src: str, job) -> str:
    if job is None:
        log = build_log_path(_so_path(src))
        if not os.path.exists(log):
            return ""
        with open(log) as f:
            return f.read()
    proc, tmp, so = job
    out = proc.communicate()[0].decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}.cu:\n{out}")
    with open(build_log_path(so), "w") as f:
        f.write(out)
    os.replace(tmp, so)
    return out


def build_all() -> dict[str, str]:
    """Compile every source that has no library yet, one nvcc each, all
    started together; returns nvcc's output per source (a library built
    before gives the output kept beside it)."""
    jobs = {src: _start_build(src) for src in SOURCES}
    return {src: _finish_build(src, job) for src, job in jobs.items()}


def _lib(src: str) -> ctypes.PyDLL:
    lib = _LIBS.get(src)
    if lib is not None:
        return lib
    _finish_build(src, _start_build(src))
    lib = ctypes.PyDLL(_so_path(src))
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    for fn, sig in SOURCES[src].items():
        f = getattr(lib, fn)
        f.restype = ctypes.c_int
        f.argtypes = [kinds[c] for c in sig]
    _LIBS[src] = lib
    return lib


def ready(t: torch.Tensor, dt=torch.int32) -> torch.Tensor:
    """t as a wrapper passes it to `launch_checked`: dtype dt, contiguous,
    its data 16-byte aligned (K1's level forms and K8 load rows 16 bytes
    at a time); a copy only where t is not so already."""
    if t.dtype is not dt or not t.is_contiguous():
        t = t.to(dt).contiguous()
    return t.clone() if t.data_ptr() & 15 else t


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
            dt = a.dtype
            if dt is not _I32 and dt is not _F32:
                raise TypeError(f"{kernel}: input has dtype {dt}, "
                                f"expected torch.int32 or torch.float32")
            d = a.get_device() if a.is_cuda else None
            if d is None or (dev is not None and d != dev):
                raise ValueError(f"{kernel}: inputs must lie on one CUDA "
                                 f"device, got {a.device}")
            if not a.is_contiguous():
                raise ValueError(f"{kernel}: inputs must be contiguous")
            dev = d
            a = a.data_ptr()
        cargs.append(a)
    launch_checked(kernel, fn, dev, *cargs)


def launch_checked(kernel: str, fn: str, dev: int, *cargs) -> None:
    """`launch`'s call, for a wrapper that has itself made its tensors
    int32 or float32, contiguous and on CUDA device `dev` and passes
    their data pointers (K1's level forms, whose call at the encoder's
    shapes is its host time)."""
    f = _FNS.get(fn) or _bind(kernel, fn)
    err = f(*cargs, _raw_stream(dev) if _raw_stream is not None
            else torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {err}")
    COUNTS[kernel] += 1


def _bind(kernel: str, fn: str):
    f = _FNS[fn] = getattr(_lib(KERNELS[kernel][0]), fn)
    return f
