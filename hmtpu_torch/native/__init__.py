"""Native (C++) runtime components.

The serial runtime tail (CABAC entropy coding) is C++ compiled on first
use with the system toolchain.  The .so is cached in the package's
build directory keyed by source hash, under a file-name prefix of its
own, so the repo carries only sources.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_LIB = None
_TRIED = False
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build")


def _source_path() -> str:
    return os.path.join(os.path.dirname(__file__), "entropy.cpp")


def _build() -> str:
    src = _source_path()
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"hmtpu_torch_entropy_{tag}.so")
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.check_call(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src,
             "-o", tmp])
        os.replace(tmp, so)
    return so


def get_entropy_lib():
    """Load (building if needed) the entropy engine; None if the
    toolchain is unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("HMTPU_NO_NATIVE"):
        return None
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, subprocess.SubprocessError):
        return None
    fn = lib.hmtpu_entropy_encode
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    fn.restype = ctypes.c_int64
    fn.argtypes = [u8p, u8p, u8p, u8p,            # state/lps/renorm tables
                   i32p, i32p, i32p, i32p,        # scan blob/index/off/4x4
                   u8p, i32p, ctypes.c_int64,     # ctx, cmds
                   i32p, u8p, ctypes.c_int64,     # levels, out
                   i32p]                          # substream bounds out
    fn2 = lib.hmtpu_encode_pslice
    fn2.restype = ctypes.c_int64
    fn2.argtypes = [u8p, u8p, u8p, u8p,           # state/lps/renorm tables
                    i32p, i32p, i32p, i32p,       # scan blob/index/off/4x4
                    u8p, u8p, ctypes.c_int64,     # ctx, out, cap
                    i32p, i32p,                   # geom, cu_off
                    i32p, i32p, i32p, i32p, i32p, i32p, i32p,  # decisions
                    i32p, i32p, i32p,             # levels y/cb/cr
                    i32p, i32p, i32p,             # 16x16-CU levels
                    i32p, i32p, i32p,             # 32x32-CU levels
                    i32p,                         # depth8
                    i32p,                         # sao (nullable)
                    i32p,                         # tsf (ts flags/cell)
                    i32p]                         # substream bounds out
    _LIB = lib
    return _LIB


def available() -> bool:
    return get_entropy_lib() is not None
