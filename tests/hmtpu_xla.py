"""Keeping hmtpu's XLA:CPU programs from filling a test worker's mappings.

XLA:CPU maps the code of every program that it compiles, or loads from the
persistent compile cache, into the process: a few thousand mappings for
one whole-frame pass, kept while the program stays cached.  A test worker
that has run several whole-frame encodes reaches Linux's limit on the
mappings of one process (`vm.max_map_count`, 65530 by default), and the
next compile or cache load aborts the worker ("allocateMappedMemory failed
with error: Cannot allocate memory", or a segmentation fault inside
`get_executable_and_time`).  So the port's tests

  - run hmtpu's side of an end-to-end comparison in a spawned child that
    exits after the encode, and its mappings go with it (`encode`);
  - drop the programs that hmtpu holds in the worker before and after
    each of their modules (`release_programs`, an autouse fixture that a
    test module takes by importing it), so that the tests a worker runs
    after them start from an empty set.
"""
import gc
import multiprocessing
import sys
from concurrent.futures import ProcessPoolExecutor

import pytest


def encode(cfg, planes, bit_depth=8, record=None):
    """hmtpu's `Encoder(EncoderConfig(**cfg))` on `planes`, a list of
    numpy (y, u, v) planes, in a fresh process.  Returns (stream, states,
    slice types): `states` holds, as numpy dicts, the state of each call
    of the pass that `record` names as "module.function" of
    `hmtpu.encoder` (for example "pframe_dev.full_pframe_pass"); the
    frame encoder looks the pass up at call time, so wrapping the module's
    attribute sees every call."""
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        return pool.submit(_encode, cfg, planes, bit_depth, record).result()


def _encode(cfg, planes, bit_depth, record):
    import importlib

    import jax
    import numpy as np

    # the root conftest's setting, which a spawned child does not run
    jax.config.update("jax_platforms", "cpu")
    from hmtpu.encoder.top import Encoder, EncoderConfig
    from hmtpu.io.yuv import Frame

    seen = []
    if record:
        mod_name, fn_name = record.split(".")
        mod = importlib.import_module("hmtpu.encoder." + mod_name)
        inner = getattr(mod, fn_name)

        def wrapped(*a, **k):
            out = inner(*a, **k)
            st = out if isinstance(out, dict) else out[0]
            seen.append({n: np.asarray(v) for n, v in st.items()})
            return out

        setattr(mod, fn_name, wrapped)
    enc = Encoder(EncoderConfig(**cfg))
    bs = enc.encode_sequence([Frame(*p, bit_depth) for p in planes])
    return bs, seen, [r.slice_type for r in enc.results]


def drop_programs():
    """Drop every compiled program that the loaded hmtpu modules and JAX
    hold: JAX's caches, hmtpu's `lru_cache`s, and the dicts of compiled
    executables in hmtpu's closures (pframe_dev's compile-once wrappers).
    Each is rebuilt, or read from the persistent cache, on its next use."""
    if "jax" not in sys.modules:
        return
    import jax
    from jax.stages import Compiled

    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == "hmtpu" or name.startswith("hmtpu.")):
            continue
        for obj in list(vars(mod).values()):
            if hasattr(obj, "cache_clear"):
                obj.cache_clear()
            for cell in getattr(obj, "__closure__", None) or ():
                try:
                    held = cell.cell_contents
                except ValueError:
                    continue
                if (isinstance(held, dict) and held and all(
                        isinstance(v, Compiled) for v in held.values())):
                    held.clear()
    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True, scope="module")
def release_programs():
    drop_programs()
    yield
    drop_programs()
