"""Entropy backends for the encoders' slice-data serialisation.

The CU-tree walk records bins/TB-levels through one of two backends
with the same surface:

- PyBackend: the reference path — Python CabacEncoder + residual.py,
  bit-exact per tests.
- NativeBackend: records a decision stream (the TPU-first "decision
  tensor" of SURVEY §7) and replays it through the C++ engine in
  native/entropy.cpp in one call.  Byte-identical to PyBackend
  (tests/test_native_entropy.py).
"""
from __future__ import annotations

import numpy as np

from hmtpu_torch import native
from hmtpu_torch.common import spec_tables as st
from hmtpu_torch.common.scan import cg_scan_order, scan_order
from hmtpu_torch.entropy import cabac
from hmtpu_torch.entropy.contexts import CTX_IDX_MAP_4x4, OFF
from hmtpu_torch.entropy.residual import encode_residual
from hmtpu_torch.io.bitstream import BitWriter

(OP_BIN, OP_BIN_EP, OP_BINS_EP, OP_TRM, OP_RESIDUAL, OP_TERMINATE,
 OP_SAVE_CTX, OP_RESTORE_CTX, OP_END_SUBSTREAM) = range(9)


class PyBackend:
    """CabacEncoder-backed reference path."""

    def __init__(self, ctx: np.ndarray):
        self.ctx = ctx
        self.bw = BitWriter()
        self.enc = cabac.CabacEncoder(self.bw)
        self.boundaries: list[int] = []    # substream end byte offsets
        self._saved_ctx = None
        self._init_ctx = ctx.copy()

    def encode_bin(self, idx: int, v: int) -> None:
        self.enc.encode_bin(self.ctx, idx, v)

    def encode_bin_ep(self, v: int) -> None:
        self.enc.encode_bin_ep(v)

    def encode_bins_ep(self, v: int, n: int) -> None:
        self.enc.encode_bins_ep(v, n)

    def encode_bin_trm(self, v: int) -> None:
        self.enc.encode_bin_trm(v)

    def residual(self, lev: np.ndarray, log2: int, is_luma: bool,
                 scan_idx: int, sdh: bool) -> None:
        encode_residual(self.enc, self.ctx, lev, log2, is_luma,
                        scan_idx, sdh)

    def save_ctx(self) -> None:
        """WPP: store contexts after the row's 2nd CTU (9.3.2.2)."""
        self._saved_ctx = self.ctx.copy()

    def restore_ctx(self) -> None:
        """WPP row start: slice-init contexts, then sync from the
        stored state when the top-right CTU exists."""
        self.ctx[:] = self._saved_ctx if self._saved_ctx is not None \
            else self._init_ctx

    def end_substream(self) -> None:
        """End a WPP CTU-row substream: end_of_subset_one_bit(=trm 1)
        + flush + byte alignment, then restart the arithmetic engine
        (TEncSlice.cpp:1072-1083)."""
        self.enc.flush_terminate()
        self.boundaries.append(len(self.bw.get_bytes()))

    def finish(self) -> bytes:
        """encodeBinTrm(1) + flush + rbsp stop bit + alignment."""
        self.enc.encode_bin_trm(1)
        self.enc.finish()
        self.bw.write(1, 1)
        self.bw.align_zero()
        return self.bw.get_bytes()


# ---------------------------------------------------------------------------
# native backend

def _build_scan_blob():
    """Pack every (log2, scan) table the C engine may need."""
    blob: list[int] = []
    index = np.zeros(12, dtype=np.int32)
    for log2 in (2, 3, 4, 5):
        for si in (0, 1, 2):
            if log2 > 3 and si != 0:
                # hor/ver scans exist only for 4x4/8x8 TBs; alias diag
                index[(log2 - 2) * 3 + si] = index[(log2 - 2) * 3]
                continue
            index[(log2 - 2) * 3 + si] = len(blob)
            scans = scan_order(log2, si)
            cgo = cg_scan_order(log2, si)
            blob.append(scans.shape[0])
            blob.extend(int(x) for x in cgo)
            blob.extend(int(x) for x in scans.reshape(-1))
    return np.asarray(blob, dtype=np.int32), index


_TABLES = None


def _tables():
    global _TABLES
    if _TABLES is None:
        blob, index = _build_scan_blob()
        off = np.asarray([OFF["LAST_X"], OFF["LAST_Y"], OFF["LAST_X_C"],
                          OFF["LAST_Y_C"], OFF["SIG_CG_FLAG"],
                          OFF["SIG_FLAG"], OFF["ONE_FLAG"],
                          OFF["ABS_FLAG"]], dtype=np.int32)
        _TABLES = dict(
            next_mps=np.ascontiguousarray(cabac.NEXT_STATE_MPS),
            next_lps=np.ascontiguousarray(cabac.NEXT_STATE_LPS),
            lps=np.ascontiguousarray(
                st.RANGE_TAB_LPS.astype(np.uint8).reshape(-1)),
            renorm=np.ascontiguousarray(
                st.RENORM_TABLE.astype(np.uint8)),
            blob=blob, index=index, off=off,
            ctx4x4=np.ascontiguousarray(
                CTX_IDX_MAP_4x4.astype(np.int32)),
        )
    return _TABLES


class NativeBackend:
    """Decision-stream recorder + one-shot C++ replay."""

    def __init__(self, ctx: np.ndarray):
        self.ctx = ctx
        self.cmds: list[int] = []
        self.levels: list[np.ndarray] = []
        self.level_off = 0

    def encode_bin(self, idx: int, v: int) -> None:
        self.cmds += (OP_BIN, idx, v, 0)

    def encode_bin_ep(self, v: int) -> None:
        self.cmds += (OP_BIN_EP, v, 0, 0)

    def encode_bins_ep(self, v: int, n: int) -> None:
        self.cmds += (OP_BINS_EP, v, n, 0)

    def encode_bin_trm(self, v: int) -> None:
        self.cmds += (OP_TRM, v, 0, 0)

    def save_ctx(self) -> None:
        self.cmds += (OP_SAVE_CTX, len(self.ctx), 0, 0)

    def restore_ctx(self) -> None:
        self.cmds += (OP_RESTORE_CTX, len(self.ctx), 0, 0)

    def end_substream(self) -> None:
        self.cmds += (OP_END_SUBSTREAM, 0, 0, 0)
        self._n_sub = getattr(self, "_n_sub", 0) + 1

    def residual(self, lev: np.ndarray, log2: int, is_luma: bool,
                 scan_idx: int, sdh: bool) -> None:
        flat = np.ascontiguousarray(lev.reshape(-1), dtype=np.int32)
        a = log2 | (scan_idx << 4) | (int(is_luma) << 8) | (int(sdh) << 9)
        self.cmds += (OP_RESIDUAL, a, self.level_off, 0)
        self.levels.append(flat)
        self.level_off += flat.size

    def finish(self) -> bytes:
        import ctypes

        lib = native.get_entropy_lib()
        t = _tables()
        self.cmds += (OP_TERMINATE, 0, 0, 0)
        cmds = np.asarray(self.cmds, dtype=np.int32)
        levels = (np.concatenate(self.levels) if self.levels
                  else np.zeros(1, dtype=np.int32))
        # worst case ~2 bytes per recorded bin + levels; generous cap
        cap = 1024 + 2 * (len(cmds) // 4) + 8 * levels.size
        out = np.zeros(cap, dtype=np.uint8)
        ctx = np.ascontiguousarray(self.ctx)
        bounds = np.zeros(2 + getattr(self, "_n_sub", 0),
                          dtype=np.int32)

        u8 = ctypes.POINTER(ctypes.c_uint8)
        i32 = ctypes.POINTER(ctypes.c_int32)

        def p8(a):
            return a.ctypes.data_as(u8)

        def p32(a):
            return a.ctypes.data_as(i32)

        n = lib.hmtpu_entropy_encode(
            p8(t["next_mps"]), p8(t["next_lps"]), p8(t["lps"]),
            p8(t["renorm"]), p32(t["blob"]), p32(t["index"]),
            p32(t["off"]), p32(t["ctx4x4"]), p8(ctx), p32(cmds),
            len(cmds) // 4, p32(levels), p8(out), cap, p32(bounds))
        if n < 0:
            raise RuntimeError(f"native entropy engine failed ({n})")
        self.boundaries = [int(x) for x in bounds[1:1 + bounds[0]]]
        self.ctx[:] = ctx        # adapted states back to the caller
        return out[:n].tobytes()


def entry_point_sizes(rbsp: bytes, boundaries: list[int]) -> list[int]:
    """entry_point_offset values (7.4.7.1) from substream boundary
    byte offsets within the slice-data RBSP: span size plus the
    emulation-prevention bytes the NAL writer will insert inside the
    span (TEncSlice.cpp:1087 substreamSize + countStartCodeEmulations;
    per-span counting is exact because substreams end in a nonzero
    stop-bit byte)."""
    from hmtpu_torch.io.bitstream import count_emulations
    offs = []
    prev = 0
    for b in boundaries:
        span = rbsp[prev:b]
        offs.append(len(span) + count_emulations(span))
        prev = b
    return offs


def make_backend(ctx: np.ndarray):
    """Prefer the native engine; fall back to the Python reference.
    The symbol trace (utils/trace.py) forces the Python backend — the
    native bin engine does not speak the trace."""
    from hmtpu_torch.entropy import cabac as _cabac
    if native.available() and _cabac.TRACE is None:
        return NativeBackend(ctx)
    return PyBackend(ctx)


# CU-syntax context offsets in the order native/entropy.cpp expects
_CU_OFF_KEYS = ("SAO_MERGE_FLAG", "SAO_TYPE_IDX", "SPLIT_FLAG",
                "SKIP_FLAG", "PRED_MODE", "PART_SIZE", "INTRA_PRED_MODE",
                "CHROMA_PRED_MODE", "QT_CBF_LUMA", "QT_CBF_CHROMA",
                "QT_ROOT_CBF", "MERGE_FLAG", "MERGE_IDX", "MVD",
                "REF_PIC", "MVP_IDX", "INTER_DIR", "TRANSFORMSKIP_FLAG")


def pack_sao_grid(grid, n_ctu_x: int, n_ctu_y: int) -> np.ndarray:
    """Per-CTU SAO params -> (nCtu, 21) int32 [3 x (type, eo_class,
    band_pos, off0..3)] for the native slice writer."""
    out = np.zeros((n_ctu_y * n_ctu_x, 21), dtype=np.int32)
    for cy in range(n_ctu_y):
        for cx in range(n_ctu_x):
            row = out[cy * n_ctu_x + cx]
            for c, p in enumerate(grid[cy][cx]):
                row[c * 7 + 0] = p.type_idx
                row[c * 7 + 1] = p.eo_class
                row[c * 7 + 2] = p.band_pos
                row[c * 7 + 3:c * 7 + 7] = p.offsets
    return out


def encode_pslice_native(ctx: np.ndarray, geom: dict,
                         kind, mi, mvdx, mvdy, mvpi, refi, imode,
                         levy, levcb, levcr, lev16y, lev16cb, lev16cr,
                         lev32y, lev32cb, lev32cr,
                         depth8, sao_packed, tsf=None):
    """One-call native slice-data serialisation from decision tensors.
    Returns (rbsp, substream boundary byte offsets) — boundaries empty
    unless geom["wpp"]; None when the native engine is unavailable."""
    import ctypes

    lib = native.get_entropy_lib()
    if lib is None:
        return None
    t = _tables()
    g = np.asarray([geom["w"], geom["h"], geom["ctu"], geom["max_merge"],
                    geom["num_ref"], geom["sdh"], geom["sao_luma"],
                    geom["sao_chroma"], geom["bd"],
                    geom.get("wpp", 0), len(ctx),
                    geom.get("ts", 0)], dtype=np.int32)
    cu_off = np.asarray([OFF[k] for k in _CU_OFF_KEYS], dtype=np.int32)

    def c32(a):
        return np.ascontiguousarray(np.asarray(a, dtype=np.int32)
                                    .reshape(-1))

    arrs = [c32(a) for a in (kind, mi, mvdx, mvdy, mvpi, refi, imode,
                             levy, levcb, levcr, lev16y, lev16cb,
                             lev16cr, lev32y, lev32cb, lev32cr,
                             depth8)]
    n_blocks = arrs[0].size
    cap = 4096 + 8 * sum(arrs[i].size for i in range(7, 16)) \
        + 16 * n_blocks
    out = np.zeros(cap, dtype=np.uint8)
    ctxc = np.ascontiguousarray(ctx)

    u8 = ctypes.POINTER(ctypes.c_uint8)
    i32 = ctypes.POINTER(ctypes.c_int32)

    def p8(a):
        return a.ctypes.data_as(u8)

    def p32(a):
        return a.ctypes.data_as(i32)

    sao_ptr = ctypes.cast(None, i32) if sao_packed is None \
        else p32(np.ascontiguousarray(sao_packed))
    n_rows = (geom["h"] + geom["ctu"] - 1) // geom["ctu"]
    bounds = np.zeros(2 + n_rows, dtype=np.int32)
    tsf_arr = c32(tsf) if tsf is not None \
        else np.zeros(n_blocks, dtype=np.int32)
    n = lib.hmtpu_encode_pslice(
        p8(t["next_mps"]), p8(t["next_lps"]), p8(t["lps"]),
        p8(t["renorm"]), p32(t["blob"]), p32(t["index"]), p32(t["off"]),
        p32(t["ctx4x4"]), p8(ctxc), p8(out), cap, p32(g), p32(cu_off),
        *[p32(a) for a in arrs], sao_ptr, p32(tsf_arr), p32(bounds))
    if n < 0:
        raise RuntimeError(f"native slice writer failed ({n})")
    ctx[:] = ctxc
    return out[:n].tobytes(), [int(x) for x in bounds[1:1 + bounds[0]]]
