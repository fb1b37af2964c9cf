"""Transform-coefficient coding: residual_coding() syntax (H.265
7.3.8.11) — encoder and decoder over the CABAC engine.

Capability parity with the reference's TEncSbac::codeCoeffNxN
(TEncSbac.cpp:1181) and TDecSbac::parseCoeffNxN, re-expressed around the
precomputed grouped scan tables of common/scan.py.  The per-TB syntax
stays host-side (it is the inherently serial CABAC tail); the encoder
upstream prepares level arrays on device and this module serialises
them.

Supports: last-significant position, coded_sub_block_flag,
sig_coeff_flag with the full 9.3.4.2.5 context derivation, greater1/
greater2 flags, sign data hiding, Golomb-Rice remainders with the HEVC
v1 in-group Rice adaptation (COEF_REMAIN_BIN_REDUCTION = 3).
"""
from __future__ import annotations

import numpy as np

from hmtpu_torch.common.scan import SCAN_VER, cg_scan_order, scan_order
from hmtpu_torch.entropy.contexts import CTX_IDX_MAP_4x4, OFF

_SIG_CHROMA_OFF = 28  # FIRST_SIG_FLAG_CTX_CHROMA within the SIG_FLAG block
_C1FLAG_NUMBER = 8


# --------------------------------------------------------------------------
# shared derivation helpers

def _last_ctx_params(log2: int, is_luma: bool):
    if is_luma:
        return 3 * (log2 - 2) + ((log2 - 1) >> 2), (log2 + 1) >> 2
    return 0, log2 - 2


def _group_idx(pos: int) -> int:
    if pos < 4:
        return pos
    bl = pos.bit_length()
    return ((bl - 1) << 1) + ((pos >> (bl - 2)) & 1)


def _min_in_group(g: int) -> int:
    if g < 4:
        return g
    return (2 + (g & 1)) << ((g >> 1) - 1)


def _sig_ctx_inc(patt: int, x: int, y: int, log2: int, scan_idx: int,
                 is_luma: bool) -> int:
    """9.3.4.2.5 sigCtx (before the luma/chroma block offset)."""
    if log2 == 2:
        return int(CTX_IDX_MAP_4x4[(y << 2) + x])
    if x + y == 0:
        return 0
    xp, yp = x & 3, y & 3
    if patt == 0:
        sig = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
    elif patt == 1:
        sig = 2 if yp == 0 else (1 if yp == 1 else 0)
    elif patt == 2:
        sig = 2 if xp == 0 else (1 if xp == 1 else 0)
    else:
        sig = 2
    if is_luma:
        if (x >> 2) + (y >> 2) > 0:
            sig += 3
        sig += (9 if scan_idx == 0 else 15) if log2 == 3 else 21
    else:
        sig += 9 if log2 == 3 else 12
    return sig


def _sig_ctx_full(patt, raster, size, log2, scan_idx, is_luma):
    x, y = raster % size, raster // size
    sc = _sig_ctx_inc(patt, x, y, log2, scan_idx, is_luma)
    return OFF["SIG_FLAG"] + (sc if is_luma else _SIG_CHROMA_OFF + sc)


def _cg_patt(cg_sig_raster: np.ndarray, cg_x: int, cg_y: int, cg_w: int) -> int:
    right = cg_x + 1 < cg_w and cg_sig_raster[cg_y * cg_w + cg_x + 1]
    below = cg_y + 1 < cg_w and cg_sig_raster[(cg_y + 1) * cg_w + cg_x]
    return (1 if right else 0) | (2 if below else 0)


# --------------------------------------------------------------------------
# Golomb-Rice remainder (xWriteCoefRemainExGolomb parity)

def write_remainder(enc, symbol: int, rice: int) -> None:
    if symbol < (3 << rice):
        length = symbol >> rice
        enc.encode_bins_ep((1 << (length + 1)) - 2, length + 1)
        if rice:
            enc.encode_bins_ep(symbol & ((1 << rice) - 1), rice)
    else:
        length = rice
        symbol -= 3 << rice
        while symbol >= (1 << length):
            symbol -= 1 << length
            length += 1
        enc.encode_bins_ep((1 << (3 + length + 1 - rice)) - 2,
                           3 + length + 1 - rice)
        if length:
            enc.encode_bins_ep(symbol, length)


def read_remainder(dec, rice: int) -> int:
    prefix = 0
    while prefix < 32 and dec.decode_bin_ep() == 1:
        prefix += 1
    if prefix < 3:
        suffix = dec.decode_bins_ep(rice) if rice else 0
        return (prefix << rice) + suffix
    length = prefix - 3 + rice
    suffix = dec.decode_bins_ep(length) if length else 0
    return suffix + ((((1 << (prefix - 3)) + 2) << rice))


# --------------------------------------------------------------------------
# encoder

def encode_residual(enc, ctx: np.ndarray, coeffs: np.ndarray, log2: int,
                    is_luma: bool, scan_idx: int,
                    sign_hiding: bool = False) -> None:
    """Serialise one TB's quantised levels (coeffs: [size,size] int32,
    raster layout; must contain at least one nonzero)."""
    size = 1 << log2
    flat = coeffs.reshape(-1)
    scans = scan_order(log2, scan_idx)
    cg_raster_order = cg_scan_order(log2, scan_idx)
    num_cg = scans.shape[0]
    cg_w = max(size >> 2, 1)

    scan_flat = flat[scans.reshape(-1)]
    nz = np.nonzero(scan_flat)[0]
    assert nz.size, "encode_residual on an all-zero TB"
    last_scan_pos = int(nz.max())
    last_cg = last_scan_pos >> 4
    last_raster = int(scans[last_cg, last_scan_pos & 15])
    last_x, last_y = last_raster % size, last_raster // size
    if scan_idx == SCAN_VER:
        last_x, last_y = last_y, last_x

    # ---- last position
    goff, gshift = _last_ctx_params(log2, is_luma)
    gx, gy = _group_idx(last_x), _group_idx(last_y)
    cmax = (log2 << 1) - 1
    ctx_x = OFF["LAST_X" if is_luma else "LAST_X_C"]
    ctx_y = OFF["LAST_Y" if is_luma else "LAST_Y_C"]
    for b in range(gx):
        enc.encode_bin(ctx, ctx_x + goff + (b >> gshift), 1)
    if gx < cmax:
        enc.encode_bin(ctx, ctx_x + goff + (gx >> gshift), 0)
    for b in range(gy):
        enc.encode_bin(ctx, ctx_y + goff + (b >> gshift), 1)
    if gy < cmax:
        enc.encode_bin(ctx, ctx_y + goff + (gy >> gshift), 0)
    if gx > 3:
        enc.encode_bins_ep(last_x - _min_in_group(gx), (gx >> 1) - 1)
    if gy > 3:
        enc.encode_bins_ep(last_y - _min_in_group(gy), (gy >> 1) - 1)

    # coded_sub_block_flag map in raster CG layout
    cg_sig_scan = np.array(
        [(scan_flat[ci * 16:(ci + 1) * 16] != 0).any() for ci in range(num_cg)]
    )
    cg_sig_raster = np.zeros(num_cg, dtype=bool)
    for ci in range(num_cg):
        cg_sig_raster[int(cg_raster_order[ci])] = cg_sig_scan[ci]

    c1 = 1
    for ci in range(last_cg, -1, -1):
        cg_r = int(cg_raster_order[ci])
        cg_x, cg_y = cg_r % cg_w, cg_r // cg_w
        infer_dc = False
        if 0 < ci < last_cg:
            right = cg_x + 1 < cg_w and cg_sig_raster[cg_r + 1]
            below = cg_y + 1 < cg_w and cg_sig_raster[cg_r + cg_w]
            ctx_inc = OFF["SIG_CG_FLAG"] + (0 if is_luma else 2) + \
                (1 if (right or below) else 0)
            enc.encode_bin(ctx, ctx_inc, int(cg_sig_scan[ci]))
            infer_dc = bool(cg_sig_scan[ci])
            if not cg_sig_scan[ci]:
                continue
        # NB: CG0 and the last CG have coded_sub_block_flag inferred 1,
        # so their sig flags are always coded (possibly all zero in CG0)
        patt = _cg_patt(cg_sig_raster, cg_x, cg_y, cg_w)

        # ---- sig_coeff_flag (reverse scan within CG)
        sig_levels = []  # (scan pos in CG, level), reverse scan order
        if ci == last_cg:
            start = (last_scan_pos & 15) - 1
            sig_levels.append((last_scan_pos & 15,
                               int(scan_flat[last_scan_pos])))
        else:
            start = 15
        for p in range(start, -1, -1):
            lv = int(scan_flat[ci * 16 + p])
            sig = lv != 0
            if p == 0 and infer_dc:
                assert sig, "inferSbDcSigCoeffFlag requires nonzero DC"
            else:
                raster = int(scans[ci, p])
                enc.encode_bin(ctx, _sig_ctx_full(patt, raster, size, log2,
                                                  scan_idx, is_luma),
                               int(sig))
            if sig:
                sig_levels.append((p, lv))
            if sig and p > 0:
                infer_dc = False

        # ---- level/sign coding for this CG
        n = len(sig_levels)
        if n == 0:
            continue        # all-zero CG0 below the last CG
        abs_levels = [abs(v) for _, v in sig_levels]
        signs = [1 if v < 0 else 0 for _, v in sig_levels]
        ctx_set = (2 if (ci > 0 and is_luma) else 0) + (1 if c1 == 0 else 0)
        c1 = 1
        first_g2 = -1
        for i in range(min(n, _C1FLAG_NUMBER)):
            g1 = int(abs_levels[i] > 1)
            enc.encode_bin(ctx, OFF["ONE_FLAG"] + (0 if is_luma else 16)
                           + ctx_set * 4 + c1, g1)
            if g1:
                c1 = 0
                if first_g2 < 0:
                    first_g2 = i
            elif 0 < c1 < 3:
                c1 += 1
        if first_g2 >= 0:
            enc.encode_bin(ctx, OFF["ABS_FLAG"]
                           + (ctx_set if is_luma else 4 + ctx_set),
                           int(abs_levels[first_g2] > 2))

        hide = sign_hiding and (sig_levels[0][0] - sig_levels[-1][0] > 3)
        if hide:
            assert (sum(abs_levels) & 1) == signs[-1], \
                "sign-hiding parity not satisfied by quantiser"
        sign_bits = signs[:-1] if hide else signs
        for s in sign_bits:
            enc.encode_bin_ep(s)

        rice = 0
        first_coeff2 = 1
        for i in range(n):
            base = (2 + first_coeff2) if i < _C1FLAG_NUMBER else 1
            if abs_levels[i] >= base:
                write_remainder(enc, abs_levels[i] - base, rice)
                if abs_levels[i] > (3 << rice):
                    rice = min(rice + 1, 4)
            if abs_levels[i] >= 2:
                first_coeff2 = 0


# --------------------------------------------------------------------------
# decoder

def decode_residual(dec, ctx: np.ndarray, log2: int, is_luma: bool,
                    scan_idx: int, sign_hiding: bool = False) -> np.ndarray:
    """Parse one TB; returns [size,size] int32 levels (raster)."""
    size = 1 << log2
    scans = scan_order(log2, scan_idx)
    cg_raster_order = cg_scan_order(log2, scan_idx)
    num_cg = scans.shape[0]
    cg_w = max(size >> 2, 1)
    out = np.zeros(size * size, dtype=np.int32)

    # ---- last position
    goff, gshift = _last_ctx_params(log2, is_luma)
    cmax = (log2 << 1) - 1
    ctx_x = OFF["LAST_X" if is_luma else "LAST_X_C"]
    ctx_y = OFF["LAST_Y" if is_luma else "LAST_Y_C"]
    gx = 0
    while gx < cmax and dec.decode_bin(ctx, ctx_x + goff + (gx >> gshift)):
        gx += 1
    gy = 0
    while gy < cmax and dec.decode_bin(ctx, ctx_y + goff + (gy >> gshift)):
        gy += 1
    if gx > 3:
        last_x = _min_in_group(gx) + dec.decode_bins_ep((gx >> 1) - 1)
    else:
        last_x = gx
    if gy > 3:
        last_y = _min_in_group(gy) + dec.decode_bins_ep((gy >> 1) - 1)
    else:
        last_y = gy
    if scan_idx == SCAN_VER:
        last_x, last_y = last_y, last_x
    last_raster = last_y * size + last_x
    # find scan position
    pos_of_raster = {int(scans[ci, p]): ci * 16 + p
                     for ci in range(num_cg) for p in range(16)}
    last_scan_pos = pos_of_raster[last_raster]
    last_cg = last_scan_pos >> 4

    cg_sig_raster = np.zeros(num_cg, dtype=bool)
    cg_sig_raster[int(cg_raster_order[last_cg])] = True
    cg_sig_raster[int(cg_raster_order[0])] = True

    c1 = 1
    for ci in range(last_cg, -1, -1):
        cg_r = int(cg_raster_order[ci])
        cg_x, cg_y = cg_r % cg_w, cg_r // cg_w
        infer_dc = False
        cg_coded = True
        if 0 < ci < last_cg:
            right = cg_x + 1 < cg_w and cg_sig_raster[cg_r + 1]
            below = cg_y + 1 < cg_w and cg_sig_raster[cg_r + cg_w]
            ctx_inc = OFF["SIG_CG_FLAG"] + (0 if is_luma else 2) + \
                (1 if (right or below) else 0)
            cg_coded = bool(dec.decode_bin(ctx, ctx_inc))
            cg_sig_raster[cg_r] = cg_coded
            infer_dc = cg_coded
        if not cg_coded:
            continue
        patt = _cg_patt(cg_sig_raster, cg_x, cg_y, cg_w)

        sig_pos = []
        if ci == last_cg:
            sig_pos.append(last_scan_pos & 15)
            start = (last_scan_pos & 15) - 1
        else:
            start = 15
        for p in range(start, -1, -1):
            if p == 0 and infer_dc:
                sig = 1
            else:
                raster = int(scans[ci, p])
                sig = dec.decode_bin(ctx, _sig_ctx_full(
                    patt, raster, size, log2, scan_idx, is_luma))
            if sig:
                sig_pos.append(p)
                if p > 0:
                    infer_dc = False

        n = len(sig_pos)
        if n == 0:
            continue
        ctx_set = (2 if (ci > 0 and is_luma) else 0) + (1 if c1 == 0 else 0)
        c1 = 1
        g1_flags = []
        first_g2 = -1
        for i in range(min(n, _C1FLAG_NUMBER)):
            g1 = dec.decode_bin(ctx, OFF["ONE_FLAG"] + (0 if is_luma else 16)
                                + ctx_set * 4 + c1)
            g1_flags.append(g1)
            if g1:
                c1 = 0
                if first_g2 < 0:
                    first_g2 = i
            elif 0 < c1 < 3:
                c1 += 1
        g2 = 0
        if first_g2 >= 0:
            g2 = dec.decode_bin(ctx, OFF["ABS_FLAG"]
                                + (ctx_set if is_luma else 4 + ctx_set))

        hide = sign_hiding and (sig_pos[0] - sig_pos[-1] > 3)
        num_signs = n - 1 if hide else n
        signs = [dec.decode_bin_ep() for _ in range(num_signs)]

        rice = 0
        first_coeff2 = 1
        abs_levels = []
        for i in range(n):
            base = 1
            if i < _C1FLAG_NUMBER:
                base = 1 + g1_flags[i] + (g2 if i == first_g2 else 0)
            level = base
            base_cap = (2 + first_coeff2) if i < _C1FLAG_NUMBER else 1
            if level == base_cap:
                level += read_remainder(dec, rice)
                if level > (3 << rice):
                    rice = min(rice + 1, 4)
            abs_levels.append(level)
            if level >= 2:
                first_coeff2 = 0

        if hide:
            total = sum(abs_levels)
            signs.append(total & 1)
        for i in range(n):
            lv = abs_levels[i] * (-1 if signs[i] else 1)
            out[int(scans[ci, sig_pos[i]])] = lv

    return out.reshape(size, size)
