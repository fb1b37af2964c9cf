"""sao() CTU syntax (H.265 7.3.8.3): encode through an entropy backend,
decode from a CabacDecoder.  Parity with TEncSbac::codeSAOBlkParam /
TDecSbac::parseSAOBlkParam.

params3 is a 3-list [luma, cb, cr] of ops/sao.py CtuSaoParams; edge
offsets are stored signed (categories 3/4 non-positive) and serialised
as magnitudes per the spec's inferred-sign rule.
"""
from __future__ import annotations

import numpy as np

from hmtpu_torch.entropy.contexts import OFF
from hmtpu_torch.ops.sao import CtuSaoParams, max_offset


def _enc_offset_abs(enc, v: int, cmax: int) -> None:
    # TR, cMax = saoMaxOffsetQVal, bypass bins
    for _ in range(v):
        enc.encode_bin_ep(1)
    if v < cmax:
        enc.encode_bin_ep(0)


def _dec_offset_abs(dec, cmax: int) -> int:
    v = 0
    while v < cmax and dec.decode_bin_ep():
        v += 1
    return v


def encode_sao_ctu(enc, params3, left_avail: bool, up_avail: bool,
                   sao_luma: bool, sao_chroma: bool,
                   bd: int = 8) -> None:
    """Serialise one CTU's SAO params (no merge in this encoder: the
    merge flags are coded 0 whenever present)."""
    if left_avail:
        enc.encode_bin(OFF["SAO_MERGE_FLAG"], 0)
    if up_avail:
        enc.encode_bin(OFF["SAO_MERGE_FLAG"], 0)
    for c in range(3):
        if c == 0 and not sao_luma:
            continue
        if c > 0 and not sao_chroma:
            continue
        p = params3[c]
        if c in (0, 1):
            t = p.type_idx
            enc.encode_bin(OFF["SAO_TYPE_IDX"], int(t != 0))
            if t != 0:
                enc.encode_bin_ep(int(t == 2))
        else:
            t = params3[1].type_idx
        if t == 0:
            continue
        offs = [int(v) for v in p.offsets]
        for v in offs:
            _enc_offset_abs(enc, abs(v), max_offset(bd))
        if t == 1:                       # band: signs + position
            for v in offs:
                if v != 0:
                    enc.encode_bin_ep(int(v < 0))
            enc.encode_bins_ep(p.band_pos, 5)
        elif c in (0, 1):                # edge: class (shared cb/cr)
            enc.encode_bins_ep(p.eo_class, 2)


def decode_sao_ctu(dec, ctx, left_params3, up_params3,
                   sao_luma: bool, sao_chroma: bool, bd: int = 8):
    """Parse one CTU's SAO params; returns [luma, cb, cr]."""
    if left_params3 is not None and \
            dec.decode_bin(ctx, OFF["SAO_MERGE_FLAG"]):
        return [CtuSaoParams(p.type_idx, p.eo_class, p.band_pos,
                             p.offsets.copy()) for p in left_params3]
    if up_params3 is not None and \
            dec.decode_bin(ctx, OFF["SAO_MERGE_FLAG"]):
        return [CtuSaoParams(p.type_idx, p.eo_class, p.band_pos,
                             p.offsets.copy()) for p in up_params3]
    out = [CtuSaoParams(), CtuSaoParams(), CtuSaoParams()]
    for c in range(3):
        if c == 0 and not sao_luma:
            continue
        if c > 0 and not sao_chroma:
            continue
        p = out[c]
        if c in (0, 1):
            t = 0
            if dec.decode_bin(ctx, OFF["SAO_TYPE_IDX"]):
                t = 2 if dec.decode_bin_ep() else 1
            p.type_idx = t
        else:
            t = out[1].type_idx
            p.type_idx = t
        if t == 0:
            continue
        mags = [_dec_offset_abs(dec, max_offset(bd))
                for _ in range(4)]
        if t == 1:
            offs = []
            for v in mags:
                if v and dec.decode_bin_ep():
                    v = -v
                offs.append(v)
            p.offsets = np.asarray(offs, dtype=np.int32)
            p.band_pos = dec.decode_bins_ep(5)
        else:
            # edge: categories 1/2 non-negative, 3/4 non-positive
            p.offsets = np.asarray(
                [mags[0], mags[1], -mags[2], -mags[3]], dtype=np.int32)
            if c in (0, 1):
                p.eo_class = dec.decode_bins_ep(2)
            else:
                p.eo_class = out[1].eo_class
    return out
