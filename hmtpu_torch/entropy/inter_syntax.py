"""Inter-prediction syntax binarizations: mvd_coding, merge_idx,
ref_idx (H.265 7.3.8.9, 9.3.3).

Capability parity with the reference's TEncSbac::codeMvd/codeMergeIndex
(TEncSbac.cpp:427-520) and their TDecSbac twins, kept as free functions
over the flat context array so encoder and decoder share one definition
of each binarization.
"""
from __future__ import annotations

from hmtpu_torch.entropy.contexts import OFF


# -- k-th order Exp-Golomb, bypass bins (9.3.3.3) ---------------------------

def encode_egk(enc, value: int, k: int) -> None:
    while value >= (1 << k):
        enc.encode_bin_ep(1)
        value -= 1 << k
        k += 1
    enc.encode_bin_ep(0)
    if k:
        enc.encode_bins_ep(value, k)


def decode_egk(dec, k: int) -> int:
    value = 0
    while dec.decode_bin_ep():
        value += 1 << k
        k += 1
    if k:
        value += dec.decode_bins_ep(k)
    return value


# -- mvd_coding (7.3.8.9) ---------------------------------------------------

def encode_mvd(enc, mvd_x: int, mvd_y: int) -> None:
    ax, ay = abs(mvd_x), abs(mvd_y)
    enc.encode_bin(OFF["MVD"] + 0, int(ax > 0))
    enc.encode_bin(OFF["MVD"] + 0, int(ay > 0))
    if ax > 0:
        enc.encode_bin(OFF["MVD"] + 1, int(ax > 1))
    if ay > 0:
        enc.encode_bin(OFF["MVD"] + 1, int(ay > 1))
    for a, v in ((ax, mvd_x), (ay, mvd_y)):
        if a > 0:
            if a > 1:
                encode_egk(enc, a - 2, 1)
            enc.encode_bin_ep(int(v < 0))


def decode_mvd(dec, ctx) -> tuple[int, int]:
    gx = dec.decode_bin(ctx, OFF["MVD"] + 0)
    gy = dec.decode_bin(ctx, OFF["MVD"] + 0)
    g1x = dec.decode_bin(ctx, OFF["MVD"] + 1) if gx else 0
    g1y = dec.decode_bin(ctx, OFF["MVD"] + 1) if gy else 0
    out = []
    for g, g1 in ((gx, g1x), (gy, g1y)):
        if not g:
            out.append(0)
            continue
        a = 1 if not g1 else 2 + decode_egk(dec, 1)
        out.append(-a if dec.decode_bin_ep() else a)
    return out[0], out[1]


# -- merge_idx: TR cMax = MaxNumMergeCand-1, first bin ctx, rest EP ---------

def encode_merge_idx(enc, idx: int, max_cand: int) -> None:
    if max_cand <= 1:
        return
    enc.encode_bin(OFF["MERGE_IDX"], int(idx > 0))
    if idx > 0:
        for i in range(1, idx):
            enc.encode_bin_ep(1)
        if idx < max_cand - 1:
            enc.encode_bin_ep(0)


def decode_merge_idx(dec, ctx, max_cand: int) -> int:
    if max_cand <= 1:
        return 0
    if not dec.decode_bin(ctx, OFF["MERGE_IDX"]):
        return 0
    idx = 1
    while idx < max_cand - 1 and dec.decode_bin_ep():
        idx += 1
    return idx


# -- inter_pred_idc (9.3.3.7): bin0 ctx = CtDepth, bin1 ctx 4 ---------------
# (the nPbW+nPbH==12 single-bin form never occurs with 2Nx2N PUs)

def encode_inter_dir(enc, inter_dir: int, depth: int) -> None:
    """inter_dir: 1 = PRED_L0, 2 = PRED_L1, 3 = PRED_BI."""
    enc.encode_bin(OFF["INTER_DIR"] + depth, int(inter_dir == 3))
    if inter_dir != 3:
        enc.encode_bin(OFF["INTER_DIR"] + 4, int(inter_dir == 2))


def decode_inter_dir(dec, ctx, depth: int) -> int:
    if dec.decode_bin(ctx, OFF["INTER_DIR"] + depth):
        return 3
    return 2 if dec.decode_bin(ctx, OFF["INTER_DIR"] + 4) else 1


# -- ref_idx: TR cMax = numRef-1, bins 0/1 ctx-coded, rest EP ---------------

def encode_ref_idx(enc, idx: int, num_ref: int) -> None:
    if num_ref <= 1:
        return
    enc.encode_bin(OFF["REF_PIC"] + 0, int(idx > 0))
    if idx > 0 and num_ref > 2:
        enc.encode_bin(OFF["REF_PIC"] + 1, int(idx > 1))
        if idx > 1:
            for i in range(2, idx):
                enc.encode_bin_ep(1)
            if idx < num_ref - 1:
                enc.encode_bin_ep(0)


def decode_ref_idx(dec, ctx, num_ref: int) -> int:
    if num_ref <= 1:
        return 0
    if not dec.decode_bin(ctx, OFF["REF_PIC"] + 0):
        return 0
    if num_ref == 2 or not dec.decode_bin(ctx, OFF["REF_PIC"] + 1):
        return 1
    idx = 2
    while idx < num_ref - 1 and dec.decode_bin_ep():
        idx += 1
    return idx
