"""HM-compatible option system: cascading `-c file.cfg` config files
with `Key : value  # comment` lines plus `--Key=Value` CLI overrides
and the common short flags.

Capability parity with the reference's program_options_lite
(source/Lib/TAppCommon/program_options_lite.h:46-80, option table
TAppEncCfg.cpp:657+): the keys used by the five BASELINE configs are
mapped onto EncoderConfig; recognised-but-inapplicable keys are
accepted and reported once so HM config files run unmodified.  A copy
of hmtpu/apps/options.py: the port keeps its own.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field


def parse_cfg_file(path: str) -> dict[str, str]:
    """One `Key : value` per line; '#' starts a comment; FrameN rows
    keep their full tail as the value."""
    out: dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or ":" not in line:
                continue
            key, val = line.split(":", 1)
            out[key.strip()] = val.strip()
    return out


# short CLI flags (TAppEncCfg option table parity)
SHORT_FLAGS = {
    "-i": "InputFile",
    "-b": "BitstreamFile",
    "-o": "ReconFile",
    "-wdt": "SourceWidth",
    "-hgt": "SourceHeight",
    "-fr": "FrameRate",
    "-f": "FramesToBeEncoded",
    "-q": "QP",
    "-ip": "IntraPeriod",
    "-g": "GOPSize",
}


def parse_cli(argv: list[str]) -> dict[str, str]:
    """-c file.cfg (cascading), --Key=Value, and short flags."""
    opts: dict[str, str] = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-c":
            opts.update(parse_cfg_file(argv[i + 1]))
            i += 2
        elif a.startswith("--"):
            if "=" in a:
                k, v = a[2:].split("=", 1)
            else:
                k, v = a[2:], argv[i + 1]
                i += 1
            opts[k] = v
            i += 1
        elif a in SHORT_FLAGS:
            opts[SHORT_FLAGS[a]] = argv[i + 1]
            i += 2
        else:
            raise SystemExit(f"unknown argument: {a}")
    return opts


@dataclass
class AppConfig:
    """Resolved application configuration (I/O + codec)."""
    input_file: str = ""
    bitstream_file: str = "str.bin"
    recon_file: str = ""
    width: int = 416
    height: int = 240
    frame_rate: float = 50.0
    frames: int = 0
    frame_skip: int = 0
    input_bit_depth: int = 8
    internal_bit_depth: int = 8
    qp: int = 32
    intra_period: int = -1
    gop: str = "ldp"
    gop_size: int = 4
    num_refs: int = 1
    sao: bool = True
    deblock: bool = True
    search_range: int = 64
    max_num_merge_cand: int = 5
    sign_hiding: bool = False
    subpel: str = "dctif"
    nn_weights_dir: str = ""
    rdoq: bool = True
    tmvp: bool = True
    transform_skip: bool = False
    rate_control: bool = False
    target_kbps: float = 0.0
    wpp: bool = False
    profile: str = ""
    decision: str = "scan"
    sei_buffering_period: bool = False
    ignored: list = field(default_factory=list)


_BOOLISH = {"0": False, "1": True, "false": False, "true": True}

# keys that are recognised HM options outside the current envelope;
# they are accepted (HM cfgs run unmodified) and reported once.
# Benign: descriptive, redundant with our defaults, or pure speed
# knobs whose output-identity HM doesn't guarantee either.
_ACCEPTED_KEYS = {
    "Level", "Tier", "IntraConstraintFlag",
    "MaxCUWidth", "MaxCUHeight",
    "MaxPartitionDepth", "QuadtreeTULog2MaxSize", "QuadtreeTULog2MinSize",
    "DecodingRefreshType", "FastSearch", "BipredSearchRange",
    "HadamardME", "FEN", "FDM",
    "SliceChromaQPOffsetPeriodicity", "SliceCbQpOffsetIntraOrPeriodic",
    "SliceCrQpOffsetIntraOrPeriodic", "LoopFilterOffsetInPPS",
    "DeblockingFilterMetric", "InputChromaFormat", "ConformanceWindowMode",
    "PCMEnabledFlag", "TemporalLevel0IndexSEIEnabled",
    "SEIDecodedPictureHash",
    "RCLCUSeparateModel", "InitialQP", "RCForceIntraQP", "Frame1",
    "Frame2", "Frame3", "Frame4", "Frame5", "Frame6", "Frame7", "Frame8",
}

# recognised keys that WOULD change the coded stream but have no knob
# behind them yet: accepting one silently would make an HM cfg encode
# something materially different, so each non-default value gets a
# loud per-key warning (and still lands in cfg.ignored)
_BEHAVIORAL_KEYS = {
    # key: default value (warn only when the cfg deviates from it)
    "QuadtreeTUMaxDepthInter": "1",
    "QuadtreeTUMaxDepthIntra": "1",
    "MaxDeltaQP": "0",
    "MaxCuDQPDepth": "0",
    "DeltaQpRD": "0",
    "RDOQTS": None,
    "TransformSkipFast": None,
    "LoopFilterBetaOffset_div2": "0",
    "LoopFilterTcOffset_div2": "0",
    "CUTransquantBypassFlagForce": "0",
    "TransquantBypassEnableFlag": "0",
    "ScalingList": "0",
    "AdaptiveQP": "0",
    "LCULevelRateControl": None,
}


def resolve(opts: dict[str, str]) -> AppConfig:
    cfg = AppConfig()
    frame_rows = {k: v for k, v in opts.items() if k.startswith("Frame")
                  and k[5:].isdigit()}

    def geti(key, default):
        return int(opts.get(key, default))

    cfg.input_file = opts.get("InputFile", cfg.input_file)
    cfg.bitstream_file = opts.get("BitstreamFile", cfg.bitstream_file)
    cfg.recon_file = opts.get("ReconFile", "")
    cfg.width = geti("SourceWidth", cfg.width)
    cfg.height = geti("SourceHeight", cfg.height)
    cfg.frame_rate = float(opts.get("FrameRate", cfg.frame_rate))
    cfg.frames = geti("FramesToBeEncoded", 0)
    cfg.frame_skip = geti("FrameSkip", 0)
    cfg.input_bit_depth = geti("InputBitDepth", 8)
    cfg.internal_bit_depth = geti("InternalBitDepth",
                                  cfg.input_bit_depth)
    cfg.profile = opts.get("Profile", "").lower()
    if cfg.profile == "main10":
        cfg.internal_bit_depth = max(cfg.internal_bit_depth, 10)
    cfg.qp = geti("QP", cfg.qp)
    cfg.intra_period = geti("IntraPeriod", -1)
    cfg.gop_size = geti("GOPSize", cfg.gop_size)
    cfg.search_range = geti("SearchRange", cfg.search_range)
    cfg.max_num_merge_cand = geti("MaxNumMergeCand", 5)
    cfg.sign_hiding = _BOOLISH.get(opts.get("SignHideFlag", "1").lower(),
                                   False)
    cfg.sao = _BOOLISH.get(opts.get("SAO", "1").lower(), True)
    cfg.deblock = not _BOOLISH.get(
        opts.get("LoopFilterDisable", "0").lower(), False)
    cfg.subpel = opts.get("SubPel", cfg.subpel).lower()
    cfg.nn_weights_dir = opts.get("NNWeightsDir", "")
    cfg.rdoq = _BOOLISH.get(opts.get("RDOQ", "1").lower(), True)
    cfg.tmvp = _BOOLISH.get(opts.get("EnableTemporalMvp", "1").lower(),
                            True)
    cfg.transform_skip = _BOOLISH.get(
        opts.get("TransformSkip", "0").lower(), False)
    cfg.rate_control = _BOOLISH.get(
        opts.get("RateControl", "0").lower(), False)
    if cfg.rate_control:
        # HM TargetBitrate is in bps (TAppEncCfg.cpp RateControl group)
        cfg.target_kbps = float(opts.get("TargetBitrate", "0")) / 1000.0
    cfg.wpp = _BOOLISH.get(opts.get("WaveFrontSynchro", "0").lower(),
                           False)
    cfg.decision = opts.get("DecisionEngine", cfg.decision).lower()
    cfg.sei_buffering_period = _BOOLISH.get(
        opts.get("SEIBufferingPeriod", "0").lower(), False)

    # GOP structure: intra period 1 => all intra; B rows => random
    # access; otherwise low-delay P (the reference BASELINE configs)
    row_types = [v.split()[0] for v in frame_rows.values() if v.split()]
    if cfg.intra_period == 1:
        cfg.gop = "ai"
    elif "B" in row_types or cfg.gop_size >= 8:
        cfg.gop = "ra"
    else:
        cfg.gop = "ldp"
    if row_types:
        try:
            n_act = int(list(frame_rows.values())[0].split()[9])
            cfg.num_refs = max(1, min(4, n_act))
        except (IndexError, ValueError):
            pass

    handled = {
        "InputFile", "BitstreamFile", "ReconFile", "SourceWidth",
        "SourceHeight", "FrameRate", "FramesToBeEncoded", "FrameSkip",
        "InputBitDepth", "InternalBitDepth", "QP", "IntraPeriod",
        "GOPSize", "SearchRange", "MaxNumMergeCand", "SignHideFlag",
        "SAO", "LoopFilterDisable", "SubPel", "NNWeightsDir",
        "RDOQ", "EnableTemporalMvp", "TransformSkip", "RateControl",
        "TargetBitrate", "DecisionEngine", "SEIBufferingPeriod",
        "WaveFrontSynchro", "Profile",
    }
    for k in opts:
        if k in handled or (k.startswith("Frame") and k[5:].isdigit()):
            continue
        if k in _BEHAVIORAL_KEYS:
            default = _BEHAVIORAL_KEYS[k]
            if default is None or opts[k].strip() != default:
                print(f"Warning: option {k}={opts[k]} is recognised "
                      f"but NOT implemented — the encode will differ "
                      f"from HM's for this config", file=sys.stderr)
            cfg.ignored.append(k)
        elif k in _ACCEPTED_KEYS:
            cfg.ignored.append(k)
        else:
            print(f"Warning: unknown option {k}", file=sys.stderr)
    return cfg
