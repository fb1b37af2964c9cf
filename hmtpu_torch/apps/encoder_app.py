"""Encoder CLI of the port (hmtpu/apps/encoder_app.py; capability parity
with TAppEncoder, encmain.cpp:52, TAppEncTop.cpp:468): HM-style config
files and overrides, YUV in, Annex-B out, the per-frame log and the
TEncAnalyze summary.

    python -m hmtpu_torch.apps.encoder_app [--device cuda|cpu] \\
        -c cfg/encoder_lowdelay_P_main.cfg -i in.yuv -wdt 416 -hgt 240 \\
        -f 2 -q 22 -b out.hevc [-o recon.yuv]

`--device` (before the HM options; `cuda` by default, which raises when
there is no card) is the port's one addition.  `ReconFile` is written
from the encoder's own reconstructed pictures, the ones the decoded
picture hash SEI hashes.  Options outside the port's slices (random
access, InternalBitDepth 10, RateControl, WaveFrontSynchro) raise the
encoder's NotImplementedError naming their ROADMAP.md item.
"""
from __future__ import annotations

import sys
import time

from hmtpu_torch.apps.options import parse_cli, resolve
from hmtpu_torch.encoder.top import Encoder, EncoderConfig
from hmtpu_torch.io.yuv import YuvReader, YuvWriter
from hmtpu_torch.utils.analyze import Analyze


def _split_device(argv: list[str], device: str):
    """Take `--device X` / `--device=X` off the front of argv."""
    argv = list(argv)
    if argv and argv[0].startswith("--device"):
        if "=" in argv[0]:
            device = argv.pop(0).split("=", 1)[1]
        else:
            argv.pop(0)
            device = argv.pop(0)
    return argv, device


def main(argv=None, device: str = "cuda") -> int:
    return 0 if run(argv, device) is not None else 1


def run(argv=None, device: str = "cuda"):
    """Encode as `main` does; returns the Encoder (its `results`, `cfg`
    and `pps` describe the run), or None when there is no InputFile."""
    argv, device = _split_device(sys.argv[1:] if argv is None else argv,
                                 device)
    app = resolve(parse_cli(argv))
    if not app.input_file:
        print("error: no InputFile", file=sys.stderr)
        return None
    if app.ignored:
        print(f"note: accepted HM options outside the current envelope: "
              f"{sorted(set(app.ignored))}", file=sys.stderr)

    enc = Encoder(EncoderConfig(
        width=app.width, height=app.height, qp=app.qp,
        bit_depth=app.internal_bit_depth, gop=app.gop,
        intra_period=max(app.intra_period, 0),
        num_refs=app.num_refs, sao=app.sao, deblock=app.deblock,
        subpel=app.subpel, search_range=min(app.search_range, 64),
        max_num_merge_cand=app.max_num_merge_cand,
        sign_data_hiding=app.sign_hiding,
        rdoq=app.rdoq, tmvp=app.tmvp, decision=app.decision,
        transform_skip=app.transform_skip,
        sei_buffering_period=app.sei_buffering_period,
        target_kbps=app.target_kbps, frame_rate=app.frame_rate,
        wpp=app.wpp,
        profile=app.profile if app.profile in
        ("main-rext", "high-throughput-rext") else "",
        nn_weights_dir=app.nn_weights_dir or None), device=device)

    rd = YuvReader(app.input_file, app.width, app.height,
                   file_bit_depth=app.input_bit_depth,
                   internal_bit_depth=app.internal_bit_depth)
    if app.frame_skip:
        rd.skip_frames(app.frame_skip)
    frames = []
    n = app.frames if app.frames > 0 else 1 << 30
    while len(frames) < n:
        f = rd.read_frame()
        if f is None:
            break
        frames.append(f)
    print(f"encoding {len(frames)} frames {app.width}x{app.height} "
          f"QP {app.qp} gop={app.gop} subpel={enc.cfg.subpel} "
          f"on {enc.device}")

    wr = None
    if app.recon_file:
        wr = YuvWriter(app.recon_file, file_bit_depth=app.input_bit_depth)
        enc.recon_sink = lambda poc, frame: wr.write_frame(frame)
    t0 = time.time()
    try:
        stream = enc.encode_sequence(frames)
    finally:
        if wr is not None:
            wr.close()
    dt = time.time() - t0
    with open(app.bitstream_file, "wb") as f:
        f.write(stream)

    ana = Analyze(frame_rate=app.frame_rate)
    for r in enc.results:
        ana.add_result(r.slice_type, r.bits, r.psnr_y, r.psnr_u, r.psnr_v)
        print(ana.frame_line(r.poc, r.slice_type, app.qp, r.bits,
                             r.psnr_y, r.psnr_u, r.psnr_v, r.seconds))
    ana.print_summary()
    print(f"\nBytes written to file: {len(stream)}")
    print(f" Total Time: {dt:9.3f} sec. ({len(frames) / dt:.3f} fps)")
    return enc


if __name__ == "__main__":
    sys.exit(main())
