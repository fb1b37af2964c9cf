"""Per-slice-type PSNR/bitrate analytics and summary printout —
capability parity with TEncAnalyze (TEncAnalyze.h:60 addResult :73,
printOut :139) and the per-frame log of TEncGOP::xCalculateAddPSNR
(TEncGOP.cpp:2108).  A copy of hmtpu/utils/analyze.py: the port keeps
its own."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class _Acc:
    frames: int = 0
    bits: int = 0
    psnr_y: float = 0.0
    psnr_u: float = 0.0
    psnr_v: float = 0.0

    def add(self, bits, py, pu, pv):
        self.frames += 1
        self.bits += bits
        self.psnr_y += py
        self.psnr_u += pu
        self.psnr_v += pv


@dataclass
class Analyze:
    frame_rate: float = 50.0
    accs: dict = field(default_factory=lambda: {
        "I": _Acc(), "P": _Acc(), "B": _Acc(), "a": _Acc()})

    def add_result(self, slice_type: str, bits: int, psnr_y: float,
                   psnr_u: float, psnr_v: float) -> None:
        self.accs[slice_type].add(bits, psnr_y, psnr_u, psnr_v)
        self.accs["a"].add(bits, psnr_y, psnr_u, psnr_v)

    def frame_line(self, poc, slice_type, qp, bits, py, pu, pv,
                   secs) -> str:
        return (f"POC {poc:4d} ( {slice_type}-SLICE, QP {qp} ) "
                f"{bits:10d} bits [Y {py:6.4f} dB  U {pu:6.4f} dB  "
                f"V {pv:6.4f} dB] [ET {secs:5.3f} ]")

    def _summary_line(self, name: str, acc: _Acc) -> str:
        if acc.frames == 0:
            return ""
        n = acc.frames
        kbps = acc.bits * self.frame_rate / n / 1000.0
        return (f"\t{n:8d}    {self.frame_rate:5.4f}   {kbps:12.4f}   "
                f"{acc.psnr_y / n:8.4f}   {acc.psnr_u / n:8.4f}   "
                f"{acc.psnr_v / n:8.4f}")

    def print_summary(self, out=None) -> str:
        lines = []
        hdr = ("\tTotal Frames |   Bitrate     Y-PSNR     U-PSNR     "
               "V-PSNR")
        for name, label in (("a", "SUMMARY"), ("I", "I Slices"),
                            ("P", "P Slices"), ("B", "B Slices")):
            acc = self.accs[name]
            if acc.frames == 0:
                continue
            lines.append(f"\n{label} {'-' * 56}")
            lines.append(hdr)
            lines.append(self._summary_line(name, acc))
        text = "\n".join(lines)
        print(text, file=out)
        return text
