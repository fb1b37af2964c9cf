// K7's and K11's arithmetic, shared by their entry points (mc_dctif.cu)
// and the P z-scan walker K23 (pwalk.cuh): the DCT-IF prediction of one
// block (8-tap luma at quarter-pel, 4-tap chroma at eighth-pel, H.265
// 8.5.4.2.2), bit-exact with hmtpu/ops/interp.py:173 _mc_batch_jax (final
// samples) and :227 _mc_batch_jax_i (kInter: the intermediate-precision
// hypotheses of bi-prediction, int32 and unclipped).
//
// Block-cooperative (hm_port.cuh): the clamped (nh + ntaps - 1) x (nw +
// ntaps - 1) patch of the reference is gathered into `patch`, the
// horizontal pass writes every patch row's filtered output to `tmp`, the
// vertical pass reads it.  The integer position and phase come from the
// MV: `mv >> 2` (`>> 3` chroma) is an arithmetic shift, so it floors for
// negative MVs as the reference does, and `mv & 3` (`& 7`) is the phase.
// The intermediate stage subtracts the 14-bit offset only when both
// phases are non-zero; copy, H-only and V-only take the reference's own
// roundings.  Compiles as host C++ too.
#pragma once

#include "hm_dsp.cuh"
#include "hm_port.cuh"

namespace hm {

HM_CONST int kChroma[8][4] = {
    {0, 64, 0, 0},   {-2, 58, 10, -2}, {-4, 54, 16, -2}, {-6, 46, 28, -4},
    {-4, 36, 36, -4}, {-4, 28, 46, -6}, {-2, 16, 54, -4}, {-2, 10, 58, -2}};

// ints of the patch and tmp areas of an nw x nh block
HM_HD constexpr int mc_patch_ints(int nw, int nh, int chroma) {
  const int ntaps = chroma ? 4 : 8;
  return (nh + ntaps - 1) * (nw + ntaps - 1);
}
HM_HD constexpr int mc_tmp_ints(int nw, int nh, int chroma) {
  return (nh + (chroma ? 4 : 8) - 1) * nw;
}

// the nw x nh block at (xs0, ys0) of `plane` (H x W) moved by (mx, my)
// into out (raster); patch and tmp as sized above
template <bool kInter>
HM_FN void mc_block(const int* plane, int H, int W, int xs0, int ys0, int mx,
                    int my, int nw, int nh, int chroma, int bd, int* patch,
                    int* tmp, int* out, int tid, int nt) {
  const int ntaps = chroma ? 4 : 8;
  const int half = ntaps / 2 - 1;
  const int sh = chroma ? 3 : 2;
  const int msk = chroma ? 7 : 3;
  const int x = xs0 + (mx >> sh);
  const int y = ys0 + (my >> sh);
  const int fx = mx & msk, fy = my & msk;
  const int pw = nw + ntaps - 1, ph = nh + ntaps - 1;

  for (int k = tid; k < ph * pw; k += nt) {
    const int i = k / pw, j = k - (k / pw) * pw;
    const int yy = iclamp(y - half + i, 0, H - 1);
    const int xx = iclamp(x - half + j, 0, W - 1);
    patch[k] = plane[(size_t)yy * W + xx];
  }
  HM_GSYNC(nt);

  const int* cx = chroma ? &kChroma[fx][0] : &kLuma[fx][0];
  const int* cy = chroma ? &kChroma[fy][0] : &kLuma[fy][0];
  const int shift1 = bd - 8;
  const bool both = fx != 0 && fy != 0;
  for (int k = tid; k < ph * nw; k += nt) {
    const int i = k / nw, j = k - (k / nw) * nw;
    int acc = 0;
    for (int t = 0; t < ntaps; ++t) acc += cx[t] * patch[i * pw + j + t];
    tmp[k] = both ? (acc - (IF_INTERNAL_OFFS << shift1)) >> shift1 : acc;
  }
  HM_GSYNC(nt);

  const int maxv = (1 << bd) - 1;
  const int shift2 = IF_FILTER_PREC + (IF_INTERNAL_PREC - bd);
  const int off2 = (1 << (shift2 - 1)) + (IF_INTERNAL_OFFS << IF_FILTER_PREC);
  for (int k = tid; k < nh * nw; k += nt) {
    const int i = k / nw, j = k - (k / nw) * nw;
    int v;
    if (kInter) {
      if (fx == 0 && fy == 0) {
        v = (patch[(i + half) * pw + j + half] << (IF_INTERNAL_PREC - bd)) -
            IF_INTERNAL_OFFS;
      } else if (fy == 0) {
        v = (tmp[(i + half) * nw + j] - (IF_INTERNAL_OFFS << shift1)) >>
            shift1;
      } else {
        int acc2 = 0;
        for (int t = 0; t < ntaps; ++t) acc2 += cy[t] * tmp[(i + t) * nw + j];
        v = acc2 >> IF_FILTER_PREC;
        // V-only: the horizontal pass was phase 0 (x64)
        if (fx == 0) v = (v - (IF_INTERNAL_OFFS << shift1)) >> shift1;
      }
      out[k] = v;
      continue;
    }
    if (fx == 0 && fy == 0) {
      v = patch[(i + half) * pw + j + half];
    } else if (fy == 0) {
      v = (tmp[(i + half) * nw + j] + 32) >> IF_FILTER_PREC;
    } else {
      int acc2 = 0;
      for (int t = 0; t < ntaps; ++t) acc2 += cy[t] * tmp[(i + t) * nw + j];
      // V-only: the horizontal pass was phase 0 (x64), so
      // (acc2 + (32 << 6)) >> 12 == (S + 32) >> 6
      v = fx == 0 ? (acc2 + (32 << IF_FILTER_PREC)) >> (2 * IF_FILTER_PREC)
                  : (acc2 + off2) >> shift2;
    }
    out[k] = iclamp(v, 0, maxv);
  }
  HM_GSYNC(nt);
}

}  // namespace hm
