// K20's arithmetic, shared by its entry points (mode_bits.cu) and the I
// z-scan walker K21 (iwalk.cuh): the intra luma mode's rate
// (prev_intra_luma_pred_flag + mpm_idx, or the 5-bit
// rem_intra_luma_pred_mode) with the 8.4.2 MPM list from the left and
// above modes, bit-exact with hmtpu/ops/ratebits.py:378
// intra_mode_mpm_bits.  Each bit count is rounded as the reference
// rounds it: (ctx + 1.0) + idx_gt0, or ctx + 5.0 (float32 additions, one
// at a time).
#pragma once

#include "hm_port.cuh"

namespace hm {

HM_FN int mod32(int v) { return ((v % 32) + 32) % 32; }

// tab: the flat fractional-bit table; ctx: INTRA_PRED_MODE's offset
HM_FN float mpm_bits(const float* tab, int ctx, int mode, int lm, int am) {
  const bool eq = lm == am, lt2 = lm < 2;
  const int m0 = eq && lt2 ? 0 : lm;
  const int m1 = eq ? (lt2 ? 1 : 2 + mod32(lm + 29)) : am;
  const int m2_eq = lt2 ? 26 : 2 + mod32(lm - 1);
  const int m2_ne = lm != 0 && am != 0 ? 0 : (lm != 1 && am != 1 ? 1 : 26);
  const int m2 = eq ? m2_eq : m2_ne;
  const bool in0 = mode == m0;
  if (in0 || mode == m1 || mode == m2)
    return HM_FADD(HM_FADD(tab[2 * ctx + 1], 1.0f), in0 ? 0.0f : 1.0f);
  return HM_FADD(tab[2 * ctx], 5.0f);
}

// the NxN CU's four PUs in z-order (hmtpu/encoder/iframe_dev.py:353-356),
// each PU's neighbours the earlier PUs' modes: ((a + b) + c) + d
HM_FN float mpm_bits4(const float* tab, int ctx, const int* m4, int l,
                      int a) {
  float s = mpm_bits(tab, ctx, m4[0], l, a);
  s = HM_FADD(s, mpm_bits(tab, ctx, m4[1], m4[0], a));
  s = HM_FADD(s, mpm_bits(tab, ctx, m4[2], l, m4[0]));
  return HM_FADD(s, mpm_bits(tab, ctx, m4[3], m4[2], m4[1]));
}

}  // namespace hm
