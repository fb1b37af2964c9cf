// K2's arithmetic, shared by its entry points (intra_pred.cu), the fused
// rough mode decision K22 (i_rmd.cuh) and the I z-scan walker K21
// (iwalk.cuh): HEVC intra prediction (H.265 8.4.4.2), bit-exact with
// hmtpu/ops/intra_pred.py:230 filter_reference_batched and :69
// predict_all_modes / :149 predict_one_mode.
//
// Reference lines are 4N+1 samples, bottom-left -> corner -> top-right
// (ref[2N-1-y] = p[-1][y], ref[2N] = p[-1][-1], ref[2N+1+x] = p[x][-1]).
// The angular taps are derived per sample from the spec's angle tables.
#pragma once

#include "hm_port.cuh"

namespace hm {

// intraPredAngle, modes 2..34 (Table 8-5)
HM_CONST int kAngles[33] = {32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5,
                            -9, -13, -17, -21, -26, -32, -26, -21,
                            -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17,
                            21, 26, 32};

HM_FN int inv_angle(int a) {
  switch (a) {
    case -2: return -4096;
    case -5: return -1638;
    case -9: return -910;
    case -13: return -630;
    case -17: return -482;
    case -21: return -390;
    case -26: return -315;
    case -32: return -256;
    default: return 0;
  }
}

HM_FN int log2_of(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// 8.4.4.2.3 filtering decision (should_filter in ops/intra_ref.py)
HM_FN bool uses_filtered(int mode, int n, int is_luma) {
  if (!is_luma || mode == 1 || n == 4) return false;
  const int d = imin(iabs(mode - 26), iabs(mode - 10));
  const int thres = n == 8 ? 7 : (n == 16 ? 1 : 0);
  return d > thres;
}

// sample k of the filtered line of r: [1 2 1], or the strong bilinear
// filter of a 32x32 block where it applies
HM_FN int filter_sample(const int* r, int k, int n, int bd, int strong) {
  const int line = 4 * n + 1;
  int v = r[k];
  if (k > 0 && k < line - 1) v = (r[k - 1] + 2 * r[k] + r[k + 1] + 2) >> 2;
  if (strong && n == 32) {
    const int thr = 1 << (bd - 5);
    const int corner = r[2 * n];
    const int topmid = r[2 * n + 1 + (n - 1)];
    const int topend = r[4 * n];
    const int leftmid = r[2 * n - 1 - (n - 1)];
    const int leftend = r[0];
    const bool bi = iabs(corner + topend - 2 * topmid) < thr &&
                    iabs(corner + leftend - 2 * leftmid) < thr;
    if (bi) {
      v = r[k];
      if (k >= 1 && k <= 2 * n - 1) {          // left column, y = 2n-1-k
        const int y = 2 * n - 1 - k;
        v = ((63 - y) * corner + (y + 1) * leftend + 32) >> 6;
      } else if (k >= 2 * n + 1 && k <= 4 * n - 1) {   // top row
        const int x = k - (2 * n + 1);
        v = ((63 - x) * corner + (x + 1) * topend + 32) >> 6;
      }
    }
  }
  return v;
}

// the DC value of the unfiltered line
HM_FN int intra_dc(const int* su, int n, int log2n) {
  int s = n;
  for (int i = 0; i < n; ++i) s += su[2 * n + 1 + i] + su[2 * n - 1 - i];
  return s >> (log2n + 1);
}

// prediction sample (y, x) of `mode` from the unfiltered (su) and
// filtered (sf) lines; dc = intra_dc(su)
HM_FN int pred_sample(const int* su, const int* sf, int dc, int mode, int n,
                      int log2n, int is_luma, int bd, int y, int x) {
  const int maxv = (1 << bd) - 1;
  const bool edge = is_luma && n < 32;
  const int* r = uses_filtered(mode, n, is_luma) ? sf : su;
  int v;
  if (mode == 0) {               // planar
    v = ((n - 1 - x) * r[2 * n - 1 - y] + (x + 1) * r[3 * n + 1] +
         (n - 1 - y) * r[2 * n + 1 + x] + (y + 1) * r[n - 1] + n) >>
        (log2n + 1);
  } else if (mode == 1) {        // DC
    v = dc;
    if (edge) {
      if (y == 0 && x == 0)
        v = (su[2 * n - 1] + 2 * dc + su[2 * n + 1] + 2) >> 2;
      else if (x == 0)
        v = (su[2 * n - 1 - y] + 3 * dc + 2) >> 2;
      else if (y == 0)
        v = (su[2 * n + 1 + x] + 3 * dc + 2) >> 2;
    }
  } else {                       // angular
    const int a = kAngles[mode - 2];
    const int inv = inv_angle(a);
    const bool vert = mode >= 18;
    const int major = vert ? y : x;
    const int minor = vert ? x : y;
    const int ii = ((major + 1) * a) >> 5;
    const int ff = ((major + 1) * a) & 31;
    const int t0 = minor + ii + 1;
    const int t1 = imin(t0 + 1, 2 * n);
    int i0, i1;
    if (vert) {
      i0 = t0 >= 0 ? 2 * n + t0 : 2 * n - ((t0 * inv + 128) >> 8);
      i1 = t1 >= 0 ? 2 * n + t1 : 2 * n - ((t1 * inv + 128) >> 8);
    } else {
      i0 = t0 >= 0 ? 2 * n - t0 : 2 * n + ((t0 * inv + 128) >> 8);
      i1 = t1 >= 0 ? 2 * n - t1 : 2 * n + ((t1 * inv + 128) >> 8);
    }
    v = ((32 - ff) * r[i0] + ff * r[i1] + 16) >> 5;
    if (edge && mode == 26 && x == 0)
      v = iclamp(su[2 * n + 1] + ((su[2 * n - 1 - y] - su[2 * n]) >> 1), 0,
                 maxv);
    if (edge && mode == 10 && y == 0)
      v = iclamp(su[2 * n - 1] + ((su[2 * n + 1 + x] - su[2 * n]) >> 1), 0,
                 maxv);
  }
  return v;
}

}  // namespace hm
