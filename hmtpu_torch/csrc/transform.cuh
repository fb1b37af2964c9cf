// K1's arithmetic, shared by its entry points (transform.cu) and the I
// z-scan walker (iwalk.cuh): the two-stage integer DCT / DST of H.265
// 8.6.4 and the 4x4 transform skip of 8.6.4.2, bit-exact with
// hmtpu/ops/transform.py:38, :58, :84 and :89.  Accumulation is int32:
// |sum| <= n * 90 * 2^15 < 2^31.
#pragma once

#include "hm_port.cuh"

namespace hm {

constexpr int COEFF_MIN = -(1 << 15);
constexpr int COEFF_MAX = (1 << 15) - 1;

// x * 2^-s rounded, or x * 2^-s exactly for s <= 0
HM_FN int rshift_round(int x, int s) {
  return s > 0 ? (x + (1 << (s - 1))) >> s : x * (1 << (-s));
}

HM_FN int clip16(int x) { return iclamp(x, COEFF_MIN, COEFF_MAX); }

// Stage 1 at (i, j) of one n x n TB: T the matrix, X the input.
//   forward: tmp[i][j] = sum_k T[i][k] * res[j][k]
//   inverse: tmp[i][j] = sum_k T[k][i] * coeff[k][j], clipped to 16 bits
template <bool INV>
HM_FN int tr_stage1(const int* T, const int* X, int n, int i, int j, int s1) {
  int acc = 0;
  if (!INV) {
    for (int k = 0; k < n; ++k) acc += T[i * n + k] * X[j * n + k];
    return rshift_round(acc, s1);
  }
  for (int k = 0; k < n; ++k) acc += T[k * n + i] * X[k * n + j];
  return clip16(rshift_round(acc, s1));
}

// Stage 2 at (i, j) from stage 1's TMP.
//   forward: coeff[i][j] = sum_k T[i][k] * tmp[j][k]
//   inverse: res[i][j] = sum_k tmp[i][k] * T[k][j], clipped to 16 bits
template <bool INV>
HM_FN int tr_stage2(const int* T, const int* TMP, int n, int i, int j,
                    int s2) {
  int acc = 0;
  if (!INV) {
    for (int k = 0; k < n; ++k) acc += T[i * n + k] * TMP[j * n + k];
    return rshift_round(acc, s2);
  }
  for (int k = 0; k < n; ++k) acc += TMP[i * n + k] * T[k * n + j];
  return clip16(rshift_round(acc, s2));
}

// transform skip: forward resi << ts_shift; inverse ((d << (5 + log2)) +
// (1 << (bdShift - 1))) >> bdShift, clipped to 16 bits
HM_FN int ts_fwd(int v, int s1) { return v * (1 << s1); }
HM_FN int ts_inv(int v, int s1, int s2) {
  return clip16((v * (1 << s1) + (1 << (s2 - 1))) >> s2);
}

// One whole TB, the block's threads cooperating: x -> out through tmp
// (three distinct buffers of n * n).  Ends with a barrier.
template <bool INV>
HM_FN void transform_tb(const int* T, const int* x, int* tmp, int* out, int n,
                        int s1, int s2, int tid, int nt) {
  const int nn = n * n;
  for (int e = tid; e < nn; e += nt)
    tmp[e] = tr_stage1<INV>(T, x, n, e / n, e % n, s1);
  HM_GSYNC(nt);
  for (int e = tid; e < nn; e += nt)
    out[e] = tr_stage2<INV>(T, tmp, n, e / n, e % n, s2);
  HM_GSYNC(nt);
}

}  // namespace hm
