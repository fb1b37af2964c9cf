// Pieces shared by the motion kernels: the 8-tap luma DCT-IF taps and
// the interpolation precision constants of H.265 8.5.4.2.2 (K7
// mc_dctif.cu, K9 frac_refine.cu), and the 8-point Walsh-Hadamard
// butterflies of HM's 8x8 SATD (K8 satd.cu, K9).  The taps also serve
// mc_dctif.cuh, which compiles as host C++ too.
#pragma once

#include "hm_port.cuh"

namespace hm {

// Luma 8-tap DCT-IF, quarter-pel phases 0..3 (H.265 Table 8-11)
HM_CONST int kLuma[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};

constexpr int IF_FILTER_PREC = 6;
constexpr int IF_INTERNAL_PREC = 14;
constexpr int IF_INTERNAL_OFFS = 1 << (IF_INTERNAL_PREC - 1);

// in place: v <- v H8 (the Sylvester-ordered Hadamard matrix of the
// reference's xCalcHADs8x8)
HM_FN void fwht8(int* v) {
#pragma unroll
  for (int h = 1; h < 8; h <<= 1)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if ((i & h) == 0) {
        const int a = v[i], b = v[i + h];
        v[i] = a + b;
        v[i + h] = a - b;
      }
}

}  // namespace hm
