// K12's per-sample arithmetic, shared by its entry point (bi_pred.cu) and
// the B z-scan walker K26 (bwalk.cuh): one sample of the bi-prediction
// average or of the merge screening's approximate uni prediction
// (hmtpu/ops/interp.py:295 bi_average_t; hmtpu/encoder/pframe_dev.py:292
// apx_uni, :440-444), from the two intermediate-precision hypotheses:
//   dir == 3: clip((i0 + i1 + (1 << (14 - bd)) + 2 * 8192) >> (15 - bd))
//   else:     clip((i + 8192 + (1 << (13 - bd))) >> (14 - bd)), with i
//             = i0 where dir & 1 (list 0), else i1.
// Signed ints, arithmetic shifts.  Compiles as host C++ too.
#pragma once

#include "hm_port.cuh"

namespace hm {

HM_HD int bi_pred_sample(int i0, int i1, int dir, int bd) {
  const int shift = 15 - bd;
  const int headroom = 14 - bd;
  const int maxv = (1 << bd) - 1;
  int v;
  if (dir == 3) {
    v = (i0 + i1 + (1 << (shift - 1)) + 2 * 8192) >> shift;
  } else {
    v = ((dir & 1) ? i0 : i1) + 8192 + (1 << (headroom - 1));
    v >>= headroom;
  }
  return v < 0 ? 0 : v > maxv ? maxv : v;
}

}  // namespace hm
