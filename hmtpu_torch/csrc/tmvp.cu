// K24 tmvp_grid: the collocated candidates of one CU grid of a P frame
// (the 8, 16 or padded 32 grid) and their scalings to reference 0 and to
// each block's reference, in one launch; the port of
// hmtpu/search/wavefront.py:634 temporal_cand_grid_dev and :624
// scale_mv_pair_dev as hmtpu/encoder/pframe_dev.py:381 `t_level` composes
// them.  The lane code is tmvp.cuh.
//
// What bounds it on the H100: neither roofline.  A block reads two
// collocated rows (4 ints each), its reference index and two POCs, and
// writes 5 ints; a few dozen integer operations.  The plain version runs
// the composition as about 60 small torch operations a grid; the kernel
// is one launch, one thread per block, everything in registers.
#include <cuda_runtime.h>

#include "tmvp.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void tmvp_kernel(const __grid_constant__ tmvp::Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.gw * a.gh) tmvp::tmvp_lane(a, i);
}

}  // namespace

extern "C" int hm_tmvp_grid(const void* col_mvx, const void* col_mvy,
                            const void* col_ok, const void* col_poc,
                            const void* aref, const void* ref_pocs, void* out,
                            int n, int gw, int gh, int w, int h, int log2_ctu,
                            int cur_poc, int col_pic_poc, int R,
                            void* stream) {
  if (gw < 1 || gh < 1 || R < 1 || w < 8 || h < 8 || n < 8)
    return cudaErrorInvalidValue;
  const tmvp::Args a{(const int*)col_mvx, (const int*)col_mvy,
                     (const int*)col_ok,  (const int*)col_poc,
                     (const int*)aref,    (const int*)ref_pocs,
                     (int*)out,           n,
                     gw,                  gh,
                     w,                   h,
                     log2_ctu,            cur_poc,
                     col_pic_poc,         R};
  const int P = gw * gh;
  tmvp_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0,
                (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
