// K24 tmvp_grid: the collocated candidates of one CU grid of a P frame
// (the 8, 16 or padded 32 grid) and their scalings to reference 0 and to
// each block's reference, in one launch; the port of
// hmtpu/search/wavefront.py:634 temporal_cand_grid_dev and :624
// scale_mv_pair_dev as hmtpu/encoder/pframe_dev.py:381 `t_level` composes
// them; and the grids form, a P pass's three grids in one launch.  The
// lane code is tmvp.cuh.
//
// What bounds it on the H100: neither roofline.  A block reads two
// collocated rows (4 ints each), its reference index and two POCs, and
// writes 5 ints; a few dozen integer operations.  The plain version runs
// the composition as about 60 small torch operations a grid; the kernel
// is one launch, one thread per block, everything in registers, and the
// grids form one launch for the pass's three grids (the grid chosen by
// comparisons), so a P pass pays one launch's floor, not three.
#include <cuda_runtime.h>

#include "tmvp.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void tmvp_grids_kernel(const __grid_constant__ tmvp::Grids a) {
  tmvp::grids_lane(a, blockIdx.x * blockDim.x + threadIdx.x);
}

}  // namespace

// the collocated field (bh, bw) each of col_mvx, col_mvy, col_ok and
// col_poc, the L0 POCs ref_pocs (R,); one output of 5 * (P0 + P1 + P2)
// ints (grid l's (5, P_l) rows after the grids before it); each grid's
// references aref_l (P_l,) and (n, gw, gh)
extern "C" int hm_tmvp_grids(const void* col_mvx, const void* col_mvy,
                             const void* col_ok, const void* col_poc,
                             const void* ref_pocs, void* out,
                             const void* aref0, const void* aref1,
                             const void* aref2, int ngrids, int n0, int gw0,
                             int gh0, int n1, int gw1, int gh1, int n2,
                             int gw2, int gh2, int w, int h, int log2_ctu,
                             int cur_poc, int col_pic_poc, int R,
                             void* stream) {
  if (ngrids < 1 || ngrids > 3 || R < 1 || w < 8 || h < 8)
    return cudaErrorInvalidValue;
  const void* aref[3] = {aref0, aref1, aref2};
  const int geo[3][3] = {{n0, gw0, gh0}, {n1, gw1, gh1}, {n2, gw2, gh2}};
  tmvp::Grids a{};
  int total = 0;
  for (int l = 0; l < ngrids; ++l) {
    const int n = geo[l][0], gw = geo[l][1], gh = geo[l][2];
    if (gw < 1 || gh < 1 || n < 8) return cudaErrorInvalidValue;
    a.g[l] = tmvp::Args{(const int*)col_mvx, (const int*)col_mvy,
                        (const int*)col_ok,  (const int*)col_poc,
                        (const int*)aref[l], (const int*)ref_pocs,
                        (int*)out + 5 * total, n,
                        gw,                  gh,
                        w,                   h,
                        log2_ctu,            cur_poc,
                        col_pic_poc,         R};
    a.p[l] = gw * gh;
    total += gw * gh;
  }
  tmvp_grids_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// one grid: its references aref (gw * gh,), its output (5, gw * gh)
extern "C" int hm_tmvp_grid(const void* col_mvx, const void* col_mvy,
                            const void* col_ok, const void* col_poc,
                            const void* aref, const void* ref_pocs, void* out,
                            int n, int gw, int gh, int w, int h, int log2_ctu,
                            int cur_poc, int col_pic_poc, int R,
                            void* stream) {
  return hm_tmvp_grids(col_mvx, col_mvy, col_ok, col_poc, ref_pocs, out,
                       aref, nullptr, nullptr, 1, n, gw, gh, 0, 0, 0, 0, 0,
                       0, w, h, log2_ctu, cur_poc, col_pic_poc, R, stream);
}
