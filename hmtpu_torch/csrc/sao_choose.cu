// K25 sao_choose: the per-CTU RD choice of SAO type, edge class or band
// position and the four offsets, for luma and the chroma pair (Cr under
// Cb's type and class), from K4's statistics in one launch; the port of
// hmtpu/ops/sao.py:305 _choose_params_dev with :267
// _offsets_and_delta_dev.  The lane code is sao_choose.cuh.
//
// What bounds it on the H100: neither roofline.  A CTU's three statistic
// rows are 1,152 bytes and its choice about 600 float32 operations; at
// 416x240 (28 CTUs) that is 32 KB and 17 k operations.  A thread that
// runs a plane's 48 offset choices (each a division and about 12
// dependent operations) and 29 band runs in series is a chain of some
// 700 dependent steps; two planes in series twice that.
//
// Design: a warp per (CTU, plane), a CTU's three warps a block.  Lane b
// takes band b and (b < 16) edge class b >> 2's category b & 3: two
// offset choices a lane; the classes' sums, the band runs and both
// argmins are shuffles.  The Cb warp leaves its type and class in shared
// memory; the Cr warp computes its candidates beside it and reads them
// after the block's one barrier.
#include <cuda_runtime.h>

#include "sao_choose.cuh"

namespace {

__global__ void __launch_bounds__(96)
    sao_choose_kernel(const int* __restrict__ st_y,
                      const int* __restrict__ st_u,
                      const int* __restrict__ st_v,
                      const float* __restrict__ lam, int mo,
                      int* __restrict__ out) {
  __shared__ int cb[2];
  const int ctu = blockIdx.x, plane = threadIdx.x >> 5;
  const int* st = (plane == 0 ? st_y : plane == 1 ? st_u : st_v) +
                  (size_t)ctu * saoc::ROW;
  saoc::Cand c;
  saoc::candidates(st, *lam, mo, c);
  int* o = out + (size_t)ctu * 21 + plane * 7;
  int typ, cls;
  if (plane < 2) {
    saoc::decide(c, -1, -1, o, typ, cls);
    if (plane == 1 && threadIdx.x == 32) {
      cb[0] = typ;
      cb[1] = cls;
    }
  }
  __syncthreads();
  if (plane == 2) saoc::decide(c, cb[0], cb[1], o, typ, cls);
}

}  // namespace

// st_*: (nctu, 96) int32 K4 statistics of luma, Cb and Cr; lam: the
// device float32 lambda; out (nctu, 3, 7) int32
extern "C" int hm_sao_choose(const void* st_y, const void* st_u,
                             const void* st_v, const void* lam, void* out,
                             int nctu, int mo, void* stream) {
  if (nctu < 1 || mo < 1 || !lam) return cudaErrorInvalidValue;
  sao_choose_kernel<<<nctu, 96, 0, (cudaStream_t)stream>>>(
      (const int*)st_y, (const int*)st_u, (const int*)st_v, (const float*)lam,
      mo, (int*)out);
  return (int)cudaGetLastError();
}
