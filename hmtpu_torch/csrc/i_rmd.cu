// K22 i_rmd: the fused rough mode decision (ROADMAP queue B9), the port
// of hmtpu/encoder/iframe_dev.py:133-175 (`rmd`, `_topk_modes`) with
// hmtpu/encoder/intra_rdo.py:78 `_satd` and iframe_dev.py:94 `_satd4`:
// per picture block the k best of the 35 intra modes by SATD + lambda *
// flat mode bits, from source-sample reference lines.  The I pass calls it
// at n = 8, 16 and 32 with k = 2 and at n = 4 with k = 1; the P pass's
// open-loop intra mode (hmtpu/encoder/pframe_dev.py phase 1b) at n = 8
// with k = 1.  The lane code is i_rmd.cuh.
//
// What bounds it on the H100: operations.  A block reads its n x n source
// samples and a 4n+1 line and writes k ints; the work is 35 predictions
// and Hadamard transforms of n x n samples (about 35 * n * n * 30 integer
// operations), which the plain version spreads over a (P, 35, n, n)
// prediction tensor in device memory (1560 x 35 x 64 int32 = 14 MB at
// 416x240, n = 8).
//
// Design: one thread block of 7 warps per picture block; its line, the
// filtered line and its source samples in shared memory.  Each warp (a
// quarter-warp at n = 4) takes a mode in turn, predicts two samples a
// lane of each 8x8 (4x4) tile into registers, subtracts the source and
// runs the 2D butterflies as register and shuffle stages, reducing
// sum |.| over its lanes (i_rmd.cuh); the per-mode SATDs meet in shared
// memory, and one warp takes the top k by warp argmins.  At n = 8 the
// 35 modes are 5 a warp, and the 1,560 blocks of a 416x240 picture fill
// the card's 132 SMs.
#include <cuda_runtime.h>

#include "i_rmd.cuh"

namespace {

constexpr int THREADS = 7 * 32;

__global__ void __launch_bounds__(THREADS) rmd_kernel(rmd::Args a) {
  __shared__ int sm[rmd::R_INTS];
  rmd::rmd_block(a, blockIdx.x, threadIdx.x, blockDim.x, sm);
}

}  // namespace

extern "C" int hm_i_rmd(const void* plane, const void* sub, const void* none,
                        void* out, int nb, int w, int n, int bd, int strong,
                        int k, float lam_sqrt, void* stream) {
  if ((n != 4 && n != 8 && n != 16 && n != 32) || k < 1 || k > 35 || nb < 0)
    return cudaErrorInvalidValue;
  rmd::Args a;
  a.plane = (const int*)plane;
  a.sub = (const int*)sub;
  a.none = (const int*)none;
  a.out = (int*)out;
  a.w = w;
  a.n = n;
  a.bd = bd;
  a.strong = strong;
  a.k = k;
  a.lam_sqrt = lam_sqrt;
  if (nb > 0) rmd_kernel<<<nb, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
