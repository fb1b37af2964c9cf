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
// Design: one thread block of 128 threads per picture block; the block's
// line and its filtered form in shared memory; one thread per (mode, 8x8
// tile) item predicts its 64 samples into registers, subtracts the source
// and runs the 2D butterflies; per-mode sums and the top-k after barriers.
#include <cuda_runtime.h>

#include "i_rmd.cuh"

namespace {

constexpr int THREADS = 128;

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
