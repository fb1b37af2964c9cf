// K20 mpm_bits: the intra luma mode's rate (prev_intra_luma_pred_flag +
// mpm_idx, or the 5-bit rem_intra_luma_pred_mode) with the 8.4.2 MPM list
// from the left and above modes, bit-exact with
// hmtpu/ops/ratebits.py:378 intra_mode_mpm_bits.  Two forms:
//   - one mode per lane, K candidate modes per CU sharing its neighbours
//     (the I pass's 8/16/32 levels, the P pass's intra arm);
//   - the NxN CU's four PUs in one lane (hmtpu/encoder/iframe_dev.py:353-356),
//     each PU's neighbours the earlier PUs' modes: ((a + b) + c) + d.
// Each bit count is rounded as the reference rounds it: (ctx + 1.0) +
// idx_gt0, or ctx + 5.0 (float32 additions, one at a time).
//
// What bounds it on the H100: neither bytes nor operations (three int32
// reads and one float32 write a lane, 1,560 x 35 lanes at most); a call is
// one short launch.  Design: one thread per lane, elementwise, over the
// functions of mode_bits.cuh (shared with the I z-scan walker K21).
#include <cuda_runtime.h>

#include "mode_bits.cuh"

namespace {

using hm::mpm_bits;

// mode: (N,) with N = lanes; lm / am: (N / K,): lane i reads entry i / K
__global__ void mpm_kernel(const float* __restrict__ tab,
                           const int* __restrict__ mode,
                           const int* __restrict__ lm,
                           const int* __restrict__ am,
                           float* __restrict__ out, int N, int K, int ctx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  out[i] = mpm_bits(tab, ctx, mode[i], lm[i / K], am[i / K]);
}

// m4: (N, 4) the PUs' modes in z-order; lm / am: (N,) the CU's neighbours
__global__ void mpm4_kernel(const float* __restrict__ tab,
                            const int* __restrict__ m4,
                            const int* __restrict__ lm,
                            const int* __restrict__ am,
                            float* __restrict__ out, int N, int ctx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  out[i] = hm::mpm_bits4(tab, ctx, m4 + 4 * i, lm[i], am[i]);
}

}  // namespace

extern "C" int hm_mpm_bits(const void* tab, const void* mode, const void* lm,
                           const void* am, void* out, int N, int K, int ctx,
                           void* stream) {
  if (N <= 0 || K < 1 || N % K) return cudaErrorInvalidValue;
  mpm_kernel<<<(N + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const float*)tab, (const int*)mode, (const int*)lm, (const int*)am,
      (float*)out, N, K, ctx);
  return (int)cudaGetLastError();
}

extern "C" int hm_mpm_bits4(const void* tab, const void* m4, const void* lm,
                            const void* am, void* out, int N, int ctx,
                            void* stream) {
  if (N <= 0) return cudaErrorInvalidValue;
  mpm4_kernel<<<(N + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const float*)tab, (const int*)m4, (const int*)lm, (const int*)am,
      (float*)out, N, ctx);
  return (int)cudaGetLastError();
}
