// K25 sao_choose: the per-CTU RD choice of SAO type, edge class or band
// position and the four offsets, for luma and the chroma pair (Cr under
// Cb's type and class), from K4's statistics in one launch; the port of
// hmtpu/ops/sao.py:305 _choose_params_dev with :267
// _offsets_and_delta_dev.  The lane code is sao_choose.cuh.
//
// What bounds it on the H100: neither roofline.  A CTU's three statistic
// rows are 1,152 bytes and its choice about 600 float32 operations; at
// 416x240 (28 CTUs) that is 32 KB and 17 k operations.  The plain version
// issues some 150 torch operations a plane; here the frame's choice is one
// launch, two threads per CTU (luma; Cb then Cr), everything in registers.
#include <cuda_runtime.h>

#include "sao_choose.cuh"

namespace {

constexpr int kThreads = 64;

__global__ void sao_choose_kernel(const int* __restrict__ st_y,
                                  const int* __restrict__ st_u,
                                  const int* __restrict__ st_v,
                                  const float* __restrict__ lam, int mo,
                                  int* __restrict__ out, int nctu) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 2 * nctu) saoc::choose_lane(st_y, st_u, st_v, *lam, mo, out, i);
}

}  // namespace

// st_*: (nctu, 96) int32 K4 statistics of luma, Cb and Cr; lam: the
// device float32 lambda; out (nctu, 3, 7) int32
extern "C" int hm_sao_choose(const void* st_y, const void* st_u,
                             const void* st_v, const void* lam, void* out,
                             int nctu, int mo, void* stream) {
  if (nctu < 1 || mo < 1 || !lam) return cudaErrorInvalidValue;
  sao_choose_kernel<<<(2 * nctu + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const int*)st_y, (const int*)st_u, (const int*)st_v, (const float*)lam,
      mo, (int*)out, nctu);
  return (int)cudaGetLastError();
}
