// K12 bi_pred: the bi-prediction average and the B-slice merge
// screening select, fused (hmtpu/ops/interp.py:295 bi_average_t, and
// hmtpu/encoder/pframe_dev.py:440-444, the `pred_l` of merge_b_nxn with
// its `apx_uni` :292).  Per hypothesis pair n (of N, each S samples):
//   cdir[n] == 3: clip((i0 + i1 + (1 << (14 - bd)) + 2 * 8192) >> (15 - bd))
//   else:         clip((i + 8192 + (1 << (13 - bd))) >> (14 - bd)), with i
//                 = i0 where cdir & 1 (list 0), else i1.
// The same kernel with every cdir 3 is the exact bi-average of the merge
// winner (merge_b_winner).
//
// What bounds it on the H100: an elementwise pass, two int32 reads and
// one int32 write a sample and a handful of integer operations, so the
// bytes bound it; at the encoder's batch sizes (a few thousand to a few
// hundred thousand samples) the launch cost dominates both.
//
// Design: one thread a sample, a grid-stride loop, the pair's direction
// read once a sample from the (N,) vector (it stays in L1); the sample's
// arithmetic is bi_pred.cuh's, which K26 runs too.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bi_pred.cuh"

namespace {

__global__ void bi_pred_kernel(const int* __restrict__ i0,
                               const int* __restrict__ i1,
                               const int* __restrict__ cdir,
                               int* __restrict__ out, long long total, int S,
                               int bd) {
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < total; k += (long long)gridDim.x * blockDim.x)
    out[k] = hm::bi_pred_sample(i0[k], i1[k], cdir[k / S], bd);
}

}  // namespace

extern "C" int hm_bi_pred(const void* i0, const void* i1, const void* cdir,
                          void* out, int n, int S, int bd, void* stream) {
  if (n < 1 || S < 1 || bd < 8 || bd > 14) return cudaErrorInvalidValue;
  const long long total = (long long)n * S;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  bi_pred_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)i0, (const int*)i1, (const int*)cdir, (int*)out, total, S,
      bd);
  return (int)cudaGetLastError();
}
