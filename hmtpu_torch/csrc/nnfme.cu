// K6 nnfme: the NN-FME MLP over a batch of PUs, the replacement for
// hmtpu/models/nnfme.py:127 forward and :143 predict_offsets: input
// standardisation and the two size-embedding rows, the 17->22->20->49
// layers with ReLU and the batch-norm affine, the argmax over the 49
// quarter-pel classes (first index on ties) and its offsets
// (cls % 7 - 3, cls / 7 - 3).
//
// What bounds it on the H100: launch cost.  A call is one CU level of a
// frame (1560 / 390 / 104 PUs at 416x240), about 2,060 multiply-adds
// per PU against 2,060 weights (8 KB, packed once when they load) read
// once per block, and 3 outputs per PU (49 logits more only when the
// caller passes a logits pointer): microseconds of work at either rate.
//
// Design: one thread per PU, the packed weights in shared memory (every
// thread of a block reads the same weight at the same time: a
// broadcast).  Every dot product is summed in ascending k order with one
// rounded multiply and one rounded add per term (__fmul_rn, __fadd_rn:
// no FMA contraction) and the standardisation with __fsub_rn /
// __fdiv_rn / __fmul_rn, so the plain PyTorch version (the same loop)
// gives the same bits on the card and on the CPU.  That arithmetic lives
// in nnfme.cuh, which K14 (nnfme_train.cu) shares.
#include <cuda_runtime.h>
#include <stdint.h>

#include "nnfme.cuh"

namespace {

using namespace nnfme;

__global__ void nnfme_kernel(const float* __restrict__ pack,
                             const float* __restrict__ costs,
                             const int* __restrict__ heights,
                             const int* __restrict__ widths,
                             float* __restrict__ logits, int* __restrict__ cls,
                             int* __restrict__ offs, int nb) {
  __shared__ float p[kPack];
  for (int k = threadIdx.x; k < kPack; k += blockDim.x) p[k] = pack[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nb) return;

  float feat[17], u[9], v[9], h1[22], h2[20], lg[49];
  features(p, costs + (size_t)i * 9, row_h(heights[i]), row_w(widths[i]),
           feat, u, v);
  dense<17, 22>(feat, p + oW1, p + oB1, h1);
  relu_affine(h1, p + oG1, p + oBeta1, h1, 22);
  dense<22, 20>(h1, p + oW2, p + oB2, h2);
  relu_affine(h2, p + oG2, p + oBeta2, h2, 20);
  dense<20, 49>(h2, p + oW3, p + oB3, lg);

  int best = 0;
  for (int j = 0; j < 49; ++j)
    if (lg[j] > lg[best]) best = j;
  if (logits != nullptr)  // null when the caller wants only the classes
    for (int j = 0; j < 49; ++j) logits[(size_t)i * 49 + j] = lg[j];
  cls[i] = best;
  offs[2 * i] = best % 7 - 3;
  offs[2 * i + 1] = best / 7 - 3;
}

}  // namespace

extern "C" int hm_nnfme(const void* pack, const void* costs, const void* heights,
                        const void* widths, void* logits, void* cls, void* offs,
                        int nb, void* stream) {
  const int threads = 128;
  nnfme_kernel<<<(nb + threads - 1) / threads, threads, 0,
                 (cudaStream_t)stream>>>(
      (const float*)pack, (const float*)costs, (const int*)heights,
      (const int*)widths, (float*)logits, (int*)cls, (int*)offs, nb);
  return (int)cudaGetLastError();
}
