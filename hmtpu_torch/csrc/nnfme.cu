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
// gives the same bits on the card and on the CPU.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPack = 9 * 3 + 32 * 2 + 22 * 17 + 22 * 3 + 20 * 22 + 20 * 3 +
                      49 * 20 + 49;

// size -> embedding row (the height table keeps the reference's
// 16-before-12 order)
__constant__ int kRowH[65] = {0, 0, 0, 0, 1, 0, 0, 0, 2, 0, 0, 0, 4, 0, 0, 0,
                              3, 0, 0, 0, 0, 0, 0, 0, 5, 0, 0, 0, 0, 0, 0, 0,
                              6, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                              0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                              7};
__constant__ int kRowW[65] = {0, 0, 0, 0, 1, 0, 0, 0, 2, 0, 0, 0, 3, 0, 0, 0,
                              4, 0, 0, 0, 0, 0, 0, 0, 5, 0, 0, 0, 0, 0, 0, 0,
                              6, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                              0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                              7};

template <int K, int N>
__device__ __forceinline__ void dense(const float* in, const float* w,
                                      const float* b, float* out) {
  for (int j = 0; j < N; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) acc = __fadd_rn(acc, __fmul_rn(in[k], w[j * K + k]));
    out[j] = __fadd_rn(acc, b[j]);
  }
}

__device__ __forceinline__ void relu_affine(float* h, const float* g,
                                            const float* beta, int n) {
  for (int j = 0; j < n; ++j)
    h[j] = __fadd_rn(__fmul_rn(fmaxf(h[j], 0.0f), g[j]), beta[j]);
}

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

  const float* mean = p;
  const float* stdv = mean + 9;
  const float* gin = stdv + 9;
  const float* emb_h = gin + 9;
  const float* emb_w = emb_h + 32;
  const float* w1 = emb_w + 32;
  const float* b1 = w1 + 22 * 17;
  const float* g1 = b1 + 22;
  const float* beta1 = g1 + 22;
  const float* w2 = beta1 + 22;
  const float* b2 = w2 + 20 * 22;
  const float* g2 = b2 + 20;
  const float* beta2 = g2 + 20;
  const float* w3 = beta2 + 20;
  const float* b3 = w3 + 49 * 20;

  float feat[17];
  const int rh = kRowH[min(max(heights[i], 0), 64)];
  const int rw = kRowW[min(max(widths[i], 0), 64)];
  for (int k = 0; k < 4; ++k) {
    feat[k] = emb_h[rh * 4 + k];
    feat[4 + k] = emb_w[rw * 4 + k];
  }
  for (int k = 0; k < 9; ++k)
    feat[8 + k] = __fmul_rn(
        __fdiv_rn(__fsub_rn(costs[(size_t)i * 9 + k], mean[k]), stdv[k]), gin[k]);

  float h1[22], h2[20], lg[49];
  dense<17, 22>(feat, w1, b1, h1);
  relu_affine(h1, g1, beta1, 22);
  dense<22, 20>(h1, w2, b2, h2);
  relu_affine(h2, g2, beta2, 20);
  dense<20, 49>(h2, w3, b3, lg);

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
