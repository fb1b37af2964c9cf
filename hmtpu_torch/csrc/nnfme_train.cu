// K14 nnfme_fwd, K15 nnfme_bwd and K16 adam: one NN-FME training step
// (hmtpu/models/train.py:46 train_step) on the card.
//
//   K14  the forward of loss_fn (:38): the 17->22->20->49 MLP of K6 over a
//        batch of rows, the softmax cross-entropy with integer labels as
//        optax computes it (the max subtracted, log-sum-exp, minus the
//        label's logit), the first-index argmax against the label, and,
//        for the backward, the logits' gradient of the mean loss and the
//        two hidden layers' pre-activations.  Per thread block, the sum of
//        its rows' losses and hits; a second kernel sums the blocks'
//        partials and divides by the batch: the mean loss and accuracy.
//   K15  the backward (jax.value_and_grad, :49): the gradient of all 2060
//        parameters (PACK_ORDER; mean, std and gin included) summed over
//        the batch, then the blocks' partials summed by the same second
//        kernel.
//   K16  optax.adam's update (:51-53), elementwise over the 2060.
//
// What bounds them on the H100: launch cost.  A step of batch 1024 moves
// about 0.7 MB (the rows, the saved activations and d-logits, 33 KB of
// per-block partials) and does about 15 M float32 operations: a few
// microseconds at either rate, under the 5-20 us a launch costs.  So the
// design keeps to one launch per stage (two kernels for the two-pass
// reductions) and puts its care in the arithmetic.
//
// Design.  K14 runs one thread per row, kRows rows per block, the packed
// parameters in shared memory, every dot product in ascending k with
// separately rounded multiply and add (no FMA): K6's forward, from the
// same code (nnfme.cuh), so its logits are K6's bit for bit.  K15 runs kRows rows per block of 256
// threads: first one thread per row recomputes the features and the
// post-activations from the saved pre-activations and propagates the
// d-logits back to every layer's input (ascending sums, no FMA), keeping
// the per-row vectors in shared memory; then every thread owns parameters
// and sums their per-row products over the block's rows in ascending row
// order.  The blocks' partials are summed in ascending block order by one
// thread per parameter: a fixed order with no atomics, so the card gives
// the same gradient bits on every run.  JAX's maximum(x, 0) passes 0.5 of
// the gradient at exactly x == 0; K15 does the same.  The embedding
// gradient goes only to the rows the size tables select (the height
// table keeps the reference's 16-before-12 order).  K16 follows optax's
// order of operations: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu,
// m^ = mu / bc1, v^ = nu / bc2 (bc = 1 - b^count, computed by the caller
// in float32), p = p + (-lr) m^ / (sqrt(v^) + eps), in place.
//
// K14's exp and log are not the library's expf / logf, whose last bit
// differs from the CPU's exp / log: hm_expf and hm_logf below (Cephes'
// expf / logf polynomials) round every operation on its own, and the
// plain version (models/train.py exp_f32 / log_f32) does the same
// operations, so K14 and its plain version agree bit for bit on the card
// and on the CPU alike.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nnfme.cuh"

namespace {

using namespace nnfme;

constexpr int kRows = 64;          // batch rows per thread block
constexpr int kBwdThreads = 256;

// e^x: x = k ln2 + r (ln2 in two parts), a degree-7 polynomial in r, times
// 2^k from its bits; 0 below x = -87 (e^-87 is 1.6e-38, just above the
// smallest normal float32); for x <= 88
__device__ __forceinline__ float hm_expf(float x) {
  if (x < -87.0f) return 0.0f;
  const float k = floorf(__fadd_rn(__fmul_rn(x, 1.44269504088896341f), 0.5f));
  const float r = __fsub_rn(__fsub_rn(x, __fmul_rn(k, 0.693359375f)),
                            __fmul_rn(k, -2.12194440e-4f));
  const float z = __fmul_rn(r, r);
  float y = __fadd_rn(__fmul_rn(r, 1.9875691500e-4f), 1.3981999507e-3f);
  y = __fadd_rn(__fmul_rn(y, r), 8.3334519073e-3f);
  y = __fadd_rn(__fmul_rn(y, r), 4.1665795894e-2f);
  y = __fadd_rn(__fmul_rn(y, r), 1.6666665459e-1f);
  y = __fadd_rn(__fmul_rn(y, r), 5.0000001201e-1f);
  y = __fadd_rn(__fadd_rn(__fmul_rn(y, z), r), 1.0f);
  return __fmul_rn(y, __int_as_float(((int)k + 127) << 23));
}

// log x for a positive normal x: x = m 2^e with m in [sqrt(1/2), sqrt(2)),
// a degree-9 polynomial in m - 1, plus e ln2 (in two parts)
__device__ __forceinline__ float hm_logf(float x) {
  const int b = __float_as_int(x);
  int e = (b >> 23) - 126;
  float m = __int_as_float((b & 0x007fffff) | 0x3f000000);
  if (m < 0.707106781186547524f) {
    e -= 1;
    m = __fsub_rn(__fadd_rn(m, m), 1.0f);
  } else {
    m = __fsub_rn(m, 1.0f);
  }
  const float z = __fmul_rn(m, m);
  float y = __fadd_rn(__fmul_rn(m, 7.0376836292e-2f), -1.1514610310e-1f);
  y = __fadd_rn(__fmul_rn(y, m), 1.1676998740e-1f);
  y = __fadd_rn(__fmul_rn(y, m), -1.2420140846e-1f);
  y = __fadd_rn(__fmul_rn(y, m), 1.4249322787e-1f);
  y = __fadd_rn(__fmul_rn(y, m), -1.6668057665e-1f);
  y = __fadd_rn(__fmul_rn(y, m), 2.0000714765e-1f);
  y = __fadd_rn(__fmul_rn(y, m), -2.4999993993e-1f);
  y = __fadd_rn(__fmul_rn(y, m), 3.3333331174e-1f);
  y = __fmul_rn(__fmul_rn(y, m), z);
  const float fe = (float)e;
  y = __fadd_rn(y, __fmul_rn(fe, -2.12194440e-4f));
  y = __fadd_rn(y, __fmul_rn(z, -0.5f));
  return __fadd_rn(__fadd_rn(m, y), __fmul_rn(fe, 0.693359375f));
}

__device__ __forceinline__ void load_pack(float* p, const float* pack) {
  for (int k = threadIdx.x; k < kPack; k += blockDim.x) p[k] = pack[k];
}

// d maximum(z, 0) / dz as JAX takes it: 1 above, 0.5 at exactly 0, 0 below
__device__ __forceinline__ float drelu(float z) {
  return z > 0.0f ? 1.0f : (z == 0.0f ? 0.5f : 0.0f);
}

__global__ void __launch_bounds__(kRows)
    fwd_kernel(const float* __restrict__ pack, const float* __restrict__ costs,
               const int* __restrict__ heights, const int* __restrict__ widths,
               const int* __restrict__ labels, float* __restrict__ z1o,
               float* __restrict__ z2o, float* __restrict__ dlo,
               float* __restrict__ part, int B, float inv_b) {
  __shared__ float p[kPack];
  __shared__ float sl[kRows], sc[kRows];
  load_pack(p, pack);
  __syncthreads();
  const int t = threadIdx.x;
  const int i = blockIdx.x * kRows + t;
  float loss = 0.0f, hit = 0.0f;
  if (i < B) {
    float feat[17], u[9], v[9], z1[22], h1[22], z2[20], h2[20], lg[49];
    features(p, costs + (size_t)i * 9, row_h(heights[i]), row_w(widths[i]),
             feat, u, v);
    dense<17, 22>(feat, p + oW1, p + oB1, z1);
    relu_affine(z1, p + oG1, p + oBeta1, h1, 22);
    dense<22, 20>(h1, p + oW2, p + oB2, z2);
    relu_affine(z2, p + oG2, p + oBeta2, h2, 20);
    dense<20, 49>(h2, p + oW3, p + oB3, lg);
    int best = 0;
    for (int j = 0; j < 49; ++j)
      if (lg[j] > lg[best]) best = j;
    const float m = lg[best];
    float s = 0.0f;
    for (int j = 0; j < 49; ++j)
      s = __fadd_rn(s, hm_expf(__fsub_rn(lg[j], m)));
    const int y = min(max(labels[i], 0), 48);
    loss = __fsub_rn(__fadd_rn(hm_logf(s), m), lg[y]);
    hit = best == y ? 1.0f : 0.0f;
    if (dlo != nullptr) {
      // d(mean loss)/d logit_j = exp(l_j - m) * ((1/B) / s) - [j == y] / B
      const float gs = __fdiv_rn(inv_b, s);
      for (int j = 0; j < 49; ++j) {
        float d = __fmul_rn(hm_expf(__fsub_rn(lg[j], m)), gs);
        if (j == y) d = __fadd_rn(d, -inv_b);
        dlo[(size_t)i * 49 + j] = d;
      }
      for (int j = 0; j < 22; ++j) z1o[(size_t)i * 22 + j] = z1[j];
      for (int j = 0; j < 20; ++j) z2o[(size_t)i * 20 + j] = z2[j];
    }
  }
  sl[t] = loss;
  sc[t] = hit;
  __syncthreads();
  if (t == 0) {
    float a = 0.0f, b = 0.0f;
    for (int r = 0; r < kRows; ++r) {
      a = __fadd_rn(a, sl[r]);
      b = __fadd_rn(b, sc[r]);
    }
    part[2 * blockIdx.x] = a;
    part[2 * blockIdx.x + 1] = b;
  }
}

// the per-row vectors K15 keeps in shared memory (floats, one row each)
constexpr int rDl = 0, rH2 = 49, rDz2 = 69, rDh2 = 89, rA2 = 109, rH1 = 129,
              rDz1 = 151, rDh1 = 173, rA1 = 195, rFeat = 217, rDf = 234,
              rTm = 242, rTs = 251, rTg = 260, kStride = 269;

// parameter j's share of one row's gradient
__device__ __forceinline__ float contrib(const float* q, int rh, int rw, int j) {
  if (j < oStd) return q[rTm + j];
  if (j < oGin) return q[rTs + j - oStd];
  if (j < oEmbH) return q[rTg + j - oGin];
  if (j < oEmbW) {
    const int e = j - oEmbH;
    return (e >> 2) == rh ? q[rDf + (e & 3)] : 0.0f;
  }
  if (j < oW1) {
    const int e = j - oEmbW;
    return (e >> 2) == rw ? q[rDf + 4 + (e & 3)] : 0.0f;
  }
  if (j < oB1) {
    const int e = j - oW1;
    return __fmul_rn(q[rDz1 + e / 17], q[rFeat + e % 17]);
  }
  if (j < oG1) return q[rDz1 + j - oB1];
  if (j < oBeta1) return __fmul_rn(q[rDh1 + j - oG1], q[rA1 + j - oG1]);
  if (j < oW2) return q[rDh1 + j - oBeta1];
  if (j < oB2) {
    const int e = j - oW2;
    return __fmul_rn(q[rDz2 + e / 22], q[rH1 + e % 22]);
  }
  if (j < oG2) return q[rDz2 + j - oB2];
  if (j < oBeta2) return __fmul_rn(q[rDh2 + j - oG2], q[rA2 + j - oG2]);
  if (j < oW3) return q[rDh2 + j - oBeta2];
  if (j < oB3) {
    const int e = j - oW3;
    return __fmul_rn(q[rDl + e / 20], q[rH2 + e % 20]);
  }
  return q[rDl + j - oB3];
}

__global__ void __launch_bounds__(kBwdThreads)
    bwd_kernel(const float* __restrict__ pack, const float* __restrict__ costs,
               const int* __restrict__ heights, const int* __restrict__ widths,
               const float* __restrict__ z1i, const float* __restrict__ z2i,
               const float* __restrict__ dli, const float* __restrict__ gscale,
               float* __restrict__ part, int B) {
  extern __shared__ float sm[];
  float* p = sm;                                  // kPack
  float* rows = p + kPack;                        // kRows x kStride
  int* rhs = (int*)(rows + kRows * kStride);      // kRows
  int* rws = rhs + kRows;                         // kRows
  load_pack(p, pack);
  __syncthreads();
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - r0);
  if (t < nrows) {
    const int i = r0 + t;
    float* q = rows + t * kStride;
    const int rh = row_h(heights[i]);
    const int rw = row_w(widths[i]);
    rhs[t] = rh;
    rws[t] = rw;
    float feat[17], u[9], v[9];
    features(p, costs + (size_t)i * 9, rh, rw, feat, u, v);
    for (int k = 0; k < 17; ++k) q[rFeat + k] = feat[k];
    for (int j = 0; j < 22; ++j) {
      const float a = fmaxf(z1i[(size_t)i * 22 + j], 0.0f);
      q[rA1 + j] = a;
      q[rH1 + j] = __fadd_rn(__fmul_rn(a, p[oG1 + j]), p[oBeta1 + j]);
    }
    for (int j = 0; j < 20; ++j) {
      const float a = fmaxf(z2i[(size_t)i * 20 + j], 0.0f);
      q[rA2 + j] = a;
      q[rH2 + j] = __fadd_rn(__fmul_rn(a, p[oG2 + j]), p[oBeta2 + j]);
    }
    const float gsc = *gscale;   // the loss's cotangent (1 for a step)
    for (int j = 0; j < 49; ++j) q[rDl + j] = __fmul_rn(dli[(size_t)i * 49 + j], gsc);
    // layer 3 back: dh2 = dl W3, then through the affine and the ReLU
    for (int k = 0; k < 20; ++k) {
      float acc = 0.0f;
      for (int j = 0; j < 49; ++j)
        acc = __fadd_rn(acc, __fmul_rn(q[rDl + j], p[oW3 + j * 20 + k]));
      q[rDh2 + k] = acc;
      q[rDz2 + k] = __fmul_rn(__fmul_rn(acc, p[oG2 + k]),
                              drelu(z2i[(size_t)i * 20 + k]));
    }
    for (int k = 0; k < 22; ++k) {
      float acc = 0.0f;
      for (int j = 0; j < 20; ++j)
        acc = __fadd_rn(acc, __fmul_rn(q[rDz2 + j], p[oW2 + j * 22 + k]));
      q[rDh1 + k] = acc;
      q[rDz1 + k] = __fmul_rn(__fmul_rn(acc, p[oG1 + k]),
                              drelu(z1i[(size_t)i * 22 + k]));
    }
    float df[17];
    for (int k = 0; k < 17; ++k) {
      float acc = 0.0f;
      for (int j = 0; j < 22; ++j)
        acc = __fadd_rn(acc, __fmul_rn(q[rDz1 + j], p[oW1 + j * 17 + k]));
      df[k] = acc;
    }
    for (int k = 0; k < 8; ++k) q[rDf + k] = df[k];
    // x = (c - mean) / std * gin: d gin = dx v; dv = dx gin; d mean = -dv /
    // std; d std = -((dv / std^2) u), 1 / std^2 as 1 / (std std)
    for (int k = 0; k < 9; ++k) {
      const float dx = df[8 + k];
      const float dv = __fmul_rn(dx, p[oGin + k]);
      const float sd = p[oStd + k];
      q[rTm + k] = -__fdiv_rn(dv, sd);
      q[rTs + k] = -__fmul_rn(__fmul_rn(dv, __fdiv_rn(1.0f, __fmul_rn(sd, sd))), u[k]);
      q[rTg + k] = __fmul_rn(dx, v[k]);
    }
  }
  __syncthreads();
  for (int j = t; j < kPack; j += kBwdThreads) {
    float acc = 0.0f;
    for (int r = 0; r < nrows; ++r)
      acc = __fadd_rn(acc, contrib(rows + r * kStride, rhs[r], rws[r], j));
    part[(size_t)blockIdx.x * kPack + j] = acc;
  }
}

// out[j] = sum over blocks b ascending of part[b][j] (divided by div > 0)
__global__ void colsum_kernel(const float* __restrict__ part,
                              float* __restrict__ out, int nb, int n,
                              float div) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float a = 0.0f;
  for (int b = 0; b < nb; ++b) a = __fadd_rn(a, part[(size_t)b * n + j]);
  out[j] = div > 0.0f ? __fdiv_rn(a, div) : a;
}

__global__ void adam_kernel(float* __restrict__ prm, const float* __restrict__ g,
                            float* __restrict__ mu, float* __restrict__ nu,
                            float b1, float omb1, float b2, float omb2,
                            float bc1, float bc2, float eps, float neg_lr,
                            int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const float gj = g[j];
  const float m = __fadd_rn(__fmul_rn(omb1, gj), __fmul_rn(b1, mu[j]));
  const float v = __fadd_rn(__fmul_rn(omb2, __fmul_rn(gj, gj)), __fmul_rn(b2, nu[j]));
  mu[j] = m;
  nu[j] = v;
  const float u = __fdiv_rn(__fdiv_rn(m, bc1),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), eps));
  prm[j] = __fadd_rn(prm[j], __fmul_rn(neg_lr, u));
}

}  // namespace

// K14: z1 / z2 / dl null for the loss and accuracy alone (validation);
// part has 2 floats per block of kRows rows, out 2 (mean loss, accuracy)
extern "C" int hm_nnfme_fwd(const void* pack, const void* costs,
                            const void* heights, const void* widths,
                            const void* labels, void* z1, void* z2, void* dl,
                            void* part, void* out, int B, float inv_b,
                            void* stream) {
  if (B <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = (B + kRows - 1) / kRows;
  fwd_kernel<<<nb, kRows, 0, s>>>(
      (const float*)pack, (const float*)costs, (const int*)heights,
      (const int*)widths, (const int*)labels, (float*)z1, (float*)z2,
      (float*)dl, (float*)part, B, inv_b);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  colsum_kernel<<<1, 32, 0, s>>>((const float*)part, (float*)out, nb, 2,
                                 (float)B);
  return (int)cudaGetLastError();
}

// K15: part has kPack floats per block of kRows rows, grad kPack
extern "C" int hm_nnfme_bwd(const void* pack, const void* costs,
                            const void* heights, const void* widths,
                            const void* z1, const void* z2, const void* dl,
                            const void* gscale, void* part, void* grad, int B,
                            void* stream) {
  if (B <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)(kPack + kRows * kStride) * sizeof(float)
                      + (size_t)2 * kRows * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nb = (B + kRows - 1) / kRows;
  bwd_kernel<<<nb, kBwdThreads, smem, s>>>(
      (const float*)pack, (const float*)costs, (const int*)heights,
      (const int*)widths, (const float*)z1, (const float*)z2,
      (const float*)dl, (const float*)gscale, (float*)part, B);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  colsum_kernel<<<(kPack + 255) / 256, 256, 0, s>>>(
      (const float*)part, (float*)grad, nb, kPack, 0.0f);
  return (int)cudaGetLastError();
}

// K16: params, mu and nu updated in place
extern "C" int hm_adam(void* prm, const void* grad, void* mu, void* nu,
                       float b1, float omb1, float b2, float omb2, float bc1,
                       float bc2, float eps, float neg_lr, int n,
                       void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  adam_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (float*)prm, (const float*)grad, (float*)mu, (float*)nu, b1, omb1, b2,
      omb2, bc1, bc2, eps, neg_lr, n);
  return (int)cudaGetLastError();
}
