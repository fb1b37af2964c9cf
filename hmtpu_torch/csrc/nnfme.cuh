// The NN-FME MLP's forward pieces shared by K6 (nnfme.cu, inference) and
// K14 / K15 (nnfme_train.cu, training): the packed layout (PACK_ORDER),
// the size -> embedding-row tables, the standardised features, and the
// dense layer and ReLU + affine with separately rounded multiply and add
// (no FMA contraction), every dot product in ascending k.  One copy of
// this arithmetic keeps the training forward's logits K6's bit for bit.
#pragma once

namespace nnfme {

// the fields' offsets in the packed vector (PACK_ORDER)
constexpr int oMean = 0, oStd = 9, oGin = 18, oEmbH = 27, oEmbW = 59,
              oW1 = 91, oB1 = 465, oG1 = 487, oBeta1 = 509, oW2 = 531,
              oB2 = 971, oG2 = 991, oBeta2 = 1011, oW3 = 1031, oB3 = 2011;
constexpr int kPack = oB3 + 49;
static_assert(kPack == 9 * 3 + 32 * 2 + 22 * 17 + 22 * 3 + 20 * 22 +
                           20 * 3 + 49 * 20 + 49,
              "PACK_ORDER's size");

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

__device__ __forceinline__ int row_h(int h) { return kRowH[min(max(h, 0), 64)]; }
__device__ __forceinline__ int row_w(int w) { return kRowW[min(max(w, 0), 64)]; }

// the 17 features of packed parameters p and one row's 9 costs c, and
// the standardisation's u = c - mean, v = u / std (feature = v * gin)
__device__ __forceinline__ void features(const float* p, const float* c, int rh,
                                         int rw, float* feat, float* u,
                                         float* v) {
  for (int k = 0; k < 4; ++k) {
    feat[k] = p[oEmbH + rh * 4 + k];
    feat[4 + k] = p[oEmbW + rw * 4 + k];
  }
  for (int k = 0; k < 9; ++k) {
    u[k] = __fsub_rn(c[k], p[oMean + k]);
    v[k] = __fdiv_rn(u[k], p[oStd + k]);
    feat[8 + k] = __fmul_rn(v[k], p[oGin + k]);
  }
}

// out = in W^T + b, W row-major (N, K)
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

// h = max(z, 0) g + beta (h may be z)
__device__ __forceinline__ void relu_affine(const float* z, const float* g,
                                            const float* beta, float* h, int n) {
  for (int j = 0; j < n; ++j)
    h[j] = __fadd_rn(__fmul_rn(fmaxf(z[j], 0.0f), g[j]), beta[j]);
}

}  // namespace nnfme
