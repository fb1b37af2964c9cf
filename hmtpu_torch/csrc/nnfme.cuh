// The NN-FME MLP's forward pieces shared by K6 (nnfme.cu, inference) and
// K14 / K15 (nnfme_train.cu over nnfme_train.cuh, training): the packed
// layout (PACK_ORDER), the size -> embedding-row tables, the standardised
// features, one output unit of a dense layer, and the ReLU + affine, with
// separately rounded multiply and add (no FMA contraction), every dot
// product in ascending k.  K6 runs them one thread per row (`features`,
// `dense<>`), K14 and K15 one lane per unit; both call `feature` and
// `dense_unit`, so the training forward's logits are K6's bit for bit.
// On hm_port.cuh's terms: compiles as host C++ too.
#pragma once

#include "hm_port.cuh"

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
HM_CONST int kRowH[65] = {0, 0, 0, 0, 1, 0, 0, 0, 2, 0, 0, 0, 4, 0, 0, 0,
                          3, 0, 0, 0, 0, 0, 0, 0, 5, 0, 0, 0, 0, 0, 0, 0,
                          6, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                          0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                          7};
HM_CONST int kRowW[65] = {0, 0, 0, 0, 1, 0, 0, 0, 2, 0, 0, 0, 3, 0, 0, 0,
                          4, 0, 0, 0, 0, 0, 0, 0, 5, 0, 0, 0, 0, 0, 0, 0,
                          6, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                          0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                          7};

HM_FN int row_h(int h) { return kRowH[hm::iclamp(h, 0, 64)]; }
HM_FN int row_w(int w) { return kRowW[hm::iclamp(w, 0, 64)]; }

// feature k (< 17) of packed parameters p and a row, ck its cost k - 8
// (for k >= 8); for k >= 8 also the standardisation's u = c - mean and
// v = u / std (feature = v * gin)
HM_FN float feature(const float* p, float ck, int rh, int rw, int k,
                    float& u, float& v) {
  if (k < 4) return p[oEmbH + rh * 4 + k];
  if (k < 8) return p[oEmbW + rw * 4 + k - 4];
  const int i = k - 8;
  u = HM_FSUB(ck, p[oMean + i]);
  v = HM_FDIV(u, p[oStd + i]);
  return HM_FMUL(v, p[oGin + i]);
}

// all 17 features of a row with 9 costs c, and u, v of the 9 costs
HM_FN void features(const float* p, const float* c, int rh, int rw,
                    float* feat, float* u, float* v) {
  for (int k = 0; k < 8; ++k)
    feat[k] = feature(p, 0.0f, rh, rw, k, u[0], v[0]);
  for (int k = 8; k < 17; ++k)
    feat[k] = feature(p, c[k - 8], rh, rw, k, u[k - 8], v[k - 8]);
}

// one output unit: bias + the sum over ascending k of in(k) w[k], w the
// unit's row of a row-major (N, K) weight
template <int K, class In>
HM_FN float dense_unit(In in, const float* w, float b) {
  float acc = 0.0f;
  HM_UNROLL
  for (int k = 0; k < K; ++k) acc = HM_FADD(acc, HM_FMUL(in(k), w[k]));
  return HM_FADD(acc, b);
}

// out = in W^T + b, W row-major (N, K)
template <int K, int N>
HM_FN void dense(const float* in, const float* w, const float* b,
                 float* out) {
  for (int j = 0; j < N; ++j)
    out[j] = dense_unit<K>([&](int k) { return in[k]; }, w + j * K, b[j]);
}

// max(z, 0) g + beta
HM_FN float relu_affine(float z, float g, float beta) {
  return HM_FADD(HM_FMUL(fmaxf(z, 0.0f), g), beta);
}

// h = max(z, 0) g + beta (h may be z)
HM_FN void relu_affine(const float* z, const float* g, const float* beta,
                       float* h, int n) {
  for (int j = 0; j < n; ++j) h[j] = relu_affine(z[j], g[j], beta[j]);
}

}  // namespace nnfme
