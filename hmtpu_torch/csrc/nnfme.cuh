// The NN-FME MLP's forward shared by K6 (nnfme.cu, inference) and K14 /
// K15 (nnfme_train.cu over nnfme_train.cuh, training): the packed layout
// (PACK_ORDER), the size -> embedding-row tables, the standardised
// features, one output unit of a dense layer, the ReLU + affine, the
// logits and their first-index argmax, with separately rounded multiply
// and add (no FMA contraction), every dot product in ascending k.  A row
// runs on a warp, one output unit a lane (`forward_lanes`); K6 and K14
// call the same functions, so K6's logits are the training forward's bit
// for bit.  On hm_port.cuh's terms: compiles as host C++ too, where
// `infer_host` runs K6's rows on one thread, lanes in order or reversed.
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

// one output unit: bias + the sum over ascending k of in(k) w[k], w the
// unit's row of a row-major (N, K) weight
template <int K, class In>
HM_FN float dense_unit(In in, const float* w, float b) {
  float acc = 0.0f;
  HM_UNROLL
  for (int k = 0; k < K; ++k) acc = HM_FADD(acc, HM_FMUL(in(k), w[k]));
  return HM_FADD(acc, b);
}

// max(z, 0) g + beta
HM_FN float relu_affine(float z, float g, float beta) {
  return HM_FADD(HM_FMUL(fmaxf(z, 0.0f), g), beta);
}

// ---------------------------------------------------------------------------
// A row on a warp, one output unit a lane (K6, K14, K15)

using L32 = hm::Lanes<float, 32>;

// the 17 features on lanes 0-16 from cost k - 8 on lane k in 8-16 (c),
// and u and v of cost k - 8 on lane k in 8-16 (lanes 17-31 repeat
// feature 16)
HM_FN void feature_lanes(const float* p, const L32& c, int rh, int rw,
                         L32& f, L32& u, L32& v) {
  HM_LANES(k, 32) {
    float uk = 0.0f, vk = 0.0f;
    f[k] = feature(p, c[k], rh, rw, hm::imin(k, 16), uk, vk);
    u[k] = uk;
    v[k] = vk;
  }
}

// unit j of the layer on lane j (j < N; lanes above repeat unit N - 1):
// dense_unit over the K inputs held on lanes 0..K-1
template <int K, int N>
HM_FN void dense_lanes(const L32& in, const float* w, const float* b,
                       L32& out) {
  HM_LANES(j, 32) {
    const int n = hm::imin(j, N - 1);
    out[j] = dense_unit<K>([&](int k) { return hm::lane_get(in, k); },
                           w + n * K, b[n]);
  }
}

// h = max(z, 0) g + beta on lanes 0..N-1
template <int N>
HM_FN void relu_affine_lanes(const L32& z, const float* g, const float* beta,
                             L32& h) {
  HM_LANES(j, 32) {
    const int n = hm::imin(j, N - 1);
    h[j] = relu_affine(z[j], g[n], beta[n]);
  }
}

// the 49 logits from h2 on lanes 0-19: unit j on lane j (lo), unit 32 + j
// on lanes 0-16 (hi)
HM_FN void logits_lanes(const float* p, const L32& h2, L32& lo, L32& hi) {
  HM_LANES(j, 32) {
    const auto x = [&](int k) { return hm::lane_get(h2, k); };
    lo[j] = dense_unit<20>(x, p + oW3 + j * 20, p[oB3 + j]);
    const int n = 32 + hm::imin(j, 16);
    hi[j] = dense_unit<20>(x, p + oW3 + n * 20, p[oB3 + n]);
  }
}

// the largest logit m and its first index: each lane's lower index on a
// tie, then the least (-logit, index) over the lanes
HM_FN void argmax_lanes(const L32& lo, const L32& hi, float& m, int& best) {
  hm::Lanes<float, 32> neg;
  hm::Lanes<int, 32> idx;
  HM_LANES(j, 32) {
    const bool up = j < 17 && hi[j] > lo[j];
    neg[j] = -(up ? hi[j] : lo[j]);
    idx[j] = up ? 32 + j : j;
  }
  float nm;
  hm::lane_argmin(neg, idx, nm, best);
  m = -nm;
}

// the forward of one row on a warp, its costs on lanes 8-16 (c): the
// pre-activations z1 (lanes 0-21) and z2 (lanes 0-19) and the logits (lo,
// hi as logits_lanes)
HM_FN void forward_lanes(const float* p, const L32& c, int rh, int rw,
                         L32& z1, L32& z2, L32& lo, L32& hi) {
  L32 f, u, v, h1, h2;
  feature_lanes(p, c, rh, rw, f, u, v);
  dense_lanes<17, 22>(f, p + oW1, p + oB1, z1);
  relu_affine_lanes<22>(z1, p + oG1, p + oBeta1, h1);
  dense_lanes<22, 20>(h1, p + oW2, p + oB2, z2);
  relu_affine_lanes<20>(z2, p + oG2, p + oBeta2, h2);
  logits_lanes(p, h2, lo, hi);
}

// ---------------------------------------------------------------------------
// K6: the rows of up to three levels (a CU grid's stencils each) in one
// launch.  Level l has rows[l] rows of 9 costs at costs[l], int32 (the
// stencils as ME gives them, each converted as `.to(torch.float32)` does:
// rounded to nearest) or float32; a row's embedding rows come from
// size[l] (both sides), or from per-row heights and widths where those
// are given (one level).  The outputs hold the levels' rows in turn.

struct Levels {
  const void* costs[3];
  int rows[3];
  int size[3];
  int n;               // levels
  int f32;             // the costs are float32
  const int* heights;  // per-row sizes (one level), or null
  const int* widths;
  float* logits;       // (rows, 49), or null
  int* cls;            // (rows,)
  int* offs;           // (rows, 2)
};

// row i's costs on lanes 8-16 and its embedding rows
// (the level by comparisons, not an index into the kernel's arguments)
HM_FN void load_costs(const Levels& a, int i, L32& c, int& rh, int& rw) {
  int r = i, size = a.size[0];
  const void* cost = a.costs[0];
  if (a.n > 1 && r >= a.rows[0]) {
    r -= a.rows[0];
    cost = a.costs[1];
    size = a.size[1];
    if (a.n > 2 && r >= a.rows[1]) {
      r -= a.rows[1];
      cost = a.costs[2];
      size = a.size[2];
    }
  }
  HM_LANES(k, 32) {
    const size_t e = (size_t)r * 9 + hm::iclamp(k - 8, 0, 8);
    c[k] = a.f32 ? ((const float*)cost)[e] : (float)((const int*)cost)[e];
  }
  rh = row_h(a.heights != nullptr ? a.heights[i] : size);
  rw = row_w(a.widths != nullptr ? a.widths[i] : size);
}

// row i on a warp: its logits (where wanted), class and offsets
HM_FN void infer_row(const float* p, const Levels& a, int i, const L32& c,
                     int rh, int rw) {
  L32 z1, z2, lo, hi;
  forward_lanes(p, c, rh, rw, z1, z2, lo, hi);
  float m;
  int best;
  argmax_lanes(lo, hi, m, best);
  HM_LANES(j, 32) {
    if (a.logits != nullptr) {
      a.logits[(size_t)i * 49 + j] = lo[j];
      if (j < 17) a.logits[(size_t)i * 49 + 32 + j] = hi[j];
    }
    if (j < 2) a.offs[2 * (size_t)i + j] = j == 0 ? best % 7 - 3
                                                  : best / 7 - 3;
    if (j == 2) a.cls[i] = best;
  }
}

#if !defined(__CUDACC__)
// K6 on one host thread: every row in turn
inline void infer_host(const float* p, const Levels& a) {
  int total = 0;
  for (int l = 0; l < a.n; ++l) total += a.rows[l];
  for (int i = 0; i < total; ++i) {
    L32 c;
    int rh, rw;
    load_costs(a, i, c, rh, rw);
    infer_row(p, a, i, c, rh, rw);
  }
}
#endif

}  // namespace nnfme
