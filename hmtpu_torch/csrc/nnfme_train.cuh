// The lane code of K14 nnfme_fwd and K15 nnfme_bwd (nnfme_train.cu), on
// hm_port.cuh's terms, so that it also compiles as host C++: a row of the
// batch on a warp, one output unit a lane; a block's rows summed per
// parameter (`param_sum`); the blocks' partials of 32 parameters staged
// in shared memory by (tid, nt) threads, then summed in ascending block
// order, a parameter a lane.  `fwd_host` and `bwd_host` run the same functions on
// one host thread (tests/test_torch_nnfme_lanes.py holds them to
// models/train.py's plain versions, lanes in order and reversed).
//
// The order of every sum is the plain versions': each output unit's dot
// product in ascending k from 0 (nnfme.cuh `forward_lanes`: K6's), the
// softmax's 49 terms in ascending j from 0 on every lane, the d-vectors'
// sums in ascending j from 0; a parameter's gradient summed over the
// KROWS rows of a block in ascending row order from 0 (models/train.py
// `_block_sums`), then over the blocks in ascending order from 0
// (`_col_sum`).  A lane reads another lane's value only through
// `lane_get` of a value a former HM_LANES loop finished (on the card a
// shuffle), never through memory a lane of the same loop writes.
//
// Every global load a thread makes is issued in batches (`stage_in`,
// `chunk_sums`, the row's inputs ahead of the parameters' barrier): a
// load of another block's store goes to L2, so a loop that waits on each
// load in turn is what costs.
//
// K16, optax.adam's update, is K15's tail (`AdamTail`): the lane that
// finishes a parameter's gradient in `chunk_sums` updates the parameter
// and its two moments, with the bias corrections of the step read from
// a table by the step count (`adam_one`, `AdamArgs`).
#pragma once

#include <math.h>
#if !defined(__CUDACC__)
#include <string.h>
#include <vector>
#endif

#include "hm_port.cuh"
#include "nnfme.cuh"

namespace nnt {

using namespace nnfme;
using hm::Lanes;
using hm::imin;
using hm::lane_get;

// batch rows a thread block, one a warp (models/train.py KROWS)
constexpr int KROWS = 8;
constexpr int kThreads = KROWS * 32;
// loads a thread keeps in flight when it stages memory; the staging
// tile of the blocks' partials (floats: 128 blocks of 32 parameters and
// a pad column)
constexpr int kLdBatch = 16;
constexpr int kTile = 128 * 33;

#if defined(__CUDACC__)
HM_FN float bits_float(int b) { return __int_as_float(b); }
HM_FN int float_bits(float x) { return __float_as_int(x); }
// another block's store, read past this SM's L1
#define NNT_LD_OTHER(p) __ldcg(p)
#else
inline float bits_float(int b) {
  float x;
  memcpy(&x, &b, sizeof x);
  return x;
}
inline int float_bits(float x) {
  int b;
  memcpy(&b, &x, sizeof b);
  return b;
}
#define NNT_LD_OTHER(p) (*(p))
#endif

// e^x: x = k ln2 + r (ln2 in two parts), a degree-7 polynomial in r, times
// 2^k from its bits; 0 below x = -87 (e^-87 is 1.6e-38, just above the
// smallest normal float32); for x <= 88.  Cephes' expf with every
// operation rounded on its own: models/train.py exp_f32 does the same
// operations, where the library's expf differs from the CPU's in the last
// bit
HM_FN float hm_expf(float x) {
  if (x < -87.0f) return 0.0f;
  const float k = floorf(HM_FADD(HM_FMUL(x, 1.44269504088896341f), 0.5f));
  const float r = HM_FSUB(HM_FSUB(x, HM_FMUL(k, 0.693359375f)),
                          HM_FMUL(k, -2.12194440e-4f));
  const float z = HM_FMUL(r, r);
  float y = HM_FADD(HM_FMUL(r, 1.9875691500e-4f), 1.3981999507e-3f);
  y = HM_FADD(HM_FMUL(y, r), 8.3334519073e-3f);
  y = HM_FADD(HM_FMUL(y, r), 4.1665795894e-2f);
  y = HM_FADD(HM_FMUL(y, r), 1.6666665459e-1f);
  y = HM_FADD(HM_FMUL(y, r), 5.0000001201e-1f);
  y = HM_FADD(HM_FADD(HM_FMUL(y, z), r), 1.0f);
  return HM_FMUL(y, bits_float(((int)k + 127) << 23));
}

// log x for a positive normal x: x = m 2^e with m in [sqrt(1/2), sqrt(2)),
// a degree-9 polynomial in m - 1, plus e ln2 (in two parts); Cephes' logf
// rounded as models/train.py log_f32
HM_FN float hm_logf(float x) {
  const int b = float_bits(x);
  int e = (b >> 23) - 126;
  float m = bits_float((b & 0x007fffff) | 0x3f000000);
  if (m < 0.707106781186547524f) {
    e -= 1;
    m = HM_FSUB(HM_FADD(m, m), 1.0f);
  } else {
    m = HM_FSUB(m, 1.0f);
  }
  const float z = HM_FMUL(m, m);
  float y = HM_FADD(HM_FMUL(m, 7.0376836292e-2f), -1.1514610310e-1f);
  y = HM_FADD(HM_FMUL(y, m), 1.1676998740e-1f);
  y = HM_FADD(HM_FMUL(y, m), -1.2420140846e-1f);
  y = HM_FADD(HM_FMUL(y, m), 1.4249322787e-1f);
  y = HM_FADD(HM_FMUL(y, m), -1.6668057665e-1f);
  y = HM_FADD(HM_FMUL(y, m), 2.0000714765e-1f);
  y = HM_FADD(HM_FMUL(y, m), -2.4999993993e-1f);
  y = HM_FADD(HM_FMUL(y, m), 3.3333331174e-1f);
  y = HM_FMUL(HM_FMUL(y, m), z);
  const float fe = (float)e;
  y = HM_FADD(y, HM_FMUL(fe, -2.12194440e-4f));
  y = HM_FADD(y, HM_FMUL(z, -0.5f));
  return HM_FADD(HM_FADD(m, y), HM_FMUL(fe, 0.693359375f));
}

// d maximum(z, 0) / dz as JAX takes it: 1 above, 0.5 at exactly 0, 0 below
HM_FN float drelu(float z) {
  return z > 0.0f ? 1.0f : (z == 0.0f ? 0.5f : 0.0f);
}

// one row's inputs on a warp's lanes, loaded before the block's copy of
// the parameters is complete: cost k - 8 on lane k in 8-16, the size
// rows and the label; for K15 z1 (unit k on lane k), z2 and the
// d-logits (unit k on lane k of dlo, unit 32 + k on lanes 0-16 of dhi)
struct RowIn {
  L32 c, z1, z2, dlo, dhi;
  int rh, rw, label;
};

HM_FN void load_row(const float* costs, const int* heights,
                    const int* widths, const int* labels, const float* z1,
                    const float* z2, const float* dl, size_t i, RowIn& in) {
  HM_LANES(k, 32) {
    in.c[k] = costs[i * 9 + hm::iclamp(k - 8, 0, 8)];
    if (z1 != nullptr) {
      in.z1[k] = z1[i * 22 + imin(k, 21)];
      in.z2[k] = z2[i * 20 + imin(k, 19)];
      in.dlo[k] = dl[i * 49 + k];
      in.dhi[k] = dl[i * 49 + 32 + imin(k, 16)];
    }
  }
  in.rh = row_h(heights[i]);
  in.rw = row_w(widths[i]);
  in.label = labels != nullptr ? labels[i] : 0;
}

// s[k] = x[k] for k < n, kLdBatch loads in flight a thread; thread tid
// of nt
HM_FN void stage_in(const float* x, int n, float* s, int tid, int nt) {
  for (int k0 = tid; k0 < n; k0 += nt * kLdBatch) {
    float v[kLdBatch];
    HM_UNROLL
    for (int t = 0; t < kLdBatch; ++t) {
      const int k = k0 + t * nt;
      v[t] = k < n ? x[k] : 0.0f;
    }
    HM_UNROLL
    for (int t = 0; t < kLdBatch; ++t)
      if (k0 + t * nt < n) s[k0 + t * nt] = v[t];
  }
}

// ---------------------------------------------------------------------------
// K14: one row's forward, cross-entropy and hit on a warp; with dl, the
// row's d(mean loss)/d logits (49), z1 (22) and z2 (20) stored

HM_FN void fwd_row(const float* p, const RowIn& in, float inv_b, float* z1o,
                   float* z2o, float* dl, float& loss, float& hit) {
  L32 z1, z2, lo, hi;
  nnfme::forward_lanes(p, in.c, in.rh, in.rw, z1, z2, lo, hi);
  float m;
  int best;
  argmax_lanes(lo, hi, m, best);
  L32 elo, ehi;
  HM_LANES(j, 32) {
    elo[j] = hm_expf(HM_FSUB(lo[j], m));
    ehi[j] = hm_expf(HM_FSUB(hi[j], m));
  }
  // the softmax's sum in ascending j from 0, on every lane
  float s = 0.0f;
  HM_UNROLL
  for (int j = 0; j < 32; ++j) s = HM_FADD(s, lane_get(elo, j));
  HM_UNROLL
  for (int j = 0; j < 17; ++j) s = HM_FADD(s, lane_get(ehi, j));
  const int y = hm::iclamp(in.label, 0, 48);
  const float ly = y < 32 ? lane_get(lo, y) : lane_get(hi, y - 32);
  loss = HM_FSUB(HM_FADD(hm_logf(s), m), ly);
  hit = best == y ? 1.0f : 0.0f;
  if (dl == nullptr) return;
  // d(mean loss)/d logit_j = exp(l_j - m) * ((1/B) / s) - [j == y] / B
  const float gs = HM_FDIV(inv_b, s);
  HM_LANES(j, 32) {
    float d = HM_FMUL(elo[j], gs);
    if (j == y) d = HM_FADD(d, -inv_b);
    dl[j] = d;
    if (j < 17) {
      float d2 = HM_FMUL(ehi[j], gs);
      if (32 + j == y) d2 = HM_FADD(d2, -inv_b);
      dl[32 + j] = d2;
    }
    if (j < 22) z1o[j] = z1[j];
    if (j < 20) z2o[j] = z2[j];
  }
}

// a block's losses and hits summed in ascending row order from 0
HM_FN void block_sums(const float* sl, const float* sc, int nrows,
                      float* loss, float* hit) {
  float a = 0.0f, b = 0.0f;
  for (int r = 0; r < nrows; ++r) {
    a = HM_FADD(a, sl[r]);
    b = HM_FADD(b, sc[r]);
  }
  *loss = a;
  *hit = b;
}

// ---------------------------------------------------------------------------
// K15: one row's backward on a warp, into its row vector q (floats):
// every per-row factor of a parameter's gradient, one slot each

constexpr int rDl = 0, rH2 = 49, rDz2 = 69, rDh2 = 89, rG2 = 109, rH1 = 129,
              rDz1 = 151, rDh1 = 173, rG1 = 195, rFeat = 217, rEh = 234,
              rEw = 266, rTm = 298, rTs = 307, rTg = 316, kStride = 325;

HM_FN void bwd_row(const float* p, const RowIn& in, float gsc, float* q) {
  const L32 &zz1 = in.z1, &zz2 = in.z2;
  const int rh = in.rh, rw = in.rw;
  L32 f, u, v, dlo, dhi, dz2, dz1, df;
  feature_lanes(p, in.c, in.rh, in.rw, f, u, v);
  // the post-activations again, the scaled d-logits
  HM_LANES(k, 32) {
    dlo[k] = HM_FMUL(in.dlo[k], gsc);
    dhi[k] = HM_FMUL(in.dhi[k], gsc);
    q[rDl + k] = dlo[k];
    if (k < 17) {
      q[rDl + 32 + k] = dhi[k];
      q[rFeat + k] = f[k];
    }
    if (k < 22) q[rH1 + k] = relu_affine(zz1[k], p[oG1 + k], p[oBeta1 + k]);
    if (k < 20) q[rH2 + k] = relu_affine(zz2[k], p[oG2 + k], p[oBeta2 + k]);
  }
  // layer 3 back: dh2 = dl W3 on lanes 0-19, then through the affine and
  // the ReLU
  HM_LANES(k, 32) {
    const int k3 = imin(k, 19);
    float dh2 = 0.0f;
    HM_UNROLL
    for (int j = 0; j < 32; ++j)
      dh2 = HM_FADD(dh2, HM_FMUL(lane_get(dlo, j), p[oW3 + j * 20 + k3]));
    HM_UNROLL
    for (int j = 0; j < 17; ++j)
      dh2 = HM_FADD(dh2, HM_FMUL(lane_get(dhi, j),
                                 p[oW3 + (32 + j) * 20 + k3]));
    dz2[k] = HM_FMUL(HM_FMUL(dh2, p[oG2 + k3]), drelu(zz2[k]));
    if (k < 20) {
      q[rDh2 + k] = dh2;
      q[rDz2 + k] = dz2[k];
      q[rG2 + k] = HM_FMUL(dh2, fmaxf(zz2[k], 0.0f));
    }
  }
  HM_LANES(k, 32) {  // layer 2 back: dh1 = dz2 W2 on lanes 0-21
    const int k2 = imin(k, 21);
    float dh1 = 0.0f;
    HM_UNROLL
    for (int j = 0; j < 20; ++j)
      dh1 = HM_FADD(dh1, HM_FMUL(lane_get(dz2, j), p[oW2 + j * 22 + k2]));
    dz1[k] = HM_FMUL(HM_FMUL(dh1, p[oG1 + k2]), drelu(zz1[k]));
    if (k < 22) {
      q[rDh1 + k] = dh1;
      q[rDz1 + k] = dz1[k];
      q[rG1 + k] = HM_FMUL(dh1, fmaxf(zz1[k], 0.0f));
    }
  }
  // layer 1 back: the features' gradient on lanes 0-16
  HM_LANES(k, 32) {
    const int k1 = imin(k, 16);
    float g = 0.0f;
    HM_UNROLL
    for (int j = 0; j < 22; ++j)
      g = HM_FADD(g, HM_FMUL(lane_get(dz1, j), p[oW1 + j * 17 + k1]));
    df[k] = g;
  }
  HM_LANES(e, 32) {
    // the embeddings: only the rows the size tables select (entry e of
    // a table is row e / 4, column e % 4)
    const float dh = lane_get(df, e & 3), dw = lane_get(df, 4 + (e & 3));
    q[rEh + e] = (e >> 2) == rh ? dh : 0.0f;
    q[rEw + e] = (e >> 2) == rw ? dw : 0.0f;
    // x = (c - mean) / std * gin on lanes 8-16: d gin = dx v; dv = dx gin;
    // d mean = -dv / std; d std = -((dv / std^2) u), 1 / std^2 as
    // 1 / (std std)
    if (e >= 8 && e < 17) {
      const int i = e - 8;
      const float dx = df[e];
      const float dv = HM_FMUL(dx, p[oGin + i]);
      const float sd = p[oStd + i];
      q[rTm + i] = -HM_FDIV(dv, sd);
      q[rTs + i] = -HM_FMUL(HM_FMUL(dv, HM_FDIV(1.0f, HM_FMUL(sd, sd))),
                            u[e]);
      q[rTg + i] = HM_FMUL(dx, v[e]);
    }
  }
}

// parameter p's factors in a row vector: its share of a row's gradient
// is q[a] q[b], or q[a] where b < 0 (K15's launcher tabulates them once)
HM_HD void param_src(int p, int& a, int& b) {
  b = -1;
  if (p < oStd) {
    a = rTm + p;
  } else if (p < oGin) {
    a = rTs + p - oStd;
  } else if (p < oEmbH) {
    a = rTg + p - oGin;
  } else if (p < oEmbW) {
    a = rEh + p - oEmbH;
  } else if (p < oW1) {
    a = rEw + p - oEmbW;
  } else if (p < oB1) {
    a = rDz1 + (p - oW1) / 17;
    b = rFeat + (p - oW1) % 17;
  } else if (p < oG1) {
    a = rDz1 + p - oB1;
  } else if (p < oBeta1) {
    a = rG1 + p - oG1;
  } else if (p < oW2) {
    a = rDh1 + p - oBeta1;
  } else if (p < oB2) {
    a = rDz2 + (p - oW2) / 22;
    b = rH1 + (p - oW2) % 22;
  } else if (p < oG2) {
    a = rDz2 + p - oB2;
  } else if (p < oBeta2) {
    a = rG2 + p - oG2;
  } else if (p < oW3) {
    a = rDh2 + p - oBeta2;
  } else if (p < oB3) {
    a = rDl + (p - oW3) / 20;
    b = rH2 + (p - oW3) % 20;
  } else {
    a = rDl + p - oB3;
  }
}

// the sum of a parameter's shares (q[a] q[b], or q[a] where b < 0) over
// a block's nrows row vectors, in ascending row order from 0
HM_FN float param_sum(const float* rows, int nrows, int a, int b) {
  float x[KROWS], y[KROWS];
  HM_UNROLL
  for (int r = 0; r < KROWS; ++r) {
    x[r] = rows[r * kStride + a];
    y[r] = rows[r * kStride + (b < 0 ? a : b)];
  }
  float acc = 0.0f;
  HM_UNROLL
  for (int r = 0; r < KROWS; ++r)
    if (r < nrows) acc = HM_FADD(acc, b < 0 ? x[r] : HM_FMUL(x[r], y[r]));
  return acc;
}

// acc + s[0] + s[pitch] + ... + s[(n - 1) pitch] in that order, 32 loads
// ahead of the adds
HM_FN float chain_sum(float acc, const float* s, int n, int pitch) {
  for (int b0 = 0; b0 < n; b0 += 32) {
    float v[32];
    HM_UNROLL
    for (int t = 0; t < 32; ++t)
      v[t] = b0 + t < n ? s[(b0 + t) * pitch] : 0.0f;
    HM_UNROLL
    for (int t = 0; t < 32; ++t)
      if (b0 + t < n) acc = HM_FADD(acc, v[t]);
  }
  return acc;
}

// K16: optax.adam's update of one parameter, in optax's order of
// separately rounded operations: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2
// + b2 nu, m^ = mu / bc1, v^ = nu / bc2, p = p + (-lr) m^ / (sqrt(v^) +
// eps), with bc = 1 - b^k the step's bias corrections
struct AdamArgs {
  float* prm;        // the parameters, written
  const float* old;  // their values before the step
  float* mu;
  float* nu;
  float b1, omb1, b2, omb2, bc1, bc2, eps, neg_lr;
};

HM_FN void adam_one(const AdamArgs& a, int j, float g) {
  const float m = HM_FADD(HM_FMUL(a.omb1, g), HM_FMUL(a.b1, a.mu[j]));
  const float v =
      HM_FADD(HM_FMUL(a.omb2, HM_FMUL(g, g)), HM_FMUL(a.b2, a.nu[j]));
  a.mu[j] = m;
  a.nu[j] = v;
  const float u = HM_FDIV(HM_FDIV(m, a.bc1),
                          HM_FADD(HM_FSQRT(HM_FDIV(v, a.bc2)), a.eps));
  a.prm[j] = HM_FADD(a.old[j], HM_FMUL(a.neg_lr, u));
}

// the bias corrections of the update that follows `count` updates: row
// count of the (ntab, 2) table bc (1 - b1^k, 1 - b2^k for k = 1..ntab);
// false past the table
HM_FN bool adam_step(const float* bc, int ntab, int count, AdamArgs& a) {
  if (count < 0 || count >= ntab) return false;
  a.bc1 = bc[2 * count];
  a.bc2 = bc[2 * count + 1];
  return true;
}

// what chunk_sums does with each finished column: nothing (K14, and K15
// for the gradient alone), or K16's update of that parameter
struct NoTail {
  HM_FN void operator()(int, float) const {}
};
struct AdamTail {
  AdamArgs a;
  HM_FN void operator()(int j, float g) const { adam_one(a, j, g); }
};

// columns CW ch .. CW ch + CW - 1 of the blocks' partials part (nb rows
// of ncols floats, written by other blocks), each summed from 0 in
// ascending block order (divided by div > 0) to out[column], then
// handed to tail(column, sum) on the lane that summed it: the block
// stages up to kTile / (CW + 1) rows of them at a time in tile (shared),
// kLdBatch loads in flight a thread, then warp 0 adds a column a lane;
// thread tid of nt
template <int CW, class Tail = NoTail>
HM_FN void chunk_sums(const float* part, int nb, int ncols, int ch,
                      float* tile, float* out, float div, int tid, int nt,
                      const Tail& tail = Tail()) {
  constexpr int pitch = CW + 1, rows_max = kTile / pitch;
  const int c0 = ch * CW, nc = imin(CW, ncols - c0);
  L32 acc;
  HM_LANES(c, 32) acc[c] = 0.0f;
  for (int b0 = 0; b0 < nb; b0 += rows_max) {
    const int rows = imin(rows_max, nb - b0), n = rows * CW;
    HM_SYNC();  // the tile's former rows added
    for (int k0 = tid; k0 < n; k0 += nt * kLdBatch) {
      float v[kLdBatch];
      HM_UNROLL
      for (int t = 0; t < kLdBatch; ++t) {
        const int k = k0 + t * nt, b = k / CW, c = k % CW;
        v[t] = k < n && c < nc
                   ? NNT_LD_OTHER(part + (size_t)(b0 + b) * ncols + c0 + c)
                   : 0.0f;
      }
      HM_UNROLL
      for (int t = 0; t < kLdBatch; ++t) {
        const int k = k0 + t * nt;
        if (k < n) tile[(k / CW) * pitch + k % CW] = v[t];
      }
    }
    HM_SYNC();
    if (tid < 32) {
      HM_LANES(c, 32) {
        acc[c] = chain_sum(acc[c], tile + imin(c, CW - 1), rows, pitch);
      }
    }
  }
  if (tid < 32) {
    HM_LANES(c, 32) {
      if (c < nc) {
        const float s = div > 0.0f ? HM_FDIV(acc[c], div) : acc[c];
        out[c0 + c] = s;
        tail(c0 + c, s);
      }
    }
  }
}

#if !defined(__CUDACC__)
// K14 on one host thread: the kernel's rows, block sums and final sums
// in turn.  part: 2 * nb floats (nb = ceil(B / KROWS)); z1o / z2o / dl
// null for the loss and accuracy alone
inline void fwd_host(const float* pack, const float* costs, const int* h,
                     const int* w, const int* labels, float* z1o, float* z2o,
                     float* dl, float* part, float* out, int B,
                     float inv_b) {
  const int nb = (B + KROWS - 1) / KROWS;
  std::vector<float> tile(kTile);
  for (int blk = 0; blk < nb; ++blk) {
    const int nrows = imin(KROWS, B - blk * KROWS);
    float sl[KROWS], sc[KROWS];
    for (int r = 0; r < nrows; ++r) {
      const size_t i = (size_t)blk * KROWS + r;
      RowIn in;
      load_row(costs, h, w, labels, nullptr, nullptr, nullptr, i, in);
      fwd_row(pack, in, inv_b, dl ? z1o + i * 22 : nullptr,
              dl ? z2o + i * 20 : nullptr, dl ? dl + i * 49 : nullptr,
              sl[r], sc[r]);
    }
    block_sums(sl, sc, nrows, part + 2 * blk, part + 2 * blk + 1);
  }
  chunk_sums<2>(part, nb, 2, 0, tile.data(), out, (float)B, 0, 1);
}

// K15 on one host thread.  part: kPack * nb floats, a block's row after
// another, as the kernel keeps them.  With mu (non-null), K16 as its
// tail: pack, mu and nu updated in place with the bias corrections of
// row *count of the (ntab, 2) table bc, and *count + 1 written back
// (nothing updated past the table)
inline void bwd_host(float* pack, const float* costs, const int* h,
                     const int* w, const float* z1, const float* z2,
                     const float* dl, float gsc, float* part, float* grad,
                     int B, float* mu, float* nu, int* count,
                     const float* bc, int ntab, float b1, float omb1,
                     float b2, float omb2, float eps, float neg_lr) {
  const int nb = (B + KROWS - 1) / KROWS;
  std::vector<float> rows(KROWS * kStride, 0.0f), tile(kTile);
  for (int blk = 0; blk < nb; ++blk) {
    const int nrows = imin(KROWS, B - blk * KROWS);
    for (int r = 0; r < nrows; ++r) {
      RowIn in;
      load_row(costs, h, w, nullptr, z1, z2, dl, (size_t)blk * KROWS + r,
               in);
      bwd_row(pack, in, gsc, rows.data() + r * kStride);
    }
    for (int p = 0; p < kPack; ++p) {
      int a, b;
      param_src(p, a, b);
      part[(size_t)blk * kPack + p] = param_sum(rows.data(), nrows, a, b);
    }
  }
  AdamArgs ad{pack, pack, mu, nu, b1, omb1, b2, omb2, 0.0f, 0.0f, eps,
              neg_lr};
  const bool upd = mu != nullptr && adam_step(bc, ntab, *count, ad);
  for (int ch = 0; ch * 32 < kPack; ++ch) {
    if (upd)
      chunk_sums<32>(part, nb, kPack, ch, tile.data(), grad, 0.0f, 0, 1,
                     AdamTail{ad});
    else
      chunk_sums<32>(part, nb, kPack, ch, tile.data(), grad, 0.0f, 0, 1);
  }
  if (upd) *count += 1;
}
#endif

}  // namespace nnt
