// K1's arithmetic, shared by its entry points (transform.cu) and the I
// z-scan walker (iwalk.cuh): the two-stage integer DCT / DST of H.265
// 8.6.4 and the 4x4 transform skip of 8.6.4.2, bit-exact with
// hmtpu/ops/transform.py:38, :58, :84 and :89.  Accumulation is int32:
// |sum| <= n * 90 * 2^15 < 2^31.
#pragma once

#include "hm_port.cuh"

namespace hm {

constexpr int COEFF_MIN = -(1 << 15);
constexpr int COEFF_MAX = (1 << 15) - 1;

// x * 2^-s rounded, or x * 2^-s exactly for s <= 0
HM_FN int rshift_round(int x, int s) {
  return s > 0 ? (x + (1 << (s - 1))) >> s : x * (1 << (-s));
}

HM_FN int clip16(int x) { return iclamp(x, COEFF_MIN, COEFF_MAX); }

// Stage 1 at (i, j) of one n x n TB: T the matrix, X the input.
//   forward: tmp[i][j] = sum_k T[i][k] * res[j][k]
//   inverse: tmp[i][j] = sum_k T[k][i] * coeff[k][j], clipped to 16 bits
template <bool INV>
HM_FN int tr_stage1(const int* T, const int* X, int n, int i, int j, int s1) {
  int acc = 0;
  if (!INV) {
    for (int k = 0; k < n; ++k) acc += T[i * n + k] * X[j * n + k];
    return rshift_round(acc, s1);
  }
  for (int k = 0; k < n; ++k) acc += T[k * n + i] * X[k * n + j];
  return clip16(rshift_round(acc, s1));
}

// Stage 2 at (i, j) from stage 1's TMP.
//   forward: coeff[i][j] = sum_k T[i][k] * tmp[j][k]
//   inverse: res[i][j] = sum_k tmp[i][k] * T[k][j], clipped to 16 bits
template <bool INV>
HM_FN int tr_stage2(const int* T, const int* TMP, int n, int i, int j,
                    int s2) {
  int acc = 0;
  if (!INV) {
    for (int k = 0; k < n; ++k) acc += T[i * n + k] * TMP[j * n + k];
    return rshift_round(acc, s2);
  }
  for (int k = 0; k < n; ++k) acc += TMP[i * n + k] * T[k * n + j];
  return clip16(rshift_round(acc, s2));
}

// transform skip: forward resi << ts_shift; inverse ((d << (5 + log2)) +
// (1 << (bdShift - 1))) >> bdShift, clipped to 16 bits
HM_FN int ts_fwd(int v, int s1) { return v * (1 << s1); }
HM_FN int ts_inv(int v, int s1, int s2) {
  return clip16((v * (1 << s1) + (1 << (s2 - 1))) >> s2);
}

// One whole TB, the block's threads cooperating: x -> out through tmp
// (three distinct buffers of n * n).  Ends with a barrier.
template <bool INV>
HM_FN void transform_tb(const int* T, const int* x, int* tmp, int* out, int n,
                        int s1, int s2, int tid, int nt) {
  const int nn = n * n;
  for (int e = tid; e < nn; e += nt)
    tmp[e] = tr_stage1<INV>(T, x, n, e / n, e % n, s1);
  HM_GSYNC(nt);
  for (int e = tid; e < nn; e += nt)
    out[e] = tr_stage2<INV>(T, tmp, n, e / n, e % n, s2);
  HM_GSYNC(nt);
}

// ---------------------------------------------------------------------------
// K1's level forms (transform.cu fwd_level_kernel / inv_level_kernel): the
// P and B passes' coding step around K10 for a CU level's three planes
// (or one plane), hmtpu/encoder/pframe_dev.py:188 `_code` with the
// combine of `hypothesis` (ops/transform.py fwd_level / inv_level).
//
// A TB of n x n on n lanes of a warp (32 / n TBs a warp), lane r holding
// row r of the residual (forward) or column r of the coefficients
// (inverse) in registers: each stage is one lane's 1-D transform of the
// n values it holds, and the stages meet through the warp's n x (n + 1)
// tile of the TB in shared memory (the pad keeps a row's and a column's
// n words in n banks).  A thread block takes g = max(1, 32 / n) blocks
// of the level, luma on the first g n lanes and each chroma plane on the
// next g n / 2, so a warp holds TBs of one size; the inverse's per-block
// sums meet in shared memory behind the block's barrier.
//
// The 1-D transforms are HM's even/odd partial butterflies
// (partialButterfly* / partialButterflyInverse*), written once for every
// n: the n-point matrix is rows 0, 32/n, 2 * 32/n, ... of the 32-point
// one cut to n columns, its even rows are the n/2-point matrix, and row k
// is symmetric (k even) or antisymmetric (k odd) about the middle column.
// So sum_j T[k][j] x[j] = sum_{j < n/2} T[k][j] (x[j] +- x[n-1-j]), the
// even rows recursively.  In int32 this equals the n-term product bit for
// bit: every product and every partial sum is an exact integer of at most
// n * 90 * 2^16 < 2^31 in magnitude (a stage's input is a residual of at
// most 10 bits, a rounded first stage, or a coefficient clipped to 16
// bits), so the regrouped sum is the same integer, and rounding happens
// only at each stage's shift, where the matrix product rounds.  The 4x4
// DST (use_dst, the first plane at n = 4) is the full 4-term product.
//
// The transform-skip pair (ts, hmtpu/encoder/pframe_dev.py:223
// `_code_ts_sel`): the 4x4 planes (the one plane, or the chroma pair of
// an 8x8 level) are coded both ways.  The forward also writes each such
// TB's TS coefficients, the residual shifted (ts_fwd); K10 codes both
// alternatives between the launches; the inverse reconstructs both
// (ts_inv: the rounding shift and the 16-bit clip), prices
// transform_skip_flag where each is coded (cbf 1), and keeps the TS
// alternative only where it is coded and strictly cheaper: nz1 && d1 +
// lam bits1 < d0 + lam bits0.  It writes the kept reconstruction,
// levels, distortion and rate (the flag included) and a word a block of
// the planes that kept TS.

// the 32-point DCT of H.265 8.6.4.2 (transMatrix)
HM_CONST int kDct32[32][32] = {
    {64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64,
     64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64,
     64, 64, 64, 64, 64, 64, 64, 64, 64, 64},
    {90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46,
     38, 31, 22, 13, 4, -4, -13, -22, -31, -38, -46,
     -54, -61, -67, -73, -78, -82, -85, -88, -90, -90},
    {90, 87, 80, 70, 57, 43, 25, 9, -9, -25, -43,
     -57, -70, -80, -87, -90, -90, -87, -80, -70, -57, -43,
     -25, -9, 9, 25, 43, 57, 70, 80, 87, 90},
    {90, 82, 67, 46, 22, -4, -31, -54, -73, -85, -90,
     -88, -78, -61, -38, -13, 13, 38, 61, 78, 88, 90,
     85, 73, 54, 31, 4, -22, -46, -67, -82, -90},
    {89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50,
     -18, 18, 50, 75, 89, 89, 75, 50, 18, -18, -50,
     -75, -89, -89, -75, -50, -18, 18, 50, 75, 89},
    {88, 67, 31, -13, -54, -82, -90, -78, -46, -4, 38,
     73, 90, 85, 61, 22, -22, -61, -85, -90, -73, -38,
     4, 46, 78, 90, 82, 54, 13, -31, -67, -88},
    {87, 57, 9, -43, -80, -90, -70, -25, 25, 70, 90,
     80, 43, -9, -57, -87, -87, -57, -9, 43, 80, 90,
     70, 25, -25, -70, -90, -80, -43, 9, 57, 87},
    {85, 46, -13, -67, -90, -73, -22, 38, 82, 88, 54,
     -4, -61, -90, -78, -31, 31, 78, 90, 61, 4, -54,
     -88, -82, -38, 22, 73, 90, 67, 13, -46, -85},
    {83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36,
     -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36,
     36, 83, 83, 36, -36, -83, -83, -36, 36, 83},
    {82, 22, -54, -90, -61, 13, 78, 85, 31, -46, -90,
     -67, 4, 73, 88, 38, -38, -88, -73, -4, 67, 90,
     46, -31, -85, -78, -13, 61, 90, 54, -22, -82},
    {80, 9, -70, -87, -25, 57, 90, 43, -43, -90, -57,
     25, 87, 70, -9, -80, -80, -9, 70, 87, 25, -57,
     -90, -43, 43, 90, 57, -25, -87, -70, 9, 80},
    {78, -4, -82, -73, 13, 85, 67, -22, -88, -61, 31,
     90, 54, -38, -90, -46, 46, 90, 38, -54, -90, -31,
     61, 88, 22, -67, -85, -13, 73, 82, 4, -78},
    {75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89,
     50, -50, -89, -18, 75, 75, -18, -89, -50, 50, 89,
     18, -75, -75, 18, 89, 50, -50, -89, -18, 75},
    {73, -31, -90, -22, 78, 67, -38, -90, -13, 82, 61,
     -46, -88, -4, 85, 54, -54, -85, 4, 88, 46, -61,
     -82, 13, 90, 38, -67, -78, 22, 90, 31, -73},
    {70, -43, -87, 9, 90, 25, -80, -57, 57, 80, -25,
     -90, -9, 87, 43, -70, -70, 43, 87, -9, -90, -25,
     80, 57, -57, -80, 25, 90, 9, -87, -43, 70},
    {67, -54, -78, 38, 85, -22, -90, 4, 90, 13, -88,
     -31, 82, 46, -73, -61, 61, 73, -46, -82, 31, 88,
     -13, -90, -4, 90, 22, -85, -38, 78, 54, -67},
    {64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64,
     64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64,
     -64, 64, 64, -64, -64, 64, 64, -64, -64, 64},
    {61, -73, -46, 82, 31, -88, -13, 90, -4, -90, 22,
     85, -38, -78, 54, 67, -67, -54, 78, 38, -85, -22,
     90, 4, -90, 13, 88, -31, -82, 46, 73, -61},
    {57, -80, -25, 90, -9, -87, 43, 70, -70, -43, 87,
     9, -90, 25, 80, -57, -57, 80, 25, -90, 9, 87,
     -43, -70, 70, 43, -87, -9, 90, -25, -80, 57},
    {54, -85, -4, 88, -46, -61, 82, 13, -90, 38, 67,
     -78, -22, 90, -31, -73, 73, 31, -90, 22, 78, -67,
     -38, 90, -13, -82, 61, 46, -88, 4, 85, -54},
    {50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18,
     -75, 75, 18, -89, 50, 50, -89, 18, 75, -75, -18,
     89, -50, -50, 89, -18, -75, 75, 18, -89, 50},
    {46, -90, 38, 54, -90, 31, 61, -88, 22, 67, -85,
     13, 73, -82, 4, 78, -78, -4, 82, -73, -13, 85,
     -67, -22, 88, -61, -31, 90, -54, -38, 90, -46},
    {43, -90, 57, 25, -87, 70, 9, -80, 80, -9, -70,
     87, -25, -57, 90, -43, -43, 90, -57, -25, 87, -70,
     -9, 80, -80, 9, 70, -87, 25, 57, -90, 43},
    {38, -88, 73, -4, -67, 90, -46, -31, 85, -78, 13,
     61, -90, 54, 22, -82, 82, -22, -54, 90, -61, -13,
     78, -85, 31, 46, -90, 67, 4, -73, 88, -38},
    {36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83,
     -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83,
     -83, 36, 36, -83, 83, -36, -36, 83, -83, 36},
    {31, -78, 90, -61, 4, 54, -88, 82, -38, -22, 73,
     -90, 67, -13, -46, 85, -85, 46, 13, -67, 90, -73,
     22, 38, -82, 88, -54, -4, 61, -90, 78, -31},
    {25, -70, 90, -80, 43, 9, -57, 87, -87, 57, -9,
     -43, 80, -90, 70, -25, -25, 70, -90, 80, -43, -9,
     57, -87, 87, -57, 9, 43, -80, 90, -70, 25},
    {22, -61, 85, -90, 73, -38, -4, 46, -78, 90, -82,
     54, -13, -31, 67, -88, 88, -67, 31, 13, -54, 82,
     -90, 78, -46, 4, 38, -73, 90, -85, 61, -22},
    {18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75,
     89, -89, 75, -50, 18, 18, -50, 75, -89, 89, -75,
     50, -18, -18, 50, -75, 89, -89, 75, -50, 18},
    {13, -38, 61, -78, 88, -90, 85, -73, 54, -31, 4,
     22, -46, 67, -82, 90, -90, 82, -67, 46, -22, -4,
     31, -54, 73, -85, 90, -88, 78, -61, 38, -13},
    {9, -25, 43, -57, 70, -80, 87, -90, 90, -87, 80,
     -70, 57, -43, 25, -9, -9, 25, -43, 57, -70, 80,
     -87, 90, -90, 87, -80, 70, -57, 43, -25, 9},
    {4, -13, 22, -31, 38, -46, 54, -61, 67, -73, 78,
     -82, 85, -88, 90, -90, 90, -90, 88, -85, 82, -78,
     73, -67, 61, -54, 46, -38, 31, -22, 13, -4}};
HM_CONST int kDst4[4][4] = {
    {29, 55, 74, 84}, {74, 74, 0, -74}, {84, -29, -74, 55}, {55, -84, 74, -29}};

// y[k] = sum_j T_N[k][j] x[j], T_N the N-point DCT (N a power of two <= 32)
template <int N>
HM_FN void dct_fwd_1d(const int (&x)[N], int (&y)[N]) {
  if constexpr (N == 1) {
    y[0] = kDct32[0][0] * x[0];
  } else {
    constexpr int H = N / 2, S = 32 / N;
    int e[H], o[H], ye[H];
    HM_UNROLL
    for (int j = 0; j < H; ++j) {
      e[j] = x[j] + x[N - 1 - j];
      o[j] = x[j] - x[N - 1 - j];
    }
    dct_fwd_1d<H>(e, ye);
    HM_UNROLL
    for (int m = 0; m < H; ++m) {
      int acc = 0;
      HM_UNROLL
      for (int j = 0; j < H; ++j) acc += kDct32[(2 * m + 1) * S][j] * o[j];
      y[2 * m] = ye[m];
      y[2 * m + 1] = acc;
    }
  }
}

// r[i] = sum_k T_N[k][i] c[k]
template <int N>
HM_FN void dct_inv_1d(const int (&c)[N], int (&r)[N]) {
  if constexpr (N == 1) {
    r[0] = kDct32[0][0] * c[0];
  } else {
    constexpr int H = N / 2, S = 32 / N;
    int ce[H], e[H];
    HM_UNROLL
    for (int m = 0; m < H; ++m) ce[m] = c[2 * m];
    dct_inv_1d<H>(ce, e);
    HM_UNROLL
    for (int i = 0; i < H; ++i) {
      int o = 0;
      HM_UNROLL
      for (int m = 0; m < H; ++m)
        o += kDct32[(2 * m + 1) * S][i] * c[2 * m + 1];
      r[i] = e[i] + o;
      r[N - 1 - i] = e[i] - o;
    }
  }
}

// the 1-D stage of a TB: the DCT, or the 4x4 DST where dst (N = 4)
template <int N>
HM_FN void tr_1d(const int (&x)[N], int (&y)[N], bool inv, bool dst) {
  if constexpr (N == 4) {
    if (dst) {
      HM_UNROLL
      for (int k = 0; k < 4; ++k) {
        int acc = 0;
        HM_UNROLL
        for (int j = 0; j < 4; ++j)
          acc += (inv ? kDst4[j][k] : kDst4[k][j]) * x[j];
        y[k] = acc;
      }
      return;
    }
  }
  if (inv)
    dct_inv_1d<N>(x, y);
  else
    dct_fwd_1d<N>(x, y);
}

// n int32 words from p into x (16 bytes a load on the card; p 16-byte
// aligned) and back
template <int N>
HM_FN void load_words(const int* p, int (&x)[N]) {
#if defined(__CUDACC__)
  if constexpr (N % 4 == 0) {
    HM_UNROLL
    for (int q = 0; q < N / 4; ++q) {
      const int4 v = reinterpret_cast<const int4*>(p)[q];
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
    return;
  }
#endif
  HM_UNROLL
  for (int k = 0; k < N; ++k) x[k] = p[k];
}
template <int N>
HM_FN void store_words(int* p, const int (&x)[N]) {
#if defined(__CUDACC__)
  if constexpr (N % 4 == 0) {
    HM_UNROLL
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<int4*>(p)[q] =
          make_int4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    return;
  }
#endif
  HM_UNROLL
  for (int k = 0; k < N; ++k) p[k] = x[k];
}

// A launch of a level form: planes (1 or 3) of m TBs each, plane 0 of n0
// x n0, planes 1 and 2 of n1 x n1; `mode` bit depth | use_dst << 8 (the
// DST on plane 0 at n0 = 4) | ts << 9 (the transform-skip pair on the
// 4x4 planes: plane 0 of one, planes 1 and 2 of three at n0 = 8).  fwd
// reads org, pred and writes coef (and tcoef of the TS planes); inv reads
// deq, lev, pred, org (and, three planes or ts, bits and dw) and writes
// rec and sse, and, three planes, cbf, dist and bitsum; with ts it also
// reads the TS planes' tdeq, tlev, tbits, the flag's two prices and lam,
// and writes their kept levk and bitk and a word ts a block.
struct LevelArgs {
  const int* org[3];
  const int* pred[3];
  const int* deq[3];
  const int* lev[3];
  const float* bits[3];
  const float* dw;  // the chroma distortion weight (0-d), or null
  int* coef[3];
  int* rec[3];
  float* sse[3];
  int* cbf;
  float* dist;
  float* bitsum;
  // the transform-skip pair, indexed by plane like the others
  int* tcoef[3];
  const int* tdeq[3];
  const int* tlev[3];
  const float* tbits[3];
  const float* tsflag;  // transform_skip_flag's bits for 0 and 1
  const float* lam;     // the TS planes' lambda (0-d)
  int* levk[3];
  float* bitk[3];
  int* ts;  // bit i: the i-th TS plane kept transform skip
  int m, n0, n1, planes, mode;
};

// blocks of the level a thread block, and its threads
HM_HD int level_g(int n0) { return n0 >= 32 ? 1 : 32 / n0; }
HM_HD int level_threads(int n0, int n1, int planes) {
  return level_g(n0) * (planes == 3 ? n0 + 2 * n1 : n0);
}
constexpr int kLevelWarps = 2;       // the most warps a thread block has
constexpr int kLevelTile = 32 * 33;  // a warp's shared words

// thread t of thread block blk: its plane, TB, row (or column) and size;
// false past the level's end
struct LaneJob {
  int plane, tb, r, n, slot;
  bool ok;
};
HM_FN LaneJob lane_job(const LevelArgs& a, int blk, int t) {
  const int g = level_g(a.n0);
  LaneJob j;
  int base = 0;
  j.plane = 0;
  j.n = a.n0;
  if (t >= g * a.n0) {
    base = g * a.n0;
    j.plane = 1;
    j.n = a.n1;
    if (t >= base + g * a.n1) {
      base += g * a.n1;
      j.plane = 2;
    }
  }
  j.slot = (t - base) / j.n;
  j.r = (t - base) % j.n;
  j.tb = blk * g + j.slot;
  j.ok = j.plane < a.planes && j.tb < a.m;
  return j;
}

HM_FN int level_bd(const LevelArgs& a) { return a.mode & 255; }

// plane k's entry of a launch argument (by comparisons: no dynamic index
// into the kernel's parameters)
template <class T>
HM_FN T plane_of(T const (&v)[3], int k) {
  return k == 0 ? v[0] : k == 1 ? v[1] : v[2];
}
HM_FN bool level_dst(const LevelArgs& a, const LaneJob& j) {
  return ((a.mode >> 8) & 1) && j.plane == 0 && j.n == 4;
}
// whether plane k is coded as a transform-skip pair, and its bit in ts
HM_HD bool level_ts(const LevelArgs& a, int k) {
  return ((a.mode >> 9) & 1) && (a.planes == 1 ? k == 0 : k > 0);
}
HM_HD int ts_bit(const LevelArgs& a, int k) { return a.planes == 1 ? 0 : k - 1; }

#if defined(__CUDACC__)
#define HM_WSYNC() __syncwarp()
#else
#define HM_WSYNC() ((void)0)
#endif

// the forward on warp w of thread block blk, its TBs of N x N; sm the
// warp's tile
template <int N>
HM_FN void fwd_warp(const LevelArgs& a, int blk, int w, int* sm) {
  const int bd = level_bd(a), lg = N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4 : 5;
  const int s1 = lg + bd - 9, s2 = lg + 6;
  HM_LANES(l, 32) {
    const LaneJob j = lane_job(a, blk, w * 32 + l);
    if (j.ok) {  // stage 1: row r of the residual
      const size_t off = ((size_t)j.tb * N + j.r) * N;
      int o[N], p[N], x[N], y[N];
      load_words<N>(plane_of(a.org, j.plane) + off, o);
      load_words<N>(plane_of(a.pred, j.plane) + off, p);
      HM_UNROLL
      for (int k = 0; k < N; ++k) x[k] = o[k] - p[k];
      if constexpr (N == 4) {
        if (level_ts(a, j.plane)) {  // the TS coefficients: the shift
          int t[N];
          HM_UNROLL
          for (int k = 0; k < N; ++k) t[k] = ts_fwd(x[k], 15 - bd - lg);
          store_words<N>(plane_of(a.tcoef, j.plane) + off, t);
        }
      }
      tr_1d<N>(x, y, false, level_dst(a, j));
      int* t = sm + (l / N) * N * (N + 1);
      HM_UNROLL
      for (int i = 0; i < N; ++i) t[i * (N + 1) + j.r] = rshift_round(y[i], s1);
    }
  }
  HM_WSYNC();
  HM_LANES(l, 32) {
    const LaneJob j = lane_job(a, blk, w * 32 + l);
    if (j.ok) {  // stage 2: column r of the coefficients
      const int* t = sm + (l / N) * N * (N + 1) + j.r * (N + 1);
      int x[N], y[N];
      HM_UNROLL
      for (int k = 0; k < N; ++k) x[k] = t[k];
      tr_1d<N>(x, y, false, level_dst(a, j));
      int* c = plane_of(a.coef, j.plane) + (size_t)j.tb * N * N + j.r;
      HM_UNROLL
      for (int i = 0; i < N; ++i) c[i * N] = rshift_round(y[i], s2);
    }
  }
  HM_WSYNC();
}

// the sum (or OR) of v over the N lanes of lane l's TB, to each of them
#if defined(__CUDACC__)
template <int N>
HM_FN unsigned tb_mask() {
  return N == 32 ? 0xffffffffu
                 : ((1u << N) - 1) << (threadIdx.x & 31 & ~(N - 1));
}
template <int N>
HM_FN int tb_sum(const Lanes<int, 32>& v, int) {
  return (int)__reduce_add_sync(tb_mask<N>(), (unsigned)v.v);
}
template <int N>
HM_FN int tb_or(const Lanes<int, 32>& v, int) {
  return (int)__reduce_or_sync(tb_mask<N>(), (unsigned)v.v);
}
#else
template <int N>
inline int tb_sum(const Lanes<int, 32>& v, int l) {
  int s = 0;
  for (int k = l & ~(N - 1); k < (l & ~(N - 1)) + N; ++k) s += v[k];
  return s;
}
template <int N>
inline int tb_or(const Lanes<int, 32>& v, int l) {
  int s = 0;
  for (int k = l & ~(N - 1); k < (l & ~(N - 1)) + N; ++k) s |= v[k];
  return s;
}
#endif

// a thread block's per-TB sums: the SSE (int) and the nonzero level flag
// of each plane's g TBs; for a TS pair, the kept distortion and rate and
// whether TS was kept
struct LevelSums {
  int sse[3][8];
  int nz[3][8];
  float d[3][8];
  float b[3][8];
  int use[3][8];
};

// the float32 SSE of plane k's TB with that integer sum: times dw on the
// chroma planes (every plane of a one-plane call) where dw is given
HM_FN float level_sse(const LevelArgs& a, int k, int e) {
  const float d = (float)e;
  return a.dw != nullptr && (a.planes == 1 || k > 0) ? HM_FMUL(d, *a.dw)
                                                     : d;
}

// row r of a TS plane's TB, reconstructed from its TS alternative (the
// residual ts_inv of its dequantised values) over the prediction p
template <int N>
HM_FN void ts_rec_row(const LevelArgs& a, int k, size_t off, const int* p,
                      int* x) {
  const int bd = level_bd(a), vmax = (1 << bd) - 1;
  int q[N];
  load_words<N>(plane_of(a.tdeq, k) + off, q);
  HM_UNROLL
  for (int c = 0; c < N; ++c)
    x[c] = iclamp(p[c] + ts_inv(q[c], 7, 20 - bd), 0, vmax);
}

// the inverse on warp w of thread block blk, its TBs of N x N; at N = 4
// the lanes of a TS plane's TB also reconstruct its transform-skip
// alternative, and the TB's lanes pick one
template <int N>
HM_FN void inv_warp(const LevelArgs& a, int blk, int w, int* sm,
                    LevelSums& s) {
  const int bd = level_bd(a), s1 = 7, s2 = 20 - bd, vmax = (1 << bd) - 1;
  Lanes<int, 32> nz, sse, nz1, sse1;
  HM_LANES(l, 32) {
    const LaneJob j = lane_job(a, blk, w * 32 + l);
    nz[l] = 0;
    if (j.ok) {  // stage 1: column r of the dequantised coefficients
      const size_t off = (size_t)j.tb * N * N + j.r;
      const int *deq = plane_of(a.deq, j.plane) + off,
                *lev = plane_of(a.lev, j.plane) + off;
      int c[N], y[N], any = 0;
      HM_UNROLL
      for (int k = 0; k < N; ++k) {
        c[k] = deq[k * N];
        any |= lev[k * N];
      }
      nz[l] = any != 0;
      tr_1d<N>(c, y, true, level_dst(a, j));
      int* t = sm + (l / N) * N * (N + 1);
      HM_UNROLL
      for (int i = 0; i < N; ++i)
        t[i * (N + 1) + j.r] = clip16(rshift_round(y[i], s1));
    }
  }
  HM_WSYNC();
  HM_LANES(l, 32) {
    const LaneJob j = lane_job(a, blk, w * 32 + l);
    sse[l] = 0;
    sse1[l] = 0;
    nz1[l] = 0;
    if (j.ok) {  // stage 2: row r of the residual, the reconstruction
      const size_t off = ((size_t)j.tb * N + j.r) * N;
      int p[N], o[N], x[N], y[N];
      load_words<N>(plane_of(a.pred, j.plane) + off, p);
      load_words<N>(plane_of(a.org, j.plane) + off, o);
      const int* t = sm + (l / N) * N * (N + 1) + j.r * (N + 1);
      HM_UNROLL
      for (int k = 0; k < N; ++k) x[k] = t[k];
      tr_1d<N>(x, y, true, level_dst(a, j));
      int e = 0;
      HM_UNROLL
      for (int k = 0; k < N; ++k) {
        x[k] = iclamp(p[k] + clip16(rshift_round(y[k], s2)), 0, vmax);
        e += (o[k] - x[k]) * (o[k] - x[k]);
      }
      store_words<N>(plane_of(a.rec, j.plane) + off, x);
      sse[l] = e;
      if constexpr (N == 4) {
        if (level_ts(a, j.plane)) {  // row r of the TS alternative
          int lv[N], any = 0, e1 = 0;
          ts_rec_row<N>(a, j.plane, off, p, x);
          load_words<N>(plane_of(a.tlev, j.plane) + off, lv);
          HM_UNROLL
          for (int k = 0; k < N; ++k) {
            e1 += (o[k] - x[k]) * (o[k] - x[k]);
            any |= lv[k];
          }
          sse1[l] = e1;
          nz1[l] = any != 0;
        }
      }
    }
  }
  HM_LANES(l, 32) {  // the TB's sums over its lanes (exact: integers)
    const LaneJob j = lane_job(a, blk, w * 32 + l);
    const int e = tb_sum<N>(sse, l), z = tb_or<N>(nz, l);
    if (j.ok && j.r == 0) {
      s.sse[j.plane][j.slot] = e;
      s.nz[j.plane][j.slot] = z;
    }
    if constexpr (N == 4) {
      // a TS pair: both priced with the flag where coded, TS kept where
      // coded and strictly cheaper; each lane writes its row of the kept
      // levels and, where TS is kept, of its reconstruction
      const int e1 = tb_sum<N>(sse1, l), z1 = tb_or<N>(nz1, l);
      if (j.ok && level_ts(a, j.plane)) {
        const int k = j.plane, tb = j.tb;
        const float d0 = level_sse(a, k, e), d1 = level_sse(a, k, e1);
        const float b0 = HM_FADD(plane_of(a.bits, k)[tb],
                                 z ? a.tsflag[0] : 0.0f);
        const float b1 = HM_FADD(plane_of(a.tbits, k)[tb],
                                 z1 ? a.tsflag[1] : 0.0f);
        const float lam = *a.lam;
        const bool use = z1 != 0 && HM_FADD(d1, HM_FMUL(lam, b1)) <
                                        HM_FADD(d0, HM_FMUL(lam, b0));
        const size_t off = ((size_t)tb * N + j.r) * N;
        int lv[N];
        load_words<N>((use ? plane_of(a.tlev, k) : plane_of(a.lev, k)) + off,
                      lv);
        store_words<N>(plane_of(a.levk, k) + off, lv);
        if (use) {
          int p[N], x[N];
          load_words<N>(plane_of(a.pred, k) + off, p);
          ts_rec_row<N>(a, k, off, p, x);
          store_words<N>(plane_of(a.rec, k) + off, x);
        }
        if (j.r == 0) {
          s.d[k][j.slot] = use ? d1 : d0;
          s.b[k][j.slot] = use ? b1 : b0;
          s.use[k][j.slot] = use;
          s.nz[k][j.slot] = use ? 1 : z;
        }
      }
    }
  }
  HM_WSYNC();
}

// plane k's kept distortion and rate of the TB in slot `slot` (tb): a TS
// pair's pick, else its SSE (times dw) and K10's bits
HM_FN float level_d(const LevelArgs& a, const LevelSums& s, int k,
                    int slot) {
  return level_ts(a, k) ? s.d[k][slot] : level_sse(a, k, s.sse[k][slot]);
}
HM_FN float level_b(const LevelArgs& a, const LevelSums& s, int k, int slot,
                    int tb) {
  return level_ts(a, k) ? s.b[k][slot] : plane_of(a.bits, k)[tb];
}

// after the block's barrier: each TB's sse (and, TS pairs, its kept rate
// and the block's word of planes that kept TS), and, three planes, each
// block's cbf (bit k: plane k has a nonzero level), dist = (dy + du) +
// dv and bitsum = (by + bu) + bv; thread tid of nt
HM_FN void level_combine(const LevelArgs& a, int blk, const LevelSums& s,
                         int tid, int nt) {
  const int g = level_g(a.n0);
  for (int q = tid; q < a.planes * g; q += nt) {
    const int k = q / g, slot = q % g, tb = blk * g + slot;
    if (tb >= a.m) continue;
    plane_of(a.sse, k)[tb] = level_d(a, s, k, slot);
    if (level_ts(a, k)) plane_of(a.bitk, k)[tb] = s.b[k][slot];
  }
  for (int slot = tid; slot < g; slot += nt) {
    const int tb = blk * g + slot;
    if (tb >= a.m) continue;
    if ((a.mode >> 9) & 1) {
      int t = 0;
      for (int k = 0; k < a.planes; ++k)
        if (level_ts(a, k)) t |= s.use[k][slot] << ts_bit(a, k);
      a.ts[tb] = t;
    }
    if (a.planes != 3) continue;
    a.cbf[tb] = s.nz[0][slot] | s.nz[1][slot] << 1 | s.nz[2][slot] << 2;
    a.dist[tb] = HM_FADD(HM_FADD(level_d(a, s, 0, slot),
                                 level_d(a, s, 1, slot)),
                         level_d(a, s, 2, slot));
    a.bitsum[tb] = HM_FADD(HM_FADD(level_b(a, s, 0, slot, tb),
                                   level_b(a, s, 1, slot, tb)),
                           level_b(a, s, 2, slot, tb));
  }
}

// warp w's size
HM_FN int warp_n(const LevelArgs& a, int blk, int w) {
  return lane_job(a, blk, w * 32).n;
}

template <bool INV>
HM_FN void level_warp(const LevelArgs& a, int blk, int w, int* sm,
                      LevelSums& s) {
  switch (warp_n(a, blk, w)) {
#define HM_LEVEL_CASE(n)                 \
  case n:                                \
    if constexpr (INV)                   \
      inv_warp<n>(a, blk, w, sm, s);     \
    else                                 \
      fwd_warp<n>(a, blk, w, sm);        \
    break;
    HM_LEVEL_CASE(4)
    HM_LEVEL_CASE(8)
    HM_LEVEL_CASE(16)
    HM_LEVEL_CASE(32)
#undef HM_LEVEL_CASE
  }
}

#if !defined(__CUDACC__)
// a level form on one host thread: each thread block's warps in turn,
// then (inverse) its combine
template <bool INV>
inline void level_host(const LevelArgs& a) {
  const int g = level_g(a.n0);
  const int warps = (level_threads(a.n0, a.n1, a.planes) + 31) / 32;
  static int sm[kLevelTile];
  for (int blk = 0; blk * g < a.m; ++blk) {
    LevelSums s{};
    for (int w = 0; w < warps; ++w) level_warp<INV>(a, blk, w, sm, s);
    if (INV) level_combine(a, blk, s, 0, 1);
  }
}
#endif

}  // namespace hm
