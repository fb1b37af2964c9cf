// K9 frac_refine: HM's two-stage fractional motion refinement
// (xPatternSearchFracDIF, TEncSearch.cpp:5232-5268), bit-exact with
// hmtpu/search/me.py:249 frac_refine_batch on a stacked reference with
// per-block `ridx`.  Per block: 9 half-pel candidates around 4 * int_mv
// (_FRAC_OFFS x 2, the centre first), then 9 quarter-pel candidates
// around the half-pel winner (offsets x 1); each candidate is priced by
// the 8x8-tiled Hadamard SATD ((sum |H D H| + 2) >> 2 per tile, summed)
// of the org block against its 8-tap DCT-IF luma prediction, and each
// stage keeps the first candidate of least cost (jnp.argmin), so the
// centre wins a tie.
//
// What bounds it on the H100: operations.  Per block and candidate it
// filters (n + 7) x n + n x n samples with 8 taps and runs the 8x8
// butterflies over n x n differences; the bytes (the (n + 8)^2 patch
// and the org block, read once) are far fewer.  At the P pass's shapes
// (1560 8x8, 390 16x16, 104 32x32 blocks at 416x240) a call is a few
// hundred microseconds of integer work at most, and launch-bound at the
// small levels.
//
// Design: one thread block per block (PU).  Every candidate of both
// stages lies within one pel of the integer MV (|offset| <= 3 quarter
// pels), so the block's clamped (n + 8) x (n + 8) integer patch of its
// own reference is staged in shared memory once and covers all 18
// predictions; the org block is staged beside it.  Per candidate: the
// horizontal pass into shared memory, the vertical pass into the
// prediction tile (K7's arithmetic: `mv >> 2` floors for negative MVs,
// `mv & 3` is the phase, and the intermediate shift only applies when
// both phases are non-zero), then eight threads per 8x8 tile run the
// butterflies (K8's) on rows and columns and add their absolute sums
// into the tile's shared counter with integer atomics (exact, in any
// order).  One thread takes the argmin.  All arithmetic is integer.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hm_dsp.cuh"

namespace {

using hm::IF_FILTER_PREC;
using hm::IF_INTERNAL_OFFS;
using hm::IF_INTERNAL_PREC;
using hm::fwht8;
using hm::kLuma;

constexpr int THREADS = 256;
constexpr int MAX_N = 32;
constexpr int MAX_TILES = (MAX_N / 8) * (MAX_N / 8);

// (dy, dx) of the 9 candidates, the centre first (me.py _FRAC_OFFS)
__constant__ int kOffs[9][2] = {{0, 0},  {0, -1}, {0, 1},  {-1, 0}, {1, 0},
                                {-1, -1}, {-1, 1}, {1, -1}, {1, 1}};

// shared memory of one block, carved from the dynamic allocation
struct Smem {
  int* patch;  // (n + 8) x (n + 8) clamped reference samples
  int* org;    // n x n
  int* tmp;    // (n + 7) x n horizontal-pass output
  int* pred;   // n x n prediction, then the Hadamard rows of the tiles
  int* tile;   // MAX_TILES per-tile |H D H| sums
  int* cost;   // 9 candidate SATDs
  int* mv;     // the current centre (qx, qy)
};

// the DCT-IF luma prediction of candidate (qx, qy) into s.pred; the patch
// starts 4 integer samples above-left of the block's integer MV (px0,
// py0 relative to the block), so every tap of every candidate lies in it
__device__ void predict(const Smem& s, int n, int pw, int imx, int imy,
                        int qx, int qy, int bd) {
  const int fx = qx & 3, fy = qy & 3;
  // first tap of output (0, 0): integer position - 3, relative to the
  // patch origin (imx - 4, imy - 4)
  const int ox = (qx >> 2) - imx + 1, oy = (qy >> 2) - imy + 1;
  const int* cx = &kLuma[fx][0];
  const int* cy = &kLuma[fy][0];
  const int shift1 = bd - 8;
  const bool both = fx != 0 && fy != 0;
  for (int k = threadIdx.x; k < (n + 7) * n; k += blockDim.x) {
    const int i = k / n, j = k - (k / n) * n;
    const int* row = s.patch + (oy + i) * pw + ox + j;
    int acc = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) acc += cx[t] * row[t];
    s.tmp[k] = both ? (acc - (IF_INTERNAL_OFFS << shift1)) >> shift1 : acc;
  }
  __syncthreads();
  const int maxv = (1 << bd) - 1;
  const int shift2 = IF_FILTER_PREC + (IF_INTERNAL_PREC - bd);
  const int off2 = (1 << (shift2 - 1)) + (IF_INTERNAL_OFFS << IF_FILTER_PREC);
  for (int k = threadIdx.x; k < n * n; k += blockDim.x) {
    const int i = k / n, j = k - (k / n) * n;
    int v;
    if (fx == 0 && fy == 0) {
      v = s.patch[(oy + i + 3) * pw + ox + j + 3];
    } else if (fy == 0) {
      v = (s.tmp[(i + 3) * n + j] + 32) >> IF_FILTER_PREC;
    } else {
      int acc2 = 0;
#pragma unroll
      for (int t = 0; t < 8; ++t) acc2 += cy[t] * s.tmp[(i + t) * n + j];
      v = fx == 0 ? (acc2 + (32 << IF_FILTER_PREC)) >> (2 * IF_FILTER_PREC)
                  : (acc2 + off2) >> shift2;
    }
    s.pred[k] = min(max(v, 0), maxv);
  }
  __syncthreads();
}

// SATD of s.org against s.pred (overwrites s.pred); thread 0 stores it
// in s.cost[c]
__device__ void satd(const Smem& s, int n, int c) {
  const int nt = n / 8;
  const int t = threadIdx.x;
  const int tile = t >> 3, r = t & 7;
  const bool active = tile < nt * nt;
  const int ty = tile / max(nt, 1), tx = tile - ty * nt;
  if (t < MAX_TILES) s.tile[t] = 0;
  int v[8];
  if (active) {
    const int base = (ty * 8 + r) * n + tx * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = s.org[base + j] - s.pred[base + j];
    fwht8(v);
  }
  __syncthreads();
  if (active) {
    // the tile's rows go back into its own 8 x 8 of the prediction
    const int base = (ty * 8 + r) * n + tx * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) s.pred[base + j] = v[j];
  }
  __syncthreads();
  if (active) {
    const int base = (ty * 8) * n + tx * 8 + r;
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = s.pred[base + i * n];
    fwht8(v);
    int a = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) a += abs(v[i]);
    atomicAdd(&s.tile[tile], a);
  }
  __syncthreads();
  if (t == 0) {
    int sum = 0;
    for (int k = 0; k < nt * nt; ++k) sum += (s.tile[k] + 2) >> 2;
    s.cost[c] = sum;
  }
  __syncthreads();
}

__global__ void frac_kernel(const int* __restrict__ refs,
                            const int* __restrict__ ridx,
                            const int* __restrict__ xs0,
                            const int* __restrict__ ys0,
                            const int* __restrict__ org,
                            const int* __restrict__ imvx,
                            const int* __restrict__ imvy,
                            int* __restrict__ out_x, int* __restrict__ out_y,
                            int R, int H, int W, int n, int bd) {
  extern __shared__ int sm[];
  const int b = blockIdx.x;
  const int pw = n + 8;
  Smem s;
  s.patch = sm;
  s.org = s.patch + pw * pw;
  s.tmp = s.org + n * n;
  s.pred = s.tmp + (n + 7) * n;
  s.tile = s.pred + n * n;
  s.cost = s.tile + MAX_TILES;
  s.mv = s.cost + 9;

  const int imx = imvx[b], imy = imvy[b];
  const int r = min(max(ridx[b], 0), R - 1);
  const int* plane = refs + (size_t)r * H * W;
  const int x0 = xs0[b] + imx - 4, y0 = ys0[b] + imy - 4;
  for (int k = threadIdx.x; k < pw * pw; k += blockDim.x) {
    const int i = k / pw, j = k - (k / pw) * pw;
    const int yy = min(max(y0 + i, 0), H - 1);
    const int xx = min(max(x0 + j, 0), W - 1);
    s.patch[k] = plane[(size_t)yy * W + xx];
  }
  for (int k = threadIdx.x; k < n * n; k += blockDim.x)
    s.org[k] = org[(size_t)b * n * n + k];
  if (threadIdx.x == 0) {
    s.mv[0] = imx * 4;
    s.mv[1] = imy * 4;
  }
  __syncthreads();

  for (int step = 2; step >= 1; --step) {
    const int cx = s.mv[0], cy = s.mv[1];
    for (int c = 0; c < 9; ++c) {
      predict(s, n, pw, imx, imy, cx + kOffs[c][1] * step,
              cy + kOffs[c][0] * step, bd);
      satd(s, n, c);
    }
    if (threadIdx.x == 0) {
      int best = 0;
      for (int c = 1; c < 9; ++c)
        if (s.cost[c] < s.cost[best]) best = c;
      s.mv[0] = cx + kOffs[best][1] * step;
      s.mv[1] = cy + kOffs[best][0] * step;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out_x[b] = s.mv[0];
    out_y[b] = s.mv[1];
  }
}

}  // namespace

extern "C" int hm_frac_refine(const void* refs, const void* ridx,
                              const void* xs0, const void* ys0,
                              const void* org, const void* imvx,
                              const void* imvy, void* out_x, void* out_y,
                              int nb, int R, int H, int W, int n, int bd,
                              void* stream) {
  if ((n != 8 && n != 16 && n != 32) || R < 1 || bd < 8 || bd > 12)
    return cudaErrorInvalidValue;
  const int pw = n + 8;
  const size_t smem = (size_t)(pw * pw + n * n + (n + 7) * n + n * n +
                               MAX_TILES + 9 + 2) * sizeof(int);
  frac_kernel<<<nb, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)refs, (const int*)ridx, (const int*)xs0, (const int*)ys0,
      (const int*)org, (const int*)imvx, (const int*)imvy, (int*)out_x,
      (int*)out_y, R, H, W, n, bd);
  return (int)cudaGetLastError();
}
