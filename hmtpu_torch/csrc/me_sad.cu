// K5 me_sad and K13 me_sad1 (the single-level form, further below; it
// shares K5's window staging and its (cost, index) tie merge).
//
// K5 me_sad: full-window integer motion estimation for the 8x8, 16x16
// and 32x32 CU levels of one reference, bit-exact with
// hmtpu/search/me.py:120 integer_me_levels (the 8x8 SAD volume of
// integer_me_sad_volume :29, its 16/32 sums :138-140, and the argmin +
// stencil of _volume_best :72).
//
// What bounds it on the H100: the work.  Every 8x8 block is compared
// at all (2R+1)^2 displacements: at 416x240 and R = 64, 99,840 samples
// x 16,641 displacements = 1.66 G absolute differences per reference.
// The bytes are tiny (two int32 planes in, 12 int32 per lane out).
// Materialising the reference's 8x8 SAD volume would write 104 MB per
// reference (16641 x 1560 x 4 B) and read it back three times; this
// kernel never writes it.
//
// Design: one thread block per 32x32 region of the padded 32-grid.  The
// region's (32 + 2R)^2 window of edge-replicated reference samples is
// staged in shared memory once (clamped coordinates are HM's margin
// replication).  Thread t owns 8x8 cell t % 16 (its 64 source samples in
// registers) and displacement lane t / 16: per step, 16 displacements
// run at once, each thread sums its cell's SAD, and warp shuffles sum
// the four cells of each 16x16 block and the sixteen of the region (the
// 16 threads of one displacement are one half-warp).  Cells outside the
// picture add zero, as the reference's zero-padded 32-grid strip does.
// Each thread keeps a running (cost, index) minimum per level over its
// displacements in increasing index order, updating only on a strictly
// smaller cost; the 16 partial minima per lane are then merged comparing
// (cost, index) pairs, so ties go to the first index in row-major
// (dy, dx) order, as jnp.argmin.  The cost is float32(SAD) +
// float32(bits) * lambda_sqrt with two separately rounded operations
// (__fmul_rn, __fadd_rn: no FMA contraction), as the reference computes
// it.  The nine stencil SADs around each winner (clamped to the window)
// are recomputed from the staged window afterwards.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = kThreads / 16;   // displacements in flight

__device__ __forceinline__ int bits_of(int v) {
  const unsigned code = v <= 0 ? ((unsigned)(-v) << 1) + 1u : (unsigned)v << 1;
  return 2 * (31 - __clz((int)code)) + 1;
}

// cell (cy, cx) of the region, 0..3 each, from the thread's cell slot:
// slot = 4 * q16 + sub, q16 and sub in (row, col) order (0,0),(0,1),(1,0),(1,1)
__device__ __forceinline__ int cell_row(int c) {
  return ((c >> 2) >> 1) * 2 + ((c & 3) >> 1);
}
__device__ __forceinline__ int cell_col(int c) {
  return ((c >> 2) & 1) * 2 + ((c & 3) & 1);
}

__device__ __forceinline__ bool better(float c, int i, float bc, int bi) {
  return c < bc || (c == bc && i < bi);
}

// Stage one 32x32 region: its (32 + 2R)^2 window of reference samples
// around (y0, x0), edge-replicated by clamped reads (HM's margin
// padding), and its source samples (zero outside the picture).
__device__ void stage_region(int* win, int* sorg, const int* __restrict__ ref,
                             const int* __restrict__ org, int H, int W, int R,
                             int y0, int x0) {
  const int S = 32 + 2 * R;
  for (int k = threadIdx.x; k < S * S; k += blockDim.x) {
    const int wy = k / S, wx = k - (k / S) * S;
    const int yy = min(max(y0 - R + wy, 0), H - 1);
    const int xx = min(max(x0 - R + wx, 0), W - 1);
    win[k] = ref[(size_t)yy * W + xx];
  }
  for (int k = threadIdx.x; k < 32 * 32; k += blockDim.x) {
    const int yy = y0 + (k >> 5), xx = x0 + (k & 31);
    sorg[k] = (yy < H && xx < W) ? org[(size_t)yy * W + xx] : 0;
  }
}

// SAD of region cell (cy, cx) at window offset (dyi, dxi)
__device__ int cell_sad(const int* win, int S, const int* org, int cy, int cx,
                        int dyi, int dxi) {
  int s = 0;
  const int* w0 = win + (cy * 8 + dyi) * S + cx * 8 + dxi;
  const int* o0 = org + cy * 8 * 32 + cx * 8;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) s += abs(o0[i * 32 + j] - w0[i * S + j]);
  return s;
}

__global__ void __launch_bounds__(kThreads)
    me_kernel(const int* __restrict__ ref, const int* __restrict__ org,
              int* __restrict__ out8, int* __restrict__ out16,
              int* __restrict__ out32, int H, int W, int R, float lam) {
  extern __shared__ int sm[];
  const int side = 2 * R + 1;
  const int D = side * side;
  const int S = 32 + 2 * R;
  const int bh = H / 8, bw = W / 8, gh = bh / 2, gw = bw / 2;
  const int qw = (gw + 1) / 2;
  const int qy = blockIdx.x / qw, qx = blockIdx.x - (blockIdx.x / qw) * qw;
  const int y0 = qy * 32, x0 = qx * 32;

  int* win = sm;                                  // S * S
  int* sorg = win + S * S;                        // 32 * 32
  float* rc = (float*)(sorg + 32 * 32);           // 3 levels x kThreads
  int* ri = (int*)(rc + 3 * kThreads);            // 3 levels x kThreads
  int* best = ri + 3 * kThreads;                  // 16 + 4 + 1 winners
  int* sten = best + 21;                          // 21 x 9 stencil sums

  const int t = threadIdx.x;
  stage_region(win, sorg, ref, org, H, W, R, y0, x0);
  for (int k = t; k < 21 * 9; k += kThreads) sten[k] = 0;
  __syncthreads();

  const int c = t & 15, g = t >> 4;
  const int cy = cell_row(c), cx = cell_col(c);
  const bool in8 = (qy * 4 + cy) < bh && (qx * 4 + cx) < bw;
  int o[64];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) o[i * 8 + j] = sorg[(cy * 8 + i) * 32 + cx * 8 + j];

  float b8 = FLT_MAX, b16 = FLT_MAX, b32 = FLT_MAX;
  int i8 = 0x7fffffff, i16 = 0x7fffffff, i32 = 0x7fffffff;
  for (int base = 0; base < D; base += kGroups) {
    const int d = base + g;
    const bool ok = d < D;
    const int dyi = ok ? d / side : 0;
    const int dxi = ok ? d - dyi * side : 0;
    int s = 0;
    if (in8) {
      const int* w0 = win + (cy * 8 + dyi) * S + cx * 8 + dxi;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s += abs(o[i * 8 + j] - w0[i * S + j]);
    }
    int s16 = s + __shfl_xor_sync(0xffffffffu, s, 1);
    s16 += __shfl_xor_sync(0xffffffffu, s16, 2);
    int s32 = s16 + __shfl_xor_sync(0xffffffffu, s16, 4);
    s32 += __shfl_xor_sync(0xffffffffu, s32, 8);
    if (ok) {
      const float mv = __fmul_rn((float)(bits_of((dxi - R) * 4)
                                         + bits_of((dyi - R) * 4)), lam);
      const float c8 = __fadd_rn((float)s, mv);
      const float c16 = __fadd_rn((float)s16, mv);
      const float c32 = __fadd_rn((float)s32, mv);
      if (c8 < b8) { b8 = c8; i8 = d; }
      if (c16 < b16) { b16 = c16; i16 = d; }
      if (c32 < b32) { b32 = c32; i32 = d; }
    }
  }
  rc[t] = b8; ri[t] = i8;
  rc[kThreads + t] = b16; ri[kThreads + t] = i16;
  rc[2 * kThreads + t] = b32; ri[2 * kThreads + t] = i32;
  __syncthreads();

  // merge the kGroups partial minima of each lane: 16 cells, the 4
  // 16x16 blocks (cell slots 0, 4, 8, 12), the region (slot 0)
  if (t < 21) {
    const int lvl = t < 16 ? 0 : (t < 20 ? 1 : 2);
    const int slot = t < 16 ? t : (t < 20 ? (t - 16) * 4 : 0);
    float bc = FLT_MAX;
    int bi = 0x7fffffff;
    for (int k = 0; k < kGroups; ++k) {
      const float cc = rc[lvl * kThreads + k * 16 + slot];
      const int ii = ri[lvl * kThreads + k * 16 + slot];
      if (better(cc, ii, bc, bi)) { bc = cc; bi = ii; }
    }
    best[t] = bi;
  }
  __syncthreads();

  // stencils: 21 lanes x 9 points, each a sum of 1, 4 or 16 cell SADs
  for (int k = t; k < 3 * 144; k += kThreads) {
    const int lvl = k / 144, r = k - lvl * 144;
    int lane, p, cell;
    if (lvl == 0) { lane = r / 9; p = r - lane * 9; cell = lane; }
    else if (lvl == 1) {
      const int q = r / 36;
      lane = 16 + q; p = (r - q * 36) / 4; cell = q * 4 + (r & 3);
    } else { lane = 20; p = r / 16; cell = r & 15; }
    const int ccy = cell_row(cell), ccx = cell_col(cell);
    if ((qy * 4 + ccy) >= bh || (qx * 4 + ccx) >= bw) continue;
    const int bi = best[lane];
    const int bdy = bi / side, bdx = bi - bdy * side;
    const int oy = min(max(bdy + p / 3 - 1, 0), side - 1);
    const int ox = min(max(bdx + p % 3 - 1, 0), side - 1);
    atomicAdd(&sten[lane * 9 + p], cell_sad(win, S, sorg, ccy, ccx, oy, ox));
  }
  __syncthreads();

  if (t < 21) {
    int* o_ = nullptr;
    if (t < 16) {
      const int by = qy * 4 + cell_row(t), bx = qx * 4 + cell_col(t);
      if (by < bh && bx < bw) o_ = out8 + ((size_t)by * bw + bx) * 12;
    } else if (t < 20) {
      const int q = t - 16;
      const int gy = qy * 2 + (q >> 1), gx = qx * 2 + (q & 1);
      if (gy < gh && gx < gw) o_ = out16 + ((size_t)gy * gw + gx) * 12;
    } else {
      o_ = out32 + (size_t)blockIdx.x * 12;
    }
    if (o_ != nullptr) {
      const int bi = best[t];
      const int bdy = bi / side;
      o_[0] = bi - bdy * side - R;
      o_[1] = bdy - R;
      o_[2] = sten[t * 9 + 4];
      for (int p = 0; p < 9; ++p) o_[3 + p] = sten[t * 9 + p];
    }
  }
}


// K13 me_sad1: the single-level form, bit-exact with
// hmtpu/search/me.py:107 integer_me for 8x8 blocks (the SAD volume of
// integer_me_sad_volume :29 and the argmin + stencil of _volume_best :72)
// with a quarter-pel MV predictor per block in the motion cost, for any
// picture whose sides are multiples of 8 (the P pass takes it where a
// side is not a multiple of 16; dataset extraction always).  The work and
// its bound are K5's; there is no 16/32 sum.  One thread block per 32x32
// region of the picture, staged as K5 stages it; cells of the last row or
// column of regions that lie outside the picture are masked.  Thread t
// owns cell t % 16 (row-major in the region) and displacement lane t / 16,
// keeps a running (cost, index) minimum over its displacements in
// increasing index order (strictly smaller cost only), and the 16 partial
// minima of a cell are merged on (cost, index): ties go to the first
// index in row-major (dy, dx) order.  The cost is K5's, float32(SAD) +
// float32(bits(4 dx - px) + bits(4 dy - py)) * lambda_sqrt with separately
// rounded operations.  The nine stencil SADs (clamped to the window) are
// then recomputed from the staged window, one (cell, point) per thread.
__global__ void __launch_bounds__(kThreads)
    me1_kernel(const int* __restrict__ ref, const int* __restrict__ org,
               const int* __restrict__ pmx, const int* __restrict__ pmy,
               int* __restrict__ out, int H, int W, int R, float lam) {
  extern __shared__ int sm[];
  const int side = 2 * R + 1;
  const int D = side * side;
  const int S = 32 + 2 * R;
  const int bh = H / 8, bw = W / 8;
  const int rw = (W + 31) / 32;
  const int qy = blockIdx.x / rw, qx = blockIdx.x - (blockIdx.x / rw) * rw;
  const int y0 = qy * 32, x0 = qx * 32;

  int* win = sm;                                  // S * S
  int* sorg = win + S * S;                        // 32 * 32
  float* rc = (float*)(sorg + 32 * 32);           // kThreads
  int* ri = (int*)(rc + kThreads);                // kThreads
  int* best = ri + kThreads;                      // 16 winners

  const int t = threadIdx.x;
  stage_region(win, sorg, ref, org, H, W, R, y0, x0);
  __syncthreads();

  const int c = t & 15, g = t >> 4;
  const int cy = c >> 2, cx = c & 3;
  const int by = qy * 4 + cy, bx = qx * 4 + cx;
  float bc = FLT_MAX;
  int bi = 0x7fffffff;
  if (by < bh && bx < bw) {
    int o[64];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i * 8 + j] = sorg[(cy * 8 + i) * 32 + cx * 8 + j];
    const int px = pmx[(size_t)by * bw + bx], py = pmy[(size_t)by * bw + bx];
    for (int d = g; d < D; d += kGroups) {
      const int dyi = d / side, dxi = d - (d / side) * side;
      const int* w0 = win + (cy * 8 + dyi) * S + cx * 8 + dxi;
      int s = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s += abs(o[i * 8 + j] - w0[i * S + j]);
      const float mv = __fmul_rn((float)(bits_of((dxi - R) * 4 - px)
                                         + bits_of((dyi - R) * 4 - py)), lam);
      const float cc = __fadd_rn((float)s, mv);
      if (cc < bc) { bc = cc; bi = d; }
    }
  }
  rc[t] = bc;
  ri[t] = bi;
  __syncthreads();

  if (t < 16) {
    float mc = FLT_MAX;
    int mi = 0x7fffffff;
    for (int k = 0; k < kGroups; ++k)
      if (better(rc[k * 16 + t], ri[k * 16 + t], mc, mi)) {
        mc = rc[k * 16 + t];
        mi = ri[k * 16 + t];
      }
    best[t] = mi;
  }
  __syncthreads();

  // per block: mvx, mvy, best SAD, the 3x3 stencil
  for (int k = t; k < 16 * 9; k += kThreads) {
    const int cell = k / 9, p = k - (k / 9) * 9;
    const int ccy = cell >> 2, ccx = cell & 3;
    const int bby = qy * 4 + ccy, bbx = qx * 4 + ccx;
    if (bby >= bh || bbx >= bw) continue;
    const int b = best[cell];
    const int bdy = b / side, bdx = b - (b / side) * side;
    const int oy = min(max(bdy + p / 3 - 1, 0), side - 1);
    const int ox = min(max(bdx + p % 3 - 1, 0), side - 1);
    const int sad = cell_sad(win, S, sorg, ccy, ccx, oy, ox);
    int* o_ = out + ((size_t)bby * bw + bbx) * 12;
    o_[3 + p] = sad;
    if (p == 4) {
      o_[0] = bdx - R;
      o_[1] = bdy - R;
      o_[2] = sad;
    }
  }
}

}  // namespace

extern "C" int hm_me_sad_levels(const void* ref, const void* org, void* out8,
                                void* out16, void* out32, int H, int W, int R,
                                float lam, void* stream) {
  if (H % 16 || W % 16 || R < 0 || R > 64) return cudaErrorInvalidValue;
  const int S = 32 + 2 * R;
  const size_t smem = (size_t)(S * S + 32 * 32) * sizeof(int)
                      + (size_t)3 * kThreads * (sizeof(float) + sizeof(int))
                      + (size_t)(21 + 21 * 9) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      me_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int gh = H / 16, gw = W / 16;
  const int blocks = ((gh + 1) / 2) * ((gw + 1) / 2);
  me_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)ref, (const int*)org, (int*)out8, (int*)out16, (int*)out32,
      H, W, R, lam);
  return (int)cudaGetLastError();
}

extern "C" int hm_me_sad1(const void* ref, const void* org, const void* pmx,
                          const void* pmy, void* out, int H, int W, int R,
                          float lam, void* stream) {
  if (H <= 0 || W <= 0 || H % 8 || W % 8 || R < 0 || R > 64)
    return cudaErrorInvalidValue;
  const int S = 32 + 2 * R;
  const size_t smem = (size_t)(S * S + 32 * 32) * sizeof(int)
                      + (size_t)kThreads * (sizeof(float) + sizeof(int))
                      + (size_t)16 * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      me1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = ((H + 31) / 32) * ((W + 31) / 32);
  me1_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)ref, (const int*)org, (const int*)pmx, (const int*)pmy,
      (int*)out, H, W, R, lam);
  return (int)cudaGetLastError();
}
