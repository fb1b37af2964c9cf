// K5 me_sad and K13 me_sad1 (the single-level form, further below, with
// its own window staging).
//
// K5 me_sad: full-window integer motion estimation for the 8x8, 16x16
// and 32x32 CU levels of one reference, bit-exact with
// hmtpu/search/me.py:120 integer_me_levels (the 8x8 SAD volume of
// integer_me_sad_volume :29, its 16/32 sums :138-140, and the argmin +
// stencil of _volume_best :72).  Its arithmetic is me_sad.cuh's.
//
// What bounds it on the H100: the work.  Every 8x8 block is compared
// at all (2R+1)^2 displacements: at 416x240 and R = 64, 99,840 samples
// x 16,641 displacements = 1.66 G absolute differences per reference.
// The bytes are tiny (two int32 planes in, 12 int32 per lane out).
// Materialising the reference's 8x8 SAD volume would write 104 MB per
// reference (16641 x 1560 x 4 B) and read it back three times; this
// kernel never writes it.
//
// Design: a block per (32x32 region of the padded 32-grid, chunk of its
// dy range): me::NCH chunks, so 8 x 104 blocks at 416x240 fill the card
// several deep where one block a region (the earlier design) left 28 of
// 132 SMs idle.  A block stages its chunk's window rows packed (bytes at
// 8 bits, halfwords at 10: me_sad.cuh) with a row stride padded off the
// banks' period (the earlier int32 window, 160 words a row, put a
// warp's four cell rows on one bank: four-way conflicts on every load).
// Each warp takes units of two adjacent dy (its half-warps) by eight dx:
// a lane owns one of the region's 16 cells, loads each window word once
// for the eight displacements, and takes four samples' absolute
// differences and their sum in one __vsadu4 (VABSDIFF4 in the SASS) at
// 8 bits, two samples' as the halfwords' max - min at 10 bits (__vsadu2
// has no instruction of its own on the H100: its emulation, mostly PRMT
// and IABS, made the 10-bit kernel 4.5 times as slow as the 8-bit one);
// shuffles sum the cells to their 16x16 blocks and the region.  Each
// thread keeps its running (cost, index) keys, the block merges them and
// one atomicMin a lane and block merges the chunks.  A second kernel, a
// block a region, reads the winners and takes the nine stencil SADs
// around each from the planes.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "me_sad.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = kThreads / 16;   // K13: displacements in flight
static_assert(kThreads == me::THREADS, "K5 and K13 blocks");

// K5's first kernel: block (region, chunk) of the search, its minima
// into keys (NLANE a region, NO_KEY before the launch)
template <int P>
__global__ void __launch_bounds__(me::THREADS)
    me_kernel(const int* __restrict__ ref, const int* __restrict__ org,
              unsigned long long* __restrict__ keys, int H, int W, int R,
              float lam) {
  extern __shared__ unsigned smw[];
  __shared__ unsigned long long wk[me::THREADS / 32][me::NLANE];
  const int side = 2 * R + 1, nq = me::nq_of(R);
  const int stride = me::row_words(R, P);
  const int bh = H / 8, bw = W / 8, gw = bw / 2, qw = (gw + 1) / 2;
  const int g = blockIdx.x, qy = g / qw, qx = g - qy * qw;
  const int y0 = qy * 32, x0 = qx * 32;
  const int dlo = me::chunk_lo(blockIdx.y, side);
  const int nd = me::chunk_lo(blockIdx.y + 1, side) - dlo;
  unsigned* win = smw;
  unsigned* sorg = smw + (me::chunk_rows(R) + 31) * stride;
  me::stage<P>(ref, org, H, W, R, y0, x0, dlo, nd + 31, win, sorg,
               threadIdx.x, blockDim.x);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane & 15, half = lane >> 4, cy = c >> 2, cx = c & 3;
  const bool in8 = me::cell_in(c, qy, qx, bh, bw);
  unsigned o[8 * (8 / P)];
  me::cell_source<P>(sorg, cy, cx, o);
  unsigned long long k8 = me::NO_KEY, k16 = me::NO_KEY, k32 = me::NO_KEY;
  const int nu = (nd + 1) / 2 * nq;
  for (int u = warp; u < nu; u += me::THREADS / 32) {
    const int pr = u / nq, q = u - pr * nq, dyl = 2 * pr + half;
    const bool row_ok = dyl < nd;
    int s[8];
    if (in8 && row_ok)
      me::unit_sads<P>(win, stride, o, cy, cx, dyl, q, s);
    else
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] = 0;
    const int dyi = dlo + dyl;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // the cell's 16x16 block: cells c ^ 1 and c ^ 4; the region: ^ 2, ^ 8
      int s16 = s[j] + __shfl_xor_sync(0xffffffffu, s[j], 1);
      s16 += __shfl_xor_sync(0xffffffffu, s16, 4);
      int s32 = s16 + __shfl_xor_sync(0xffffffffu, s16, 2);
      s32 += __shfl_xor_sync(0xffffffffu, s32, 8);
      const int dxi = 8 * q + j;
      if (row_ok && dxi < side) {
        const int d = dyi * side + dxi;
        const float mv = me::mv_cost(dxi, dyi, R, lam);
        k8 = me::key_min(k8, me::key_of(__fadd_rn((float)s[j], mv), d));
        k16 = me::key_min(k16, me::key_of(__fadd_rn((float)s16, mv), d));
        k32 = me::key_min(k32, me::key_of(__fadd_rn((float)s32, mv), d));
      }
    }
  }
  // the two half-warps' keys, then the warps', then the chunks'
  k8 = me::key_min(k8, __shfl_xor_sync(0xffffffffu, k8, 16));
  k16 = me::key_min(k16, __shfl_xor_sync(0xffffffffu, k16, 16));
  k32 = me::key_min(k32, __shfl_xor_sync(0xffffffffu, k32, 16));
  if (lane < 16) wk[warp][lane] = k8;
  if (lane < 16 && (cx & 1) == 0 && (cy & 1) == 0)
    wk[warp][16 + (cy >> 1) * 2 + (cx >> 1)] = k16;
  if (lane == 0) wk[warp][20] = k32;
  __syncthreads();
  if (threadIdx.x < me::NLANE) {
    unsigned long long k = wk[0][threadIdx.x];
    for (int w = 1; w < me::THREADS / 32; ++w)
      k = me::key_min(k, wk[w][threadIdx.x]);
    atomicMin(keys + (size_t)g * me::NLANE + threadIdx.x, k);
  }
}

// K5's second kernel: block g reads region g's winners and writes each
// lane's (mvx, mvy, best SAD, 3x3 stencil)
__global__ void __launch_bounds__(me::THREADS)
    me_out_kernel(const int* __restrict__ ref, const int* __restrict__ org,
                  const unsigned long long* __restrict__ keys,
                  int* __restrict__ out8, int* __restrict__ out16,
                  int* __restrict__ out32, int H, int W, int R) {
  __shared__ int best[me::NLANE];
  __shared__ int sten[me::NLANE * 9];
  const int side = 2 * R + 1, bh = H / 8, bw = W / 8, gw = bw / 2;
  const int qw = (gw + 1) / 2, g = blockIdx.x, qy = g / qw, qx = g - qy * qw;
  const int t = threadIdx.x;
  if (t < me::NLANE)
    best[t] = (int)(keys[(size_t)g * me::NLANE + t] & 0xffffffffu);
  for (int k = t; k < me::NLANE * 9; k += blockDim.x) sten[k] = 0;
  __syncthreads();
  // 16 + 4 * 4 + 16 cells of the lanes, 9 points each
  for (int k = t; k < 48 * 9; k += blockDim.x) {
    const int e = k / 9, p = k - e * 9;
    const int lane = e < 16 ? e : e < 32 ? 16 + ((e - 16) >> 2) : 20;
    const int c = me::lane_cell(lane, e < 16 ? 0 : e < 32 ? (e - 16) & 3
                                                          : e - 32);
    if (!me::cell_in(c, qy, qx, bh, bw)) continue;
    int oy, ox;
    me::sten_at(best[lane], p, side, &oy, &ox);
    atomicAdd(&sten[lane * 9 + p],
              me::cell_sad(ref, org, H, W, R, qy * 32, qx * 32, c, oy, ox));
  }
  __syncthreads();
  if (t < me::NLANE) {
    int* o = me::out_row(out8, out16, out32, t, g, qy, qx, bh, bw);
    if (o != nullptr) {
      const int d = best[t];
      o[0] = d % side - R;
      o[1] = d / side - R;
      o[2] = sten[t * 9 + 4];
      for (int p = 0; p < 9; ++p) o[3 + p] = sten[t * 9 + p];
    }
  }
}

__device__ __forceinline__ int bits_of(int v) {
  const unsigned code = v <= 0 ? ((unsigned)(-v) << 1) + 1u : (unsigned)v << 1;
  return 2 * (31 - __clz((int)code)) + 1;
}

__device__ __forceinline__ bool better(float c, int i, float bc, int bi) {
  return c < bc || (c == bc && i < bi);
}

// K13: stage one 32x32 region: its (32 + 2R)^2 window of reference
// samples around (y0, x0), edge-replicated by clamped reads (HM's margin
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

// K13: SAD of region cell (cy, cx) at window offset (dyi, dxi)
__device__ int cell_sad(const int* win, int S, const int* org, int cy, int cx,
                        int dyi, int dxi) {
  int s = 0;
  const int* w0 = win + (cy * 8 + dyi) * S + cx * 8 + dxi;
  const int* o0 = org + cy * 8 * 32 + cx * 8;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) s += abs(o0[i * 32 + j] - w0[i * S + j]);
  return s;
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

// keys: (regions, me::NLANE) uint64 scratch on the card; bd 8 or 10 (the
// samples' bits: bytes or halfwords staged)
extern "C" int hm_me_sad_levels(const void* ref, const void* org, void* out8,
                                void* out16, void* out32, void* keys, int H,
                                int W, int R, int bd, float lam,
                                void* stream) {
  if (H <= 0 || W <= 0 || H % 16 || W % 16 || R < 0 || R > me::MAX_R ||
      (bd != 8 && bd != 10))
    return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int gh = H / 16, gw = W / 16;
  const int regions = ((gh + 1) / 2) * ((gw + 1) / 2);
  cudaError_t e = cudaMemsetAsync(
      keys, 0xff, (size_t)regions * me::NLANE * sizeof(unsigned long long),
      st);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(regions, me::NCH);
  if (bd == 8)
    me_kernel<4><<<grid, me::THREADS, me::stage_words(R, 4) * 4, st>>>(
        (const int*)ref, (const int*)org, (unsigned long long*)keys, H, W, R,
        lam);
  else
    me_kernel<2><<<grid, me::THREADS, me::stage_words(R, 2) * 4, st>>>(
        (const int*)ref, (const int*)org, (unsigned long long*)keys, H, W, R,
        lam);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  me_out_kernel<<<regions, me::THREADS, 0, st>>>(
      (const int*)ref, (const int*)org, (const unsigned long long*)keys,
      (int*)out8, (int*)out16, (int*)out32, H, W, R);
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
