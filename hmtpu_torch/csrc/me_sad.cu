// K5 me_sad and K13 me_sad1 (the single-level form, further below), both
// over me_sad.cuh's packed window and units.
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
//
// K13 me_sad1: hmtpu/search/me.py:107 integer_me for 8x8 blocks (the SAD
// volume of integer_me_sad_volume :29, the argmin + stencil of
// _volume_best :72) with a quarter-pel MV predictor per block in the
// motion cost, for any picture whose sides are multiples of 8 (the P
// pass takes it where a side is not a multiple of 16; dataset extraction
// always).  Its work and bound are K5's at one level (at 1080x1920 and R
// = 64, 2.07 M samples x 16,641 displacements).  Its design is K5's: a
// block per (32x32 region of the picture, dy chunk), the window staged
// packed, units of two dy by eight dx a warp, a (cost, index) key per
// cell merged over the chunks with one atomicMin; there is no 16x16 or
// region sum, and each cell's cost prices its own predictor
// (me::unit_key1), so nothing of the cost is shared across the region.
// Cells of the last row or column of regions that fall outside the
// picture are masked.  A second kernel takes the nine stencil SADs.  (The
// earlier K13, a block a region with an int32 window and one
// displacement at a time a thread, ran at 9 % of its bound on an H100
// 80GB HBM3 at 700 W: PERF.md.)
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "me_sad.cuh"

namespace {

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

// K13's first kernel: block (region, chunk) of the search as K5's, at
// one level: each lane's cell keeps its own running key, priced against
// the cell's own predictor; the two half-warps' keys, the warps', then
// one atomicMin a cell and block merges the chunks (keys: 16 a region,
// NO_KEY before the launch)
template <int P>
__global__ void __launch_bounds__(me::THREADS)
    me1_kernel(const int* __restrict__ ref, const int* __restrict__ org,
               const int* __restrict__ pmx, const int* __restrict__ pmy,
               unsigned long long* __restrict__ keys, int H, int W, int R,
               float lam) {
  extern __shared__ unsigned smw[];
  __shared__ unsigned long long wk[me::THREADS / 32][16];
  const int side = 2 * R + 1, nq = me::nq_of(R);
  const int stride = me::row_words(R, P);
  const int bh = H / 8, bw = W / 8, qw = (bw + 3) / 4;
  const int g = blockIdx.x, qy = g / qw, qx = g - qy * qw;
  const int dlo = me::chunk_lo(blockIdx.y, side);
  const int nd = me::chunk_lo(blockIdx.y + 1, side) - dlo;
  unsigned* win = smw;
  unsigned* sorg = smw + (me::chunk_rows(R) + 31) * stride;
  me::stage<P>(ref, org, H, W, R, qy * 32, qx * 32, dlo, nd + 31, win, sorg,
               threadIdx.x, blockDim.x);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane & 15, half = lane >> 4, cy = c >> 2, cx = c & 3;
  unsigned long long k = me::NO_KEY;
  if (me::cell_in(c, qy, qx, bh, bw)) {
    const size_t b = (size_t)(qy * 4 + cy) * bw + qx * 4 + cx;
    const int px = pmx[b], py = pmy[b];
    unsigned o[8 * (8 / P)];
    me::cell_source<P>(sorg, cy, cx, o);
    const int nu = (nd + 1) / 2 * nq;
    for (int u = warp; u < nu; u += me::THREADS / 32) {
      const int pr = u / nq, q = u - pr * nq, dyl = 2 * pr + half;
      if (dyl >= nd) continue;
      int s[8];
      me::unit_sads<P>(win, stride, o, cy, cx, dyl, q, s);
      k = me::unit_key1(s, dlo + dyl, q, side, R, px, py, lam, k);
    }
  }
  k = me::key_min(k, __shfl_xor_sync(0xffffffffu, k, 16));
  if (lane < 16) wk[warp][lane] = k;
  __syncthreads();
  if (threadIdx.x < 16) {
    k = wk[0][threadIdx.x];
    for (int w = 1; w < me::THREADS / 32; ++w)
      k = me::key_min(k, wk[w][threadIdx.x]);
    atomicMin(keys + (size_t)g * 16 + threadIdx.x, k);
  }
}

// K13's second kernel: block g reads region g's winners and writes each
// cell's (mvx, mvy, best SAD, 3x3 stencil), a (cell, point) a thread
__global__ void __launch_bounds__(me::THREADS)
    me1_out_kernel(const int* __restrict__ ref, const int* __restrict__ org,
                   const unsigned long long* __restrict__ keys,
                   int* __restrict__ out, int H, int W, int R) {
  const int bh = H / 8, bw = W / 8, qw = (bw + 3) / 4;
  const int g = blockIdx.x, qy = g / qw, qx = g - qy * qw;
  const int e = threadIdx.x;
  if (e < 16 * 9 && me::cell_in(e / 9, qy, qx, bh, bw))
    me::out1_item(ref, org, out, H, W, R, qy, qx, e,
                  (int)(keys[(size_t)g * 16 + e / 9] & 0xffffffffu));
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

// keys: (regions, 16) uint64 scratch on the card (regions of 32x32 over
// the picture); bd 8 or 10 (the samples' bits: bytes or halfwords staged)
extern "C" int hm_me_sad1(const void* ref, const void* org, const void* pmx,
                          const void* pmy, void* out, void* keys, int H,
                          int W, int R, int bd, float lam, void* stream) {
  if (H <= 0 || W <= 0 || H % 8 || W % 8 || R < 0 || R > me::MAX_R ||
      (bd != 8 && bd != 10))
    return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int regions = ((H / 8 + 3) / 4) * ((W / 8 + 3) / 4);
  cudaError_t e = cudaMemsetAsync(
      keys, 0xff, (size_t)regions * 16 * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(regions, me::NCH);
  if (bd == 8)
    me1_kernel<4><<<grid, me::THREADS, me::stage_words(R, 4) * 4, st>>>(
        (const int*)ref, (const int*)org, (const int*)pmx, (const int*)pmy,
        (unsigned long long*)keys, H, W, R, lam);
  else
    me1_kernel<2><<<grid, me::THREADS, me::stage_words(R, 2) * 4, st>>>(
        (const int*)ref, (const int*)org, (const int*)pmx, (const int*)pmy,
        (unsigned long long*)keys, H, W, R, lam);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  me1_out_kernel<<<regions, me::THREADS, 0, st>>>(
      (const int*)ref, (const int*)org, (const unsigned long long*)keys,
      (int*)out, H, W, R);
  return (int)cudaGetLastError();
}
