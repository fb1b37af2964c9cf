// K8 satd8: HM's 8x8 Hadamard SATD (TComRdCost::xCalcHADs8x8,
// (sum |H D H| + 2) >> 2 per 8x8 tile) summed over the tiles of each
// block, bit-exact with hmtpu/search/me.py:159 satd_batch.  The NN-FME
// gate (hmtpu/encoder/pframe_dev.py:1545) calls it twice per CU level.
//
// What bounds it on the H100: bytes.  Per sample it reads two int32
// values and does 6 add/subtracts of butterflies and one abs-add; at the
// gate's shapes (1560 8x8, 390 16x16, 104 32x32 blocks) a call moves
// 0.8 MB or less, so it is launch-bound in practice.
//
// Design: one thread block per block, eight threads per 8x8 tile.  Each
// thread loads one row of the tile's difference into registers and runs
// the 8-point Walsh-Hadamard butterflies (the Sylvester matrix of the
// reference, so D H), writes the row to shared memory; after a barrier
// each thread runs the butterflies down one column (H (D H)) and sums
// the absolute values.  The eight column sums of a tile meet through
// width-8 warp shuffles, the tile's (s + 2) >> 2 goes into the block's
// sum with an integer atomic (order-independent), and one thread writes
// it.  All integer, so the result is exact.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hm_dsp.cuh"

namespace {

using hm::fwht8;

__global__ void satd_kernel(const int* __restrict__ a,
                            const int* __restrict__ b, int* __restrict__ out,
                            int n) {
  // blockDim is at least one warp; threads past the tiles only take part
  // in the shuffles
  extern __shared__ int sm[];
  int* total = sm;
  int* rows = sm + 1;
  const int nt = n / 8;                  // tiles per side
  const int t = threadIdx.x;
  const int tile = t >> 3, r = t & 7;
  const bool active = tile < nt * nt;
  const int ty = tile / nt, tx = tile - (tile / nt) * nt;
  const size_t base = (size_t)blockIdx.x * n * n;
  if (t == 0) *total = 0;

  int v[8];
  const size_t row0 = base + (size_t)(ty * 8 + r) * n + tx * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = active ? a[row0 + j] - b[row0 + j] : 0;
  fwht8(v);
  int* tl = rows + tile * 64;
#pragma unroll
  for (int j = 0; j < 8; ++j) tl[r * 8 + j] = v[j];
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = tl[i * 8 + r];
  fwht8(v);
  int s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += abs(v[i]);
  s += __shfl_xor_sync(0xffffffffu, s, 1, 8);
  s += __shfl_xor_sync(0xffffffffu, s, 2, 8);
  s += __shfl_xor_sync(0xffffffffu, s, 4, 8);
  if (r == 0 && active) atomicAdd(total, (s + 2) >> 2);
  __syncthreads();
  if (t == 0) out[blockIdx.x] = *total;
}

}  // namespace

extern "C" int hm_satd8(const void* a, const void* b, void* out, int nb, int n,
                        void* stream) {
  if (n % 8 || n < 8 || n > 64) return cudaErrorInvalidValue;
  const int tiles = (n / 8) * (n / 8);
  const int threads = tiles * 8 < 32 ? 32 : tiles * 8;
  const size_t smem = (size_t)(1 + (threads / 8) * 64) * sizeof(int);
  satd_kernel<<<nb, threads, smem, (cudaStream_t)stream>>>(
      (const int*)a, (const int*)b, (int*)out, n);
  return (int)cudaGetLastError();
}
