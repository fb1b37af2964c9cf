// K19 mv_regularize: the motion-field coherence pass of the P pass (its
// Jacobi rounds, 3 a P pass at hmtpu_torch/encoder/pframe_dev.py), all
// rounds in one launch, bit-exact with hmtpu/search/me.py:194
// regularize_mv_field; the lane code is in mv_regularize.cuh.
//
// What bounds it on the H100: a round at 416x240 reads the original and
// six candidate 8x8 blocks of reference samples per cell (1560 cells,
// about 0.75 MB of int32 with each distinct sample counted once, 0.2 us at
// 3.35 TB/s) and a few hundred operations a cell: the rounds' chain of
// dependent loads, warp sums and the barriers between rounds, not bytes,
// bound it.
//
// Design: a cooperative launch (every block resident) of blocks of 16
// warps (98 at 416x240: fewer blocks make a cheaper barrier); warp w takes
// cells w, w + warps, ... of a round (a cell a warp at 416x240, about
// eight at 1920x1080).  A round reads the field the round before wrote,
// so the rounds meet at a grid-wide barrier (K15's pattern,
// csrc/nnfme_train.cu, with one counter that only grows within a launch:
// an arrival is one release add by the block's first thread, then
// acquire loads until k x blocks have arrived) and the fields are
// double-buffered (the returned field and a scratch one); the fields are
// read through L2, as other blocks wrote them in this launch.  lam_sqrt
// stays in device memory.
#include <cuda_runtime.h>

#include "mv_regularize.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// the grid barrier's counters: blocks arrived (it only grows within a
// launch: barrier k waits for k x gridDim.x arrivals) and blocks done
// (the last one resets both for the next launch)
__device__ unsigned int g_reg_arrived = 0;
__device__ unsigned int g_reg_done = 0;

// every block of the (cooperative) grid waits here until all of them have
// arrived at barrier k (1, 2, ...): the block's writes (ordered before
// its first thread's arrival by the block's barrier) released with the
// arrival, the others' acquired before the block goes on
__device__ __forceinline__ void grid_sync(int k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(
                     &g_reg_arrived)
                 : "memory");
    const unsigned int target = (unsigned int)k * gridDim.x;
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(&g_reg_arrived)
                   : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) reg_kernel(mvr::Args a) {
  const int warps = gridDim.x * kWarps;
  const int wi = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n = a.bh * a.bw;
  for (int k = 0; k < a.iters; ++k) {
    if (k) grid_sync(k);
    for (int b = wi; b < n; b += warps) mvr::cell(a, k, b);
  }
  // every block is past its last barrier once all have counted themselves
  // done: the last resets the counters
  if (threadIdx.x == 0 && atomicAdd(&g_reg_done, 1u) == gridDim.x - 1) {
    g_reg_arrived = 0;
    g_reg_done = 0;
    __threadfence();
  }
}

// the most blocks resident at once on the current device
int grid_cap() {
  static int cap[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cap[dev] == 0) {
    int sms = 0, per = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, reg_kernel,
                                                      kThreads, 0) !=
            cudaSuccess)
      return 0;
    cap[dev] = sms * per;
  }
  return cap[dev];
}

}  // namespace

// refs (R, H, W), org (H, W), the input field (mvx, mvy, ridx), lam_sqrt
// (one float32); the returned field and a scratch field (bh, bw) each;
// (R, H, W, rounds)
extern "C" int hm_mv_regularize(const void* refs, const void* org,
                                const void* ix, const void* iy,
                                const void* ir, const void* lam_sqrt,
                                void* ox, void* oy, void* orr, void* tx,
                                void* ty, void* tr, int R, int H, int W,
                                int iters, void* stream) {
  if (R < 1 || H < 8 || W < 8 || H % 8 || W % 8 || iters < 1)
    return cudaErrorInvalidValue;
  const int cap = grid_cap();
  if (cap <= 0) return cudaErrorInvalidConfiguration;
  mvr::Args a{(const int*)refs,
              (const int*)org,
              (const float*)lam_sqrt,
              {(const int*)ix, (const int*)iy, (const int*)ir},
              {(int*)ox, (int*)oy, (int*)orr},
              {(int*)tx, (int*)ty, (int*)tr},
              R, H, W, H / 8, W / 8, iters};
  const int cells = a.bh * a.bw;
  const int grid = min((cells + kWarps - 1) / kWarps, cap);
  void* args[] = {(void*)&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)reg_kernel, dim3(grid), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
