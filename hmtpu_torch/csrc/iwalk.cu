// K21 i_walk: the I-frame z-scan as one launch per dependency level, the
// port of hmtpu/encoder/iframe_dev.py:114 iframe_pass (its `lax.scan`s
// over the 8 level :459, the 16 level :480/:538 and the 32 level
// :560/:614, inside the jit at :680).  The lane code is iwalk.cuh.
//
// What bounds it on the H100: neither bytes nor operations.  A level
// moves a few kilobytes a lane (the source and committed samples its
// reference lines and CUs read, the levels and reconstruction it writes)
// and does a few million integer and float32 operations across at most a
// handful of lanes; what costs is the chain inside a lane: per 8x8 cell
// about 30 coding steps one after another (the candidates, the four NxN
// PUs in order, the transform-skip trials), each a transform, the RDOQ
// trellis with its serial scans, a second pricing and the inverse.  The
// plain version issues that chain as about 2,000 torch operations a level
// from the host; here a level is one launch.
//
// Design: one thread block of THREADS threads per lane (a cell, a 16x16
// region or a 32x32 region of the level), the candidates in sequence;
// per-sample work split over the threads, K10's working set in shared
// memory, the lane's candidates in its device scratch.  The schedules and
// gather maps stay on the card (uploaded once per geometry); the level
// index is the only per-launch argument besides the frame's fixed ones.
// Padding lanes (-1) return at once.
#include <cuda_runtime.h>

#include "iwalk.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    iwalk_kernel(const __grid_constant__ iw::Args a, int level) {
  extern __shared__ double smem[];
  iw::walk_lane(a, level, blockIdx.x, threadIdx.x, blockDim.x, smem);
}

}  // namespace

// scratch: (bmax, iw::SCRATCH) int32 on the card; ptrs / ints / flts: host
// arrays of n_ptrs pointers, n_ints ints and n_flts floats, which must be
// iw::N_PTRS, N_INTS and N_FLTS (iw::args_from's order; the scratch
// pointer among them is this one)
extern "C" int hm_i_walk(void* scratch, const void* ptrs, int n_ptrs,
                         const void* ints, int n_ints, const void* flts,
                         int n_flts, int level, void* stream) {
  if (n_ptrs != iw::N_PTRS || n_ints != iw::N_INTS || n_flts != iw::N_FLTS)
    return cudaErrorInvalidValue;
  iw::Args a = iw::args_from((const long long*)ptrs, (const int*)ints,
                             (const float*)flts);
  if (a.scratch != scratch || a.scratch_ints != iw::SCRATCH ||
      a.bmax < 1 || level < 0 ||
      (a.geom != 8 && a.geom != 16 && a.geom != 32) ||
      (a.bd != 8 && a.bd != 10))
    return cudaErrorInvalidValue;
  const int log2max = a.geom == 8 ? 3 : a.geom == 16 ? 4 : 5;
  const size_t smem = hm::rdoq_smem_bytes(log2max);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        iwalk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  iwalk_kernel<<<a.bmax, THREADS, smem, (cudaStream_t)stream>>>(a, level);
  return (int)cudaGetLastError();
}

