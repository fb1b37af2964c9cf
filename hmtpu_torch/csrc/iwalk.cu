// K21 i_walk: the I-frame z-scan as one launch per dependency level, the
// port of hmtpu/encoder/iframe_dev.py:114 iframe_pass (its `lax.scan`s
// over the 8 level :459, the 16 level :480/:538 and the 32 level
// :560/:614, inside the jit at :680).  The lane code is iwalk.cuh.
//
// What bounds it on the H100: neither bytes nor operations.  A level
// moves a few kilobytes a lane (the source and committed samples its
// reference lines and CUs read, the levels and reconstruction it writes)
// and does a few million integer and float32 operations across at most a
// handful of lanes (7 at 416x240); what costs is the chain inside a lane:
// per 8x8 cell 2 8x8 and up to 20 4x4 codings, each a transform, the RDOQ
// trellis with its serial scans, a second pricing and the inverse, then
// per 16x16 region the larger CU's 6 codings.  The plain version issues
// that chain as about 2,000 torch operations a level from the host; here
// a level is one launch.
//
// Design: one thread block per lane (a cell, a 16x16 region or a 32x32
// region of the level), its warps in teams (iwalk.cuh, "K21's lane"):
// the cells' codings side by side in one round a cell, the NxN chain of
// four PUs on two warps beside them, the 16x16 (and 32x32) trial on warps
// of its own beside its cells; the working set in shared memory
// (iw::smem_bytes), no device scratch.  The earlier design (a block of 4
// warps running each coding after the other, its scratch in device
// memory) was profiled with clocks on the H100 (scripts/iwalk_phases.py;
// PERF.md).  The schedules and gather maps stay on the card (uploaded
// once per geometry); the level index is the only per-launch argument
// besides the frame's fixed ones.  Padding lanes (-1) return at once.
#include <cuda_runtime.h>

#define HM_GROUPS  // groups of the block with their own barriers (hm_port.cuh)
#include "iwalk.cuh"

namespace {

__global__ void __launch_bounds__(iw::THREADS, 1)
    iwalk_kernel(const __grid_constant__ iw::Args a, int level) {
  extern __shared__ __align__(16) int smem[];
  iw::walk_lane(a, level, blockIdx.x, threadIdx.x, blockDim.x, smem);
}

}  // namespace

// scratch: (bmax, 0) int32 on the card (K21 keeps its lane in shared
// memory); ptrs / ints / flts: host arrays of n_ptrs pointers, n_ints ints
// and n_flts floats, which must be iw::N_PTRS, N_INTS and N_FLTS
// (iw::args_from's order; the scratch pointer among them is this one)
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
  // the arena's limit, raised once per device to the largest layout
  static bool raised[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(iwalk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             iw::smem_bytes(32));
    if (e != cudaSuccess) return (int)e;
    raised[dev] = true;
  }
  // geometry 8: the cells' team alone
  const int threads = a.geom == 8 ? 32 * iw::CELL_WARPS : iw::THREADS;
  iwalk_kernel<<<a.bmax, threads, iw::smem_bytes(a.geom),
                 (cudaStream_t)stream>>>(a, level);
  return (int)cudaGetLastError();
}

#ifdef HM_PHASE_CLOCK
// the phase clocks' sums (hm_port.cuh) into host arrays of hm::HM_PH_N
// uint64 each, then zeroed
extern "C" int hm_i_walk_phases(void* cycles, void* counts) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(cycles, hm::hm_ph_cycles,
                             sizeof(hm::hm_ph_cycles));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(counts, hm::hm_ph_count,
                             sizeof(hm::hm_ph_count));
  static const unsigned long long zero[hm::HM_PH_N] = {};
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(hm::hm_ph_cycles, zero, sizeof(zero));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(hm::hm_ph_count, zero, sizeof(zero));
  return (int)e;
}
#endif
