// K23 p_walk: the P-slice z-scan as one launch per dependency level, the
// port of hmtpu/encoder/pframe_dev.py:255 wavefront_pass in its P form
// (the Python loops over the 8 level :944, the 16 level :1066 and the 32
// level :1102 of the port; the reference's `lax.scan`s), with the merge /
// skip / AMVP / intra RD of every 8x8 CU, the 16x16 and 32x32 CU trials,
// the split RD and the commits.  The lane code is pwalk.cuh.
//
// What bounds it on the H100: neither bytes nor operations.  A level
// moves tens of kilobytes a lane (the source, the candidates' reference
// patches, the committed samples and rows it reads, the levels and
// reconstruction it writes) and does a few million integer and float32
// operations across at most a handful of lanes; what costs is the chain
// inside a lane: per 8x8 cell five candidates' motion compensation, two
// deadzone codings and an RDOQ recode of three TBs each, the AMVP list,
// often an intra coding, then per 16x16 and 32x32 region the same for one
// larger CU, all one after another.  The plain version issues that chain
// as thousands of torch operations a level from the host; here a level is
// one launch.
//
// Design: one thread block of pw::THREADS (8 warps) per lane (a cell, or
// a 32x32 region of the level with its 16x16 regions and cells in
// z-order), the CU trials in sequence, each trial's independent items
// side by side in groups of the block: the merge candidates' MC, the
// finalists' deadzone codings with the intra arm's, the winner's recode,
// a warp a coding in a cell (two at 16x16, the block at 32x32), under
// warp or named barriers; the trial's whole working set in shared memory
// (pw::SMEM_BYTES, at most 227 KB), no device scratch.  A level of the
// earlier design (the whole block on one coding after another), profiled
// with clocks on the H100 (scripts/pwalk_phases.py), spent 88 % of a lane
// in its codings and 82 % of the last thread's time at barriers, waiting
// for thread 0's stages: the rounds of tasks shorten that chain.  The
// AMVP hypotheses (K7 + K10 over the whole frame), the open-loop intra
// modes (K22) and the temporal candidates (K24) are computed before the
// walk and read here; the level index is the only per-launch argument
// besides the frame's fixed ones.  Padding lanes (-1) return at once.
#include <cuda_runtime.h>

#define HM_GROUPS  // groups of the block with their own barriers (hm_port.cuh)
#include "pwalk.cuh"

namespace {

__global__ void __launch_bounds__(pw::THREADS, 1)
    pwalk_kernel(const __grid_constant__ pw::Args a, int level) {
  extern __shared__ __align__(16) int smem[];
  pw::walk_lane(a, level, blockIdx.x, threadIdx.x, blockDim.x, smem);
}

}  // namespace

// scratch: (bmax, 0) int32 on the card (K23 keeps its lane in shared
// memory); ptrs / ints / flts: host arrays of n_ptrs pointers, n_ints ints
// and n_flts floats, which must be pw::N_PTRS, N_INTS and N_FLTS
// (pw::args_from's order; the scratch pointer among them is this one)
extern "C" int hm_p_walk(void* scratch, const void* ptrs, int n_ptrs,
                         const void* ints, int n_ints, const void* flts,
                         int n_flts, int level, void* stream) {
  if (n_ptrs != pw::N_PTRS || n_ints != pw::N_INTS || n_flts != pw::N_FLTS)
    return cudaErrorInvalidValue;
  pw::Args a = pw::args_from((const long long*)ptrs, (const int*)ints,
                             (const float*)flts);
  if (a.scratch != scratch || a.scratch_ints != 0 ||
      a.bmax < 1 || level < 0 || (a.geom != 8 && a.geom != 32) ||
      (a.bd != 8 && a.bd != 10) || a.max_merge < 1 ||
      a.max_merge > pw::MAXM || a.R < 1 || a.num_ref < 1)
    return cudaErrorInvalidValue;
  // the arena's limit, raised once per device to the larger layout
  static bool raised[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(pwalk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pw::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    raised[dev] = true;
  }
  const int smem = a.geom == 8 ? pw::SMEM8_BYTES : pw::SMEM_BYTES;
  pwalk_kernel<<<a.bmax, pw::THREADS, smem, (cudaStream_t)stream>>>(a,
                                                                     level);
  return (int)cudaGetLastError();
}

#ifdef HM_PHASE_CLOCK
// the phase clocks' sums (hm_port.cuh) into host arrays of hm::HM_PH_N
// uint64 each, then zeroed
extern "C" int hm_p_walk_phases(void* cycles, void* counts) {
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
