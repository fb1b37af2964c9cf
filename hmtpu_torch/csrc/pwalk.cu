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
// Design: one thread block of THREADS threads per lane (a cell, or a
// 32x32 region of the level with its 16x16 regions and cells in z-order),
// the steps in sequence; per-sample work split over the threads, K10's
// working set in shared memory, the candidates' predictions and the coded
// CUs in the lane's device scratch.  The AMVP hypotheses (K7 + K10 over
// the whole frame), the open-loop intra modes (K22) and the temporal
// candidates (K24) are computed before the walk and read here; the level
// index is the only per-launch argument besides the frame's fixed ones.
// Padding lanes (-1) return at once.
#include <cuda_runtime.h>

#include "pwalk.cuh"

namespace {

constexpr int THREADS = 128;
static_assert(THREADS <= pw::RED_THREADS, "the SSE reduction's width");

__global__ void __launch_bounds__(THREADS)
    pwalk_kernel(const __grid_constant__ pw::Args a, int level) {
  extern __shared__ double smem[];
  pw::walk_lane(a, level, blockIdx.x, threadIdx.x, blockDim.x, smem);
}

}  // namespace

// scratch: (bmax, pw::SCRATCH) int32 on the card; ptrs / ints / flts: host
// arrays of n_ptrs pointers, n_ints ints and n_flts floats, which must be
// pw::N_PTRS, N_INTS and N_FLTS (pw::args_from's order; the scratch
// pointer among them is this one)
extern "C" int hm_p_walk(void* scratch, const void* ptrs, int n_ptrs,
                         const void* ints, int n_ints, const void* flts,
                         int n_flts, int level, void* stream) {
  if (n_ptrs != pw::N_PTRS || n_ints != pw::N_INTS || n_flts != pw::N_FLTS)
    return cudaErrorInvalidValue;
  pw::Args a = pw::args_from((const long long*)ptrs, (const int*)ints,
                             (const float*)flts);
  if (a.scratch != scratch || a.scratch_ints != pw::SCRATCH ||
      a.bmax < 1 || level < 0 || (a.geom != 8 && a.geom != 32) ||
      (a.bd != 8 && a.bd != 10) || a.max_merge < 1 ||
      a.max_merge > pw::MAXM || a.R < 1 || a.num_ref < 1)
    return cudaErrorInvalidValue;
  const size_t smem = hm::rdoq_smem_bytes(a.geom == 8 ? 3 : 5);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pwalk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pwalk_kernel<<<a.bmax, THREADS, smem, (cudaStream_t)stream>>>(a, level);
  return (int)cudaGetLastError();
}
