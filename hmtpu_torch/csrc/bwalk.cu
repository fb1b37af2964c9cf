// K26 b_walk: the B-slice z-scan as one launch per dependency level, the
// port of hmtpu/encoder/pframe_dev.py:255 wavefront_pass in its B form
// (the B merge list, every candidate's hypotheses and screening, the
// winner's exact prediction and coding, the AMVP list of the block's own
// list with its inter_pred_idc bits, the intra trial, the 16x16 and 32x32
// CU trials, the split RD and the commits), with the B pass's syntax-flag
// prices (hmtpu/ops/ratebits.py:305-450) read from the context table.
// The lane code is bwalk.cuh over pwalk.cuh's.
//
// What bounds it on the H100: as K23 (pwalk.cu), neither bytes nor
// operations but the chain inside a lane: per 8x8 cell up to 2 x M
// hypotheses at intermediate precision, the screening, the winner's
// exact prediction, one RDOQ coding of three TBs, the AMVP list, often
// an intra coding, then the same per 16x16 and 32x32 trial, one after
// another.  The plain version issues that chain as tens of thousands of
// torch operations a level from the host; here a level is one launch.
//
// Design: K23's (one thread block of THREADS threads per lane, the steps
// in sequence, per-sample work split over the threads, K10's working set
// in shared memory, the hypotheses and coded CUs in the lane's device
// scratch), as its own kernel so K23's code is untouched.  The AMVP
// hypotheses (K7 + K10 over the whole frame, each block's list through
// the union stack) and the open-loop intra modes (K22) are computed
// before the walk and read here.  Padding lanes (-1) return at once.
#include <cuda_runtime.h>

#include "bwalk.cuh"

namespace {

constexpr int THREADS = 128;
static_assert(THREADS <= bw::RED_THREADS, "the SSE reduction's width");

__global__ void __launch_bounds__(THREADS, 1)
    bwalk_kernel(const __grid_constant__ bw::Args a, int level) {
  extern __shared__ double smem[];
  bw::walk_lane(a, level, blockIdx.x, threadIdx.x, blockDim.x, smem);
}

}  // namespace

// scratch: (bmax, bw::SCRATCH) int32 on the card; ptrs / ints / flts: host
// arrays of n_ptrs pointers, n_ints ints and n_flts floats, which must be
// bw::N_PTRS, N_INTS and N_FLTS (bw::args_from's order; the scratch
// pointer among them is this one).  A B slice has no transform skip and
// no temporal grids.
extern "C" int hm_b_walk(void* scratch, const void* ptrs, int n_ptrs,
                         const void* ints, int n_ints, const void* flts,
                         int n_flts, int level, void* stream) {
  if (n_ptrs != bw::N_PTRS || n_ints != bw::N_INTS || n_flts != bw::N_FLTS)
    return cudaErrorInvalidValue;
  const bw::Args b = bw::args_from((const long long*)ptrs, (const int*)ints,
                                   (const float*)flts);
  const pw::Args& a = b.p;
  if (a.scratch != scratch || a.scratch_ints != bw::SCRATCH ||
      a.bmax < 1 || level < 0 || (a.geom != 8 && a.geom != 32) ||
      (a.bd != 8 && a.bd != 10) || a.max_merge < 1 ||
      a.max_merge > pw::MAXM || a.R < 1 || a.num_ref < 1 ||
      b.num_ref_l1 < 1 || a.ts != 0 || a.t8 || a.t16 || a.t32 ||
      !b.l0map || !b.l1map || !b.ref_pocs_l1 || !b.lx8 ||
      (a.geom == 32 && (!b.lx16 || !b.lx32)))
    return cudaErrorInvalidValue;
  // the working set's limit, raised once per device to the larger one (the
  // coder's tables in static shared memory come on top of it)
  static bool raised[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(bwalk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)hm::rdoq_smem_bytes(5));
    if (e != cudaSuccess) return (int)e;
    raised[dev] = true;
  }
  const size_t smem = hm::rdoq_smem_bytes(a.geom == 8 ? 3 : 5);
  bwalk_kernel<<<a.bmax, THREADS, smem, (cudaStream_t)stream>>>(b, level);
  return (int)cudaGetLastError();
}
