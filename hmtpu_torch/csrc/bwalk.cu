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
// Design: K21's (iwalk.cu) and K23's (pwalk.cu): one thread block of
// bw::THREADS (8 warps) a lane, in teams (bwalk.cuh, "K26's lane"): the
// cells on warps 0-5 (the block at geometry 8), each cell's codings as two
// rounds of tasks side by side on one-warp groups (the merge candidates'
// hypotheses and screening with the intra arm's predictions; the merge
// winner's three planes predicted and coded with the intra arm's
// codings); each 16x16 trial on warp 6 beside its region's cells, the
// 32x32 trial on warp 7 beside its four regions, joined by a named
// barrier before the compare and the commit; the SSEs exact group sums;
// the lane's whole working set in shared memory (bw::smem_bytes), no
// device scratch.  The earlier design (128 threads on every step in turn,
// the lane in 146 KB of device scratch, the SSEs summed on thread 0) took
// 144.9 ms a B pass at 416x240 on an H100 80GB HBM3 at 700 W (PERF.md).  The AMVP
// hypotheses (K7 + K10 over the whole frame, each block's list through
// the union stack) and the open-loop intra modes (K22) are computed before
// the walk and read here.  Padding lanes (-1) return at once.
#include <cuda_runtime.h>

#define HM_GROUPS  // groups of the block with their own barriers (hm_port.cuh)
#include "bwalk.cuh"

namespace {

__global__ void __launch_bounds__(bw::THREADS, 1)
    bwalk_kernel(const __grid_constant__ bw::Args a, int level) {
  extern __shared__ __align__(16) int smem[];
  bw::walk_lane(a, level, blockIdx.x, threadIdx.x, blockDim.x, smem);
}

}  // namespace

// scratch: (bmax, 0) int32 on the card (K26 keeps its lane in shared
// memory); ptrs / ints / flts: host arrays of n_ptrs pointers, n_ints ints
// and n_flts floats, which must be bw::N_PTRS, N_INTS and N_FLTS
// (bw::args_from's order; the scratch pointer among them is this one).  A
// B slice has no transform skip and no temporal grids.
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
  // the arena's limit, raised once per device to the larger layout
  static bool raised[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(bwalk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bw::smem_bytes(32));
    if (e != cudaSuccess) return (int)e;
    raised[dev] = true;
  }
  bwalk_kernel<<<a.bmax, bw::THREADS, bw::smem_bytes(a.geom),
                 (cudaStream_t)stream>>>(b, level);
  return (int)cudaGetLastError();
}
