// K17 merge_cands and K18 amvp_rd: the z-scan's merge lists and its AMVP
// lists with their MVD pricing, one thread per CU lane, over the lane
// functions of mvcand.cuh.
//
// K17 replaces hmtpu/search/wavefront.py:295 merge_candidates_dev (P: the
// spatial list, the temporal candidate appended unpruned, the zero fill
// over the active references) and :357 merge_candidates_dev_b (B:
// full-motion pruning, the 12 combined bi-predictive pairs, the dir=3
// fill cycling min(R0, R1) references).
//
// K18 replaces the AMVP blocks of the P/B decision pass
// (hmtpu/encoder/pframe_dev.py:815-826, 1129-1140, 1402-1413 and
// amvp_b_nxn :487-514): per lane the AMVP list (amvp_candidates_dev :497,
// P with TMVP; amvp_candidates_dev_b :519, B), mvd_bits against both
// predictors (predictor 1 only when strictly cheaper), ref_idx_bits and,
// in B slices, inter_dir_bits; it also writes the AMVP CU's motion columns.
//
// What bounds them on the H100: neither bytes nor operations.  A call
// reads 5 neighbour rows a lane (80-280 bytes) and does a few hundred
// integer operations; the z-scan gives it 1-400 lanes, so a call is one
// short launch and its cost is the launch.  The design keeps each lane's
// whole derivation in registers (one thread, no shared memory, no
// barriers) and writes each output column contiguously ((planes, B, ...)),
// so the callers take plain views.
#include <cuda_runtime.h>

#include "mvcand.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void merge_kernel(const int* __restrict__ nb,
                             const int* __restrict__ t,
                             const int* __restrict__ pocs0,
                             const int* __restrict__ pocs1,
                             int* __restrict__ out, int B, int C, int M,
                             int limit, int r0, int r1) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < B)
    mvc::merge_lane(nb, t, pocs0, pocs1, out, lane, B, C, M, limit, r0, r1);
}

__global__ void amvp_kernel(const int* __restrict__ nbv,
                            const int* __restrict__ nbp,
                            const int* __restrict__ aref,
                            const int* __restrict__ amx,
                            const int* __restrict__ amy,
                            const int* __restrict__ lx,
                            const int* __restrict__ t,
                            const int* __restrict__ pocs0,
                            const int* __restrict__ pocs1,
                            const float* __restrict__ tab,
                            int* __restrict__ oi, float* __restrict__ of,
                            mvc::AmvpArgs a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < a.B)
    mvc::amvp_lane(nbv, nbp, aref, amx, amy, lx, t, pocs0, pocs1, tab, oi, of,
                   lane, a);
}

}  // namespace

extern "C" int hm_merge_cands(const void* nb, const void* t, const void* pocs0,
                              const void* pocs1, void* out, int B, int C,
                              int M, int limit, int r0, int r1,
                              void* stream) {
  if (B <= 0 || (C != 4 && C != 8) || M < 1 || M > mvc::kMaxMerge ||
      (C == 8 && (r0 < 1 || r1 < 1 || !pocs0 || !pocs1)))
    return cudaErrorInvalidValue;
  merge_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                 (cudaStream_t)stream>>>(
      (const int*)nb, (const int*)t, (const int*)pocs0, (const int*)pocs1,
      (int*)out, B, C, M, limit, r0, r1);
  return (int)cudaGetLastError();
}

extern "C" int hm_amvp_rd(const void* nbv, const void* nbp, const void* aref,
                          const void* amx, const void* amy, const void* lx,
                          const void* t, const void* pocs0, const void* pocs1,
                          const void* tab, void* oi, void* of, int B, int S,
                          int c_dir, int c_mvx, int c_mvy, int c_ref,
                          int c_mvx1, int c_mvy1, int c_ref1, int cur_poc,
                          int r0, int r1, int cmax0, int cmax1, int depth,
                          int ctx_mvd, int ctx_ref, int ctx_dir,
                          void* stream) {
  if (B <= 0 || r0 < 1 || (lx && (r1 < 1 || !pocs1)))
    return cudaErrorInvalidValue;
  const mvc::AmvpArgs a{B,      S,       c_dir,   c_mvx, c_mvy, c_ref,
                        c_mvx1, c_mvy1,  c_ref1,  cur_poc, r0, r1,
                        cmax0,  cmax1,   depth,   ctx_mvd, ctx_ref, ctx_dir};
  amvp_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                (cudaStream_t)stream>>>(
      (const int*)nbv, (const int*)nbp, (const int*)aref, (const int*)amx,
      (const int*)amy, (const int*)lx, (const int*)t, (const int*)pocs0,
      (const int*)pocs1, (const float*)tab, (int*)oi, (float*)of, a);
  return (int)cudaGetLastError();
}
