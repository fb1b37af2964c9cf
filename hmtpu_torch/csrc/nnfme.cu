// K6 nnfme: the NN-FME MLP over the PUs of up to three CU levels in one
// launch, the replacement for hmtpu/models/nnfme.py:127 forward and :143
// predict_offsets (called once per level at
// hmtpu/encoder/pframe_dev.py:1656, 1683, 1723): input standardisation
// and the two size-embedding rows, the 17->22->20->49 layers with ReLU
// and the batch-norm affine, the argmax over the 49 quarter-pel classes
// (first index on ties) and its offsets (cls % 7 - 3, cls / 7 - 3).
//
// What bounds it on the H100: the chain of dependent steps.  A P pass's
// call is 2,054 rows at 416x240 (1560 / 390 / 104 at the 8, 16 and 32
// levels), about 2,060 multiply-adds a row against 2,060 weights (8 KB)
// read once a block, 9 costs in and 3 outputs out a row (49 logits more
// only when the caller passes a logits pointer): about 0.1 MB, so well
// under a microsecond at either rate.  One thread running a row's whole
// MLP is a chain of some 2,060 rounded operations; three launches a P
// pass paid it three times.
//
// Design (nnfme.cuh `forward_lanes`, K14's): a row on a warp, an output
// unit a lane, 8 rows a block (257 blocks at 2,054 rows: one wave), the
// packed weights in shared memory, each warp's costs and sizes loaded
// before the block's copy of the weights is complete.  A row's chain is
// then 17 + 22 + 20 + 20 steps of one unit each, the inputs of a layer
// taken from the lanes that hold them by shuffles.  Every dot product is
// summed in ascending k with one rounded multiply and one rounded add
// per term (__fmul_rn, __fadd_rn: no FMA contraction), so the plain
// PyTorch version (models/nnfme.py `forward_plain`, the same loop) and
// K14's forward give the same bits.  The argmax is a warp argmin of
// (-logit, index).  The levels' stencils are read as ME writes them
// (int32, converted to float32 rounded to nearest, as
// `.to(torch.float32)`), each row's size from its level: the P pass's
// casts and size tensors go.  One-level calls (`forward`,
// `predict_offsets`) take float32 costs and per-row sizes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "nnfme.cuh"

namespace {

using namespace nnfme;

constexpr int KROWS = 8;  // rows a block, one a warp
constexpr int kThreads = KROWS * 32;

__global__ void __launch_bounds__(kThreads)
    nnfme_kernel(const float* __restrict__ pack, Levels a, int total) {
  __shared__ float p[kPack];
  const int i = blockIdx.x * KROWS + (threadIdx.x >> 5);
  L32 c;
  int rh = 0, rw = 0;
  if (i < total) load_costs(a, i, c, rh, rw);
  HM_UNROLL
  for (int t = 0; t < (kPack + kThreads - 1) / kThreads; ++t) {
    const int k = threadIdx.x + t * kThreads;
    if (k < kPack) p[k] = pack[k];
  }
  __syncthreads();
  if (i < total) infer_row(p, a, i, c, rh, rw);
}

}  // namespace

// up to three levels: each level's costs (int32 stencils, or float32
// where f32), rows and pel size; per-row heights and widths (one level)
// or null; outputs (logits may be null)
extern "C" int hm_nnfme(const void* pack, const void* c0, const void* c1,
                        const void* c2, const void* heights,
                        const void* widths, void* logits, void* cls,
                        void* offs, int r0, int r1, int r2, int s0, int s1,
                        int s2, int nlev, int f32, void* stream) {
  if (nlev < 1 || nlev > 3 || (heights != nullptr && nlev != 1))
    return cudaErrorInvalidValue;
  Levels a{{c0, c1, c2}, {r0, r1, r2}, {s0, s1, s2}, nlev, f32,
           (const int*)heights, (const int*)widths, (float*)logits,
           (int*)cls, (int*)offs};
  int total = 0;
  for (int l = 0; l < nlev; ++l) total += a.rows[l];
  nnfme_kernel<<<(total + KROWS - 1) / KROWS, kThreads, 0,
                 (cudaStream_t)stream>>>((const float*)pack, a, total);
  return (int)cudaGetLastError();
}
