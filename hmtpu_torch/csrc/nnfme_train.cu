// K14 nnfme_fwd, K15 nnfme_bwd and K16 adam (K15's tail): one NN-FME
// training step (hmtpu/models/train.py:46 train_step) on the card, in
// two launches.
//
//   K14  the forward of loss_fn (:38): the 17->22->20->49 MLP of K6 over a
//        batch of rows, the softmax cross-entropy with integer labels as
//        optax computes it (the max subtracted, log-sum-exp, minus the
//        label's logit), the first-index argmax against the label, and,
//        for the backward, the logits' gradient of the mean loss and the
//        two hidden layers' pre-activations; the mean loss and accuracy.
//   K15  the backward (jax.value_and_grad, :49): the gradient of all 2060
//        parameters (PACK_ORDER; mean, std and gin included) summed over
//        the batch.
//   K16  optax.adam's update (:51-53), elementwise over the 2060: the
//        tail of K15's launch, where each parameter's gradient is
//        finished.
//
// What bounds them on the H100: latency.  A step of batch 1024 moves
// about 0.7 MB and does about 15 M float32 operations: well under a
// microsecond at either rate, so what counts is the longest chain of
// dependent steps and the number of launches.
//
// Design (the lane code is nnfme_train.cuh's, which the CPU tests also
// run).  A block of KROWS warps takes KROWS rows, a row on a warp, one
// output unit on a lane: K14's 22, 20 and 49 units (the logits in two
// rounds), K15's 20, 22 and 17 d-units and 9 standardisation terms; each
// unit's sum in ascending order with separately rounded multiply and add
// (no FMA), other lanes' values by shuffles.  At B = 1024 that is 128
// blocks.  Each warp loads its row's inputs before the block's copy of
// the parameters is complete, and every staging copy keeps 16 loads in
// flight a thread.  K14 stores d-logits, z1 and z2 coalesced by lane; a
// block's losses and hits are summed by one thread in ascending row
// order; the last block to finish (a ticket from one atomicAdd on an
// integer counter the kernel resets) stages the blocks' partials in
// shared memory, sums each column in ascending block order on a lane and
// divides by B.  K15 keeps each row's factors (the d-vectors,
// activations and features, the size-selected embedding gradient) in
// shared memory; every thread owns parameters, reads each one's two
// factors' slots from a table (copied once a device), and sums their
// products over the block's rows in ascending row order; the partials go
// to scratch, a block's after another (coalesced); after a grid barrier
// (a cooperative launch, so every block is resident; an arrival counter
// the kernel resets and a generation word), each block takes 32
// parameters, stages their partials in shared memory and sums each in
// ascending block order on a lane of warp 0 (nnfme_train.cuh
// `chunk_sums`); in a training step that lane goes on to K16's update of
// the parameter (`AdamTail`), so the gradient is not read back from
// memory by a launch of its own.  Fixed orders and no float atomics: the card gives the
// same gradient bits on every run, and the plain versions
// (models/train.py) sum in the same orders; K15's grid has a block for
// each 32 parameters at least, so a small batch's column sums run side
// by side too.  One launch a call each, shared memory under 48 KB (no
// attribute to set).  JAX's maximum(x, 0) passes 0.5 of the gradient at
// exactly x == 0; K15 does the same.  The embedding gradient goes only
// to the rows the size tables select (the height table keeps the
// reference's 16-before-12 order).  K16 follows optax's order of
// operations: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, m^ = mu /
// bc1, v^ = nu / bc2, p = p + (-lr) m^ / (sqrt(v^) + eps), in place.
// The step count is a device int32 that every block reads before the
// grid barrier and block 0 increments after it; bc = 1 - b^k comes from
// the caller's float32 table by that count, so a step passes no host
// value that changes from step to step.
//
// The partials' scratch is the caller's (one tensor a device, kept
// between calls, shared by K14 and K15), and the ticket and the barrier
// are one each a device, so launches of K14 and K15 must not overlap one
// another: the trainer runs them on one stream.
#include <cuda_runtime.h>
#include <stdint.h>

#include "nnfme_train.cuh"

namespace {

using namespace nnt;

// K14's ticket and K15's barrier arrivals, each back to 0 when a launch
// ends; K15's barrier generation, which only grows
__device__ unsigned int g_fwd_ticket = 0;
__device__ unsigned int g_bwd_arrived = 0;
__device__ unsigned int g_bwd_gen = 0;
// each parameter's row-vector sources (nnfme_train.cuh param_src),
// copied once a device by K15's launcher
__device__ int2 g_src[kPack];

#if defined(NNT_PHASES)
// scripts/nnfme_phases.py's build (never the trainer's): thread 0 of each
// of the first 4096 blocks stamps the global timer at each phase boundary
// k (K14 0-4, K15 8-13)
__device__ unsigned long long g_stamps[16 * 4096];
#define NNT_STAMP(k)                                                  \
  do {                                                                \
    if (threadIdx.x == 0 && blockIdx.x < 4096) {                      \
      unsigned long long t_;                                          \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));          \
      g_stamps[(k) * 4096 + blockIdx.x] = t_;                         \
    }                                                                 \
  } while (0)
#else
#define NNT_STAMP(k) ((void)0)
#endif

__global__ void __launch_bounds__(kThreads)
    nnfme_fwd_kernel(const float* __restrict__ pack,
                     const float* __restrict__ costs,
                     const int* __restrict__ heights,
                     const int* __restrict__ widths,
                     const int* __restrict__ labels, float* __restrict__ z1o,
                     float* __restrict__ z2o, float* __restrict__ dlo,
                     float* __restrict__ part, float* __restrict__ out,
                     int B, float inv_b) {
  __shared__ float p[kPack];
  __shared__ float tile[kTile];
  __shared__ float sl[KROWS], sc[KROWS];
  __shared__ int last;
  NNT_STAMP(0);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int i = blk * KROWS + w;  // the warp's row
  RowIn in;
  if (i < B)
    load_row(costs, heights, widths, labels, nullptr, nullptr, nullptr, i,
             in);
  stage_in(pack, kPack, p, threadIdx.x, kThreads);
  __syncthreads();
  NNT_STAMP(1);
  if (i < B) {
    float loss, hit;
    const bool g = dlo != nullptr;
    fwd_row(p, in, inv_b, g ? z1o + (size_t)i * 22 : nullptr,
            g ? z2o + (size_t)i * 20 : nullptr,
            g ? dlo + (size_t)i * 49 : nullptr, loss, hit);
    if (lane == 0) {
      sl[w] = loss;
      sc[w] = hit;
    }
  }
  __syncthreads();
  NNT_STAMP(2);
  if (threadIdx.x == 0) {
    block_sums(sl, sc, min(KROWS, B - blk * KROWS), part + 2 * blk,
               part + 2 * blk + 1);
    __threadfence();
    last = atomicAdd(&g_fwd_ticket, 1u) == (unsigned)nb - 1;
    if (last) g_fwd_ticket = 0;
  }
  __syncthreads();
  NNT_STAMP(3);
  if (!last) return;
  __threadfence();
  chunk_sums<2>(part, nb, 2, 0, tile, out, (float)B, threadIdx.x, kThreads);
  NNT_STAMP(4);
}

// every block of the (cooperative) grid waits here for all the others
__device__ __forceinline__ void grid_sync() {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = &g_bwd_gen;
    const unsigned int g0 = *gen;
    __threadfence();
    if (atomicAdd(&g_bwd_arrived, 1u) == gridDim.x - 1) {
      g_bwd_arrived = 0;
      __threadfence();
      atomicAdd(&g_bwd_gen, 1u);
    } else {
      while (*gen == g0) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// K15, and K16 as its tail where mu is not null: pack, mu and nu
// updated in place, the step count read before the grid barrier and its
// successor written after it
__global__ void __launch_bounds__(kThreads)
    nnfme_bwd_kernel(float* pack, const float* __restrict__ costs,
                     const int* __restrict__ heights,
                     const int* __restrict__ widths,
                     const float* __restrict__ z1i,
                     const float* __restrict__ z2i,
                     const float* __restrict__ dli,
                     const float* __restrict__ gscale,
                     float* __restrict__ part, float* __restrict__ grad,
                     int B, float* __restrict__ mu, float* __restrict__ nu,
                     int* __restrict__ count, const float* __restrict__ bc,
                     int ntab, float b1, float omb1, float b2, float omb2,
                     float eps, float neg_lr) {
  __shared__ float p[kPack];
  // the block's row vectors, then the partials' staging tile
  __shared__ float rows[kTile > KROWS * kStride ? kTile : KROWS * kStride];
  NNT_STAMP(8);
  const int w = threadIdx.x >> 5;
  const int nb = (B + KROWS - 1) / KROWS;
  RowIn in;
  int i = blockIdx.x * KROWS + w;
  if (i < B) load_row(costs, heights, widths, nullptr, z1i, z2i, dli, i, in);
  stage_in(pack, kPack, p, threadIdx.x, kThreads);
  const float gsc = *gscale;  // the loss's cotangent (1 for a step)
  // the step's count and bias corrections, read before any block passes
  // the barrier after which block 0 writes the count
  const int c = mu != nullptr ? *count : 0;
  AdamArgs ad{pack, p, mu, nu, b1, omb1, b2, omb2, 0.0f, 0.0f, eps, neg_lr};
  const bool upd = mu != nullptr && adam_step(bc, ntab, c, ad);
  // the thread's parameters' sources, loaded with the parameters
  constexpr int kPer = (kPack + kThreads - 1) / kThreads;
  int2 src[kPer];
  HM_UNROLL
  for (int k = 0; k < kPer; ++k)
    src[k] = g_src[min((int)threadIdx.x + k * kThreads, kPack - 1)];
  __syncthreads();
  NNT_STAMP(9);
  for (int blk = blockIdx.x; blk < nb; blk += gridDim.x) {
    i = blk * KROWS + w;
    if (blk != (int)blockIdx.x && i < B)
      load_row(costs, heights, widths, nullptr, z1i, z2i, dli, i, in);
    if (i < B) bwd_row(p, in, gsc, rows + w * kStride);
    __syncthreads();
    NNT_STAMP(10);
    const int nrows = min(KROWS, B - blk * KROWS);
    HM_UNROLL
    for (int k = 0; k < kPer; ++k) {
      const int q = threadIdx.x + k * kThreads;
      if (q < kPack)
        part[(size_t)blk * kPack + q] =
            param_sum(rows, nrows, src[k].x, src[k].y);
    }
    __syncthreads();
  }
  NNT_STAMP(11);
  grid_sync();
  NNT_STAMP(12);
  // 32 parameters a block at a time, their partials staged in shared
  // memory, a parameter a lane of warp 0, which goes on to K16's update
  // of it in a training step (the old value from the block's copy)
  for (int ch = blockIdx.x; ch * 32 < kPack; ch += gridDim.x) {
    if (upd)
      chunk_sums<32>(part, nb, kPack, ch, rows, grad, 0.0f, threadIdx.x,
                     kThreads, AdamTail{ad});
    else
      chunk_sums<32>(part, nb, kPack, ch, rows, grad, 0.0f, threadIdx.x,
                     kThreads);
  }
  if (upd && blockIdx.x == 0 && threadIdx.x == 0) *count = c + 1;
  NNT_STAMP(13);  // thread 0 adds in chunk_sums: the block's last work
}

// the most K15 blocks resident at once on the current device; the first
// call on a device also copies the parameters' sources to g_src
int bwd_grid_cap() {
  static int cap[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cap[dev] == 0) {
    int sms = 0, per = 0;
    static int2 src[kPack];
    for (int p = 0; p < kPack; ++p) param_src(p, src[p].x, src[p].y);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, nnfme_bwd_kernel,
                                                      kThreads, 0) !=
            cudaSuccess ||
        cudaMemcpyToSymbol(g_src, src, sizeof src) != cudaSuccess)
      return 0;
    cap[dev] = sms * per;
  }
  return cap[dev];
}

}  // namespace

// K14: z1 / z2 / dl null for the loss and accuracy alone (validation);
// part: 2 floats a block of KROWS rows (scratch), out 2 (mean loss,
// accuracy)
extern "C" int hm_nnfme_fwd(const void* pack, const void* costs,
                            const void* heights, const void* widths,
                            const void* labels, void* z1, void* z2, void* dl,
                            void* part, void* out, int B, float inv_b,
                            void* stream) {
  if (B <= 0) return cudaErrorInvalidValue;
  nnfme_fwd_kernel<<<(B + KROWS - 1) / KROWS, kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const float*)pack, (const float*)costs, (const int*)heights,
      (const int*)widths, (const int*)labels, (float*)z1, (float*)z2,
      (float*)dl, (float*)part, (float*)out, B, inv_b);
  return (int)cudaGetLastError();
}

// K15: part: kPack floats a block of KROWS rows (scratch), grad kPack.
// With mu (else null: the gradient alone), K16 as its tail: pack, mu and
// nu updated in place with the bias corrections of row *count of the
// (ntab, 2) table bc, and *count incremented, all on the device (nothing
// is updated where *count is past the table: the caller checks first)
extern "C" int hm_nnfme_bwd(void* pack, const void* costs,
                            const void* heights, const void* widths,
                            const void* z1, const void* z2, const void* dl,
                            const void* gscale, void* part, void* grad, int B,
                            void* mu, void* nu, void* count, const void* bc,
                            int ntab, float b1, float omb1, float b2,
                            float omb2, float eps, float neg_lr,
                            void* stream) {
  if (B <= 0 || (mu != nullptr && (nu == nullptr || count == nullptr ||
                                   bc == nullptr || ntab <= 0)))
    return cudaErrorInvalidValue;
  const int cap = bwd_grid_cap();
  if (cap <= 0) return cudaErrorInvalidConfiguration;
  const int nb = (B + KROWS - 1) / KROWS;
  // at least a block a chunk of 32 parameters for the column sums (a
  // small batch's blocks would otherwise take them in turn)
  const int grid = min(max(nb, (kPack + 31) / 32), cap);
  void* args[] = {&pack,         (void*)&costs, (void*)&heights,
                  (void*)&widths, (void*)&z1,   (void*)&z2,
                  (void*)&dl,    (void*)&gscale, &part,
                  &grad,         &B,            &mu,
                  &nu,           &count,        (void*)&bc,
                  &ntab,         &b1,           &omb1,
                  &b2,           &omb2,         &eps,
                  &neg_lr};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)nnfme_bwd_kernel, dim3(grid), dim3(kThreads),
      args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#if defined(NNT_PHASES)
// the stamps, to host memory (16 * 4096 uint64), then cleared
extern "C" int hm_nnfme_stamps(void* out) {
  void* dev = nullptr;
  cudaError_t e = cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&dev, g_stamps);
  if (e == cudaSuccess) e = cudaMemset(dev, 0, sizeof(g_stamps));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}
#endif
