// K7 mc_dctif: batched DCT-IF motion compensation (8-tap luma at
// quarter-pel, 4-tap chroma at eighth-pel, H.265 8.5.4.2.2), bit-exact
// with hmtpu/ops/interp.py:173 _mc_batch_jax as reached through
// mc_luma_batch :304, mc_chroma_batch :312, mc_luma_batch_refs :318 and
// mc_chroma_batch_refs :326.
//
// What bounds it on the H100: each call predicts a batch of small
// blocks (8..32 luma, 4..16 chroma; a few hundred to 1560 of them).
// Per output sample it reads at most (1 + 7/n)^2 reference samples and
// does 2 * ntaps multiply-adds, so the bytes (one int32 read of the
// patch, one int32 write per sample) bound it, and at the encoder's
// batch sizes the launch cost dominates both.
//
// Design: one thread block per predicted block.  The block's clamped
// (n_h + ntaps - 1) x (n_w + ntaps - 1) patch of its own reference (per
// block index into the stacked references) is gathered into shared
// memory once; the horizontal pass writes every patch row's filtered
// output to shared memory, and the vertical pass reads it.  The integer
// position and phase come from the MV inside the kernel: `mv >> 2`
// (`>> 3` chroma) is an arithmetic shift, so it floors for negative MVs
// as the reference does, and `mv & 3` (`& 7`) is the phase.  The
// intermediate stage subtracts the 14-bit offset only when both phases
// are non-zero; copy, H-only and V-only take the reference's own
// roundings.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hm_dsp.cuh"

namespace {

using hm::IF_FILTER_PREC;
using hm::IF_INTERNAL_OFFS;
using hm::IF_INTERNAL_PREC;
using hm::kLuma;

__constant__ int kChroma[8][4] = {
    {0, 64, 0, 0},   {-2, 58, 10, -2}, {-4, 54, 16, -2}, {-6, 46, 28, -4},
    {-4, 36, 36, -4}, {-4, 28, 46, -6}, {-2, 16, 54, -4}, {-2, 10, 58, -2}};

__global__ void mc_kernel(const int* __restrict__ refs,
                          const int* __restrict__ ridx,
                          const int* __restrict__ xs0,
                          const int* __restrict__ ys0,
                          const int* __restrict__ mvx,
                          const int* __restrict__ mvy, int* __restrict__ out,
                          int R, int H, int W, int nw, int nh, int chroma,
                          int bd) {
  extern __shared__ int sm[];
  const int b = blockIdx.x;
  const int ntaps = chroma ? 4 : 8;
  const int half = ntaps / 2 - 1;
  const int sh = chroma ? 3 : 2;
  const int msk = chroma ? 7 : 3;
  const int mx = mvx[b], my = mvy[b];
  const int x = xs0[b] + (mx >> sh);
  const int y = ys0[b] + (my >> sh);
  const int fx = mx & msk, fy = my & msk;
  // an out-of-range reference index clamps, as the reference's gather
  const int r = min(max(ridx[b], 0), R - 1);
  const int pw = nw + ntaps - 1, ph = nh + ntaps - 1;
  int* patch = sm;
  int* tmp = sm + ph * pw;
  const int* plane = refs + (size_t)r * H * W;

  for (int k = threadIdx.x; k < ph * pw; k += blockDim.x) {
    const int i = k / pw, j = k - (k / pw) * pw;
    const int yy = min(max(y - half + i, 0), H - 1);
    const int xx = min(max(x - half + j, 0), W - 1);
    patch[k] = plane[(size_t)yy * W + xx];
  }
  __syncthreads();

  const int* cx = chroma ? &kChroma[fx][0] : &kLuma[fx][0];
  const int* cy = chroma ? &kChroma[fy][0] : &kLuma[fy][0];
  const int shift1 = bd - 8;
  const bool both = fx != 0 && fy != 0;
  for (int k = threadIdx.x; k < ph * nw; k += blockDim.x) {
    const int i = k / nw, j = k - (k / nw) * nw;
    int acc = 0;
    for (int t = 0; t < ntaps; ++t) acc += cx[t] * patch[i * pw + j + t];
    tmp[k] = both ? (acc - (IF_INTERNAL_OFFS << shift1)) >> shift1 : acc;
  }
  __syncthreads();

  const int maxv = (1 << bd) - 1;
  const int shift2 = IF_FILTER_PREC + (IF_INTERNAL_PREC - bd);
  const int off2 = (1 << (shift2 - 1)) + (IF_INTERNAL_OFFS << IF_FILTER_PREC);
  int* o = out + (size_t)b * nh * nw;
  for (int k = threadIdx.x; k < nh * nw; k += blockDim.x) {
    const int i = k / nw, j = k - (k / nw) * nw;
    int v;
    if (fx == 0 && fy == 0) {
      v = patch[(i + half) * pw + j + half];
    } else if (fy == 0) {
      v = (tmp[(i + half) * nw + j] + 32) >> IF_FILTER_PREC;
    } else {
      int acc2 = 0;
      for (int t = 0; t < ntaps; ++t) acc2 += cy[t] * tmp[(i + t) * nw + j];
      // V-only: the horizontal pass was phase 0 (x64), so
      // (acc2 + (32 << 6)) >> 12 == (S + 32) >> 6
      v = fx == 0 ? (acc2 + (32 << IF_FILTER_PREC)) >> (2 * IF_FILTER_PREC)
                  : (acc2 + off2) >> shift2;
    }
    o[k] = min(max(v, 0), maxv);
  }
}

}  // namespace

extern "C" int hm_mc_dctif(const void* refs, const void* ridx, const void* xs0,
                           const void* ys0, const void* mvx, const void* mvy,
                           void* out, int nb, int R, int H, int W, int nw,
                           int nh, int chroma, int bd, void* stream) {
  if (nw < 1 || nh < 1 || nw > 64 || nh > 64 || R < 1 || bd < 8 || bd > 14)
    return cudaErrorInvalidValue;
  const int ntaps = chroma ? 4 : 8;
  const int pw = nw + ntaps - 1, ph = nh + ntaps - 1;
  const size_t smem = (size_t)(ph * pw + ph * nw) * sizeof(int);
  const int threads = nw * nh >= 256 ? 256 : 128;
  mc_kernel<<<nb, threads, smem, (cudaStream_t)stream>>>(
      (const int*)refs, (const int*)ridx, (const int*)xs0, (const int*)ys0,
      (const int*)mvx, (const int*)mvy, (int*)out, R, H, W, nw, nh, chroma,
      bd);
  return (int)cudaGetLastError();
}
