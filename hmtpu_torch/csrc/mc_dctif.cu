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
// Design (the arithmetic is mc_dctif.cuh's, shared with the P z-scan
// walker K23): one thread block per predicted block.  The block's clamped
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
//
// K11 mc_dctif_i (hm_mc_dctif_i) is the same kernel at intermediate
// precision, bit-exact with hmtpu/ops/interp.py:227 _mc_batch_jax_i as
// reached through mc_luma_batch_refs_i :281 and mc_chroma_batch_refs_i
// :288: the hypotheses of B-slice bi-prediction, int32 and unclipped,
// with HM's is_last=False rules (copy (s << (14 - bd)) - 8192; H-only and
// V-only (sum - (8192 << (bd - 8))) >> (bd - 8); both phases the
// intermediate stage then >> 6).  The offsets make the sums negative, so
// every shift is an arithmetic shift of a signed int.  Bound and design
// as K7's: one thread block per block, the patch staged in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mc_dctif.cuh"

namespace {

template <bool kInter>
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
  // an out-of-range reference index clamps, as the reference's gather
  const int r = min(max(ridx[b], 0), R - 1);
  hm::mc_block<kInter>(refs + (size_t)r * H * W, H, W, xs0[b], ys0[b], mvx[b],
                       mvy[b], nw, nh, chroma, bd, sm,
                       sm + hm::mc_patch_ints(nw, nh, chroma),
                       out + (size_t)b * nh * nw, threadIdx.x, blockDim.x);
}

template <bool kInter>
int launch_mc(const void* refs, const void* ridx, const void* xs0,
              const void* ys0, const void* mvx, const void* mvy, void* out,
              int nb, int R, int H, int W, int nw, int nh, int chroma, int bd,
              void* stream) {
  if (nw < 1 || nh < 1 || nw > 64 || nh > 64 || R < 1 || bd < 8 || bd > 14)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)(hm::mc_patch_ints(nw, nh, chroma) +
                               hm::mc_tmp_ints(nw, nh, chroma)) *
                      sizeof(int);
  const int threads = nw * nh >= 256 ? 256 : 128;
  mc_kernel<kInter><<<nb, threads, smem, (cudaStream_t)stream>>>(
      (const int*)refs, (const int*)ridx, (const int*)xs0, (const int*)ys0,
      (const int*)mvx, (const int*)mvy, (int*)out, R, H, W, nw, nh, chroma,
      bd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hm_mc_dctif(const void* refs, const void* ridx, const void* xs0,
                           const void* ys0, const void* mvx, const void* mvy,
                           void* out, int nb, int R, int H, int W, int nw,
                           int nh, int chroma, int bd, void* stream) {
  return launch_mc<false>(refs, ridx, xs0, ys0, mvx, mvy, out, nb, R, H, W,
                          nw, nh, chroma, bd, stream);
}

extern "C" int hm_mc_dctif_i(const void* refs, const void* ridx,
                             const void* xs0, const void* ys0, const void* mvx,
                             const void* mvy, void* out, int nb, int R, int H,
                             int W, int nw, int nh, int chroma, int bd,
                             void* stream) {
  return launch_mc<true>(refs, ridx, xs0, ys0, mvx, mvy, out, nb, R, H, W, nw,
                         nh, chroma, bd, stream);
}
