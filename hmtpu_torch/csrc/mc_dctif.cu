// K7 mc_dctif: batched DCT-IF motion compensation (8-tap luma at
// quarter-pel, 4-tap chroma at eighth-pel, H.265 8.5.4.2.2), bit-exact
// with hmtpu/ops/interp.py:173 _mc_batch_jax as reached through
// mc_luma_batch :304, mc_chroma_batch :312, mc_luma_batch_refs :318 and
// mc_chroma_batch_refs :326.  K11 mc_dctif_i (hm_mc_dctif_i, and
// hm_mc_forms with inter) is the same kernel at intermediate precision,
// bit-exact with :227 _mc_batch_jax_i as reached through
// mc_luma_batch_refs_i :281 and mc_chroma_batch_refs_i :288: the
// hypotheses of B-slice bi-prediction, int32 and unclipped, with HM's
// is_last=False rules (mc_dctif.cuh's roundings).
//
// What bounds it on the H100: each call predicts a batch of small
// blocks (8..32 luma, 4..16 chroma; a few hundred to 1560 of them).
// Per output sample it reads at most (1 + 7/n)^2 reference samples and
// does 2 * ntaps multiply-adds, so the bytes (the distinct reference
// samples, one int32 write per sample) bound it; at the encoder's batch
// sizes the launch and one block's chain of dependent loads dominate.
//
// Design (the arithmetic is mc_dctif.cuh's `mc_warp`): a warp a part of a
// predicted block (a whole block up to 8 wide, 4 rows of a wider one), 8
// warps a CTA, each warp's patch and intermediate rows in its own
// slice of shared memory; the passes separated by __syncwarp, no block
// barrier.  One launch takes up to three forms over the same blocks (grid
// (parts / warps a CTA, forms)): `hm_mc_forms` gives the P pass's AMVP
// hypotheses (luma n x n and the chroma pair n/2 x n/2 with the same
// reference and MV) and the NN gate's two MV sets of the same luma
// blocks, each block's position taken from its index on the level's grid
// (no position arrays); `hm_mc_dctif` / `hm_mc_dctif_i` are the one-form
// calls with a position per block.  Before, one 128-thread block a block
// (`hm::mc_block`, which the walkers K23 and K26 still run) and one
// launch a plane and an MV set.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mc_dctif.cuh"

namespace {

constexpr int kWarps = 8;

struct Forms {
  hm::McForm f0, f1, f2;
};

// form i by value (no address of the kernel's parameters is taken, which
// would copy them to the stack)
__device__ __forceinline__ hm::McForm form_of(const Forms& a, int i) {
  hm::McForm f;
  f.refs = i == 0 ? a.f0.refs : i == 1 ? a.f1.refs : a.f2.refs;
  f.out = i == 0 ? a.f0.out : i == 1 ? a.f1.out : a.f2.out;
  f.H = i == 0 ? a.f0.H : i == 1 ? a.f1.H : a.f2.H;
  f.W = i == 0 ? a.f0.W : i == 1 ? a.f1.W : a.f2.W;
  f.nw = i == 0 ? a.f0.nw : i == 1 ? a.f1.nw : a.f2.nw;
  f.nh = i == 0 ? a.f0.nh : i == 1 ? a.f1.nh : a.f2.nh;
  f.chroma = i == 0 ? a.f0.chroma : i == 1 ? a.f1.chroma : a.f2.chroma;
  f.mvset = i == 0 ? a.f0.mvset : i == 1 ? a.f1.mvset : a.f2.mvset;
  return f;
}

template <bool kInter>
__global__ void __launch_bounds__(kWarps * 32)
    mc_kernel(Forms fs, hm::McBlocks a, int per_warp) {
  extern __shared__ int sm[];
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x * kWarps + warp;
  const hm::McForm f = form_of(fs, blockIdx.y);
  const int parts = hm::mc_parts(f.nw, f.nh);
  if (g >= a.nb * parts) return;  // the whole warp: no barrier spans warps
  const int b = g / parts;
  hm::mc_form_block<kInter>(f, a, b, g - b * parts, sm + warp * per_warp);
}

int launch_mc(const Forms& fs, int nf, const hm::McBlocks& a, bool inter,
              void* stream) {
  const hm::McForm* f[3] = {&fs.f0, &fs.f1, &fs.f2};
  int per_warp = 0, parts = 0;
  for (int k = 0; k < nf; ++k) {
    const hm::McForm& g = *f[k];
    if (g.nw < 1 || g.nh < 1 || g.nw > 64 || g.nh > 64 || g.mvset < 0 ||
        g.mvset > 1 || g.H < 1 || g.W < 1)
      return cudaErrorInvalidValue;
    per_warp = std::max(per_warp, hm::mc_warp_ints(g.nw, g.nh, g.chroma));
    parts = std::max(parts, hm::mc_parts(g.nw, g.nh));
  }
  if (nf < 1 || nf > 3 || a.R < 1 || a.bd < 8 || a.bd > 14 ||
      (!a.xs0 && a.gw < 1))
    return cudaErrorInvalidValue;
  if (a.nb == 0) return 0;
  // at most 8 x 1,485 ints (64x64 luma's parts): under 48 KB
  const size_t smem = (size_t)kWarps * per_warp * sizeof(int);
  const dim3 grid((a.nb * parts + kWarps - 1) / kWarps, nf);
  if (inter)
    mc_kernel<true><<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
        fs, a, per_warp);
  else
    mc_kernel<false><<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
        fs, a, per_warp);
  return (int)cudaGetLastError();
}

int launch_one(const void* refs, const void* ridx, const void* xs0,
               const void* ys0, const void* mvx, const void* mvy, void* out,
               int nb, int R, int H, int W, int nw, int nh, int chroma, int bd,
               bool inter, void* stream) {
  Forms fs{};
  fs.f0 = hm::McForm{(const int*)refs, (int*)out, H, W, nw, nh, chroma, 0};
  const hm::McBlocks a{(const int*)ridx, (const int*)xs0, (const int*)ys0,
                       (const int*)mvx,  (const int*)mvy, nb, R, 0, bd};
  if (!xs0 || !ys0) return cudaErrorInvalidValue;
  return launch_mc(fs, 1, a, inter, stream);
}

}  // namespace

extern "C" int hm_mc_dctif(const void* refs, const void* ridx, const void* xs0,
                           const void* ys0, const void* mvx, const void* mvy,
                           void* out, int nb, int R, int H, int W, int nw,
                           int nh, int chroma, int bd, void* stream) {
  return launch_one(refs, ridx, xs0, ys0, mvx, mvy, out, nb, R, H, W, nw, nh,
                    chroma, bd, false, stream);
}

extern "C" int hm_mc_dctif_i(const void* refs, const void* ridx,
                             const void* xs0, const void* ys0, const void* mvx,
                             const void* mvy, void* out, int nb, int R, int H,
                             int W, int nw, int nh, int chroma, int bd,
                             void* stream) {
  return launch_one(refs, ridx, xs0, ys0, mvx, mvy, out, nb, R, H, W, nw, nh,
                    chroma, bd, true, stream);
}

// nf forms (1-3) of the same nb blocks of a grid gw cells wide: form k
// predicts n_k x n_k blocks from refs_k (R, H_k, W_k) into out_k with MV
// set mvset_k (mvx / mvy: nb entries a set)
extern "C" int hm_mc_forms(const void* refs0, const void* refs1,
                           const void* refs2, void* out0, void* out1,
                           void* out2, const void* ridx, const void* mvx,
                           const void* mvy, int nb, int nf, int R, int gw,
                           int bd, int inter, int H0, int W0, int n0,
                           int chroma0, int mvset0, int H1, int W1, int n1,
                           int chroma1, int mvset1, int H2, int W2, int n2,
                           int chroma2, int mvset2, void* stream) {
  Forms fs{};
  fs.f0 = hm::McForm{(const int*)refs0, (int*)out0, H0, W0, n0, n0, chroma0,
                     mvset0};
  fs.f1 = hm::McForm{(const int*)refs1, (int*)out1, H1, W1, n1, n1, chroma1,
                     mvset1};
  fs.f2 = hm::McForm{(const int*)refs2, (int*)out2, H2, W2, n2, n2, chroma2,
                     mvset2};
  const hm::McBlocks a{(const int*)ridx, nullptr, nullptr, (const int*)mvx,
                       (const int*)mvy,  nb,      R,       gw, bd};
  return launch_mc(fs, nf, a, inter != 0, stream);
}
