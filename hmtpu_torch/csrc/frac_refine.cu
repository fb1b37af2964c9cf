// K9 frac_refine: HM's two-stage fractional motion refinement
// (xPatternSearchFracDIF, TEncSearch.cpp:5232-5268), bit-exact with
// hmtpu/search/me.py:249 frac_refine_batch on a stacked reference with a
// reference index per block; and the P / B pass's three CU levels in one
// launch (hmtpu/encoder/pframe_dev.py:1667-1745: a level's blocks of the
// original, edge-padded at the 32 level, refined around its integer MVs
// against its union references).  The lane code is frac_refine.cuh.
//
// What bounds it on the H100: operations.  Per PU a stage filters the
// patch horizontally once a column of candidates with a sub-pel phase
// ((n + 8) x n sums of 8 taps) and each candidate's n x n samples
// vertically, then runs the 8x8 butterflies on the differences; the
// bytes (the (n + 8)^2 patch and the org block, read once) are far fewer.
//
// Design: a warp a PU, its patch and its column's horizontal sums in the
// warp's own shared memory, a lane a column of an 8x8 tile, an 8x8 PU's
// three candidates of a column side by side; the stage's argmin by
// shuffles (frac_refine.cuh).  Warps meet by __syncwarp only.  The levels
// form reads the original luma plane, the integer MVs and the reference
// indices in place, each block's position from its grid index.
#include <cuda_runtime.h>

#include "frac_refine.cuh"

namespace {

constexpr int kWarps = 2;  // warps a block

template <int N>
__global__ void __launch_bounds__(kWarps * 32)
    frac_kernel(const __grid_constant__ frac::Job a) {
  extern __shared__ int sm[];
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + w;
  if (b < a.nb) frac::warp_pu<N>(a, b, sm + w * frac::smem_ints(N));
}

__global__ void __launch_bounds__(kWarps * 32)
    frac_levels_kernel(const __grid_constant__ frac::Levels g, int stride) {
  extern __shared__ int sm[];
  frac::levels_warp(g, blockIdx.x * kWarps + (threadIdx.x >> 5),
                    sm + (threadIdx.x >> 5) * stride);
}

int blocks_for(int warps) { return (warps + kWarps - 1) / kWarps; }

// one job: the kernel of its PU size
int launch_one(const frac::Job& a, cudaStream_t st) {
  const size_t smem = kWarps * frac::smem_ints(a.n) * sizeof(int);
  if (a.n == 8) {
    frac_kernel<8><<<blocks_for(a.nb), kWarps * 32, smem, st>>>(a);
  } else if (a.n == 16) {
    frac_kernel<16><<<blocks_for(a.nb), kWarps * 32, smem, st>>>(a);
  } else {
    frac_kernel<32><<<blocks_for(a.nb), kWarps * 32, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

bool valid(int n, int R, int bd) {
  return (n == 8 || n == 16 || n == 32) && R >= 1 && bd >= 8 && bd <= 12;
}

}  // namespace

// the one-call form: refs (R, H, W), org (nb, n, n), ridx, xs0, ys0, the
// integer MVs (nb,) int32; out (2, nb)
extern "C" int hm_frac_refine(const void* refs, const void* ridx,
                              const void* xs0, const void* ys0,
                              const void* org, const void* imvx,
                              const void* imvy, void* out, int nb, int R,
                              int H, int W, int n, int bd, void* stream) {
  if (!valid(n, R, bd) || nb < 1) return cudaErrorInvalidValue;
  const frac::Job a{(const int*)refs, R, H, W, (const int*)org, 0, 0,
                    (const int*)xs0, (const int*)ys0, (const int*)ridx,
                    (const int*)imvx, (const int*)imvy, (int*)out, n, 0, nb,
                    bd};
  return launch_one(a, (cudaStream_t)stream);
}

// the levels form: refs (R, H, W), the original plane (oh, ow); for each
// of nlev levels its integer MVs and reference indices (nb,) (the grid in
// raster order), its output (2, nb) and (n, grid width, blocks)
extern "C" int hm_frac_levels(const void* refs, const void* org,
                              const void* mx0, const void* my0,
                              const void* r0, void* out0, const void* mx1,
                              const void* my1, const void* r1, void* out1,
                              const void* mx2, const void* my2,
                              const void* r2, void* out2, int R, int H,
                              int W, int oh, int ow, int nlev, int bd,
                              int n0, int gw0, int nb0, int n1, int gw1,
                              int nb1, int n2, int gw2, int nb2,
                              void* stream) {
  if (nlev < 1 || nlev > 3 || oh < 1 || ow < 1 || R < 1)
    return cudaErrorInvalidValue;
  const void* p[3][4] = {{mx0, my0, r0, out0},
                         {mx1, my1, r1, out1},
                         {mx2, my2, r2, out2}};
  const int geo[3][3] = {{n0, gw0, nb0}, {n1, gw1, nb1}, {n2, gw2, nb2}};
  frac::Levels g{};
  int total = 0, stride = 0;
  for (int l = 0; l < nlev; ++l) {
    const int n = geo[l][0], gw = geo[l][1], nb = geo[l][2];
    if (!valid(n, R, bd) || gw < 1 || nb < 0 || nb % gw)
      return cudaErrorInvalidValue;
    g.lv[l] = frac::Job{(const int*)refs, R, H, W, (const int*)org, oh, ow,
                        nullptr, nullptr, (const int*)p[l][2],
                        (const int*)p[l][0], (const int*)p[l][1],
                        (int*)p[l][3], n, gw, nb, bd};
    g.nb[l] = nb;
    total += nb;
    stride = stride > frac::smem_ints(n) ? stride : frac::smem_ints(n);
  }
  if (nlev == 1 && total)
    // one level (the extraction's): the kernel of its PU size alone
    return launch_one(g.lv[0], (cudaStream_t)stream);
  if (total)
    frac_levels_kernel<<<blocks_for(total), kWarps * 32,
                         kWarps * stride * sizeof(int),
                         (cudaStream_t)stream>>>(g, stride);
  return (int)cudaGetLastError();
}
