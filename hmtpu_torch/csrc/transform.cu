// K1 int_transform: the two-stage integer DCT (n = 4, 8, 16, 32) and the
// 4x4 DST of H.265 8.6.4, forward and inverse, bit-exact with
// hmtpu/ops/transform.py:38 forward_transform and :58 inverse_transform.
//
// What bounds it on the H100: at the encoder's shapes (a few hundred
// TBs per call at most, often a handful) the call is bound by launch
// cost; the data moved is one int32 read and one int32 write per
// coefficient, and the work is 2n multiply-adds per coefficient in
// int32, far below either roofline.  PyTorch has no int32 matrix
// product on CUDA, which is why this is a kernel at all.
//
// Design (the arithmetic is transform.cuh's, shared with the I z-scan
// walker K21): one thread per coefficient, G = 256 / n^2 TBs per block (one
// TB of 1024 threads at n = 32).  The transform matrix and the block's
// TBs are staged in shared memory; stage 1 writes its rounded (and,
// inverse, clipped) intermediate to shared memory, one barrier, stage 2
// reads it.  Accumulation is int32: |sum| <= n * 90 * 2^15 < 2^31.
//
// Level forms (hm_fwd_level, hm_inv_level; transform.cuh "K1's level
// forms"): the P and B passes' coding step around K10,
// hmtpu/encoder/pframe_dev.py:188 `_code` with `hypothesis`'s combine,
// for a CU level's three planes (or one plane) in one launch each: the
// forward forms org - pred and transforms it; the inverse transforms
// K10's dequantised coefficients and writes rec = clip(pred + r, 0,
// 2^bd - 1), each TB's SSE (the integer sum of (org - rec)^2, one
// float32 conversion, times dw on chroma) and, three planes, each
// block's cbf, dist = (dy + du) + dv and bits = (by + bu) + bv.  Bound by
// bytes (12 B a sample forward, 20 B inverse) and, at the P pass's
// shapes (150k samples a level at 416x240, under a microsecond at 3.35
// TB/s), by the chain of a TB's loads, two 1-D butterflies and its
// stores.  A TB on n lanes of a warp, a row (or column) a lane in
// registers, 16-byte loads of both planes' rows in one round, the two
// stages through the warp's padded tile in shared memory; a thread
// block of g = 32 / n blocks (one at n = 32) holds the level's three
// planes of those blocks, two warps (one for one plane).  Replaces the
// two launches a plane and the torch operations around them.
//
// TS mode (mode bit 9; transform.cuh "The transform-skip pair"): the 4x4
// transform skip of 8.6.4.2 (hmtpu/ops/transform.py:84 transform_skip_fwd,
// resi << ts_shift; :89 transform_skip_inv, ((d << (5 + log2)) + (1 <<
// (bdShift - 1))) >> bdShift clipped to 16 bits) folded into the level
// forms with `_code_ts_sel`'s pick: the forward writes a TS plane's
// coefficients both ways in one launch, the inverse reconstructs, prices
// and picks the pair in one.  The shift alone was bound by its launch; in
// the level forms it adds a store a row to the forward and a load and a
// reconstruction a row to the inverse, and the pick's torch operations
// (the SSE, the flag's price, the RD compare, the selects) are gone.
#include <cuda_runtime.h>
#include <stdint.h>

#include "transform.cuh"

namespace {

template <bool INV>
__global__ void transform_kernel(const int* __restrict__ x,
                                 const int* __restrict__ t,
                                 int* __restrict__ out, int nb, int n,
                                 int shift1, int shift2) {
  extern __shared__ int smem[];
  const int nn = n * n;
  const int groups = blockDim.x / nn;
  int* s_t = smem;
  int* s_x = s_t + nn;
  int* s_tmp = s_x + groups * nn;
  for (int k = threadIdx.x; k < nn; k += blockDim.x) s_t[k] = t[k];
  const int g = threadIdx.x / nn;
  const int e = threadIdx.x - g * nn;
  const int i = e / n;
  const int j = e - i * n;
  const long long tb = (long long)blockIdx.x * groups + g;
  const bool valid = tb < nb;
  s_x[threadIdx.x] = valid ? x[tb * nn + e] : 0;
  __syncthreads();
  int* TMP = s_tmp + g * nn;
  TMP[e] = hm::tr_stage1<INV>(s_t, s_x + g * nn, n, i, j, shift1);
  __syncthreads();
  const int r = hm::tr_stage2<INV>(s_t, TMP, n, i, j, shift2);
  if (valid) out[tb * nn + e] = r;
}

template <bool INV>
int launch(const void* x, const void* t, void* out, int nb, int n,
           int shift1, int shift2, void* stream) {
  if (n != 4 && n != 8 && n != 16 && n != 32) return cudaErrorInvalidValue;
  const int nn = n * n;
  const int groups = nn >= 256 ? 1 : 256 / nn;
  const int threads = groups * nn;
  const int blocks = (nb + groups - 1) / groups;
  const size_t smem = (size_t)(nn + 2 * groups * nn) * sizeof(int);
  transform_kernel<INV><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int*)x, (const int*)t, (int*)out, nb, n, shift1, shift2);
  return (int)cudaGetLastError();
}

template <bool INV>
__device__ __forceinline__ void level_body(const hm::LevelArgs& a) {
  __shared__ int sm[hm::kLevelWarps][hm::kLevelTile];
  __shared__ hm::LevelSums s;
  const int w = threadIdx.x >> 5;
  hm::level_warp<INV>(a, blockIdx.x, w, sm[w], s);
  if (INV) {
    __syncthreads();
    hm::level_combine(a, blockIdx.x, s, threadIdx.x, blockDim.x);
  }
}

__global__ void __launch_bounds__(hm::kLevelWarps * 32)
    fwd_level_kernel(hm::LevelArgs a) {
  level_body<false>(a);
}

__global__ void __launch_bounds__(hm::kLevelWarps * 32)
    inv_level_kernel(hm::LevelArgs a) {
  level_body<true>(a);
}

int launch_level(bool inv, const hm::LevelArgs& a, void* stream) {
  const int bd = a.mode & 255;
  if ((a.planes != 1 && a.planes != 3) || a.m < 1 || bd < 8 || bd > 12 ||
      (a.n0 != 4 && a.n0 != 8 && a.n0 != 16 && a.n0 != 32) ||
      (a.planes == 3 && (a.n1 * 2 != a.n0 || a.n1 < 4)))
    return cudaErrorInvalidValue;
  if ((a.mode >> 9) & 1) {  // the TS pair: 4x4 planes, every pointer given
    if ((a.planes == 1 ? a.n0 : a.n1) != 4) return cudaErrorInvalidValue;
    for (int k = 0; k < a.planes; ++k) {
      if (!hm::level_ts(a, k)) continue;
      if (inv ? (a.tdeq[k] == nullptr || a.tlev[k] == nullptr ||
                 a.tbits[k] == nullptr || a.bits[k] == nullptr ||
                 a.levk[k] == nullptr || a.bitk[k] == nullptr)
              : a.tcoef[k] == nullptr)
        return cudaErrorInvalidValue;
    }
    if (inv && (a.tsflag == nullptr || a.lam == nullptr || a.ts == nullptr))
      return cudaErrorInvalidValue;
  }
  const int threads = hm::level_threads(a.n0, a.n1, a.planes);
  const int g = hm::level_g(a.n0);
  if (threads > hm::kLevelWarps * 32 || threads % 32 != 0 || g > 8)
    return cudaErrorInvalidValue;
  const int blocks = (a.m + g - 1) / g;
  if (inv)
    inv_level_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  else
    fwd_level_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hm_int_transform_fwd(const void* x, const void* t, void* out,
                                    int nb, int n, int shift1, int shift2,
                                    void* stream) {
  return launch<false>(x, t, out, nb, n, shift1, shift2, stream);
}

extern "C" int hm_int_transform_inv(const void* x, const void* t, void* out,
                                    int nb, int n, int shift1, int shift2,
                                    void* stream) {
  return launch<true>(x, t, out, nb, n, shift1, shift2, stream);
}

// a level's planes (1 or 3): org, pred, coef of each, and the TS
// coefficients of the TS planes (or null); (blocks, luma n, chroma n,
// planes, bit depth | use_dst << 8 | ts << 9)
extern "C" int hm_fwd_level(const void* o0, const void* o1, const void* o2,
                            const void* p0, const void* p1, const void* p2,
                            void* c0, void* c1, void* c2, void* t0, void* t1,
                            void* t2, int m, int n0, int n1, int planes,
                            int mode, void* stream) {
  hm::LevelArgs a{};
  a.org[0] = (const int*)o0, a.org[1] = (const int*)o1,
  a.org[2] = (const int*)o2;
  a.pred[0] = (const int*)p0, a.pred[1] = (const int*)p1,
  a.pred[2] = (const int*)p2;
  a.coef[0] = (int*)c0, a.coef[1] = (int*)c1, a.coef[2] = (int*)c2;
  a.tcoef[0] = (int*)t0, a.tcoef[1] = (int*)t1, a.tcoef[2] = (int*)t2;
  a.m = m, a.n0 = n0, a.n1 = n1, a.planes = planes, a.mode = mode;
  return launch_level(false, a, stream);
}

// deq, lev, pred, org and K10's bits of each plane, dw (or null); rec and
// sse of each, and cbf, dist and bitsum (three planes); ts (a host array,
// or null without the TS pair) the TS planes' device pointers, by plane:
// tdeq[3], tlev[3], tbits[3], the flag's two prices, lam, levk[3],
// bitk[3], the ts word; as hm_fwd_level
extern "C" int hm_inv_level(
    const void* d0, const void* d1, const void* d2, const void* l0,
    const void* l1, const void* l2, const void* p0, const void* p1,
    const void* p2, const void* o0, const void* o1, const void* o2,
    const void* b0, const void* b1, const void* b2, const void* dw,
    void* r0, void* r1, void* r2, void* s0, void* s1, void* s2, void* cbf,
    void* dist, void* bitsum, const void* const* ts, int m, int n0, int n1,
    int planes, int mode, void* stream) {
  hm::LevelArgs a{};
  a.deq[0] = (const int*)d0, a.deq[1] = (const int*)d1,
  a.deq[2] = (const int*)d2;
  a.lev[0] = (const int*)l0, a.lev[1] = (const int*)l1,
  a.lev[2] = (const int*)l2;
  a.pred[0] = (const int*)p0, a.pred[1] = (const int*)p1,
  a.pred[2] = (const int*)p2;
  a.org[0] = (const int*)o0, a.org[1] = (const int*)o1,
  a.org[2] = (const int*)o2;
  a.bits[0] = (const float*)b0, a.bits[1] = (const float*)b1,
  a.bits[2] = (const float*)b2;
  a.dw = (const float*)dw;
  a.rec[0] = (int*)r0, a.rec[1] = (int*)r1, a.rec[2] = (int*)r2;
  a.sse[0] = (float*)s0, a.sse[1] = (float*)s1, a.sse[2] = (float*)s2;
  a.cbf = (int*)cbf, a.dist = (float*)dist, a.bitsum = (float*)bitsum;
  if (ts != nullptr) {
    for (int k = 0; k < 3; ++k) {
      a.tdeq[k] = (const int*)ts[k];
      a.tlev[k] = (const int*)ts[3 + k];
      a.tbits[k] = (const float*)ts[6 + k];
      a.levk[k] = (int*)ts[11 + k];
      a.bitk[k] = (float*)ts[14 + k];
    }
    a.tsflag = (const float*)ts[9];
    a.lam = (const float*)ts[10];
    a.ts = (int*)ts[17];
  } else if ((mode >> 9) & 1) {
    return cudaErrorInvalidValue;
  }
  a.m = m, a.n0 = n0, a.n1 = n1, a.planes = planes, a.mode = mode;
  if (planes == 3 && (b0 == nullptr || b1 == nullptr || b2 == nullptr ||
                      cbf == nullptr || dist == nullptr || bitsum == nullptr))
    return cudaErrorInvalidValue;
  return launch_level(true, a, stream);
}
