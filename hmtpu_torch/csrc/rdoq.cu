// K10 rdoq: rate-distortion optimised quantisation and the TB rate in one
// kernel, bit-exact with the port's plain versions of
// hmtpu/ops/rdoq.py:43 rdoq_tb, hmtpu/ops/ratebits.py:161 tb_bits and
// hmtpu/ops/quant.py:78,91 quantize_t / dequantize_t.  Per TB of a batch
// of one size (n = 4..32) it computes the levels (the RDOQ trellis, or
// deadzone quantisation plus the sign-data-hiding parity stage), the
// fractional-bit price of residual_coding() for them and the dequantised
// coefficients, each where the caller asks for it; or, given levels, only
// their price and dequantisation.
//
// What bounds it on the H100: neither roofline.  A TB reads n^2 int32
// coefficients and writes n^2 levels, n^2 dequantised values and one
// float; the work per coefficient is a few dozen float32 operations and
// table reads.  What costs is the chain of dependent steps inside a TB
// (the context state, the Rice adaptation, the last position, the
// order-fixed sums), which the plain version runs as hundreds of small
// tensor operations per call; here it is one launch per call.
//
// Design (the arithmetic is rdoq.cuh's, shared with the walkers K21, K23
// and K26): one lane per coefficient position, a CG on a half-warp, the
// context state from warp votes (rdoq.cuh).  A 4x4 TB takes a half-warp
// and an 8x8 TB a warp, several TBs a block (groups of the block with
// their own barriers, HM_GROUPS); a 16x16 TB takes 4 warps and a 32x32
// 8, a block each.  Each block builds the last-position table of its
// (size, component) once in shared memory before its TBs and, up to
// 16x16, stages there the context bits and the size's tables the TBs
// read; each TB's working set is in shared memory beside them.
//
// Parity with the plain version, which runs the same arithmetic:
//   - every cost is float32 in the plain version's order of operations,
//     with __fmul_rn / __fadd_rn / __fsub_rn so nvcc contracts nothing
//     into an FMA;
//   - sums are taken in float64 and rounded once to float32, as
//     ratebits.fsum does (the TB-rate sums are multiples of 2^-15 below
//     2^20, exact in any order; the others keep their order on one lane);
//   - the quantiser step 2^qbits / scale and the lambdas come from the
//     caller's tables; the kernel computes no exp2;
//   - every argmin keeps the first index of least value; right shifts of
//     negative ints are arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

#define HM_GROUPS  // groups of the block with their own barriers (hm_port.cuh)
#define HM_INLINE_BIG  // one call site: the coder inlined (hm_port.cuh)
#include "rdoq.cuh"

namespace {

// threads a TB, by log2 of its size; at 4 and 8, 128-thread blocks
__host__ __device__ constexpr int tb_threads(int log2) {
  return log2 == 2 ? 16 : log2 == 3 ? 32 : log2 == 4 ? 128 : 256;
}
constexpr int SMALL_BLOCK = 128;
constexpr int LPB_BYTES = 2 * hm::MAX_SIZE * sizeof(float);
// up to 16x16 a block stages the context bits K10 reads and the size's
// packed tables beside the last-position table (ops/rdoq.py
// _k10_tables: 7 npos + 2 ncg + 48 ints, 31 size floats)
constexpr int CB_FLOATS = 384;   // >= rdoq_cb_floats of the port's layout
__host__ __device__ constexpr int tab_ints(int log2) {
  return 7 * (1 << (2 * log2)) + 2 * ((1 << (2 * log2)) >> 4) + 48;
}
__host__ __device__ constexpr int tab_floats(int log2) {
  return 31 * (1 << log2);
}
__host__ __device__ constexpr int staged_bytes(int log2) {
  return log2 > 4 ? 0
                  : (CB_FLOATS + tab_ints(log2) + tab_floats(log2) + 1) / 2 *
                        8;
}

struct Params {
  hm::RdoqCfg c;
  const int* x;         // (B, n*n) raster coefficients, or levels
  const float* lam;     // device scalar lambda (trellis and SDH only)
  const int* scan_sel;  // (B,) coding scan of each TB, or null
  int* lev_out;         // (B, n*n) raster levels, or null
  int* deq_out;         // (B, n*n) dequantised coefficients, or null
  float* bits_out;      // (B,) TB rate, or null
  int nb;
  int ncb;              // context bits staged (0: read from device memory)
};

__global__ void __launch_bounds__(256) rdoq_kernel(Params P) {
  extern __shared__ double sm_raw[];
  const int log2 = P.c.log2, size = 1 << log2, npos = size * size;
  const int tt = tb_threads(log2);
  const int g = threadIdx.x / tt, t = threadIdx.x - g * tt;
  float* lpb = (float*)sm_raw;   // none without a context table (no
                                 // trellis, no rate asked)
  if (P.c.cb)
    hm::rdoq_last_bits(P.c.cb, P.c.tabs_f, P.c.ctx_x, P.c.ctx_y, size, lpb,
                       threadIdx.x, blockDim.x);
  const int staged = staged_bytes(log2);
  float* cbs = lpb + 2 * hm::MAX_SIZE;
  int* tis = (int*)(cbs + CB_FLOATS);
  float* tfs = (float*)(tis + tab_ints(log2));
  if (staged) {
    for (int k = threadIdx.x; k < P.ncb; k += blockDim.x) cbs[k] = P.c.cb[k];
    for (int k = threadIdx.x; k < tab_ints(log2); k += blockDim.x)
      tis[k] = P.c.tabs_i[k];
    for (int k = threadIdx.x; k < tab_floats(log2); k += blockDim.x)
      tfs[k] = P.c.tabs_f[k];
  }
  __syncthreads();
  const int b = blockIdx.x * (blockDim.x / tt) + g;
  if (b >= P.nb) return;   // a group past the batch's end
  hm::RdoqSmem S = hm::rdoq_smem(
      (char*)sm_raw + LPB_BYTES + staged + g * hm::rdoq_smem_bytes(log2),
      npos);
  hm::RdoqCfg c = P.c;
  c.lpb = lpb;
  if (staged) {
    c.tabs_i = tis;
    c.tabs_f = tfs;
    if (P.ncb) c.cb = cbs;
  }
  const bool lev_in = c.flags & hm::F_LEV_IN;
  const float lam =
      (c.flags & (hm::F_TRELLIS | hm::F_SDH)) && !lev_in ? *P.lam : 0.f;
  const size_t o = (size_t)b * npos;
  const float bits = hm::rdoq_tb(
      c, lam, P.scan_sel ? P.scan_sel[b] : -1, P.x + o,
      P.lev_out ? P.lev_out + o : nullptr, P.deq_out ? P.deq_out + o : nullptr,
      P.bits_out != nullptr, S, t, tt);
  if (P.bits_out && t == 0) P.bits_out[b] = bits;
}

}  // namespace

extern "C" int hm_rdoq(const void* x, const void* cb, const void* lam,
                       const void* scan_sel, const void* tabs_i,
                       const void* tabs_f, void* lev_out, void* deq_out,
                       void* bits_out, int nb, int log2, int flags, int scale,
                       int qbits, int add, int iscale, int dq_shift,
                       int ctx_x, int ctx_y, int sig_cg_base, int one_base,
                       int abs_base, float inv, float cscale, void* stream) {
  if (log2 < 2 || log2 > 5 || nb < 0 || qbits < 1 || qbits > 30 ||
      dq_shift < -20 || dq_shift > 20)
    return cudaErrorInvalidValue;
  if (!(flags & hm::F_LEV_IN) && (flags & (hm::F_TRELLIS | hm::F_SDH)) &&
      !lam)
    return cudaErrorInvalidValue;
  Params P;
  P.c.cb = (const float*)cb;
  P.c.tabs_i = (const int*)tabs_i;
  P.c.tabs_f = (const float*)tabs_f;
  P.c.log2 = log2;
  P.c.flags = flags;
  P.c.scale = scale;
  P.c.qbits = qbits;
  P.c.add = add;
  P.c.iscale = iscale;
  P.c.dq_shift = dq_shift;
  P.c.ctx_x = ctx_x;
  P.c.ctx_y = ctx_y;
  P.c.sig_cg_base = sig_cg_base;
  P.c.one_base = one_base;
  P.c.abs_base = abs_base;
  P.c.inv = inv;
  P.c.cscale = cscale;
  P.x = (const int*)x;
  P.lam = (const float*)lam;
  P.scan_sel = (const int*)scan_sel;
  P.lev_out = (int*)lev_out;
  P.deq_out = (int*)deq_out;
  P.bits_out = (float*)bits_out;
  P.nb = nb;
  const int ncb = hm::rdoq_cb_floats(abs_base);
  P.ncb = cb && ncb <= CB_FLOATS ? ncb : 0;
  const int tt = tb_threads(log2);
  const int threads = tt < SMALL_BLOCK ? SMALL_BLOCK : tt;
  const int per = threads / tt;   // TBs a block
  const size_t smem =
      LPB_BYTES + staged_bytes(log2) + per * hm::rdoq_smem_bytes(log2);
  static_assert(LPB_BYTES + hm::rdoq_smem_bytes(5) <= 48 * 1024 &&
                    LPB_BYTES + staged_bytes(4) + hm::rdoq_smem_bytes(4) <=
                        48 * 1024 &&
                    LPB_BYTES + staged_bytes(3) +
                            4 * hm::rdoq_smem_bytes(3) <= 48 * 1024,
                "K10's shared memory without the opt-in");
  if (nb > 0)
    rdoq_kernel<<<(nb + per - 1) / per, threads, smem,
                  (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
