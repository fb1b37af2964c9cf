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
// table reads.  What costs is the chain of dependent scans inside a TB
// (the greater-1 context state, the Rice adaptation, the last-position
// search), which the plain version runs as hundreds of small tensor
// operations per call; here it is one launch per call.
//
// Design (the arithmetic is rdoq.cuh's, shared with the I z-scan walker
// K21): one thread block per TB, one thread per 4x4 coefficient group
// (CG; up to 64).  Coefficients, levels and per-position costs sit in
// shared memory in the coding scan order; a CG's thread walks its 16
// positions in reverse scan order, which is the coder's order, and
// carries the context state (rank, greater-1 count, Rice parameter) in
// registers.  The few TB-wide scans (last position, the prefix and
// suffix sums of stage 3, the order-fixed float64 sums) run on thread 0.
// The context table is read through the read-only cache.
//
// Parity with the plain version, which runs the same arithmetic:
//   - every cost is float32 in the plain version's order of operations,
//     with __fmul_rn / __fadd_rn / __fsub_rn so nvcc contracts nothing
//     into an FMA;
//   - sums are taken in float64 and rounded once to float32, as
//     ratebits.fsum does (the TB-rate sums are multiples of 2^-15 below
//     2^20, exact in any order);
//   - the quantiser step 2^qbits / scale and the lambdas come from the
//     caller's tables; the kernel computes no exp2;
//   - every argmin keeps the first index of least value; right shifts of
//     negative ints are arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rdoq.cuh"

namespace {

struct Params {
  hm::RdoqCfg c;
  const int* x;         // (B, n*n) raster coefficients, or levels
  const float* lam;     // device scalar lambda (trellis and SDH only)
  const int* scan_sel;  // (B,) coding scan of each TB, or null
  int* lev_out;         // (B, n*n) raster levels, or null
  int* deq_out;         // (B, n*n) dequantised coefficients, or null
  float* bits_out;      // (B,) TB rate, or null
};

__global__ void rdoq_kernel(Params P) {
  extern __shared__ double sm_raw[];
  const int npos = 1 << (2 * P.c.log2);
  hm::RdoqSmem S = hm::rdoq_smem(sm_raw, npos);
  const int b = blockIdx.x, t = threadIdx.x;
  const bool lev_in = P.c.flags & hm::F_LEV_IN;
  const float lam =
      (P.c.flags & (hm::F_TRELLIS | hm::F_SDH)) && !lev_in ? *P.lam : 0.f;
  const size_t o = (size_t)b * npos;
  const float bits = hm::rdoq_tb(
      P.c, lam, P.scan_sel ? P.scan_sel[b] : -1, P.x + o,
      P.lev_out ? P.lev_out + o : nullptr, P.deq_out ? P.deq_out + o : nullptr,
      P.bits_out != nullptr, S, t, blockDim.x);
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
  const int ncg = (1 << (2 * log2)) >> 4;
  const size_t smem = hm::rdoq_smem_bytes(log2);
  const int threads = ncg > 32 ? 64 : 32;
  if (nb > 0)
    rdoq_kernel<<<nb, threads, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
