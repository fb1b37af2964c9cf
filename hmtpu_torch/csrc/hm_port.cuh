// What lets the lane code of the kernels compile both for the card
// (nvcc, sm_90a) and as host C++ (g++), so the CPU tests can drive it:
// function qualifiers, the barrier hook, float32 operations rounded one
// at a time (no FMA contraction: host builds use -ffp-contract=off), and
// the few intrinsics the lanes use.
//
// Block-cooperative code is written as functions of (tid, nt): thread
// `tid` of `nt` takes the items tid, tid + nt, ... of a loop, and
// HM_SYNC() is the block's barrier.  On the host nt = 1 and the barrier
// is empty, so the same code runs as one sequential thread.
//
// A function of (tid, nt) may also run in a group of the block: a run of
// nt consecutive threads (a multiple of 32) that starts at a multiple of
// nt, tid the index inside the run.  HM_GSYNC(nt) is the barrier of the
// caller's group.  A kernel whose source defines HM_GROUPS before its
// includes (K21, K23) gets the block's barrier when nt is the whole
// block, __syncwarp() for one warp, else a named barrier of its size and
// group (group_sync; 16 exist a block, 0 is the block's); every other
// kernel runs its groups as the whole block and gets the block's barrier
// alone.  Sums that are exact in any order reduce over a group with
// group_sum (integers) and group_sum_d (float64 multiples of 2^-15),
// argmins with group_argmin.
//
// Phase clocks: a build with HM_PHASE_CLOCK (scripts/pwalk_phases.py,
// iwalk_phases.py; never the encode path's) adds, on thread 0 of each
// block (HM_PH_STOP_IF: on the thread where its condition holds), the
// clock64() cycles between HM_PH_START(t) and HM_PH_STOP(k, t) to
// hm_ph_cycles[k] and one to hm_ph_count[k], and, on the block's last
// thread, the cycles it waits at each barrier to slot HM_PH_BAR.  Without
// it both are empty.
#pragma once

#include <math.h>
#include <stddef.h>

#if defined(__CUDACC__)
#define HM_FN __device__ __forceinline__
// host and device: what the launchers also call
#define HM_HD __host__ __device__ inline
// large lane functions: one copy in the kernel, called from many sites
#define HM_BIG __device__ __noinline__
#define HM_CONST __constant__
#define HM_SYNC() hm::block_sync()
#if defined(HM_GROUPS)
#define HM_GSYNC(nt) hm::group_sync(nt)
#else
#define HM_GSYNC(nt) ((void)(nt), hm::block_sync())
#endif
#define HM_FMUL(a, b) __fmul_rn((a), (b))
#define HM_FADD(a, b) __fadd_rn((a), (b))
#define HM_FSUB(a, b) __fsub_rn((a), (b))
#define HM_CLZ(x) __clz(x)
// the sum of the 4 bytes' absolute differences, the 2 halfwords'
// absolute differences (packed: max - min borrows nothing across the
// halves), and the funnel shift right of (hi:lo) by sh bits (0 <= sh <
// 32)
#define HM_VSADU4(a, b) __vsadu4((a), (b))
#define HM_VABSDIFFU2(a, b) (__vmaxu2((a), (b)) - __vminu2((a), (b)))
#define HM_FSHR(lo, hi, sh) __funnelshift_r((lo), (hi), (sh))
#define HM_UNROLL _Pragma("unroll")
#else
#define HM_FN inline
#define HM_HD inline
#define HM_BIG inline
#define HM_CONST static const
#define HM_SYNC() ((void)0)
#define HM_GSYNC(nt) ((void)(nt))
#define HM_FMUL(a, b) ((float)(a) * (float)(b))
#define HM_FADD(a, b) ((float)(a) + (float)(b))
#define HM_FSUB(a, b) ((float)(a) - (float)(b))
#define HM_CLZ(x) __builtin_clz(x)
#define HM_VSADU4(a, b) hm::vsadu4_host((a), (b))
#define HM_VABSDIFFU2(a, b) hm::vabsdiffu2_host((a), (b))
#define HM_FSHR(lo, hi, sh)                                         \
  ((unsigned)(((((unsigned long long)(hi)) << 32) | (unsigned)(lo)) >> \
              (sh)))
#define HM_UNROLL
#endif

namespace hm {

constexpr int HM_PH_N = 40;       // phase slots
constexpr int HM_PH_BAR = HM_PH_N - 1;
// the coding step's phases (walk.cuh code_tb, rdoq.cuh rdoq_tb), after a
// kernel's own slots: residual and transform, K10's set-up, the trellis'
// stages 1 to 3, the exact-rate guard, sign hiding, the TB rate, the
// levels' and dequantised output, inverse transform and SSE
constexpr int HM_PH_CODE = 27;
enum { PHC_FWD, PHC_INIT, PHC_S1, PHC_S2, PHC_S3, PHC_GUARD, PHC_SDH,
       PHC_BITS, PHC_OUT, PHC_INV, PHC_N };
static_assert(HM_PH_CODE + PHC_N <= HM_PH_BAR, "phase slots");

#if defined(__CUDACC__) && defined(HM_PHASE_CLOCK)
__device__ unsigned long long hm_ph_cycles[HM_PH_N];
__device__ unsigned long long hm_ph_count[HM_PH_N];
__device__ __forceinline__ long long ph_now() { return clock64(); }
__device__ __forceinline__ void ph_add(int k, long long t0) {
  if (threadIdx.x == 0) {
    atomicAdd(&hm_ph_cycles[k], (unsigned long long)(clock64() - t0));
    atomicAdd(&hm_ph_count[k], 1ull);
  }
}
__device__ __forceinline__ void ph_add_if(int k, long long t0, bool on) {
  if (on) {
    atomicAdd(&hm_ph_cycles[k], (unsigned long long)(clock64() - t0));
    atomicAdd(&hm_ph_count[k], 1ull);
  }
}
__device__ __forceinline__ void ph_bar(long long t0) {
  if (threadIdx.x == blockDim.x - 1) {
    atomicAdd(&hm_ph_cycles[HM_PH_BAR], (unsigned long long)(clock64() - t0));
    atomicAdd(&hm_ph_count[HM_PH_BAR], 1ull);
  }
}
#else
HM_FN long long ph_now() { return 0; }
HM_FN void ph_add(int, long long) {}
HM_FN void ph_add_if(int, long long, bool) {}
HM_FN void ph_bar(long long) {}
#endif
#define HM_PH_START(t) const long long t = hm::ph_now()
#define HM_PH_STOP(k, t) hm::ph_add((k), (t))
// the same, stamped by the thread where `on` holds (a team's first)
#define HM_PH_STOP_IF(k, t, on) hm::ph_add_if((k), (t), (on))

#if defined(__CUDACC__)
__device__ __forceinline__ void block_sync() {
  const long long t0 = ph_now();
  __syncthreads();
  ph_bar(t0);
}

#if defined(HM_GROUPS)
// groups of a block of at most 8 warps, each starting at a multiple of its
// size: a named barrier per (size, group), ids 1-4 for two warps, 5-6
// three, 7-8 four, 9, 10, 11 five, six, seven
__device__ __forceinline__ void group_sync(int nt) {
  const long long t0 = ph_now();
  if (nt >= (int)blockDim.x) {
    __syncthreads();
  } else if (nt == 32) {
    __syncwarp();
  } else {
    const int w = nt >> 5;
    const int base = w == 2 ? 1 : w == 3 ? 5 : w == 4 ? 7 : w + 4;
    asm volatile("bar.sync %0, %1;" ::"r"(base + (int)threadIdx.x / nt),
                 "r"(nt)
                 : "memory");
  }
  ph_bar(t0);
}
#endif

// the sum of v over the caller's group of nt threads, to every thread of
// it (exact: integers); red holds nt / 32 int64 of the group's own
__device__ __forceinline__ long long group_sum(long long v, int tid, int nt,
                                               long long* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (nt <= 32) return v;
  if ((tid & 31) == 0) red[tid >> 5] = v;
  HM_GSYNC(nt);
  long long s = 0;
  for (int w = 0; w < nt / 32; ++w) s += red[w];
  HM_GSYNC(nt);
  return s;
}

// the sum of v over the caller's group, to every thread of it, for sums
// that are exact in any order (float64 multiples of a power of two far
// from overflow); red holds nt / 32 float64 of the group's own
__device__ __forceinline__ double group_sum_d(double v, int tid, int nt,
                                              double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (nt <= 32) return v;
  if ((tid & 31) == 0) red[tid >> 5] = v;
  HM_GSYNC(nt);
  double s = 0.0;
  for (int w = 0; w < nt / 32; ++w) s += red[w];
  HM_GSYNC(nt);
  return s;
}

// the least (v, i) over the caller's group, v first, then the lower i, to
// every thread of it; red holds 32 int64 of the group's own
__device__ __forceinline__ void group_argmin(float& v, int& i, int tid,
                                             int nt, long long* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
  if (nt <= 32) return;
  float* rv = (float*)red;
  int* ri = (int*)red + 32;
  if ((tid & 31) == 0) {
    rv[tid >> 5] = v;
    ri[tid >> 5] = i;
  }
  HM_GSYNC(nt);
  v = rv[0];
  i = ri[0];
  for (int w = 1; w < nt / 32; ++w)
    if (rv[w] < v || (rv[w] == v && ri[w] < i)) {
      v = rv[w];
      i = ri[w];
    }
  HM_GSYNC(nt);
}
#else
inline long long group_sum(long long v, int, int, long long*) { return v; }
inline double group_sum_d(double v, int, int, double*) { return v; }
inline void group_argmin(float&, int&, int, int, long long*) {}
#endif

#if !defined(__CUDACC__)
// the host forms of HM_VSADU4 and HM_VABSDIFFU2
inline unsigned vsadu4_host(unsigned a, unsigned b) {
  unsigned s = 0;
  for (int k = 0; k < 32; k += 8) {
    const unsigned x = (a >> k) & 0xffu, y = (b >> k) & 0xffu;
    s += x > y ? x - y : y - x;
  }
  return s;
}
inline unsigned vabsdiffu2_host(unsigned a, unsigned b) {
  unsigned d = 0;
  for (int k = 0; k < 32; k += 16) {
    const unsigned x = (a >> k) & 0xffffu, y = (b >> k) & 0xffffu;
    d |= (x > y ? x - y : y - x) << k;
  }
  return d;
}
#endif

HM_FN int imin(int a, int b) { return a < b ? a : b; }
HM_FN int imax(int a, int b) { return a > b ? a : b; }
HM_FN int iclamp(int v, int lo, int hi) { return imin(imax(v, lo), hi); }
HM_FN int iabs(int v) { return v < 0 ? -v : v; }

}  // namespace hm
