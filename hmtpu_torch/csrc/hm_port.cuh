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
#define HM_SYNC() __syncthreads()
#define HM_FMUL(a, b) __fmul_rn((a), (b))
#define HM_FADD(a, b) __fadd_rn((a), (b))
#define HM_FSUB(a, b) __fsub_rn((a), (b))
#define HM_CLZ(x) __clz(x)
#define HM_LDG(p) __ldg(p)
#else
#define HM_FN inline
#define HM_HD inline
#define HM_BIG inline
#define HM_CONST static const
#define HM_SYNC() ((void)0)
#define HM_FMUL(a, b) ((float)(a) * (float)(b))
#define HM_FADD(a, b) ((float)(a) + (float)(b))
#define HM_FSUB(a, b) ((float)(a) - (float)(b))
#define HM_CLZ(x) __builtin_clz(x)
#define HM_LDG(p) (*(p))
#endif

namespace hm {

HM_FN int imin(int a, int b) { return a < b ? a : b; }
HM_FN int imax(int a, int b) { return a > b ? a : b; }
HM_FN int iclamp(int v, int lo, int hi) { return imin(imax(v, lo), hi); }
HM_FN int iabs(int v) { return v < 0 ? -v : v; }

}  // namespace hm
