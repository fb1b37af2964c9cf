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
// group_sum (integers) and group_sums_d (float64 multiples of 2^-15),
// argmins with group_argmin.
//
// Lanes (the coding step's CGs, K22's tiles): code written for a set of
// W consecutive threads of a group (W = 4, 8, 16 or 32; the set starts at a
// multiple of W), each holding one lane's value.  On the card a
// `Lanes<T, W>` is the thread's own register, HM_LANES(j, W) runs its
// body once as lane j, and `ballot`, `lane_get`, `lane_xor`, `lane_sum`,
// `lane_or` and `lane_argmin` (float or int values) are warp votes,
// shuffles and reductions over the set's mask.  On the host one thread
// holds all W values and HM_LANES loops over them, in order or
// (lane_reverse) last lane first, so the CPU tests can show that no lane
// reads what another lane of the same loop writes; the helpers loop over
// the values and compute the same thing.
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
// (a kernel that calls them from one site defines HM_INLINE_BIG before
// its includes, and gets them inlined: no call frames, no spills)
#if defined(HM_INLINE_BIG)
#define HM_BIG __device__ __forceinline__
#else
#define HM_BIG __device__ __noinline__
#endif
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
#define HM_FDIV(a, b) __fdiv_rn((a), (b))
#define HM_FSQRT(a) __fsqrt_rn(a)
#define HM_CLZ(x) __clz(x)
#define HM_POPC(x) __popc(x)
#define HM_CLZ64(x) __clzll((long long)(x))
#define HM_CTZ64(x) (__ffsll((long long)(x)) - 1)
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
#define HM_FDIV(a, b) ((float)(a) / (float)(b))
#define HM_FSQRT(a) sqrtf((float)(a))
#define HM_CLZ(x) __builtin_clz(x)
#define HM_POPC(x) __builtin_popcount(x)
#define HM_CLZ64(x) __builtin_clzll(x)
#define HM_CTZ64(x) __builtin_ctzll(x)
#define HM_VSADU4(a, b) hm::vsadu4_host((a), (b))
#define HM_VABSDIFFU2(a, b) hm::vabsdiffu2_host((a), (b))
#define HM_FSHR(lo, hi, sh)                                         \
  ((unsigned)(((((unsigned long long)(hi)) << 32) | (unsigned)(lo)) >> \
              (sh)))
#define HM_UNROLL
#endif

namespace hm {

constexpr int HM_PH_N = 48;       // phase slots
constexpr int HM_PH_BAR = HM_PH_N - 1;
// the coding step's phases (walk.cuh code_tb, rdoq.cuh rdoq_tb), after a
// kernel's own slots: residual and transform, K10's set-up, the trellis'
// stages 1 to 3, the exact-rate guard, sign hiding, the TB rate, the
// levels' and dequantised output, inverse transform and SSE; then the
// sub-steps of rdoq.cuh (every call of tb_bits: its CG flags and last
// position, the position pass, the sums, the tail; the trellis' prelude
// and stage 1's position pass; the guard's distortion sums) and the
// stamping thread's wait at barriers inside rdoq_tb
constexpr int HM_PH_CODE = 27;
enum { PHC_FWD, PHC_INIT, PHC_S1, PHC_S2, PHC_S3, PHC_GUARD, PHC_SDH,
       PHC_BITS, PHC_OUT, PHC_INV, PHC_TB_FLAGS, PHC_TB_POS, PHC_TB_SUMS,
       PHC_TB_TAIL, PHC_T_PRE, PHC_T_S1P, PHC_XRD, PHC_WAIT, PHC_N };
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
// thread 0's mark that it is inside rdoq_tb (a magic value, so that the
// uninitialised word reads as outside)
constexpr int PH_IN_CODE = 0x5a17c0de;
__device__ __forceinline__ int& ph_in_code() {
  __shared__ int in_code;
  return in_code;
}
__device__ __forceinline__ void ph_code(bool on) {
  if (threadIdx.x == 0) ph_in_code() = on ? PH_IN_CODE : 0;
}
__device__ __forceinline__ void ph_bar(long long t0) {
  if (threadIdx.x == blockDim.x - 1) {
    atomicAdd(&hm_ph_cycles[HM_PH_BAR], (unsigned long long)(clock64() - t0));
    atomicAdd(&hm_ph_count[HM_PH_BAR], 1ull);
  }
  if (threadIdx.x == 0 && ph_in_code() == PH_IN_CODE) {
    atomicAdd(&hm_ph_cycles[HM_PH_CODE + PHC_WAIT],
              (unsigned long long)(clock64() - t0));
    atomicAdd(&hm_ph_count[HM_PH_CODE + PHC_WAIT], 1ull);
  }
}
#else
HM_FN long long ph_now() { return 0; }
HM_FN void ph_add(int, long long) {}
HM_FN void ph_add_if(int, long long, bool) {}
HM_FN void ph_bar(long long) {}
HM_FN void ph_code(bool) {}
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
// three, 7-8 four, 9, 10, 11 five, six, seven; a part of a warp (8 or 16
// threads) syncs its own lanes
__device__ __forceinline__ void group_sync(int nt) {
  const long long t0 = ph_now();
  if (nt >= (int)blockDim.x) {
    __syncthreads();
  } else if (nt == 32) {
    __syncwarp();
  } else if (nt < 32) {
    __syncwarp(((1u << nt) - 1) << (threadIdx.x & 31 & ~(nt - 1)));
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

// the mask of the caller's warp, or of its part when the group is less
// than a warp (8 or 16 threads)
__device__ __forceinline__ unsigned group_mask(int nt) {
  return nt >= 32 ? 0xffffffffu
                  : ((1u << nt) - 1) << (threadIdx.x & 31 & ~(nt - 1));
}

// the sum of v over the caller's group of nt threads, to every thread of
// it (exact: integers); red holds nt / 32 int64 of the group's own
__device__ __forceinline__ long long group_sum(long long v, int tid, int nt,
                                               long long* red) {
  const unsigned m = group_mask(nt);
  for (int o = (nt < 32 ? nt : 32) >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(m, v, o);
  if (nt <= 32) return v;
  if ((tid & 31) == 0) red[tid >> 5] = v;
  HM_GSYNC(nt);
  long long s = 0;
  for (int w = 0; w < nt / 32; ++w) s += red[w];
  HM_GSYNC(nt);
  return s;
}

// K sums at once (v[0..K)), each exact in any order (float64 multiples
// of a power of two far from overflow), to every thread of the group;
// red holds K * nt / 32 float64 of the group's own
template <int K>
__device__ __forceinline__ void group_sums_d(double* v, int tid, int nt,
                                             double* red) {
  const unsigned m = group_mask(nt);
  for (int o = (nt < 32 ? nt : 32) >> 1; o > 0; o >>= 1) {
    HM_UNROLL
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(m, v[k], o);
  }
  if (nt <= 32) return;
  if ((tid & 31) == 0) {
    HM_UNROLL
    for (int k = 0; k < K; ++k) red[(tid >> 5) * K + k] = v[k];
  }
  HM_GSYNC(nt);
  HM_UNROLL
  for (int k = 0; k < K; ++k) {
    double s = 0.0;
    for (int w = 0; w < nt / 32; ++w) s += red[w * K + k];
    v[k] = s;
  }
  HM_GSYNC(nt);
}

// the least (v, i) over the caller's group, v first, then the lower i, to
// every thread of it; red holds 32 int64 of the group's own
__device__ __forceinline__ void group_argmin(float& v, int& i, int tid,
                                             int nt, long long* red) {
  const unsigned m = group_mask(nt);
  for (int o = (nt < 32 ? nt : 32) >> 1; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(m, v, o);
    const int oi = __shfl_xor_sync(m, i, o);
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
template <int K>
inline void group_sums_d(double*, int, int, double*) {}
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

// ---------------------------------------------------------------------------
// Lanes (see the top of the file)

#if defined(__CUDACC__)
template <class T, int W>
struct Lanes {
  T v;
  __device__ __forceinline__ T& operator[](int) { return v; }
  __device__ __forceinline__ const T& operator[](int) const { return v; }
};
#define HM_LANES(j, W) \
  for (int j = (int)(threadIdx.x & ((W) - 1)), j##_1 = 1; j##_1; j##_1 = 0)

// the set's lanes in its warp, and where they start
template <int W>
__device__ __forceinline__ unsigned lane_mask() {
  return W == 32 ? 0xffffffffu
                 : ((1u << W) - 1) << (threadIdx.x & 31 & ~(W - 1));
}
template <int W>
__device__ __forceinline__ unsigned lane_base() {
  return threadIdx.x & 31 & ~(W - 1);
}
// bit j: lane j's p
template <int W>
__device__ __forceinline__ unsigned ballot(const Lanes<bool, W>& p) {
  return __ballot_sync(lane_mask<W>(), p.v) >> lane_base<W>();
}
// lane src's value, to every lane
template <class T, int W>
__device__ __forceinline__ T lane_get(const Lanes<T, W>& x, int src) {
  return __shfl_sync(lane_mask<W>(), x.v, src, W);
}
// lane j ^ m's value, to lane j
template <class T, int W>
__device__ __forceinline__ Lanes<T, W> lane_xor(const Lanes<T, W>& x,
                                                int m) {
  return Lanes<T, W>{__shfl_xor_sync(lane_mask<W>(), x.v, m, W)};
}
template <int W>
__device__ __forceinline__ int lane_sum(const Lanes<int, W>& x) {
  return __reduce_add_sync(lane_mask<W>(), x.v);
}
template <int W>
__device__ __forceinline__ unsigned lane_or(const Lanes<unsigned, W>& x) {
  return __reduce_or_sync(lane_mask<W>(), x.v);
}
// the least (x, key) over the lanes, x first, then the lower key, to
// every lane
template <class T, int W>
__device__ __forceinline__ void lane_argmin(const Lanes<T, W>& x,
                                            const Lanes<int, W>& key, T& v,
                                            int& k) {
  v = x.v;
  k = key.v;
  for (int o = W >> 1; o > 0; o >>= 1) {
    const T ov = __shfl_xor_sync(lane_mask<W>(), v, o, W);
    const int ok = __shfl_xor_sync(lane_mask<W>(), k, o, W);
    if (ov < v || (ov == v && ok < k)) {
      v = ov;
      k = ok;
    }
  }
}
#else
inline int lane_reverse = 0;  // host build: HM_LANES runs the last lane first
template <class T, int W>
struct Lanes {
  T v[W];
  T& operator[](int j) { return v[j]; }
  const T& operator[](int j) const { return v[j]; }
};
#define HM_LANES(j, W)                             \
  for (int j##_k = 0; j##_k < (W); ++j##_k)        \
    if (const int j = hm::lane_reverse ? (W) - 1 - j##_k : j##_k; true)

template <int W>
inline unsigned ballot(const Lanes<bool, W>& p) {
  unsigned b = 0;
  for (int j = 0; j < W; ++j) b |= (unsigned)p[j] << j;
  return b;
}
template <class T, int W>
inline T lane_get(const Lanes<T, W>& x, int src) {
  return x[src];
}
template <class T, int W>
inline Lanes<T, W> lane_xor(const Lanes<T, W>& x, int m) {
  Lanes<T, W> r;
  for (int j = 0; j < W; ++j) r[j] = x[j ^ m];
  return r;
}
template <int W>
inline int lane_sum(const Lanes<int, W>& x) {
  int s = 0;
  for (int j = 0; j < W; ++j) s += x[j];
  return s;
}
template <int W>
inline unsigned lane_or(const Lanes<unsigned, W>& x) {
  unsigned s = 0;
  for (int j = 0; j < W; ++j) s |= x[j];
  return s;
}
template <class T, int W>
inline void lane_argmin(const Lanes<T, W>& x, const Lanes<int, W>& key, T& v,
                        int& k) {
  v = x[0];
  k = key[0];
  for (int j = 1; j < W; ++j)
    if (x[j] < v || (x[j] == v && key[j] < k)) {
      v = x[j];
      k = key[j];
    }
}
#endif

}  // namespace hm
