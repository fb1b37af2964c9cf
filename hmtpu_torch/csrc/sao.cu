// K4 sao: sample adaptive offset statistics and application (H.265
// 8.7.3), bit-exact with hmtpu/ops/sao.py:282 _sao_stats_dev
// (hm_sao_stats) and :358 apply_sao_dev (hm_sao_apply).  The per-CTU RD
// choice between them is K25 (sao_choose.cu).  Each entry takes one plane
// or a frame's three (luma at its CTU, the chroma pair at theirs) in one
// launch.  The lane code is sao.cuh's.
//
// What bounds it on the H100: the statistics read each sample of the
// original and the reconstruction once and write 96 int32 a CTU; the
// apply reads each reconstructed sample and writes it once, and reads the
// (Y, X, planes, 7) parameters.  A 416x240 frame is about 1.2 MB of int32
// in all (0.36 us at 3.35 TB/s), 1920x1080 about 25 MB (7.4 us), so at
// the encoder's size both are bound by the launch and the latency of a
// few dependent steps (a round of loads, the warps' sums, the cluster's
// barrier), and at 1080p by memory bytes and the warps' sums.
//
// Design.  Statistics: a cluster of kStrips blocks a CTU
// (`__cluster_dims__`; grid (kStrips x CTUs, planes)), each block a strip
// of the CTU's rows: 28 CTUs x 3 planes x 8 = 672 blocks of 8 warps at
// 416x240, every one resident at once on 132 SMs (one block a CTU, 28
// blocks a plane, before).  A block stages its strip of both planes, the
// reconstruction with a one-sample halo, in shared memory in one round
// of loads (16-byte pieces where the width is a multiple of 4); its warps
// count 32 samples a step with warp sums of packed (count, difference)
// ints into registers (sao.cuh: no atomics, no runtime-indexed array) and
// write their 96 counters to shared memory, the block sums them and
// writes its row of the leader block's shared memory (distributed shared
// memory, after the split cluster barrier that the block arrived at on
// entry); after a second barrier the leader sums the rows and stores each
// counter once.  Apply: a thread a quad of samples, grid (quads / 256,
// planes), the three rows around the quad and the parameters read in one
// round (the parameters as K25 wrote them: no per-plane copy).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sao.cuh"

namespace cg = cooperative_groups;

namespace {

struct Planes {
  sao::Plane p0, p1, p2;
  bool vec0, vec1, vec2;
};

// plane i's fields, by value (no address of the kernel's parameters is
// taken, which would copy them to the stack)
__device__ __forceinline__ sao::Plane plane_of(const Planes& a, int i,
                                               bool& vec) {
  vec = i == 0 ? a.vec0 : i == 1 ? a.vec1 : a.vec2;
  sao::Plane p;
  p.org = i == 0 ? a.p0.org : i == 1 ? a.p1.org : a.p2.org;
  p.rec = i == 0 ? a.p0.rec : i == 1 ? a.p1.rec : a.p2.rec;
  p.out = i == 0 ? a.p0.out : i == 1 ? a.p1.out : a.p2.out;
  p.h = i == 0 ? a.p0.h : i == 1 ? a.p1.h : a.p2.h;
  p.w = i == 0 ? a.p0.w : i == 1 ? a.p1.w : a.p2.w;
  p.ctu = i == 0 ? a.p0.ctu : i == 1 ? a.p1.ctu : a.p2.ctu;
  return p;
}

// the cluster's split barrier: arrive (releasing this thread's writes),
// then wait (acquiring the others')
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__global__ void __cluster_dims__(sao::kStrips, 1, 1)
    __launch_bounds__(sao::kThreads)
        stats_kernel(Planes a, int* __restrict__ out, int nctu, int bd) {
  __shared__ __align__(16) int tile[sao::kTile];
  __shared__ int part[sao::kWarps * sao::kBins];
  // the leader's: every block's sums, one row a block
  __shared__ int sums[sao::kStrips * sao::kBins];
  cg::cluster_group cluster = cg::this_cluster();
  // every block has started once this phase completes: then the leader's
  // shared memory may be written (waited for after the counting)
  cluster_arrive();
  bool vec;
  const sao::Plane p = plane_of(a, blockIdx.y, vec);
  const int c = blockIdx.x / sao::kStrips;
  const int s = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  int x0, tw, ys, sh;
  sao::strip_of(p, c, s, x0, tw, ys, sh);
  if (sh > 0) {
    sao::stage(p.rec, p.org, p.h, p.w, x0, ys, sh, tw, tile, vec, tid,
               sao::kThreads);
    __syncthreads();
    sao::warp_counts(tile, p.h, p.w, x0, ys, sh, tw, bd, tid >> 5,
                     part + (tid >> 5) * sao::kBins);
    __syncthreads();
  }
  int v = 0;
  if (tid < sao::kBins && sh > 0) {
#pragma unroll
    for (int wp = 0; wp < sao::kWarps; ++wp) v += part[wp * sao::kBins + tid];
  }
  cluster_wait();
  // each block's sums into its row of the leader's
  if (tid < sao::kBins)
    cluster.map_shared_rank(sums, 0)[s * sao::kBins + tid] = v;
  cluster_arrive();
  cluster_wait();
  if (s == 0 && tid < sao::kBins) {
    int t = 0;
#pragma unroll
    for (int r = 0; r < sao::kStrips; ++r) t += sums[r * sao::kBins + tid];
    out[((size_t)blockIdx.y * nctu + c) * sao::kBins + tid] = t;
  }
}

__global__ void __launch_bounds__(256)
    apply_kernel(Planes a, const int* __restrict__ params, int np, int bd) {
  bool vec;
  const sao::Plane p = plane_of(a, blockIdx.y, vec);
  const int qw = (p.w + 3) >> 2;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p.h * qw) return;
  const int y = q / qw, x0 = (q - y * qw) << 2;
  const int nx = (p.w + p.ctu - 1) / p.ctu;
  const int* prm =
      params + (((size_t)(y / p.ctu) * nx + x0 / p.ctu) * np + blockIdx.y) * 7;
  sao::apply_quad(p, prm, y, x0, bd, vec);
}

bool aligned16(const void* q) { return ((uintptr_t)q & 15) == 0; }

// the planes' geometry; np 1 (plane 0 alone) or 3 (plane 0 at (h, w, ctu),
// planes 1 and 2 at (hc, wc, ctuc), the same CTU count)
int planes_of(Planes& a, const void* const* org, const void* const* rec,
              void* const* out, int np, int h, int w, int ctu, int hc,
              int wc, int ctuc) {
  if (np != 1 && np != 3) return (int)cudaErrorInvalidValue;
  sao::Plane* ps[3] = {&a.p0, &a.p1, &a.p2};
  bool* vs[3] = {&a.vec0, &a.vec1, &a.vec2};
  for (int i = 0; i < 3; ++i) {
    const bool on = i < np;
    sao::Plane& p = *ps[i];
    p.org = on && org ? (const int*)org[i] : nullptr;
    p.rec = on ? (const int*)rec[i] : nullptr;
    p.out = on && out ? (int*)out[i] : nullptr;
    p.h = i == 0 ? h : hc;
    p.w = i == 0 ? w : wc;
    p.ctu = i == 0 ? ctu : ctuc;
    if (on && (p.h < 1 || p.w < 1 || p.ctu < 4 || p.ctu > sao::kMaxCtu ||
               p.ctu % 4))
      return (int)cudaErrorInvalidValue;
    *vs[i] = on && p.w % 4 == 0 && aligned16(p.rec) &&
             (!p.out || aligned16(p.out));
  }
  if (np == 3 && sao::ctus(h, w, ctu) != sao::ctus(hc, wc, ctuc))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" int hm_sao_stats(const void* org0, const void* rec0,
                            const void* org1, const void* rec1,
                            const void* org2, const void* rec2, void* out,
                            int np, int h, int w, int ctu, int hc, int wc,
                            int ctuc, int bd, void* stream) {
  const void* org[3] = {org0, org1, org2};
  const void* rec[3] = {rec0, rec1, rec2};
  Planes a;
  const int err = planes_of(a, org, rec, nullptr, np, h, w, ctu, hc, wc, ctuc);
  if (err) return err;
  if (bd < 8 || bd > sao::kMaxBd) return (int)cudaErrorInvalidValue;
  const int nctu = sao::ctus(h, w, ctu);
  stats_kernel<<<dim3(nctu * sao::kStrips, np), sao::kThreads, 0,
                 (cudaStream_t)stream>>>(a, (int*)out, nctu, bd);
  return (int)cudaGetLastError();
}

extern "C" int hm_sao_apply(const void* rec0, const void* rec1,
                            const void* rec2, const void* params, void* out0,
                            void* out1, void* out2, int np, int h, int w,
                            int ctu, int hc, int wc, int ctuc, int bd,
                            void* stream) {
  const void* rec[3] = {rec0, rec1, rec2};
  void* out[3] = {out0, out1, out2};
  Planes a;
  const int err = planes_of(a, nullptr, rec, out, np, h, w, ctu, hc, wc, ctuc);
  if (err) return err;
  const int quads = h * ((w + 3) / 4);
  apply_kernel<<<dim3((quads + 255) / 256, np), 256, 0,
                 (cudaStream_t)stream>>>(a, (const int*)params, np, bd);
  return (int)cudaGetLastError();
}
