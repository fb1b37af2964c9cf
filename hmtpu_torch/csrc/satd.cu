// K8 satd8: HM's 8x8 Hadamard SATD (TComRdCost::xCalcHADs8x8,
// (sum |H D H| + 2) >> 2 per 8x8 tile) summed over the tiles of each
// block, bit-exact with hmtpu/search/me.py:159 satd_batch; and the NN-FME
// gate of the P pass's three CU levels in one launch
// (hmtpu/encoder/pframe_dev.py:1545-1560: a level's two predictions
// against the original, the NN MV kept where its SATD is strictly below
// the integer MV's).  The lane code is satd.cuh.
//
// What bounds it on the H100: bytes, about a microsecond.  Per
// sample a call reads two int32 values (the gate three: the original and
// both predictions) and does 48 butterfly additions and an abs-add per
// tile row of 8; the gate at 416x240 moves about 3.7 MB (the original
// once a level, both predictions of 306 k samples, the MVs in and out):
// about 1.1 us at 3.35 TB/s.
//
// Design: a warp per four 8x8 blocks, or per larger block in rounds of
// four tiles; eight lanes a tile, a row a lane loaded 16 bytes at a time,
// the row butterflies in registers, the column butterflies and every sum
// by shuffles: no shared memory, no barrier, no atomic.  The gate reads
// the original plane in place (rows and columns clamped: the 32 level's
// edge replication), each org row once for both predictions, and writes
// the MV it keeps.
#include <cuda_runtime.h>

#include "satd.cuh"

namespace {

constexpr int kWarps = 4;  // warps a block

__global__ void __launch_bounds__(kWarps * 32)
    satd_kernel(satd::Job a, int warps) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w < warps) satd::warp_job(a, w);
}

// up to three levels' jobs, their warps one after another
struct Gate {
  satd::Job lv[3];
  int warps[3];
};

__global__ void __launch_bounds__(kWarps * 32) satd_gate_kernel(Gate g) {
  int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  // the level by comparisons (no dynamic index into the argument)
  if (w < g.warps[0]) {
    satd::warp_job(g.lv[0], w);
  } else if ((w -= g.warps[0]) < g.warps[1]) {
    satd::warp_job(g.lv[1], w);
  } else if ((w -= g.warps[1]) < g.warps[2]) {
    satd::warp_job(g.lv[2], w);
  }
}

int blocks_for(int warps) { return (warps + kWarps - 1) / kWarps; }

}  // namespace

// a, b: (nb, n, n) int32, 16-byte aligned; out (nb,) int32
extern "C" int hm_satd8(const void* a, const void* b, void* out, int nb, int n,
                        void* stream) {
  if (n % 8 || n < 8 || n > 64 || nb < 1) return cudaErrorInvalidValue;
  satd::Job j{(const int*)a, 0, 0, {(const int*)b, nullptr}, 1, n, 0, nb,
              nullptr, nullptr, (int*)out};
  const int warps = satd::job_warps(j);
  satd_kernel<<<blocks_for(warps), kWarps * 32, 0, (cudaStream_t)stream>>>(
      j, warps);
  return (int)cudaGetLastError();
}

// org: the (oh, ow) plane (ow a multiple of 8); for each of nlev levels:
// its two predictions (nb, n, n), its MV sets mvx / mvy (2, nb), its
// output (2, nb) and (n, grid width, nb); every pointer 16-byte aligned
extern "C" int hm_satd_gate(const void* org, const void* p00,
                            const void* p01, const void* mx0,
                            const void* my0, void* out0, const void* p10,
                            const void* p11, const void* mx1,
                            const void* my1, void* out1, const void* p20,
                            const void* p21, const void* mx2,
                            const void* my2, void* out2, int oh, int ow,
                            int nlev, int n0, int gw0, int nb0, int n1,
                            int gw1, int nb1, int n2, int gw2, int nb2,
                            void* stream) {
  if (nlev < 1 || nlev > 3 || oh < 1 || ow < 8 || ow % 8)
    return cudaErrorInvalidValue;
  const void* p[3][5] = {{p00, p01, mx0, my0, out0},
                         {p10, p11, mx1, my1, out1},
                         {p20, p21, mx2, my2, out2}};
  const int geo[3][3] = {{n0, gw0, nb0}, {n1, gw1, nb1}, {n2, gw2, nb2}};
  Gate g{};
  int total = 0;
  for (int l = 0; l < 3; ++l) {
    const int n = geo[l][0], gw = geo[l][1], nb = geo[l][2];
    if (l >= nlev) {
      g.warps[l] = 0;
      continue;
    }
    if (n % 8 || n < 8 || n > 64 || gw < 1 || nb < 0 || nb % gw)
      return cudaErrorInvalidValue;
    g.lv[l] = satd::Job{(const int*)org, oh, ow,
                        {(const int*)p[l][0], (const int*)p[l][1]}, 2, n, gw,
                        nb, (const int*)p[l][2], (const int*)p[l][3],
                        (int*)p[l][4]};
    g.warps[l] = satd::job_warps(g.lv[l]);
    total += g.warps[l];
  }
  if (total)
    satd_gate_kernel<<<blocks_for(total), kWarps * 32, 0,
                       (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}
