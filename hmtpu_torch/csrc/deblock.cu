// K3 deblock: the HEVC in-loop deblocking filter of one picture (H.265
// 8.7.2) in one launch, bit-exact with hmtpu/ops/deblock.py:471
// deblock_frame_dev; the lane code, and why its tiles are independent, is
// in deblock.cuh.
//
// What bounds it on the H100: each sample is read once and written once
// (a 416x240 picture is 0.6 MB of int32 planes in and out, 0.18 us at
// 3.35 TB/s), the metadata a few tens of KB; the work a 4-line segment is
// a few hundred integer operations.  So a picture is bound by its chain:
// a block's tile load, two filter passes behind a barrier, the store.
//
// Design: a block of 192 threads a tile position (a 32x32 luma tile and
// its two 16x16 chroma tiles), 112 blocks at 416x240; each thread loads
// its share of the tiles into registers and, with those loads in flight,
// threads 0-95 derive the block's 96 filter switches (a segment's
// boundary strength in each direction, from the metadata only: a
// segment's fields in one round of loads, the POCs from the block's
// table in shared memory) into shared memory; then the block places the
// tiles in shared memory, filters the vertical edges, meets at a
// barrier, filters the horizontal edges, meets again and stores the
// tiles to new planes.  Two entries: the 4x4-map
// form (deblock_frame_dev's arguments) and the state form (the passes'
// 8x8 cell state read in place).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "deblock.cuh"

namespace {

template <class Src>
__global__ void __launch_bounds__(db::NT)
    deblock_kernel(db::Planes pl, Src m, db::Par q) {
  __shared__ db::Tile tl;
  __shared__ int tab[32];
  __shared__ int bs[2 * db::NTASK];
  const int tx = blockIdx.x, ty = blockIdx.y, i = threadIdx.x;
  // the tiles' samples and switch i's fields (direction i / 48, task
  // i % 48) in flight together
  db::Stage<db::NT> st;
  db::fetch<db::NT>(st, pl, q, tx, ty, i);
  db::Switch<Src> w;
  if (i < 2 * db::NTASK)
    w = db::switch_load(m, q, tx, ty, i / db::NTASK, i % db::NTASK);
  m.fill_pocs(tab, i);
  __syncthreads();
  if (i < 2 * db::NTASK) bs[i] = db::switch_bs(m, w, tab);
  db::place<db::NT>(st, tl, i);
  __syncthreads();
  const int t = i >> 2;
  db::run_task(tl, q, tx, ty, 0, t, bs[t]);
  __syncthreads();
  db::run_task(tl, q, tx, ty, 1, t, bs[db::NTASK + t]);
  __syncthreads();
  db::store_tile(pl, tl, q, tx, ty, i, db::NT);
}

db::Par make_par(int h, int w, int qp, int bd, int beta_off, int tc_off,
                 int tc_cb, int tc_cr) {
  return db::Par{h, w, qp, bd, beta_off, tc_off, tc_cb, tc_cr};
}

db::Planes make_planes(const void* y, const void* u, const void* v, void* oy,
                       void* ou, void* ov) {
  return db::Planes{{(const int*)y, (const int*)u, (const int*)v},
                    {(int*)oy, (int*)ou, (int*)ov}};
}

template <class Src>
int launch(const db::Planes& pl, const Src& m, const db::Par& q,
           void* stream) {
  const dim3 grid(db::tiles_x(q), db::tiles_y(q));
  deblock_kernel<Src><<<grid, db::NT, 0, (cudaStream_t)stream>>>(pl, m, q);
  return (int)cudaGetLastError();
}

bool bad_shape(int h, int w, int bd) {
  return h < 8 || w < 8 || h % 8 || w % 8 || bd < 8 || bd > 12;
}

}  // namespace

// the 4x4-map form: planes in and out, the maps (mask_v / mask_h may be
// null), then (h, w, qp, bit depth, beta / tC offsets, the chroma tCs)
extern "C" int hm_deblock_map(const void* y, const void* u, const void* v,
                              void* oy, void* ou, void* ov,
                              const void* intra4, const void* cbf4,
                              const void* mvx, const void* mvy,
                              const void* refpoc, const void* mask_v,
                              const void* mask_h, int h, int w, int qp,
                              int bd, int beta_off, int tc_off, int tc_cb,
                              int tc_cr, void* stream) {
  if (bad_shape(h, w, bd)) return cudaErrorInvalidValue;
  db::MapSrc m{(const int*)intra4, (const int*)cbf4, (const int*)mvx,
               (const int*)mvy,    (const int*)refpoc, (const int*)mask_v,
               (const int*)mask_h, h / 4, w / 4, w / 8};
  return launch(make_planes(y, u, v, oy, ou, ov), m,
                make_par(h, w, qp, bd, beta_off, tc_off, tc_cb, tc_cr),
                stream);
}

// the state form: planes in and out; the columns (dir .. ref1 null in an
// I slice), their row stride; `pocs` a host array (nr0, nr1, the lists'
// 16 POCs each), copied into the kernel's arguments; then as above
extern "C" int hm_deblock_state(const void* y, const void* u, const void* v,
                                void* oy, void* ou, void* ov,
                                const void* dir, const void* mvx,
                                const void* mvy, const void* ref,
                                const void* mvx1, const void* mvy1,
                                const void* ref1, const void* cbf,
                                const void* sz, int stride, const void* pocs,
                                int h, int w, int qp, int bd, int beta_off,
                                int tc_off, int tc_cb, int tc_cr,
                                void* stream) {
  if (bad_shape(h, w, bd) || stride < 1 || sz == nullptr)
    return cudaErrorInvalidValue;
  db::StateSrc m;
  m.dir = (const int*)dir;
  m.mvx = (const int*)mvx;
  m.mvy = (const int*)mvy;
  m.ref = (const int*)ref;
  m.mvx1 = (const int*)mvx1;
  m.mvy1 = (const int*)mvy1;
  m.ref1 = (const int*)ref1;
  m.cbf = (const int*)cbf;
  m.sz = (const int*)sz;
  m.stride = stride;
  m.bw = w / 8;
  const int* hp = (const int*)pocs;
  m.nr0 = hp[0];
  m.nr1 = hp[1];
  if (m.nr0 < 0 || m.nr0 > 16 || m.nr1 < 0 || m.nr1 > 16 ||
      (dir != nullptr && (m.nr0 < 1 || !mvx || !mvy || !ref || !mvx1 ||
                          !mvy1 || !ref1 || !cbf)))
    return cudaErrorInvalidValue;
  memcpy(m.poc0, hp + 2, sizeof m.poc0);
  memcpy(m.poc1, hp + 18, sizeof m.poc1);
  return launch(make_planes(y, u, v, oy, ou, ov), m,
                make_par(h, w, qp, bd, beta_off, tc_off, tc_cb, tc_cr),
                stream);
}
