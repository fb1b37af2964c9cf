// K4 sao: sample adaptive offset statistics and application (H.265
// 8.7.3), bit-exact with hmtpu/ops/sao.py:282 _sao_stats_dev
// (hm_sao_stats) and :358 apply_sao_dev (hm_sao_apply).  The per-CTU RD
// choice (:305 _choose_params_dev) stays in PyTorch.
//
// What bounds it on the H100: the statistics read each sample of the
// original and the reconstruction once (plus neighbours from cache) and
// write 96 int32 per CTU; the apply reads each reconstructed sample and
// writes it once.  A 416x240 picture is ~0.6 MB of int32 in all, so both
// are bound by launch cost and, beyond it, by memory bytes.
//
// Design: hm_sao_stats runs one thread block per CTU.  Its threads walk
// the CTU's samples, classify each under the 4 edge classes and the 32
// bands, and accumulate org - rec sums and counts in 96 shared-memory
// int32 counters with block-local atomics (integer, so the order does
// not matter); one store per counter per CTU, no global atomics across
// CTUs.  hm_sao_apply runs one thread per sample and reads the
// deblocked neighbours across CTU borders; samples whose edge neighbour
// lies outside the picture get no edge offset.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// EO class -> neighbour a (dy, dx), neighbour b (dy, dx)
__constant__ int kEo[4][4] = {
    {0, -1, 0, 1}, {-1, 0, 1, 0}, {-1, -1, 1, 1}, {-1, 1, 1, -1}};

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

// remapped edgeIdx (0 = none, 1..4) of sample (y, x) under class c
__device__ __forceinline__ int edge_cat(const int* rec, int h, int w, int y,
                                        int x, int c) {
  const int ady = kEo[c][0], adx = kEo[c][1];
  const int bdy = kEo[c][2], bdx = kEo[c][3];
  if ((adx || bdx) && (x == 0 || x == w - 1)) return 0;
  if ((ady || bdy) && (y == 0 || y == h - 1)) return 0;
  const int p = rec[y * w + x];
  const int a = rec[(y + ady) * w + x + adx];
  const int b = rec[(y + bdy) * w + x + bdx];
  const int raw = 2 + sgn(p - a) + sgn(p - b);
  const int remap[5] = {1, 2, 0, 3, 4};
  return remap[raw];
}

__global__ void stats_kernel(const int* __restrict__ org,
                             const int* __restrict__ rec,
                             int* __restrict__ out, int h, int w, int ctu,
                             int bd) {
  // [0,16) edge sums (class*4 + cat-1), [16,32) edge counts,
  // [32,64) band sums, [64,96) band counts
  __shared__ int acc[96];
  for (int i = threadIdx.x; i < 96; i += blockDim.x) acc[i] = 0;
  __syncthreads();
  const int nx = (w + ctu - 1) / ctu;
  const int cy = blockIdx.x / nx, cx = blockIdx.x - cy * nx;
  const int y0 = cy * ctu, x0 = cx * ctu;
  const int th = min(ctu, h - y0), tw = min(ctu, w - x0);
  for (int i = threadIdx.x; i < th * tw; i += blockDim.x) {
    const int y = y0 + i / tw, x = x0 + i % tw;
    const int r = rec[y * w + x];
    const int d = org[y * w + x] - r;
    for (int c = 0; c < 4; ++c) {
      const int cat = edge_cat(rec, h, w, y, x, c);
      if (cat > 0) {
        atomicAdd(&acc[c * 4 + cat - 1], d);
        atomicAdd(&acc[16 + c * 4 + cat - 1], 1);
      }
    }
    const int band = r >> (bd - 5);
    atomicAdd(&acc[32 + band], d);
    atomicAdd(&acc[64 + band], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 96; i += blockDim.x)
    out[(long long)blockIdx.x * 96 + i] = acc[i];
}

__global__ void apply_kernel(const int* __restrict__ rec,
                             const int* __restrict__ params,
                             int* __restrict__ out, int h, int w, int ctu,
                             int bd) {
  const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= (long long)h * w) return;
  const int y = (int)(id / w), x = (int)(id - (long long)y * w);
  const int nx = (w + ctu - 1) / ctu;
  const int* p = params + ((y / ctu) * nx + x / ctu) * 7;
  const int typ = p[0];
  const int r = rec[id];
  int delta = 0;
  if (typ == 2) {
    const int cat = edge_cat(rec, h, w, y, x, p[1]);
    if (cat > 0) delta = p[3 + cat - 1];
  } else if (typ == 1) {
    const int bidx = ((r >> (bd - 5)) - p[2]) & 31;
    if (bidx < 4) delta = p[3 + bidx];
  }
  out[id] = min(max(r + delta, 0), (1 << bd) - 1);
}

}  // namespace

extern "C" int hm_sao_stats(const void* org, const void* rec, void* out,
                            int h, int w, int ctu, int bd, void* stream) {
  const int n_ctu = ((h + ctu - 1) / ctu) * ((w + ctu - 1) / ctu);
  stats_kernel<<<n_ctu, 256, 0, (cudaStream_t)stream>>>(
      (const int*)org, (const int*)rec, (int*)out, h, w, ctu, bd);
  return (int)cudaGetLastError();
}

extern "C" int hm_sao_apply(const void* rec, const void* params, void* out,
                            int h, int w, int ctu, int bd, void* stream) {
  const long long total = (long long)h * w;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  apply_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)rec, (const int*)params, (int*)out, h, w, ctu, bd);
  return (int)cudaGetLastError();
}
