// K19 mv_regularize: one Jacobi round of the motion-field coherence pass,
// bit-exact with hmtpu/search/me.py:194 regularize_mv_field (with
// _block_sad_int :178 and mv_bits_dev_f :239).  The P pass calls it once
// per frame (hmtpu/encoder/pframe_dev.py:1150 in the port) with 3 rounds;
// a round reads the whole field the previous round wrote, so each round
// is one launch (the launch boundary is the grid-wide barrier).
//
// Per 8x8 block the round re-picks (mv, ref) among [self, the block to
// the left, to the right, above, below, zero] (the reference's roll by
// (0, 1), (0, -1), (1, 0), (-1, 0): the neighbours wrap around the
// picture edge), minimising SAD + lam_sqrt * bits, where a candidate
// equal to one of the four neighbours costs 2 bits and any other its
// full-pel MVD bits against the right-hand neighbour (roll (0, -1)) + 1.
// SAD reads clamp to the picture (no padded reference).  The cost is
// rounded as the reference rounds it: float32 product, then float32 sum
// (no FMA), and the first of equal costs wins.
//
// What bounds it on the H100: bytes, far below the launch cost.  A round
// at 416x240 reads 6 x 64 reference samples and 64 original samples per
// block (1560 blocks, about 2.8 MB of int32 with every read counted, 0.8
// ms at 3.35 TB/s if none hit in cache; the picture's planes are 0.4 MB
// each, so most reads hit L2).  Design: one 64-thread block per 8x8
// block, one thread per sample; the six SADs are summed with warp
// shuffles (integers: any order is exact), and one thread prices the
// candidates and writes the block's choice.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int bit_len4(int v) {
  const int a = abs(v * 4);
  return a > 0 ? 32 - __clz(a) : 0;
}

__global__ void reg_kernel(const int* __restrict__ refs,
                           const int* __restrict__ org,
                           const int* __restrict__ ix,
                           const int* __restrict__ iy,
                           const int* __restrict__ ir,
                           const float* __restrict__ lam_sqrt,
                           int* __restrict__ ox, int* __restrict__ oy,
                           int* __restrict__ orr, int R, int H, int W,
                           int bh, int bw) {
  __shared__ int cand[6][3];
  __shared__ int part[6][2];
  const int b = blockIdx.x;
  const int by = b / bw, bx = b - (b / bw) * bw;
  const int t = threadIdx.x;
  if (t < 6) {
    // [self, (0, 1), (0, -1), (1, 0), (-1, 0), zero]: the roll by (dy, dx)
    // reads the block at (by - dy, bx - dx), wrapped
    const int dy[5] = {0, 0, 0, 1, -1}, dx[5] = {0, 1, -1, 0, 0};
    if (t < 5) {
      const int sy = (by - dy[t] + bh) % bh, sx = (bx - dx[t] + bw) % bw;
      const int s = sy * bw + sx;
      cand[t][0] = ix[s];
      cand[t][1] = iy[s];
      cand[t][2] = ir[s];
    } else {
      cand[5][0] = cand[5][1] = cand[5][2] = 0;
    }
  }
  __syncthreads();
  const int py = by * 8 + (t >> 3), px = bx * 8 + (t & 7);
  const int o = org[(size_t)py * W + px];
  for (int c = 0; c < 6; ++c) {
    const int r = min(max(cand[c][2], 0), R - 1);
    const int yy = min(max(py + cand[c][1], 0), H - 1);
    const int xx = min(max(px + cand[c][0], 0), W - 1);
    int d = abs(o - refs[((size_t)r * H + yy) * W + xx]);
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) d += __shfl_xor_sync(0xffffffffu, d, k);
    if ((t & 31) == 0) part[c][t >> 5] = d;
  }
  __syncthreads();
  if (t != 0) return;
  const float lam = *lam_sqrt;
  int best = 0;
  float best_cost = 0.0f;
  for (int c = 0; c < 6; ++c) {
    const float sad = (float)(part[c][0] + part[c][1]);
    bool eq = false;
    for (int k = 1; k < 5; ++k)
      eq = eq || (cand[c][0] == cand[k][0] && cand[c][1] == cand[k][1] &&
                  cand[c][2] == cand[k][2]);
    const float mvd = (float)(2 * bit_len4(cand[c][0] - cand[2][0]) +
                              2 * bit_len4(cand[c][1] - cand[2][1]) + 2);
    const float bits = eq ? 2.0f : __fadd_rn(mvd, 1.0f);
    const float cost = __fadd_rn(sad, __fmul_rn(lam, bits));
    if (c == 0 || cost < best_cost) {
      best = c;
      best_cost = cost;
    }
  }
  ox[b] = cand[best][0];
  oy[b] = cand[best][1];
  orr[b] = cand[best][2];
}

}  // namespace

extern "C" int hm_mv_regularize(const void* refs, const void* org,
                                const void* ix, const void* iy,
                                const void* ir, const void* lam_sqrt,
                                void* ox, void* oy, void* orr, int R, int H,
                                int W, void* stream) {
  if (R < 1 || H < 8 || W < 8 || H % 8 || W % 8) return cudaErrorInvalidValue;
  const int bh = H / 8, bw = W / 8;
  reg_kernel<<<bh * bw, 64, 0, (cudaStream_t)stream>>>(
      (const int*)refs, (const int*)org, (const int*)ix, (const int*)iy,
      (const int*)ir, (const float*)lam_sqrt, (int*)ox, (int*)oy, (int*)orr,
      R, H, W, bh, bw);
  return (int)cudaGetLastError();
}
