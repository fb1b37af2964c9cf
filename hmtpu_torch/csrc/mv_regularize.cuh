// K19 mv_regularize's lane code: the motion-field coherence pass of the P
// pass, bit-exact with hmtpu/search/me.py:194 regularize_mv_field (with
// _block_sad_int :178 and mv_bits_dev_f :239).
//
// A Jacobi round re-picks every 8x8 block's (mv, ref) among [self, the
// block to the left, to the right, above, below, zero] (the reference's
// roll by (0, 1), (0, -1), (1, 0), (-1, 0): the neighbours wrap around the
// picture edge), minimising SAD + lam_sqrt * bits, where a candidate equal
// to one of the four neighbours costs 2 bits and any other its full-pel
// MVD bits against the right-hand neighbour (roll (0, -1)) + 1.  SAD reads
// clamp to the picture and the reference index to [0, R - 1].  The cost
// is rounded as the reference rounds it: float32 product, then float32 sum
// (no FMA), and the first of equal costs wins.  Every round reads the
// field the round before wrote (the first the input) and writes a buffer
// of its own: rounds alternate between the returned field and a scratch
// field so that the last one writes the returned field, whatever the
// number of rounds.
//
// A cell on a warp (`Lanes<int, 32>`): lane j holds samples 2 j and 2 j + 1
// of the 8x8 block (row j / 4); the six candidates' SADs are six partial
// sums a lane, reduced by six independent warp sums; lanes 0-5 price a
// candidate each, and `lane_argmin` (the lower index on equal costs) picks
// the winner, which lane 0 writes.  Compiles as host C++ too (one thread
// holds a warp's lanes; `rounds_host` runs every cell of a round in turn).
#pragma once

#include "hm_port.cuh"

#if defined(__CUDACC__)
// a field another block wrote in this launch: read through L2, not L1
#define MVR_LD(p) __ldcg(p)
#else
#define MVR_LD(p) (*(p))
#endif

namespace mvr {

using L32 = hm::Lanes<int, 32>;

struct Args {
  const int* refs;   // (R, H, W)
  const int* org;    // (H, W)
  const float* lam;  // lam_sqrt, one float32 in device memory
  const int* in[3];  // the input field: mvx, mvy, ridx (bh, bw)
  int* out[3];       // the returned field
  int* tmp[3];       // the scratch field
  int R, H, W, bh, bw, iters;
};

// the field round k writes: the last round the returned one, the rounds
// before it alternately the scratch and the returned field
HM_HD int* dst(const Args& a, int k, int c) {
  return ((a.iters - 1 - k) & 1) == 0 ? a.out[c] : a.tmp[c];
}
// the field round k reads: the input, then what the round before wrote
HM_HD const int* src(const Args& a, int k, int c) {
  return k == 0 ? a.in[c] : dst(a, k - 1, c);
}

HM_FN int bit_len4(int v) {
  const int a = hm::iabs(v * 4);
  return a > 0 ? 32 - HM_CLZ((unsigned)a) : 0;
}

// round k of cell b, on one warp
HM_FN void cell(const Args& a, int k, int b) {
  const float lam = *a.lam;
  const int by = b / a.bw, bx = b - by * a.bw;
  const int* fx = src(a, k, 0);
  const int* fy = src(a, k, 1);
  const int* fr = src(a, k, 2);
  // [self, (0, 1), (0, -1), (1, 0), (-1, 0), zero]: the roll by (dy, dx)
  // reads the block at (by - dy, bx - dx), wrapped
  const int dy[5] = {0, 0, 0, 1, -1}, dx[5] = {0, 1, -1, 0, 0};
  int cx[6], cy[6], cr[6];
  HM_UNROLL
  for (int c = 0; c < 5; ++c) {
    int sy = by - dy[c], sx = bx - dx[c];
    sy += sy < 0 ? a.bh : sy >= a.bh ? -a.bh : 0;
    sx += sx < 0 ? a.bw : sx >= a.bw ? -a.bw : 0;
    const int s = sy * a.bw + sx;
    cx[c] = MVR_LD(fx + s);
    cy[c] = MVR_LD(fy + s);
    cr[c] = MVR_LD(fr + s);
  }
  cx[5] = cy[5] = cr[5] = 0;
  L32 sad[6];
  HM_LANES(j, 32) {
    const int py = by * 8 + (j >> 2), px = bx * 8 + (j & 3) * 2;
    const int* orow = a.org + (size_t)py * a.W + px;
    const int o0 = orow[0], o1 = orow[1];
    HM_UNROLL
    for (int c = 0; c < 6; ++c) {
      const int r = hm::iclamp(cr[c], 0, a.R - 1);
      const int yy = hm::iclamp(py + cy[c], 0, a.H - 1);
      const int* row = a.refs + ((size_t)r * a.H + yy) * a.W;
      sad[c][j] = hm::iabs(o0 - row[hm::iclamp(px + cx[c], 0, a.W - 1)]) +
                  hm::iabs(o1 - row[hm::iclamp(px + 1 + cx[c], 0, a.W - 1)]);
    }
  }
  int tot[6];
  HM_UNROLL
  for (int c = 0; c < 6; ++c) tot[c] = hm::lane_sum(sad[c]);
  hm::Lanes<float, 32> cost;
  L32 key;
  HM_LANES(j, 32) {
    int x = 0, y = 0, r = 0, s = 0;
    HM_UNROLL
    for (int c = 0; c < 6; ++c) {
      x = j == c ? cx[c] : x;
      y = j == c ? cy[c] : y;
      r = j == c ? cr[c] : r;
      s = j == c ? tot[c] : s;
    }
    bool eq = false;
    HM_UNROLL
    for (int n = 1; n < 5; ++n)
      eq = eq || (x == cx[n] && y == cy[n] && r == cr[n]);
    const float mvd =
        (float)(2 * bit_len4(x - cx[2]) + 2 * bit_len4(y - cy[2]) + 2);
    const float bits = eq ? 2.0f : HM_FADD(mvd, 1.0f);
    cost[j] = j < 6 ? HM_FADD((float)s, HM_FMUL(lam, bits)) : INFINITY;
    key[j] = j;
  }
  float best_cost;
  int best;
  hm::lane_argmin(cost, key, best_cost, best);
  int wx = 0, wy = 0, wr = 0;
  HM_UNROLL
  for (int c = 0; c < 6; ++c) {
    wx = best == c ? cx[c] : wx;
    wy = best == c ? cy[c] : wy;
    wr = best == c ? cr[c] : wr;
  }
  HM_LANES(j, 32) {
    if (j == 0) {
      dst(a, k, 0)[b] = wx;
      dst(a, k, 1)[b] = wy;
      dst(a, k, 2)[b] = wr;
    }
  }
}

#if !defined(__CUDACC__)
// the host build: every round, every cell of a round in turn
inline void rounds_host(const Args& a) {
  for (int k = 0; k < a.iters; ++k)
    for (int b = 0; b < a.bh * a.bw; ++b) cell(a, k, b);
}
#endif

}  // namespace mvr
