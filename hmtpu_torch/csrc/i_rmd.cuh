// K22 i_rmd's lane code: the open-loop rough mode decision (RMD) of one
// n x n picture block, the port of hmtpu/encoder/iframe_dev.py:133-175
// (`rmd`, `_topk_modes`) with hmtpu/encoder/intra_rdo.py:78 `_satd` and
// iframe_dev.py:94 `_satd4`: the source-sample reference line through
// its substituted gather (8.4.4.2.2), the filter, the 35 modes' luma
// predictions (intra_pred.cuh), the Hadamard SATD of each residual
// ((sum |H D H| + 2) >> 2 per 8x8 tile, summed, for n >= 8; (sum + 1) >> 1
// at n = 4), rd = float(satd) + lam_sqrt * mode_bits (two float32
// operations, each rounded), and the k lowest in a stable order (ties to
// the lower mode).  No (35, n, n) prediction leaves the block.
//
// Block-cooperative (hm_port.cuh): the (mode, tile) items are split over
// the threads, the per-mode sums and the top-k run after barriers; the
// file also compiles as host C++, which the CPU tests drive.
#pragma once

#include "hm_port.cuh"
#include "intra_pred.cuh"

namespace rmd {

using namespace hm;

// the RMD's flat mode bits (intra_rdo.py _MODE_BITS)
HM_FN float mode_bits(int m) {
  return (m < 2) ? 2.5f : (m == 10 || m == 26) ? 3.5f : 5.0f;
}

struct Args {
  const int* plane;  // (h, w) source samples
  const int* sub;    // (blocks, 4n + 1) substituted gather into plane
  const int* none;   // (blocks,) no reference sample available
  int* out;          // (blocks, k) mode indices
  int w, n, bd, strong, k;
  float lam_sqrt;
};

// the block's working set (ints): lines, per-item SATD, per-mode cost
constexpr int R_SU = 0, R_SF = 132, R_T = 264, R_RD = R_T + 35 * 16;
constexpr int R_INTS = R_RD + 36;

// in place, the unnormalised Walsh-Hadamard transform of n values
// spaced `stride` apart
HM_FN void fwht(int* v, int n, int stride) {
  for (int h = 1; h < n; h <<= 1)
    for (int i = 0; i < n; ++i)
      if ((i & h) == 0) {
        const int x = v[i * stride], y = v[(i + h) * stride];
        v[i * stride] = x + y;
        v[(i + h) * stride] = x - y;
      }
}

HM_FN void rmd_block(const Args& a, int blk, int tid, int nt, int* sm) {
  const int n = a.n, line = 4 * n + 1, log2n = log2_of(n);
  const int bwn = a.w / n, bx0 = (blk % bwn) * n, by0 = (blk / bwn) * n;
  const int mid = 1 << (a.bd - 1), none = a.none[blk];
  int* su = sm + R_SU;
  int* sf = sm + R_SF;
  int* ts = sm + R_T;
  float* rd = (float*)(sm + R_RD);
  for (int k = tid; k < line; k += nt)
    su[k] = none ? mid : a.plane[a.sub[(size_t)blk * line + k]];
  HM_SYNC();
  for (int k = tid; k < line; k += nt)
    sf[k] = filter_sample(su, k, n, a.bd, a.strong);
  HM_SYNC();
  const int dc = intra_dc(su, n, log2n);
  const int tile = n >= 8 ? 8 : 4, tw = n / tile, T = tw * tw;
  for (int item = tid; item < 35 * T; item += nt) {
    const int m = item / T, t = item % T;
    const int ty = (t / tw) * tile, tx = (t % tw) * tile;
    int d[64];
    for (int y = 0; y < tile; ++y)
      for (int x = 0; x < tile; ++x)
        d[y * tile + x] =
            a.plane[(by0 + ty + y) * a.w + bx0 + tx + x] -
            pred_sample(su, sf, dc, m, n, log2n, 1, a.bd, ty + y, tx + x);
    for (int y = 0; y < tile; ++y) fwht(d + y * tile, tile, 1);
    for (int x = 0; x < tile; ++x) fwht(d + x, tile, tile);
    int s = 0;
    for (int e = 0; e < tile * tile; ++e) s += iabs(d[e]);
    ts[item] = tile == 8 ? (s + 2) >> 2 : (s + 1) >> 1;
  }
  HM_SYNC();
  for (int m = tid; m < 35; m += nt) {
    int satd = 0;
    for (int t = 0; t < T; ++t) satd += ts[m * T + t];
    rd[m] = HM_FADD((float)satd, HM_FMUL(a.lam_sqrt, mode_bits(m)));
  }
  HM_SYNC();
  if (tid == 0) {
    // the first k of a stable ascending sort
    unsigned long long taken = 0;
    for (int j = 0; j < a.k; ++j) {
      int best = -1;
      for (int m = 0; m < 35; ++m)
        if (!((taken >> m) & 1ull) && (best < 0 || rd[m] < rd[best]))
          best = m;
      taken |= 1ull << best;
      a.out[(size_t)blk * a.k + j] = best;
    }
  }
  HM_SYNC();
}

}  // namespace rmd
