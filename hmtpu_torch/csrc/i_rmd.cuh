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
// One (mode, tile) on a set of lanes (hm_port.cuh's Lanes): an 8x8 tile
// on a warp, a 4x4 tile on a quarter-warp, two residual samples a lane
// (row r, columns c and c + tile / 2), so the row butterflies are the
// pair in registers and lane exchanges over the column bits, the column
// butterflies lane exchanges over the row bits: no transpose through
// memory, no tile in local memory.  The block's sets take the modes in
// turn, each summing its mode's tiles (integers: any order); the top-k
// is k argmins over the 35 (rd, mode) on one warp.  Block-cooperative
// (hm_port.cuh): a block of whole warps, or the host's one thread, which
// runs the sets and their lanes in turn; the file also compiles as host
// C++, which the CPU tests drive.
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

// the block's working set (ints): the lines, the source block, the
// modes' SATDs, the DC value
constexpr int R_SU = 0, R_SF = 132, R_SRC = 264, R_SATD = R_SRC + 1024;
constexpr int R_DC = R_SATD + 36;
constexpr int R_INTS = R_DC + 4;

// one mode's SATD over the n x n block on a set of W lanes (ts x ts
// tiles, ts = 8 on a warp, 4 on a quarter-warp), to every lane of the set
template <int W, int ts>
HM_FN int mode_satd(const Args& a, const int* src, const int* su,
                    const int* sf, int dc, int m, int log2n) {
  constexpr int half = ts / 2;
  const int n = a.n, tw = n / ts;
  int satd = 0;
  for (int t = 0; t < tw * tw; ++t) {
    const int ty = (t / tw) * ts, tx = (t % tw) * ts;
    Lanes<int, W> x0, x1;
    HM_LANES(j, W) {
      const int y = ty + j / half, x = tx + j % half;
      const int d0 = src[y * n + x] -
                     pred_sample(su, sf, dc, m, n, log2n, 1, a.bd, y, x);
      const int d1 = src[y * n + x + half] -
                     pred_sample(su, sf, dc, m, n, log2n, 1, a.bd, y,
                                 x + half);
      // the rows' first stage: columns c and c + ts / 2 in registers
      x0[j] = d0 + d1;
      x1[j] = d0 - d1;
    }
    // the rows' other stages over the lane bits below ts / 2 (the column
    // bits), the columns' over the lane bits above (the row bits): lane j
    // keeps x + y where its bit h is clear, the partner's value less its
    // own where it is set
    for (int h = 1; h < W; h <<= 1) {
      const Lanes<int, W> o0 = lane_xor(x0, h), o1 = lane_xor(x1, h);
      HM_LANES(j, W) {
        x0[j] = (j & h) ? o0[j] - x0[j] : x0[j] + o0[j];
        x1[j] = (j & h) ? o1[j] - x1[j] : x1[j] + o1[j];
      }
    }
    Lanes<int, W> s;
    HM_LANES(j, W) s[j] = iabs(x0[j]) + iabs(x1[j]);
    const int sum = lane_sum(s);
    satd += ts == 8 ? (sum + 2) >> 2 : (sum + 1) >> 1;
  }
  return satd;
}

// the modes in turn on the block's sets of W lanes (nt / W of them; one
// on the host), each mode's SATD into sm[R_SATD + m]
template <int W, int ts>
HM_FN void all_satds(const Args& a, int* sm, int log2n, int tid, int nt) {
  const int ns = nt >= 32 ? nt / W : 1, set = nt >= 32 ? tid / W : 0;
  const int* src = sm + R_SRC;
  const int* su = sm + R_SU;
  const int* sf = sm + R_SF;
  const int dc = sm[R_DC];
  for (int m = set; m < 35; m += ns) {
    const int satd = mode_satd<W, ts>(a, src, su, sf, dc, m, log2n);
    if ((tid & (W - 1)) == 0) sm[R_SATD + m] = satd;
  }
}

HM_FN void rmd_block(const Args& a, int blk, int tid, int nt, int* sm) {
  const int n = a.n, line = 4 * n + 1, log2n = log2_of(n);
  const int bwn = a.w / n, bx0 = (blk % bwn) * n, by0 = (blk / bwn) * n;
  const int mid = 1 << (a.bd - 1), none = a.none[blk];
  int* su = sm + R_SU;
  int* sf = sm + R_SF;
  int* src = sm + R_SRC;
  for (int k = tid; k < line; k += nt)
    su[k] = none ? mid : a.plane[a.sub[(size_t)blk * line + k]];
  for (int e = tid; e < n * n; e += nt)
    src[e] = a.plane[(by0 + e / n) * a.w + bx0 + e % n];
  HM_SYNC();
  for (int k = tid; k < line; k += nt)
    sf[k] = filter_sample(su, k, n, a.bd, a.strong);
  if (tid == 0) sm[R_DC] = intra_dc(su, n, log2n);
  HM_SYNC();
  if (n == 4)
    all_satds<8, 4>(a, sm, log2n, tid, nt);
  else
    all_satds<32, 8>(a, sm, log2n, tid, nt);
  HM_SYNC();
  if (tid < 32) {
    // the first k of a stable ascending sort: k argmins over (rd, mode),
    // lane l holding the modes l and l + 32
    Lanes<float, 32> r0, r1;
    Lanes<int, 32> m0, m1;
    HM_LANES(j, 32) {
      m0[j] = j;
      m1[j] = j + 32 < 35 ? j + 32 : 99;
      r0[j] = HM_FADD((float)sm[R_SATD + j],
                      HM_FMUL(a.lam_sqrt, mode_bits(j)));
      r1[j] = m1[j] < 35 ? HM_FADD((float)sm[R_SATD + m1[j]],
                                   HM_FMUL(a.lam_sqrt, mode_bits(m1[j])))
                         : INFINITY;
    }
    for (int q = 0; q < a.k; ++q) {
      Lanes<float, 32> v;
      Lanes<int, 32> key;
      HM_LANES(j, 32) {
        const bool second = r1[j] < r0[j] || (r1[j] == r0[j] && m1[j] < m0[j]);
        v[j] = second ? r1[j] : r0[j];
        key[j] = second ? m1[j] : m0[j];
      }
      float best;
      int bm;
      lane_argmin(v, key, best, bm);
      if (tid == 0) a.out[(size_t)blk * a.k + q] = bm;
      HM_LANES(j, 32) {
        if (m0[j] == bm) {
          r0[j] = INFINITY;
          m0[j] = 99;
        }
        if (m1[j] == bm) {
          r1[j] = INFINITY;
          m1[j] = 99;
        }
      }
    }
  }
  HM_SYNC();
}

}  // namespace rmd
