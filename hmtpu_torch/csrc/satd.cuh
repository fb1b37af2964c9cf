// K8 satd8's lane code: HM's 8x8 Hadamard SATD (TComRdCost::xCalcHADs8x8,
// (sum |H D H| + 2) >> 2 a tile), summed over a block's 8x8 tiles; the
// port of hmtpu/search/me.py:159 satd_batch, and the NN-FME gate that
// compares two predictions of each block with it
// (hmtpu/encoder/pframe_dev.py:1545-1560).
//
// A warp takes four tiles, eight lanes a tile, one row a lane
// (`Lanes<int, 32>`: lane j holds row j & 7 of tile j >> 3): the row's
// butterflies run in its registers (hm::fwht8), the column's across the
// tile's lanes by shuffles at distances 1, 2 and 4, the tile's sum by a
// width-8 warp sum.  A block of 8x8 is a tile, so a warp takes four
// blocks; a larger block takes the warp for (n / 8)^2 / 4 rounds of four
// tiles, and its tiles meet by shuffles at distances 8 and 16.  All
// integer: the result is exact in any order.
//
// A job is one call's blocks: the one-call form's (B, n, n) pairs, or a
// gate level's blocks of an n-grid over the original plane (read in
// place, rows and columns clamped to the plane: the edge replication)
// against its two predictions (B, n, n).  Compiles as host C++ too (one
// thread holds a warp's lanes; `job_host`).
#pragma once

#include "hm_dsp.cuh"
#include "hm_port.cuh"

namespace satd {

using L32 = hm::Lanes<int, 32>;

struct Job {
  const int* org;  // the one-call form's a (B, n, n), or the gate's plane
  int oh, ow;      // the plane's sides (a multiple of 8 wide); 0: (B, n, n)
  const int* pred[2];  // (B, n, n) each; the one-call form's b in pred[0]
  int np;              // predictions compared with org: 1 or 2
  int n, gw, nb;       // block side, grid width (the gate), blocks
  const int* mvx;      // the gate: (2, B) quarter-pel MV sets (or null)
  const int* mvy;
  int* out;  // the one-call form: (B,) SATD; the gate: (2, B) the MV kept
};

// warps a job takes: four 8x8 blocks a warp, else a block a warp
HM_HD int job_warps(const Job& a) {
  return a.n == 8 ? (a.nb + 3) >> 2 : a.nb;
}

// row r of an 8x8 tile at p (16 bytes at a time on the card)
HM_FN void load8(const int* p, int* v) {
#if defined(__CUDACC__)
  const int4 x = __ldg(reinterpret_cast<const int4*>(p));
  const int4 y = __ldg(reinterpret_cast<const int4*>(p) + 1);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  v[4] = y.x, v[5] = y.y, v[6] = y.z, v[7] = y.w;
#else
  for (int i = 0; i < 8; ++i) v[i] = p[i];
#endif
}

// per lane: its tile's (sum |H D H| + 2) >> 2, D the difference whose
// column i lane j holds in c[i][j]
HM_FN void tile_satd(L32 (&c)[8], L32& tv) {
  HM_LANES(j, 32) {
    int v[8];
    HM_UNROLL
    for (int i = 0; i < 8; ++i) v[i] = c[i][j];
    hm::fwht8(v);
    HM_UNROLL
    for (int i = 0; i < 8; ++i) c[i][j] = v[i];
  }
  HM_UNROLL
  for (int h = 1; h < 8; h <<= 1) {
    HM_UNROLL
    for (int i = 0; i < 8; ++i) {
      const L32 o = hm::lane_xor(c[i], h);
      HM_LANES(j, 32) c[i][j] = (j & h) ? o[j] - c[i][j] : c[i][j] + o[j];
    }
  }
  L32 s;
  HM_LANES(j, 32) {
    int t = 0;
    HM_UNROLL
    for (int i = 0; i < 8; ++i) t += hm::iabs(c[i][j]);
    s[j] = t;
  }
  HM_UNROLL
  for (int h = 1; h < 8; h <<= 1) {
    const L32 o = hm::lane_xor(s, h);
    HM_LANES(j, 32) s[j] += o[j];
  }
  HM_LANES(j, 32) tv[j] = (s[j] + 2) >> 2;
}

// warp wi of a job: its blocks' SATDs against each prediction, and the
// result (the SATD, or the gate's pick: the first MV set only where its
// SATD is strictly below the second's) written by each block's lane 0
HM_FN void warp_job(const Job& a, int wi) {
  const int nt = a.n >> 3, tiles = nt * nt;
  const int rounds = tiles == 1 ? 1 : tiles >> 2;
  L32 acc[2];
  HM_LANES(j, 32) acc[0][j] = acc[1][j] = 0;
  for (int k = 0; k < rounds; ++k) {
    L32 d[2][8];
    HM_LANES(j, 32) {
      const int g = j >> 3, r = j & 7;
      const int b = tiles == 1 ? 4 * wi + g : wi;
      const int t = tiles == 1 ? 0 : 4 * k + g;
      const int ty = t / nt, tx = t - ty * nt;
      int o[8] = {0, 0, 0, 0, 0, 0, 0, 0}, q[8];
      const bool on = b < a.nb;
      if (on) {
        if (a.oh == 0) {
          load8(a.org + ((size_t)b * a.n + ty * 8 + r) * a.n + tx * 8, o);
        } else {
          const int by = b / a.gw, bx = b - by * a.gw;
          const int y = hm::imin(by * a.n + ty * 8 + r, a.oh - 1);
          const int x = bx * a.n + tx * 8;
          const int* row = a.org + (size_t)y * a.ow;
          if (x < a.ow) {
            load8(row + x, o);
          } else {
            HM_UNROLL
            for (int i = 0; i < 8; ++i) o[i] = row[a.ow - 1];
          }
        }
      }
      HM_UNROLL
      for (int s = 0; s < 2; ++s) {
        if (on && s < a.np) {
          load8(a.pred[s] + ((size_t)b * a.n + ty * 8 + r) * a.n + tx * 8,
                q);
        } else {
          HM_UNROLL
          for (int i = 0; i < 8; ++i) q[i] = o[i];
        }
        HM_UNROLL
        for (int i = 0; i < 8; ++i) d[s][i][j] = o[i] - q[i];
      }
    }
    // (s a constant in every loop over the sets: no dynamic index into
    // the registers)
    HM_UNROLL
    for (int s = 0; s < 2; ++s) {
      if (s >= a.np) continue;
      L32 tv;
      tile_satd(d[s], tv);
      HM_LANES(j, 32) acc[s][j] += tv[j];
    }
  }
  if (tiles > 1) {
    HM_UNROLL
    for (int s = 0; s < 2; ++s) {
      HM_UNROLL
      for (int h = 8; h < 32; h <<= 1) {
        const L32 o = hm::lane_xor(acc[s], h);
        HM_LANES(j, 32) acc[s][j] += o[j];
      }
    }
  }
  HM_LANES(j, 32) {
    const int b = tiles == 1 ? 4 * wi + (j >> 3) : wi;
    if ((j & (tiles == 1 ? 7 : 31)) == 0 && b < a.nb) {
      if (a.np == 1) {
        a.out[b] = acc[0][j];
      } else {
        const int s = acc[0][j] < acc[1][j] ? 0 : 1;
        a.out[b] = a.mvx[s * a.nb + b];
        a.out[a.nb + b] = a.mvy[s * a.nb + b];
      }
    }
  }
}

#if !defined(__CUDACC__)
// a job on one host thread: its warps in turn
inline void job_host(const Job& a) {
  for (int w = 0; w < job_warps(a); ++w) warp_job(a, w);
}
#endif

}  // namespace satd
