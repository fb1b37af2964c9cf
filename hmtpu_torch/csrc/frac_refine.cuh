// K9 frac_refine's lane code: HM's two-stage fractional motion refinement
// (xPatternSearchFracDIF, TEncSearch.cpp:5232-5268), the port of
// hmtpu/search/me.py:249 frac_refine_batch on a stacked reference with a
// reference index per block.  Per block (PU): 9 half-pel candidates around
// 4 * int_mv (_FRAC_OFFS x 2, the centre first), then 9 quarter-pel
// candidates around the half-pel winner (offsets x 1); each candidate is
// priced by the summed 8x8 Hadamard SATD of the block against its 8-tap
// DCT-IF luma prediction (final samples, clipped to bd bits), and each
// stage keeps the first candidate of least cost (jnp.argmin).
//
// A warp takes a PU (`Lanes<int, 32>`).  Every candidate of both stages
// lies within one sample of the integer MV (|offset| <= 3 quarter pels),
// so the PU's clamped (n + 8) x (n + 8) patch of its own reference goes
// into the warp's shared memory once.  A stage's candidates go by column:
// the three of a column share their horizontal position (integer column
// and phase), so the horizontal pass runs once a column, over every patch
// row, into the warp's shared memory as raw 8-tap sums (none where the
// phase is 0: those candidates read the patch itself), and each of the
// column's candidates runs its vertical pass over it.  The raw sum is
// kept because the intermediate differs by case: `hm::mc_tmp` offsets and
// shifts it only where both phases are non-zero, the H-only case rounds
// the raw sum itself (`mc_honly`).  The vertical pass is one formula for
// the four cases: the phase-0 taps (64 at the centre) make the copy and
// H-only sums 64 times the sample, so no lane waits on another's branch.
//
// A lane holds a column of an 8x8 tile (the SATD of a tile equals that of
// its transpose, so `satd::tile_satd` takes columns as it takes rows): it
// reads the 15 source rows of its column once and makes the 8 outputs
// from registers.  An 8x8 PU puts its column's three candidates side by
// side, eight lanes a candidate (lanes 24-31 repeat the third); a 16x16
// or 32x32 PU runs one candidate at a time, its (n / 8)^2 tiles in rounds
// of four, as satd::warp_job does.  The stage's pick is `hm::lane_argmin`
// over the nine costs, lane c holding candidate c's, so the first index
// wins a tie.  No block barrier, no atomic: the lanes meet by __syncwarp
// and shuffles.  All integer, so the order of the sums does not matter.
//
// A job is one call's PUs: the one-call form's (nb, n, n) org blocks at
// positions xs0 / ys0, or a level's blocks of an n-grid over the original
// plane, read in place with rows and columns clamped to it (the 32
// level's edge replication).  Compiles as host C++ too (one thread holds
// a warp's lanes; `job_host`), lanes in order or last first
// (tests/test_torch_frac_lanes.py).
#pragma once

#include "hm_dsp.cuh"
#include "hm_port.cuh"
#include "mc_dctif.cuh"
#include "satd.cuh"

// a loop kept rolled on the card (its body is large)
#if defined(__CUDACC__)
#define FRAC_ROLLED _Pragma("unroll 1")
#else
#define FRAC_ROLLED
#endif

namespace frac {

using L32 = hm::Lanes<int, 32>;
using hm::iclamp;
using hm::imin;

// (dy, dx) of a stage's 9 candidates, the centre first (me.py _FRAC_OFFS)
HM_CONST int kOffs[9][2] = {{0, 0},  {0, -1}, {0, 1},  {-1, 0}, {1, 0},
                            {-1, -1}, {-1, 1}, {1, -1}, {1, 1}};
// the candidates of each column (dx = -1, 0, 1), by row (dy = -1, 0, 1)
HM_CONST int kByDx[3][3] = {{5, 1, 7}, {3, 0, 4}, {6, 2, 8}};

struct Job {
  const int* refs;  // (R, H, W) reference planes
  int R, H, W;
  const int* org;  // the one-call form's (nb, n, n), or the (oh, ow) plane
  int oh, ow;      // the plane's sides; 0: (nb, n, n)
  const int* xs0;  // (nb,) block positions, or null: the n-grid gw wide
  const int* ys0;
  const int* ridx;  // (nb,) each block's reference (clamped to R)
  const int* mvx;   // (nb,) integer MVs
  const int* mvy;
  int* out;  // (2, nb): the quarter-pel MVs, x then y
  int n, gw, nb, bd;
};

// the row strides of the patch and of the horizontal sums: 8 rows apart
// lie 16 banks apart, so a 16x16 PU's four tiles read without conflicts
HM_HD constexpr int patch_stride(int n) { return n + 10; }
HM_HD constexpr int sums_stride(int n) { return n + 2; }
// the columns' sums kept at once: all three of a stage (its horizontal
// passes side by side), one at a time at 32x32
HM_HD constexpr int sums_slots(int n) { return n == 32 ? 1 : 3; }
// ints of a warp's shared memory for an n x n PU
HM_HD constexpr int smem_ints(int n) {
  return (n + 8) * (patch_stride(n) + sums_slots(n) * sums_stride(n));
}

// the clamped (n + 8)^2 patch of `plane` whose corner is (x0, y0); lp
// lanes a row, rp rows a step, 8 loads of a lane in flight
HM_FN void gather(const int* plane, int H, int W, int x0, int y0, int n,
                  int* patch) {
  const int pw = n + 8, ps = patch_stride(n);
  const int lp = hm::mc_row_lanes(pw), rp = 32 / lp;
  constexpr int kLd = 8;
  HM_LANES(j, 32) {
    const int c = j & (lp - 1);
    for (int c0 = 0; c0 < pw; c0 += lp) {
      const int col = c0 + c;
      if (col < pw) {
        const int* src = plane + iclamp(x0 + col, 0, W - 1);
        for (int i0 = j / lp; i0 < pw; i0 += kLd * rp) {
          int v[kLd];
          HM_UNROLL
          for (int u = 0; u < kLd; ++u) {
            const int i = i0 + u * rp;
            v[u] = i < pw ? src[(size_t)iclamp(y0 + i, 0, H - 1) * W] : 0;
          }
          HM_UNROLL
          for (int u = 0; u < kLd; ++u)
            if (i0 + u * rp < pw) patch[(i0 + u * rp) * ps + col] = v[u];
        }
      }
    }
  }
}

// the raw horizontal 8-tap sums of phase fx at integer column ix (relative
// to the integer MV) over every patch row: sums[r][c] = sum_t kLuma[fx][t]
// * patch[r][ix + c + 1 + t]
template <int N>
HM_FN void h_pass(const int* patch, int ix, int fx, int* sums) {
  constexpr int pw = N + 8, ps = patch_stride(N), ss = sums_stride(N);
  // (N + 8) * N is a multiple of 32: every lane takes as many sums
  static_assert(pw * N % 32 == 0, "sums a lane");
  HM_LANES(j, 32) {
    HM_UNROLL
    for (int u = 0; u < pw * N / 32; ++u) {
      const int k = j + 32 * u, r = k / N, c = k - r * N;
      const int* s = patch + r * ps + ix + c + 1;
      int acc = 0;
      HM_UNROLL
      for (int t = 0; t < 8; ++t) acc += hm::kLuma[fx][t] * s[t];
      sums[r * ss + c] = acc;
    }
  }
}

// per lane: the SATD of its 8x8 tile (the column c = j & 7 of the tile
// at (ty, tx) in lane j's slot) of the candidate with horizontal phase fx
// at integer column ix (the warp's own) and vertical phase fy[j] at
// integer row iy[j], read from the patch (fx == 0) or from the column's
// sums.  At 8x8 a lane's vertical phase is its slot's, so every case
// takes the one formula; above, the phases are the warp's own and the
// copy and H-only cases read their 8 samples alone
template <int N>
HM_FN void tile_cost(const Job& a, int b, int xs, int ys, const int* patch,
                     const int* sums, int ix, int fx, const L32& iy,
                     const L32& fy, const L32& ty, const L32& tx, L32& tv) {
  constexpr int ps = patch_stride(N), ss = sums_stride(N);
  // the source column: patch samples or horizontal sums, and its stride
  const int st = fx == 0 ? ps : ss;
  L32 d[8];
  HM_LANES(j, 32) {
    const int c = tx[j] * 8 + (j & 7);
    const int* src = fx == 0 ? patch + ix + c + 4 : sums + c;
    // source rows r0 .. r0 + 14 (patch rows: 4 above the block)
    const int r0 = iy[j] + ty[j] * 8 + 1;
    int v[8];
    if (N > 8 && fy[j] == 0) {
      HM_UNROLL
      for (int i = 0; i < 8; ++i) {
        const int x = src[(r0 + 3 + i) * st];
        v[i] = fx == 0 ? hm::mc_copy<false>(x, a.bd)
                       : hm::mc_honly<false>(x, a.bd);
      }
    } else {
      const bool both = fx != 0 && fy[j] != 0;
      int w[15];
      HM_UNROLL
      for (int t = 0; t < 15; ++t) {
        const int x = src[(r0 + t) * st];
        w[t] = both ? hm::mc_tmp(x, true, a.bd) : x;
      }
      int cy[8];
      HM_UNROLL
      for (int t = 0; t < 8; ++t) cy[t] = hm::kLuma[fy[j]][t];
      HM_UNROLL
      for (int i = 0; i < 8; ++i) {
        int s = 0;
        HM_UNROLL
        for (int t = 0; t < 8; ++t) s += cy[t] * w[i + t];
        // phase 0 vertically: s is 64 times the sample (copy, H-only)
        v[i] = fy[j] == 0
                   ? (fx == 0 ? hm::mc_copy<false>(s >> 6, a.bd)
                              : hm::mc_honly<false>(s >> 6, a.bd))
                   : (fx == 0 ? hm::mc_vonly<false>(s, a.bd)
                              : hm::mc_both<false>(s, a.bd));
      }
    }
    // the org column
    if (a.oh == 0) {
      const int* p = a.org + ((size_t)b * N + ty[j] * 8) * N + c;
      HM_UNROLL
      for (int i = 0; i < 8; ++i) d[i][j] = p[(size_t)i * N] - v[i];
    } else {
      const int* p = a.org + imin(xs + c, a.ow - 1);
      HM_UNROLL
      for (int i = 0; i < 8; ++i)
        d[i][j] = p[(size_t)imin(ys + ty[j] * 8 + i, a.oh - 1) * a.ow] - v[i];
    }
  }
  satd::tile_satd(d, tv);
}

// PU b of a job of N x N PUs on a warp; sm: smem_ints(N) ints of the
// warp's own
template <int N>
HM_FN void warp_pu(const Job& a, int b, int* sm) {
  constexpr int nt = N >> 3, rounds = nt == 1 ? 1 : nt * nt / 4;
  constexpr int slots = sums_slots(N), slot = (N + 8) * sums_stride(N);
  int* patch = sm;
  int* sums = sm + (N + 8) * patch_stride(N);
  const int imx = a.mvx[b], imy = a.mvy[b];
  const int xs = a.xs0 ? a.xs0[b] : (b % a.gw) * N;
  const int ys = a.xs0 ? a.ys0[b] : (b / a.gw) * N;
  const int* plane =
      a.refs + (size_t)iclamp(a.ridx[b], 0, a.R - 1) * a.H * a.W;
  gather(plane, a.H, a.W, xs + imx - 4, ys + imy - 4, N, patch);
  MC_WSYNC();
  int cx = 4 * imx, cy = 4 * imy;
  for (int step = 2; step >= 1; --step) {
    L32 cost, key;
    HM_LANES(j, 32) {
      cost[j] = 0x7fffffff;
      key[j] = j;
    }
    if (nt == 1) {
      // three slots: every column's sums, then the column's three
      // candidates side by side (slot 3 repeats the third)
      HM_UNROLL
      for (int g = 0; g < 3; ++g) {
        const int qx = cx + (g - 1) * step;
        if (qx & 3) h_pass<N>(patch, (qx >> 2) - imx, qx & 3, sums + g * slot);
      }
      MC_WSYNC();
      HM_UNROLL
      for (int g = 0; g < 3; ++g) {
        const int qx = cx + (g - 1) * step;
        L32 iy, fy, zero, tv;
        HM_LANES(j, 32) {
          const int qy = cy + (imin(j >> 3, 2) - 1) * step;
          iy[j] = (qy >> 2) - imy;
          fy[j] = qy & 3;
          zero[j] = 0;
        }
        tile_cost<N>(a, b, xs, ys, patch, sums + g * slot, (qx >> 2) - imx,
                     qx & 3, iy, fy, zero, zero, tv);
        HM_UNROLL
        for (int s = 0; s < 3; ++s) {
          const int t = hm::lane_get(tv, 8 * s);
          HM_LANES(j, 32) if (j == kByDx[g][s]) cost[j] = t;
        }
      }
    } else {
      if (slots == 3) {
        for (int g = 0; g < 3; ++g) {
          const int qx = cx + (g - 1) * step;
          if (qx & 3)
            h_pass<N>(patch, (qx >> 2) - imx, qx & 3, sums + g * slot);
        }
        MC_WSYNC();
      }
      // the nine candidates, column by column, a candidate's tiles in
      // rounds of four
      FRAC_ROLLED
      for (int c = 0; c < 9; ++c) {
        const int g = c / 3, s = c - 3 * g;
        const int qx = cx + (g - 1) * step, qy = cy + (s - 1) * step;
        const int fx = qx & 3, ix = (qx >> 2) - imx;
        if (slots == 1 && s == 0) {
          // one slot: the column's sums over the last column's
          MC_WSYNC();
          if (fx != 0) h_pass<N>(patch, ix, fx, sums);
          MC_WSYNC();
        }
        L32 iy, fy, acc;
        HM_LANES(j, 32) {
          iy[j] = (qy >> 2) - imy;
          fy[j] = qy & 3;
          acc[j] = 0;
        }
        HM_UNROLL
        for (int k = 0; k < rounds; ++k) {
          L32 ty, tx, tv;
          HM_LANES(j, 32) {
            const int t = 4 * k + (j >> 3);
            ty[j] = t / nt;
            tx[j] = t - ty[j] * nt;
          }
          tile_cost<N>(a, b, xs, ys, patch, sums + (slots == 3 ? g * slot : 0),
                       ix, fx, iy, fy, ty, tx, tv);
          HM_LANES(j, 32) acc[j] += tv[j];
        }
        HM_UNROLL
        for (int h = 8; h < 32; h <<= 1) {
          const L32 o = hm::lane_xor(acc, h);
          HM_LANES(j, 32) acc[j] += o[j];
        }
        HM_LANES(j, 32) if (j == kByDx[g][s]) cost[j] = acc[j];
      }
    }
    // the next stage's sums overwrite these
    MC_WSYNC();
    int best_cost, best;
    hm::lane_argmin(cost, key, best_cost, best);
    cx += kOffs[best][1] * step;
    cy += kOffs[best][0] * step;
  }
  HM_LANES(j, 32) {
    if (j == 0) {
      a.out[b] = cx;
      a.out[a.nb + b] = cy;
    }
  }
}

// PU b of a job on a warp, by the job's PU size
HM_FN void warp_job(const Job& a, int b, int* sm) {
  if (a.n == 8) {
    warp_pu<8>(a, b, sm);
  } else if (a.n == 16) {
    warp_pu<16>(a, b, sm);
  } else {
    warp_pu<32>(a, b, sm);
  }
}

// the levels form: up to three levels' jobs, their PUs one after another
struct Levels {
  Job lv[3];
  int nb[3];
};

// warp b of the levels form (sm: the launch's largest smem_ints); the
// level by comparisons (no dynamic index into the argument), one call of
// each PU size's code
HM_FN void levels_warp(const Levels& g, int b, int* sm) {
  const Job* a = &g.lv[0];
  if (b >= g.nb[0]) {
    b -= g.nb[0];
    a = &g.lv[1];
    if (b >= g.nb[1]) {
      b -= g.nb[1];
      a = &g.lv[2];
      if (b >= g.nb[2]) return;
    }
  }
  warp_job(*a, b, sm);
}

#if !defined(__CUDACC__)
// a job on one host thread: its PUs in turn
inline void job_host(const Job& a) {
  int* sm = new int[smem_ints(a.n)];
  for (int b = 0; b < a.nb; ++b) warp_job(a, b, sm);
  delete[] sm;
}
// the levels form on one host thread: its warps in turn
inline void levels_host(const Levels& g) {
  int* sm = new int[smem_ints(32)];
  for (int b = 0; b < g.nb[0] + g.nb[1] + g.nb[2]; ++b)
    levels_warp(g, b, sm);
  delete[] sm;
}
#endif

}  // namespace frac
