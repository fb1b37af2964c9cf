// K24 tmvp_grid's lane code: the collocated (temporal) candidate of one
// block of a CU grid and its two scalings, the port of
// hmtpu/search/wavefront.py:634 temporal_cand_grid_dev and :624
// scale_mv_pair_dev as the P pass composes them (`t_level`,
// hmtpu/encoder/pframe_dev.py:381): 8.5.3.2.8's bottom-right position
// (inside the picture and the CTU row) else the centre, read from the
// collocated picture's 8x8 motion at the 16x16-compressed position
// ((x >> 4) << 4); the candidate's MV scaled to reference 0 (merge) and
// to the block's own reference (AMVP), tb and td clipped to [-128, 127]
// and the MV kept as it is where td == tb before the clip.  Integer only;
// the shifts of negative values are arithmetic, the division truncates
// (mvcand.cuh scale_mv).  `grids_lane` is the grids form's indexing: the
// pass's three grids in one launch.  Compiles as host C++ too.
#pragma once

#include "hm_port.cuh"
#include "mvcand.cuh"

namespace tmvp {

using hm::iclamp;
using hm::imin;

struct Args {
  const int *col_mvx, *col_mvy, *col_ok, *col_poc;  // (bh, bw) 8x8 grid
  const int* aref;      // (gw * gh,) each block's searched reference
  const int* ref_pocs;  // (R,) the L0 POCs
  int* out;             // (5, gw * gh): t_ok, merge (x, y), AMVP (x, y)
  int n, gw, gh, w, h, log2_ctu, cur_poc, col_pic_poc, R;
};

// scale_mv_pair_dev: 8.5.3.1.3 with the TMVP clip of tb and td
HM_FN void scale_pair(int mvx, int mvy, int tb, int td, int* ox, int* oy) {
  if (td == tb) {
    *ox = mvx;
    *oy = mvy;
    return;
  }
  mvc::scale_mv(mvx, mvy, iclamp(tb, -128, 127), iclamp(td, -128, 127), ox,
                oy);
}

// block i of the grid (raster order)
HM_FN void tmvp_lane(const Args& a, int i) {
  const int bw = a.w / 8, bh = a.h / 8, P = a.gw * a.gh;
  const int x0 = (i % a.gw) * a.n, y0 = (i / a.gw) * a.n;
  auto at = [&](int xs, int ys) {
    return imin((ys >> 4) * 2, bh - 1) * bw + imin((xs >> 4) * 2, bw - 1);
  };
  const int xbr = x0 + a.n, ybr = y0 + a.n;
  const bool br_in = xbr < a.w && ybr < a.h &&
                     (y0 >> a.log2_ctu) == (ybr >> a.log2_ctu);
  const int fb = at(imin(xbr, a.w - 1), imin(ybr, a.h - 1));
  const int fc = at(x0 + a.n / 2, y0 + a.n / 2);
  const bool ok_br = a.col_ok[fb] != 0 && br_in;
  const bool ok_ct = a.col_ok[fc] != 0;
  const int f = ok_br ? fb : fc;
  const int rx = a.col_mvx[f], ry = a.col_mvy[f];
  const int td = a.col_pic_poc - a.col_poc[f];
  int mx, my, ax, ay;
  scale_pair(rx, ry, a.cur_poc - a.ref_pocs[0], td, &mx, &my);
  scale_pair(rx, ry, a.cur_poc - a.ref_pocs[iclamp(a.aref[i], 0, a.R - 1)],
             td, &ax, &ay);
  a.out[i] = ok_br || ok_ct;
  a.out[P + i] = mx;
  a.out[2 * P + i] = my;
  a.out[3 * P + i] = ax;
  a.out[4 * P + i] = ay;
}

// the grids form: up to three grids of a pass (the 8, 16 and padded 32
// grids), their blocks one after another, each grid's output its own
// (5, gw * gh) rows
struct Grids {
  Args g[3];
  int p[3];  // blocks a grid (0: no grid)
};

// block i of the grids form; the grid by comparisons (no dynamic index
// into the argument)
HM_FN void grids_lane(const Grids& a, int i) {
  if (i < a.p[0]) {
    tmvp_lane(a.g[0], i);
  } else if ((i -= a.p[0]) < a.p[1]) {
    tmvp_lane(a.g[1], i);
  } else if ((i -= a.p[1]) < a.p[2]) {
    tmvp_lane(a.g[2], i);
  }
}

#if !defined(__CUDACC__)
// the grids form on one host thread: its blocks in order, or
// (hm::lane_reverse) last first
inline void grids_host(const Grids& a) {
  const int total = a.p[0] + a.p[1] + a.p[2];
  for (int k = 0; k < total; ++k)
    grids_lane(a, hm::lane_reverse ? total - 1 - k : k);
}
#endif

}  // namespace tmvp
