// K3 deblock's lane code: the HEVC in-loop deblocking filter (H.265
// 8.7.2) of one picture, bit-exact with hmtpu/ops/deblock.py:471
// deblock_frame_dev (its boundary strength :452 _bs_dev, masked by the
// CU-interior grids, and its luma :294 and chroma :374 edge filters), and
// with the P / B / I passes' inputs to it (hmtpu/encoder/pframe_dev.py:
// 1797-1832: the 4x4 maps repeated from the 8x8 state, the POC lookups,
// the CU-interior masks), which the state form reads from the 8x8 state
// in place.
//
// Why a tile is independent of its neighbours.  Luma edges of one
// direction lie on the 8-grid, 8 samples apart; a luma filter reads 4
// samples on each side of its edge and writes at most 3, and its
// decisions read lines 0 and 3 of a 4-line segment that starts on the
// 4-grid.  A tile whose borders lie 4 samples off the 8-grid (at 8k + 4)
// therefore holds every sample that its own edges read or write, in both
// directions: a vertical edge at x = 8m reads columns 8m - 4 .. 8m + 3,
// inside the columns [8a + 4, 8b + 4) of the tile whenever a < m <= b,
// and its segments' rows are 4-aligned runs inside the tile's rows; the
// horizontal edges likewise.  The samples a horizontal edge reads were
// written (if at all) by vertical edges of the same tile.  Chroma (4:2:0)
// is the same on its own 8-grid: a filter reads 2 samples on each side
// and writes 1, and chroma tile borders lie at 8k + 4 chroma samples.  So
// each tile runs the picture's order (8.7.2: all vertical edges, then all
// horizontal ones) on its own, behind one barrier of its own, and no two
// tiles share a sample.
//
// Design: a thread block a tile position: a 32x32 luma tile and the two
// 16x16 chroma tiles at the same index (both grids have as many tiles,
// (w + 4) / 32 rounded up across, for sides that are multiples of 8).  The
// tiles are loaded coalesced into shared memory (rows padded to an odd
// stride: the lanes of a warp read different rows or columns), filtered
// in place and stored coalesced to new planes.  A direction's work is 48
// tasks of four lanes: 32 luma segments (4 edges x 8 segments of 4 lines)
// and 8 chroma segments of each chroma plane (2 edges x 4 segments).  A
// luma segment takes a line a lane (`Lanes<int, 4>`): each lane loads its
// 8 samples and its line's decision terms, lines 0 and 3's terms reach
// every lane by two shuffles and a vote, and each lane filters its own
// line.  A chroma segment takes a line a lane too.  The boundary strength
// of a task's segment (and whether a chroma segment is on: the co-located
// luma BS is 2) depends on the metadata alone: threads 0-95 derive the 96
// switches of the block's two directions, a switch a thread, into shared
// memory while the tiles' loads are in flight.
//
// Two forms of metadata: `MapSrc`, the 4x4 maps deblock_frame_dev takes
// (intra, cbf, two lists' MVs and reference POCs, the optional
// CU-interior masks on the 8-cell grid), and `StateSrc`, the passes' 8x8
// cell state read in place (P / B: the direction, both lists' MVs and
// reference indices, the luma cbf and the CU size columns of `blk`, and
// the lists' POCs by value; I: the CU size column alone, every cell
// intra).  Compiles as host C++ too (one thread runs a tile's tasks in
// turn and a task's lanes in a loop: `frame_host`).
#pragma once

#include "hm_port.cuh"

namespace db {

using L4 = hm::Lanes<int, 4>;

HM_CONST int kBeta[52] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  6,  7,
    8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32,
    34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
HM_CONST int kTc[54] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13,
    14, 16, 18, 20, 22, 24};

constexpr int TL = 32;           // luma tile side
constexpr int TC = 16;           // chroma tile side
constexpr int SL = TL + 1;       // shared-memory row strides
constexpr int SC = TC + 1;
constexpr int NTASK = 48;        // a direction's tasks: 32 luma, 2 x 8 chroma
constexpr int NT = 4 * NTASK;    // threads a block on the card

struct Par {
  int h, w;                      // luma sides, multiples of 8
  int qp, bd, beta_off, tc_off;
  int tc_cb, tc_cr;              // the chroma planes' tC (BS 2)
};

struct Planes {
  const int* in[3];              // (h, w), (h/2, w/2) x 2
  int* out[3];
};

struct Tile {
  int y[TL * SL];
  int c[2][TC * SC];
};

// 8.7.2.4: the motion test between sides p and q, each with two lists'
// reference POCs (-1: list unused) and MVs
HM_FN bool far4(int ax, int ay, int bx, int by) {
  return hm::iabs(ax - bx) >= 4 || hm::iabs(ay - by) >= 4;
}

struct Motion {
  int r0, r1, x0, y0, x1, y1;
};

HM_FN bool motion_bs(const Motion& p, const Motion& q) {
  const int big = 1 << 20;
  const bool pu0 = p.r0 >= 0, pu1 = p.r1 >= 0, qu0 = q.r0 >= 0,
             qu1 = q.r1 >= 0;
  const int cnt_p = (int)pu0 + (int)pu1, cnt_q = (int)qu0 + (int)qu1;
  const int p_lo = hm::imin(pu0 ? p.r0 : big, pu1 ? p.r1 : big);
  const int p_hi = hm::imax(pu0 ? p.r0 : -big, pu1 ? p.r1 : -big);
  const int q_lo = hm::imin(qu0 ? q.r0 : big, qu1 ? q.r1 : big);
  const int q_hi = hm::imax(qu0 ? q.r0 : -big, qu1 ? q.r1 : -big);
  if (cnt_p != cnt_q || p_lo != q_lo || p_hi != q_hi) return true;
  if (cnt_p == 2 && cnt_q == 2) {
    if (p_lo == p_hi) {
      return (far4(p.x0, p.y0, q.x0, q.y0) || far4(p.x1, p.y1, q.x1, q.y1)) &&
             (far4(p.x0, p.y0, q.x1, q.y1) || far4(p.x1, p.y1, q.x0, q.y0));
    }
    const bool p_is_lo = pu0 && p.r0 == p_lo;
    const bool q_is_lo = qu0 && q.r0 == q_lo;
    const int plx = p_is_lo ? p.x0 : p.x1, ply = p_is_lo ? p.y0 : p.y1;
    const int phx = p_is_lo ? p.x1 : p.x0, phy = p_is_lo ? p.y1 : p.y0;
    const int qlx = q_is_lo ? q.x0 : q.x1, qly = q_is_lo ? q.y0 : q.y1;
    const int qhx = q_is_lo ? q.x1 : q.x0, qhy = q_is_lo ? q.y1 : q.y0;
    return far4(plx, ply, qlx, qly) || far4(phx, phy, qhx, qhy);
  }
  const int pux = pu0 ? p.x0 : p.x1, puy = pu0 ? p.y0 : p.y1;
  const int qux = qu0 ? q.x0 : q.x1, quy = qu0 ? q.y0 : q.y1;
  return far4(pux, puy, qux, quy);
}

// An edge segment's boundary strength comes in two steps: `load` reads
// both sides' fields (one round of independent loads, the POCs left as
// reference indices), `bs` applies the rules in order (8.7.2.4: the
// CU-interior mask, intra, luma cbf, motion) with the block's POC table.
// A kernel issues the loads with the tiles' and fills the table meanwhile.

// the 4x4 maps of deblock_frame_dev
struct MapSrc {
  const int* intra4;  // (h4, w4)
  const int* cbf4;    // (h4, w4)
  const int* mvx;     // (2, h4, w4)
  const int* mvy;
  const int* refpoc;  // (2, h4, w4), -1 = list unused
  const int* mask_v;  // (h/8, w/8 - 1) CU-interior vertical edges, or null
  const int* mask_h;  // (h/8 - 1, w/8), or null
  int h4, w4, bw;

  struct Edge {
    int interior, ip, iq, cp, cq;
    Motion mp, mq;
  };
  // (no table: the POCs are in the maps)
  HM_FN void fill_pocs(int*, int) const {}
  HM_FN Motion side(int b) const {
    const int n = h4 * w4;
    return Motion{refpoc[b], refpoc[n + b], mvx[b], mvy[b], mvx[n + b],
                  mvy[n + b]};
  }
  // luma segment `seg` (4 samples along the edge) of edge j at 8 (j + 1)
  // across direction dir
  HM_FN Edge load(int dir, int j, int seg) const {
    int p, q;
    Edge e;
    if (dir == 0) {  // vertical edge: p = 4x4 column 2j + 1, q = 2j + 2
      p = seg * w4 + 2 * j + 1;
      q = p + 1;
      e.interior = mask_v ? mask_v[(seg >> 1) * (bw - 1) + j] : 0;
    } else {         // horizontal edge: p = row 2j + 1, q = 2j + 2
      p = (2 * j + 1) * w4 + seg;
      q = p + w4;
      e.interior = mask_h ? mask_h[j * bw + (seg >> 1)] : 0;
    }
    e.ip = intra4[p];
    e.iq = intra4[q];
    e.cp = cbf4[p];
    e.cq = cbf4[q];
    e.mp = side(p);
    e.mq = side(q);
    return e;
  }
  HM_FN int bs(const Edge& e, const int*) const {
    if (e.interior) return 0;
    if (e.ip || e.iq) return 2;
    if (e.cp || e.cq || motion_bs(e.mp, e.mq)) return 1;
    return 0;
  }
};

// the passes' 8x8 cell state: column pointers with a row stride (P / B:
// `blk`'s columns; I: dir .. ref1 null, every cell intra)
struct StateSrc {
  const int* dir;     // inter direction: bit 0 list 0, bit 1 list 1; 0 intra
  const int* mvx;
  const int* mvy;
  const int* ref;
  const int* mvx1;
  const int* mvy1;
  const int* ref1;
  const int* cbf;     // luma cbf
  const int* sz;      // CU size: 0 8x8, 1 16x16, 2 32x32
  int stride, bw;
  int nr0, nr1;       // the lists' lengths (nr1 0: a P slice)
  int poc0[16], poc1[16];

  // a cell's fields: direction, luma cbf, both lists' reference indices
  // and MVs
  struct Cell {
    int d, cbf, r0, r1, x0, y0, x1, y1;
  };
  struct Edge {
    int j, s;   // the edge's index, the left / upper cell's CU size
    Cell p, q;
  };
  // the POC table `tab` (list 0's 16 POCs, then list 1's), entry t of 32
  // (by selects: an index into the kernel's argument would copy it to
  // the stack); a block fills its table in shared memory once
  HM_FN void fill_pocs(int* tab, int t) const {
    if (t >= 32) return;
    int v = 0;
    HM_UNROLL
    for (int k = 0; k < 16; ++k)
      v = (t & 15) == k ? (t < 16 ? poc0[k] : poc1[k]) : v;
    tab[t] = v;
  }
  HM_FN Cell cell(size_t o) const {
    return Cell{dir[o],  cbf[o],  ref[o],  ref1[o],
                mvx[o],  mvy[o],  mvx1[o], mvy1[o]};
  }
  // a side's POCs (at clamp(ref, 0, n - 1); -1 where the list is unused)
  // and MVs (0 where it is unused)
  HM_FN Motion side(const Cell& c, const int* tab) const {
    const bool u0 = (c.d & 1) != 0, u1 = (c.d & 2) != 0;
    return Motion{u0 ? tab[hm::iclamp(c.r0, 0, nr0 - 1)] : -1,
                  u1 && nr1 > 0 ? tab[16 + hm::iclamp(c.r1, 0, nr1 - 1)]
                                : -1,
                  u0 ? c.x0 : 0, u0 ? c.y0 : 0, u1 ? c.x1 : 0,
                  u1 ? c.y1 : 0};
  }
  HM_FN Edge load(int d, int j, int seg) const {
    int p, q;
    if (d == 0) {  // cells (seg / 2, j) | (seg / 2, j + 1)
      p = (seg >> 1) * bw + j;
      q = p + 1;
    } else {       // cells (j, seg / 2) over (j + 1, seg / 2)
      p = j * bw + (seg >> 1);
      q = p + bw;
    }
    const size_t op = (size_t)p * stride, oq = (size_t)q * stride;
    Edge e;
    e.j = j;
    e.s = sz[op];
    if (dir != nullptr) {
      e.p = cell(op);
      e.q = cell(oq);
    }
    return e;
  }
  HM_FN int bs(const Edge& e, const int* tab) const {
    // an 8-pel edge interior to a 16x16 / 32x32 CU (the left or upper
    // cell's size and the edge's parity) is no boundary
    if ((e.s == 1 && (e.j & 1) == 0) || (e.s == 2 && (e.j & 3) != 3))
      return 0;
    if (dir == nullptr || e.p.d == 0 || e.q.d == 0) return 2;
    if (e.p.cbf > 0 || e.q.cbf > 0) return 1;
    return motion_bs(side(e.p, tab), side(e.q, tab)) ? 1 : 0;
  }
};

// task t of direction d in tile (tx, ty): its plane (0 luma, 1 Cb, 2 Cr),
// its edge's index and segment on the plane's grid of that direction, and
// the shared-memory offset of line 0's q0 with the steps between lines
// and across the edge; on false where the segment is not in the picture
struct Seg {
  bool on;
  int plane, j, seg, o, sl, sa;
};

HM_FN Seg seg_of(const Par& q, int tx, int ty, int d, int t) {
  Seg s;
  if (t < 32) {
    const int e = t >> 3, k = t & 7;
    // the edge 8 e + 4 samples into the tile, segment 4 k
    const int ex = (d == 0 ? tx : ty) * TL + 8 * e;
    const int sx = (d == 0 ? ty : tx) * TL - 4 + 4 * k;
    const int across = d == 0 ? q.w : q.h, along = d == 0 ? q.h : q.w;
    s.plane = 0;
    s.on = ex > 0 && ex < across && sx >= 0 && sx < along;
    s.j = ex / 8 - 1;
    s.seg = sx >> 2;
    s.sl = d == 0 ? SL : 1;
    s.sa = d == 0 ? 1 : SL;
    s.o = 4 * k * s.sl + (8 * e + 4) * s.sa;
    return s;
  }
  const int c = (t - 32) >> 3, e = ((t - 32) >> 2) & 1, k = t & 3;
  const int hc = q.h >> 1, wc = q.w >> 1;
  const int ex = (d == 0 ? tx : ty) * TC + 8 * e;
  const int sx = (d == 0 ? ty : tx) * TC - 4 + 4 * k;
  const int across = d == 0 ? wc : hc, along = d == 0 ? hc : wc;
  // interior chroma edges: q1 at ex + 1 inside the plane
  const int ne = across - 2 > 0 ? (across - 2) / 8 : 0;
  s.plane = 1 + c;
  s.j = ex / 8 - 1;
  s.on = ex > 0 && s.j < ne && sx >= 0 && sx < along;
  s.seg = sx >> 2;
  s.sl = d == 0 ? SC : 1;
  s.sa = d == 0 ? 1 : SC;
  s.o = 4 * k * s.sl + (8 * e + 4) * s.sa;
  return s;
}

// the filter switch of task t of direction d in tile (tx, ty): a luma
// segment's BS (0: off), a chroma segment's 2 where the co-located luma BS
// (luma edge 2 j + 1, segment 2 seg) is 2, else 0; `switch_load` reads its
// fields, `switch_bs` decides with the block's POC table (`fill_pocs`)
template <class Src>
struct Switch {
  bool on, chroma;
  typename Src::Edge e;
};

template <class Src>
HM_FN Switch<Src> switch_load(const Src& m, const Par& q, int tx, int ty,
                              int d, int t) {
  const Seg s = seg_of(q, tx, ty, d, t);
  Switch<Src> w;
  w.on = s.on;
  w.chroma = s.plane != 0;
  if (s.on)
    w.e = w.chroma ? m.load(d, 2 * s.j + 1, 2 * s.seg) : m.load(d, s.j, s.seg);
  return w;
}

template <class Src>
HM_FN int switch_bs(const Src& m, const Switch<Src>& w, const int* tab) {
  if (!w.on) return 0;
  const int lbs = m.bs(w.e, tab);
  if (!w.chroma) return lbs;
  return lbs == 2 ? 2 : 0;
}

// one 4-line luma segment, a line a lane: p the luma tile, o line 0's q0
HM_FN void luma_seg(int* p, int o, int sl, int sa, int bs, const Par& q) {
  const int tc_q = hm::iclamp(q.qp + 2 * (bs - 1) + (q.tc_off << 1), 0, 53);
  const int beta = kBeta[hm::iclamp(q.qp + (q.beta_off << 1), 0, 51)]
                   << (q.bd - 8);
  const int tc = kTc[tc_q] << (q.bd - 8);
  const int maxv = (1 << q.bd) - 1;
  L4 v[8], dpq;
  hm::Lanes<bool, 4> strong_line;
  HM_LANES(i, 4) {
    HM_UNROLL
    for (int k = 0; k < 8; ++k) v[k][i] = p[o + i * sl + (k - 4) * sa];
    const int dp = hm::iabs(v[1][i] - 2 * v[2][i] + v[3][i]);
    const int dq = hm::iabs(v[6][i] - 2 * v[5][i] + v[4][i]);
    // both terms in one word: each below 2^14 at 12 bits
    dpq[i] = dp | (dq << 16);
    strong_line[i] =
        2 * (dp + dq) < (beta >> 2) &&
        hm::iabs(v[0][i] - v[3][i]) + hm::iabs(v[4][i] - v[7][i]) <
            (beta >> 3) &&
        hm::iabs(v[3][i] - v[4][i]) < ((5 * tc + 1) >> 1);
  }
  // lines 0 and 3's terms, to every lane
  const int d03 = hm::lane_get(dpq, 0) + hm::lane_get(dpq, 3);
  const unsigned sv = hm::ballot(strong_line);
  const int dp03 = d03 & 0xffff, dq03 = d03 >> 16;
  if (!(dp03 + dq03 < beta)) return;
  const bool strong = (sv & 9u) == 9u;
  const int side = (beta + (beta >> 1)) >> 3;
  const int tch = tc >> 1;
  HM_LANES(i, 4) {
    const int p3 = v[0][i], p2 = v[1][i], p1 = v[2][i], p0 = v[3][i];
    const int q0 = v[4][i], q1 = v[5][i], q2 = v[6][i], q3 = v[7][i];
    int* l = p + o + i * sl;
    if (strong) {
      const int t2 = 2 * tc;
      l[-1 * sa] = hm::iclamp(
          (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0 - t2, p0 + t2);
      l[-2 * sa] = hm::iclamp((p2 + p1 + p0 + q0 + 2) >> 2, p1 - t2, p1 + t2);
      l[-3 * sa] = hm::iclamp((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                              p2 - t2, p2 + t2);
      l[0] = hm::iclamp((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                        q0 - t2, q0 + t2);
      l[sa] = hm::iclamp((q2 + q1 + q0 + p0 + 2) >> 2, q1 - t2, q1 + t2);
      l[2 * sa] = hm::iclamp((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3,
                             q2 - t2, q2 + t2);
    } else {
      const int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (hm::iabs(delta) < 10 * tc) {
        const int dcl = hm::iclamp(delta, -tc, tc);
        l[-1 * sa] = hm::iclamp(p0 + dcl, 0, maxv);
        l[0] = hm::iclamp(q0 - dcl, 0, maxv);
        if (dp03 < side) {
          const int d1 =
              hm::iclamp((((p2 + p0 + 1) >> 1) - p1 + dcl) >> 1, -tch, tch);
          l[-2 * sa] = hm::iclamp(p1 + d1, 0, maxv);
        }
        if (dq03 < side) {
          const int d1 =
              hm::iclamp((((q2 + q0 + 1) >> 1) - q1 - dcl) >> 1, -tch, tch);
          l[sa] = hm::iclamp(q1 + d1, 0, maxv);
        }
      }
    }
  }
}

// one 4-line chroma segment (BS 2), a line a lane
HM_FN void chroma_seg(int* p, int o, int sl, int sa, int tc, int bd) {
  const int maxv = (1 << bd) - 1;
  HM_LANES(i, 4) {
    int* l = p + o + i * sl;
    const int p1 = l[-2 * sa], p0 = l[-sa], q0 = l[0], q1 = l[sa];
    const int delta =
        hm::iclamp((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc);
    l[-sa] = hm::iclamp(p0 + delta, 0, maxv);
    l[0] = hm::iclamp(q0 - delta, 0, maxv);
  }
}

// task t of direction d, with its switch bs (`switch_bs`)
HM_FN void run_task(Tile& tl, const Par& q, int tx, int ty, int d, int t,
                    int bs) {
  if (bs <= 0) return;
  const Seg s = seg_of(q, tx, ty, d, t);
  if (s.plane == 0) {
    luma_seg(tl.y, s.o, s.sl, s.sa, bs, q);
  } else {
    chroma_seg(tl.c[s.plane - 1], s.o, s.sl, s.sa,
               s.plane == 1 ? q.tc_cb : q.tc_cr, q.bd);
  }
}

// a thread's share of the tiles' samples (thread tid of NTH takes samples
// tid, tid + NTH, ... of the luma tile, then of the two chroma tiles),
// held in registers between `fetch` and `place`: the loads are in flight
// while the boundary strengths load.  Samples outside the picture are
// neither read nor written.
template <int NTH>
struct Stage {
  int y[(TL * TL + NTH - 1) / NTH];
  int c[(2 * TC * TC + NTH - 1) / NTH];
};

template <int NTH>
HM_FN void fetch(Stage<NTH>& st, const Planes& pl, const Par& q, int tx,
                 int ty, int tid) {
  const int y0 = ty * TL - 4, x0 = tx * TL - 4;
  HM_UNROLL
  for (int k = 0; k < (TL * TL + NTH - 1) / NTH; ++k) {
    const int i = tid + k * NTH, y = y0 + i / TL, x = x0 + i % TL;
    st.y[k] = i < TL * TL && y >= 0 && y < q.h && x >= 0 && x < q.w
                  ? pl.in[0][(size_t)y * q.w + x]
                  : 0;
  }
  const int hc = q.h >> 1, wc = q.w >> 1;
  const int yc0 = ty * TC - 4, xc0 = tx * TC - 4;
  HM_UNROLL
  for (int k = 0; k < (2 * TC * TC + NTH - 1) / NTH; ++k) {
    const int i = tid + k * NTH, c = i / (TC * TC);
    const int y = yc0 + (i / TC) % TC, x = xc0 + i % TC;
    // (the plane's pointer picked by a select: an index into the
    // kernel's argument would copy it to the stack)
    st.c[k] = i < 2 * TC * TC && y >= 0 && y < hc && x >= 0 && x < wc
                  ? (c ? pl.in[2] : pl.in[1])[(size_t)y * wc + x]
                  : 0;
  }
}

template <int NTH>
HM_FN void place(const Stage<NTH>& st, Tile& tl, int tid) {
  HM_UNROLL
  for (int k = 0; k < (TL * TL + NTH - 1) / NTH; ++k) {
    const int i = tid + k * NTH;
    if (i < TL * TL) tl.y[(i / TL) * SL + i % TL] = st.y[k];
  }
  HM_UNROLL
  for (int k = 0; k < (2 * TC * TC + NTH - 1) / NTH; ++k) {
    const int i = tid + k * NTH;
    if (i < 2 * TC * TC)
      tl.c[i / (TC * TC)][((i / TC) % TC) * SC + i % TC] = st.c[k];
  }
}

// the filtered tiles out to the new planes, thread tid of nt
HM_FN void store_tile(const Planes& pl, const Tile& tl, const Par& q, int tx,
                      int ty, int tid, int nt) {
  const int y0 = ty * TL - 4, x0 = tx * TL - 4;
  for (int i = tid; i < TL * TL; i += nt) {
    const int r = i / TL, c = i % TL, y = y0 + r, x = x0 + c;
    if (y >= 0 && y < q.h && x >= 0 && x < q.w)
      pl.out[0][(size_t)y * q.w + x] = tl.y[r * SL + c];
  }
  const int hc = q.h >> 1, wc = q.w >> 1;
  const int yc0 = ty * TC - 4, xc0 = tx * TC - 4;
  for (int i = tid; i < 2 * TC * TC; i += nt) {
    const int c = i / (TC * TC), r = (i / TC) % TC, k = i % TC;
    const int y = yc0 + r, x = xc0 + k;
    if (y >= 0 && y < hc && x >= 0 && x < wc)
      (c ? pl.out[2] : pl.out[1])[(size_t)y * wc + x] = tl.c[c][r * SC + k];
  }
}

// tiles across and down (luma and chroma grids alike)
HM_HD int tiles_x(const Par& q) { return (q.w + 4 + TL - 1) / TL; }
HM_HD int tiles_y(const Par& q) { return (q.h + 4 + TL - 1) / TL; }

#if !defined(__CUDACC__)
// the host build: every tile in turn, a direction's tasks in turn (last
// first with hm::lane_reverse, as the lanes of each)
template <class Src>
inline void frame_host(const Src& m, const Planes& pl, const Par& q) {
  static Tile tl;
  for (int ty = 0; ty < tiles_y(q); ++ty) {
    for (int tx = 0; tx < tiles_x(q); ++tx) {
      static Stage<1> st;
      fetch<1>(st, pl, q, tx, ty, 0);
      int tab[32], bs[2][NTASK];
      for (int t = 0; t < 32; ++t) m.fill_pocs(tab, t);
      for (int d = 0; d < 2; ++d)
        for (int t = 0; t < NTASK; ++t)
          bs[d][t] = switch_bs(m, switch_load(m, q, tx, ty, d, t), tab);
      place<1>(st, tl, 0);
      for (int d = 0; d < 2; ++d)
        for (int k = 0; k < NTASK; ++k) {
          const int t = hm::lane_reverse ? NTASK - 1 - k : k;
          run_task(tl, q, tx, ty, d, t, bs[d][t]);
        }
      store_tile(pl, tl, q, tx, ty, 0, 1);
    }
  }
}
#endif

}  // namespace db
