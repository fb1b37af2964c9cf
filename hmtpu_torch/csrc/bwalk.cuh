// K26 b_walk's lane code: one lane of one z-scan dependency level of the
// B-slice decision pass, the port of hmtpu/encoder/pframe_dev.py:255
// wavefront_pass in its B form (`merge_b_nxn` :411, `merge_b_winner`
// :446, `amvp_b_nxn` :487, the B branches of `cell_step` :732, :807, :879,
// :919, `region16` :1065, :1121, :1177 and `step32` :1338, :1394, :1449,
// the hoisted 16 and 32 levels :971, :987, :1241, :1263) as the port's
// plain version (hmtpu_torch/encoder/pframe_dev.py `wavefront_pass_plain`:
// `b_merge_rd`, `merge_b_nxn`, `merge_b_winner`, `amvp_cu`) runs it.
//
// The decisions are the P walk's (the cell step, the 16x16 and 32x32
// trials, region16, step32 and their commits); what differs in a B slice:
//   merge      the B merge list (combined bi-predictive candidates, the
//              dir = 3 zero fill); every candidate's hypotheses at
//              intermediate precision (K11's body) from the union stack
//              of both lists (l0map / l1map), screened on its luma SSE
//              against the bi-average or the approximate uni samples
//              (K12's body, bi_pred.cuh) plus lam * merge_idx bits; the
//              winner predicted exactly (a uni winner at final precision,
//              K7's body; a bi winner the bi-average of the exact
//              hypotheses, chroma from both chroma hypotheses), priced as
//              skip by its 3-plane SSE and coded once with the RDOQ
//              trellis for merge (no finalists, no forced BIG for an
//              all-zero merge);
//   AMVP       the list of the block's own list lx (no temporal
//              candidate), ref_idx priced against that list's size, plus
//              the inter_pred_idc bits at the CU's depth; its hypothesis
//              is predicted and coded before the walk (K7 + K10 over the
//              frame), so a lane only derives the list and the bits;
//   state      the seven motion columns (dir, L0, L1) of the chosen
//              hypothesis; no transform skip and no TMVP in B slices.
// The syntax-flag prices are pwalk.cuh's table reads (B8's helpers), the
// intra arm's tasks K23's (pw::intra_pred_task, pw::intra_code_task).
//
// Parity with the plain version: every float32 operation is rounded on
// its own, in the plain version's order (the screening's SSE + lam *
// merge_idx bits, the skip and merge costs, the split RD); integer SSEs
// are exact group sums; ties take the first index, and the 16 and 32
// trials win only when strictly cheaper.
//
// The arguments are K23's (pw::Args, its transform-skip flag 0 and its
// temporal grids null) followed by the B slice's: the list maps, the
// list-1 POCs, the hoisted hypotheses' lists.  K26's lane ("K26's lane"
// below) is K21's design: teams of warps, each CU trial's codings side by
// side in groups of its team, the 16x16 and 32x32 trials beside their
// cells, the working set in shared memory.  Compiles as host C++ (one
// thread, one group) for the CPU tests.
#pragma once

#include "bi_pred.cuh"
#include "groups.cuh"
#include "pwalk.cuh"

namespace bw {

using namespace hm;
using gp::deal;
using gp::Grp;
using gp::group_of;
using gp::NTASK;
using gp::r4;
using gp::task_of;
using gp::Team;
#if !defined(__CUDACC__)
using gp::task_reverse;
#endif
using pw::Amvp;
using pw::BIG;
using pw::Hoist;
using pw::INTRA_GATE;
using pw::MAXM;
using pw::Prices;
using pw::cbv;
using wk::TbRes;
using wk::code_tb;
using wk::copy_block;

struct Args {
  pw::Args p;                   // K23's arguments
  const int *l0map, *l1map;     // (num_ref,), (num_ref_l1,): union index
  const int* ref_pocs_l1;       // (num_ref_l1,)
  const int *lx8, *lx16, *lx32;  // each hoisted hypothesis's list, or null
  int num_ref_l1, cmax1, ctx_dir;  // ctx_dir: INTER_DIR's context offset
};

constexpr int N_PTRS = pw::N_PTRS + 6;
constexpr int N_INTS = pw::N_INTS + 3;
constexpr int N_FLTS = pw::N_FLTS;

// K23's arguments from the arrays' heads, then the B slice's
inline Args args_from(const long long* p, const int* v, const float* f) {
  Args b;
  b.p = pw::args_from(p, v, f);
  const long long* q = p + pw::N_PTRS;
  b.l0map = (const int*)q[0];
  b.l1map = (const int*)q[1];
  b.ref_pocs_l1 = (const int*)q[2];
  b.lx8 = (const int*)q[3];
  b.lx16 = (const int*)q[4];
  b.lx32 = (const int*)q[5];
  const int* w = v + pw::N_INTS;
  b.num_ref_l1 = w[0];
  b.cmax1 = w[1];
  b.ctx_dir = w[2];
  return b;
}

// a hypothesis's motion: the seven state columns K_DIR .. K_REF, K_MVX1 ..
struct Mot {
  int dir, mvx, mvy, ref, mvx1, mvy1, ref1;
};

HM_FN int union_idx(const Args& b, int r, int lx) {
  return lx == 0 ? b.l0map[iclamp(r, 0, b.p.num_ref - 1)]
                 : b.l1map[iclamp(r, 0, b.num_ref_l1 - 1)];
}

// the AMVP hypothesis's motion: list lx's reference and MV, the other
// list zero
HM_FN Mot amvp_mot(int lx, int r, int mx, int my) {
  return Mot{1 + lx,          lx == 0 ? mx : 0, lx == 0 ? my : 0,
             lx == 0 ? r : 0, lx == 1 ? mx : 0, lx == 1 ? my : 0,
             lx == 1 ? r : 0};
}

// amvp_rd's B form (K18): list lx's AMVP list (no temporal candidate), the
// mvd against both predictors (predictor 1 only when its bits are lower),
// ref_idx + inter_pred_idc bits at CU depth `depth`
HM_FN Amvp amvp_b(const Args& b, const mvc::Motion* m, int lx, int r, int mx,
                  int my, int depth) {
  const pw::Args& a = b.p;
  int poc0[5], poc1[5];
  for (int s = 0; s < 5; ++s) {
    poc0[s] = a.ref_pocs[iclamp(m[s].ref0, 0, a.num_ref - 1)];
    poc1[s] = b.ref_pocs_l1[iclamp(m[s].ref1, 0, b.num_ref_l1 - 1)];
  }
  const int tpoc = lx == 0 ? a.ref_pocs[iclamp(r, 0, a.num_ref - 1)]
                           : b.ref_pocs_l1[iclamp(r, 0, b.num_ref_l1 - 1)];
  int mvp[4];
  mvc::amvp_b(m, poc0, poc1, lx, tpoc, a.cur_poc, 0, 0, 0, mvp);
  const int ctx = a.ctx[pw::C_MVD];
  const float b0 = mvc::mvd_bits(a.cb, ctx, mx - mvp[0], my - mvp[1]);
  const float b1 = mvc::mvd_bits(a.cb, ctx, mx - mvp[2], my - mvp[3]);
  Amvp o;
  o.mvpi = b1 < b0;
  o.mvdx = mx - mvp[o.mvpi ? 2 : 0];
  o.mvdy = my - mvp[o.mvpi ? 3 : 1];
  o.bits_mvd = o.mvpi ? b1 : b0;
  o.b_ref = HM_FADD(mvc::ref_idx_bits(a.cb, a.ctx[pw::C_REF], r,
                                      lx == 0 ? a.cmax0 : b.cmax1),
                    mvc::inter_dir_bits(a.cb, b.ctx_dir, 1 + lx, depth));
  return o;
}

HM_FN void write_row(int* row, int kind, int mi, const Amvp& am,
                     const Mot& m, int sz, int cbfy) {
  const int v[pw::NCOL] = {kind,   mi,    am.mvdx, am.mvdy, am.mvpi,
                           m.dir,  m.mvx, m.mvy,   m.ref,   sz,
                           cbfy,   m.mvx1, m.mvy1, m.ref1};
  for (int c = 0; c < pw::NCOL; ++c) row[c] = v[c];
}

// ---------------------------------------------------------------------------
// K26's lane: teams of warps, the codings side by side, the working set in
// shared memory.
//
// A block of THREADS (8 warps) a lane.  At geometry 8 (a lane is a cell)
// the whole block is the cells' team; at geometry 32 warps 0-5 walk the
// cells, warp 6 runs each region's 16x16 trial beside its four cells and
// warp 7 the 32x32 trial beside all four regions: a trial reads only state
// outside its region (the neighbours' motion and the flags left and above
// it, committed in earlier levels or, for a 16x16 trial, by the earlier
// regions of its lane, which are done before it starts).  Only the
// compare against the cells' cost and the commit wait for the join (warps
// 0-6 for a 16x16 trial, the block for the 32x32 one), in the plain
// order: the cells' cost, the split-flag terms, cost16 < cost8, the
// commit (commit_large), as K21 (iwalk.cuh) does it.  A CU trial runs as
// two rounds of tasks dealt to its team's one-warp groups heaviest first
// (gp::deal):
//   R1  every merge candidate's hypotheses at intermediate precision (one
//       or both lists) and its screening SSE, a task each; in a cell also
//       the intra arm's three predictions (K23's tasks);
//   R2  the merge winner's three planes, each predicted exactly with its
//       SSE (the skip cost's) and coded, a task each; in a cell also the
//       intra arm's three codings, whatever the gate then decides.
// Between the rounds every thread derives the same scalars (the list, the
// screening's winner, the costs) in the plain order.  Each group has its
// own coding work area, K10 set, MC patch and hypothesis buffers; a task
// writes only its own outputs and its result slot; every SSE is an exact
// group sum.  Sources, predictions and codings lie in shared memory
// (cu_place); K26 takes no device scratch.  The host build runs every
// team on its one thread: the trials after their cells, or
// (task_reverse) before them with every round's tasks last first.

constexpr int THREADS = 256;    // a lane's block: 8 warps
constexpr int CELL_WARPS = 6;   // the cells' team at geometry 32
constexpr int SCRATCH = 0;      // ints of device scratch a lane
// the cells' one-warp coding groups (the block at geometry 8)
HM_HD constexpr int cell_groups(int geom) {
  return geom == 8 ? THREADS / 32 : CELL_WARPS;
}
// the second round's result slots: the intra arm's codings (a cell's; K23's
// intra_code_task writes slots 0-2), then the merge winner's planes
enum { S_INTRA = 0, S_WIN = 3 };

// a group's area: its coding work area and K10 set, its MC patch and the
// two hypothesis buffers of a task
struct GrpMem {
  int *work, *k10, *patch, *tmp, *h0, *h1;
};
HM_HD constexpr int grp_place(int n, int* base = nullptr,
                              GrpMem* g = nullptr) {
  int at = 0;
#define BW_PUT(f, ints)                          \
  do {                                           \
    if (g) g->f = base + at;                     \
    at += r4(ints);                              \
  } while (0)
  BW_PUT(work, wk::work_ints(n * n));
  BW_PUT(k10, (int)(rdoq_smem_bytes(n == 8 ? 3 : n == 16 ? 4 : 5) / 4));
  BW_PUT(patch, mc_patch_ints(n, n, 0));
  BW_PUT(tmp, mc_tmp_ints(n, n, 0));
  BW_PUT(h0, n * n);
  BW_PUT(h1, n * n);
#undef BW_PUT
  return at;
}

// a larger trial's result, from its team to the join
struct TrialOut {
  float cost;  // the least of skip / merge / AMVP, without the split bit
  int c, mi, cbf;
  Mot w;       // the merge winner's motion (skip and merge alike)
  Amvp am;
};

// one CU trial's shared memory (the intra arm only in a cell)
struct CuMem {
  pw::CuMem p;                        // the source (oy, ou, ov), a cell's
                                      // intra arm (iref .. irv), the
                                      // round's result slots and deal
  int *py, *pu, *pv;                  // the merge winner's prediction
  int *ly, *lu, *lv, *ry, *ru, *rv;   // and its coding
  long long* sse;                     // (MAXM + 3,) the candidates'
                                      // screening SSEs, the winner's planes'
  TrialOut* out;                      // a larger trial's result
  float* sub;                         // the cost it is compared with
  int* grp;
  int gints;                          // ints of a group's area
};

// ints of a trial's shared memory at side n with ng groups; places it at
// base when m is given
HM_HD constexpr int cu_place(int n, int ng, int* base = nullptr,
                             CuMem* m = nullptr) {
  const int nn = n * n, ncc = nn / 4, cell = n == 8;
  int at = 0;
#define BW_PUT(f, ints)                          \
  do {                                           \
    if (m) m->f = (decltype(m->f))(base + at);   \
    at += r4(ints);                              \
  } while (0)
  BW_PUT(p.oy, nn);
  BW_PUT(p.ou, ncc);
  BW_PUT(p.ov, ncc);
  BW_PUT(py, nn);
  BW_PUT(pu, ncc);
  BW_PUT(pv, ncc);
  BW_PUT(ly, nn);
  BW_PUT(lu, ncc);
  BW_PUT(lv, ncc);
  BW_PUT(ry, nn);
  BW_PUT(ru, ncc);
  BW_PUT(rv, ncc);
  BW_PUT(p.iref, 34 * cell);
  BW_PUT(p.ireff, 34 * cell);
  BW_PUT(p.irefu, 18 * cell);
  BW_PUT(p.irefv, 18 * cell);
  BW_PUT(p.ipy, 64 * cell);
  BW_PUT(p.ipu, 16 * cell);
  BW_PUT(p.ipv, 16 * cell);
  BW_PUT(p.ily, 64 * cell);
  BW_PUT(p.ilu, 16 * cell);
  BW_PUT(p.ilv, 16 * cell);
  BW_PUT(p.iry, 64 * cell);
  BW_PUT(p.iru, 16 * cell);
  BW_PUT(p.irv, 16 * cell);
  BW_PUT(sse, 2 * (MAXM + 3));
  BW_PUT(p.rsse, NTASK);
  BW_PUT(p.rbits, NTASK);
  BW_PUT(p.rnz, NTASK);
  BW_PUT(p.ord, NTASK);
  BW_PUT(out, (int)((sizeof(TrialOut) + 3) / 4) * (1 - cell));
  BW_PUT(sub, 1 - cell);
  const int gints = grp_place(n);
  BW_PUT(grp, ng * gints);
#undef BW_PUT
  if (m) m->gints = gints;
  return at;
}

// K26's dynamic shared memory at a geometry (bytes): the cells', then at
// geometry 32 the 16x16 trial's and the 32x32 trial's.  What a block
// leaves of the SM's 256 KB is its L1 cache (the coding tables, the
// threads' stacks).
HM_HD constexpr int smem_ints(int geom) {
  return cu_place(8, cell_groups(geom)) +
         (geom == 32 ? cu_place(16, 1) + cu_place(32, 1) : 0);
}
HM_HD constexpr int smem_bytes(int geom) { return 4 * smem_ints(geom); }
static_assert(smem_bytes(8) <= smem_bytes(32), "the largest layout");
static_assert(smem_bytes(32) + 4 * wk::LP_FLOATS <= 232448,
              "K26's shared memory: 227 KB a block on the H100");

struct Walk {  // K26's lane: its Args, its block's threads and arena
  const Args* bp;
  const pw::Args* ap;  // K23's part of them (bp->p)
  int tid, nt;
  int* smem;
  HM_FN bool host() const { return nt < 32; }
};

HM_FN Team team_of(const Walk& W, int w0, int nw) {
  return gp::team_of(W.tid, W.nt, w0, nw);
}

// the cells' shared memory, and a larger trial's (n = 16 or 32)
HM_FN CuMem cell_mem(const Walk& W) {
  CuMem m{};
  cu_place(8, cell_groups(W.ap->geom), W.smem, &m);
  return m;
}
HM_FN CuMem trial_mem(const Walk& W, int n) {
  CuMem m{};
  cu_place(n, 1,
           W.smem + cu_place(8, cell_groups(32)) +
               (n == 32 ? cu_place(16, 1) : 0),
           &m);
  return m;
}

HM_FN GrpMem grp_mem(const CuMem& m, int n, int g) {
  GrpMem gm{};
  grp_place(n, m.grp + g * m.gints, &gm);
  return gm;
}

// a coding lane over a group's area (n x n TBs at most)
HM_FN wk::Lane coder_of(const pw::Args& a, const GrpMem& gm, int tid,
                        int nt, int n) {
  return wk::coder_lane(a.cd, gm.work, gm.k10, tid, nt, n);
}

// a team as a lane without a coding area (copies, commits)
HM_FN wk::Lane plain_of(const pw::Args& a, const Team& T) {
  return wk::plain_lane(a.cd, T.tid, T.nt);
}

// ---------------------------------------------------------------------------
// merge RD (b_merge_rd) in two rounds

struct Merge {  // the list and its screening, every thread alike
  int M, mi;
  int c[7][MAXM];  // dir, mvx0, mvy0, ref0, mvx1, mvy1, ref1
  float bmi[MAXM];
};

struct MergeRes {
  float cost_skip, cost_merge;
  int mi, cbf;
  Mot w;  // the winner's motion (skip and merge alike)
};

// plane p (0 luma, 1 Cb, 2 Cr) of the n x n CU at (x0, y0) from the
// union stack's reference u moved by (mx, my), at intermediate precision
// (kInter) or final, into out; the group's patch
template <bool kInter>
HM_FN void mc_plane(const pw::Args& a, const GrpMem& gm, const wk::Lane& L,
                    int u, int p, int mx, int my, int n, int x0, int y0,
                    int* out) {
  const int H = p ? a.h / 2 : a.h, Wd = p ? a.w / 2 : a.w, k = p ? n / 2 : n;
  const int* pl = p == 0 ? a.refs_y : p == 1 ? a.refs_u : a.refs_v;
  mc_block<kInter>(pl + (size_t)iclamp(u, 0, a.R - 1) * H * Wd, H, Wd,
                   p ? x0 / 2 : x0, p ? y0 / 2 : y0, mx, my, k, k, p != 0,
                   a.bd, gm.patch, gm.tmp, out, L.tid, L.nt);
}

// list lx's hypothesis of candidate c, plane p, at intermediate precision
HM_FN void hyp(const Walk& W, const GrpMem& gm, const wk::Lane& L,
               const Merge& mg, int c, int lx, int p, int n, int x0, int y0,
               int* out) {
  mc_plane<true>(*W.ap, gm, L, union_idx(*W.bp, mg.c[lx ? 6 : 3][c], lx),
                 p, mg.c[lx ? 4 : 1][c], mg.c[lx ? 5 : 2][c], n, x0, y0,
                 out);
}

// R1's task of candidate c: its hypotheses (list 0 where dir & 1, list 1
// where dir & 2) in the group's buffers, the luma SSE of its screening
// samples (the bi-average or the approximate uni sample) into m.sse[c]
HM_FN void cand_task(const Walk& W, const CuMem& m, const GrpMem& gm,
                     wk::Lane& L, const Merge& mg, int c, int n, int x0,
                     int y0) {
  const int dir = mg.c[0][c], bd = W.ap->bd;
  if (dir & 1) hyp(W, gm, L, mg, c, 0, 0, n, x0, y0, gm.h0);
  if (dir & 2) hyp(W, gm, L, mg, c, 1, 0, n, x0, y0, gm.h1);
  long long s = 0;
  for (int e = L.tid; e < n * n; e += L.nt) {
    const long long d =
        m.p.oy[e] - bi_pred_sample(gm.h0[e], gm.h1[e], dir, bd);
    s += d * d;
  }
  s = group_sum(s, L.tid, L.nt, wk::red_of(L));
  if (L.tid == 0) m.sse[c] = s;
}

// R2's task of the merge winner's plane p: its exact prediction (a uni
// winner's at final precision; a bi winner's the bi-average of both
// lists' hypotheses), that prediction's SSE into m.sse[MAXM + p], and its
// coding (the trellis when rdoq) into the winner's buffers and slot
// S_WIN + p
HM_FN void win_task(const Walk& W, const CuMem& m, const GrpMem& gm,
                    wk::Lane& L, const Merge& mg, int p, int n, int log2,
                    int x0, int y0) {
  const pw::Args& a = *W.ap;
  const int c = mg.mi, dir = mg.c[0][c], k = p ? n / 2 : n;
  int* pred = p == 0 ? m.py : p == 1 ? m.pu : m.pv;
  const int* org = p == 0 ? m.p.oy : p == 1 ? m.p.ou : m.p.ov;
  if (dir == 3) {
    hyp(W, gm, L, mg, c, 0, p, n, x0, y0, gm.h0);
    hyp(W, gm, L, mg, c, 1, p, n, x0, y0, gm.h1);
    for (int e = L.tid; e < k * k; e += L.nt)
      pred[e] = bi_pred_sample(gm.h0[e], gm.h1[e], 3, a.bd);
    HM_GSYNC(L.nt);
  } else {
    const int lx = (dir & 1) ? 0 : 1;
    mc_plane<false>(a, gm, L, union_idx(*W.bp, mg.c[lx ? 6 : 3][c], lx), p,
                    mg.c[lx ? 4 : 1][c], mg.c[lx ? 5 : 2][c], n, x0, y0,
                    pred);
  }
  long long s = 0;
  for (int e = L.tid; e < k * k; e += L.nt) {
    const long long d = org[e] - pred[e];
    s += d * d;
  }
  s = group_sum(s, L.tid, L.nt, wk::red_of(L));
  if (L.tid == 0) m.sse[MAXM + p] = s;
  const bool tr = a.rdoq != 0;
  const TbRes r =
      p == 0 ? code_tb(L, log2, true, false, false, -1, a.lam, false, 0.f,
                       org, pred, m.ly, m.ry, tr)
             : code_tb(L, log2 - 1, false, false, false, -1, a.lam_c, true,
                       a.wchroma, org, pred, p == 1 ? m.lu : m.lv,
                       p == 1 ? m.ru : m.rv, tr);
  pw::put_res(m.p, L, S_WIN + p, r);
}

// the B merge of the n x n CU at (x0, y0) on team T's groups (G, its
// group's area gm and coding lane L), the source in m.p.o*: R1, the
// screening, R2; in a cell (blk >= 0) the intra arm's predictions and
// codings ride along (slots S_INTRA ..).  Returns the merge result, the
// same on every thread of T
HM_BIG MergeRes merge_rounds(const Walk& W, const Team& T, const CuMem& m,
                             const Grp& G, const GrpMem& gm, wk::Lane& L,
                             int n, int log2, int x0, int y0, int blk,
                             const mvc::Motion* nb, float b_skip1,
                             float b_inter) {
  const Args& b = *W.bp;
  const pw::Args& a = b.p;
  const pw::Walk PW{W.ap, T.tid, T.nt, W.smem};  // K23's intra tasks
  const int ni = blk >= 0 ? 3 : 0;
  Merge mg;
  mg.M = a.max_merge;
  mvc::merge_list_b(nb, a.ref_pocs, b.ref_pocs_l1, a.num_ref, b.num_ref_l1,
                    mg.M, mg.c[0], mg.c[1], mg.c[2], mg.c[3], mg.c[4],
                    mg.c[5], mg.c[6]);

  // R1: the candidates (a bi one weighs 2), the intra predictions
  const int n1 = mg.M + ni;
  if (T.tid == 0) {
    int w[NTASK];
    for (int t = 0; t < n1; ++t)
      w[t] = t < mg.M ? (mg.c[0][t] == 3 ? 2 : 1) : 1;
    deal(w, n1, G.ng, m.p.ord);
  }
  HM_GSYNC(T.nt);
  const int np1 = (n1 + G.ng - 1) / G.ng * G.ng;
  for (int k = G.g; k < np1; k += G.ng) {
    const int tk = m.p.ord[task_of(k, np1)];
    if (tk < 0) continue;
    if (tk < mg.M)
      cand_task(W, m, gm, L, mg, tk, n, x0, y0);
    else
      pw::intra_pred_task(PW, m.p, L, blk, tk - mg.M);
  }
  HM_GSYNC(T.nt);
  // the screening: float(luma SSE) + lam * merge_idx bits, first minimum
  float best = 0.f;
  mg.mi = 0;
  for (int c = 0; c < mg.M; ++c) {
    mg.bmi[c] = pw::merge_idx_bits(a, c);
    const float e = HM_FADD((float)m.sse[c], HM_FMUL(a.lam, mg.bmi[c]));
    if (c == 0 || e < best) {
      best = e;
      mg.mi = c;
    }
  }

  // R2: the winner's planes (luma 4, chroma 2), the intra codings (alike)
  const int n2 = 3 + ni;
  if (T.tid == 0) {
    int w[NTASK];
    for (int t = 0; t < n2; ++t) w[t] = t % 3 == 0 ? 4 : 2;
    deal(w, n2, G.ng, m.p.ord);
  }
  HM_GSYNC(T.nt);
  const int np2 = (n2 + G.ng - 1) / G.ng * G.ng;
  for (int k = G.g; k < np2; k += G.ng) {
    const int tk = m.p.ord[task_of(k, np2)];
    if (tk < 0) continue;
    if (tk < 3)
      win_task(W, m, gm, L, mg, tk, n, log2, x0, y0);
    else
      pw::intra_code_task(PW, m.p, L, blk, tk - 3);
  }
  HM_GSYNC(T.nt);

  MergeRes r;
  const int mi = mg.mi;
  r.mi = mi;
  r.w = Mot{mg.c[0][mi], mg.c[1][mi], mg.c[2][mi], mg.c[3][mi],
            mg.c[4][mi], mg.c[5][mi], mg.c[6][mi]};
  // skip's distortion: float(ssd_y) + wchroma * float(ssd_u + ssd_v)
  const float msse3 =
      HM_FADD((float)m.sse[MAXM],
              HM_FMUL(a.wchroma, (float)(m.sse[MAXM + 1] + m.sse[MAXM + 2])));
  const TbRes ry = pw::get_res(m.p, S_WIN), ru = pw::get_res(m.p, S_WIN + 1),
              rv = pw::get_res(m.p, S_WIN + 2);
  r.cbf = ry.nz | (ru.nz << 1) | (rv.nz << 2);
  // skip: msse3 + lam * (b_skip1 + merge_idx)
  r.cost_skip = HM_FADD(msse3, HM_FMUL(a.lam, HM_FADD(b_skip1, mg.bmi[mi])));
  // merge: (dY + dU + dV) + lam * ((((((b_inter + merge_flag) + merge_idx)
  // + cbf) + bY) + bU) + bV)
  float bs = HM_FADD(HM_FADD(b_inter, cbv(a, a.ctx[pw::C_MERGE_FLAG], 1)),
                     mg.bmi[mi]);
  bs = HM_FADD(bs, pw::cbf_bits_inter(a, ry.nz, ru.nz, rv.nz));
  bs = HM_FADD(HM_FADD(HM_FADD(bs, ry.bits), ru.bits), rv.bits);
  r.cost_merge = HM_FADD(HM_FADD(HM_FADD(ry.sse, ru.sse), rv.sse),
                         HM_FMUL(a.lam, bs));
  return r;
}

// ---------------------------------------------------------------------------
// the steps

// one 8x8 CU on the cells' team T: returns the least of its four costs;
// commits its decision
HM_BIG float cell_step(const Walk& W, const Team& T, int blk) {
  const Args& b = *W.bp;
  const pw::Args& a = b.p;
  const Grp G = group_of(T.tid, T.nt, cell_groups(a.geom));
  const CuMem m = cell_mem(W);
  const GrpMem gm = grp_mem(m, 8, G.g);
  wk::Lane L = coder_of(a, gm, G.tid, G.nt, 8);
  const wk::Lane B = plain_of(a, T);
  const int bw = a.w / 8, byi = blk / bw, bxi = blk % bw;
  const int x0 = bxi * 8, y0 = byi * 8;
  copy_block(B, a.org_y, a.w, x0, y0, 8, m.p.oy);
  copy_block(B, a.org_u, a.w / 2, x0 / 2, y0 / 2, 4, m.p.ou);
  copy_block(B, a.org_v, a.w / 2, x0 / 2, y0 / 2, 4, m.p.ov);
  mvc::Motion nb[5];
  pw::neighbours(a, a.nb_flat + 5 * blk, a.nb_ok + 5 * blk, nb);
  const Prices pr = pw::mode_prices(a, blk, bxi, byi);
  const float b_common = HM_FADD(pr.b_skip0, cbv(a, a.ctx[pw::C_PART], 1));
  const float b_inter =
      HM_FADD(b_common, cbv(a, a.ctx[pw::C_PRED_MODE], 0));
  const MergeRes mr = merge_rounds(W, T, m, G, gm, L, 8, 3, x0, y0, blk, nb,
                                   pr.b_skip1, b_inter);

  const Hoist& h8 = a.h8;
  const int lx = b.lx8[blk], aref = h8.ref[blk];
  const Amvp am = amvp_b(b, nb, lx, aref, h8.mvx[blk], h8.mvy[blk],
                         a.log2_ctu - 3);
  const float cost_amvp = pw::amvp_cost(a, h8, blk, b_inter, am);

  // intra, priced only when the best inter cost is above the gate
  const float inter_best =
      fminf(mr.cost_skip, fminf(mr.cost_merge, cost_amvp));
  float cost_intra = BIG;
  const TbRes iy = pw::get_res(m.p, S_INTRA),
              iu = pw::get_res(m.p, S_INTRA + 1),
              iv = pw::get_res(m.p, S_INTRA + 2);
  const int icbf = iy.nz | (iu.nz << 1) | (iv.nz << 2);
  if (!(inter_best <= HM_FMUL(INTRA_GATE, a.lam))) {
    const int im = a.imode[blk];
    const int lmode =
        (bxi > 0 && pr.l_blk[pw::K_KIND] == 3) ? a.imode[blk - 1] : 1;
    const bool am_ok = byi > 0 && (y0 & ((1 << a.log2_ctu) - 1)) != 0;
    const int amode =
        (am_ok && pr.a_blk[pw::K_KIND] == 3) ? a.imode[blk - bw] : 1;
    const float b_icbf = HM_FADD(
        HM_FADD(pw::cbf_chroma(a, iu.nz), pw::cbf_chroma(a, iv.nz)),
        pw::cbf_luma(a, iy.nz));
    // (dY + dU + dV) + lam * ((((((b_common + pred_mode) + mpm) + dm) +
    // cbf) + bY) + bU) + bV)
    float bs = HM_FADD(b_common, cbv(a, a.ctx[pw::C_PRED_MODE], 1));
    bs = HM_FADD(bs, mpm_bits(a.cb, a.ctx[pw::C_IPM], im, lmode, amode));
    bs = HM_FADD(bs, cbv(a, a.ctx[pw::C_CHROMA_DM], 0));
    bs = HM_FADD(bs, b_icbf);
    bs = HM_FADD(HM_FADD(HM_FADD(bs, iy.bits), iu.bits), iv.bits);
    cost_intra = HM_FADD(HM_FADD(HM_FADD(iy.sse, iu.sse), iv.sse),
                         HM_FMUL(a.lam, bs));
  }

  const float costs[4] = {mr.cost_skip, mr.cost_merge, cost_amvp,
                          cost_intra};
  int choice = 0;
  for (int c = 1; c < 4; ++c)
    if (costs[c] < costs[choice]) choice = c;
  if (choice == 1 && !mr.cbf) choice = 0;

  // commit: reconstruction, levels, the row (no transform skip)
  const int* ry = choice == 0 ? m.py
                  : choice == 1 ? m.ry
                  : choice == 2 ? h8.rec_y + blk * 64
                                : m.p.iry;
  const int* ru = choice == 0 ? m.pu
                  : choice == 1 ? m.ru
                  : choice == 2 ? h8.rec_u + blk * 16
                                : m.p.iru;
  const int* rv = choice == 0 ? m.pv
                  : choice == 1 ? m.rv
                  : choice == 2 ? h8.rec_v + blk * 16
                                : m.p.irv;
  for (int e = T.tid; e < 64; e += T.nt)
    a.rec_y[(y0 + e / 8) * a.w + x0 + e % 8] = ry[e];
  for (int e = T.tid; e < 16; e += T.nt) {
    const int o = (y0 / 2 + e / 4) * (a.w / 2) + x0 / 2 + e % 4;
    a.rec_u[o] = ru[e];
    a.rec_v[o] = rv[e];
  }
  for (int e = T.tid; e < 96; e += T.nt) {
    int v = 0;
    if (choice == 1)
      v = e < 64 ? m.ly[e] : e < 80 ? m.lu[e - 64] : m.lv[e - 80];
    else if (choice == 2)
      v = h8.lev[blk * 96 + e];
    else if (choice == 3)
      v = e < 64 ? m.p.ily[e] : e < 80 ? m.p.ilu[e - 64] : m.p.ilv[e - 80];
    a.levs[blk * 96 + e] = v;
  }
  if (T.tid == 0) {
    int* row = a.blk + (size_t)blk * pw::NCOL;
    if (choice == 0)
      write_row(row, 0, mr.mi, am, mr.w, 0, 0);
    else if (choice == 1)
      write_row(row, 1, mr.mi, am, mr.w, 0, mr.cbf & 1);
    else if (choice == 2)
      write_row(row, 2, mr.mi, am,
                amvp_mot(lx, aref, h8.mvx[blk], h8.mvy[blk]), 0,
                h8.cbf[blk] & 1);
    else
      write_row(row, 3, mr.mi, am, Mot{0, 0, 0, 0, 0, 0, 0}, 0, icbf & 1);
    a.tsf[blk] = 0;
  }
  HM_GSYNC(T.nt);
  float best = costs[0];
  for (int c = 1; c < 4; ++c) best = fminf(best, costs[c]);
  return best;
}

// one n x n inter CU trial (skip / merge / the hoisted AMVP of list lx[g],
// one TU) at grid position (gx, gy) on its team T (one group), from the
// committed state outside the region; its result into m.out, its
// prediction and coded winner left in m for commit_large
template <int LOG2>
HM_BIG void large_trial(const Walk& W, const Team& T, int g, int gx, int gy,
                        int corner, const int* nb_idx, const int* nb_ok,
                        const Hoist& hs, const int* lx) {
  constexpr int n = 1 << LOG2;
  const Args& b = *W.bp;
  const pw::Args& a = b.p;
  const CuMem m = trial_mem(W, n);
  const Grp G = group_of(T.tid, T.nt, 1);
  const GrpMem gm = grp_mem(m, n, G.g);
  wk::Lane L = coder_of(a, gm, G.tid, G.nt, n);
  const wk::Lane B = plain_of(a, T);
  const int x0 = gx * n, y0 = gy * n;
  copy_block(B, a.org_y, a.w, x0, y0, n, m.p.oy);
  copy_block(B, a.org_u, a.w / 2, x0 / 2, y0 / 2, n / 2, m.p.ou);
  copy_block(B, a.org_v, a.w / 2, x0 / 2, y0 / 2, n / 2, m.p.ov);
  mvc::Motion nb[5];
  pw::neighbours(a, nb_idx, nb_ok, nb);
  const Prices pr = pw::mode_prices(a, corner, gx, gy);
  const float b_inter =
      HM_FADD(HM_FADD(pr.b_skip0, cbv(a, a.ctx[pw::C_PART], 1)),
              cbv(a, a.ctx[pw::C_PRED_MODE], 0));
  const MergeRes mr = merge_rounds(W, T, m, G, gm, L, n, LOG2, x0, y0, -1,
                                   nb, pr.b_skip1, b_inter);
  const Amvp am = amvp_b(b, nb, lx[g], hs.ref[g], hs.mvx[g], hs.mvy[g],
                         a.log2_ctu - LOG2);
  const float costs[3] = {mr.cost_skip, mr.cost_merge,
                          pw::amvp_cost(a, hs, g, b_inter, am)};
  int c = 0;
  for (int k = 1; k < 3; ++k)
    if (costs[k] < costs[c]) c = k;
  if (c == 1 && !mr.cbf) c = 0;
  if (T.tid == 0)
    *m.out = TrialOut{fminf(costs[0], fminf(costs[1], costs[2])), c, mr.mi,
                      mr.cbf, mr.w, am};
}

// commit a large CU trial (its result r, its arena m) to its `ncell`
// cells (`cells` in z-order), team T cooperating
HM_BIG void commit_large(const Walk& W, const Team& T, const CuMem& m,
                         const TrialOut& r, int g, int gx, int gy, int n,
                         int log2, const Hoist& hs, const int* lx,
                         const int* cells, int ncell) {
  const pw::Args& a = *W.ap;
  const int x0 = gx * n, y0 = gy * n, nn = n * n, nc = n / 2, ncc = nc * nc;
  const int c = r.c;
  const int* ry = c == 0 ? m.py : c == 1 ? m.ry : hs.rec_y + (size_t)g * nn;
  const int* ru = c == 0 ? m.pu : c == 1 ? m.ru : hs.rec_u + (size_t)g * ncc;
  const int* rv = c == 0 ? m.pv : c == 1 ? m.rv : hs.rec_v + (size_t)g * ncc;
  for (int e = T.tid; e < nn; e += T.nt)
    a.rec_y[(y0 + e / n) * a.w + x0 + e % n] = ry[e];
  for (int e = T.tid; e < ncc; e += T.nt) {
    const int o = (y0 / 2 + e / nc) * (a.w / 2) + x0 / 2 + e % nc;
    a.rec_u[o] = ru[e];
    a.rec_v[o] = rv[e];
  }
  // levs: the flat [Y | U | V] cut into 96-value slabs, one per cell in
  // `cells` order
  const int tot = nn + 2 * ncc;
  for (int e = T.tid; e < tot; e += T.nt) {
    int v = 0;
    if (c == 1)
      v = e < nn ? m.ly[e] : e < nn + ncc ? m.lu[e - nn] : m.lv[e - nn - ncc];
    else if (c == 2)
      v = hs.lev[(size_t)g * tot + e];
    a.levs[cells[e / 96] * 96 + e % 96] = v;
  }
  if (T.tid == 0) {
    const Mot mo =
        c == 2 ? amvp_mot(lx[g], hs.ref[g], hs.mvx[g], hs.mvy[g]) : r.w;
    const int cbfy = c == 0 ? 0 : c == 1 ? r.cbf & 1 : hs.cbf[g] & 1;
    for (int k = 0; k < ncell; ++k) {
      write_row(a.blk + (size_t)cells[k] * pw::NCOL, c, r.mi, r.am, mo,
                log2 - 3, cbfy);
      a.tsf[cells[k]] = 0;
    }
  }
  HM_GSYNC(T.nt);
}

// four cell steps in z-order beside the 16x16 CU trial, then its compare
// and commit: the cells' team (warps 0-5), the trial's (warp 6), the two
// joined (warps 0-6, which alone call this)
HM_BIG float region16(const Walk& W, int g) {
  const Args& b = *W.bp;
  const pw::Args& a = b.p;
  const Team TC = team_of(W, 0, CELL_WARPS);
  const Team TT = team_of(W, CELL_WARPS, 1);
  const Team TJ = team_of(W, 0, CELL_WARPS + 1);
  const CuMem m = trial_mem(W, 16);
  const int bw = a.w / 8, gw = a.w / 16, gx = g % gw, gy = g / gw;
  const int corner = (gy * 2) * bw + gx * 2;
  const int* c4 = a.cells16 + 4 * g;
  float cost8 = 0.f;
  for (int k = 0; k < 2; ++k) {
    // the host: the cells first, or the trial first when tasks run last
    // first
    const int part = W.host() ? task_of(k, 2) : (TC.in ? 0 : 1);
    if (part == 0 && TC.in) {
      for (int j = 0; j < 4; ++j)
        cost8 = HM_FADD(cost8, cell_step(W, TC, c4[j]));
    } else if (part == 1 && TT.in) {
      large_trial<4>(W, TT, g, gx, gy, corner, a.nb16_cell + 5 * g,
                     a.nb16_ok + 5 * g, a.h16, b.lx16);
    }
    if (!W.host()) break;
  }
  // the join: the cells' cost reaches the trial's team, the trial's
  // result the cells'
  if (TC.in && TC.tid == 0) *m.sub = cost8;
  HM_GSYNC(TJ.nt);
  const TrialOut r = *m.out;
  cost8 = *m.sub;
  // split_cu_flag at the 16 depth (ctx from neighbour depths)
  const Prices pr = pw::mode_prices(a, corner, gx, gy);
  const float cost16 = HM_FADD(r.cost, pw::split_bits(a, 0, pr, gx, gy, 1));
  cost8 = HM_FADD(cost8, pw::split_bits(a, 1, pr, gx, gy, 1));
  if (!(cost16 < cost8)) {
    HM_GSYNC(TJ.nt);  // the arena is the next trial's
    return cost8;
  }
  commit_large(W, TJ, m, r, g, gx, gy, 16, 4, a.h16, b.lx16, c4, 4);
  return cost16;
}

// four region16 steps beside the 32x32 CU trial where the region lies
// inside the picture (the padded grid's partial regions never form one),
// then its compare and commit (the block)
HM_BIG void step32(const Walk& W, int g) {
  const Args& b = *W.bp;
  const pw::Args& a = b.p;
  const Team TJ = team_of(W, 0, CELL_WARPS + 1);
  const Team T32 = team_of(W, CELL_WARPS + 1, 1);
  const Team TB = team_of(W, 0, THREADS / 32);
  const CuMem m = trial_mem(W, 32);
  const int bw = a.w / 8, qw = (a.w / 16 + 1) / 2, gx = g % qw, gy = g / qw;
  const int corner = (gy * 4) * bw + gx * 4;
  const int* c16 = a.c16_32 + 4 * g;
  const bool full = a.full32[g] != 0;
  float cost_sub = 0.f;
  for (int k = 0; k < 2; ++k) {
    const int part = W.host() ? task_of(k, 2) : (TJ.in ? 0 : 1);
    if (part == 0 && TJ.in) {
      for (int j = 0; j < 4; ++j)
        if (c16[j] >= 0) cost_sub = HM_FADD(cost_sub, region16(W, c16[j]));
    } else if (part == 1 && T32.in && full) {
      large_trial<5>(W, T32, g, gx, gy, corner, a.nb32_cell + 5 * g,
                     a.nb32_ok + 5 * g, a.h32, b.lx32);
    }
    if (!W.host()) break;
  }
  if (!full) return;
  if (TJ.in && TJ.tid == 0) *m.sub = cost_sub;
  HM_GSYNC(TB.nt);
  const TrialOut r = *m.out;
  cost_sub = *m.sub;
  const Prices pr = pw::mode_prices(a, corner, gx, gy);
  const float cost32 = HM_FADD(r.cost, pw::split_bits(a, 0, pr, gx, gy, 2));
  cost_sub = HM_FADD(cost_sub, pw::split_bits(a, 1, pr, gx, gy, 2));
  if (cost32 < cost_sub)
    commit_large(W, TB, m, r, g, gx, gy, 32, 5, a.h32, b.lx32,
                 a.c8_32 + 16 * g, 16);
}

// lane `lane` of level `level`, the block's tid of nt threads; smem is
// the arena (smem_bytes(geometry), 16-byte aligned)
HM_BIG void walk_lane(const Args& b, int level, int lane, int tid, int nt,
                      void* smem) {
  const pw::Args& a = b.p;
  const int blk = a.lv[level * a.bmax + lane];
  if (blk < 0) return;  // a padding lane does nothing
  wk::build_last_bits(a.cd, tid, nt);
  HM_SYNC();
  Walk W;
  W.bp = &b;
  W.ap = &a;
  W.tid = tid;
  W.nt = nt;
  W.smem = (int*)smem;
  if (a.geom == 8)
    cell_step(W, team_of(W, 0, THREADS / 32), blk);
  else
    step32(W, blk);
}

}  // namespace bw
