// K21 i_walk's lane code: one lane of one z-scan dependency level of the
// I-frame decision pass, the port of hmtpu/encoder/iframe_dev.py:114
// iframe_pass (`try_modes` :170, `nxn_trial` :258, the 8x8 cell step
// :380, the 16x16 `region16` :470 and the 32x32 `step32` :549) as the
// port's plain version (hmtpu_torch/encoder/iframe_dev.py
// `iframe_pass_plain`) runs it.
//
// A lane reads the committed reconstruction and modes its neighbours
// left behind in earlier levels, decides its CU(s) and commits in place:
//   cell_step  an 8x8 CU: the K = 2 RMD candidates (2Nx2N, luma 8x8 and
//              chroma 4x4; with transform skip the chroma 4x4 trial) coded
//              and priced, the best kept; then the NxN trial (four 4x4 PUs
//              in z-order, each predicted from the substituted line of
//              8.4.4.2.2 over the committed and the earlier PUs' samples,
//              DST, the TS trial; the chroma pair in the DM mode), which
//              overwrites where strictly cheaper;
//   region16   four cell steps in z-order, then the 16x16 CU trial;
//   step32     four region16 steps, then the 32x32 CU trial.
// Each coding step (`code_tb`) is the plain `_code`: K1's transform
// (transform.cuh), K10's RDOQ, dequantisation and TB rate (rdoq.cuh), the
// inverse, the clip and the SSE; the mode rates are K20's (mode_bits.cuh),
// the predictions K2's (intra_pred.cuh), the syntax-flag bits the table
// entries the plain flag helpers (hmtpu/ops/ratebits.py:305-450) read.
//
// Parity with the plain version: every float32 operation is rounded on
// its own, in the plain version's order (see each sum below); integer
// SSEs are exact group sums; the candidate pick keeps the first of equal
// costs, the NxN, 16 and 32 trials and the TS choice win only when
// strictly cheaper.
//
// K21's lane (below): the block's warps in teams, the cells' and the
// larger trials' codings side by side in groups of them, the whole
// working set in shared memory.  The file also compiles as host C++ (one
// thread, one group), which the CPU tests drive level by level.
#pragma once

#include "groups.cuh"
#include "mode_bits.cuh"
#include "walk.cuh"

namespace iw {

using namespace hm;
using gp::deal;
using gp::get_res;
using gp::group_of;
using gp::Grp;
using gp::imax_c;
using gp::NTASK;
using gp::put_res;
using gp::r4;
using gp::Slots;
using gp::task_of;
#if !defined(__CUDACC__)
using gp::task_reverse;
#endif
using wk::NTB;
using wk::TB_INTS;
using wk::TbRes;
using wk::code_tb;
using wk::copy_block;
using wk::gather_line;
using wk::predict;
using wk::scan_sel;

constexpr int K = 2;        // RDOQ-coded candidates per CU (K8 = K16)

// phase clock slots (hm_port.cuh; HM_PHASE_CLOCK builds only): each phase
// of a CU trial by its size (log2 3, 4, 5), then the lane, the 16x16 and
// 32x32 regions whole (each trial beside its cells or regions)
enum { PH_SRC, PH_PRED, PH_CODE, PH_NXN, PH_NXNC, PH_PICK, PH_COMMIT,
       PH_JOIN, PH_NPH };
HM_FN int ph(int phase, int log2) { return phase * 3 + (log2 - 3); }
constexpr int PH_LANE = 3 * PH_NPH, PH_T16 = PH_LANE + 1,
              PH_T32 = PH_T16 + 1;
static_assert(PH_T32 < HM_PH_CODE, "phase slots");

static_assert(PH_T32 < HM_PH_CODE, "phase slots");

// context offsets (entropy/contexts.py OFF) the flag prices read
enum { C_CBF_LUMA, C_CBF_CHROMA, C_PART, C_CHROMA_DM, C_SPLIT, C_IPM, C_TS,
       NCTX };

// The walk's arguments, one set per frame (host arrays in this order:
// see args_from).
struct Args {
  const int *org_y, *org_u, *org_v;
  int *rec_y, *rec_u, *rec_v, *imode, *imode4, *part, *cusz, *cbfy, *levs,
      *tsf;
  const int *cand8, *cand4, *cand16, *cand32;  // RMD candidates (K22)
  const int* lv;     // (levels, bmax) lanes of this geometry, -1 padded
  const int* nb_ok;  // (P, 5) availability of A1, B1, B0, A0, B2
  // substituted reference gathers: (blocks, 4n + 1) indices, (blocks,)
  // none-available flags
  const int *g8s, *g8n, *g4s, *g4n, *g16s, *g16n, *g8cs, *g8cn, *g32s,
      *g32n, *g16cs, *g16cn;
  const int *cells16, *c16_32, *c8_32;  // (P16, 4), (P32, 4), (P32, 16)
  const int* mats;                      // DCT 4, 8, 16, 32, then DST 4
  const float* cb;                      // (NUM_CTX * 2,) fractional bits
  const int* tabs_i;                    // K10's packed tables, NTB sets
  const float* tabs_f;
  int* scratch;                         // lanes x SCRATCH ints
  int w, h, bd, log2_ctu, geom, bmax, sdh, ts, sis, scratch_ints;
  int ctx[NCTX];
  wk::Coder cd;          // the coding step's tables (walk.cuh)
  float lam, lam_c, wchroma;
};

constexpr int N_PTRS = 39;
constexpr int N_INTS = 10 + NCTX + NTB * TB_INTS;
constexpr int N_FLTS = NTB * 2 + 3;

// Args from host arrays of N_PTRS pointers, N_INTS ints, N_FLTS floats
inline Args args_from(const long long* p, const int* v, const float* f) {
  Args a;
  const int** cp[] = {&a.org_y, &a.org_u, &a.org_v};
  int** mp[] = {&a.rec_y, &a.rec_u, &a.rec_v, &a.imode, &a.imode4, &a.part,
                &a.cusz, &a.cbfy, &a.levs, &a.tsf};
  const int** cp2[] = {&a.cand8, &a.cand4, &a.cand16, &a.cand32, &a.lv,
                       &a.nb_ok, &a.g8s, &a.g8n, &a.g4s, &a.g4n, &a.g16s,
                       &a.g16n, &a.g8cs, &a.g8cn, &a.g32s, &a.g32n, &a.g16cs,
                       &a.g16cn, &a.cells16, &a.c16_32, &a.c8_32, &a.mats};
  int k = 0;
  for (auto q : cp) *q = (const int*)p[k++];
  for (auto q : mp) *q = (int*)p[k++];
  for (auto q : cp2) *q = (const int*)p[k++];
  a.cb = (const float*)p[k++];
  a.tabs_i = (const int*)p[k++];
  a.tabs_f = (const float*)p[k++];
  a.scratch = (int*)p[k++];
  int i = 0;
  a.w = v[i++];
  a.h = v[i++];
  a.bd = v[i++];
  a.log2_ctu = v[i++];
  a.geom = v[i++];
  a.bmax = v[i++];
  a.sdh = v[i++];
  a.ts = v[i++];
  a.sis = v[i++];
  a.scratch_ints = v[i++];
  for (int c = 0; c < NCTX; ++c) a.ctx[c] = v[i++];
  for (int s = 0; s < NTB; ++s)
    for (int c = 0; c < TB_INTS; ++c) a.cd.tb[s][c] = v[i++];
  int j = 0;
  for (int s = 0; s < NTB; ++s) {
    a.cd.tbf[s][0] = f[j++];
    a.cd.tbf[s][1] = f[j++];
  }
  a.cd.mats = a.mats;
  a.cd.cb = a.cb;
  a.cd.tabs_i = a.tabs_i;
  a.cd.tabs_f = a.tabs_f;
  a.cd.bd = a.bd;
  a.cd.sdh = a.sdh;
  a.cd.ctx_ts = a.ctx[C_TS];
  a.lam = f[j++];
  a.lam_c = f[j++];
  a.wchroma = f[j++];
  return a;
}

HM_FN float cbf_bits(const Args& a, int ctx, int nz) {
  return a.cb[2 * ctx + (nz ? 1 : 0)];
}

// mpm_neighbours: the left and above cells' modes (1 outside the picture
// and above the CTU row)
HM_FN void neighbours(const Args& a, int b, int bxi, int byi, int y0,
                      int* lm, int* am) {
  const int bw = a.w / 8;
  *lm = bxi > 0 ? a.imode[b - 1] : 1;
  *am = (byi > 0 && (y0 & ((1 << a.log2_ctu) - 1)) != 0) ? a.imode[b - bw]
                                                          : 1;
}

// 8.4.4.2.2 substitution of a 17-sample PU line (one thread)
HM_FN void sub_line(const int* vals, const int* avail, int mid, int* out) {
  int first = -1;
  for (int e = 0; e < 17 && first < 0; ++e)
    if (avail[e]) first = e;
  const int v0 = first >= 0 ? vals[first] : mid;
  int src = -1;
  for (int e = 0; e < 17; ++e) {
    if (avail[e]) src = e;
    out[e] = src >= 0 ? vals[src] : v0;
  }
}

// ---------------------------------------------------------------------------
// K21's lane: teams of warps, the codings side by side, the working set in
// shared memory.
//
// A block of THREADS (8 warps) a lane, in teams: warps 0-5 walk the cells;
// at geometry 16 warps 6-7 run the region's 16x16 trial beside its four
// cells (it reads only state outside its region: its reference lines and
// the corner's left and above modes, committed in earlier levels); at
// geometry 32 warp 6 runs each region's 16x16 trial beside its cells and
// warp 7 the 32x32 trial beside all four regions.  Only the compare
// against the cells' cost and the commit wait for the team's barrier
// (the block's, or at geometry 32 warps 0-6's for the 16x16 trials), in
// the plain order: the cells' cost8, the split-flag terms, cost16 <
// cost8, the commit.  A team's round of tasks is dealt to its groups
// heaviest first (groups.cuh):
//   a cell   one round: the candidates' 8x8 luma and 4x4 chroma codings,
//            their chroma TS alternatives, the NxN chroma pair and its TS
//            alternatives, each a task of one warp (warps 2-5); the NxN
//            chain of four PUs in order, the critical path, on warps 0-1,
//            each PU's two codings (with TS) one on each warp;
//   a trial  the two candidates' luma and chroma codings, a task of one
//            warp each.
// Each group has its own coding work area and K10 set; a task writes only
// its own outputs and result slot; every thread derives the scalars
// between rounds in the plain order.  Sources, lines, predictions and
// codings lie in shared memory (place_*); K21 takes no device scratch.
// The host build runs every team on its one thread: the trials after
// their cells, or (task_reverse) before them with every round's tasks
// last first.

constexpr int THREADS = 256;   // a lane's block at geometries 16 and 32
constexpr int CELL_WARPS = 6;  // the cells' team (the block at geometry 8)
constexpr int NG_CELL = 4;     // its one-warp coding groups (warps 2-5)
constexpr int SCRATCH = 0;     // ints of device scratch a lane

// the cells' tasks: the candidates' luma, chroma (k, plane), the NxN
// chroma pair, then with TS the chroma TS alternatives and the pair's;
// the NxN chain's slots: its halves' codings of a PU, then the PUs
enum { T_Y = 0, T_C = 2, T_N = 6, T_TC = 8, T_TN = 12, NT_TS = 14,
       NT_PLAIN = 8, S_HALF = 16, S_PU = 18 };
static_assert(S_PU + 4 <= NTASK, "result slots");

// a group's area: its coding work area and K10 set for TBs up to n x n
struct GrpMem {
  int *work, *k10;
};
HM_HD constexpr int grp_place(int n, int* base = nullptr,
                              GrpMem* g = nullptr) {
  int at = 0;
  if (g) g->work = base + at;
  at += r4(wk::work_ints(n * n));
  if (g) g->k10 = base + at;
  at += r4((int)(rdoq_smem_bytes(n == 4 ? 2 : n == 8 ? 3 : n == 16 ? 4 : 5) /
                 4));
  return at;
}

// the cells' shared memory
struct CellMem {
  int *iref, *ireff, *irefu, *irefv;  // the lines (the NxN trial's too)
  int *oy, *ou, *ov, *o4;             // the source (o4: the PUs' order)
  int *py, *pu, *pv, *pnu, *pnv;      // the candidates', the NxN pair's
  int *ly, *ry, *lu, *ru, *lv, *rv;   // the candidates' codings (K each)
  int *ltu, *rtu, *ltv, *rtv;         // their chroma TS alternatives
  int *lnu, *rnu, *lnv, *rnv;         // the NxN chroma pair's codings
  int *ltnu, *rtnu, *ltnv, *rtnv;     // and their TS alternatives
  int *l4, *r4, *l4t, *r4t;           // the chain: the PUs' codings, a
  int *line, *p4;                     // PU's TS one, line, prediction
  float *rsse, *rbits;                // the round's result slots
  int *rnz, *rts, *ord;               // and its deal (thread 0's)
  int* grp;                           // the chain's halves, NG_CELL groups
};
HM_HD constexpr int place_cells(int* base = nullptr, CellMem* m = nullptr) {
  int at = 0;
#define IW_PUT(f, ints)                          \
  do {                                           \
    if (m) m->f = (decltype(m->f))(base + at);   \
    at += r4(ints);                              \
  } while (0)
  IW_PUT(iref, 33);
  IW_PUT(ireff, 33);
  IW_PUT(irefu, 17);
  IW_PUT(irefv, 17);
  IW_PUT(oy, 64);
  IW_PUT(ou, 16);
  IW_PUT(ov, 16);
  IW_PUT(o4, 64);
  IW_PUT(py, K * 64);
  IW_PUT(pu, K * 16);
  IW_PUT(pv, K * 16);
  IW_PUT(pnu, 16);
  IW_PUT(pnv, 16);
  IW_PUT(ly, K * 64);
  IW_PUT(ry, K * 64);
  IW_PUT(lu, K * 16);
  IW_PUT(ru, K * 16);
  IW_PUT(lv, K * 16);
  IW_PUT(rv, K * 16);
  IW_PUT(ltu, K * 16);
  IW_PUT(rtu, K * 16);
  IW_PUT(ltv, K * 16);
  IW_PUT(rtv, K * 16);
  IW_PUT(lnu, 16);
  IW_PUT(rnu, 16);
  IW_PUT(lnv, 16);
  IW_PUT(rnv, 16);
  IW_PUT(ltnu, 16);
  IW_PUT(rtnu, 16);
  IW_PUT(ltnv, 16);
  IW_PUT(rtnv, 16);
  IW_PUT(l4, 64);
  IW_PUT(r4, 64);
  IW_PUT(l4t, 16);
  IW_PUT(r4t, 16);
  IW_PUT(line, 17);
  IW_PUT(p4, 16);
  IW_PUT(rsse, NTASK);
  IW_PUT(rbits, NTASK);
  IW_PUT(rnz, NTASK);
  IW_PUT(rts, NTASK);
  IW_PUT(ord, NTASK);
  IW_PUT(grp, 2 * grp_place(4) + NG_CELL * grp_place(8));
  return at;
}

// a larger CU trial's shared memory (n = 16 or 32, ng groups)
struct TrialMem {
  int *iref, *ireff, *irefu, *irefv;
  int *oy, *ou, *ov;
  int *py, *pu, *pv;                  // per candidate
  int *ly, *ry, *lu, *ru, *lv, *rv;   // the candidates' codings
  float *rsse, *rbits;
  int *rnz, *ord;
  int* res;                           // the trial's (ki, nz) and cost
  int* grp;
};
HM_HD constexpr int place_trial(int n, int ng, int* base = nullptr,
                                TrialMem* m = nullptr) {
  const int nn = n * n, ncc = nn / 4;
  int at = 0;
  IW_PUT(iref, 4 * n + 1);
  IW_PUT(ireff, 4 * n + 1);
  IW_PUT(irefu, 2 * n + 1);
  IW_PUT(irefv, 2 * n + 1);
  IW_PUT(oy, nn);
  IW_PUT(ou, ncc);
  IW_PUT(ov, ncc);
  IW_PUT(py, K * nn);
  IW_PUT(pu, K * ncc);
  IW_PUT(pv, K * ncc);
  IW_PUT(ly, K * nn);
  IW_PUT(ry, K * nn);
  IW_PUT(lu, K * ncc);
  IW_PUT(ru, K * ncc);
  IW_PUT(lv, K * ncc);
  IW_PUT(rv, K * ncc);
  IW_PUT(rsse, NTASK);
  IW_PUT(rbits, NTASK);
  IW_PUT(rnz, NTASK);
  IW_PUT(ord, NTASK);
  IW_PUT(res, 4);
  IW_PUT(grp, ng * grp_place(n));
#undef IW_PUT
  return at;
}

// the teams after the cells' warps: the 16x16 trial's (two warps at
// geometry 16, one at 32), then at geometry 32 the 32x32 trial's one;
// the threads that meet for a 16x16 trial's compare and commit
HM_HD constexpr int t16_warps(int geom) { return geom == 16 ? 2 : 1; }
HM_HD constexpr int join16_threads(int geom) {
  return 32 * (CELL_WARPS + t16_warps(geom));
}

// K21's dynamic shared memory at a geometry (bytes): the cells', the
// 16x16 trial's, the 32x32 trial's
HM_HD constexpr int smem_ints(int geom) {
  return place_cells() + (geom >= 16 ? place_trial(16, t16_warps(geom)) : 0) +
         (geom == 32 ? place_trial(32, 1) : 0);
}
HM_HD constexpr int smem_bytes(int geom) { return 4 * smem_ints(geom); }
static_assert(smem_bytes(32) + 4 * wk::LP_FLOATS <= 232448,
              "K21's shared memory: 227 KB a block on the H100");

struct Walk {  // K21's lane: its Args, its block's threads and arena
  const Args* ap;
  int tid, nt;
  int* smem;
  HM_FN bool host() const { return nt < 32; }
};

// a team of nw warps from warp w0 (groups.cuh)
using gp::Team;
HM_FN Team team_of(const Walk& W, int w0, int nw) {
  return gp::team_of(W.tid, W.nt, w0, nw);
}

// a coding lane over a group's area (n x n TBs at most)
HM_FN wk::Lane coder_of(const Args& a, const GrpMem& gm, int tid, int nt,
                        int n) {
  return wk::coder_lane(a.cd, gm.work, gm.k10, tid, nt, n);
}

// a team as a lane without a coding area (gathers, copies, predictions)
HM_FN wk::Lane plain_of(const Args& a, const Team& T) {
  return wk::plain_lane(a.cd, T.tid, T.nt);
}

HM_FN Slots slots_of(const CellMem& m) {
  return Slots{m.rsse, m.rbits, m.rnz, m.rts};
}
HM_FN Slots slots_of(const TrialMem& m) {
  return Slots{m.rsse, m.rbits, m.rnz, nullptr};
}

// the chroma result of slot t, with its TS alternative (slot tt) when ts
HM_FN TbRes chroma_res(const Args& a, const Slots& s, int t, int tt,
                       bool ts) {
  const TbRes r0 = get_res(s, t);
  return ts ? wk::ts_pick(a.cd, false, a.lam_c, r0, get_res(s, tt)) : r0;
}

// ---------------------------------------------------------------------------
// the 8x8 cell

// the NxN chain on its group (G): the four PUs in z-order, each predicted
// from the substituted line over the committed samples and the earlier
// PUs' reconstruction; with TS each PU's two codings on the group's two
// halves; the PUs' results into slots S_PU + j
HM_FN void nxn_chain(const Walk& W, const CellMem& m, const Grp& G, int b,
                     const int* m4, const GrpMem* ga) {
  const Args& a = *W.ap;
  const Slots sl = slots_of(m);
  const int mid = 1 << (a.bd - 1);
  const int* iref = m.iref;
  const int* nbo = a.nb_ok + 5 * b;
  const int aL = nbo[0], aA = nbo[1], aAR = nbo[2], aBL = nbo[3],
            aC = nbo[4];
  wk::Lane P = coder_of(a, ga[0], G.tid, G.nt, 4);  // the whole group
  const Grp H = group_of(G.tid, G.nt, a.ts ? 2 : 1);  // its halves
  for (int j = 0; j < 4; ++j) {
    if (G.tid == 0) {
      const int* r0 = m.r4;
      const int* r1 = r0 + 16;
      const int* r2 = r0 + 32;
      int v[17], av[17];
      for (int k = 0; k < 4; ++k) {
        if (j == 0) {        // all references external
          v[k] = iref[8 + k];
          v[4 + k] = iref[12 + k];
          v[9 + k] = iref[17 + k];
          v[13 + k] = iref[21 + k];
          av[k] = av[4 + k] = aL;
          av[9 + k] = av[13 + k] = aA;
        } else if (j == 1) { // left = PU 0's right column
          v[k] = 0;
          v[4 + k] = r0[(3 - k) * 4 + 3];
          v[9 + k] = iref[21 + k];
          v[13 + k] = iref[25 + k];
          av[k] = 0;
          av[4 + k] = 1;
          av[9 + k] = aA;
          av[13 + k] = aAR;
        } else if (j == 2) { // top = PU 0 and PU 1's bottom rows
          v[k] = iref[4 + k];
          v[4 + k] = iref[8 + k];
          v[9 + k] = r0[12 + k];
          v[13 + k] = r1[12 + k];
          av[k] = aBL;
          av[4 + k] = aL;
          av[9 + k] = av[13 + k] = 1;
        } else {             // left = PU 2, corner PU 0, top PU 1
          v[k] = 0;
          v[4 + k] = r2[(3 - k) * 4 + 3];
          v[9 + k] = r1[12 + k];
          v[13 + k] = 0;
          av[k] = 0;
          av[4 + k] = av[9 + k] = 1;
          av[13 + k] = 0;
        }
      }
      v[8] = j == 0 ? iref[16] : j == 1 ? iref[20] : j == 2 ? iref[12]
                                                           : r0[15];
      av[8] = j == 0 ? aC : j == 1 ? aA : j == 2 ? aL : 1;
      sub_line(v, av, mid, m.line);
    }
    HM_GSYNC(G.nt);
    predict(P, m.line, m.line, m4[j], 4, 1, m.p4);
    const int sel = scan_sel(m4[j]);
    int* lj = m.l4 + 16 * j;
    int* rj = m.r4 + 16 * j;
    if (!a.ts) {
      const TbRes r = code_tb(P, 2, true, true, false, sel, a.lam, false, 0.f,
                              m.o4 + 16 * j, m.p4, lj, rj);
      put_res(sl, P, S_PU + j, r);
      continue;
    }
    // _code_ts_sel: the transform coding (half 0) and the TS one (half 1)
    for (int k = H.g; k < 2; k += H.ng) {
      const int h = task_of(k, 2);
      wk::Lane L = coder_of(a, ga[h], H.tid, H.nt, 4);
      const TbRes r = code_tb(L, 2, true, true, h == 1, sel, a.lam, false,
                              0.f, m.o4 + 16 * j, m.p4, h ? m.l4t : lj,
                              h ? m.r4t : rj);
      put_res(sl, L, S_HALF + h, r);
    }
    HM_GSYNC(G.nt);
    const TbRes r = wk::ts_pick(a.cd, true, a.lam, get_res(sl, S_HALF),
                                get_res(sl, S_HALF + 1));
    if (r.ts) {
      for (int e = G.tid; e < 16; e += G.nt) {
        lj[e] = m.l4t[e];
        rj[e] = m.r4t[e];
      }
    }
    HM_GSYNC(G.nt);
    put_res(sl, P, S_PU + j, r);
  }
}

// one of a cell's single tasks (T_*): its coding into its own buffers and
// slot t
HM_FN void cell_task(const Walk& W, const CellMem& m, wk::Lane& L, int t,
                     const int* modes, int mc) {
  const Args& a = *W.ap;
  TbRes r;
  if (t < T_C) {                       // a candidate's luma 8x8
    r = code_tb(L, 3, true, false, false, scan_sel(modes[t]), a.lam, false,
                0.f, m.oy, m.py + 64 * t, m.ly + 64 * t, m.ry + 64 * t);
  } else if (t < T_N || (t >= T_TC && t < T_TN)) {
    const bool tsc = t >= T_TC;        // a candidate's chroma 4x4
    const int c = t - (tsc ? T_TC : T_C), k = c >> 1, v = c & 1;
    const int o = 16 * k;
    int* lev = v ? (tsc ? m.ltv : m.lv) : (tsc ? m.ltu : m.lu);
    int* rec = v ? (tsc ? m.rtv : m.rv) : (tsc ? m.rtu : m.ru);
    r = code_tb(L, 2, false, false, tsc, scan_sel(modes[k]), a.lam_c, true,
                a.wchroma, v ? m.ov : m.ou, (v ? m.pv : m.pu) + o, lev + o,
                rec + o);
  } else {                             // the NxN chroma pair in PU 0's mode
    const bool tsc = t >= T_TN;
    const int v = t - (tsc ? T_TN : T_N);
    int* lev = v ? (tsc ? m.ltnv : m.lnv) : (tsc ? m.ltnu : m.lnu);
    int* rec = v ? (tsc ? m.rtnv : m.rnv) : (tsc ? m.rtnu : m.rnu);
    r = code_tb(L, 2, false, false, tsc, scan_sel(mc), a.lam_c, true,
                a.wchroma, v ? m.ov : m.ou, v ? m.pnv : m.pnu, lev, rec);
  }
  put_res(slots_of(m), L, t, r);
}

// one 8x8 CU on the cells' team (T): returns its cost; commits its
// decision
HM_BIG float cell_step(const Walk& W, const Team& T, int b) {
  const Args& a = *W.ap;
  CellMem m{};
  place_cells(W.smem, &m);
  const Slots sl = slots_of(m);
  const int bw = a.w / 8, byi = b / bw, bxi = b % bw, gw4 = a.w / 4;
  const int x0 = bxi * 8, y0 = byi * 8;
  const int modes[K] = {a.cand8[K * b], a.cand8[K * b + 1]};
  int m4[4];
  for (int j = 0; j < 4; ++j)
    m4[j] = a.cand4[(2 * byi + (j >> 1)) * gw4 + 2 * bxi + (j & 1)];
  const int mc = m4[0];
  const wk::Lane B = plain_of(a, T);

  // sources and lines (the candidates' and the NxN trial's are the same)
  HM_PH_START(t_src);
  gather_line(B, a.rec_y, a.g8s + b * 33, a.g8n[b], 33, m.iref);
  gather_line(B, a.rec_u, a.g4s + b * 17, a.g4n[b], 17, m.irefu);
  gather_line(B, a.rec_v, a.g4s + b * 17, a.g4n[b], 17, m.irefv);
  for (int k = T.tid; k < 33; k += T.nt)
    m.ireff[k] = filter_sample(m.iref, k, 8, a.bd, a.sis);
  for (int e = T.tid; e < 64; e += T.nt) {
    const int j = e >> 4, i = (e >> 2) & 3, x = e & 3;
    m.o4[e] = a.org_y[(y0 + 4 * (j >> 1) + i) * a.w + x0 + 4 * (j & 1) + x];
  }
  copy_block(B, a.org_y, a.w, x0, y0, 8, m.oy);
  copy_block(B, a.org_u, a.w / 2, x0 / 2, y0 / 2, 4, m.ou);
  copy_block(B, a.org_v, a.w / 2, x0 / 2, y0 / 2, 4, m.ov);
  const int nt2 = a.ts ? NT_TS : NT_PLAIN;
  if (T.tid == 0) {
    int w[NTASK];   // the luma 8x8 codings 3, the 4x4 ones 1
    for (int t = 0; t < nt2; ++t) w[t] = t < T_C ? 3 : 1;
    deal(w, nt2, W.host() ? 1 : NG_CELL, m.ord);
  }
  HM_PH_STOP(ph(PH_SRC, 3), t_src);
  HM_PH_START(t_pred);
  for (int k = 0; k < K; ++k) {
    predict(B, m.iref, m.ireff, modes[k], 8, 1, m.py + 64 * k);
    predict(B, m.irefu, m.irefu, modes[k], 4, 0, m.pu + 16 * k);
    predict(B, m.irefv, m.irefv, modes[k], 4, 0, m.pv + 16 * k);
  }
  predict(B, m.irefu, m.irefu, mc, 4, 0, m.pnu);
  predict(B, m.irefv, m.irefv, mc, 4, 0, m.pnv);
  HM_PH_STOP(ph(PH_PRED, 3), t_pred);

  // the round: the chain on warps 0-1, the tasks on warps 2-5 (the host:
  // the chain first, or last when the tasks run last first)
  HM_PH_START(t_code);
  GrpMem ga[2 + NG_CELL];
  for (int g = 0; g < 2; ++g) grp_place(4, m.grp + g * grp_place(4), &ga[g]);
  for (int g = 0; g < NG_CELL; ++g)
    grp_place(8, m.grp + 2 * grp_place(4) + g * grp_place(8), &ga[2 + g]);
  const int np2 = W.host() ? nt2 : (nt2 + NG_CELL - 1) / NG_CELL * NG_CELL;
  if (W.host()) {
    const Grp G = group_of(0, 1, 1);
    for (int k = 0; k <= np2; ++k) {
      const int kk = task_of(k, np2 + 1);
      if (kk == 0) {
        nxn_chain(W, m, G, b, m4, ga);
      } else {
        wk::Lane L = coder_of(a, ga[2], 0, 1, 8);
        cell_task(W, m, L, m.ord[kk - 1], modes, mc);
      }
    }
  } else if (T.tid < 64) {
    HM_PH_START(t_nxn);
    nxn_chain(W, m, group_of(T.tid, 64, 1), b, m4, ga);
    HM_PH_STOP(ph(PH_NXN, 3), t_nxn);
  } else {
    const Grp G = group_of(T.tid - 64, T.nt - 64, NG_CELL);
    wk::Lane L = coder_of(a, ga[2 + G.g], G.tid, G.nt, 8);
    for (int k = G.g; k < np2; k += G.ng) {
      const int t = m.ord[k];
      if (t >= 0) cell_task(W, m, L, t, modes, mc);
    }
  }
  HM_GSYNC(T.nt);
  HM_PH_STOP(ph(PH_CODE, 3), t_code);

  // try_modes + pick_best, nxn_trial's cost, in the plain order
  HM_PH_START(t_pick);
  int lm, am;
  neighbours(a, b, bxi, byi, y0, &lm, &am);
  float cost[K];
  int nz[K], tsu[K], tsv[K];
  for (int k = 0; k < K; ++k) {
    // (mpm + part 2Nx2N) + chroma DM
    const float mb =
        HM_FADD(HM_FADD(mpm_bits(a.cb, a.ctx[C_IPM], modes[k], lm, am),
                        a.cb[2 * a.ctx[C_PART] + 1]),
                a.cb[2 * a.ctx[C_CHROMA_DM]]);
    const TbRes ry = get_res(sl, T_Y + k);
    const TbRes ru = chroma_res(a, sl, T_C + 2 * k, T_TC + 2 * k, a.ts);
    const TbRes rv = chroma_res(a, sl, T_C + 2 * k + 1, T_TC + 2 * k + 1,
                                a.ts);
    // b_cbf = (cbf_cb + cbf_cr) + cbf_luma (trafo depth 0)
    const float b_cbf =
        HM_FADD(HM_FADD(cbf_bits(a, a.ctx[C_CBF_CHROMA], ru.nz),
                        cbf_bits(a, a.ctx[C_CBF_CHROMA], rv.nz)),
                cbf_bits(a, a.ctx[C_CBF_LUMA] + 1, ry.nz));
    // (dY + dU + dV) + lam * ((bY + bU + bV + b_cbf) + mb)
    const float bsum =
        HM_FADD(HM_FADD(HM_FADD(HM_FADD(ry.bits, ru.bits), rv.bits), b_cbf),
                mb);
    cost[k] = HM_FADD(HM_FADD(HM_FADD(ry.sse, ru.sse), rv.sse),
                      HM_FMUL(a.lam, bsum));
    nz[k] = ry.nz;
    tsu[k] = ru.ts;
    tsv[k] = rv.ts;
  }
  int ki = 0;
  for (int k = 1; k < K; ++k)
    if (cost[k] < cost[ki]) ki = k;
  TbRes pr[4];
  for (int j = 0; j < 4; ++j) pr[j] = get_res(sl, S_PU + j);
  const TbRes rc[2] = {chroma_res(a, sl, T_N, T_TN, a.ts),
                       chroma_res(a, sl, T_N + 1, T_TN + 1, a.ts)};
  // rate: part NxN + the four PUs' mode, cbf and residual + chroma
  const float mb4 = mpm_bits4(a.cb, a.ctx[C_IPM], m4, lm, am);
  // Python's sum() of the four luma cbf bits from 0, then the chroma pair
  float b_cbf = cbf_bits(a, a.ctx[C_CBF_LUMA], pr[0].nz);
  for (int j = 1; j < 4; ++j)
    b_cbf = HM_FADD(b_cbf, cbf_bits(a, a.ctx[C_CBF_LUMA], pr[j].nz));
  b_cbf = HM_FADD(b_cbf, cbf_bits(a, a.ctx[C_CBF_CHROMA], rc[0].nz));
  b_cbf = HM_FADD(b_cbf, cbf_bits(a, a.ctx[C_CBF_CHROMA], rc[1].nz));
  // (d0 + d1 + d2 + d3 + dCu + dCv) + lam * (mb + part + dm + b_cbf +
  // bb0 + ... + bCv), left to right
  float d = pr[0].sse;
  for (int j = 1; j < 4; ++j) d = HM_FADD(d, pr[j].sse);
  d = HM_FADD(HM_FADD(d, rc[0].sse), rc[1].sse);
  float bs = HM_FADD(mb4, a.cb[2 * a.ctx[C_PART]]);
  bs = HM_FADD(bs, a.cb[2 * a.ctx[C_CHROMA_DM]]);
  bs = HM_FADD(bs, b_cbf);
  for (int j = 0; j < 4; ++j) bs = HM_FADD(bs, pr[j].bits);
  bs = HM_FADD(HM_FADD(bs, rc[0].bits), rc[1].bits);
  const float cost_n = HM_FADD(d, HM_FMUL(a.lam, bs));
  const bool use_n = cost_n < cost[ki];
  HM_PH_STOP(ph(PH_PICK, 3), t_pick);

  // commit: the winner's reconstruction, levels, modes and flags
  HM_PH_START(t_cm);
  const int o = 16 * ki;
  const int* ry = use_n ? m.r4 : m.ry + 64 * ki;
  const int* ly = use_n ? m.l4 : m.ly + 64 * ki;
  const int* ru = use_n ? (rc[0].ts ? m.rtnu : m.rnu)
                        : (tsu[ki] ? m.rtu : m.ru) + o;
  const int* rv = use_n ? (rc[1].ts ? m.rtnv : m.rnv)
                        : (tsv[ki] ? m.rtv : m.rv) + o;
  const int* lu = use_n ? (rc[0].ts ? m.ltnu : m.lnu)
                        : (tsu[ki] ? m.ltu : m.lu) + o;
  const int* lv = use_n ? (rc[1].ts ? m.ltnv : m.lnv)
                        : (tsv[ki] ? m.ltv : m.lv) + o;
  for (int e = T.tid; e < 64; e += T.nt) {
    const int i = e >> 3, j = e & 7;
    // NxN: the PUs' 4x4 blocks in their quadrants
    const int src = use_n ? ((i >> 2) * 2 + (j >> 2)) * 16 + (i & 3) * 4 +
                                (j & 3)
                          : e;
    a.rec_y[(y0 + i) * a.w + x0 + j] = ry[src];
    a.levs[b * 96 + e] = ly[src];
  }
  for (int e = T.tid; e < 16; e += T.nt) {
    const int oc = (y0 / 2 + (e >> 2)) * (a.w / 2) + x0 / 2 + (e & 3);
    a.rec_u[oc] = ru[e];
    a.rec_v[oc] = rv[e];
    a.levs[b * 96 + 64 + e] = lu[e];
    a.levs[b * 96 + 80 + e] = lv[e];
  }
  if (T.tid == 0) {
    for (int j = 0; j < 4; ++j)
      a.imode4[4 * b + j] = use_n ? m4[j] : modes[ki];
    a.imode[b] = a.imode4[4 * b];
    a.part[b] = use_n;
    a.cusz[b] = 0;
    a.cbfy[b] = use_n ? (pr[0].nz | pr[1].nz | pr[2].nz | pr[3].nz) : nz[ki];
    a.tsf[b] = use_n ? pr[0].ts | (pr[1].ts << 1) | (pr[2].ts << 2) |
                           (pr[3].ts << 3) | (rc[0].ts << 4) | (rc[1].ts << 5)
                     : (tsu[ki] << 4) | (tsv[ki] << 5);
  }
  HM_GSYNC(T.nt);
  HM_PH_STOP(ph(PH_COMMIT, 3), t_cm);
  return use_n ? cost_n : cost[ki];
}

// ---------------------------------------------------------------------------
// the larger CU trials

// a larger trial's geometry: n x n at (x0, y0), its RMD row, gathers,
// candidates, the cells it commits to
struct Big {
  int n, log2, row, x0, y0, ncell, cusz;
  const int *gls, *gln, *gcs, *gcn, *cand, *cells;
};

HM_FN Big big16(const Args& a, int g) {
  const int gw = a.w / 16;
  return Big{16, 4, g, (g % gw) * 16, (g / gw) * 16, 4, 1, a.g16s, a.g16n,
             a.g8cs, a.g8cn, a.cand16, a.cells16 + 4 * g};
}
HM_FN Big big32(const Args& a, int g) {
  const int qw = a.w / 32;
  return Big{32, 5, g, (g % qw) * 32, (g / qw) * 32, 16, 2, a.g32s, a.g32n,
             a.g16cs, a.g16cn, a.cand32, a.c8_32 + 16 * g};
}

// try_modes of a larger CU on its team (T, ng coding groups): the lines,
// sources and predictions, then the candidates' codings (a luma task and
// two chroma tasks each) as one round; the pick, its cost and cbf into
// m.res (the team's thread 0)
HM_BIG void trial(const Walk& W, const Team& T, const TrialMem& m, int ng,
                  const Big& c) {
  const Args& a = *W.ap;
  const Slots sl = slots_of(m);
  const int n = c.n, nc = n / 2, ll = 4 * n + 1, lc = 2 * n + 1;
  const int nn = n * n, ncc = nc * nc;
  const int modes[K] = {c.cand[K * c.row], c.cand[K * c.row + 1]};
  const wk::Lane B = plain_of(a, T);
  HM_PH_START(t_src);
  gather_line(B, a.rec_y, c.gls + c.row * ll, c.gln[c.row], ll, m.iref);
  gather_line(B, a.rec_u, c.gcs + c.row * lc, c.gcn[c.row], lc, m.irefu);
  gather_line(B, a.rec_v, c.gcs + c.row * lc, c.gcn[c.row], lc, m.irefv);
  for (int k = T.tid; k < ll; k += T.nt)
    m.ireff[k] = filter_sample(m.iref, k, n, a.bd, a.sis);
  copy_block(B, a.org_y, a.w, c.x0, c.y0, n, m.oy);
  copy_block(B, a.org_u, a.w / 2, c.x0 / 2, c.y0 / 2, nc, m.ou);
  copy_block(B, a.org_v, a.w / 2, c.x0 / 2, c.y0 / 2, nc, m.ov);
  if (T.tid == 0) {
    int w[3 * K];   // luma 4, chroma 1
    for (int t = 0; t < 3 * K; ++t) w[t] = t < K ? 4 : 1;
    deal(w, 3 * K, ng, m.ord);
  }
  HM_PH_STOP_IF(ph(PH_SRC, c.log2), t_src, T.tid == 0);
  HM_PH_START(t_pred);
  for (int k = 0; k < K; ++k) {
    predict(B, m.iref, m.ireff, modes[k], n, 1, m.py + nn * k);
    predict(B, m.irefu, m.irefu, modes[k], nc, 0, m.pu + ncc * k);
    predict(B, m.irefv, m.irefv, modes[k], nc, 0, m.pv + ncc * k);
  }
  HM_PH_STOP_IF(ph(PH_PRED, c.log2), t_pred, T.tid == 0);
  HM_PH_START(t_code);
  const Grp G = group_of(T.tid, T.nt, ng);
  GrpMem gm{};
  grp_place(n, m.grp + G.g * grp_place(n), &gm);
  wk::Lane L = coder_of(a, gm, G.tid, G.nt, n);
  const int np = (3 * K + G.ng - 1) / G.ng * G.ng;
  for (int k = G.g; k < np; k += G.ng) {
    const int t = m.ord[task_of(k, np)];
    if (t < 0) continue;
    TbRes r;
    if (t < K) {
      r = code_tb(L, c.log2, true, false, false, -1, a.lam, false, 0.f, m.oy,
                  m.py + nn * t, m.ly + nn * t, m.ry + nn * t);
    } else {
      const int kk = (t - K) >> 1, v = (t - K) & 1;
      r = code_tb(L, c.log2 - 1, false, false, false, -1, a.lam_c, true,
                  a.wchroma, v ? m.ov : m.ou, (v ? m.pv : m.pu) + ncc * kk,
                  (v ? m.lv : m.lu) + ncc * kk, (v ? m.rv : m.ru) + ncc * kk);
    }
    put_res(sl, L, t, r);
  }
  HM_GSYNC(T.nt);
  HM_PH_STOP_IF(ph(PH_CODE, c.log2), t_code, T.tid == 0);
  if (T.tid == 0) {
    const int bw = a.w / 8, bxi = c.x0 / 8, byi = c.y0 / 8;
    int lm, am;
    neighbours(a, byi * bw + bxi, bxi, byi, c.y0, &lm, &am);
    float cost[K];
    for (int k = 0; k < K; ++k) {
      // mpm + chroma DM
      const float mb = HM_FADD(mpm_bits(a.cb, a.ctx[C_IPM], modes[k], lm, am),
                               a.cb[2 * a.ctx[C_CHROMA_DM]]);
      const TbRes ry = get_res(sl, k), ru = get_res(sl, K + 2 * k),
                  rv = get_res(sl, K + 2 * k + 1);
      const float b_cbf =
          HM_FADD(HM_FADD(cbf_bits(a, a.ctx[C_CBF_CHROMA], ru.nz),
                          cbf_bits(a, a.ctx[C_CBF_CHROMA], rv.nz)),
                  cbf_bits(a, a.ctx[C_CBF_LUMA] + 1, ry.nz));
      const float bsum = HM_FADD(
          HM_FADD(HM_FADD(HM_FADD(ry.bits, ru.bits), rv.bits), b_cbf), mb);
      cost[k] = HM_FADD(HM_FADD(HM_FADD(ry.sse, ru.sse), rv.sse),
                        HM_FMUL(a.lam, bsum));
    }
    int ki = 0;
    for (int k = 1; k < K; ++k)
      if (cost[k] < cost[ki]) ki = k;
    m.res[0] = ki;
    m.res[1] = get_res(sl, ki).nz;
    ((float*)m.res)[2] = cost[ki];
  }
}

// after the trial and the cells (cost_sub): the split-flag terms and
// the compare; where strictly cheaper, the commit by team T to the
// trial's cells in `cells` order; returns the kept cost
HM_BIG float trial_commit(const Walk& W, const Team& T, const TrialMem& m,
                          const Big& c, float cost_sub) {
  const Args& a = *W.ap;
  const int ki = m.res[0], nzy = m.res[1];
  // neighbour-depth approximation of the split ctxInc: ctx 1 both ways
  const int sp = 2 * (a.ctx[C_SPLIT] + 1);
  const float cost =
      HM_FADD(((const float*)m.res)[2], HM_FMUL(a.lam, a.cb[sp]));
  cost_sub = HM_FADD(cost_sub, HM_FMUL(a.lam, a.cb[sp + 1]));
  if (!(cost < cost_sub)) {
    HM_GSYNC(T.nt);   // the arena is the next trial's
    return cost_sub;
  }
  HM_PH_START(t_cm);
  const int n = c.n, nc = n / 2, nn = n * n, ncc = nc * nc;
  const int* ry = m.ry + ki * nn;
  const int* ru = m.ru + ki * ncc;
  const int* rv = m.rv + ki * ncc;
  const int* ly = m.ly + ki * nn;
  const int* lu = m.lu + ki * ncc;
  const int* lv = m.lv + ki * ncc;
  for (int e = T.tid; e < nn; e += T.nt)
    a.rec_y[(c.y0 + e / n) * a.w + c.x0 + e % n] = ry[e];
  for (int e = T.tid; e < ncc; e += T.nt) {
    const int o = (c.y0 / 2 + e / nc) * (a.w / 2) + c.x0 / 2 + e % nc;
    a.rec_u[o] = ru[e];
    a.rec_v[o] = rv[e];
  }
  // levs: the flat [Y | U | V] cut into 96-value slabs, one per cell in
  // `cells` order
  const int* cells = c.cells;
  for (int e = T.tid; e < nn + 2 * ncc; e += T.nt) {
    const int v = e < nn ? ly[e] : e < nn + ncc ? lu[e - nn]
                                                : lv[e - nn - ncc];
    a.levs[cells[e / 96] * 96 + e % 96] = v;
  }
  if (T.tid == 0) {
    const int wmode = c.cand[K * c.row + ki];
    for (int k = 0; k < c.ncell; ++k) {
      const int cell = c.cells[k];
      a.imode[cell] = wmode;
      for (int j = 0; j < 4; ++j) a.imode4[4 * cell + j] = wmode;
      a.part[cell] = 0;
      a.cusz[cell] = c.cusz;
      a.cbfy[cell] = nzy;
      a.tsf[cell] = 0;
    }
  }
  HM_GSYNC(T.nt);
  HM_PH_STOP_IF(ph(PH_COMMIT, c.log2), t_cm, T.tid == 0);
  return cost;
}

// four cell steps in z-order beside the 16x16 CU trial, then its compare
// and commit: the cells' team, the trial's team, the two joined (all the
// block's threads at geometry 16, warps 0-6 at 32)
HM_BIG float region16(const Walk& W, const TrialMem& m16, int g) {
  const Args& a = *W.ap;
  const int geom = a.geom;
  const Team TC = team_of(W, 0, CELL_WARPS);
  const Team TT = team_of(W, CELL_WARPS, t16_warps(geom));
  const Big c = big16(a, g);
  float cost8 = 0.f;
  HM_PH_START(t16);
  for (int k = 0; k < 2; ++k) {
    // the host: the cells first, or the trial first when tasks run last
    // first
    const int part = W.host() ? task_of(k, 2) : (TC.in ? 0 : 1);
    if (part == 0 && TC.in) {
      for (int j = 0; j < 4; ++j)
        cost8 = HM_FADD(cost8, cell_step(W, TC, c.cells[j]));
    } else if (part == 1 && TT.in) {
      trial(W, TT, m16, t16_warps(geom), c);
    }
    if (!W.host()) break;
  }
  // the join: the cells' cost8 reaches the trial's team, the trial's
  // result the cells'
  if (TC.in && TC.tid == 0) ((float*)m16.res)[3] = cost8;
  HM_PH_START(t_join);
  const Team TJ = team_of(W, 0, join16_threads(geom) / 32);
  HM_GSYNC(TJ.nt);
  HM_PH_STOP(ph(PH_JOIN, 4), t_join);
  const float r = trial_commit(W, TJ, m16, c, ((const float*)m16.res)[3]);
  HM_PH_STOP(PH_T16, t16);
  return r;
}

// four region16 steps beside the 32x32 CU trial, then its compare and
// commit (the block)
HM_BIG void step32(const Walk& W, const TrialMem& m16, const TrialMem& m32,
                   int g) {
  const Args& a = *W.ap;
  const Team T32 = team_of(W, CELL_WARPS + 1, 1);
  const Team TJ = team_of(W, 0, join16_threads(32) / 32);
  const int* c16 = a.c16_32 + 4 * g;
  const Big c = big32(a, g);
  float cost_sub = 0.f;
  HM_PH_START(t32);
  for (int k = 0; k < 2; ++k) {
    const int part = W.host() ? task_of(k, 2) : (TJ.in ? 0 : 1);
    if (part == 0 && TJ.in) {
      for (int j = 0; j < 4; ++j)
        cost_sub = HM_FADD(cost_sub,
                           c16[j] >= 0 ? region16(W, m16, c16[j]) : 0.f);
    } else if (part == 1 && T32.in) {
      trial(W, T32, m32, 1, c);
    }
    if (!W.host()) break;
  }
  if (TJ.in && TJ.tid == 0) ((float*)m32.res)[3] = cost_sub;
  const Team TB = team_of(W, 0, THREADS / 32);
  HM_GSYNC(TB.nt);
  trial_commit(W, TB, m32, c, ((const float*)m32.res)[3]);
  HM_PH_STOP(PH_T32, t32);
}

// lane `lane` of level `level`, the block's tid of nt threads; smem is
// the arena (smem_bytes(geometry), 16-byte aligned)
HM_BIG void walk_lane(const Args& a, int level, int lane, int tid, int nt,
                      void* smem) {
  const int blk = a.lv[level * a.bmax + lane];
  if (blk < 0) return;   // a padding lane does nothing
  wk::build_last_bits(a.cd, tid, nt);
  HM_SYNC();
  Walk W;
  W.ap = &a;
  W.tid = tid;
  W.nt = nt;
  W.smem = (int*)smem;
  const int c_ints = place_cells();
  TrialMem m16{}, m32{};
  if (a.geom >= 16)
    place_trial(16, t16_warps(a.geom), W.smem + c_ints, &m16);
  if (a.geom == 32)
    place_trial(32, 1, W.smem + c_ints + place_trial(16, t16_warps(32)),
                &m32);
  HM_PH_START(t_lane);
  if (a.geom == 8)
    cell_step(W, team_of(W, 0, CELL_WARPS), blk);
  else if (a.geom == 16)
    region16(W, m16, blk);
  else
    step32(W, m16, m32, blk);
  HM_PH_STOP(PH_LANE, t_lane);
}

}  // namespace iw
