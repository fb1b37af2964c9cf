// K23 p_walk's lane code: one lane of one z-scan dependency level of the
// P-slice decision pass, the port of hmtpu/encoder/pframe_dev.py:255
// wavefront_pass in its P form (`p_merge_all_rd` :519, `cell_step` :682,
// `region16` :1017 and `step32` :1293 with their larger CU trials, the
// TMVP grids of `t_level` :381 read from K24) as the port's plain version
// (hmtpu_torch/encoder/pframe_dev.py `wavefront_pass_plain`) runs it.
//
// A lane reads the committed state its neighbours left in earlier levels
// (reconstruction, the per-cell rows of `blk`), decides its CU(s) and
// commits in place:
//   cell_step  an 8x8 CU: skip and merge over the exact merge list (every
//              candidate predicted by K7's DCT-IF, skip priced by its
//              3-plane SSE, the two best by screening coded with deadzone
//              quantisation, the winner recoded with the RDOQ trellis and,
//              with transform skip, its 4x4 chroma TBs tried both ways),
//              the AMVP hypothesis (phase 1a's coding, the AMVP list, mvd
//              and ref_idx bits), and intra (the open-loop mode predicted
//              from the committed samples and coded) when the best inter
//              cost is above INTRA_GATE * lambda; the cheapest wins, an
//              all-zero merge counting as skip;
//   region16   four cell steps in z-order, then one 16x16 inter CU trial
//              (skip / merge / the hoisted AMVP) that overwrites where it
//              is strictly cheaper with the split flag priced in;
//   step32     four region16 steps, then the 32x32 trial where the region
//              lies inside the picture.
// The coding step is walk.cuh's (K1's transform, K10's quantisation and
// rate); the merge lists and AMVP lists are mvcand.cuh's (K17, K18), the
// predictions mc_dctif.cuh's (K7) and intra_pred.cuh's (K2), the mode
// rate mode_bits.cuh's (K20); the syntax-flag bits are the table entries
// the plain flag helpers (hmtpu/ops/ratebits.py:305-450) read.
//
// Parity with the plain version: every float32 operation is rounded on
// its own, in the plain version's order (see each sum below); integer
// SSEs are summed exactly and converted once; ties take the first index
// (argmin, the stable sort of the screening costs), and the 16 and 32
// trials win only when strictly cheaper.
//
// Group-cooperative (hm_port.cuh): every thread of a lane's block runs
// the same control flow and derives the same scalars (lists, costs) from
// the same reads; a CU trial's independent items (the candidates' MC, the
// finalists' codings, the winner's recode, the intra arm) run side by
// side in groups of the block (a warp a coding in a cell, two at 16x16,
// the block at 32x32), as "K23's lane" below says; the SSEs are exact
// group sums.  The trial's whole working set (source, predictions, coded
// CUs, each group's coding work area and K10 set) lies in shared memory.
// The file also compiles as host C++ (one thread, one group), which the
// CPU tests drive level by level.
//
// K26 (bwalk.cuh) runs its own lane, in K21's teams, over this file's
// helpers (the arguments, the flag prices, motion, the intra arm's tasks
// and the result slots).
#pragma once

#include "groups.cuh"
#include "hm_port.cuh"
#include "mc_dctif.cuh"
#include "mode_bits.cuh"
#include "mvcand.cuh"
#include "walk.cuh"

namespace pw {

using namespace hm;
using wk::NTB;
using wk::TB_INTS;
using wk::TbRes;
using wk::code_tb;
using wk::code_ts_sel;
using wk::copy_block;
using wk::gather_line;
using wk::predict;
using wk::scan_sel;

constexpr float INTRA_GATE = 24.0f;
constexpr float BIG = 3e38f;
constexpr int MAXM = mvc::kMaxMerge;
constexpr int F = 2;  // merge finalists coded with deadzone quantisation

// phase clock slots (hm_port.cuh; HM_PHASE_CLOCK builds only): each phase
// of a CU trial by its size (log2 3, 4, 5), then the lane, the 16x16 and
// 32x32 trials whole
enum { PH_SRC, PH_MC, PH_SSE, PH_DZ, PH_RDOQ, PH_AMVP, PH_INTRA, PH_COMMIT,
       PH_NPH };
HM_FN int ph(int phase, int log2) { return phase * 3 + (log2 - 3); }
constexpr int PH_LANE = 3 * PH_NPH, PH_T16 = PH_LANE + 1,
              PH_T32 = PH_LANE + 2;
static_assert(PH_T32 < HM_PH_BAR, "phase slots");

// the state's per-cell columns (pframe_dev.py K_*)
enum { K_KIND, K_MI, K_MVDX, K_MVDY, K_MVPI, K_DIR, K_MVX, K_MVY, K_REF,
       K_SZ, K_CBFY, K_MVX1, K_MVY1, K_REF1, NCOL };

// context offsets (entropy/contexts.py OFF) the flag prices read
enum { C_SKIP, C_MERGE_FLAG, C_MERGE_IDX, C_PRED_MODE, C_PART, C_CBF_LUMA,
       C_CBF_CHROMA, C_ROOT_CBF, C_MVP_IDX, C_MVD, C_REF, C_SPLIT,
       C_CHROMA_DM, C_IPM, C_TS, NCTX };

// the AMVP hypothesis of every block of a CU grid, coded before the walk
// (phase 1a at 8x8, the hoisted 16 and 32 levels): the block's searched
// reference and MV, its coding's distortion and rate, the cbf flags (bit
// 0 luma, 1 Cb, 2 Cr), reconstruction, levels (the flat [Y | U | V]) and,
// at 8x8 with transform skip, the chroma TS flags (else null)
struct Hoist {
  const int *ref, *mvx, *mvy, *cbf, *rec_y, *rec_u, *rec_v, *lev, *ts;
  const float *dist, *bits;
};

// The walk's arguments, one set per frame (host arrays in this order:
// see args_from).
struct Args {
  const int *org_y, *org_u, *org_v;
  const int *refs_y, *refs_u, *refs_v;  // (R, H, W), (R, H/2, W/2)
  int *rec_y, *rec_u, *rec_v, *blk, *levs, *tsf;
  const int* imode;           // (P,) the open-loop intra mode (K22)
  const int *nb_ok, *nb_flat;  // (P, 5) per cell
  const int *g8s, *g8n, *g4s, *g4n;  // intra reference gathers
  const int *t8, *t16, *t32;   // (5, grid) K24's candidates, or null
  const int* lv;               // (levels, bmax) lanes, -1 padded
  const int *cells16, *nb16_ok, *nb16_cell;              // (P16, 4|5)
  const int *c16_32, *c8_32, *nb32_ok, *nb32_cell, *full32;
  const int* ref_pocs;         // (R,)
  const int* mats;
  const float* cb;
  const int* tabs_i;
  const float* tabs_f;
  int* scratch;
  Hoist h8, h16, h32;
  int w, h, bd, log2_ctu, geom, bmax, sdh, ts, rdoq, R, num_ref, max_merge,
      limit, cmax0, cur_poc, scratch_ints;
  int ctx[NCTX];
  wk::Coder cd;
  float lam, lam_c, wchroma;
};

constexpr int N_PTRS = 37 + 3 * 11;
constexpr int N_INTS = 16 + NCTX + NTB * TB_INTS;
constexpr int N_FLTS = NTB * 2 + 3;

// Args from host arrays of N_PTRS pointers, N_INTS ints, N_FLTS floats
inline Args args_from(const long long* p, const int* v, const float* f) {
  Args a;
  int k = 0;
  const int** cp[] = {&a.org_y, &a.org_u, &a.org_v, &a.refs_y, &a.refs_u,
                      &a.refs_v};
  int** mp[] = {&a.rec_y, &a.rec_u, &a.rec_v, &a.blk, &a.levs, &a.tsf};
  const int** cp2[] = {&a.imode,   &a.nb_ok,    &a.nb_flat, &a.g8s,
                       &a.g8n,     &a.g4s,      &a.g4n,     &a.t8,
                       &a.t16,     &a.t32,      &a.lv,      &a.cells16,
                       &a.nb16_ok, &a.nb16_cell, &a.c16_32, &a.c8_32,
                       &a.nb32_ok, &a.nb32_cell, &a.full32, &a.ref_pocs,
                       &a.mats};
  for (auto q : cp) *q = (const int*)p[k++];
  for (auto q : mp) *q = (int*)p[k++];
  for (auto q : cp2) *q = (const int*)p[k++];
  a.cb = (const float*)p[k++];
  a.tabs_i = (const int*)p[k++];
  a.tabs_f = (const float*)p[k++];
  a.scratch = (int*)p[k++];
  Hoist* hoists[3] = {&a.h8, &a.h16, &a.h32};
  for (Hoist* hp : hoists) {
    const int** hq[] = {&hp->ref,   &hp->mvx,   &hp->mvy, &hp->cbf,
                        &hp->rec_y, &hp->rec_u, &hp->rec_v, &hp->lev,
                        &hp->ts};
    for (auto q : hq) *q = (const int*)p[k++];
    hp->dist = (const float*)p[k++];
    hp->bits = (const float*)p[k++];
  }
  int i = 0;
  int* iv[] = {&a.w,       &a.h,    &a.bd,        &a.log2_ctu, &a.geom,
               &a.bmax,    &a.sdh,  &a.ts,        &a.rdoq,     &a.R,
               &a.num_ref, &a.max_merge, &a.limit, &a.cmax0,   &a.cur_poc,
               &a.scratch_ints};
  for (auto q : iv) *q = v[i++];
  for (int c = 0; c < NCTX; ++c) a.ctx[c] = v[i++];
  for (int s = 0; s < NTB; ++s)
    for (int c = 0; c < TB_INTS; ++c) a.cd.tb[s][c] = v[i++];
  int j = 0;
  for (int s = 0; s < NTB; ++s) {
    a.cd.tbf[s][0] = f[j++];
    a.cd.tbf[s][1] = f[j++];
  }
  a.lam = f[j++];
  a.lam_c = f[j++];
  a.wchroma = f[j++];
  a.cd.mats = a.mats;
  a.cd.cb = a.cb;
  a.cd.tabs_i = a.tabs_i;
  a.cd.tabs_f = a.tabs_f;
  a.cd.bd = a.bd;
  a.cd.sdh = a.sdh;
  a.cd.ctx_ts = a.ctx[C_TS];
  return a;
}

// ---------------------------------------------------------------------------
// the syntax-flag prices (ops/ratebits.py)

HM_FN float cbv(const Args& a, int ctx, int bin) { return a.cb[2 * ctx + bin]; }

HM_FN float cbf_luma(const Args& a, int nz) {   // trafo depth 0
  return cbv(a, a.ctx[C_CBF_LUMA] + 1, nz != 0);
}
HM_FN float cbf_chroma(const Args& a, int nz) {
  return cbv(a, a.ctx[C_CBF_CHROMA], nz != 0);
}

// chroma cbf pair + luma cbf (inferred when both chroma are zero)
HM_FN float cbf_bits_inter(const Args& a, int y, int u, int v) {
  return HM_FADD(HM_FADD(cbf_chroma(a, u), cbf_chroma(a, v)),
                 (u || v) ? cbf_luma(a, y) : 0.f);
}

// rqt_root_cbf + (the cbf flags when coded) of an AMVP CU
HM_FN float root_cbf_bits(const Args& a, int cbf) {
  const int root = cbf != 0;
  return HM_FADD(cbv(a, a.ctx[C_ROOT_CBF], root),
                 root ? cbf_bits_inter(a, cbf & 1, (cbf >> 1) & 1,
                                       (cbf >> 2) & 1)
                      : 0.f);
}

// merge_idx: truncated unary, the first bin coded, the rest EP
HM_FN float merge_idx_bits(const Args& a, int mi) {
  const float b = cbv(a, a.ctx[C_MERGE_IDX], mi > 0);
  if (a.max_merge <= 1) return b;
  const int ep = mi > 0 ? (mi - 1) + (mi < a.max_merge - 1) : 0;
  return HM_FADD(b, (float)ep);
}

// ---------------------------------------------------------------------------
// motion

struct Cand {  // a CU's temporal candidate for merge (m*) and AMVP (a*)
  int ok, mx, my, ax, ay;
};

HM_FN Cand t_cand(const int* t, int npos, int g) {
  Cand c = {0, 0, 0, 0, 0};
  if (t) {
    c.ok = t[g];
    c.mx = t[npos + g];
    c.my = t[2 * npos + g];
    c.ax = t[3 * npos + g];
    c.ay = t[4 * npos + g];
  }
  return c;
}

// the neighbours' motion from the state ([A1, B1, B0, A0, B2]); valid
// where available and inter
HM_FN void neighbours(const Args& a, const int* idx, const int* ok,
                      mvc::Motion* m) {
  for (int s = 0; s < 5; ++s) {
    const int* r = a.blk + (size_t)idx[s] * NCOL;
    m[s] = mvc::Motion{ok[s] && r[K_DIR] > 0, r[K_DIR], r[K_MVX], r[K_MVY],
                       r[K_REF], r[K_MVX1], r[K_MVY1], r[K_REF1]};
  }
}

struct Amvp {
  int mvpi, mvdx, mvdy;
  float bits_mvd, b_ref;
};

// amvp_rd's P form (K18): the list with the temporal candidate scaled to
// the block's reference, the mvd against both predictors (predictor 1
// only when its bits are lower), the ref_idx bits
HM_FN Amvp amvp(const Args& a, const mvc::Motion* m, int r, int mx, int my,
                const Cand& t) {
  int poc[5];
  for (int s = 0; s < 5; ++s)
    poc[s] = a.ref_pocs[iclamp(m[s].ref0, 0, a.num_ref - 1)];
  int mvp[4];
  mvc::amvp_p(m, poc, a.ref_pocs[iclamp(r, 0, a.num_ref - 1)], a.cur_poc,
              t.ok, t.ax, t.ay, mvp);
  const float b0 = mvc::mvd_bits(a.cb, a.ctx[C_MVD], mx - mvp[0], my - mvp[1]);
  const float b1 = mvc::mvd_bits(a.cb, a.ctx[C_MVD], mx - mvp[2], my - mvp[3]);
  Amvp o;
  o.mvpi = b1 < b0;
  o.mvdx = mx - mvp[o.mvpi ? 2 : 0];
  o.mvdy = my - mvp[o.mvpi ? 3 : 1];
  o.bits_mvd = o.mvpi ? b1 : b0;
  o.b_ref = mvc::ref_idx_bits(a.cb, a.ctx[C_REF], r, a.cmax0);
  return o;
}

// cost_amvp: dist + lam * (((((b_inter + merge_flag(0)) + mvp_idx) +
// mvd) + ref_idx) + root cbf) + levels' rate)
HM_FN float amvp_cost(const Args& a, const Hoist& hs, int g, float b_inter,
                      const Amvp& am) {
  float s = HM_FADD(b_inter, cbv(a, a.ctx[C_MERGE_FLAG], 0));
  s = HM_FADD(s, cbv(a, a.ctx[C_MVP_IDX], am.mvpi));
  s = HM_FADD(s, am.bits_mvd);
  s = HM_FADD(s, am.b_ref);
  s = HM_FADD(s, root_cbf_bits(a, hs.cbf[g]));
  s = HM_FADD(s, hs.bits[g]);
  return HM_FADD(hs.dist[g], HM_FMUL(a.lam, s));
}

// ---------------------------------------------------------------------------
// a merge trial's result

struct MergeRes {
  float cost_skip, cost_merge;
  int mi_skip, mi_merge, cbf, ts, wf;  // wf: the winner's recode buffer
  int sk_mvx, sk_mvy, sk_ref, mg_mvx, mg_mvy, mg_ref;
};

// ---------------------------------------------------------------------------
// the flags and rows of a step

struct Prices {
  const int *l_blk, *a_blk;
  float b_skip1, b_skip0;
};

// cu_skip_flag bits from the committed state left of / above `corner`
HM_FN Prices mode_prices(const Args& a, int corner, int gx, int gy) {
  const int bw = a.w / 8;
  Prices p;
  p.l_blk = a.blk + (size_t)(gx > 0 ? corner - 1 : 0) * NCOL;
  p.a_blk = a.blk + (size_t)(gy > 0 ? corner - bw : 0) * NCOL;
  const int inc = (gx > 0 && p.l_blk[K_KIND] == 0) +
                  (gy > 0 && p.a_blk[K_KIND] == 0);
  p.b_skip1 = cbv(a, a.ctx[C_SKIP] + inc, 1);
  p.b_skip0 = cbv(a, a.ctx[C_SKIP] + inc, 0);
  return p;
}

// lam * split_cu_flag bits (ctx from the neighbours' CU sizes)
HM_FN float split_bits(const Args& a, int val, const Prices& p, int gx,
                       int gy, int below) {
  const int inc = (gx > 0 && p.l_blk[K_SZ] < below) +
                  (gy > 0 && p.a_blk[K_SZ] < below);
  return HM_FMUL(a.lam, cbv(a, a.ctx[C_SPLIT] + inc, val));
}

HM_FN void write_row(int* row, int kind, int mi, const Amvp& am, int dir,
                     int mvx, int mvy, int ref, int sz, int cbfy) {
  const int v[NCOL] = {kind, mi, am.mvdx, am.mvdy, am.mvpi, dir, mvx, mvy,
                       ref, sz, cbfy, 0, 0, 0};
  for (int c = 0; c < NCOL; ++c) row[c] = v[c];
}

// ---------------------------------------------------------------------------
// K23's lane: groups of the block side by side, the working set in shared
// memory.
//
// A CU trial runs as rounds of independent tasks, each closed by the
// block's barrier: R1 predicts every merge candidate's planes and sums each
// plane's SSE (in a cell also the intra arm's predictions); R2 codes the
// finalists with deadzone quantisation and, in a cell (8 groups),
// already recodes every finalist (the RDOQ trellis, the
// chroma transform-skip trials) of which the cost compare then keeps the
// winner's, and in a cell codes the intra arm's TBs, whatever the gate
// then decides (it passes for nearly every cell); with fewer groups (the
// 16x16 and 32x32 trials) R3 recodes the winner alone.  Fewer, larger
// groups there keep the block's shared memory small enough to leave the
// L1 cache room for the coding tables and the threads' stacks (on the
// H100 a larger arena ran slower: PERF.md).  A round's tasks go to the
// groups heaviest first in a snake (`deal`); a group's coding work area,
// K10 working set, MC patch and the deadzone codings' levels and
// reconstruction are its own, a task's outputs are the task's own.
// Between rounds every thread derives the same scalars
// (lists, costs, choices) in the plain order.  The host build has one
// group; `task_reverse` runs its task loops last task first, so the CPU
// tests can show that no task reads what another task of its round
// writes.

constexpr int THREADS = 256;  // a lane's block: 8 warps
constexpr int NG_8 = 8;   // groups of an 8x8 trial: a warp each
constexpr int NG_16 = 4;  // of a 16x16 trial: two warps each
constexpr int NG_32 = 1;  // of a 32x32 trial: the block
HM_HD constexpr int ng_of(int n) {
  return n == 8 ? NG_8 : n == 16 ? NG_16 : NG_32;
}
// whether a trial's finalists are recoded with their deadzone codings, in
// one round (a cell), or the winner alone after them (the larger trials)
HM_HD constexpr bool spec_of(int n) { return n == 8; }
// its recode buffers: every finalist's, or the winner's
HM_HD constexpr int nfb_of(int n) { return spec_of(n) ? F : 1; }
// the group pieces (groups.cuh)
using gp::deal;
using gp::group_of;
using gp::Grp;
using gp::imax_c;
using gp::NTASK;  // the most tasks of a round (a cell's R2: 21)
using gp::r4;
using gp::task_of;
#if !defined(__CUDACC__)
using gp::task_reverse;
#endif

// a group's area: its coding work area and K10 working set, its MC patch
// (R1) and in the same place the deadzone codings' levels and
// reconstruction (R2)
struct GrpMem {
  int *work, *k10, *patch, *tmp, *dzl, *dzr;
};

// one CU trial's shared memory (the intra arm and the TS alternatives
// only in a cell)
struct CuMem {
  int *oy, *ou, *ov;                  // the source
  int *py, *pu, *pv;                  // per merge candidate
  int *ly, *lu, *lv, *ry, *ru, *rv;   // the recodes (nfb_of(n) buffers,
  int *ltu, *ltv, *rtu, *rtv;         // buffer f at f times a plane),
                                      // their chroma TS alternatives
  int *iref, *ireff, *irefu, *irefv;  // intra: the reference lines,
  int *ipy, *ipu, *ipv;               // the prediction, the coded CU
  int *ily, *ilu, *ilv, *iry, *iru, *irv, *iltu, *iltv, *irtu, *irtv;
  long long* sse;                     // (MAXM, 3) the candidates' SSEs
  float *rsse, *rbits;                // (NTASK,) a round's results
  int *rnz, *ord;                     // and its deal (thread 0's)
  int* grp;
  int gints;                          // ints of a group's area
};

// ints of a group's area at side n; places it at base when g is given
HM_HD constexpr int grp_place(int n, int* base = nullptr,
                              GrpMem* g = nullptr) {
  int at = 0;
#define PW_PUT(f, ints)            \
  do {                             \
    if (g) g->f = base + at;       \
    at += r4(ints);                \
  } while (0)
  PW_PUT(work, wk::work_ints(n * n));
  PW_PUT(k10, (int)(rdoq_smem_bytes(n == 8 ? 3 : n == 16 ? 4 : 5) / 4));
  const int mc = at;
  PW_PUT(patch, mc_patch_ints(n, n, 0));
  PW_PUT(tmp, mc_tmp_ints(n, n, 0));
  at = mc;
  PW_PUT(dzl, n * n);
  PW_PUT(dzr, n * n);
  at = imax_c(at, mc + r4(mc_patch_ints(n, n, 0)) + r4(mc_tmp_ints(n, n, 0)));
#undef PW_PUT
  return at;
}

// ints of a trial's shared memory at side n with ng groups; places it at
// base when m is given
HM_HD constexpr int cu_place(int n, int ng, int* base = nullptr,
                             CuMem* m = nullptr) {
  const int nn = n * n, ncc = nn / 4, cell = n == 8, nb = nfb_of(n);
  int at = 0;
#define PW_PUT(f, ints)            \
  do {                             \
    if (m) m->f = (decltype(m->f))(base + at); \
    at += r4(ints);                \
  } while (0)
  PW_PUT(oy, nn);
  PW_PUT(ou, ncc);
  PW_PUT(ov, ncc);
  PW_PUT(py, MAXM * nn);
  PW_PUT(pu, MAXM * ncc);
  PW_PUT(pv, MAXM * ncc);
  PW_PUT(ly, nb * nn);
  PW_PUT(lu, nb * ncc);
  PW_PUT(lv, nb * ncc);
  PW_PUT(ry, nb * nn);
  PW_PUT(ru, nb * ncc);
  PW_PUT(rv, nb * ncc);
  PW_PUT(ltu, nb * 16 * cell);
  PW_PUT(ltv, nb * 16 * cell);
  PW_PUT(rtu, nb * 16 * cell);
  PW_PUT(rtv, nb * 16 * cell);
  PW_PUT(iref, 34 * cell);
  PW_PUT(ireff, 34 * cell);
  PW_PUT(irefu, 18 * cell);
  PW_PUT(irefv, 18 * cell);
  PW_PUT(ipy, 64 * cell);
  PW_PUT(ipu, 16 * cell);
  PW_PUT(ipv, 16 * cell);
  PW_PUT(ily, 64 * cell);
  PW_PUT(ilu, 16 * cell);
  PW_PUT(ilv, 16 * cell);
  PW_PUT(iry, 64 * cell);
  PW_PUT(iru, 16 * cell);
  PW_PUT(irv, 16 * cell);
  PW_PUT(iltu, 16 * cell);
  PW_PUT(iltv, 16 * cell);
  PW_PUT(irtu, 16 * cell);
  PW_PUT(irtv, 16 * cell);
  PW_PUT(sse, 2 * 3 * MAXM);
  PW_PUT(rsse, NTASK);
  PW_PUT(rbits, NTASK);
  PW_PUT(rnz, NTASK);
  PW_PUT(ord, NTASK);
  const int gints = grp_place(n);
  PW_PUT(grp, ng * gints);
#undef PW_PUT
  if (m) m->gints = gints;
  return at;
}

// K23's dynamic shared memory: the largest trial's layout of a geometry
// (8: cells alone; 32: with the 16x16 and 32x32 trials).  What a block
// leaves of the SM's 256 KB is its L1 cache, which holds the coding
// tables and the threads' stacks.
constexpr int SMEM8_BYTES = 4 * cu_place(8, NG_8);
constexpr int SMEM_BYTES =
    4 * imax_c(cu_place(8, NG_8),
               imax_c(cu_place(16, NG_16), cu_place(32, NG_32)));
static_assert(SMEM_BYTES + 4 * wk::LP_FLOATS <= 232448,
              "K23's shared memory: 227 KB a block on the H100");

struct Walk {  // K23's lane: its Args, its block's threads and arena
  const Args* ap;
  int tid, nt;
  int* smem;
};

HM_FN CuMem cu_mem(const Walk& W, int n, int ng) {
  CuMem m{};
  cu_place(n, ng, W.smem, &m);
  return m;
}

HM_FN GrpMem grp_mem(const CuMem& m, int n, int g) {
  GrpMem gm{};
  grp_place(n, m.grp + g * m.gints, &gm);
  return gm;
}

// group G's coding lane in its area (the block's own lane when G is the
// whole block)
HM_FN wk::Lane coder_of(const Walk& W, const GrpMem& gm, int tid, int nt,
                        int n) {
  return wk::coder_lane(W.ap->cd, gm.work, gm.k10, tid, nt, n);
}

// the block as one lane (copies of the source, commits)
HM_FN wk::Lane block_of(const Walk& W) {
  return wk::plain_lane(W.ap->cd, W.tid, W.nt);
}

// a round's result slots
HM_FN gp::Slots res_of(const CuMem& m) {
  return gp::Slots{m.rsse, m.rbits, m.rnz, nullptr};
}
HM_FN void put_res(const CuMem& m, const wk::Lane& L, int t,
                   const TbRes& r) {
  gp::put_res(res_of(m), L, t, r);
}
HM_FN TbRes get_res(const CuMem& m, int t) {
  return gp::get_res(res_of(m), t);
}

// ---------------------------------------------------------------------------
// merge RD (p_merge_all_rd) in rounds

struct Merge {  // the list and its screening, every thread alike
  int M, nf, fidx[F];
  int cmx[MAXM], cmy[MAXM], crf[MAXM];
  float bmi[MAXM];
};

// R1's MC task t < 3 M: plane t / M of candidate t % M predicted, its SSE
// against the source into m.sse
HM_FN void mc_task(const Walk& W, const CuMem& m, const GrpMem& gm,
                   wk::Lane& L, const Merge& g, int t, int n, int x0,
                   int y0) {
  const Args& a = *W.ap;
  const int p = t / g.M, c = t - p * g.M, nc = n / 2;
  const int nn = n * n, ncc = nc * nc;
  const int rr = iclamp(g.crf[c], 0, a.R - 1);
  const int H = p ? a.h / 2 : a.h, Wd = p ? a.w / 2 : a.w;
  const int* ref = p == 0 ? a.refs_y + (size_t)rr * a.h * a.w
                   : (p == 1 ? a.refs_u : a.refs_v) +
                         (size_t)rr * (a.h / 2) * (a.w / 2);
  int* out = p == 0 ? m.py + c * nn : (p == 1 ? m.pu : m.pv) + c * ncc;
  const int* org = p == 0 ? m.oy : p == 1 ? m.ou : m.ov;
  const int k = p ? nc : n;
  mc_block<false>(ref, H, Wd, p ? x0 / 2 : x0, p ? y0 / 2 : y0, g.cmx[c],
                  g.cmy[c], k, k, p != 0, a.bd, gm.patch, gm.tmp, out,
                  L.tid, L.nt);
  long long s = 0;
  for (int e = L.tid; e < k * k; e += L.nt) {
    const long long d = org[e] - out[e];
    s += d * d;
  }
  s = group_sum(s, L.tid, L.nt, wk::red_of(L));
  if (L.tid == 0) m.sse[3 * c + p] = s;
}

// after R1: skip priced by the 3-plane SSE (float(ssd_y) + wchroma *
// float(ssd_u + ssd_v)), the screening costs, the F finalists
HM_FN void merge_screen(const Args& a, const CuMem& m, float b_skip1,
                        Merge& g, MergeRes& r) {
  const int M = g.M;
  float cost_sk[MAXM], screen[MAXM];
  for (int c = 0; c < M; ++c) {
    const long long* q = m.sse + 3 * c;
    const float e = HM_FADD((float)q[0], HM_FMUL(a.wchroma,
                                                 (float)(q[1] + q[2])));
    g.bmi[c] = merge_idx_bits(a, c);
    cost_sk[c] = HM_FADD(e, HM_FMUL(a.lam, HM_FADD(b_skip1, g.bmi[c])));
    screen[c] = HM_FADD(e, HM_FMUL(a.lam, g.bmi[c]));
  }
  r.mi_skip = 0;
  for (int c = 1; c < M; ++c)
    if (cost_sk[c] < cost_sk[r.mi_skip]) r.mi_skip = c;
  r.cost_skip = cost_sk[r.mi_skip];
  // the finalists: the stable sort's first F = repeated first minima
  g.nf = M < F ? M : F;
  for (int f = 0; f < g.nf; ++f) {
    int best = -1;
    for (int c = 0; c < M; ++c) {
      bool taken = false;
      for (int q = 0; q < f; ++q) taken = taken || g.fidx[q] == c;
      if (!taken && (best < 0 || screen[c] < screen[best])) best = c;
    }
    g.fidx[f] = best;
  }
}

// R2's deadzone task t < 3 nf: plane t % 3 of finalist t / 3, its result
// into slot t0 + t
HM_FN void dz_task(const Walk& W, const CuMem& m, const GrpMem& gm,
                   wk::Lane& L, const Merge& g, int t0, int t, int n,
                   int log2) {
  const Args& a = *W.ap;
  const int f = t / 3, p = t - 3 * f, c = g.fidx[f];
  const int nn = n * n, ncc = nn / 4;
  const TbRes r =
      p == 0 ? code_tb(L, log2, true, false, false, -1, a.lam, false, 0.f,
                       m.oy, m.py + c * nn, gm.dzl, gm.dzr, false)
             : code_tb(L, log2 - 1, false, false, false, -1, a.lam_c, true,
                       a.wchroma, p == 1 ? m.ou : m.ov,
                       (p == 1 ? m.pu : m.pv) + c * ncc, gm.dzl, gm.dzr,
                       false);
  put_res(m, L, t0 + t, r);
}

// the finalist (its index in fidx) of least deadzone cost, from R2's
// results at t0
HM_FN int merge_pick(const Args& a, const CuMem& m, const Merge& g, int t0) {
  float cost_f[F];
  for (int f = 0; f < g.nf; ++f) {
    const TbRes ry = get_res(m, t0 + 3 * f), ru = get_res(m, t0 + 3 * f + 1),
                rv = get_res(m, t0 + 3 * f + 2);
    // (dY + dCb + dCr) + lam * ((((bmi + cbf) + bY) + bCb) + bCr)
    float b = HM_FADD(g.bmi[g.fidx[f]], cbf_bits_inter(a, ry.nz, ru.nz,
                                                        rv.nz));
    b = HM_FADD(HM_FADD(HM_FADD(b, ry.bits), ru.bits), rv.bits);
    cost_f[f] = HM_FADD(HM_FADD(HM_FADD(ry.sse, ru.sse), rv.sse),
                        HM_FMUL(a.lam, b));
  }
  int fi = 0;
  for (int f = 1; f < g.nf; ++f)
    if (cost_f[f] < cost_f[fi]) fi = f;
  return fi;
}

// the recode task j of finalist f, its result into slot t: 0 Y, 1 Cb,
// 2 Cr (the trellis when rdoq), 3 and 4 their 4x4 transform-skip codings;
// into the finalist's buffers (the one buffer when the winner alone is
// recoded)
HM_FN void rc_task(const Walk& W, const CuMem& m, wk::Lane& L,
                   const Merge& g, int f, int j, int t, int n, int log2) {
  const Args& a = *W.ap;
  const int nn = n * n, ncc = nn / 4, c = g.fidx[f];
  const int bf = spec_of(n) ? f : 0;
  const bool tr = a.rdoq != 0;
  TbRes r;
  if (j == 0) {
    r = code_tb(L, log2, true, false, false, -1, a.lam, false, 0.f, m.oy,
                m.py + c * nn, m.ly + bf * nn, m.ry + bf * nn, tr);
  } else {
    const bool u = j == 1 || j == 3;
    const int o = bf * (j >= 3 ? 16 : ncc);
    r = code_tb(L, log2 - 1, false, false, j >= 3, -1, a.lam_c, true,
                a.wchroma, u ? m.ou : m.ov, (u ? m.pu : m.pv) + c * ncc,
                (j == 1 ? m.lu : j == 2 ? m.lv : j == 3 ? m.ltu : m.ltv) + o,
                (j == 1 ? m.ru : j == 2 ? m.rv : j == 3 ? m.rtu : m.rtv) + o,
                tr);
  }
  put_res(m, L, t, r);
}

// a chroma TB's result (slot t0) with its TS trial (slot t1); the TS
// coding's levels and reconstruction copied in when chosen, the block
// cooperating; every thread
HM_FN TbRes ts_keep(const Walk& W, const CuMem& m, int t0, int t1, bool ts,
                    int* lev, int* rec, const int* levt, const int* rect) {
  const TbRes r0 = get_res(m, t0);
  if (!ts) return r0;
  const TbRes r = wk::ts_pick(W.ap->cd, false, W.ap->lam_c, r0,
                              get_res(m, t1));
  if (r.ts) {
    for (int e = W.tid; e < 16; e += W.nt) {
      lev[e] = levt[e];
      rec[e] = rect[e];
    }
    HM_SYNC();
  }
  return r;
}

// the winner (finalist fi, its recodes' results at slot t0, nr of them):
// its cbf, TS flags and cost (an all-zero residual leaves it to skip)
HM_FN void merge_finish(const Walk& W, const CuMem& m, const Merge& g,
                        int fi, int t0, int n, bool ts, float b_inter,
                        MergeRes& r) {
  const Args& a = *W.ap;
  const int wi = g.fidx[fi], cc = n * n / 4, bf = spec_of(n) ? fi : 0;
  r.wf = bf;
  r.mi_merge = wi;
  const TbRes ry = get_res(m, t0);
  const TbRes ru = ts_keep(W, m, t0 + 1, t0 + 3, ts, m.lu + bf * cc,
                           m.ru + bf * cc, m.ltu + bf * 16, m.rtu + bf * 16);
  const TbRes rv = ts_keep(W, m, t0 + 2, t0 + 4, ts, m.lv + bf * cc,
                           m.rv + bf * cc, m.ltv + bf * 16, m.rtv + bf * 16);
  r.cbf = ry.nz | (ru.nz << 1) | (rv.nz << 2);
  r.ts = ru.ts | (rv.ts << 1);
  // (dY + dU + dV) + lam * ((((hdr + cbf) + bY) + bU) + bV), hdr =
  // (b_inter + merge_flag) + merge_idx
  const float hdr =
      HM_FADD(HM_FADD(b_inter, cbv(a, a.ctx[C_MERGE_FLAG], 1)), g.bmi[wi]);
  float b = HM_FADD(hdr, cbf_bits_inter(a, ry.nz, ru.nz, rv.nz));
  b = HM_FADD(HM_FADD(HM_FADD(b, ry.bits), ru.bits), rv.bits);
  r.cost_merge = HM_FADD(HM_FADD(HM_FADD(ry.sse, ru.sse), rv.sse),
                         HM_FMUL(a.lam, b));
  // an all-zero-residual merge IS skip with one extra flag
  if (!r.cbf) r.cost_merge = BIG;
  r.sk_mvx = g.cmx[r.mi_skip];
  r.sk_mvy = g.cmy[r.mi_skip];
  r.sk_ref = g.crf[r.mi_skip];
  r.mg_mvx = g.cmx[wi];
  r.mg_mvy = g.cmy[wi];
  r.mg_ref = g.crf[wi];
}

// the source of the n x n CU at (x0, y0), the block cooperating
HM_FN void copy_source(const Walk& W, const CuMem& m, int x0, int y0,
                       int n) {
  const Args& a = *W.ap;
  wk::Lane B = block_of(W);
  copy_block(B, a.org_y, a.w, x0, y0, n, m.oy);
  copy_block(B, a.org_u, a.w / 2, x0 / 2, y0 / 2, n / 2, m.ou);
  copy_block(B, a.org_v, a.w / 2, x0 / 2, y0 / 2, n / 2, m.ov);
}

// ---------------------------------------------------------------------------
// the steps

// R1's intra task t (0 luma, 1 Cb, 2 Cr) of cell b: the reference line
// (luma also filtered) and the open-loop mode's prediction
HM_FN void intra_pred_task(const Walk& W, const CuMem& m, wk::Lane& L,
                           int b, int t) {
  const Args& a = *W.ap;
  const int im = a.imode[b];
  if (t == 0) {
    gather_line(L, a.rec_y, a.g8s + b * 33, a.g8n[b], 33, m.iref);
    for (int k = L.tid; k < 33; k += L.nt)
      m.ireff[k] = filter_sample(m.iref, k, 8, a.bd, 0);
    HM_GSYNC(L.nt);
    predict(L, m.iref, m.ireff, im, 8, 1, m.ipy);
  } else {
    int* line = t == 1 ? m.irefu : m.irefv;
    gather_line(L, t == 1 ? a.rec_u : a.rec_v, a.g4s + b * 17, a.g4n[b], 17,
                line);
    predict(L, line, line, im, 4, 0, t == 1 ? m.ipu : m.ipv);
  }
}

// R2's intra coding task t of cell b: 0 Y, 1 Cb, 2 Cr, 3 and 4 their TS
// codings
HM_FN void intra_code_task(const Walk& W, const CuMem& m, wk::Lane& L,
                           int b, int t) {
  const Args& a = *W.ap;
  const int sel = scan_sel(a.imode[b]);
  const bool tr = a.rdoq != 0;
  TbRes r;
  if (t == 0) {
    r = code_tb(L, 3, true, false, false, sel, a.lam, false, 0.f, m.oy,
                m.ipy, m.ily, m.iry, tr);
  } else {
    const bool u = t == 1 || t == 3;
    r = code_tb(L, 2, false, false, t >= 3, sel, a.lam_c, true, a.wchroma,
                u ? m.ou : m.ov, u ? m.ipu : m.ipv,
                t == 1 ? m.ilu : t == 2 ? m.ilv : t == 3 ? m.iltu : m.iltv,
                t == 1 ? m.iru : t == 2 ? m.irv : t == 3 ? m.irtu : m.irtv,
                tr);
  }
  put_res(m, L, t, r);
}

// one 8x8 CU: returns the least of its four costs; commits its decision
HM_BIG float cell_step(const Walk& W, int b) {
  const Args& a = *W.ap;
  const Grp G = group_of(W.tid, W.nt, NG_8);
  const CuMem m = cu_mem(W, 8, G.ng);
  const GrpMem gm = grp_mem(m, 8, G.g);
  wk::Lane L = coder_of(W, gm, G.tid, G.nt, 8);
  const int bw = a.w / 8, P = bw * (a.h / 8), byi = b / bw, bxi = b % bw;
  const int x0 = bxi * 8, y0 = byi * 8;
  HM_PH_START(t_src);
  copy_source(W, m, x0, y0, 8);
  mvc::Motion nb[5];
  neighbours(a, a.nb_flat + 5 * b, a.nb_ok + 5 * b, nb);
  const Prices pr = mode_prices(a, b, bxi, byi);
  const float b_common = HM_FADD(pr.b_skip0, cbv(a, a.ctx[C_PART], 1));
  const float b_inter = HM_FADD(b_common, cbv(a, a.ctx[C_PRED_MODE], 0));
  const Cand t = t_cand(a.t8, P, b);
  Merge g;
  g.M = a.max_merge;
  mvc::merge_list_p(nb, t.ok, t.mx, t.my, g.M, a.limit, g.cmx, g.cmy, g.crf);
  HM_PH_STOP(ph(PH_SRC, 3), t_src);

  // R1: the candidates' planes and SSEs, the intra arm's predictions
  HM_PH_START(t_mc);
  const int n1 = 3 * g.M + 3;
  for (int k = G.g; k < n1; k += G.ng) {
    const int tk = task_of(k, n1);
    if (tk < 3 * g.M)
      mc_task(W, m, gm, L, g, tk, 8, x0, y0);
    else
      intra_pred_task(W, m, L, b, tk - 3 * g.M);
  }
  HM_SYNC();
  HM_PH_STOP(ph(PH_MC, 3), t_mc);
  HM_PH_START(t_sse);
  MergeRes mr;
  merge_screen(a, m, pr.b_skip1, g, mr);
  HM_PH_STOP(ph(PH_SSE, 3), t_sse);

  // R2: the intra arm's codings (slots 0 .. ni - 1), the finalists'
  // deadzone codings (3 each), their recodes (nr each)
  HM_PH_START(t_dz);
  const int ni = a.ts ? 5 : 3, nr = a.ts ? 5 : 3, t_rc = ni + 3 * g.nf;
  const int n2 = t_rc + nr * g.nf;
  if (W.tid == 0) {
    int w[NTASK];   // RDOQ luma 4, chroma 2; deadzone luma 2, chroma 1
    for (int t2 = 0; t2 < n2; ++t2)
      w[t2] = t2 < ni ? (t2 == 0 ? 4 : 2)
              : t2 < t_rc ? ((t2 - ni) % 3 == 0 ? 2 : 1)
                          : ((t2 - t_rc) % nr == 0 ? 4 : 2);
    deal(w, n2, G.ng, m.ord);
  }
  HM_SYNC();
  const int np2 = (n2 + G.ng - 1) / G.ng * G.ng;
  for (int k = G.g; k < np2; k += G.ng) {
    const int tk = m.ord[task_of(k, np2)];
    if (tk < 0) continue;
    if (tk < ni)
      intra_code_task(W, m, L, b, tk);
    else if (tk < t_rc)
      dz_task(W, m, gm, L, g, ni, tk - ni, 8, 3);
    else
      rc_task(W, m, L, g, (tk - t_rc) / nr, (tk - t_rc) % nr, tk, 8, 3);
  }
  HM_SYNC();
  HM_PH_STOP(ph(PH_DZ, 3), t_dz);

  // the intra arm's results and the winner's
  HM_PH_START(t_rq);
  const TbRes iy = get_res(m, 0);
  const TbRes iu = ts_keep(W, m, 1, 3, a.ts, m.ilu, m.iru, m.iltu, m.irtu);
  const TbRes iv = ts_keep(W, m, 2, 4, a.ts, m.ilv, m.irv, m.iltv, m.irtv);
  const int fi = merge_pick(a, m, g, ni);
  merge_finish(W, m, g, fi, t_rc + nr * fi, 8, a.ts, b_inter, mr);
  HM_PH_STOP(ph(PH_RDOQ, 3), t_rq);

  HM_PH_START(t_am);
  const Hoist& h8 = a.h8;
  const int aref = h8.ref[b], amx = h8.mvx[b], amy = h8.mvy[b];
  const Amvp am = amvp(a, nb, aref, amx, amy, t);
  const float cost_amvp = amvp_cost(a, h8, b, b_inter, am);
  HM_PH_STOP(ph(PH_AMVP, 3), t_am);

  // intra, priced only when the best inter cost is above the gate
  HM_PH_START(t_in);
  const float inter_best =
      fminf(mr.cost_skip, fminf(mr.cost_merge, cost_amvp));
  float cost_intra = BIG;
  const int icbf = iy.nz | (iu.nz << 1) | (iv.nz << 2);
  const int its = iu.ts | (iv.ts << 1);
  const int im = a.imode[b];
  if (!(inter_best <= HM_FMUL(INTRA_GATE, a.lam))) {
    const int* l_blk = pr.l_blk;
    const int* a_blk = pr.a_blk;
    const int lmode = (bxi > 0 && l_blk[K_KIND] == 3) ? a.imode[b - 1] : 1;
    const bool am_ok = byi > 0 && (y0 & ((1 << a.log2_ctu) - 1)) != 0;
    const int amode = (am_ok && a_blk[K_KIND] == 3) ? a.imode[b - bw] : 1;
    const float b_icbf = HM_FADD(
        HM_FADD(cbf_chroma(a, iu.nz), cbf_chroma(a, iv.nz)),
        cbf_luma(a, iy.nz));
    // (dY + dU + dV) + lam * ((((((b_common + pred_mode) + mpm) + dm) +
    // cbf) + bY) + bU) + bV)
    float bs = HM_FADD(b_common, cbv(a, a.ctx[C_PRED_MODE], 1));
    bs = HM_FADD(bs, mpm_bits(a.cb, a.ctx[C_IPM], im, lmode, amode));
    bs = HM_FADD(bs, cbv(a, a.ctx[C_CHROMA_DM], 0));
    bs = HM_FADD(bs, b_icbf);
    bs = HM_FADD(HM_FADD(HM_FADD(bs, iy.bits), iu.bits), iv.bits);
    cost_intra = HM_FADD(HM_FADD(HM_FADD(iy.sse, iu.sse), iv.sse),
                         HM_FMUL(a.lam, bs));
  }
  HM_PH_STOP(ph(PH_INTRA, 3), t_in);
  HM_PH_START(t_cm);

  const float costs[4] = {mr.cost_skip, mr.cost_merge, cost_amvp,
                          cost_intra};
  int choice = 0;
  for (int c = 1; c < 4; ++c)
    if (costs[c] < costs[choice]) choice = c;
  if (choice == 1 && !mr.cbf) choice = 0;
  const int mi = choice == 0 ? mr.mi_skip : mr.mi_merge;

  // commit: reconstruction, levels, the row, the TS flags
  const int ms = mr.mi_skip;
  const int wf = mr.wf;
  const int* ry = choice == 0 ? m.py + ms * 64
                  : choice == 1 ? m.ry + wf * 64
                  : choice == 2 ? h8.rec_y + b * 64
                                : m.iry;
  const int* ru = choice == 0 ? m.pu + ms * 16
                  : choice == 1 ? m.ru + wf * 16
                  : choice == 2 ? h8.rec_u + b * 16
                                : m.iru;
  const int* rv = choice == 0 ? m.pv + ms * 16
                  : choice == 1 ? m.rv + wf * 16
                  : choice == 2 ? h8.rec_v + b * 16
                                : m.irv;
  for (int e = W.tid; e < 64; e += W.nt)
    a.rec_y[(y0 + e / 8) * a.w + x0 + e % 8] = ry[e];
  for (int e = W.tid; e < 16; e += W.nt) {
    const int o = (y0 / 2 + e / 4) * (a.w / 2) + x0 / 2 + e % 4;
    a.rec_u[o] = ru[e];
    a.rec_v[o] = rv[e];
  }
  for (int e = W.tid; e < 96; e += W.nt) {
    int v = 0;
    if (choice == 1)
      v = e < 64 ? m.ly[wf * 64 + e] : e < 80 ? m.lu[wf * 16 + e - 64]
                                              : m.lv[wf * 16 + e - 80];
    else if (choice == 2)
      v = h8.lev[b * 96 + e];
    else if (choice == 3)
      v = e < 64 ? m.ily[e] : e < 80 ? m.ilu[e - 64] : m.ilv[e - 80];
    a.levs[b * 96 + e] = v;
  }
  if (W.tid == 0) {
    int* row = a.blk + (size_t)b * NCOL;
    if (choice == 0)
      write_row(row, 0, mi, am, 1, mr.sk_mvx, mr.sk_mvy, mr.sk_ref, 0, 0);
    else if (choice == 1)
      write_row(row, 1, mi, am, 1, mr.mg_mvx, mr.mg_mvy, mr.mg_ref, 0,
                mr.cbf & 1);
    else if (choice == 2)
      write_row(row, 2, mi, am, 1, amx, amy, aref, 0, h8.cbf[b] & 1);
    else
      write_row(row, 3, mi, am, 0, 0, 0, 0, 0, icbf & 1);
    a.tsf[b] = choice == 0 ? 0 : choice == 1 ? mr.ts
               : choice == 2 ? (h8.ts ? h8.ts[b] : 0) : its;
  }
  HM_SYNC();
  HM_PH_STOP(ph(PH_COMMIT, 3), t_cm);
  float best = costs[0];
  for (int c = 1; c < 4; ++c) best = fminf(best, costs[c]);
  return best;
}

struct LargeRes {
  float cost;  // the least of skip / merge / AMVP, without the split bit
  Prices pr;
  MergeRes mr;
  Amvp am;
  int c;
};

// one n x n inter CU trial (skip / merge / the hoisted AMVP, one TU) at
// grid position (gx, gy), from the committed state outside the region;
// its predictions and coded winner stay in the arena for commit_large
template <int LOG2>
HM_BIG LargeRes large_cu(const Walk& W, int g, int gx, int gy, int corner,
                         const int* nb_idx, const int* nb_ok, const int* tl,
                         int npos, const Hoist& hs) {
  constexpr int n = 1 << LOG2, log2 = LOG2;
  const Args& a = *W.ap;
  const Grp G = group_of(W.tid, W.nt, ng_of(n));
  const CuMem m = cu_mem(W, n, G.ng);
  const GrpMem gm = grp_mem(m, n, G.g);
  wk::Lane L = coder_of(W, gm, G.tid, G.nt, n);
  const int x0 = gx * n, y0 = gy * n;
  HM_PH_START(t_src);
  copy_source(W, m, x0, y0, n);
  mvc::Motion nb[5];
  neighbours(a, nb_idx, nb_ok, nb);
  LargeRes r;
  r.pr = mode_prices(a, corner, gx, gy);
  const float b_inter =
      HM_FADD(HM_FADD(r.pr.b_skip0, cbv(a, a.ctx[C_PART], 1)),
              cbv(a, a.ctx[C_PRED_MODE], 0));
  const Cand t = t_cand(tl, npos, g);
  Merge mg;
  mg.M = a.max_merge;
  mvc::merge_list_p(nb, t.ok, t.mx, t.my, mg.M, a.limit, mg.cmx, mg.cmy,
                    mg.crf);
  HM_PH_STOP(ph(PH_SRC, log2), t_src);

  HM_PH_START(t_mc);
  const int n1 = 3 * mg.M;
  for (int k = G.g; k < n1; k += G.ng)
    mc_task(W, m, gm, L, mg, task_of(k, n1), n, x0, y0);
  HM_SYNC();
  HM_PH_STOP(ph(PH_MC, log2), t_mc);
  HM_PH_START(t_sse);
  merge_screen(a, m, r.pr.b_skip1, mg, r.mr);
  HM_PH_STOP(ph(PH_SSE, log2), t_sse);

  // R2: the finalists' deadzone codings (slots 0 .. 3 nf - 1); R3
  // recodes the winner alone
  HM_PH_START(t_dz);
  const int t_rc = 3 * mg.nf;
  if (W.tid == 0) {
    int w[NTASK];   // deadzone luma 2, chroma 1
    for (int t2 = 0; t2 < t_rc; ++t2) w[t2] = t2 % 3 == 0 ? 2 : 1;
    deal(w, t_rc, G.ng, m.ord);
  }
  HM_SYNC();
  const int np2 = (t_rc + G.ng - 1) / G.ng * G.ng;
  for (int k = G.g; k < np2; k += G.ng) {
    const int tk = m.ord[task_of(k, np2)];
    if (tk >= 0) dz_task(W, m, gm, L, mg, 0, tk, n, log2);
  }
  HM_SYNC();
  HM_PH_STOP(ph(PH_DZ, log2), t_dz);

  HM_PH_START(t_rq);
  const int fi = merge_pick(a, m, mg, 0);
  // R3 writes slots and buffers merge_pick does not read
  for (int k = G.g; k < 3; k += G.ng) {
    const int j3 = task_of(k, 3);
    rc_task(W, m, L, mg, fi, j3, t_rc + 3 * fi + j3, n, log2);
  }
  HM_SYNC();
  merge_finish(W, m, mg, fi, t_rc + 3 * fi, n, false, b_inter, r.mr);
  HM_PH_STOP(ph(PH_RDOQ, log2), t_rq);

  HM_PH_START(t_am);
  r.am = amvp(a, nb, hs.ref[g], hs.mvx[g], hs.mvy[g], t);
  const float costs[3] = {r.mr.cost_skip, r.mr.cost_merge,
                          amvp_cost(a, hs, g, b_inter, r.am)};
  r.c = 0;
  for (int c = 1; c < 3; ++c)
    if (costs[c] < costs[r.c]) r.c = c;
  if (r.c == 1 && !r.mr.cbf) r.c = 0;
  r.cost = fminf(costs[0], fminf(costs[1], costs[2]));
  HM_PH_STOP(ph(PH_AMVP, log2), t_am);
  return r;
}

// commit a large CU trial to its `ncell` cells (`cells` in z-order), from
// the arena large_cu left
template <int LOG2>
HM_BIG void commit_large(const Walk& W, const LargeRes& r, int g, int gx,
                         int gy, const Hoist& hs, const int* cells,
                         int ncell) {
  constexpr int n = 1 << LOG2, log2 = LOG2;
  const Args& a = *W.ap;
  const CuMem m = cu_mem(W, n, group_of(W.tid, W.nt, ng_of(n)).ng);
  const int x0 = gx * n, y0 = gy * n, nn = n * n, nc = n / 2, ncc = nc * nc;
  const int c = r.c, ms = r.mr.mi_skip, wf = r.mr.wf;
  HM_PH_START(t_cm);
  const int* ry = c == 0 ? m.py + ms * nn
                  : c == 1 ? m.ry + wf * nn : hs.rec_y + (size_t)g * nn;
  const int* ru = c == 0 ? m.pu + ms * ncc
                  : c == 1 ? m.ru + wf * ncc : hs.rec_u + (size_t)g * ncc;
  const int* rv = c == 0 ? m.pv + ms * ncc
                  : c == 1 ? m.rv + wf * ncc : hs.rec_v + (size_t)g * ncc;
  for (int e = W.tid; e < nn; e += W.nt)
    a.rec_y[(y0 + e / n) * a.w + x0 + e % n] = ry[e];
  for (int e = W.tid; e < ncc; e += W.nt) {
    const int o = (y0 / 2 + e / nc) * (a.w / 2) + x0 / 2 + e % nc;
    a.rec_u[o] = ru[e];
    a.rec_v[o] = rv[e];
  }
  // levs: the flat [Y | U | V] cut into 96-value slabs, one per cell in
  // `cells` order
  const int tot = nn + 2 * ncc;
  for (int e = W.tid; e < tot; e += W.nt) {
    int v = 0;
    if (c == 1)
      v = e < nn ? m.ly[wf * nn + e]
          : e < nn + ncc ? m.lu[wf * ncc + e - nn]
                         : m.lv[wf * ncc + e - nn - ncc];
    else if (c == 2)
      v = hs.lev[(size_t)g * tot + e];
    a.levs[cells[e / 96] * 96 + e % 96] = v;
  }
  if (W.tid == 0) {
    const MergeRes& mr = r.mr;
    const int mi = c == 0 ? mr.mi_skip : mr.mi_merge;
    for (int k = 0; k < ncell; ++k) {
      int* row = a.blk + (size_t)cells[k] * NCOL;
      if (c == 0)
        write_row(row, 0, mi, r.am, 1, mr.sk_mvx, mr.sk_mvy, mr.sk_ref,
                  log2 - 3, 0);
      else if (c == 1)
        write_row(row, 1, mi, r.am, 1, mr.mg_mvx, mr.mg_mvy, mr.mg_ref,
                  log2 - 3, mr.cbf & 1);
      else
        write_row(row, 2, mi, r.am, 1, hs.mvx[g], hs.mvy[g], hs.ref[g],
                  log2 - 3, hs.cbf[g] & 1);
      a.tsf[cells[k]] = 0;
    }
  }
  HM_SYNC();
  HM_PH_STOP(ph(PH_COMMIT, log2), t_cm);
}

// four cell steps in z-order, then the 16x16 CU trial
HM_BIG float region16(const Walk& W, int g) {
  const Args& a = *W.ap;
  const int bw = a.w / 8, gw = a.w / 16;
  const int* c4 = a.cells16 + 4 * g;
  float cost8 = 0.f;
  for (int j = 0; j < 4; ++j) cost8 = HM_FADD(cost8, cell_step(W, c4[j]));
  const int gx = g % gw, gy = g / gw;
  HM_PH_START(t16);
  const LargeRes r = large_cu<4>(W, g, gx, gy, (gy * 2) * bw + gx * 2,
                                 a.nb16_cell + 5 * g, a.nb16_ok + 5 * g,
                                 a.t16, gw * (a.h / 16), a.h16);
  // split_cu_flag at the 16 depth (ctx from neighbour depths)
  const float cost16 = HM_FADD(r.cost, split_bits(a, 0, r.pr, gx, gy, 1));
  cost8 = HM_FADD(cost8, split_bits(a, 1, r.pr, gx, gy, 1));
  const bool win = cost16 < cost8;
  if (win) commit_large<4>(W, r, g, gx, gy, a.h16, c4, 4);
  HM_PH_STOP(PH_T16, t16);
  return win ? cost16 : cost8;
}

// four region16 steps, then the 32x32 CU trial where the region lies
// inside the picture (the padded grid's partial regions never form one)
HM_BIG void step32(const Walk& W, int g) {
  const Args& a = *W.ap;
  const int bw = a.w / 8, qw = (a.w / 16 + 1) / 2, qh = (a.h / 16 + 1) / 2;
  const int* c16 = a.c16_32 + 4 * g;
  float cost_sub = 0.f;
  for (int j = 0; j < 4; ++j)
    if (c16[j] >= 0) cost_sub = HM_FADD(cost_sub, region16(W, c16[j]));
  if (!a.full32[g]) return;
  const int gx = g % qw, gy = g / qw;
  HM_PH_START(t32);
  const LargeRes r = large_cu<5>(W, g, gx, gy, (gy * 4) * bw + gx * 4,
                                 a.nb32_cell + 5 * g, a.nb32_ok + 5 * g,
                                 a.t32, qw * qh, a.h32);
  const float cost32 = HM_FADD(r.cost, split_bits(a, 0, r.pr, gx, gy, 2));
  cost_sub = HM_FADD(cost_sub, split_bits(a, 1, r.pr, gx, gy, 2));
  if (cost32 < cost_sub)
    commit_large<5>(W, r, g, gx, gy, a.h32, a.c8_32 + 16 * g, 16);
  HM_PH_STOP(PH_T32, t32);
}

// lane `lane` of level `level`, the block's tid of nt threads; smem is
// the arena (SMEM_BYTES, 16-byte aligned)
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
  HM_PH_START(t_lane);
  if (a.geom == 8)
    cell_step(W, blk);
  else
    step32(W, blk);
  HM_PH_STOP(PH_LANE, t_lane);
}

}  // namespace pw
