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
// Block-cooperative (hm_port.cuh): every thread of a lane's block runs
// the same control flow and derives the same scalars (lists, costs) from
// the same reads; the per-sample loops are split over the threads, the
// SSE partial sums reduced by thread 0.  The lane's scratch (the
// candidates' predictions, the coded winner, the intra CU, the coding
// work area) lies in device memory; K10's working set in shared memory.
// The file also compiles as host C++ (one thread), which the CPU tests
// drive level by level.
#pragma once

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
// the lane's scratch (ints), sized for a 32x32 CU with MAXM candidates

constexpr int S_ORGY = 0;                   // the CU's source, raster
constexpr int S_ORGU = S_ORGY + 1024;
constexpr int S_ORGV = S_ORGU + 256;
constexpr int S_PREDY = S_ORGV + 256;       // per merge candidate
constexpr int S_PREDU = S_PREDY + MAXM * 1024;
constexpr int S_PREDV = S_PREDU + MAXM * 256;
constexpr int S_LEVY = S_PREDV + MAXM * 256;  // the merge winner, coded
constexpr int S_LEVU = S_LEVY + 1024;
constexpr int S_LEVV = S_LEVU + 256;
constexpr int S_RECY = S_LEVV + 256;
constexpr int S_RECU = S_RECY + 1024;
constexpr int S_RECV = S_RECU + 256;
constexpr int S_DZL = S_RECV + 256;         // a finalist's levels, rec
constexpr int S_DZR = S_DZL + 1024;
constexpr int S_PATCH = S_DZR + 1024;       // MC: 39 x 39 patch, 39 x 32
constexpr int S_TMP = S_PATCH + 39 * 39 + 1;
constexpr int S_IREF = S_TMP + 39 * 32;     // intra: 8x8 luma line,
constexpr int S_IREFF = S_IREF + 34;        // its filtered form,
constexpr int S_IREFU = S_IREFF + 34;       // the chroma lines
constexpr int S_IREFV = S_IREFU + 18;
constexpr int S_IPY = S_IREFV + 18;         // prediction, levels, rec
constexpr int S_IPU = S_IPY + 64;
constexpr int S_IPV = S_IPU + 16;
constexpr int S_ILY = S_IPV + 16;
constexpr int S_ILU = S_ILY + 64;
constexpr int S_ILV = S_ILU + 16;
constexpr int S_IRY = S_ILV + 16;
constexpr int S_IRU = S_IRY + 64;
constexpr int S_IRV = S_IRU + 16;
constexpr int RED_THREADS = 256;            // the SSE partial sums: 2 per
constexpr int S_RED = S_IRV + 16;           // thread and candidate (int64)
constexpr int S_SC = S_RED + 2 * 2 * MAXM * RED_THREADS;  // 3-plane SSEs
constexpr int S_W = S_SC + 2 * MAXM;        // the coding work area
constexpr int SCRATCH = S_W + wk::WORK_INTS;
static_assert(S_RED % 2 == 0 && SCRATCH % 2 == 0,
              "the int64 partial sums need 8-byte alignment");

struct Lane : wk::Lane {
  const Args* ap;
};

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
// merge RD (p_merge_all_rd)

struct MergeRes {
  float cost_skip, cost_merge;
  int mi_skip, mi_merge, cbf, ts;
  int sk_mvx, sk_mvy, sk_ref, mg_mvx, mg_mvy, mg_ref;
};

// the n x n block at (x0, y0) of reference r into out: luma and chroma
HM_BIG void mc_cu(Lane& L, int r, int x0, int y0, int mx, int my, int n,
                  int* py, int* pu, int* pv) {
  const Args& a = *L.ap;
  int* s = L.s;
  const int H = a.h, W = a.w, rr = iclamp(r, 0, a.R - 1);
  const size_t ly = (size_t)H * W, lc = (size_t)(H / 2) * (W / 2);
  mc_block<false>(a.refs_y + rr * ly, H, W, x0, y0, mx, my, n, n, 0, a.bd,
                  s + S_PATCH, s + S_TMP, py, L.tid, L.nt);
  mc_block<false>(a.refs_u + rr * lc, H / 2, W / 2, x0 / 2, y0 / 2, mx, my,
                  n / 2, n / 2, 1, a.bd, s + S_PATCH, s + S_TMP, pu, L.tid,
                  L.nt);
  mc_block<false>(a.refs_v + rr * lc, H / 2, W / 2, x0 / 2, y0 / 2, mx, my,
                  n / 2, n / 2, 1, a.bd, s + S_PATCH, s + S_TMP, pv, L.tid,
                  L.nt);
}

// every merge candidate predicted, skip priced by its 3-plane SSE, the F
// best by screening coded with deadzone quantisation, the winner recoded
// (the trellis when rdoq) into S_LEV* / S_REC*; the source is in S_ORG*
HM_BIG MergeRes merge_rd(Lane& L, int n, int log2, int x0, int y0,
                         const mvc::Motion* nb, const Cand& t, float b_skip1,
                         float b_inter) {
  const Args& a = *L.ap;
  int* s = L.s;
  const int M = a.max_merge, nn = n * n, nc = n / 2, ncc = nc * nc;
  int cmx[MAXM], cmy[MAXM], crf[MAXM];
  mvc::merge_list_p(nb, t.ok, t.mx, t.my, M, a.limit, cmx, cmy, crf);
  for (int m = 0; m < M; ++m)
    mc_cu(L, crf[m], x0, y0, cmx[m], cmy[m], n, s + S_PREDY + m * nn,
          s + S_PREDU + m * ncc, s + S_PREDV + m * ncc);

  // the 3-plane SSE per candidate: integer partial sums, thread 0 adds
  // them; float(ssd_y) + wchroma * float(ssd_u + ssd_v)
  long long* red = (long long*)(s + S_RED);
  const int nt = L.nt < RED_THREADS ? L.nt : RED_THREADS;
  for (int m = 0; m < M; ++m) {
    if (L.tid < nt) {
      long long py = 0, pc = 0;
      const int* p = s + S_PREDY + m * nn;
      for (int e = L.tid; e < nn; e += nt) {
        const long long d = s[S_ORGY + e] - p[e];
        py += d * d;
      }
      const int* pu = s + S_PREDU + m * ncc;
      const int* pv = s + S_PREDV + m * ncc;
      for (int e = L.tid; e < ncc; e += nt) {
        const long long du = s[S_ORGU + e] - pu[e];
        const long long dv = s[S_ORGV + e] - pv[e];
        pc += du * du + dv * dv;
      }
      red[(2 * m) * RED_THREADS + L.tid] = py;
      red[(2 * m + 1) * RED_THREADS + L.tid] = pc;
    }
  }
  HM_SYNC();
  float* sse3 = (float*)(s + S_SC);
  if (L.tid == 0) {
    for (int m = 0; m < M; ++m) {
      long long sy = 0, sc = 0;
      for (int k = 0; k < nt; ++k) {
        sy += red[(2 * m) * RED_THREADS + k];
        sc += red[(2 * m + 1) * RED_THREADS + k];
      }
      sse3[m] = HM_FADD((float)sy, HM_FMUL(a.wchroma, (float)sc));
    }
  }
  HM_SYNC();
  float bmi[MAXM], cost_sk[MAXM], screen[MAXM];
  for (int m = 0; m < M; ++m) {
    const float e = sse3[m];
    bmi[m] = merge_idx_bits(a, m);
    cost_sk[m] = HM_FADD(e, HM_FMUL(a.lam, HM_FADD(b_skip1, bmi[m])));
    screen[m] = HM_FADD(e, HM_FMUL(a.lam, bmi[m]));
  }
  MergeRes r;
  r.mi_skip = 0;
  for (int m = 1; m < M; ++m)
    if (cost_sk[m] < cost_sk[r.mi_skip]) r.mi_skip = m;
  r.cost_skip = cost_sk[r.mi_skip];

  // the finalists: the stable sort's first F = repeated first minima
  const int nf = M < F ? M : F;
  int fidx[F];
  for (int f = 0; f < nf; ++f) {
    int best = -1;
    for (int m = 0; m < M; ++m) {
      bool taken = false;
      for (int q = 0; q < f; ++q) taken = taken || fidx[q] == m;
      if (!taken && (best < 0 || screen[m] < screen[best])) best = m;
    }
    fidx[f] = best;
  }
  float cost_f[F];
  for (int f = 0; f < nf; ++f) {
    const int m = fidx[f];
    const TbRes ry = code_tb(L, log2, true, false, false, -1, a.lam, false,
                             0.f, s + S_ORGY, s + S_PREDY + m * nn,
                             s + S_DZL, s + S_DZR, 0, false);
    const TbRes ru = code_tb(L, log2 - 1, false, false, false, -1, a.lam_c,
                             true, a.wchroma, s + S_ORGU,
                             s + S_PREDU + m * ncc, s + S_DZL, s + S_DZR, 0,
                             false);
    const TbRes rv = code_tb(L, log2 - 1, false, false, false, -1, a.lam_c,
                             true, a.wchroma, s + S_ORGV,
                             s + S_PREDV + m * ncc, s + S_DZL, s + S_DZR, 0,
                             false);
    // (dY + dCb + dCr) + lam * ((((bmi + cbf) + bY) + bCb) + bCr)
    float b = HM_FADD(bmi[m], cbf_bits_inter(a, ry.nz, ru.nz, rv.nz));
    b = HM_FADD(HM_FADD(HM_FADD(b, ry.bits), ru.bits), rv.bits);
    cost_f[f] = HM_FADD(HM_FADD(HM_FADD(ry.sse, ru.sse), rv.sse),
                        HM_FMUL(a.lam, b));
  }
  int fi = 0;
  for (int f = 1; f < nf; ++f)
    if (cost_f[f] < cost_f[fi]) fi = f;
  const int wi = fidx[fi];
  r.mi_merge = wi;

  // the winner recoded; with transform skip its 4x4 chroma TBs both ways
  const bool tr = a.rdoq != 0;
  const TbRes ry = code_tb(L, log2, true, false, false, -1, a.lam, false, 0.f,
                           s + S_ORGY, s + S_PREDY + wi * nn, s + S_LEVY,
                           s + S_RECY, 0, tr);
  TbRes ru, rv;
  if (a.ts && log2 == 3) {
    ru = code_ts_sel(L, false, false, -1, a.lam_c, true, a.wchroma,
                     s + S_ORGU, s + S_PREDU + wi * ncc, s + S_LEVU,
                     s + S_RECU, tr);
    rv = code_ts_sel(L, false, false, -1, a.lam_c, true, a.wchroma,
                     s + S_ORGV, s + S_PREDV + wi * ncc, s + S_LEVV,
                     s + S_RECV, tr);
  } else {
    ru = code_tb(L, log2 - 1, false, false, false, -1, a.lam_c, true,
                 a.wchroma, s + S_ORGU, s + S_PREDU + wi * ncc, s + S_LEVU,
                 s + S_RECU, 0, tr);
    rv = code_tb(L, log2 - 1, false, false, false, -1, a.lam_c, true,
                 a.wchroma, s + S_ORGV, s + S_PREDV + wi * ncc, s + S_LEVV,
                 s + S_RECV, 0, tr);
  }
  r.cbf = ry.nz | (ru.nz << 1) | (rv.nz << 2);
  r.ts = ru.ts | (rv.ts << 1);
  // (dY + dU + dV) + lam * ((((hdr + cbf) + bY) + bU) + bV), hdr =
  // (b_inter + merge_flag) + merge_idx
  const float hdr =
      HM_FADD(HM_FADD(b_inter, cbv(a, a.ctx[C_MERGE_FLAG], 1)), bmi[wi]);
  float b = HM_FADD(hdr, cbf_bits_inter(a, ry.nz, ru.nz, rv.nz));
  b = HM_FADD(HM_FADD(HM_FADD(b, ry.bits), ru.bits), rv.bits);
  r.cost_merge = HM_FADD(HM_FADD(HM_FADD(ry.sse, ru.sse), rv.sse),
                         HM_FMUL(a.lam, b));
  // an all-zero-residual merge IS skip with one extra flag
  if (!r.cbf) r.cost_merge = BIG;
  r.sk_mvx = cmx[r.mi_skip];
  r.sk_mvy = cmy[r.mi_skip];
  r.sk_ref = crf[r.mi_skip];
  r.mg_mvx = cmx[wi];
  r.mg_mvy = cmy[wi];
  r.mg_ref = crf[wi];
  return r;
}

// ---------------------------------------------------------------------------
// the steps

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

// one 8x8 CU: returns the least of its four costs; commits its decision
HM_BIG float cell_step(Lane& L, int b) {
  const Args& a = *L.ap;
  int* s = L.s;
  const int bw = a.w / 8, P = bw * (a.h / 8), byi = b / bw, bxi = b % bw;
  const int x0 = bxi * 8, y0 = byi * 8;
  copy_block(L, a.org_y, a.w, x0, y0, 8, s + S_ORGY);
  copy_block(L, a.org_u, a.w / 2, x0 / 2, y0 / 2, 4, s + S_ORGU);
  copy_block(L, a.org_v, a.w / 2, x0 / 2, y0 / 2, 4, s + S_ORGV);
  mvc::Motion nb[5];
  neighbours(a, a.nb_flat + 5 * b, a.nb_ok + 5 * b, nb);
  const Prices pr = mode_prices(a, b, bxi, byi);
  const float b_common = HM_FADD(pr.b_skip0, cbv(a, a.ctx[C_PART], 1));
  const float b_inter = HM_FADD(b_common, cbv(a, a.ctx[C_PRED_MODE], 0));
  const Cand t = t_cand(a.t8, P, b);
  const MergeRes mr = merge_rd(L, 8, 3, x0, y0, nb, t, pr.b_skip1, b_inter);

  const Hoist& h8 = a.h8;
  const int aref = h8.ref[b], amx = h8.mvx[b], amy = h8.mvy[b];
  const Amvp am = amvp(a, nb, aref, amx, amy, t);
  const float cost_amvp = amvp_cost(a, h8, b, b_inter, am);

  const float inter_best =
      fminf(mr.cost_skip, fminf(mr.cost_merge, cost_amvp));
  float cost_intra = BIG;
  int icbf = 0, its = 0;
  if (!(inter_best <= HM_FMUL(INTRA_GATE, a.lam))) {
    // intra: the open-loop mode predicted from the committed samples
    const int im = a.imode[b];
    gather_line(L, a.rec_y, a.g8s + b * 33, a.g8n[b], 33, s + S_IREF);
    for (int k = L.tid; k < 33; k += L.nt)
      s[S_IREFF + k] = filter_sample(s + S_IREF, k, 8, a.bd, 0);
    gather_line(L, a.rec_u, a.g4s + b * 17, a.g4n[b], 17, s + S_IREFU);
    gather_line(L, a.rec_v, a.g4s + b * 17, a.g4n[b], 17, s + S_IREFV);
    predict(L, s + S_IREF, s + S_IREFF, im, 8, 1, s + S_IPY);
    predict(L, s + S_IREFU, s + S_IREFU, im, 4, 0, s + S_IPU);
    predict(L, s + S_IREFV, s + S_IREFV, im, 4, 0, s + S_IPV);
    const int sel = scan_sel(im);
    const bool tr = a.rdoq != 0;
    const TbRes ry = code_tb(L, 3, true, false, false, sel, a.lam, false, 0.f,
                             s + S_ORGY, s + S_IPY, s + S_ILY, s + S_IRY, 0,
                             tr);
    TbRes ru, rv;
    if (a.ts) {
      ru = code_ts_sel(L, false, false, sel, a.lam_c, true, a.wchroma,
                       s + S_ORGU, s + S_IPU, s + S_ILU, s + S_IRU, tr);
      rv = code_ts_sel(L, false, false, sel, a.lam_c, true, a.wchroma,
                       s + S_ORGV, s + S_IPV, s + S_ILV, s + S_IRV, tr);
    } else {
      ru = code_tb(L, 2, false, false, false, sel, a.lam_c, true, a.wchroma,
                   s + S_ORGU, s + S_IPU, s + S_ILU, s + S_IRU, 0, tr);
      rv = code_tb(L, 2, false, false, false, sel, a.lam_c, true, a.wchroma,
                   s + S_ORGV, s + S_IPV, s + S_ILV, s + S_IRV, 0, tr);
    }
    icbf = ry.nz | (ru.nz << 1) | (rv.nz << 2);
    its = ru.ts | (rv.ts << 1);
    const int* l_blk = pr.l_blk;
    const int* a_blk = pr.a_blk;
    const int lmode = (bxi > 0 && l_blk[K_KIND] == 3) ? a.imode[b - 1] : 1;
    const bool am_ok = byi > 0 && (y0 & ((1 << a.log2_ctu) - 1)) != 0;
    const int amode = (am_ok && a_blk[K_KIND] == 3) ? a.imode[b - bw] : 1;
    const float b_icbf = HM_FADD(
        HM_FADD(cbf_chroma(a, ru.nz), cbf_chroma(a, rv.nz)),
        cbf_luma(a, ry.nz));
    // (dY + dU + dV) + lam * ((((((b_common + pred_mode) + mpm) + dm) +
    // cbf) + bY) + bU) + bV)
    float bs = HM_FADD(b_common, cbv(a, a.ctx[C_PRED_MODE], 1));
    bs = HM_FADD(bs, mpm_bits(a.cb, a.ctx[C_IPM], im, lmode, amode));
    bs = HM_FADD(bs, cbv(a, a.ctx[C_CHROMA_DM], 0));
    bs = HM_FADD(bs, b_icbf);
    bs = HM_FADD(HM_FADD(HM_FADD(bs, ry.bits), ru.bits), rv.bits);
    cost_intra = HM_FADD(HM_FADD(HM_FADD(ry.sse, ru.sse), rv.sse),
                         HM_FMUL(a.lam, bs));
  }

  const float costs[4] = {mr.cost_skip, mr.cost_merge, cost_amvp,
                          cost_intra};
  int choice = 0;
  for (int c = 1; c < 4; ++c)
    if (costs[c] < costs[choice]) choice = c;
  if (choice == 1 && !mr.cbf) choice = 0;
  const int mi = choice == 0 ? mr.mi_skip : mr.mi_merge;

  // commit: reconstruction, levels, the row, the TS flags
  const int ms = mr.mi_skip;
  const int* ry = choice == 0 ? s + S_PREDY + ms * 64
                  : choice == 1 ? s + S_RECY
                  : choice == 2 ? h8.rec_y + b * 64
                                : s + S_IRY;
  const int* ru = choice == 0 ? s + S_PREDU + ms * 16
                  : choice == 1 ? s + S_RECU
                  : choice == 2 ? h8.rec_u + b * 16
                                : s + S_IRU;
  const int* rv = choice == 0 ? s + S_PREDV + ms * 16
                  : choice == 1 ? s + S_RECV
                  : choice == 2 ? h8.rec_v + b * 16
                                : s + S_IRV;
  for (int e = L.tid; e < 64; e += L.nt)
    a.rec_y[(y0 + e / 8) * a.w + x0 + e % 8] = ry[e];
  for (int e = L.tid; e < 16; e += L.nt) {
    const int o = (y0 / 2 + e / 4) * (a.w / 2) + x0 / 2 + e % 4;
    a.rec_u[o] = ru[e];
    a.rec_v[o] = rv[e];
  }
  for (int e = L.tid; e < 96; e += L.nt) {
    int v = 0;
    if (choice == 1)
      v = e < 64 ? s[S_LEVY + e] : e < 80 ? s[S_LEVU + e - 64]
                                          : s[S_LEVV + e - 80];
    else if (choice == 2)
      v = h8.lev[b * 96 + e];
    else if (choice == 3)
      v = e < 64 ? s[S_ILY + e] : e < 80 ? s[S_ILU + e - 64]
                                         : s[S_ILV + e - 80];
    a.levs[b * 96 + e] = v;
  }
  if (L.tid == 0) {
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
// grid position (gx, gy), from the committed state outside the region
HM_BIG LargeRes large_cu(Lane& L, int g, int gx, int gy, int corner, int n,
                         int log2, const int* nb_idx, const int* nb_ok,
                         const int* tl, int npos, const Hoist& hs) {
  const Args& a = *L.ap;
  int* s = L.s;
  const int x0 = gx * n, y0 = gy * n;
  copy_block(L, a.org_y, a.w, x0, y0, n, s + S_ORGY);
  copy_block(L, a.org_u, a.w / 2, x0 / 2, y0 / 2, n / 2, s + S_ORGU);
  copy_block(L, a.org_v, a.w / 2, x0 / 2, y0 / 2, n / 2, s + S_ORGV);
  mvc::Motion nb[5];
  neighbours(a, nb_idx, nb_ok, nb);
  LargeRes r;
  r.pr = mode_prices(a, corner, gx, gy);
  const float b_inter =
      HM_FADD(HM_FADD(r.pr.b_skip0, cbv(a, a.ctx[C_PART], 1)),
              cbv(a, a.ctx[C_PRED_MODE], 0));
  const Cand t = t_cand(tl, npos, g);
  r.mr = merge_rd(L, n, log2, x0, y0, nb, t, r.pr.b_skip1, b_inter);
  r.am = amvp(a, nb, hs.ref[g], hs.mvx[g], hs.mvy[g], t);
  const float costs[3] = {r.mr.cost_skip, r.mr.cost_merge,
                          amvp_cost(a, hs, g, b_inter, r.am)};
  r.c = 0;
  for (int c = 1; c < 3; ++c)
    if (costs[c] < costs[r.c]) r.c = c;
  if (r.c == 1 && !r.mr.cbf) r.c = 0;
  r.cost = fminf(costs[0], fminf(costs[1], costs[2]));
  return r;
}

// commit a large CU trial to its `ncell` cells (`cells` in z-order)
HM_BIG void commit_large(Lane& L, const LargeRes& r, int g, int gx, int gy,
                         int n, int log2, const Hoist& hs, const int* cells,
                         int ncell) {
  const Args& a = *L.ap;
  int* s = L.s;
  const int x0 = gx * n, y0 = gy * n, nn = n * n, nc = n / 2, ncc = nc * nc;
  const int c = r.c, ms = r.mr.mi_skip;
  const int* ry = c == 0 ? s + S_PREDY + ms * nn
                  : c == 1 ? s + S_RECY : hs.rec_y + (size_t)g * nn;
  const int* ru = c == 0 ? s + S_PREDU + ms * ncc
                  : c == 1 ? s + S_RECU : hs.rec_u + (size_t)g * ncc;
  const int* rv = c == 0 ? s + S_PREDV + ms * ncc
                  : c == 1 ? s + S_RECV : hs.rec_v + (size_t)g * ncc;
  for (int e = L.tid; e < nn; e += L.nt)
    a.rec_y[(y0 + e / n) * a.w + x0 + e % n] = ry[e];
  for (int e = L.tid; e < ncc; e += L.nt) {
    const int o = (y0 / 2 + e / nc) * (a.w / 2) + x0 / 2 + e % nc;
    a.rec_u[o] = ru[e];
    a.rec_v[o] = rv[e];
  }
  // levs: the flat [Y | U | V] cut into 96-value slabs, one per cell in
  // `cells` order
  const int tot = nn + 2 * ncc;
  for (int e = L.tid; e < tot; e += L.nt) {
    int v = 0;
    if (c == 1)
      v = e < nn ? s[S_LEVY + e] : e < nn + ncc ? s[S_LEVU + e - nn]
                                                : s[S_LEVV + e - nn - ncc];
    else if (c == 2)
      v = hs.lev[(size_t)g * tot + e];
    a.levs[cells[e / 96] * 96 + e % 96] = v;
  }
  if (L.tid == 0) {
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
}

// four cell steps in z-order, then the 16x16 CU trial
HM_BIG float region16(Lane& L, int g) {
  const Args& a = *L.ap;
  const int bw = a.w / 8, gw = a.w / 16;
  const int* c4 = a.cells16 + 4 * g;
  float cost8 = 0.f;
  for (int j = 0; j < 4; ++j) cost8 = HM_FADD(cost8, cell_step(L, c4[j]));
  const int gx = g % gw, gy = g / gw;
  const LargeRes r = large_cu(L, g, gx, gy, (gy * 2) * bw + gx * 2, 16, 4,
                              a.nb16_cell + 5 * g, a.nb16_ok + 5 * g, a.t16,
                              gw * (a.h / 16), a.h16);
  // split_cu_flag at the 16 depth (ctx from neighbour depths)
  const float cost16 = HM_FADD(r.cost, split_bits(a, 0, r.pr, gx, gy, 1));
  cost8 = HM_FADD(cost8, split_bits(a, 1, r.pr, gx, gy, 1));
  if (!(cost16 < cost8)) return cost8;
  commit_large(L, r, g, gx, gy, 16, 4, a.h16, c4, 4);
  return cost16;
}

// four region16 steps, then the 32x32 CU trial where the region lies
// inside the picture (the padded grid's partial regions never form one)
HM_BIG void step32(Lane& L, int g) {
  const Args& a = *L.ap;
  const int bw = a.w / 8, qw = (a.w / 16 + 1) / 2, qh = (a.h / 16 + 1) / 2;
  const int* c16 = a.c16_32 + 4 * g;
  float cost_sub = 0.f;
  for (int j = 0; j < 4; ++j)
    if (c16[j] >= 0) cost_sub = HM_FADD(cost_sub, region16(L, c16[j]));
  if (!a.full32[g]) return;
  const int gx = g % qw, gy = g / qw;
  const LargeRes r = large_cu(L, g, gx, gy, (gy * 4) * bw + gx * 4, 32, 5,
                              a.nb32_cell + 5 * g, a.nb32_ok + 5 * g, a.t32,
                              qw * qh, a.h32);
  const float cost32 = HM_FADD(r.cost, split_bits(a, 0, r.pr, gx, gy, 2));
  cost_sub = HM_FADD(cost_sub, split_bits(a, 1, r.pr, gx, gy, 2));
  if (cost32 < cost_sub)
    commit_large(L, r, g, gx, gy, 32, 5, a.h32, a.c8_32 + 16 * g, 16);
}

// lane `lane` of level `level`: smem is K10's working set (8-byte
// aligned, rdoq_smem_bytes of the geometry's largest TB)
HM_BIG void walk_lane(const Args& a, int level, int lane, int tid, int nt,
                      void* smem) {
  const int blk = a.lv[level * a.bmax + lane];
  if (blk < 0) return;   // a padding lane does nothing
  Lane L;
  L.ap = &a;
  L.cd = &a.cd;
  L.tid = tid;
  L.nt = nt;
  L.S = rdoq_smem(smem, 1 << (2 * (a.geom == 8 ? 3 : 5)));
  L.s = a.scratch + (size_t)lane * SCRATCH;
  L.work = L.s + S_W;
  if (a.geom == 8)
    cell_step(L, blk);
  else
    step32(L, blk);
}

}  // namespace pw
