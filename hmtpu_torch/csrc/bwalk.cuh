// K26 b_walk's lane code: one lane of one z-scan dependency level of the
// B-slice decision pass, the port of hmtpu/encoder/pframe_dev.py:255
// wavefront_pass in its B form (`merge_b_nxn` :411, `merge_b_winner`
// :446, `amvp_b_nxn` :487, the B branches of `cell_step` :732, :807, :879,
// :919, `region16` :1065, :1121, :1177 and `step32` :1338, :1394, :1449,
// the hoisted 16 and 32 levels :971, :987, :1241, :1263) as the port's
// plain version (hmtpu_torch/encoder/pframe_dev.py `wavefront_pass_plain`:
// `b_merge_rd`, `merge_b_nxn`, `merge_b_winner`, `amvp_cu`) runs it.
//
// The structure is the P walk's (the cell step, the 16x16 and 32x32
// trials, region16, step32 and their commits), on the whole block with
// the lane's device scratch; what differs in a B slice:
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
//              the inter_pred_idc bits at the CU's depth;
//   state      the seven motion columns (dir, L0, L1) of the chosen
//              hypothesis; no transform skip and no TMVP in B slices.
// The syntax-flag prices are pwalk.cuh's table reads (B8's helpers).
//
// The arguments are K23's (pw::Args, its transform-skip flag 0 and its
// temporal grids null) followed by the B slice's: the list maps, the
// list-1 POCs, the hoisted hypotheses' lists.  The lane's device scratch
// is this file's S_* layout.
// Block-cooperative (hm_port.cuh); compiles as host C++ (one thread) for
// the CPU tests.
#pragma once

#include "bi_pred.cuh"
#include "pwalk.cuh"

namespace bw {

using namespace hm;
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
using wk::gather_line;
using wk::predict;
using wk::scan_sel;

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

// the lane's device scratch (ints), sized for a 32x32 CU with MAXM
// candidates: the source, the candidates' predictions (the winner's exact
// prediction in the first candidate's slots), the coded winner, the MC
// and intra work areas, the SSE partial sums, the coding work area, then
// both lists' luma hypotheses of every candidate and the bi winner's
// chroma hypotheses of one plane

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
constexpr int S_I0 = S_W + wk::WORK_INTS;
constexpr int S_I1 = S_I0 + MAXM * 1024;
constexpr int S_CI = S_I1 + MAXM * 1024;
constexpr int SCRATCH = S_CI + 2 * 256;
static_assert(S_RED % 2 == 0 && SCRATCH % 2 == 0,
              "the int64 partial sums need 8-byte alignment in every "
              "lane's scratch");

struct Lane : wk::Lane {
  const pw::Args* ap;  // K23's arguments (bp->p)
  const Args* bp;
};

// the n x n block at (x0, y0) of reference r into py, pu, pv: luma and
// chroma, the whole block
HM_BIG void mc_cu(Lane& L, int r, int x0, int y0, int mx, int my, int n,
                  int* py, int* pu, int* pv) {
  const pw::Args& a = *L.ap;
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

// ---------------------------------------------------------------------------
// merge RD (b_merge_rd)

struct MergeRes {
  float cost_skip, cost_merge;
  int mi, cbf;
  Mot w;  // the winner's motion (skip and merge alike)
};

// the luma SSE (sy) and the chroma pair's (sc) of (py, pu, pv) against
// the source in S_ORG*, exact: per-thread int64 partials, thread 0 sums
HM_FN void sse3(Lane& L, int n, const int* py, const int* pu, const int* pv,
                long long* sy, long long* sc) {
  int* s = L.s;
  long long* red = (long long*)(s + S_RED);
  const int nt = L.nt < RED_THREADS ? L.nt : RED_THREADS;
  const int nn = n * n, ncc = nn / 4;
  if (L.tid < nt) {
    long long a = 0, c = 0;
    for (int e = L.tid; e < nn; e += nt) {
      const long long d = s[S_ORGY + e] - py[e];
      a += d * d;
    }
    for (int e = L.tid; e < ncc; e += nt) {
      const long long du = s[S_ORGU + e] - pu[e];
      const long long dv = s[S_ORGV + e] - pv[e];
      c += du * du + dv * dv;
    }
    red[L.tid] = a;
    red[RED_THREADS + L.tid] = c;
  }
  HM_SYNC();
  if (L.tid == 0) {
    long long a = 0, c = 0;
    for (int k = 0; k < nt; ++k) {
      a += red[k];
      c += red[RED_THREADS + k];
    }
    red[2 * RED_THREADS] = a;
    red[2 * RED_THREADS + 1] = c;
  }
  HM_SYNC();
  *sy = red[2 * RED_THREADS];
  *sc = red[2 * RED_THREADS + 1];
  HM_SYNC();
}

// the n x n hypothesis of plane (H x W planes, union index u) at
// intermediate precision into out
HM_FN void hyp(Lane& L, const int* planes, int H, int W, int u, int x0,
               int y0, int mx, int my, int n, int chroma, int* out) {
  const pw::Args& a = *L.ap;
  int* s = L.s;
  mc_block<true>(planes + (size_t)iclamp(u, 0, a.R - 1) * H * W, H, W, x0,
                 y0, mx, my, n, n, chroma, a.bd, s + S_PATCH,
                 s + S_TMP, out, L.tid, L.nt);
}

// every candidate of the B merge list hypothesised and screened, the
// winner predicted exactly into S_PRED* (first slots), priced as skip and
// coded once (the trellis when rdoq) into S_LEV* / S_REC*; the source is
// in S_ORG*
HM_BIG MergeRes b_merge_rd(Lane& L, int n, int log2, int x0, int y0,
                           const mvc::Motion* nb, float b_skip1,
                           float b_inter) {
  const Args& b = *L.bp;
  const pw::Args& a = b.p;
  int* s = L.s;
  const int M = a.max_merge, nn = n * n, nc = n / 2, ncc = nc * nc;
  const int H = a.h, W = a.w;
  int c[7][MAXM];  // dir, mvx0, mvy0, ref0, mvx1, mvy1, ref1
  mvc::merge_list_b(nb, a.ref_pocs, b.ref_pocs_l1, a.num_ref, b.num_ref_l1,
                    M, c[0], c[1], c[2], c[3], c[4], c[5], c[6]);
  // the hypotheses each candidate's screening reads
  for (int m = 0; m < M; ++m) {
    if (c[0][m] & 1)
      hyp(L, a.refs_y, H, W, union_idx(b, c[3][m], 0), x0, y0, c[1][m],
          c[2][m], n, 0, s + S_I0 + m * nn);
    if (c[0][m] & 2)
      hyp(L, a.refs_y, H, W, union_idx(b, c[6][m], 1), x0, y0, c[4][m],
          c[5][m], n, 0, s + S_I1 + m * nn);
  }
  // the screening: float(luma SSE) + lam * merge_idx bits, first minimum
  long long* red = (long long*)(s + S_RED);
  const int nt = L.nt < RED_THREADS ? L.nt : RED_THREADS;
  for (int m = 0; m < M; ++m) {
    if (L.tid < nt) {
      long long acc = 0;
      const int *p0 = s + S_I0 + m * nn, *p1 = s + S_I1 + m * nn;
      for (int e = L.tid; e < nn; e += nt) {
        const long long d =
            s[S_ORGY + e] - bi_pred_sample(p0[e], p1[e], c[0][m], a.bd);
        acc += d * d;
      }
      red[m * RED_THREADS + L.tid] = acc;
    }
  }
  HM_SYNC();
  float* sse = (float*)(s + S_SC);
  if (L.tid == 0) {
    for (int m = 0; m < M; ++m) {
      long long t = 0;
      for (int k = 0; k < nt; ++k) t += red[m * RED_THREADS + k];
      sse[m] = (float)t;
    }
  }
  HM_SYNC();
  float bmi[MAXM];
  int mi = 0;
  float best = 0.f;
  for (int m = 0; m < M; ++m) {
    bmi[m] = pw::merge_idx_bits(a, m);
    const float e = HM_FADD(sse[m], HM_FMUL(a.lam, bmi[m]));
    if (m == 0 || e < best) {
      best = e;
      mi = m;
    }
  }

  // the winner's exact prediction
  MergeRes r;
  r.mi = mi;
  r.w = Mot{c[0][mi], c[1][mi], c[2][mi], c[3][mi],
            c[4][mi], c[5][mi], c[6][mi]};
  const Mot& w = r.w;
  const int u0 = union_idx(b, w.ref, 0), u1 = union_idx(b, w.ref1, 1);
  int* py = s + S_PREDY;
  int* pu = s + S_PREDU;
  int* pv = s + S_PREDV;
  if (w.dir == 3) {
    const int *p0 = s + S_I0 + mi * nn, *p1 = s + S_I1 + mi * nn;
    for (int e = L.tid; e < nn; e += L.nt)
      py[e] = bi_pred_sample(p0[e], p1[e], 3, a.bd);
    const int* cpl[2] = {a.refs_u, a.refs_v};
    int* cout[2] = {pu, pv};
    for (int k = 0; k < 2; ++k) {
      hyp(L, cpl[k], H / 2, W / 2, u0, x0 / 2, y0 / 2, w.mvx, w.mvy, nc, 1,
          s + S_CI);
      hyp(L, cpl[k], H / 2, W / 2, u1, x0 / 2, y0 / 2, w.mvx1, w.mvy1, nc, 1,
          s + S_CI + 256);
      for (int e = L.tid; e < ncc; e += L.nt)
        cout[k][e] = bi_pred_sample(s[S_CI + e], s[S_CI + 256 + e], 3, a.bd);
      HM_SYNC();
    }
  } else {
    const bool l0 = (w.dir & 1) != 0;
    mc_cu(L, l0 ? u0 : u1, x0, y0, l0 ? w.mvx : w.mvx1,
              l0 ? w.mvy : w.mvy1, n, py, pu, pv);
  }
  long long sy, sc;
  sse3(L, n, py, pu, pv, &sy, &sc);
  const float msse3 = HM_FADD((float)sy, HM_FMUL(a.wchroma, (float)sc));

  // the winner coded once
  const bool tr = a.rdoq != 0;
  const TbRes ry = code_tb(L, log2, true, false, false, -1, a.lam, false, 0.f,
                           s + S_ORGY, py, s + S_LEVY,
                           s + S_RECY, tr);
  const TbRes ru = code_tb(L, log2 - 1, false, false, false, -1, a.lam_c,
                           true, a.wchroma, s + S_ORGU, pu,
                           s + S_LEVU, s + S_RECU, tr);
  const TbRes rv = code_tb(L, log2 - 1, false, false, false, -1, a.lam_c,
                           true, a.wchroma, s + S_ORGV, pv,
                           s + S_LEVV, s + S_RECV, tr);
  r.cbf = ry.nz | (ru.nz << 1) | (rv.nz << 2);
  // skip: msse3 + lam * (b_skip1 + merge_idx)
  r.cost_skip = HM_FADD(msse3, HM_FMUL(a.lam, HM_FADD(b_skip1, bmi[mi])));
  // merge: (dY + dU + dV) + lam * ((((((b_inter + merge_flag) + merge_idx)
  // + cbf) + bY) + bU) + bV)
  float bs = HM_FADD(HM_FADD(b_inter, cbv(a, a.ctx[pw::C_MERGE_FLAG], 1)),
                     bmi[mi]);
  bs = HM_FADD(bs, pw::cbf_bits_inter(a, ry.nz, ru.nz, rv.nz));
  bs = HM_FADD(HM_FADD(HM_FADD(bs, ry.bits), ru.bits), rv.bits);
  r.cost_merge = HM_FADD(HM_FADD(HM_FADD(ry.sse, ru.sse), rv.sse),
                         HM_FMUL(a.lam, bs));
  return r;
}

// ---------------------------------------------------------------------------
// the steps

HM_FN void write_row(int* row, int kind, int mi, const Amvp& am,
                     const Mot& m, int sz, int cbfy) {
  const int v[pw::NCOL] = {kind,   mi,    am.mvdx, am.mvdy, am.mvpi,
                           m.dir,  m.mvx, m.mvy,   m.ref,   sz,
                           cbfy,   m.mvx1, m.mvy1, m.ref1};
  for (int c = 0; c < pw::NCOL; ++c) row[c] = v[c];
}

// one 8x8 CU: returns the least of its four costs; commits its decision
HM_BIG float cell_step(Lane& L, int blk) {
  const Args& b = *L.bp;
  const pw::Args& a = b.p;
  int* s = L.s;
  const int bw = a.w / 8, byi = blk / bw, bxi = blk % bw;
  const int x0 = bxi * 8, y0 = byi * 8;
  copy_block(L, a.org_y, a.w, x0, y0, 8, s + S_ORGY);
  copy_block(L, a.org_u, a.w / 2, x0 / 2, y0 / 2, 4, s + S_ORGU);
  copy_block(L, a.org_v, a.w / 2, x0 / 2, y0 / 2, 4, s + S_ORGV);
  mvc::Motion nb[5];
  pw::neighbours(a, a.nb_flat + 5 * blk, a.nb_ok + 5 * blk, nb);
  const Prices pr = pw::mode_prices(a, blk, bxi, byi);
  const float b_common = HM_FADD(pr.b_skip0, cbv(a, a.ctx[pw::C_PART], 1));
  const float b_inter =
      HM_FADD(b_common, cbv(a, a.ctx[pw::C_PRED_MODE], 0));
  const MergeRes mr = b_merge_rd(L, 8, 3, x0, y0, nb, pr.b_skip1, b_inter);

  const Hoist& h8 = a.h8;
  const int lx = b.lx8[blk], aref = h8.ref[blk];
  const Amvp am = amvp_b(b, nb, lx, aref, h8.mvx[blk], h8.mvy[blk],
                         a.log2_ctu - 3);
  const float cost_amvp = pw::amvp_cost(a, h8, blk, b_inter, am);

  const float inter_best =
      fminf(mr.cost_skip, fminf(mr.cost_merge, cost_amvp));
  float cost_intra = BIG;
  int icbf = 0;
  if (!(inter_best <= HM_FMUL(INTRA_GATE, a.lam))) {
    // intra: the open-loop mode predicted from the committed samples
    const int im = a.imode[blk];
    gather_line(L, a.rec_y, a.g8s + blk * 33, a.g8n[blk], 33, s + S_IREF);
    for (int k = L.tid; k < 33; k += L.nt)
      s[S_IREFF + k] = filter_sample(s + S_IREF, k, 8, a.bd, 0);
    gather_line(L, a.rec_u, a.g4s + blk * 17, a.g4n[blk], 17,
                s + S_IREFU);
    gather_line(L, a.rec_v, a.g4s + blk * 17, a.g4n[blk], 17,
                s + S_IREFV);
    predict(L, s + S_IREF, s + S_IREFF, im, 8, 1, s + S_IPY);
    predict(L, s + S_IREFU, s + S_IREFU, im, 4, 0, s + S_IPU);
    predict(L, s + S_IREFV, s + S_IREFV, im, 4, 0, s + S_IPV);
    const int sel = scan_sel(im);
    const bool tr = a.rdoq != 0;
    const TbRes ry = code_tb(L, 3, true, false, false, sel, a.lam, false, 0.f,
                             s + S_ORGY, s + S_IPY, s + S_ILY,
                             s + S_IRY, tr);
    const TbRes ru = code_tb(L, 2, false, false, false, sel, a.lam_c, true,
                             a.wchroma, s + S_ORGU, s + S_IPU,
                             s + S_ILU, s + S_IRU, tr);
    const TbRes rv = code_tb(L, 2, false, false, false, sel, a.lam_c, true,
                             a.wchroma, s + S_ORGV, s + S_IPV,
                             s + S_ILV, s + S_IRV, tr);
    icbf = ry.nz | (ru.nz << 1) | (rv.nz << 2);
    const int lmode =
        (bxi > 0 && pr.l_blk[pw::K_KIND] == 3) ? a.imode[blk - 1] : 1;
    const bool am_ok = byi > 0 && (y0 & ((1 << a.log2_ctu) - 1)) != 0;
    const int amode =
        (am_ok && pr.a_blk[pw::K_KIND] == 3) ? a.imode[blk - bw] : 1;
    const float b_icbf = HM_FADD(
        HM_FADD(pw::cbf_chroma(a, ru.nz), pw::cbf_chroma(a, rv.nz)),
        pw::cbf_luma(a, ry.nz));
    // (dY + dU + dV) + lam * ((((((b_common + pred_mode) + mpm) + dm) +
    // cbf) + bY) + bU) + bV)
    float bs = HM_FADD(b_common, cbv(a, a.ctx[pw::C_PRED_MODE], 1));
    bs = HM_FADD(bs, mpm_bits(a.cb, a.ctx[pw::C_IPM], im, lmode, amode));
    bs = HM_FADD(bs, cbv(a, a.ctx[pw::C_CHROMA_DM], 0));
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

  // commit: reconstruction, levels, the row (no transform skip)
  const int* ry = choice == 0 ? s + S_PREDY
                  : choice == 1 ? s + S_RECY
                  : choice == 2 ? h8.rec_y + blk * 64
                                : s + S_IRY;
  const int* ru = choice == 0 ? s + S_PREDU
                  : choice == 1 ? s + S_RECU
                  : choice == 2 ? h8.rec_u + blk * 16
                                : s + S_IRU;
  const int* rv = choice == 0 ? s + S_PREDV
                  : choice == 1 ? s + S_RECV
                  : choice == 2 ? h8.rec_v + blk * 16
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
      v = h8.lev[blk * 96 + e];
    else if (choice == 3)
      v = e < 64 ? s[S_ILY + e] : e < 80 ? s[S_ILU + e - 64]
                                             : s[S_ILV + e - 80];
    a.levs[blk * 96 + e] = v;
  }
  if (L.tid == 0) {
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

// one n x n inter CU trial (skip / merge / the hoisted AMVP of list lx[g],
// one TU) at grid position (gx, gy), from the committed state outside
// the region
HM_BIG LargeRes large_cu(Lane& L, int g, int gx, int gy, int corner, int n,
                         int log2, const int* nb_idx, const int* nb_ok,
                         const Hoist& hs, const int* lx) {
  const Args& b = *L.bp;
  const pw::Args& a = b.p;
  int* s = L.s;
  const int x0 = gx * n, y0 = gy * n;
  copy_block(L, a.org_y, a.w, x0, y0, n, s + S_ORGY);
  copy_block(L, a.org_u, a.w / 2, x0 / 2, y0 / 2, n / 2, s + S_ORGU);
  copy_block(L, a.org_v, a.w / 2, x0 / 2, y0 / 2, n / 2, s + S_ORGV);
  mvc::Motion nb[5];
  pw::neighbours(a, nb_idx, nb_ok, nb);
  LargeRes r;
  r.pr = pw::mode_prices(a, corner, gx, gy);
  const float b_inter =
      HM_FADD(HM_FADD(r.pr.b_skip0, cbv(a, a.ctx[pw::C_PART], 1)),
              cbv(a, a.ctx[pw::C_PRED_MODE], 0));
  r.mr = b_merge_rd(L, n, log2, x0, y0, nb, r.pr.b_skip1, b_inter);
  r.am = amvp_b(b, nb, lx[g], hs.ref[g], hs.mvx[g], hs.mvy[g],
                a.log2_ctu - log2);
  const float costs[3] = {r.mr.cost_skip, r.mr.cost_merge,
                          pw::amvp_cost(a, hs, g, b_inter, r.am)};
  r.c = 0;
  for (int c = 1; c < 3; ++c)
    if (costs[c] < costs[r.c]) r.c = c;
  if (r.c == 1 && !r.mr.cbf) r.c = 0;
  r.cost = fminf(costs[0], fminf(costs[1], costs[2]));
  return r;
}

// commit a large CU trial to its `ncell` cells (`cells` in z-order)
HM_BIG void commit_large(Lane& L, const LargeRes& r, int g, int gx, int gy,
                         int n, int log2, const Hoist& hs, const int* lx,
                         const int* cells, int ncell) {
  const pw::Args& a = L.bp->p;
  int* s = L.s;
  const int x0 = gx * n, y0 = gy * n, nn = n * n, nc = n / 2, ncc = nc * nc;
  const int c = r.c;
  const int* ry = c == 0 ? s + S_PREDY
                  : c == 1 ? s + S_RECY : hs.rec_y + (size_t)g * nn;
  const int* ru = c == 0 ? s + S_PREDU
                  : c == 1 ? s + S_RECU : hs.rec_u + (size_t)g * ncc;
  const int* rv = c == 0 ? s + S_PREDV
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
      v = e < nn ? s[S_LEVY + e]
                 : e < nn + ncc ? s[S_LEVU + e - nn]
                                : s[S_LEVV + e - nn - ncc];
    else if (c == 2)
      v = hs.lev[(size_t)g * tot + e];
    a.levs[cells[e / 96] * 96 + e % 96] = v;
  }
  if (L.tid == 0) {
    const MergeRes& mr = r.mr;
    const Mot m = c == 2 ? amvp_mot(lx[g], hs.ref[g], hs.mvx[g], hs.mvy[g])
                         : mr.w;
    const int cbfy = c == 0 ? 0 : c == 1 ? mr.cbf & 1 : hs.cbf[g] & 1;
    for (int k = 0; k < ncell; ++k) {
      write_row(a.blk + (size_t)cells[k] * pw::NCOL, c, mr.mi, r.am, m,
                log2 - 3, cbfy);
      a.tsf[cells[k]] = 0;
    }
  }
  HM_SYNC();
}

// four cell steps in z-order, then the 16x16 CU trial
HM_BIG float region16(Lane& L, int g) {
  const Args& b = *L.bp;
  const pw::Args& a = b.p;
  const int bw = a.w / 8, gw = a.w / 16;
  const int* c4 = a.cells16 + 4 * g;
  float cost8 = 0.f;
  for (int j = 0; j < 4; ++j) cost8 = HM_FADD(cost8, cell_step(L, c4[j]));
  const int gx = g % gw, gy = g / gw;
  const LargeRes r = large_cu(L, g, gx, gy, (gy * 2) * bw + gx * 2, 16, 4,
                              a.nb16_cell + 5 * g, a.nb16_ok + 5 * g, a.h16,
                              b.lx16);
  // split_cu_flag at the 16 depth (ctx from neighbour depths)
  const float cost16 = HM_FADD(r.cost, pw::split_bits(a, 0, r.pr, gx, gy, 1));
  cost8 = HM_FADD(cost8, pw::split_bits(a, 1, r.pr, gx, gy, 1));
  if (!(cost16 < cost8)) return cost8;
  commit_large(L, r, g, gx, gy, 16, 4, a.h16, b.lx16, c4, 4);
  return cost16;
}

// four region16 steps, then the 32x32 CU trial where the region lies
// inside the picture (the padded grid's partial regions never form one)
HM_BIG void step32(Lane& L, int g) {
  const Args& b = *L.bp;
  const pw::Args& a = b.p;
  const int bw = a.w / 8, qw = (a.w / 16 + 1) / 2;
  const int* c16 = a.c16_32 + 4 * g;
  float cost_sub = 0.f;
  for (int j = 0; j < 4; ++j)
    if (c16[j] >= 0) cost_sub = HM_FADD(cost_sub, region16(L, c16[j]));
  if (!a.full32[g]) return;
  const int gx = g % qw, gy = g / qw;
  const LargeRes r = large_cu(L, g, gx, gy, (gy * 4) * bw + gx * 4, 32, 5,
                              a.nb32_cell + 5 * g, a.nb32_ok + 5 * g, a.h32,
                              b.lx32);
  const float cost32 = HM_FADD(r.cost, pw::split_bits(a, 0, r.pr, gx, gy, 2));
  cost_sub = HM_FADD(cost_sub, pw::split_bits(a, 1, r.pr, gx, gy, 2));
  if (cost32 < cost_sub)
    commit_large(L, r, g, gx, gy, 32, 5, a.h32, b.lx32, a.c8_32 + 16 * g,
                 16);
}

// lane `lane` of level `level`: smem is K10's working set (8-byte
// aligned, rdoq_smem_bytes of the geometry's largest TB)
HM_BIG void walk_lane(const Args& b, int level, int lane, int tid, int nt,
                      void* smem) {
  const pw::Args& a = b.p;
  const int blk = a.lv[level * a.bmax + lane];
  if (blk < 0) return;  // a padding lane does nothing
  wk::build_last_bits(a.cd, tid, nt);
  HM_SYNC();
  Lane L;
  L.ap = &a;
  L.bp = &b;
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

}  // namespace bw
