// K21 i_walk's lane code: one lane of one z-scan dependency level of the
// I-frame decision pass, the port of hmtpu/encoder/iframe_dev.py:114
// iframe_pass (`try_modes` :170, `nxn_trial` :258, the 8x8 cell step, the
// 16x16 `region16` :480 and the 32x32 `step32` :560) as the port's plain
// version (hmtpu_torch/encoder/iframe_dev.py `iframe_pass_plain`) runs it.
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
// its own, in the plain version's order (see each sum below); the
// candidate pick keeps the first of equal costs, the NxN, 16 and 32
// trials and the TS choice win only when strictly cheaper.
//
// Block-cooperative (hm_port.cuh): every thread of a lane's block runs
// the same control flow; the per-sample loops are split over the threads,
// scalar steps run on thread 0 and reach the others through the lane's
// scratch after a barrier.  The lane's scratch (candidate predictions,
// levels, reconstructions, reference lines) lies in device memory; K10's
// working set in shared memory.  The file also compiles as host C++
// (one thread), which the CPU tests drive level by level.
#pragma once

#include "mode_bits.cuh"
#include "walk.cuh"

namespace iw {

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

constexpr int K = 2;        // RDOQ-coded candidates per CU (K8 = K16)

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

// ---------------------------------------------------------------------------
// the lane's scratch (ints), sized for a 32x32 CU with K candidates

constexpr int S_IREF = 0;                 // 4 * 32 + 1 luma line
constexpr int S_IREFF = S_IREF + 132;     // its filtered form
constexpr int S_IREFU = S_IREFF + 132;    // chroma lines, 2 * 32 + 1
constexpr int S_IREFV = S_IREFU + 68;
constexpr int S_ORGY = S_IREFV + 68;      // the CU's source, raster
constexpr int S_ORGU = S_ORGY + 1024;
constexpr int S_ORGV = S_ORGU + 256;
constexpr int S_PREDY = S_ORGV + 256;     // per candidate
constexpr int S_PREDU = S_PREDY + K * 1024;
constexpr int S_PREDV = S_PREDU + K * 256;
constexpr int S_LEVY = S_PREDV + K * 256;
constexpr int S_LEVU = S_LEVY + K * 1024;
constexpr int S_LEVV = S_LEVU + K * 256;
constexpr int S_RECY = S_LEVV + K * 256;
constexpr int S_RECU = S_RECY + K * 1024;
constexpr int S_RECV = S_RECU + K * 256;
constexpr int S_W = S_RECV + K * 256;     // the coding work area (walk.cuh)
constexpr int S_LINE = S_W + wk::WORK_INTS;  // a 4x4 PU's substituted line
constexpr int S_ORG4 = S_LINE + 20;       // NxN: four PUs' source
constexpr int S_PRED4 = S_ORG4 + 64;
constexpr int S_LEV4 = S_PRED4 + 16;
constexpr int S_REC4 = S_LEV4 + 64;
constexpr int S_ORGC = S_REC4 + 64;       // NxN chroma pair
constexpr int S_PREDC = S_ORGC + 32;
constexpr int S_LEVC = S_PREDC + 32;
constexpr int S_RECC = S_LEVC + 32;
constexpr int SCRATCH = S_RECC + 32;
static_assert(S_W % 2 == 0, "the coding work area's int64 reduction");

struct Lane : wk::Lane {
  const Args* ap;
};

HM_FN float cbf_bits(const Args& a, int ctx, int nz) {
  return a.cb[2 * ctx + (nz ? 1 : 0)];
}

// mpm_neighbours: the left and above cells' modes (1 outside the picture
// and above the CTU row)
HM_FN void neighbours(const Lane& L, int b, int bxi, int byi, int y0,
                      int* lm, int* am) {
  const Args& a = *L.ap;
  const int bw = a.w / 8;
  *lm = bxi > 0 ? a.imode[b - 1] : 1;
  *am = (byi > 0 && (y0 & ((1 << a.log2_ctu) - 1)) != 0) ? a.imode[b - bw]
                                                          : 1;
}

struct TryRes {
  int ki, nz, ts_u, ts_v;
  float cost;
};

// try_modes + pick_best: the K candidates of an n x n CU (luma at (x0,
// y0), gather rows `row`), coded against the committed state
HM_BIG TryRes try_modes(Lane& L, int row, const int* gls, const int* gln,
                        const int* gcs, const int* gcn, int n, int log2,
                        int x0, int y0, const int* modes, const float* mb) {
  const Args& a = *L.ap;
  int* s = L.s;
  const int nc = n / 2, ll = 4 * n + 1, lc = 2 * n + 1;
  gather_line(L, a.rec_y, gls + row * ll, gln[row], ll, s + S_IREF);
  gather_line(L, a.rec_u, gcs + row * lc, gcn[row], lc, s + S_IREFU);
  gather_line(L, a.rec_v, gcs + row * lc, gcn[row], lc, s + S_IREFV);
  for (int k = L.tid; k < ll; k += L.nt)
    s[S_IREFF + k] = filter_sample(s + S_IREF, k, n, a.bd, a.sis);
  copy_block(L, a.org_y, a.w, x0, y0, n, s + S_ORGY);
  copy_block(L, a.org_u, a.w / 2, x0 / 2, y0 / 2, nc, s + S_ORGU);
  copy_block(L, a.org_v, a.w / 2, x0 / 2, y0 / 2, nc, s + S_ORGV);
  const bool ts_c = a.ts && log2 == 3;
  float cost[K];
  int nz[K], tsu[K], tsv[K];
  for (int k = 0; k < K; ++k) {
    const int m = modes[k];
    int* py = s + S_PREDY + k * 1024;
    int* pu = s + S_PREDU + k * 256;
    int* pv = s + S_PREDV + k * 256;
    predict(L, s + S_IREF, s + S_IREFF, m, n, 1, py);
    predict(L, s + S_IREFU, s + S_IREFU, m, nc, 0, pu);
    predict(L, s + S_IREFV, s + S_IREFV, m, nc, 0, pv);
    // the mode-dependent coding scans drive the SDH parity groups: 8x8
    // luma and 4x4 chroma TBs only
    const int sel_y = log2 == 3 ? scan_sel(m) : -1;
    const int sel_c = log2 - 1 == 2 ? scan_sel(m) : -1;
    const TbRes ry = code_tb(L, log2, true, false, false, sel_y, a.lam, false,
                             0.f, s + S_ORGY, py, s + S_LEVY + k * 1024,
                             s + S_RECY + k * 1024);
    TbRes ru, rv;
    if (ts_c) {
      ru = code_ts_sel(L, false, false, sel_c, a.lam_c, true, a.wchroma,
                       s + S_ORGU, pu, s + S_LEVU + k * 256,
                       s + S_RECU + k * 256);
      rv = code_ts_sel(L, false, false, sel_c, a.lam_c, true, a.wchroma,
                       s + S_ORGV, pv, s + S_LEVV + k * 256,
                       s + S_RECV + k * 256);
    } else {
      ru = code_tb(L, log2 - 1, false, false, false, sel_c, a.lam_c, true,
                   a.wchroma, s + S_ORGU, pu, s + S_LEVU + k * 256,
                   s + S_RECU + k * 256);
      rv = code_tb(L, log2 - 1, false, false, false, sel_c, a.lam_c, true,
                   a.wchroma, s + S_ORGV, pv, s + S_LEVV + k * 256,
                   s + S_RECV + k * 256);
    }
    // b_cbf = (cbf_cb + cbf_cr) + cbf_luma (trafo depth 0)
    const float b_cbf =
        HM_FADD(HM_FADD(cbf_bits(a, a.ctx[C_CBF_CHROMA], ru.nz),
                        cbf_bits(a, a.ctx[C_CBF_CHROMA], rv.nz)),
                cbf_bits(a, a.ctx[C_CBF_LUMA] + 1, ry.nz));
    // (dY + dU + dV) + lam * ((bY + bU + bV + b_cbf) + mb)
    const float bsum =
        HM_FADD(HM_FADD(HM_FADD(HM_FADD(ry.bits, ru.bits), rv.bits), b_cbf),
                mb[k]);
    cost[k] = HM_FADD(HM_FADD(HM_FADD(ry.sse, ru.sse), rv.sse),
                      HM_FMUL(a.lam, bsum));
    nz[k] = ry.nz;
    tsu[k] = ru.ts;
    tsv[k] = rv.ts;
  }
  TryRes r;
  r.ki = 0;
  for (int k = 1; k < K; ++k)
    if (cost[k] < cost[r.ki]) r.ki = k;
  r.cost = cost[r.ki];
  r.nz = nz[r.ki];
  r.ts_u = tsu[r.ki];
  r.ts_v = tsv[r.ki];
  return r;
}

struct NxnRes {
  float cost;
  int nz, tsf;
};

// 8.4.4.2.2 substitution of a 17-sample PU line (thread 0)
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

// nxn_trial: the four 4x4 PUs in z-order with exact sequential
// reconstruction, then the chroma pair in PU 0's mode
HM_BIG NxnRes nxn_trial(Lane& L, int b, int bxi, int byi, int x0, int y0,
                        int lm, int am) {
  const Args& a = *L.ap;
  int* s = L.s;
  const int mid = 1 << (a.bd - 1), gw4 = a.w / 4;
  int m4[4];
  for (int j = 0; j < 4; ++j)
    m4[j] = a.cand4[(2 * byi + (j >> 1)) * gw4 + 2 * bxi + (j & 1)];
  for (int e = L.tid; e < 64; e += L.nt) {
    const int j = e >> 4, i = (e >> 2) & 3, x = e & 3;
    s[S_ORG4 + e] =
        a.org_y[(y0 + 4 * (j >> 1) + i) * a.w + x0 + 4 * (j & 1) + x];
  }
  gather_line(L, a.rec_y, a.g8s + b * 33, a.g8n[b], 33, s + S_IREF);
  const int* iref = s + S_IREF;
  const int* nbo = a.nb_ok + 5 * b;
  const int aL = nbo[0], aA = nbo[1], aAR = nbo[2], aBL = nbo[3],
            aC = nbo[4];
  TbRes pr[4];
  for (int j = 0; j < 4; ++j) {
    if (L.tid == 0) {
      const int* r0 = s + S_REC4;
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
      sub_line(v, av, mid, s + S_LINE);
    }
    HM_SYNC();
    predict(L, s + S_LINE, s + S_LINE, m4[j], 4, 1, s + S_PRED4);
    const int sel = scan_sel(m4[j]);
    if (a.ts) {
      pr[j] = code_ts_sel(L, true, true, sel, a.lam, false, 0.f,
                          s + S_ORG4 + 16 * j, s + S_PRED4,
                          s + S_LEV4 + 16 * j, s + S_REC4 + 16 * j);
    } else {
      pr[j] = code_tb(L, 2, true, true, false, sel, a.lam, false, 0.f,
                      s + S_ORG4 + 16 * j, s + S_PRED4, s + S_LEV4 + 16 * j,
                      s + S_REC4 + 16 * j);
    }
  }

  // chroma: one 4x4 TB pair, DM mode = PU 0's luma mode
  const int mc = m4[0], selc = scan_sel(mc);
  gather_line(L, a.rec_u, a.g4s + b * 17, a.g4n[b], 17, s + S_IREFU);
  gather_line(L, a.rec_v, a.g4s + b * 17, a.g4n[b], 17, s + S_IREFV);
  copy_block(L, a.org_u, a.w / 2, x0 / 2, y0 / 2, 4, s + S_ORGC);
  copy_block(L, a.org_v, a.w / 2, x0 / 2, y0 / 2, 4, s + S_ORGC + 16);
  predict(L, s + S_IREFU, s + S_IREFU, mc, 4, 0, s + S_PREDC);
  predict(L, s + S_IREFV, s + S_IREFV, mc, 4, 0, s + S_PREDC + 16);
  TbRes rc[2];
  for (int c = 0; c < 2; ++c) {
    const int o = 16 * c;
    rc[c] = a.ts ? code_ts_sel(L, false, false, selc, a.lam_c, true,
                               a.wchroma, s + S_ORGC + o, s + S_PREDC + o,
                               s + S_LEVC + o, s + S_RECC + o)
                 : code_tb(L, 2, false, false, false, selc, a.lam_c, true,
                           a.wchroma, s + S_ORGC + o, s + S_PREDC + o,
                           s + S_LEVC + o, s + S_RECC + o);
  }

  // rate: part NxN + the four PUs' mode, cbf and residual + chroma
  NxnRes r;
  r.tsf = pr[0].ts | (pr[1].ts << 1) | (pr[2].ts << 2) | (pr[3].ts << 3) |
          (rc[0].ts << 4) | (rc[1].ts << 5);
  r.nz = pr[0].nz | pr[1].nz | pr[2].nz | pr[3].nz;
  const float mb = mpm_bits4(a.cb, a.ctx[C_IPM], m4, lm, am);
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
  float bs = HM_FADD(mb, a.cb[2 * a.ctx[C_PART]]);
  bs = HM_FADD(bs, a.cb[2 * a.ctx[C_CHROMA_DM]]);
  bs = HM_FADD(bs, b_cbf);
  for (int j = 0; j < 4; ++j) bs = HM_FADD(bs, pr[j].bits);
  bs = HM_FADD(HM_FADD(bs, rc[0].bits), rc[1].bits);
  r.cost = HM_FADD(d, HM_FMUL(a.lam, bs));
  return r;
}

// one 8x8 CU: returns its cost; commits its decision
HM_BIG float cell_step(Lane& L, int b) {
  const Args& a = *L.ap;
  int* s = L.s;
  const int bw = a.w / 8, byi = b / bw, bxi = b % bw;
  const int x0 = bxi * 8, y0 = byi * 8;
  const int modes[K] = {a.cand8[K * b], a.cand8[K * b + 1]};
  int lm, am;
  neighbours(L, b, bxi, byi, y0, &lm, &am);
  float mb[K];
  for (int k = 0; k < K; ++k)   // (mpm + part 2Nx2N) + chroma DM
    mb[k] = HM_FADD(HM_FADD(mpm_bits(a.cb, a.ctx[C_IPM], modes[k], lm, am),
                            a.cb[2 * a.ctx[C_PART] + 1]),
                    a.cb[2 * a.ctx[C_CHROMA_DM]]);
  const TryRes t = try_modes(L, b, a.g8s, a.g8n, a.g4s, a.g4n, 8, 3, x0, y0,
                             modes, mb);
  const NxnRes nx = nxn_trial(L, b, bxi, byi, x0, y0, lm, am);
  const bool use_n = nx.cost < t.cost;
  const int ki = t.ki, wmode = modes[ki];
  const int* ry = use_n ? s + S_REC4 : s + S_RECY + ki * 1024;
  const int* ly = use_n ? s + S_LEV4 : s + S_LEVY + ki * 1024;
  const int* ru = use_n ? s + S_RECC : s + S_RECU + ki * 256;
  const int* rv = use_n ? s + S_RECC + 16 : s + S_RECV + ki * 256;
  const int* lu = use_n ? s + S_LEVC : s + S_LEVU + ki * 256;
  const int* lv = use_n ? s + S_LEVC + 16 : s + S_LEVV + ki * 256;
  for (int e = L.tid; e < 64; e += L.nt) {
    const int i = e >> 3, j = e & 7;
    // NxN: the PUs' 4x4 blocks in their quadrants
    const int src = use_n ? ((i >> 2) * 2 + (j >> 2)) * 16 + (i & 3) * 4 +
                                (j & 3)
                          : e;
    a.rec_y[(y0 + i) * a.w + x0 + j] = ry[src];
    a.levs[b * 96 + e] = ly[src];
  }
  for (int e = L.tid; e < 16; e += L.nt) {
    const int o = (y0 / 2 + (e >> 2)) * (a.w / 2) + x0 / 2 + (e & 3);
    a.rec_u[o] = ru[e];
    a.rec_v[o] = rv[e];
    a.levs[b * 96 + 64 + e] = lu[e];
    a.levs[b * 96 + 80 + e] = lv[e];
  }
  if (L.tid == 0) {
    const int gw4 = a.w / 4;
    for (int j = 0; j < 4; ++j)
      a.imode4[4 * b + j] =
          use_n ? a.cand4[(2 * byi + (j >> 1)) * gw4 + 2 * bxi + (j & 1)]
                : wmode;
    a.imode[b] = a.imode4[4 * b];
    a.part[b] = use_n;
    a.cusz[b] = 0;
    a.cbfy[b] = use_n ? nx.nz : t.nz;
    a.tsf[b] = use_n ? nx.tsf : (t.ts_u << 4) | (t.ts_v << 5);
  }
  HM_SYNC();
  return use_n ? nx.cost : t.cost;
}

// the larger CU trial of region16 / step32: n x n at (x0, y0), corner cell
// `corner`, gather rows `row`; commits to `ncell` cells in `cells` order
// where strictly cheaper than `cost_sub`; returns the kept cost
HM_BIG float large_cu(Lane& L, int row, int n, int log2, int x0, int y0,
                      const int* gls, const int* gln, const int* gcs,
                      const int* gcn, const int* cand, const int* cells,
                      int ncell, int cusz, float cost_sub) {
  const Args& a = *L.ap;
  int* s = L.s;
  const int bw = a.w / 8, bxi = x0 / 8, byi = y0 / 8;
  const int corner = byi * bw + bxi;
  const int modes[K] = {cand[K * row], cand[K * row + 1]};
  int lm, am;
  neighbours(L, corner, bxi, byi, y0, &lm, &am);
  float mb[K];
  for (int k = 0; k < K; ++k)   // mpm + chroma DM
    mb[k] = HM_FADD(mpm_bits(a.cb, a.ctx[C_IPM], modes[k], lm, am),
                    a.cb[2 * a.ctx[C_CHROMA_DM]]);
  const TryRes t =
      try_modes(L, row, gls, gln, gcs, gcn, n, log2, x0, y0, modes, mb);
  // neighbour-depth approximation of the split ctxInc: ctx 1 both ways
  const int sp = 2 * (a.ctx[C_SPLIT] + 1);
  const float cost = HM_FADD(t.cost, HM_FMUL(a.lam, a.cb[sp]));
  cost_sub = HM_FADD(cost_sub, HM_FMUL(a.lam, a.cb[sp + 1]));
  if (!(cost < cost_sub)) return cost_sub;
  const int ki = t.ki, nc = n / 2, nn = n * n, ncc = nc * nc;
  const int* ry = s + S_RECY + ki * 1024;
  const int* ru = s + S_RECU + ki * 256;
  const int* rv = s + S_RECV + ki * 256;
  const int* ly = s + S_LEVY + ki * 1024;
  const int* lu = s + S_LEVU + ki * 256;
  const int* lv = s + S_LEVV + ki * 256;
  for (int e = L.tid; e < nn; e += L.nt)
    a.rec_y[(y0 + e / n) * a.w + x0 + e % n] = ry[e];
  for (int e = L.tid; e < ncc; e += L.nt) {
    const int o = (y0 / 2 + e / nc) * (a.w / 2) + x0 / 2 + e % nc;
    a.rec_u[o] = ru[e];
    a.rec_v[o] = rv[e];
  }
  // levs: the flat [Y | U | V] cut into 96-value slabs, one per cell in
  // `cells` order
  for (int e = L.tid; e < nn + 2 * ncc; e += L.nt) {
    const int v = e < nn ? ly[e] : e < nn + ncc ? lu[e - nn]
                                                : lv[e - nn - ncc];
    a.levs[cells[e / 96] * 96 + e % 96] = v;
  }
  if (L.tid == 0) {
    const int wmode = modes[ki];
    for (int c = 0; c < ncell; ++c) {
      const int cell = cells[c];
      a.imode[cell] = wmode;
      for (int j = 0; j < 4; ++j) a.imode4[4 * cell + j] = wmode;
      a.part[cell] = 0;
      a.cusz[cell] = cusz;
      a.cbfy[cell] = t.nz;
      a.tsf[cell] = 0;
    }
  }
  HM_SYNC();
  return cost;
}

// four cell steps in z-order, then the 16x16 CU trial
HM_BIG float region16(Lane& L, int g) {
  const Args& a = *L.ap;
  const int* c4 = a.cells16 + 4 * g;
  float cost8 = 0.f;
  for (int j = 0; j < 4; ++j) cost8 = HM_FADD(cost8, cell_step(L, c4[j]));
  const int gw = a.w / 16;
  return large_cu(L, g, 16, 4, (g % gw) * 16, (g / gw) * 16, a.g16s, a.g16n,
                  a.g8cs, a.g8cn, a.cand16, c4, 4, 1, cost8);
}

// four region16 steps, then the 32x32 CU trial
HM_BIG float step32(Lane& L, int g) {
  const Args& a = *L.ap;
  const int* c16 = a.c16_32 + 4 * g;
  float cost_sub = 0.f;
  for (int j = 0; j < 4; ++j)
    cost_sub = HM_FADD(cost_sub, c16[j] >= 0 ? region16(L, c16[j]) : 0.f);
  const int qw = a.w / 32;
  return large_cu(L, g, 32, 5, (g % qw) * 32, (g / qw) * 32, a.g32s, a.g32n,
                  a.g16cs, a.g16cn, a.cand32, a.c8_32 + 16 * g, 16, 2,
                  cost_sub);
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
  L.S = rdoq_smem(smem, 1 << (2 * (a.geom == 8 ? 3 : a.geom == 16 ? 4 : 5)));
  L.s = a.scratch + (size_t)lane * SCRATCH;
  L.work = L.s + S_W;
  if (a.geom == 8)
    cell_step(L, blk);
  else if (a.geom == 16)
    region16(L, blk);
  else
    step32(L, blk);
}

}  // namespace iw
