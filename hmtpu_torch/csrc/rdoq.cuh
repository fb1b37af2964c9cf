// K10's arithmetic, shared by its entry point (rdoq.cu) and the I z-scan
// walker K21 (iwalk.cuh): per TB the levels (the RDOQ trellis, or deadzone
// quantisation, then the sign-data-hiding parity stage), the fractional
// bit price of residual_coding() for them (tb_bits) and their
// dequantisation, bit-exact with the port's plain versions of
// hmtpu/ops/rdoq.py:43 rdoq_tb, hmtpu/ops/ratebits.py:161 tb_bits and
// hmtpu/ops/quant.py:78,91.
//
// Block-cooperative (hm_port.cuh): one TB per call, the block's threads
// take the 4x4 coefficient groups (CGs) tid, tid + nt, ...; a CG's thread
// walks its 16 positions in reverse scan order, which is the coder's
// order, carrying the context state (rank, greater-1 count, Rice
// parameter).  The few TB-wide scans (last position, the prefix and
// suffix sums of stage 3, the order-fixed float64 sums) run on thread 0.
// Coefficients, levels and per-position costs sit in `RdoqSmem` (shared
// memory on the card) in the coding scan order.
//
// Parity with the plain version, which runs the same arithmetic:
//   - every cost is float32 in the plain version's order of operations,
//     each operation rounded on its own (HM_FMUL / HM_FADD / HM_FSUB), so
//     nothing is contracted into an FMA;
//   - sums are taken in float64 and rounded once to float32, as
//     ratebits.fsum does (the TB-rate sums are multiples of 2^-15 below
//     2^20, exact in any order);
//   - the quantiser step 2^qbits / scale and the lambdas come from the
//     caller's tables; nothing here computes exp2;
//   - every argmin keeps the first index of least value; right shifts of
//     negative ints are arithmetic.
#pragma once

#include "hm_port.cuh"
#include "transform.cuh"

namespace hm {

constexpr int C1FLAG = 8;
constexpr int MAX_NCG = 64;
constexpr int MAX_SIZE = 32;
constexpr int NPART = 5;  // csbf, sig, greater-1, greater-2, remainder

constexpr int F_LEV_IN = 1;   // x holds levels: price / dequantise only
constexpr int F_TRELLIS = 2;  // the RDOQ trellis (else deadzone)
constexpr int F_SDH = 4;      // sign data hiding (parity stage, sign bits)
constexpr int F_LUMA = 8;

// the constants of one (size, component) at one QP
struct RdoqCfg {
  const float* cb;      // (NUM_CTX*2,) fractional bits per (ctx, bin)
  const int* tabs_i;    // packed int tables (see Tabs)
  const float* tabs_f;  // packed float tables (see Tabs)
  int log2, flags, scale, qbits, add, iscale, dq_shift;
  int ctx_x, ctx_y, sig_cg_base, one_base, abs_base;
  float inv, cscale;
};

// views into the packed tables of one (size, scan, component)
struct Tabs {
  const int *scans, *sig_tab, *right, *below, *last_x, *last_y, *rank_tab;
  const float *w_cnt, *ep_cnt;
};

HM_FN Tabs rdoq_tabs(const RdoqCfg& P, int npos, int ncg) {
  Tabs t;
  t.scans = P.tabs_i;
  t.sig_tab = t.scans + npos;       // (4, npos)
  t.right = t.sig_tab + 4 * npos;   // (ncg,), ncg = none
  t.below = t.right + ncg;
  t.last_x = t.below + ncg;         // (npos,)
  t.last_y = t.last_x + npos;
  t.rank_tab = t.last_y + npos;     // (3, 16)
  t.w_cnt = P.tabs_f;               // (size, 15, 2)
  t.ep_cnt = t.w_cnt + 30 * (1 << P.log2);
  return t;
}

struct RdoqFixed {
  int cg_sig[MAX_NCG];  // rounded-level significance per CG (trellis)
  int g1any[MAX_NCG];
  int cg_last[MAX_NCG];
  int t_sig[MAX_NCG];   // tb_bits: the priced levels' CG state
  int t_g1any[MAX_NCG];
  int t_last[MAX_NCG];
  int t_signs[MAX_NCG];
  double part[NPART][MAX_NCG];
  float lxb[MAX_SIZE], lyb[MAX_SIZE];
  int last_pos, t_last_pos, best_last, use_zero, use_fb;
  float bits, rd_fb;
};

struct RdoqSmem {
  RdoqFixed* f;
  int *sc, *a, *maxabs, *fb, *lev;    // scan order
  float *d0, *cost, *sigb1, *tmp;
};

// bytes of the working set for TBs up to 2^log2 on a side
HM_HD size_t rdoq_smem_bytes(int log2) {
  return sizeof(RdoqFixed) + (size_t)9 * (1 << (2 * log2)) * sizeof(int);
}

// the working set laid out from `base` (8-byte aligned) for npos positions
HM_FN RdoqSmem rdoq_smem(void* base, int npos) {
  RdoqSmem S;
  S.f = reinterpret_cast<RdoqFixed*>(base);
  int* ip = reinterpret_cast<int*>(S.f + 1);
  S.sc = ip;
  S.a = ip + npos;
  S.maxabs = ip + 2 * npos;
  S.fb = ip + 3 * npos;
  S.lev = ip + 4 * npos;
  float* fp = reinterpret_cast<float*>(ip + 5 * npos);
  S.d0 = fp;
  S.cost = fp + npos;
  S.sigb1 = fp + 2 * npos;
  S.tmp = fp + 3 * npos;
  return S;
}

HM_FN float cbits(const RdoqCfg& P, int ctx, int bin) {
  return HM_LDG(P.cb + ctx * 2 + bin);
}

// (a - l * 2^qbits / scale)^2 scaled to pixel SSE
HM_FN float rdoq_dist(const RdoqCfg& P, int a, int l) {
  const float d = HM_FSUB((float)a, HM_FMUL((float)l, P.inv));
  return HM_FMUL(HM_FMUL(d, d), P.cscale);
}

// EP bits of xWriteCoefRemainExGolomb(sym, rice)
HM_FN float rem_bits(int sym, int rice) {
  if (sym < (3 << rice)) return (float)((sym >> rice) + 1 + rice);
  const int x = sym - (3 << rice) + (1 << rice);
  return (float)(4 + 2 * (31 - HM_CLZ(x)) - rice);
}

HM_FN int cg_flag(const int* flags, int idx, int ncg) {
  return idx < ncg ? flags[idx] : 0;
}

// ---------------------------------------------------------------------------
// tb_bits on the |levels| A (scan order) of this block's TB; every thread
// calls it, thread 0's float32 result is returned to all

HM_BIG float tb_bits(const RdoqCfg& P, const Tabs& T, RdoqSmem& S,
                     const int* A, bool sdh, int npos, int ncg, int tid,
                     int nt) {
  RdoqFixed& F = *S.f;
  for (int ci = tid; ci < ncg; ci += nt) {
    const int base = ci * 16;
    int sig = 0, last = -1, cnt = 0, g1 = 0;
    for (int j = 15; j >= 0; --j) {
      const int a = A[base + j];
      if (a > 0) {
        if (last < 0) last = base + j;
        if (cnt < C1FLAG && a > 1) g1 = 1;
        sig = 1;
        ++cnt;
      }
    }
    F.t_sig[ci] = sig;
    F.t_last[ci] = last;
    F.t_g1any[ci] = g1;
  }
  HM_SYNC();
  if (tid == 0) {
    int lp = -1;
    for (int ci = 0; ci < ncg; ++ci) lp = imax(lp, F.t_last[ci]);
    F.t_last_pos = lp;
  }
  HM_SYNC();
  const int last_pos = F.t_last_pos;
  const int last_cg = last_pos >> 4;
  for (int ci = tid; ci < ncg; ci += nt) {
    const int base = ci * 16;
    const int rs = cg_flag(F.t_sig, T.right[ci], ncg);
    const int bs = cg_flag(F.t_sig, T.below[ci], ncg);
    const int cg_sig = F.t_sig[ci];
    double part[NPART] = {0.0, 0.0, 0.0, 0.0, 0.0};
    // coded_sub_block_flag, CGs strictly between 0 and the last
    if (ci > 0 && ci < last_cg)
      part[0] = cbits(P, P.sig_cg_base + (rs | bs), cg_sig);
    // sig_coeff_flag; the DC bin is inferred when an explicitly coded
    // CG's only significance is at position 0
    const bool cg_coded = cg_sig || ci == 0;
    bool rest_zero = true;
    for (int j = 1; j < 16; ++j) rest_zero = rest_zero && A[base + j] == 0;
    const bool dc_skip = ci > 0 && ci < last_cg && cg_sig && rest_zero;
    const int patt = rs + 2 * bs;
    for (int j = 0; j < 16; ++j) {
      const int p = base + j;
      if (p < last_pos && cg_coded && !(j == 0 && dc_skip))
        part[1] += cbits(P, T.sig_tab[patt * npos + p], A[p] > 0);
    }
    // ctx_set: +1 when the previously processed coded CG (the nearest
    // higher index) had a greater-1; +2 for a luma CG other than 0
    int cs = 0;
    for (int j = ci + 1; j < ncg; ++j)
      if (F.t_sig[j] && j <= last_cg) {
        cs = F.t_g1any[j];
        break;
      }
    if ((P.flags & F_LUMA) && ci > 0) cs += 2;
    // the coder's walk, last to first position: greater-1 state,
    // greater-2, escape base and the Rice adaptation
    int rank = 0, g1cnt = 0, ge2cnt = 0, rice = 0, n_sig = 0;
    int g2val = -1, maxp = -1, minp = 99;
    for (int j = 15; j >= 0; --j) {
      const int a = A[base + j];
      const bool s = a > 0;
      const bool grp = s && rank < C1FLAG;
      const bool g1 = a > 1;
      if (grp) {
        const int c1 = g1cnt > 0 ? 0 : imin(1 + rank, 3);
        part[2] += cbits(P, P.one_base + cs * 4 + c1, g1);
      }
      if (grp && g1) {
        if (g2val < 0) g2val = a > 2;
        ++g1cnt;
      }
      const int bse = rank < C1FLAG ? (ge2cnt > 0 ? 2 : 3) : 1;
      if (s && a >= bse) {
        part[4] += rem_bits(imax(a - bse, 0), rice);
        if (a > (3 << rice)) rice = imin(rice + 1, 4);
      }
      if (s) {
        if (a >= 2) ++ge2cnt;
        maxp = imax(maxp, j);
        minp = imin(minp, j);
        ++n_sig;
        ++rank;
      }
    }
    if (g1cnt > 0) part[3] = cbits(P, P.abs_base + cs, g2val);
    const int hide = sdh && (maxp - minp) > 3;
    F.t_signs[ci] = n_sig > 0 ? n_sig - hide : 0;
    for (int k = 0; k < NPART; ++k) F.part[k][ci] = part[k];
  }
  HM_SYNC();
  if (tid == 0) {
    float bits = 0.f;
    if (last_pos >= 0) {
      const int lx = T.last_x[last_pos], ly = T.last_y[last_pos];
      double sx = 0.0, sy = 0.0;
      for (int k = 0; k < 30; ++k) {
        sx += (double)HM_FMUL(T.w_cnt[lx * 30 + k], cbits(P, P.ctx_x, k));
        sy += (double)HM_FMUL(T.w_cnt[ly * 30 + k], cbits(P, P.ctx_y, k));
      }
      bits = HM_FADD(HM_FADD(HM_FADD((float)sx, (float)sy), T.ep_cnt[lx]),
                     T.ep_cnt[ly]);
      int signs = 0;
      for (int ci = 0; ci < ncg; ++ci) signs += F.t_signs[ci];
      for (int k = 0; k < NPART; ++k) {
        double s = 0.0;
        for (int ci = 0; ci < ncg; ++ci) s += F.part[k][ci];
        // the plain version adds the sign count before the remainders
        if (k == NPART - 1) bits = HM_FADD(bits, (float)signs);
        bits = HM_FADD(bits, (float)s);
      }
    }
    F.bits = bits;
  }
  HM_SYNC();
  return F.bits;
}

// ---------------------------------------------------------------------------
// the RDOQ trellis on S.maxabs -> S.lev (stages 1-3 of rdoq_tb)

HM_BIG void rdoq_trellis(const RdoqCfg& P, const Tabs& T, RdoqSmem& S,
                         float lam, int npos, int ncg, int tid, int nt) {
  RdoqFixed& F = *S.f;
  const int size = 1 << P.log2;
  for (int ci = tid; ci < ncg; ci += nt) {
    // the rounded levels' significance and greater-1 flags per CG
    const int base = ci * 16;
    int sig = 0, cnt = 0, g1 = 0;
    for (int j = 15; j >= 0; --j) {
      const int m = S.maxabs[base + j];
      if (m > 0) {
        if (cnt < C1FLAG && m > 1) g1 = 1;
        sig = 1;
        ++cnt;
      }
    }
    F.cg_sig[ci] = sig;
    F.g1any[ci] = g1;
  }
  for (int c = tid; c < size; c += nt) {
    // the last-position prefix + suffix bits of each coordinate
    double sx = 0.0, sy = 0.0;
    for (int k = 0; k < 30; ++k) {
      sx += (double)HM_FMUL(T.w_cnt[c * 30 + k], cbits(P, P.ctx_x, k));
      sy += (double)HM_FMUL(T.w_cnt[c * 30 + k], cbits(P, P.ctx_y, k));
    }
    F.lxb[c] = HM_FADD((float)sx, T.ep_cnt[c]);
    F.lyb[c] = HM_FADD((float)sy, T.ep_cnt[c]);
  }
  HM_SYNC();

  // ---- stage 1: level choice per position among maxAbs, maxAbs-1, 0
  for (int ci = tid; ci < ncg; ci += nt) {
    const int base = ci * 16;
    const int rs = cg_flag(F.cg_sig, T.right[ci], ncg);
    const int bs = cg_flag(F.cg_sig, T.below[ci], ncg);
    const int patt = rs + 2 * bs;
    int cs = 0;
    for (int j = ci + 1; j < ncg; ++j)
      if (F.cg_sig[j]) {
        cs = F.g1any[j];
        break;
      }
    if ((P.flags & F_LUMA) && ci > 0) cs += 2;
    int rank[16], c1[16], rice_at[16];
    int cnt = 0, g1cnt = 0, minr = 99;
    for (int j = 15; j >= 0; --j) {
      const int m = S.maxabs[base + j];
      const bool s = m > 0;
      rank[j] = cnt;
      c1[j] = g1cnt > 0 ? 0 : imin(1 + cnt, 3);
      if (m > 1 && s && cnt < C1FLAG) ++g1cnt;
      if (s && m >= 2) minr = imin(minr, cnt);
      if (s) ++cnt;
    }
    int rice = 0;
    for (int j = 15; j >= 0; --j) {
      const int m = S.maxabs[base + j];
      rice_at[j] = rice;
      const int bse = rank[j] < C1FLAG ? (rank[j] == minr ? 3 : 2) : 1;
      if (m > 0 && m >= bse && m > (3 << rice)) rice = imin(rice + 1, 4);
    }
    for (int j = 0; j < 16; ++j) {
      const int p = base + j;
      const int a = S.a[p], m = S.maxabs[p];
      const bool scg = m > 0;
      const int sctx = T.sig_tab[patt * npos + p];
      const float sb0 = cbits(P, sctx, 0), sb1 = cbits(P, sctx, 1);
      S.sigb1[p] = sb1;
      const bool low = rank[j] < C1FLAG;
      const bool has_g2 = rank[j] == minr;
      const int bse = low ? (has_g2 ? 3 : 2) : 1;
      const int one_ctx = P.one_base + cs * 4 + c1[j];
      const int abs_ctx = P.abs_base + cs;
      const int rj = rice_at[j];
      // bits of |level| lv > 0 without the sig flag, then the RD cost
      auto cost_nz = [&](int lv) {
        const bool g1 = lv > 1;
        float r = low ? cbits(P, one_ctx, g1) : 0.f;
        r = HM_FADD(r, (has_g2 && g1 && low) ? cbits(P, abs_ctx, lv > 2)
                                             : 0.f);
        r = HM_FADD(r, lv >= bse ? rem_bits(imax(lv - bse, 0), rj) : 0.f);
        r = HM_FADD(r, 1.f);
        return HM_FADD(rdoq_dist(P, a, lv), HM_FMUL(lam, HM_FADD(r, sb1)));
      };
      const float c_max = cost_nz(m);
      const int cand2 = imax(m - 1, 0);
      const float c_dec = cand2 > 0 ? cost_nz(cand2) : INFINITY;
      const float c_zero = HM_FADD(S.d0[p], HM_FMUL(lam, sb0));
      S.lev[p] = (scg && c_dec < c_max && c_dec < c_zero)
                     ? cand2
                     : ((scg && c_zero <= c_max) ? 0 : m);
      S.cost[p] = scg ? fminf(c_max, fminf(c_dec, c_zero)) : S.d0[p];
    }
    int last = -1;
    for (int j = 15; j >= 0 && last < 0; --j)
      if (S.lev[base + j] > 0) last = base + j;
    F.cg_last[ci] = last;
  }
  HM_SYNC();
  if (tid == 0) {
    int lp = -1;
    for (int ci = 0; ci < ncg; ++ci) lp = imax(lp, F.cg_last[ci]);
    F.last_pos = lp;
  }
  HM_SYNC();

  // ---- stage 2: zero a CG whose coded cost loses to its all-zero cost
  for (int ci = tid; ci < ncg; ci += nt) {
    const int base = ci * 16;
    const int rs = cg_flag(F.cg_sig, T.right[ci], ncg);
    const int bs = cg_flag(F.cg_sig, T.below[ci], ncg);
    const int csbf = P.sig_cg_base + (rs | bs);
    double sc = 0.0, sd = 0.0;
    for (int j = 0; j < 16; ++j) {
      sc += (double)S.cost[base + j];
      sd += (double)S.d0[base + j];
    }
    const float coded = HM_FADD((float)sc, HM_FMUL(lam, cbits(P, csbf, 1)));
    const float zero = HM_FADD((float)sd, HM_FMUL(lam, cbits(P, csbf, 0)));
    if (ci > 0 && ci < (F.last_pos >> 4) && zero < coded)
      for (int j = 0; j < 16; ++j) {
        S.lev[base + j] = 0;
        S.cost[base + j] = S.d0[base + j];
      }
  }
  HM_SYNC();

  // ---- stage 3: the best last position (its sig flag refunded, the
  // last-position bits paid, the rest zeroed) against the all-zero TB
  if (tid == 0) {
    double acc = 0.0;
    for (int p = npos - 1; p >= 0; --p) {
      acc += (double)S.d0[p];
      S.tmp[p] = HM_FSUB((float)acc, S.d0[p]);
    }
    const float all_zero = (float)acc;
    double pre = 0.0;
    float best = INFINITY;
    int bi = 0;
    for (int p = 0; p < npos; ++p) {
      const float c = S.cost[p];
      pre += (double)c;
      const float prefix = HM_FSUB((float)pre, c);
      const float lb = HM_FADD(F.lxb[T.last_x[p]], F.lyb[T.last_y[p]]);
      float v = HM_FADD(
          HM_FADD(HM_FADD(prefix, HM_FSUB(c, HM_FMUL(lam, S.sigb1[p]))),
                  S.tmp[p]),
          HM_FMUL(lam, lb));
      if (!(S.lev[p] > 0)) v = INFINITY;
      if (v < best) {
        best = v;
        bi = p;
      }
    }
    F.best_last = bi;
    F.use_zero = all_zero <= best;
  }
  HM_SYNC();
  for (int p = tid; p < npos; p += nt)
    if (F.use_zero || p > F.best_last) S.lev[p] = 0;
  HM_SYNC();
}

// d(levels) + lambda * (bits + cbf) of the exact-rate guard; thread 0
HM_FN float rdoq_exact_rd(const RdoqCfg& P, RdoqSmem& S, const int* L,
                          float bits, float lam, int npos) {
  double d = 0.0;
  bool nz = false;
  for (int p = 0; p < npos; ++p) {
    d += (double)rdoq_dist(P, S.a[p], L[p]);
    nz = nz || L[p] != 0;
  }
  return HM_FADD((float)d, HM_FMUL(lam, HM_FADD(bits, nz ? 1.f : 0.f)));
}

// sign data hiding parity (xQuant SDH branch) on S.lev, per CG; sel is
// the TB's coding scan (0 diag, 1 hor, 2 ver) or -1 for the static one
HM_BIG void rdoq_sdh(const RdoqCfg& P, const Tabs& T, RdoqSmem& S, int sel,
                     int ncg, int tid, int nt) {
  for (int ci = tid; ci < ncg; ci += nt) {
    const int base = ci * 16;
    int rk[16];
    for (int j = 0; j < 16; ++j)
      rk[j] = sel < 0 ? j : T.rank_tab[sel * 16 + j];
    int maxp = -1, minp = 99, asum = 0;
    for (int j = 0; j < 16; ++j) {
      const int l = S.lev[base + j];
      if (l != 0) {
        maxp = imax(maxp, rk[j]);
        minp = imin(minp, rk[j]);
      }
      asum += l;
    }
    int first_neg = 0;
    for (int j = 0; j < 16; ++j)
      if (S.lev[base + j] != 0 && rk[j] == minp && S.sc[base + j] < 0)
        ++first_neg;
    const bool bad = (maxp - minp) > 3 && (asum & 1) != first_neg;
    if (!bad) continue;
    float best = INFINITY, best_inc = INFINITY, best_dec = INFINITY;
    int pick = 0;
    for (int j = 0; j < 16; ++j) {
      const int l = S.lev[base + j], a = S.a[base + j];
      const float now = rdoq_dist(P, a, l);
      const bool span = rk[j] >= minp && rk[j] <= maxp;
      const float inc = (span && l < COEFF_MAX)
                            ? HM_FSUB(rdoq_dist(P, a, l + 1), now)
                            : INFINITY;
      const float dec = (span && l > 1)
                            ? HM_FSUB(rdoq_dist(P, a, l - 1), now)
                            : INFINITY;
      const float m = fminf(inc, dec);
      if (j == 0 || m < best) {
        best = m;
        pick = j;
        best_inc = inc;
        best_dec = dec;
      }
    }
    S.lev[base + pick] += best_inc <= best_dec ? 1 : -1;
  }
}

// One TB: x its raster coefficients (or levels with F_LEV_IN); writes the
// raster levels and dequantised coefficients where asked, and returns the
// TB rate (0 unless want_bits) to every thread.  lam is read only by the
// trellis and the SDH stage.  Ends with a barrier.
HM_BIG float rdoq_tb(const RdoqCfg& P, float lam, int sel, const int* x,
                     int* lev_out, int* deq_out, bool want_bits, RdoqSmem& S,
                     int tid, int nt) {
  const int npos = 1 << (2 * P.log2), ncg = npos >> 4;
  const Tabs T = rdoq_tabs(P, npos, ncg);
  RdoqFixed& F = *S.f;
  const bool lev_in = P.flags & F_LEV_IN;
  const bool sdh = P.flags & F_SDH;

  for (int p = tid; p < npos; p += nt) {
    const int v = x[T.scans[p]];
    const int a = iabs(v);
    S.sc[p] = v;
    S.a[p] = a;
    if (lev_in) {
      S.lev[p] = a;
    } else {
      // int32 is enough: a <= 2^15, scale < 2^15, the offsets < 2^27
      S.maxabs[p] = imin((a * P.scale + (1 << (P.qbits - 1))) >> P.qbits,
                         COEFF_MAX);
      S.fb[p] = imin((a * P.scale + P.add) >> P.qbits, COEFF_MAX);
      const float af = (float)a;
      S.d0[p] = HM_FMUL(HM_FMUL(af, af), P.cscale);
      S.lev[p] = S.fb[p];
    }
  }
  HM_SYNC();

  if (!lev_in) {
    if (P.flags & F_TRELLIS) {
      rdoq_trellis(P, T, S, lam, npos, ncg, tid, nt);
      // exact-rate guard: re-price the trellis result and the deadzone
      // levels with tb_bits and keep the cheaper
      const float b_fb = tb_bits(P, T, S, S.fb, false, npos, ncg, tid, nt);
      if (tid == 0) F.rd_fb = rdoq_exact_rd(P, S, S.fb, b_fb, lam, npos);
      const float b_lev = tb_bits(P, T, S, S.lev, false, npos, ncg, tid, nt);
      if (tid == 0)
        F.use_fb = F.rd_fb < rdoq_exact_rd(P, S, S.lev, b_lev, lam, npos);
      HM_SYNC();
      if (F.use_fb)
        for (int p = tid; p < npos; p += nt) S.lev[p] = S.fb[p];
      HM_SYNC();
    }
    if (sdh) {
      rdoq_sdh(P, T, S, sel, ncg, tid, nt);
      HM_SYNC();
    }
  }

  const float bits =
      want_bits ? tb_bits(P, T, S, S.lev, sdh, npos, ncg, tid, nt) : 0.f;
  for (int p = tid; p < npos; p += nt) {
    const int l = S.sc[p] < 0 ? -S.lev[p] : S.lev[p];
    const int o = T.scans[p];
    if (lev_out) lev_out[o] = l;
    if (deq_out) {
      const int prod = l * P.iscale;
      const int s = P.dq_shift;
      const int v = s > 0 ? (prod + (1 << (s - 1))) >> s
                          : iclamp(prod, -(1 << 26), 1 << 26) * (1 << (-s));
      deq_out[o] = clip16(v);
    }
  }
  HM_SYNC();
  return bits;
}

}  // namespace hm
