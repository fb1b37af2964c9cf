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
// suffix sums of stage 3, the order-fixed float64 sums) run on thread 0,
// each over values the group computed beforehand side by side (the
// per-position costs of stage 3, the guard's distortions), and the
// argmin of stage 3 is a group reduction.
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
  int cg_pc[MAX_NCG];   // stage 1: a CG's sig pattern | ctx set << 2
  int t_sig[MAX_NCG];   // tb_bits: the priced levels' CG state
  int t_g1any[MAX_NCG];
  int t_last[MAX_NCG];
  int t_signs[MAX_NCG];
  double csbf_b[MAX_NCG], g2_b[MAX_NCG];  // tb_bits: a CG's csbf, greater-2
  float lxb[MAX_SIZE], lyb[MAX_SIZE];
  long long red[32];     // the group's reductions (hm_port.cuh)
  int last_pos, t_last_pos, use_fb;
  float bits, all_zero;
};

struct RdoqSmem {
  RdoqFixed* f;
  int *sc, *a, *maxabs, *fb, *lev, *ctx;    // scan order
  float *d0, *cost, *sigb1, *tmp, *pre;
};

// bytes of the working set for TBs up to 2^log2 on a side
HM_HD constexpr size_t rdoq_smem_bytes(int log2) {
  return sizeof(RdoqFixed) + (size_t)11 * (1 << (2 * log2)) * sizeof(int);
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
  S.ctx = ip + 5 * npos;
  float* fp = reinterpret_cast<float*>(ip + 6 * npos);
  S.d0 = fp;
  S.cost = fp + npos;
  S.sigb1 = fp + 2 * npos;
  S.tmp = fp + 3 * npos;
  S.pre = fp + 4 * npos;
  return S;
}

HM_FN float cbits(const RdoqCfg& P, int ctx, int bin) {
  return P.cb[ctx * 2 + bin];
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
  HM_GSYNC(nt);
  if (tid == 0) {
    int lp = -1;
    for (int ci = 0; ci < ncg; ++ci) lp = imax(lp, F.t_last[ci]);
    F.t_last_pos = lp;
  }
  HM_GSYNC(nt);
  const int last_pos = F.t_last_pos;
  const int last_cg = last_pos >> 4;
  // a CG's thread: its flags and the coder's walk, last to first
  // position, for each position's greater-1 context, escape base and Rice
  // parameter (S.ctx); the coded_sub_block_flag and greater-2 bits, the
  // sign count
  for (int ci = tid; ci < ncg; ci += nt) {
    const int base = ci * 16;
    const int rs = cg_flag(F.t_sig, T.right[ci], ncg);
    const int bs = cg_flag(F.t_sig, T.below[ci], ncg);
    const int cg_sig = F.t_sig[ci];
    // coded_sub_block_flag, CGs strictly between 0 and the last
    F.csbf_b[ci] = ci > 0 && ci < last_cg
                        ? cbits(P, P.sig_cg_base + (rs | bs), cg_sig)
                        : 0.0;
    // sig_coeff_flag; the DC bin is inferred when an explicitly coded
    // CG's only significance is at position 0
    const bool cg_coded = cg_sig || ci == 0;
    bool rest_zero = true;
    for (int j = 1; j < 16; ++j) rest_zero = rest_zero && A[base + j] == 0;
    const bool dc_skip = ci > 0 && ci < last_cg && cg_sig && rest_zero;
    // ctx_set: +1 when the previously processed coded CG (the nearest
    // higher index) had a greater-1; +2 for a luma CG other than 0
    int cs = 0;
    for (int j = ci + 1; j < ncg; ++j)
      if (F.t_sig[j] && j <= last_cg) {
        cs = F.t_g1any[j];
        break;
      }
    if ((P.flags & F_LUMA) && ci > 0) cs += 2;
    F.cg_pc[ci] = (rs + 2 * bs) | (cs << 2) | (cg_coded << 4) |
                  (dc_skip << 5);
    int rank = 0, g1cnt = 0, ge2cnt = 0, rice = 0, n_sig = 0;
    int g2val = -1, maxp = -1, minp = 99;
    for (int j = 15; j >= 0; --j) {
      const int a = A[base + j];
      const bool s = a > 0;
      const bool grp = s && rank < C1FLAG;
      const int c1 = g1cnt > 0 ? 0 : imin(1 + rank, 3);
      const int bse = rank < C1FLAG ? (ge2cnt > 0 ? 2 : 3) : 1;
      const bool rem = s && a >= bse;
      // grp: 1 bit, c1: 2, rem: 1, bse: 2, rice <= 4: 3
      S.ctx[base + j] = grp | (c1 << 1) | (rem << 3) | (bse << 4) |
                        (rice << 6);
      if (grp && a > 1) {
        if (g2val < 0) g2val = a > 2;
        ++g1cnt;
      }
      if (rem && a > (3 << rice)) rice = imin(rice + 1, 4);
      if (s) {
        if (a >= 2) ++ge2cnt;
        maxp = imax(maxp, j);
        minp = imin(minp, j);
        ++n_sig;
        ++rank;
      }
    }
    F.g2_b[ci] = g1cnt > 0 ? cbits(P, P.abs_base + cs, g2val) : 0.0;
    const int hide = sdh && (maxp - minp) > 3;
    F.t_signs[ci] = n_sig > 0 ? n_sig - hide : 0;
  }
  HM_GSYNC(nt);
  // every position: its sig_coeff_flag, greater-1 and remainder bits,
  // summed over the group (exact: the sums are multiples of 2^-15)
  double s1 = 0.0, s2 = 0.0, s4 = 0.0;
  for (int p = tid; p < npos; p += nt) {
    const int pc = F.cg_pc[p >> 4], cx = S.ctx[p], a = A[p];
    const bool cg_coded = (pc >> 4) & 1, dc_skip = (pc >> 5) & 1;
    if (p < last_pos && cg_coded && !((p & 15) == 0 && dc_skip))
      s1 += cbits(P, T.sig_tab[(pc & 3) * npos + p], a > 0);
    if (cx & 1)
      s2 += cbits(P, P.one_base + (pc >> 2 & 3) * 4 + ((cx >> 1) & 3),
                  a > 1);
    if ((cx >> 3) & 1)
      s4 += rem_bits(imax(a - ((cx >> 4) & 3), 0), (cx >> 6) & 7);
  }
  double* red = (double*)F.red;
  s1 = group_sum_d(s1, tid, nt, red);
  s2 = group_sum_d(s2, tid, nt, red);
  s4 = group_sum_d(s4, tid, nt, red);
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
      double s0 = 0.0, s3 = 0.0;
      for (int ci = 0; ci < ncg; ++ci) {
        signs += F.t_signs[ci];
        s0 += F.csbf_b[ci];
        s3 += F.g2_b[ci];
      }
      // the plain version's order: the five parts, the sign count before
      // the remainders
      bits = HM_FADD(bits, (float)s0);
      bits = HM_FADD(bits, (float)s1);
      bits = HM_FADD(bits, (float)s2);
      bits = HM_FADD(bits, (float)s3);
      bits = HM_FADD(bits, (float)signs);
      bits = HM_FADD(bits, (float)s4);
    }
    F.bits = bits;
  }
  HM_GSYNC(nt);
  return F.bits;
}

// ---------------------------------------------------------------------------
// the RDOQ trellis on S.maxabs -> S.lev (stages 1-3 of rdoq_tb)

HM_BIG void rdoq_trellis(const RdoqCfg& P, const Tabs& T, RdoqSmem& S,
                         float lam, int npos, int ncg, int tid, int nt) {
  RdoqFixed& F = *S.f;
  const int size = 1 << P.log2;
  HM_PH_START(t_s1);
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
  HM_GSYNC(nt);

  // ---- stage 1: level choice per position among maxAbs, maxAbs-1, 0.
  // A CG's thread walks the coder's order, last to first, for each
  // position's contexts (rank, greater-1 state, Rice parameter) as the
  // rounded levels leave them; then the positions are priced side by side.
  for (int ci = tid; ci < ncg; ci += nt) {
    const int base = ci * 16;
    const int rs = cg_flag(F.cg_sig, T.right[ci], ncg);
    const int bs = cg_flag(F.cg_sig, T.below[ci], ncg);
    int cs = 0;
    for (int j = ci + 1; j < ncg; ++j)
      if (F.cg_sig[j]) {
        cs = F.g1any[j];
        break;
      }
    if ((P.flags & F_LUMA) && ci > 0) cs += 2;
    F.cg_pc[ci] = (rs + 2 * bs) | (cs << 2);
    // the rank of the first level >= 2 (the greater-2 flag's position)
    int cnt = 0, minr = 99;
    for (int j = 15; j >= 0; --j) {
      const int m = S.maxabs[base + j];
      if (m >= 2) minr = imin(minr, cnt);
      if (m > 0) ++cnt;
    }
    cnt = 0;
    int g1cnt = 0, rice = 0;
    for (int j = 15; j >= 0; --j) {
      const int m = S.maxabs[base + j];
      const bool low = cnt < C1FLAG, has_g2 = cnt == minr;
      const int bse = low ? (has_g2 ? 3 : 2) : 1;
      const int c1 = g1cnt > 0 ? 0 : imin(1 + cnt, 3);
      // c1: 2 bits, rice <= 4: 3, bse: 2, then low, has_g2
      S.ctx[base + j] = c1 | (rice << 2) | (bse << 5) | (low << 7) |
                        (has_g2 << 8);
      if (m > 1 && cnt < C1FLAG) ++g1cnt;
      if (m > 0) ++cnt;
      if (m > 0 && m >= bse && m > (3 << rice)) rice = imin(rice + 1, 4);
    }
  }
  HM_GSYNC(nt);
  for (int p = tid; p < npos; p += nt) {
    const int pc = F.cg_pc[p >> 4], cx = S.ctx[p];
    const int patt = pc & 3, cs = pc >> 2;
    const int c1 = cx & 3, rj = (cx >> 2) & 7, bse = (cx >> 5) & 3;
    const bool low = (cx >> 7) & 1, has_g2 = (cx >> 8) & 1;
    const int a = S.a[p], m = S.maxabs[p];
    const bool scg = m > 0;
    const int sctx = T.sig_tab[patt * npos + p];
    const float sb0 = cbits(P, sctx, 0), sb1 = cbits(P, sctx, 1);
    S.sigb1[p] = sb1;
    const int one_ctx = P.one_base + cs * 4 + c1;
    const int abs_ctx = P.abs_base + cs;
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
  HM_GSYNC(nt);
  for (int ci = tid; ci < ncg; ci += nt) {
    const int base = ci * 16;
    int last = -1;
    for (int j = 15; j >= 0 && last < 0; --j)
      if (S.lev[base + j] > 0) last = base + j;
    F.cg_last[ci] = last;
  }
  HM_GSYNC(nt);
  if (tid == 0) {
    int lp = -1;
    for (int ci = 0; ci < ncg; ++ci) lp = imax(lp, F.cg_last[ci]);
    F.last_pos = lp;
  }
  HM_GSYNC(nt);
  HM_PH_STOP(HM_PH_CODE + PHC_S1, t_s1);

  // ---- stage 2: zero a CG whose coded cost loses to its all-zero cost
  HM_PH_START(t_s2);
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
  HM_GSYNC(nt);
  HM_PH_STOP(HM_PH_CODE + PHC_S2, t_s2);

  // ---- stage 3: the best last position (its sig flag refunded, the
  // last-position bits paid, the rest zeroed) against the all-zero TB.
  // Thread 0 keeps the two float64 running sums in their order (the
  // suffix of d0, the prefix of cost; each position's rounded to float32),
  // the group prices every position and takes the first of least cost.
  HM_PH_START(t_s3);
  // (eight values a step into registers, so the loads and stores do not
  // wait on the sum: npos is a multiple of 16)
  if (tid == 0) {
    double acc = 0.0;
    for (int p0 = npos - 8; p0 >= 0; p0 -= 8) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = S.d0[p0 + k];
#pragma unroll
      for (int k = 7; k >= 0; --k) {
        acc += (double)v[k];
        v[k] = (float)acc;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) S.tmp[p0 + k] = v[k];
    }
    F.all_zero = (float)acc;
    double pre = 0.0;
    for (int p0 = 0; p0 < npos; p0 += 8) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = S.cost[p0 + k];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        pre += (double)v[k];
        v[k] = (float)pre;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) S.pre[p0 + k] = v[k];
    }
  }
  HM_GSYNC(nt);
  float best = INFINITY;
  int bi = npos;   // none: loses to every position
  for (int p = tid; p < npos; p += nt) {
    const float c = S.cost[p];
    const float prefix = HM_FSUB(S.pre[p], c);
    const float lb = HM_FADD(F.lxb[T.last_x[p]], F.lyb[T.last_y[p]]);
    float v = HM_FADD(
        HM_FADD(HM_FADD(prefix, HM_FSUB(c, HM_FMUL(lam, S.sigb1[p]))),
                HM_FSUB(S.tmp[p], S.d0[p])),
        HM_FMUL(lam, lb));
    if (!(S.lev[p] > 0)) v = INFINITY;
    if (bi == npos || v < best) {
      best = v;
      bi = p;
    }
  }
  group_argmin(best, bi, tid, nt, F.red);
  const bool use_zero = F.all_zero <= best;
  for (int p = tid; p < npos; p += nt)
    if (use_zero || p > bi) S.lev[p] = 0;
  HM_GSYNC(nt);
  HM_PH_STOP(HM_PH_CODE + PHC_S3, t_s3);
}

// d(levels) + lambda * (bits + cbf) of the exact-rate guard: the
// positions' distortions side by side (into S.tmp), their float64 sum in
// order on thread 0, which alone returns it; every thread calls it
HM_FN float rdoq_exact_rd(const RdoqCfg& P, RdoqSmem& S, const int* L,
                          float bits, float lam, int npos, int tid, int nt) {
  for (int p = tid; p < npos; p += nt) S.tmp[p] = rdoq_dist(P, S.a[p], L[p]);
  HM_GSYNC(nt);
  float r = 0.f;
  if (tid == 0) {
    double d = 0.0;
    int nz = 0;
    for (int p0 = 0; p0 < npos; p0 += 8) {   // npos: a multiple of 16
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] = S.tmp[p0 + k];
        nz |= L[p0 + k];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) d += (double)v[k];
    }
    r = HM_FADD((float)d, HM_FMUL(lam, HM_FADD(bits, nz ? 1.f : 0.f)));
  }
  HM_GSYNC(nt);
  return r;
}

// sign data hiding parity (xQuant SDH branch) on S.lev, per CG; sel is
// the TB's coding scan (0 diag, 1 hor, 2 ver) or -1 for the static one
HM_BIG void rdoq_sdh(const RdoqCfg& P, const Tabs& T, RdoqSmem& S, int sel,
                     int ncg, int tid, int nt) {
  for (int ci = tid; ci < ncg; ci += nt) {
    const int base = ci * 16;
    // a position's rank in the TB's coding scan
    const int* rt = T.rank_tab + (sel < 0 ? 0 : sel * 16);
    auto rk = [&](int j) { return sel < 0 ? j : rt[j]; };
    int maxp = -1, minp = 99, asum = 0;
    for (int j = 0; j < 16; ++j) {
      const int l = S.lev[base + j];
      if (l != 0) {
        maxp = imax(maxp, rk(j));
        minp = imin(minp, rk(j));
      }
      asum += l;
    }
    int first_neg = 0;
    for (int j = 0; j < 16; ++j)
      if (S.lev[base + j] != 0 && rk(j) == minp && S.sc[base + j] < 0)
        ++first_neg;
    const bool bad = (maxp - minp) > 3 && (asum & 1) != first_neg;
    if (!bad) continue;
    float best = INFINITY, best_inc = INFINITY, best_dec = INFINITY;
    int pick = 0;
    for (int j = 0; j < 16; ++j) {
      const int l = S.lev[base + j], a = S.a[base + j];
      const float now = rdoq_dist(P, a, l);
      const bool span = rk(j) >= minp && rk(j) <= maxp;
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

  HM_PH_START(t_init);
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
  HM_GSYNC(nt);
  HM_PH_STOP(HM_PH_CODE + PHC_INIT, t_init);

  if (!lev_in) {
    if (P.flags & F_TRELLIS) {
      rdoq_trellis(P, T, S, lam, npos, ncg, tid, nt);
      // exact-rate guard: re-price the trellis result and the deadzone
      // levels with tb_bits and keep the cheaper
      HM_PH_START(t_guard);
      const float b_fb = tb_bits(P, T, S, S.fb, false, npos, ncg, tid, nt);
      const float rd_fb =
          rdoq_exact_rd(P, S, S.fb, b_fb, lam, npos, tid, nt);
      const float b_lev = tb_bits(P, T, S, S.lev, false, npos, ncg, tid, nt);
      const float rd_lev =
          rdoq_exact_rd(P, S, S.lev, b_lev, lam, npos, tid, nt);
      if (tid == 0) F.use_fb = rd_fb < rd_lev;
      HM_GSYNC(nt);
      if (F.use_fb)
        for (int p = tid; p < npos; p += nt) S.lev[p] = S.fb[p];
      HM_GSYNC(nt);
      HM_PH_STOP(HM_PH_CODE + PHC_GUARD, t_guard);
    }
    if (sdh) {
      HM_PH_START(t_sdh);
      rdoq_sdh(P, T, S, sel, ncg, tid, nt);
      HM_GSYNC(nt);
      HM_PH_STOP(HM_PH_CODE + PHC_SDH, t_sdh);
    }
  }

  HM_PH_START(t_bits);
  const float bits =
      want_bits ? tb_bits(P, T, S, S.lev, sdh, npos, ncg, tid, nt) : 0.f;
  HM_PH_STOP(HM_PH_CODE + PHC_BITS, t_bits);
  HM_PH_START(t_out);
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
  HM_GSYNC(nt);
  HM_PH_STOP(HM_PH_CODE + PHC_OUT, t_out);
  return bits;
}

}  // namespace hm
