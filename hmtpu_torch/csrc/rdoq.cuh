// K10's arithmetic, shared by its entry point (rdoq.cu) and the three
// z-scan walkers K21, K23 and K26 (walk.cuh code_tb): per TB the levels
// (the RDOQ trellis, or deadzone quantisation, then the sign-data-hiding
// parity stage), the fractional bit price of residual_coding() for them
// (tb_bits) and their dequantisation, bit-exact with the port's plain
// versions of hmtpu/ops/rdoq.py:43 rdoq_tb, hmtpu/ops/ratebits.py:161
// tb_bits and hmtpu/ops/quant.py:78,91.
//
// One lane per coefficient position (hm_port.cuh's Lanes): a 4x4
// coefficient group (CG) sits on the 16 lanes of a half-warp, its
// position j on lane j, so the coder's order (j from 15 down to 0) runs
// from the top lane.  A group of nt threads (a half-warp, one warp or
// several; the host's one thread) takes nt / 16 CGs a round.  A
// position's context state comes from votes over its CG's lanes, not
// from a walk: its rank (the significant positions after it in the
// coder's order) with the C1FLAG cap, the greater-1 and >= 2 states seen
// before it, the trellis' rank of the first level >= 2, each a popcount
// of a ballot above the lane.  The Rice parameter, the one real chain
// (0..4, monotone), steps over the set bits of the lanes that may raise
// it (rice_before).  A CG's context set reads the nearest higher coded
// CG's greater-1 flag from words of the TB's CG flags (flag_bits: at
// most 64 CGs, so one 64-bit word).  The last position's prefix bits per
// coordinate come from a table built once per launch (rdoq_last_bits).
// The exact-rate guard prices the deadzone and the trellis levels side
// by side on the group's two halves; with SDH off the TB rate of the
// kept levels is the guard's.  Shared memory holds the positions' values
// in scan order (`RdoqSmem`) and each CG's flags.
//
// Every function ends with the group's barrier, and the barriers a call
// meets depend on nt, the TB size and the flags alone, never on the
// data: so the guard's halves may share the block's barrier in a build
// without groups (hm_port.cuh: there every group syncs on the block's).
//
// Parity with the plain version, which runs the same arithmetic:
//   - every cost is float32 in the plain version's order of operations,
//     each operation rounded on its own (HM_FMUL / HM_FADD / HM_FSUB), so
//     nothing is contracted into an FMA;
//   - sums are taken in float64 and rounded once to float32, as
//     ratebits.fsum does.  The TB-rate sums are multiples of 2^-15 below
//     2^20, exact in any order, so they reduce over the lanes; the sums
//     whose order is fixed keep it on one lane (stage 2's CG sums, stage
//     3's two running sums, the guard's distortion sums, the 30-term
//     last-position sums);
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
  const float* lpb;     // (2 size,) rdoq_last_bits of this size, component
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

// The last position's prefix and suffix bits of each x coordinate of a TB
// of `size`, then of each y, before its EP bins: the 30-term float64 sums
// in k order, rounded once, that tb_bits and the trellis price (out: 2
// size floats).  The group's items tid, tid + nt, ...; the caller's
// barrier follows.  Built once per launch: by each block of K10, and by
// each walker block for every table set (walk.cuh).
HM_FN void rdoq_last_bits(const float* cb, const float* w_cnt, int ctx_x,
                          int ctx_y, int size, float* out, int tid, int nt) {
  for (int c = tid; c < 2 * size; c += nt) {
    const bool y = c >= size;
    const float* w = w_cnt + (c - (y ? size : 0)) * 30;
    const float* b = cb + 2 * (y ? ctx_y : ctx_x);
    double s = 0.0;
    for (int k = 0; k < 30; ++k) s += (double)HM_FMUL(w[k], b[k]);
    out[c] = (float)s;
  }
}

// the context bits K10 reads, from 0: the contexts below the last set of
// greater-2 contexts' end (abs_base + 4; the significance, greater-1 and
// last-position contexts lie below it), two floats each
HM_HD constexpr int rdoq_cb_floats(int abs_base) { return 2 * (abs_base + 4); }

// one pricing's CG state (tb_bits)
struct TbScr {
  unsigned short cgm[MAX_NCG];  // a CG's significant positions, bit j
  unsigned char g1[MAX_NCG];    // a level > 1 among its first C1FLAG
  double red[6 * 8];            // the group's sums (8 warps at most)
};

struct RdoqFixed {
  TbScr tb[2];                   // the guard's two pricings
  unsigned short mcgm[MAX_NCG];  // the rounded levels' significance
  unsigned short lcgm[MAX_NCG];  // stage 1's levels' significance
  unsigned char mg1[MAX_NCG];    // the rounded levels' greater-1 flag
  unsigned char zf[MAX_NCG];     // stage 2: the CG's zero cost wins
  long long red[32];             // group_argmin
  float rd[2], b[2];             // the guard's RD costs and rates
  float all_zero;
};

struct RdoqSmem {
  RdoqFixed* f;
  int *sc, *a, *maxabs, *fb, *lev;       // scan order
  float *d0, *cost, *sigb1, *tmp, *pre;
};

// bytes of the working set for TBs up to 2^log2 on a side
HM_HD constexpr size_t rdoq_smem_bytes(int log2) {
  return sizeof(RdoqFixed) + (size_t)10 * (1 << (2 * log2)) * sizeof(int);
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

HM_FN int hibit(unsigned m) { return m ? 31 - HM_CLZ(m) : -1; }
HM_FN int hibit64(unsigned long long w) {
  return w ? 63 - HM_CLZ64(w) : -1;
}

// bit c where f[c] != 0 (c < n <= 64), to every thread of the group
template <class T>
HM_FN unsigned long long flag_bits(const T* f, int n) {
  unsigned long long w = 0;
  for (int q = 0; q < n; q += 16) {
    Lanes<bool, 16> b;
    HM_LANES(j, 16) b[j] = q + j < n && f[q + j] != 0;
    w |= (unsigned long long)ballot(b) << q;
  }
  return w;
}

// CG c's bit of w (c = ncg: no neighbour)
HM_FN int cg_bit(unsigned long long w, int c, int ncg) {
  return c < ncg ? (int)((w >> c) & 1) : 0;
}

// the flag in g of the nearest CG above ci whose bit in sig is set (0 if
// none): the coder's previously processed coded CG
HM_FN int next_flag(unsigned long long sig, unsigned long long g, int ci) {
  const unsigned long long up = ci < 63 ? sig & (~0ull << (ci + 1)) : 0ull;
  return up ? (int)((g >> HM_CTZ64(up)) & 1) : 0;
}

// the steps of a level a that may raise the Rice parameter: the r in
// 0..3 with a > 3 << r (the coder's cRiceParam update, capped at 4)
HM_FN int rice_steps(int a) {
  return (a > 3) + (a > 6) + (a > 12) + (a > 24);
}

// The Rice parameter before each lane's position in the coder's order
// (lane 15 first, from 0): lane j moves it from r to r + 1 where r < t[j]
// (0 <= t[j] <= 4: rice_steps where the lane codes a remainder, else 0).
// On the card each lane steps over the set bits of the lanes above it,
// from three ballots of t's bits.
HM_FN Lanes<int, 16> rice_before(const Lanes<int, 16>& t) {
  Lanes<int, 16> r;
#if defined(__CUDACC__)
  const unsigned m0 = ballot(Lanes<bool, 16>{(t.v & 1) != 0});
  const unsigned m1 = ballot(Lanes<bool, 16>{(t.v & 2) != 0});
  const unsigned m2 = ballot(Lanes<bool, 16>{(t.v & 4) != 0});
  const int j = (int)(threadIdx.x & 15);
  unsigned m = (m0 | m1 | m2) & ~((2u << j) - 1);
  int s = 0;
  while (m) {
    const int b = 31 - __clz(m);
    m ^= 1u << b;
    const int tb = ((m0 >> b) & 1) | (((m1 >> b) & 1) << 1) |
                   (((m2 >> b) & 1) << 2);
    s += s < tb;
  }
  r.v = s;
#else
  int s = 0;
  for (int j = 15; j >= 0; --j) {
    r[j] = s;
    s += s < t[j];
  }
#endif
  return r;
}

// the float64 sum of a CG's 16 values in lane order 0..15, to every lane
HM_FN double lane_sum_ordered(const Lanes<float, 16>& v) {
  double s = 0.0;
  for (int k = 0; k < 16; ++k) s += (double)lane_get(v, k);
  return s;
}

// The CG rounds of a group: each half-warp takes one CG a round (the
// host's one thread every CG in turn); `ci` its CG, `on` whether it has
// one.  Lane 0 of the CG does the CG's own writes and sums (`lead`).
#define RDOQ_CG_ROUNDS(ci, on, ncg, tid, nt)                \
  for (int ci##_0 = 0, ci##_n = (nt) >= 16 ? (nt) >> 4 : 1; \
       ci##_0 < (ncg); ci##_0 += ci##_n)                    \
    if (const int ci = ci##_0 + ((tid) >> 4); true)         \
      if (const bool on = ci < (ncg); true)
HM_FN bool lead(int tid) { return (tid & 15) == 0; }

// ---------------------------------------------------------------------------
// tb_bits on the |levels| A (scan order) of this group's TB, with the
// scratch X; the float32 rate reaches every thread

HM_BIG float tb_bits(const RdoqCfg& P, const Tabs& T, TbScr& X,
                     const int* A, bool sdh, int npos, int ncg, int tid,
                     int nt) {
  HM_PH_START(t_fl);
  // each CG's significance and greater-1 flag
  RDOQ_CG_ROUNDS(ci, on, ncg, tid, nt) {
    Lanes<int, 16> a;
    Lanes<bool, 16> s, g;
    HM_LANES(j, 16) {
      a[j] = on ? A[ci * 16 + j] : 0;
      s[j] = a[j] > 0;
    }
    const unsigned sm = ballot(s);
    HM_LANES(j, 16) {
      g[j] = s[j] && a[j] > 1 && HM_POPC(sm >> (j + 1)) < C1FLAG;
    }
    const unsigned gm = ballot(g);
    if (on && lead(tid)) {
      X.cgm[ci] = (unsigned short)sm;
      X.g1[ci] = gm != 0;
    }
  }
  HM_GSYNC(nt);
  const unsigned long long sw = flag_bits(X.cgm, ncg);
  const unsigned long long gw = flag_bits(X.g1, ncg);
  const int last_cg = hibit64(sw);
  const int last_pos =
      last_cg < 0 ? -1 : last_cg * 16 + hibit(X.cgm[last_cg]);
  HM_PH_STOP(HM_PH_CODE + PHC_TB_FLAGS, t_fl);

  // every position's sig_coeff_flag, greater-1 and remainder bits; each
  // CG's coded_sub_block_flag, greater-2 bin and sign count
  HM_PH_START(t_pp);
  double s[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};  // csbf, sig, gt1, gt2,
                                                 // signs, remainders
  RDOQ_CG_ROUNDS(ci, on, ncg, tid, nt) {
    const unsigned sm = on ? X.cgm[ci] : 0u;
    Lanes<int, 16> a, rk, bse, t;
    Lanes<bool, 16> sv, grp, b1, b2, b3, rem;
    HM_LANES(j, 16) {
      a[j] = on ? A[ci * 16 + j] : 0;
      sv[j] = a[j] > 0;
      rk[j] = HM_POPC(sm >> (j + 1));
      grp[j] = sv[j] && rk[j] < C1FLAG;
      b1[j] = grp[j] && a[j] > 1;
      b2[j] = sv[j] && a[j] >= 2;
      b3[j] = a[j] > 2;
    }
    const unsigned g1m = ballot(b1), ge2m = ballot(b2), g2m = ballot(b3);
    HM_LANES(j, 16) {
      bse[j] = rk[j] < C1FLAG ? ((ge2m >> (j + 1)) ? 2 : 3) : 1;
      rem[j] = sv[j] && a[j] >= bse[j];
      t[j] = rem[j] ? rice_steps(a[j]) : 0;
    }
    const Lanes<int, 16> rice = rice_before(t);
    const int rs = on ? cg_bit(sw, T.right[ci], ncg) : 0;
    const int bs = on ? cg_bit(sw, T.below[ci], ncg) : 0;
    // ctx_set: +1 when the previously processed coded CG (the nearest
    // higher index) had a greater-1; +2 for a luma CG other than 0
    const int cs = next_flag(sw, gw, ci) +
                   (((P.flags & F_LUMA) && ci > 0) ? 2 : 0);
    // the DC bin is inferred when an explicitly coded CG's only
    // significance is at position 0
    const bool coded = sm != 0u || ci == 0;
    const bool dc_skip = ci > 0 && ci < last_cg && sm == 1u;
    const int* sig_tab = T.sig_tab + (rs + 2 * bs) * npos + ci * 16;
    HM_LANES(j, 16) {
      if (on && ci * 16 + j < last_pos && coded && !(j == 0 && dc_skip))
        s[1] += cbits(P, sig_tab[j], sv[j]);
      if (grp[j])
        s[2] += cbits(P,
                      P.one_base + cs * 4 +
                          ((g1m >> (j + 1)) ? 0 : imin(1 + rk[j], 3)),
                      a[j] > 1);
      if (rem[j]) s[5] += rem_bits(imax(a[j] - bse[j], 0), rice[j]);
    }
    if (on && lead(tid)) {
      if (ci > 0 && ci < last_cg)
        s[0] += cbits(P, P.sig_cg_base + (rs | bs), sm != 0u);
      if (g1m) s[3] += cbits(P, P.abs_base + cs, (g2m >> hibit(g1m)) & 1);
      if (sm)
        s[4] += HM_POPC(sm) -
                (sdh && hibit(sm) - (int)HM_CTZ64(sm) > 3 ? 1 : 0);
    }
  }
  HM_PH_STOP(HM_PH_CODE + PHC_TB_POS, t_pp);
  HM_PH_START(t_su);
  group_sums_d<6>(s, tid, nt, X.red);
  HM_PH_STOP(HM_PH_CODE + PHC_TB_SUMS, t_su);
  HM_PH_START(t_tl);
  float bits = 0.f;
  if (last_pos >= 0) {
    const int size = 1 << P.log2;
    const int lx = T.last_x[last_pos], ly = T.last_y[last_pos];
    bits = HM_FADD(HM_FADD(HM_FADD(P.lpb[lx], P.lpb[size + ly]),
                           T.ep_cnt[lx]),
                   T.ep_cnt[ly]);
    // the plain version's order: the five parts, the sign count before
    // the remainders
    for (int k = 0; k < 6; ++k) bits = HM_FADD(bits, (float)s[k]);
  }
  HM_GSYNC(nt);
  HM_PH_STOP(HM_PH_CODE + PHC_TB_TAIL, t_tl);
  return bits;
}

// ---------------------------------------------------------------------------
// the RDOQ trellis on S.maxabs -> S.lev (stages 1-3 of rdoq_tb); the
// rounded levels' CG flags (F.mcgm, F.mg1) come from the set-up

HM_BIG void rdoq_trellis(const RdoqCfg& P, const Tabs& T, RdoqSmem& S,
                         float lam, int npos, int ncg, int tid, int nt) {
  RdoqFixed& F = *S.f;
  HM_PH_START(t_s1);
  HM_PH_START(t_pre);
  const unsigned long long sw = flag_bits(F.mcgm, ncg);
  const unsigned long long gw = flag_bits(F.mg1, ncg);
  HM_PH_STOP(HM_PH_CODE + PHC_T_PRE, t_pre);

  // ---- stage 1: level choice per position among maxAbs, maxAbs-1, 0,
  // each position's contexts (rank, greater-1 state, Rice parameter) as
  // the rounded levels leave them; then each CG's stage-2 verdict: its
  // coded cost (the positions' costs summed in order) against its
  // all-zero cost
  HM_PH_START(t_s1p);
  RDOQ_CG_ROUNDS(ci, on, ncg, tid, nt) {
    const unsigned sm = on ? F.mcgm[ci] : 0u;
    Lanes<int, 16> m, a, rk, bse, t, lv;
    Lanes<float, 16> d0, cst;
    Lanes<bool, 16> b1, b2, nz;
    HM_LANES(j, 16) {
      const int p = ci * 16 + j;
      m[j] = on ? S.maxabs[p] : 0;
      a[j] = on ? S.a[p] : 0;
      d0[j] = on ? S.d0[p] : 0.f;
      rk[j] = HM_POPC(sm >> (j + 1));
      b1[j] = m[j] > 1 && rk[j] < C1FLAG;
      b2[j] = m[j] >= 2;
    }
    const unsigned g1m = ballot(b1), g2m = ballot(b2);
    // the rank of the first level >= 2 (the greater-2 flag's position)
    const int minr = g2m ? HM_POPC(sm >> (hibit(g2m) + 1)) : 99;
    HM_LANES(j, 16) {
      bse[j] = rk[j] < C1FLAG ? (rk[j] == minr ? 3 : 2) : 1;
      t[j] = (m[j] > 0 && m[j] >= bse[j]) ? rice_steps(m[j]) : 0;
    }
    const Lanes<int, 16> rice = rice_before(t);
    const int rs = on ? cg_bit(sw, T.right[ci], ncg) : 0;
    const int bs = on ? cg_bit(sw, T.below[ci], ncg) : 0;
    const int cs = next_flag(sw, gw, ci) +
                   (((P.flags & F_LUMA) && ci > 0) ? 2 : 0);
    const int* sig_tab = T.sig_tab + (rs + 2 * bs) * npos + ci * 16;
    const int one_ctx = P.one_base + cs * 4, abs_ctx = P.abs_base + cs;
    HM_LANES(j, 16) {
      const int p = ci * 16 + j;
      const bool low = rk[j] < C1FLAG, has_g2 = rk[j] == minr;
      const int c1 = (g1m >> (j + 1)) ? 0 : imin(1 + rk[j], 3);
      const int b = bse[j], rj = rice[j], aj = a[j], mj = m[j];
      const int sctx = on ? sig_tab[j] : 0;
      const float sb0 = cbits(P, sctx, 0), sb1 = cbits(P, sctx, 1);
      // bits of |level| l > 0 without the sig flag, then the RD cost
      auto cost_nz = [&](int l) {
        const bool g1 = l > 1;
        float r = low ? cbits(P, one_ctx + c1, g1) : 0.f;
        r = HM_FADD(r, (has_g2 && g1 && low) ? cbits(P, abs_ctx, l > 2)
                                             : 0.f);
        r = HM_FADD(r, l >= b ? rem_bits(imax(l - b, 0), rj) : 0.f);
        r = HM_FADD(r, 1.f);
        return HM_FADD(rdoq_dist(P, aj, l), HM_FMUL(lam, HM_FADD(r, sb1)));
      };
      const bool scg = mj > 0;
      const float c_max = cost_nz(mj);
      const int cand2 = imax(mj - 1, 0);
      const float c_dec = cand2 > 0 ? cost_nz(cand2) : INFINITY;
      const float c_zero = HM_FADD(d0[j], HM_FMUL(lam, sb0));
      lv[j] = (scg && c_dec < c_max && c_dec < c_zero)
                  ? cand2
                  : ((scg && c_zero <= c_max) ? 0 : mj);
      cst[j] = scg ? fminf(c_max, fminf(c_dec, c_zero)) : d0[j];
      nz[j] = lv[j] > 0;
      if (on) {
        S.lev[p] = lv[j];
        S.cost[p] = cst[j];
        S.sigb1[p] = sb1;
      }
    }
    const unsigned lm = ballot(nz);
    const double sc = lane_sum_ordered(cst), sd = lane_sum_ordered(d0);
    if (on && lead(tid)) {
      const int csbf = P.sig_cg_base + (rs | bs);
      const float coded =
          HM_FADD((float)sc, HM_FMUL(lam, cbits(P, csbf, 1)));
      const float zero = HM_FADD((float)sd, HM_FMUL(lam, cbits(P, csbf, 0)));
      F.lcgm[ci] = (unsigned short)lm;
      F.zf[ci] = zero < coded;
    }
  }
  HM_GSYNC(nt);
  HM_PH_STOP(HM_PH_CODE + PHC_T_S1P, t_s1p);
  HM_PH_STOP(HM_PH_CODE + PHC_S1, t_s1);

  // ---- stage 2: zero each CG strictly between the first and the last
  // coded one (stage 1's levels) whose all-zero cost wins (zw: its bit)
  HM_PH_START(t_s2);
  const int last_cg = hibit64(flag_bits(F.lcgm, ncg));
  const unsigned long long zw =
      last_cg > 1 ? flag_bits(F.zf, ncg) & (((1ull << last_cg) - 1) & ~1ull)
                  : 0ull;
  HM_PH_STOP(HM_PH_CODE + PHC_S2, t_s2);

  // ---- stage 3: the best last position (its sig flag refunded, the
  // last-position bits paid, the rest zeroed) against the all-zero TB.
  // The two float64 running sums keep their order, side by side on the
  // group's threads 0 and 1 (one after the other on the host): the suffix
  // sums of d0 (S.tmp; the whole is the all-zero cost) and the prefix
  // sums of the costs after stage 2 (S.pre), each position's rounded to
  // float32; eight values a step in registers (npos: a multiple of 16)
  HM_PH_START(t_s3);
  for (int k = tid; k < 2; k += nt) {
    const bool suf = k == 0;
    float* out = suf ? S.tmp : S.pre;
    double acc = 0.0;
    for (int i = 0; i < npos; i += 8) {
      float v[8];
      HM_UNROLL
      for (int q = 0; q < 8; ++q) {
        const int p = suf ? npos - 1 - (i + q) : i + q;
        v[q] = (suf || ((zw >> (p >> 4)) & 1)) ? S.d0[p] : S.cost[p];
      }
      HM_UNROLL
      for (int q = 0; q < 8; ++q) {
        acc += (double)v[q];
        v[q] = (float)acc;
      }
      HM_UNROLL
      for (int q = 0; q < 8; ++q) out[suf ? npos - 1 - (i + q) : i + q] = v[q];
    }
    if (suf) F.all_zero = (float)acc;
  }
  HM_GSYNC(nt);
  const int size = 1 << P.log2;
  float best = INFINITY;
  int bi = npos;   // none: loses to every position
  for (int p = tid; p < npos; p += nt) {
    const bool zc = (zw >> (p >> 4)) & 1;
    const float c = zc ? S.d0[p] : S.cost[p];
    const int lv = zc ? 0 : S.lev[p];
    const float prefix = HM_FSUB(S.pre[p], c);
    const int lx = T.last_x[p], ly = T.last_y[p];
    const float lb = HM_FADD(HM_FADD(P.lpb[lx], T.ep_cnt[lx]),
                             HM_FADD(P.lpb[size + ly], T.ep_cnt[ly]));
    float v = HM_FADD(
        HM_FADD(HM_FADD(prefix, HM_FSUB(c, HM_FMUL(lam, S.sigb1[p]))),
                HM_FSUB(S.tmp[p], S.d0[p])),
        HM_FMUL(lam, lb));
    if (!(lv > 0)) v = INFINITY;
    if (bi == npos || v < best) {
      best = v;
      bi = p;
    }
  }
  group_argmin(best, bi, tid, nt, F.red);
  const bool use_zero = F.all_zero <= best;
  for (int p = tid; p < npos; p += nt)
    if (use_zero || p > bi || ((zw >> (p >> 4)) & 1)) S.lev[p] = 0;
  HM_GSYNC(nt);
  HM_PH_STOP(HM_PH_CODE + PHC_S3, t_s3);
}

// d(levels) + lambda * (bits + cbf) of the exact-rate guard: the
// positions' distortions summed in position order in float64 by the
// group's thread 0, which alone returns it
HM_FN float rdoq_exact_rd(const RdoqCfg& P, const RdoqSmem& S, const int* L,
                          float bits, float lam, int npos, int tid) {
  if (tid != 0) return 0.f;
  double d = 0.0;
  int nz = 0;
  for (int p0 = 0; p0 < npos; p0 += 8) {   // npos: a multiple of 16
    float v[8];
    HM_UNROLL
    for (int k = 0; k < 8; ++k) {
      v[k] = rdoq_dist(P, S.a[p0 + k], L[p0 + k]);
      nz |= L[p0 + k];
    }
    HM_UNROLL
    for (int k = 0; k < 8; ++k) d += (double)v[k];
  }
  return HM_FADD((float)d, HM_FMUL(lam, HM_FADD(bits, nz ? 1.f : 0.f)));
}

// the guard's pricing h (0: the deadzone levels, 1: the trellis's) on a
// group of nt threads: its rate and RD cost into F.b[h], F.rd[h]
HM_FN void rdoq_price(const RdoqCfg& P, const Tabs& T, RdoqSmem& S, int h,
                      float lam, int npos, int ncg, int tid, int nt) {
  const int* L = h ? S.lev : S.fb;
  const float b = tb_bits(P, T, S.f->tb[h], L, false, npos, ncg, tid, nt);
  HM_PH_START(t_x);
  const float r = rdoq_exact_rd(P, S, L, b, lam, npos, tid);
  if (tid == 0) {
    S.f->b[h] = b;
    S.f->rd[h] = r;
  }
  HM_PH_STOP(HM_PH_CODE + PHC_XRD, t_x);
}

// sign data hiding parity (xQuant SDH branch) on S.lev, per CG; sel is
// the TB's coding scan (0 diag, 1 hor, 2 ver) or -1 for the static one
HM_BIG void rdoq_sdh(const RdoqCfg& P, const Tabs& T, RdoqSmem& S, int sel,
                     int ncg, int tid, int nt) {
  const int* rt = T.rank_tab + (sel < 0 ? 0 : sel * 16);
  RDOQ_CG_ROUNDS(ci, on, ncg, tid, nt) {
    Lanes<int, 16> l, a, rk;
    Lanes<unsigned, 16> rb;
    Lanes<bool, 16> neg;
    HM_LANES(j, 16) {
      l[j] = on ? S.lev[ci * 16 + j] : 0;
      a[j] = on ? S.a[ci * 16 + j] : 0;
      // a position's rank in the TB's coding scan
      rk[j] = sel < 0 ? j : rt[j];
      rb[j] = l[j] != 0 ? 1u << rk[j] : 0u;
    }
    const unsigned rm = lane_or(rb);   // the ranks of the nonzero levels
    const int maxp = hibit(rm), minp = rm ? (int)HM_CTZ64(rm) : 99;
    HM_LANES(j, 16) {
      neg[j] = rb[j] != 0u && rk[j] == minp && S.sc[ci * 16 + j] < 0;
    }
    const int first_neg = HM_POPC(ballot(neg));
    const int asum = lane_sum(l);
    if (!((maxp - minp) > 3 && (asum & 1) != first_neg)) continue;
    Lanes<float, 16> m, inc, dec;
    Lanes<int, 16> key;
    HM_LANES(j, 16) {
      key[j] = j;
      const float now = rdoq_dist(P, a[j], l[j]);
      const bool span = rk[j] >= minp && rk[j] <= maxp;
      inc[j] = (span && l[j] < COEFF_MAX)
                   ? HM_FSUB(rdoq_dist(P, a[j], l[j] + 1), now)
                   : INFINITY;
      dec[j] = (span && l[j] > 1) ? HM_FSUB(rdoq_dist(P, a[j], l[j] - 1), now)
                                  : INFINITY;
      m[j] = fminf(inc[j], dec[j]);
    }
    float best;
    int pick;
    lane_argmin(m, key, best, pick);
    HM_LANES(j, 16) {
      if (j == pick) S.lev[ci * 16 + j] = l[j] + (inc[j] <= dec[j] ? 1 : -1);
    }
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
  const bool trellis = !lev_in && (P.flags & F_TRELLIS);
  const bool sdh = P.flags & F_SDH;
  ph_code(true);

  HM_PH_START(t_init);
  RDOQ_CG_ROUNDS(ci, on, ncg, tid, nt) {
    Lanes<int, 16> m;
    Lanes<bool, 16> s, g;
    HM_LANES(j, 16) {
      const int p = ci * 16 + j;
      m[j] = 0;
      if (on) {
        const int v = x[T.scans[p]];
        const int a = iabs(v);
        S.sc[p] = v;
        S.a[p] = a;
        if (lev_in) {
          S.lev[p] = a;
        } else {
          // int32 is enough: a <= 2^15, scale < 2^15, the offsets < 2^27
          m[j] = imin((a * P.scale + (1 << (P.qbits - 1))) >> P.qbits,
                      COEFF_MAX);
          S.maxabs[p] = m[j];
          S.fb[p] = imin((a * P.scale + P.add) >> P.qbits, COEFF_MAX);
          const float af = (float)a;
          S.d0[p] = HM_FMUL(HM_FMUL(af, af), P.cscale);
          S.lev[p] = S.fb[p];
        }
      }
      s[j] = m[j] > 0;
    }
    if (trellis) {
      // the rounded levels' significance and greater-1 flag per CG
      const unsigned sm = ballot(s);
      HM_LANES(j, 16) {
        g[j] = m[j] > 1 && HM_POPC(sm >> (j + 1)) < C1FLAG;
      }
      const unsigned gm = ballot(g);
      if (on && lead(tid)) {
        F.mcgm[ci] = (unsigned short)sm;
        F.mg1[ci] = gm != 0;
      }
    }
  }
  HM_GSYNC(nt);
  HM_PH_STOP(HM_PH_CODE + PHC_INIT, t_init);

  bool use_fb = false;
  if (trellis) {
    rdoq_trellis(P, T, S, lam, npos, ncg, tid, nt);
    // exact-rate guard: the deadzone levels and the trellis result priced
    // with tb_bits, side by side on the group's halves (one after the
    // other on a half-warp or the host's thread), the cheaper kept
    HM_PH_START(t_guard);
    if (nt >= 32) {
      const int hn = nt >> 1, h = tid >= hn;
      rdoq_price(P, T, S, h, lam, npos, ncg, tid - h * hn, hn);
    } else {
      for (int h = 0; h < 2; ++h)
        rdoq_price(P, T, S, h, lam, npos, ncg, tid, nt);
    }
    HM_GSYNC(nt);
    use_fb = F.rd[0] < F.rd[1];
    if (use_fb)
      for (int p = tid; p < npos; p += nt) S.lev[p] = S.fb[p];
    HM_GSYNC(nt);
    HM_PH_STOP(HM_PH_CODE + PHC_GUARD, t_guard);
  }
  if (sdh && !lev_in) {
    HM_PH_START(t_sdh);
    rdoq_sdh(P, T, S, sel, ncg, tid, nt);
    HM_GSYNC(nt);
    HM_PH_STOP(HM_PH_CODE + PHC_SDH, t_sdh);
  }

  // the TB rate; with the trellis and SDH off, the guard's price of the
  // levels it kept (the same function on the same levels)
  HM_PH_START(t_bits);
  float bits = 0.f;
  if (want_bits)
    bits = (trellis && !sdh)
               ? (use_fb ? F.b[0] : F.b[1])
               : tb_bits(P, T, F.tb[0], S.lev, sdh, npos, ncg, tid, nt);
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
  ph_code(false);
  return bits;
}

}  // namespace hm
