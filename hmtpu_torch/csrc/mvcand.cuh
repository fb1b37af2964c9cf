// The z-scan's motion-candidate derivations and their rate pieces, one
// lane (one CU) per call, shared by K17 merge_cands and K18 amvp_rd
// (mvcand.cu) and meant for the z-scan walkers (ROADMAP queue B: B11,
// B14) that will include them.  Plain arguments only (no torch types).
//
//   merge_list_p   8.5.3.1.2 (P): spatial candidates, the temporal one
//                  appended unpruned, the zero fill
//                  (hmtpu/search/wavefront.py:295 merge_candidates_dev)
//   merge_list_b   8.5.3.1.2-3 (B): full-motion pruning, the 12-pair
//                  combined bi-predictive candidates, the dir=3 zero fill
//                  (hmtpu/search/wavefront.py:357 merge_candidates_dev_b)
//   scale_mv       8.5.3.1.3 (hmtpu/search/wavefront.py:479 _scale_mv_dev)
//   amvp_p/amvp_b  8.5.3.1.5/6 (hmtpu/search/wavefront.py:497, :519) over
//                  amvp_assemble (:571)
//   mvd_bits, ref_idx_bits, inter_dir_bits
//                  hmtpu/ops/ratebits.py:439, :399, :429, with ep_eg1_bits
//   merge_lane, amvp_lane
//                  one lane of K17 / K18 over the kernels' flat arrays
//
// Neighbour slots are in the order [A1, B1, B0, A0, B2] throughout.
// Every integer step is the reference's: arithmetic right shifts of
// negative products, C-truncating division for tx.  Float sums are
// rounded one addition at a time in the reference's order (no
// contraction: additions only).  The file also compiles as host C++, so
// the lane logic can be checked without a card.
#pragma once

#include <stddef.h>

#if defined(__CUDACC__)
#define MVC_FN __device__ __forceinline__
#define MVC_FADD(a, b) __fadd_rn((a), (b))
#else
#define MVC_FN inline
#define MVC_FADD(a, b) ((a) + (b))
#endif

namespace mvc {

constexpr int kA1 = 0, kB1 = 1, kB0 = 2, kA0 = 3, kB2 = 4;
constexpr int kMaxMerge = 5;

MVC_FN int imin(int a, int b) { return a < b ? a : b; }
MVC_FN int imax(int a, int b) { return a > b ? a : b; }
MVC_FN int iclamp(int v, int lo, int hi) { return imin(imax(v, lo), hi); }
MVC_FN int iabs(int v) { return v < 0 ? -v : v; }

// floor(log2(x)) for x >= 1
MVC_FN int floor_log2(int x) {
  int n = 0;
  while (x > 1) {
    x >>= 1;
    ++n;
  }
  return n;
}

// One neighbour's motion.  dir: bit 0 list 0, bit 1 list 1 (P: 1).
struct Motion {
  int valid, dir, mvx0, mvy0, ref0, mvx1, mvy1, ref1;
};

// ---------------------------------------------------------------------------
// merge lists

// P: (B, M) columns of one lane; t_ok/t_mvx/t_mvy the temporal candidate
// (t_ok 0 when there is none), `limit` the zero fill's reference count
MVC_FN void merge_list_p(const Motion* nb, int t_ok, int t_mvx, int t_mvy,
                         int max_merge, int limit, int* cmx, int* cmy,
                         int* crf) {
  auto same = [&](int i, int j) {
    return nb[i].valid && nb[j].valid && nb[i].mvx0 == nb[j].mvx0 &&
           nb[i].mvy0 == nb[j].mvy0 && nb[i].ref0 == nb[j].ref0;
  };
  int incl[6];
  incl[0] = nb[kA1].valid;
  incl[1] = nb[kB1].valid && !same(kB1, kA1);
  incl[2] = nb[kB0].valid && !same(kB0, kB1);
  incl[3] = nb[kA0].valid && !same(kA0, kA1);
  const int cnt4 = incl[0] + incl[1] + incl[2] + incl[3];
  incl[4] = nb[kB2].valid && !same(kB2, kA1) && !same(kB2, kB1) && cnt4 < 4;
  incl[5] = t_ok != 0;
  int n = 0;
  for (int k = 0; k < 6; ++k) {
    if (!incl[k]) continue;
    if (n < max_merge) {
      cmx[n] = k < 5 ? nb[k].mvx0 : t_mvx;
      cmy[n] = k < 5 ? nb[k].mvy0 : t_mvy;
      crf[n] = k < 5 ? nb[k].ref0 : 0;
    }
    ++n;
  }
  for (int k = n; k < max_merge; ++k) {
    cmx[k] = 0;
    cmy[k] = 0;
    crf[k] = k - n < limit ? k - n : 0;
  }
}

// B: the lane's list as seven columns; pocs0/pocs1 the lists' POCs
// (r0/r1 entries), for the combined candidates' identity check
MVC_FN void merge_list_b(const Motion* nb, const int* pocs0, const int* pocs1,
                         int r0, int r1, int max_merge, int* cdir, int* cx0,
                         int* cy0, int* cr0, int* cx1, int* cy1, int* cr1) {
  auto same = [&](int i, int j) {
    const Motion &a = nb[i], &b = nb[j];
    const int ua0 = a.dir & 1, ub0 = b.dir & 1;
    const int ua1 = a.dir & 2, ub1 = b.dir & 2;
    const bool eq0 = !(ua0 || ub0) || (ua0 && ub0 && a.mvx0 == b.mvx0 &&
                                       a.mvy0 == b.mvy0 && a.ref0 == b.ref0);
    const bool eq1 = !(ua1 || ub1) || (ua1 && ub1 && a.mvx1 == b.mvx1 &&
                                       a.mvy1 == b.mvy1 && a.ref1 == b.ref1);
    return a.valid && b.valid && a.dir == b.dir && eq0 && eq1;
  };
  int incl[5];
  incl[0] = nb[kA1].valid;
  incl[1] = nb[kB1].valid && !same(kB1, kA1);
  incl[2] = nb[kB0].valid && !same(kB0, kB1);
  incl[3] = nb[kA0].valid && !same(kA0, kA1);
  const int cnt4 = incl[0] + incl[1] + incl[2] + incl[3];
  incl[4] = nb[kB2].valid && !same(kB2, kA1) && !same(kB2, kB1) && cnt4 < 4;
  for (int k = 0; k < max_merge; ++k)
    cdir[k] = cx0[k] = cy0[k] = cr0[k] = cx1[k] = cy1[k] = cr1[k] = 0;
  int n = 0;
  for (int k = 0; k < 5; ++k) {
    if (!incl[k]) continue;
    if (n < max_merge) {
      cdir[n] = nb[k].dir;
      cx0[n] = nb[k].mvx0;
      cy0[n] = nb[k].mvy0;
      cr0[n] = nb[k].ref0;
      cx1[n] = nb[k].mvx1;
      cy1[n] = nb[k].mvy1;
      cr1[n] = nb[k].ref1;
    }
    ++n;
  }
  const int n_sp = imin(n, max_merge);
  // the combined candidates, (l0Cand, l1Cand) pairs in the spec's
  // priority order, read the spatial entries (below n_sp) and land at
  // n_sp and after; those past the list are dropped
  const int l0c[12] = {0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3};
  const int l1c[12] = {1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2};
  int nc = 0;
  for (int p = 0; p < 12; ++p) {
    const int i0 = l0c[p], i1 = l1c[p];
    if (i0 >= max_merge || i1 >= max_merge) continue;
    if (!(n_sp > i0 && n_sp > i1 && p < n_sp * (n_sp - 1))) continue;
    if (!(cdir[i0] & 1) || !(cdir[i1] & 2)) continue;
    const int poc0 = pocs0[iclamp(cr0[i0], 0, r0 - 1)];
    const int poc1 = pocs1[iclamp(cr1[i1], 0, r1 - 1)];
    if (poc0 == poc1 && cx0[i0] == cx1[i1] && cy0[i0] == cy1[i1]) continue;
    const int s = n_sp + nc;
    if (s < max_merge) {
      const int x0 = cx0[i0], y0 = cy0[i0], f0 = cr0[i0];
      const int x1 = cx1[i1], y1 = cy1[i1], f1 = cr1[i1];
      cdir[s] = 3;
      cx0[s] = x0;
      cy0[s] = y0;
      cr0[s] = f0;
      cx1[s] = x1;
      cy1[s] = y1;
      cr1[s] = f1;
    }
    ++nc;
  }
  const int n_tot = imin(n_sp + nc, max_merge);
  const int nr = imin(r0, r1);
  for (int k = n_tot; k < max_merge; ++k) {
    const int r = k - n_tot < nr ? k - n_tot : 0;
    cdir[k] = 3;
    cx0[k] = cy0[k] = cx1[k] = cy1[k] = 0;
    cr0[k] = cr1[k] = r;
  }
}

// ---------------------------------------------------------------------------
// AMVP

// 8.5.3.1.3: scale (mvx, mvy) from POC distance td to tb; unchanged when
// td == tb
MVC_FN void scale_mv(int mvx, int mvy, int tb, int td, int* ox, int* oy) {
  if (td == tb) {
    *ox = mvx;
    *oy = mvy;
    return;
  }
  const int abs_td = iabs(td);
  const int num = 16384 + (abs_td >> 1);
  const int tx = td > 0 ? num / imax(td, 1) : -(num / imax(abs_td, 1));
  const int dsf = iclamp((tb * tx + 32) >> 6, -4096, 4095);
  const int px = dsf * mvx, py = dsf * mvy;
  const int mx = (iabs(px) + 127) >> 8, my = (iabs(py) + 127) >> 8;
  *ox = iclamp(px >= 0 ? mx : -mx, -32768, 32767);
  *oy = iclamp(py >= 0 ? my : -my, -32768, 32767);
}

// the first slot of `slots` whose flag is set, or slots[0] when none is
MVC_FN int first_of(const int* flags, const int* slots, int n, int* found) {
  for (int k = 0; k < n; ++k)
    if (flags[slots[k]]) {
      *found = 1;
      return slots[k];
    }
  *found = 0;
  return slots[0];
}

// 8.5.3.1.6's A/B derivation and the list [a?, b?, t?, (0, 0)...]:
// valid, unscaled (same-POC) flags, their MVs (ux, uy) and the scaled
// MVs (sx, sy) per slot
MVC_FN void amvp_assemble(const int* valid, const int* unscaled,
                          const int* ux, const int* uy, const int* sx,
                          const int* sy, int t_ok, int t_mvx, int t_mvy,
                          int* mvp) {
  const int a_slots[2] = {kA0, kA1};
  const int b_slots[3] = {kB0, kB1, kB2};
  int a_u_f, a_s_f, b_u_f, b_s_f;
  const int a_u = first_of(unscaled, a_slots, 2, &a_u_f);
  const int a_s = first_of(valid, a_slots, 2, &a_s_f);
  const int b_u = first_of(unscaled, b_slots, 3, &b_u_f);
  const int b_s = first_of(valid, b_slots, 3, &b_s_f);
  int found_a = a_u_f || a_s_f;
  int ax = a_u_f ? ux[a_u] : sx[a_s], ay = a_u_f ? uy[a_u] : sy[a_s];
  const int a_has_inter = valid[kA0] || valid[kA1];
  // isScaledFlagLX == 0: B's same-POC candidate moves into the A slot and
  // B re-derives with scaling allowed
  int bx, by, found_b;
  if (a_has_inter) {
    bx = ux[b_u];
    by = uy[b_u];
    found_b = b_u_f;
  } else {
    ax = ux[b_u];
    ay = uy[b_u];
    found_a = b_u_f;
    bx = sx[b_s];
    by = sy[b_s];
    found_b = b_s_f;
  }
  if (found_a && found_b && ax == bx && ay == by) found_b = 0;
  if (!t_ok) t_mvx = t_mvy = 0;
  mvp[0] = found_a ? ax : found_b ? bx : t_ok ? t_mvx : 0;
  mvp[1] = found_a ? ay : found_b ? by : t_ok ? t_mvy : 0;
  const int second_b = found_a && found_b;
  const int second_t = !second_b && (found_a || found_b) && t_ok;
  mvp[2] = second_b ? bx : second_t ? t_mvx : 0;
  mvp[3] = second_b ? by : second_t ? t_mvy : 0;
}

// P: nb_refpoc the POC of each neighbour's reference, target_poc the
// block's own; mvp = (mvp0x, mvp0y, mvp1x, mvp1y)
MVC_FN void amvp_p(const Motion* nb, const int* nb_refpoc, int target_poc,
                   int cur_poc, int t_ok, int t_mvx, int t_mvy, int* mvp) {
  int valid[5], unscaled[5], ux[5], uy[5], sx[5], sy[5];
  const int tb = cur_poc - target_poc;
  for (int s = 0; s < 5; ++s) {
    valid[s] = nb[s].valid;
    unscaled[s] = nb[s].valid && nb_refpoc[s] == target_poc;
    ux[s] = nb[s].mvx0;
    uy[s] = nb[s].mvy0;
    scale_mv(nb[s].mvx0, nb[s].mvy0, tb, cur_poc - nb_refpoc[s], &sx[s],
             &sy[s]);
  }
  amvp_assemble(valid, unscaled, ux, uy, sx, sy, t_ok, t_mvx, t_mvy, mvp);
}

// B: the neighbour candidate may come from either of its lists: a same-POC
// match in the order (LX, LY), else the first present list scaled.  poc0 /
// poc1 the POCs of each neighbour's references, lx the block's list.
MVC_FN void amvp_b(const Motion* nb, const int* poc0, const int* poc1, int lx,
                   int target_poc, int cur_poc, int t_ok, int t_mvx,
                   int t_mvy, int* mvp) {
  int valid[5], unscaled[5], ux[5], uy[5], sx[5], sy[5];
  const int tb = cur_poc - target_poc;
  for (int s = 0; s < 5; ++s) {
    const Motion& m = nb[s];
    const int u0 = (m.dir & 1) != 0, u1 = (m.dir & 2) != 0;
    const int usex = (lx == 0 ? u0 : u1) && m.valid;
    const int usey = (lx == 0 ? u1 : u0) && m.valid;
    const int mxx = lx == 0 ? m.mvx0 : m.mvx1, mxy = lx == 0 ? m.mvy0 : m.mvy1;
    const int myx = lx == 0 ? m.mvx1 : m.mvx0, myy = lx == 0 ? m.mvy1 : m.mvy0;
    const int pxp = lx == 0 ? poc0[s] : poc1[s];
    const int pyp = lx == 0 ? poc1[s] : poc0[s];
    const int hitx = usex && pxp == target_poc;
    const int hity = usey && pyp == target_poc;
    valid[s] = m.valid;
    unscaled[s] = hitx || hity;
    ux[s] = hitx ? mxx : myx;
    uy[s] = hitx ? mxy : myy;
    if (unscaled[s]) {
      sx[s] = ux[s];
      sy[s] = uy[s];
    } else {
      scale_mv(usex ? mxx : myx, usex ? mxy : myy, tb,
               cur_poc - (usex ? pxp : pyp), &sx[s], &sy[s]);
    }
  }
  amvp_assemble(valid, unscaled, ux, uy, sx, sy, t_ok, t_mvx, t_mvy, mvp);
}

// ---------------------------------------------------------------------------
// rate pieces; tab is the flat (NUM_CTX * 2) fractional-bit table

// EP bits of the k=1 exp-Golomb MVD remainder
MVC_FN float ep_eg1_bits(int u) {
  return (float)(2 * floor_log2((u >> 1) + 1) + 2);
}

// mvd_coding (7.3.8.9) of both components: from 0, x then y, each in the
// order ctx bin 0, ctx bin 1, EG1 remainder, sign
MVC_FN float mvd_bits(const float* tab, int ctx_mvd, int dx, int dy) {
  float total = 0.0f;
  const int v[2] = {dx, dy};
  for (int k = 0; k < 2; ++k) {
    const int av = iabs(v[k]);
    total = MVC_FADD(total, tab[2 * ctx_mvd + (av > 0)]);
    total = MVC_FADD(total, av > 0 ? tab[2 * (ctx_mvd + 1) + (av > 1)] : 0.0f);
    total = MVC_FADD(total, av > 1 ? ep_eg1_bits(av - 2) : 0.0f);
    total = MVC_FADD(total, av > 0 ? 1.0f : 0.0f);
  }
  return total;
}

// ref_idx_lX truncated unary with cMax = cmax (0: nothing coded)
MVC_FN float ref_idx_bits(const float* tab, int ctx_ref, int r, int cmax) {
  if (cmax < 1) return 0.0f;
  float b = tab[2 * ctx_ref + (r > 0)];
  if (cmax >= 2) {
    b = MVC_FADD(b, r > 0 ? tab[2 * (ctx_ref + 1) + (r > 1)] : 0.0f);
    const int ep = imax(imin(r, cmax) - 2, 0) + (r >= 2 && r < cmax);
    b = MVC_FADD(b, (float)ep);
  }
  return b;
}

// inter_pred_idc (9.3.3.7, the 2Nx2N form): bin 0 on ctx CtDepth, bin 1
// on ctx 4 when not bi
MVC_FN float inter_dir_bits(const float* tab, int ctx_dir, int inter_dir,
                            int depth) {
  const int bi = inter_dir == 3;
  const float b = tab[2 * (ctx_dir + depth) + bi];
  return MVC_FADD(b, bi ? 0.0f : tab[2 * (ctx_dir + 4) + (inter_dir == 2)]);
}

// ---------------------------------------------------------------------------
// one lane of K17 and K18 over flat arrays (the kernels' thread bodies)

// nb: (B, 5, C) int32, C = 4 [valid, mvx, mvy, ref] (P) or
// C = 8 [valid, dir, mvx0, mvy0, ref0, mvx1, mvy1, ref1] (B);
// t: (B, 3) [ok, mvx, mvy] or null; out: (3 or 7, B, M) int32
MVC_FN void merge_lane(const int* nb, const int* t, const int* pocs0,
                       const int* pocs1, int* out, int lane, int B, int C,
                       int M, int limit, int r0, int r1) {
  const int* row = nb + (size_t)lane * 5 * C;
  Motion m[5];
  for (int s = 0; s < 5; ++s) {
    const int* r = row + s * C;
    if (C == 4) {
      m[s] = Motion{r[0], 1, r[1], r[2], r[3], 0, 0, 0};
    } else {
      m[s] = Motion{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7]};
    }
  }
  const size_t plane = (size_t)B * M;
  int* o = out + (size_t)lane * M;
  if (C == 4) {
    int cmx[kMaxMerge], cmy[kMaxMerge], crf[kMaxMerge];
    const int* tl = t ? t + (size_t)lane * 3 : nullptr;
    merge_list_p(m, tl ? tl[0] : 0, tl ? tl[1] : 0, tl ? tl[2] : 0, M, limit,
                 cmx, cmy, crf);
    for (int k = 0; k < M; ++k) {
      o[k] = cmx[k];
      o[plane + k] = cmy[k];
      o[2 * plane + k] = crf[k];
    }
  } else {
    int c[7][kMaxMerge];
    merge_list_b(m, pocs0, pocs1, r0, r1, M, c[0], c[1], c[2], c[3], c[4],
                 c[5], c[6]);
    for (int j = 0; j < 7; ++j)
      for (int k = 0; k < M; ++k) o[j * plane + k] = c[j][k];
  }
}

struct AmvpArgs {
  int B, S;                       // lanes, columns of a state row
  int c_dir, c_mvx, c_mvy, c_ref, c_mvx1, c_mvy1, c_ref1;
  int cur_poc, r0, r1, cmax0, cmax1, depth;
  int ctx_mvd, ctx_ref, ctx_dir;  // context offsets (entropy/contexts.py)
};

// nbv: (B, 5) valid; nbp: (B, 5, S) the neighbours' state rows; lx: (B,)
// list per lane (B slices) or null (P); t: (B, 3) or null;
// oi: (10, B) [use1, mvdx, mvdy, dir, mvx0, mvy0, ref0, mvx1, mvy1, ref1];
// of: (2, B) [mvd bits, ref_idx (+ inter_pred_idc) bits]
MVC_FN void amvp_lane(const int* nbv, const int* nbp, const int* aref,
                      const int* amx, const int* amy, const int* lx,
                      const int* t, const int* pocs0, const int* pocs1,
                      const float* tab, int* oi, float* of, int lane,
                      const AmvpArgs& a) {
  Motion m[5];
  int poc0[5], poc1[5];
  for (int s = 0; s < 5; ++s) {
    const int* r = nbp + ((size_t)lane * 5 + s) * a.S;
    m[s] = Motion{nbv[lane * 5 + s], r[a.c_dir], r[a.c_mvx], r[a.c_mvy],
                  r[a.c_ref], r[a.c_mvx1], r[a.c_mvy1], r[a.c_ref1]};
    poc0[s] = pocs0[iclamp(m[s].ref0, 0, a.r0 - 1)];
    poc1[s] = lx ? pocs1[iclamp(m[s].ref1, 0, a.r1 - 1)] : 0;
  }
  const int r = aref[lane], mx = amx[lane], my = amy[lane];
  const int l = lx ? lx[lane] : 0;
  const int t_ok = t ? t[lane * 3] : 0;
  const int t_mvx = t ? t[lane * 3 + 1] : 0;
  const int t_mvy = t ? t[lane * 3 + 2] : 0;
  int mvp[4];
  float b_ref;
  if (lx) {
    const int tpoc = l == 0 ? pocs0[iclamp(r, 0, a.r0 - 1)]
                            : pocs1[iclamp(r, 0, a.r1 - 1)];
    amvp_b(m, poc0, poc1, l, tpoc, a.cur_poc, t_ok, t_mvx, t_mvy, mvp);
    b_ref = MVC_FADD(
        ref_idx_bits(tab, a.ctx_ref, r, l == 0 ? a.cmax0 : a.cmax1),
        inter_dir_bits(tab, a.ctx_dir, 1 + l, a.depth));
  } else {
    amvp_p(m, poc0, pocs0[iclamp(r, 0, a.r0 - 1)], a.cur_poc, t_ok, t_mvx,
           t_mvy, mvp);
    b_ref = ref_idx_bits(tab, a.ctx_ref, r, a.cmax0);
  }
  const float bits0 = mvd_bits(tab, a.ctx_mvd, mx - mvp[0], my - mvp[1]);
  const float bits1 = mvd_bits(tab, a.ctx_mvd, mx - mvp[2], my - mvp[3]);
  const int use1 = bits1 < bits0;     // ties keep predictor 0
  const size_t B = a.B;
  oi[lane] = use1;
  oi[B + lane] = mx - mvp[use1 ? 2 : 0];
  oi[2 * B + lane] = my - mvp[use1 ? 3 : 1];
  oi[3 * B + lane] = 1 + l;
  oi[4 * B + lane] = l == 0 ? mx : 0;
  oi[5 * B + lane] = l == 0 ? my : 0;
  oi[6 * B + lane] = l == 0 ? r : 0;
  oi[7 * B + lane] = l == 1 ? mx : 0;
  oi[8 * B + lane] = l == 1 ? my : 0;
  oi[9 * B + lane] = l == 1 ? r : 0;
  of[lane] = use1 ? bits1 : bits0;
  of[B + lane] = b_ref;
}

}  // namespace mvc
