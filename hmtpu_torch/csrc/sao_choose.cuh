// K25 sao_choose's lane code: the RD choice of one CTU's SAO parameters
// for one plane from K4's statistics on a warp, the port of
// hmtpu/ops/sao.py:305 _choose_params_dev with :267
// _offsets_and_delta_dev, as the port's plain version
// (hmtpu_torch/ops/sao.py `_choose_params_plain`) runs it.
//
// A (CTU, plane) on 32 lanes (`Lanes<T, 32>`): lane b takes band b's
// offset and distortion change, lanes 0-15 also edge class b >> 2's
// category b & 3 (1-2 non-negative, 3-4 non-positive), so no lane runs
// more than two `offset_delta`.  A class's four lanes meet by shuffles
// ((d0 + d1) + (d2 + d3), the |offset| sum), the class of least cost is
// a lane argmin (first index on ties); lane p < 29 sums the band run
// ((d[p] + d[p+1]) + d[p+2]) + d[p+3] from its neighbours, and the run
// of least change is another lane argmin.  Then off, band or edge (edge
// on a tie with band), or the type and class given (Cr under Cb's:
// `decide` runs after the Cb warp's, its candidates before).
//
// Parity: float32 in the plain version's order, each operation rounded on
// its own; the offset is round-half-to-even of the float32 quotient
// (rintf); cnt * off * off - (2 * off) * e_sum as written there.
// Compiles as host C++ too (one thread holds a warp's 32 lanes:
// `choose_host`).
#pragma once

#include "hm_port.cuh"

namespace saoc {

// one CTU's statistics: K4's row of 96 ints (edge sums and counts per
// class x category, band sums and counts per band)
constexpr int ROW = 96;

using LF = hm::Lanes<float, 32>;
using LI = hm::Lanes<int, 32>;

// _offsets_and_delta of one (sum, count); sc > 0 / < 0: the sign
// constraint, 0 none
HM_FN void offset_delta(int e_sum_i, int cnt_i, int sc, int mo, int* off,
                        float* delta) {
  const float e_sum = (float)e_sum_i, cnt = (float)cnt_i;
  float o = cnt > 0.f ? rintf(HM_FDIV(e_sum, cnt > 1.f ? cnt : 1.f)) : 0.f;
  o = o < (float)-mo ? (float)-mo : (o > (float)mo ? (float)mo : o);
  if (sc > 0 && o < 0.f) o = 0.f;
  if (sc < 0 && o > 0.f) o = 0.f;
  const int oi = (int)o;
  auto d = [&](int v) {
    return HM_FSUB(HM_FMUL(HM_FMUL(cnt, (float)v), (float)v),
                   HM_FMUL((float)(2 * v), e_sum));
  };
  const float d0 = d(oi);
  const int shr = oi - (oi > 0 ? 1 : oi < 0 ? -1 : 0);
  const float d1 = d(shr);
  const bool take = d1 < d0;
  *off = take ? shr : oi;
  *delta = take ? d1 : d0;
}

// a plane's candidates, on every lane: the edge offsets (lane 4c + k:
// class c, category k) and each class's cost (on its four lanes), the
// band offsets (lane b) and the best run's position and cost
struct Cand {
  LI e_off, b_off;
  LF e_cost;
  int cls, pos;
  float b_cost;
};

HM_FN void candidates(const int* st, float lam, int mo, Cand& c) {
  LF e_del, b_del;
  HM_LANES(j, 32) {
    int o;
    float d;
    offset_delta(st[32 + j], st[64 + j], 0, mo, &o, &d);
    c.b_off[j] = o;
    b_del[j] = d;
    o = 0;
    d = 0.f;
    if (j < 16)
      offset_delta(st[j], st[16 + j], (j & 3) < 2 ? 1 : -1, mo, &o, &d);
    c.e_off[j] = o;
    e_del[j] = d;
  }
  // each class's (d0 + d1) + (d2 + d3) and |offset| sum on its 4 lanes
  LF s1;
  LI a1;
  {
    const LF x = hm::lane_xor(e_del, 1);
    const LI y = hm::lane_xor(c.e_off, 1);
    HM_LANES(j, 32) {
      s1[j] = HM_FADD(e_del[j], x[j]);
      a1[j] = hm::iabs(c.e_off[j]) + hm::iabs(y[j]);
    }
  }
  LF key;
  LI idx;
  {
    const LF x = hm::lane_xor(s1, 2);
    const LI y = hm::lane_xor(a1, 2);
    HM_LANES(j, 32) {
      const float bits = HM_FADD(6.0f, (float)(a1[j] + y[j]));
      c.e_cost[j] = HM_FADD(HM_FADD(s1[j], x[j]), HM_FMUL(lam, bits));
      key[j] = j < 16 ? c.e_cost[j] : INFINITY;
      idx[j] = j >> 2;
    }
  }
  float v;
  hm::lane_argmin(key, idx, v, c.cls);
  // the band runs: lane p < 29 from lanes p + 1 .. p + 3
  HM_LANES(j, 32) {
    const float r = HM_FADD(
        HM_FADD(HM_FADD(b_del[j], hm::lane_get(b_del, hm::imin(j + 1, 31))),
                hm::lane_get(b_del, hm::imin(j + 2, 31))),
        hm::lane_get(b_del, hm::imin(j + 3, 31)));
    key[j] = j < 29 ? r : INFINITY;
    idx[j] = j;
  }
  float run_b;
  hm::lane_argmin(key, idx, run_b, c.pos);
  int bbits = 0;
  for (int k = 0; k < 4; ++k) {
    const int o = hm::lane_get(c.b_off, c.pos + k);
    bbits += hm::iabs(o) + (o != 0);
  }
  c.b_cost = HM_FADD(run_b, HM_FMUL(lam, HM_FADD(9.0f, (float)bbits)));
}

// the plane's 7 params [type, class, band position, 4 offsets] to out
// (lanes 0-6 write); force_type / force_cls < 0: chosen here.  Returns
// the type and class to every lane.
HM_FN void decide(const Cand& c, int force_type, int force_cls, int* out,
                  int& typ, int& cls) {
  cls = force_cls >= 0 ? force_cls : c.cls;
  const float e_cost_b = hm::lane_get(c.e_cost, 4 * cls);
  if (force_type >= 0)
    typ = force_type;
  else
    typ = (e_cost_b < 0.f && e_cost_b <= c.b_cost) ? 2
                                                    : (c.b_cost < 0.f ? 1 : 0);
  const LI& offs = typ == 2 ? c.e_off : c.b_off;
  const int base = typ == 2 ? 4 * cls : c.pos;
  HM_LANES(j, 32) {
    const int o = hm::lane_get(offs, base + ((j - 3) & 3));
    if (j < 7)
      out[j] = j == 0   ? typ
               : j == 1 ? (typ == 2 ? cls : 0)
               : j == 2 ? (typ == 1 ? c.pos : 0)
                        : (typ == 0 ? 0 : o);
  }
}

#if !defined(__CUDACC__)
// K25 on one host thread: each CTU's luma, Cb, then Cr under Cb's type
// and class (the kernel's order: every warp's candidates, then the
// decisions, Cr's after Cb's); st_*: (nctu, ROW), out (nctu, 3, 7)
inline void choose_host(const int* st_y, const int* st_u, const int* st_v,
                        float lam, int mo, int* out, int nctu) {
  for (int ctu = 0; ctu < nctu; ++ctu) {
    Cand c[3];
    const int* st[3] = {st_y, st_u, st_v};
    for (int p = 0; p < 3; ++p) candidates(st[p] + ctu * ROW, lam, mo, c[p]);
    int* o = out + ctu * 21;
    int typ, cls, t2, c2;
    decide(c[0], -1, -1, o, t2, c2);
    decide(c[1], -1, -1, o + 7, typ, cls);
    decide(c[2], typ, cls, o + 14, t2, c2);
  }
}
#endif

}  // namespace saoc
