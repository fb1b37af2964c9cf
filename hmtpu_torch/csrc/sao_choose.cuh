// K25 sao_choose's lane code: the RD choice of one CTU's SAO parameters
// for one plane from K4's statistics, the port of hmtpu/ops/sao.py:305
// _choose_params_dev with :267 _offsets_and_delta_dev, as the port's plain
// version (hmtpu_torch/ops/sao.py `_choose_params_plain`) runs it: per
// edge class the four offsets (categories 1-2 non-negative, 3-4
// non-positive) and their distortion change, the class of least cost;
// per band position the run of four bands of least distortion change;
// then off, band or edge (edge on a tie with band), or the type and class
// given (Cr under Cb's).
//
// Parity: float32 in the plain version's order, each operation rounded on
// its own; the offset is round-half-to-even of the float32 quotient
// (rintf); cnt * off * off - (2 * off) * e_sum as written there; the band
// runs ((d[p] + d[p+1]) + d[p+2]) + d[p+3]; ties take the first index.
// Compiles as host C++ too.
#pragma once

#include "hm_port.cuh"

#if defined(__CUDACC__)
#define SAO_FDIV(a, b) __fdiv_rn((a), (b))
#else
#define SAO_FDIV(a, b) ((float)(a) / (float)(b))
#endif

namespace saoc {

// one CTU's statistics: K4's row of 96 ints (edge sums and counts per
// class x category, band sums and counts per band)
constexpr int ROW = 96;

// _offsets_and_delta of one (sum, count); sc > 0 / < 0: the sign
// constraint, 0 none
HM_FN void offset_delta(int e_sum_i, int cnt_i, int sc, int mo, int* off,
                        float* delta) {
  const float e_sum = (float)e_sum_i, cnt = (float)cnt_i;
  float o = cnt > 0.f ? rintf(SAO_FDIV(e_sum, cnt > 1.f ? cnt : 1.f)) : 0.f;
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

// one CTU: st its statistics row, out its 7 params [type, class, band
// position, 4 offsets]; force_type / force_cls < 0: chosen here
HM_FN void choose(const int* st, float lam, int mo, int force_type,
                  int force_cls, int* out) {
  int e_off[4][4];
  float e_cost[4];
  for (int c = 0; c < 4; ++c) {
    float dl[4];
    int bits = 0;
    for (int k = 0; k < 4; ++k) {
      offset_delta(st[c * 4 + k], st[16 + c * 4 + k], k < 2 ? 1 : -1, mo,
                   &e_off[c][k], &dl[k]);
      bits += e_off[c][k] < 0 ? -e_off[c][k] : e_off[c][k];
    }
    const float delta = HM_FADD(HM_FADD(dl[0], dl[1]), HM_FADD(dl[2], dl[3]));
    e_cost[c] = HM_FADD(delta, HM_FMUL(lam, HM_FADD(6.0f, (float)bits)));
  }
  int cls = 0;
  for (int c = 1; c < 4; ++c)
    if (e_cost[c] < e_cost[cls]) cls = c;
  if (force_cls >= 0) cls = force_cls;
  const float e_cost_b = e_cost[cls];

  int b_off[32];
  float b_del[32];
  for (int b = 0; b < 32; ++b)
    offset_delta(st[32 + b], st[64 + b], 0, mo, &b_off[b], &b_del[b]);
  int pos = 0;
  float run_b = 0.f;
  for (int p = 0; p < 29; ++p) {
    const float r = HM_FADD(
        HM_FADD(HM_FADD(b_del[p], b_del[p + 1]), b_del[p + 2]), b_del[p + 3]);
    if (p == 0 || r < run_b) {
      run_b = r;
      pos = p;
    }
  }
  int bbits = 0;
  for (int k = 0; k < 4; ++k) {
    const int v = b_off[pos + k];
    bbits += (v < 0 ? -v : v) + (v != 0);
  }
  const float b_cost = HM_FADD(run_b, HM_FMUL(lam, HM_FADD(9.0f,
                                                           (float)bbits)));
  int typ;
  if (force_type >= 0)
    typ = force_type;
  else
    typ = (e_cost_b < 0.f && e_cost_b <= b_cost) ? 2 : (b_cost < 0.f ? 1 : 0);
  out[0] = typ;
  out[1] = typ == 2 ? cls : 0;
  out[2] = typ == 1 ? pos : 0;
  for (int k = 0; k < 4; ++k)
    out[3 + k] = typ == 0 ? 0 : typ == 2 ? e_off[cls][k] : b_off[pos + k];
}

// thread `i` of 2 per CTU: i even luma, odd the chroma pair (Cb, then Cr
// under Cb's type and class); st_*: (nctu, ROW), out (nctu, 3, 7)
HM_FN void choose_lane(const int* st_y, const int* st_u, const int* st_v,
                       float lam, int mo, int* out, int i) {
  const int ctu = i >> 1;
  int* o = out + ctu * 21;
  if ((i & 1) == 0) {
    choose(st_y + ctu * ROW, lam, mo, -1, -1, o);
  } else {
    choose(st_u + ctu * ROW, lam, mo, -1, -1, o + 7);
    choose(st_v + ctu * ROW, lam, mo, o[7], o[8], o + 14);
  }
}

}  // namespace saoc
