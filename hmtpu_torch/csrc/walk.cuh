// The coding step and the sample helpers that both z-scan walkers run:
// K21 i_walk (iwalk.cuh, the I pass) and K23 p_walk (pwalk.cuh, the P
// pass).  Each is the port's plain version of the step it replaces:
//   code_tb      `_code` of hmtpu_torch/encoder/pframe_dev.py and
//                intra_rdo.py (transform or transform skip, K10's RDOQ or
//                deadzone quantisation with the dequantisation and the TB
//                rate, the inverse, the clip, the SSE);
//   code_ts_sel  `_code_ts_sel` (a 4x4 TB both ways, the transform-skip
//                one kept when coded and strictly cheaper with its flag);
//   gather_line, copy_block, predict
//                the substituted reference line, a block of a plane, and
//                one intra mode's prediction (K2's arithmetic,
//                intra_pred.cuh).
// Group-cooperative as hm_port.cuh says: a lane's threads (L.tid of L.nt)
// are one group of the block (or of a team of it) in K21, K23 and K26;
// every function ends with the group's barrier.  Compiles as host C++ too.
#pragma once

#include "hm_port.cuh"
#include "intra_pred.cuh"
#include "rdoq.cuh"
#include "transform.cuh"

namespace wk {

using namespace hm;

// K10 table sets: log2 2..4 x (luma, chroma), then 32x32 luma
constexpr int NTB = 7;
constexpr int TB_INTS = 12;

// the K10 table set of a TB size and component
HM_FN int tb_set(int log2, bool luma) {
  return (log2 - 2) * 2 + (luma ? 0 : 1);
}

// the coding step's constants, one set per frame
struct Coder {
  const int* mats;       // DCT 4, 8, 16, 32, then DST 4
  const float* cb;       // (NUM_CTX * 2,) fractional bits
  const int* tabs_i;     // K10's packed tables, NTB sets
  const float* tabs_f;
  int bd, sdh, ctx_ts;   // ctx_ts: TRANSFORMSKIP_FLAG's context offset
  int tb[NTB][TB_INTS];  // per set: tabs_i / tabs_f offsets, ctx_x, ctx_y,
                         // sig_cg_base, one_base, abs_base, scale, qbits,
                         // add, iscale, dq_shift
  float tbf[NTB][2];     // per set: inv, cscale
};

// K10's last-position tables of the NTB sets (hm::rdoq_last_bits): set s
// at lp_off(s) of lp_tables(), which every walker block builds once
// (build_last_bits) before its first coding.  (The context bits and the
// small sets' packed tables stay in device memory: staged beside these,
// they left the coding no faster and gave K23 and K26 spills.)
HM_HD constexpr int lp_size(int s) { return 4 << (s >> 1); }
HM_HD constexpr int lp_off(int s) {
  return s == 0 ? 0 : lp_off(s - 1) + 2 * lp_size(s - 1);
}
constexpr int LP_FLOATS = lp_off(NTB);

#if defined(__CUDACC__)
__device__ __forceinline__ float* lp_tables() {
  __shared__ float t[LP_FLOATS];
  return t;
}
#else
inline float* lp_tables() {
  static float t[LP_FLOATS];
  return t;
}
#endif

// every set's table into lp_tables(), the block's tid of nt threads; the
// caller's block barrier follows
HM_FN void build_last_bits(const Coder& c, int tid, int nt) {
  float* t = lp_tables();
  for (int s = 0; s < NTB; ++s)
    rdoq_last_bits(c.cb, c.tabs_f + c.tb[s][1], c.tb[s][2], c.tb[s][3],
                   lp_size(s), t + lp_off(s), tid, nt);
}

// ints of a coding work area for TBs of up to `stride` samples: three
// work TBs, the TS alternative's 4x4 levels and reconstruction, the
// group's reduction scratch (32 int64)
HM_HD constexpr int work_ints(int stride) { return 3 * stride + 32 + 64; }

// one lane's thread (tid of the nt of its block or group), K10's working
// set (shared memory on the card) and its coding work area (work_ints(
// wstride) ints of the group's shared memory)
struct Lane {
  const Coder* cd;
  int tid, nt;
  RdoqSmem S;
  int* work;  // its coding work area
  int wstride = 1024;
};

// a coding lane: thread tid of nt, K10's working set at k10 for TBs up to
// n x n, and the coding work area `work` (work_ints(n * n) ints)
HM_FN Lane coder_lane(const Coder& cd, int* work, void* k10, int tid,
                      int nt, int n) {
  Lane L;
  L.cd = &cd;
  L.tid = tid;
  L.nt = nt;
  L.S = rdoq_smem(k10, n * n);
  L.work = work;
  L.wstride = n * n;
  return L;
}

// a lane without a coding area (copies, gathers, predictions, commits)
HM_FN Lane plain_lane(const Coder& cd, int tid, int nt) {
  Lane L;
  L.cd = &cd;
  L.tid = tid;
  L.nt = nt;
  L.S = RdoqSmem{};
  L.work = nullptr;
  return L;
}

// the lane's int64 reduction scratch (hm_port.cuh group_sum)
HM_FN long long* red_of(const Lane& L) {
  return (long long*)(L.work + 3 * L.wstride + 32);
}

// one coding step's result
struct TbRes {
  float sse, bits;
  int nz, ts;
};

// the mode-dependent coding scan (7.4.9.11): 2 vertical, 1 horizontal
HM_FN int scan_sel(int m) {
  return (m >= 6 && m <= 14) ? 2 : ((m >= 22 && m <= 30) ? 1 : 0);
}

// the transform matrix of size n (DST at n = 4 when dst)
HM_FN const int* mat(const Coder& c, int n, bool dst) {
  if (dst) return c.mats + 16 + 64 + 256 + 1024;
  return c.mats + (n == 4 ? 0 : n == 8 ? 16 : n == 16 ? 80 : 336);
}

// line[k] = none ? mid : plane[sub[k]]
HM_FN void gather_line(const Lane& L, const int* plane, const int* sub,
                       int none, int len, int* out) {
  const int mid = 1 << (L.cd->bd - 1);
  for (int k = L.tid; k < len; k += L.nt) out[k] = none ? mid : plane[sub[k]];
  HM_GSYNC(L.nt);
}

HM_FN void copy_block(const Lane& L, const int* plane, int width, int x0,
                      int y0, int n, int* out) {
  for (int e = L.tid; e < n * n; e += L.nt)
    out[e] = plane[(y0 + e / n) * width + x0 + e % n];
  HM_GSYNC(L.nt);
}

HM_FN void predict(const Lane& L, const int* su, const int* sf, int mode,
                   int n, int luma, int* out) {
  const int log2n = log2_of(n);
  const int dc = intra_dc(su, n, log2n);
  for (int e = L.tid; e < n * n; e += L.nt)
    out[e] = pred_sample(su, sf, dc, mode, n, log2n, luma, L.cd->bd, e / n,
                         e % n);
  HM_GSYNC(L.nt);
}

// _code: transform (or skip) -> RDOQ (the trellis, or deadzone when
// !trellis), dequantisation and TB rate (K10) -> inverse -> clip -> SSE
// (times dw when weighed); lev and rec raster.  The result reaches every
// thread of the lane.
HM_BIG TbRes code_tb(Lane& L, int log2, bool luma, bool dst, bool ts,
                     int sel, float lam, bool weigh, float dw, const int* org,
                     const int* pred, int* lev, int* rec,
                     bool trellis = true) {
  const Coder& a = *L.cd;
  const int n = 1 << log2, nn = n * n, tid = L.tid, nt = L.nt;
  int* w1 = L.work;
  int* w2 = w1 + L.wstride;
  int* w3 = w2 + L.wstride;
  HM_PH_START(t_fwd);
  for (int e = tid; e < nn; e += nt) w1[e] = org[e] - pred[e];
  HM_GSYNC(L.nt);
  if (ts) {
    for (int e = tid; e < nn; e += nt)
      w2[e] = ts_fwd(w1[e], 15 - a.bd - log2);
    HM_GSYNC(L.nt);
  } else {
    transform_tb<false>(mat(a, n, dst), w1, w3, w2, n, log2 + a.bd + 6 - 15,
                        log2 + 6, tid, nt);
  }
  HM_PH_STOP(HM_PH_CODE + PHC_FWD, t_fwd);
  const int s = tb_set(log2, luma);
  RdoqCfg c;
  c.cb = a.cb;
  c.tabs_i = a.tabs_i + a.tb[s][0];
  c.tabs_f = a.tabs_f + a.tb[s][1];
  c.lpb = lp_tables() + lp_off(s);
  c.log2 = log2;
  c.flags = (trellis ? F_TRELLIS : 0) | (a.sdh ? F_SDH : 0) |
            (luma ? F_LUMA : 0);
  c.ctx_x = a.tb[s][2];
  c.ctx_y = a.tb[s][3];
  c.sig_cg_base = a.tb[s][4];
  c.one_base = a.tb[s][5];
  c.abs_base = a.tb[s][6];
  c.scale = a.tb[s][7];
  c.qbits = a.tb[s][8];
  c.add = a.tb[s][9];
  c.iscale = a.tb[s][10];
  c.dq_shift = a.tb[s][11];
  c.inv = a.tbf[s][0];
  c.cscale = a.tbf[s][1];
  const float bits = rdoq_tb(c, lam, sel, w2, lev, w1, true, L.S, tid, nt);
  HM_PH_START(t_inv);
  if (ts) {
    for (int e = tid; e < nn; e += nt)
      w2[e] = ts_inv(w1[e], 5 + log2, 20 - a.bd);
    HM_GSYNC(L.nt);
  } else {
    transform_tb<true>(mat(a, n, dst), w1, w3, w2, n, 7, 20 - a.bd, tid, nt);
  }
  // the SSE and the coded flag, exact integer sums over the lane
  const int maxv = (1 << a.bd) - 1;
  long long sse = 0, nz = 0;
  for (int e = tid; e < nn; e += nt) {
    const int v = iclamp(pred[e] + w2[e], 0, maxv);
    rec[e] = v;
    const long long d = org[e] - v;
    sse += d * d;
    nz += lev[e] != 0;
  }
  sse = group_sum(sse, tid, nt, red_of(L));
  nz = group_sum(nz, tid, nt, red_of(L));
  HM_GSYNC(L.nt);
  HM_PH_STOP(HM_PH_CODE + PHC_INV, t_inv);
  TbRes r;
  r.sse = (float)sse;
  if (weigh) r.sse = HM_FMUL(r.sse, dw);  // HM's chroma distortion weight
  r.bits = bits;
  r.nz = nz != 0;
  r.ts = 0;
  return r;
}

// the 4x4 TB's choice of _code_ts_sel from its two codings: the TS one
// (r1) when coded and strictly cheaper with the transform_skip_flag bit
// priced in; the result carries the flag's bits and ts
HM_FN TbRes ts_pick(const Coder& a, bool luma, float lam, const TbRes& r0,
                    const TbRes& r1) {
  const int ctx = a.ctx_ts + (luma ? 0 : 1);
  const float b0 = HM_FADD(r0.bits, r0.nz ? a.cb[2 * ctx] : 0.f);
  const float b1 = HM_FADD(r1.bits, r1.nz ? a.cb[2 * ctx + 1] : 0.f);
  const bool use = r1.nz && HM_FADD(r1.sse, HM_FMUL(lam, b1)) <
                                HM_FADD(r0.sse, HM_FMUL(lam, b0));
  TbRes r;
  r.sse = use ? r1.sse : r0.sse;
  r.bits = use ? b1 : b0;
  r.nz = use ? r1.nz : r0.nz;
  r.ts = use;
  return r;
}

// _code_ts_sel: a 4x4 TB coded both ways, the TS one kept when coded and
// strictly cheaper with the transform_skip_flag bit priced in
HM_BIG TbRes code_ts_sel(Lane& L, bool luma, bool dst, int sel, float lam,
                         bool weigh, float dw, const int* org,
                         const int* pred, int* lev, int* rec,
                         bool trellis = true) {
  int* levt = L.work + 3 * L.wstride;
  int* rect = levt + 16;
  const TbRes r0 = code_tb(L, 2, luma, dst, false, sel, lam, weigh, dw, org,
                           pred, lev, rec, trellis);
  const TbRes r1 = code_tb(L, 2, luma, dst, true, sel, lam, weigh, dw, org,
                           pred, levt, rect, trellis);
  const TbRes r = ts_pick(*L.cd, luma, lam, r0, r1);
  if (r.ts) {
    for (int e = L.tid; e < 16; e += L.nt) {
      lev[e] = levt[e];
      rec[e] = rect[e];
    }
    HM_GSYNC(L.nt);
  }
  return r;
}

}  // namespace wk
