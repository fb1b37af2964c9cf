// K3 deblock: the HEVC in-loop deblocking filter (H.265 8.7.2), bit-exact
// with hmtpu/ops/deblock.py:471 deblock_frame_dev together with its
// boundary strength (:452 _bs_dev, masked by the CU-interior grids) and
// the luma (:294 _luma_edges_dev) and chroma (:374 _chroma_edges_dev)
// edge filters.
//
// What bounds it on the H100: each luma sample is read about once and
// at most six per edge are written; the work per 4-line segment is a
// few hundred integer operations.  A 416x240 picture is ~150 KB of
// int32 samples, so one launch per direction is bound by launch cost
// and latency, not by bytes or operations.
//
// Design: one launch per direction (dir 0: all vertical edges, dir 1:
// all horizontal edges, the 8.7.2 order), in place.  One thread owns
// one 4-sample segment of one edge: it derives the segment's boundary
// strength from the 4x4 metadata (intra, cbf, motion), applies the
// CU-interior mask, and filters its 4 lines.  Luma segments and the
// chroma segments of both planes share the launch (chroma filters only
// where the co-located luma BS is 2).  Edges of one direction are 8
// samples apart and a filter reads 4 and writes 3 samples per side, so
// no two threads touch the same sample.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ int kBeta[52] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  6,  7,
    8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32,
    34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
__constant__ int kTc[54] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13,
    14, 16, 18, 20, 22, 24};

struct Meta {
  const int* intra4;   // (h4, w4)
  const int* cbf4;     // (h4, w4)
  const int* mvx;      // (2, h4, w4)
  const int* mvy;
  const int* refpoc;   // (2, h4, w4), -1 = list unused
  const int* mask;     // CU-interior edges of this direction, or null
  int h4, w4, bw;
};

__device__ __forceinline__ bool far4(int ax, int ay, int bx, int by) {
  return abs(ax - bx) >= 4 || abs(ay - by) >= 4;
}

// 8.7.2.4 motion test between 4x4 blocks p and q (flat 4x4 indices)
__device__ bool motion_bs(const Meta& m, int p, int q) {
  const int plane = m.h4 * m.w4;
  const int pr0 = m.refpoc[p], pr1 = m.refpoc[plane + p];
  const int qr0 = m.refpoc[q], qr1 = m.refpoc[plane + q];
  const int pmx0 = m.mvx[p], pmx1 = m.mvx[plane + p];
  const int pmy0 = m.mvy[p], pmy1 = m.mvy[plane + p];
  const int qmx0 = m.mvx[q], qmx1 = m.mvx[plane + q];
  const int qmy0 = m.mvy[q], qmy1 = m.mvy[plane + q];
  const int big = 1 << 20;
  const bool pu0 = pr0 >= 0, pu1 = pr1 >= 0, qu0 = qr0 >= 0, qu1 = qr1 >= 0;
  const int cnt_p = (int)pu0 + (int)pu1, cnt_q = (int)qu0 + (int)qu1;
  const int p_lo = min(pu0 ? pr0 : big, pu1 ? pr1 : big);
  const int p_hi = max(pu0 ? pr0 : -big, pu1 ? pr1 : -big);
  const int q_lo = min(qu0 ? qr0 : big, qu1 ? qr1 : big);
  const int q_hi = max(qu0 ? qr0 : -big, qu1 ? qr1 : -big);
  if (cnt_p != cnt_q || p_lo != q_lo || p_hi != q_hi) return true;
  if (cnt_p == 2 && cnt_q == 2) {
    if (p_lo == p_hi) {
      return (far4(pmx0, pmy0, qmx0, qmy0) || far4(pmx1, pmy1, qmx1, qmy1)) &&
             (far4(pmx0, pmy0, qmx1, qmy1) || far4(pmx1, pmy1, qmx0, qmy0));
    }
    const bool p_is_lo = pu0 && pr0 == p_lo;
    const bool q_is_lo = qu0 && qr0 == q_lo;
    const int plx = p_is_lo ? pmx0 : pmx1, ply = p_is_lo ? pmy0 : pmy1;
    const int phx = p_is_lo ? pmx1 : pmx0, phy = p_is_lo ? pmy1 : pmy0;
    const int qlx = q_is_lo ? qmx0 : qmx1, qly = q_is_lo ? qmy0 : qmy1;
    const int qhx = q_is_lo ? qmx1 : qmx0, qhy = q_is_lo ? qmy1 : qmy0;
    return far4(plx, ply, qlx, qly) || far4(phx, phy, qhx, qhy);
  }
  const int pux = pu0 ? pmx0 : pmx1, puy = pu0 ? pmy0 : pmy1;
  const int qux = qu0 ? qmx0 : qmx1, quy = qu0 ? qmy0 : qmy1;
  return far4(pux, puy, qux, quy);
}

// BS of luma segment `seg` (4 samples along the edge) of edge `j` at
// 8(j+1) across the direction; the CU-interior mask zeroes it.
__device__ int bs_at(const Meta& m, int dir, int j, int seg) {
  int p, q, mi;
  if (dir == 0) {          // vertical edge: p = column 2j+1, q = 2j+2
    p = seg * m.w4 + 2 * j + 1;
    q = p + 1;
    mi = (seg >> 1) * (m.bw - 1) + j;
  } else {                 // horizontal edge: p = row 2j+1, q = 2j+2
    p = (2 * j + 1) * m.w4 + seg;
    q = p + m.w4;
    mi = j * m.bw + (seg >> 1);
  }
  if (m.mask && m.mask[mi]) return 0;
  if (m.intra4[p] || m.intra4[q]) return 2;
  if (m.cbf4[p] || m.cbf4[q] || motion_bs(m, p, q)) return 1;
  return 0;
}

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return min(max(v, lo), hi);
}

// filter one 4-line luma segment; s(i, k) addresses sample k in
// {0..7} = p3 p2 p1 p0 q0 q1 q2 q3 of line i
__device__ void luma_segment(int* pl, long long base, long long step_line,
                             long long step_across, int bs, int qp, int bd,
                             int beta_off, int tc_off) {
  if (bs <= 0) return;
  const int tc_q = clip3(0, 53, qp + 2 * (bs - 1) + (tc_off << 1));
  const int beta = kBeta[clip3(0, 51, qp + (beta_off << 1))] << (bd - 8);
  const int tc = kTc[tc_q] << (bd - 8);
  const int maxv = (1 << bd) - 1;
  int v[4][8];
  for (int i = 0; i < 4; ++i)
    for (int k = 0; k < 8; ++k)
      v[i][k] = pl[base + i * step_line + (k - 4) * step_across];
  int dp[4], dq[4];
  for (int i = 0; i < 4; ++i) {
    dp[i] = abs(v[i][1] - 2 * v[i][2] + v[i][3]);
    dq[i] = abs(v[i][6] - 2 * v[i][5] + v[i][4]);
  }
  const int dp03 = dp[0] + dp[3];
  const int dq03 = dq[0] + dq[3];
  if (!(dp03 + dq03 < beta)) return;
  bool strong = true;
  for (int i = 0; i < 4; i += 3) {
    strong = strong && (2 * (dp[i] + dq[i]) < (beta >> 2)) &&
             (abs(v[i][0] - v[i][3]) + abs(v[i][4] - v[i][7]) < (beta >> 3)) &&
             (abs(v[i][3] - v[i][4]) < ((5 * tc + 1) >> 1));
  }
  const int side = (beta + (beta >> 1)) >> 3;
  const int tch = tc >> 1;
  for (int i = 0; i < 4; ++i) {
    const int p3 = v[i][0], p2 = v[i][1], p1 = v[i][2], p0 = v[i][3];
    const int q0 = v[i][4], q1 = v[i][5], q2 = v[i][6], q3 = v[i][7];
    int o[8] = {p3, p2, p1, p0, q0, q1, q2, q3};
    if (strong) {
      const int t2 = 2 * tc;
      o[3] = clip3(p0 - t2, p0 + t2, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
      o[2] = clip3(p1 - t2, p1 + t2, (p2 + p1 + p0 + q0 + 2) >> 2);
      o[1] = clip3(p2 - t2, p2 + t2, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
      o[4] = clip3(q0 - t2, q0 + t2, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3);
      o[5] = clip3(q1 - t2, q1 + t2, (q2 + q1 + q0 + p0 + 2) >> 2);
      o[6] = clip3(q2 - t2, q2 + t2, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
    } else {
      const int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (abs(delta) < 10 * tc) {
        const int dcl = clip3(-tc, tc, delta);
        o[3] = clip3(0, maxv, p0 + dcl);
        o[4] = clip3(0, maxv, q0 - dcl);
        if (dp03 < side) {
          const int d1 = clip3(-tch, tch, (((p2 + p0 + 1) >> 1) - p1 + dcl) >> 1);
          o[2] = clip3(0, maxv, p1 + d1);
        }
        if (dq03 < side) {
          const int d1 = clip3(-tch, tch, (((q2 + q0 + 1) >> 1) - q1 - dcl) >> 1);
          o[5] = clip3(0, maxv, q1 + d1);
        }
      }
    }
    for (int k = 1; k < 7; ++k)
      pl[base + i * step_line + (k - 4) * step_across] = o[k];
  }
}

__device__ void chroma_segment(int* pl, long long base, long long step_line,
                               long long step_across, int tc, int bd) {
  const int maxv = (1 << bd) - 1;
  for (int i = 0; i < 4; ++i) {
    const long long o = base + i * step_line;
    const int p1 = pl[o - 2 * step_across], p0 = pl[o - step_across];
    const int q0 = pl[o], q1 = pl[o + step_across];
    const int delta = clip3(-tc, tc, ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3));
    pl[o - step_across] = clip3(0, maxv, p0 + delta);
    pl[o] = clip3(0, maxv, q0 - delta);
  }
}

__global__ void deblock_kernel(int* __restrict__ y, int* __restrict__ u,
                               int* __restrict__ v, Meta m, int h, int w,
                               int dir, int qp, int tc_cb, int tc_cr, int bd,
                               int beta_off, int tc_off) {
  const int hc = h / 2, wc = w / 2;
  // luma: edges across the direction, segments of 4 along it
  const int ne_l = dir == 0 ? w / 8 - 1 : h / 8 - 1;
  const int ns_l = dir == 0 ? h / 4 : w / 4;
  const int ne_c = dir == 0 ? max((wc - 2) / 8, 0) : max((hc - 2) / 8, 0);
  const int ns_c = dir == 0 ? hc / 4 : wc / 4;
  const long long n_l = (long long)max(ne_l, 0) * ns_l;
  const long long n_c = (long long)ne_c * ns_c;
  const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (id < n_l) {
    const int j = (int)(id / ns_l);
    const int seg = (int)(id - (long long)j * ns_l);
    const int bs = bs_at(m, dir, j, seg);
    long long base, step_line, step_across;
    if (dir == 0) {
      base = (long long)(seg * 4) * w + 8 * (j + 1);
      step_line = w;
      step_across = 1;
    } else {
      base = (long long)(8 * (j + 1)) * w + seg * 4;
      step_line = 1;
      step_across = w;
    }
    luma_segment(y, base, step_line, step_across, bs, qp, bd, beta_off,
                 tc_off);
    return;
  }
  long long c = id - n_l;
  if (c >= 2 * n_c) return;
  const int comp = c >= n_c;     // 0 = Cb, 1 = Cr
  c -= comp * n_c;
  const int k = (int)(c / ns_c);
  const int seg = (int)(c - (long long)k * ns_c);
  // co-located luma segment 2*seg of luma edge 2k+1
  if (bs_at(m, dir, 2 * k + 1, 2 * seg) != 2) return;
  long long base, step_line, step_across;
  if (dir == 0) {
    base = (long long)(seg * 4) * wc + 8 * (k + 1);
    step_line = wc;
    step_across = 1;
  } else {
    base = (long long)(8 * (k + 1)) * wc + seg * 4;
    step_line = 1;
    step_across = wc;
  }
  chroma_segment(comp ? v : u, base, step_line, step_across,
                 comp ? tc_cr : tc_cb, bd);
}

}  // namespace

extern "C" int hm_deblock_edges(void* y, void* u, void* v, const void* intra4,
                                const void* cbf4, const void* mvx,
                                const void* mvy, const void* refpoc,
                                const void* mask, int h, int w, int dir,
                                int qp, int tc_cb, int tc_cr, int bd,
                                int beta_off, int tc_off, void* stream) {
  Meta m;
  m.intra4 = (const int*)intra4;
  m.cbf4 = (const int*)cbf4;
  m.mvx = (const int*)mvx;
  m.mvy = (const int*)mvy;
  m.refpoc = (const int*)refpoc;
  m.mask = (const int*)mask;
  m.h4 = h / 4;
  m.w4 = w / 4;
  m.bw = w / 8;
  const int hc = h / 2, wc = w / 2;
  const long long ne_l = dir == 0 ? w / 8 - 1 : h / 8 - 1;
  const long long ns_l = dir == 0 ? h / 4 : w / 4;
  const long long ne_c = dir == 0 ? (wc - 2 > 0 ? (wc - 2) / 8 : 0)
                                  : (hc - 2 > 0 ? (hc - 2) / 8 : 0);
  const long long ns_c = dir == 0 ? hc / 4 : wc / 4;
  const long long total = (ne_l > 0 ? ne_l : 0) * ns_l + 2 * ne_c * ns_c;
  if (total == 0) return 0;
  const int threads = 128;
  const int blocks = (int)((total + threads - 1) / threads);
  deblock_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (int*)y, (int*)u, (int*)v, m, h, w, dir, qp, tc_cb, tc_cr, bd,
      beta_off, tc_off);
  return (int)cudaGetLastError();
}
