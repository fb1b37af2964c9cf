// K5 me_sad's arithmetic: full-window integer motion estimation for the
// 8x8, 16x16 and 32x32 CU levels of one reference, bit-exact with
// hmtpu/search/me.py:120 integer_me_levels (the 8x8 SAD volume of
// integer_me_sad_volume :29, its 16 / 32 sums :138-140, the argmin and
// stencil of _volume_best :72) as the port's plain version
// (hmtpu_torch/search/me.py `integer_me_levels_plain`) computes it.
//
// The work is split as me_sad.cu launches it: a region is a 32x32 block
// of the padded 32-grid, its (2R + 1)^2 displacements are cut into NCH
// chunks of rows dy, and a (region, chunk) stages the rows of reference
// samples its chunk reads, packed (four bytes a word at 8 bits, two
// halfwords at 10), with the region's source packed alike.  A unit is one
// dy and eight adjacent dx of one 8x8 cell: each window word loaded feeds
// the eight displacements through funnel shifts, and each packed word
// pair is one __vsadu4 (four samples) or, at 10 bits, the halfwords'
// max - min (__vmaxu2, __vminu2).  A cell's SAD
// sums to its 16x16 block's and the region's (cells outside the picture
// add zero, as the plain version's zero-padded 32-grid strip does); the
// cost is float32(SAD) + float32(bits) * lambda_sqrt, each operation
// rounded on its own; every (cost, index) minimum is kept as a 64-bit key
// (cost bits << 32 | index: a cost is never below 0, so its float32 bits
// order as uint32), so the least key is the first index of the least
// cost in row-major (dy, dx) order, as the plain argmin, whatever order
// the units and chunks run in.  The nine stencil SADs around each winner
// (clamped to the window) are taken after the merge from the planes.
//
// K13 me_sad1 (hmtpu/search/me.py:107 integer_me for 8x8 blocks, as
// `integer_me_plain` computes it) runs the same staging and units at one
// level: no 16x16 or region sums, each cell keeps its own key, and its
// cost prices the bits against the cell's own quarter-pel predictor
// (unit_key1); the regions tile pictures whose sides are multiples of 8,
// cells outside the picture masked.
//
// Compiles as host C++ too (hm_port.cuh's shim: the packed sums and
// differences and the funnel shift); `levels_host` and `level1_host` run
// the same units, chunk by chunk, on one thread, which the CPU tests
// drive.
#pragma once

#include <float.h>
#include <stdint.h>

#include "hm_port.cuh"

namespace me {

using namespace hm;

constexpr int THREADS = 256;  // a (region, chunk) block: 8 warps
constexpr int NCH = 8;        // chunks of a region's dy range
constexpr int NLANE = 21;     // a region's lanes: 16 cells, 4 16x16, itself
constexpr int MAX_R = 64;

// units of eight dx that cover a row of 2R + 1 displacements
HM_HD constexpr int nq_of(int R) { return (2 * R + 1 + 7) / 8; }
// samples of a staged row: the region's 32 and the units' reach
HM_HD constexpr int row_samples(int R) { return 32 + 8 * nq_of(R); }
// words of a staged row (P samples a word), padded so that a warp's
// loads of one row (16 cells, the two half-warps on adjacent dy) fall
// into distinct banks at 8 bits (a stride of 1 mod 4 words) and at most
// two ways at 10 (2 mod 4)
HM_HD constexpr int row_words(int R, int P) {
  return row_samples(R) / P + ((P == 4 ? 1 : 2) - row_samples(R) / P % 4 +
                               4) % 4;
}
// the first dy of chunk c (c = NCH: one past the last)
HM_HD int chunk_lo(int c, int side) { return c * side / NCH; }
// the most dy rows of a chunk
HM_HD constexpr int chunk_rows(int R) { return (2 * R + 1 + NCH - 1) / NCH; }
// staged words of a (region, chunk): its window rows and the source
HM_HD constexpr int stage_words(int R, int P) {
  return (chunk_rows(R) + 31) * row_words(R, P) + 32 * (32 / P);
}

// signed Exp-Golomb MV-component bit length (me.py _bits_of)
HM_FN int bits_of(int v) {
  const unsigned code = v <= 0 ? ((unsigned)(-v) << 1) + 1u : (unsigned)v << 1;
  return 2 * (31 - HM_CLZ((int)code)) + 1;
}

// the bits of one MV component at window offset di against a
// quarter-pel predictor component p
HM_FN int mv_bits(int di, int R, int p) { return bits_of((di - R) * 4 - p); }

// the motion cost of a displacement from its components' bits:
// float32(bits) * lambda
HM_FN float mv_cost_of(int bx, int by, float lam) {
  return HM_FMUL((float)(bx + by), lam);
}

// the motion cost of window offset (dyi, dxi), zero predictor (K5)
HM_FN float mv_cost(int dxi, int dyi, int R, float lam) {
  return mv_cost_of(mv_bits(dxi, R, 0), mv_bits(dyi, R, 0), lam);
}

// a (cost, index) minimum as one word: the least key wins, ties to the
// lower index
HM_FN unsigned long long key_of(float cost, int d) {
  union {
    float f;
    unsigned u;
  } c;
  c.f = cost;
  return ((unsigned long long)c.u << 32) | (unsigned)d;
}
HM_FN unsigned long long key_min(unsigned long long a,
                                 unsigned long long b) {
  return a < b ? a : b;
}
constexpr unsigned long long NO_KEY = ~0ull;

// P samples into a word, the first in the low bits
template <int P>
HM_FN unsigned pack(const int* v) {
  unsigned w = 0;
  for (int e = 0; e < P; ++e) w |= (unsigned)v[e] << (e * (32 / P));
  return w;
}

// stage window rows dlo .. dlo + rows - 1 of region (y0, x0) (row r at
// picture row y0 - R + dlo + r, sample k at column x0 - R + k, clamped:
// HM's margin replication) into win (row_words(R, P) a row) and the
// region's source into sorg (32 / P words a row; zero outside the
// picture); thread tid of nt
template <int P>
HM_FN void stage(const int* ref, const int* org, int H, int W, int R,
                 int y0, int x0, int dlo, int rows, unsigned* win,
                 unsigned* sorg, int tid, int nt) {
  const int ws = row_samples(R) / P, stride = row_words(R, P);
  for (int k = tid; k < rows * ws; k += nt) {
    const int r = k / ws, wd = k - r * ws;
    const int* row = ref + (size_t)iclamp(y0 - R + dlo + r, 0, H - 1) * W;
    int v[P];
    for (int e = 0; e < P; ++e)
      v[e] = row[iclamp(x0 - R + wd * P + e, 0, W - 1)];
    win[r * stride + wd] = pack<P>(v);
  }
  constexpr int ow = 32 / P;
  for (int k = tid; k < 32 * ow; k += nt) {
    const int r = k / ow, wd = k - r * ow, yy = y0 + r;
    int v[P];
    for (int e = 0; e < P; ++e) {
      const int xx = x0 + wd * P + e;
      v[e] = (yy < H && xx < W) ? org[(size_t)yy * W + xx] : 0;
    }
    sorg[k] = pack<P>(v);
  }
}

// the SADs of one cell row against eight adjacent displacements: wrow is
// the window word of the first one's first sample, orow the row's 8 / P
// source words; acc[j] += the SAD at displacement j (at 8 bits each
// word's __vsadu4; at 10 bits the halfwords' absolute differences, max
// - min, summed in their halves: a cell's 32 a half stay below 2^16)
template <int P>
HM_FN void row_sads(const unsigned* wrow, const unsigned* orow,
                    unsigned* acc) {
  constexpr int OW = 8 / P, LW = (15 + P - 1) / P, NB = 16 - P;
  unsigned w[LW];
  HM_UNROLL
  for (int k = 0; k < LW; ++k) w[k] = wrow[k];
  unsigned sh[NB];  // the window's words shifted by b samples
  HM_UNROLL
  for (int b = 0; b < NB; ++b)
    sh[b] = b % P == 0 ? w[b / P]
                       : HM_FSHR(w[b / P], w[b / P + 1], (b % P) * (32 / P));
  HM_UNROLL
  for (int j = 0; j < 8; ++j)
    HM_UNROLL
    for (int k = 0; k < OW; ++k)
      acc[j] += P == 4 ? HM_VSADU4(orow[k], sh[j + k * P])
                       : HM_VABSDIFFU2(orow[k], sh[j + k * P]);
}

// a unit: cell (cy, cx) at chunk row dyl and displacements 8q .. 8q + 7;
// o the cell's 8 rows of source words; s[8] the SADs
template <int P>
HM_FN void unit_sads(const unsigned* win, int stride, const unsigned* o,
                     int cy, int cx, int dyl, int q, int* s) {
  const unsigned* w0 = win + (cy * 8 + dyl) * stride + (cx * 8 + 8 * q) / P;
  unsigned acc[8];
  HM_UNROLL
  for (int j = 0; j < 8; ++j) acc[j] = 0;
  HM_UNROLL
  for (int i = 0; i < 8; ++i)
    row_sads<P>(w0 + i * stride, o + i * (8 / P), acc);
  HM_UNROLL
  for (int j = 0; j < 8; ++j)
    s[j] = P == 4 ? (int)acc[j] : (int)((acc[j] & 0xffffu) + (acc[j] >> 16));
}

// the cell's 8 rows of source words from the staged source
template <int P>
HM_FN void cell_source(const unsigned* sorg, int cy, int cx, unsigned* o) {
  constexpr int OW = 8 / P;
HM_UNROLL
  for (int i = 0; i < 8; ++i)
HM_UNROLL
    for (int k = 0; k < OW; ++k)
      o[i * OW + k] = sorg[(cy * 8 + i) * (32 / P) + cx * OW + k];
}

// whether cell c (row-major in the region: c = 4 cy + cx) of region
// (qy, qx) lies in the picture of bh x bw cells
HM_FN bool cell_in(int c, int qy, int qx, int bh, int bw) {
  return qy * 4 + (c >> 2) < bh && qx * 4 + (c & 3) < bw;
}

// lane t of a region: 0-15 its cells, 16-19 its 16x16 blocks (row-major),
// 20 itself; the cell of its p-th item (p < 1, 4 or 16 cells), and
// whether the lane is in the picture (gh x gw 16x16 blocks)
HM_FN int lane_cells(int t) { return t < 16 ? 1 : t < 20 ? 4 : 16; }
HM_FN int lane_cell(int t, int p) {
  if (t < 16) return t;
  if (t < 20) {
    const int a = (t - 16) >> 1, b = (t - 16) & 1;
    return (2 * a + (p >> 1)) * 4 + 2 * b + (p & 1);
  }
  return p;
}

// the SAD of cell c of region (y0, x0) at window offset (oy, ox), from
// the int32 planes (the reference clamped to the picture)
HM_FN int cell_sad(const int* ref, const int* org, int H, int W, int R,
                   int y0, int x0, int c, int oy, int ox) {
  const int cy = c >> 2, cx = c & 3;
  int s = 0;
  for (int i = 0; i < 8; ++i) {
    const int yy = y0 + cy * 8 + i;
    const int* rr = ref + (size_t)iclamp(yy - R + oy, 0, H - 1) * W;
    const int* oo = org + (size_t)yy * W;
    for (int j = 0; j < 8; ++j) {
      const int xx = x0 + cx * 8 + j;
      s += iabs(oo[xx] - rr[iclamp(xx - R + ox, 0, W - 1)]);
    }
  }
  return s;
}

// the output row of lane t of region g: (mvx, mvy, best SAD, the 3x3
// stencil), or null outside the picture
HM_FN int* out_row(int* out8, int* out16, int* out32, int t, int g, int qy,
                   int qx, int bh, int bw) {
  const int gh = bh / 2, gw = bw / 2;
  if (t < 16) {
    const int by = qy * 4 + (t >> 2), bx = qx * 4 + (t & 3);
    return by < bh && bx < bw ? out8 + ((size_t)by * bw + bx) * 12 : nullptr;
  }
  if (t < 20) {
    const int gy = qy * 2 + ((t - 16) >> 1), gx = qx * 2 + ((t - 16) & 1);
    return gy < gh && gx < gw ? out16 + ((size_t)gy * gw + gx) * 12
                              : nullptr;
  }
  return out32 + (size_t)g * 12;
}

// stencil point p (0..8, row-major) of a winner at index d: the window
// offset, clamped to it
HM_FN void sten_at(int d, int p, int side, int* oy, int* ox) {
  const int dy = d / side, dx = d - (d / side) * side;
  *oy = iclamp(dy + p / 3 - 1, 0, side - 1);
  *ox = iclamp(dx + p % 3 - 1, 0, side - 1);
}

// K13 (the single level): a unit's eight SADs s (window row dyi,
// columns 8q .. 8q + 7) into a cell's running key k; the cost is
// float32(SAD) + float32(bits(4 dx - px) + bits(4 dy - py)) * lambda,
// the cell's own quarter-pel predictor (px, py) in the bits
HM_FN unsigned long long unit_key1(const int* s, int dyi, int q, int side,
                                   int R, int px, int py, float lam,
                                   unsigned long long k) {
  const int by = mv_bits(dyi, R, py);
  HM_UNROLL
  for (int j = 0; j < 8; ++j) {
    const int dxi = 8 * q + j;
    if (dxi < side)
      k = key_min(k, key_of(HM_FADD((float)s[j],
                                    mv_cost_of(mv_bits(dxi, R, px), by, lam)),
                            dyi * side + dxi));
  }
  return k;
}

// K13's output item e (0 .. 143: cell e / 9, stencil point e % 9) of
// region (qy, qx) from the cell's winner d, into the cell's row of out
// (mvx, mvy, the best SAD, the 3x3 stencil): the point's SAD, and with
// the centre point the MV and the best SAD
HM_FN void out1_item(const int* ref, const int* org, int* out, int H, int W,
                     int R, int qy, int qx, int e, int d) {
  const int c = e / 9, p = e - c * 9, side = 2 * R + 1;
  int oy, ox;
  sten_at(d, p, side, &oy, &ox);
  const int sad = cell_sad(ref, org, H, W, R, qy * 32, qx * 32, c, oy, ox);
  int* o =
      out + ((size_t)(qy * 4 + (c >> 2)) * (W / 8) + qx * 4 + (c & 3)) * 12;
  o[3 + p] = sad;
  if (p == 4) {
    o[0] = d % side - R;
    o[1] = d / side - R;
    o[2] = sad;
  }
}

#if !defined(__CUDACC__)
// K5 on one host thread: every (region, chunk) block's units in turn, the
// cells' SADs summed to the 16x16 blocks and the region as the kernel's
// warp shuffles sum them, the minima merged as keys, then the outputs
template <int P>
inline void levels_host(const int* ref, const int* org, int* out8,
                        int* out16, int* out32, int H, int W, int R,
                        float lam) {
  const int side = 2 * R + 1, bh = H / 8, bw = W / 8, gh = bh / 2,
            gw = bw / 2, qw = (gw + 1) / 2, qh = (gh + 1) / 2;
  const int stride = row_words(R, P), nq = nq_of(R);
  unsigned* win = new unsigned[stage_words(R, P)];
  unsigned* sorg = win + (chunk_rows(R) + 31) * stride;
  unsigned long long* keys = new unsigned long long[qh * qw * NLANE];
  for (int k = 0; k < qh * qw * NLANE; ++k) keys[k] = NO_KEY;
  for (int g = 0; g < qh * qw; ++g) {
    const int qy = g / qw, qx = g % qw, y0 = qy * 32, x0 = qx * 32;
    unsigned long long* kg = keys + g * NLANE;
    for (int ch = 0; ch < NCH; ++ch) {
      const int dlo = chunk_lo(ch, side), nd = chunk_lo(ch + 1, side) - dlo;
      stage<P>(ref, org, H, W, R, y0, x0, dlo, nd + 31, win, sorg, 0, 1);
      for (int dyl = 0; dyl < nd; ++dyl)
        for (int q = 0; q < nq; ++q) {
          int s[16][8];
          for (int c = 0; c < 16; ++c) {
            unsigned o[8 * (8 / P)];
            cell_source<P>(sorg, c >> 2, c & 3, o);
            unit_sads<P>(win, stride, o, c >> 2, c & 3, dyl, q, s[c]);
            if (!cell_in(c, qy, qx, bh, bw))
              for (int j = 0; j < 8; ++j) s[c][j] = 0;
          }
          for (int j = 0; j < 8; ++j) {
            const int dxi = 8 * q + j, dyi = dlo + dyl;
            if (dxi >= side) continue;
            const int d = dyi * side + dxi;
            const float mv = mv_cost(dxi, dyi, R, lam);
            int s32 = 0;
            for (int b = 0; b < 4; ++b) {
              int s16 = 0;
              for (int p = 0; p < 4; ++p) s16 += s[lane_cell(16 + b, p)][j];
              s32 += s16;
              kg[16 + b] = key_min(kg[16 + b],
                                   key_of(HM_FADD((float)s16, mv), d));
            }
            for (int c = 0; c < 16; ++c)
              kg[c] = key_min(kg[c], key_of(HM_FADD((float)s[c][j], mv), d));
            kg[20] = key_min(kg[20], key_of(HM_FADD((float)s32, mv), d));
          }
        }
    }
    for (int t = 0; t < NLANE; ++t) {
      int* o = out_row(out8, out16, out32, t, g, qy, qx, bh, bw);
      if (!o) continue;
      const int d = (int)(kg[t] & 0xffffffffu);
      for (int p = 0; p < 9; ++p) {
        int oy, ox, sum = 0;
        sten_at(d, p, side, &oy, &ox);
        for (int e = 0; e < lane_cells(t); ++e) {
          const int c = lane_cell(t, e);
          if (cell_in(c, qy, qx, bh, bw))
            sum += cell_sad(ref, org, H, W, R, y0, x0, c, oy, ox);
        }
        o[3 + p] = sum;
      }
      o[0] = d % side - R;
      o[1] = d / side - R;
      o[2] = o[3 + 4];
    }
  }
  delete[] keys;
  delete[] win;
}

// K13 on one host thread: every (region, chunk) block's units in turn,
// each cell's minimum kept as a key, then the outputs
template <int P>
inline void level1_host(const int* ref, const int* org, const int* pmx,
                        const int* pmy, int* out, int H, int W, int R,
                        float lam) {
  const int side = 2 * R + 1, bh = H / 8, bw = W / 8, qh = (bh + 3) / 4,
            qw = (bw + 3) / 4;
  const int stride = row_words(R, P), nq = nq_of(R);
  unsigned* win = new unsigned[stage_words(R, P)];
  unsigned* sorg = win + (chunk_rows(R) + 31) * stride;
  for (int g = 0; g < qh * qw; ++g) {
    const int qy = g / qw, qx = g % qw;
    unsigned long long kg[16];
    for (int c = 0; c < 16; ++c) kg[c] = NO_KEY;
    for (int ch = 0; ch < NCH; ++ch) {
      const int dlo = chunk_lo(ch, side), nd = chunk_lo(ch + 1, side) - dlo;
      stage<P>(ref, org, H, W, R, qy * 32, qx * 32, dlo, nd + 31, win, sorg,
               0, 1);
      for (int c = 0; c < 16; ++c) {
        if (!cell_in(c, qy, qx, bh, bw)) continue;
        const size_t b = (size_t)(qy * 4 + (c >> 2)) * bw + qx * 4 + (c & 3);
        unsigned o[8 * (8 / P)];
        cell_source<P>(sorg, c >> 2, c & 3, o);
        for (int dyl = 0; dyl < nd; ++dyl)
          for (int q = 0; q < nq; ++q) {
            int s[8];
            unit_sads<P>(win, stride, o, c >> 2, c & 3, dyl, q, s);
            kg[c] = unit_key1(s, dlo + dyl, q, side, R, pmx[b], pmy[b], lam,
                              kg[c]);
          }
      }
    }
    for (int e = 0; e < 16 * 9; ++e)
      if (cell_in(e / 9, qy, qx, bh, bw))
        out1_item(ref, org, out, H, W, R, qy, qx, e,
                  (int)(kg[e / 9] & 0xffffffffu));
  }
  delete[] win;
}
#endif

}  // namespace me
