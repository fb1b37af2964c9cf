// K4 sao's lane code (sao.cu), on hm_port.cuh's terms, so that it also
// compiles as host C++: the statistics of a CTU's strip of rows on the
// warps of a block, and the apply of four neighbouring samples a thread.
// `stats_host` and `apply_host` run the same functions on one host thread
// (tests/test_torch_sao_lanes.py holds them to ops/sao.py's plain
// versions, lanes in order and reversed).
//
// Statistics (hmtpu/ops/sao.py:282 _sao_stats_dev): a CTU's rows are cut
// into kStrips strips, one a block.  A block stages its strip of the
// reconstruction with a one-sample halo and of the original in shared
// memory (`stage`: one round of loads), then each warp takes 32 of the
// strip's samples a step (`warp_step`): lane j the sample's org - rec, its
// band and its edge bins (one bit for each class's category), then the
// warp's sums count them (`count_step`): a sample's count and difference
// packed in one int (`kOne` + d), one warp sum for each of the 16 (class,
// category) bins and one for each band present (the bands found with one
// warp OR of their bits), every sum independent of the others.  Lane j of
// the warp keeps edge bin j's packed sum (j < 16) and band j's, in
// registers: no thread-private array, no atomics; the counts and sums are
// unpacked once, at the warp's end.  All of it is integer (a CTU's sum is
// at most 4096 x 1023 at 10 bits), so any order of the sums gives the same
// bits.
//
// Apply (hmtpu/ops/sao.py:358 apply_sao_dev): a thread takes four
// neighbouring samples of a row, which lie in one CTU (CTU sides are
// multiples of 4), reads its CTU's parameters once and its edge
// neighbours from the plane (through L1 on the card), and writes the four
// filtered samples (16-byte loads and stores where the width is a
// multiple of 4).
#pragma once

#include "hm_port.cuh"

namespace sao {

using hm::Lanes;
using hm::imin;

constexpr int kWarps = 8;               // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kStrips = 8;              // blocks a CTU: the cluster's size
constexpr int kMaxCtu = 64;
// a staged row: the left halo at column 3, the CTU's columns from 4, the
// right halo after them (16-byte aligned rows and interior); the tile holds
// the reconstruction's rows with the halo rows, then the original's
constexpr int kPitch = kMaxCtu + 8;
constexpr int kMaxRows = kMaxCtu / kStrips + 2;
constexpr int kTile = (2 * kMaxRows - 2) * kPitch;
// a block's counters: edge sums and counts (class x category), band sums,
// band counts (the row layout of ops/sao.py `sao_stats_rows`)
constexpr int kBins = 96;
// a sample in a warp sum: kOne + d, so a lane's sum over its warp's steps
// is (count << 20) + the differences' sum: a warp takes at most 64 samples
// of a strip, whose sum is under 2^19 up to 12 bits (the launchers refuse
// more)
constexpr int kOne = 1 << 20;
constexpr int kMaxBd = 12;
static_assert(kMaxCtu / kStrips * kMaxCtu / kWarps * ((1 << kMaxBd) - 1) <
                  kOne / 2,
              "a warp's packed sums");

// one plane's statistics or apply
struct Plane {
  const int* org;   // statistics only
  const int* rec;
  int* out;         // apply only
  int h, w, ctu;
};

HM_FN int sgn(int v) { return (v > 0) - (v < 0); }

// a packed warp sum's count and its differences' sum
HM_FN int packed_count(int s) { return (s + (kOne >> 1)) >> 20; }
HM_FN int packed_sum(int s) { return s - packed_count(s) * kOne; }

// the remapped edge category (0 none, 1..4) of sample p between a and b
HM_FN int edge_cat(int p, int a, int b) {
  const int raw = 2 + sgn(p - a) + sgn(p - b);
  return raw == 2 ? 0 : raw < 2 ? raw + 1 : raw;
}

// the rows of a strip: a CTU's rows over kStrips
HM_FN int strip_rows(int ctu) { return (ctu + kStrips - 1) / kStrips; }

#if defined(__CUDACC__)
// 4 ints from global memory (16-byte aligned) to shared memory, through L1
HM_FN void copy4(int* dst, const int* src) {
  *(int4*)dst = __ldg((const int4*)src);
}
HM_FN int ld(const int* p) { return __ldg(p); }
HM_FN int ctz32(unsigned x) { return __ffs((int)x) - 1; }
#else
inline void copy4(int* dst, const int* src) {
  for (int k = 0; k < 4; ++k) dst[k] = src[k];
}
inline int ld(const int* p) { return *p; }
inline int ctz32(unsigned x) { return __builtin_ctz(x); }
#endif

// the strip's rows [ys, ys + sh) of the CTU columns [x0, x0 + tw): rec
// (h x w) with a one-sample halo into tile (picture row ys + r at tile row
// r + 1, column x0 + x at tile column 4 + x), org after it (row ys + r at
// tile row sh + 2 + r).  Rows and columns past the picture repeat its edge
// (a neighbour outside the picture gives no category, so their values are
// never used).  vec: w is a multiple of 4 and the planes 16-byte aligned,
// so every staged row's interior goes in 16-byte pieces
HM_FN void stage(const int* rec, const int* org, int h, int w, int x0, int ys,
                 int sh, int tw, int* tile, bool vec, int tid, int nt) {
  const int rows = 2 * sh + 2;  // rec's with the halo, then org's
  // staged row r: its plane and picture row
  auto src = [&](int r) {
    return r < sh + 2
               ? rec + (size_t)hm::iclamp(ys - 1 + r, 0, h - 1) * w
               : org + (size_t)(ys + r - sh - 2) * w;
  };
  if (vec) {
    const int q = tw >> 2;
    for (int k = tid; k < rows * q; k += nt) {
      const int r = k / q, c = (k - r * q) << 2;
      copy4(tile + r * kPitch + 4 + c, src(r) + x0 + c);
    }
    for (int k = tid; k < (sh + 2) * 2; k += nt) {
      const int r = k >> 1, c = (k & 1) ? tw : -1;
      tile[r * kPitch + 4 + c] = ld(src(r) + hm::iclamp(x0 + c, 0, w - 1));
    }
    return;
  }
  for (int k = tid; k < rows * (tw + 2); k += nt) {
    const int r = k / (tw + 2), c = k - r * (tw + 2) - 1;
    if (r < sh + 2 || (c >= 0 && c < tw))
      tile[r * kPitch + 4 + c] = ld(src(r) + hm::iclamp(x0 + c, 0, w - 1));
  }
}

// a warp's counts of one step: lane j's sample (where act) has difference
// d, band `band` and its edge bins in hits (bit class * 4 + category - 1).
// Lane j < 16 adds edge bin j's packed sum to e, lane j band j's to b
HM_FN void count_step(const Lanes<bool, 32>& act, const Lanes<int, 32>& d,
                      const Lanes<int, 32>& band,
                      const Lanes<unsigned, 32>& hits, Lanes<int, 32>& e,
                      Lanes<int, 32>& b) {
  Lanes<int, 32> one;  // the sample packed: kOne + d, 0 where not act
  Lanes<unsigned, 32> bit;
  HM_LANES(j, 32) {
    one[j] = act[j] ? kOne + d[j] : 0;
    // a sample outside the bit depth's range is in no band (as in the
    // plain version)
    bit[j] = act[j] && (unsigned)band[j] < 32u ? 1u << band[j] : 0u;
  }
  HM_UNROLL
  for (int bin = 0; bin < 16; ++bin) {
    Lanes<int, 32> v;
    HM_LANES(j, 32) { v[j] = (hits[j] >> bin) & 1u ? one[j] : 0; }
    const int s = hm::lane_sum(v);
    HM_LANES(j, 32) {
      if (j == bin) e[j] += s;
    }
  }
  // the bands present, each summed on its own
  for (unsigned left = hm::lane_or(bit); left; left &= left - 1) {
    const int bb = ctz32(left);
    Lanes<int, 32> v;
    HM_LANES(j, 32) { v[j] = band[j] == bb ? one[j] : 0; }
    const int s = hm::lane_sum(v);
    HM_LANES(j, 32) {
      if (j == bb) b[j] += s;
    }
  }
}

// an edge category's bin bit of class c (none for category 0)
HM_FN unsigned bin_bit(int cat, int c) {
  return cat ? 1u << (c * 4 + cat - 1) : 0u;
}

// a warp's step over the strip's samples [i0, i0 + 32) (the strip: sh
// rows of tw samples from (x0, ys) of an h x w plane, staged in tile),
// lane j sample i0 + j, counted into e, b as count_step says
HM_FN void warp_step(const int* tile, int h, int w, int x0, int ys, int sh,
                     int tw, int bd, int i0, Lanes<int, 32>& e,
                     Lanes<int, 32>& b) {
  Lanes<bool, 32> act;
  Lanes<int, 32> d, band;
  Lanes<unsigned, 32> hits;
  HM_LANES(j, 32) {
    const int i = i0 + j;
    act[j] = i < sh * tw;
    const int r = act[j] ? i / tw : 0;
    const int x = act[j] ? i - r * tw : 0;
    const int* t = tile + (r + 1) * kPitch + 4 + x;
    const int p = t[0];
    const int gy = ys + r, gx = x0 + x;
    d[j] = t[(sh + 1) * kPitch] - p;  // org's row r
    band[j] = p >> (bd - 5);
    const bool in_x = gx > 0 && gx < w - 1, in_y = gy > 0 && gy < h - 1;
    unsigned hb = 0;
    if (in_x) hb |= bin_bit(edge_cat(p, t[-1], t[1]), 0);
    if (in_y) hb |= bin_bit(edge_cat(p, t[-kPitch], t[kPitch]), 1);
    if (in_x && in_y) {
      hb |= bin_bit(edge_cat(p, t[-kPitch - 1], t[kPitch + 1]), 2);
      hb |= bin_bit(edge_cat(p, t[-kPitch + 1], t[kPitch - 1]), 3);
    }
    hits[j] = hb;
  }
  count_step(act, d, band, hits, e, b);
}

// warp `warp`'s share of a staged strip: its steps, then its counters in
// part (kBins ints of the warp's own; lane j + 16 takes edge bin j's count
// from lane j)
HM_FN void warp_counts(const int* tile, int h, int w, int x0, int ys, int sh,
                       int tw, int bd, int warp, int* part) {
  Lanes<int, 32> e, b;
  HM_LANES(j, 32) {
    e[j] = 0;
    b[j] = 0;
  }
  for (int i0 = warp * 32; i0 < sh * tw; i0 += kWarps * 32)
    warp_step(tile, h, w, x0, ys, sh, tw, bd, i0, e, b);
  HM_LANES(j, 32) {
    const int n = packed_count(hm::lane_get(e, j & 15));
    part[j] = j < 16 ? packed_sum(e[j]) : n;
    part[32 + j] = packed_sum(b[j]);
    part[64 + j] = packed_count(b[j]);
  }
}

// the strip of CTU `c` that block `s` of its cluster takes: (x0, tw, ys,
// sh); sh <= 0 where the CTU has fewer rows
HM_FN void strip_of(const Plane& p, int c, int s, int& x0, int& tw, int& ys,
                    int& sh) {
  const int nx = (p.w + p.ctu - 1) / p.ctu;
  const int cy = c / nx, cx = c - cy * nx;
  x0 = cx * p.ctu;
  tw = imin(p.ctu, p.w - x0);
  const int y0 = cy * p.ctu, th = imin(p.ctu, p.h - y0);
  const int sr = strip_rows(p.ctu);
  ys = y0 + s * sr;
  sh = imin(sr, th - s * sr);
}

// samples x0 - 1 .. x0 + 4 of a row of width w into v (columns past the
// row repeat its edge); vec: the four from x0 in one 16-byte load
HM_FN void load6(const int* row, int x0, int w, bool vec, int* v) {
  v[0] = ld(row + hm::imax(x0 - 1, 0));
  v[5] = ld(row + imin(x0 + 4, w - 1));
  if (vec) {
#if defined(__CUDACC__)
    const int4 q = __ldg((const int4*)(row + x0));
    v[1] = q.x;
    v[2] = q.y;
    v[3] = q.z;
    v[4] = q.w;
#else
    for (int k = 0; k < 4; ++k) v[1 + k] = row[x0 + k];
#endif
  } else {
    HM_UNROLL
    for (int k = 0; k < 4; ++k) v[1 + k] = ld(row + imin(x0 + k, w - 1));
  }
}

// four samples of row y from column x0 (a multiple of 4) of plane p
// filtered with their CTU's parameters prm (type, class, band position,
// four offsets); vec: w is a multiple of 4 (16-byte loads and stores).
// The three rows' samples around them are loaded with the parameters, in
// one round, whatever the class
HM_FN void apply_quad(const Plane& p, const int* prm, int y, int x0, int bd,
                      bool vec) {
  const int h = p.h, w = p.w;
  // registers: every index is a constant once unrolled
  int up[6], c[6], dn[6];
  load6(p.rec + (size_t)hm::imax(y - 1, 0) * w, x0, w, vec, up);
  load6(p.rec + (size_t)y * w, x0, w, vec, c);
  load6(p.rec + (size_t)imin(y + 1, h - 1) * w, x0, w, vec, dn);
  const int typ = ld(prm), cls = ld(prm + 1), bpos = ld(prm + 2);
  const int o0 = ld(prm + 3), o1 = ld(prm + 4), o2 = ld(prm + 5),
            o3 = ld(prm + 6);
  const int maxv = (1 << bd) - 1;
  const bool in_y = cls == 0 || (y > 0 && y < h - 1);
  int r[4];
  HM_UNROLL
  for (int k = 0; k < 4; ++k) {
    const int x = x0 + k, s = c[1 + k];
    int delta = 0;
    if (typ == 2) {
      // the class's neighbours a and b
      const int a = cls == 0 ? c[k] : cls == 1 ? up[1 + k]
                                    : cls == 2 ? up[k] : up[2 + k];
      const int bb = cls == 0 ? c[2 + k] : cls == 1 ? dn[1 + k]
                                         : cls == 2 ? dn[2 + k] : dn[k];
      if (in_y && (cls == 1 || (x > 0 && x < w - 1))) {
        const int cat = edge_cat(s, a, bb);
        delta = cat == 1 ? o0 : cat == 2 ? o1 : cat == 3 ? o2 : cat == 4 ? o3
                                                                          : 0;
      }
    } else if (typ == 1) {
      const int bidx = ((s >> (bd - 5)) - bpos) & 31;
      delta = bidx == 0 ? o0 : bidx == 1 ? o1 : bidx == 2 ? o2
                                                          : bidx == 3 ? o3 : 0;
    }
    r[k] = hm::iclamp(s + delta, 0, maxv);
  }
  int* dst = p.out + (size_t)y * w;
  if (vec) {
#if defined(__CUDACC__)
    *(int4*)(dst + x0) = make_int4(r[0], r[1], r[2], r[3]);
#else
    for (int k = 0; k < 4; ++k) dst[x0 + k] = r[k];
#endif
  } else {
    HM_UNROLL
    for (int k = 0; k < 4; ++k)
      if (x0 + k < w) dst[x0 + k] = r[k];
  }
}

// the CTU count of a plane
HM_HD int ctus(int h, int w, int ctu) {
  return ((h + ctu - 1) / ctu) * ((w + ctu - 1) / ctu);
}

#if !defined(__CUDACC__)
// K4's statistics on one host thread: every plane's CTUs, each CTU's
// strips, each strip's warps in turn, then the block's and the cluster's
// sums.  out: np x CTUs x kBins (the planes' CTU counts equal)
inline void stats_host(const Plane* planes, int np, int bd, int* out) {
  static int tile[kTile];
  int part[kWarps * kBins];
  for (int pi = 0; pi < np; ++pi) {
    const Plane& p = planes[pi];
    const int n = ctus(p.h, p.w, p.ctu);
    for (int c = 0; c < n; ++c) {
      int* o = out + ((size_t)pi * n + c) * kBins;
      for (int k = 0; k < kBins; ++k) o[k] = 0;
      for (int s = 0; s < kStrips; ++s) {
        int x0, tw, ys, sh;
        strip_of(p, c, s, x0, tw, ys, sh);
        if (sh <= 0) continue;
        stage(p.rec, p.org, p.h, p.w, x0, ys, sh, tw, tile, p.w % 4 == 0, 0,
              1);
        for (int wp = 0; wp < kWarps; ++wp)
          warp_counts(tile, p.h, p.w, x0, ys, sh, tw, bd, wp,
                      part + wp * kBins);
        for (int k = 0; k < kBins; ++k)
          for (int wp = 0; wp < kWarps; ++wp) o[k] += part[wp * kBins + k];
      }
    }
  }
}

// K4's apply on one host thread: every plane's quads, last first when
// reverse (no quad reads what another writes).  params: (Y, X, np, 7)
inline void apply_host(const Plane* planes, int np, const int* params, int bd,
                       int reverse) {
  for (int pi = 0; pi < np; ++pi) {
    const Plane& p = planes[pi];
    const int qw = (p.w + 3) / 4, nx = (p.w + p.ctu - 1) / p.ctu;
    const int nq = p.h * qw;
    for (int k = 0; k < nq; ++k) {
      const int q = reverse ? nq - 1 - k : k;
      const int y = q / qw, x0 = (q - y * qw) * 4;
      const int* prm =
          params + (((size_t)(y / p.ctu) * nx + x0 / p.ctu) * np + pi) * 7;
      apply_quad(p, prm, y, x0, bd, p.w % 4 == 0);
    }
  }
}
#endif

}  // namespace sao
