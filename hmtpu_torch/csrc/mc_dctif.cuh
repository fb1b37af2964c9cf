// K7's and K11's arithmetic, shared by their entry points (mc_dctif.cu)
// and the z-scan walkers K23 (pwalk.cuh) and K26 (bwalk.cuh): the DCT-IF
// prediction of one block (8-tap luma at quarter-pel, 4-tap chroma at
// eighth-pel, H.265 8.5.4.2.2), bit-exact with hmtpu/ops/interp.py:173
// _mc_batch_jax (final samples) and :227 _mc_batch_jax_i (kInter: the
// intermediate-precision hypotheses of bi-prediction, int32 and
// unclipped).  One copy of the taps (kLuma in hm_dsp.cuh, kChroma here)
// and of the roundings (`mc_copy`, `mc_honly`, `mc_vonly`, `mc_both`)
// serves both forms below.
//
// `mc_block` (the walkers' form, block-cooperative on hm_port.cuh's (tid,
// nt) terms): the clamped (nh + ntaps - 1) x (nw + ntaps - 1) patch of the
// reference is gathered into `patch`, the horizontal pass writes every
// patch row's filtered output to `tmp`, the vertical pass reads it.
//
// `mc_warp` (K7's and K11's own kernel, Lanes<int, 32>): a warp a part of
// a block, the part a run of `mc_part_rows` rows (a whole block up to 8
// wide, 4 rows of a wider one, so a level's large blocks still fill the
// card); a part is predicted as a
// block of its own, which gives the same samples, since each output sample
// reads only the rows and columns around it.  The lanes gather the part's
// patch a row
// segment at a time (a power of two of lanes a row, several rows a step,
// so a warp's loads are consecutive addresses; 8 loads of a lane in
// flight before their stores), the horizontal pass runs only where the
// horizontal phase is
// non-zero and only over the rows the vertical pass reads (all of them
// where the vertical phase is non-zero, the block's own rows otherwise),
// the vertical pass (or the copy, or the V-only pass straight from the
// patch) writes the output in rows.  On the card the passes are separated
// by __syncwarp; a lane reads another lane's patch or tmp entry only
// after the loop that wrote it.  `forms_host` runs it on one host thread,
// lanes in order or last first (tests/test_torch_mc_lanes.py).
//
// The integer position and phase come from the MV: `mv >> 2` (`>> 3`
// chroma) is an arithmetic shift, so it floors for negative MVs as the
// reference does, and `mv & 3` (`& 7`) is the phase.  The intermediate
// stage subtracts the 14-bit offset only when both phases are non-zero;
// copy, H-only and V-only take the reference's own roundings.  Compiles
// as host C++ too.
#pragma once

#include "hm_dsp.cuh"
#include "hm_port.cuh"

namespace hm {

HM_CONST int kChroma[8][4] = {
    {0, 64, 0, 0},   {-2, 58, 10, -2}, {-4, 54, 16, -2}, {-6, 46, 28, -4},
    {-4, 36, 36, -4}, {-4, 28, 46, -6}, {-2, 16, 54, -4}, {-2, 10, 58, -2}};

// ints of the patch and tmp areas of an nw x nh block
HM_HD constexpr int mc_patch_ints(int nw, int nh, int chroma) {
  const int ntaps = chroma ? 4 : 8;
  return (nh + ntaps - 1) * (nw + ntaps - 1);
}
HM_HD constexpr int mc_tmp_ints(int nw, int nh, int chroma) {
  return (nh + (chroma ? 4 : 8) - 1) * nw;
}

// the roundings of the four cases (final samples, clipped to bd bits; or
// kInter: HM's is_last=False rules, unclipped): the copy of sample s; the
// H-only pass's sum a at the output's row; the V-only pass's sum a (taps
// on the samples themselves); the vertical sum a over the intermediate
// rows when both phases are non-zero
template <bool kInter>
HM_FN int mc_copy(int s, int bd) {
  return kInter ? (s << (IF_INTERNAL_PREC - bd)) - IF_INTERNAL_OFFS
                : iclamp(s, 0, (1 << bd) - 1);
}
template <bool kInter>
HM_FN int mc_honly(int a, int bd) {
  const int shift1 = bd - 8;
  return kInter ? (a - (IF_INTERNAL_OFFS << shift1)) >> shift1
                : iclamp((a + 32) >> IF_FILTER_PREC, 0, (1 << bd) - 1);
}
template <bool kInter>
HM_FN int mc_vonly(int a, int bd) {
  return mc_honly<kInter>(a, bd);
}
template <bool kInter>
HM_FN int mc_both(int a, int bd) {
  const int shift2 = IF_FILTER_PREC + (IF_INTERNAL_PREC - bd);
  const int off2 = (1 << (shift2 - 1)) + (IF_INTERNAL_OFFS << IF_FILTER_PREC);
  return kInter ? a >> IF_FILTER_PREC
                : iclamp((a + off2) >> shift2, 0, (1 << bd) - 1);
}
// the horizontal pass's value kept for the vertical pass: offset and
// scaled down when both phases are non-zero
HM_FN int mc_tmp(int a, bool both, int bd) {
  const int shift1 = bd - 8;
  return both ? (a - (IF_INTERNAL_OFFS << shift1)) >> shift1 : a;
}

// the nw x nh block at (xs0, ys0) of `plane` (H x W) moved by (mx, my)
// into out (raster); patch and tmp as sized above
template <bool kInter>
HM_FN void mc_block(const int* plane, int H, int W, int xs0, int ys0, int mx,
                    int my, int nw, int nh, int chroma, int bd, int* patch,
                    int* tmp, int* out, int tid, int nt) {
  const int ntaps = chroma ? 4 : 8;
  const int half = ntaps / 2 - 1;
  const int sh = chroma ? 3 : 2;
  const int msk = chroma ? 7 : 3;
  const int x = xs0 + (mx >> sh);
  const int y = ys0 + (my >> sh);
  const int fx = mx & msk, fy = my & msk;
  const int pw = nw + ntaps - 1, ph = nh + ntaps - 1;

  for (int k = tid; k < ph * pw; k += nt) {
    const int i = k / pw, j = k - (k / pw) * pw;
    const int yy = iclamp(y - half + i, 0, H - 1);
    const int xx = iclamp(x - half + j, 0, W - 1);
    patch[k] = plane[(size_t)yy * W + xx];
  }
  HM_GSYNC(nt);

  const int* cx = chroma ? &kChroma[fx][0] : &kLuma[fx][0];
  const int* cy = chroma ? &kChroma[fy][0] : &kLuma[fy][0];
  const bool both = fx != 0 && fy != 0;
  for (int k = tid; k < ph * nw; k += nt) {
    const int i = k / nw, j = k - (k / nw) * nw;
    int acc = 0;
    for (int t = 0; t < ntaps; ++t) acc += cx[t] * patch[i * pw + j + t];
    tmp[k] = mc_tmp(acc, both, bd);
  }
  HM_GSYNC(nt);

  for (int k = tid; k < nh * nw; k += nt) {
    const int i = k / nw, j = k - (k / nw) * nw;
    int v;
    if (fx == 0 && fy == 0) {
      v = mc_copy<kInter>(patch[(i + half) * pw + j + half], bd);
    } else if (fy == 0) {
      v = mc_honly<kInter>(tmp[(i + half) * nw + j], bd);
    } else {
      int acc2 = 0;
      for (int t = 0; t < ntaps; ++t) acc2 += cy[t] * tmp[(i + t) * nw + j];
      // V-only: the horizontal pass was phase 0 (x64), so acc2 is 64
      // times the vertical sum exactly
      v = fx == 0 ? mc_vonly<kInter>(acc2 >> IF_FILTER_PREC, bd)
                  : mc_both<kInter>(acc2, bd);
    }
    out[k] = v;
  }
  HM_GSYNC(nt);
}

// ---------------------------------------------------------------------------
// the warp form

#if defined(__CUDACC__)
#define MC_WSYNC() __syncwarp()
#else
#define MC_WSYNC() ((void)0)
#endif

// lanes given to a row of n items: the least power of two >= n, at most 32
HM_FN int mc_row_lanes(int n) {
  return n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 32;
}

// the rows of a warp's part of an nw x nh block (64 / nw, at least 4),
// and the parts of the block
HM_HD int mc_part_rows(int nw, int nh) {
  const int r = 64 / nw < 4 ? 4 : 64 / nw;
  return r < nh ? r : nh;
}
HM_HD int mc_parts(int nw, int nh) {
  const int r = mc_part_rows(nw, nh);
  return (nh + r - 1) / r;
}
// ints of a warp's patch and tmp areas for a part of an nw x nh block
HM_HD int mc_warp_ints(int nw, int nh, int chroma) {
  const int r = mc_part_rows(nw, nh);
  return mc_patch_ints(nw, r, chroma) + mc_tmp_ints(nw, r, chroma);
}

// mc_block's work on one warp: the nw x nh block at (xs0, ys0) of `plane`
// (H x W) moved by (mx, my) into out (raster, global memory); patch and
// tmp are the warp's own (mc_patch_ints, mc_tmp_ints)
template <bool kInter>
HM_FN void mc_warp(const int* plane, int H, int W, int xs0, int ys0, int mx,
                   int my, int nw, int nh, int chroma, int bd, int* patch,
                   int* tmp, int* out) {
  const int ntaps = chroma ? 4 : 8;
  const int half = ntaps / 2 - 1;
  const int sh = chroma ? 3 : 2;
  const int msk = chroma ? 7 : 3;
  const int x = xs0 + (mx >> sh);
  const int y = ys0 + (my >> sh);
  const int fx = mx & msk, fy = my & msk;
  const int pw = nw + ntaps - 1, ph = nh + ntaps - 1;

  // the patch: lp lanes a row (rp rows a step), each lane one column a
  // segment of lp, its clamped column found once
  const int lp = mc_row_lanes(pw), rp = 32 / lp;
  constexpr int kLd = 8;  // a lane's loads in flight
  HM_LANES(j, 32) {
    const int c = j & (lp - 1);
    for (int c0 = 0; c0 < pw; c0 += lp) {
      const int col = c0 + c;
      if (col < pw) {
        const int* src = plane + iclamp(x - half + col, 0, W - 1);
        for (int i0 = j / lp; i0 < ph; i0 += kLd * rp) {
          int v[kLd];
          HM_UNROLL
          for (int u = 0; u < kLd; ++u) {
            const int i = i0 + u * rp;
            v[u] = i < ph ? src[(size_t)iclamp(y - half + i, 0, H - 1) * W]
                          : 0;
          }
          HM_UNROLL
          for (int u = 0; u < kLd; ++u)
            if (i0 + u * rp < ph) patch[(i0 + u * rp) * pw + col] = v[u];
        }
      }
    }
  }
  MC_WSYNC();

  const int* cx = chroma ? &kChroma[fx][0] : &kLuma[fx][0];
  const int* cy = chroma ? &kChroma[fy][0] : &kLuma[fy][0];
  // an output row (and a tmp row) on lo lanes, ro rows a step
  const int lo = mc_row_lanes(nw), ro = 32 / lo;
  if (fx != 0) {
    // the rows the vertical pass reads, or the block's own rows
    const int i0 = fy != 0 ? 0 : half, i1 = fy != 0 ? ph : half + nh;
    const bool both = fy != 0;
    HM_LANES(j, 32) {
      const int c = j & (lo - 1);
      for (int c0 = 0; c0 < nw; c0 += lo) {
        const int col = c0 + c;
        if (col < nw) {
          for (int i = i0 + j / lo; i < i1; i += ro) {
            const int* s = patch + i * pw + col;
            int acc = 0;
            for (int t = 0; t < ntaps; ++t) acc += cx[t] * s[t];
            tmp[i * nw + col] = mc_tmp(acc, both, bd);
          }
        }
      }
    }
    MC_WSYNC();
  }

  HM_LANES(j, 32) {
    const int c = j & (lo - 1);
    for (int c0 = 0; c0 < nw; c0 += lo) {
      const int col = c0 + c;
      if (col < nw) {
        for (int i = j / lo; i < nh; i += ro) {
          int v;
          if (fy == 0) {
            v = fx == 0 ? mc_copy<kInter>(patch[(i + half) * pw + col + half],
                                          bd)
                        : mc_honly<kInter>(tmp[(i + half) * nw + col], bd);
          } else if (fx == 0) {
            const int* s = patch + i * pw + col + half;
            int a = 0;
            for (int t = 0; t < ntaps; ++t) a += cy[t] * s[t * pw];
            v = mc_vonly<kInter>(a, bd);
          } else {
            const int* s = tmp + i * nw + col;
            int a = 0;
            for (int t = 0; t < ntaps; ++t) a += cy[t] * s[t * nw];
            v = mc_both<kInter>(a, bd);
          }
          out[i * nw + col] = v;
        }
      }
    }
  }
}

// a form of K7 / K11's launch: one plane's stacked references (R, H, W),
// its blocks' side (nw x nh), luma or chroma, which MV set it takes, and
// its output (blocks x nh x nw)
struct McForm {
  const int* refs;
  int* out;
  int H, W, nw, nh, chroma, mvset;
};

// block b of a form: its reference (clamped, as the reference's gather),
// position (xs0 / ys0, or the b-th cell of a grid gw cells wide) and MV
// (mvx / mvy: the MV sets one after another, nb each)
struct McBlocks {
  const int* ridx;
  const int* xs0;  // null: the grid
  const int* ys0;
  const int* mvx;
  const int* mvy;
  int nb, R, gw, bd;
};

// part `part` of block b of form f on a warp; patch: mc_warp_ints ints
template <bool kInter>
HM_FN void mc_form_block(const McForm& f, const McBlocks& a, int b, int part,
                         int* patch) {
  const int r = iclamp(a.ridx[b], 0, a.R - 1);
  const int xs = a.xs0 ? a.xs0[b] : (b % a.gw) * f.nw;
  const int ys = a.xs0 ? a.ys0[b] : (b / a.gw) * f.nh;
  const int m = f.mvset * a.nb + b;
  const int rows = mc_part_rows(f.nw, f.nh), y0 = part * rows;
  const int nh = imin(rows, f.nh - y0);
  mc_warp<kInter>(f.refs + (size_t)r * f.H * f.W, f.H, f.W, xs, ys + y0,
                  a.mvx[m], a.mvy[m], f.nw, nh, f.chroma, a.bd, patch,
                  patch + mc_patch_ints(f.nw, nh, f.chroma),
                  f.out + ((size_t)b * f.nh + y0) * f.nw);
}

#if !defined(__CUDACC__)
// K7 (K11 with kInter) on one host thread: every form's blocks in turn
template <bool kInter>
inline void forms_host(const McForm* forms, int nf, const McBlocks& a) {
  for (int k = 0; k < nf; ++k) {
    const McForm& f = forms[k];
    int* patch = new int[mc_warp_ints(f.nw, f.nh, f.chroma)];
    for (int b = 0; b < a.nb; ++b)
      for (int part = 0; part < mc_parts(f.nw, f.nh); ++part)
        mc_form_block<kInter>(f, a, b, part, patch);
    delete[] patch;
  }
}
#endif

}  // namespace hm
