// Native CABAC entropy tail for the hmtpu encoder.
//
// The encoder's batched device passes reduce each frame to a compact
// decision stream (CU-level bins recorded by entropy/recorder.py plus
// per-TB quantised level arrays).  This engine replays that stream
// through the binary arithmetic coder and the full residual_coding()
// syntax (H.265 7.3.8.11 / 9.3.4.3) in one C call — the inherently
// serial tail the reference runs in TEncBinCoderCABAC.cpp:69-440 and
// TEncSbac::codeCoeffNxN (TEncSbac.cpp:1181).
//
// All spec tables (state transitions, LPS ranges, renorm, scan orders,
// context-offset layout) are injected from Python so the single source
// of truth stays in hmtpu_torch/common/spec_tables.py; the Python engine in
// entropy/cabac.py is the bit-exact reference this file is validated
// against (tests/test_native_entropy.py).

#include <cstdint>
#include <cstring>

namespace {

struct Tables {
    const uint8_t* next_mps;     // 128
    const uint8_t* next_lps;     // 128
    const uint8_t* lps_tab;      // 64 * 4
    const uint8_t* renorm;       // 32
    const int32_t* scan_blob;    // packed scan tables
    const int32_t* scan_index;   // 12 offsets: (log2-2)*3 + scan_idx
    const int32_t* off;          // ctx offsets, see OFF_* below
    const int32_t* ctx4x4;       // 16-entry sig ctx map for 4x4
};

enum {
    OFF_LAST_X = 0, OFF_LAST_Y, OFF_LAST_X_C, OFF_LAST_Y_C,
    OFF_SIG_CG, OFF_SIG, OFF_ONE, OFF_ABS,
};

struct Enc {
    uint64_t low;
    uint32_t range;
    int bits_left;
    int num_buffered;
    uint32_t buffered_byte;
    uint8_t* out;
    int64_t pos, cap;
    uint8_t* ctx;
    const Tables* t;
    bool overflow;

    void put(uint8_t b) {
        if (pos >= cap) { overflow = true; return; }
        out[pos++] = b;
    }

    void test_write() {
        if (bits_left < 12) {
            uint32_t lead = (uint32_t)(low >> (24 - bits_left));
            bits_left += 8;
            low &= 0xFFFFFFFFull >> bits_left;
            if (lead == 0xFF) {
                num_buffered++;
            } else if (num_buffered > 0) {
                uint32_t carry = lead >> 8;
                put((uint8_t)((buffered_byte + carry) & 0xFF));
                uint8_t fill = (uint8_t)((0xFF + carry) & 0xFF);
                while (num_buffered > 1) { put(fill); num_buffered--; }
                buffered_byte = lead & 0xFF;
                num_buffered = 1;
            } else {
                num_buffered = 1;
                buffered_byte = lead;
            }
        }
    }

    void encode_bin(int idx, int bin) {
        uint8_t state = ctx[idx];
        uint32_t lps = t->lps_tab[(state >> 1) * 4 + ((range >> 6) & 3)];
        range -= lps;
        if (bin != (state & 1)) {
            int nb = t->renorm[lps >> 3];
            low = (low + range) << nb;
            range = lps << nb;
            ctx[idx] = t->next_lps[state];
            bits_left -= nb;
            test_write();
        } else {
            ctx[idx] = t->next_mps[state];
            if (range < 256) {
                low <<= 1;
                range <<= 1;
                bits_left -= 1;
                test_write();
            }
        }
    }

    void encode_aligned_bins_ep(uint32_t value, int num_bins) {
        int remaining = num_bins;
        while (remaining > 0) {
            int take = remaining < 8 ? remaining : 8;
            uint32_t mask = (1u << take) - 1;
            uint32_t bins = (value >> (remaining - take)) & mask;
            low = (low << take) + ((uint64_t)bins << 8);
            remaining -= take;
            bits_left -= take;
            test_write();
        }
    }

    void encode_bin_ep(int bin) {
        if (range == 256) { encode_aligned_bins_ep(bin, 1); return; }
        low <<= 1;
        if (bin) low += range;
        bits_left -= 1;
        test_write();
    }

    void encode_bins_ep(uint32_t value, int num_bins) {
        if (range == 256) { encode_aligned_bins_ep(value, num_bins); return; }
        while (num_bins > 8) {
            num_bins -= 8;
            uint32_t pattern = value >> num_bins;
            low = (low << 8) + (uint64_t)range * pattern;
            value -= pattern << num_bins;
            bits_left -= 8;
            test_write();
        }
        low = (low << num_bins) + (uint64_t)range * value;
        bits_left -= num_bins;
        test_write();
    }

    void encode_bin_trm(int bin) {
        range -= 2;
        if (bin) {
            low += range;
            low <<= 7;
            range = 2 << 7;
            bits_left -= 7;
        } else if (range >= 256) {
            return;
        } else {
            low <<= 1;
            range <<= 1;
            bits_left -= 1;
        }
        test_write();
    }

    // finish + stop bit + byte alignment (end of slice data)
    void finish_and_terminate() {
        if (low >> (32 - bits_left)) {
            put((uint8_t)(buffered_byte + 1));
            while (num_buffered > 1) { put(0x00); num_buffered--; }
            low -= 1ull << (32 - bits_left);
        } else {
            if (num_buffered > 0) put((uint8_t)buffered_byte);
            while (num_buffered > 1) { put(0xFF); num_buffered--; }
        }
        // trailing partial bits of low, then rbsp stop bit + align
        int nbits = 24 - bits_left;
        uint64_t tail = (low >> 8) & ((1ull << nbits) - 1);
        // append the stop bit
        tail = (tail << 1) | 1;
        nbits += 1;
        int pad = (8 - (nbits & 7)) & 7;
        tail <<= pad;
        nbits += pad;
        for (int sh = nbits - 8; sh >= 0; sh -= 8)
            put((uint8_t)((tail >> sh) & 0xFF));
    }
};

// ---------------------------------------------------------------------
// residual_coding (port of entropy/residual.py::encode_residual)

inline int last_goff(int log2, bool luma) {
    return luma ? 3 * (log2 - 2) + ((log2 - 1) >> 2) : 0;
}
inline int last_gshift(int log2, bool luma) {
    return luma ? (log2 + 1) >> 2 : log2 - 2;
}
inline int group_idx(int pos) {
    if (pos < 4) return pos;
    int bl = 32 - __builtin_clz((unsigned)pos);
    return ((bl - 1) << 1) + ((pos >> (bl - 2)) & 1);
}
inline int min_in_group(int g) {
    if (g < 4) return g;
    return (2 + (g & 1)) << ((g >> 1) - 1);
}

inline int sig_ctx_inc(const Tables* t, int patt, int x, int y, int log2,
                       int scan_idx, bool luma) {
    if (log2 == 2) return t->ctx4x4[(y << 2) + x];
    if (x + y == 0) return 0;
    int xp = x & 3, yp = y & 3, sig;
    if (patt == 0) sig = (xp + yp == 0) ? 2 : (xp + yp < 3 ? 1 : 0);
    else if (patt == 1) sig = (yp == 0) ? 2 : (yp == 1 ? 1 : 0);
    else if (patt == 2) sig = (xp == 0) ? 2 : (xp == 1 ? 1 : 0);
    else sig = 2;
    if (luma) {
        if ((x >> 2) + (y >> 2) > 0) sig += 3;
        sig += (log2 == 3) ? (scan_idx == 0 ? 9 : 15) : 21;
    } else {
        sig += (log2 == 3) ? 9 : 12;
    }
    return sig;
}

void write_remainder(Enc& e, int symbol, int rice) {
    if (symbol < (3 << rice)) {
        int length = symbol >> rice;
        e.encode_bins_ep((1u << (length + 1)) - 2, length + 1);
        if (rice) e.encode_bins_ep(symbol & ((1 << rice) - 1), rice);
    } else {
        int length = rice;
        symbol -= 3 << rice;
        while (symbol >= (1 << length)) { symbol -= 1 << length; length++; }
        e.encode_bins_ep((1u << (3 + length + 1 - rice)) - 2,
                         3 + length + 1 - rice);
        if (length) e.encode_bins_ep(symbol, length);
    }
}

constexpr int SIG_CHROMA_OFF = 28;
constexpr int C1FLAG_NUMBER = 8;
constexpr int SCAN_VER_IDX = 2;

void encode_residual(Enc& e, const int32_t* levels, int log2, bool luma,
                     int scan_idx, bool sdh) {
    const Tables* t = e.t;
    const int32_t* off = t->off;
    int size = 1 << log2;
    const int32_t* tab =
        t->scan_blob + t->scan_index[(log2 - 2) * 3 + scan_idx];
    int num_cg = tab[0];
    const int32_t* cg_order = tab + 1;             // num_cg raster ids
    const int32_t* scans = tab + 1 + num_cg;       // num_cg * 16 rasters
    int cg_w = size >> 2 > 0 ? size >> 2 : 1;

    int32_t scan_flat[1024];
    int last_scan_pos = -1;
    for (int i = 0; i < num_cg * 16; i++) {
        scan_flat[i] = levels[scans[i]];
        if (scan_flat[i]) last_scan_pos = i;
    }
    int last_cg = last_scan_pos >> 4;
    int last_raster = scans[last_scan_pos];
    int last_x = last_raster % size, last_y = last_raster / size;
    if (scan_idx == SCAN_VER_IDX) { int tmp = last_x; last_x = last_y; last_y = tmp; }

    // ---- last position
    int goff = last_goff(log2, luma), gshift = last_gshift(log2, luma);
    int gx = group_idx(last_x), gy = group_idx(last_y);
    int cmax = (log2 << 1) - 1;
    int ctx_x = off[luma ? OFF_LAST_X : OFF_LAST_X_C];
    int ctx_y = off[luma ? OFF_LAST_Y : OFF_LAST_Y_C];
    for (int b = 0; b < gx; b++)
        e.encode_bin(ctx_x + goff + (b >> gshift), 1);
    if (gx < cmax) e.encode_bin(ctx_x + goff + (gx >> gshift), 0);
    for (int b = 0; b < gy; b++)
        e.encode_bin(ctx_y + goff + (b >> gshift), 1);
    if (gy < cmax) e.encode_bin(ctx_y + goff + (gy >> gshift), 0);
    if (gx > 3) e.encode_bins_ep(last_x - min_in_group(gx), (gx >> 1) - 1);
    if (gy > 3) e.encode_bins_ep(last_y - min_in_group(gy), (gy >> 1) - 1);

    // coded_sub_block_flag maps
    bool cg_sig_scan[64], cg_sig_raster[64];
    for (int ci = 0; ci < num_cg; ci++) {
        bool any = false;
        for (int p = 0; p < 16; p++) any |= scan_flat[ci * 16 + p] != 0;
        cg_sig_scan[ci] = any;
    }
    for (int ci = 0; ci < num_cg; ci++)
        cg_sig_raster[cg_order[ci]] = cg_sig_scan[ci];

    int c1 = 1;
    for (int ci = last_cg; ci >= 0; ci--) {
        int cg_r = cg_order[ci];
        int cg_x = cg_r % cg_w, cg_y = cg_r / cg_w;
        bool infer_dc = false;
        if (0 < ci && ci < last_cg) {
            bool right = cg_x + 1 < cg_w && cg_sig_raster[cg_r + 1];
            bool below = cg_y + 1 < cg_w && cg_sig_raster[cg_r + cg_w];
            int ctx_inc = off[OFF_SIG_CG] + (luma ? 0 : 2)
                          + ((right || below) ? 1 : 0);
            e.encode_bin(ctx_inc, cg_sig_scan[ci] ? 1 : 0);
            infer_dc = cg_sig_scan[ci];
            if (!cg_sig_scan[ci]) continue;
        }
        bool right = cg_x + 1 < cg_w && cg_sig_raster[cg_y * cg_w + cg_x + 1];
        bool below = cg_y + 1 < cg_w && cg_sig_raster[(cg_y + 1) * cg_w + cg_x];
        int patt = (right ? 1 : 0) | (below ? 2 : 0);

        // ---- sig_coeff_flag (reverse scan within CG)
        int sig_pos[16], sig_lv[16];
        int n = 0;
        int start;
        if (ci == last_cg) {
            start = (last_scan_pos & 15) - 1;
            sig_pos[n] = last_scan_pos & 15;
            sig_lv[n++] = scan_flat[last_scan_pos];
        } else {
            start = 15;
        }
        for (int p = start; p >= 0; p--) {
            int lv = scan_flat[ci * 16 + p];
            bool sig = lv != 0;
            if (!(p == 0 && infer_dc)) {
                int raster = scans[ci * 16 + p];
                int x = raster % size, y = raster / size;
                int sc = sig_ctx_inc(t, patt, x, y, log2, scan_idx, luma);
                e.encode_bin(off[OFF_SIG] + (luma ? sc : SIG_CHROMA_OFF + sc),
                             sig ? 1 : 0);
            }
            if (sig) { sig_pos[n] = p; sig_lv[n++] = lv; }
            if (sig && p > 0) infer_dc = false;
        }

        if (n == 0) continue;        // all-zero CG0 below the last CG

        // ---- greater1/greater2, signs, remainders
        int abs_lv[16], signs[16];
        for (int i = 0; i < n; i++) {
            abs_lv[i] = sig_lv[i] < 0 ? -sig_lv[i] : sig_lv[i];
            signs[i] = sig_lv[i] < 0 ? 1 : 0;
        }
        int ctx_set = ((ci > 0 && luma) ? 2 : 0) + (c1 == 0 ? 1 : 0);
        c1 = 1;
        int first_g2 = -1;
        int lim = n < C1FLAG_NUMBER ? n : C1FLAG_NUMBER;
        for (int i = 0; i < lim; i++) {
            int g1 = abs_lv[i] > 1 ? 1 : 0;
            e.encode_bin(off[OFF_ONE] + (luma ? 0 : 16) + ctx_set * 4 + c1,
                         g1);
            if (g1) {
                c1 = 0;
                if (first_g2 < 0) first_g2 = i;
            } else if (0 < c1 && c1 < 3) {
                c1++;
            }
        }
        if (first_g2 >= 0)
            e.encode_bin(off[OFF_ABS] + (luma ? ctx_set : 4 + ctx_set),
                         abs_lv[first_g2] > 2 ? 1 : 0);

        bool hide = sdh && (sig_pos[0] - sig_pos[n - 1] > 3);
        int nsign = hide ? n - 1 : n;
        for (int i = 0; i < nsign; i++) e.encode_bin_ep(signs[i]);

        int rice = 0, first_coeff2 = 1;
        for (int i = 0; i < n; i++) {
            int base = (i < C1FLAG_NUMBER) ? (2 + first_coeff2) : 1;
            if (abs_lv[i] >= base) {
                write_remainder(e, abs_lv[i] - base, rice);
                if (abs_lv[i] > (3 << rice)) rice = rice < 4 ? rice + 1 : 4;
            }
            if (abs_lv[i] >= 2) first_coeff2 = 0;
        }
    }
}

// ---------------------------------------------------------------------
// P-slice slice-data serialiser: walks the CTU quadtree over the 8x8
// decision tensors the device wavefront produces and emits the complete
// slice payload in one call (the native twin of the Python walk in
// encoder/pframe.py::_entropy_pass, which remains the bit-exact
// reference; parity enforced by tests/test_native_entropy.py).

enum {                               // cu_off layout (python packs this)
    CU_SAO_MERGE = 0, CU_SAO_TYPE, CU_SPLIT, CU_SKIP, CU_PRED_MODE,
    CU_PART_SIZE, CU_INTRA_MODE, CU_CHROMA_MODE, CU_QT_CBF_LUMA,
    CU_QT_CBF_CHROMA, CU_QT_ROOT_CBF, CU_MERGE_FLAG, CU_MERGE_IDX,
    CU_MVD, CU_REF_PIC, CU_MVP_IDX, CU_INTER_DIR, CU_TRANSFORMSKIP,
    CU_OFF_N,
};

struct SliceCfg {
    int w, h, ctu, log2_ctu;
    int bw, bh;                      // 8x8 block grid
    int max_merge, num_ref;
    int sdh;                         // sign data hiding
    int sao_luma, sao_chroma, bd;
    int ts;                          // PPS transform_skip_enabled
    const int32_t* tsf;              // per-cell flag bits: cb|cr<<1
    const int32_t* cu_off;
    // per-block decision tensors (bh*bw)
    const int32_t* kind;             // 0 skip 1 merge 2 amvp 3 intra
    const int32_t* mi;               // merge idx
    const int32_t* mvdx;
    const int32_t* mvdy;
    const int32_t* mvpi;
    const int32_t* refi;
    const int32_t* imode;            // intra mode (valid when kind==3)
    const int32_t* levy;             // (bh*bw) * 64
    const int32_t* levcb;            // (bh*bw) * 16
    const int32_t* levcr;            // (bh*bw) * 16
    const int32_t* lev16y;           // (bh/2*bw/2) * 256
    const int32_t* lev16cb;          // (bh/2*bw/2) * 64
    const int32_t* lev16cr;          // (bh/2*bw/2) * 64
    const int32_t* lev32y;           // (bh/4*bw/4) * 1024
    const int32_t* lev32cb;          // (bh/4*bw/4) * 256
    const int32_t* lev32cr;          // (bh/4*bw/4) * 256
    const int32_t* depth8;           // (bh*bw) coding-tree depth/cell
    // per-CTU SAO params: 21 int32 = 3 x (type, eo_class, band_pos, o0..o3)
    const int32_t* sao;
};

inline int sao_max_offset(int bd) { return (1 << (bd < 10 ? bd : 10) - 5) - 1; }

void write_sao_offset_abs(Enc& e, int v, int cmax) {
    for (int i = 0; i < v; i++) e.encode_bin_ep(1);
    if (v < cmax) e.encode_bin_ep(0);
}

void write_sao_ctu(Enc& e, const SliceCfg& s, const int32_t* p3,
                   bool left, bool up) {
    if (left) e.encode_bin(s.cu_off[CU_SAO_MERGE], 0);
    if (up) e.encode_bin(s.cu_off[CU_SAO_MERGE], 0);
    int cmax = sao_max_offset(s.bd);
    for (int c = 0; c < 3; c++) {
        if (c == 0 && !s.sao_luma) continue;
        if (c > 0 && !s.sao_chroma) continue;
        const int32_t* p = p3 + c * 7;
        int t;
        if (c < 2) {
            t = p[0];
            e.encode_bin(s.cu_off[CU_SAO_TYPE], t != 0);
            if (t != 0) e.encode_bin_ep(t == 2);
        } else {
            t = p3[1 * 7 + 0];
        }
        if (t == 0) continue;
        for (int i = 0; i < 4; i++) {
            int v = p[3 + i];
            write_sao_offset_abs(e, v < 0 ? -v : v, cmax);
        }
        if (t == 1) {
            for (int i = 0; i < 4; i++)
                if (p[3 + i] != 0) e.encode_bin_ep(p[3 + i] < 0);
            e.encode_bins_ep((uint32_t)p[2], 5);
        } else if (c < 2) {
            e.encode_bins_ep((uint32_t)p[1], 2);
        }
    }
}

// candModeList (H.265 8.4.2)
void mpm_list_c(int a, int b, int out[3]) {
    if (a == b) {
        if (a < 2) { out[0] = 0; out[1] = 1; out[2] = 26; return; }
        out[0] = a;
        out[1] = 2 + ((a + 29) % 32);
        out[2] = 2 + ((a - 1) % 32);
        return;
    }
    out[0] = a; out[1] = b;
    if (a != 0 && b != 0) out[2] = 0;
    else if (a != 1 && b != 1) out[2] = 1;
    else out[2] = 26;
}

inline int intra_scan_of(int mode, int log2, bool luma) {
    if (log2 > 3 || (!luma && log2 > 2)) return 0;
    if (mode >= 6 && mode <= 14) return 2;
    if (mode >= 22 && mode <= 30) return 1;
    return 0;
}

inline bool any_nz(const int32_t* p, int n) {
    for (int i = 0; i < n; i++) if (p[i]) return true;
    return false;
}

void write_egk(Enc& e, int value, int k) {
    while (value >= (1 << k)) { e.encode_bin_ep(1); value -= 1 << k; k++; }
    e.encode_bin_ep(0);
    if (k) e.encode_bins_ep((uint32_t)value, k);
}

void write_mvd(Enc& e, const SliceCfg& s, int mvd_x, int mvd_y) {
    int ax = mvd_x < 0 ? -mvd_x : mvd_x, ay = mvd_y < 0 ? -mvd_y : mvd_y;
    e.encode_bin(s.cu_off[CU_MVD] + 0, ax > 0);
    e.encode_bin(s.cu_off[CU_MVD] + 0, ay > 0);
    if (ax > 0) e.encode_bin(s.cu_off[CU_MVD] + 1, ax > 1);
    if (ay > 0) e.encode_bin(s.cu_off[CU_MVD] + 1, ay > 1);
    if (ax > 0) {
        if (ax > 1) write_egk(e, ax - 2, 1);
        e.encode_bin_ep(mvd_x < 0);
    }
    if (ay > 0) {
        if (ay > 1) write_egk(e, ay - 2, 1);
        e.encode_bin_ep(mvd_y < 0);
    }
}

void write_merge_idx(Enc& e, const SliceCfg& s, int idx) {
    if (s.max_merge <= 1) return;
    e.encode_bin(s.cu_off[CU_MERGE_IDX], idx > 0);
    if (idx > 0) {
        for (int i = 1; i < idx; i++) e.encode_bin_ep(1);
        if (idx < s.max_merge - 1) e.encode_bin_ep(0);
    }
}

void write_ref_idx(Enc& e, const SliceCfg& s, int idx) {
    if (s.num_ref <= 1) return;
    e.encode_bin(s.cu_off[CU_REF_PIC] + 0, idx > 0);
    if (idx > 0 && s.num_ref > 2) {
        e.encode_bin(s.cu_off[CU_REF_PIC] + 1, idx > 1);
        if (idx > 1) {
            for (int i = 2; i < idx; i++) e.encode_bin_ep(1);
            if (idx < s.num_ref - 1) e.encode_bin_ep(0);
        }
    }
}

// 64x64 inter CU (TU quadtree forced one level down: log2TrafoSize 6
// exceeds MaxTbLog2SizeY 5, so split_transform_flag is inferred and
// the CU codes four 32x32 TBs — H.265 7.3.8.8 interSplitFlag; the
// reference's recursive form is TComTU.cpp / TEncSearch.cpp:5273).
// The quadrant coefficients are the collapsed 32x32 CUs' lev32 blocks.
void write_cu64_residual(Enc& e, const SliceCfg& s, int x0, int y0) {
    int q32w = s.bw >> 2;
    const int32_t *ly[4], *lcb[4], *lcr[4];
    bool cy[4], ccb[4], ccr[4];
    for (int i = 0; i < 4; i++) {
        int qx = (x0 >> 5) + (i & 1), qy = (y0 >> 5) + (i >> 1);
        int p32 = qy * q32w + qx;
        ly[i] = s.lev32y + p32 * 1024;
        lcb[i] = s.lev32cb + p32 * 256;
        lcr[i] = s.lev32cr + p32 * 256;
        cy[i] = any_nz(ly[i], 1024);
        ccb[i] = any_nz(lcb[i], 256);
        ccr[i] = any_nz(lcr[i], 256);
    }
    bool root_cb = ccb[0] || ccb[1] || ccb[2] || ccb[3];
    bool root_cr = ccr[0] || ccr[1] || ccr[2] || ccr[3];
    // root chroma cbfs at trafoDepth 0 (32x32 chroma TB pre-split)
    e.encode_bin(s.cu_off[CU_QT_CBF_CHROMA] + 0, root_cb);
    e.encode_bin(s.cu_off[CU_QT_CBF_CHROMA] + 0, root_cr);
    for (int i = 0; i < 4; i++) {
        // child trafoDepth 1: chroma cbf only under a set parent,
        // luma cbf always coded (ctx +0 at depth > 0)
        if (root_cb) e.encode_bin(s.cu_off[CU_QT_CBF_CHROMA] + 1, ccb[i]);
        if (root_cr) e.encode_bin(s.cu_off[CU_QT_CBF_CHROMA] + 1, ccr[i]);
        e.encode_bin(s.cu_off[CU_QT_CBF_LUMA] + 0, cy[i]);
        if (cy[i]) encode_residual(e, ly[i], 5, true, 0, s.sdh);
        if (root_cb && ccb[i])
            encode_residual(e, lcb[i], 4, false, 0, s.sdh);
        if (root_cr && ccr[i])
            encode_residual(e, lcr[i], 4, false, 0, s.sdh);
    }
}

inline bool cu64_any_cbf(const SliceCfg& s, int x0, int y0) {
    int q32w = s.bw >> 2;
    for (int i = 0; i < 4; i++) {
        int qx = (x0 >> 5) + (i & 1), qy = (y0 >> 5) + (i >> 1);
        int p32 = qy * q32w + qx;
        if (any_nz(s.lev32y + p32 * 1024, 1024)) return true;
        if (any_nz(s.lev32cb + p32 * 256, 256)) return true;
        if (any_nz(s.lev32cr + p32 * 256, 256)) return true;
    }
    return false;
}

// transform_skip_flag for a 4x4 chroma TB (7.3.8.11; ctx +1 = chroma)
inline void ts_flag_chroma(Enc& e, const SliceCfg& s, int p, int bit) {
    if (s.ts)
        e.encode_bin(s.cu_off[CU_TRANSFORMSKIP] + 1,
                     (s.tsf[p] >> bit) & 1);
}

void write_cu_p(Enc& e, const SliceCfg& s, int x0, int y0, int log2) {
    int bxi = x0 >> 3, byi = y0 >> 3;
    int p = byi * s.bw + bxi;
    int k = s.kind[p];
    int inc = 0;
    if (bxi > 0 && s.kind[p - 1] == 0) inc++;
    if (byi > 0 && s.kind[p - s.bw] == 0) inc++;
    e.encode_bin(s.cu_off[CU_SKIP] + inc, k == 0);
    if (k == 0) { write_merge_idx(e, s, s.mi[p]); return; }
    e.encode_bin(s.cu_off[CU_PRED_MODE], k == 3);

    if (log2 == 6) {                 // 64x64 inter CU, residual below
        e.encode_bin(s.cu_off[CU_PART_SIZE], 1);     // 2Nx2N
        if (k == 1) {
            e.encode_bin(s.cu_off[CU_MERGE_FLAG], 1);
            write_merge_idx(e, s, s.mi[p]);
        } else {
            e.encode_bin(s.cu_off[CU_MERGE_FLAG], 0);
            write_ref_idx(e, s, s.refi[p]);
            write_mvd(e, s, s.mvdx[p], s.mvdy[p]);
            e.encode_bin(s.cu_off[CU_MVP_IDX], s.mvpi[p]);
            int root = cu64_any_cbf(s, x0, y0) ? 1 : 0;
            e.encode_bin(s.cu_off[CU_QT_ROOT_CBF], root);
            if (!root) return;
        }
        write_cu64_residual(e, s, x0, y0);
        return;
    }

    const int32_t *ly, *lcb, *lcr;
    int nl, nc;
    if (log2 == 5) {                 // 32x32 inter CU
        int p32 = (byi >> 2) * (s.bw >> 2) + (bxi >> 2);
        ly = s.lev32y + p32 * 1024;
        lcb = s.lev32cb + p32 * 256;
        lcr = s.lev32cr + p32 * 256;
        nl = 1024; nc = 256;
    } else if (log2 == 4) {          // 16x16 inter CU
        int p16 = (byi >> 1) * (s.bw >> 1) + (bxi >> 1);
        ly = s.lev16y + p16 * 256;
        lcb = s.lev16cb + p16 * 64;
        lcr = s.lev16cr + p16 * 64;
        nl = 256; nc = 64;
    } else {
        ly = s.levy + p * 64;
        lcb = s.levcb + p * 16;
        lcr = s.levcr + p * 16;
        nl = 64; nc = 16;
    }
    bool cbf_y = any_nz(ly, nl), cbf_cb = any_nz(lcb, nc),
         cbf_cr = any_nz(lcr, nc);

    if (k == 3) {                    // intra
        e.encode_bin(s.cu_off[CU_PART_SIZE], 1);   // 2Nx2N
        int mode = s.imode[p];
        int lm = (bxi > 0 && s.kind[p - 1] == 3) ? s.imode[p - 1] : 1;
        int am = (byi > 0 && (y0 & (s.ctu - 1)) != 0
                  && s.kind[p - s.bw] == 3) ? s.imode[p - s.bw] : 1;
        int mpm[3];
        mpm_list_c(lm, am, mpm);
        int mi_idx = -1;
        for (int i = 0; i < 3; i++) if (mpm[i] == mode) { mi_idx = i; break; }
        if (mi_idx >= 0) {
            e.encode_bin(s.cu_off[CU_INTRA_MODE], 1);
            e.encode_bin_ep(mi_idx == 0 ? 0 : 1);
            if (mi_idx) e.encode_bin_ep(mi_idx - 1);
        } else {
            e.encode_bin(s.cu_off[CU_INTRA_MODE], 0);
            // remove-sorted-mpms remainder
            int srt[3] = {mpm[0], mpm[1], mpm[2]};
            for (int i = 0; i < 2; i++)
                for (int j = i + 1; j < 3; j++)
                    if (srt[j] < srt[i]) { int t = srt[i]; srt[i] = srt[j]; srt[j] = t; }
            int rem = mode;
            for (int i = 2; i >= 0; i--) if (mode > srt[i]) rem--;
            e.encode_bins_ep((uint32_t)rem, 5);
        }
        e.encode_bin(s.cu_off[CU_CHROMA_MODE], 0);   // DM
        e.encode_bin(s.cu_off[CU_QT_CBF_CHROMA], cbf_cb);
        e.encode_bin(s.cu_off[CU_QT_CBF_CHROMA], cbf_cr);
        e.encode_bin(s.cu_off[CU_QT_CBF_LUMA] + 1, cbf_y);
        if (cbf_y)
            encode_residual(e, ly, 3, true,
                            intra_scan_of(mode, 3, true), s.sdh);
        if (cbf_cb) {
            ts_flag_chroma(e, s, p, 0);
            encode_residual(e, lcb, 2, false,
                            intra_scan_of(mode, 2, false), s.sdh);
        }
        if (cbf_cr) {
            ts_flag_chroma(e, s, p, 1);
            encode_residual(e, lcr, 2, false,
                            intra_scan_of(mode, 2, false), s.sdh);
        }
        return;
    }

    // inter 2Nx2N
    e.encode_bin(s.cu_off[CU_PART_SIZE], 1);
    if (k == 1) {                    // merge
        e.encode_bin(s.cu_off[CU_MERGE_FLAG], 1);
        write_merge_idx(e, s, s.mi[p]);
    } else {                         // AMVP (P: L0 only)
        e.encode_bin(s.cu_off[CU_MERGE_FLAG], 0);
        write_ref_idx(e, s, s.refi[p]);
        write_mvd(e, s, s.mvdx[p], s.mvdy[p]);
        e.encode_bin(s.cu_off[CU_MVP_IDX], s.mvpi[p]);
    }
    if (k == 2) {
        int root = (cbf_y || cbf_cb || cbf_cr) ? 1 : 0;
        e.encode_bin(s.cu_off[CU_QT_ROOT_CBF], root);
        if (!root) return;
    }
    e.encode_bin(s.cu_off[CU_QT_CBF_CHROMA], cbf_cb);
    e.encode_bin(s.cu_off[CU_QT_CBF_CHROMA], cbf_cr);
    if (cbf_cb || cbf_cr)
        e.encode_bin(s.cu_off[CU_QT_CBF_LUMA] + 1, cbf_y);
    if (cbf_y) encode_residual(e, ly, log2, true, 0, s.sdh);
    if (cbf_cb) {
        if (log2 == 3) ts_flag_chroma(e, s, p, 0);
        encode_residual(e, lcb, log2 - 1, false, 0, s.sdh);
    }
    if (cbf_cr) {
        if (log2 == 3) ts_flag_chroma(e, s, p, 1);
        encode_residual(e, lcr, log2 - 1, false, 0, s.sdh);
    }
}

void write_quadtree_p(Enc& e, const SliceCfg& s, int x0, int y0, int log2,
                      int depth) {
    int size = 1 << log2;
    bool inside = x0 + size <= s.w && y0 + size <= s.h;
    int bxi = x0 >> 3, byi = y0 >> 3;
    bool split = s.depth8[byi * s.bw + bxi] > depth;
    if (inside && log2 > 3) {
        // 9.3.4.2.2: context from neighbour CU depths
        int inc = 0;
        if (x0 > 0 && s.depth8[byi * s.bw + bxi - 1] > depth) inc++;
        if (y0 > 0 && s.depth8[(byi - 1) * s.bw + bxi] > depth) inc++;
        e.encode_bin(s.cu_off[CU_SPLIT] + inc, split ? 1 : 0);
    }
    if (log2 > 3 && (split || !inside)) {
        int half = size >> 1;
        if (x0 < s.w && y0 < s.h)
            write_quadtree_p(e, s, x0, y0, log2 - 1, depth + 1);
        if (x0 + half < s.w && y0 < s.h)
            write_quadtree_p(e, s, x0 + half, y0, log2 - 1, depth + 1);
        if (x0 < s.w && y0 + half < s.h)
            write_quadtree_p(e, s, x0, y0 + half, log2 - 1, depth + 1);
        if (x0 + half < s.w && y0 + half < s.h)
            write_quadtree_p(e, s, x0 + half, y0 + half, log2 - 1,
                             depth + 1);
    } else {
        write_cu_p(e, s, x0, y0, log2);
    }
}

}  // namespace

// arithmetic-engine restart at a WPP substream boundary
// (TEncBinCABAC::start; contexts are handled separately)
inline void enc_restart(Enc& e) {
    e.low = 0; e.range = 510; e.bits_left = 23;
    e.num_buffered = 0; e.buffered_byte = 0xFF;
}

// ---------------------------------------------------------------------
// command stream: 4 int32 per command [op, a, b, c]
enum {
    OP_BIN = 0,        // a=ctx idx, b=bin
    OP_BIN_EP = 1,     // a=bin
    OP_BINS_EP = 2,    // a=value, b=num_bins
    OP_TRM = 3,        // a=bin
    OP_RESIDUAL = 4,   // a=log2|(scan<<4)|(luma<<8)|(sdh<<9), b=lvl offset
    OP_TERMINATE = 5,  // trm(1) + finish + stop bit + align
    OP_SAVE_CTX = 6,       // a=n_ctx: WPP context storage (9.3.2.2)
    OP_RESTORE_CTX = 7,    // a=n_ctx: row-start sync (saved else init)
    OP_END_SUBSTREAM = 8,  // trm(1)+flush+align+engine restart
};

extern "C" int64_t hmtpu_entropy_encode(
    const uint8_t* next_mps, const uint8_t* next_lps,
    const uint8_t* lps_tab, const uint8_t* renorm,
    const int32_t* scan_blob, const int32_t* scan_index,
    const int32_t* off, const int32_t* ctx4x4,
    uint8_t* ctx, const int32_t* cmds, int64_t num_cmds,
    const int32_t* levels, uint8_t* out, int64_t out_cap,
    int32_t* bounds_out) {
    Tables t{next_mps, next_lps, lps_tab, renorm,
             scan_blob, scan_index, off, ctx4x4};
    Enc e;
    enc_restart(e);
    e.out = out; e.pos = 0; e.cap = out_cap;
    e.ctx = ctx; e.t = &t; e.overflow = false;
    uint8_t saved[1024];
    int nb = 0;

    for (int64_t i = 0; i < num_cmds; i++) {
        const int32_t* c = cmds + i * 4;
        switch (c[0]) {
            case OP_BIN: e.encode_bin(c[1], c[2]); break;
            case OP_BIN_EP: e.encode_bin_ep(c[1]); break;
            case OP_BINS_EP: e.encode_bins_ep((uint32_t)c[1], c[2]); break;
            case OP_TRM: e.encode_bin_trm(c[1]); break;
            case OP_RESIDUAL: {
                int a = c[1];
                encode_residual(e, levels + c[2], a & 15, (a >> 8) & 1,
                                (a >> 4) & 3, (a >> 9) & 1);
                break;
            }
            case OP_TERMINATE:
                e.encode_bin_trm(1);
                e.finish_and_terminate();
                break;
            case OP_SAVE_CTX:
                // the recorder guarantees a save precedes any restore
                // (a width-1 picture saves the slice-init state once)
                if (c[1] > 1024) return -3;
                memcpy(saved, e.ctx, c[1]);
                break;
            case OP_RESTORE_CTX:
                if (c[1] > 1024) return -3;
                memcpy(e.ctx, saved, c[1]);
                break;
            case OP_END_SUBSTREAM:
                e.encode_bin_trm(1);
                e.finish_and_terminate();
                enc_restart(e);
                if (bounds_out) bounds_out[1 + nb++] = (int32_t)e.pos;
                break;
            default:
                return -2;
        }
        if (e.overflow) return -1;
    }
    if (bounds_out) bounds_out[0] = nb;
    return e.pos;
}

// Whole-slice serialisation from decision tensors (device wavefront
// output).  geom = [w, h, ctu_size, max_merge, num_ref, sdh, sao_luma,
// sao_chroma, bd].  sao may be null (no per-CTU SAO syntax).
extern "C" int64_t hmtpu_encode_pslice(
    const uint8_t* next_mps, const uint8_t* next_lps,
    const uint8_t* lps_tab, const uint8_t* renorm,
    const int32_t* scan_blob, const int32_t* scan_index,
    const int32_t* off, const int32_t* ctx4x4,
    uint8_t* ctx, uint8_t* out, int64_t out_cap,
    const int32_t* geom, const int32_t* cu_off,
    const int32_t* kind, const int32_t* mi,
    const int32_t* mvdx, const int32_t* mvdy,
    const int32_t* mvpi, const int32_t* refi, const int32_t* imode,
    const int32_t* levy, const int32_t* levcb, const int32_t* levcr,
    const int32_t* lev16y, const int32_t* lev16cb,
    const int32_t* lev16cr, const int32_t* lev32y,
    const int32_t* lev32cb, const int32_t* lev32cr,
    const int32_t* depth8, const int32_t* sao, const int32_t* tsf,
    int32_t* bounds_out) {
    Tables t{next_mps, next_lps, lps_tab, renorm,
             scan_blob, scan_index, off, ctx4x4};
    Enc e;
    enc_restart(e);
    e.out = out; e.pos = 0; e.cap = out_cap;
    e.ctx = ctx; e.t = &t; e.overflow = false;

    SliceCfg s;
    s.w = geom[0]; s.h = geom[1]; s.ctu = geom[2];
    s.log2_ctu = 31 - __builtin_clz((unsigned)s.ctu);
    s.bw = s.w >> 3; s.bh = s.h >> 3;
    s.max_merge = geom[3]; s.num_ref = geom[4]; s.sdh = geom[5];
    s.sao_luma = geom[6]; s.sao_chroma = geom[7]; s.bd = geom[8];
    s.ts = geom[11]; s.tsf = tsf;
    s.cu_off = cu_off;
    s.kind = kind; s.mi = mi; s.mvdx = mvdx; s.mvdy = mvdy;
    s.mvpi = mvpi; s.refi = refi; s.imode = imode;
    s.levy = levy; s.levcb = levcb; s.levcr = levcr;
    s.lev16y = lev16y; s.lev16cb = lev16cb; s.lev16cr = lev16cr;
    s.lev32y = lev32y; s.lev32cb = lev32cb; s.lev32cr = lev32cr;
    s.depth8 = depth8; s.sao = sao;

    int n_ctu_x = (s.w + s.ctu - 1) / s.ctu;
    int n_ctu_y = (s.h + s.ctu - 1) / s.ctu;
    // WPP (entropy_coding_sync): ctx stored after the row's 2nd CTU,
    // restored at each row start; one byte-aligned substream per row
    // (TEncSlice.cpp:1066-1089, 9.3.2.2)
    bool wpp = geom[9] != 0;
    int n_ctx = geom[10];
    if (n_ctx > 1024) return -3;
    uint8_t saved[1024];
    if (wpp) memcpy(saved, ctx, n_ctx);   // width-1 fallback = init
    int sync_x = n_ctu_x > 1 ? 1 : -1;
    int nb = 0;
    for (int cy = 0; cy < n_ctu_y; cy++) {
        if (wpp && cy > 0) {
            memcpy(ctx, saved, n_ctx);
            enc_restart(e);
        }
        for (int cx = 0; cx < n_ctu_x; cx++) {
            if (sao)
                write_sao_ctu(e, s, sao + (cy * n_ctu_x + cx) * 21,
                              cx > 0, cy > 0);
            write_quadtree_p(e, s, cx * s.ctu, cy * s.ctu, s.log2_ctu, 0);
            if (wpp && cx == sync_x) memcpy(saved, ctx, n_ctx);
            bool last = cy == n_ctu_y - 1 && cx == n_ctu_x - 1;
            if (!last) e.encode_bin_trm(0);
            if (wpp && cx == n_ctu_x - 1 && !last) {
                e.encode_bin_trm(1);
                e.finish_and_terminate();
                enc_restart(e);
                if (bounds_out) bounds_out[1 + nb++] = (int32_t)e.pos;
            }
            if (e.overflow) return -1;
        }
    }
    e.encode_bin_trm(1);
    e.finish_and_terminate();
    if (bounds_out) bounds_out[0] = nb;
    if (e.overflow) return -1;
    return e.pos;
}
