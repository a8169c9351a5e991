/* CAVLC slice-data writer, native serial implementation.
 *
 * Exact port of the framework's Python writer
 * (h264_tpu/encoder/syntax_cavlc.py + entropy/cavlc/enc.py), which is the
 * oracle it is fuzz-tested against.  Spec 7.3.5 + 9.1/9.2 semantics
 * (reference behavior: lencod/src/macroblock.c writeMBLayer:2582,
 * writeCoeff4x4_CAVLC:4099, vlc.c level/total_zeros/run writers).
 *
 * Scope: frame-coded P/I slices, mb types PSKIP/P16x16/P16x8/P8x16/P8x8/
 * I4MB/I16MB, 4:2:0.  Returns -1 for anything else; the caller falls back
 * to the Python writer.  All VLC tables are passed in from the Python
 * single source of truth (entropy/cavlc/tables.py).
 */

#include <stdint.h>
#include <string.h>

/* mb types (h264_tpu/decoder/mbtables.py) */
#define MB_PSKIP 0
#define MB_P16x16 1
#define MB_P16x8 2
#define MB_P8x16 3
#define MB_P8x8 8
#define MB_I4 9
#define MB_I16 10
#define B8_8x8 4
#define B8_8x4 5
#define B8_4x8 6
#define B8_4x4 7
#define DC_PRED 2

static const int ZZX[16] = {0,1,0,0,1,2,3,2,1,0,1,2,3,3,2,3};
static const int ZZY[16] = {0,0,1,2,1,0,0,1,2,3,3,2,1,2,3,3};
static const int B4X[16] = {0,1,0,1,2,3,2,3,0,1,0,1,2,3,2,3};
static const int B4Y[16] = {0,0,1,1,0,0,1,1,2,2,3,3,2,2,3,3};

typedef struct {
    uint8_t *buf;
    long cap_bits;
    long pos; /* bits written */
    int err;
} BW;

static void put(BW *w, uint32_t val, int n) {
    if (n <= 0) return;
    if (w->pos + n > w->cap_bits) { w->err = 1; return; }
    long pos = w->pos;
    w->pos += n;
    for (int i = n - 1; i >= 0; i--, pos++) {
        if ((val >> i) & 1)
            w->buf[pos >> 3] |= (uint8_t)(0x80 >> (pos & 7));
    }
}

static void put64(BW *w, uint64_t val, int n) {
    if (n > 32) {
        put(w, (uint32_t)(val >> 32), n - 32);
        put(w, (uint32_t)(val & 0xffffffffu), 32);
    } else {
        put(w, (uint32_t)val, n);
    }
}

static void ue(BW *w, uint32_t v) {
    uint64_t code = (uint64_t)v + 1;
    int n = 0;
    for (uint64_t t = code; t; t >>= 1) n++;
    put(w, 0, n - 1);
    put64(w, code, n);
}

static void se(BW *w, int32_t v) {
    ue(w, v > 0 ? (uint32_t)(2 * v - 1) : (uint32_t)(-2 * v));
}

static void te(BW *w, int v, int max_val) {
    if (max_val == 1)
        put(w, 1 - v, 1);
    else
        ue(w, v);
}

/* ---- residual block (entropy/cavlc/enc.py encode_block) --------------- */

#define T3(t, a, b, c) ((t)[((a) * 4 + (b)) * 17 + (c)])
#define T2(t, a, b, C) ((t)[(a) * (C) + (b)])

static const int32_t INC_VLC[7] = {0, 3, 6, 12, 24, 48, 32768};

typedef struct {
    const int32_t *ct_len, *ct_code;       /* [3][4][17] */
    const int32_t *ctc_len, *ctc_code;     /* [4][17] (4:2:0 chroma DC) */
    const int32_t *tz_len, *tz_code;       /* [15][16] */
    const int32_t *tzc_len, *tzc_code;     /* [15][16] padded (yuv 0) */
    const int32_t *rb_len, *rb_code;       /* [7][15] */
    const int32_t *cbp_intra, *cbp_inter;  /* [48] */
} Tables;

static void level_escape2(BW *w, int32_t levabsesc, int sign, int sub_offset) {
    int num_prefix = 15;
    int length = 28;
    if (levabsesc > 2048) {
        num_prefix++;
        while (levabsesc > (1 << (num_prefix - 3)) - 4096) num_prefix++;
    }
    int addbit = num_prefix - 15;
    length += addbit << 1;
    int64_t val = levabsesc;
    if (sub_offset) val -= ((int64_t)2048 << addbit) - 2048;
    if (val < 0 || length > 64) { w->err = 2; return; }
    put64(w, ((uint64_t)1 << (12 + addbit)) | ((uint64_t)val << 1) |
                 (uint64_t)sign,
          length);
}

static void level_vlc1(BW *w, int32_t level) {
    int32_t levabs = level < 0 ? -level : level;
    int sign = level < 0;
    if (levabs < 8) {
        put(w, 1, levabs * 2 + sign - 1);
    } else if (levabs < 16) {
        put(w, (1u << 4) | ((uint32_t)(levabs - 8) << 1) | (uint32_t)sign, 19);
    } else {
        level_escape2(w, levabs - 16, sign, 0);
    }
}

static void level_vlcn(BW *w, int32_t level, int vlc) {
    int sign = level < 0;
    int32_t levabs = (level < 0 ? -level : level) - 1;
    int shift = vlc - 1;
    int32_t escape = 15 << shift;
    if (levabs < escape) {
        int32_t suffix = levabs & ((1 << shift) - 1);
        int num_prefix = levabs >> shift;
        int length = num_prefix + vlc + 1;
        if (length > 64) { w->err = 2; return; }
        put64(w, ((uint64_t)1 << (shift + 1)) | ((uint64_t)suffix << 1) |
                     (uint64_t)sign,
              length);
    } else {
        level_escape2(w, levabs - escape, sign, 1);
    }
}

/* scan: coefficients in scan order; returns total_coeff */
static int encode_block(BW *w, const int32_t *scan, int max_coeff, int nc,
                        int chroma_dc, const Tables *T) {
    int32_t levels[16];
    int32_t runs[16];
    int numcoeff = 0, run = 0, totzeros = 0;
    for (int i = 0; i < max_coeff; i++) {
        if (scan[i] == 0) {
            run++;
        } else {
            levels[numcoeff] = scan[i];
            runs[numcoeff] = run;
            totzeros += run;
            run = 0;
            numcoeff++;
        }
    }
    int t1 = 0;
    for (int k = numcoeff - 1; k >= 0 && t1 < 3; k--) {
        int32_t a = levels[k] < 0 ? -levels[k] : levels[k];
        if (a == 1) t1++; else break;
    }

    if (chroma_dc) {
        put(w, T3(T->ctc_code, 0, t1, numcoeff), T3(T->ctc_len, 0, t1, numcoeff));
    } else {
        int vlcnum = nc < 2 ? 0 : (nc < 4 ? 1 : (nc < 8 ? 2 : 3));
        if (vlcnum == 3) {
            put(w, numcoeff ? (uint32_t)(((numcoeff - 1) << 2) | t1) : 3u, 6);
        } else {
            put(w, T3(T->ct_code, vlcnum, t1, numcoeff),
                T3(T->ct_len, vlcnum, t1, numcoeff));
        }
    }
    if (numcoeff == 0) return 0;

    if (t1) {
        uint32_t code = 0;
        for (int k = numcoeff - 1; k > numcoeff - 1 - t1; k--)
            code = (code << 1) | (levels[k] < 0 ? 1u : 0u);
        put(w, code, t1);
    }

    int level_two_or_higher = (numcoeff > 3 && t1 == 3) ? 0 : 1;
    int vlc = (numcoeff > 10 && t1 < 3) ? 1 : 0;
    int first = 1;
    for (int k = numcoeff - 1 - t1; k >= 0; k--) {
        int32_t lv = levels[k];
        int32_t enc_lv = lv;
        if (level_two_or_higher) {
            level_two_or_higher = 0;
            enc_lv = lv > 0 ? lv - 1 : lv + 1;
        }
        if (vlc == 0)
            level_vlc1(w, enc_lv);
        else
            level_vlcn(w, enc_lv, vlc);
        int32_t a = lv < 0 ? -lv : lv;
        if (a > INC_VLC[vlc]) vlc++;
        if (first && a > 3) vlc = 2;
        first = 0;
    }

    if (numcoeff < max_coeff) {
        const int32_t *lt = chroma_dc ? T->tzc_len : T->tz_len;
        const int32_t *ct = chroma_dc ? T->tzc_code : T->tz_code;
        put(w, T2(ct, numcoeff - 1, totzeros, 16),
            T2(lt, numcoeff - 1, totzeros, 16));
    }

    int zerosleft = totzeros;
    int numcoef = numcoeff;
    for (int k = numcoeff - 1; k >= 0; k--) {
        if (!zerosleft || numcoeff <= 1) break;
        if (numcoef > 1) {
            int vlcr = zerosleft - 1 < 6 ? zerosleft - 1 : 6;
            int r = runs[k];
            put(w, T2(T->rb_code, vlcr, r, 15), T2(T->rb_len, vlcr, r, 15));
            zerosleft -= r;
            numcoef--;
        }
    }
    return numcoeff;
}

/* ---- slice writer ------------------------------------------------------ */

typedef struct {
    int n_mbW, n_mbH, n_mbs, W4, H4, cW2, cH2;
    const int32_t *mb_type, *skip_flag, *cbp, *qp, *c_ipred_mode;
    const int32_t *b8mode;   /* [nb][4] */
    const int32_t *i16mode, *is_intra, *slice_id;
    const int32_t *ipredmode; /* [H4][W4] */
    const int32_t *ref_idx0;  /* [H4][W4] */
    const int32_t *mvd0;      /* [H4][W4][2] */
    const int32_t *luma_levels; /* [nb][16][4][4] */
    const int32_t *luma_dc;     /* [nb][4][4] */
    const int32_t *chroma_dc;   /* [nb][2][2][2] */
    const int32_t *chroma_levels; /* [nb][2][4][4][4] */
    int is_p, n_ref, constrained_intra, chroma420;
    int32_t *nnz; /* [3][H4][W4] */
    int cur_qp;
    const Tables *T;
} Ctx;

/* frame-coding luma 4x4 neighbor (state.py luma4x4_neighbor), for left
 * (dx=-1) or up (dy=-1) of block (bx,by) in MB addr.  Returns avail;
 * outputs neighbor MB addr and absolute block coords. */
static int luma_nb(const Ctx *c, int addr, int bx, int by, int left,
                   int *n_addr, int *ax, int *ay) {
    int mb_x = addr % c->n_mbW, mb_y = addr / c->n_mbW;
    int na;
    int nbx, nby;
    if (left) {
        if (bx > 0) { na = addr; nbx = bx - 1; nby = by; }
        else if (mb_x > 0) { na = addr - 1; nbx = 3; nby = by; }
        else return 0;
    } else {
        if (by > 0) { na = addr; nbx = bx; nby = by - 1; }
        else if (mb_y > 0) { na = addr - c->n_mbW; nbx = bx; nby = 3; }
        else return 0;
    }
    if (c->slice_id[na] != c->slice_id[addr]) return 0;
    *n_addr = na;
    *ax = 4 * (na % c->n_mbW) + nbx;
    *ay = 4 * (na / c->n_mbW) + nby;
    return 1;
}

/* chroma (4:2:0) 4x4 neighbor on the 2x2 block grid */
static int chroma_nb(const Ctx *c, int addr, int bx, int by, int left,
                     int *ax, int *ay) {
    int mb_x = addr % c->n_mbW, mb_y = addr / c->n_mbW;
    int na, nbx, nby;
    if (left) {
        if (bx > 0) { na = addr; nbx = bx - 1; nby = by; }
        else if (mb_x > 0) { na = addr - 1; nbx = 1; nby = by; }
        else return 0;
    } else {
        if (by > 0) { na = addr; nbx = bx; nby = by - 1; }
        else if (mb_y > 0) { na = addr - c->n_mbW; nbx = bx; nby = 1; }
        else return 0;
    }
    if (c->slice_id[na] != c->slice_id[addr]) return 0;
    *ax = 2 * (na % c->n_mbW) + nbx;
    *ay = 2 * (na / c->n_mbW) + nby;
    return 1;
}

static int mpm(const Ctx *c, int addr, int bx, int by) {
    int la_addr, lax, lay, ua_addr, uax, uay;
    int la = luma_nb(c, addr, bx, by, 1, &la_addr, &lax, &lay);
    int ua = luma_nb(c, addr, bx, by, 0, &ua_addr, &uax, &uay);
    if (c->constrained_intra) {
        if (la) la = c->is_intra[la_addr];
        if (ua) ua = c->is_intra[ua_addr];
    }
    int left_m = la ? c->ipredmode[lay * c->W4 + lax] : -1;
    int up_m = ua ? c->ipredmode[uay * c->W4 + uax] : -1;
    if (left_m < 0 || up_m < 0) return DC_PRED;
    return left_m < up_m ? left_m : up_m;
}

static int predict_nnz(const Ctx *c, int addr, int bx, int by, int plane) {
    int la, ua, na, lax, lay, uax, uay;
    if (plane == 0) {
        la = luma_nb(c, addr, bx, by, 1, &na, &lax, &lay);
        ua = luma_nb(c, addr, bx, by, 0, &na, &uax, &uay);
    } else {
        la = chroma_nb(c, addr, bx, by, 1, &lax, &lay);
        ua = chroma_nb(c, addr, bx, by, 0, &uax, &uay);
    }
    int pred = 0, cnt = 0;
    long ps = (long)plane * c->H4 * c->W4;
    if (la) { pred += c->nnz[ps + lay * c->W4 + lax]; cnt++; }
    if (ua) { pred += c->nnz[ps + uay * c->W4 + uax]; cnt++; }
    if (cnt == 2) pred = (pred + 1) >> 1;
    return pred;
}

static void write_motion(Ctx *c, BW *w, int addr, int mbt) {
    int x4 = 4 * (addr % c->n_mbW), y4 = 4 * (addr / c->n_mbW);
    int parts[4][5];
    int n_parts;
    if (mbt == MB_P16x16) {
        int p0[5] = {0, 0, 4, 4, 0};
        memcpy(parts[0], p0, sizeof p0);
        n_parts = 1;
    } else if (mbt == MB_P16x8) {
        int p0[5] = {0, 0, 4, 2, 0}, p1[5] = {0, 2, 4, 2, 2};
        memcpy(parts[0], p0, sizeof p0);
        memcpy(parts[1], p1, sizeof p1);
        n_parts = 2;
    } else if (mbt == MB_P8x16) {
        int p0[5] = {0, 0, 2, 4, 0}, p1[5] = {2, 0, 2, 4, 1};
        memcpy(parts[0], p0, sizeof p0);
        memcpy(parts[1], p1, sizeof p1);
        n_parts = 2;
    } else { /* P8x8 */
        for (int b8 = 0; b8 < 4; b8++) {
            parts[b8][0] = (b8 & 1) * 2;
            parts[b8][1] = (b8 >> 1) * 2;
            parts[b8][2] = 2;
            parts[b8][3] = 2;
            parts[b8][4] = b8;
        }
        n_parts = 4;
    }
    if (c->n_ref > 1) {
        for (int i = 0; i < n_parts; i++) {
            int bx = parts[i][0], by = parts[i][1];
            te(w, c->ref_idx0[(y4 + by) * c->W4 + x4 + bx], c->n_ref - 1);
        }
    }
    for (int i = 0; i < n_parts; i++) {
        int bx = parts[i][0], by = parts[i][1], b8 = parts[i][4];
        int subs[4][2];
        int n_subs;
        if (mbt == MB_P8x8) {
            int b8m = c->b8mode[addr * 4 + b8];
            int sw = (b8m == B8_8x8 || b8m == B8_8x4) ? 2 : 1;
            int sh = (b8m == B8_8x8 || b8m == B8_4x8) ? 2 : 1;
            n_subs = 0;
            for (int dy = 0; dy < 2; dy += sh)
                for (int dx = 0; dx < 2; dx += sw) {
                    subs[n_subs][0] = bx + dx;
                    subs[n_subs][1] = by + dy;
                    n_subs++;
                }
        } else {
            subs[0][0] = bx;
            subs[0][1] = by;
            n_subs = 1;
        }
        for (int s = 0; s < n_subs; s++) {
            long o = ((long)(y4 + subs[s][1]) * c->W4 + x4 + subs[s][0]) * 2;
            se(w, c->mvd0[o]);
            se(w, c->mvd0[o + 1]);
        }
    }
}

static void write_residuals(Ctx *c, BW *w, int addr) {
    int mbt = c->mb_type[addr];
    int cbp = c->cbp[addr];
    int x4 = 4 * (addr % c->n_mbW), y4 = 4 * (addr / c->n_mbW);
    long L = (long)c->H4 * c->W4;
    int32_t scan[16];

    if (mbt == MB_I16) {
        const int32_t *dc = c->luma_dc + (long)addr * 16;
        for (int i = 0; i < 16; i++) scan[i] = dc[ZZY[i] * 4 + ZZX[i]];
        int nc = predict_nnz(c, addr, 0, 0, 0);
        int n = encode_block(w, scan, 16, nc, 0, c->T);
        c->nnz[(long)y4 * c->W4 + x4] = n;
    }
    if (cbp & 15) {
        int maxc = mbt == MB_I16 ? 15 : 16;
        for (int b8 = 0; b8 < 4; b8++) {
            for (int b4 = 0; b4 < 4; b4++) {
                int blk = b8 * 4 + b4;
                int bx = B4X[blk], by = B4Y[blk];
                if (!(cbp & (1 << b8))) {
                    c->nnz[(long)(y4 + by) * c->W4 + x4 + bx] = 0;
                    continue;
                }
                const int32_t *lv = c->luma_levels + ((long)addr * 16 + blk) * 16;
                int off = mbt == MB_I16 ? 1 : 0;
                for (int i = off; i < 16; i++)
                    scan[i - off] = lv[ZZY[i] * 4 + ZZX[i]];
                int nc = predict_nnz(c, addr, bx, by, 0);
                int n = encode_block(w, scan, maxc, nc, 0, c->T);
                c->nnz[(long)(y4 + by) * c->W4 + x4 + bx] = n;
            }
        }
    }
    if (!c->chroma420) return;
    if (cbp > 15) {
        for (int uv = 0; uv < 2; uv++) {
            const int32_t *dc = c->chroma_dc + ((long)addr * 2 + uv) * 4;
            scan[0] = dc[0]; scan[1] = dc[1]; scan[2] = dc[2]; scan[3] = dc[3];
            encode_block(w, scan, 4, -1, 1, c->T);
        }
    }
    if (cbp > 31) {
        int x2 = 2 * (addr % c->n_mbW), y2 = 2 * (addr / c->n_mbW);
        for (int uv = 0; uv < 2; uv++) {
            for (int blk = 0; blk < 4; blk++) {
                int bx = blk & 1, by = blk >> 1;
                const int32_t *lv =
                    c->chroma_levels + (((long)addr * 2 + uv) * 4 + blk) * 16;
                for (int i = 1; i < 16; i++)
                    scan[i - 1] = lv[ZZY[i] * 4 + ZZX[i]];
                int nc = predict_nnz(c, addr, bx, by, 1 + uv);
                int n = encode_block(w, scan, 15, nc, 0, c->T);
                /* plane index 1+uv, on the chroma block grid (2*W_mb wide,
                 * stored in the W4-wide nnz plane) */
                c->nnz[(long)(1 + uv) * L + (long)(y2 + by) * c->W4 + x2 + bx] = n;
            }
        }
    }
}

static int write_mb(Ctx *c, BW *w, int addr) {
    int mbt = c->mb_type[addr];
    int cbp = c->cbp[addr];
    int val;
    if (mbt == MB_I16) {
        int off4 = (cbp >> 4) + 3 * ((cbp & 15) ? 1 : 0);
        val = (c->is_p ? 6 : 1) + c->i16mode[addr] + 4 * off4;
    } else if (mbt == MB_I4) {
        val = c->is_p ? 5 : 0;
    } else if (mbt >= MB_P16x16 && mbt <= MB_P8x16) {
        val = mbt - 1;
    } else if (mbt == MB_P8x8) {
        val = 3;
    } else {
        return -1;
    }
    ue(w, val);

    int x4 = 4 * (addr % c->n_mbW), y4 = 4 * (addr / c->n_mbW);

    if (mbt == MB_P8x8) {
        for (int b8 = 0; b8 < 4; b8++) {
            int b8m = c->b8mode[addr * 4 + b8];
            if (b8m < B8_8x8 || b8m > B8_4x4) return -1;
            ue(w, b8m - B8_8x8);
        }
    }

    if (mbt == MB_I4) {
        for (int blk = 0; blk < 16; blk++) {
            int bx = B4X[blk], by = B4Y[blk];
            int mode = c->ipredmode[(y4 + by) * c->W4 + x4 + bx];
            int m = mpm(c, addr, bx, by);
            if (mode == m) {
                put(w, 1, 1);
            } else {
                put(w, 0, 1);
                put(w, mode < m ? mode : mode - 1, 3);
            }
        }
    }
    if (mbt == MB_I4 || mbt == MB_I16) ue(w, c->c_ipred_mode[addr]);

    if (mbt >= MB_P16x16 && mbt <= MB_P8x8 && mbt != MB_I4)
        write_motion(c, w, addr, mbt);

    if (mbt != MB_I16)
        ue(w, (mbt == MB_I4 ? c->T->cbp_intra : c->T->cbp_inter)[cbp]);

    if (cbp != 0 || mbt == MB_I16) {
        int dq = c->qp[addr] - c->cur_qp;
        c->cur_qp = c->qp[addr];
        se(w, dq);
    }
    write_residuals(c, w, addr);
    return 0;
}

long cavlc_write_slice(
    int n_mbW, int n_mbH,
    const int32_t *mb_type, const int32_t *skip_flag, const int32_t *cbp,
    const int32_t *qp, const int32_t *c_ipred_mode, const int32_t *b8mode,
    const int32_t *i16mode, const int32_t *is_intra, const int32_t *slice_id,
    const int32_t *ipredmode, const int32_t *ref_idx0, const int32_t *mvd0,
    const int32_t *luma_levels, const int32_t *luma_dc,
    const int32_t *chroma_dc, const int32_t *chroma_levels,
    int is_p, int n_ref, int init_qp, int constrained_intra, int chroma420,
    const int32_t *mb_addrs, int n_addrs,
    const int32_t *ct_len, const int32_t *ct_code,
    const int32_t *ctc_len, const int32_t *ctc_code,
    const int32_t *tz_len, const int32_t *tz_code,
    const int32_t *tzc_len, const int32_t *tzc_code,
    const int32_t *rb_len, const int32_t *rb_code,
    const int32_t *cbp_intra, const int32_t *cbp_inter,
    int32_t *nnz, uint8_t *out, long out_cap_bits) {
    Tables T = {ct_len, ct_code, ctc_len, ctc_code, tz_len, tz_code,
                tzc_len, tzc_code, rb_len, rb_code, cbp_intra, cbp_inter};
    Ctx c = {n_mbW, n_mbH, n_mbW * n_mbH, 4 * n_mbW, 4 * n_mbH,
             2 * n_mbW, 2 * n_mbH,
             mb_type, skip_flag, cbp, qp, c_ipred_mode, b8mode, i16mode,
             is_intra, slice_id, ipredmode, ref_idx0, mvd0, luma_levels,
             luma_dc, chroma_dc, chroma_levels, is_p, n_ref,
             constrained_intra, chroma420, nnz, init_qp, &T};
    BW w = {out, out_cap_bits, 0, 0};
    int skip_run = 0;
    for (int i = 0; i < n_addrs; i++) {
        int addr = mb_addrs[i];
        if (is_p && skip_flag[addr]) {
            skip_run++;
            continue;
        }
        if (is_p) {
            ue(&w, skip_run);
            skip_run = 0;
        }
        if (write_mb(&c, &w, addr) < 0) return -1;
        if (w.err) return -1;
    }
    if (is_p && skip_run) ue(&w, skip_run);
    if (w.err) return -1;
    return w.pos;
}
