/* Native full-picture reconstruction: parsed SE tensors -> pixels.
 *
 * The host runtime tail of the decoder: motion-vector derivation
 * (PMV / P_Skip / B spatial+temporal direct), quarter-pel MC with
 * weighted prediction, intra prediction (I4/I8/I16 + chroma), and
 * dequant + inverse transforms, in one C pass over the flat state
 * arrays the native CABAC/CAVLC parsers fill.  decoder/recon.py and
 * decoder/mv.py remain the portable oracles; this file mirrors their
 * arithmetic exactly (which in turn mirrors ldecod/src/macroblock.c
 * decode_one_macroblock:4203, mc_prediction.c get_block_luma:149,
 * block.c itrans/itrans_2, transform8x8.c itrans8x8).
 *
 * Frame coding, 4:2:0, 8-bit, no IPCM (the Python wrapper falls back
 * to the oracle for pictures that need more).
 *
 * Build: gcc -O3 -shared -fPIC -o librecon.so recon.c
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>
#include <stdlib.h>

#define MAXREF 32
#define NONE_ID (-(int64_t)1000000000)

/* JM internal macroblock modes (decoder/mbtables.py) */
enum { PSKIP=0, P16x16=1, P16x8=2, P8x16=3, P8x8M=8, I4MB=9, I16MB=10,
       IBLOCK=11, I8MB=13, IPCM=14 };
enum { B8_DIRECT=0, B8_8x8=4, B8_8x4=5, B8_4x8=6, B8_4x4=7 };
enum { PD_L0=0, PD_L1=1, PD_BI=2 };
enum { ST_P=0, ST_B=1, ST_I=2 };

static const int BLK4_X[16] = {0,1,0,1,2,3,2,3,0,1,0,1,2,3,2,3};
static const int BLK4_Y[16] = {0,0,1,1,0,0,1,1,2,2,3,3,2,2,3,3};

/* normAdjust4x4 / normAdjust8x8 dequant tables (spec 8.5.9) */
static const int V4C[6][3] = {
  {10,16,13},{11,18,14},{13,20,16},{14,23,18},{16,25,20},{18,29,23}};
static const int CLASS4[4][4] = {{0,2,0,2},{2,1,2,1},{0,2,0,2},{2,1,2,1}};
static const int V8C[6][6] = {
  {20,18,32,19,25,24},{22,19,35,21,28,26},{26,23,42,24,33,31},
  {28,25,45,26,35,33},{32,28,51,30,40,38},{36,32,58,34,46,43}};
static int class8(int i, int j) {
  if (i % 4 == 0 && j % 4 == 0) return 0;
  if (i % 2 == 1 && j % 2 == 1) return 1;
  if (i % 4 == 2 && j % 4 == 2) return 2;
  if ((i % 4 == 0 && j % 2 == 1) || (i % 2 == 1 && j % 4 == 0)) return 3;
  if ((i % 4 == 0 && j % 4 == 2) || (i % 4 == 2 && j % 4 == 0)) return 4;
  return 5;
}

static inline int iclip(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
static inline int64_t rshift_rnd_sf64(int64_t x, int a) {
  return (x + ((int64_t)1 << (a - 1))) >> a;
}
static inline int imin(int a, int b) { return a < b ? a : b; }
static inline int imax(int a, int b) { return a > b ? a : b; }
static inline int med3(int a, int b, int c) {
  return a + b + c - imin(a, imin(b, c)) - imax(a, imax(b, c));
}

/* ---- context ---- */
typedef struct {
  int W, H, n_mbs, W4, H4;      /* geometry in MBs / 4x4 blocks */
  int width, height, cw, ch;    /* pixels; chroma plane dims */
  int pad;                      /* reference-plane padding (MC.PAD) */
  int cip;                      /* constrained_intra_pred_flag */
  /* state arrays */
  const int32_t *slice_id, *mb_type, *qp, *qpc, *i16mode, *c_ipred_mode,
                *b8mode, *b8pdir;
  const uint8_t *is_intra, *skip_flag, *transform8x8;
  const int8_t *ipredmode, *ref_idx_in;
  const int32_t *mvd;
  const int32_t *luma_levels, *luma8_levels, *luma_dc, *chroma_dc,
                *chroma_levels;
  /* outputs */
  int8_t *ref_idx;              /* (2, H4, W4) — spatial direct writes */
  int32_t *mv;                  /* (2, H4, W4, 2) */
  int64_t *ref_pic_id;          /* (2, H4, W4) */
  int32_t *Y, *U, *V;           /* picture planes */
  /* per-slice tables (NS slices) */
  int NS;
  const int32_t *s_type, *s_spatial, *s_d8x8, *s_nref; /* s_nref (NS,2) */
  const int64_t *s_refids;      /* (NS, 2, MAXREF) unique ids (POCs) */
  const uint8_t *s_reflt;       /* (NS, 2, MAXREF) long-term flags */
  const int32_t *s_curpoc, *s_colpoc;
  /* colocated (per slice; NULL-able via s_has_col) */
  const int32_t *s_has_col;
  const uint8_t *col_moving;    /* (NS, H4, W4) */
  const int8_t *col_ref0, *col_ref1;   /* (NS, H4, W4) */
  const int64_t *col_id0, *col_id1;    /* (NS, H4, W4) */
  const int32_t *col_mv0, *col_mv1;    /* (NS, H4, W4, 2) */
  /* WP tables */
  const int32_t *wp_mode, *wp_ly, *wp_lc;       /* (NS,) */
  const int32_t *cadj;          /* (NS, 2, MAXREF) chroma parity adj */
  const int32_t *wy, *oy;       /* (NS, 2, MAXREF) */
  const int32_t *wc, *oc;       /* (NS, 2, MAXREF, 2) */
  const int32_t *wimp;          /* (NS, MAXREF, MAXREF, 2) implicit pairs */
  /* reference plane pointer tables (NS, 2, MAXREF) */
  int32_t *const *refY, *const *refU, *const *refV;
  /* scaling matrices: ws4 (6,16) ws8 (2,64) or NULL (flat 16) */
  const int32_t *ws4, *ws8;
} rctx_t;

/* inverse level scale = normAdjust * WeightScale (list idx per use) */
static void ils4(const rctx_t *c, int list_idx, int rem, int *out /*16*/) {
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) {
      int w = c->ws4 ? c->ws4[list_idx * 16 + i * 4 + j] : 16;
      out[i * 4 + j] = V4C[rem][CLASS4[i][j]] * w;
    }
}
static void ils8(const rctx_t *c, int list_idx, int rem, int *out /*64*/) {
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) {
      int w = c->ws8 ? c->ws8[list_idx * 64 + i * 8 + j] : 16;
      out[i * 8 + j] = V8C[rem][class8(i, j)] * w;
    }
}

/* ---- transforms (transforms.py duals, int64 internals) ---- */
static void inv4x4(const int64_t in[16], int64_t out[16]) {
  int64_t t[16];
  for (int r = 0; r < 4; r++) {
    int64_t w0 = in[r*4], w1 = in[r*4+1], w2 = in[r*4+2], w3 = in[r*4+3];
    int64_t e0 = w0 + w2, e1 = w0 - w2;
    int64_t e2 = (w1 >> 1) - w3, e3 = w1 + (w3 >> 1);
    t[r*4] = e0 + e3; t[r*4+1] = e1 + e2;
    t[r*4+2] = e1 - e2; t[r*4+3] = e0 - e3;
  }
  for (int cidx = 0; cidx < 4; cidx++) {
    int64_t w0 = t[cidx], w1 = t[4+cidx], w2 = t[8+cidx], w3 = t[12+cidx];
    int64_t e0 = w0 + w2, e1 = w0 - w2;
    int64_t e2 = (w1 >> 1) - w3, e3 = w1 + (w3 >> 1);
    out[cidx] = e0 + e3; out[4+cidx] = e1 + e2;
    out[8+cidx] = e1 - e2; out[12+cidx] = e0 - e3;
  }
}
static void had4x4(const int64_t in[16], int64_t out[16]) {
  int64_t t[16];
  for (int r = 0; r < 4; r++) {
    int64_t w0 = in[r*4], w1 = in[r*4+1], w2 = in[r*4+2], w3 = in[r*4+3];
    int64_t e0 = w0 + w2, e1 = w0 - w2, e2 = w1 - w3, e3 = w1 + w3;
    t[r*4] = e0 + e3; t[r*4+1] = e1 + e2;
    t[r*4+2] = e1 - e2; t[r*4+3] = e0 - e3;
  }
  for (int cidx = 0; cidx < 4; cidx++) {
    int64_t w0 = t[cidx], w1 = t[4+cidx], w2 = t[8+cidx], w3 = t[12+cidx];
    int64_t e0 = w0 + w2, e1 = w0 - w2, e2 = w1 - w3, e3 = w1 + w3;
    out[cidx] = e0 + e3; out[4+cidx] = e1 + e2;
    out[8+cidx] = e1 - e2; out[12+cidx] = e0 - e3;
  }
}
static void inv8_1d(const int64_t p[8], int64_t o[8]) {
  int64_t a0 = p[0] + p[4], a4 = p[0] - p[4];
  int64_t a2 = (p[2] >> 1) - p[6], a6 = p[2] + (p[6] >> 1);
  int64_t b0 = a0 + a6, b2 = a4 + a2, b4 = a4 - a2, b6 = a0 - a6;
  int64_t a1 = -p[3] + p[5] - p[7] - (p[7] >> 1);
  int64_t a3 = p[1] + p[7] - p[3] - (p[3] >> 1);
  int64_t a5 = -p[1] + p[7] + p[5] + (p[5] >> 1);
  int64_t a7 = p[3] + p[5] + p[1] + (p[1] >> 1);
  int64_t b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2);
  int64_t b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
  o[0] = b0 + b7; o[1] = b2 + b5; o[2] = b4 + b3; o[3] = b6 + b1;
  o[4] = b6 - b1; o[5] = b4 - b3; o[6] = b2 - b5; o[7] = b0 - b7;
}
static void inv8x8(const int64_t in[64], int64_t out[64]) {
  int64_t t[64], row[8], o[8];
  for (int r = 0; r < 8; r++) {
    inv8_1d(in + r * 8, t + r * 8);
  }
  for (int cidx = 0; cidx < 8; cidx++) {
    for (int r = 0; r < 8; r++) row[r] = t[r * 8 + cidx];
    inv8_1d(row, o);
    for (int r = 0; r < 8; r++) out[r * 8 + cidx] = o[r];
  }
}

/* ---- neighbor topology (decoder/state.py) ---- */
static inline int mb_avail(const rctx_t *c, int nb, int cur) {
  if (nb < 0 || nb >= c->n_mbs) return 0;
  return c->slice_id[nb] == c->slice_id[cur];
}
static int luma_nb(const rctx_t *c, int addr, int xp, int yp, int *nb_addr,
                   int *px4, int *py4) {
  int mbx = addr % c->W, mby = addr / c->W;
  int na;
  if (xp < 0 && yp < 0) na = (mbx > 0 && mby > 0) ? addr - c->W - 1 : -1;
  else if (xp < 0) na = (mbx > 0 && yp < 16) ? addr - 1 : -1;
  else if (yp < 0) {
    if (xp < 16) na = mby > 0 ? addr - c->W : -1;
    else na = (mby > 0 && mbx < c->W - 1) ? addr - c->W + 1 : -1;
  } else if (xp < 16 && yp < 16) na = addr;
  else return 0;
  if (na < 0 || !mb_avail(c, na, addr)) return 0;
  *nb_addr = na;
  if (px4) {
    *px4 = 4 * (na % c->W) + ((xp & 15) >> 2);
    *py4 = 4 * (na / c->W) + ((yp & 15) >> 2);
  }
  return 1;
}

/* ---- MV derivation (decoder/mv.py duals) ---- */
static int nb_info(const rctx_t *c, int addr, int lst, int xp, int yp,
                   int *ref, int *mvx, int *mvy) {
  int na, px, py;
  if (!luma_nb(c, addr, xp, yp, &na, &px, &py)) return 0;
  long plane = (long)c->H4 * c->W4;
  *ref = c->ref_idx[lst * plane + (long)py * c->W4 + px];
  *mvx = c->mv[((lst * plane + (long)py * c->W4 + px) << 1)];
  *mvy = c->mv[((lst * plane + (long)py * c->W4 + px) << 1) + 1];
  return 1;
}

static void pmv_calc(const rctx_t *c, int addr, int lst, int ref,
                     int bx, int by, int w4, int h4, int *ox, int *oy) {
  int xp = bx << 2, yp = by << 2, wpix = w4 << 2;
  int ra = 0, ax = 0, ay = 0, rb = 0, bxv = 0, byv = 0, rc = 0, cx = 0,
      cy = 0;
  int aa = nb_info(c, addr, lst, xp - 1, yp, &ra, &ax, &ay);
  int ab = nb_info(c, addr, lst, xp, yp - 1, &rb, &bxv, &byv);
  int ac = nb_info(c, addr, lst, xp + wpix, yp - 1, &rc, &cx, &cy);
  if (yp > 0) {
    if (xp < 8) {
      if ((yp == 8 && wpix == 16) || (yp != 8 && xp + wpix == 8)) ac = 0;
    } else if (xp + wpix == 16) ac = 0;
  }
  if (!ac) ac = nb_info(c, addr, lst, xp - 1, yp - 1, &rc, &cx, &cy);

  if (w4 == 4 && h4 == 2) {  /* 16x8 */
    if (by == 0 && ab && rb == ref) { *ox = bxv; *oy = byv; return; }
    if (by == 2 && aa && ra == ref) { *ox = ax; *oy = ay; return; }
  } else if (w4 == 2 && h4 == 4) {  /* 8x16 */
    if (bx == 0 && aa && ra == ref) { *ox = ax; *oy = ay; return; }
    if (bx == 2 && ac && rc == ref) { *ox = cx; *oy = cy; return; }
  }
  int ma = aa && ra == ref, mb = ab && rb == ref, mc = ac && rc == ref;
  int n = ma + mb + mc;
  if (n == 1) {
    if (ma) { *ox = ax; *oy = ay; }
    else if (mb) { *ox = bxv; *oy = byv; }
    else { *ox = cx; *oy = cy; }
    return;
  }
  if (!ab && !ac && aa) { *ox = ax; *oy = ay; return; }
  if (!aa) { ax = 0; ay = 0; }
  if (!ab) { bxv = 0; byv = 0; }
  if (!ac) { cx = 0; cy = 0; }
  *ox = med3(ax, bxv, cx);
  *oy = med3(ay, byv, cy);
}

static void set_block(rctx_t *c, int lst, int x4, int y4, int bx, int by,
                      int w4, int h4, int ref, int mvx, int mvy,
                      int64_t rid) {
  long plane = (long)c->H4 * c->W4;
  for (int j = 0; j < h4; j++)
    for (int i = 0; i < w4; i++) {
      long o = lst * plane + (long)(y4 + by + j) * c->W4 + x4 + bx + i;
      c->ref_idx[o] = (int8_t)ref;
      c->mv[(o << 1)] = mvx;
      c->mv[(o << 1) + 1] = mvy;
      c->ref_pic_id[o] = rid;
    }
}

static void pskip_mv(rctx_t *c, int addr, int *ox, int *oy) {
  int ra, ax, ay, rb, bx, by;
  int aa = nb_info(c, addr, 0, -1, 0, &ra, &ax, &ay);
  int ab = nb_info(c, addr, 0, 0, -1, &rb, &bx, &by);
  if (!aa || !ab || (ra == 0 && ax == 0 && ay == 0)
      || (rb == 0 && bx == 0 && by == 0)) {
    *ox = 0; *oy = 0;
    return;
  }
  pmv_calc(c, addr, 0, 0, 0, 0, 4, 4, ox, oy);
}

static int spatial_ref_sel(rctx_t *c, int addr, int lst) {
  int r, mx, my, best = 1 << 29, found = 0;
  int av;
  av = nb_info(c, addr, lst, -1, 0, &r, &mx, &my);
  if (av && r >= 0 && r < best) { best = r; found = 1; }
  av = nb_info(c, addr, lst, 0, -1, &r, &mx, &my);
  if (av && r >= 0 && r < best) { best = r; found = 1; }
  av = nb_info(c, addr, lst, 16, -1, &r, &mx, &my);
  if (!av) av = nb_info(c, addr, lst, -1, -1, &r, &mx, &my);
  if (av && r >= 0 && r < best) { best = r; found = 1; }
  return found ? best : -1;
}

static void spatial_direct(rctx_t *c, int addr, int sid, int b8 /* -1=MB */) {
  int l0 = spatial_ref_sel(c, addr, 0);
  int l1 = spatial_ref_sel(c, addr, 1);
  int both_zero = (l0 < 0 && l1 < 0);
  int m0x = 0, m0y = 0, m1x = 0, m1y = 0;
  if (!both_zero) {
    if (l0 >= 0) pmv_calc(c, addr, 0, l0, 0, 0, 4, 4, &m0x, &m0y);
    if (l1 >= 0) pmv_calc(c, addr, 1, l1, 0, 0, 4, 4, &m1x, &m1y);
  }
  int x4 = 4 * (addr % c->W), y4 = 4 * (addr / c->W);
  const int64_t *ids0 = c->s_refids + ((long)sid * 2) * MAXREF;
  const int64_t *ids1 = c->s_refids + ((long)sid * 2 + 1) * MAXREF;
  int inference = c->s_d8x8[sid];
  int bx0 = 0, by0 = 0, bx1 = 4, by1 = 4;
  if (b8 >= 0) {
    bx0 = (b8 & 1) * 2; by0 = (b8 >> 1) * 2;
    bx1 = bx0 + 2; by1 = by0 + 2;
  }
  long mplane = (long)c->H4 * c->W4;
  for (int by = by0; by < by1; by++)
    for (int bx = bx0; bx < bx1; bx++) {
      int cxb, cyb;
      if (inference) {
        cxb = (bx & 2) + ((bx & 2) >> 1);
        cyb = (by & 2) + ((by & 2) >> 1);
      } else { cxb = bx; cyb = by; }
      int moving = 1;
      if (c->s_has_col[sid])
        moving = c->col_moving[(long)sid * mplane
                               + (long)(y4 + cyb) * c->W4 + x4 + cxb];
      int r0, r1, a0x, a0y, a1x, a1y;
      if (both_zero) {
        r0 = 0; r1 = 0; a0x = a0y = a1x = a1y = 0;
      } else {
        if (l0 >= 0) {
          r0 = l0;
          if (l0 == 0 && !moving) { a0x = 0; a0y = 0; }
          else { a0x = m0x; a0y = m0y; }
        } else { r0 = -1; a0x = 0; a0y = 0; }
        if (l1 >= 0) {
          r1 = l1;
          if (l1 == 0 && !moving) { a1x = 0; a1y = 0; }
          else { a1x = m1x; a1y = m1y; }
        } else { r1 = -1; a1x = 0; a1y = 0; }
      }
      set_block(c, 0, x4, y4, bx, by, 1, 1, r0, a0x, a0y,
                r0 >= 0 ? ids0[r0] : NONE_ID);
      set_block(c, 1, x4, y4, bx, by, 1, 1, r1, a1x, a1y,
                r1 >= 0 ? ids1[r1] : NONE_ID);
    }
}

static int cdiv(int a, int b) {
  return a / b;  /* C division truncates toward zero (mv.py _cdiv) */
}
static int dist_scale_factor(int cur, int p0, int p1) {
  int tb = iclip(cur - p0, -128, 127);
  int td = iclip(p1 - p0, -128, 127);
  int ad = cdiv(td, 2); if (ad < 0) ad = -ad;
  int tx = cdiv(16384 + ad, td);
  int v = (tb * tx + 32) >> 6;
  return iclip(v, -1024, 1023);
}

static int temporal_direct(rctx_t *c, int addr, int sid, int b8) {
  int x4 = 4 * (addr % c->W), y4 = 4 * (addr / c->W);
  const int64_t *ids0 = c->s_refids + ((long)sid * 2) * MAXREF;
  const int64_t *ids1 = c->s_refids + ((long)sid * 2 + 1) * MAXREF;
  const uint8_t *lt0 = c->s_reflt + ((long)sid * 2) * MAXREF;
  int n0 = c->s_nref[sid * 2];
  int cur_poc = c->s_curpoc[sid];
  int poc1 = c->s_colpoc[sid];
  int inference = c->s_d8x8[sid];
  long mplane = (long)c->H4 * c->W4;
  int bx0 = 0, by0 = 0, bx1 = 4, by1 = 4;
  if (b8 >= 0) {
    bx0 = (b8 & 1) * 2; by0 = (b8 >> 1) * 2;
    bx1 = bx0 + 2; by1 = by0 + 2;
  }
  for (int by = by0; by < by1; by++)
    for (int bx = bx0; bx < bx1; bx++) {
      int cxb, cyb;
      if (inference) {
        cxb = (bx & 2) + ((bx & 2) >> 1);
        cyb = (by & 2) + ((by & 2) >> 1);
      } else { cxb = bx; cyb = by; }
      long co = (long)sid * mplane + (long)(y4 + cyb) * c->W4 + x4 + cxb;
      int col_intra = 0;
      int64_t rid = 0;
      int mcx = 0, mcy = 0;
      if (c->col_ref0[co] >= 0) {
        rid = c->col_id0[co];
        mcx = c->col_mv0[co << 1]; mcy = c->col_mv0[(co << 1) + 1];
      } else if (c->col_ref1[co] >= 0) {
        rid = c->col_id1[co];
        mcx = c->col_mv1[co << 1]; mcy = c->col_mv1[(co << 1) + 1];
      } else col_intra = 1;
      int ref_l0 = 0, l0x = 0, l0y = 0, l1x = 0, l1y = 0;
      if (!col_intra) {
        int mapped = -1;
        for (int k = 0; k < n0; k++)
          if (ids0[k] == rid) { mapped = k; break; }
        if (mapped < 0) return -1;  /* unmappable: oracle handles */
        ref_l0 = mapped;
        int poc0 = (int)rid;
        if (lt0[mapped] || poc1 == poc0) {
          l0x = mcx; l0y = mcy; l1x = 0; l1y = 0;
        } else {
          int dsf = dist_scale_factor(cur_poc, poc0, poc1);
          l0x = (dsf * mcx + 128) >> 8;
          l0y = (dsf * mcy + 128) >> 8;
          l1x = l0x - mcx; l1y = l0y - mcy;
        }
      }
      set_block(c, 0, x4, y4, bx, by, 1, 1, ref_l0, l0x, l0y, ids0[ref_l0]);
      set_block(c, 1, x4, y4, bx, by, 1, 1, 0, l1x, l1y, ids1[0]);
    }
  return 0;
}

static int derive_mb(rctx_t *c, int addr) {
  int sid = c->slice_id[addr];
  if (sid < 0) return 0;
  int stype = c->s_type[sid];
  int mbt = c->mb_type[addr];
  if (c->is_intra[addr]) return 0;
  int x4 = 4 * (addr % c->W), y4 = 4 * (addr / c->W);
  long plane = (long)c->H4 * c->W4;
  const int64_t *ids;
  int bframe = stype == ST_B;
  if (bframe && mbt == 0) {  /* B skip / direct 16x16 */
    if (c->s_spatial[sid]) spatial_direct(c, addr, sid, -1);
    else if (temporal_direct(c, addr, sid, -1) < 0) return -1;
    return 0;
  }
  if (!bframe && mbt == PSKIP && c->skip_flag[addr]) {
    int mx, my;
    pskip_mv(c, addr, &mx, &my);
    ids = c->s_refids + ((long)sid * 2) * MAXREF;
    set_block(c, 0, x4, y4, 0, 0, 4, 4, 0, mx, my, ids[0]);
    return 0;
  }
  /* partitions */
  int parts[4][5], n_parts;
  if (mbt == P16x16) {
    n_parts = 1; int t[5] = {0,0,4,4,0}; memcpy(parts[0], t, sizeof t);
  } else if (mbt == P16x8) {
    n_parts = 2;
    int t0[5] = {0,0,4,2,0}, t1[5] = {0,2,4,2,2};
    memcpy(parts[0], t0, sizeof t0); memcpy(parts[1], t1, sizeof t1);
  } else if (mbt == P8x16) {
    n_parts = 2;
    int t0[5] = {0,0,2,4,0}, t1[5] = {2,0,2,4,1};
    memcpy(parts[0], t0, sizeof t0); memcpy(parts[1], t1, sizeof t1);
  } else {
    n_parts = 4;
    for (int b8 = 0; b8 < 4; b8++) {
      int t[5] = {(b8 & 1) * 2, (b8 >> 1) * 2, 2, 2, b8};
      memcpy(parts[b8], t, sizeof t);
    }
  }
  for (int lst = 0; lst < 2; lst++) {
    if (lst == 1 && !bframe) break;
    ids = c->s_refids + ((long)sid * 2 + lst) * MAXREF;
    for (int k = 0; k < n_parts; k++) {
      int bx = parts[k][0], by = parts[k][1], w4 = parts[k][2],
          h4 = parts[k][3], b8 = parts[k][4];
      int b8m = c->b8mode[addr * 4 + b8];
      int pdir = c->b8pdir[addr * 4 + b8];
      if (b8m == IBLOCK) continue;
      if (mbt == P8x8M && b8m == B8_DIRECT) {
        if (lst == 0) {
          if (c->s_spatial[sid]) spatial_direct(c, addr, sid, b8);
          else if (temporal_direct(c, addr, sid, b8) < 0) return -1;
        }
        continue;
      }
      if (pdir != lst && pdir != PD_BI) continue;
      int ref = c->ref_idx[lst * plane + (long)(y4 + by) * c->W4 + x4 + bx];
      int64_t rid = ids[ref];
      int sw = w4, sh = h4;
      if (mbt == P8x8M) {
        switch (b8m) {
          case B8_8x8: sw = 2; sh = 2; break;
          case B8_8x4: sw = 2; sh = 1; break;
          case B8_4x8: sw = 1; sh = 2; break;
          default:     sw = 1; sh = 1; break;
        }
        for (int dy = 0; dy < 2; dy += sh)
          for (int dx = 0; dx < 2; dx += sw) {
            int sx = bx + dx, sy = by + dy;
            int px, py;
            pmv_calc(c, addr, lst, ref, sx, sy, sw, sh, &px, &py);
            long o = (lst * plane + (long)(y4 + sy) * c->W4 + x4 + sx) << 1;
            set_block(c, lst, x4, y4, sx, sy, sw, sh, ref,
                      px + c->mvd[o], py + c->mvd[o + 1], rid);
          }
      } else {
        int px, py;
        pmv_calc(c, addr, lst, ref, bx, by, w4, h4, &px, &py);
        long o = (lst * plane + (long)(y4 + by) * c->W4 + x4 + bx) << 1;
        set_block(c, lst, x4, y4, bx, by, w4, h4, ref,
                  px + c->mvd[o], py + c->mvd[o + 1], rid);
      }
    }
  }
  return 0;
}

/* ---- luma quarter-pel MC (interp.py luma_block dual, per 4x4) ---- */
static void conv6h_row(const int32_t *p, int n, int32_t *out) {
  for (int i = 0; i < n; i++)
    out[i] = p[i-2] - 5*p[i-1] + 20*p[i] + 20*p[i+1] - 5*p[i+2] + p[i+3];
}
static void luma_mc4(const int32_t *P, int stride, int x0, int y0,
                     int dx, int dy, int32_t out[16]) {
  /* (x0, y0) already include padding */
  const int32_t *base = P + (long)y0 * stride + x0;
  if (dx == 0 && dy == 0) {
    for (int j = 0; j < 4; j++)
      for (int i = 0; i < 4; i++) out[j*4+i] = base[(long)j*stride + i];
    return;
  }
  int32_t full0[16], full1[16], bh[16], hv[16], cj[16];
  int need_b = 0, need_h = 0, need_j = 0;
  int bddx = 0, bddy = 0, hddx = 0, hddy = 0;
  if (dy == 0) { need_b = 1; }
  else if (dx == 0) { need_h = 1; }
  else if (dx == 2 && dy == 2) { need_j = 1; }
  else if (dx == 2) { need_j = 1; need_b = 1; bddy = (dy == 3); }
  else if (dy == 2) { need_j = 1; need_h = 1; hddx = (dx == 3); }
  else { need_b = 1; need_h = 1; bddy = (dy == 3); hddx = (dx == 3); }
  if (need_b) {
    for (int j = 0; j < 4; j++) {
      const int32_t *row = base + (long)(j + bddy) * stride;
      for (int i = 0; i < 4; i++) {
        int v = row[i-2] - 5*row[i-1] + 20*row[i] + 20*row[i+1]
                - 5*row[i+2] + row[i+3];
        bh[j*4+i] = iclip((v + 16) >> 5, 0, 255);
      }
    }
  }
  if (need_h) {
    for (int j = 0; j < 4; j++)
      for (int i = 0; i < 4; i++) {
        const int32_t *col = base + (long)j * stride + i + hddx;
        int v = col[-2*stride] - 5*col[-stride] + 20*col[0]
                + 20*col[stride] - 5*col[2*stride] + col[3*stride];
        hv[j*4+i] = iclip((v + 16) >> 5, 0, 255);
      }
  }
  if (need_j) {
    int32_t b1[9 * 4];  /* horizontal 6-tap rows y0-2 .. y0+6 */
    for (int j = -2; j <= 6; j++) {
      const int32_t *row = base + (long)j * stride;
      for (int i = 0; i < 4; i++)
        b1[(j+2)*4+i] = row[i-2] - 5*row[i-1] + 20*row[i] + 20*row[i+1]
                        - 5*row[i+2] + row[i+3];
    }
    for (int j = 0; j < 4; j++)
      for (int i = 0; i < 4; i++) {
        int64_t v = (int64_t)b1[j*4+i] - 5*b1[(j+1)*4+i] + 20*b1[(j+2)*4+i]
                    + 20*b1[(j+3)*4+i] - 5*b1[(j+4)*4+i] + b1[(j+5)*4+i];
        cj[j*4+i] = iclip((int)((v + 512) >> 10), 0, 255);
      }
  }
  if (dy == 0) {  /* a, b, c */
    if (dx == 2) { memcpy(out, bh, sizeof bh); return; }
    int off = (dx == 3);
    for (int j = 0; j < 4; j++)
      for (int i = 0; i < 4; i++)
        out[j*4+i] = (base[(long)j*stride + i + off] + bh[j*4+i] + 1) >> 1;
    return;
  }
  if (dx == 0) {  /* d, h, n */
    if (dy == 2) { memcpy(out, hv, sizeof hv); return; }
    int off = (dy == 3);
    for (int j = 0; j < 4; j++)
      for (int i = 0; i < 4; i++)
        out[j*4+i] = (base[(long)(j + off)*stride + i] + hv[j*4+i] + 1) >> 1;
    return;
  }
  if (dx == 2 && dy == 2) { memcpy(out, cj, sizeof cj); return; }
  if (dx == 2) {  /* f / q: avg(b-or-s, j) */
    for (int k = 0; k < 16; k++) out[k] = (bh[k] + cj[k] + 1) >> 1;
    return;
  }
  if (dy == 2) {  /* i / k: avg(h-or-m, j) */
    for (int k = 0; k < 16; k++) out[k] = (hv[k] + cj[k] + 1) >> 1;
    return;
  }
  for (int k = 0; k < 16; k++) out[k] = (bh[k] + hv[k] + 1) >> 1;
}

/* ---- residual helpers ---- */

/* add scaled residual to pred, clip (recon.py _add_residual) */
static inline int add_res(int64_t res, int pred) {
  return iclip((int)rshift_rnd_sf64(res + ((int64_t)pred << 6), 6), 0, 255);
}

/* 4x4 dequant + itrans + add into dst (stride), list_idx selects ws4 */
static void resid4(const rctx_t *c, const int32_t *lev, int qp, int list_idx,
                   const int *pred /*16*/, int32_t *dst, int stride) {
  int per = qp / 6, rem = qp % 6;
  int ils[16];
  ils4(c, list_idx, rem, ils);
  int any = 0;
  for (int k = 0; k < 16; k++) any |= lev[k];
  if (!any) {
    for (int j = 0; j < 4; j++)
      for (int i = 0; i < 4; i++)
        dst[(long)j * stride + i] = iclip(pred[j*4+i], 0, 255);
    return;
  }
  int64_t coef[16], res[16];
  for (int k = 0; k < 16; k++)
    coef[k] = rshift_rnd_sf64(((int64_t)lev[k] * ils[k]) << per, 4);
  inv4x4(coef, res);
  for (int j = 0; j < 4; j++)
    for (int i = 0; i < 4; i++)
      dst[(long)j * stride + i] = add_res(res[j*4+i], pred[j*4+i]);
}

/* I16 / chroma variants need an externally-set DC coefficient */
static void resid4_dc(const rctx_t *c, const int32_t *lev, int64_t dc,
                      int qp, int list_idx, const int *pred, int32_t *dst,
                      int stride) {
  int per = qp / 6, rem = qp % 6;
  int ils[16];
  ils4(c, list_idx, rem, ils);
  int64_t coef[16], res[16];
  for (int k = 0; k < 16; k++)
    coef[k] = rshift_rnd_sf64(((int64_t)lev[k] * ils[k]) << per, 4);
  coef[0] = dc;
  int any = 0;
  for (int k = 0; k < 16; k++) any |= (coef[k] != 0);
  if (!any) {
    for (int j = 0; j < 4; j++)
      for (int i = 0; i < 4; i++)
        dst[(long)j * stride + i] = iclip(pred[j*4+i], 0, 255);
    return;
  }
  inv4x4(coef, res);
  for (int j = 0; j < 4; j++)
    for (int i = 0; i < 4; i++)
      dst[(long)j * stride + i] = add_res(res[j*4+i], pred[j*4+i]);
}

static void resid8(const rctx_t *c, const int32_t *lev, int qp, int list_idx,
                   const int *pred /*64*/, int32_t *dst, int stride) {
  int per = qp / 6, rem = qp % 6;
  int ils[64];
  ils8(c, list_idx, rem, ils);
  int any = 0;
  for (int k = 0; k < 64; k++) any |= lev[k];
  if (!any) {
    for (int j = 0; j < 8; j++)
      for (int i = 0; i < 8; i++)
        dst[(long)j * stride + i] = iclip(pred[j*8+i], 0, 255);
    return;
  }
  int64_t coef[64], res[64];
  for (int k = 0; k < 64; k++)
    coef[k] = rshift_rnd_sf64(((int64_t)lev[k] * ils[k]) << per, 6);
  inv8x8(coef, res);
  for (int j = 0; j < 8; j++)
    for (int i = 0; i < 8; i++)
      dst[(long)j * stride + i] = add_res(res[j*8+i], pred[j*8+i]);
}

/* chroma 8x8 residual of one component onto pred[64] (recon.py
 * _chroma_residual / _chroma_residual_inter; ws list idx passed in) */
static void chroma_resid(const rctx_t *c, int addr, int uv, int list_idx,
                         const int *pred /*64*/, int32_t *plane,
                         int cx, int cy) {
  int qpc = c->qpc[addr * 2 + uv];
  int per = qpc / 6, rem = qpc % 6;
  int ils[16];
  ils4(c, list_idx, rem, ils);
  /* DC: 2x2 hadamard then truncating dequant (quant.py dequant_chroma_dc) */
  const int32_t *dcl = c->chroma_dc + ((long)addr * 2 + uv) * 4;
  int64_t a = dcl[0], b = dcl[1], d = dcl[2], e = dcl[3];
  int64_t had[4] = {a + b + d + e, a - b + d - e, a + b - d - e,
                    a - b - d + e};
  int64_t dc[4];
  for (int k = 0; k < 4; k++) {
    int64_t t = had[k] * ils[0];
    dc[k] = per < 5 ? (t >> (5 - per)) : (t << (per - 5));
  }
  for (int blk = 0; blk < 4; blk++) {
    int bx = blk & 1, by = blk >> 1;
    const int32_t *lev =
        c->chroma_levels + (((long)addr * 2 + uv) * 4 + blk) * 16;
    int pblk[16];
    for (int j = 0; j < 4; j++)
      for (int i = 0; i < 4; i++)
        pblk[j*4+i] = pred[(by*4+j)*8 + bx*4+i];
    resid4_dc(c, lev, dc[blk], qpc, list_idx, pblk,
              plane + (long)(cy + by*4) * c->cw + cx + bx*4, c->cw);
  }
}

/* ---- intra prediction (ops/intra.py duals) ---- */

static int avail_intra(const rctx_t *c, int avail, int nb) {
  if (!avail) return 0;
  if (c->cip) return c->is_intra[nb];
  return 1;
}

static void pred4x4_c(int mode, const int *up, const int *ur, const int *lf,
                      int X, int au, int al, int aul, int aur, int p[16]) {
  int A, B, Cc, D, E, F, G, Hh, I, J, K, L;
  if (au) { A = up[0]; B = up[1]; Cc = up[2]; D = up[3]; }
  else A = B = Cc = D = 128;
  if (aur) { E = ur[0]; F = ur[1]; G = ur[2]; Hh = ur[3]; }
  else E = F = G = Hh = D;
  if (al) { I = lf[0]; J = lf[1]; K = lf[2]; L = lf[3]; }
  else I = J = K = L = 128;
  int Xv = aul ? X : 128;
  switch (mode) {
    case 0:  /* vertical */
      for (int j = 0; j < 4; j++) {
        p[j*4] = A; p[j*4+1] = B; p[j*4+2] = Cc; p[j*4+3] = D;
      }
      break;
    case 1:  /* horizontal */
      for (int j = 0; j < 4; j++) {
        int v = j == 0 ? I : (j == 1 ? J : (j == 2 ? K : L));
        p[j*4] = p[j*4+1] = p[j*4+2] = p[j*4+3] = v;
      }
      break;
    case 2: {  /* DC */
      int s;
      if (au && al) s = (A + B + Cc + D + I + J + K + L + 4) >> 3;
      else if (al) s = (I + J + K + L + 2) >> 2;
      else if (au) s = (A + B + Cc + D + 2) >> 2;
      else s = 128;
      for (int k = 0; k < 16; k++) p[k] = s;
      break;
    }
    case 3: {  /* diag down-left */
      int d0 = (A + Cc + 2*B + 2) >> 2, d1 = (B + D + 2*Cc + 2) >> 2;
      int d2 = (Cc + E + 2*D + 2) >> 2, d3 = (D + F + 2*E + 2) >> 2;
      int d4 = (E + G + 2*F + 2) >> 2, d5 = (F + Hh + 2*G + 2) >> 2;
      int d6 = (G + 3*Hh + 2) >> 2;
      int dd[7] = {d0, d1, d2, d3, d4, d5, d6};
      for (int j = 0; j < 4; j++)
        for (int i = 0; i < 4; i++) p[j*4+i] = dd[i + j];
      break;
    }
    case 4: {  /* diag down-right */
      int r0 = (L + 2*K + J + 2) >> 2, r1 = (K + 2*J + I + 2) >> 2;
      int r2 = (J + 2*I + Xv + 2) >> 2, r3 = (I + 2*Xv + A + 2) >> 2;
      int r4 = (Xv + 2*A + B + 2) >> 2, r5 = (A + 2*B + Cc + 2) >> 2;
      int r6 = (B + 2*Cc + D + 2) >> 2;
      int rr[7] = {r0, r1, r2, r3, r4, r5, r6};
      for (int j = 0; j < 4; j++)
        for (int i = 0; i < 4; i++) p[j*4+i] = rr[3 - j + i];
      break;
    }
    case 5: {  /* vertical-right */
      p[0]  = (Xv + A + 1) >> 1;  p[1]  = (A + B + 1) >> 1;
      p[2]  = (B + Cc + 1) >> 1;  p[3]  = (Cc + D + 1) >> 1;
      p[4]  = (I + 2*Xv + A + 2) >> 2; p[5] = (Xv + 2*A + B + 2) >> 2;
      p[6]  = (A + 2*B + Cc + 2) >> 2; p[7] = (B + 2*Cc + D + 2) >> 2;
      p[8]  = (Xv + 2*I + J + 2) >> 2; p[9] = p[0]; p[10] = p[1];
      p[11] = p[2];
      p[12] = (I + 2*J + K + 2) >> 2; p[13] = p[4]; p[14] = p[5];
      p[15] = p[6];
      break;
    }
    case 6: {  /* horizontal-down */
      p[0]  = (Xv + I + 1) >> 1;  p[1] = (I + 2*Xv + A + 2) >> 2;
      p[2]  = (Xv + 2*A + B + 2) >> 2; p[3] = (A + 2*B + Cc + 2) >> 2;
      p[4]  = (I + J + 1) >> 1;   p[5] = (Xv + 2*I + J + 2) >> 2;
      p[6]  = p[0]; p[7] = p[1];
      p[8]  = (J + K + 1) >> 1;   p[9] = (I + 2*J + K + 2) >> 2;
      p[10] = p[4]; p[11] = p[5];
      p[12] = (K + L + 1) >> 1;   p[13] = (J + 2*K + L + 2) >> 2;
      p[14] = p[8]; p[15] = p[9];
      break;
    }
    case 7: {  /* vertical-left */
      p[0]  = (A + B + 1) >> 1;   p[1] = (B + Cc + 1) >> 1;
      p[2]  = (Cc + D + 1) >> 1;  p[3] = (D + E + 1) >> 1;
      p[4]  = (A + 2*B + Cc + 2) >> 2; p[5] = (B + 2*Cc + D + 2) >> 2;
      p[6]  = (Cc + 2*D + E + 2) >> 2; p[7] = (D + 2*E + F + 2) >> 2;
      p[8]  = p[1]; p[9] = p[2]; p[10] = p[3];
      p[11] = (E + F + 1) >> 1;
      p[12] = p[5]; p[13] = p[6]; p[14] = p[7];
      p[15] = (E + 2*F + G + 2) >> 2;
      break;
    }
    default: {  /* 8: horizontal-up */
      p[0]  = (I + J + 1) >> 1;   p[1] = (I + 2*J + K + 2) >> 2;
      p[2]  = (J + K + 1) >> 1;   p[3] = (J + 2*K + L + 2) >> 2;
      p[4]  = p[2]; p[5] = p[3];
      p[6]  = (K + L + 1) >> 1;   p[7] = (K + 3*L + 2) >> 2;
      p[8]  = p[6]; p[9] = p[7]; p[10] = L; p[11] = L;
      p[12] = L; p[13] = L; p[14] = L; p[15] = L;
      break;
    }
  }
}

/* intra 8x8 reference filtering + prediction (ops/intra.py
 * filter_ref_8x8 / pred8x8) */
static void pred8x8_c(int mode, const int *up8, const int *ur8,
                      const int *lf8, int X, int au, int al, int aul,
                      int aur, int p[64]) {
  int64_t P[17], L[9], Pf[17], Lf[9];
  for (int i = 0; i < 8; i++) P[1 + i] = au ? up8[i] : 128;
  for (int i = 0; i < 8; i++) P[9 + i] = aur ? ur8[i] : P[8];
  P[0] = aul ? X : 128;
  for (int i = 0; i < 8; i++) L[1 + i] = al ? lf8[i] : 128;
  L[0] = P[0];
  memcpy(Pf, P, sizeof P);
  memcpy(Lf, L, sizeof L);
  if (au) {
    Pf[1] = aul ? (P[0] + 2*P[1] + P[2] + 2) >> 2
                : (3*P[1] + P[2] + 2) >> 2;
    for (int i = 2; i < 16; i++) Pf[i] = (P[i-1] + 2*P[i] + P[i+1] + 2) >> 2;
    Pf[16] = (P[15] + 3*P[16] + 2) >> 2;
  }
  if (aul) {
    if (au && al) Pf[0] = (P[1] + 2*P[0] + L[1] + 2) >> 2;
    else if (au) Pf[0] = (3*P[0] + P[1] + 2) >> 2;
    else if (al) Pf[0] = (3*P[0] + L[1] + 2) >> 2;
    Lf[0] = Pf[0];
  }
  if (al) {
    Lf[1] = aul ? (L[0] + 2*L[1] + L[2] + 2) >> 2
                : (3*L[1] + L[2] + 2) >> 2;
    for (int i = 2; i < 8; i++) Lf[i] = (L[i-1] + 2*L[i] + L[i+1] + 2) >> 2;
    Lf[8] = (L[7] + 3*L[8] + 2) >> 2;
  }
  const int64_t *up = Pf + 1;  /* up[0..15] */
  const int64_t *left = Lf + 1;
  int64_t Xf = Pf[0];
  switch (mode) {
    case 2: {
      int64_t s;
      if (au && al) {
        int64_t t = 0;
        for (int i = 0; i < 8; i++) t += up[i] + left[i];
        s = (t + 8) >> 4;
      } else if (al) {
        int64_t t = 0;
        for (int i = 0; i < 8; i++) t += left[i];
        s = (t + 4) >> 3;
      } else if (au) {
        int64_t t = 0;
        for (int i = 0; i < 8; i++) t += up[i];
        s = (t + 4) >> 3;
      } else s = 128;
      for (int k = 0; k < 64; k++) p[k] = (int)s;
      break;
    }
    case 0:
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) p[y*8+x] = (int)up[x];
      break;
    case 1:
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) p[y*8+x] = (int)left[y];
      break;
    case 3:
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) {
          if (x == 7 && y == 7)
            p[y*8+x] = (int)((up[14] + 3*up[15] + 2) >> 2);
          else {
            int k = x + y;
            p[y*8+x] = (int)((up[k] + 2*up[k+1] + up[k+2] + 2) >> 2);
          }
        }
      break;
    case 4:
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) {
          if (x > y) {
            int k = x - y;
            int64_t a = k >= 2 ? up[k-2] : Xf;
            int64_t b = k >= 1 ? up[k-1] : Xf;
            p[y*8+x] = (int)((a + 2*b + up[k] + 2) >> 2);
          } else if (x < y) {
            int k = y - x;
            int64_t a = k >= 2 ? left[k-2] : Xf;
            int64_t b = k >= 1 ? left[k-1] : Xf;
            p[y*8+x] = (int)((a + 2*b + left[k] + 2) >> 2);
          } else
            p[y*8+x] = (int)((up[0] + 2*Xf + left[0] + 2) >> 2);
        }
      break;
    case 5: {
      int64_t uq[17], lq[9];
      uq[0] = Xf; memcpy(uq + 1, up, 16 * sizeof(int64_t));
      lq[0] = Xf; memcpy(lq + 1, left, 8 * sizeof(int64_t));
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) {
          int z = 2 * x - y;
          if (z >= 0 && z % 2 == 0) {
            int k = x - (y >> 1);
            p[y*8+x] = (int)((uq[k] + uq[k+1] + 1) >> 1);
          } else if (z >= 0) {
            int k = x - (y >> 1);
            p[y*8+x] = (int)((uq[k-1] + 2*uq[k] + uq[k+1] + 2) >> 2);
          } else if (z == -1)
            p[y*8+x] = (int)((left[0] + 2*Xf + up[0] + 2) >> 2);
          else {
            int n = y - 2 * x;
            p[y*8+x] = (int)((lq[n] + 2*lq[n-1] + lq[n-2] + 2) >> 2);
          }
        }
      break;
    }
    case 6: {
      int64_t uq[17], lq[9];
      uq[0] = Xf; memcpy(uq + 1, up, 16 * sizeof(int64_t));
      lq[0] = Xf; memcpy(lq + 1, left, 8 * sizeof(int64_t));
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) {
          int z = 2 * y - x;
          if (z >= 0 && z % 2 == 0) {
            int k = y - (x >> 1);
            p[y*8+x] = (int)((lq[k] + lq[k+1] + 1) >> 1);
          } else if (z >= 0) {
            int k = y - (x >> 1);
            p[y*8+x] = (int)((lq[k-1] + 2*lq[k] + lq[k+1] + 2) >> 2);
          } else if (z == -1)
            p[y*8+x] = (int)((up[0] + 2*Xf + left[0] + 2) >> 2);
          else {
            int n = x - 2 * y;
            p[y*8+x] = (int)((uq[n] + 2*uq[n-1] + uq[n-2] + 2) >> 2);
          }
        }
      break;
    }
    case 7:
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) {
          int k = x + (y >> 1);
          if (y % 2 == 0)
            p[y*8+x] = (int)((up[k] + up[k+1] + 1) >> 1);
          else
            p[y*8+x] = (int)((up[k] + 2*up[k+1] + up[k+2] + 2) >> 2);
        }
      break;
    default:  /* 8 */
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) {
          int z = x + 2 * y;
          if (z > 13) p[y*8+x] = (int)left[7];
          else if (z == 13)
            p[y*8+x] = (int)((left[6] + 3*left[7] + 2) >> 2);
          else if (z % 2 == 0) {
            int k = y + (x >> 1);
            p[y*8+x] = (int)((left[k] + left[k+1] + 1) >> 1);
          } else {
            int k = y + (x >> 1);
            p[y*8+x] = (int)((left[k] + 2*left[k+1] + left[k+2] + 2) >> 2);
          }
        }
      break;
  }
}

/* ---- per-MB reconstruction ---- */
static int recon_one_mb(rctx_t *c, int addr) {
  int W = c->W;
  int mx = (addr % W) * 16, my = (addr / W) * 16;
  int cx = (addr % W) * 8, cy = (addr / W) * 8;
  int x4 = 4 * (addr % W), y4 = 4 * (addr / W);
  int mbt = c->mb_type[addr];
  int qp = c->qp[addr];
  int width = c->width, cw = c->cw;
  int32_t *Y = c->Y;
  long plane4 = (long)c->H4 * c->W4;

  if (mbt == IPCM) return -1;  /* oracle handles IPCM pictures */

  if (c->is_intra[addr]) {
    int up_mb = -1, left_mb = -1, ul_mb = -1;
    int au0 = (addr / W > 0) && mb_avail(c, addr - W, addr);
    int al0 = (addr % W > 0) && mb_avail(c, addr - 1, addr);
    if (au0) up_mb = addr - W;
    if (al0) left_mb = addr - 1;
    int aul0 = luma_nb(c, addr, -1, -1, &ul_mb, NULL, NULL);

    if (mbt == I4MB) {
      for (int blk = 0; blk < 16; blk++) {
        int bx = BLK4_X[blk], by = BLK4_Y[blk];
        int ioff = bx * 4, joff = by * 4;
        int px = mx + ioff, py = my + joff;
        int mode = c->ipredmode[(long)(y4 + by) * c->W4 + x4 + bx];
        int lmb, umb, urmb, ulmb;
        int la = luma_nb(c, addr, ioff - 1, joff, &lmb, NULL, NULL);
        int ua = luma_nb(c, addr, ioff, joff - 1, &umb, NULL, NULL);
        int ura = luma_nb(c, addr, ioff + 4, joff - 1, &urmb, NULL, NULL);
        int ula = luma_nb(c, addr, ioff - 1, joff - 1, &ulmb, NULL, NULL);
        if (ioff == 4 && (joff == 4 || joff == 12)) ura = 0;
        la = avail_intra(c, la, lmb);
        ua = avail_intra(c, ua, umb);
        ura = avail_intra(c, ura, urmb);
        ula = avail_intra(c, ula, ulmb);
        int up[4] = {0,0,0,0}, ur[4] = {0,0,0,0}, lf[4] = {0,0,0,0}, X = 0;
        if (ua)
          for (int i = 0; i < 4; i++) up[i] = Y[(long)(py-1)*width + px + i];
        if (ura)
          for (int i = 0; i < 4; i++)
            ur[i] = Y[(long)(py-1)*width + px + 4 + i];
        if (la)
          for (int i = 0; i < 4; i++) lf[i] = Y[(long)(py+i)*width + px - 1];
        if (ula) X = Y[(long)(py-1)*width + px - 1];
        int pred[16];
        pred4x4_c(mode, up, ur, lf, X, ua, la, ula, ura, pred);
        const int32_t *lev = c->luma_levels + ((long)addr * 16 + blk) * 16;
        resid4(c, lev, qp, 0, pred, Y + (long)py * width + px, width);
      }
    } else if (mbt == I8MB) {
      for (int b8 = 0; b8 < 4; b8++) {
        int ioff = (b8 & 1) * 8, joff = (b8 >> 1) * 8;
        int px = mx + ioff, py = my + joff;
        int mode = c->ipredmode[(long)(y4 + (b8 >> 1) * 2) * c->W4
                                + x4 + (b8 & 1) * 2];
        int lmb, umb, urmb, ulmb;
        int la = luma_nb(c, addr, ioff - 1, joff, &lmb, NULL, NULL);
        int ua = luma_nb(c, addr, ioff, joff - 1, &umb, NULL, NULL);
        int ura = luma_nb(c, addr, ioff + 8, joff - 1, &urmb, NULL, NULL);
        int ula = luma_nb(c, addr, ioff - 1, joff - 1, &ulmb, NULL, NULL);
        if (ioff == 8 && joff == 8) ura = 0;
        la = avail_intra(c, la, lmb);
        ua = avail_intra(c, ua, umb);
        ura = avail_intra(c, ura, urmb);
        ula = avail_intra(c, ula, ulmb);
        int up8[8] = {0}, ur8[8] = {0}, lf8[8] = {0}, X = 0;
        if (ua)
          for (int i = 0; i < 8; i++) up8[i] = Y[(long)(py-1)*width + px + i];
        if (ura) {
          int navail = width - (px + 8);  /* edge: pad with last sample */
          if (navail > 8) navail = 8;
          for (int i = 0; i < 8; i++) {
            int xx = px + 8 + (i < navail ? i : navail - 1);
            ur8[i] = Y[(long)(py-1)*width + xx];
          }
        }
        if (la)
          for (int i = 0; i < 8; i++) lf8[i] = Y[(long)(py+i)*width + px - 1];
        if (ula) X = Y[(long)(py-1)*width + px - 1];
        int pred[64];
        pred8x8_c(mode, up8, ur8, lf8, X, ua, la, ula, ura, pred);
        const int32_t *lev = c->luma8_levels + ((long)addr * 4 + b8) * 64;
        resid8(c, lev, qp, 0, pred, Y + (long)py * width + px, width);
      }
    } else {  /* I16MB */
      int au = avail_intra(c, au0, up_mb);
      int al = avail_intra(c, al0, left_mb);
      int aul = avail_intra(c, aul0, ul_mb);
      int64_t up[16], lf[16], X = 0;
      for (int i = 0; i < 16; i++) {
        up[i] = au ? Y[(long)(my-1)*width + mx + i] : 0;
        lf[i] = al ? Y[(long)(my+i)*width + mx - 1] : 0;
      }
      if (aul) X = Y[(long)(my-1)*width + mx - 1];
      int mode = c->i16mode[addr];
      int pred[256];
      if (mode == 2) {
        int64_t s;
        if (au && al) {
          int64_t t = 0;
          for (int i = 0; i < 16; i++) t += up[i] + lf[i];
          s = (t + 16) >> 5;
        } else if (al) {
          int64_t t = 0;
          for (int i = 0; i < 16; i++) t += lf[i];
          s = (t + 8) >> 4;
        } else if (au) {
          int64_t t = 0;
          for (int i = 0; i < 16; i++) t += up[i];
          s = (t + 8) >> 4;
        } else s = 128;
        for (int k = 0; k < 256; k++) pred[k] = (int)s;
      } else if (mode == 0) {
        for (int y = 0; y < 16; y++)
          for (int x = 0; x < 16; x++) pred[y*16+x] = (int)up[x];
      } else if (mode == 1) {
        for (int y = 0; y < 16; y++)
          for (int x = 0; x < 16; x++) pred[y*16+x] = (int)lf[y];
      } else {  /* plane */
        int64_t Hs = 0, Vs = 0;
        for (int i = 0; i < 8; i++) {
          int64_t bsamp = (6 - i) >= 0 ? up[6 - i] : X;
          Hs += (i + 1) * (up[8 + i] - bsamp);
          int64_t bs2 = (6 - i) >= 0 ? lf[6 - i] : X;
          Vs += (i + 1) * (lf[8 + i] - bs2);
        }
        int64_t a = 16 * (lf[15] + up[15]);
        int64_t b = (5 * Hs + 32) >> 6;
        int64_t cc = (5 * Vs + 32) >> 6;
        for (int y = 0; y < 16; y++)
          for (int x = 0; x < 16; x++) {
            int64_t v = (a + b * (x - 7) + cc * (y - 7) + 16) >> 5;
            pred[y*16+x] = iclip((int)v, 0, 255);
          }
      }
      /* DC path: hadamard of DC levels, then dequant (rshift_rnd 6) */
      int64_t dcl[16], dch[16];
      for (int k = 0; k < 16; k++) dcl[k] = c->luma_dc[(long)addr*16 + k];
      had4x4(dcl, dch);
      int per = qp / 6, rem = qp % 6;
      int ilst[16];
      ils4(c, 0, rem, ilst);
      int64_t dc[16];
      for (int k = 0; k < 16; k++)
        dc[k] = rshift_rnd_sf64((dch[k] * ilst[0]) << per, 6);
      for (int blk = 0; blk < 16; blk++) {
        int bx = BLK4_X[blk], by = BLK4_Y[blk];
        const int32_t *lev = c->luma_levels + ((long)addr * 16 + blk) * 16;
        int pblk[16];
        for (int j = 0; j < 4; j++)
          for (int i = 0; i < 4; i++)
            pblk[j*4+i] = pred[(by*4+j)*16 + bx*4+i];
        resid4_dc(c, lev, dc[by*4+bx], qp, 0, pblk,
                  Y + (long)(my + by*4) * width + mx + bx*4, width);
      }
    }
    /* chroma intra */
    {
      int au = avail_intra(c, au0, up_mb);
      int al = avail_intra(c, al0, left_mb);
      int mode = c->c_ipred_mode[addr];
      for (int uv = 0; uv < 2; uv++) {
        int32_t *Pl = uv ? c->V : c->U;
        int64_t up[8], lf[8], X = 0;
        for (int i = 0; i < 8; i++) {
          up[i] = au ? Pl[(long)(cy-1)*cw + cx + i] : 0;
          lf[i] = al ? Pl[(long)(cy+i)*cw + cx - 1] : 0;
        }
        if (au && al && aul0) X = Pl[(long)(cy-1)*cw + cx - 1];
        int pred[64];
        if (mode == 0) {  /* DC per quadrant */
          for (int by = 0; by < 8; by += 4)
            for (int bx = 0; bx < 8; bx += 4) {
              int64_t us = up[bx] + up[bx+1] + up[bx+2] + up[bx+3];
              int64_t ls = lf[by] + lf[by+1] + lf[by+2] + lf[by+3];
              int64_t s = 128;
              int tl = (bx == 0 && by == 0), br = (bx == 4 && by == 4);
              if (tl || br) {
                if (au && al) s = (us + ls + 4) >> 3;
                else if (au) s = (us + 2) >> 2;
                else if (al) s = (ls + 2) >> 2;
              } else if (by == 0) {  /* top right */
                if (au) s = (us + 2) >> 2;
                else if (al) s = (ls + 2) >> 2;
              } else {               /* bottom left */
                if (al) s = (ls + 2) >> 2;
                else if (au) s = (us + 2) >> 2;
              }
              for (int j = 0; j < 4; j++)
                for (int i = 0; i < 4; i++)
                  pred[(by+j)*8 + bx+i] = (int)s;
            }
        } else if (mode == 1) {
          for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) pred[y*8+x] = (int)lf[y];
        } else if (mode == 2) {
          for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) pred[y*8+x] = (int)up[x];
        } else {  /* plane */
          int64_t Hs = 0, Vs = 0;
          for (int x = 0; x < 4; x++) {
            int64_t b = (2 - x) >= 0 ? up[2 - x] : X;
            Hs += (x + 1) * (up[4 + x] - b);
          }
          for (int y = 0; y < 4; y++) {
            int64_t b = (2 - y) >= 0 ? lf[2 - y] : X;
            Vs += (y + 1) * (lf[4 + y] - b);
          }
          int64_t a0 = 16 * (lf[7] + up[7]);
          int64_t b0 = (34 * Hs + 32) >> 6;
          int64_t c0 = (34 * Vs + 32) >> 6;
          for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) {
              int64_t v = (a0 + b0 * (x - 3) + c0 * (y - 3) + 16) >> 5;
              pred[y*8+x] = iclip((int)v, 0, 255);
            }
        }
        chroma_resid(c, addr, uv, 1 + uv, pred, Pl, cx, cy);
      }
    }
    return 0;
  }

  /* ---- inter MB ---- */
  int sid = c->slice_id[addr];
  int pred_y[256], pred_u[64], pred_v[64];
  int wpm = c->wp_mode[sid];
  int ly = c->wp_ly[sid], lc = c->wp_lc[sid];
  for (int by = 0; by < 4; by++)
    for (int bx = 0; bx < 4; bx++) {
      int px = mx + bx * 4, py = my + by * 4;
      int32_t py0[2][16], pu0[2][4], pv0[2][4];
      int used_lst[2], used_ref[2], n_used = 0;
      for (int lst = 0; lst < 2; lst++) {
        long o = lst * plane4 + (long)(y4 + by) * c->W4 + x4 + bx;
        int ref = c->ref_idx[o];
        if (ref < 0) continue;
        int mvx = c->mv[o << 1], mvy = c->mv[(o << 1) + 1];
        const int32_t *Yp = c->refY[((long)sid * 2 + lst) * MAXREF + ref];
        const int32_t *Up = c->refU[((long)sid * 2 + lst) * MAXREF + ref];
        const int32_t *Vp = c->refV[((long)sid * 2 + lst) * MAXREF + ref];
        int stride = width + 2 * c->pad;
        int cstride = cw + 2 * c->pad;
        int xi = px + (mvx >> 2), yi = py + (mvy >> 2);
        int dx = mvx & 3, dy = mvy & 3;
        xi = imax(-(c->pad - 8), imin(width + c->pad - 12, xi));
        yi = imax(-(c->pad - 8), imin(c->height + c->pad - 12, yi));
        luma_mc4(Yp, stride, xi + c->pad, yi + c->pad, dx, dy,
                 py0[n_used]);
        int cvy = mvy + c->cadj[((long)sid * 2 + lst) * MAXREF + ref];
        int cxi = (px >> 1) + (mvx >> 3), cyi = (py >> 1) + (cvy >> 3);
        int fx = mvx & 7, fy = cvy & 7;
        cxi = imax(-(c->pad - 4), imin(cw + c->pad - 8, cxi));
        cyi = imax(-(c->pad - 4), imin(c->ch + c->pad - 8, cyi));
        for (int j = 0; j < 2; j++)
          for (int i = 0; i < 2; i++) {
            long co = (long)(cyi + c->pad + j) * cstride + cxi + c->pad + i;
            int A = Up[co], B = Up[co + 1], Cc = Up[co + cstride],
                D = Up[co + cstride + 1];
            pu0[n_used][j*2+i] =
                ((8-fx)*(8-fy)*A + fx*(8-fy)*B + (8-fx)*fy*Cc
                 + fx*fy*D + 32) >> 6;
            A = Vp[co]; B = Vp[co + 1]; Cc = Vp[co + cstride];
            D = Vp[co + cstride + 1];
            pv0[n_used][j*2+i] =
                ((8-fx)*(8-fy)*A + fx*(8-fy)*B + (8-fx)*fy*Cc
                 + fx*fy*D + 32) >> 6;
          }
        used_lst[n_used] = lst;
        used_ref[n_used] = ref;
        n_used++;
      }
      if (n_used == 0) return -1;
      int yb[16], ub[4], vb[4];
      if (n_used == 2) {
        if (wpm) {
          int i0 = used_ref[0], i1 = used_ref[1];
          int wy0, oy0, wy1, oy1, wc0[2], oc0[2], wc1[2], oc1[2];
          if (wpm == 2) {
            const int32_t *pair = c->wimp
                + (((long)sid * MAXREF + i0) * MAXREF + i1) * 2;
            wy0 = pair[0]; wy1 = pair[1]; oy0 = oy1 = 0;
            wc0[0] = wc0[1] = wy0; wc1[0] = wc1[1] = wy1;
            oc0[0] = oc0[1] = oc1[0] = oc1[1] = 0;
          } else {
            long o0 = ((long)sid * 2 + 0) * MAXREF + i0;
            long o1 = ((long)sid * 2 + 1) * MAXREF + i1;
            wy0 = c->wy[o0]; oy0 = c->oy[o0];
            wy1 = c->wy[o1]; oy1 = c->oy[o1];
            for (int k = 0; k < 2; k++) {
              wc0[k] = c->wc[o0 * 2 + k]; oc0[k] = c->oc[o0 * 2 + k];
              wc1[k] = c->wc[o1 * 2 + k]; oc1[k] = c->oc[o1 * 2 + k];
            }
          }
          for (int k = 0; k < 16; k++)
            yb[k] = iclip((int)((((int64_t)py0[0][k]*wy0
                      + (int64_t)py0[1][k]*wy1 + (1 << ly)) >> (ly + 1))
                      + ((oy0 + oy1 + 1) >> 1)), 0, 255);
          for (int k = 0; k < 4; k++) {
            ub[k] = iclip((int)((((int64_t)pu0[0][k]*wc0[0]
                      + (int64_t)pu0[1][k]*wc1[0] + (1 << lc)) >> (lc + 1))
                      + ((oc0[0] + oc1[0] + 1) >> 1)), 0, 255);
            vb[k] = iclip((int)((((int64_t)pv0[0][k]*wc0[1]
                      + (int64_t)pv0[1][k]*wc1[1] + (1 << lc)) >> (lc + 1))
                      + ((oc0[1] + oc1[1] + 1) >> 1)), 0, 255);
          }
        } else {
          for (int k = 0; k < 16; k++)
            yb[k] = (py0[0][k] + py0[1][k] + 1) >> 1;
          for (int k = 0; k < 4; k++) {
            ub[k] = (pu0[0][k] + pu0[1][k] + 1) >> 1;
            vb[k] = (pv0[0][k] + pv0[1][k] + 1) >> 1;
          }
        }
      } else if (wpm == 1) {
        long o0 = ((long)sid * 2 + used_lst[0]) * MAXREF + used_ref[0];
        int w0 = c->wy[o0], o0y = c->oy[o0];
        for (int k = 0; k < 16; k++)
          yb[k] = iclip((int)((((int64_t)py0[0][k] * w0
                    + (ly >= 1 ? (1 << (ly - 1)) : 0)) >> ly) + o0y),
                    0, 255);
        for (int k = 0; k < 4; k++) {
          ub[k] = iclip((int)((((int64_t)pu0[0][k] * c->wc[o0 * 2]
                    + (lc >= 1 ? (1 << (lc - 1)) : 0)) >> lc)
                    + c->oc[o0 * 2]), 0, 255);
          vb[k] = iclip((int)((((int64_t)pv0[0][k] * c->wc[o0 * 2 + 1]
                    + (lc >= 1 ? (1 << (lc - 1)) : 0)) >> lc)
                    + c->oc[o0 * 2 + 1]), 0, 255);
        }
      } else {
        memcpy(yb, py0[0], sizeof yb);
        memcpy(ub, pu0[0], sizeof ub);
        memcpy(vb, pv0[0], sizeof vb);
      }
      for (int j = 0; j < 4; j++)
        for (int i = 0; i < 4; i++)
          pred_y[(by*4+j)*16 + bx*4+i] = yb[j*4+i];
      for (int j = 0; j < 2; j++)
        for (int i = 0; i < 2; i++) {
          pred_u[(by*2+j)*8 + bx*2+i] = ub[j*2+i];
          pred_v[(by*2+j)*8 + bx*2+i] = vb[j*2+i];
        }
    }

  /* luma residual */
  if (c->transform8x8[addr]) {
    for (int b8 = 0; b8 < 4; b8++) {
      int ioff = (b8 & 1) * 8, joff = (b8 >> 1) * 8;
      const int32_t *lev = c->luma8_levels + ((long)addr * 4 + b8) * 64;
      int pblk[64];
      for (int j = 0; j < 8; j++)
        for (int i = 0; i < 8; i++)
          pblk[j*8+i] = pred_y[(joff+j)*16 + ioff+i];
      resid8(c, lev, qp, 1, pblk,
             Y + (long)(my + joff) * width + mx + ioff, width);
    }
  } else {
    for (int blk = 0; blk < 16; blk++) {
      int bx = BLK4_X[blk], by = BLK4_Y[blk];
      const int32_t *lev = c->luma_levels + ((long)addr * 16 + blk) * 16;
      int pblk[16];
      for (int j = 0; j < 4; j++)
        for (int i = 0; i < 4; i++)
          pblk[j*4+i] = pred_y[(by*4+j)*16 + bx*4+i];
      resid4(c, lev, qp, 3, pblk,
             Y + (long)(my + by*4) * width + mx + bx*4, width);
    }
  }
  chroma_resid(c, addr, 0, 4, pred_u, c->U, cx, cy);
  chroma_resid(c, addr, 1, 5, pred_v, c->V, cx, cy);
  return 0;
}

/* ---- entry point ---- */
long recon_picture(
    int W, int H, int width, int height, int pad, int cip,
    const int32_t *slice_id_a, const int32_t *mb_type_a,
    const uint8_t *is_intra_a, const uint8_t *skip_flag_a,
    const uint8_t *t8_a, const int32_t *qp_a, const int32_t *qpc_a,
    const int32_t *i16mode_a, const int32_t *cipm_a,
    const int32_t *b8mode_a, const int32_t *b8pdir_a,
    const int8_t *ipredmode_a, const int32_t *mvd_a,
    int8_t *ref_idx_a, int32_t *mv_a, int64_t *ref_pic_id_a,
    const int32_t *luma_levels_a, const int32_t *luma8_levels_a,
    const int32_t *luma_dc_a, const int32_t *chroma_dc_a,
    const int32_t *chroma_levels_a,
    int32_t *Y, int32_t *U, int32_t *V,
    int NS, const int32_t *s_type, const int32_t *s_spatial,
    const int32_t *s_d8x8, const int32_t *s_nref,
    const int64_t *s_refids, const uint8_t *s_reflt,
    const int32_t *s_curpoc, const int32_t *s_colpoc,
    const int32_t *s_has_col, const uint8_t *col_moving,
    const int8_t *col_ref0, const int8_t *col_ref1,
    const int64_t *col_id0, const int64_t *col_id1,
    const int32_t *col_mv0, const int32_t *col_mv1,
    const int32_t *wp_mode, const int32_t *wp_ly, const int32_t *wp_lc,
    const int32_t *cadj,
    const int32_t *wy, const int32_t *oy, const int32_t *wc,
    const int32_t *oc, const int32_t *wimp,
    int32_t *const *refY, int32_t *const *refU, int32_t *const *refV,
    const int32_t *ws4, const int32_t *ws8, int has_ws) {
  rctx_t C;
  memset(&C, 0, sizeof C);
  rctx_t *c = &C;
  c->W = W; c->H = H; c->n_mbs = W * H; c->W4 = 4 * W; c->H4 = 4 * H;
  c->width = width; c->height = height;
  c->cw = width / 2; c->ch = height / 2;
  c->pad = pad; c->cip = cip;
  c->slice_id = slice_id_a; c->mb_type = mb_type_a;
  c->is_intra = is_intra_a; c->skip_flag = skip_flag_a;
  c->transform8x8 = t8_a; c->qp = qp_a; c->qpc = qpc_a;
  c->i16mode = i16mode_a; c->c_ipred_mode = cipm_a;
  c->b8mode = b8mode_a; c->b8pdir = b8pdir_a;
  c->ipredmode = ipredmode_a; c->mvd = mvd_a;
  c->ref_idx = ref_idx_a; c->mv = mv_a; c->ref_pic_id = ref_pic_id_a;
  c->luma_levels = luma_levels_a; c->luma8_levels = luma8_levels_a;
  c->luma_dc = luma_dc_a; c->chroma_dc = chroma_dc_a;
  c->chroma_levels = chroma_levels_a;
  c->Y = Y; c->U = U; c->V = V;
  c->NS = NS; c->s_type = s_type; c->s_spatial = s_spatial;
  c->s_d8x8 = s_d8x8; c->s_nref = s_nref; c->s_refids = s_refids;
  c->s_reflt = s_reflt; c->s_curpoc = s_curpoc; c->s_colpoc = s_colpoc;
  c->s_has_col = s_has_col; c->col_moving = col_moving;
  c->col_ref0 = col_ref0; c->col_ref1 = col_ref1;
  c->col_id0 = col_id0; c->col_id1 = col_id1;
  c->col_mv0 = col_mv0; c->col_mv1 = col_mv1;
  c->wp_mode = wp_mode; c->wp_ly = wp_ly; c->wp_lc = wp_lc;
  c->cadj = cadj;
  c->wy = wy; c->oy = oy; c->wc = wc; c->oc = oc; c->wimp = wimp;
  c->refY = refY; c->refU = refU; c->refV = refV;
  c->ws4 = has_ws ? ws4 : NULL;
  c->ws8 = has_ws ? ws8 : NULL;

  /* pass 1: motion derivation in raster order */
  int any_b = 0;
  for (int s = 0; s < NS; s++) any_b |= (s_type[s] != ST_I);
  if (any_b)
    for (int addr = 0; addr < c->n_mbs; addr++)
      if (derive_mb(c, addr) < 0) return -1;

  /* pass 2: reconstruction in raster order */
  for (int addr = 0; addr < c->n_mbs; addr++) {
    if (c->slice_id[addr] < 0) return -1;  /* missing MBs: oracle/ERC */
    if (recon_one_mb(c, addr) < 0) return -1;
  }
  return 0;
}

/* ---- fused recon + deblock ------------------------------------------- */
/* deblock.c entry points (deblock.c is linked into librecon.so) */
void compute_strengths(const uint8_t *is_intra, const int64_t *cbp_blk,
                       const int64_t *rid0, const int64_t *rid1,
                       const int32_t *mv0, const int32_t *mv1,
                       int W, int H, int field,
                       int32_t *BSV, int32_t *BSH);
void deblock_run(int32_t *Y, int32_t *U, int32_t *V, int W_pix, int H_pix,
                 int n_mbW, int n_mbH, const int32_t *BSV, const int32_t *BSH,
                 const int32_t *qp, const int32_t *qpc,
                 const int32_t *lf_disable, const int32_t *lf_alpha,
                 const int32_t *lf_beta, const int32_t *transform8x8,
                 const int32_t *slice_id, int cfi, int32_t max_y,
                 int32_t max_c);

/* recon_picture, then boundary strengths + in-loop filter in the same
 * call (one marshalling pass per picture; ldecod does the same inline —
 * image.c decode_one_frame tail).  Frame pictures, 4:2:0/mono, 8-bit. */
long recon_and_deblock(
    int W, int H, int width, int height, int pad, int cip,
    const int32_t *slice_id_a, const int32_t *mb_type_a,
    const uint8_t *is_intra_a, const uint8_t *skip_flag_a,
    const uint8_t *t8_a, const int32_t *qp_a, const int32_t *qpc_a,
    const int32_t *i16mode_a, const int32_t *cipm_a,
    const int32_t *b8mode_a, const int32_t *b8pdir_a,
    const int8_t *ipredmode_a, const int32_t *mvd_a,
    int8_t *ref_idx_a, int32_t *mv_a, int64_t *ref_pic_id_a,
    const int32_t *luma_levels_a, const int32_t *luma8_levels_a,
    const int32_t *luma_dc_a, const int32_t *chroma_dc_a,
    const int32_t *chroma_levels_a,
    int32_t *Y, int32_t *U, int32_t *V,
    int NS, const int32_t *s_type, const int32_t *s_spatial,
    const int32_t *s_d8x8, const int32_t *s_nref,
    const int64_t *s_refids, const uint8_t *s_reflt,
    const int32_t *s_curpoc, const int32_t *s_colpoc,
    const int32_t *s_has_col, const uint8_t *col_moving,
    const int8_t *col_ref0, const int8_t *col_ref1,
    const int64_t *col_id0, const int64_t *col_id1,
    const int32_t *col_mv0, const int32_t *col_mv1,
    const int32_t *wp_mode, const int32_t *wp_ly, const int32_t *wp_lc,
    const int32_t *cadj,
    const int32_t *wy, const int32_t *oy, const int32_t *wc,
    const int32_t *oc, const int32_t *wimp,
    int32_t *const *refY, int32_t *const *refU, int32_t *const *refV,
    const int32_t *ws4, const int32_t *ws8, int has_ws,
    const int64_t *cbp_blk, const int32_t *lf_disable,
    const int32_t *lf_alpha, const int32_t *lf_beta, int cfi) {
  long rc = recon_picture(
      W, H, width, height, pad, cip, slice_id_a, mb_type_a, is_intra_a,
      skip_flag_a, t8_a, qp_a, qpc_a, i16mode_a, cipm_a, b8mode_a,
      b8pdir_a, ipredmode_a, mvd_a, ref_idx_a, mv_a, ref_pic_id_a,
      luma_levels_a, luma8_levels_a, luma_dc_a, chroma_dc_a,
      chroma_levels_a, Y, U, V, NS, s_type, s_spatial, s_d8x8, s_nref,
      s_refids, s_reflt, s_curpoc, s_colpoc, s_has_col, col_moving,
      col_ref0, col_ref1, col_id0, col_id1, col_mv0, col_mv1, wp_mode,
      wp_ly, wp_lc, cadj, wy, oy, wc, oc, wimp, refY, refU, refV,
      ws4, ws8, has_ws);
  if (rc != 0) return rc;
  int n_mbs = W * H;
  int W4 = 4 * W, H4 = 4 * H;
  long n4 = (long)W4 * H4;
  static const int64_t REF_NONE = -1000000000LL;
  int64_t *rid = (int64_t *)malloc(2 * n4 * sizeof(int64_t));
  int32_t *bs = (int32_t *)malloc(2 * n4 * sizeof(int32_t));
  int32_t *t8_32 = (int32_t *)malloc(n_mbs * sizeof(int32_t));
  if (!rid || !bs || !t8_32) { free(rid); free(bs); free(t8_32); return -2; }
  for (int l = 0; l < 2; l++)
    for (long i = 0; i < n4; i++)
      rid[l * n4 + i] = ref_idx_a[l * n4 + i] >= 0
                            ? ref_pic_id_a[l * n4 + i] : REF_NONE;
  for (int i = 0; i < n_mbs; i++) t8_32[i] = t8_a[i];
  compute_strengths(is_intra_a, cbp_blk, rid, rid + n4,
                    mv_a, mv_a + 2 * n4, W, H, 0, bs, bs + n4);
  deblock_run(Y, U, V, width, height, W, H, bs, bs + n4, qp_a, qpc_a,
              lf_disable, lf_alpha, lf_beta, t8_32, slice_id_a, cfi,
              255, 255);
  free(rid); free(bs); free(t8_32);
  return 0;
}
