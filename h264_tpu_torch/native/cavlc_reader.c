/* Native CAVLC slice-data parser: payload -> PictureParseState arrays.
 *
 * The decode dual of cavlc_writer.c and the C counterpart of
 * decoder/cavlc_mb.py (which remains the portable oracle): Exp-Golomb
 * macroblock layer + table-driven CAVLC residual decoding
 * (ldecod/src/vlc.c readers, macroblock.c readCoeff4x4_CAVLC:2227)
 * in one pass over the flat state tensors.
 *
 * Frame coding, 4:2:0/monochrome, I/P/B slices, IPCM (8-bit), T8x8,
 * FMO scan.  No data partitioning (the wrapper falls back).
 *
 * Build: gcc -O3 -shared -fPIC -o libcavlc_reader.so cavlc_reader.c
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

enum { PSKIP=0, P16x16=1, P16x8=2, P8x16=3, P8x8M=8, I4MB=9, I16MB=10,
       IBLOCK=11, I8MB=13, IPCM=14 };
enum { B8_DIRECT=0, B8_8x8=4, B8_8x4=5, B8_4x8=6, B8_4x4=7 };
enum { PD_L0=0, PD_L1=1, PD_BI=2 };
enum { ST_P=0, ST_B=1, ST_I=2 };
#define DC_PRED 2

static const int BLK4_X[16] = {0,1,0,1,2,3,2,3,0,1,0,1,2,3,2,3};
static const int BLK4_Y[16] = {0,0,1,1,0,0,1,1,2,2,3,3,2,2,3,3};
static const int I16_CBP_TAB[6] = {0, 16, 32, 15, 31, 47};
static const int SUB_MB_P_MODE[5] = {B8_8x8, B8_8x4, B8_4x8, B8_4x4, IBLOCK};
static const int SUB_MB_P_PDIR[5] = {0, 0, 0, 0, -1};
static const int SUB_MB_B_MODE[14] = {
  B8_DIRECT, B8_8x8, B8_8x8, B8_8x8, B8_8x4, B8_4x8, B8_8x4, B8_4x8,
  B8_8x4, B8_4x8, B8_4x4, B8_4x4, B8_4x4, IBLOCK };
static const int SUB_MB_B_PDIR[14] = {2,0,1,2,0,0,1,1,2,2,0,1,2,-1};
static const int B_PDIR_16x16[4] = {0, 0, 1, 2};
static int b_pdir_16x8(int raw, int *p0, int *p1) {
  switch (raw) {
    case 4:  *p0=0; *p1=0; return 1;  case 6:  *p0=1; *p1=1; return 1;
    case 8:  *p0=0; *p1=1; return 1;  case 10: *p0=1; *p1=0; return 1;
    case 12: *p0=0; *p1=2; return 1;  case 14: *p0=1; *p1=2; return 1;
    case 16: *p0=2; *p1=0; return 1;  case 18: *p0=2; *p1=1; return 1;
    case 20: *p0=2; *p1=2; return 1;  default: return 0;
  }
}
static int b_pdir_8x16(int raw, int *p0, int *p1) {
  switch (raw) {
    case 5:  *p0=0; *p1=0; return 1;  case 7:  *p0=1; *p1=1; return 1;
    case 9:  *p0=0; *p1=1; return 1;  case 11: *p0=1; *p1=0; return 1;
    case 13: *p0=0; *p1=2; return 1;  case 15: *p0=1; *p1=2; return 1;
    case 17: *p0=2; *p1=0; return 1;  case 19: *p0=2; *p1=1; return 1;
    case 21: *p0=2; *p1=2; return 1;  default: return 0;
  }
}
static const int INC_VLC[7] = {0, 3, 6, 12, 24, 48, 32768};

/* ---- bit reader ---- */
typedef struct {
  const uint8_t *data;
  long pos, n_bits, stop_pos;
  int err;
} br_t;

static void br_init(br_t *r, const uint8_t *data, long n_bytes,
                    long start_bit) {
  r->data = data;
  r->pos = start_bit;
  r->n_bits = 8 * n_bytes;
  r->err = 0;
  long i = n_bytes - 1;
  while (i >= 0 && data[i] == 0) i--;
  if (i < 0) r->stop_pos = 0;
  else {
    int b = data[i], low = 0;
    while (!(b & (1 << low))) low++;
    r->stop_pos = (i << 3) + (7 - low);
  }
}
static inline int br_bit(br_t *r) {
  if (r->pos >= r->n_bits) { r->err = 1; return 0; }
  int v = (r->data[r->pos >> 3] >> (7 - (r->pos & 7))) & 1;
  r->pos++;
  return v;
}
static inline uint32_t br_u(br_t *r, int n) {
  uint32_t v = 0;
  while (n--) v = (v << 1) | br_bit(r);
  return v;
}
static int br_ue(br_t *r) {
  int zeros = 0;
  while (!br_bit(r)) {
    if (++zeros > 31 || r->err) { r->err = 1; return 0; }
  }
  return (1 << zeros) - 1 + br_u(r, zeros);
}
static int br_se(br_t *r) {
  int k = br_ue(r);
  return (k & 1) ? (k + 1) / 2 : -(k / 2);
}
static int br_te(br_t *r, int maxv) {
  if (maxv == 1) return !br_bit(r);
  return br_ue(r);
}
static inline int br_more(const br_t *r) {
  return r->pos < r->stop_pos;
}

/* ---- VLC table reads (linear scan over the shared code tables) ---- */
typedef struct {
  /* tabs from native/_get_cavlc_tables (same order as cavlc_writer) */
  const int32_t *ct_len, *ct_code;       /* (3,4,17) coeff_token */
  const int32_t *cdc_len, *cdc_code;     /* (4,17) chroma-DC token */
  const int32_t *tz_len, *tz_code;       /* (15,16) total_zeros */
  const int32_t *tzc_len, *tzc_code;     /* (15,16) cdc total_zeros */
  const int32_t *rb_len, *rb_code;       /* (7,15) run_before */
  const int32_t *cbp_intra, *cbp_inter;  /* (48) cbp -> codeNum */
} ctabs_t;

static int vlc_read(br_t *r, const int32_t *len, const int32_t *code,
                    int n, int max_len) {
  uint32_t acc = 0;
  for (int ln = 1; ln <= max_len; ln++) {
    acc = (acc << 1) | br_bit(r);
    if (r->err) return -1;
    for (int v = 0; v < n; v++)
      if (len[v] == ln && (uint32_t)code[v] == acc) return v;
  }
  return -1;
}

static int pair_read(br_t *r, const int32_t *len, const int32_t *code,
                     int *nc, int *t1) {
  /* len/code: (4,17) for one vlc row; value = (numcoeff, t1s) */
  uint32_t acc = 0;
  for (int ln = 1; ln <= 24; ln++) {
    acc = (acc << 1) | br_bit(r);
    if (r->err) return -1;
    for (int a = 0; a < 4; a++)
      for (int b = 0; b < 17; b++)
        if (len[a * 17 + b] == ln && (uint32_t)code[a * 17 + b] == acc) {
          *nc = b;
          *t1 = a;
          return 0;
        }
  }
  return -1;
}

static int read_level(br_t *r, int vlc) {
  int zeros = 0;
  while (br_bit(r) == 0) {
    if (++zeros > 64 || r->err) { r->err = 1; return 0; }
  }
  if (vlc == 0) {
    if (zeros < 14) {
      int levabs = (zeros >> 1) + 1;
      return (zeros & 1) ? -levabs : levabs;
    }
    if (zeros == 14) {
      int rest = br_u(r, 4);
      int levabs = 8 + (rest >> 1);
      return (rest & 1) ? -levabs : levabs;
    }
    int addbit = zeros - 15;
    int rest = br_u(r, 12 + addbit);
    int levabs = (rest >> 1) + 16;  /* VLC1 escape omits the offset */
    return (rest & 1) ? -levabs : levabs;
  }
  int shift = vlc - 1;
  if (zeros < 15) {
    int suffix = shift ? br_u(r, shift) : 0;
    int levabs = (zeros << shift) + suffix + 1;
    return br_bit(r) ? -levabs : levabs;
  }
  int addbit = zeros - 15;
  long offset = ((2048L << addbit) - 2048);
  long rest = br_u(r, 12 + addbit);
  long levabs = (rest >> 1) + offset + (15L << shift) + 1;
  return (rest & 1) ? (int)-levabs : (int)levabs;
}

/* decode one residual block (entropy/cavlc/dec.py decode_block) */
static int decode_block(br_t *r, const ctabs_t *t, int max_coeff, int nc,
                        int chroma_dc, int *coeffs, int *total) {
  memset(coeffs, 0, sizeof(int) * max_coeff);
  int numcoeff = 0, t1s = 0;
  if (chroma_dc) {
    if (pair_read(r, t->cdc_len, t->cdc_code, &numcoeff, &t1s) < 0)
      return -1;
  } else {
    int vlcnum = nc < 2 ? 0 : (nc < 4 ? 1 : (nc < 8 ? 2 : 3));
    if (vlcnum == 3) {
      int code = br_u(r, 6);
      if (code == 3) { numcoeff = 0; t1s = 0; }
      else { numcoeff = (code >> 2) + 1; t1s = code & 3; }
    } else if (pair_read(r, t->ct_len + vlcnum * 4 * 17,
                         t->ct_code + vlcnum * 4 * 17, &numcoeff,
                         &t1s) < 0)
      return -1;
  }
  *total = numcoeff;
  if (numcoeff == 0) return 0;
  if (numcoeff > max_coeff) return -1;
  int levels[16];
  memset(levels, 0, sizeof levels);
  for (int i = 0; i < t1s; i++)
    levels[numcoeff - 1 - i] = br_bit(r) ? -1 : 1;
  int two_or_higher = !(numcoeff > 3 && t1s == 3);
  int vlc = (numcoeff > 10 && t1s < 3) ? 1 : 0;
  int first = 1;
  for (int k = numcoeff - 1 - t1s; k >= 0; k--) {
    int lv = read_level(r, vlc);
    if (r->err) return -1;
    if (two_or_higher) {
      two_or_higher = 0;
      lv = lv > 0 ? lv + 1 : lv - 1;
    }
    levels[k] = lv;
    int a = lv < 0 ? -lv : lv;
    if (a > INC_VLC[vlc]) vlc++;
    if (first && a > 3) vlc = 2;
    first = 0;
  }
  int totzeros = 0;
  if (numcoeff < max_coeff) {
    if (chroma_dc)
      totzeros = vlc_read(r, t->tzc_len + (numcoeff - 1) * 16,
                          t->tzc_code + (numcoeff - 1) * 16, 16, 16);
    else
      totzeros = vlc_read(r, t->tz_len + (numcoeff - 1) * 16,
                          t->tz_code + (numcoeff - 1) * 16, 16, 16);
    if (totzeros < 0) return -1;
  }
  int runs[16];
  memset(runs, 0, sizeof runs);
  int zerosleft = totzeros, numcoef = numcoeff;
  for (int k = numcoeff - 1; k >= 0; k--) {
    if (!zerosleft || numcoeff <= 1) break;
    if (numcoef > 1) {
      int vlcr = zerosleft - 1 < 6 ? zerosleft - 1 : 6;
      int run = vlc_read(r, t->rb_len + vlcr * 15,
                         t->rb_code + vlcr * 15, 15, 16);
      if (run < 0) return -1;
      runs[k] = run;
      zerosleft -= run;
      numcoef--;
    }
  }
  runs[0] += zerosleft;
  int pos = -1;
  for (int k = 0; k < numcoeff; k++) {
    pos += runs[k] + 1;
    if (pos >= max_coeff) return -1;
    coeffs[pos] = levels[k];
  }
  return 0;
}

/* ---- parser context (mirrors cabac_reader's layout) ---- */
typedef struct {
  br_t r;
  ctabs_t tabs;
  int W, H, n_mbs, W4, H4;
  int32_t *slice_id, *mb_type, *raw_mb_type, *cbp, *qp_arr, *c_ipred_mode,
          *b8mode, *b8pdir, *i16mode;
  int64_t *cbp_blk;
  uint8_t *is_intra, *skip_flag, *transform8x8, *nnz;
  int8_t *ipredmode, *ref_idx;
  int32_t *mvd, *luma_levels, *luma8_levels, *luma_dc, *chroma_dc,
          *chroma_levels;
  int slice_type, qp, n_ref0, n_ref1, t8_mode, cip, cfi, d8x8, sid;
  const uint8_t *rbsp;
  uint8_t *ipcm_data; int32_t *ipcm_addrs; int ipcm_cap, n_ipcm;
  /* zigzag raster maps shared with the cabac reader tabs */
  const int32_t *zz4, *zz8;
} cav_t;

static inline int mb_avail(const cav_t *c, int nb, int cur) {
  if (nb < 0 || nb >= c->n_mbs) return 0;
  return c->slice_id[nb] == c->slice_id[cur];
}
static int luma_nb(const cav_t *c, int addr, int xp, int yp, int *nb_addr,
                   int *bx, int *by) {
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
  if (bx) { *bx = (xp & 15) >> 2; *by = (yp & 15) >> 2; }
  return 1;
}
static int chroma_nb(const cav_t *c, int addr, int xp, int yp,
                     int *nb_addr, int *bx, int *by) {
  int mbx = addr % c->W, mby = addr / c->W;
  int na;
  if (xp < 0 && yp < 0) na = (mbx > 0 && mby > 0) ? addr - c->W - 1 : -1;
  else if (xp < 0) na = mbx > 0 ? addr - 1 : -1;
  else if (yp < 0) na = mby > 0 ? addr - c->W : -1;
  else if (xp < 8 && yp < 8) na = addr;
  else return 0;
  if (na < 0 || !mb_avail(c, na, addr)) return 0;
  *nb_addr = na;
  *bx = (xp & 7) >> 2; *by = (yp & 7) >> 2;
  return 1;
}

static int predict_nnz(const cav_t *c, int addr, int bx, int by,
                       int plane) {
  long pstride = (long)c->H4 * c->W4;
  int la, ua, lmb, lbx, lby, umb, ubx, uby;
  int lx = 0, ly = 0, ux = 0, uy = 0;
  if (plane == 0) {
    la = luma_nb(c, addr, (bx << 2) - 1, by << 2, &lmb, &lbx, &lby);
    ua = luma_nb(c, addr, bx << 2, (by << 2) - 1, &umb, &ubx, &uby);
    if (la) { lx = 4 * (lmb % c->W) + lbx; ly = 4 * (lmb / c->W) + lby; }
    if (ua) { ux = 4 * (umb % c->W) + ubx; uy = 4 * (umb / c->W) + uby; }
  } else {
    la = chroma_nb(c, addr, (bx << 2) - 1, by << 2, &lmb, &lbx, &lby);
    ua = chroma_nb(c, addr, bx << 2, (by << 2) - 1, &umb, &ubx, &uby);
    if (la) { lx = 2 * (lmb % c->W) + lbx; ly = 2 * (lmb / c->W) + lby; }
    if (ua) { ux = 2 * (umb % c->W) + ubx; uy = 2 * (umb / c->W) + uby; }
  }
  int cnt = 0, pred = 0;
  if (la) { pred += c->nnz[plane * pstride + (long)ly * c->W4 + lx]; cnt++; }
  if (ua) { pred += c->nnz[plane * pstride + (long)uy * c->W4 + ux]; cnt++; }
  if (cnt == 2) pred = (pred + 1) >> 1;
  return pred;
}

static void setup_skip(cav_t *c, int addr) {
  c->skip_flag[addr] = 1;
  if (c->slice_type == ST_B) {
    c->mb_type[addr] = 0;
    for (int b = 0; b < 4; b++) {
      c->b8mode[addr * 4 + b] = B8_DIRECT;
      c->b8pdir[addr * 4 + b] = PD_BI;
    }
  } else {
    c->mb_type[addr] = PSKIP;
    for (int b = 0; b < 4; b++) {
      c->b8mode[addr * 4 + b] = 0;
      c->b8pdir[addr * 4 + b] = PD_L0;
    }
  }
  int x4 = 4 * (addr % c->W), y4 = 4 * (addr / c->W);
  for (int dy = 0; dy < 4; dy++)
    for (int dx = 0; dx < 4; dx++)
      c->ipredmode[(long)(y4 + dy) * c->W4 + x4 + dx] = DC_PRED;
}

static int no_part_lt8(const cav_t *c, int addr) {
  int mbt = c->mb_type[addr];
  if (mbt == P16x16 || mbt == P16x8 || mbt == P8x16) return 1;
  if (mbt == 0 && c->slice_type == ST_B) return c->d8x8;
  if (mbt == P8x8M) {
    for (int b = 0; b < 4; b++) {
      int m = c->b8mode[addr * 4 + b];
      if (!((m == B8_DIRECT && c->d8x8) || m == B8_8x8)) return 0;
    }
    return 1;
  }
  return 0;
}

static int read_motion(cav_t *c, int addr, int mbt) {
  br_t *r = &c->r;
  int x4 = 4 * (addr % c->W), y4 = 4 * (addr / c->W);
  long plane = (long)c->H4 * c->W4;
  int bframe = c->slice_type == ST_B;
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
  int allrefzero = !bframe && c->raw_mb_type[addr] == 5;
  for (int lst = 0; lst < 2; lst++) {
    if (lst == 1 && !bframe) break;
    int n_ref = lst == 0 ? c->n_ref0 : c->n_ref1;
    for (int k = 0; k < n_parts; k++) {
      int bx = parts[k][0], by = parts[k][1], w4 = parts[k][2],
          h4 = parts[k][3], b8 = parts[k][4];
      int b8m = c->b8mode[addr * 4 + b8];
      int pdir = c->b8pdir[addr * 4 + b8];
      if (b8m == IBLOCK || (mbt == P8x8M && b8m == B8_DIRECT)) continue;
      if (bframe && pdir != lst && pdir != PD_BI) continue;
      int ref = (n_ref > 1 && !allrefzero) ? br_te(r, n_ref - 1) : 0;
      if (ref >= 32 || ref < 0) return -1;
      for (int dy = 0; dy < h4; dy++)
        for (int dx = 0; dx < w4; dx++)
          c->ref_idx[lst * plane + (long)(y4 + by + dy) * c->W4
                     + x4 + bx + dx] = (int8_t)ref;
    }
  }
  for (int lst = 0; lst < 2; lst++) {
    if (lst == 1 && !bframe) break;
    for (int k = 0; k < n_parts; k++) {
      int bx = parts[k][0], by = parts[k][1], w4 = parts[k][2],
          h4 = parts[k][3], b8 = parts[k][4];
      int b8m = c->b8mode[addr * 4 + b8];
      int pdir = c->b8pdir[addr * 4 + b8];
      if (b8m == IBLOCK || (mbt == P8x8M && b8m == B8_DIRECT)) continue;
      if (bframe && pdir != lst && pdir != PD_BI) continue;
      int sw = w4, sh = h4;
      if (mbt == P8x8M) {
        switch (b8m) {
          case B8_8x8: sw = 2; sh = 2; break;
          case B8_8x4: sw = 2; sh = 1; break;
          case B8_4x8: sw = 1; sh = 2; break;
          default:     sw = 1; sh = 1; break;
        }
      }
      for (int dy = 0; dy < h4; dy += sh)
        for (int dx = 0; dx < w4; dx += sw) {
          int mvdx = br_se(r), mvdy = br_se(r);
          for (int jy = 0; jy < sh; jy++)
            for (int jx = 0; jx < sw; jx++) {
              long o = (lst * plane
                        + (long)(y4 + by + dy + jy) * c->W4
                        + x4 + bx + dx + jx) << 1;
              c->mvd[o] = mvdx;
              c->mvd[o + 1] = mvdy;
            }
        }
    }
  }
  return c->r.err ? -1 : 0;
}

static int read_residuals(cav_t *c, int addr) {
  br_t *r = &c->r;
  const ctabs_t *t = &c->tabs;
  int mbt = c->mb_type[addr];
  int cbp = c->cbp[addr];
  int x4 = 4 * (addr % c->W), y4 = 4 * (addr / c->W);
  long pstride = (long)c->H4 * c->W4;
  int coeffs[16], n;
  if (mbt == I16MB) {
    int nc = predict_nnz(c, addr, 0, 0, 0);
    if (decode_block(r, t, 16, nc, 0, coeffs, &n) < 0) return -1;
    c->nnz[(long)y4 * c->W4 + x4] = (uint8_t)n;
    for (int k = 0; k < 16; k++)
      if (coeffs[k]) {
        c->luma_dc[(long)addr * 16 + c->zz4[k]] = coeffs[k];
        c->cbp_blk[addr] |= 1;
      }
  }
  if (cbp & 15) {
    int maxc = mbt == I16MB ? 15 : 16;
    int t8 = c->transform8x8[addr];
    for (int b8 = 0; b8 < 4; b8++)
      for (int b4 = 0; b4 < 4; b4++) {
        int blk = b8 * 4 + b4;
        int bx = BLK4_X[blk], by = BLK4_Y[blk];
        if (!(cbp & (1 << b8))) {
          c->nnz[(long)(y4 + by) * c->W4 + x4 + bx] = 0;
          continue;
        }
        int nc = predict_nnz(c, addr, bx, by, 0);
        if (decode_block(r, t, maxc, nc, 0, coeffs, &n) < 0) return -1;
        c->nnz[(long)(y4 + by) * c->W4 + x4 + bx] = (uint8_t)n;
        if (t8) {
          int nz = 0;
          for (int k = 0; k < maxc; k++)
            if (coeffs[k]) {
              c->luma8_levels[((long)addr * 4 + b8) * 64
                              + c->zz8[(k << 2) + b4]] = coeffs[k];
              nz++;
            }
          if (nz)
            c->cbp_blk[addr] |= 51ll << (4 * b8 - 2 * (b8 & 1));
          continue;
        }
        int off = mbt == I16MB ? 1 : 0;
        int nz = 0;
        for (int k = 0; k < maxc; k++)
          if (coeffs[k]) {
            c->luma_levels[((long)addr * 16 + blk) * 16
                           + c->zz4[k + off]] = coeffs[k];
            nz++;
          }
        if (nz) c->cbp_blk[addr] |= 1ll << (4 * by + bx);
      }
  }
  if (c->cfi != 1) return 0;
  int x2 = 2 * (addr % c->W), y2 = 2 * (addr / c->W);
  if (cbp > 15)
    for (int uv = 0; uv < 2; uv++) {
      if (decode_block(r, t, 4, -1, 1, coeffs, &n) < 0) return -1;
      for (int k = 0; k < 4; k++)
        if (coeffs[k])
          c->chroma_dc[((long)addr * 2 + uv) * 4 + (k >> 1) * 2 + (k & 1)]
              = coeffs[k];
    }
  if (cbp > 31)
    for (int uv = 0; uv < 2; uv++)
      for (int blk = 0; blk < 4; blk++) {
        int bx = blk & 1, by = blk >> 1;
        int nc = predict_nnz(c, addr, bx, by, 1 + uv);
        if (decode_block(r, t, 15, nc, 0, coeffs, &n) < 0) return -1;
        c->nnz[(1 + uv) * pstride + (long)(y2 + by) * c->W4 + x2 + bx]
            = (uint8_t)n;
        for (int k = 0; k < 15; k++)
          if (coeffs[k])
            c->chroma_levels[(((long)addr * 2 + uv) * 4 + blk) * 16
                             + c->zz4[k + 1]] = coeffs[k];
      }
  return 0;
}

static int read_ipcm(cav_t *c, int addr) {
  br_t *r = &c->r;
  r->pos = (r->pos + 7) & ~7l;
  long need = 256 + (c->cfi == 1 ? 128 : 0);
  if (r->pos + 8 * need > r->n_bits) return -1;
  if (c->n_ipcm >= c->ipcm_cap) return -1;
  memcpy(c->ipcm_data + (long)c->n_ipcm * 384, c->rbsp + r->pos / 8, need);
  c->ipcm_addrs[c->n_ipcm++] = addr;
  r->pos += 8 * need;
  c->qp_arr[addr] = c->qp;
  int x4 = 4 * (addr % c->W), y4 = 4 * (addr / c->W);
  long pstride = (long)c->H4 * c->W4;
  for (int dy = 0; dy < 4; dy++)
    for (int dx = 0; dx < 4; dx++)
      c->nnz[(long)(y4 + dy) * c->W4 + x4 + dx] = 16;
  int x2 = 2 * (addr % c->W), y2 = 2 * (addr / c->W);
  for (int pl = 1; pl < 3; pl++)
    for (int dy = 0; dy < 2; dy++)
      for (int dx = 0; dx < 2; dx++)
        c->nnz[pl * pstride + (long)(y2 + dy) * c->W4 + x2 + dx] = 16;
  return 0;
}

static int read_mb(cav_t *c, int addr) {
  br_t *r = &c->r;
  int x4 = 4 * (addr % c->W), y4 = 4 * (addr / c->W);
  for (int dy = 0; dy < 4; dy++)
    for (int dx = 0; dx < 4; dx++)
      c->ipredmode[(long)(y4 + dy) * c->W4 + x4 + dx] = DC_PRED;
  int raw = br_ue(r);
  int is_p = c->slice_type == ST_P, is_b = c->slice_type == ST_B;
  if (is_p) raw += 1;
  c->raw_mb_type[addr] = raw;
  int set_all_b8 = 1, b8m = 0, b8p = -1;
  if (is_p) {
    if (raw < 4) { c->mb_type[addr] = raw; b8m = raw; b8p = 0; }
    else if (raw == 4 || raw == 5) { c->mb_type[addr] = P8x8M; set_all_b8 = 0; }
    else if (raw == 6) { c->mb_type[addr] = I4MB; b8m = IBLOCK; }
    else if (raw == 31) c->mb_type[addr] = IPCM;
    else if (raw <= 30) {
      c->mb_type[addr] = I16MB;
      c->cbp[addr] = I16_CBP_TAB[(raw - 7) >> 2];
      c->i16mode[addr] = (raw - 7) & 3;
    } else return -1;
  } else if (is_b) {
    if (raw == 0) { c->mb_type[addr] = 0; b8m = B8_DIRECT; b8p = PD_BI; }
    else if (raw == 23) { c->mb_type[addr] = I4MB; b8m = IBLOCK; }
    else if (raw == 48) c->mb_type[addr] = IPCM;
    else if (raw > 23 && raw < 48) {
      c->mb_type[addr] = I16MB;
      c->cbp[addr] = I16_CBP_TAB[(raw - 24) >> 2];
      c->i16mode[addr] = (raw - 24) & 3;
    } else if (raw == 22) { c->mb_type[addr] = P8x8M; set_all_b8 = 0; }
    else if (raw < 4) {
      c->mb_type[addr] = P16x16; b8m = 1; b8p = B_PDIR_16x16[raw];
    } else if ((raw & 1) == 0) {
      int p0, p1;
      if (!b_pdir_16x8(raw, &p0, &p1)) return -1;
      c->mb_type[addr] = P16x8;
      for (int b = 0; b < 4; b++) c->b8mode[addr*4+b] = 2;
      c->b8pdir[addr*4+0] = c->b8pdir[addr*4+1] = p0;
      c->b8pdir[addr*4+2] = c->b8pdir[addr*4+3] = p1;
      set_all_b8 = 0;
    } else {
      int p0, p1;
      if (!b_pdir_8x16(raw, &p0, &p1)) return -1;
      c->mb_type[addr] = P8x16;
      for (int b = 0; b < 4; b++) c->b8mode[addr*4+b] = 3;
      c->b8pdir[addr*4+0] = c->b8pdir[addr*4+2] = p0;
      c->b8pdir[addr*4+1] = c->b8pdir[addr*4+3] = p1;
      set_all_b8 = 0;
    }
  } else {  /* I */
    if (raw == 0) { c->mb_type[addr] = I4MB; b8m = IBLOCK; }
    else if (raw == 25) c->mb_type[addr] = IPCM;
    else if (raw <= 24) {
      c->mb_type[addr] = I16MB;
      c->cbp[addr] = I16_CBP_TAB[(raw - 1) >> 2];
      c->i16mode[addr] = (raw - 1) & 3;
    } else return -1;
  }
  if (set_all_b8)
    for (int b = 0; b < 4; b++) {
      c->b8mode[addr * 4 + b] = b8m;
      c->b8pdir[addr * 4 + b] = b8p;
    }
  int mbt = c->mb_type[addr];
  c->is_intra[addr] = (mbt == I4MB || mbt == I16MB || mbt == I8MB
                       || mbt == IPCM);
  if (mbt == IPCM) return read_ipcm(c, addr);

  if (mbt == P8x8M)
    for (int b8 = 0; b8 < 4; b8++) {
      int v = br_ue(r);
      if (is_b) {
        if (v > 13) return -1;
        c->b8mode[addr * 4 + b8] = SUB_MB_B_MODE[v];
        c->b8pdir[addr * 4 + b8] = SUB_MB_B_PDIR[v];
      } else {
        if (v > 4) return -1;
        c->b8mode[addr * 4 + b8] = SUB_MB_P_MODE[v];
        c->b8pdir[addr * 4 + b8] = SUB_MB_P_PDIR[v];
      }
    }

  if (mbt == I4MB && c->t8_mode && br_bit(r)) {
    c->transform8x8[addr] = 1;
    c->mb_type[addr] = I8MB;
    mbt = I8MB;
  }
  if (mbt == I4MB || mbt == I8MB) {
    int step = mbt == I8MB ? 2 : 1;
    for (int b8 = 0; b8 < 4; b8++)
      for (int j = 0; j < 2; j += step)
        for (int i = 0; i < 2; i += step) {
          int bx = ((b8 & 1) << 1) + i;
          int by = (b8 & 2) + j;
          int lmb, lbx, lby, umb, ubx, uby;
          int la = luma_nb(c, addr, (bx << 2) - 1, by << 2,
                           &lmb, &lbx, &lby);
          int ua = luma_nb(c, addr, bx << 2, (by << 2) - 1,
                           &umb, &ubx, &uby);
          if (c->cip) {
            la = la && c->is_intra[lmb];
            ua = ua && c->is_intra[umb];
          }
          int lm = la ? c->ipredmode[
              (long)(4 * (lmb / c->W) + lby) * c->W4
              + 4 * (lmb % c->W) + lbx] : -1;
          int um = ua ? c->ipredmode[
              (long)(4 * (umb / c->W) + uby) * c->W4
              + 4 * (umb % c->W) + ubx] : -1;
          int mpm = (lm < 0 || um < 0) ? DC_PRED : (lm < um ? lm : um);
          int mode;
          if (br_bit(r)) mode = mpm;
          else {
            int rem = br_u(r, 3);
            mode = rem < mpm ? rem : rem + 1;
          }
          for (int jy = 0; jy < step; jy++)
            for (int jx = 0; jx < step; jx++)
              c->ipredmode[(long)(y4 + by + jy) * c->W4 + x4 + bx + jx]
                  = (int8_t)mode;
        }
  }
  if ((mbt == I4MB || mbt == I8MB || mbt == I16MB) && c->cfi)
    c->c_ipred_mode[addr] = br_ue(r);
  if (mbt == P16x16 || mbt == P16x8 || mbt == P8x16 || mbt == P8x8M)
    if (read_motion(c, addr, mbt) < 0) return -1;
  if (mbt != I16MB) {
    int code = br_ue(r);
    if (code >= 48) return -1;
    const int32_t *tab = (mbt == I4MB || mbt == I8MB)
        ? c->tabs.cbp_intra : c->tabs.cbp_inter;
    /* tables map cbp -> codeNum (4:2:0); invert by scan */
    int cbp = -1;
    for (int v = 0; v < 48; v++)
      if (tab[v] == code) { cbp = v; break; }
    if (cbp < 0) return -1;
    c->cbp[addr] = cbp;
  }
  int cbp = c->cbp[addr];
  if (mbt != I4MB && mbt != I8MB && mbt != I16MB && (cbp & 15)
      && c->t8_mode && no_part_lt8(c, addr))
    c->transform8x8[addr] = br_bit(r);
  if (cbp != 0 || mbt == I16MB) {
    int dq = br_se(r);
    c->qp = (c->qp + dq + 52) % 52;
  }
  c->qp_arr[addr] = c->qp;
  if (read_residuals(c, addr) < 0) return -1;
  return c->r.err ? -1 : 0;
}

long cavlc_parse_slice(
    int W, int H,
    int32_t *mb_type, int32_t *raw_mb_type, uint8_t *skip_flag,
    int32_t *cbp, int64_t *cbp_blk,
    int32_t *qp_arr, int32_t *c_ipred_mode, int32_t *b8mode,
    int32_t *b8pdir, int32_t *i16mode, uint8_t *is_intra,
    uint8_t *transform8x8, int32_t *slice_id_arr, int8_t *ipredmode,
    int8_t *ref_idx, int32_t *mvd, int32_t *luma_levels,
    int32_t *luma8_levels, int32_t *luma_dc, int32_t *chroma_dc,
    int32_t *chroma_levels, uint8_t *nnz,
    int slice_type, int init_qp, int n_ref0, int n_ref1, int t8_mode,
    int constrained_intra, int cfi, int d8x8_inference, int first_mb,
    int slice_id, const int32_t *next_addr,
    const uint8_t *rbsp, long rbsp_bytes, long start_bit,
    const int32_t *ct_len, const int32_t *ct_code,
    const int32_t *cdc_len, const int32_t *cdc_code,
    const int32_t *tz_len, const int32_t *tz_code,
    const int32_t *tzc_len, const int32_t *tzc_code,
    const int32_t *rb_len, const int32_t *rb_code,
    const int32_t *cbp_intra, const int32_t *cbp_inter,
    const int32_t *zz4, const int32_t *zz8,
    uint8_t *ipcm_data, int32_t *ipcm_addrs, int ipcm_cap,
    int32_t *n_ipcm_out) {
  cav_t C;
  memset(&C, 0, sizeof C);
  cav_t *c = &C;
  c->W = W; c->H = H; c->n_mbs = W * H; c->W4 = 4 * W; c->H4 = 4 * H;
  c->mb_type = mb_type; c->raw_mb_type = raw_mb_type;
  c->skip_flag = skip_flag; c->cbp = cbp; c->cbp_blk = cbp_blk;
  c->qp_arr = qp_arr; c->c_ipred_mode = c_ipred_mode;
  c->b8mode = b8mode; c->b8pdir = b8pdir; c->i16mode = i16mode;
  c->is_intra = is_intra; c->transform8x8 = transform8x8;
  c->slice_id = slice_id_arr; c->ipredmode = ipredmode;
  c->ref_idx = ref_idx; c->mvd = mvd;
  c->luma_levels = luma_levels; c->luma8_levels = luma8_levels;
  c->luma_dc = luma_dc; c->chroma_dc = chroma_dc;
  c->chroma_levels = chroma_levels; c->nnz = nnz;
  c->slice_type = slice_type; c->qp = init_qp;
  c->n_ref0 = n_ref0; c->n_ref1 = n_ref1; c->t8_mode = t8_mode;
  c->cip = constrained_intra; c->cfi = cfi; c->d8x8 = d8x8_inference;
  c->sid = slice_id; c->rbsp = rbsp;
  c->ipcm_data = ipcm_data; c->ipcm_addrs = ipcm_addrs;
  c->ipcm_cap = ipcm_cap; c->n_ipcm = 0;
  c->zz4 = zz4; c->zz8 = zz8;
  c->tabs.ct_len = ct_len; c->tabs.ct_code = ct_code;
  c->tabs.cdc_len = cdc_len; c->tabs.cdc_code = cdc_code;
  c->tabs.tz_len = tz_len; c->tabs.tz_code = tz_code;
  c->tabs.tzc_len = tzc_len; c->tabs.tzc_code = tzc_code;
  c->tabs.rb_len = rb_len; c->tabs.rb_code = rb_code;
  c->tabs.cbp_intra = cbp_intra; c->tabs.cbp_inter = cbp_inter;
  br_init(&c->r, rbsp, rbsp_bytes, start_bit);

  int addr = first_mb;
  long parsed = 0;
  int is_pb = slice_type == ST_P || slice_type == ST_B;
  while (addr >= 0 && addr < c->n_mbs && br_more(&c->r)) {
    if (is_pb) {
      int skip_run = br_ue(&c->r);
      if (c->r.err || skip_run > c->n_mbs) return -1;
      while (skip_run-- > 0 && addr >= 0 && addr < c->n_mbs) {
        slice_id_arr[addr] = slice_id;
        qp_arr[addr] = c->qp;
        setup_skip(c, addr);
        parsed++;
        addr = next_addr ? next_addr[addr] : addr + 1;
      }
      if (addr < 0 || addr >= c->n_mbs || !br_more(&c->r)) break;
    }
    slice_id_arr[addr] = slice_id;
    qp_arr[addr] = c->qp;
    if (read_mb(c, addr) < 0) return -1;
    parsed++;
    addr = next_addr ? next_addr[addr] : addr + 1;
    if (parsed > c->n_mbs) return -1;
  }
  *n_ipcm_out = c->n_ipcm;
  return parsed;
}
