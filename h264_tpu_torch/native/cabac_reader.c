/* Native CABAC slice-data parser: payload -> PictureParseState arrays.
 *
 * The decode dual of cabac_writer.c: fuses the arithmetic decoder
 * (spec 9.3.3.2), context adaptation, and MB-layer de-binarization
 * (the exact dual of decoder/cabac_mb.py, which remains the portable
 * oracle) into one C pass that fills the flat per-MB state tensors the
 * TPU reconstruction stage consumes.  The reference's equivalent layers
 * are ldecod/src/cabac.c (readMB_typeInfo_CABAC:549, readMVD_CABAC:269,
 * readCBP_CABAC:977, read_significance_map:1470, readRunLevel_CABAC:1574)
 * over biaridecod.c:281; this implementation is structured around flat
 * state tensors + a flat context array rather than JM's per-MB structs.
 *
 * Frame coding, 4:2:0/monochrome, I/P/B slices, IPCM (8-bit), FMO scan
 * via next_addr[].  No MBAFF/fields (the Python wrapper falls back to
 * the oracle when unsupported).
 *
 * Build: gcc -O3 -shared -fPIC -o libcabac_reader.so cabac_reader.c
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

/* ---- engine tables (ITU-T H.264 9.3.3.2, normative constants) ---- */
static const uint8_t rangeTabLPS[64][4] = {
  {128,176,208,240},{128,167,197,227},{128,158,187,216},{123,150,178,205},
  {116,142,169,195},{111,135,160,185},{105,128,152,175},{100,122,144,166},
  { 95,116,137,158},{ 90,110,130,150},{ 85,104,123,142},{ 81, 99,117,135},
  { 77, 94,111,128},{ 73, 89,105,122},{ 69, 85,100,116},{ 66, 80, 95,110},
  { 62, 76, 90,104},{ 59, 72, 86, 99},{ 56, 69, 81, 94},{ 53, 65, 77, 89},
  { 51, 62, 73, 85},{ 48, 59, 69, 80},{ 46, 56, 66, 76},{ 43, 53, 63, 72},
  { 41, 50, 59, 69},{ 39, 48, 56, 65},{ 37, 45, 54, 62},{ 35, 43, 51, 59},
  { 33, 41, 48, 56},{ 32, 39, 46, 53},{ 30, 37, 43, 50},{ 29, 35, 41, 48},
  { 27, 33, 39, 45},{ 26, 31, 37, 43},{ 24, 30, 35, 41},{ 23, 28, 33, 39},
  { 22, 27, 32, 37},{ 21, 26, 30, 35},{ 20, 24, 29, 33},{ 19, 23, 27, 31},
  { 18, 22, 26, 30},{ 17, 21, 25, 28},{ 16, 20, 23, 27},{ 15, 19, 22, 25},
  { 14, 18, 21, 24},{ 14, 17, 20, 23},{ 13, 16, 19, 22},{ 12, 15, 18, 21},
  { 12, 14, 17, 20},{ 11, 14, 16, 19},{ 11, 13, 15, 18},{ 10, 12, 15, 17},
  { 10, 12, 14, 16},{  9, 11, 13, 15},{  9, 11, 12, 14},{  8, 10, 12, 14},
  {  8,  9, 11, 13},{  7,  9, 11, 12},{  7,  9, 10, 12},{  7,  8, 10, 11},
  {  6,  8,  9, 11},{  6,  7,  9, 10},{  6,  7,  8,  9},{  2,  2,  2,  2}
};
static const uint8_t transIdxMPS[64] = {
   1, 2, 3, 4, 5, 6, 7, 8, 9,10,11,12,13,14,15,16,
  17,18,19,20,21,22,23,24,25,26,27,28,29,30,31,32,
  33,34,35,36,37,38,39,40,41,42,43,44,45,46,47,48,
  49,50,51,52,53,54,55,56,57,58,59,60,61,62,62,63
};
static const uint8_t transIdxLPS[64] = {
   0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9,11,11,12,
  13,13,15,15,16,16,18,18,19,19,21,21,22,22,23,24,
  24,25,26,26,27,27,28,29,29,30,30,30,31,32,32,33,
  33,33,34,34,35,35,35,36,36,36,37,37,37,38,38,63
};

/* ---- flat context-group bases (entropy/cabac/engine.py layout) ---- */
enum {
  G_MB_TYPE = 0,          /* 3 x 11 */
  G_B8_TYPE = 33,         /* 2 x 9  */
  G_MV_RES = 51,          /* 2 x 10 */
  G_REF_NO = 71,          /* 2 x 6  */
  G_DELTA_QP = 83,        /* 1 x 4  */
  G_MB_AFF = 87,          /* 1 x 4  */
  G_TRANSFORM_SIZE = 91,  /* 1 x 3  */
  G_IPR = 94,             /* 1 x 2  */
  G_CIPR = 96,            /* 1 x 4  */
  G_CBP = 100,            /* 3 x 4  */
  G_BCBP = 112,           /* 22 x 4 */
  G_MAP = 200,            /* 22 x 15 */
  G_LAST = 530,           /* 22 x 15 */
  G_ONE = 860,            /* 22 x 5 */
  G_ABS = 970             /* 22 x 5 */
};

/* JM internal macroblock modes (decoder/mbtables.py) */
enum { PSKIP=0, P16x16=1, P16x8=2, P8x16=3, P8x8M=8, I4MB=9, I16MB=10,
       IBLOCK=11, I8MB=13, IPCM=14 };
enum { B8_DIRECT=0, B8_8x8=4, B8_8x4=5, B8_4x8=6, B8_4x4=7 };
enum { PD_L0=0, PD_L1=1, PD_BI=2, PD_INTRA=-1 };
enum { LUMA_16DC=0, LUMA_16AC=1, LUMA_8x8=2, LUMA_4x4=5,
       CHROMA_DC=6, CHROMA_AC=7 };
enum { ST_P=0, ST_B=1, ST_I=2 };
#define DC_PRED 2

static const int I16_CBP_TAB[6] = {0, 16, 32, 15, 31, 47};
/* sub_mb_type -> (b8mode, b8pdir) */
static const int SUB_MB_P_MODE[5] = {B8_8x8, B8_8x4, B8_4x8, B8_4x4, IBLOCK};
static const int SUB_MB_P_PDIR[5] = {0, 0, 0, 0, -1};
static const int SUB_MB_B_MODE[14] = {
  B8_DIRECT, B8_8x8, B8_8x8, B8_8x8, B8_8x4, B8_4x8, B8_8x4, B8_4x8,
  B8_8x4, B8_4x8, B8_4x4, B8_4x4, B8_4x4, IBLOCK };
static const int SUB_MB_B_PDIR[14] = {2,0,1,2,0,0,1,1,2,2,0,1,2,-1};
/* B mb_type pdir tables (mbtables.py B_PDIR_*) */
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

#define T2C_BCBP(t)   (p->t2c[0*22 + (t)])
#define T2C_MAP(t)    (p->t2c[1*22 + (t)])
#define T2C_LAST(t)   (p->t2c[2*22 + (t)])
#define T2C_ONE(t)    (p->t2c[3*22 + (t)])
#define T2C_ABS(t)    (p->t2c[4*22 + (t)])
#define T2C_MAXPOS(t) (p->t2c[5*22 + (t)])
#define T2C_C1ISDC(t) (p->t2c[6*22 + (t)])
#define T2C_MAXC2(t)  (p->t2c[7*22 + (t)])

/* ---- arithmetic decoder (spec 9.3.3.2, bit-at-a-time renorm form) ---- */
typedef struct {
  const uint8_t *data;
  long n_bits, pos;
  uint32_t range, offset;
} adec_t;

static inline int get_bit(adec_t *d) {
  long q = d->pos++;
  if (q >= d->n_bits) return 0;  /* legal trailing renorm reads */
  return (d->data[q >> 3] >> (7 - (q & 7))) & 1;
}
static void adec_init(adec_t *d, const uint8_t *data, long n_bits,
                      long start_bit) {
  d->data = data; d->n_bits = n_bits; d->pos = start_bit; d->range = 510;
  uint32_t off = 0;
  for (int i = 0; i < 9; i++) off = (off << 1) | get_bit(d);
  d->offset = off;
}

/* ---- parser state ---- */
typedef struct {
  adec_t d;
  uint8_t *states, *mps;
  /* geometry */
  int W, H, n_mbs, W4, H4;
  /* outputs */
  int32_t *mb_type, *raw_mb_type;
  uint8_t *skip_flag;
  int32_t *cbp;
  int64_t *cbp_bits, *cbp_blk;
  int32_t *qp_arr, *c_ipred_mode, *b8mode, *b8pdir, *i16mode;
  uint8_t *is_intra, *transform8x8;
  int32_t *slice_id_arr;
  int8_t *ipredmode, *ref_idx;
  int32_t *mvd, *luma_levels, *luma8_levels, *luma_dc, *chroma_dc,
          *chroma_levels;
  uint8_t *nnz;
  /* slice params */
  int slice_type, qp, n_ref0, n_ref1, t8_mode, cip, cfi, d8x8, slice_id;
  int last_dquant, allrefzero;
  /* tables */
  const int32_t *p2c_map, *p2c_last, *t2c, *zz4, *zz8;
  /* ipcm spill */
  uint8_t *ipcm_data; int32_t *ipcm_addrs; int ipcm_cap, n_ipcm;
  const uint8_t *rbsp; long rbsp_bits;
} par_t;

static inline int decision(par_t *p, int idx) {
  adec_t *d = &p->d;
  int st = p->states[idx];
  uint32_t rlps = rangeTabLPS[st][(d->range >> 6) & 3];
  d->range -= rlps;
  int bit;
  if (d->offset < d->range) {
    bit = p->mps[idx];
    p->states[idx] = transIdxMPS[st];
  } else {
    d->offset -= d->range;
    d->range = rlps;
    bit = p->mps[idx] ^ 1;
    if (st == 0) p->mps[idx] ^= 1;
    p->states[idx] = transIdxLPS[st];
  }
  while (d->range < 256) {
    d->range <<= 1;
    d->offset = (d->offset << 1) | get_bit(d);
  }
  return bit;
}
static inline int bypass(par_t *p) {
  adec_t *d = &p->d;
  d->offset = (d->offset << 1) | get_bit(d);
  if (d->offset >= d->range) { d->offset -= d->range; return 1; }
  return 0;
}
static inline int terminate_(par_t *p) {
  adec_t *d = &p->d;
  d->range -= 2;
  if (d->offset >= d->range) return 1;
  while (d->range < 256) {
    d->range <<= 1;
    d->offset = (d->offset << 1) | get_bit(d);
  }
  return 0;
}

/* ---- neighbor topology (decoder/state.py; frame coding) ---- */
static inline int mb_avail(par_t *p, int nb, int cur) {
  if (nb < 0 || nb >= p->n_mbs) return 0;
  return p->slice_id_arr[nb] == p->slice_id_arr[cur];
}
static inline int mb_left(par_t *p, int addr) {
  if (addr % p->W == 0) return -1;
  int a = addr - 1;
  return mb_avail(p, a, addr) ? a : -1;
}
static inline int mb_up(par_t *p, int addr) {
  int a = addr - p->W;
  if (a < 0) return -1;
  return mb_avail(p, a, addr) ? a : -1;
}
/* luma 4x4 neighbor of pixel (xp, yp) relative to MB addr.  Returns
 * avail; fills nb_addr, block coords within the nb MB, abs block pos. */
static int luma_nb(par_t *p, int addr, int xp, int yp, int *nb_addr,
                   int *bx, int *by, int *px4, int *py4) {
  int mbx = addr % p->W, mby = addr / p->W;
  int na;
  if (xp < 0 && yp < 0) na = (mbx > 0 && mby > 0) ? addr - p->W - 1 : -1;
  else if (xp < 0) na = (mbx > 0 && yp < 16) ? addr - 1 : -1;
  else if (yp < 0) {
    if (xp < 16) na = mby > 0 ? addr - p->W : -1;
    else na = (mby > 0 && mbx < p->W - 1) ? addr - p->W + 1 : -1;
  } else if (xp < 16 && yp < 16) na = addr;
  else return 0;
  if (na < 0 || !mb_avail(p, na, addr)) return 0;
  int x = xp & 15, y = yp & 15;
  *nb_addr = na;
  *bx = x >> 2; *by = y >> 2;
  *px4 = 4 * (na % p->W) + *bx;
  *py4 = 4 * (na / p->W) + *by;
  return 1;
}
/* chroma 4x4 neighbor for the 8x8 4:2:0 chroma MB */
static int chroma_nb(par_t *p, int addr, int xp, int yp, int *nb_addr,
                     int *bx, int *by) {
  int mbx = addr % p->W, mby = addr / p->W;
  int na;
  if (xp < 0 && yp < 0) na = (mbx > 0 && mby > 0) ? addr - p->W - 1 : -1;
  else if (xp < 0) na = mbx > 0 ? addr - 1 : -1;
  else if (yp < 0) na = mby > 0 ? addr - p->W : -1;
  else if (xp < 8 && yp < 8) na = addr;
  else return 0;
  if (na < 0 || !mb_avail(p, na, addr)) return 0;
  *nb_addr = na;
  *bx = (xp & 7) >> 2; *by = (yp & 7) >> 2;
  return 1;
}

/* ---- small SE readers (duals of cabac_mb.py) ---- */

static int read_mb_skip(par_t *p, int addr) {
  int up = mb_up(p, addr), left = mb_left(p, addr);
  int a = (left >= 0 && !p->skip_flag[left]) ? 1 : 0;
  int b = (up >= 0 && !p->skip_flag[up]) ? 1 : 0;
  int bit;
  if (p->slice_type == ST_B)
    bit = decision(p, G_MB_TYPE + 2 * 11 + 7 + a + b);
  else
    bit = decision(p, G_MB_TYPE + 1 * 11 + a + b);
  if (bit) p->last_dquant = 0;
  return bit;
}

static int read_mb_type_I(par_t *p, int addr) {
  int up = mb_up(p, addr), left = mb_left(p, addr);
  int base = G_MB_TYPE;
  int a = (left >= 0 && p->mb_type[left] != I4MB
           && p->mb_type[left] != I8MB) ? 1 : 0;
  int b = (up >= 0 && p->mb_type[up] != I4MB
           && p->mb_type[up] != I8MB) ? 1 : 0;
  if (!decision(p, base + a + b)) return 0;
  if (terminate_(p)) return 25;  /* IPCM */
  int act = 1;
  act += 12 * decision(p, base + 4);
  if (decision(p, base + 5)) act += decision(p, base + 6) ? 8 : 4;
  act += 2 * decision(p, base + 7);
  act += decision(p, base + 8);
  return act;
}

static int read_mb_type_P(par_t *p) {
  int base = G_MB_TYPE + 11;
  if (decision(p, base + 4)) return decision(p, base + 7) ? 7 : 6;
  if (decision(p, base + 5)) return decision(p, base + 7) ? 2 : 3;
  return decision(p, base + 6) ? 4 : 1;
}

static int read_mb_type_B(par_t *p, int addr) {
  int up = mb_up(p, addr), left = mb_left(p, addr);
  int base = G_MB_TYPE + 2 * 11;
  int a = (left >= 0 && p->mb_type[left] != 0) ? 1 : 0;
  int b = (up >= 0 && p->mb_type[up] != 0) ? 1 : 0;
  if (!decision(p, base + a + b)) return 0;
  int act;
  if (decision(p, base + 4)) {
    if (decision(p, base + 5)) {
      act = 12;
      act += 8 * decision(p, base + 6);
      act += 4 * decision(p, base + 6);
      act += 2 * decision(p, base + 6);
      if (act == 24) act = 11;
      else if (act == 26) act = 22;
      else {
        if (act == 22) act = 23;
        act += decision(p, base + 6);
      }
    } else {
      act = 3;
      act += 4 * decision(p, base + 6);
      act += 2 * decision(p, base + 6);
      act += decision(p, base + 6);
    }
  } else {
    act = decision(p, base + 6) ? 2 : 1;
  }
  return act;
}

static int read_i16_suffix(par_t *p, int act) {
  if (terminate_(p)) return p->slice_type == ST_B ? 48 : 31;  /* IPCM */
  int base = G_MB_TYPE + 11;
  act += 12 * decision(p, base + 8);
  if (decision(p, base + 9)) {
    act += 4;
    if (decision(p, base + 9)) act += 4;
  }
  act += 2 * decision(p, base + 10);
  act += decision(p, base + 10);
  return act;
}

static int read_sub_mb_type(par_t *p) {
  if (p->slice_type != ST_B) {
    int base = G_B8_TYPE;
    if (decision(p, base + 1)) return 0;
    if (decision(p, base + 3)) return decision(p, base + 4) ? 2 : 3;
    return 1;
  }
  int base = G_B8_TYPE + 9;
  if (!decision(p, base + 0)) return 0;  /* direct */
  int act;
  if (decision(p, base + 1)) {
    if (decision(p, base + 2)) {
      if (decision(p, base + 3)) {
        act = 10;
        if (decision(p, base + 3)) act += 1;
      } else {
        act = 6;
        if (decision(p, base + 3)) act += 2;
        if (decision(p, base + 3)) act += 1;
      }
    } else {
      act = 2;
      if (decision(p, base + 3)) act += 2;
      if (decision(p, base + 3)) act += 1;
    }
  } else {
    act = decision(p, base + 3) ? 1 : 0;
  }
  return act + 1;
}

static int read_transform_size(par_t *p, int addr) {
  int up = mb_up(p, addr), left = mb_left(p, addr);
  int a = left >= 0 ? p->transform8x8[left] : 0;
  int b = up >= 0 ? p->transform8x8[up] : 0;
  return decision(p, G_TRANSFORM_SIZE + a + b);
}

static void read_intra_pred_modes(par_t *p, int addr) {
  int base = G_IPR;
  int x4 = 4 * (addr % p->W), y4 = 4 * (addr / p->W);
  int is8 = p->transform8x8[addr];
  int step = is8 ? 2 : 1;
  for (int b8 = 0; b8 < 4; b8++) {
    if (p->b8mode[addr * 4 + b8] != IBLOCK) continue;
    for (int j = 0; j < 2; j += step)
      for (int i = 0; i < 2; i += step) {
        int bx = ((b8 & 1) << 1) + i;
        int by = (b8 & 2) + j;
        int mode_in;
        if (decision(p, base)) mode_in = -1;
        else {
          mode_in = decision(p, base + 1);
          mode_in |= decision(p, base + 1) << 1;
          mode_in |= decision(p, base + 1) << 2;
        }
        int lmb, lbx, lby, lx, ly, umb, ubx, uby, ux, uy;
        int la = luma_nb(p, addr, (bx << 2) - 1, by << 2,
                         &lmb, &lbx, &lby, &lx, &ly);
        int ua = luma_nb(p, addr, bx << 2, (by << 2) - 1,
                         &umb, &ubx, &uby, &ux, &uy);
        if (p->cip) {
          la = la && p->is_intra[lmb];
          ua = ua && p->is_intra[umb];
        }
        int left_m = la ? p->ipredmode[ly * p->W4 + lx] : -1;
        int up_m = ua ? p->ipredmode[uy * p->W4 + ux] : -1;
        int mpm = (left_m < 0 || up_m < 0) ? DC_PRED
                  : (left_m < up_m ? left_m : up_m);
        int mode = mode_in == -1 ? mpm
                   : (mode_in < mpm ? mode_in : mode_in + 1);
        for (int dy = 0; dy < step; dy++)
          for (int dx = 0; dx < step; dx++)
            p->ipredmode[(y4 + by + dy) * p->W4 + x4 + bx + dx] =
                (int8_t)mode;
      }
  }
}

static int read_cipred_mode(par_t *p, int addr) {
  int up = mb_up(p, addr), left = mb_left(p, addr);
  int a = (left >= 0 && p->c_ipred_mode[left] != 0
           && p->mb_type[left] != IPCM) ? 1 : 0;
  int b = (up >= 0 && p->c_ipred_mode[up] != 0
           && p->mb_type[up] != IPCM) ? 1 : 0;
  int base = G_CIPR;
  if (!decision(p, base + a + b)) return 0;
  if (!decision(p, base + 3)) return 1;
  return decision(p, base + 3) ? 3 : 2;
}

static int read_cbp(par_t *p, int addr) {
  int base = G_CBP;
  int up = mb_up(p, addr), left = mb_left(p, addr);
  int cbp = 0;
  for (int mb_y = 0; mb_y < 4; mb_y += 2) {
    for (int mb_x = 0; mb_x < 4; mb_x += 2) {
      int a, b;
      if (mb_y == 0) {
        if (up < 0 || p->mb_type[up] == IPCM) b = 0;
        else b = (p->cbp[up] & (1 << (2 + mb_x / 2))) ? 0 : 1;
      } else {
        b = (cbp & (1 << (mb_x / 2))) ? 0 : 1;
      }
      if (mb_x == 0) {
        int lmb, lbx, lby, lx, ly;
        int la = luma_nb(p, addr, -1, mb_y << 2, &lmb, &lbx, &lby, &lx, &ly);
        if (la) {
          if (p->mb_type[lmb] == IPCM) a = 0;
          else a = (p->cbp[lmb] & (1 << (2 * (lby / 2) + 1))) ? 0 : 1;
        } else a = 0;
      } else {
        a = (cbp & (1 << mb_y)) ? 0 : 1;
      }
      if (decision(p, base + a + 2 * b)) cbp += 1 << (mb_y + mb_x / 2);
    }
  }
  if (p->cfi == 1) {
    int b = (up >= 0 && (p->mb_type[up] == IPCM || p->cbp[up] > 15)) ? 1 : 0;
    int a = (left >= 0 && (p->mb_type[left] == IPCM || p->cbp[left] > 15))
            ? 1 : 0;
    if (decision(p, G_CBP + 4 + a + 2 * b)) {
      b = (up >= 0 && (p->mb_type[up] == IPCM
           || (p->cbp[up] > 15 && (p->cbp[up] >> 4) == 2))) ? 1 : 0;
      a = (left >= 0 && (p->mb_type[left] == IPCM
           || (p->cbp[left] > 15 && (p->cbp[left] >> 4) == 2))) ? 1 : 0;
      cbp += decision(p, G_CBP + 8 + a + 2 * b) ? 32 : 16;
    }
  }
  if (cbp == 0) p->last_dquant = 0;
  return cbp;
}

static int read_dquant(par_t *p) {
  int base = G_DELTA_QP;
  int act_ctx = p->last_dquant != 0 ? 1 : 0;
  int act_sym;
  if (!decision(p, base + act_ctx)) act_sym = 0;
  else if (!decision(p, base + 2)) act_sym = 1;
  else {
    act_sym = 1;
    while (decision(p, base + 3) && act_sym < 128) act_sym++;
    act_sym += 1;
  }
  int dq = (act_sym + 1) / 2;
  if ((act_sym & 1) == 0) dq = -dq;
  p->last_dquant = dq;
  return dq;
}

static int exp_golomb_bypass(par_t *p, int k) {
  int symbol = 0;
  while (bypass(p) && k < 30) { symbol += 1 << k; k++; }
  int binary = 0;
  while (k) { k--; if (bypass(p)) binary |= 1 << k; }
  return symbol + binary;
}

static int unary_exp_golomb_mv(par_t *p, int base, int max_bin) {
  if (!decision(p, base)) return 0;
  int symbol = 0, k = 1, bin = 1, offset = 1, l = 0;
  for (;;) {
    l = decision(p, base + offset);
    bin++;
    if (bin == 2) offset++;
    if (bin == max_bin) offset++;
    symbol++;
    k++;
    if (l == 0 || k == 8) break;  /* exp_start = 8 */
  }
  if (l != 0) symbol += exp_golomb_bypass(p, 3) + 1;
  return symbol;
}

static int unary_exp_golomb_level(par_t *p, int idx) {
  if (!decision(p, idx)) return 0;
  int symbol = 0, k = 1, l = 0;
  for (;;) {
    l = decision(p, idx);
    symbol++;
    k++;
    if (l == 0 || k == 13) break;  /* exp_start = 13 */
  }
  if (l != 0) symbol += exp_golomb_bypass(p, 0) + 1;
  return symbol;
}

static int read_ref_idx(par_t *p, int addr, int lst, int bx, int by) {
  int lmb, lbx, lby, lx, ly, umb, ubx, uby, ux, uy;
  int la = luma_nb(p, addr, (bx << 2) - 1, by << 2, &lmb, &lbx, &lby,
                   &lx, &ly);
  int ua = luma_nb(p, addr, bx << 2, (by << 2) - 1, &umb, &ubx, &uby,
                   &ux, &uy);
  long plane = (long)p->H4 * p->W4;
  int a = 0, b = 0;
  if (la) {
    int b8 = (lbx / 2) % 2 + 2 * ((lby / 2) % 2);
    if (p->mb_type[lmb] != IPCM
        && !(p->slice_type == ST_B && p->mb_type[lmb] == 0
             && !p->is_intra[lmb])
        && !(p->b8mode[lmb * 4 + b8] == 0 && p->b8pdir[lmb * 4 + b8] == 2))
      a = p->ref_idx[lst * plane + (long)ly * p->W4 + lx] > 0 ? 1 : 0;
  }
  if (ua) {
    int b8 = (ubx / 2) % 2 + 2 * ((uby / 2) % 2);
    if (p->mb_type[umb] != IPCM
        && !(p->slice_type == ST_B && p->mb_type[umb] == 0
             && !p->is_intra[umb])
        && !(p->b8mode[umb * 4 + b8] == 0 && p->b8pdir[umb * 4 + b8] == 2))
      b = p->ref_idx[lst * plane + (long)uy * p->W4 + ux] > 0 ? 1 : 0;
  }
  int base = G_REF_NO;
  if (!decision(p, base + a + 2 * b)) return 0;
  if (!decision(p, base + 4)) return 1;
  int k = 2;
  while (decision(p, base + 5) && k < 64) k++;
  return k;
}

static int read_mvd(par_t *p, int addr, int lst, int bx, int by, int comp) {
  int lmb, lbx, lby, lx, ly, umb, ubx, uby, ux, uy;
  int la = luma_nb(p, addr, (bx << 2) - 1, by << 2, &lmb, &lbx, &lby,
                   &lx, &ly);
  int ua = luma_nb(p, addr, bx << 2, (by << 2) - 1, &umb, &ubx, &uby,
                   &ux, &uy);
  long plane = (long)p->H4 * p->W4;
  int a_val = 0, b_val = 0;
  if (la) {
    int ox = 4 * (lmb % p->W), oy = 4 * (lmb / p->W);
    int v = p->mvd[((lst * plane + (long)(oy + lby) * p->W4 + ox + lbx) << 1)
                   + comp];
    a_val = v < 0 ? -v : v;
  }
  if (ua) {
    int ox = 4 * (umb % p->W), oy = 4 * (umb / p->W);
    int v = p->mvd[((lst * plane + (long)(oy + uby) * p->W4 + ox + ubx) << 1)
                   + comp];
    b_val = v < 0 ? -v : v;
  }
  int err = a_val + b_val;
  int act_ctx = err < 3 ? 5 * comp : (err > 32 ? 5 * comp + 3 : 5 * comp + 2);
  if (!decision(p, G_MV_RES + act_ctx)) return 0;
  int val = unary_exp_golomb_mv(p, G_MV_RES + 10 + 5 * comp, 3) + 1;
  if (bypass(p)) val = -val;
  return val;
}

/* ---- coded_block_flag with the cbp_bits bitmap (cabac_mb.py) ---- */
static int read_cbf(par_t *p, int addr, int btype, int is_v, int bx, int by) {
  int is_luma = (btype == LUMA_16DC || btype == LUMA_16AC
                 || btype == LUMA_8x8 || btype == LUMA_4x4);
  int is_dc = (btype == LUMA_16DC || btype == CHROMA_DC);
  int default_bit = p->is_intra[addr] ? 1 : 0;
  int i = is_dc ? 0 : bx, j = is_dc ? 0 : by;
  int la, ua, lmb = -1, lbx = 0, lby = 0, umb = -1, ubx = 0, uby = 0;
  int dx, dy;  /* scratch */
  if (is_luma) {
    la = luma_nb(p, addr, (i << 2) - 1, j << 2, &lmb, &lbx, &lby, &dx, &dy);
    ua = luma_nb(p, addr, i << 2, (j << 2) - 1, &umb, &ubx, &uby, &dx, &dy);
  } else {
    la = chroma_nb(p, addr, (i << 2) - 1, j << 2, &lmb, &lbx, &lby);
    ua = chroma_nb(p, addr, i << 2, (j << 2) - 1, &umb, &ubx, &uby);
  }
  int bit_a, bit_b;
  if (btype == LUMA_16DC) { bit_a = bit_b = 0; }
  else if (btype == CHROMA_DC) { bit_a = bit_b = 17 + is_v; }
  else if (btype == CHROMA_AC) {
    bit_a = (is_v ? 35 : 19) + (la ? 4 * lby + lbx : 0);
    bit_b = (is_v ? 35 : 19) + (ua ? 4 * uby + ubx : 0);
  } else {
    bit_a = 1 + (la ? 4 * lby + lbx : 0);
    bit_b = 1 + (ua ? 4 * uby + ubx : 0);
  }
  int cbf;
  if (btype == LUMA_8x8) {
    cbf = 1;  /* coded_block_flag not sent for luma 8x8 (4:2:0 streams) */
  } else {
    int upper = default_bit, left = default_bit;
    if (ua)
      upper = p->mb_type[umb] == IPCM ? 1
              : (int)((p->cbp_bits[umb] >> bit_b) & 1);
    if (la)
      left = p->mb_type[lmb] == IPCM ? 1
             : (int)((p->cbp_bits[lmb] >> bit_a) & 1);
    int ctx2 = 2 * upper + left;
    cbf = decision(p, G_BCBP + T2C_BCBP(btype) * 4 + ctx2);
  }
  if (cbf) {
    int bit;
    if (btype == LUMA_16DC) bit = 0;
    else if (btype == CHROMA_DC) bit = 17 + is_v;
    else if (btype == CHROMA_AC) bit = (is_v ? 35 : 19) + 4 * by + bx;
    else bit = 1 + 4 * by + bx;
    uint64_t mask = 1ull << bit;
    if (btype == LUMA_8x8)
      mask |= (1ull << (bit + 1)) | (1ull << (bit + 4)) | (1ull << (bit + 5));
    p->cbp_bits[addr] |= (int64_t)mask;
  }
  return cbf;
}

/* residual block: cbf + significance map + levels; levels out in scan
 * order (length maxpos); returns count of nonzeros or -1 if cbf==0 */
static int read_block(par_t *p, int addr, int btype, int is_v, int bx,
                      int by, int *coeff) {
  if (!read_cbf(p, addr, btype, is_v, bx, by)) return -1;
  int maxpos = T2C_MAXPOS(btype);
  memset(coeff, 0, sizeof(int) * maxpos);
  const int32_t *map = p->p2c_map + T2C_MAP(btype) * 0;  /* see below */
  (void)map;
  int t = btype;
  const int32_t *m_row = p->p2c_map + (long)t * 64;
  const int32_t *l_row = p->p2c_last + (long)t * 64;
  int base_m = G_MAP + T2C_MAP(t) * 15;
  int base_l = G_LAST + T2C_LAST(t) * 15;
  int c1isdc = T2C_C1ISDC(t);
  int shift = c1isdc ? 0 : -1;
  int i0 = c1isdc ? 0 : 1;
  int i1 = c1isdc ? maxpos - 1 : maxpos;
  int i = i0, last_seen = 0;
  while (i < i1) {
    if (decision(p, base_m + m_row[i])) {
      coeff[i + shift] = 1;
      if (decision(p, base_l + l_row[i])) { last_seen = 1; break; }
    }
    i++;
  }
  if (!last_seen) coeff[i1 + shift] = 1;
  int base_o = G_ONE + T2C_ONE(t) * 5;
  int base_a = G_ABS + T2C_ABS(t) * 5;
  int c1 = 1, c2 = 0, mc2 = T2C_MAXC2(t), nz = 0;
  for (int idx = maxpos - 1; idx >= 0; idx--) {
    if (coeff[idx]) {
      int ctx = c1 < 4 ? c1 : 4;
      coeff[idx] += decision(p, base_o + ctx);
      if (coeff[idx] == 2) {
        ctx = c2 < mc2 ? c2 : mc2;
        coeff[idx] += unary_exp_golomb_level(p, base_a + ctx);
        c1 = 0;
        c2++;
      } else if (c1) c1++;
      if (bypass(p)) coeff[idx] = -coeff[idx];
      nz++;
    }
  }
  return nz;
}

static void read_residuals(par_t *p, int addr) {
  int cbp = p->cbp[addr];
  int mbt = p->mb_type[addr];
  int x4o = 4 * (addr % p->W), y4o = 4 * (addr / p->W);
  int coeff[64];
  if (mbt == I16MB) {
    int n = read_block(p, addr, LUMA_16DC, 0, 0, 0, coeff);
    if (n >= 0) {
      for (int k = 0; k < 16; k++)
        if (coeff[k]) {
          p->luma_dc[addr * 16 + p->zz4[k]] = coeff[k];
          p->cbp_blk[addr] |= 1;
        }
    }
  }
  if (cbp & 15) {
    int t8 = p->transform8x8[addr];
    for (int b8 = 0; b8 < 4; b8++) {
      if (!(cbp & (1 << b8))) continue;
      if (t8) {
        int n = read_block(p, addr, LUMA_8x8, 0, (b8 & 1) * 2,
                           (b8 >> 1) * 2, coeff);
        if (n < 0) continue;
        int nz = 0;
        for (int k = 0; k < 64; k++)
          if (coeff[k]) {
            p->luma8_levels[addr * 256 + b8 * 64 + p->zz8[k]] = coeff[k];
            nz++;
          }
        if (nz) {
          p->cbp_blk[addr] |= 51ll << (4 * b8 - 2 * (b8 & 1));
          int bx8 = (b8 & 1) * 2, by8 = (b8 >> 1) * 2;
          for (int dy = 0; dy < 2; dy++)
            for (int dx = 0; dx < 2; dx++)
              p->nnz[(long)(y4o + by8 + dy) * p->W4 + x4o + bx8 + dx] =
                  (uint8_t)nz;
        }
      } else {
        int btype = mbt == I16MB ? LUMA_16AC : LUMA_4x4;
        int off = btype == LUMA_16AC ? 1 : 0;
        for (int b4 = 0; b4 < 4; b4++) {
          int blk = b8 * 4 + b4;
          static const int BLK4_X[16] = {0,1,0,1,2,3,2,3,0,1,0,1,2,3,2,3};
          static const int BLK4_Y[16] = {0,0,1,1,0,0,1,1,2,2,3,3,2,2,3,3};
          int bx = BLK4_X[blk], by = BLK4_Y[blk];
          int n = read_block(p, addr, btype, 0, bx, by, coeff);
          if (n < 0) continue;
          int nz = 0;
          int maxpos = T2C_MAXPOS(btype);
          for (int k = 0; k < maxpos; k++)
            if (coeff[k]) {
              p->luma_levels[addr * 256 + blk * 16 + p->zz4[k + off]] =
                  coeff[k];
              nz++;
            }
          if (nz) {
            p->cbp_blk[addr] |= 1ll << (4 * by + bx);
            p->nnz[(long)(y4o + by) * p->W4 + x4o + bx] = (uint8_t)nz;
          }
        }
      }
    }
  }
  if (p->cfi == 1) {
    if (cbp > 15) {
      for (int uv = 0; uv < 2; uv++) {
        int n = read_block(p, addr, CHROMA_DC, uv, 0, 0, coeff);
        if (n >= 0)
          for (int k = 0; k < 4; k++)
            if (coeff[k]) p->chroma_dc[addr * 8 + uv * 4 + k] = coeff[k];
      }
    }
    if (cbp > 31) {
      for (int uv = 0; uv < 2; uv++)
        for (int blk = 0; blk < 4; blk++) {
          int bx = blk & 1, by = blk >> 1;
          int n = read_block(p, addr, CHROMA_AC, uv, bx, by, coeff);
          if (n < 0) continue;
          for (int k = 0; k < 15; k++)
            if (coeff[k])
              p->chroma_levels[addr * 128 + uv * 64 + blk * 16
                               + p->zz4[k + 1]] = coeff[k];
        }
    }
  }
}

/* ---- motion info (ref idx + MVDs per partition) ---- */
static void read_motion_info(par_t *p, int addr) {
  int mbt = p->mb_type[addr];
  int x4 = 4 * (addr % p->W), y4 = 4 * (addr / p->W);
  int bframe = p->slice_type == ST_B;
  long plane = (long)p->H4 * p->W4;
  /* partitions: (bx, by, w, h, b8) */
  int parts[4][5];
  int n_parts;
  if (mbt == P16x16) {
    n_parts = 1;
    int t[5] = {0, 0, 4, 4, 0}; memcpy(parts[0], t, sizeof t);
  } else if (mbt == P16x8) {
    n_parts = 2;
    int t0[5] = {0, 0, 4, 2, 0}, t1[5] = {0, 2, 4, 2, 2};
    memcpy(parts[0], t0, sizeof t0); memcpy(parts[1], t1, sizeof t1);
  } else if (mbt == P8x16) {
    n_parts = 2;
    int t0[5] = {0, 0, 2, 4, 0}, t1[5] = {2, 0, 2, 4, 1};
    memcpy(parts[0], t0, sizeof t0); memcpy(parts[1], t1, sizeof t1);
  } else {  /* P8x8 */
    n_parts = 4;
    for (int b8 = 0; b8 < 4; b8++) {
      int t[5] = {(b8 & 1) * 2, (b8 >> 1) * 2, 2, 2, b8};
      memcpy(parts[b8], t, sizeof t);
    }
  }
  /* reference indices: list0 then list1 */
  for (int lst = 0; lst < 2; lst++) {
    int n_active = lst == 0 ? p->n_ref0 : p->n_ref1;
    for (int k = 0; k < n_parts; k++) {
      int bx = parts[k][0], by = parts[k][1], w = parts[k][2],
          h = parts[k][3], b8 = parts[k][4];
      int b8m = p->b8mode[addr * 4 + b8];
      int pdir = p->b8pdir[addr * 4 + b8];
      if (mbt == P8x8M && b8m == B8_DIRECT) continue;
      if (b8m == IBLOCK) continue;
      if (pdir != lst && pdir != PD_BI) continue;
      if (lst == 1 && !bframe) continue;
      int ref = 0;
      if (n_active > 1 && !(mbt == P8x8M && p->allrefzero))
        ref = read_ref_idx(p, addr, lst, bx, by);
      for (int dy = 0; dy < h; dy++)
        for (int dx = 0; dx < w; dx++)
          p->ref_idx[lst * plane + (long)(y4 + by + dy) * p->W4
                     + x4 + bx + dx] = (int8_t)ref;
    }
  }
  /* MVDs: list0 then list1, per sub-partition */
  for (int lst = 0; lst < 2; lst++) {
    for (int k = 0; k < n_parts; k++) {
      int bx = parts[k][0], by = parts[k][1], w = parts[k][2],
          h = parts[k][3], b8 = parts[k][4];
      int b8m = p->b8mode[addr * 4 + b8];
      int pdir = p->b8pdir[addr * 4 + b8];
      if (b8m == IBLOCK || (mbt == P8x8M && b8m == B8_DIRECT)) continue;
      if (pdir != lst && pdir != PD_BI) continue;
      if (lst == 1 && !bframe) continue;
      int sw = w, sh = h, nsub = 1;
      int subs[4][2];
      if (mbt == P8x8M) {
        switch (b8m) {
          case B8_8x8: sw = 2; sh = 2; break;
          case B8_8x4: sw = 2; sh = 1; break;
          case B8_4x8: sw = 1; sh = 2; break;
          default:     sw = 1; sh = 1; break;  /* B8_4x4 */
        }
        nsub = 0;
        for (int dy = 0; dy < 2; dy += sh)
          for (int dx = 0; dx < 2; dx += sw) {
            subs[nsub][0] = bx + dx; subs[nsub][1] = by + dy; nsub++;
          }
      } else {
        subs[0][0] = bx; subs[0][1] = by;
      }
      for (int s = 0; s < nsub; s++) {
        int sx = subs[s][0], sy = subs[s][1];
        int mvd0 = read_mvd(p, addr, lst, sx, sy, 0);
        int mvd1 = read_mvd(p, addr, lst, sx, sy, 1);
        for (int dy = 0; dy < sh; dy++)
          for (int dx = 0; dx < sw; dx++) {
            long o = (lst * plane + (long)(y4 + sy + dy) * p->W4
                      + x4 + sx + dx) << 1;
            p->mvd[o] = mvd0;
            p->mvd[o + 1] = mvd1;
          }
      }
    }
  }
}

static int no_part_less_than_8x8(par_t *p, int addr) {
  int mbt = p->mb_type[addr];
  if (mbt == P16x16 || mbt == P16x8 || mbt == P8x16) return 1;
  if (mbt == 0 && p->slice_type == ST_B) return p->d8x8;
  if (mbt == P8x8M) {
    for (int b = 0; b < 4; b++) {
      int m = p->b8mode[addr * 4 + b];
      if (!((m == B8_DIRECT && p->d8x8) || m == B8_8x8)) return 0;
    }
    return 1;
  }
  return 0;
}

static int read_ipcm(par_t *p, int addr) {
  /* byte-align, copy raw samples, restart the arithmetic engine */
  long pos = (p->d.pos + 7) & ~7l;
  if (p->n_ipcm >= p->ipcm_cap) return -1;
  long need = 256 + (p->cfi == 1 ? 128 : 0);
  if (pos + 8 * need > p->rbsp_bits + 64) return -1;  /* truncated */
  uint8_t *dst = p->ipcm_data + (long)p->n_ipcm * 384;
  const uint8_t *src = p->rbsp + pos / 8;
  memcpy(dst, src, need);
  p->ipcm_addrs[p->n_ipcm++] = addr;
  pos += 8 * need;
  p->qp_arr[addr] = p->qp;
  int x4 = 4 * (addr % p->W), y4 = 4 * (addr / p->W);
  long plane = (long)p->H4 * p->W4;
  for (int pl = 0; pl < 3; pl++)
    for (int dy = 0; dy < 4; dy++)
      for (int dx = 0; dx < 4; dx++)
        p->nnz[pl * plane + (long)(y4 + dy) * p->W4 + x4 + dx] = 16;
  p->last_dquant = 0;
  adec_init(&p->d, p->rbsp, p->rbsp_bits, pos);
  return 0;
}

/* ---- macroblock orchestration ---- */
static int read_mb(par_t *p, int addr) {
  int x4 = 4 * (addr % p->W), y4 = 4 * (addr / p->W);
  for (int dy = 0; dy < 4; dy++)
    for (int dx = 0; dx < 4; dx++)
      p->ipredmode[(long)(y4 + dy) * p->W4 + x4 + dx] = DC_PRED;
  int raw;
  int stype = p->slice_type;
  if (stype == ST_I) {
    raw = read_mb_type_I(p, addr);
    /* interpret_I */
    if (raw == 0) {
      p->mb_type[addr] = I4MB;
      for (int b = 0; b < 4; b++) {
        p->b8mode[addr * 4 + b] = IBLOCK;
        p->b8pdir[addr * 4 + b] = -1;
      }
    } else if (raw == 25) {
      p->mb_type[addr] = IPCM;
      p->cbp[addr] = 0;
      p->i16mode[addr] = 0;
      for (int b = 0; b < 4; b++) {
        p->b8mode[addr * 4 + b] = 0;
        p->b8pdir[addr * 4 + b] = -1;
      }
    } else {
      p->mb_type[addr] = I16MB;
      for (int b = 0; b < 4; b++) {
        p->b8mode[addr * 4 + b] = 0;
        p->b8pdir[addr * 4 + b] = -1;
      }
    }
  } else if (stype == ST_B) {
    raw = read_mb_type_B(p, addr);
    if (raw > 23) raw = read_i16_suffix(p, raw);
    /* interpret_B */
    if (raw == 0) {
      p->mb_type[addr] = 0;
      for (int b = 0; b < 4; b++) {
        p->b8mode[addr * 4 + b] = B8_DIRECT;
        p->b8pdir[addr * 4 + b] = PD_BI;
      }
    } else if (raw == 23) {
      p->mb_type[addr] = I4MB;
      for (int b = 0; b < 4; b++) {
        p->b8mode[addr * 4 + b] = IBLOCK;
        p->b8pdir[addr * 4 + b] = -1;
      }
    } else if (raw > 23 && raw < 48) {
      p->mb_type[addr] = I16MB;
      for (int b = 0; b < 4; b++) {
        p->b8mode[addr * 4 + b] = 0;
        p->b8pdir[addr * 4 + b] = -1;
      }
    } else if (raw == 22) {
      p->mb_type[addr] = P8x8M;
    } else if (raw < 4) {
      p->mb_type[addr] = P16x16;
      for (int b = 0; b < 4; b++) {
        p->b8mode[addr * 4 + b] = 1;
        p->b8pdir[addr * 4 + b] = B_PDIR_16x16[raw];
      }
    } else if (raw == 48) {
      p->mb_type[addr] = IPCM;
      for (int b = 0; b < 4; b++) {
        p->b8mode[addr * 4 + b] = 0;
        p->b8pdir[addr * 4 + b] = -1;
      }
    } else if ((raw & 1) == 0) {  /* 16x8 */
      int p0, p1;
      if (!b_pdir_16x8(raw, &p0, &p1)) return -1;
      p->mb_type[addr] = P16x8;
      p->b8mode[addr*4+0] = p->b8mode[addr*4+1] =
      p->b8mode[addr*4+2] = p->b8mode[addr*4+3] = 2;
      p->b8pdir[addr*4+0] = p->b8pdir[addr*4+1] = p0;
      p->b8pdir[addr*4+2] = p->b8pdir[addr*4+3] = p1;
    } else {  /* 8x16 */
      int p0, p1;
      if (!b_pdir_8x16(raw, &p0, &p1)) return -1;
      p->mb_type[addr] = P8x16;
      p->b8mode[addr*4+0] = p->b8mode[addr*4+1] =
      p->b8mode[addr*4+2] = p->b8mode[addr*4+3] = 3;
      p->b8pdir[addr*4+0] = p->b8pdir[addr*4+2] = p0;
      p->b8pdir[addr*4+1] = p->b8pdir[addr*4+3] = p1;
    }
  } else {  /* P */
    raw = read_mb_type_P(p);
    if (raw == 7) raw = read_i16_suffix(p, raw);
    /* interpret_P */
    if (raw < 4) {
      p->mb_type[addr] = raw;
      for (int b = 0; b < 4; b++) {
        p->b8mode[addr * 4 + b] = raw;
        p->b8pdir[addr * 4 + b] = 0;
      }
    } else if (raw == 4 || raw == 5) {
      p->mb_type[addr] = P8x8M;
      p->allrefzero = raw == 5;
    } else if (raw == 6) {
      p->mb_type[addr] = I4MB;
      for (int b = 0; b < 4; b++) {
        p->b8mode[addr * 4 + b] = IBLOCK;
        p->b8pdir[addr * 4 + b] = -1;
      }
    } else if (raw == 31) {
      p->mb_type[addr] = IPCM;
      for (int b = 0; b < 4; b++) {
        p->b8mode[addr * 4 + b] = 0;
        p->b8pdir[addr * 4 + b] = -1;
      }
    } else {
      p->mb_type[addr] = I16MB;
      for (int b = 0; b < 4; b++) {
        p->b8mode[addr * 4 + b] = 0;
        p->b8pdir[addr * 4 + b] = -1;
      }
    }
  }
  p->raw_mb_type[addr] = raw;
  int mbt = p->mb_type[addr];
  p->is_intra[addr] = (mbt == I4MB || mbt == I16MB || mbt == I8MB
                       || mbt == IPCM) ? 1 : 0;

  if (mbt == IPCM) return read_ipcm(p, addr);

  if (mbt == P8x8M) {
    for (int b8 = 0; b8 < 4; b8++) {
      int v = read_sub_mb_type(p);
      if (stype == ST_B) {
        if (v > 13) return -1;
        p->b8mode[addr * 4 + b8] = SUB_MB_B_MODE[v];
        p->b8pdir[addr * 4 + b8] = SUB_MB_B_PDIR[v];
      } else {
        if (v > 4) return -1;
        p->b8mode[addr * 4 + b8] = SUB_MB_P_MODE[v];
        p->b8pdir[addr * 4 + b8] = SUB_MB_P_PDIR[v];
      }
    }
  }

  if (mbt == I4MB && p->t8_mode) {
    if (read_transform_size(p, addr)) {
      p->transform8x8[addr] = 1;
      p->mb_type[addr] = I8MB;
      mbt = I8MB;
    }
  }

  if (mbt == I4MB || mbt == I8MB) read_intra_pred_modes(p, addr);
  if (p->is_intra[addr] && p->cfi == 1)
    p->c_ipred_mode[addr] = read_cipred_mode(p, addr);

  if (!p->is_intra[addr] && mbt != 0) read_motion_info(p, addr);

  if (mbt == I16MB) {
    int off = stype == ST_I ? 1 : (stype == ST_B ? 24 : 7);
    p->cbp[addr] = I16_CBP_TAB[(raw - off) >> 2];
    p->i16mode[addr] = (raw - off) & 3;
  } else {
    p->cbp[addr] = read_cbp(p, addr);
  }
  int cbp = p->cbp[addr];

  if (mbt != I4MB && mbt != I8MB && mbt != I16MB && (cbp & 15)
      && p->t8_mode && no_part_less_than_8x8(p, addr))
    p->transform8x8[addr] = read_transform_size(p, addr);

  if (cbp != 0 || mbt == I16MB) {
    int dq = read_dquant(p);
    p->qp = (p->qp + dq + 52) % 52;
  }
  p->qp_arr[addr] = p->qp;

  read_residuals(p, addr);
  return 0;
}

static void setup_skip_mb(par_t *p, int addr) {
  p->skip_flag[addr] = 1;
  p->raw_mb_type[addr] = -2;
  p->qp_arr[addr] = p->qp;
  if (p->slice_type == ST_B) {
    p->mb_type[addr] = 0;  /* BSKIP_DIRECT */
    for (int b = 0; b < 4; b++) {
      p->b8mode[addr * 4 + b] = B8_DIRECT;
      p->b8pdir[addr * 4 + b] = PD_BI;
    }
  } else {
    p->mb_type[addr] = PSKIP;
    for (int b = 0; b < 4; b++) {
      p->b8mode[addr * 4 + b] = 0;
      p->b8pdir[addr * 4 + b] = PD_L0;
    }
  }
  int x4 = 4 * (addr % p->W), y4 = 4 * (addr / p->W);
  for (int dy = 0; dy < 4; dy++)
    for (int dx = 0; dx < 4; dx++)
      p->ipredmode[(long)(y4 + dy) * p->W4 + x4 + dx] = DC_PRED;
}

/* ---- entry point ---- */
long cabac_parse_slice(
    int W, int H,
    int32_t *mb_type, int32_t *raw_mb_type, uint8_t *skip_flag,
    int32_t *cbp, int64_t *cbp_bits, int64_t *cbp_blk,
    int32_t *qp_arr, int32_t *c_ipred_mode, int32_t *b8mode,
    int32_t *b8pdir, int32_t *i16mode, uint8_t *is_intra,
    uint8_t *transform8x8, int32_t *slice_id_arr, int8_t *ipredmode,
    int8_t *ref_idx, int32_t *mvd, int32_t *luma_levels,
    int32_t *luma8_levels, int32_t *luma_dc, int32_t *chroma_dc,
    int32_t *chroma_levels, uint8_t *nnz,
    int slice_type, int init_qp, int n_ref0, int n_ref1, int t8_mode,
    int constrained_intra, int cfi, int d8x8_inference, int first_mb,
    int slice_id, const int32_t *next_addr,
    const uint8_t *rbsp, long rbsp_bits, long start_bit,
    const int32_t *p2c_map, const int32_t *p2c_last, const int32_t *t2c,
    const int32_t *zz4, const int32_t *zz8,
    uint8_t *states, uint8_t *mps,
    uint8_t *ipcm_data, int32_t *ipcm_addrs, int ipcm_cap,
    int32_t *n_ipcm_out) {
  par_t P;
  memset(&P, 0, sizeof P);
  par_t *p = &P;
  p->W = W; p->H = H; p->n_mbs = W * H; p->W4 = 4 * W; p->H4 = 4 * H;
  p->mb_type = mb_type; p->raw_mb_type = raw_mb_type;
  p->skip_flag = skip_flag; p->cbp = cbp; p->cbp_bits = cbp_bits;
  p->cbp_blk = cbp_blk; p->qp_arr = qp_arr;
  p->c_ipred_mode = c_ipred_mode; p->b8mode = b8mode; p->b8pdir = b8pdir;
  p->i16mode = i16mode; p->is_intra = is_intra;
  p->transform8x8 = transform8x8; p->slice_id_arr = slice_id_arr;
  p->ipredmode = ipredmode; p->ref_idx = ref_idx; p->mvd = mvd;
  p->luma_levels = luma_levels; p->luma8_levels = luma8_levels;
  p->luma_dc = luma_dc; p->chroma_dc = chroma_dc;
  p->chroma_levels = chroma_levels; p->nnz = nnz;
  p->slice_type = slice_type; p->qp = init_qp;
  p->n_ref0 = n_ref0; p->n_ref1 = n_ref1; p->t8_mode = t8_mode;
  p->cip = constrained_intra; p->cfi = cfi; p->d8x8 = d8x8_inference;
  p->slice_id = slice_id;
  p->last_dquant = 0; p->allrefzero = 0;
  p->p2c_map = p2c_map; p->p2c_last = p2c_last; p->t2c = t2c;
  p->zz4 = zz4; p->zz8 = zz8;
  p->ipcm_data = ipcm_data; p->ipcm_addrs = ipcm_addrs;
  p->ipcm_cap = ipcm_cap; p->n_ipcm = 0;
  p->rbsp = rbsp; p->rbsp_bits = rbsp_bits;
  p->states = states; p->mps = mps;
  adec_init(&p->d, rbsp, rbsp_bits, start_bit);

  int addr = first_mb;
  long parsed = 0;
  int is_pb = slice_type == ST_P || slice_type == ST_B;
  for (;;) {
    if (addr < 0 || addr >= p->n_mbs) break;
    slice_id_arr[addr] = slice_id;
    qp_arr[addr] = p->qp;
    int skipped = is_pb ? read_mb_skip(p, addr) : 0;
    if (skipped) setup_skip_mb(p, addr);
    else if (read_mb(p, addr) < 0) return -1;
    parsed++;
    if (terminate_(p)) break;  /* end_of_slice_flag */
    addr = next_addr ? next_addr[addr] : addr + 1;
    if (parsed > p->n_mbs) return -1;  /* corrupt stream guard */
  }
  *n_ipcm_out = p->n_ipcm;
  return parsed;
}
