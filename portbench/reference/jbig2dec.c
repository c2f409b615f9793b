/* A JBIG2 generic-region decoder (ITU-T T.88), written for the
 * benchmark's judge: it reads the mask streams of a written PDF back to
 * pixels without any code of the program under test.
 *
 * It takes a PDF-embedded segment stream (no file header): page
 * information segments (type 48), immediate generic regions (types 38
 * and 39; arithmetic coding, GBTEMPLATE 0 with any AT pixels, with or
 * without TPGDON) OR-ed onto the page, and end-of-page / end-of-stripe /
 * end-of-file segments.  Anything else is refused with a negative code.
 *
 * Build: cc -O2 -shared -fPIC -o libpbjbig2.so jbig2dec.c
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* Annex E, Table E.1: Qe, NMPS, NLPS, SWITCH */
static const uint16_t QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
    0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
    0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
    0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
    0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
static const uint8_t NMPS[47] = {
    1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
static const uint8_t NLPS[47] = {
    1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14,
    15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
    30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
static const uint8_t SWITCH[47] = {
    1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

typedef struct {
  const uint8_t *buf;
  long n, bp;
  uint32_t c, a;
  int ct;
} Mq;

static uint8_t byte_at(const Mq *d, long i) {
  return i < d->n ? d->buf[i] : 0xFF;
}

static void bytein(Mq *d) {
  if (byte_at(d, d->bp) == 0xFF) {
    if (byte_at(d, d->bp + 1) > 0x8F) {
      d->c += 0xFF00;
      d->ct = 8;
    } else {
      d->bp++;
      d->c += (uint32_t)byte_at(d, d->bp) << 9;
      d->ct = 7;
    }
  } else {
    d->bp++;
    d->c += (uint32_t)byte_at(d, d->bp) << 8;
    d->ct = 8;
  }
}

static void initdec(Mq *d, const uint8_t *buf, long n) {
  d->buf = buf;
  d->n = n;
  d->bp = 0;
  d->c = (uint32_t)byte_at(d, 0) << 16;
  bytein(d);
  d->c <<= 7;
  d->ct -= 7;
  d->a = 0x8000;
}

static void renormd(Mq *d) {
  do {
    if (d->ct == 0) bytein(d);
    d->a <<= 1;
    d->c <<= 1;
    d->ct--;
  } while ((d->a & 0x8000) == 0);
}

/* One decision in the context (idx, mps): Figure E.15, the LPS
 * sub-interval at the bottom of A. */
static int decode(Mq *d, uint8_t *idx, uint8_t *mps) {
  uint32_t qe = QE[*idx];
  int bit;
  d->a -= qe;
  if ((d->c >> 16) < qe) {
    /* LPS_EXCHANGE */
    if (d->a < qe) {
      bit = *mps;
      *idx = NMPS[*idx];
    } else {
      bit = 1 - *mps;
      if (SWITCH[*idx]) *mps = 1 - *mps;
      *idx = NLPS[*idx];
    }
    d->a = qe;
  } else {
    d->c -= qe << 16;
    if (d->a & 0x8000) return *mps;
    /* MPS_EXCHANGE */
    if (d->a < qe) {
      bit = 1 - *mps;
      if (SWITCH[*idx]) *mps = 1 - *mps;
      *idx = NLPS[*idx];
    } else {
      bit = *mps;
      *idx = NMPS[*idx];
    }
  }
  renormd(d);
  return bit;
}

static uint32_t be32(const uint8_t *p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | p[3];
}

static int px(const uint8_t *img, int w, int h, int x, int y) {
  if (x < 0 || x >= w || y < 0 || y >= h) return 0;
  return img[(long)y * w + x];
}

/* 6.2.5.7 with GBTEMPLATE 0: the region's pixels into reg (w*h bytes) */
static int generic_template0(const uint8_t *data, long n, int w, int h,
                             int tpgdon, const int8_t at[8], uint8_t *reg) {
  uint8_t *idx = calloc(65536, 1), *mps = calloc(65536, 1);
  Mq d;
  int ltp = 0;
  if (!idx || !mps) {
    free(idx);
    free(mps);
    return -20;
  }
  initdec(&d, data, n);
  for (int y = 0; y < h; ++y) {
    uint8_t *row = reg + (long)y * w;
    if (tpgdon) {
      if (decode(&d, &idx[0x9B25], &mps[0x9B25])) ltp = !ltp;
      if (ltp) {
        if (y > 0) memcpy(row, row - w, (size_t)w);
        else memset(row, 0, (size_t)w);
        continue;
      }
    }
    for (int x = 0; x < w; ++x) {
      int cx = 0;
      cx |= px(reg, w, h, x - 1, y) << 0;
      cx |= px(reg, w, h, x - 2, y) << 1;
      cx |= px(reg, w, h, x - 3, y) << 2;
      cx |= px(reg, w, h, x - 4, y) << 3;
      cx |= px(reg, w, h, x + at[0], y + at[1]) << 4;
      cx |= px(reg, w, h, x + 2, y - 1) << 5;
      cx |= px(reg, w, h, x + 1, y - 1) << 6;
      cx |= px(reg, w, h, x, y - 1) << 7;
      cx |= px(reg, w, h, x - 1, y - 1) << 8;
      cx |= px(reg, w, h, x - 2, y - 1) << 9;
      cx |= px(reg, w, h, x + at[2], y + at[3]) << 10;
      cx |= px(reg, w, h, x + at[4], y + at[5]) << 11;
      cx |= px(reg, w, h, x + 1, y - 2) << 12;
      cx |= px(reg, w, h, x, y - 2) << 13;
      cx |= px(reg, w, h, x - 1, y - 2) << 14;
      cx |= px(reg, w, h, x + at[6], y + at[7]) << 15;
      row[x] = (uint8_t)decode(&d, &idx[cx], &mps[cx]);
    }
  }
  free(idx);
  free(mps);
  return 0;
}

/* Decode an embedded segment stream onto page (w*h bytes, 1 = black).
 * Returns the number of generic regions decoded, or a negative code. */
long pb_jbig2_decode(const uint8_t *s, long n, uint8_t *page, int w, int h) {
  long pos = 0, regions = 0;
  memset(page, 0, (size_t)w * h);
  while (pos < n) {
    if (pos + 6 > n) return -1;
    uint8_t flags = s[pos + 4];
    int type = flags & 0x3F;
    int page4 = (flags >> 6) & 1;
    long p = pos + 5;
    int count = s[p] >> 5;
    if (count == 7) return -2; /* long form: not written for one page */
    p += 1;
    uint32_t segnum = be32(s + pos);
    int refsize = segnum <= 256 ? 1 : (segnum <= 65536 ? 2 : 4);
    p += (long)count * refsize;
    p += page4 ? 4 : 1;
    if (p + 4 > n) return -3;
    uint32_t len = be32(s + p);
    p += 4;
    if (len == 0xFFFFFFFFu || p + (long)len > n) return -4;
    const uint8_t *data = s + p;
    if (type == 48) {
      if (len < 8 || (int)be32(data) != w || (int)be32(data + 4) != h)
        return -5;
    } else if (type == 38 || type == 39) {
      if (len < 18) return -6;
      int rw = (int)be32(data), rh = (int)be32(data + 4);
      int rx = (int)be32(data + 8), ry = (int)be32(data + 12);
      uint8_t gb = data[17];
      if (gb & 1) return -7;            /* MMR */
      if ((gb >> 1) & 3) return -8;     /* templates 1-3 */
      if ((gb >> 4) & 1) return -9;     /* extended template */
      if (len < 26 || rw <= 0 || rh <= 0 || rx < 0 || ry < 0 ||
          rx + rw > w || ry + rh > h)
        return -10;
      int8_t at[8];
      memcpy(at, data + 18, 8);
      uint8_t *reg = malloc((size_t)rw * rh);
      if (!reg) return -20;
      int err = generic_template0(data + 26, (long)len - 26, rw, rh,
                                  (gb >> 3) & 1, at, reg);
      if (err) {
        free(reg);
        return err;
      }
      int op = data[16] & 7;
      for (int y = 0; y < rh; ++y)
        for (int x = 0; x < rw; ++x) {
          uint8_t *dst = page + (long)(ry + y) * w + rx + x;
          uint8_t v = reg[(long)y * rw + x];
          if (op == 0) *dst |= v;
          else if (op == 1) *dst &= v;
          else if (op == 2) *dst ^= v;
          else if (op == 3) *dst = !(*dst ^ v);
          else *dst = v;
        }
      free(reg);
      regions++;
    } else if (type != 49 && type != 50 && type != 51) {
      return -11;
    }
    pos = p + len;
  }
  return regions;
}
