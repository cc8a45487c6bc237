// The JPEG codec's host loops (data/jpeg.py parses the markers and calls
// these through ctypes; built with the host C compiler at first use).
//
// Decoding reproduces libjpeg(-turbo)'s default decompression bit for bit:
// Huffman decoding of sequential and progressive scans (spectral selection,
// successive approximation, EOB runs), restart intervals, the ISLOW integer
// IDCT (jidctint.c) with the SIMD IDCT's saturation, "fancy" triangular chroma
// upsampling (jdsample.c) and the 16-bit fixed-point YCbCr->RGB tables
// (jdcolor.c). Encoding reproduces libjpeg-turbo's compressor: RGB->YCbCr
// (jccolor.c), h2v2 downsampling (jcsample.c), the ISLOW forward DCT
// (jfdctint.c), reciprocal quantisation (jcdctmgr.c) and the sequential and
// progressive Huffman encoders (jchuff.c, jcphuff.c).
//
// Coefficients are int16, 64 a block in natural (row-major) order; a
// component's blocks form a (rows, stride) grid inside one int16 buffer.
// A scan is described by an int64 array:
//   [0] components in the scan   [1] Ss  [2] Se  [3] Ah  [4] Al
//   [5] restart interval (MCUs)  [6] MCUs a row  [7] MCU rows
//   [8] progressive (0/1)
//   then per component, 8 values: offset of its blocks (int16 elements),
//   stride (blocks a row), width and height in blocks (a non-interleaved
//   scan covers these), h and v sampling factors, DC table, AC table.

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define SCAN_HEAD 9
#define SCAN_COMP 8

static const int natural_order[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for safety in a corrupt stream (as jutils.c)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- decoding

typedef struct {
  const uint8_t* data;
  int64_t len, pos;   // pos: the next byte to read
  uint64_t buf;       // the low `bits` bits are unread, MSB first
  int bits;
  int marker;         // a marker was reached: zeros are fed from here on
} BitReader;

// Refill to at least 57 bits, undoing byte stuffing; at a marker (or the
// end of the data) feed zeros, as libjpeg's fill_bit_buffer does.
static void fill_bits(BitReader* br) {
  while (br->bits <= 56) {
    unsigned c = 0;
    if (!br->marker) {
      if (br->pos >= br->len) {
        br->marker = 1;
      } else {
        c = br->data[br->pos];
        if (c == 0xFF) {
          int64_t p = br->pos + 1;
          while (p < br->len && br->data[p] == 0xFF) ++p;
          if (p < br->len && br->data[p] == 0) {
            br->pos = p + 1;           // stuffed 0xFF
          } else {
            br->pos = p - 1;           // leave pos at the marker's 0xFF
            br->marker = 1;
            c = 0;
          }
        } else {
          br->pos++;
        }
      }
    }
    br->buf = (br->buf << 8) | c;
    br->bits += 8;
  }
}

static inline int get_bits(BitReader* br, int n) {
  if (n == 0) return 0;
  if (br->bits < n) fill_bits(br);
  br->bits -= n;
  return (int)((br->buf >> br->bits) & ((1u << n) - 1));
}

static inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

typedef struct {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
  uint8_t look_nbits[512];
  uint8_t look_sym[512];
  int present;
} HuffTable;

// bits_vals: 16 counts then up to 256 symbols (jdhuff.c's
// jpeg_make_d_derived_tbl with a 9-bit lookahead).
static int make_decode_table(const int32_t* bits_vals, HuffTable* t) {
  int huffsize[257];
  unsigned huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int n = bits_vals[l - 1];
    if (n < 0 || p + n > 256) return -1;
    while (n--) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  const int numsymbols = p;
  for (int i = 0; i < numsymbols; ++i) t->huffval[i] = (uint8_t)bits_vals[16 + i];
  unsigned code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1u << si)) return -1;    // bad table
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits_vals[l - 1]) {
      t->valoffset[l] = p - (int32_t)huffcode[p];
      p += bits_vals[l - 1];
      t->maxcode[l] = (int32_t)huffcode[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0x7FFFFFFF;   // sentinel
  memset(t->look_nbits, 0, sizeof t->look_nbits);
  p = 0;
  for (int l = 1; l <= 9; ++l) {
    for (int i = 1; i <= bits_vals[l - 1]; ++i, ++p) {
      int look = (int)(huffcode[p] << (9 - l));
      for (int c = 1 << (9 - l); c > 0; --c, ++look) {
        t->look_nbits[look] = (uint8_t)l;
        t->look_sym[look] = t->huffval[p];
      }
    }
  }
  t->present = 1;
  return 0;
}

static inline int decode_symbol(BitReader* br, const HuffTable* t) {
  if (br->bits < 16) fill_bits(br);
  const int look = (int)((br->buf >> (br->bits - 9)) & 511);
  const int nb = t->look_nbits[look];
  if (nb) {
    br->bits -= nb;
    return t->look_sym[look];
  }
  int l = 10;
  int32_t code = (int32_t)((br->buf >> (br->bits - l)) & ((1u << l) - 1));
  while (l <= 16 && code > t->maxcode[l]) {
    ++l;
    code = (int32_t)((br->buf >> (br->bits - l)) & ((1u << l) - 1));
  }
  if (l > 16) return 0;          // corrupt data: libjpeg returns 0 as well
  br->bits -= l;
  return t->huffval[(t->valoffset[l] + code) & 0xFF];
}

typedef struct {
  int16_t* blocks;   // this component's first block
  int64_t stride, width, height;
  int h, v, dc, ac;
} ScanComp;

// Skip the restart marker at the reader's position (after the bit buffer
// is dropped). Returns 0, or -1 when no RSTn is there.
static int restart(BitReader* br) {
  br->bits = 0;
  br->buf = 0;
  int64_t p = br->pos;
  while (p < br->len && br->data[p] == 0xFF) ++p;
  if (p >= br->len || br->data[p] < 0xD0 || br->data[p] > 0xD7) return -1;
  br->pos = p + 1;
  br->marker = 0;
  return 0;
}

static void decode_block(BitReader* br, int16_t* blk, const HuffTable* dct,
                         const HuffTable* act, int* last_dc, int Ss, int Se,
                         int Ah, int Al, int progressive, int* eobrun) {
  if (!progressive) {                     // sequential: the whole block
    int s = decode_symbol(br, dct);
    if (s) s = extend(get_bits(br, s), s);
    *last_dc = (int)((unsigned)*last_dc + (unsigned)s);  // wraps, never UB
    blk[0] = (int16_t)*last_dc;
    for (int k = 1; k < 64; ++k) {
      int rs = decode_symbol(br, act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[natural_order[k]] = (int16_t)extend(get_bits(br, s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return;
  }
  if (Ss == 0) {                          // DC scans
    if (Ah == 0) {
      int s = decode_symbol(br, dct);
      if (s) s = extend(get_bits(br, s), s);
      *last_dc = (int)((unsigned)*last_dc + (unsigned)s);  // wraps, never UB
      blk[0] = (int16_t)((unsigned)*last_dc << Al);
    } else if (get_bits(br, 1)) {
      blk[0] |= (int16_t)(1 << Al);
    }
    return;
  }
  if (Ah == 0) {                          // AC first pass
    if (*eobrun > 0) {
      (*eobrun)--;
      return;
    }
    for (int k = Ss; k <= Se; ++k) {
      int rs = decode_symbol(br, act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[natural_order[k]] = (int16_t)((unsigned)extend(get_bits(br, s), s) << Al);
      } else if (r == 15) {
        k += 15;
      } else {
        *eobrun = 1 << r;
        if (r) *eobrun += get_bits(br, r);
        (*eobrun)--;
        break;
      }
    }
    return;
  }
  // AC refinement (jdphuff.c decode_mcu_AC_refine)
  const int p1 = 1 << Al, m1 = -1 * (1 << Al);
  int k = Ss;
  if (*eobrun == 0) {
    for (; k <= Se; ++k) {
      int rs = decode_symbol(br, act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = get_bits(br, 1) ? p1 : m1;
      } else if (r != 15) {
        *eobrun = 1 << r;
        if (r) *eobrun += get_bits(br, r);
        break;
      }
      do {
        int16_t* coef = blk + natural_order[k];
        if (*coef != 0) {
          if (get_bits(br, 1) && (*coef & p1) == 0)
            *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
        } else {
          if (--r < 0) break;
        }
        ++k;
      } while (k <= Se);
      if (s) blk[natural_order[k]] = (int16_t)s;
    }
  }
  if (*eobrun > 0) {
    for (; k <= Se; ++k) {
      int16_t* coef = blk + natural_order[k];
      if (*coef != 0 && get_bits(br, 1) && (*coef & p1) == 0)
        *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
    }
    (*eobrun)--;
  }
}

static void scan_comps(const int64_t* scan, int16_t* coefs, ScanComp* comps) {
  for (int c = 0; c < scan[0]; ++c) {
    const int64_t* q = scan + SCAN_HEAD + SCAN_COMP * c;
    comps[c].blocks = coefs + q[0];
    comps[c].stride = q[1];
    comps[c].width = q[2];
    comps[c].height = q[3];
    comps[c].h = (int)q[4];
    comps[c].v = (int)q[5];
    comps[c].dc = (int)q[6];
    comps[c].ac = (int)q[7];
  }
}

// Decode one scan's entropy-coded data, data[pos:len), into `coefs`.
// tables: 8 Huffman tables (0-3 DC, 4-7 AC) of 16 + 256 int32 each, with
// `present` a bit each. Returns the position of the marker that ends the
// scan, or -1 for a missing restart marker, -2 for a bad Huffman table,
// -3 when out of memory, -4 for a scan header outside the ranges that
// keep the decode inside its buffers (1-4 components, tables 0-3,
// 0 <= Ss <= Se <= 63, Ah <= 14, Al <= 13; data/jpeg.py refuses these
// first).
int64_t jpeg_decode_scan(const uint8_t* data, int64_t len, int64_t pos,
                         const int64_t* scan, int16_t* coefs,
                         const int32_t* tables, int64_t present) {
  if (scan[0] < 1 || scan[0] > 4 || scan[1] < 0 || scan[1] > scan[2] ||
      scan[2] > 63 || scan[3] < 0 || scan[3] > 14 || scan[4] < 0 ||
      scan[4] > 13)
    return -4;
  for (int c = 0; c < scan[0]; ++c) {
    const int64_t* q = scan + SCAN_HEAD + SCAN_COMP * c;
    if (q[6] < 0 || q[6] > 3 || q[7] < 0 || q[7] > 3) return -4;
  }
  HuffTable* huff = (HuffTable*)calloc(8, sizeof(HuffTable));
  if (!huff) return -3;
  for (int t = 0; t < 8; ++t)
    if ((present >> t) & 1)
      if (make_decode_table(tables + t * 272, huff + t)) {
        free(huff);
        return -2;
      }
  const int n = (int)scan[0], Ss = (int)scan[1], Se = (int)scan[2];
  const int Ah = (int)scan[3], Al = (int)scan[4];
  const int64_t interval = scan[5], mcus_x = scan[6], mcus_y = scan[7];
  const int progressive = (int)scan[8];
  ScanComp comps[4];
  scan_comps(scan, coefs, comps);
  BitReader br = {data, len, pos, 0, 0, 0};
  int last_dc[4] = {0, 0, 0, 0};
  int eobrun = 0;
  int64_t togo = interval;
  for (int64_t my = 0; my < mcus_y; ++my) {
    for (int64_t mx = 0; mx < mcus_x; ++mx) {
      if (interval) {
        if (togo == 0) {
          if (restart(&br)) {
            free(huff);
            return -1;
          }
          memset(last_dc, 0, sizeof last_dc);
          eobrun = 0;
          togo = interval;
        }
        togo--;
      }
      for (int c = 0; c < n; ++c) {
        const ScanComp* sc = comps + c;
        const HuffTable* dct = huff + sc->dc;
        const HuffTable* act = huff + 4 + sc->ac;
        if (n == 1) {
          int16_t* blk = sc->blocks + (my * sc->stride + mx) * 64;
          decode_block(&br, blk, dct, act, last_dc + c, Ss, Se, Ah, Al,
                       progressive, &eobrun);
          continue;
        }
        for (int y = 0; y < sc->v; ++y)
          for (int x = 0; x < sc->h; ++x) {
            int16_t* blk = sc->blocks +
                ((my * sc->v + y) * sc->stride + mx * sc->h + x) * 64;
            decode_block(&br, blk, dct, act, last_dc + c, Ss, Se, Ah, Al,
                         progressive, &eobrun);
          }
      }
    }
  }
  free(huff);
  // the scan ends at the next marker: skip padding bits and bytes to it
  int64_t p = br.pos;
  while (p < len && !(data[p] == 0xFF && p + 1 < len && data[p + 1] != 0 &&
                      data[p + 1] != 0xFF))
    ++p;
  return p;
}

// jidctint.c's jpeg_idct_islow
#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

// The IDCT's output stage: a value centred on 0 -> sample, saturated to
// [0, 255] as the SIMD IDCT of libjpeg-turbo does (its packs saturate;
// jdmaster.c's range-limit table, which the C IDCT indexes, instead wraps
// a value beyond +-512 modulo 1024: only crafted coefficients reach it).
static inline uint8_t idct_sample(int64_t x) {
  x += 128;
  return (uint8_t)(x < 0 ? 0 : x > 255 ? 255 : x);
}

static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                       int64_t stride) {
  int ws[64];
  int64_t tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
  int64_t z1, z2, z3, z4, z5;
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      // a DC-only column: the SIMD IDCT shifts the dequantized DC in a
      // 16-bit lane, so it wraps to 16 bits
      int dc = (int16_t)(uint16_t)((unsigned)(ip[0] * qp[0]) << PASS1_BITS);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    z2 = ip[16] * qp[16];
    z3 = ip[48] * qp[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    tmp0 = (z2 + z3) * ((int64_t)1 << CONST_BITS);
    tmp1 = (z2 - z3) * ((int64_t)1 << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    wp[0] = (int)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
    wp[56] = (int)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
    wp[8] = (int)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
    wp[48] = (int)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
    wp[16] = (int)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
    wp[40] = (int)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
    wp[24] = (int)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
    wp[32] = (int)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      const uint8_t dc = idct_sample(DESCALE((int64_t)wp[0], PASS1_BITS + 3));
      memset(op, dc, 8);
      continue;
    }
    z2 = wp[2];
    z3 = wp[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    tmp0 = ((int64_t)wp[0] + wp[4]) * ((int64_t)1 << CONST_BITS);
    tmp1 = ((int64_t)wp[0] - wp[4]) * ((int64_t)1 << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    op[0] = idct_sample(DESCALE(tmp10 + tmp3, sh));
    op[7] = idct_sample(DESCALE(tmp10 - tmp3, sh));
    op[1] = idct_sample(DESCALE(tmp11 + tmp2, sh));
    op[6] = idct_sample(DESCALE(tmp11 - tmp2, sh));
    op[2] = idct_sample(DESCALE(tmp12 + tmp1, sh));
    op[5] = idct_sample(DESCALE(tmp12 - tmp1, sh));
    op[3] = idct_sample(DESCALE(tmp13 + tmp0, sh));
    op[4] = idct_sample(DESCALE(tmp13 - tmp0, sh));
  }
}

// Inverse-transform a component's (rows, cols) blocks, `stride` blocks a
// row apart, into the plane `out` of (rows * 8, cols * 8) samples.
// q: the component's quantisation table in natural order.
void jpeg_idct_plane(const int16_t* blocks, int64_t stride, int64_t rows,
                     int64_t cols, const uint16_t* q, uint8_t* out) {
  const int64_t ostride = cols * 8;
  for (int64_t by = 0; by < rows; ++by)
    for (int64_t bx = 0; bx < cols; ++bx)
      idct_islow(blocks + (by * stride + bx) * 64, q,
                 out + by * 8 * ostride + bx * 8, ostride);
}

// Upsample a component plane `in` ((dh, dw) real samples, `in_stride`
// apart) by the integer factors (hf, vf) to `out` (H, W), as jdsample.c
// selects its method: h2v1 and h2v2 "fancy" (triangular) when dw > 2,
// h1v2 fancy, else replication. Rows above the first and below the last
// repeat them, as jdmainct.c's context pointers do.
void jpeg_upsample(const uint8_t* in, int64_t in_stride, int64_t dw,
                   int64_t dh, int64_t hf, int64_t vf, uint8_t* out,
                   int64_t W, int64_t H) {
  const int64_t ow = dw * hf;             // libjpeg's padded output width
  uint8_t* row = (uint8_t*)malloc((size_t)(ow + 16));
  if (!row) return;
  for (int64_t y = 0; y < H; ++y) {
    const int64_t iy = y / vf;
    const uint8_t* r0 = in + iy * in_stride;
    if (hf == 2 && vf == 2 && dw > 2) {
      const int64_t near = iy, far = (y & 1) ? (iy + 1 < dh ? iy + 1 : dh - 1)
                                              : (iy > 0 ? iy - 1 : 0);
      const uint8_t* a = in + near * in_stride;
      const uint8_t* b = in + far * in_stride;
      int this_sum = a[0] * 3 + b[0], next_sum = a[1] * 3 + b[1], last_sum;
      row[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
      row[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
      last_sum = this_sum;
      this_sum = next_sum;
      for (int64_t x = 1; x < dw - 1; ++x) {
        next_sum = a[x + 1] * 3 + b[x + 1];
        row[2 * x] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        row[2 * x + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      row[2 * dw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
      row[2 * dw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
    } else if (hf == 2 && vf == 1 && dw > 2) {
      row[0] = r0[0];
      row[1] = (uint8_t)((r0[0] * 3 + r0[1] + 2) >> 2);
      for (int64_t x = 1; x < dw - 1; ++x) {
        const int v = r0[x] * 3;
        row[2 * x] = (uint8_t)((v + r0[x - 1] + 1) >> 2);
        row[2 * x + 1] = (uint8_t)((v + r0[x + 1] + 2) >> 2);
      }
      row[2 * dw - 2] = (uint8_t)((r0[dw - 1] * 3 + r0[dw - 2] + 1) >> 2);
      row[2 * dw - 1] = r0[dw - 1];
    } else if (hf == 1 && vf == 2) {
      const int odd = (int)(y & 1);
      const int64_t far = odd ? (iy + 1 < dh ? iy + 1 : dh - 1)
                              : (iy > 0 ? iy - 1 : 0);
      const uint8_t* b = in + far * in_stride;
      const int bias = odd ? 2 : 1;
      for (int64_t x = 0; x < dw; ++x)
        row[x] = (uint8_t)((r0[x] * 3 + b[x] + bias) >> 2);
    } else {
      for (int64_t x = 0; x < dw; ++x)
        memset(row + x * hf, r0[x], (size_t)hf);
    }
    memcpy(out + y * W, row, (size_t)W);
  }
  free(row);
}

// jdcolor.c's ycc_rgb_convert: n pixels of planes y, cb, cr -> RGB
// triples.
void jpeg_ycc_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                  uint8_t* rgb, int64_t n) {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  const int64_t one_half = (int64_t)1 << 15;
  for (int i = 0; i < 256; ++i) {
    const int64_t x = i - 128;
    cr_r[i] = (int)((91881 * x + one_half) >> 16);      // FIX(1.40200)
    cb_b[i] = (int)((116130 * x + one_half) >> 16);     // FIX(1.77200)
    cr_g[i] = -46802 * x;                               // FIX(0.71414)
    cb_g[i] = -22554 * x + one_half;                    // FIX(0.34414)
  }
  for (int64_t i = 0; i < n; ++i) {
    const int Y = y[i], b = cb[i], r = cr[i];
    int R = Y + cr_r[r];
    int G = Y + (int)((cb_g[b] + cr_g[r]) >> 16);
    int B = Y + cb_b[b];
    rgb[3 * i] = (uint8_t)(R < 0 ? 0 : R > 255 ? 255 : R);
    rgb[3 * i + 1] = (uint8_t)(G < 0 ? 0 : G > 255 ? 255 : G);
    rgb[3 * i + 2] = (uint8_t)(B < 0 ? 0 : B > 255 ? 255 : B);
  }
}

// ---------------------------------------------------------------- encoding

// jccolor.c's rgb_ycc_convert: n RGB triples -> planes y, cb, cr.
void jpeg_rgb_ycc(const uint8_t* rgb, uint8_t* y, uint8_t* cb, uint8_t* cr,
                  int64_t n) {
  int64_t tab[8 * 256];
  const int64_t one_half = (int64_t)1 << 15, cbcr_offset = (int64_t)128 << 16;
  for (int64_t i = 0; i < 256; ++i) {
    tab[i] = 19595 * i;                                  // FIX(0.29900)
    tab[i + 256] = 38470 * i;                            // FIX(0.58700)
    tab[i + 512] = 7471 * i + one_half;                  // FIX(0.11400)
    tab[i + 768] = -11059 * i;                           // FIX(0.16874)
    tab[i + 1024] = -21709 * i;                          // FIX(0.33126)
    tab[i + 1280] = 32768 * i + cbcr_offset + one_half - 1;
    tab[i + 1536] = -27439 * i;                          // FIX(0.41869)
    tab[i + 1792] = -5329 * i;                           // FIX(0.08131)
  }
  for (int64_t i = 0; i < n; ++i) {
    const int r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    y[i] = (uint8_t)((tab[r] + tab[g + 256] + tab[b + 512]) >> 16);
    cb[i] = (uint8_t)((tab[r + 768] + tab[g + 1024] + tab[b + 1280]) >> 16);
    cr[i] = (uint8_t)((tab[r + 1280] + tab[g + 1536] + tab[b + 1792]) >> 16);
  }
}

static void fdct_islow(int* d) {
  int64_t tmp0, tmp1, tmp2, tmp3, tmp4, tmp5, tmp6, tmp7;
  int64_t tmp10, tmp11, tmp12, tmp13, z1, z2, z3, z4, z5;
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 8 : 1, next = pass ? 1 : 8;
    const int sh = pass ? CONST_BITS + PASS1_BITS : CONST_BITS - PASS1_BITS;
    for (int i = 0; i < 8; ++i) {
      int* p = d + i * next;
      tmp0 = p[0] + p[7 * step];
      tmp7 = p[0] - p[7 * step];
      tmp1 = p[step] + p[6 * step];
      tmp6 = p[step] - p[6 * step];
      tmp2 = p[2 * step] + p[5 * step];
      tmp5 = p[2 * step] - p[5 * step];
      tmp3 = p[3 * step] + p[4 * step];
      tmp4 = p[3 * step] - p[4 * step];
      tmp10 = tmp0 + tmp3;
      tmp13 = tmp0 - tmp3;
      tmp11 = tmp1 + tmp2;
      tmp12 = tmp1 - tmp2;
      if (pass) {
        p[0] = (int)DESCALE(tmp10 + tmp11, PASS1_BITS);
        p[4 * step] = (int)DESCALE(tmp10 - tmp11, PASS1_BITS);
      } else {
        p[0] = (int)((tmp10 + tmp11) * (1 << PASS1_BITS));
        p[4 * step] = (int)((tmp10 - tmp11) * (1 << PASS1_BITS));
      }
      z1 = (tmp12 + tmp13) * FIX_0_541196100;
      p[2 * step] = (int)DESCALE(z1 + tmp13 * FIX_0_765366865, sh);
      p[6 * step] = (int)DESCALE(z1 + tmp12 * -FIX_1_847759065, sh);
      z1 = tmp4 + tmp7;
      z2 = tmp5 + tmp6;
      z3 = tmp4 + tmp6;
      z4 = tmp5 + tmp7;
      z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      p[7 * step] = (int)DESCALE(tmp4 + z1 + z3, sh);
      p[5 * step] = (int)DESCALE(tmp5 + z2 + z4, sh);
      p[3 * step] = (int)DESCALE(tmp6 + z2 + z3, sh);
      p[step] = (int)DESCALE(tmp7 + z1 + z4, sh);
    }
  }
}

// Forward-transform and quantise the (rows, cols) blocks of the plane `in`
// (cols * 8 samples a row) into `blocks` (`stride` blocks a row apart).
// q: the quantisation table in natural order. Quantisation is
// libjpeg-turbo's: a 16-bit reciprocal, correction and shift per
// coefficient (compute_reciprocal), applied to the magnitude.
void jpeg_fdct_plane(const uint8_t* in, int64_t rows, int64_t cols,
                     const uint16_t* q, int16_t* blocks, int64_t stride) {
  uint32_t recip[64], corr[64];
  int shift[64];
  for (int i = 0; i < 64; ++i) {
    const uint32_t divisor = (uint32_t)q[i] << 3;
    if (divisor == 1) {
      recip[i] = 1;
      corr[i] = 0;
      shift[i] = -16;
      continue;
    }
    int b = 0;
    while ((divisor >> (b + 1)) != 0) ++b;    // flss(divisor) - 1
    int r = 16 + b;
    uint32_t fq = (uint32_t)(((uint64_t)1 << r) / divisor);
    const uint32_t fr = (uint32_t)(((uint64_t)1 << r) % divisor);
    uint32_t c = divisor / 2;
    if (fr == 0) {
      fq >>= 1;
      r--;
    } else if (fr <= divisor / 2u) {
      c++;
    } else {
      fq++;
    }
    recip[i] = fq & 0xFFFF;
    corr[i] = c & 0xFFFF;
    shift[i] = r - 16;
  }
  const int64_t istride = cols * 8;
  int ws[64];
  for (int64_t by = 0; by < rows; ++by)
    for (int64_t bx = 0; bx < cols; ++bx) {
      const uint8_t* src = in + by * 8 * istride + bx * 8;
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c) ws[r * 8 + c] = src[r * istride + c] - 128;
      fdct_islow(ws);
      int16_t* out = blocks + (by * stride + bx) * 64;
      for (int i = 0; i < 64; ++i) {
        int t = (int16_t)ws[i];                   // DCTELEM is 16 bits
        const int neg = t < 0;
        uint32_t m = (uint16_t)(neg ? -t : t);
        uint32_t product = (m + corr[i]) * recip[i];
        product >>= shift[i] + 16;
        t = (int16_t)product;
        out[i] = (int16_t)(neg ? -t : t);
      }
    }
}

typedef struct {
  uint8_t* out;
  int64_t cap, n;
  uint64_t buf;
  int bits;
  int overflow;
  int64_t* freq;          // counting pass: symbol counts, no output
  const int32_t* codes;   // 8 tables x 256 x (code, size)
} BitWriter;

static void put_byte(BitWriter* bw, uint8_t c) {
  if (bw->n + 2 > bw->cap) {
    bw->overflow = 1;
    return;
  }
  bw->out[bw->n++] = c;
  if (c == 0xFF) bw->out[bw->n++] = 0;    // byte stuffing
}

static void put_bits(BitWriter* bw, uint32_t code, int size) {
  if (bw->freq || size == 0) return;
  bw->buf = (bw->buf << size) | (code & ((1u << size) - 1));
  bw->bits += size;
  while (bw->bits >= 8) {
    bw->bits -= 8;
    put_byte(bw, (uint8_t)(bw->buf >> bw->bits));
  }
}

static void put_symbol(BitWriter* bw, int table, int sym) {
  if (bw->freq) {
    bw->freq[table * 257 + sym]++;
    return;
  }
  const int32_t* e = bw->codes + (table * 256 + sym) * 2;
  if (e[1] == 0) bw->overflow = 2;        // symbol without a code
  put_bits(bw, (uint32_t)e[0], e[1]);
}

static void flush_bits(BitWriter* bw) {
  if (bw->freq) return;
  put_bits(bw, 0x7F, 7);                  // pad with ones
  bw->buf = 0;
  bw->bits = 0;
}

static int nbits_of(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

typedef struct {
  int eobrun, be;
  char corr[1000];  // buffered correction bits (jcphuff.c's bit_buffer)
  int ac_table;
} Refine;

static void emit_corr(BitWriter* bw, const char* bits, int n) {
  for (int i = 0; i < n; ++i) put_bits(bw, (uint32_t)bits[i], 1);
}

static void emit_eobrun(BitWriter* bw, Refine* st) {
  if (st->eobrun > 0) {
    const int nb = nbits_of(st->eobrun) - 1;
    put_symbol(bw, st->ac_table, nb << 4);
    if (nb) put_bits(bw, (uint32_t)st->eobrun, nb);
    st->eobrun = 0;
    emit_corr(bw, st->corr, st->be);
    st->be = 0;
  }
}

static void encode_block(BitWriter* bw, const int16_t* blk, int dct, int act,
                         int* last_dc, int Ss, int Se, int Ah, int Al,
                         int progressive, Refine* st) {
  if (!progressive || Ss == 0) {
    if (progressive && Ah) {                       // DC refinement
      put_bits(bw, (uint32_t)((blk[0] >> Al) & 1), 1);
      return;
    }
    const int dc = progressive ? (blk[0] >> Al) : blk[0];
    int t = dc - *last_dc, t2 = t;
    *last_dc = dc;
    if (t < 0) {
      t = -t;
      t2--;
    }
    const int nb = nbits_of(t);
    put_symbol(bw, dct, nb);
    put_bits(bw, (uint32_t)t2, nb);
    if (progressive) return;
  }
  if (!progressive) {
    int r = 0;
    for (int k = 1; k < 64; ++k) {
      int t = blk[natural_order[k]];
      if (t == 0) {
        ++r;
        continue;
      }
      while (r > 15) {
        put_symbol(bw, 4 + act, 0xF0);
        r -= 16;
      }
      int t2 = t;
      if (t < 0) {
        t = -t;
        t2--;
      }
      const int nb = nbits_of(t);
      put_symbol(bw, 4 + act, (r << 4) + nb);
      put_bits(bw, (uint32_t)t2, nb);
      r = 0;
    }
    if (r > 0) put_symbol(bw, 4 + act, 0);
    return;
  }
  st->ac_table = 4 + act;
  if (Ah == 0) {                                   // AC first pass
    int r = 0;
    for (int k = Ss; k <= Se; ++k) {
      int t = blk[natural_order[k]], t2;
      if (t == 0) {
        ++r;
        continue;
      }
      if (t < 0) {
        t = -t >> Al;
        t2 = ~t;
      } else {
        t >>= Al;
        t2 = t;
      }
      if (t == 0) {
        ++r;
        continue;
      }
      emit_eobrun(bw, st);
      while (r > 15) {
        put_symbol(bw, 4 + act, 0xF0);
        r -= 16;
      }
      const int nb = nbits_of(t);
      put_symbol(bw, 4 + act, (r << 4) + nb);
      put_bits(bw, (uint32_t)t2, nb);
      r = 0;
    }
    if (r > 0) {
      st->eobrun++;
      if (st->eobrun == 0x7FFF) emit_eobrun(bw, st);
    }
    return;
  }
  // AC refinement (jcphuff.c encode_mcu_AC_refine)
  int absv[64], eob = 0;
  for (int k = Ss; k <= Se; ++k) {
    int t = blk[natural_order[k]];
    if (t < 0) t = -t;
    t >>= Al;
    absv[k] = t;
    if (t == 1) eob = k;
  }
  int r = 0, br = 0;
  char* brbuf = st->corr + st->be;
  for (int k = Ss; k <= Se; ++k) {
    const int t = absv[k];
    if (t == 0) {
      ++r;
      continue;
    }
    while (r > 15 && k <= eob) {
      emit_eobrun(bw, st);
      put_symbol(bw, 4 + act, 0xF0);
      r -= 16;
      emit_corr(bw, brbuf, br);
      brbuf = st->corr;
      br = 0;
    }
    if (t > 1) {
      brbuf[br++] = (char)(t & 1);
      continue;
    }
    emit_eobrun(bw, st);
    put_symbol(bw, 4 + act, (r << 4) + 1);
    put_bits(bw, blk[natural_order[k]] < 0 ? 0u : 1u, 1);
    emit_corr(bw, brbuf, br);
    brbuf = st->corr;
    br = 0;
    r = 0;
  }
  if (r > 0 || br > 0) {
    st->eobrun++;
    st->be += br;
    if (st->eobrun == 0x7FFF || st->be > 1000 - 64 + 1) emit_eobrun(bw, st);
  }
}

// Entropy-code one scan of `coefs` into `out` (at most `cap` bytes), or,
// with `freq` non-NULL, count its Huffman symbols there (8 tables x 257)
// instead. codes: 8 tables (0-3 DC, 4-7 AC) x 256 symbols x (code, size).
// Returns the bytes written, -1 when `cap` is too small, -2 when a symbol
// has no code.
int64_t jpeg_encode_scan(const int64_t* scan, const int16_t* coefs,
                         const int32_t* codes, int64_t* freq, uint8_t* out,
                         int64_t cap) {
  const int n = (int)scan[0], Ss = (int)scan[1], Se = (int)scan[2];
  const int Ah = (int)scan[3], Al = (int)scan[4];
  const int64_t interval = scan[5], mcus_x = scan[6], mcus_y = scan[7];
  const int progressive = (int)scan[8];
  ScanComp comps[4];
  scan_comps(scan, (int16_t*)coefs, comps);
  BitWriter bw = {out, cap, 0, 0, 0, 0, freq, codes};
  Refine* st = (Refine*)calloc(1, sizeof(Refine));
  if (!st) return -3;
  int last_dc[4] = {0, 0, 0, 0};
  int64_t togo = interval;
  int next_rst = 0;
  for (int64_t my = 0; my < mcus_y; ++my) {
    for (int64_t mx = 0; mx < mcus_x; ++mx) {
      if (interval) {
        if (togo == 0) {
          if (progressive) emit_eobrun(&bw, st);
          flush_bits(&bw);
          if (!freq) {
            if (bw.n + 2 > bw.cap) {
              bw.overflow = 1;
            } else {
              bw.out[bw.n++] = 0xFF;
              bw.out[bw.n++] = (uint8_t)(0xD0 + next_rst);
            }
          }
          next_rst = (next_rst + 1) & 7;
          memset(last_dc, 0, sizeof last_dc);
          st->eobrun = 0;
          st->be = 0;
          togo = interval;
        }
        togo--;
      }
      for (int c = 0; c < n; ++c) {
        const ScanComp* sc = comps + c;
        if (n == 1) {
          encode_block(&bw, sc->blocks + (my * sc->stride + mx) * 64, sc->dc,
                       sc->ac, last_dc + c, Ss, Se, Ah, Al, progressive, st);
          continue;
        }
        for (int y = 0; y < sc->v; ++y)
          for (int x = 0; x < sc->h; ++x)
            encode_block(&bw, sc->blocks +
                                  ((my * sc->v + y) * sc->stride +
                                   mx * sc->h + x) * 64,
                         sc->dc, sc->ac, last_dc + c, Ss, Se, Ah, Al,
                         progressive, st);
      }
    }
  }
  if (progressive) emit_eobrun(&bw, st);
  flush_bits(&bw);
  free(st);
  if (bw.overflow == 1) return -1;
  if (bw.overflow == 2) return -2;
  return bw.n;
}
