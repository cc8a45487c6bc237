// Host-side loops that numpy cannot vectorise well: the PNG row unfilter
// (data/png.py), PIL's 8-bit separable resample pass (data/base.py) and the
// CRC-32C of TensorBoard's record framing (utils/tensorboard.py). Built with
// the host C compiler at first use and bound with ctypes (data/native.py).

#include <stdint.h>
#include <string.h>

static inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

// Undo the row filters of an 8-bit PNG image (PNG specification, section
// 9). Average and Paeth depend on the pixel just decoded to their left, so
// a row is decoded serially.
// raw: `height` rows of 1 + `stride` bytes, a filter-type byte then the
// filtered row; out: `height` rows of `stride` bytes; bpp: bytes a pixel.
// Returns 0, or 1 + the index of the first row whose filter type is unknown.
int png_unfilter(const uint8_t* raw, uint8_t* out, int64_t height,
                 int64_t stride, int64_t bpp) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = raw + y * (stride + 1) + 1;
    uint8_t* row = out + y * stride;
    const uint8_t* up = y ? row - stride : NULL;
    int64_t i;
    switch (src[-1]) {
      case 0:
        memcpy(row, src, (size_t)stride);
        break;
      case 1:
        for (i = 0; i < stride; ++i)
          row[i] = (uint8_t)(src[i] + (i >= bpp ? row[i - bpp] : 0));
        break;
      case 2:
        for (i = 0; i < stride; ++i)
          row[i] = (uint8_t)(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (i = 0; i < stride; ++i) {
          const int left = i >= bpp ? row[i - bpp] : 0;
          row[i] = (uint8_t)(src[i] + ((left + (up ? up[i] : 0)) >> 1));
        }
        break;
      case 4:
        for (i = 0; i < stride; ++i) {
          const int left = i >= bpp ? row[i - bpp] : 0;
          const int above = up ? up[i] : 0;
          const int corner = (up && i >= bpp) ? up[i - bpp] : 0;
          row[i] = (uint8_t)(src[i] + paeth(left, above, corner));
        }
        break;
      default:
        return (int)(y + 1);
    }
  }
  return 0;
}

// One pass of PIL's 8-bit resample (libImaging/Resample.c) along the middle
// axis of `in`, (outer, n_in, inner) -> `out`, (outer, n_out, inner): output
// x sums count[x] taps from source index first[x] with the fixed-point
// weights kk[x * ksize + t] (22 fraction bits), rounds and clips to 8 bits.
void resample_u8(const uint8_t* in, uint8_t* out, int64_t outer,
                 int64_t n_in, int64_t inner, int64_t n_out,
                 const int64_t* first, const int64_t* count,
                 const int32_t* kk, int64_t ksize) {
  for (int64_t o = 0; o < outer; ++o) {
    for (int64_t x = 0; x < n_out; ++x) {
      const int32_t* k = kk + x * ksize;
      const uint8_t* src = in + (o * n_in + first[x]) * inner;
      uint8_t* dst = out + (o * n_out + x) * inner;
      for (int64_t i = 0; i < inner; ++i) {
        int32_t ss = 1 << 21;
        for (int64_t t = 0; t < count[x]; ++t) ss += src[t * inner + i] * k[t];
        dst[i] = ss <= 0 ? 0 : (ss >= (1 << 30) ? 255 : (uint8_t)(ss >> 22));
      }
    }
  }
}

// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) of n bytes, one
// table lookup a byte; the table is built per call (2 K steps), so calls
// from several threads share nothing.
uint32_t crc32c(const uint8_t* data, int64_t n) {
  uint32_t table[256];
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
    table[i] = c;
  }
  uint32_t crc = 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; ++i)
    crc = table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}
