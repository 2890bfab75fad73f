// PNG scanline unfiltering (PNG specification, section 9: filter method 0).
//
// The inflated image data of a non-interlaced PNG is `height` rows, each a filter-type
// byte and `row_bytes` filtered bytes.  Sub, Average and Paeth read the byte `bpp`
// places to the left in the same row, already unfiltered, so each row is a serial
// recurrence from left to right: this loop is what numpy cannot vectorise.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a);
  const int pb = std::abs(p - b);
  const int pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// Unfilters `height` rows of `data` (each 1 + row_bytes bytes) into `out` (height *
// row_bytes bytes).  bpp: bytes per complete pixel, at least 1.  Returns 0, or 1 + the
// index of the first row whose filter type is not 0-4.
long long m3t_png_unfilter(const uint8_t* data, int height, long long row_bytes, int bpp,
                           uint8_t* out) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = data + static_cast<long long>(y) * (row_bytes + 1);
    const uint8_t filter = src[0];
    ++src;
    uint8_t* row = out + static_cast<long long>(y) * row_bytes;
    const uint8_t* up = y > 0 ? row - row_bytes : nullptr;
    switch (filter) {
      case 0:  // None
        for (long long x = 0; x < row_bytes; ++x) row[x] = src[x];
        break;
      case 1:  // Sub
        for (long long x = 0; x < row_bytes; ++x)
          row[x] = static_cast<uint8_t>(src[x] + (x >= bpp ? row[x - bpp] : 0));
        break;
      case 2:  // Up
        for (long long x = 0; x < row_bytes; ++x)
          row[x] = static_cast<uint8_t>(src[x] + (up ? up[x] : 0));
        break;
      case 3:  // Average
        for (long long x = 0; x < row_bytes; ++x) {
          const int a = x >= bpp ? row[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          row[x] = static_cast<uint8_t>(src[x] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (long long x = 0; x < row_bytes; ++x) {
          const int a = x >= bpp ? row[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          const int c = (up && x >= bpp) ? up[x - bpp] : 0;
          row[x] = static_cast<uint8_t>(src[x] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
