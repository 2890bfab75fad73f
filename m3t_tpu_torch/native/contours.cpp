// Border following for binary masks: the contours that OpenCV's
// findContours(mask, RETR_LIST, CHAIN_APPROX_NONE) returns, in its order, each from its
// start pixel and in its direction (Suzuki and Abe, "Topological structural analysis of
// digitized binary images by border following", 1985, as OpenCV implements it).
//
// The mask is copied into a frame one pixel wider on every side, so that pixels outside
// the image are 0.  A raster scan starts an outer border at a 1-pixel whose left
// neighbour is 0, and a hole border at a pixel >= 1 whose right neighbour is 0.  Each
// border is followed with 8-connectivity; a followed pixel is marked 2, or -126 where
// its right neighbour was examined and found 0, which keeps it from starting another
// border.  Contours come out in the reverse of the order in which the scan found them.
//
// Built into the same host library as rasterizer.cpp (m3t_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Direction s: 0 right, 1 up-right, 2 up, 3 up-left, 4 left, 5 down-left, 6 down,
// 7 down-right (image rows grow downwards).
const int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int kDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};
const int8_t kVisited = 2;
const int8_t kVisitedRightEnd = static_cast<int8_t>(2 | -128);

// Follows the border that starts at frame pixel (x0, y0) and appends its points (image
// coordinates, x then y) to out.
void follow(int8_t* frame, int step, int x0, int y0, bool hole, std::vector<int32_t>& out) {
  int deltas[16];
  for (int s = 0; s < 16; ++s) deltas[s] = kDy[s & 7] * step + kDx[s & 7];
  int8_t* const i0 = frame + static_cast<long long>(y0) * step + x0;
  int x = x0 - 1, y = y0 - 1;

  // The last pixel of the border: the first nonzero neighbour clockwise from the
  // start's outside.
  int s_end = hole ? 0 : 4;
  int s = s_end;
  int8_t* i1;
  do {
    s = (s - 1) & 7;
    i1 = i0 + deltas[s];
  } while (*i1 == 0 && s != s_end);

  if (s == s_end) {  // a single pixel
    *i0 = kVisitedRightEnd;
    out.push_back(x);
    out.push_back(y);
    return;
  }
  int8_t* i3 = i0;
  for (;;) {
    // The next border pixel: the first nonzero neighbour counter-clockwise from the
    // direction the border came from.
    s_end = s;
    int8_t* i4 = i3;
    while (s < 15) {
      i4 = i3 + deltas[++s];
      if (*i4 != 0) break;
    }
    s &= 7;
    if (static_cast<unsigned>(s - 1) < static_cast<unsigned>(s_end)) {
      *i3 = kVisitedRightEnd;  // its right neighbour was examined and is 0
    } else if (*i3 == 1) {
      *i3 = kVisited;
    }
    out.push_back(x);
    out.push_back(y);
    x += kDx[s];
    y += kDy[s];
    if (i4 == i0 && i3 == i1) break;
    i3 = i4;
    s = (s + 4) & 7;
  }
}

}  // namespace

extern "C" {

// mask: (h, w) bytes, nonzero = foreground.  Writes the contours' points (x, y int32
// pairs, contour after contour) to xy and their point counts to lengths when they fit
// (xy_cap points, lengths_cap contours); sets *n_contours and returns the total number
// of points either way, so that a caller whose buffers were short can call again.
long long m3t_find_contours(const uint8_t* mask, int h, int w, int32_t* xy,
                            long long xy_cap, int32_t* lengths, int lengths_cap,
                            int* n_contours) {
  const int step = w + 2;
  std::vector<int8_t> frame(static_cast<size_t>(h + 2) * step, 0);
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = mask + static_cast<size_t>(y) * w;
    int8_t* dst = frame.data() + static_cast<size_t>(y + 1) * step + 1;
    for (int x = 0; x < w; ++x) dst[x] = src[x] != 0;
  }
  std::vector<std::vector<int32_t>> found;
  for (int y = 1; y <= h; ++y) {
    int8_t* row = frame.data() + static_cast<size_t>(y) * step;
    int8_t prev = 0;
    for (int x = 1; x <= w; ++x) {
      const int8_t p = row[x];
      if (p == prev) continue;
      if (prev == 0 && p == 1) {
        found.emplace_back();
        follow(frame.data(), step, x, y, false, found.back());
      } else if (p == 0 && prev >= 1) {
        found.emplace_back();
        follow(frame.data(), step, x - 1, y, true, found.back());
      }
      prev = row[x];
    }
  }
  long long total = 0;
  for (const auto& c : found) total += static_cast<long long>(c.size() / 2);
  *n_contours = static_cast<int>(found.size());
  if (total <= xy_cap && static_cast<long long>(found.size()) <= lengths_cap) {
    int32_t* dst = xy;
    int k = 0;
    for (auto it = found.rbegin(); it != found.rend(); ++it, ++k) {
      std::memcpy(dst, it->data(), it->size() * sizeof(int32_t));
      dst += it->size();
      lengths[k] = static_cast<int32_t>(it->size() / 2);
    }
  }
  return total;
}

}  // extern "C"
