// Native per-frame sample loader: the two host loops of a KITTI sample, each
// in one pass, with a plain C interface loaded by ctypes
// (sparse_pooling_tpu_torch/native/sample_loader.py).
//
//   spt_unfilter_png  undoes the PNG row filters of an inflated 8-bit RGB or
//                     RGBA image (the IDAT stream, inflated by Python's zlib)
//                     and writes its RGB rows straight into the top left of
//                     the caller's H x W x 3 canvas: no intermediate image,
//                     no pad copy.
//   spt_load_points   reads a velodyne .bin once; one fused pass does the
//                     velo -> rect affine map (f32), the image-frustum test
//                     and the BEV area-extents test, writing survivors in
//                     scan order. Same operations as
//                     data/pointcloud.load_points_filtered.
//
// The points loop is a copy of sparse_pooling_tpu/native/sample_loader/
// sample_loader.cpp. Its PNG decode goes through libpng there; this copy
// needs no library beyond the C++ runtime (the machine with the card has no
// libpng headers), so it takes over only the part that costs: the per-byte
// filter loop.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------- PNG

static inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// raw: h rows of (1 filter byte + w * channels bytes), the inflated IDAT
// stream of a non-interlaced 8-bit image with channels 3 (RGB) or 4 (RGBA).
// The rows are unfiltered in place (raw is the caller's scratch), and each
// row's RGB goes to canvas row y (row-major, canvas_w * 3 bytes a row; alpha
// is dropped). Returns 0 ok; 1 malformed (a filter type above 4, or a bad
// channel count); 2 the image exceeds the canvas.
int spt_unfilter_png(uint8_t* raw, int h, int w, int channels, uint8_t* canvas, int canvas_h,
                     int canvas_w) {
  if (channels != 3 && channels != 4) return 1;
  if (h > canvas_h || w > canvas_w) return 2;
  const size_t stride = (size_t)w * channels;
  const int bpp = channels;
  uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    uint8_t* row = raw + (size_t)y * (stride + 1);
    const int filter = row[0];
    uint8_t* cur = row + 1;
    switch (filter) {
      case 0:  // None
        break;
      case 1:  // Sub
        for (size_t i = bpp; i < stride; ++i) cur[i] = (uint8_t)(cur[i] + cur[i - bpp]);
        break;
      case 2:  // Up
        if (prev)
          for (size_t i = 0; i < stride; ++i) cur[i] = (uint8_t)(cur[i] + prev[i]);
        break;
      case 3:  // Average
        for (size_t i = 0; i < stride; ++i) {
          const int left = i >= (size_t)bpp ? cur[i - bpp] : 0;
          const int up = prev ? prev[i] : 0;
          cur[i] = (uint8_t)(cur[i] + ((left + up) >> 1));
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < stride; ++i) {
          const int left = i >= (size_t)bpp ? cur[i - bpp] : 0;
          const int up = prev ? prev[i] : 0;
          const int up_left = (prev && i >= (size_t)bpp) ? prev[i - bpp] : 0;
          cur[i] = (uint8_t)(cur[i] + paeth(left, up, up_left));
        }
        break;
      default:
        return 1;
    }
    uint8_t* dst = canvas + (size_t)y * canvas_w * 3;
    if (channels == 3) {
      std::memcpy(dst, cur, stride);
    } else {
      for (int x = 0; x < w; ++x) {
        dst[x * 3] = cur[x * 4];
        dst[x * 3 + 1] = cur[x * 4 + 1];
        dst[x * 3 + 2] = cur[x * 4 + 2];
      }
    }
    prev = cur;
  }
  return 0;
}

// ---------------------------------------------------------------- points

// velodyne .bin -> camera-frame filtered points, one fused pass.
//   m:  velo->rect rows (3x4, row-major, f32)  [from FrameCalib.velo_to_rect]
//   p2: projection rows (3x4, row-major, f32)
//   ext: x_min,x_max,y_min,y_max,z_min,z_max (BEV area extents, cam frame)
// Writes up to `cap` survivors into out (cap x 3, f32) in scan order and
// stores the TOTAL survivor count in n_total (callers detect overflow when
// n_total > cap and take the numpy twin's seeded subsample instead).
// Returns 0 ok, 1 io error.
int spt_load_points(const char* velo_path, const float* m, const float* p2, int img_h, int img_w,
                    const float* ext, float* out, int cap, int* n_total) {
  FILE* fp = fopen(velo_path, "rb");
  if (!fp) return 1;
  // stream in chunks: no full-scan buffer, stays in L2
  constexpr int kChunk = 4096;
  static thread_local float buf[kChunk * 4];
  const float wm1 = (float)img_w - 1.0f, hm1 = (float)img_h - 1.0f;
  int kept = 0, total = 0;
  size_t n;
  while ((n = fread(buf, sizeof(float) * 4, kChunk, fp)) > 0) {
    for (size_t i = 0; i < n; ++i) {
      const float vx = buf[i * 4], vy = buf[i * 4 + 1], vz = buf[i * 4 + 2];
      const float x = m[0] * vx + m[1] * vy + m[2] * vz + m[3];
      const float y = m[4] * vx + m[5] * vy + m[6] * vz + m[7];
      const float z = m[8] * vx + m[9] * vy + m[10] * vz + m[11];
      if (!(z > 0.0f)) continue;  // behind the image plane (and NaN-safe)
      const float u_n = p2[0] * x + p2[1] * y + p2[2] * z + p2[3];
      const float v_n = p2[4] * x + p2[5] * y + p2[6] * z + p2[7];
      const float w_n = p2[8] * x + p2[9] * y + p2[10] * z + p2[11];
      const float u = u_n / w_n, v = v_n / w_n;
      if (!(u >= 0.0f && u <= wm1 && v >= 0.0f && v <= hm1)) continue;
      if (!(x >= ext[0] && x < ext[1] && y >= ext[2] && y < ext[3] && z >= ext[4] && z < ext[5]))
        continue;
      if (kept < cap) {
        out[kept * 3] = x;
        out[kept * 3 + 1] = y;
        out[kept * 3 + 2] = z;
        ++kept;
      }
      ++total;
    }
  }
  const bool failed = ferror(fp) != 0;
  fclose(fp);
  if (failed) return 1;
  *n_total = total;
  return 0;
}

}  // extern "C"
