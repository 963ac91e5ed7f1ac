// Native KITTI prediction-row formatter: the port's copy of the JAX
// package's (sparse_pooling_tpu/native/pred_format/pred_format.cpp).
//
// Renders the prediction writer's numeric block into the txt file's bytes
// with snprintf: correctly rounded %.6f, byte-identical to CPython's
// formatting of the same doubles (runtime/predictions.py keeps the Python
// formatter as its twin). The ctypes call releases the GIL, so the
// evaluator's writer thread formats while the loader threads run.
//
// Row format: "<name> -1 -1 alpha x1 y1 x2 y2 h w l x y z ry score\n",
// every numeric field %.6f. Built by
// sparse_pooling_tpu_torch/native/pred_format.py with g++ -O2 -std=c++17.

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// num:   [n_rows, 13] float64 (alpha x1 y1 x2 y2 h w l x y z ry score)
// cls:   [n_rows] int32 indices into names
// names: '\n'-joined class names (no trailing newline needed)
// out:   caller buffer of cap bytes; receives the full file content
// returns total length written, or -1 on overflow / bad class index.
int spt_format_kitti_rows(const double* num, const int32_t* cls, int n_rows,
                          const char* names, char* out, int cap) {
  // split names once
  const char* name_ptr[64];
  int name_len[64];
  int n_names = 0;
  const char* p = names;
  while (*p && n_names < 64) {
    const char* e = strchr(p, '\n');
    size_t len = e ? (size_t)(e - p) : strlen(p);
    name_ptr[n_names] = p;
    name_len[n_names] = (int)len;
    ++n_names;
    if (!e) break;
    p = e + 1;
  }
  int pos = 0;
  for (int r = 0; r < n_rows; ++r) {
    int c = cls[r];
    if (c < 0 || c >= n_names) return -1;
    if (pos + name_len[c] + 16 > cap) return -1;
    memcpy(out + pos, name_ptr[c], name_len[c]);
    pos += name_len[c];
    memcpy(out + pos, " -1 -1", 6);
    pos += 6;
    const double* row = num + (size_t)r * 13;
    int w = snprintf(out + pos, cap - pos,
                     " %.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f"
                     " %.6f %.6f %.6f\n",
                     row[0], row[1], row[2], row[3], row[4], row[5], row[6],
                     row[7], row[8], row[9], row[10], row[11], row[12]);
    if (w < 0 || pos + w >= cap) return -1;
    pos += w;
  }
  return pos;
}

}  // extern "C"
