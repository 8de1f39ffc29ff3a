// Native host-side point-cloud IO for the data-loader tier of the port —
// a copy of tpu_pillars/native/pointcloud.cc, built by the port's own loader.
//
// The reference's L0 loader (lyft_dataset_sdk) does np.fromfile + Python
// slicing per sweep; this does one pass in C++: read the float32 .bin,
// range-crop, select feature columns, and write straight into the caller's
// pre-allocated static (max_points, n_features) buffer (already padded) —
// the exact array the detector's padded batch holds. Exposed via ctypes; see
// tpu_pillars_torch/data/native_io.py (which also carries the NumPy path and
// builds this file with `g++ -O3 -shared -fPIC` into
// tpu_pillars_torch/_build/, under a name that hashes the source and flags).

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Returns the number of IN-RANGE points in the file (which may EXCEED
// max_points — the caller computes kept = min(total, max_points) and
// overflow = total - kept), or -1 on IO error. Only the first max_points
// in-range points are written; the rest are counted so truncation by the
// static budget is reported, never silent.
// in_stride: floats per point in the file (Lyft: 5 = x,y,z,intensity,ring)
// n_take:    leading feature columns to keep (detector: 4)
// out:       (max_points, n_take) float32, caller-initialized (padding value)
// crop:      [x_min, x_max, y_min, y_max, z_min, z_max]
int64_t load_crop_pad(const char* path, int64_t in_stride, int64_t n_take,
                      float* out, int64_t max_points, const float* crop) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;

  constexpr int64_t kChunkPts = 16384;
  float* buf = new float[kChunkPts * in_stride];
  int64_t in_range = 0;
  const float x0 = crop[0], x1 = crop[1], y0 = crop[2], y1 = crop[3],
              z0 = crop[4], z1 = crop[5];

  for (;;) {
    size_t got = std::fread(buf, sizeof(float) * in_stride, kChunkPts, f);
    if (got == 0) break;
    for (size_t i = 0; i < got; ++i) {
      const float* p = buf + i * in_stride;
      const float x = p[0], y = p[1], z = p[2];
      if (x < x0 || x >= x1 || y < y0 || y >= y1 || z < z0 || z > z1)
        continue;
      if (in_range < max_points)
        std::memcpy(out + in_range * n_take, p, sizeof(float) * n_take);
      ++in_range;
    }
    if (got < static_cast<size_t>(kChunkPts)) break;
  }
  delete[] buf;
  std::fclose(f);
  return in_range;
}

// Multi-sweep variant: applies a 3x4 row-major rigid transform [R | t] to
// xyz and appends a constant dt as the last output column.
// out: (max_points, n_take + 1); returns the sweep's IN-RANGE point count
// (may exceed the remaining budget max_points - start_row; the caller
// computes rows actually written and the overflow), or -1 on IO error.
int64_t load_transform_crop_pad(const char* path, int64_t in_stride,
                                int64_t n_take, const float* rt, float dt,
                                float* out, int64_t max_points,
                                const float* crop, int64_t start_row) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;

  constexpr int64_t kChunkPts = 16384;
  float* buf = new float[kChunkPts * in_stride];
  int64_t written = start_row;
  int64_t in_range = 0;
  const int64_t out_stride = n_take + 1;
  const float x0 = crop[0], x1 = crop[1], y0 = crop[2], y1 = crop[3],
              z0 = crop[4], z1 = crop[5];

  for (;;) {
    size_t got = std::fread(buf, sizeof(float) * in_stride, kChunkPts, f);
    if (got == 0) break;
    for (size_t i = 0; i < got; ++i) {
      const float* p = buf + i * in_stride;
      const float x = rt[0] * p[0] + rt[1] * p[1] + rt[2] * p[2] + rt[3];
      const float y = rt[4] * p[0] + rt[5] * p[1] + rt[6] * p[2] + rt[7];
      const float z = rt[8] * p[0] + rt[9] * p[1] + rt[10] * p[2] + rt[11];
      if (x < x0 || x >= x1 || y < y0 || y >= y1 || z < z0 || z > z1)
        continue;
      ++in_range;
      if (written >= max_points) continue;
      float* o = out + written * out_stride;
      o[0] = x; o[1] = y; o[2] = z;
      for (int64_t k = 3; k < n_take; ++k) o[k] = p[k];
      o[n_take] = dt;
      ++written;
    }
    if (got < static_cast<size_t>(kChunkPts)) break;
  }
  delete[] buf;
  std::fclose(f);
  return in_range;
}

}  // extern "C"
