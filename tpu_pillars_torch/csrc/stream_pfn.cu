// K11 streaming front end: sorted, cell-centred points -> BEV canvas, with
// no pillar table.
//
// Replaces tpu_pillars/ops/stream_pfn.py _stream_kernel (wrapper
// stream_canvas_from_sorted). For each of the first P runs of equal pillar
// id in a sample's sorted stream (row start_row[b, p], from the torch
// sidecar), over the run's kept points (its first N rows):
//     canvas[b, gid] = relu(max_s (W_eff^T r'_s) + t)
// with t the decoration bias from the kept points' x/y/z sums and the cell
// centre (fold_decoration's w_dec rows [w_xc, w_yc, w_zc, -w_x, -w_y, b]).
// The TPU kernel staged two 1,024-point chunks, reduced every run with a
// prefix-doubling ladder of rolls and placed the results through a ring
// window with bf16 one-hot matmuls: placement machinery for a machine with
// no scattered stores. Here each cell has exactly one source, so one warp
// per run computes it and stores it straight into a zeroed canvas.
//
// Lane s loads slot s of the run (N <= 32, so one row per lane; the kept
// lanes are 0..cnt-1 because a run is contiguous, and no lane reads past
// the sample's end). The slots are then broadcast in order with shuffles:
// every lane keeps the running max of its channels (lane, lane + 32, ...)
// and the x/y/z sums in slot order, the plain version's order. Built with
// --fmad=false, so kernel and plain version round alike.
//
// Bound on this card: bytes — the (B, H, W, C) canvas written once
// dominates (the kept points, their ids and start_row are a few MB); the
// F * C multiply-adds per kept point are far below the f32 peak.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxF = 8;
constexpr int kMaxCPerLane = 4;   // C <= 128
constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
stream_pfn_kernel(const int* __restrict__ gid, const float* __restrict__ pts,
                  const int* __restrict__ start_row,
                  const float* __restrict__ w_eff,
                  const float* __restrict__ w_dec, float* __restrict__ canvas,
                  int batch, int m, int p_max, int n_max, int n_f, int c,
                  int w_grid, int hw, float x_min, float y_min, float vx,
                  float vy) {
  const int lane = threadIdx.x & 31;
  const long long task =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= (long long)batch * p_max) return;   // uniform across the warp
  const int j = start_row[task];
  if (j < 0) return;
  const int b = (int)(task / p_max);
  const int* g_b = gid + (size_t)b * m;
  const int g = g_b[j];
  const int row = j + lane;
  const bool kept = lane < n_max && row < m && g_b[row] == g;
  const int cnt = __popc(__ballot_sync(0xffffffffu, kept));

  float x[kMaxF];
  const float* p_row = pts + ((size_t)b * m + (kept ? row : j)) * n_f;
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) x[f] = (kept && f < n_f) ? p_row[f] : 0.0f;

  float w[kMaxCPerLane][kMaxF];
  float umax[kMaxCPerLane];
#pragma unroll
  for (int k = 0; k < kMaxCPerLane; ++k) {
    const int ch = lane + 32 * k;
    umax[k] = -INFINITY;
#pragma unroll
    for (int f = 0; f < kMaxF; ++f)
      w[k][f] = (ch < c && f < n_f) ? w_eff[f * c + ch] : 0.0f;
  }

  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int s = 0; s < cnt; ++s) {      // cnt is uniform across the warp
    float xs[kMaxF];
#pragma unroll
    for (int f = 0; f < kMaxF; ++f)
      xs[f] = __shfl_sync(0xffffffffu, x[f], s);
    sx = sx + xs[0];
    sy = sy + xs[1];
    sz = sz + xs[2];
#pragma unroll
    for (int k = 0; k < kMaxCPerLane; ++k) {
      float u = xs[0] * w[k][0];
#pragma unroll
      for (int f = 1; f < kMaxF; ++f)
        if (f < n_f) u = u + xs[f] * w[k][f];
      umax[k] = fmaxf(umax[k], u);
    }
  }

  const float inv_cnt = 1.0f / fmaxf((float)cnt, 1.0f);
  const float mx = sx * inv_cnt;
  const float my = sy * inv_cnt;
  const float mz = sz * inv_cnt;
  const float col = (float)(g % w_grid);
  const float rw = (float)(g / w_grid);
  const float cx = x_min + (col + 0.5f) * vx;
  const float cy = y_min + (rw + 0.5f) * vy;
  float* out = canvas + ((size_t)b * hw + g) * c;
#pragma unroll
  for (int k = 0; k < kMaxCPerLane; ++k) {
    const int ch = lane + 32 * k;
    if (ch >= c) break;
    float t = w_dec[5 * c + ch] - mx * w_dec[0 * c + ch];
    t = t - my * w_dec[1 * c + ch];
    t = t - mz * w_dec[2 * c + ch];
    t = t - cx * w_dec[3 * c + ch];
    t = t - cy * w_dec[4 * c + ch];
    out[ch] = fmaxf(umax[k] + t, 0.0f);
  }
}

}  // namespace

// gid (B, M) int32 ascending (H*W sentinel), pts (B, M, F) f32 cell-centred,
// start_row (B, P) int32 (-1: no run), w_eff (F, C), w_dec (8, C) ->
// canvas (B, H*W, C) f32, zeroed by the caller. F <= 8, N <= 32, C <= 128.
extern "C" int stream_pfn(const int* gid, const float* pts,
                          const int* start_row, const float* w_eff,
                          const float* w_dec, float* canvas, int batch, int m,
                          int p_max, int n_max, int n_f, int c, int w_grid,
                          int hw, float x_min, float y_min, float vx, float vy,
                          cudaStream_t stream) {
  if (n_f < 3 || n_f > kMaxF || n_max < 1 || n_max > 32 || c < 1 ||
      c > 32 * kMaxCPerLane)
    return (int)cudaErrorInvalidValue;
  const long long tasks = (long long)batch * p_max;
  if (tasks == 0 || m == 0) return 0;
  const int grid = (int)((tasks + kWarps - 1) / kWarps);
  stream_pfn_kernel<<<grid, kWarps * 32, 0, stream>>>(
      gid, pts, start_row, w_eff, w_dec, canvas, batch, m, p_max, n_max, n_f,
      c, w_grid, hw, x_min, y_min, vx, vy);
  return (int)cudaGetLastError();
}
