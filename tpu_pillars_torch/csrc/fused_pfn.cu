// K2 fused PFN: pillar features straight from the emit table.
//
// Replaces tpu_pillars/ops/fused_pfn.py _fpfn_kernel (wrapper
// pfn_from_table). For every pillar row:
//     relu(max_{j < cnt} (W_eff^T r'_j) + t)     (0 where cnt == 0)
// with t the decoration bias from the meta sums and the cell centre
// (fold_decoration's w_dec rows [w_xc, w_yc, w_zc, -w_x, -w_y, b]).
// On the TPU the F x C product ran as one kron(I_N, W_eff) block-diagonal
// MXU matmul with a log2(N) ladder of lane rolls for the max; with F = 4
// that product is tiny, so here each thread owns one (pillar, channel) and
// walks the pillar's kept points with f32 CUDA-core multiply-adds, keeping
// the running max in a register. No power-of-two N is needed.
//
// Built with --fmad=false and written in the plain version's exact order of
// operations, so kernel and plain version agree bit for bit.
//
// Bound on this card: bytes — it reads the (rows, N*F) table and the meta
// once and writes (rows, C); the N*F*C multiply-adds per row are far below
// the f32 peak.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxF = 8;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fused_pfn_kernel(const float* __restrict__ table,
                 const float* __restrict__ meta,
                 const float* __restrict__ w_eff,
                 const float* __restrict__ w_dec, float* __restrict__ out,
                 int rows, int p_rows, int n_pts, int n_f, int c,
                 int w_grid, float x_min, float y_min, float vx, float vy) {
  const int ch = threadIdx.x;
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= rows) return;
  const int b = r / p_rows;
  const int p = r - b * p_rows;
  const float* m_b = meta + (size_t)b * 8 * p_rows;

  float w[kMaxF];
  for (int f = 0; f < n_f; ++f) w[f] = w_eff[f * c + ch];

  const float cnt = m_b[p];
  const float* row = table + (size_t)r * n_pts * n_f;
  // the plain version masks slots j >= cnt to -1e9 before the max
  float smax = cnt < (float)n_pts ? -1e9f : -INFINITY;
  for (int j = 0; (float)j < cnt && j < n_pts; ++j) {
    const float* x = row + j * n_f;
    float u = x[0] * w[0];
    for (int f = 1; f < n_f; ++f) u = u + x[f] * w[f];
    smax = fmaxf(smax, u);
  }

  const int pid = (int)m_b[p_rows + p];
  const float col = (float)(pid % w_grid);
  const float rw = (float)(pid / w_grid);
  const float cx = x_min + (col + 0.5f) * vx;
  const float cy = y_min + (rw + 0.5f) * vy;
  const float inv_cnt = 1.0f / fmaxf(cnt, 1.0f);
  const float mx = m_b[2 * p_rows + p] * inv_cnt;
  const float my = m_b[3 * p_rows + p] * inv_cnt;
  const float mz = m_b[4 * p_rows + p] * inv_cnt;
  float t = w_dec[5 * c + ch] - mx * w_dec[0 * c + ch];
  t = t - my * w_dec[1 * c + ch];
  t = t - mz * w_dec[2 * c + ch];
  t = t - cx * w_dec[3 * c + ch];
  t = t - cy * w_dec[4 * c + ch];
  out[(size_t)r * c + ch] = cnt > 0.0f ? fmaxf(smax + t, 0.0f) : 0.0f;
}

}  // namespace

// table (rows, n_pts * F), meta (B, 8, p_rows) with rows = B * p_rows,
// w_eff (F, C), w_dec (8, C) -> out (rows, C). F <= 8, C <= 256.
extern "C" int fused_pfn(const float* table, const float* meta,
                         const float* w_eff, const float* w_dec, float* out,
                         int rows, int p_rows, int n_pts, int n_f, int c,
                         int w_grid, float x_min, float y_min, float vx,
                         float vy, cudaStream_t stream) {
  if (n_f > kMaxF || c > kThreads || c <= 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int per_block = kThreads / c;
  const dim3 block(c, per_block);
  const int grid = (rows + per_block - 1) / per_block;
  fused_pfn_kernel<<<grid, block, 0, stream>>>(table, meta, w_eff, w_dec, out,
                                               rows, p_rows, n_pts, n_f, c,
                                               w_grid, x_min, y_min, vx, vy);
  return (int)cudaGetLastError();
}
