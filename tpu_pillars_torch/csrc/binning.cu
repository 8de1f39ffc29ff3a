// K8 binning: per-point rank within its cell + saturated per-cell histogram.
//
// Replaces tpu_pillars/ops/binning_pallas.py _rank_kernel (wrapper
// rank_and_hist, caller pillarize_batch_binned). The TPU kernel walked a
// sequential grid of 1,024-point chunks and carried the running histogram
// in VMEM, doing the lookup and the update as one-hot bf16 matmuls. Hopper
// blocks run in no order, and integer atomics give deterministic counts
// but not deterministic ranks (rank(i) = #{j < i in the same cell} depends
// on input order). So one block walks one sample's chunks in order:
//   * the count of the point's cell before the chunk comes from a global
//     per-sample int32 histogram (read through L2, after the barrier that
//     follows the previous chunk's atomics);
//   * the in-chunk exclusive count comes from comparing the point's cell
//     with the cells of the earlier slots, staged in shared memory;
//   * after a barrier, each valid point adds one to its cell with an
//     integer atomic.
// rank = min(count before + in-chunk count, 64) = min(exact rank, 64), so
// it does not depend on the chunking: exact below 64, 64 at and above (the
// TPU kernel's contract is "exact below 64, >= 64"). The histogram is
// min(count, 64) as f32. Invalid points (row outside [0, h_bins) or col
// outside [0, w_pad)) get rank 0 and touch nothing.
//
// Bound on this card: bytes (rows and cols read, rank and histogram
// written). This first design runs one block per sample and does a
// quadratic in-chunk comparison, so it is far from that bound.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;
constexpr int kCap = 64;

__global__ void __launch_bounds__(kChunk)
rank_hist_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                 int* __restrict__ rank, int* __restrict__ count,
                 float* __restrict__ hist, int m, int h_bins, int w_pad) {
  __shared__ int s_cell[kChunk];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const long long cells = (long long)h_bins * w_pad;
  const int* r_b = rows + (long long)b * m;
  const int* c_b = cols + (long long)b * m;
  int* rank_b = rank + (long long)b * m;
  int* cnt_b = count + b * cells;

  for (int c0 = 0; c0 < m; c0 += kChunk) {
    const int i = c0 + t;
    int cell = -1;
    if (i < m) {
      const int r = r_b[i], c = c_b[i];
      if (r >= 0 && r < h_bins && c >= 0 && c < w_pad) cell = r * w_pad + c;
    }
    s_cell[t] = cell;
    __syncthreads();
    if (cell >= 0) {
      const int before = min(__ldcg(cnt_b + cell), kCap);
      int excl = 0;
      for (int j = 0; j < t; ++j) excl += s_cell[j] == cell;
      rank_b[i] = min(before + excl, kCap);
    } else if (i < m) {
      rank_b[i] = 0;
    }
    __syncthreads();  // every read of this chunk precedes its updates
    if (cell >= 0) atomicAdd(cnt_b + cell, 1);
    __syncthreads();
  }

  float* h_b = hist + b * cells;
  for (long long e = t; e < cells; e += kChunk) {
    h_b[e] = (float)min(__ldcg(cnt_b + e), kCap);
  }
}

}  // namespace

// rows, cols (B, M) int32 (a row outside [0, h_bins) marks an invalid point)
// -> rank (B, M) int32, hist (B, h_bins, w_pad) f32; count (B, h_bins,
// w_pad) int32 scratch zeroed by the caller.
extern "C" int rank_and_hist(const int* rows, const int* cols, int* rank,
                             int* count, float* hist, int batch, int m,
                             int h_bins, int w_pad, cudaStream_t stream) {
  if (batch == 0) return 0;
  rank_hist_kernel<<<batch, kChunk, 0, stream>>>(rows, cols, rank, count,
                                                 hist, m, h_bins, w_pad);
  return (int)cudaGetLastError();
}
