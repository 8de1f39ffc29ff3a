// K9 BEV block gather: pillar rows with ascending ids -> dense canvas.
//
// Replaces tpu_pillars/ops/bev_pallas.py _bev_kernel (wrapper
// scatter_to_bev_emit). Same contract as K3 (csrc/bev_scatter.cu), but a
// gather rather than a scatter: the pillarizers emit each sample's pillars
// in ascending id order, so the pillars that land in any run of canvas
// cells form one contiguous range of rows. On the TPU a broadcast-compare
// count gave each canvas block its row range [lo, hi) and three bf16
// one-hot matmuls expanded the staged rows. Here one block owns one
// (sample, tile of kTileCells cells):
//   * two threads binary-search the sample's ascending where(mask, pid, HW)
//     for the tile's [lo, hi);
//   * the rows in [lo, hi) mark their cell in a shared-memory map;
//   * the block writes every canvas element of the tile exactly once — the
//     pillar's feature or zero — so the canvas needs no zero-fill pass and
//     no atomics, and the result is bit-exact.
//
// Bound on this card: bytes — the canvas write (B * H * W * C * 4 bytes)
// dominates; the pillar rows, ids and mask are read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileCells = 128;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bev_gather_kernel(const float* __restrict__ feats,
                  const int* __restrict__ pid,
                  const uint8_t* __restrict__ mask,
                  float* __restrict__ canvas, int p, int c, int hw,
                  bool vec) {
  __shared__ int s_map[kTileCells];
  __shared__ int s_range[2];
  const int b = blockIdx.y;
  const int cell0 = blockIdx.x * kTileCells;
  const int ncell = min(kTileCells, hw - cell0);
  const int* pid_b = pid + (long long)b * p;
  const uint8_t* m_b = mask + (long long)b * p;

  if (threadIdx.x < 2) {
    // first row whose effective id reaches the bound
    const int target = cell0 + threadIdx.x * ncell;
    int lo = 0, hi = p;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int e = m_b[mid] ? pid_b[mid] : hw;
      if (e < target) lo = mid + 1; else hi = mid;
    }
    s_range[threadIdx.x] = lo;
  }
  for (int i = threadIdx.x; i < kTileCells; i += blockDim.x) s_map[i] = -1;
  __syncthreads();
  for (int k = s_range[0] + threadIdx.x; k < s_range[1]; k += blockDim.x) {
    // in range whenever the ids ascend; the guard keeps a caller that
    // breaks the precondition inside the map
    const int off = (m_b[k] ? pid_b[k] : hw) - cell0;
    if (off >= 0 && off < ncell) s_map[off] = k;
  }
  __syncthreads();

  const float* f_b = feats + (long long)b * p * c;
  float* out = canvas + ((long long)b * hw + cell0) * c;
  if (vec) {
    const int c4 = c >> 2;
    const int n = ncell * c4;
    float4* out4 = reinterpret_cast<float4*>(out);
    const float4* f4 = reinterpret_cast<const float4*>(f_b);
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int cell = e / c4;
      const int k = s_map[cell];
      out4[e] = k >= 0 ? f4[(long long)k * c4 + (e - cell * c4)]
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    const int n = ncell * c;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int cell = e / c;
      const int k = s_map[cell];
      out[e] = k >= 0 ? f_b[(long long)k * c + (e - cell * c)] : 0.0f;
    }
  }
}

}  // namespace

// feats (B, P, C) f32, pid (B, P) int32, mask (B, P) bool, with
// where(mask, pid, hw) ascending per sample -> canvas (B, hw, C) f32, every
// element written (the caller may pass uninitialised memory).
extern "C" int bev_gather(const float* feats, const int* pid,
                          const uint8_t* mask, float* canvas, int batch,
                          int p, int c, int hw, cudaStream_t stream) {
  if (batch == 0 || hw == 0 || c == 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  // 16-byte stores where the rows allow them
  const bool vec = (c & 3) == 0
                   && (((uintptr_t)feats | (uintptr_t)canvas) & 15) == 0;
  const dim3 grid((hw + kTileCells - 1) / kTileCells, batch);
  bev_gather_kernel<<<grid, kThreads, 0, stream>>>(feats, pid, mask, canvas,
                                                   p, c, hw, vec);
  return (int)cudaGetLastError();
}
