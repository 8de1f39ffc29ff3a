// K6 PFN: linear (BatchNorm folded) + bias + ReLU + masked max over points.
//
// Replaces tpu_pillars/ops/pfn_pallas.py _pfn_kernel (wrapper pfn_fused).
// For every pillar p and channel ch:
//     out[p, ch] = max_{j : mask[p, j]} relu(sum_f x[p, j, f] * w[f, ch] + b[ch])
// and 0 for a pillar with no valid point. On the TPU one (BLOCK*N, D) x
// (D, C) MXU product per grid step fed a VMEM max. With D = 9 the product is
// tiny, so here one warp owns one pillar: the pillar's N x D floats (36-byte
// rows, not 16-byte aligned) and its mask are staged in shared memory, W and
// b once per block, and each lane owns channels lane, lane + 32, ... (two at
// C = 64). A lane walks the valid slots, skips the masked ones and keeps a
// running max in a register; the (P, N, C) activation never exists.
//
// Built with --fmad=false, and the D products are summed in the plain
// version's order (f = 0, 1, ...), then the bias, then ReLU, so kernel and
// plain version round the same f32 operations.
//
// Bound on this card: the (P, N) mask and the valid slots' rows (36 B each
// at D = 9) are read once and (P, C) written; each valid slot costs
// 2 * D * C flops (1,152 at C = 64). With most slots valid that is above the
// f32 ridge of ~20 flops per byte and operations bound it; with few valid
// slots (about 8% on lidar-like sweeps at the full config) the bytes do.
// The kernel reads every slot's row, masked or not: the row loads do not
// wait on the mask, and staging only the valid rows (the mask first, then
// the rows it selects) measured slower on the H100, since each warp then
// waits for two global loads in a row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // pillars per block
constexpr int kMaxPerLane = 8;  // C <= 256

__global__ void __launch_bounds__(kWarps * 32)
pfn_kernel(const float* __restrict__ feats, const uint8_t* __restrict__ mask,
           const float* __restrict__ w, const float* __restrict__ bias,
           float* __restrict__ out, int p, int n, int d, int c) {
  extern __shared__ float smem[];
  float* s_w = smem;                      // d * c
  float* s_b = s_w + d * c;               // c
  float* s_x = s_b + c;                   // kWarps * n * d
  uint8_t* s_m = reinterpret_cast<uint8_t*>(s_x + kWarps * n * d);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < d * c; i += blockDim.x) s_w[i] = w[i];
  for (int i = threadIdx.x; i < c; i += blockDim.x) s_b[i] = bias[i];

  const long long pil = (long long)blockIdx.x * kWarps + warp;
  const bool live = pil < p;
  float* x = s_x + warp * n * d;
  uint8_t* m = s_m + warp * n;
  if (live) {
    const float* src = feats + pil * n * d;
    for (int i = lane; i < n * d; i += 32) x[i] = src[i];
    for (int j = lane; j < n; j += 32) m[j] = mask[pil * n + j];
  }
  __syncthreads();
  if (!live) return;

  for (int k = 0; k < kMaxPerLane; ++k) {
    const int ch = lane + 32 * k;
    if (ch >= c) break;
    const float bc = s_b[ch];
    float smax = 0.0f;
    bool any = false;
    for (int j = 0; j < n; ++j) {
      if (!m[j]) continue;
      const float* xj = x + j * d;
      float u = xj[0] * s_w[ch];
      for (int f = 1; f < d; ++f) u = u + xj[f] * s_w[f * c + ch];
      u = u + bc;
      u = fmaxf(u, 0.0f);
      smax = any ? fmaxf(smax, u) : u;
      any = true;
    }
    out[pil * c + ch] = any ? smax : 0.0f;
  }
}

}  // namespace

// features (P, N, D) f32, mask (P, N) bool, w (D, C), b (C,) -> out (P, C).
// C <= 256; the shared memory (W, b and 8 pillars) must fit in 227 KB.
extern "C" int pfn_fused(const float* feats, const uint8_t* mask,
                         const float* w, const float* bias, float* out, int p,
                         int n, int d, int c, cudaStream_t stream) {
  if (c <= 0 || c > 32 * kMaxPerLane || d <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (p == 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)d * c + c
                                       + (size_t)kWarps * n * d)
                      + (size_t)kWarps * n;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pfn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (int)((p + kWarps - 1) / kWarps);
  pfn_kernel<<<grid, kWarps * 32, smem, stream>>>(feats, mask, w, bias, out,
                                                  p, n, d, c);
  return (int)cudaGetLastError();
}
