// K3 BEV scatter: pillar features -> dense (B, H*W, C) canvas.
//
// Replaces tpu_pillars/ops/bev_pallas.py _bev_ring_kernel (wrapper
// scatter_to_bev_ring). The TPU kernel streamed pillars through a VMEM ring
// of canvas rows, placed them with one-hot matmuls and flushed closed
// halves to HBM. On Hopper a direct store is enough: pillar ids are unique
// per sample, so each valid pillar writes its C floats to canvas[b, pid]
// with no atomics and no ordering requirement, and the result is bit-exact.
// The wrapper zeroes the canvas (torch.zeros) before the launch.
//
// Bound on this card: bytes — the canvas write (B * H * W * C * 4 bytes,
// 41 MB per sample at the full config) dominates; this kernel writes only
// the pillar rows and reads the pillar features once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void bev_scatter_kernel(const float* __restrict__ feats,
                                   const int* __restrict__ pid,
                                   const uint8_t* __restrict__ mask,
                                   float* __restrict__ canvas, long long total,
                                   int p, int c, int hw) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long r = e / c;
  const int ch = (int)(e - r * c);
  if (!mask[r]) return;
  const int cell = pid[r];
  if (cell < 0 || cell >= hw) return;
  const long long b = r / p;
  canvas[(b * hw + cell) * c + ch] = feats[e];
}

}  // namespace

// feats (B, P, C) f32, pid (B, P) int32, mask (B, P) bool ->
// canvas (B, hw, C) f32, zeroed by the caller.
extern "C" int bev_scatter(const float* feats, const int* pid,
                           const uint8_t* mask, float* canvas, int batch,
                           int p, int c, int hw, cudaStream_t stream) {
  const long long total = (long long)batch * p * c;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  bev_scatter_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      feats, pid, mask, canvas, total, p, c, hw);
  return (int)cudaGetLastError();
}
