// K3 BEV scatter: pillar features -> dense (B, H*W, C) canvas, in one pass
// over the canvas.
//
// Replaces tpu_pillars/ops/bev_pallas.py _bev_ring_kernel (wrapper
// scatter_to_bev_ring). The TPU kernel streamed pillars through a VMEM ring
// of canvas rows, placed them with one-hot matmuls and flushed closed
// halves to HBM; its contract is scatter_to_bev_emit's: the effective ids
// where(mask, pid, hw) ascend along P in every sample, and valid ids are
// unique and lie in [0, hw). Every caller of the port meets it (the emit
// table, the classic pillarizer's canonical order).
//
// Bound on this card: bytes. The canvas write (B * H * W * C * 4 bytes,
// 328 MB at the full config and batch 8) is ~93% of what must move; the
// pillar rows, ids and mask are read once. A zeroed canvas and a scatter of
// the rows would pass over the canvas twice (the fill, then the rows amid
// it). Here one launch writes every element once into uninitialised memory:
//   * one block per (tile of kTileCells = 64 cells, sample), dispatched in
//     canvas order, so the canvas is written front to back as a fill is;
//   * the block finds its own rows, with no sidecar: its 256 threads probe
//     the sample's effective ids at a stride of ceil(P / 256), and one
//     barrier counts the probes below the tile's first cell (a 256-ary
//     search: one dependent load). The first row at or past the tile then
//     lies in the probe's segment, and, ids being unique, the tile holds at
//     most kTileCells pillars: one coalesced load of the rows from that
//     segment on (stride - 1 + kTileCells at most) finds them all, and each
//     marks its cell in a shared-memory map;
//   * the block writes every element of the tile once, the pillar's
//     feature or zero, with 16-byte streaming stores (__stcs) when C % 4 ==
//     0 and a scalar path otherwise. A tile that holds no pillar reads no
//     row. No atomics: the result is bit-exact.
// A caller that breaks the precondition gets a wrong canvas, but every
// read stays inside the sample's rows and every write inside its tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cells per block: 32 ties 64, 128 and 256 are slower (PERF.md §6)
constexpr int kTileCells = 64;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // stores in flight per thread per round

// where(mask, pid, hw) of row k; both loads go out before the select
__device__ __forceinline__ int eff_id(const int* __restrict__ pid,
                                      const uint8_t* __restrict__ mask,
                                      int k, int hw) {
  const int id = __ldg(pid + k);
  const uint8_t m = __ldg(mask + k);
  return m ? id : hw;
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// grid (tiles, B): block (t, b) writes tile t of sample b
template <typename T>
__global__ void __launch_bounds__(kThreads)
bev_scatter_kernel(const T* __restrict__ feats, const int* __restrict__ pid,
                   const uint8_t* __restrict__ mask, T* __restrict__ canvas,
                   int p, int c_t, int hw) {
  __shared__ int s_map[kTileCells];  // the row of each cell's pillar, or -1
  const int t = blockIdx.x, b = blockIdx.y;
  const int cell0 = t * kTileCells;
  const int ncell = min(kTileCells, hw - cell0);
  const long long r0 = (long long)b * p;
  const int* pid_b = pid + r0;
  const uint8_t* mask_b = mask + r0;

  for (int i = threadIdx.x; i < ncell; i += kThreads) s_map[i] = -1;
  // the search: probe i reads row i * stride; the probes below cell0 are a
  // prefix, so the first row at or past cell0 lies in
  // ((n_below - 1) * stride, n_below * stride]
  const int stride = (p + kThreads - 1) / kThreads;
  const int probe = threadIdx.x * stride;
  const bool below = probe < p && eff_id(pid_b, mask_b, probe, hw) < cell0;
  const int n_below = __syncthreads_count(below);  // also orders the map init
  const int k_lo = n_below == 0 ? 0 : (n_below - 1) * stride + 1;
  const int k_hi = min(p, n_below * stride + ncell);
  bool any = false;
  for (int k = k_lo + threadIdx.x; k < k_hi; k += kThreads) {
    const int off = eff_id(pid_b, mask_b, k, hw) - cell0;
    if (off >= 0 && off < ncell) {
      s_map[off] = k;
      any = true;
    }
  }
  const bool empty = !__syncthreads_or(any);

  const T* rows = feats + r0 * c_t;
  T* out = canvas + ((long long)b * hw + cell0) * c_t;
  const int n = ncell * c_t;
  for (int e0 = 0; e0 < n; e0 += kThreads * kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      v[u] = zero<T>();
      if (!empty && e < n) {
        const int cell = e / c_t;
        const int row = s_map[cell];
        if (row >= 0) {
          v[u] = __ldg(rows + (long long)row * c_t + (e - cell * c_t));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      if (e < n) __stcs(out + e, v[u]);
    }
  }
}

}  // namespace

// feats (B, P, C) f32, pid (B, P) int32, mask (B, P) bool, with
// where(mask, pid, hw) ascending per sample and valid ids unique ->
// canvas (B, hw, C) f32, every element written (the caller may pass
// uninitialised memory).
extern "C" int bev_scatter(const float* feats, const int* pid,
                           const uint8_t* mask, float* canvas, int batch,
                           int p, int c, int hw, cudaStream_t stream) {
  if (batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || hw == 0 || c == 0) return 0;
  const dim3 grid((hw + kTileCells - 1) / kTileCells, batch);
  if ((c & 3) == 0 && (((uintptr_t)feats | (uintptr_t)canvas) & 15) == 0) {
    bev_scatter_kernel<float4><<<grid, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(feats), pid, mask,
        reinterpret_cast<float4*>(canvas), p, c >> 2, hw);
  } else {
    bev_scatter_kernel<float><<<grid, kThreads, 0, stream>>>(
        feats, pid, mask, canvas, p, c, hw);
  }
  return (int)cudaGetLastError();
}
