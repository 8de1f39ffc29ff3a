// K9 BEV block gather: pillar rows with ascending ids -> dense canvas.
//
// Replaces tpu_pillars/ops/bev_pallas.py _bev_kernel (wrapper
// scatter_to_bev_emit). Same contract as K3 (csrc/bev_scatter.cu), but a
// gather rather than a scatter: the pillarizers emit each sample's pillars
// in ascending id order, so the pillars that land in any run of canvas
// cells form one contiguous range of rows. On the TPU a broadcast-compare
// count gave each canvas block its row range [lo, hi), scalar-prefetched,
// and three bf16 one-hot matmuls expanded the staged rows. Here:
//   * a sidecar kernel (bev_row_ranges) computes the same ranges in one
//     coalesced pass over the ids: lo[b, t] is the first row of sample b
//     whose effective id where(mask, pid, HW) reaches tile t's first cell,
//     and row k writes it for every tile that starts in (eff[k - 1],
//     eff[k]] (a long range by its whole warp, so no thread loops over a
//     run of empty tiles);
//   * the gather kernel (bev_gather) runs one block per (tile, sample),
//     dispatched in order, so the canvas is written front to back as a
//     fill would be. A tile with no pillar writes only zeros, with no map
//     and no barrier. Otherwise its rows mark their cell in a shared-memory
//     map, a barrier, and the block writes every element of the tile
//     exactly once, the pillar's feature or zero;
//   * stores are 16-byte and streaming (__stcs): the canvas is written once
//     and is far larger than L2. So the canvas needs no zero-fill pass and
//     no atomics, and the result is bit-exact.
// The tile size is the caller's (ops/bev.py GATHER_TILE_CELLS), passed to
// both kernels; the map lives in dynamic shared memory.
//
// Bound on this card: bytes. The canvas write (B * H * W * C * 4 bytes)
// dominates; the pillar rows, ids and mask are read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTileCells = 8192;  // a 32 KB map
constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // stores in flight per thread per round
constexpr int kWideRange = 8;  // tile ranges the sidecar's warps share

__device__ __forceinline__ int eff_id(const int* pid, const uint8_t* mask,
                                      long long k, int hw) {
  return mask[k] ? pid[k] : hw;
}

// lo (B, tiles + 1): lo[b, t] = #{k : eff[b, k] < t * tile}, for ascending
// eff. One thread per (sample, row k in 0..P); row P stands for an id past
// every tile. Row k owns the tiles that start in (eff[k - 1], eff[k]]:
// mostly none or one, which it writes itself. A run of empty cells gives
// one row a long range; the row's warp writes such ranges together, one at
// a time, 32 neighbouring entries a store.
__global__ void row_ranges_kernel(const int* __restrict__ pid,
                                  const uint8_t* __restrict__ mask,
                                  int* __restrict__ lo, int p, int hw,
                                  int tile, int tiles, long long total) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long b = 0;
  int k = 0, first = 1, last = 0;
  if (e < total) {
    b = e / (p + 1);
    k = (int)(e - b * (p + 1));
    const long long r0 = b * p;
    first = 0;
    if (k > 0) {
      const int prev = eff_id(pid, mask, r0 + k - 1, hw);
      first = prev < 0 ? 0 : prev / tile + 1;
    }
    last = tiles;
    if (k < p) {
      const int cur = eff_id(pid, mask, r0 + k, hw);
      last = cur < 0 ? -1 : min(cur / tile, tiles);
    }
  }
  const bool wide = last - first >= kWideRange;
  if (!wide) {
    int* lo_b = lo + b * (tiles + 1);
    for (int t = first; t <= last; ++t) lo_b[t] = k;
  }
  const int lane = threadIdx.x & 31;
  unsigned todo = __ballot_sync(0xffffffffu, wide);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int f = __shfl_sync(0xffffffffu, first, src);
    const int l = __shfl_sync(0xffffffffu, last, src);
    const int kk = __shfl_sync(0xffffffffu, k, src);
    int* lo_b = lo + __shfl_sync(0xffffffffu, b, src) * (tiles + 1);
    for (int t = f + lane; t <= l; t += 32) lo_b[t] = kk;
  }
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// the tile's n elements of type T (c_t per cell), each written once: the
// row of the cell's pillar (map entry >= 0) or zero
template <typename T>
__device__ __forceinline__ void write_tile(const T* __restrict__ rows,
                                           T* __restrict__ out, int n,
                                           int c_t, const int* map,
                                           bool empty) {
  for (int e0 = 0; e0 < n; e0 += kThreads * kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      v[u] = zero<T>();
      if (!empty && e < n) {
        const int cell = e / c_t;
        const int row = map[cell];
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

// grid (tiles, B): block (t, b) writes tile t of sample b
template <typename T>
__global__ void __launch_bounds__(kThreads)
bev_gather_kernel(const T* __restrict__ feats, const int* __restrict__ pid,
                  const uint8_t* __restrict__ mask,
                  const int* __restrict__ lo, T* __restrict__ canvas, int p,
                  int c_t, int hw, int tile, int tiles) {
  extern __shared__ int s_map[];   // the row of each cell's pillar, or -1
  const int t = blockIdx.x, b = blockIdx.y;
  const int* lo_t = lo + (long long)b * (tiles + 1) + t;
  // clamped, so a caller that breaks the precondition reads no row outside
  // the sample
  const int r_lo = max(0, min(lo_t[0], p));
  const int r_hi = max(r_lo, min(lo_t[1], p));
  const int cell0 = t * tile;
  const int ncell = min(tile, hw - cell0);
  T* out = canvas + ((long long)b * hw + cell0) * c_t;
  const T* rows = feats + (long long)b * p * c_t;
  const bool empty = r_lo >= r_hi;   // the same in every thread
  if (!empty) {
    for (int i = threadIdx.x; i < ncell; i += kThreads) s_map[i] = -1;
    __syncthreads();
    const long long r0 = (long long)b * p;
    for (int k = r_lo + threadIdx.x; k < r_hi; k += kThreads) {
      // in range whenever the ids ascend; the guard keeps a caller that
      // breaks the precondition inside the map
      const int off = eff_id(pid, mask, r0 + k, hw) - cell0;
      if (off >= 0 && off < ncell) s_map[off] = k;
    }
    __syncthreads();
  }
  write_tile<T>(rows, out, ncell * c_t, c_t, s_map, empty);
}

}  // namespace

// pid (B, P) int32, mask (B, P) bool, with where(mask, pid, hw) ascending
// per sample -> lo (B, ceil(hw / tile_cells) + 1) int32, the first row of
// each tile of tile_cells cells (1..8192).
extern "C" int bev_row_ranges(const int* pid, const uint8_t* mask, int* lo,
                              int batch, int p, int hw, int tile_cells,
                              cudaStream_t stream) {
  if (tile_cells < 1 || tile_cells > kMaxTileCells) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || hw == 0) return 0;
  const int tiles = (hw + tile_cells - 1) / tile_cells;
  const long long total = (long long)batch * (p + 1);
  const int t = 256;   // a multiple of 32: every warp is whole
  row_ranges_kernel<<<(int)((total + t - 1) / t), t, 0, stream>>>(
      pid, mask, lo, p, hw, tile_cells, tiles, total);
  return (int)cudaGetLastError();
}

// feats (B, P, C) f32, pid (B, P) int32, mask (B, P) bool, with
// where(mask, pid, hw) ascending per sample, and lo from bev_row_ranges at
// the same tile_cells -> canvas (B, hw, C) f32, every element written (the
// caller may pass uninitialised memory).
extern "C" int bev_gather(const float* feats, const int* pid,
                          const uint8_t* mask, const int* lo, float* canvas,
                          int batch, int p, int c, int hw, int tile_cells,
                          cudaStream_t stream) {
  if (tile_cells < 1 || tile_cells > kMaxTileCells) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || hw == 0 || c == 0) return 0;
  const int tiles = (hw + tile_cells - 1) / tile_cells;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles, batch);
  const size_t smem = tile_cells * sizeof(int);
  // 16-byte loads and stores where the rows allow them
  if ((c & 3) == 0 && (((uintptr_t)feats | (uintptr_t)canvas) & 15) == 0) {
    bev_gather_kernel<float4><<<grid, kThreads, smem, stream>>>(
        reinterpret_cast<const float4*>(feats), pid, mask, lo,
        reinterpret_cast<float4*>(canvas), p, c >> 2, hw, tile_cells, tiles);
  } else {
    bev_gather_kernel<float><<<grid, kThreads, smem, stream>>>(
        feats, pid, mask, lo, canvas, p, c, hw, tile_cells, tiles);
  }
  return (int)cudaGetLastError();
}
