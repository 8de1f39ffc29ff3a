// K11 streaming front end: sorted, cell-centred points -> BEV canvas, with
// no pillar table, in one pass over the canvas.
//
// Replaces tpu_pillars/ops/stream_pfn.py _stream_kernel (wrapper
// stream_canvas_from_sorted). A sample's pillar ids ascend (H*W sentinel
// last), so each occupied cell's points are one contiguous run; only the
// first N points of a run are kept, and only the sample's first P runs (the
// pillar budget). For each kept run of cell g, over its kept points:
//     canvas[b, g] = relu(max_s (W_eff^T r'_s) + t)
// with t the decoration bias from the kept points' x/y/z sums and the cell
// centre (fold_decoration's w_dec rows [w_xc, w_yc, w_zc, -w_x, -w_y, b]);
// every other cell is 0. The TPU kernel staged two 1,024-point chunks,
// reduced every run with a prefix-doubling ladder of rolls and placed the
// results through a ring window with bf16 one-hot matmuls: placement
// machinery for a machine with no scattered stores.
//
// Bound on this card: bytes. Writing the (B, H, W, C) canvas once (328 MB
// at the full config and batch 8) is ~92% of what must move; the ids, the
// kept points and the weights are read once. A zeroed canvas and a scatter
// of the runs would pass over the canvas twice (the fill, then the runs
// amid it), behind torch launches for the budget. Here one C entry runs
// three kernels on the caller's stream and writes every element once into
// uninitialised memory:
//   1. stream_index_kernel, one pass over the ids: per chunk of kChunk rows
//      the count of run starts (gid[j] < H*W, gid[j] != gid[j-1]), and per
//      tile of kTileCells cells its first row (a binary search of the
//      sample's ids for the tile's first cell, one thread per tile, all
//      searches at once; the next tile's first row ends the range);
//   2. stream_cutoff_kernel, one block per sample: a scan of the chunk
//      counts finds the chunk that holds the P-th run start and a scan of
//      that chunk's rows finds it. Ids ascend, so "among the sample's first
//      P runs" is "id <= the id of the P-th run" (H*W - 1 with fewer runs):
//      that cutoff is all the canvas kernel needs of the budget;
//   3. stream_canvas_kernel, one block per (tile, sample), dispatched in
//      canvas order as K3's (csrc/bev_scatter.cu), so the canvas is written
//      front to back as a fill is. A block whose tile holds no row, or lies
//      past the cutoff, only stores zeros. Otherwise one round of coalesced
//      loads marks each cell's first row in shared memory and stages the
//      tile's rows of points there (its first kStage rows; a run past them
//      reads device memory), so no warp waits on a chain of loads per cell;
//      then each thread computes the elements it stores, 4 channels of one
//      cell (or zero), over the cell's kept points (its first N rows) in
//      slot order: the running max of W_eff^T r' and the x/y/z sums, the
//      plain version's order, and writes every element of the tile once
//      with 16-byte streaming stores (__stcs) when C % 4 == 0 and a scalar
//      path otherwise. The feature count is a template argument, so that a
//      cell's weights and a point's features stay in registers: the
//      arithmetic of the densest cells is what holds their tiles' stores.
// Built with --fmad=false, so kernel and plain version round alike. No
// atomics: the result does not depend on the order the blocks run in.
// PRECONDITION (the reference's): each sample's ids ascend and lie in
// [0, H*W], with H*W for padding; other ids give a wrong canvas, but every
// read stays inside the sample's rows and every write inside its tile.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kMaxF = 8;
constexpr int kMaxC = 128;
constexpr int kStage = 512;       // point rows a block stages in shared memory
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCells = 64;    // STREAM_TILE_CELLS in ops/stream_pfn.py
constexpr int kChunk = 1024;      // STREAM_CHUNK_ROWS in ops/stream_pfn.py
constexpr int kUnroll = 4;        // stores in flight per thread per round

__device__ __forceinline__ bool run_start(const int* __restrict__ g, int j,
                                          int hw) {
  const int id = __ldg(g + j);
  return id < hw && (j == 0 || id != __ldg(g + j - 1));
}

// inclusive sum over the block; all threads must call it; returns the
// thread's prefix and sets *total to the block's sum
__device__ __forceinline__ int block_scan(int v, int* total) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xFFFFFFFFu, v, off);
    if (lane >= off) v += o;
  }
  __syncthreads();  // s_warp is free (an earlier call has read it)
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int x = s_warp[w];
    before += w < warp ? x : 0;
    sum += x;
  }
  *total = sum;
  return v + before;
}

// grid (n_chunk + ceil((n_tiles + 1) / kThreads), B): the first n_chunk
// blocks count run starts per chunk, the rest give each tile its first row
__global__ void __launch_bounds__(kThreads)
stream_index_kernel(const int* __restrict__ gid, int* __restrict__ counts,
                    int* __restrict__ tile_lo, int m, int hw, int n_chunk,
                    int n_tiles) {
  const int b = blockIdx.y;
  const int* g = gid + (size_t)b * m;
  if ((int)blockIdx.x < n_chunk) {
    const int j0 = blockIdx.x * kChunk;
    int n = 0;
#pragma unroll
    for (int i = 0; i < kChunk / kThreads; ++i) {
      const int j = j0 + i * kThreads + threadIdx.x;
      n += __syncthreads_count(j < m && run_start(g, j, hw));
    }
    if (threadIdx.x == 0) counts[(size_t)b * n_chunk + blockIdx.x] = n;
    return;
  }
  const int t = (blockIdx.x - n_chunk) * kThreads + threadIdx.x;
  if (t > n_tiles) return;
  const int v = min(t * kTileCells, hw);  // tile n_tiles: the first sentinel
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(g + mid) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  tile_lo[(size_t)b * (n_tiles + 1) + t] = lo;
}

// one block per sample: cutoff[b] = the id of the sample's p_max-th run
// start, or hw - 1 when it has fewer runs
__global__ void __launch_bounds__(kThreads)
stream_cutoff_kernel(const int* __restrict__ gid,
                     const int* __restrict__ counts, int* __restrict__ cutoff,
                     int m, int hw, int n_chunk, int p_max) {
  __shared__ int s_chunk, s_before;
  const int b = blockIdx.x;
  const int* g = gid + (size_t)b * m;
  const int* cnt = counts + (size_t)b * n_chunk;
  if (threadIdx.x == 0) s_chunk = -1;
  __syncthreads();
  int running = 0, total = 0;
  for (int k0 = 0; k0 < n_chunk; k0 += kThreads) {
    const int k = k0 + threadIdx.x;
    const int v = k < n_chunk ? cnt[k] : 0;
    const int incl = running + block_scan(v, &total);
    if (k < n_chunk && incl >= p_max && incl - v < p_max) {
      s_chunk = k;
      s_before = incl - v;
    }
    __syncthreads();
    if (s_chunk >= 0) break;
    running += total;
  }
  if (s_chunk < 0) {
    if (threadIdx.x == 0) cutoff[b] = hw - 1;
    return;
  }
  const int target = p_max - s_before;
  const int j_end = min(m, (s_chunk + 1) * kChunk);
  running = 0;
  for (int j0 = s_chunk * kChunk; j0 < j_end; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    const int st = j < j_end && run_start(g, j, hw);
    const int incl = running + block_scan(st, &total);
    if (st && incl == target) cutoff[b] = __ldg(g + j);
    running += total;
    if (running >= target) break;
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

// the channels [ch0, ch0 + kV) of kept cell `cell` (first row `start`, cnt
// kept points, kF features): relu(max_s W_eff^T r'_s + t), in the plain
// version's order; the cell's weights stay in registers over its points
template <int kV, int kF>
__device__ __forceinline__ void cell_channels(
    const float* __restrict__ s_pts, const float* __restrict__ pts_b,
    const float* __restrict__ s_w, const float* __restrict__ w_dec, int lo,
    int staged, int start, int cnt, int cell, int ch0, int c, int w_grid,
    float x_min, float y_min, float vx, float vy, float* out) {
  float w[kF][kV];
#pragma unroll
  for (int f = 0; f < kF; ++f)
#pragma unroll
    for (int k = 0; k < kV; ++k) w[f][k] = s_w[f * c + ch0 + k];
  float umax[kV];
#pragma unroll
  for (int k = 0; k < kV; ++k) umax[k] = -INFINITY;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int s = 0; s < cnt; ++s) {
    const int r = start + s - lo;
    const float* x = r < staged ? s_pts + r * kF
                                : pts_b + (size_t)(start + s) * kF;
    float xv[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f) xv[f] = x[f];
    sx = sx + xv[0];
    sy = sy + xv[1];
    sz = sz + xv[2];
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      float u = xv[0] * w[0][k];
#pragma unroll
      for (int f = 1; f < kF; ++f) u = u + xv[f] * w[f][k];
      umax[k] = fmaxf(umax[k], u);
    }
  }
  const float inv_cnt = 1.0f / fmaxf((float)cnt, 1.0f);
  const float mx = sx * inv_cnt;
  const float my = sy * inv_cnt;
  const float mz = sz * inv_cnt;
  const float col = (float)(cell % w_grid);
  const float rw = (float)(cell / w_grid);
  const float cx = x_min + (col + 0.5f) * vx;
  const float cy = y_min + (rw + 0.5f) * vy;
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const int ch = ch0 + k;
    float bias = __ldg(w_dec + 5 * c + ch) - mx * __ldg(w_dec + ch);
    bias = bias - my * __ldg(w_dec + 1 * c + ch);
    bias = bias - mz * __ldg(w_dec + 2 * c + ch);
    bias = bias - cx * __ldg(w_dec + 3 * c + ch);
    bias = bias - cy * __ldg(w_dec + 4 * c + ch);
    out[k] = fmaxf(umax[k] + bias, 0.0f);
  }
}

template <typename T>
__device__ __forceinline__ T pack(const float* v);
template <>
__device__ __forceinline__ float pack<float>(const float* v) { return v[0]; }
template <>
__device__ __forceinline__ float4 pack<float4>(const float* v) {
  return make_float4(v[0], v[1], v[2], v[3]);
}

// grid (n_tiles, B): block (t, b) writes cells [t * kTileCells, ...) of
// sample b. One round of loads stages the tile's first kStage rows of
// points (the runs are contiguous, so a tile's rows are one range) and
// marks each cell's first row; then each thread computes and stores its
// elements of the tile (kV = 4 channels of one cell for float4 stores).
// kF: the points' features, a template argument so that a cell's weights
// and a point's features live in registers.
template <typename T, int kF>
__global__ void __launch_bounds__(kThreads)
stream_canvas_kernel(const int* __restrict__ gid,
                     const float* __restrict__ pts,
                     const int* __restrict__ tile_lo,
                     const int* __restrict__ cutoff,
                     const float* __restrict__ w_eff,
                     const float* __restrict__ w_dec, T* __restrict__ canvas,
                     int m, int n_max, int c, int w_grid, int hw,
                     int n_tiles, float x_min, float y_min, float vx,
                     float vy) {
  constexpr int kV = sizeof(T) / sizeof(float);
  constexpr int n_f = kF;
  __shared__ float s_pts[kStage * kF];
  __shared__ float s_w[kF * kMaxC];  // w_eff (F, C)
  __shared__ int s_lb[kTileCells + 1];  // first row of each cell (and end)

  const int t = blockIdx.x, b = blockIdx.y;
  const int cell0 = t * kTileCells;
  const int ncell = min(kTileCells, hw - cell0);
  const int* g = gid + (size_t)b * m;
  const float* pts_b = pts + (size_t)b * m * n_f;
  const int lo = tile_lo[(size_t)b * (n_tiles + 1) + t];
  const int hi = tile_lo[(size_t)b * (n_tiles + 1) + t + 1];
  const int cut = cutoff[b];
  const bool empty = lo >= hi || cell0 > cut;  // the same for the block
  const int staged = min(hi - lo, kStage);

  if (!empty) {
    // row j is the first row of every cell in (gid[j - 1], gid[j]]; rows
    // lo - 1 and hi stand for the cells before and after the tile
    for (int j = lo + threadIdx.x; j <= hi; j += kThreads) {
      const int prev = j == lo ? cell0 - 1 : __ldg(g + j - 1);
      const int cur = j == hi ? cell0 + kTileCells : __ldg(g + j);
      // (clamped to the tile: with ids that break the precondition every
      // entry is still written, by some row in [lo, hi])
      const int v_end = min(cur, cell0 + kTileCells);
      for (int v = max(prev + 1, cell0); v <= v_end; ++v) s_lb[v - cell0] = j;
    }
    for (int i = threadIdx.x; i < staged * n_f; i += kThreads)
      s_pts[i] = __ldg(pts_b + (size_t)lo * n_f + i);
    for (int i = threadIdx.x; i < n_f * c; i += kThreads)
      s_w[i] = __ldg(w_eff + i);
    __syncthreads();
  }

  const int c_t = c / kV;
  T* out = canvas + ((size_t)b * hw + cell0) * c_t;
  const int n = ncell * c_t;
  for (int e0 = 0; e0 < n; e0 += kThreads * kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      v[u] = zero<T>();
      if (!empty && e < n) {
        const int i = e / c_t;
        const int start = s_lb[i];
        const int cnt = min(s_lb[i + 1] - start, n_max);
        if (cnt > 0 && cell0 + i <= cut) {
          float val[kV];
          cell_channels<kV, kF>(s_pts, pts_b, s_w, w_dec, lo, staged,
                                start, cnt, cell0 + i, (e - i * c_t) * kV,
                                c, w_grid, x_min, y_min, vx, vy, val);
          v[u] = pack<T>(val);
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

template <int kF>
void launch_canvas(bool vec, dim3 grid, cudaStream_t stream, const int* gid,
                   const float* pts, const int* tile_lo, const int* cutoff,
                   const float* w_eff, const float* w_dec, float* canvas,
                   int m, int n_max, int c, int w_grid, int hw, int n_tiles,
                   float x_min, float y_min, float vx, float vy) {
  if (vec) {
    stream_canvas_kernel<float4, kF><<<grid, kThreads, 0, stream>>>(
        gid, pts, tile_lo, cutoff, w_eff, w_dec,
        reinterpret_cast<float4*>(canvas), m, n_max, c, w_grid, hw, n_tiles,
        x_min, y_min, vx, vy);
  } else {
    stream_canvas_kernel<float, kF><<<grid, kThreads, 0, stream>>>(
        gid, pts, tile_lo, cutoff, w_eff, w_dec, canvas, m, n_max, c, w_grid,
        hw, n_tiles, x_min, y_min, vx, vy);
  }
}

}  // namespace

// gid (B, M) int32 ascending (H*W sentinel), pts (B, M, F) f32 cell-centred,
// w_eff (F, C), w_dec (8, C) -> canvas (B, H*W, C) f32, every element
// written (the caller may pass uninitialised memory). scratch: B * (
// ceil(M / 1024) + ceil(H*W / 64) + 2) int32. F <= 8, N <= 32, C <= 128.
extern "C" int stream_pfn(const int* gid, const float* pts,
                          const float* w_eff, const float* w_dec,
                          float* canvas, int* scratch, int batch, int m,
                          int p_max, int n_max, int n_f, int c, int w_grid,
                          int hw, float x_min, float y_min, float vx, float vy,
                          cudaStream_t stream) {
  if (n_f < 3 || n_f > kMaxF || n_max < 1 || n_max > 32 || c < 1 ||
      c > kMaxC || p_max < 1 || batch > 65535 || m < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || hw == 0) return 0;
  const int n_chunk = (m + kChunk - 1) / kChunk;
  const int n_tiles = (hw + kTileCells - 1) / kTileCells;
  int* counts = scratch;
  int* tile_lo = counts + (size_t)batch * n_chunk;
  int* cutoff = tile_lo + (size_t)batch * (n_tiles + 1);
  const dim3 grid_index(n_chunk + (n_tiles + kThreads) / kThreads, batch);
  stream_index_kernel<<<grid_index, kThreads, 0, stream>>>(
      gid, counts, tile_lo, m, hw, n_chunk, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stream_cutoff_kernel<<<batch, kThreads, 0, stream>>>(gid, counts, cutoff,
                                                       m, hw, n_chunk, p_max);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, batch);
  const bool vec = (c & 3) == 0 && ((uintptr_t)canvas & 15) == 0;
  using Launch = decltype(&launch_canvas<3>);
  constexpr Launch kLaunch[] = {launch_canvas<3>, launch_canvas<4>,
                                launch_canvas<5>, launch_canvas<6>,
                                launch_canvas<7>, launch_canvas<8>};
  kLaunch[n_f - 3](vec, grid, stream, gid, pts, tile_lo, cutoff, w_eff, w_dec,
                   canvas, m, n_max, c, w_grid, hw, n_tiles, x_min, y_min, vx,
                   vy);
  return (int)cudaGetLastError();
}
