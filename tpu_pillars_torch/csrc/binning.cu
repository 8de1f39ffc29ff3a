// K8 binning: per-point rank within its cell + saturated per-cell histogram.
//
// Replaces tpu_pillars/ops/binning_pallas.py _rank_kernel (wrapper
// rank_and_hist, caller pillarize_batch_binned). The TPU kernel walked a
// sequential grid of 1,024-point chunks and carried the running histogram
// in VMEM, doing the lookup and the update as one-hot bf16 matmuls.
//
//   rank(i) = min(#{j < i : cell(j) == cell(i)}, 64)   (0 for invalid i)
//   hist(c) = min(#{i : cell(i) == c}, 64)
//
// Bound on this card: bytes. The function must read rows and cols and write
// rank and the (B, h_bins, w_pad) histogram once (19.1 MB at the full config
// and batch 8); there is no arithmetic to speak of. The first port kept the
// TPU's sequential grid: one block per sample walked its 128 chunks in
// order, and each thread compared its cell with every earlier slot of the
// chunk, so a batch of 8 ran on 8 of 132 SMs and did quadratic work there:
// 238x its bound, slower than a chain of stock torch ops.
//
// The rank depends on input order, so no atomic's arrival order may decide
// it; and a counting sort by cell spends its time on random L2 traffic: a
// global atomic per point, a gather and a scatter per point and a rank
// store each took 14-22 us at the serving batch, 0.07 ms in all
// (scripts/probe_torch_binning_fpfn.py). So the points are first
// partitioned, stably, into bands of 2^shift consecutive cells (1,024 at
// the full config: two grid rows), and each band is then ranked in shared
// memory, in index order. One C entry enqueues four kernels on the
// caller's stream, into uninitialised outputs:
//   1. count_kernel, grid (tile of kTile points, sample): each tile's points
//      per band (shared-memory atomics), stored (sample, band, tile)-major;
//      invalid points (row outside [0, h_bins), col outside [0, w_pad)) get
//      their final rank 0 here and touch nothing else.
//   2. scan_kernel, one warp per (band, sample): the exclusive scan of the
//      band's counts over the tiles, and the band's total. The earlier
//      bands' totals, summed by the blocks that need them, and that scan
//      give every (band, tile) its first slot in the sample's band-ordered
//      (M,) space.
//   3. scatter_kernel, grid (tile, sample): warp w takes the tile's points
//      w * 128 .. w * 128 + 127; per-warp band counts (shared atomics), a
//      prefix over the warps and __match_any_sync within a warp give each
//      point its slot in index order, so (index, cell) pairs land band by
//      band, each band's points in index order, a tile's points in runs.
//   4. band_kernel, grid (band, sample), kWarps warps: warp w takes the
//      w-th eighth of the band's points; each warp counts its points per
//      cell in its own shared histogram, a prefix over the warps turns the
//      counts into each warp's points of the cell before it (and gives hist
//      = min(total, 64) for the band's cells, written coalesced, empty cells
//      included), and each warp walks its points 32 at a time: rank =
//      before[cell] + the lanes below with the same cell
//      (__match_any_sync), at most 64; the group's lowest lane moves
//      before[cell] on.
// Global memory sees one random access per valid point, its rank store;
// the rest is streamed. Nothing depends on the order in which blocks or
// atomics run, so the result is the same in every run and bit-equal to the
// plain version (ops/binning.py rank_by_bands_plain is this route in plain
// PyTorch). A band of n points costs n / 256 steps of 32 points a warp: a
// sample whose M = 131,072 points all share one cell puts them in one
// band, 512 steps a warp. (Measured and not kept: 4 warps a band, whose
// densest band of ~4,600 points then set the time; tiles of 4,096 points;
// the counts stored tile-major, which made the scan's reads strided.)
//
// Bands: 2^shift cells, shift the least of 10, 11, 12 that keeps a sample's
// bands at most kMaxBands; grids of more than kMaxBands * 4,096 cells a
// sample (16.8 million) are refused. scratch (int32 words, see
// rank_and_hist below): B * bands * tiles counts (then slots), B * bands
// band totals, B * M (index, cell) pairs. -Xptxas -v, no kernel spilling:
// count 32 registers, scan 30, scatter 32, band 40.

#include <cuda_runtime.h>

namespace {

constexpr int kCap = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                   // points a thread of a tile
constexpr int kTile = kThreads * kPer;    // 1,024
constexpr int kMinShift = 10;             // bands of at least 1,024 cells
constexpr int kMaxShift = 12;             // and at most 4,096
constexpr int kMaxBands = 4096;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int cell_of(int r, int c, int h_bins, int w_pad) {
  return (r >= 0 && r < h_bins && c >= 0 && c < w_pad) ? r * w_pad + c : -1;
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
             int* __restrict__ rank, int* __restrict__ counts, int m,
             int h_bins, int w_pad, int shift, int n_bands, int n_tiles) {
  extern __shared__ int s_cnt[];  // [n_bands]
  const long long b = blockIdx.y;
  const int tile = blockIdx.x;
  for (int k = threadIdx.x; k < n_bands; k += kThreads) s_cnt[k] = 0;
  __syncthreads();
  const int* r_b = rows + b * m;
  const int* c_b = cols + b * m;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tile * kTile + k * kThreads + threadIdx.x;
    if (i >= m) break;
    const int cell = cell_of(__ldg(r_b + i), __ldg(c_b + i), h_bins, w_pad);
    if (cell >= 0)
      atomicAdd(s_cnt + (cell >> shift), 1);
    else
      rank[b * m + i] = 0;
  }
  __syncthreads();
  int* out = counts + b * n_bands * n_tiles + tile;
  for (int k = threadIdx.x; k < n_bands; k += kThreads)
    out[(long long)k * n_tiles] = s_cnt[k];
}

// one warp per (band, sample): the exclusive scan over the tiles of the
// band's counts, in place, and the band's total
__global__ void __launch_bounds__(kThreads)
scan_kernel(int* __restrict__ counts, int* __restrict__ band_total,
            int n_bands, int n_tiles) {
  const long long b = blockIdx.y;
  const int band = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (band >= n_bands) return;
  int* c = counts + (b * n_bands + band) * n_tiles;
  int carry = 0;
#pragma unroll 4
  for (int t0 = 0; t0 < n_tiles; t0 += 32) {
    const int v = t0 + lane < n_tiles ? c[t0 + lane] : 0;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += u;
    }
    if (t0 + lane < n_tiles) c[t0 + lane] = carry + incl - v;
    carry += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) band_total[b * n_bands + band] = carry;
}

// the exclusive scan of a sample's band totals into s_base (n_bands ints),
// by the block
__device__ void band_bases(const int* __restrict__ total, int n_bands,
                           int* s_base, int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (n_bands + kThreads - 1) / kThreads;
  const int lo = min(n_bands, (int)threadIdx.x * per);
  const int hi = min(n_bands, lo + per);
  int own = 0;
  for (int k = lo; k < hi; ++k) own += __ldg(total + k);
  int incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int run = incl - own;
  for (int w = 0; w < warp; ++w) run += s_warp[w];
  for (int k = lo; k < hi; ++k) {
    s_base[k] = run;
    run += __ldg(total + k);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
               const int* __restrict__ slots,
               const int* __restrict__ band_total, int2* __restrict__ pairs,
               int m, int h_bins, int w_pad, int shift, int n_bands,
               int n_tiles) {
  extern __shared__ int s_cnt[];  // [kWarps][n_bands], then [n_bands]
  __shared__ int s_warp[kWarps];
  const long long b = blockIdx.y;
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* s_base = s_cnt + kWarps * n_bands;
  for (int k = threadIdx.x; k < kWarps * n_bands; k += kThreads) s_cnt[k] = 0;
  band_bases(band_total + b * n_bands, n_bands, s_base, s_warp);
  // warp w: the tile's points w * 32 * kPer + g * 32 + lane, g < kPer
  const int i0 = tile * kTile + warp * 32 * kPer + lane;
  const int* r_b = rows + b * m;
  const int* c_b = cols + b * m;
  int* mine = s_cnt + warp * n_bands;
  int cell[kPer];
#pragma unroll
  for (int g = 0; g < kPer; ++g) {
    const int i = i0 + g * 32;
    cell[g] = i < m ? cell_of(__ldg(r_b + i), __ldg(c_b + i), h_bins, w_pad)
                    : -1;
  }
#pragma unroll
  for (int g = 0; g < kPer; ++g)
    if (cell[g] >= 0) atomicAdd(mine + (cell[g] >> shift), 1);
  __syncthreads();
  // each warp's first slot in each band: the band's first slot, the
  // earlier tiles' points in the band and the earlier warps' points there
  const int* first = slots + b * n_bands * n_tiles + tile;
  for (int k = threadIdx.x; k < n_bands; k += kThreads) {
    int run = s_base[k] + __ldg(first + (long long)k * n_tiles);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = s_cnt[w * n_bands + k];
      s_cnt[w * n_bands + k] = run;
      run += v;
    }
  }
  __syncthreads();
  int2* p_b = pairs + b * m;
#pragma unroll
  for (int g = 0; g < kPer; ++g) {
    const int band = cell[g] >> shift;  // negative for an invalid point
    const unsigned valid = __ballot_sync(kFull, cell[g] >= 0);
    unsigned peers = 0;
    int base = 0;
    if (cell[g] >= 0) {
      peers = __match_any_sync(valid, band);
      base = mine[band];
      p_b[base + __popc(peers & lanes_below(lane))] =
          make_int2(i0 + g * 32, cell[g]);
    }
    __syncwarp();  // every lane has read its band's slot
    if (cell[g] >= 0 && lane == __ffs(peers) - 1)
      mine[band] = base + __popc(peers);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
band_kernel(const int2* __restrict__ pairs,
            const int* __restrict__ band_total, int* __restrict__ rank,
            float* __restrict__ hist, int m, long long cells, int shift,
            int n_bands) {
  extern __shared__ int s_hist[];  // [kWarps][1 << shift]
  __shared__ int s_sum[kWarps];
  const long long b = blockIdx.y;
  const int band = blockIdx.x;
  const int band_cells = 1 << shift;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < kWarps * band_cells; k += kThreads)
    s_hist[k] = 0;
  // the band's points [lo, hi) of the sample's band-ordered space: the
  // earlier bands' totals summed (none when M is 0)
  const int* t_b = band_total + b * n_bands;
  int own = 0;
  if (m > 0)
    for (int k = threadIdx.x; k < band; k += kThreads)
      own += __ldg(t_b + k);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) own += __shfl_xor_sync(kFull, own, d);
  if (lane == 0) s_sum[warp] = own;
  __syncthreads();
  int lo = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) lo += s_sum[w];
  const int hi = m > 0 ? lo + __ldg(t_b + band) : lo;
  // warp w: the band's points [w_lo, w_hi), in index order
  const int per = (((hi - lo) + kWarps - 1) / kWarps + 31) & ~31;
  const int w_lo = min(hi, lo + warp * per);
  const int w_hi = min(hi, w_lo + per);
  const int2* p_b = pairs + b * m;
  int* mine = s_hist + warp * band_cells;
  const int cell0 = band << shift;
  for (int j = w_lo + lane; j < w_hi; j += 32)
    atomicAdd(mine + (__ldg(&p_b[j].y) - cell0), 1);
  __syncthreads();
  // counts -> each warp's points of the cell before it; the band's hist
  float* h_b = hist + b * cells + cell0;
  for (int k = threadIdx.x; k < band_cells; k += kThreads) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = s_hist[w * band_cells + k];
      s_hist[w * band_cells + k] = run;
      run += v;
    }
    if (cell0 + k < cells) h_b[k] = (float)min(run, kCap);
  }
  __syncthreads();
  int* rank_b = rank + b * m;
  for (int j0 = w_lo; j0 < w_hi; j0 += 32) {
    const int j = j0 + lane;
    const unsigned valid = __ballot_sync(kFull, j < w_hi);
    unsigned peers = 0;
    int local = 0, before = 0;
    if (j < w_hi) {
      const int2 e = __ldg(p_b + j);
      local = e.y - cell0;
      peers = __match_any_sync(valid, local);
      before = mine[local];
      rank_b[e.x] = min(before + __popc(peers & lanes_below(lane)), kCap);
    }
    __syncwarp();  // every lane has read its cell's count
    if (j < w_hi && lane == __ffs(peers) - 1)
      mine[local] = before + __popc(peers);
    __syncwarp();
  }
}

// bands of 2^shift cells, at most kMaxBands a sample; -1 if the grid is
// too large
int band_shift(long long cells) {
  for (int s = kMinShift; s <= kMaxShift; ++s)
    if (((cells + (1LL << s) - 1) >> s) <= kMaxBands) return s;
  return -1;
}

long long head_words(int batch, long long bands, long long tiles) {
  return (batch * bands * (tiles + 1) + 3) & ~3LL;
}

// dynamic shared memory above 48 KB is asked for once per kernel
cudaError_t allow_smem(const void* kernel, int bytes, int* allowed) {
  if (bytes <= 48 * 1024 || bytes <= *allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *allowed = bytes;
  return e;
}

}  // namespace

// rows, cols (B, M) int32 (a row outside [0, h_bins) or a col outside
// [0, w_pad) marks an invalid point) -> rank (B, M) int32, hist (B, h_bins,
// w_pad) f32, every element written (the caller may pass uninitialised
// memory). scratch: scratch_words int32 words, 8-byte aligned, at least
// round4(B * bands * (tiles + 1)) + 2 * B * M with tiles = ceil(M / 1024)
// and bands = ceil(h_bins * w_pad / 2^shift) (ops/binning.py scratch_words);
// less is refused, and so are h_bins * w_pad > 2^24 and B > 65535.
extern "C" int rank_and_hist(const int* rows, const int* cols, int* rank,
                             float* hist, int* scratch, int scratch_words,
                             int batch, int m, int h_bins, int w_pad,
                             cudaStream_t stream) {
  const long long cells = (long long)h_bins * w_pad;
  const int shift = band_shift(cells);
  if (batch < 0 || batch > 65535 || m < 0 || h_bins < 0 || w_pad < 0 ||
      shift < 0 || (reinterpret_cast<size_t>(scratch) & 7) != 0)
    return (int)cudaErrorInvalidValue;
  const int n_bands = (int)((cells + (1LL << shift) - 1) >> shift);
  const int n_tiles = (m + kTile - 1) / kTile;
  const long long head = head_words(batch, n_bands, n_tiles);
  if (scratch_words < head + 2LL * batch * m)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  int* slots = scratch;
  int* band_total = scratch + (long long)batch * n_bands * n_tiles;
  int2* pairs = reinterpret_cast<int2*>(scratch + head);
  static int allowed_scatter = 0, allowed_band = 0;
  const int smem_scatter = (kWarps + 1) * n_bands * 4;
  const int smem_band = kWarps * (1 << shift) * 4;
  cudaError_t err = allow_smem((const void*)scatter_kernel, smem_scatter,
                               &allowed_scatter);
  if (err == cudaSuccess)
    err = allow_smem((const void*)band_kernel, smem_band, &allowed_band);
  if (err != cudaSuccess) return (int)err;

  if (m > 0) {
    const dim3 grid(n_tiles, batch);
    count_kernel<<<grid, kThreads, n_bands * 4, stream>>>(
        rows, cols, rank, slots, m, h_bins, w_pad, shift, n_bands, n_tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (n_bands > 0) {
      const dim3 bands((n_bands + kWarps - 1) / kWarps, batch);
      scan_kernel<<<bands, kThreads, 0, stream>>>(slots, band_total, n_bands,
                                                  n_tiles);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    scatter_kernel<<<grid, kThreads, smem_scatter, stream>>>(
        rows, cols, slots, band_total, pairs, m, h_bins, w_pad, shift,
        n_bands, n_tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (n_bands > 0) {
    band_kernel<<<dim3(n_bands, batch), kThreads, smem_band, stream>>>(
        pairs, band_total, rank, hist, m, cells, shift, n_bands);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
