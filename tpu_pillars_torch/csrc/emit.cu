// K1 emit: sorted points -> flat pillar table + per-pillar meta.
//
// Replaces tpu_pillars/ops/emit_pallas.py _emit_kernel (wrapper
// emit_table_flat). On the TPU a sequential grid carried the open segment
// across chunks in SMEM, one-hot matmuls stood in for the scatter, and a
// VMEM ring flushed closed halves to HBM.
//
// Bound on this card: bytes. The function reads each valid point's id and F
// floats once and writes the (B*P, N*F) table and the (B*8, P) meta once
// (52 MB at the full config and batch 8, most of it the table's zeros);
// there is almost no arithmetic. The first port walked each sample's
// stream with one block (8 blocks on 132 SMs at batch 8): 128 chunks of two
// block scans and four barriers each, one point's floats stored one by one
// at a 512 B row stride, then one thread per pillar summing x/y/z from
// uncoalesced rows, behind two torch.zeros fills of the outputs: 16x its
// bound.
//
// Here the ids ascend, so every slot follows from facts that can be
// computed in parallel, and one C entry runs three kernels on the caller's
// stream that write every element of table and meta once, into
// uninitialised memory:
//   1. emit_count_kernel, grid (chunk of kChunk ids, sample), kIds ids per
//      thread: the count of run starts per chunk (gid[j] < H*W and
//      gid[j] != gid[j-1]); a chunk that starts on the sentinel holds none.
//   2. emit_runs_kernel, grid (chunk, sample): the runs started in earlier
//      chunks (a sum of at most M / kChunk counts) plus a block scan of the
//      chunk's run starts give each point its run's ordinal. The first
//      point of run r (r <= P) stores its row in starts[r]; the last valid
//      point of the sample, if its run is within the budget, stores one
//      past itself in starts[r + 1]. So row r < kept holds points
//      starts[r] .. starts[r + 1] (runs are contiguous), and kept =
//      min(runs, P) is written by exactly one thread: that last point, the
//      first point of run P, or chunk 0 of a sample with no valid point.
//      Chunks past the sentinel or past the budget exit at once.
//      (ops/emit.py emit_runs_plain is this rule in plain PyTorch.)
//   3. emit_rows_kernel, grid (tile of kRows rows, sample), one warp per
//      row at a time, kRows / 8 rows a warp: a row's kept points are one
//      contiguous range of the sorted stream, so the row is its first
//      cnt * F floats and zeros, written in coalesced 16-byte stores when
//      N * F % 4 == 0 (16-byte loads too when F % 4 == 0). A warp issues the
//      loads of all its rows (the lane's float4 of each row, point `lane`'s
//      x/y/z, the pillar id) before it stores any, and reads a loaded value
//      only where it uses it, so no load waits behind another; the tile's
//      first rows and the sample's kept count come in one round. Rows past
//      `kept` are zeros. Every lane adds the x/y/z of the row's points,
//      shuffled from their lanes, in rank order, so the sums are bit-equal
//      to the plain version's sequential adds. The tile's meta (count, id,
//      sums, three zero rows) is staged in shared memory and stored
//      coalesced. The feature count is a template argument for F = 3..8
//      (the configs' range), so a point's offsets are constants; any other
//      F >= 3, and F = 4 with points not 16-byte aligned, runs the instance
//      kF = 0, which reads F at run time.
// No atomics and no float reduction across threads: the result does not
// depend on the order the blocks run in.
// PRECONDITION (the reference's): each sample's ids ascend and lie in
// [0, H*W], with H*W for padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 1024;       // ids per run-start count
constexpr int kThreads = 256;
constexpr int kIds = kChunk / kThreads;  // ids per thread of a chunk pass
constexpr int kRows = 32;          // table rows per block of the row pass
constexpr int kRowThreads = 256;   // 8 warps, kRows / 8 rows each
constexpr unsigned kFull = 0xFFFFFFFFu;

// thread t's ids j0 + kIds * t + k (hw past m) and, for each, whether it
// starts a run; prev: the id before the first of them (-1 before row 0)
__device__ __forceinline__ void chunk_ids(const int* __restrict__ g, int j0,
                                          int m, int hw, int (&id)[kIds],
                                          bool (&first)[kIds]) {
  const int j = j0 + kIds * (int)threadIdx.x;
  int prev = j == 0 ? -1 : (j - 1 < m ? __ldg(g + j - 1) : hw);
#pragma unroll
  for (int k = 0; k < kIds; ++k) id[k] = j + k < m ? __ldg(g + j + k) : hw;
#pragma unroll
  for (int k = 0; k < kIds; ++k) {
    first[k] = id[k] < hw && id[k] != prev;
    prev = id[k];
  }
}

// sum over the block; all threads call it and get the total
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int s_warp[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(kFull, v);
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += s_warp[w];
  return total;
}

// exclusive sum over the block; all threads call it
__device__ __forceinline__ int block_exclusive_scan(int v) {
  __shared__ int s_warp[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) before += w < warp ? s_warp[w] : 0;
  return before + incl - v;
}

// grid (n_chunk, B): counts[b, c] = run starts among ids [c * kChunk, ...)
__global__ void __launch_bounds__(kThreads)
emit_count_kernel(const int* __restrict__ gid, int* __restrict__ counts,
                  int m, int hw, int n_chunk) {
  const int b = blockIdx.y;
  const int* g = gid + (size_t)b * m;
  const int j0 = blockIdx.x * kChunk;
  int n = 0;
  // ids ascend: a chunk that starts on the sentinel holds no run start
  // (the same for every thread of the block)
  if (__ldg(g + j0) < hw) {
    int id[kIds];
    bool first[kIds];
    chunk_ids(g, j0, m, hw, id, first);
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kIds; ++k) mine += first[k];
    n = block_sum(mine);
  }
  if (threadIdx.x == 0) counts[(size_t)b * n_chunk + blockIdx.x] = n;
}

// grid (n_chunk, B), kIds ids per thread: starts[b, r] and kept[b], see
// the header
__global__ void __launch_bounds__(kThreads)
emit_runs_kernel(const int* __restrict__ gid, const int* __restrict__ counts,
                 int* __restrict__ starts, int* __restrict__ kept, int m,
                 int hw, int n_chunk, int p_budget) {
  __shared__ int s_before;
  const int b = blockIdx.y, c = blockIdx.x, t = threadIdx.x;
  const int* g = gid + (size_t)b * m;
  const int j0 = c * kChunk;
  if (__ldg(g + j0) >= hw) {  // the same for the block
    if (c == 0 && t == 0) kept[b] = 0;  // no valid point in the sample
    return;
  }
  if (t < 32) {  // runs started in earlier chunks
    const int* cnt = counts + (size_t)b * n_chunk;
    int v = 0;
    for (int k = t; k < c; k += 32) v += __ldg(cnt + k);
    v = __reduce_add_sync(kFull, v);
    if (t == 0) s_before = v;
  }
  int id[kIds];
  bool first[kIds];
  chunk_ids(g, j0, m, hw, id, first);
  const int j = j0 + kIds * t;
  const int next = j + kIds < m ? __ldg(g + j + kIds) : hw;
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kIds; ++k) mine += first[k];
  const int excl = block_exclusive_scan(mine);
  const int before = s_before;  // published by the scan's barrier
  if (before > p_budget) return;  // every run here is past the budget
  int ord = before + excl - 1;
  int* st = starts + (size_t)b * (p_budget + 1);
#pragma unroll
  for (int k = 0; k < kIds; ++k) {
    ord += first[k];  // the ordinal of id k's run
    if (first[k] && ord <= p_budget) {
      st[ord] = j + k;
      if (ord == p_budget) kept[b] = p_budget;
    }
    const int after = k + 1 < kIds ? id[k + 1] : next;
    if (id[k] < hw && ord < p_budget && after >= hw) {
      // the sample's last valid point
      st[ord + 1] = j + k + 1;
      kept[b] = ord + 1;
    }
  }
}

// a float4 of a row's kept floats from element e < n_src on; kVec: the
// kept floats come in whole, aligned float4s
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ src, int e,
                                        int n_src) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(src + e));
  float4 v = make_float4(__ldg(src + e), 0.0f, 0.0f, 0.0f);
  if (e + 1 < n_src) v.y = __ldg(src + e + 1);
  if (e + 2 < n_src) v.z = __ldg(src + e + 2);
  if (e + 3 < n_src) v.w = __ldg(src + e + 3);
  return v;
}

// grid (ceil(P / kRows), B): rows [r0, r0 + kRows) of sample b and their
// meta; warp w writes rows w, w + 8, ... of the tile. A warp issues the
// loads of all its rows before it stores any, and reads each loaded value
// only where it uses it, so no load waits on another. kF = 0: F at run
// time; kVec: 16-byte loads (F % 4 == 0, points 16-byte aligned), and at
// F = 4 point `lane`'s x/y/z come from the lane's first float4.
template <int kF, bool kVec>
__global__ void __launch_bounds__(kRowThreads)
emit_rows_kernel(const int* __restrict__ gid, const float* __restrict__ pts,
                 const int* __restrict__ starts, const int* __restrict__ kept,
                 float* __restrict__ table, float* __restrict__ meta, int m,
                 int n_f_rt, int n_pts, int p_budget, int vec_store) {
  constexpr int kWarpsPerBlock = kRowThreads / 32;
  constexpr int kPer = kRows / kWarpsPerBlock;  // rows per warp
  constexpr bool kXyzInV = kF == 4 && kVec;
  __shared__ float s_meta[5][kRows];  // count, id, x/y/z sums
  __shared__ int s_start[kRows + 1];
  __shared__ int s_live;
  const int n_f = kF > 0 ? kF : n_f_rt;
  const int b = blockIdx.y, r0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nrow = min(kRows, p_budget - r0);
  // the sample's kept count and the tile's first rows in one round (the
  // entries past `kept` are never used)
  if ((int)threadIdx.x <= nrow)
    s_start[threadIdx.x] =
        __ldg(starts + (size_t)b * (p_budget + 1) + r0 + threadIdx.x);
  if (threadIdx.x == 32)
    s_live = m > 0 ? min(max(__ldg(kept + b) - r0, 0), nrow) : 0;
  __syncthreads();
  const int n_live = s_live;  // rows of the tile that hold a pillar

  const int row_w = n_pts * n_f;
  const int n4 = row_w >> 2;
  const float* pts_b = pts + (size_t)b * m * n_f;
  // 1. every load of the warp's rows: the lane's first float4 of each row,
  // the x/y/z of point `lane` and the row's pillar id
  int start[kPer], cnt[kPer], id[kPer];
  float4 v[kPer];
  float px[kPer], py[kPer], pz[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = warp + u * kWarpsPerBlock;
    start[u] = 0;
    cnt[u] = 0;
    if (i < n_live) {
      start[u] = s_start[i];
      cnt[u] = min(s_start[i + 1] - start[u], n_pts);
    }
    const float* src = pts_b + (size_t)start[u] * n_f;
    const int n_src = cnt[u] * n_f;
    v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (vec_store && lane < n4 && 4 * lane < n_src)
      v[u] = load4<kVec>(src, 4 * lane, n_src);
    px[u] = py[u] = pz[u] = 0.0f;
    if (!kXyzInV && lane < cnt[u]) {
      const float* pj = src + (size_t)lane * n_f;
      px[u] = __ldg(pj);
      py[u] = __ldg(pj + 1);
      pz[u] = __ldg(pj + 2);
    }
    id[u] = 0;
    if (lane == 0 && i < n_live) id[u] = __ldg(gid + (size_t)b * m + start[u]);
  }
  // 2. the stores: the kept floats, then zeros, every element once
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = warp + u * kWarpsPerBlock;
    if (i >= nrow) break;
    float* dst = table + ((size_t)b * p_budget + r0 + i) * row_w;
    const float* src = pts_b + (size_t)start[u] * n_f;
    const int n_src = cnt[u] * n_f;
    if (vec_store) {
      float4* dst4 = reinterpret_cast<float4*>(dst);
      if (lane < n4) dst4[lane] = v[u];
      for (int q = lane + 32; q < n4; q += 32)  // rows past 128 floats
        dst4[q] = 4 * q < n_src ? load4<kVec>(src, 4 * q, n_src)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      for (int e = lane; e < row_w; e += 32)
        dst[e] = e < n_src ? __ldg(src + e) : 0.0f;
    }
  }
  // 3. meta: the sums in rank order, as the plain version adds them
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = warp + u * kWarpsPerBlock;
    if (i >= nrow) break;
    const float x = kXyzInV ? v[u].x : px[u];
    const float y = kXyzInV ? v[u].y : py[u];
    const float z = kXyzInV ? v[u].z : pz[u];
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    const int nj = min(cnt[u], 32);
    for (int k = 0; k < nj; ++k) {
      sx = sx + __shfl_sync(kFull, x, k);
      sy = sy + __shfl_sync(kFull, y, k);
      sz = sz + __shfl_sync(kFull, z, k);
    }
    const float* src = pts_b + (size_t)start[u] * n_f;
    for (int j = 32; j < cnt[u]; ++j) {  // N > 32
      const float* pj = src + (size_t)j * n_f;
      sx = sx + __ldg(pj);
      sy = sy + __ldg(pj + 1);
      sz = sz + __ldg(pj + 2);
    }
    if (lane == 0) {
      s_meta[0][i] = (float)cnt[u];
      s_meta[1][i] = (float)id[u];
      s_meta[2][i] = sx;
      s_meta[3][i] = sy;
      s_meta[4][i] = sz;
    }
  }
  __syncthreads();
  float* meta_b = meta + (size_t)b * 8 * p_budget + r0;
  for (int e = threadIdx.x; e < 8 * kRows; e += kRowThreads) {
    const int k = e / kRows, i = e % kRows;
    if (i < nrow) meta_b[(size_t)k * p_budget + i] = k < 5 ? s_meta[k][i]
                                                           : 0.0f;
  }
}

template <int kF, bool kVec>
void launch_rows(dim3 grid, cudaStream_t stream, const int* gid,
                 const float* pts, const int* starts, const int* kept,
                 float* table, float* meta, int m, int n_f, int n_pts,
                 int p_budget, int vec_store) {
  emit_rows_kernel<kF, kVec><<<grid, kRowThreads, 0, stream>>>(
      gid, pts, starts, kept, table, meta, m, n_f, n_pts, p_budget,
      vec_store);
}

}  // namespace

// gid (B, M) int32 ascending per sample (hw = invalid sentinel), pts
// (B, M, F) f32 -> table (B, P, n_pts * F) and meta (B, 8, P) f32, every
// element written (the caller may pass uninitialised memory). scratch:
// B * (ceil(M / 1024) + P + 2) int32. F >= 3, B <= 65535.
extern "C" int emit_table(const int* gid, const float* pts, float* table,
                          float* meta, int* scratch, int batch, int m,
                          int n_f, int n_pts, int p_budget, int hw,
                          cudaStream_t stream) {
  if (n_f < 3 || n_pts < 0 || p_budget < 0 || batch < 0 || m < 0 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || p_budget == 0) return 0;
  const int n_chunk = (m + kChunk - 1) / kChunk;
  int* counts = scratch;
  int* kept = counts + (size_t)batch * n_chunk;
  int* starts = kept + batch;
  if (m > 0) {
    const dim3 grid(n_chunk, batch);
    emit_count_kernel<<<grid, kThreads, 0, stream>>>(gid, counts, m, hw,
                                                     n_chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    emit_runs_kernel<<<grid, kThreads, 0, stream>>>(
        gid, counts, starts, kept, m, hw, n_chunk, p_budget);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int row_w = n_pts * n_f;
  const int vec_store = (row_w & 3) == 0 && ((uintptr_t)table & 15) == 0;
  const bool vec_load = vec_store && (n_f & 3) == 0 &&
                        ((uintptr_t)pts & 15) == 0;
  const dim3 grid((p_budget + kRows - 1) / kRows, batch);
  // (F = 4 with points not 16-byte aligned takes the run-time instance:
  // its own spilled 4 bytes under ptxas's cap of 64 registers)
  using Launch = decltype(&launch_rows<0, false>);
  constexpr Launch kLaunch[] = {launch_rows<3, false>, launch_rows<0, false>,
                                launch_rows<5, false>, launch_rows<6, false>,
                                launch_rows<7, false>, launch_rows<8, false>};
  Launch run = n_f <= 8 ? kLaunch[n_f - 3] : &launch_rows<0, false>;
  if (vec_load)
    run = n_f == 4   ? &launch_rows<4, true>
          : n_f == 8 ? &launch_rows<8, true>
                     : &launch_rows<0, true>;
  run(grid, stream, gid, pts, starts, kept, table, meta, m, n_f, n_pts,
      p_budget, vec_store);
  return (int)cudaGetLastError();
}
