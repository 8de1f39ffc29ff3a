// K1 emit: sorted points -> flat pillar table + per-pillar meta.
//
// Replaces tpu_pillars/ops/emit_pallas.py _emit_kernel (wrapper
// emit_table_flat). On the TPU a sequential grid carried the open segment
// across chunks in SMEM, one-hot matmuls stood in for the scatter, and a
// VMEM ring flushed closed halves to HBM. Here one block per sample walks
// its sorted stream in chunks of kThreads points:
//   * block-wide scans give each point its pillar ordinal (inclusive sum of
//     segment-first flags) and its rank (distance to the latest segment
//     start, max-scan), with (gid, run, ordinal) of the open segment carried
//     across chunks in shared memory;
//   * each kept point (rank < n_pts, ordinal < p_budget) is stored directly
//     at table[b, ordinal, rank * F + f];
//   * the point that closes a segment writes the pillar's kept count and id;
//   * after the stream, one thread per pillar sums the kept x/y/z of its row
//     in rank order — no float atomics, so the kernel is deterministic and
//     bit-equal to its plain version.
// Rows past the last kept pillar stay as the wrapper zeroed them.
//
// Bound on this card: bytes. It reads gid (4 B) and F payload floats per
// point and writes the kept table and meta; there is almost no arithmetic.
// This first version runs one block per sample (B blocks on 132 SMs), so it
// is latency-bound far above that byte bound; splitting a sample's stream
// across blocks is later work.

#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 1024;

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};

__global__ void __launch_bounds__(kThreads)
emit_kernel(const int* __restrict__ gid, const float* __restrict__ pts,
            float* __restrict__ table, float* __restrict__ meta, int m,
            int n_f, int n_pts, int p_budget, int hw) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage scan_tmp;
  // open segment: [0] its gid, [1] its points so far, [2] segments seen
  __shared__ int carry[3];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int row_w = n_pts * n_f;
  const int* g_b = gid + (size_t)b * m;
  const float* p_b = pts + (size_t)b * m * n_f;
  float* tab_b = table + (size_t)b * p_budget * row_w;
  float* meta_b = meta + (size_t)b * 8 * p_budget;

  if (t == 0) {
    carry[0] = -1;
    carry[1] = 0;
    carry[2] = 0;
  }
  __syncthreads();

  for (int c0 = 0; c0 < m; c0 += kThreads) {
    // invalid points sort to the tail: once a chunk starts on the sentinel
    // every later point of the sample is invalid (uniform across the block)
    if (g_b[c0] >= hw) break;
    const int cg = carry[0], crun = carry[1], cord = carry[2];
    const int i = c0 + t;
    const int g = i < m ? g_b[i] : hw;
    const int prev = t == 0 ? cg : (i - 1 < m ? g_b[i - 1] : hw);
    const bool valid = g < hw;
    const bool new_seg = g != prev;

    int cum_first, seg_start;
    Scan(scan_tmp).InclusiveSum((valid && new_seg) ? 1 : 0, cum_first);
    __syncthreads();
    Scan(scan_tmp).InclusiveScan(new_seg ? t : -1, seg_start, MaxOp());

    // no segment start at or before t in this chunk: the point continues
    // the carried segment
    const int rank = seg_start < 0 ? crun + t : t - seg_start;
    const int ord = cord + cum_first - 1;
    if (valid && ord < p_budget) {
      if (rank < n_pts) {
        float* dst = tab_b + (size_t)ord * row_w + rank * n_f;
        const float* src = p_b + (size_t)i * n_f;
        for (int f = 0; f < n_f; ++f) dst[f] = src[f];
      }
      const int next = i + 1 < m ? g_b[i + 1] : hw;
      if (next != g) {  // this point closes its segment
        meta_b[ord] = (float)(rank + 1 < n_pts ? rank + 1 : n_pts);
        meta_b[p_budget + ord] = (float)g;
      }
    }
    __syncthreads();  // every thread has read the carry
    if (t == kThreads - 1) {
      carry[0] = g;
      carry[1] = rank + 1;
      carry[2] = cord + cum_first;
    }
    __syncthreads();
  }

  // meta rows 2-4: kept x/y/z sums, in rank order, one thread per pillar
  const int n_pill = carry[2] < p_budget ? carry[2] : p_budget;
  for (int r = t; r < n_pill; r += kThreads) {
    const int cnt = (int)meta_b[r];
    const float* row = tab_b + (size_t)r * row_w;
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    for (int j = 0; j < cnt; ++j) {
      sx += row[j * n_f + 0];
      sy += row[j * n_f + 1];
      sz += row[j * n_f + 2];
    }
    meta_b[2 * p_budget + r] = sx;
    meta_b[3 * p_budget + r] = sy;
    meta_b[4 * p_budget + r] = sz;
  }
}

}  // namespace

// gid (B, M) int32 ascending per sample (hw = invalid sentinel), pts
// (B, M, F) f32; table (B, P, n_pts * F) and meta (B, 8, P) f32 zeroed by
// the caller.
extern "C" int emit_table(const int* gid, const float* pts, float* table,
                          float* meta, int batch, int m, int n_f, int n_pts,
                          int p_budget, int hw, cudaStream_t stream) {
  if (batch == 0 || m == 0) return 0;
  emit_kernel<<<batch, kThreads, 0, stream>>>(gid, pts, table, meta, m, n_f,
                                              n_pts, p_budget, hw);
  return (int)cudaGetLastError();
}
