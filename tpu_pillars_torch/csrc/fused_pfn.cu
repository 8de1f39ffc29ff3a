// K2 fused PFN: pillar features straight from the emit table.
//
// Replaces tpu_pillars/ops/fused_pfn.py _fpfn_kernel (wrapper
// pfn_from_table). For every pillar row:
//     relu(max_{j < cnt} (W_eff^T r'_j) + t)     (0 where cnt == 0)
// with t the decoration bias from the meta sums and the cell centre
// (fold_decoration's w_dec rows [w_xc, w_yc, w_zc, -w_x, -w_y, b]). On the
// TPU the F x C product ran as one kron(I_N, W_eff) block-diagonal MXU
// matmul with a log2(N) ladder of lane rolls for the max.
//
// Bound on this card: bytes. The function reads the kept rows of the
// (rows, N*F) table (slots past a pillar's count are never needed) and five
// meta rows, and writes the (rows, C) features, the int32 ids and the f32
// counts once: 31.4 MB at the serving batch, four fifths of it the feature
// store. The F*C multiply-adds per kept point are far below the f32 peak.
// The first port gave each thread one (pillar, channel): every warp loaded
// its pillar's count, then each kept row as F scalar loads that the whole
// warp waited on, then five meta values and F + 6 weights, all of it 64
// times per pillar, so per-pillar load latency, not bytes, set its time
// (15x its bound); a torch .to(int32) of the ids ran beside it.
//
// Here a block of four warps takes a tile of 128 consecutive pillars:
//   * thread t owns pillar t of the tile for the meta: count, id and the
//     x/y/z sums are five coalesced loads a warp, and the owner computes
//     the cell centre, the means and the kept count min(ceil(cnt), N) once,
//     stages them in shared memory and stores the int32 id and f32 count;
//   * a block scan of the kept counts numbers the tile's kept rows in
//     (pillar, slot) order, and the warps split the tile by work: warp w
//     takes the pillars whose work (3 per pillar, for its bias and store,
//     plus 1 per kept row) starts in the w-th quarter of the tile's. The
//     rows of a tile vary 30-fold on lidar-like sweeps (a car's cells hold
//     up to 32 points), and an even split of pillars left the densest
//     tiles' warps as the kernel's tail;
//   * lane t of a warp loads the warp's kept row r0 + t of a round of 32
//     (one float4 at F = 4 when the table is 16-byte aligned, else F
//     scalars; its pillar by a binary search of the scan in shared memory),
//     the next round's loads go out before this round's arithmetic, and
//     the rows are staged in shared memory and read back as broadcasts; a
//     slot at or past its pillar's count is never read, so whatever it
//     holds (NaN) cannot reach the output;
//   * lane l owns channels kV*l .. kV*l + kV - 1 (kV = C / 32 rounded up to
//     1, 2, 4 or 8); its w_eff columns and w_dec rows 0-5 stay in
//     registers. 4 staged rows are computed side by side (8 measured no
//     faster): u = x0 w0 + x1 w1 + ... (summed f = 0, 1, ... as the plain
//     version), a running max per pillar, and at each pillar's end t = w5 -
//     mx w0 - my w1 - mz w2 - cx w3 - cy w4 (that order) and the ReLU; the
//     pillar's C floats are one contiguous run, stored as one kV-float
//     vector a lane (float2 at C = 64) where C = 32 kV, else channel by
//     channel.
// (Measured and not kept: one warp a 32-pillar tile, whose densest tiles
// then set the time; eight warps a tile; tiles claimed through an atomic
// counter; tiles of 32-pillar groups spread over the batch; a pillar's end
// as a call rather than inlined.)
// Built with --fmad=false and in the plain version's order of operations;
// the max is exact in any order, and the plain version's -1e9 mask enters
// as max(smax, -1e9) where cnt < N, so kernel and plain version agree bit
// for bit.
//
// Instances: fpfn_kernel<kF, kV> for F = 1..8 and kV = 1, 2, 4, 8, picked
// at run time from F and C (C <= 32: kV = 1, <= 64: 2, <= 128: 4, <= 256:
// 8); the serving path runs <4, 2>. Up to 64 channels an instance keeps
// six blocks an SM (at most 80 registers: the serving batch's 750 tiles in
// one wave), wider ones may take every register. -Xptxas -v, no instance
// spilling: <4, 2> 69 registers; kV = 1 48-74, kV = 2 56-80, kV = 4
// 74-126, kV = 8 128-252.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxF = 8;
constexpr int kMaxC = 256;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

constexpr int kTile = kThreads;  // pillars a block: one a thread
constexpr int kRowsAtOnce = 4;   // staged rows computed side by side
constexpr int kPillarCost = 3;   // a pillar's finish against a row, in the
                                 // work split between warps

template <int kF>
struct Row {
  float x[kF];
  int pillar;  // of the tile, kTile past the warp's last row
};

// the tile's kept row r (numbered in (pillar, slot) order; `incl` is the
// tile's inclusive scan of its pillars' kept counts) if r < end
template <int kF>
__device__ __forceinline__ Row<kF> load_row(const float* __restrict__ table,
                                            const int* incl, int q0,
                                            int n_pts, int end, int r,
                                            bool vec) {
  Row<kF> row;
#pragma unroll
  for (int f = 0; f < kF; ++f) row.x[f] = 0.0f;
  row.pillar = kTile;
  if (r < end) {
    int p = 0;  // the first pillar whose inclusive count passes r
#pragma unroll
    for (int s = kTile / 2; s > 0; s >>= 1)
      if (incl[p + s - 1] <= r) p += s;
    const int slot = r - (p > 0 ? incl[p - 1] : 0);
    row.pillar = p;
    const float* src = table + ((size_t)(q0 + p) * n_pts + slot) * kF;
    if (vec) {
#pragma unroll
      for (int h = 0; h < kF / 4; ++h) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(src) + h);
        row.x[4 * h] = v.x;
        row.x[4 * h + 1] = v.y;
        row.x[4 * h + 2] = v.z;
        row.x[4 * h + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int f = 0; f < kF; ++f) row.x[f] = __ldg(src + f);
    }
  }
  return row;
}

template <int kV>
__device__ __forceinline__ void store_row(float* __restrict__ out, int c,
                                          int lane, const float (&v)[kV]) {
  if (c == 32 * kV) {
    float* o = out + lane * kV;
    if constexpr (kV == 1) {
      o[0] = v[0];
    } else if constexpr (kV == 2) {
      *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
    } else {
#pragma unroll
      for (int k = 0; k < kV; k += 4)
        *reinterpret_cast<float4*>(o + k) =
            make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kV; ++k)
      if (lane * kV + k < c) out[lane * kV + k] = v[k];
  }
}

// pillar q (staged as pil): relu(max(smax, -1e9 if cnt < N) + t), 0 where
// cnt is 0; t from the pillar's means and centre, in the plain order
template <int kV>
__device__ __forceinline__ void finish(float* __restrict__ out, int q,
                                       int rows, int c, int lane, int n_pts,
                                       const float4* pil,
                                       const float (&smax)[kV],
                                       const float (&wd)[6][kV]) {
  if (q >= rows) return;
  const float4 a = pil[0];  // mx, my, mz, cx
  const float4 e = pil[1];  // cy, cnt
  float o[kV];
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const float s = e.y < (float)n_pts ? fmaxf(smax[k], -1e9f) : smax[k];
    float t = wd[5][k] - a.x * wd[0][k];
    t = t - a.y * wd[1][k];
    t = t - a.z * wd[2][k];
    t = t - a.w * wd[3][k];
    t = t - e.x * wd[4][k];
    o[k] = e.y > 0.0f ? fmaxf(s + t, 0.0f) : 0.0f;
  }
  store_row<kV>(out + (size_t)q * c, c, lane, o);
}

// instances of at most 64 channels keep six blocks an SM (all 750 tiles of
// the serving batch in one wave); wider ones may take every register
template <int kF, int kV>
__global__ void __launch_bounds__(kThreads, kV <= 2 ? 6 : 1)
fpfn_kernel(const float* __restrict__ table, const float* __restrict__ meta,
            const float* __restrict__ w_eff, const float* __restrict__ w_dec,
            float* __restrict__ out, int* __restrict__ pid_out,
            float* __restrict__ cnt_out, int rows, int p_rows, int n_pts,
            int c, int w_grid, float x_min, float y_min, float vx,
            float vy) {
  constexpr int kQ = (kF + 3) / 4;  // float4s per staged row
  __shared__ float4 s_rows[kWarps][32][kQ];
  __shared__ int4 s_which[kWarps][32 / kRowsAtOnce];  // the rows' pillars
  __shared__ float4 s_pil[kTile][2];
  __shared__ int s_incl[kTile];
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4(*srow)[kQ] = s_rows[warp];
  int* which = reinterpret_cast<int*>(s_which[warp]);
  const bool vec =
      kF % 4 == 0 && (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  const int q0 = blockIdx.x * kTile;

  float we[kF][kV], wd[6][kV];
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const int ch = lane * kV + k;
#pragma unroll
    for (int f = 0; f < kF; ++f)
      we[f][k] = ch < c ? __ldg(w_eff + f * c + ch) : 0.0f;
#pragma unroll
    for (int r = 0; r < 6; ++r)
      wd[r][k] = ch < c ? __ldg(w_dec + r * c + ch) : 0.0f;
  }

  // thread t: the tile's pillar t, its meta read once (five coalesced
  // rows a warp)
  {
    const int q = q0 + threadIdx.x;
    float cnt = 0.0f, id = 0.0f, sx = 0.0f, sy = 0.0f, sz = 0.0f;
    if (q < rows) {
      const int b = q / p_rows;
      const float* mq = meta + (size_t)b * 8 * p_rows + (q - b * p_rows);
      cnt = __ldg(mq);
      id = __ldg(mq + p_rows);
      sx = __ldg(mq + 2 * p_rows);
      sy = __ldg(mq + 3 * p_rows);
      sz = __ldg(mq + 4 * p_rows);
    }
    const int pid = (int)id;
    int kept = 0;
    if (q < rows) {
      pid_out[q] = pid;
      cnt_out[q] = cnt;
      if (cnt > 0.0f) kept = (int)fminf(ceilf(cnt), (float)n_pts);
    }
    // the block's inclusive scan of the kept counts numbers the tile's
    // kept rows in (pillar, slot) order
    int incl = kept;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    s_incl[threadIdx.x] = incl;
    const float col = (float)(pid % w_grid);
    const float rw = (float)(pid / w_grid);
    const float inv_cnt = 1.0f / fmaxf(cnt, 1.0f);
    s_pil[threadIdx.x][0] = make_float4(sx * inv_cnt, sy * inv_cnt,
                                        sz * inv_cnt,
                                        x_min + (col + 0.5f) * vx);
    s_pil[threadIdx.x][1] = make_float4(y_min + (rw + 0.5f) * vy, cnt,
                                        0.0f, 0.0f);
  }
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kWarps - 1; ++w)
    if (w < warp) before += s_warp[w];
  s_incl[threadIdx.x] += before;
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += s_warp[w];
  __syncthreads();

  // warp w takes the pillars whose work (kPillarCost per pillar plus one
  // per kept row) starts in the w-th quarter of the tile's: a contiguous
  // run of the tile's pillars and of their rows, within one pillar of a
  // quarter of the work
  const int weight = kPillarCost * kTile + total;
  const int b_lo = (warp * weight + kWarps - 1) / kWarps;
  const int b_hi = ((warp + 1) * weight + kWarps - 1) / kWarps;
  // pillar i's work starts at incl_{i-1} + kPillarCost * i: p_lo, p_hi
  // count the pillars whose work starts before b_lo, b_hi
  int p_lo = 0, p_hi = 0;
#pragma unroll
  for (int s = kTile / 2; s > 0; s >>= 1) {
    const int i = p_lo + s - 1;
    if ((i > 0 ? s_incl[i - 1] : 0) + kPillarCost * i < b_lo) p_lo += s;
    const int j = p_hi + s - 1;
    if ((j > 0 ? s_incl[j - 1] : 0) + kPillarCost * j < b_hi) p_hi += s;
  }
  constexpr int kLast = kPillarCost * (kTile - 1);
  if (p_lo == kTile - 1 && s_incl[kTile - 2] + kLast < b_lo) ++p_lo;
  if (p_hi == kTile - 1 && s_incl[kTile - 2] + kLast < b_hi) ++p_hi;
  if (warp == kWarps - 1) p_hi = kTile;
  const int r_lo = p_lo > 0 ? s_incl[p_lo - 1] : 0;
  const int r_hi = p_hi > 0 ? s_incl[p_hi - 1] : 0;
  // the warp's first round of rows
  Row<kF> nxt = load_row<kF>(table, s_incl, q0, n_pts, r_hi, r_lo + lane,
                             vec);

  int i_cur = p_lo;  // the pillar whose max is open
  float smax[kV];
#pragma unroll
  for (int k = 0; k < kV; ++k) smax[k] = -INFINITY;
  for (int r0 = r_lo; r0 < r_hi; r0 += 32) {
    __syncwarp();  // the previous round's rows are read
    float xs[kQ * 4];
#pragma unroll
    for (int f = 0; f < kQ * 4; ++f) xs[f] = 0.0f;
#pragma unroll
    for (int f = 0; f < kF; ++f) xs[f] = nxt.x[f];
#pragma unroll
    for (int h = 0; h < kQ; ++h)
      srow[lane][h] = make_float4(xs[4 * h], xs[4 * h + 1], xs[4 * h + 2],
                                  xs[4 * h + 3]);
    which[lane] = nxt.pillar;
    __syncwarp();
    // the next round's rows go out before this round's arithmetic
    if (r0 + 32 < r_hi)
      nxt = load_row<kF>(table, s_incl, q0, n_pts, r_hi, r0 + 32 + lane,
                         vec);
    const int nt = min(32, r_hi - r0);
    for (int t = 0; t < nt; t += kRowsAtOnce) {
      float u[kRowsAtOnce][kV];
      const int4 w4 = s_which[warp][t / kRowsAtOnce];
      const int it[kRowsAtOnce] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int h = 0; h < kQ; ++h) {
#pragma unroll
        for (int rr = 0; rr < kRowsAtOnce; ++rr) {
          // (a row past nt gives values that are never used)
          const float4 v4 = srow[(t + rr) & 31][h];
          const float xv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int f = 4 * h + e;
            if (f < kF) {
#pragma unroll
              for (int k = 0; k < kV; ++k)
                u[rr][k] = f == 0 ? xv[e] * we[0][k]
                                  : u[rr][k] + xv[e] * we[f][k];
            }
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowsAtOnce; ++rr) {
        if (t + rr >= nt) break;
        for (; i_cur < it[rr]; ++i_cur) {  // pillars done (or with no row)
          finish<kV>(out, q0 + i_cur, rows, c, lane, n_pts, s_pil[i_cur],
                     smax, wd);
#pragma unroll
          for (int k = 0; k < kV; ++k) smax[k] = -INFINITY;
        }
#pragma unroll
        for (int k = 0; k < kV; ++k) smax[k] = fmaxf(smax[k], u[rr][k]);
      }
    }
  }
  for (; i_cur < p_hi; ++i_cur) {
    finish<kV>(out, q0 + i_cur, rows, c, lane, n_pts, s_pil[i_cur], smax,
               wd);
#pragma unroll
    for (int k = 0; k < kV; ++k) smax[k] = -INFINITY;
  }
}

struct Args {
  const float *table, *meta, *w_eff, *w_dec;
  float* out;
  int* pid_out;
  float* cnt_out;
  int rows;
  int p_rows, n_pts, c, w_grid;
  float x_min, y_min, vx, vy;
};

template <int kF, int kV>
int launch(const Args& a, cudaStream_t stream) {
  const int grid = (a.rows + kTile - 1) / kTile;
  fpfn_kernel<kF, kV><<<grid, kThreads, 0, stream>>>(
      a.table, a.meta, a.w_eff, a.w_dec, a.out, a.pid_out, a.cnt_out, a.rows,
      a.p_rows, a.n_pts, a.c, a.w_grid, a.x_min, a.y_min, a.vx, a.vy);
  return (int)cudaGetLastError();
}

template <int kV>
int launch_f(const Args& a, int n_f, cudaStream_t stream) {
  using Launch = int (*)(const Args&, cudaStream_t);
  constexpr Launch kByF[kMaxF] = {launch<1, kV>, launch<2, kV>, launch<3, kV>,
                                  launch<4, kV>, launch<5, kV>, launch<6, kV>,
                                  launch<7, kV>, launch<8, kV>};
  return kByF[n_f - 1](a, stream);
}

}  // namespace

// table (rows, n_pts * F), meta (B, 8, p_rows) with rows = B * p_rows,
// w_eff (F, C), w_dec (8, C) -> out (rows, C), pid (rows,) int32 and cnt
// (rows,) f32, every element written (the caller may pass uninitialised
// memory). 1 <= F <= 8, 1 <= C <= 256; anything else is refused.
extern "C" int fused_pfn(const float* table, const float* meta,
                         const float* w_eff, const float* w_dec, float* out,
                         int* pid, float* cnt, int rows, int p_rows,
                         int n_pts, int n_f, int c, int w_grid, float x_min,
                         float y_min, float vx, float vy,
                         cudaStream_t stream) {
  if (n_f < 1 || n_f > kMaxF || c < 1 || c > kMaxC || rows < 0 ||
      p_rows < 0 || n_pts < 0 || w_grid < 1 ||
      (rows > 0 && (p_rows == 0 || rows % p_rows != 0)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const Args a = {table, meta,  w_eff, w_dec,  out,   pid,   cnt, rows,
                  p_rows, n_pts, c,    w_grid, x_min, y_min, vx,  vy};
  if (c <= 32) return launch_f<1>(a, n_f, stream);
  if (c <= 64) return launch_f<2>(a, n_f, stream);
  if (c <= 128) return launch_f<4>(a, n_f, stream);
  return launch_f<8>(a, n_f, stream);
}
