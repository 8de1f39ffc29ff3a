// K7 tiled rotated BEV IoU: iou[b, i, j] for boxes1[b] (N, 7) x boxes2[b]
// (M, 7), every sample of a batch in one launch.
//
// Replaces tpu_pillars/ops/iou_pallas.py _iou_tile_kernel (wrapper
// rotated_iou_bev_tiled). Its contract is carried over exactly, including
// the part that makes the result depend on the tiling: each (bi, bj) JAX
// tile is recentred at its joint mean, 0.5 * (mean of the tile's row x +
// mean of its column x), taken over the filler boxes of ones that pad N and
// M to whole tiles too, each sum a halving tree over the tile padded with
// zeros to a power of two (the plain version's order). The clipping is the
// JAX kernel's _half_integral (a division per half-plane, absolute EPS
// tests), not ops/iou.py's.
//
// Bound on this card: operations. A pair that passes the circumradius gate
// costs ~850 counted f32 operations and 32 IEEE divisions; at the serving
// batch's candidates (8 x 1,024 against themselves) 37.9% of the 8.4 M
// pairs pass it. Built with --fmad=false, every counted operation is one
// instruction, so the arithmetic alone cannot go below about twice the
// operations bound (67 TFLOP/s counts an FMA as two).
//
// What held the first design back (one block per JAX tile, every thread
// walking the tile's pairs with the gate as a branch): hot pairs lie all
// over a tile (candidates come in score order, not in space), so nearly
// every warp had a hot lane and paid the whole clipping path while its
// cold lanes idled; every pair recomputed its clip box's half-planes
// twice; column boxes sat 12 words apart in shared memory (4-way bank
// conflicts); the wrapper built the payload in six or more torch launches;
// 512 blocks of 38 KB set a one-wave tail. What this design does:
//   * one launch: the kernel reads the boxes through the strides the
//     wrapper passes (a view such as cands[..., :7] needs no copy) and
//     computes cos and sin itself (cosf / sinf, which round as torch.cos
//     and torch.sin do on the card); rows at or past N and columns at or
//     past M are the fillers, x = y = 1 in the tile sums, and are never
//     computed or written;
//   * a CUDA block takes a kSubR x kSubC = 64 x 64 sub-range of its JAX
//     tile, and still recentres at the JAX tile's mean: four warps each sum
//     one of the tile's row x, row y, column x, column y (all bi or bj
//     boxes, fillers included) as the halving tree, in registers and
//     shuffles, while the other four load the sub-range's boxes;
//   * a table of the block's boxes, built once in shared memory: recentred
//     corners, half-planes (in the operation order of _half_integral's
//     prologue), centre, circumradius and area, each box a row of 28 words
//     read as 16-byte loads, conflict-free for neighbouring boxes;
//   * every pair of the sub-range is gated, and the pairs that pass are
//     listed (a ballot per step, one shared atomic per warp). The warps
//     then clip only listed pairs, each pair's two boxes loaded into
//     registers once: no lane idles through a cold pair's path, and a
//     sub-range with no hot pair clips nothing;
//   * half_integral folds the JAX kernel's selects (below), since compares
//     and selects run at half the rate of products and sums;
//   * blocks start heavy-first and end short: the sample is the innermost
//     index, so the first rows and columns of every sample (where score
//     order puts the clusters of candidates) start before any sample's
//     last ones, and the last strip of row sub-ranges is cut in halves;
//   * results are staged in shared memory, zeros first, and stored row by
//     row, 16 bytes a thread where m % 4 == 0 and the sub-range is aligned.
// A hot pair runs ~1,000 instructions for its ~850 counted operations
// (33 IEEE divisions of ~10 each, with their slow-path branches), at some
// 60% of the card's issue rate. PERF.md section 6 has the probe's numbers
// behind these choices (scripts/probe_torch_iou_tiled.py, its --variants
// among them) and the compiler's report (-Xptxas -v: 72 registers, 38,932
// bytes of static shared memory, no spill; the 32-byte stack frame is
// cosf / sinf's reduction of huge arguments).
//
// Built with --fmad=false (and no fast math, no approximate division):
// every product is rounded on its own, as plain eager torch rounds it, so
// kernel and plain version agree to rounding.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxBlock = 256;  // largest JAX tile side
constexpr int kSubR = 64;       // a CUDA block's sub-range: rows
constexpr int kSubC = 64;       // and columns (a whole number of warps);
                                // the last strips take kSubR / 2 rows
constexpr int kThreads = 256;  // warps 0-3 load boxes, 4-7 sum the tile
constexpr int kGateSteps = kSubR * kSubC / kThreads;
static_assert(kSubR + kSubC <= 128 && kSubC % 32 == 0 &&
                  kSubR * kSubC <= 65536 && kGateSteps * kThreads ==
                  kSubR * kSubC,
              "a box per thread of warps 0-3, whole warps of pairs per row, "
              "16-bit pair indices, whole gate steps");
constexpr float kEps = 1e-6f;
constexpr float kBig = 1e9f;

// A box of the table, tab[box][0..24): its recentred corners (x[4],
// y[4]), its half-planes (nx[4], ny[4], c[4]), then its centre (not
// recentred, the gate's), circumradius sqrt(w^2 + l^2) and area. Rows at
// box < kSubR, columns at kSubR + box. A row of kStride = 28 words is read
// as 16-byte loads, and 8 neighbouring boxes then fall on distinct banks.
constexpr int kGate = 20;  // centre x, centre y, circumradius, area
constexpr int kStride = 28;

struct Quad {
  float x[4], y[4];          // corners, counter-clockwise
  float nx[4], ny[4], c[4];  // half-plane h: nx x + ny y <= c
  float area;
};

__device__ __forceinline__ Quad load_quad(const float* row) {
  const float4* p = reinterpret_cast<const float4*>(row);
  const float4 x = p[0], y = p[1], nx = p[2], ny = p[3], c = p[4], g = p[5];
  return Quad{{x.x, x.y, x.z, x.w},     {y.x, y.y, y.z, y.w},
              {nx.x, nx.y, nx.z, nx.w}, {ny.x, ny.y, ny.z, ny.w},
              {c.x, c.y, c.z, c.w},     g.w};
}

// Sum over poly's edges of int x dy restricted to the inside of the convex
// clip given by its half-planes: the JAX kernel's _half_integral past its
// prologue, with the same products, sums and divisions. Edge e's vector is
// (-ny[e], nx[e]) of poly's own half-plane e: the same subtractions. The
// selects are folded, which changes no value: t_hi, the min over the
// planes' exit parameters and 1e9 for the others, then clamped to [0, 1],
// is the min of 1 and the exit parameters, clamped at 0 (min is exact),
// and likewise for t_lo. A parallel plane that the edge lies outside of
// sets t_lo to 1e9, so t_lo ends at t_hi and the edge adds
// dy * (p1x * 0 + dx * 0), as the JAX kernel's empty interval does. That
// leaves 8 compares and selects per plane instead of 13.
__device__ __forceinline__ float half_integral(const Quad& poly,
                                               const Quad& clip) {
  float area = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float p1x = poly.x[e], p1y = poly.y[e];
    const float dx = -poly.ny[e], dy = poly.nx[e];
    float t_lo = 0.0f, t_hi = 1.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float f0 = p1x * clip.nx[k] + p1y * clip.ny[k] - clip.c[k];
      const float nd = dx * clip.nx[k] + dy * clip.ny[k];
      const bool parallel = fabsf(nd) <= kEps;
      const float t_star = -f0 / (parallel ? 1.0f : nd);
      if (nd > kEps) t_hi = fminf(t_hi, t_star);
      if (nd < -kEps) t_lo = fmaxf(t_lo, t_star);
      if (parallel && f0 > kEps) t_lo = kBig;
    }
    t_hi = fmaxf(t_hi, 0.0f);
    t_lo = fminf(t_lo, t_hi);
    const float span = t_hi - t_lo;
    const float sq = 0.5f * (t_hi * t_hi - t_lo * t_lo);
    const float contrib = dy * (p1x * span + dx * sq);
    area = e == 0 ? contrib : area + contrib;
  }
  return area;
}

// One warp: the halving-tree sum of one field (src points at it, sn is the
// box stride) of the `size` boxes of a JAX tile starting at box `base`,
// padded with zeros to the power of two p; boxes at or past `limit` are
// fillers (1). Element t of a level adds element t + half: levels of
// half >= 32 in registers (value k of a lane is element lane + 32 k), then
// shuffles. The result is in lane 0.
__device__ __forceinline__ float tile_sum(const float* __restrict__ src,
                                          long long sn, int base, int size,
                                          int limit) {
  const int lane = threadIdx.x & 31;
  int p = 1;
  while (p < size) p *= 2;
  float v[kMaxBlock / 32];
#pragma unroll
  for (int k = 0; k < kMaxBlock / 32; ++k) {
    const int t = lane + 32 * k;
    const int g = base + t;
    v[k] = t < size ? (g < limit ? src[(long long)g * sn] : 1.0f) : 0.0f;
  }
  if (p >= 256) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = v[k] + v[k + 4];
  }
  if (p >= 128) {
#pragma unroll
    for (int k = 0; k < 2; ++k) v[k] = v[k] + v[k + 2];
  }
  if (p >= 64) v[0] = v[0] + v[1];
  for (int h = (p < 32 ? p : 32) / 2; h >= 1; h /= 2)
    v[0] = v[0] + __shfl_down_sync(0xffffffffu, v[0], h);
  return v[0];
}

// One block per (row sub-range, column sub-range, sample), in strips of
// row sub-ranges (nrb in all) and the sample innermost: candidates come in
// score order, so the first rows and columns of every sample hold the most
// hot pairs, and they start first. The last `split` strips are cut into
// halves of kSubR / 2 rows, so the last blocks to start are short.
__global__ void __launch_bounds__(kThreads, 2)
iou_tiled_kernel(const float* __restrict__ b1, const float* __restrict__ b2,
                 float* __restrict__ out, int n, int m, int bi, int bj,
                 int batch, int ncb, int nrb, int split, int sb1, int sn1,
                 int sc1, int sb2, int sn2, int sc2, bool wide_ok) {
  __shared__ __align__(16) float tab[kSubR + kSubC][kStride];
  __shared__ __align__(16) float s_out[kSubR * kSubC];
  __shared__ uint16_t s_hot[kSubR * kSubC];  // listed pairs, i * kSubC + j
  __shared__ float s_sum[4];               // row x, row y, column x, column y
  __shared__ int s_n;

  const int per_j = (bj + kSubC - 1) / kSubC;
  const int per_i = (bi + kSubR - 1) / kSubR;
  const int unit = blockIdx.x;
  const int per_strip = ncb * batch, whole = (nrb - split) * per_strip;
  int rb, rest, off = 0, height = kSubR;
  if (unit < whole) {
    rb = unit / per_strip;
    rest = unit - rb * per_strip;
  } else {  // half-strips: both halves of strip nrb - split first, ...
    const int y = unit - whole, half = y / per_strip;
    rb = nrb - split + half / 2;
    off = (half & 1) * (kSubR / 2);
    height = kSubR / 2;
    rest = y - half * per_strip;
  }
  const int b = rest % batch, cb = rest / batch;
  const int tj = cb / per_j, sj = cb - tj * per_j;
  const int ti = rb / per_i, si = rb - ti * per_i;
  const int row0 = ti * bi + si * kSubR + off, col0 = tj * bj + sj * kSubC;
  const int rows = min(min(height, bi - si * kSubR - off), n - row0);
  const int cols = min(min(kSubC, bj - sj * kSubC), m - col0);
  if (rows <= 0 || cols <= 0) return;  // a sub-range of fillers only

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const bool is_row = t < kSubR;
  const int box = is_row ? t : t - kSubR;  // for t < kSubR + kSubC
  const bool has_box = t < kSubR + kSubC && box < (is_row ? rows : cols);
  float w = 0.0f, l = 0.0f, c = 0.0f, s = 0.0f;
  if (warp >= 4) {  // the JAX tile's four sums
    const int which = warp - 4;
    const bool row_sum = which < 2;
    const float* src = row_sum ? b1 + (long long)b * sb1 + (which & 1) * sc1
                               : b2 + (long long)b * sb2 + (which & 1) * sc2;
    const float sum =
        row_sum ? tile_sum(src, sn1, ti * bi, bi, n)
                : tile_sum(src, sn2, tj * bj, bj, m);
    if (lane == 0) s_sum[which] = sum;
  } else if (has_box) {  // the sub-range's boxes
    const float* p = is_row ? b1 + (long long)b * sb1 +
                                  (long long)(row0 + box) * sn1
                            : b2 + (long long)b * sb2 +
                                  (long long)(col0 + box) * sn2;
    const int sc = is_row ? sc1 : sc2;
    const float x = p[0], y = p[sc], yaw = p[6 * sc];
    w = p[3 * sc];
    l = p[4 * sc];
    *reinterpret_cast<float4*>(&tab[t][kGate]) =
        make_float4(x, y, sqrtf(w * w + l * l), w * l);
    c = cosf(yaw);
    s = sinf(yaw);
  }
  for (int e = t; e < kSubR * kSubC / 4; e += kThreads)
    reinterpret_cast<float4*>(s_out)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (t == 0) s_n = 0;
  __syncthreads();

  if (has_box) {  // recentred corners, then the half-planes (_half_integral)
    // the tile means as torch divides a tensor by an int on the card: a
    // product with the f32 reciprocal (exact for blocks that are powers of
    // two; within an ulp of the quotient otherwise)
    const float ri = 1.0f / (float)bi, rj = 1.0f / (float)bj;
    const float mx = 0.5f * (s_sum[0] * ri + s_sum[2] * rj);
    const float my = 0.5f * (s_sum[1] * ri + s_sum[3] * rj);
    const float xs = tab[t][kGate] - mx, ys = tab[t][kGate + 1] - my;
    float qx[4], qy[4], nx[4], ny[4], nc[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // corners (l, w) / 2 times (+ +), (- +),
      const float lx = (q == 0 || q == 3 ? 0.5f : -0.5f) * l;  // (- -), (+ -)
      const float ly = (q < 2 ? 0.5f : -0.5f) * w;
      qx[q] = xs + c * lx - s * ly;
      qy[q] = ys + s * lx + c * ly;
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float ex = qx[(h + 1) % 4] - qx[h];
      const float ey = qy[(h + 1) % 4] - qy[h];
      nx[h] = ey;
      ny[h] = -ex;
      nc[h] = nx[h] * qx[h] + ny[h] * qy[h];
    }
    float4* row = reinterpret_cast<float4*>(tab[t]);
    row[0] = make_float4(qx[0], qx[1], qx[2], qx[3]);
    row[1] = make_float4(qy[0], qy[1], qy[2], qy[3]);
    row[2] = make_float4(nx[0], nx[1], nx[2], nx[3]);
    row[3] = make_float4(ny[0], ny[1], ny[2], ny[3]);
    row[4] = make_float4(nc[0], nc[1], nc[2], nc[3]);
  }

  // gate every pair of the sub-range (the un-recentred centres); list the
  // ones that pass: a ballot per step, then one shared atomic per warp
  unsigned warm[kGateSteps];
  int n_warm = 0;
#pragma unroll
  for (int k = 0; k < kGateSteps; ++k) {
    const int q = t + k * kThreads, i = q / kSubC, j = q % kSubC;
    bool pass = false;
    if (q < rows * kSubC && j < cols) {
      const float4 gi = *reinterpret_cast<const float4*>(&tab[i][kGate]);
      const float4 gj =
          *reinterpret_cast<const float4*>(&tab[kSubR + j][kGate]);
      const float dx = gi.x - gj.x, dy = gi.y - gj.y;
      const float rr = 0.5f * (gi.z + gj.z);
      pass = !(dx * dx + dy * dy > rr * rr);
    }
    warm[k] = __ballot_sync(0xffffffffu, pass);
    n_warm += __popc(warm[k]);
  }
  int base = 0;
  if (lane == 0 && n_warm) base = atomicAdd(&s_n, n_warm);
  base = __shfl_sync(0xffffffffu, base, 0);
#pragma unroll
  for (int k = 0; k < kGateSteps; ++k) {
    if (warm[k] >> lane & 1u)
      s_hot[base + __popc(warm[k] & ((1u << lane) - 1u))] = t + k * kThreads;
    base += __popc(warm[k]);
  }
  __syncthreads();

  const int n_hot = s_n;
  for (int h = t; h < n_hot; h += kThreads) {
    const int q = s_hot[h];
    const Quad qi = load_quad(tab[q / kSubC]);
    const Quad qj = load_quad(tab[kSubR + q % kSubC]);
    float inter = half_integral(qi, qj) + half_integral(qj, qi);
    inter = fmaxf(inter, 0.0f);
    const float ai = qi.area, aj = qj.area;
    inter = fminf(inter, fminf(ai, aj));
    const float uni = fmaxf(ai + aj - inter, kEps);
    s_out[q] = fminf(fmaxf(inter / uni, 0.0f), 1.0f);
  }
  __syncthreads();

  float* o = out + ((long long)b * n + row0) * m + col0;
  if (wide_ok && ((col0 | cols) & 3) == 0) {  // whole 16-byte chunks
    const int per = cols / 4;
    for (int e = t; e < rows * per; e += kThreads) {
      const int r = e / per, c4 = e - r * per;
      *reinterpret_cast<float4*>(o + (long long)r * m + 4 * c4) =
          *reinterpret_cast<const float4*>(s_out + r * kSubC + 4 * c4);
    }
  } else {
    for (int e = t; e < rows * cols; e += kThreads) {
      const int r = e / cols, cc = e - r * cols;
      o[(long long)r * m + cc] = s_out[r * kSubC + cc];
    }
  }
}

}  // namespace

// b1 (B, N, 7), b2 (B, M, 7) f32, read through their strides (elements:
// sample, box, field) -> out (B, N, M) f32, contiguous. 1 <= bi, bj <= 256.
extern "C" int iou_tiled(const float* b1, const float* b2, float* out,
                         int batch, int n, int m, int bi, int bj, int sb1,
                         int sn1, int sc1, int sb2, int sn2, int sc2,
                         cudaStream_t stream) {
  if (bi < 1 || bj < 1 || bi > kMaxBlock || bj > kMaxBlock)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || n <= 0 || m <= 0) return 0;
  const long long ncb =
      (long long)((m + bj - 1) / bj) * ((bj + kSubC - 1) / kSubC);
  const long long nrb =
      (long long)((n + bi - 1) / bi) * ((bi + kSubR - 1) / kSubR);
  const long long split = (nrb + 15) / 16;  // strips cut in two
  if (ncb * (nrb + split) > INT_MAX / batch)
    return (int)cudaErrorInvalidValue;
  const bool wide_ok = m % 4 == 0 && ((uintptr_t)out & 15) == 0;
  const unsigned grid = (unsigned)(ncb * (nrb + split) * batch);
  iou_tiled_kernel<<<grid, kThreads, 0, stream>>>(
      b1, b2, out, n, m, bi, bj, batch, (int)ncb, (int)nrb, (int)split, sb1,
      sn1, sc1, sb2, sn2, sc2, wide_ok);
  return (int)cudaGetLastError();
}
