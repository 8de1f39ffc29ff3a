// K7 tiled rotated BEV IoU: iou[b, i, j] for boxes1[b] (N, 7) x boxes2[b]
// (M, 7), every sample of a batch in one launch.
//
// Replaces tpu_pillars/ops/iou_pallas.py _iou_tile_kernel (wrapper
// rotated_iou_bev_tiled). Its contract is carried over exactly, including
// the part that makes the result depend on the tiling: each (bi, bj) tile
// is recentred at its joint mean, 0.5 * (mean of the tile's row x +
// mean of its column x), taken over the filler boxes of ones that pad N and
// M to whole tiles too. The clipping is the JAX kernel's _half_integral (a
// division per half-plane, absolute EPS tests), not ops/iou.py's.
//
// One block per (tile column, tile row, sample). The block stages the
// tile's payloads ([x, y, w, l, cos, sin] per box; cos and sin come from
// torch, as in the plain version), reduces the four coordinate sums as a
// halving tree over the tile padded with zeros to a power of two (the plain
// version's order), computes each box's recentred corners, circumradius
// and area once into shared memory, then walks the tile's pairs, one pair
// per thread per step, neighbouring threads on neighbouring columns so the
// output stores coalesce. A pair the circumradius gate proves disjoint is
// exactly 0 and skips the integrals; filler rows and columns are never
// computed or written.
//
// Built with --fmad=false (and no fast math): every product is rounded on
// its own, as plain eager torch rounds it, so kernel and plain version
// agree to rounding.
//
// Bound on this card: operations — ~1,500 f32 operations per pair that
// passes the gate, against 24 bytes of payload per box in and 4 bytes per
// pair out.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxBlock = 256;
constexpr int kThreads = 256;
constexpr int kPay = 6;       // x, y, w, l, cos(yaw), sin(yaw)
constexpr int kBox = 12;      // corner xs[4], ys[4], x, y, radius, area
constexpr float kEps = 1e-6f;
constexpr float kBig = 1e9f;

__device__ __forceinline__ float half_integral(const float* px,
                                               const float* py,
                                               const float* qx,
                                               const float* qy) {
  float nx[4], ny[4], cc[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const float ex = qx[(h + 1) % 4] - qx[h];
    const float ey = qy[(h + 1) % 4] - qy[h];
    nx[h] = ey;
    ny[h] = -ex;
    cc[h] = nx[h] * qx[h] + ny[h] * qy[h];
  }
  float area = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float p1x = px[e], p1y = py[e];
    const float dx = px[(e + 1) % 4] - p1x;
    const float dy = py[(e + 1) % 4] - p1y;
    float t_lo = 0.0f, t_hi = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float f0 = p1x * nx[k] + p1y * ny[k] - cc[k];
      const float nd = dx * nx[k] + dy * ny[k];
      const bool parallel = fabsf(nd) <= kEps;
      const float t_star = -f0 / (parallel ? 1.0f : nd);
      const bool ok = f0 <= kEps;
      const float hi_c =
          parallel ? (ok ? kBig : -kBig) : (nd > 0.0f ? t_star : kBig);
      const float lo_c =
          parallel ? (ok ? -kBig : kBig) : (nd < 0.0f ? t_star : -kBig);
      t_hi = k == 0 ? hi_c : fminf(t_hi, hi_c);
      t_lo = k == 0 ? lo_c : fmaxf(t_lo, lo_c);
    }
    t_hi = fmaxf(fminf(t_hi, 1.0f), 0.0f);
    t_lo = fminf(fmaxf(t_lo, 0.0f), t_hi);
    const float span = t_hi - t_lo;
    const float sq = 0.5f * (t_hi * t_hi - t_lo * t_lo);
    const float contrib = dy * (p1x * span + dx * sq);
    area = e == 0 ? contrib : area + contrib;
  }
  return area;
}

// Halving-tree sum of v[0..n) padded with zeros to the power of two p.
__device__ float tree_sum(float* red, const float* pay, int n, int p,
                          int field) {
  for (int t = threadIdx.x; t < p; t += blockDim.x)
    red[t] = t < n ? pay[t * kPay + field] : 0.0f;
  for (int half = p / 2; half >= 1; half /= 2) {
    __syncthreads();
    for (int t = threadIdx.x; t < half; t += blockDim.x)
      red[t] = red[t] + red[t + half];
  }
  __syncthreads();
  const float total = red[0];
  __syncthreads();
  return total;
}

// Recentred corners, centre, circumradius and area of n staged boxes.
__device__ void box_table(float* box, const float* pay, int n, float mx,
                          float my) {
  const float sx[4] = {0.5f, -0.5f, -0.5f, 0.5f};
  const float sy[4] = {0.5f, 0.5f, -0.5f, -0.5f};
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const float* p = pay + t * kPay;
    const float x = p[0], y = p[1], w = p[2], l = p[3], c = p[4], s = p[5];
    const float xs = x - mx, ys = y - my;
    float* o = box + t * kBox;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float lx = sx[q] * l;
      const float ly = sy[q] * w;
      o[q] = xs + c * lx - s * ly;
      o[4 + q] = ys + s * lx + c * ly;
    }
    o[8] = x;
    o[9] = y;
    o[10] = sqrtf(w * w + l * l);
    o[11] = w * l;
  }
}

__global__ void __launch_bounds__(kThreads)
iou_tiled_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                 float* __restrict__ out, int n, int m, int n_pad, int m_pad,
                 int bi, int bj) {
  const int tj = blockIdx.x, ti = blockIdx.y, b = blockIdx.z;
  __shared__ float pay_i[kMaxBlock * kPay], pay_j[kMaxBlock * kPay];
  __shared__ float box_i[kMaxBlock * kBox], box_j[kMaxBlock * kBox];
  __shared__ float red[kMaxBlock];

  const float* src_i = p1 + ((size_t)b * n_pad + (size_t)ti * bi) * kPay;
  const float* src_j = p2 + ((size_t)b * m_pad + (size_t)tj * bj) * kPay;
  for (int t = threadIdx.x; t < bi * kPay; t += blockDim.x)
    pay_i[t] = src_i[t];
  for (int t = threadIdx.x; t < bj * kPay; t += blockDim.x)
    pay_j[t] = src_j[t];
  __syncthreads();

  int pi = 1, pj = 1;
  while (pi < bi) pi *= 2;
  while (pj < bj) pj *= 2;
  const float sxi = tree_sum(red, pay_i, bi, pi, 0);
  const float syi = tree_sum(red, pay_i, bi, pi, 1);
  const float sxj = tree_sum(red, pay_j, bj, pj, 0);
  const float syj = tree_sum(red, pay_j, bj, pj, 1);
  const float mx = 0.5f * (sxi / (float)bi + sxj / (float)bj);
  const float my = 0.5f * (syi / (float)bi + syj / (float)bj);
  box_table(box_i, pay_i, bi, mx, my);
  box_table(box_j, pay_j, bj, mx, my);
  __syncthreads();

  const int rows = min(bi, n - ti * bi), cols = min(bj, m - tj * bj);
  float* o = out + (size_t)b * n * m + (size_t)ti * bi * m + (size_t)tj * bj;
  for (int p = threadIdx.x; p < rows * cols; p += blockDim.x) {
    const int i = p / cols, j = p - i * cols;
    const float* a = box_i + i * kBox;
    const float* c = box_j + j * kBox;
    const float dx = a[8] - c[8];
    const float dy = a[9] - c[9];
    const float rr = 0.5f * (a[10] + c[10]);
    float iou = 0.0f;
    if (!(dx * dx + dy * dy > rr * rr)) {
      float inter = half_integral(a, a + 4, c, c + 4) +
                    half_integral(c, c + 4, a, a + 4);
      inter = fmaxf(inter, 0.0f);
      const float ai = a[11], aj = c[11];
      inter = fminf(inter, fminf(ai, aj));
      const float uni = fmaxf(ai + aj - inter, kEps);
      iou = fminf(fmaxf(inter / uni, 0.0f), 1.0f);
    }
    o[(size_t)i * m + j] = iou;
  }
}

}  // namespace

// p1 (B, n_pad, 6), p2 (B, m_pad, 6) f32 payloads, padded to whole tiles
// with filler boxes -> out (B, n, m) f32. 1 <= bi, bj <= 256.
extern "C" int iou_tiled(const float* p1, const float* p2, float* out,
                         int batch, int n, int m, int bi, int bj,
                         cudaStream_t stream) {
  if (bi < 1 || bj < 1 || bi > kMaxBlock || bj > kMaxBlock)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || n == 0 || m == 0) return 0;
  const int ti = (n + bi - 1) / bi, tj = (m + bj - 1) / bj;
  const dim3 grid(tj, ti, batch);
  iou_tiled_kernel<<<grid, kThreads, 0, stream>>>(p1, p2, out, n, m, ti * bi,
                                                  tj * bj, bi, bj);
  return (int)cudaGetLastError();
}
