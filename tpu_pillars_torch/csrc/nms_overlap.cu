// K4 NMS overlap matrix: over[j, i] = (rotated BEV IoU(j, i) > thr) & (j < i)
// over score-sorted candidates, for every sample of a batch in one launch.
//
// Replaces tpu_pillars/ops/nms_pallas.py _over_kernel (wrapper
// overlap_matrix_pallas), with the same structure:
//   * tiles strictly below the diagonal (bj > bi) write zeros and stop;
//   * a tile-level circumradius gate runs first: when no pair of the tile can
//     overlap (|d|^2 > (r_j + r_i)^2 for all), the tile writes zeros;
//   * hot pairs run the clipping arithmetic of ops/iou.py
//     _half_edge_integral + convex_quad_intersect_area, including the
//     per-pair recentring, then the iou > thr test and & (j < i).
// The payload (corner xs, corner ys, centre, BEV area, circumradius per box)
// is computed in torch outside the kernel, as on the TPU.
//
// Built with --fmad=false (and no fast math): every product is rounded on
// its own, as plain eager torch rounds it, so kernel and plain version agree
// except where an IoU sits within rounding of the threshold.
//
// Bound on this card: operations — ~400 f32 flops per hot pair against
// 4 * K * 12 bytes of payload in and K * K bytes out per sample; the gates
// skip the lower triangle and every cross-class or far-apart tile.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kTile = 16;
constexpr int kPay = 12;  // xs[4], ys[4], cx, cy, area, circumradius

__device__ __forceinline__ float half_edge_integral(const float* px,
                                                    const float* py,
                                                    const float* cx,
                                                    const float* cy) {
  const float big = 1e9f, rel = 3e-4f, eps = 1e-6f;
  float nx[4], ny[4], cc[4], nlen[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    nx[k] = cy[(k + 1) % 4] - cy[k];
    ny[k] = cx[k] - cx[(k + 1) % 4];
    cc[k] = nx[k] * cx[k] + ny[k] * cy[k];
    nlen[k] = fabsf(nx[k]) + fabsf(ny[k]);
  }
  float total = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float x1 = px[e], y1 = py[e];
    const float dx = px[(e + 1) % 4] - x1;
    const float dy = py[(e + 1) % 4] - y1;
    const float dlen = fabsf(dx) + fabsf(dy);
    const float plen = fabsf(x1) + fabsf(y1);
    float ph = 1.0f, qh = 1.0f, pl = 0.0f, ql = 1.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float f0 = x1 * nx[k] + y1 * ny[k] - cc[k];
      const float nd = dx * nx[k] + dy * ny[k];
      const bool parallel = fabsf(nd) <= rel * (dlen * nlen[k]) + eps;
      const bool violated =
          parallel && (f0 > rel * (plen * nlen[k] + fabsf(cc[k])) + eps);
      const bool exiting = !parallel && (nd > 0.0f);
      const bool entering = !parallel && (nd < 0.0f);
      const float hp = exiting ? -f0 : (violated ? -big : big);
      const float hq = exiting ? nd : 1.0f;
      const float lp = entering ? f0 : (violated ? big : -big);
      const float lq = entering ? -nd : 1.0f;
      if (!(ph * hq < hp * qh)) {  // _fmin2 keeps (ph, qh) when it wins
        ph = hp;
        qh = hq;
      }
      if (!(pl * lq > lp * ql)) {  // _fmax2
        pl = lp;
        ql = lq;
      }
    }
    const float cross = ph * ql - pl * qh;
    const float mixed = ph * ql + pl * qh;
    const float inv = 1.0f / (qh * ql);
    float contrib = dy * cross * inv * (x1 + 0.5f * dx * mixed * inv);
    contrib = cross > 0.0f ? contrib : 0.0f;
    total = e == 0 ? contrib : total + contrib;
  }
  return total;
}

__global__ void __launch_bounds__(kTile * kTile)
nms_overlap_kernel(const float* __restrict__ pay, uint8_t* __restrict__ out,
                   int k, float thr) {
  const int bi = blockIdx.x, bj = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = bi * kTile + tx;  // suppressee (column)
  const int j = bj * kTile + ty;  // suppressor (row)
  const bool in_range = i < k && j < k;
  uint8_t* o = out + (size_t)b * k * k + (size_t)j * k + i;

  if (bj > bi) {  // strictly below the diagonal: j > i everywhere
    if (in_range) *o = 0;
    return;
  }

  __shared__ float sj[kTile][kPay], si[kTile][kPay];
  const float* pb = pay + (size_t)b * k * kPay;
  const int lin = ty * kTile + tx;
  if (lin < kTile * kPay) {
    const int row = lin / kPay, col = lin % kPay;
    const int gj = bj * kTile + row, gi = bi * kTile + row;
    sj[row][col] = gj < k ? pb[(size_t)gj * kPay + col] : 0.0f;
    si[row][col] = gi < k ? pb[(size_t)gi * kPay + col] : 0.0f;
  }
  __syncthreads();

  const float* pj = sj[ty];
  const float* pi = si[tx];
  const float dx = pj[8] - pi[8];
  const float dy = pj[9] - pi[9];
  const float rr = pj[11] + pi[11];
  const float sep = dx * dx + dy * dy - rr * rr;  // > 0: provably disjoint
  const bool warm = in_range && sep <= 0.0f;
  if (!__syncthreads_or(warm)) {
    if (in_range) *o = 0;
    return;
  }
  uint8_t over = 0;
  if (warm) {
    float jx[4], jy[4], ix[4], iy[4];
    const float midx = 0.125f * (pj[0] + pj[1] + pj[2] + pj[3] + pi[0] +
                                 pi[1] + pi[2] + pi[3]);
    const float midy = 0.125f * (pj[4] + pj[5] + pj[6] + pj[7] + pi[4] +
                                 pi[5] + pi[6] + pi[7]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      jx[q] = pj[q] - midx;
      jy[q] = pj[4 + q] - midy;
      ix[q] = pi[q] - midx;
      iy[q] = pi[4 + q] - midy;
    }
    float inter = half_edge_integral(jx, jy, ix, iy) +
                  half_edge_integral(ix, iy, jx, jy);
    inter = fmaxf(inter, 0.0f);
    const float aj = pj[10], ai = pi[10];
    inter = fminf(inter, fminf(aj, ai));
    const float uni = fmaxf(aj + ai - inter, 1e-6f);
    const float iou = fminf(fmaxf(inter / uni, 0.0f), 1.0f);
    over = (iou > thr) && (j < i);
  }
  if (in_range) *o = over;
}

}  // namespace

// pay (B, K, 12) f32 -> out (B, K, K) uint8 (0/1).
extern "C" int nms_overlap(const float* pay, uint8_t* out, int batch, int k,
                           float thr, cudaStream_t stream) {
  if (batch == 0 || k == 0) return 0;
  const int nb = (k + kTile - 1) / kTile;
  const dim3 grid(nb, nb, batch);
  const dim3 block(kTile, kTile);
  nms_overlap_kernel<<<grid, block, 0, stream>>>(pay, out, k, thr);
  return (int)cudaGetLastError();
}
