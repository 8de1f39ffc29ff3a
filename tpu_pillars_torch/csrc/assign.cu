// K5 windowed target assigner: per-class best rotated BEV IoU between every
// anchor and the valid GT boxes of its own class, both ways.
//
// Replaces tpu_pillars/ops/assign_pallas.py:143 _assign_kernel (wrapper
// windowed_best_iou, :221). For each sample b, class c and anchor a of the
// class's anchor plane (Ac = Hf * Wf * Y anchors, class-block order):
//   best[b, c, a]    = max over valid g of IoU(gt[b, c, g], anchor a)
//   best_gt[b, c, a] = the first g that attains it (strict > update)
//   gt_key[b, c, g]  = max over a of (IoU, lowest a on ties), packed as one
//                      64-bit key (see below)
// A sample/class with no valid GT leaves best = -1, best_gt = 0 and the key
// 0. An anchor farther than the sum of circumradii from a valid GT gets IoU
// 0 for it without the clipping arithmetic (the exact per-anchor gate of
// ops/iou.py); every other pair runs ops/iou.py's arithmetic op for op: per-
// pair recentring, both half-edge integrals, clamp at 0, min(a1, a2) clamp,
// max(union, eps), clip to [0, 1].
//
// Design on this card. The TPU kernel walks a sequential grid over anchor
// blocks and carries each GT's best anchor across blocks in SMEM. Blocks here
// run in no order, so: one thread per (b, c, anchor), looping over the <= 64
// GT slots of its class (held in shared memory); the GT-side argmax is a
// per-block warp-shuffle + shared-memory reduction of 64-bit keys
//   key = (order-preserving bits of the f32 IoU) << 32 | (0xFFFFFFFF - a)
// followed by one atomicMax per (block, GT): the largest key is the largest
// IoU with the lowest anchor index, whatever order the blocks run in. No
// float atomics; the result is deterministic. A block whose best IoU for a GT
// is 0 skips its atomic unless it holds anchor 0 (the dense argmax's answer
// when every IoU of the GT is 0).
//
// Anchor geometry is read from precomputed planes (C, 12, Ac): corner xs
// (4), corner ys (4), centre x/y, BEV area, circumradius, computed once on
// the host in float64 and rounded to f32 exactly as the JAX kernel's
// _anchor_planes does. Reading them (coalesced: neighbouring threads,
// neighbouring anchors) keeps the corner values identical to the JAX
// package's and costs 48 bytes per anchor, against ~30 transcendental-heavy
// operations to recompute them per thread and sample.
//
// Built with --fmad=false: every product is rounded on its own, as eager
// torch rounds it, so the kernel agrees with its plain version
// (ops/assign.py windowed_best_iou_plain); IoUs that sit at a matching
// threshold would otherwise flip under fused multiply-adds.
//
// Bound on this card: bytes — 48 bytes per anchor of planes in and 8 bytes
// per (b, c, anchor) out (~80 MB at batch 8 of the full config), against
// ~1,500 f32 operations for each pair that passes the per-anchor gate plus
// ~8 for each gated pair (~0.1 GFLOP on synthetic scenes: few pairs pass).

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 64;
constexpr int kPay = 16;  // xs[4], ys[4], cx, cy, area, radius, valid, pad[3]

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

// IoU of GT payload g against the anchor (ax, ay corners; centre, area,
// radius), ops/iou.py's order: GT first in the recentring sums and in the
// two half-edge integrals.
__device__ __forceinline__ float pair_iou(const float* g, const float* ax,
                                          const float* ay, float acx,
                                          float acy, float aarea,
                                          float arad) {
  const float dx = g[8] - acx;
  const float dy = g[9] - acy;
  const float rr = g[11] + arad;
  if (dx * dx + dy * dy > rr * rr) return 0.0f;  // provably disjoint
  const float midx =
      0.125f * (g[0] + g[1] + g[2] + g[3] + ax[0] + ax[1] + ax[2] + ax[3]);
  const float midy =
      0.125f * (g[4] + g[5] + g[6] + g[7] + ay[0] + ay[1] + ay[2] + ay[3]);
  float gx[4], gy[4], bx[4], by[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    gx[q] = g[q] - midx;
    gy[q] = g[4 + q] - midy;
    bx[q] = ax[q] - midx;
    by[q] = ay[q] - midy;
  }
  float inter = half_edge_integral(gx, gy, bx, by) +
                half_edge_integral(bx, by, gx, gy);
  inter = fmaxf(inter, 0.0f);
  const float a1 = g[10];
  inter = fminf(inter, fminf(a1, aarea));
  const float uni = fmaxf(a1 + aarea - inter, 1e-6f);
  return fminf(fmaxf(inter / uni, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(kThreads)
assign_kernel(const float* __restrict__ pay, const float* __restrict__ planes,
              float* __restrict__ best_out, int32_t* __restrict__ bestg_out,
              unsigned long long* __restrict__ gt_key, int n_cls, int gc,
              int ac) {
  const int c = blockIdx.y, b = blockIdx.z;
  const int bc = b * n_cls + c;
  const int a = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  __shared__ float sg[kMaxG][kPay];
  __shared__ unsigned long long swarp[kMaxG][kWarps];
  for (int i = threadIdx.x; i < gc * kPay; i += kThreads)
    sg[i / kPay][i % kPay] = pay[(size_t)bc * gc * kPay + i];
  __syncthreads();

  const bool live = a < ac;
  float ax[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ay[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acx = 0.0f, acy = 0.0f, aarea = 0.0f, arad = 0.0f;
  if (live) {
    const float* pl = planes + (size_t)c * 12 * ac + a;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ax[q] = pl[(size_t)q * ac];
      ay[q] = pl[(size_t)(4 + q) * ac];
    }
    acx = pl[(size_t)8 * ac];
    acy = pl[(size_t)9 * ac];
    aarea = pl[(size_t)10 * ac];
    arad = pl[(size_t)11 * ac];
  }

  float best = -1.0f;
  int bestg = 0;
  for (int g = 0; g < gc; ++g) {
    if (!(sg[g][12] > 0.0f)) continue;  // invalid slot: same for the block
    unsigned long long key = 0ull;
    if (live) {
      const float iou = pair_iou(sg[g], ax, ay, acx, acy, aarea, arad);
      if (iou > best) {
        best = iou;
        bestg = g;
      }
      // iou >= 0: its bits order like the value; the top bit keeps the key
      // of an IoU of 0 above the empty key 0
      const unsigned int hi = __float_as_uint(iou) | 0x80000000u;
      key = ((unsigned long long)hi << 32) |
            (unsigned long long)(0xFFFFFFFFu - (unsigned int)a);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xFFFFFFFFu, key, off);
      key = other > key ? other : key;
    }
    if (lane == 0) swarp[g][warp] = key;
  }
  __syncthreads();
  if (threadIdx.x < gc && sg[threadIdx.x][12] > 0.0f) {
    const int g = threadIdx.x;
    unsigned long long key = swarp[g][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      key = swarp[g][w] > key ? swarp[g][w] : key;
    const bool positive = (unsigned int)(key >> 32) != 0x80000000u;
    if (key != 0ull && (positive || blockIdx.x == 0))
      atomicMax(gt_key + (size_t)bc * gc + g, key);
  }
  if (live) {
    best_out[(size_t)bc * ac + a] = best;
    bestg_out[(size_t)bc * ac + a] = bestg;
  }
}

}  // namespace

// pay (B, C, Gc, 16) f32, planes (C, 12, Ac) f32 -> best (B, C, Ac) f32,
// best_gt (B, C, Ac) int32; gt_key (B, C, Gc) uint64 must be zeroed by the
// caller.
extern "C" int assign_best_iou(const float* pay, const float* planes,
                               float* best, int32_t* best_gt,
                               unsigned long long* gt_key, int batch,
                               int n_cls, int gc, int ac,
                               cudaStream_t stream) {
  if (batch == 0 || n_cls == 0 || ac == 0) return 0;
  if (gc > kMaxG) return (int)cudaErrorInvalidValue;
  const dim3 grid((ac + kThreads - 1) / kThreads, n_cls, batch);
  assign_kernel<<<grid, kThreads, 0, stream>>>(pay, planes, best, best_gt,
                                               gt_key, n_cls, gc, ac);
  return (int)cudaGetLastError();
}
