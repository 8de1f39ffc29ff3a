// K4 NMS overlap matrix: over[j, i] = (rotated BEV IoU(j, i) > thr) & (j < i)
// over score-sorted candidates, for every sample of a batch in one launch.
//
// Replaces tpu_pillars/ops/nms_pallas.py _over_kernel (wrapper
// overlap_matrix_pallas). On the TPU every (row tile, column tile) step of
// the grid ran, the ones below the diagonal writing zeros, a tile-level
// circumradius gate skipped the clipping when no pair of the tile could
// overlap, and the payload (corner xs, corner ys, centre, BEV area,
// circumradius per box) was computed outside the kernel.
//
// Bound on this card: operations — ~1,500 f32 operations for each pair that
// passes the circumradius gate (recentring, two half-edge integrals with 8
// IEEE divisions, the IoU), against 4 * K * 7 bytes of boxes in and K * K
// bytes out per sample. At the serving batch (8 x 1,024 class-blocked
// candidates) about 1.6 M of the 4.2 M upper-triangle pairs pass the gate.
// What the design does about it:
//   * only upper-triangle tiles launch: a 1-D grid of nb (nb + 1) / 2 tiles
//     of 64 x 64 pairs per sample. A block off the diagonal also writes the
//     mirrored lower-triangle tile, all zeros, first, so every byte of out
//     is written once and no block exists only to write zeros;
//   * the block computes both strips' payloads from the boxes into shared
//     memory once (box_payload: the operations of ops/nms_overlap.py
//     payloads, in its order), so the wrapper is one launch: computed in
//     torch, the payload took some 20 small launches whose enqueueing by
//     the host cost more than the kernel;
//   * every pair of the tile is gated (j < i < K and the circumradius test),
//     and the pairs that pass are compacted into a shared-memory list (one
//     ballot and popc per warp, one shared atomic per warp). The warps then
//     run the clipping arithmetic only on listed pairs, so no lane idles
//     through a cold pair's path, and a tile with no listed pair does none;
//   * results go to a shared-memory byte tile, stored with 16-byte stores
//     when K % 16 == 0 (byte stores otherwise).
// The per-pair arithmetic (pair_overlaps) is that of ops/iou.py
// _half_edge_integral + convex_quad_intersect_area, with the per-pair
// recentring, operation for operation. Built with --fmad=false (and no fast
// math): every product is rounded on its own, as plain eager torch rounds
// it, so kernel and plain version agree except where an IoU sits within
// rounding of the threshold.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kPay = 12;  // xs[4], ys[4], cx, cy, area, circumradius
constexpr int kPayPad = 13;  // odd row stride: no shared-memory bank clashes

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

// a box (x, y, z, w, l, h, yaw) -> its payload row, as ops/iou.py
// corners_bev and ops/nms_overlap.py payloads compute it (each product
// rounded on its own, l / 2 and w / 2 exact)
__device__ __forceinline__ void box_payload(const float* __restrict__ box,
                                            float* p) {
  const float x = box[0], y = box[1], w = box[3], l = box[4];
  const float c = cosf(box[6]), s = sinf(box[6]);
  const float hl = l * 0.5f, hw = w * 0.5f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // corners (hl, hw), (-hl, hw), (-hl, -hw),
    const float lx = q == 0 || q == 3 ? hl : -hl;  // (hl, -hw)
    const float ly = q < 2 ? hw : -hw;
    p[q] = x + c * lx - s * ly;
    p[4 + q] = y + s * lx + c * ly;
  }
  p[8] = x;
  p[9] = y;
  p[10] = w * l;
  p[11] = 0.5f * sqrtf(w * w + l * l);
}

// IoU(j, i) > thr for a pair that passed the gate (pj, pi: payload rows)
__device__ __forceinline__ bool pair_overlaps(const float* pj, const float* pi,
                                              float thr) {
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
  return iou > thr;
}

// rows [r0, r0 + kTile) x columns [c0, c0 + kTile) of one sample's (k, k)
// matrix from the byte tile s (nullptr: zeros), clipped to k
__device__ __forceinline__ void store_tile(uint8_t* __restrict__ ob,
                                           const uint8_t* s, int r0, int c0,
                                           int k, bool wide) {
  if (wide) {  // k % 16 == 0: a 16-byte chunk lies wholly in or out
    for (int e = threadIdx.x; e < kTile * kTile / 16; e += kThreads) {
      const int row = e / (kTile / 16), col = (e % (kTile / 16)) * 16;
      if (r0 + row < k && c0 + col < k) {
        const uint4 v = s ? *reinterpret_cast<const uint4*>(
                                s + row * kTile + col)
                          : make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(ob + (size_t)(r0 + row) * k + c0 + col) =
            v;
      }
    }
  } else {
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int row = e / kTile, col = e % kTile;
      if (r0 + row < k && c0 + col < k) {
        ob[(size_t)(r0 + row) * k + c0 + col] = s ? s[e] : 0;
      }
    }
  }
}

// grid (nb (nb + 1) / 2, B): block (t, b) takes upper tile t of sample b,
// in row-major order of the tiles (bj, bi) with bj <= bi
__global__ void __launch_bounds__(kThreads)
nms_overlap_kernel(const float* __restrict__ boxes,
                   uint8_t* __restrict__ out, int k, int nb, float thr,
                   bool wide) {
  __shared__ float sj[kTile][kPayPad], si[kTile][kPayPad];
  __shared__ uint16_t s_hot[kTile * kTile];  // listed pairs, jl * kTile + il
  __shared__ __align__(16) uint8_t s_out[kTile * kTile];
  __shared__ int s_n;

  int t = blockIdx.x, bj = 0;
  while (t >= nb - bj) {
    t -= nb - bj;
    ++bj;
  }
  const int bi = bj + t;
  const int b = blockIdx.y;
  const int j0 = bj * kTile, i0 = bi * kTile;
  uint8_t* ob = out + (size_t)b * k * k;
  // the mirrored tile lies strictly below the diagonal: zeros, stored
  // first so that they overlap the work below
  if (bj < bi) store_tile(ob, nullptr, i0, j0, k, wide);

  if (threadIdx.x < 2 * kTile) {  // one box per thread: rows, then columns
    const int row = threadIdx.x % kTile;
    const int g = (threadIdx.x < kTile ? j0 : i0) + row;
    float* dst = threadIdx.x < kTile ? sj[row] : si[row];
    if (g < k) {
      box_payload(boxes + ((size_t)b * k + g) * 7, dst);
    } else {
#pragma unroll
      for (int c = 0; c < kPay; ++c) dst[c] = 0.0f;
    }
  }
  for (int e = threadIdx.x; e < kTile * kTile / 16; e += kThreads) {
    reinterpret_cast<uint4*>(s_out)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();

  // gate every pair; list the ones that pass. A warp's 32 pairs share a row.
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x; q < kTile * kTile; q += kThreads) {
    const int jl = q / kTile, il = q % kTile;
    const int j = j0 + jl, i = i0 + il;
    bool warm = false;
    if (j < i && i < k) {
      const float dx = sj[jl][8] - si[il][8];
      const float dy = sj[jl][9] - si[il][9];
      const float rr = sj[jl][11] + si[il][11];
      const float sep = dx * dx + dy * dy - rr * rr;  // > 0: disjoint
      warm = sep <= 0.0f;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, warm);
    if (ballot) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&s_n, __popc(ballot));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (warm) {
        s_hot[base + __popc(ballot & ((1u << lane) - 1u))] = (uint16_t)q;
      }
    }
  }
  __syncthreads();

  const int n_hot = s_n;
  for (int h = threadIdx.x; h < n_hot; h += kThreads) {
    const int q = s_hot[h];
    const int jl = q / kTile, il = q % kTile;
    if (pair_overlaps(sj[jl], si[il], thr)) s_out[q] = 1;
  }
  __syncthreads();
  store_tile(ob, s_out, j0, i0, k, wide);
}

}  // namespace

// boxes (B, K, 7) f32 -> out (B, K, K) uint8 (0/1), every byte written.
extern "C" int nms_overlap(const float* boxes, uint8_t* out, int batch, int k,
                           float thr, cudaStream_t stream) {
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  if (batch == 0 || k == 0) return 0;
  const int nb = (k + kTile - 1) / kTile;
  const dim3 grid(nb * (nb + 1) / 2, batch);
  const bool wide = k % 16 == 0 && ((uintptr_t)out & 15) == 0;
  nms_overlap_kernel<<<grid, kThreads, 0, stream>>>(boxes, out, k, nb, thr,
                                                     wide);
  return (int)cudaGetLastError();
}
