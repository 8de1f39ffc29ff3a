// K5 windowed target assigner: per-class best rotated BEV IoU between every
// anchor and the valid GT boxes of its own class, both ways.
//
// Replaces tpu_pillars/ops/assign_pallas.py:143 _assign_kernel (wrapper
// windowed_best_iou, :221). For each sample b, class c and anchor a of the
// class's anchor plane (Ac = Hf * Wf * Y anchors, class-block order):
//   best[b, c, a]           = max over valid g of IoU(gt[b, c, g], anchor a)
//   best_gt[b, c, a]        = the first g that attains it (int64)
//   gt_best_iou[b, c, g]    = max over a of that IoU
//   gt_best_anchor[b, c, g] = the lowest a that attains it (int64)
// with the semantics of ops/assign.py windowed_best_iou_plain: a class with
// no valid GT reads best -1, best_gt 0; an anchor whose valid GT all read 0
// reads best 0 and the first valid slot; an invalid slot reads (-1, 0) and a
// valid GT with no positive IoU (0, 0). An anchor farther than the sum of
// circumradii from a GT gets IoU 0 for it without the clipping arithmetic
// (the exact per-anchor gate of ops/iou.py); every other pair runs
// ops/iou.py's arithmetic op for op: per-pair recentring, both half-edge
// integrals, clamp at 0, min(a1, a2) clamp, max(union, eps), clip to [0, 1].
//
// Bound on this card: bytes. The planes (48 bytes per anchor) are read once
// and best (4 bytes) and best_gt (8 bytes) written once per (b, c, anchor):
// ~104 MB at batch 8 of the full config, 0.031 ms at 3.35 TB/s. On training
// scenes few pairs pass the per-anchor gate, so the arithmetic is small.
// The design follows from that:
//   * one C entry, one kernel, one launch from the wrapper, which runs no
//     torch op but its output allocations: the GT payload (corners, centre,
//     area, circumradius) is computed in the kernel from the boxes, with
//     cosf / sinf and the operations of ops/assign.py gt_payload and
//     ops/iou.py corners_bev in their order (as csrc/nms_overlap.cu's
//     box_payload), and the kernel writes the int64 indices itself;
//   * anchor blocks (anchor tile, class, sample group). A tile is kRows
//     feature rows by 32 consecutive anchors of each row (the row's Wf * Y
//     anchors in (column, yaw) order: 16 cells at 2 yaws), one warp per row
//     segment, so every load and store of a warp is 32 neighbouring
//     anchors. The block holds its tile's planes in registers (one anchor
//     per thread) and loops over the samples of its group, so the 34.6 MB
//     of planes are read once, not once per sample. A group is as many
//     samples as kPayRows payload rows hold in shared memory (kPayRows /
//     Gc: all 8 samples of the training batch at Gc = 16, 4 at Gc = 64);
//   * a block-level gate, exact in effect: the host gives each (class,
//     tile) a circle that holds every anchor's centre with its circumradius
//     added (ops/assign.py tile_circles, float64, rounded up). A GT whose
//     centre lies farther from the circle's centre than the circle's
//     radius plus its own circumradius, with a relative slack of 1e-4 and
//     1e-3 m, cannot pass the per-anchor gate with any anchor of the tile
//     even after f32 rounding (the slack exceeds the gate's rounding by
//     orders of magnitude), so the block skips it. The tile is near square
//     (16 x 8 m at the full config's 1 m anchor stride) so that its circle
//     is tight: 256 consecutive anchors of the class-block order would be
//     a 128 m strip, whose circle skips almost nothing;
//   * anchors start from the class's valid set (best 0 at the first valid
//     slot, or best -1 with no valid GT), so a skipped GT leaves exactly
//     what its IoU of 0 would have left;
//   * the GT side needs no reduction across blocks: a GT's positive IoUs
//     lie in the few tiles its gate lets through, so one block per GT slot
//     (the first blocks of the grid, which run beside the anchor blocks)
//     walks those tiles' anchors through the same gate and IoU and keeps
//     the largest 64-bit key (IoU bits, then the lowest anchor). A
//     reduction across the anchor blocks would need scratch zeroed before
//     the kernel and a decode pass after it; this needs no atomics, no
//     scratch and no second operation. The result is deterministic.
//
// Anchor geometry is read from precomputed planes (C, 12, Ac): corner xs
// (4), corner ys (4), centre x/y, BEV area, circumradius, computed once on
// the host in float64 and rounded to f32 exactly as the JAX kernel's
// _anchor_planes does, so the corner values are the JAX package's.
//
// Built with --fmad=false: every product is rounded on its own, as eager
// torch rounds it, so the kernel agrees with its plain version
// (ops/assign.py windowed_best_iou_plain); IoUs that sit at a matching
// threshold would otherwise flip under fused multiply-adds.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // anchors per tile
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kWarps;  // feature rows per tile: TILE_ROWS in ops/
                               // assign.py (TILE_LANES = 32 anchors a row)
constexpr int kMaxG = 64;      // GT slots per class (a 64-bit slot mask)
constexpr int kPay = 12;       // xs[4], ys[4], cx, cy, area, radius
constexpr int kPayRows = 256;  // payload rows a block holds (sample group)
constexpr float kGateRel = 1e-4f;  // the tile gate's slack: TILE_GATE_REL
constexpr float kGateAbs = 1e-3f;  // and TILE_GATE_ABS in ops/assign.py

// the GT boxes (B, C, Gc, 7) and validity (B, C, Gc) as the caller holds
// them: any strides over (b, c, g), the 7 box values contiguous (the
// class-grouped GT are a slice of a larger buffer, and a copy would cost
// the wrapper a torch launch)
struct GtView {
  const float* gt;
  const uint8_t* gv;
  long long sb, sc, sg;  // strides of gt, in floats
  long long vb, vc, vg;  // strides of gv, in bytes
  __device__ __forceinline__ const float* box(int b, int c, int g) const {
    return gt + b * sb + c * sc + g * sg;
  }
  __device__ __forceinline__ bool valid(int b, int c, int g) const {
    return gv[b * vb + c * vc + g * vg] != 0;
  }
};

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

// a GT box (x, y, z, w, l, h, yaw) -> its payload row, as ops/assign.py
// gt_payload and ops/iou.py corners_bev compute it (each product rounded on
// its own, l / 2 and w / 2 exact)
__device__ __forceinline__ void gt_payload(const float* __restrict__ box,
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

// true when the tile circle (cx, cy, radius) proves that GT `box` passes
// the per-anchor gate with no anchor of the tile (ops/assign.py
// tile_gate_plain, in its order)
__device__ __forceinline__ bool tile_skips(const float* __restrict__ box,
                                           float4 circle) {
  const float w = box[3], l = box[4];
  const float gr = 0.5f * sqrtf(w * w + l * l);
  const float dx = box[0] - circle.x;
  const float dy = box[1] - circle.y;
  const float lim = (circle.z + gr) * (1.0f + kGateRel) + kGateAbs;
  return dx * dx + dy * dy > lim * lim;
}

// IoU of GT payload g against the anchor (ax, ay corners; centre, area,
// radius), ops/iou.py's order: GT first in the recentring sums and in the
// two half-edge integrals.
__device__ __forceinline__ bool pair_gated(const float* g, float acx,
                                           float acy, float arad) {
  const float dx = g[8] - acx;
  const float dy = g[9] - acy;
  const float rr = g[11] + arad;
  return dx * dx + dy * dy > rr * rr;  // provably disjoint: IoU 0
}

// the IoU of a pair that passed the gate
__device__ __forceinline__ float pair_clip(const float* g, const float* ax,
                                           const float* ay, float aarea) {
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

// one block per GT slot (b, c, g): its best anchor. The block lists the
// class's tiles that the GT's tile gate lets through (kThreads at a time)
// and walks their anchors, warp w on row w of each tile, through the same
// gate and IoU as the anchor side (so the values are the same bits); the
// largest key
//   (f32 bits of a positive IoU) << 32 | (0xFFFFFFFF - anchor)
// is the largest IoU at the lowest anchor. Key 0: no positive IoU.
__device__ __forceinline__ void gt_side(
    const GtView& gts, const float* __restrict__ planes,
    const float4* __restrict__ circles,
    float* __restrict__ gt_val, long long* __restrict__ gt_anchor, int slot,
    int n_cls, int gc, int hf, int lanes, int n_tiles, int tile_cols,
    int* s_tiles, int* s_n, unsigned long long* s_best) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = slot / (n_cls * gc), c = (slot / gc) % n_cls, g = slot % gc;
  if (!gts.valid(b, c, g)) {  // the same for the block
    if (threadIdx.x == 0) {
      gt_val[slot] = -1.0f;
      gt_anchor[slot] = 0;
    }
    return;
  }
  const float* box = gts.box(b, c, g);
  float p[kPay];
  gt_payload(box, p);
  const int ac = hf * lanes;
  const float* pl = planes + (size_t)c * 12 * ac;
  unsigned long long best = 0ull;
  for (int t0 = 0; t0 < n_tiles; t0 += kThreads) {
    if (threadIdx.x == 0) *s_n = 0;
    __syncthreads();
    const int t = t0 + threadIdx.x;
    const bool live =
        t < n_tiles && !tile_skips(box, circles[(size_t)c * n_tiles + t]);
    const unsigned int ballot = __ballot_sync(0xFFFFFFFFu, live);
    int base = 0;
    if (lane == 0 && ballot) base = atomicAdd(s_n, __popc(ballot));
    base = __shfl_sync(0xFFFFFFFFu, base, 0);
    if (live) s_tiles[base + __popc(ballot & ((1u << lane) - 1u))] = t;
    __syncthreads();
    const int n = *s_n;
    for (int i = 0; i < n; ++i) {
      const int tile = s_tiles[i];
      const int row = (tile / tile_cols) * kRows + warp;
      const int col = (tile % tile_cols) * 32 + lane;
      if (row >= hf || col >= lanes) continue;
      const int a = row * lanes + col;
      if (pair_gated(p, pl[(size_t)8 * ac + a], pl[(size_t)9 * ac + a],
                     pl[(size_t)11 * ac + a]))
        continue;
      float ax[4], ay[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ax[q] = pl[(size_t)q * ac + a];
        ay[q] = pl[(size_t)(4 + q) * ac + a];
      }
      const float iou = pair_clip(p, ax, ay, pl[(size_t)10 * ac + a]);
      if (iou > 0.0f) {
        const unsigned long long key =
            ((unsigned long long)__float_as_uint(iou) << 32) |
            (0xFFFFFFFFu - (unsigned int)a);
        best = key > best ? key : best;
      }
    }
    __syncthreads();  // s_tiles and s_n are reused
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xFFFFFFFFu, best, off);
    best = other > best ? other : best;
  }
  if (lane == 0) s_best[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      best = s_best[w] > best ? s_best[w] : best;
    gt_val[slot] = best ? __uint_as_float((unsigned int)(best >> 32)) : 0.0f;
    gt_anchor[slot] = best ? (long long)(0xFFFFFFFFu - (unsigned int)best)
                           : 0ll;
  }
}

// 1-D grid: the first B * C * Gc blocks take one GT slot each (gt_side),
// dispatched first so that they run beside the anchor blocks; the rest are
// (tile, class, sample group) blocks, tile fastest. An anchor block holds
// its tile's planes in registers and writes best / best_gt of its anchors
// for every sample of its group.
__global__ void __launch_bounds__(kThreads, 3)
assign_kernel(const GtView gts, const float* __restrict__ planes,
              const float4* __restrict__ circles, float* __restrict__ best_out,
              long long* __restrict__ bestg_out, float* __restrict__ gt_val,
              long long* __restrict__ gt_anchor, int batch, int n_cls, int gc,
              int hf, int lanes, int n_tiles, int tile_cols, int group,
              int gt_blocks) {
  __shared__ float s_pay[kPayRows][kPay];
  __shared__ unsigned long long s_valid[kPayRows];  // per sample of the group
  __shared__ unsigned long long s_live[kPayRows];   // valid and not skipped

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if ((int)blockIdx.x < gt_blocks) {
    gt_side(gts, planes, circles, gt_val, gt_anchor, blockIdx.x, n_cls,
            gc, hf, lanes, n_tiles, tile_cols, reinterpret_cast<int*>(s_pay),
            reinterpret_cast<int*>(s_pay) + kThreads, s_valid);
    return;
  }
  const int blk = blockIdx.x - gt_blocks;
  const int tile = blk % n_tiles;
  const int c = (blk / n_tiles) % n_cls;
  const int b0 = blk / (n_tiles * n_cls) * group;
  const int nb = min(group, batch - b0);
  const int row = (tile / tile_cols) * kRows + warp;
  const int col = (tile % tile_cols) * 32 + lane;
  const int ac = hf * lanes;
  const int a = row * lanes + col;
  const float4 circle = circles[(size_t)c * n_tiles + tile];

  // the group's payload rows, and per sample the valid and the live
  // (valid, not skipped by the tile gate) slots as 64-bit masks
  for (int i = threadIdx.x; i < nb * gc; i += kThreads) {
    const int b = b0 + i / gc, g = i % gc;
    gt_payload(gts.box(b, c, g), s_pay[i]);
  }
  for (int bl = warp; bl < nb; bl += kWarps) {
    unsigned long long vm = 0ull, lm = 0ull;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int g = lane + 32 * half;
      const bool v = g < gc && gts.valid(b0 + bl, c, g);
      const bool live = v && !tile_skips(gts.box(b0 + bl, c, g), circle);
      vm |= (unsigned long long)__ballot_sync(0xFFFFFFFFu, v) << (32 * half);
      lm |= (unsigned long long)__ballot_sync(0xFFFFFFFFu, live)
            << (32 * half);
    }
    if (lane == 0) {
      s_valid[bl] = vm;
      s_live[bl] = lm;
    }
  }

  const bool in = row < hf && col < lanes;
  float ax[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ay[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acx = 0.0f, acy = 0.0f, aarea = 0.0f, arad = 0.0f;
  if (in) {
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
  __syncthreads();
  if (!in) return;

  for (int bl = 0; bl < nb; ++bl) {
    const unsigned long long vm = s_valid[bl];
    unsigned long long lm = s_live[bl];
    float best = vm ? 0.0f : -1.0f;
    int bestg = vm ? __ffsll((long long)vm) - 1 : 0;
    while (lm) {  // the same set for the whole block
      const int g = __ffsll((long long)lm) - 1;
      lm &= lm - 1;
      const float* p = s_pay[bl * gc + g];
      if (pair_gated(p, acx, acy, arad)) continue;
      const float iou = pair_clip(p, ax, ay, aarea);
      if (iou > best) {  // strict: the first g keeps a tie
        best = iou;
        bestg = g;
      }
    }
    const size_t o = ((size_t)(b0 + bl) * n_cls + c) * ac + a;
    best_out[o] = best;
    bestg_out[o] = bestg;
  }
}

}  // namespace

// gt (B, C, Gc, 7) f32 and gv (B, C, Gc) bool with the given strides over
// (b, c, g) (gt's in floats, its last dimension contiguous; gv's in bytes),
// planes (C, 12, Ac) f32 with
// Ac = hf * lanes (lanes = Wf * Y), circles (C, n_tiles, 4) f32 (centre x,
// y, radius, 0; n_tiles = ceil(hf / 8) * ceil(lanes / 32), row-major) ->
// best (B, C, Ac) f32, best_gt (B, C, Ac) int64, gt_best_iou (B, C, Gc)
// f32, gt_best_anchor (B, C, Gc) int64. Every output element is written.
extern "C" int assign_best_iou(const float* gt, const uint8_t* gv,
                               const float* planes, const float* circles,
                               float* best, long long* best_gt, float* gt_val,
                               long long* gt_anchor, int batch, int n_cls,
                               int gc, int hf, int lanes, int n_tiles,
                               int gt_sb, int gt_sc, int gt_sg, int gv_sb,
                               int gv_sc, int gv_sg, cudaStream_t stream) {
  const int tile_cols = (lanes + 31) / 32;
  if (gc < 1 || gc > kMaxG || hf < 0 || lanes < 0 || batch < 0 ||
      n_cls < 0 || n_tiles != (hf + kRows - 1) / kRows * tile_cols)
    return (int)cudaErrorInvalidValue;
  const long long n_gt = (long long)batch * n_cls * gc;
  if (n_gt == 0) return 0;
  const int group = kPayRows / gc;
  const long long gt_blocks = n_gt;
  const long long blocks =
      gt_blocks + (long long)n_tiles * n_cls * ((batch + group - 1) / group);
  if (blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  const GtView gts{gt, gv, gt_sb, gt_sc, gt_sg, gv_sb, gv_sc, gv_sg};
  assign_kernel<<<(unsigned int)blocks, kThreads, 0, stream>>>(
      gts, planes, reinterpret_cast<const float4*>(circles), best, best_gt,
      gt_val, gt_anchor, batch, n_cls, gc, hf, lanes, n_tiles, tile_cols,
      group, (int)gt_blocks);
  return (int)cudaGetLastError();
}
