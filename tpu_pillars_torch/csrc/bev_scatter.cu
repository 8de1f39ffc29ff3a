// K3 BEV scatter: pillar features -> dense (B, H*W, C) canvas, in one pass
// over the canvas.
//
// Replaces tpu_pillars/ops/bev_pallas.py _bev_ring_kernel (wrapper
// scatter_to_bev_ring). The TPU kernel streamed pillars through a VMEM ring
// of canvas rows, placed them with one-hot matmuls and flushed closed
// halves to HBM; its contract is scatter_to_bev_emit's: the effective ids
// where(mask, pid, hw) ascend along P in every sample, and valid ids are
// unique and lie in [0, hw). Every caller of the port meets it (the emit
// table, the classic pillarizer's canonical order).
//
// Bound on this card: bytes. The canvas write (B * H * W * C * 4 bytes,
// 328 MB at the full config and batch 8) is ~93% of what must move; the
// pillar rows, ids and mask are read once. A zeroed canvas and a scatter of
// the rows would pass over the canvas twice (the fill, then the rows amid
// it). Here one launch writes every element once into uninitialised memory:
//   * one block per (tile of kTileCells = 64 cells, sample), dispatched in
//     canvas order, so the canvas is written front to back as a fill is;
//   * the block finds its own rows, with no sidecar: its 256 threads probe
//     the sample's effective ids at a stride of ceil(P / 256), and one
//     barrier counts the probes below the tile's first cell (a 256-ary
//     search: one dependent load). The first row at or past the tile then
//     lies in the probe's segment, and, ids being unique, the tile holds at
//     most kTileCells pillars: one coalesced load of the rows from that
//     segment on (stride - 1 + kTileCells at most) finds them all, and each
//     marks its cell in a shared-memory map;
//   * the block writes every element of the tile once, the pillar's
//     feature or zero, with 16-byte streaming stores (__stcs) when the row
//     fills whole 16-byte packs and a scalar path otherwise. A tile that
//     holds no pillar reads no row. No atomics: the result is bit-exact.
// A caller that breaks the precondition gets a wrong canvas, but every
// read stays inside the sample's rows and every write inside its tile.
//
// Three instances of the one kernel, each its own C entry, with the row
// and canvas element types apart:
//   * f32 rows -> f32 canvas (bev_scatter): a 16-byte pack is 4 floats
//     (C % 4 == 0);
//   * f32 rows -> bf16 canvas (bev_scatter_f32_bf16), bf16 serving: each
//     element is rounded once at the store (__float2bfloat16_rn, round to
//     nearest even), so the canvas equals the f32 one cast to bf16 bit for
//     bit, the cast that flax's first bf16 conv applies to the f32 canvas.
//     It halves the canvas write (164 MB instead of 328 MB at the full
//     config and batch 8) and saves a separate cast pass. A pack is 8
//     floats read as two 16-byte loads and stored as 8 bf16 (C % 8 == 0);
//   * bf16 rows -> bf16 canvas (bev_scatter_bf16), bf16 training and the
//     plain PillarFeatureNet: a plain copy, 8 bf16 a pack (C % 8 == 0).
// Other widths or misaligned pointers take the scalar path of the same
// instance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cells per block: 32 ties 64, 128 and 256 are slower (PERF.md §6)
constexpr int kTileCells = 64;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // stores in flight per thread per round

// where(mask, pid, hw) of row k; both loads go out before the select
__device__ __forceinline__ int eff_id(const int* __restrict__ pid,
                                      const uint8_t* __restrict__ mask,
                                      int k, int hw) {
  const int id = __ldg(pid + k);
  const uint8_t m = __ldg(mask + k);
  return m ? id : hw;
}

// 8 floats: the row pack of the f32 -> bf16 vector instance
struct __align__(16) F32x8 {
  float4 lo, hi;
};

// a row pack read once, through the read-only path
template <typename T>
__device__ __forceinline__ T load(const T* p) { return __ldg(p); }
template <>
__device__ __forceinline__ F32x8 load<F32x8>(const F32x8* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  F32x8 v;
  v.lo = __ldg(q);
  v.hi = __ldg(q + 1);
  return v;
}

// a row pack -> a canvas pack; zero() is the canvas pack of an empty cell
template <typename TIn, typename TOut>
struct Convert;
template <typename T>
struct Convert<T, T> {
  __device__ __forceinline__ static T apply(T v) { return v; }
};
template <>
struct Convert<float, __nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 apply(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <>
struct Convert<F32x8, uint4> {
  // __floats2bfloat162_rn(a, b) puts a in the low half, as in memory order
  __device__ __forceinline__ static uint4 apply(F32x8 v) {
    const __nv_bfloat162 p0 = __floats2bfloat162_rn(v.lo.x, v.lo.y);
    const __nv_bfloat162 p1 = __floats2bfloat162_rn(v.lo.z, v.lo.w);
    const __nv_bfloat162 p2 = __floats2bfloat162_rn(v.hi.x, v.hi.y);
    const __nv_bfloat162 p3 = __floats2bfloat162_rn(v.hi.z, v.hi.w);
    uint4 out;
    out.x = *reinterpret_cast<const unsigned int*>(&p0);
    out.y = *reinterpret_cast<const unsigned int*>(&p1);
    out.z = *reinterpret_cast<const unsigned int*>(&p2);
    out.w = *reinterpret_cast<const unsigned int*>(&p3);
    return out;
  }
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0);  // +0.0
}
template <>
__device__ __forceinline__ uint4 zero<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);  // eight bf16 +0.0
}

// grid (tiles, B): block (t, b) writes tile t of sample b. c_t counts packs
// per row (a TIn pack and a TOut pack hold the same elements)
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
bev_scatter_kernel(const TIn* __restrict__ feats, const int* __restrict__ pid,
                   const uint8_t* __restrict__ mask,
                   TOut* __restrict__ canvas, int p, int c_t, int hw) {
  __shared__ int s_map[kTileCells];  // the row of each cell's pillar, or -1
  const int t = blockIdx.x, b = blockIdx.y;
  const int cell0 = t * kTileCells;
  const int ncell = min(kTileCells, hw - cell0);
  const long long r0 = (long long)b * p;
  const int* pid_b = pid + r0;
  const uint8_t* mask_b = mask + r0;

  for (int i = threadIdx.x; i < ncell; i += kThreads) s_map[i] = -1;
  // the search: probe i reads row i * stride; the probes below cell0 are a
  // prefix, so the first row at or past cell0 lies in
  // ((n_below - 1) * stride, n_below * stride]
  const int stride = (p + kThreads - 1) / kThreads;
  const int probe = threadIdx.x * stride;
  const bool below = probe < p && eff_id(pid_b, mask_b, probe, hw) < cell0;
  const int n_below = __syncthreads_count(below);  // also orders the map init
  const int k_lo = n_below == 0 ? 0 : (n_below - 1) * stride + 1;
  const int k_hi = min(p, n_below * stride + ncell);
  bool any = false;
  for (int k = k_lo + threadIdx.x; k < k_hi; k += kThreads) {
    const int off = eff_id(pid_b, mask_b, k, hw) - cell0;
    if (off >= 0 && off < ncell) {
      s_map[off] = k;
      any = true;
    }
  }
  const bool empty = !__syncthreads_or(any);

  const TIn* rows = feats + r0 * c_t;
  TOut* out = canvas + ((long long)b * hw + cell0) * c_t;
  const int n = ncell * c_t;
  for (int e0 = 0; e0 < n; e0 += kThreads * kUnroll) {
    TOut v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      v[u] = zero<TOut>();
      if (!empty && e < n) {
        const int cell = e / c_t;
        const int row = s_map[cell];
        if (row >= 0) {
          v[u] = Convert<TIn, TOut>::apply(
              load(rows + (long long)row * c_t + (e - cell * c_t)));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      if (e < n) __stcs(out + e, v[u]);
    }
  }
}

// one instance: the vector path (pack types TInV / TOutV of `pack`
// elements) when C is a whole number of packs and both pointers are 16-byte
// aligned, the scalar path (TIn / TOut) otherwise
template <typename TIn, typename TOut, typename TInV, typename TOutV,
          int pack>
int launch(const void* feats, const int* pid, const uint8_t* mask,
           void* canvas, int batch, int p, int c, int hw,
           cudaStream_t stream) {
  if (batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || hw == 0 || c == 0) return 0;
  const dim3 grid((hw + kTileCells - 1) / kTileCells, batch);
  if (c % pack == 0 && (((uintptr_t)feats | (uintptr_t)canvas) & 15) == 0) {
    bev_scatter_kernel<TInV, TOutV><<<grid, kThreads, 0, stream>>>(
        static_cast<const TInV*>(feats), pid, mask,
        static_cast<TOutV*>(canvas), p, c / pack, hw);
  } else {
    bev_scatter_kernel<TIn, TOut><<<grid, kThreads, 0, stream>>>(
        static_cast<const TIn*>(feats), pid, mask, static_cast<TOut*>(canvas),
        p, c, hw);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// feats (B, P, C), pid (B, P) int32, mask (B, P) bool, with
// where(mask, pid, hw) ascending per sample and valid ids unique ->
// canvas (B, hw, C), every element written (the caller may pass
// uninitialised memory). bev_scatter: f32 rows, f32 canvas.
extern "C" int bev_scatter(const float* feats, const int* pid,
                           const uint8_t* mask, float* canvas, int batch,
                           int p, int c, int hw, cudaStream_t stream) {
  return launch<float, float, float4, float4, 4>(feats, pid, mask, canvas,
                                                 batch, p, c, hw, stream);
}

// the same with f32 rows and a bf16 canvas, each element rounded to
// nearest even once
extern "C" int bev_scatter_f32_bf16(const float* feats, const int* pid,
                                    const uint8_t* mask,
                                    __nv_bfloat16* canvas, int batch, int p,
                                    int c, int hw, cudaStream_t stream) {
  return launch<float, __nv_bfloat16, F32x8, uint4, 8>(
      feats, pid, mask, canvas, batch, p, c, hw, stream);
}

// the same with bf16 rows and a bf16 canvas (a copy)
extern "C" int bev_scatter_bf16(const __nv_bfloat16* feats, const int* pid,
                                const uint8_t* mask, __nv_bfloat16* canvas,
                                int batch, int p, int c, int hw,
                                cudaStream_t stream) {
  return launch<__nv_bfloat16, __nv_bfloat16, uint4, uint4, 8>(
      feats, pid, mask, canvas, batch, p, c, hw, stream);
}
