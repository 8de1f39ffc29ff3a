// K6 PFN: linear (BatchNorm folded) + bias + ReLU + masked max over points.
//
// Replaces tpu_pillars/ops/pfn_pallas.py _pfn_kernel (wrapper pfn_fused).
// For every pillar p and channel ch:
//     out[p, ch] = max_{j : mask[p, j]} relu(sum_f x[p, j, f] * w[f, ch] + b[ch])
// and 0 for a pillar with no valid point. On the TPU one (BLOCK*N, D) x
// (D, C) MXU product per grid step fed a VMEM max; the (P, N, C)
// activation never exists here either.
//
// Bound on this card: bytes. The function must read the (P, N) mask, the
// valid slots' rows (36 B each at D = 9) and write (P, C); each valid slot
// costs 2 * D * C flops (1,152 at C = 64), and with few valid slots (about
// 8% on lidar-like sweeps at the full config) that stays under the f32
// ridge. The first port staged every slot's row in shared memory, masked
// or not, so it read the whole (P, N, D) input (110.6 MB at the serving
// batch, ten times what the function needs), with a scalar loop, and then
// waited at a block barrier for its 8 pillars before any arithmetic: 15x
// its bound. (Its note that staging only the valid rows measured slower
// held for that block-barrier design; the design below reads only them.)
//
// Here the mask comes first and no warp waits on its block:
//   * the warps of one resident wave of blocks stride over the pillars,
//     kGroup (8) pillars a step, W pillars apart (W warps in the grid), so
//     that the dense pillars near the sensor, which sit together, spread
//     over the warps;
//   * lane j reads mask byte j of each of the step's pillars, and
//     __ballot_sync gives their valid slots; the next step's mask bytes go
//     out before this step's arithmetic and are first read at its ballots;
//   * the step's valid rows are numbered in (pillar, slot) order and lane t
//     loads row t (up to 32 a round), so every load of the round is in
//     flight at once and a masked row is never read (NaN there is
//     harmless); the lane stages its row in the warp's shared memory,
//     padded to float4s with its pillar in the padding, and every lane
//     reads each row back as broadcast float4s (three loads for D = 9, where
//     nine __shfl_sync per row measured slower);
//   * W and b sit in registers, loaded once per warp: lane l owns channels
//     l, l + 32, ... (kV of them); kRowsAtOnce rows are summed side by side,
//     and lanes store neighbouring channels (coalesced).
// The arithmetic is the plain version's: the D products summed f = 0, 1,
// ..., in f32 without fused multiply-adds (--fmad=false). The running max
// is taken over those sums, and the bias and ReLU come after it:
// relu(fl(u + b)) is monotone in u, so relu(fl(max u + b)) equals the
// plain version's max over relu(fl(u + b)) exactly (K11 does the same),
// and a row costs no bias add or ReLU.
//
// Instances: pfn_reg_kernel<kV, kD> for N <= 32, D in 8..13 (the configs'
// decorated widths: 3-8 point features + 5) and C <= 128, kV = C / 32
// rounded up to 1, 2 or 4 (W's kD * kV values stay in registers). Any other
// shape (D outside 8..13, C up to 256 in blocks of 128 channels, N > 32)
// runs pfn_any_kernel<kV>, one pillar per warp at a time, which reads each
// valid slot's row and W through the L1 cache. Lanes whose channel is >= C
// compute nothing that is stored.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxC = 256;
constexpr int kGroup = 8;  // pillars a warp of pfn_reg_kernel takes per step
constexpr int kRowsAtOnce = 4;  // valid rows it computes side by side
constexpr unsigned kFull = 0xFFFFFFFFu;

// pillar q's channels lane, lane + 32, ...: relu(umax + b), 0 for a pillar
// with no valid slot (umax -inf); lanes store neighbouring channels
template <int kV>
__device__ __forceinline__ void store(float* __restrict__ out, long long q,
                                      long long p, int c, int lane,
                                      const float (&umax)[kV],
                                      const float (&br)[kV]) {
  if (q >= p) return;
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const int ch = lane + 32 * k;
    if (ch < c) out[q * c + ch] = fmaxf(umax[k] + br[k], 0.0f);
  }
}

// position of the (k + 1)-th set bit of x (k < popc(x))
__device__ __forceinline__ int nth_set_bit(unsigned x, int k) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const unsigned lo = x & ((1u << half) - 1u);
    const int cnt = __popc(lo);
    if (k >= cnt) {
      k -= cnt;
      x >>= half;
      pos += half;
    } else {
      x = lo;
    }
  }
  return pos;
}

// n <= 32; kD == D; kV * 32 >= C. Warp w of the W in the grid takes
// pillars w, w + W, w + 2W, ... (dense pillars sit together, so neighbours
// go to different warps), kGroup of them per step. A step's valid rows are
// loaded one per lane, staged in the warp's shared memory (a row padded to
// kQ float4s, its pillar in slot kD) and read back as broadcasts.
template <int kV, int kD>
__global__ void __launch_bounds__(kThreads)
pfn_reg_kernel(const float* __restrict__ feats,
               const uint8_t* __restrict__ mask, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out,
               long long p, int n, int c) {
  constexpr int kQ = (kD + 1 + 3) / 4;  // float4s per staged row
  __shared__ float4 s_rows[kWarps][32][kQ];
  __shared__ unsigned s_bits[kWarps][kGroup];  // the step's valid slots
  const int lane = threadIdx.x & 31;
  float4(*rows)[kQ] = s_rows[threadIdx.x >> 5];
  unsigned* bits = s_bits[threadIdx.x >> 5];
  const long long n_warp = (long long)gridDim.x * kWarps;
  const long long w0 = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w0 >= p) return;

  float wr[kD][kV], br[kV];
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const int ch = lane + 32 * k;
    br[k] = ch < c ? __ldg(bias + ch) : 0.0f;
#pragma unroll
    for (int f = 0; f < kD; ++f)
      wr[f][k] = ch < c ? __ldg(w + f * c + ch) : 0.0f;
  }

  // mask byte `lane` of each pillar of the step (0 past the last pillar)
  unsigned mb[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    mb[i] = 0;
    const long long q = w0 + i * n_warp;
    if (q < p && lane < n) mb[i] = __ldg(mask + q * n + lane);
  }
  for (long long q0 = w0; q0 < p; q0 += kGroup * n_warp) {
    // pillar i of the step: q0 + i * n_warp
    int total = 0;
    __syncwarp();  // the previous step's bits are read
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const unsigned bi = __ballot_sync(kFull, mb[i] != 0);
      if (lane == 0) bits[i] = bi;
      total += __popc(bi);
    }
    __syncwarp();
    // the next step's masks go out now, read only at its ballots
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      mb[i] = 0;
      const long long q = q0 + (kGroup + i) * n_warp;
      if (q < p && lane < n) mb[i] = __ldg(mask + q * n + lane);
    }

    int i_cur = 0;  // the pillar whose max is open
    float umax[kV];
#pragma unroll
    for (int k = 0; k < kV; ++k) umax[k] = -INFINITY;
    for (int r0 = 0; r0 < total; r0 += 32) {
      // lane t stages the step's valid row r0 + t, in (pillar, slot) order
      int k = r0 + lane, pi = kGroup;
      unsigned pb = 0;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int ci = __popc(bits[i]);
        if (pi == kGroup) {
          if (k < ci) {
            pi = i;
            pb = bits[i];
          } else {
            k -= ci;
          }
        }
      }
      float x[kQ * 4];
#pragma unroll
      for (int f = 0; f < kQ * 4; ++f) x[f] = 0.0f;
      if (pi < kGroup) {
        const float* row =
            feats + ((q0 + pi * n_warp) * n + nth_set_bit(pb, k)) * kD;
#pragma unroll
        for (int f = 0; f < kD; ++f) x[f] = __ldg(row + f);
      }
      x[kD] = __int_as_float(pi);
      __syncwarp();  // the previous round's rows are read
#pragma unroll
      for (int h = 0; h < kQ; ++h)
        rows[lane][h] = make_float4(x[4 * h], x[4 * h + 1], x[4 * h + 2],
                                    x[4 * h + 3]);
      __syncwarp();
      // kRowsAtOnce rows side by side, independent chains; the max over a
      // pillar's rows is exact in any order
      const int nt = min(32, total - r0);
      for (int t = 0; t < nt; t += kRowsAtOnce) {
        float u[kRowsAtOnce][kV];
        int it[kRowsAtOnce];
#pragma unroll
        for (int h = 0; h < kQ; ++h) {
#pragma unroll
          for (int r = 0; r < kRowsAtOnce; ++r) {
            // (a row past nt gives values that are never used)
            const float4 v4 = rows[(t + r) & 31][h];
            const float xv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int f = 4 * h + e;
              if (f < kD) {
#pragma unroll
                for (int kk = 0; kk < kV; ++kk)
                  u[r][kk] = f == 0 ? xv[e] * wr[0][kk]
                                    : u[r][kk] + xv[e] * wr[f][kk];
              } else if (f == kD) {
                it[r] = __float_as_int(xv[e]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsAtOnce; ++r) {
          if (t + r >= nt) break;
          for (; i_cur < it[r]; ++i_cur) {  // pillars done (or with no row)
            store(out, q0 + i_cur * n_warp, p, c, lane, umax, br);
#pragma unroll
            for (int kk = 0; kk < kV; ++kk) umax[kk] = -INFINITY;
          }
#pragma unroll
          for (int kk = 0; kk < kV; ++kk) umax[kk] = fmaxf(umax[kk], u[r][kk]);
        }
      }
    }
    for (; i_cur < kGroup; ++i_cur) {
      store(out, q0 + i_cur * n_warp, p, c, lane, umax, br);
#pragma unroll
      for (int kk = 0; kk < kV; ++kk) umax[kk] = -INFINITY;
    }
  }
}

// any n and d; channels in blocks of 32 * kV (kV * 32 >= C, or C > 128 in
// blocks of 128)
template <int kV>
__global__ void __launch_bounds__(kThreads)
pfn_any_kernel(const float* __restrict__ feats,
               const uint8_t* __restrict__ mask, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out,
               long long p, int n, int d, int c) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long q = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       q < p; q += stride) {
    for (int c0 = 0; c0 < c; c0 += 32 * kV) {
      float acc[kV];
#pragma unroll
      for (int k = 0; k < kV; ++k) acc[k] = 0.0f;
      for (int g0 = 0; g0 < n; g0 += 32) {
        const int j = g0 + lane;
        const unsigned bits =
            __ballot_sync(kFull, j < n && __ldg(mask + q * n + j) != 0);
        for (unsigned left = bits; left; left &= left - 1) {
          const float* row = feats + (q * n + g0 + __ffs(left) - 1) * d;
          float u[kV];
          const float x0 = __ldg(row);
#pragma unroll
          for (int k = 0; k < kV; ++k) {
            const int ch = c0 + lane + 32 * k;
            u[k] = x0 * (ch < c ? __ldg(w + ch) : 0.0f);
          }
          for (int f = 1; f < d; ++f) {
            const float xf = __ldg(row + f);
#pragma unroll
            for (int k = 0; k < kV; ++k) {
              const int ch = c0 + lane + 32 * k;
              u[k] = u[k] + xf * (ch < c ? __ldg(w + f * c + ch) : 0.0f);
            }
          }
#pragma unroll
          for (int k = 0; k < kV; ++k) {
            const int ch = c0 + lane + 32 * k;
            const float b = ch < c ? __ldg(bias + ch) : 0.0f;
            acc[k] = fmaxf(acc[k], fmaxf(u[k] + b, 0.0f));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        const int ch = c0 + lane + 32 * k;
        if (ch < c) out[q * c + ch] = acc[k];
      }
    }
  }
}

// the blocks of one resident wave, or fewer when `tasks` (pillars, one
// per warp at most) need fewer; the occupancy is asked once per instance
template <typename Kernel>
int wave(Kernel kernel, int* per_sm, long long tasks) {
  if (*per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel, kThreads, 0);
    if (e != cudaSuccess) return -(int)e;
    if (*per_sm < 1) *per_sm = 1;
  }
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  const long long need = (tasks + kWarps - 1) / kWarps;
  const long long full = (long long)n_sm * *per_sm;
  return (int)(need < full ? need : full);
}

template <int kV, int kD>
int launch_reg(const float* feats, const uint8_t* mask, const float* w,
               const float* bias, float* out, long long p, int n, int c,
               cudaStream_t stream) {
  static int per_sm = 0;
  const int grid = wave(pfn_reg_kernel<kV, kD>, &per_sm, p);
  if (grid < 0) return -grid;
  pfn_reg_kernel<kV, kD><<<grid, kThreads, 0, stream>>>(feats, mask, w, bias,
                                                       out, p, n, c);
  return (int)cudaGetLastError();
}

template <int kV>
int launch_any(const float* feats, const uint8_t* mask, const float* w,
               const float* bias, float* out, long long p, int n, int d,
               int c, cudaStream_t stream) {
  static int per_sm = 0;
  const int grid = wave(pfn_any_kernel<kV>, &per_sm, p);
  if (grid < 0) return -grid;
  pfn_any_kernel<kV><<<grid, kThreads, 0, stream>>>(feats, mask, w, bias,
                                                    out, p, n, d, c);
  return (int)cudaGetLastError();
}

template <int kV>
int launch_d(const float* feats, const uint8_t* mask, const float* w,
             const float* bias, float* out, long long p, int n, int d, int c,
             cudaStream_t stream) {
  using Launch = decltype(&launch_reg<kV, 8>);
  constexpr Launch kReg[] = {launch_reg<kV, 8>,  launch_reg<kV, 9>,
                             launch_reg<kV, 10>, launch_reg<kV, 11>,
                             launch_reg<kV, 12>, launch_reg<kV, 13>};
  if (n <= 32 && d >= 8 && d <= 13)
    return kReg[d - 8](feats, mask, w, bias, out, p, n, c, stream);
  return launch_any<kV>(feats, mask, w, bias, out, p, n, d, c, stream);
}

}  // namespace

// features (P, N, D) f32, mask (P, N) bool, w (D, C), b (C,) -> out (P, C),
// every element written. C <= 256.
extern "C" int pfn_fused(const float* feats, const uint8_t* mask,
                         const float* w, const float* bias, float* out, int p,
                         int n, int d, int c, cudaStream_t stream) {
  if (c <= 0 || c > kMaxC || d <= 0 || n < 0 || p < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (p == 0) return 0;
  const int kv = (c + 31) / 32;
  if (kv <= 1) return launch_d<1>(feats, mask, w, bias, out, p, n, d, c,
                                  stream);
  if (kv <= 2) return launch_d<2>(feats, mask, w, bias, out, p, n, d, c,
                                  stream);
  if (kv <= 4) return launch_d<4>(feats, mask, w, bias, out, p, n, d, c,
                                  stream);
  return launch_any<4>(feats, mask, w, bias, out, p, n, d, c, stream);
}
