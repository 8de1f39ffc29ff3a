// K10 bitonic sort: per-sample stable sort of int32 keys, payload gathered.
//
// Replaces tpu_pillars/ops/sort_pallas.py _bitonic_kernel (wrapper
// _sort_batched, caller sort_points_by_pillar_bitonic). On the TPU a whole
// sample (key, index and payload, 3.7 MB at M = 2^17) sat in VMEM and every
// one of the log2(M) (log2(M) + 1) / 2 substages was a pair of lane or
// sublane rolls with a lexicographic (key, index) comparator. A Hopper block
// has 227 KB of shared memory, so a sample does not fit. Here:
//   * each key becomes one 64-bit composite (order-preserving key bits << 32
//     | index). Composites are unique, so any correct sort of them is
//     exactly the stable order, and the comparator is one compare;
//   * every substage whose stride is below a shared-memory tile of kTile
//     composites runs inside the tile (one block per tile, all of a size's
//     small strides in one launch); each larger stride is one pass over
//     global memory (15 passes at M = 2^17);
//   * the sorted keys, the order (the composites' low words) and the payload
//     (gathered once through the order) are written at the end. Gathering
//     gives the same rows as carrying the payload through the network.
// The sample is padded to a power of two with INT32_MAX keys, which sort
// after every real key of the same value (their indices are larger).
//
// Bound on this card: bytes. The work is one read of the keys and payload
// and one write of the keys, order and payload; the network itself moves
// each composite 2 x (15 + 6) times through global memory at M = 2^17.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kTile = 4096;  // composites per shared-memory tile (32 KB)
constexpr int kThreads = 1024;

__device__ __forceinline__ void order_pair(u64* a, u64* b, bool asc) {
  const u64 x = *a, y = *b;
  if ((x > y) == asc) {
    *a = y;
    *b = x;
  }
}

// index of the lower element of pair q at the given stride
__device__ __forceinline__ int pair_lo(int q, int stride) {
  return ((q & ~(stride - 1)) << 1) | (q & (stride - 1));
}

__global__ void compose_kernel(const int* __restrict__ key,
                               u64* __restrict__ comp, int m, int mp,
                               long long total) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long b = e / mp;
  const int i = (int)(e - b * mp);
  // flipping the sign bit maps int32 order onto uint32 order; the pad key
  // INT32_MAX maps to 0xFFFFFFFF
  const unsigned hi =
      i < m ? ((unsigned)key[b * m + i] ^ 0x80000000u) : 0xFFFFFFFFu;
  comp[e] = ((u64)hi << 32) | (unsigned)i;
}

// sizes size_first .. size_last (powers of two), each with its strides
// min(size, tile) / 2 .. 1, inside one tile of `tile` composites
__global__ void __launch_bounds__(kThreads)
tile_kernel(u64* __restrict__ comp, int mp, int tile, int size_first,
            int size_last) {
  __shared__ u64 s[kTile];
  const long long g0 = (long long)blockIdx.x * tile;
  const int base = (int)(g0 % mp);  // in-sample index of the tile's start
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s[i] = comp[g0 + i];
  __syncthreads();
  const int half = tile >> 1;
  for (int size = size_first; size <= size_last; size <<= 1) {
    for (int stride = min(size >> 1, half); stride > 0; stride >>= 1) {
      for (int q = threadIdx.x; q < half; q += blockDim.x) {
        const int lo = pair_lo(q, stride);
        order_pair(&s[lo], &s[lo + stride], ((base + lo) & size) == 0);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) comp[g0 + i] = s[i];
}

// one substage with a stride of at least a tile, over global memory
__global__ void global_kernel(u64* __restrict__ comp, int mp, int size,
                              int stride, long long pairs) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= pairs) return;
  const int hp = mp >> 1;
  const long long b = q / hp;
  const int lo = pair_lo((int)(q - b * hp), stride);
  u64* c = comp + b * mp;
  order_pair(&c[lo], &c[lo + stride], (lo & size) == 0);
}

__global__ void finish_kernel(const u64* __restrict__ comp,
                              int* __restrict__ key_out,
                              int* __restrict__ order,
                              const float* __restrict__ pay,
                              float* __restrict__ pay_out, int m, int mp,
                              int f, long long total) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long b = e / m;
  const int i = (int)(e - b * m);
  const u64 c = comp[b * mp + i];
  key_out[e] = (int)((unsigned)(c >> 32) ^ 0x80000000u);
  const int o = (int)(unsigned)(c & 0xFFFFFFFFull);
  order[e] = o;
  if (pay != nullptr) {
    const float* src = pay + (b * m + o) * f;
    for (int k = 0; k < f; ++k) pay_out[e * f + k] = src[k];
  }
}

int blocks(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

}  // namespace

// key (B, M) int32, payload (B, M, F) f32 or null -> key_out (B, M) int32
// ascending per sample, order (B, M) int32 (the stable permutation),
// pay_out (B, M, F) = payload rows in that order (if payload is given).
// scratch: B * mp 64-bit words, mp a power of two >= max(M, 2).
extern "C" int bitonic_sort(const int* key, const float* pay, int* key_out,
                            int* order, float* pay_out, void* scratch,
                            int batch, int m, int mp, int f,
                            cudaStream_t stream) {
  if (batch == 0 || m == 0) return 0;
  if (mp < 2 || (mp & (mp - 1)) != 0 || mp < m) {
    return (int)cudaErrorInvalidValue;
  }
  u64* comp = static_cast<u64*>(scratch);
  const long long total = (long long)batch * mp;
  const int t = 256;
  compose_kernel<<<blocks(total, t), t, 0, stream>>>(key, comp, m, mp, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int tile = mp < kTile ? mp : kTile;
  const int tiles = (int)(total / tile);
  tile_kernel<<<tiles, kThreads, 0, stream>>>(comp, mp, tile, 2, tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long pairs = total / 2;
  for (int size = 2 * tile; size <= mp; size <<= 1) {
    for (int stride = size >> 1; stride >= tile; stride >>= 1) {
      global_kernel<<<blocks(pairs, t), t, 0, stream>>>(comp, mp, size,
                                                         stride, pairs);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    tile_kernel<<<tiles, kThreads, 0, stream>>>(comp, mp, tile, size, size);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  const long long n_out = (long long)batch * m;
  finish_kernel<<<blocks(n_out, t), t, 0, stream>>>(comp, key_out, order, pay,
                                                    pay_out, m, mp, f, n_out);
  return (int)cudaGetLastError();
}
