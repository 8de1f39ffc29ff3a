// Greedy NMS keep masks from the K4 overlap matrix, for every row of a batch
// in one launch: keep_i = valid_i and no kept j < i with over[j, i].
//
// Replaces no Pallas kernel: the JAX package leaves the NMS fixpoint
// (tpu_pillars/ops/nms.py nms_fixpoint, a lax.while_loop of masked
// any-reductions over the (K, K) matrix) to XLA, on the device. Ported as
// that loop driven from the host, it tested convergence with a read of the
// keep mask after every pass, so the launch of a batch returned only when
// the batch was done. The sequential greedy result computed here is the
// unique solution that fixpoint iterates to, so the masks are bit-equal,
// and nothing is read back.
//
// Bound on this card: bytes, the strict upper triangle of over read once,
// B * K * (K - 1) / 2 bytes (4.2 MB at the serving batch of 8 x 1,024, 1.3 us
// at 3.35 TB/s). Above it sits the scan's floor: K dependent steps a row,
// which no number of threads shortens.
// What the design does about it:
//   * one block per row; its 1,024 threads pack the row's strict upper
//     triangle into 32-bit words (bit t of word w of row j: over[j, 32 w +
//     t]) with 16-, 8-, 4- or 1-byte loads as K allows, four bools to four
//     bits with one SIMD compare and one multiply, into shared memory
//     (K * ceil(K / 32) * 4 bytes: 128 KB at K = 1,024, 125 KB at K =
//     1,000). Where that does
//     not fit, into a global scratch of the same layout that the wrapper
//     allocates, and the scan reads it from L2: one algorithm for any K;
//   * one warp then scans 32 candidates at a time. Lane w % 32 owns word w
//     of the "suppressed" set (initially the invalid candidates and the
//     bits past K), so no lane reads another's words and the scan needs no
//     barrier. For the block of candidates 32 c .. 32 c + 31 the owner lane
//     of word c decides them in order in registers (a kept candidate ORs
//     its row's word c in), one __shfl_sync broadcasts the 32 decisions,
//     and every lane ORs the kept rows' words w > c into its own words;
//   * the keep mask leaves as one coalesced 32-byte store a block of 32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

// four bool bytes -> four bits, byte q to bit q: the bytes that are not 0
// become 1, and one multiply gathers them into the top byte
__device__ __forceinline__ uint32_t bits4(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// V bool bytes at p (V-byte aligned) -> V bits
template <int V>
__device__ __forceinline__ uint32_t load_bits(const uint8_t* p);

template <>
__device__ __forceinline__ uint32_t load_bits<16>(const uint8_t* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  return bits4(v.x) | bits4(v.y) << 4 | bits4(v.z) << 8 | bits4(v.w) << 12;
}

template <>
__device__ __forceinline__ uint32_t load_bits<8>(const uint8_t* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return bits4(v.x) | bits4(v.y) << 4;
}

template <>
__device__ __forceinline__ uint32_t load_bits<4>(const uint8_t* p) {
  return bits4(*reinterpret_cast<const uint32_t*>(p));
}

template <>
__device__ __forceinline__ uint32_t load_bits<1>(const uint8_t* p) {
  return *p != 0;
}

// word w of a row of k bools: its columns 32 w .. 32 w + 31 below k
// (k % V == 0, so every V-byte chunk lies wholly inside or past the row)
template <int V>
__device__ __forceinline__ uint32_t row_word(const uint8_t* row, int w,
                                             int k) {
  const int c0 = w * 32;
  const int n = min(32, k - c0);
  uint32_t word = 0;
#pragma unroll
  for (int q = 0; q < 32 / V; ++q)
    if (q * V < n) word |= load_bits<V>(row + c0 + q * V) << (q * V);
  return word;
}

template <int V>
__global__ void __launch_bounds__(kThreads, 1)
nms_scan_kernel(const uint8_t* __restrict__ over,
                const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep, uint32_t* scratch, int k,
                int words) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  uint32_t* remv = smem;                                   // (words,)
  uint32_t* rows = scratch ? scratch + (size_t)b * k * words
                           : smem + words;                 // (k, words)
  over += (size_t)b * k * k;
  valid += (size_t)b * k;
  keep += (size_t)b * k;

  // pack: row j's words from the one holding column j (the lower triangle
  // is never read); thread t takes words t, t + kThreads, ... of the
  // row-major (k, words) layout, stepping (j, w) without a division
  const int dj = kThreads / words, dw = kThreads % words;
  int pj = threadIdx.x / words, pw = threadIdx.x % words;
  for (int t = threadIdx.x; t < k * words; t += kThreads) {
    if (pw >= pj / 32) rows[t] = row_word<V>(over + (size_t)pj * k, pw, k);
    pj += dj;
    pw += dw;
    if (pw >= words) {
      pw -= words;
      ++pj;
    }
  }
  for (int w = threadIdx.x; w < words; w += kThreads) {
    const int c0 = w * 32, m = min(32, k - c0);
    uint32_t v = 0;
    for (int q = 0; q < m; ++q) v |= (uint32_t)(valid[c0 + q] != 0) << q;
    remv[w] = ~v;          // invalid candidates and bits past k: suppressed
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;

  // scan: one warp, 32 candidates at a time
  const int lane = threadIdx.x;
  for (int c = 0; c < words; ++c) {
    uint32_t kept = 0;
    if (lane == (c & 31)) {
      uint32_t s = remv[c];
      const uint32_t* col = rows + (size_t)c * 32 * words + c;
      const int m = min(32, k - c * 32);
#pragma unroll
      for (int t0 = 0; t0 < 32; t0 += 8) {
        uint32_t r[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          r[u] = t0 + u < m ? col[(size_t)(t0 + u) * words] : 0u;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const uint32_t bit = 1u << (t0 + u);
          if (!(s & bit)) {
            kept |= bit;
            s |= r[u];
          }
        }
      }
    }
    kept = __shfl_sync(0xffffffffu, kept, c & 31);
    if (c * 32 + lane < k) keep[c * 32 + lane] = (kept >> lane) & 1u;
    if (!kept) continue;
    for (int w = lane; w < words; w += 32) {
      if (w <= c) continue;
      const uint32_t* src = rows + (size_t)c * 32 * words + w;
      uint32_t s = remv[w];
#pragma unroll 8
      for (int t = 0; t < 32; ++t)
        if ((kept >> t) & 1u) s |= src[(size_t)t * words];
      remv[w] = s;
    }
  }
}

template <int V>
int launch(const uint8_t* over, const uint8_t* valid, uint8_t* keep,
           uint32_t* scratch, int batch, int k, cudaStream_t stream) {
  const int words = (k + 31) / 32;
  size_t smem = (size_t)words * 4;
  if (!scratch) smem += (size_t)k * words * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_scan_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_scan_kernel<V><<<batch, kThreads, smem, stream>>>(over, valid, keep,
                                                        scratch, k, words);
  return (int)cudaGetLastError();
}

}  // namespace

// over (batch, k, k) bool, valid (batch, k) bool -> keep (batch, k) bool.
// scratch: null to pack in shared memory, else (batch, k, ceil(k / 32))
// 32-bit words of global memory.
extern "C" int nms_scan(const uint8_t* over, const uint8_t* valid,
                        uint8_t* keep, uint32_t* scratch, int batch, int k,
                        cudaStream_t stream) {
  if (batch == 0 || k == 0) return 0;
  // the packed words of a row are indexed with 32-bit ints
  if ((int64_t)k * ((k + 31) / 32) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const uintptr_t a = (uintptr_t)over;
  if (k % 16 == 0 && a % 16 == 0)
    return launch<16>(over, valid, keep, scratch, batch, k, stream);
  if (k % 8 == 0 && a % 8 == 0)
    return launch<8>(over, valid, keep, scratch, batch, k, stream);
  if (k % 4 == 0 && a % 4 == 0)
    return launch<4>(over, valid, keep, scratch, batch, k, stream);
  return launch<1>(over, valid, keep, scratch, batch, k, stream);
}
