// K10 on the card: per-sample stable LSD radix sort of int32 keys, the
// order and (optionally) the payload gathered through it.
//
// Replaces tpu_pillars/ops/sort_pallas.py _bitonic_kernel (wrapper
// _sort_batched, caller sort_points_by_pillar_bitonic). The TPU kernel ran
// a bitonic network over a whole VMEM-resident sample with a lexicographic
// (key, index) comparator; a network does O(M log^2 M) work, and on this
// card, where a sample does not fit in one block's shared memory, each of
// its large strides is a pass over device memory. A stable radix sort gives
// the same result (the stable order) in a few passes. This is Onesweep
// (Adinets and Merrill, "Onesweep: A Faster Least Significant Digit Radix
// Sort for GPUs", 2022):
//   * keys are known to lie in [0, 2^key_bits); with key_bits = 32 any int32
//     is allowed and the sign bit is flipped first, which maps int32 order
//     onto uint32 order. ceil(key_bits / 9) passes of equal digits cover the
//     bits (18 bits: 2 passes of 9; 32 bits: 4 passes of 8);
//   * one upfront kernel reads the keys once and counts every pass's digits
//     per sample (peers with one digit add once to shared-memory counts,
//     then global atomics);
//   * one kernel per pass walks tiles of kTile keys. A block takes its tile
//     from an atomic counter when it starts, so every tile it waits on is
//     already running. It ranks its keys stably in shared memory (per-warp
//     digit counts in input order, peers found by one ballot per digit
//     bit), publishes its digit counts, places its keys in digit order in
//     shared memory, and finds the digits' global offsets by decoupled
//     look-back over the earlier tiles of its sample (flag and count in
//     one 32-bit status word, a window of earlier tiles read at once; tile
//     0 starts the chain from the exclusive scan of the histogram). It
//     then writes its keys and indices in digit order, so runs of one
//     digit land contiguously;
//   * the last pass writes the keys, the order and, if there is a payload,
//     the payload row of each output position (16-byte loads when F = 4);
//   * the sample is a grid dimension: no key folding and no padding.
//
// Bound on this card: bytes. The function reads the keys and payload once
// and writes the keys, order and payload once; this design reads the keys
// once more (the histogram and the first pass each read them) and moves
// each (key, index) pair through device memory once more per pass after
// the first. Counters, histograms and status words are zeroed by one
// memset on the stream per call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                  // keys per thread
constexpr int kTile = kThreads * kItems;    // keys per tile of a pass
constexpr int kMaxBits = 9;
constexpr int kMaxRadix = 1 << kMaxBits;
constexpr int kDigitsPerThread = kMaxRadix / kThreads;
constexpr int kMaxPasses = 4;
constexpr int kLookBack = 16;               // status words read at once
constexpr unsigned kFlagAggregate = 1u << 30;
constexpr unsigned kFlagPrefix = 2u << 30;
constexpr unsigned kValueMask = kFlagAggregate - 1;
constexpr int kMaxM = 1 << 30;              // counts live in 30 bits

struct Plan {
  int passes, bits, radix;
};

Plan plan_for(int key_bits) {
  Plan p;
  p.passes = (key_bits + kMaxBits - 1) / kMaxBits;
  p.bits = (key_bits + p.passes - 1) / p.passes;
  p.radix = 1 << p.bits;
  return p;
}

long long align_up(long long x) { return (x + 255) & ~255LL; }

// scratch layout: [counters | histograms | status words] (zeroed per call),
// then the key and index ping-pong buffers between passes
struct Layout {
  long long hist, status, zero_bytes, keys0, idx0, keys1, idx1, total;
};

Layout layout_for(int batch, int m, const Plan& p) {
  const long long n = (long long)batch * m;
  const long long tiles = (long long)batch * ((m + kTile - 1) / kTile);
  Layout l;
  l.hist = align_up(kMaxPasses * 4);
  l.status = l.hist + align_up((long long)batch * p.passes * p.radix * 4);
  l.zero_bytes = l.status + align_up(p.passes * tiles * p.radix * 4);
  const int buffers = p.passes == 1 ? 0 : (p.passes == 2 ? 1 : 2);
  l.keys0 = l.zero_bytes;
  l.idx0 = l.keys0 + align_up(n * 4);
  l.keys1 = l.idx0 + align_up(n * 4);
  l.idx1 = l.keys1 + align_up(n * 4);
  l.total = l.zero_bytes + buffers * 2 * align_up(n * 4);
  return l;
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// the lanes of the warp whose digit equals this lane's (bits low bits of d),
// among the lanes in `valid`: one ballot per bit, as CUB's ranking does
// (cheaper than __match_any_sync)
__device__ __forceinline__ unsigned match_digit(unsigned d, int bits,
                                                unsigned valid) {
  unsigned peers = valid;
  for (int i = 0; i < bits; ++i) {
    const unsigned set = (d >> i) & 1u;
    const unsigned vote = __ballot_sync(0xffffffffu, set);
    peers &= set ? vote : ~vote;
  }
  return peers;
}

// exclusive scan over the block of the kDigitsPerThread values each thread
// holds (thread t owns digits kDigitsPerThread * t + j)
__device__ __forceinline__ void block_exclusive_scan(
    const unsigned (&v)[kDigitsPerThread], unsigned (&e)[kDigitsPerThread],
    unsigned* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned sum = 0;
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) sum += v[j];
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  unsigned run = incl - sum;
  for (int w = 0; w < warp; ++w) run += s_warp[w];
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) {
    e[j] = run;
    run += v[j];
  }
  __syncthreads();
}

// every pass's digit counts per sample: hist[b][pass][digit]. One block per
// tile of kTile keys: every key is loaded before any is counted, so the
// loads overlap; peers with the same digit add once (runs of the sentinel
// key are common).
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const int* __restrict__ key, unsigned* __restrict__ hist,
                 int m, int passes, int bits, unsigned flip) {
  __shared__ unsigned s_hist[kMaxPasses * kMaxRadix];
  const int radix = 1 << bits;
  const unsigned mask = radix - 1;
  const int b = blockIdx.y;
  const int tile0 = blockIdx.x * kTile;
  const int n = min(kTile, m - tile0);
  for (int i = threadIdx.x; i < passes * radix; i += kThreads) s_hist[i] = 0;
  const int* key_t = key + (long long)b * m + tile0;
  unsigned u[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int pos = i * kThreads + threadIdx.x;
    u[i] = pos < n ? ((unsigned)key_t[pos] ^ flip) : 0u;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool valid = i * kThreads + (int)threadIdx.x < n;
    const unsigned in = __ballot_sync(0xffffffffu, valid);
    for (int p = 0; p < passes; ++p) {
      const unsigned d = (u[i] >> (p * bits)) & mask;
      const unsigned peers = match_digit(d, bits, in);
      if (valid && lane == __ffs(peers) - 1) {
        atomicAdd(&s_hist[p * radix + d], (unsigned)__popc(peers));
      }
    }
  }
  __syncthreads();
  unsigned* h = hist + (long long)b * passes * radix;
  for (int i = threadIdx.x; i < passes * radix; i += kThreads) {
    if (s_hist[i] != 0) atomicAdd(&h[i], s_hist[i]);
  }
}

// one digit pass over tiles of kTile keys. kFirst: keys come from the
// caller's int32 array (flipped here), indices are positions. kLast: write
// the caller's keys, order and payload rows.
template <bool kFirst, bool kLast>
__global__ void __launch_bounds__(kThreads)
pass_kernel(const int* __restrict__ key_in, const unsigned* __restrict__ k_in,
            const int* __restrict__ i_in, unsigned* __restrict__ k_out,
            int* __restrict__ i_out, int* __restrict__ key_out,
            int* __restrict__ order, const float* __restrict__ pay,
            float* __restrict__ pay_out, int f, bool vec4,
            const unsigned* __restrict__ hist, unsigned* status,
            unsigned* counter, int batch, int m, int tps, int pass,
            int passes, int bits, unsigned flip) {
  __shared__ unsigned s_key[kTile];
  __shared__ int s_idx[kTile];
  __shared__ unsigned short s_wcnt[kWarps][kMaxRadix];
  __shared__ unsigned s_local[kMaxRadix];
  __shared__ int s_global[kMaxRadix];
  __shared__ unsigned s_warp[kWarps];
  __shared__ int s_tile;

  const int radix = 1 << bits;
  const unsigned mask = radix - 1;
  const int shift = pass * bits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) s_tile = (int)atomicAdd(counter + pass, 1u);
  for (int i = threadIdx.x; i < kWarps * kMaxRadix; i += kThreads) {
    (&s_wcnt[0][0])[i] = 0;
  }
  __syncthreads();
  const int id = s_tile;
  const int b = id / tps;
  const int t = id - b * tps;
  const int tile0 = t * kTile;
  const int n = min(kTile, m - tile0);
  const long long row0 = (long long)b * m + tile0;

  // load: warp w takes the tile's keys [512 w, 512 (w + 1)), item i of lane
  // l is key 512 w + 32 i + l, so (item, lane) order is input order
  unsigned u[kItems];
  int idx[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int pos = warp * (kItems * 32) + i * 32 + lane;
    u[i] = 0;
    idx[i] = 0;
    if (pos < n) {
      if (kFirst) {
        u[i] = (unsigned)key_in[row0 + pos] ^ flip;
        idx[i] = tile0 + pos;
      } else {
        u[i] = k_in[row0 + pos];
        idx[i] = i_in[row0 + pos];
      }
    }
  }

  // stable rank within the warp: earlier items first, lower lanes first
  unsigned short rank[kItems] = {};
  const unsigned lt = lanemask_lt();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int pos = warp * (kItems * 32) + i * 32 + lane;
    const bool valid = pos < n;
    const unsigned d = (u[i] >> shift) & mask;
    const unsigned peers =
        match_digit(d, bits, __ballot_sync(0xffffffffu, valid));
    unsigned before = 0;
    if (valid) {
      before = s_wcnt[warp][d];
      rank[i] = (unsigned short)(before + __popc(peers & lt));
    }
    __syncwarp();
    if (valid && (peers & lt) == 0) {
      s_wcnt[warp][d] = (unsigned short)(before + __popc(peers));
    }
    __syncwarp();
  }
  __syncthreads();

  // per digit: the warps' exclusive offsets and the tile's count
  unsigned count[kDigitsPerThread];
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) {
    const int d = threadIdx.x * kDigitsPerThread + j;
    unsigned run = 0;
    if (d < radix) {
      for (int w = 0; w < kWarps; ++w) {
        const unsigned c = s_wcnt[w][d];
        s_wcnt[w][d] = (unsigned short)run;
        run += c;
      }
    }
    count[j] = run;
  }

  // publish the tile's counts first, so later tiles can look back past it
  unsigned* st_b = status + ((long long)pass * batch + b) * tps * radix;
  unsigned* mine = st_b + (long long)t * radix;
  if (t > 0) {
#pragma unroll
    for (int j = 0; j < kDigitsPerThread; ++j) {
      const int d = threadIdx.x * kDigitsPerThread + j;
      if (d < radix) st_relaxed(mine + d, kFlagAggregate | count[j]);
    }
  }

  // the tile's own digit starts; keys in digit order within the tile
  unsigned local[kDigitsPerThread];
  block_exclusive_scan(count, local, s_warp);
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) {
    const int d = threadIdx.x * kDigitsPerThread + j;
    if (d < radix) s_local[d] = local[j];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int pos = warp * (kItems * 32) + i * 32 + lane;
    if (pos < n) {
      const unsigned d = (u[i] >> shift) & mask;
      const int at = s_local[d] + s_wcnt[warp][d] + rank[i];
      s_key[at] = u[i];
      s_idx[at] = idx[i];
    }
  }

  // global offsets: tile 0 from the histogram, the others by decoupled
  // look-back over this sample's earlier tiles
  unsigned excl[kDigitsPerThread];
  if (t == 0) {
    unsigned h[kDigitsPerThread];
    const unsigned* hb = hist + ((long long)b * passes + pass) * radix;
#pragma unroll
    for (int j = 0; j < kDigitsPerThread; ++j) {
      const int d = threadIdx.x * kDigitsPerThread + j;
      h[j] = d < radix ? hb[d] : 0u;
    }
    block_exclusive_scan(h, excl, s_warp);
#pragma unroll
    for (int j = 0; j < kDigitsPerThread; ++j) {
      const int d = threadIdx.x * kDigitsPerThread + j;
      if (d < radix) st_relaxed(st_b + d, kFlagPrefix | (excl[j] + count[j]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kDigitsPerThread; ++j) {
      const int d = threadIdx.x * kDigitsPerThread + j;
      unsigned sum = 0;
      if (d < radix) {
        // kLookBack earlier tiles' words are read together, so a walk back
        // over aggregates costs one round trip per window, not per tile
        bool done = false;
        for (int k0 = t - 1; !done; k0 -= kLookBack) {
          unsigned v[kLookBack];
#pragma unroll
          for (int w = 0; w < kLookBack; ++w) {
            v[w] = k0 - w >= 0
                       ? ld_relaxed(st_b + (long long)(k0 - w) * radix + d)
                       : kFlagPrefix;
          }
#pragma unroll
          for (int w = 0; w < kLookBack; ++w) {
            if (done) break;
            while ((v[w] & ~kValueMask) == 0) {
              v[w] = ld_relaxed(st_b + (long long)(k0 - w) * radix + d);
            }
            sum += v[w] & kValueMask;
            done = (v[w] & kFlagPrefix) != 0;
          }
        }
        st_relaxed(mine + d, kFlagPrefix | (sum + count[j]));
      }
      excl[j] = sum;
    }
  }
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) {
    const int d = threadIdx.x * kDigitsPerThread + j;
    if (d < radix) s_global[d] = (int)excl[j] - (int)local[j];
  }
  __syncthreads();

  const long long out0 = (long long)b * m;
#pragma unroll 4
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const unsigned key = s_key[j];
    const int src = s_idx[j];
    const long long dst = out0 + s_global[(key >> shift) & mask] + j;
    if (kLast) {
      key_out[dst] = (int)(key ^ flip);
      order[dst] = src;
      if (pay != nullptr) {
        const long long s_row = (out0 + src) * f;
        if (vec4) {
          reinterpret_cast<float4*>(pay_out)[dst] =
              __ldg(reinterpret_cast<const float4*>(pay) + out0 + src);
        } else {
          for (int k = 0; k < f; ++k) pay_out[dst * f + k] = pay[s_row + k];
        }
      }
    } else {
      k_out[dst] = key;
      i_out[dst] = src;
    }
  }
}

typedef void (*PassFn)(const int*, const unsigned*, const int*, unsigned*,
                       int*, int*, int*, const float*, float*, int, bool,
                       const unsigned*, unsigned*, unsigned*, int, int, int,
                       int, int, int, unsigned);

}  // namespace

// bytes of scratch radix_sort needs for this shape
extern "C" long long radix_sort_scratch_bytes(int batch, int m,
                                              int key_bits) {
  if (key_bits < 1 || key_bits > 32 || batch < 0 || m < 0) return -1;
  return layout_for(batch, m, plan_for(key_bits)).total;
}

// key (B, M) int32, every key in [0, 2^key_bits) unless key_bits = 32;
// payload (B, M, F) f32 or null -> key_out (B, M) int32 ascending per
// sample, order (B, M) int32 (the stable permutation), pay_out (B, M, F)
// = payload rows in that order (if payload is given). scratch: at least
// radix_sort_scratch_bytes(batch, m, key_bits) bytes, 256-byte aligned.
extern "C" int radix_sort(const int* key, const float* pay, int* key_out,
                          int* order, float* pay_out, void* scratch,
                          int batch, int m, int f, int key_bits,
                          cudaStream_t stream) {
  if (key_bits < 1 || key_bits > 32 || m >= kMaxM || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || m == 0) return 0;
  const int tps = (m + kTile - 1) / kTile;
  if ((long long)batch * tps > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(key_bits);
  const Layout l = layout_for(batch, m, p);
  char* base = static_cast<char*>(scratch);
  unsigned* counter = reinterpret_cast<unsigned*>(base);
  unsigned* hist = reinterpret_cast<unsigned*>(base + l.hist);
  unsigned* status = reinterpret_cast<unsigned*>(base + l.status);
  unsigned* kb[2] = {reinterpret_cast<unsigned*>(base + l.keys0),
                     reinterpret_cast<unsigned*>(base + l.keys1)};
  int* ib[2] = {reinterpret_cast<int*>(base + l.idx0),
                reinterpret_cast<int*>(base + l.idx1)};
  const unsigned flip = key_bits == 32 ? 0x80000000u : 0u;
  const bool vec4 = f == 4 && pay != nullptr
                    && (((uintptr_t)pay | (uintptr_t)pay_out) & 15) == 0;

  cudaError_t err = cudaMemsetAsync(scratch, 0, l.zero_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  histogram_kernel<<<dim3(tps, batch), kThreads, 0, stream>>>(
      key, hist, m, p.passes, p.bits, flip);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int pass = 0; pass < p.passes; ++pass) {
    const bool first = pass == 0, last = pass == p.passes - 1;
    const PassFn fn = first ? (last ? pass_kernel<true, true>
                                    : pass_kernel<true, false>)
                            : (last ? pass_kernel<false, true>
                                    : pass_kernel<false, false>);
    const int in = (pass + 1) & 1, out = pass & 1;
    fn<<<batch * tps, kThreads, 0, stream>>>(
        key, kb[in], ib[in], kb[out], ib[out], key_out, order, pay, pay_out,
        f, vec4, hist, status, counter, batch, m, tps, pass, p.passes,
        p.bits, flip);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
