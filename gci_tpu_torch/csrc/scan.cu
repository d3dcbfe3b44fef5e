// Hopper (sm_90a) kernels of the single-GPU depth path.
//
// Every kernel here but the stream compaction (at the end of the kernels)
// is an inclusive int32 prefix sum over the concatenated genome axis,
// wrapping mod 2^32, plus an epilogue.  Two skeletons carry them.
//
// depth_scan (the plain prefix sum) is a single-pass scan with decoupled
// look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", NVIDIA 2016), one launch per call:
//
//   * each block takes the next tile of kScanTile slots from an atomic
//     counter, so it only ever waits on tiles whose blocks are already
//     running (handing tiles out by blockIdx.x could make a resident block
//     spin on a tile that was never scheduled);
//   * it loads its tile once into registers, scans it with warp shuffles,
//     and publishes the tile's aggregate in the tile's status word;
//   * one warp walks back over the predecessors' status words 32 at a time,
//     summing aggregates until it meets an inclusive prefix, then publishes
//     the tile's own inclusive prefix;
//   * every thread adds the tile's exclusive prefix and writes its slots once.
//
// A status word is one 64-bit word, state in the high half (invalid 0,
// aggregate 1, inclusive prefix 2) and the uint32 value in the low half,
// written by one st.release.gpu and read by ld.acquire.gpu, so a reader never
// sees a state without its value and L1 never serves a stale word.
//
// depth_scan replaces gci_tpu/depth/pallas_scan.py:depth_scan (the prefix sum
// behind the flag-byte build and the streamed and sharded depth).  It is
// bound by device-memory bytes: 8 B per slot for an int32 input (4 in, 4 out)
// and 5 B for the int8 form (1 in, sign-extended, 4 out), against 12 B for
// the two passes of the other kernels below.  The int8 form scans a bool
// bitmap as it lies; the compaction kernels below took its place on every
// path.  What the design does about the bytes:
//
//   * warp-striped tiles: lane l holds slots 4l..4l+3 of each 128-slot
//     column of its warp, so every load and store of a warp is one
//     contiguous 512-byte block (int8: each lane loads 16-byte words and
//     regroups the bytes by shuffle).  With each thread owning consecutive
//     slots instead, a warp's store spread over 2 KB and the scan ran ~15%
//     slower on the H100;
//   * large tiles (8192 slots, 64 a thread): a block waits in the look-back
//     with its tile held in registers and no loads in flight, so the fewer
//     tiles, the less of that wait.  Wider look-back windows (up to 512
//     status words a round trip), back-off in the spin and persistent blocks
//     that load the next tile during the look-back were each slower there.
//
// The other four kernels keep a reduce-then-scan skeleton:
//
//   1. tile_sums_kernel   one block per tile of kTile slots writes the tile's
//                         sum (one read of the input);
//   2. tile_carry_kernel  one block scans the tile sums into each tile's
//                         exclusive carry, in place (n / kTile words);
//   3. *_tiles_kernel     one block per tile re-reads its slots, scans them
//                         with a warp-shuffle block scan plus the carry, and
//                         runs the kernel's epilogue.
//
// Each thread owns kItems consecutive slots, loaded and stored as two 16-byte
// words (int32 streams) or one 8-byte word (int8 streams), so a warp moves
// one contiguous block per access and the running sum of a thread's slots
// stays in registers.  The prefix just before a thread's first slot is the
// thread's exclusive carry, so the predecessor's depth, which the epilogues
// compare against, needs no neighbour exchange.
//
// fused_depth_scan_packed replaces pallas_scan.py:fused_depth_scan_packed
// (_scan_packed_kernel).  It is bound by device-memory bytes: 4 B in and 5 B
// out per slot (depth plus the flag byte), plus the 4 B/slot re-read of
// pass 1.  Depth, gap mask, issue-interval edges and run boundaries are all
// derived from the one packed prefix in registers, so the masked depth and
// the interval mask never reach device memory.
//
// fused_depth_scan_flags, fused_depth_scan_masked and fused_depth_scan
// replace the pallas_scan.py kernels of the same names (_scan_flags_kernel,
// _scan_masked_kernel, _scan_kernel).  They scan a plain read delta and take
// the gap and scan-window state from int8 streams beside it, so unlike the
// packed word they are exact at any depth.  Each is bound by device-memory
// bytes (per slot: flags 4+1 B in, 4+1 B out; masked 4+2 B in, 4+3 B out;
// plain 4+1 B in, 4+2 B out; plus the 4 B re-read of pass 1).  The gap and
// valid state of a thread's predecessor is not in the prefix, so each
// thread reads it with one byte load at first - 1 (the TPU kernels prefetch
// the same byte per chunk as a scalar).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // two int4, or one uint2 of bytes, per thread
constexpr int kTile = kThreads * kItems;
constexpr int kCarryThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kItems == 8, "byte streams move as one 8-byte word per thread");

// depth_scan's look-back tiles: each warp owns kScanWarpSlots consecutive
// slots, as kScanCols columns of 128; lane l holds slots 4l..4l+3 of each
// column, so every warp access is one contiguous block
constexpr int kScanThreads = 128;
constexpr int kScanCols = 16;
constexpr int kScanWarpSlots = 128 * kScanCols;
constexpr int kScanTile = kScanThreads / 32 * kScanWarpSlots;
// status-word states (the word's high half; 0 is invalid)
constexpr unsigned long long kTileAggregate = 1;
constexpr unsigned long long kTileInclusive = 2;

__device__ __forceinline__ void load_items(const int32_t* __restrict__ in,
                                           int64_t first, int64_t n,
                                           uint32_t (&v)[kItems]) {
  if (first + kItems <= n) {
    const int4* p = reinterpret_cast<const int4*>(in + first);
    const int4 a = p[0];
    const int4 b = p[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      v[k] = first + k < n ? static_cast<uint32_t>(in[first + k]) : 0u;
    }
  }
}

__device__ __forceinline__ void store_items(int32_t* __restrict__ out,
                                            int64_t first, int64_t n,
                                            const uint32_t (&v)[kItems]) {
  if (first + kItems <= n) {
    int4* p = reinterpret_cast<int4*>(out + first);
    p[0] = make_int4(v[0], v[1], v[2], v[3]);
    p[1] = make_int4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (first + k < n) out[first + k] = static_cast<int32_t>(v[k]);
    }
  }
}

// The thread's kItems bytes, byte k at bits 8*(k&3) of word k>>2.
__device__ __forceinline__ void load_bytes(const int8_t* __restrict__ in,
                                           int64_t first, int64_t n,
                                           uint32_t (&b)[2]) {
  if (first + kItems <= n) {
    const uint2 w = *reinterpret_cast<const uint2*>(in + first);
    b[0] = w.x;
    b[1] = w.y;
  } else {
    b[0] = 0u;
    b[1] = 0u;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (first + k < n) {
        b[k >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(in[first + k]))
                     << (8 * (k & 3));
      }
    }
  }
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t (&b)[2], int k) {
  return (b[k >> 2] >> (8 * (k & 3))) & 0xFFu;
}

__device__ __forceinline__ void store_bytes(int8_t* __restrict__ out,
                                            int64_t first, int64_t n,
                                            const uint32_t (&b)[2]) {
  if (first + kItems <= n) {
    *reinterpret_cast<uint2*>(out + first) = make_uint2(b[0], b[1]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (first + k < n) out[first + k] = static_cast<int8_t>(byte_of(b, k));
    }
  }
}

// Sum over the block, valid in thread 0.  warp_sums holds NT / 32 words.
template <int NT>
__device__ __forceinline__ uint32_t block_sum(uint32_t x, uint32_t* warp_sums) {
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  uint32_t total = 0;
  if (warp == 0) {
    total = lane < kWarps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) total += __shfl_down_sync(kFull, total, o);
  }
  return total;
}

// Exclusive prefix of x over the threads of the block; *total gets the block
// sum in every thread.  warp_sums holds NT / 32 words and may be reused once
// this returns.
template <int NT>
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t x,
                                                         uint32_t* warp_sums,
                                                         uint32_t* total) {
  constexpr int kWarps = NT / 32;
  static_assert(kWarps <= 32, "one warp scans the warp totals");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const uint32_t warp_excl = warp == 0 ? 0u : warp_sums[warp - 1];
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return warp_excl + inc - x;
}

// Pass 3's prologue: loads the thread's kItems slots of `in` into v and
// returns the prefix (mod 2^32) of every slot before the thread's first one.
// Every thread of the block must call it (it holds block barriers).
__device__ __forceinline__ uint32_t thread_prefix(
    const int32_t* __restrict__ in, const uint32_t* __restrict__ carry,
    int64_t first, int64_t n, uint32_t (&v)[kItems], uint32_t* warp_sums) {
  load_items(in, first, n, v);
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) s += v[k];
  uint32_t total;
  return carry[blockIdx.x] + block_exclusive_scan<kThreads>(s, warp_sums, &total);
}

__device__ __forceinline__ int64_t thread_first() {
  return static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
}

__global__ void __launch_bounds__(kThreads)
tile_sums_kernel(const int32_t* __restrict__ in, int64_t n,
                 uint32_t* __restrict__ sums) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  uint32_t v[kItems];
  load_items(in, thread_first(), n, v);
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) s += v[k];
  const uint32_t t = block_sum<kThreads>(s, warp_sums);
  if (threadIdx.x == 0) sums[blockIdx.x] = t;
}

// Exclusive scan of the tile sums, in place, by one block.
__global__ void __launch_bounds__(kCarryThreads)
tile_carry_kernel(uint32_t* __restrict__ sums, int64_t n_tiles) {
  __shared__ uint32_t warp_sums[kCarryThreads / 32];
  uint32_t running = 0;
  for (int64_t base = 0; base < n_tiles;
       base += static_cast<int64_t>(kCarryThreads) * kItems) {
    const int64_t first = base + static_cast<int64_t>(threadIdx.x) * kItems;
    uint32_t v[kItems];
    uint32_t s = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      v[k] = first + k < n_tiles ? sums[first + k] : 0u;
      s += v[k];
    }
    uint32_t total;
    uint32_t acc = running + block_exclusive_scan<kCarryThreads>(s, warp_sums, &total);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (first + k < n_tiles) sums[first + k] = acc;
      acc += v[k];
    }
    running += total;
  }
}

// ---------------------------------------------------------------------------
// depth_scan: single-pass decoupled look-back
// ---------------------------------------------------------------------------

// Column j of the lane's slots at `first` (= warp base + 4 * lane), four
// int32 slots per column.
__device__ __forceinline__ void load_scan_cols(const int32_t* __restrict__ in,
                                               int64_t first, int64_t warp_end,
                                               int64_t n,
                                               uint32_t (&v)[kScanCols][4]) {
  if (warp_end <= n) {
    int4 w[kScanCols];
#pragma unroll
    for (int j = 0; j < kScanCols; ++j) {
      w[j] = *reinterpret_cast<const int4*>(in + first + 128 * j);
    }
#pragma unroll
    for (int j = 0; j < kScanCols; ++j) {
      v[j][0] = w[j].x; v[j][1] = w[j].y; v[j][2] = w[j].z; v[j][3] = w[j].w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kScanCols; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t i = first + 128 * j + k;
        v[j][k] = i < n ? static_cast<uint32_t>(in[i]) : 0u;
      }
    }
  }
}

__device__ __forceinline__ uint32_t sign_extend(uint32_t word, int k) {
  return static_cast<uint32_t>(
      static_cast<int32_t>(static_cast<int8_t>(word >> (8 * k))));
}

// The same columns of an int8 stream.  Each lane loads 16-byte words of the
// warp's bytes (lane l bytes 16l..16l+15 of every 512), and the four bytes of
// column j come from lane 8 * (j % 4) + l / 4 by shuffle; each is
// sign-extended.
__device__ __forceinline__ void load_scan_cols(const int8_t* __restrict__ in,
                                               int64_t first, int64_t warp_end,
                                               int64_t n,
                                               uint32_t (&v)[kScanCols][4]) {
  static_assert(kScanCols % 4 == 0, "int8 columns move as whole 16-byte words");
  const int lane = threadIdx.x & 31;
  if (warp_end <= n) {
    const int8_t* warp_in = in + first - 4 * lane;
    int4 q[kScanCols / 4];
#pragma unroll
    for (int m = 0; m < kScanCols / 4; ++m) {
      q[m] = *reinterpret_cast<const int4*>(warp_in + 512 * m + 16 * lane);
    }
#pragma unroll
    for (int j = 0; j < kScanCols; ++j) {
      const int src = 8 * (j & 3) + (lane >> 2);
      const int4 w = q[j >> 2];
      const uint32_t x = __shfl_sync(kFull, static_cast<uint32_t>(w.x), src);
      const uint32_t y = __shfl_sync(kFull, static_cast<uint32_t>(w.y), src);
      const uint32_t z = __shfl_sync(kFull, static_cast<uint32_t>(w.z), src);
      const uint32_t t = __shfl_sync(kFull, static_cast<uint32_t>(w.w), src);
      const int part = lane & 3;
      const uint32_t word = part == 0 ? x : part == 1 ? y : part == 2 ? z : t;
#pragma unroll
      for (int k = 0; k < 4; ++k) v[j][k] = sign_extend(word, k);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kScanCols; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t i = first + 128 * j + k;
        v[j][k] = i < n ? static_cast<uint32_t>(static_cast<int32_t>(in[i])) : 0u;
      }
    }
  }
}

// A status word holds its state from bit kShift up and a V value below it:
// depth_scan's uint32 sums (state in the high half), the compaction's
// 64-bit counts (state in the top two bits).
template <typename V>
struct StatusWord {
  static constexpr int kShift = sizeof(V) == 4 ? 32 : 62;
  static constexpr unsigned long long kValueMask = (1ull << kShift) - 1ull;
};

// One 64-bit store of (state, value), ordered after every earlier write of
// the thread; kRelaxed: unordered, for readers that need the word alone (an
// acquire load holds back every later load, and a release store waits for
// every earlier store).
template <bool kRelaxed = false, typename V>
__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned long long state, V value) {
  const unsigned long long w =
      (state << StatusWord<V>::kShift) | static_cast<unsigned long long>(value);
  if (kRelaxed) {
    asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(word), "l"(w) : "memory");
  } else {
    asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(word), "l"(w) : "memory");
  }
}

template <bool kRelaxed = false>
__device__ __forceinline__ unsigned long long observe(const unsigned long long* word) {
  unsigned long long w;
  if (kRelaxed) {
    asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(w) : "l"(word) : "memory");
  } else {
    asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(w) : "l"(word) : "memory");
  }
  return w;
}

// Exclusive prefix of tile `tile` (> 0), by one whole warp, from the status
// words of its predecessors: lane l reads tile pred - l, nearest first.  The
// warp sums the words up to the nearest inclusive prefix, re-reading any
// of those still invalid until its tile has published; it never waits on a
// word past that prefix.  Returned in every lane.
template <typename V, bool kRelaxed = false>
__device__ __forceinline__ V look_back(const unsigned long long* status, int64_t tile) {
  constexpr int kShift = StatusWord<V>::kShift;
  const int lane = threadIdx.x & 31;
  V exclusive = 0;
  for (int64_t pred = tile - 1;; pred -= 32) {
    const int64_t idx = pred - lane;
    // before tile 0 there is nothing: an inclusive prefix of 0
    unsigned long long w = idx >= 0 ? observe<kRelaxed>(status + idx) : kTileInclusive << kShift;
    unsigned inclusive;
    int last;
    while (true) {
      inclusive = __ballot_sync(kFull, (w >> kShift) == kTileInclusive);
      last = inclusive ? __ffs(inclusive) - 1 : 31;
      const bool waiting = lane <= last && (w >> kShift) == 0;
      if (!__any_sync(kFull, waiting)) break;
      if (waiting) w = observe<kRelaxed>(status + idx);
    }
    V v = lane <= last ? static_cast<V>(w & StatusWord<V>::kValueMask) : V(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    exclusive += v;
    if (inclusive) return exclusive;
  }
}

// status holds one zeroed word per tile; next_tile is a zeroed counter.
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
lookback_scan_kernel(const T* __restrict__ in, int32_t* __restrict__ out,
                     int64_t n, unsigned long long* status,
                     unsigned int* next_tile) {
  constexpr int kWarps = kScanThreads / 32;
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ unsigned int tile_index;
  __shared__ uint32_t tile_exclusive;
  if (threadIdx.x == 0) tile_index = atomicAdd(next_tile, 1u);
  __syncthreads();
  const int64_t tile = tile_index;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t warp_first = tile * kScanTile + static_cast<int64_t>(warp) * kScanWarpSlots;
  const int64_t first = warp_first + 4 * lane;
  uint32_t v[kScanCols][4];
  load_scan_cols(in, first, warp_first + kScanWarpSlots, n, v);

  // each column's exclusive prefix within the warp's slots
  uint32_t col_prefix[kScanCols];
  uint32_t warp_total = 0;
#pragma unroll
  for (int j = 0; j < kScanCols; ++j) {
    const uint32_t s = v[j][0] + v[j][1] + v[j][2] + v[j][3];
    uint32_t inc = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    col_prefix[j] = warp_total + inc - s;
    warp_total += __shfl_sync(kFull, inc, 31);
  }
  if (lane == 0) warp_sums[warp] = warp_total;
  __syncthreads();

  // warp 0: the warps' exclusive prefixes in place, the tile's aggregate,
  // the look-back, the tile's inclusive prefix
  if (warp == 0) {
    const uint32_t w = lane < kWarps ? warp_sums[lane] : 0u;
    uint32_t inc = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane < kWarps) warp_sums[lane] = inc - w;
    const uint32_t total = __shfl_sync(kFull, inc, kWarps - 1);
    if (tile == 0) {
      if (lane == 0) {
        publish(status, kTileInclusive, total);
        tile_exclusive = 0;
      }
    } else {
      if (lane == 0) publish(status + tile, kTileAggregate, total);
      const uint32_t exclusive = look_back<uint32_t>(status, tile);
      if (lane == 0) {
        publish(status + tile, kTileInclusive, exclusive + total);
        tile_exclusive = exclusive;
      }
    }
  }
  __syncthreads();

  const uint32_t prefix = tile_exclusive + warp_sums[warp];
  const bool whole = warp_first + kScanWarpSlots <= n;
#pragma unroll
  for (int j = 0; j < kScanCols; ++j) {
    uint32_t acc = prefix + col_prefix[j];
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc += v[j][k];
      o[k] = acc;
    }
    const int64_t i = first + 128 * j;
    if (whole) {
      *reinterpret_cast<int4*>(out + i) = make_int4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (i + k < n) out[i + k] = static_cast<int32_t>(o[k]);
      }
    }
  }
}

// Issue-interval membership of one packed prefix word sw:
// depth = sw >> 2 (logical), in-gap = bit1, scan-window valid = bit0.
__device__ __forceinline__ bool in_issue_range(uint32_t sw, int32_t lo,
                                               int32_t hi) {
  const int32_t depth = static_cast<int32_t>(sw >> 2);
  const int32_t masked = (sw & 2u) ? 0 : depth;
  return (sw & 1u) && masked > lo && masked <= hi;
}

__global__ void __launch_bounds__(kThreads)
packed_scan_tiles_kernel(const int32_t* __restrict__ word,
                         const uint32_t* __restrict__ carry, int64_t n,
                         int32_t lo, int32_t hi, int32_t* __restrict__ depth,
                         int8_t* __restrict__ flags) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  const int64_t first = thread_first();
  uint32_t v[kItems];
  // packed prefix just before this thread's first slot: its predecessor
  uint32_t sw = thread_prefix(word, carry, first, n, v, warp_sums);
  int32_t prev_depth;
  bool prev_m;
  if (first == 0) {
    // no slot before position 0: outside every interval, and a depth no slot
    // can hold, so position 0 always starts a run
    prev_depth = 0x7FFFFFFF;
    prev_m = false;
  } else {
    prev_depth = static_cast<int32_t>(sw >> 2);
    prev_m = in_issue_range(sw, lo, hi);
  }
  uint32_t f[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    sw += v[k];
    const int32_t d = static_cast<int32_t>(sw >> 2);
    const bool m = in_issue_range(sw, lo, hi);
    const uint32_t bits = static_cast<uint32_t>(m && !prev_m) |
                          (static_cast<uint32_t>(!m && prev_m) << 1) |
                          (static_cast<uint32_t>(d != prev_depth) << 2) |
                          ((sw & 2u) << 2);
    f[k >> 2] |= bits << (8 * (k & 3));
    v[k] = static_cast<uint32_t>(d);
    prev_depth = d;
    prev_m = m;
  }
  store_items(depth, first, n, v);
  store_bytes(flags, first, n, f);
}

// Issue-interval membership of a raw depth under its gap and scan-window
// state: the gap-masked depth lies in (lo, hi] inside the window.
__device__ __forceinline__ bool in_issue(int32_t raw, bool gap, bool valid,
                                         int32_t lo, int32_t hi) {
  const int32_t masked = gap ? 0 : raw;
  return valid && masked > lo && masked <= hi;
}

// fused_depth_scan_flags: flags in bit0 in-gap, bit1 valid; flags out bit0
// rise, bit1 fall, bit2 change (raw run boundary, forced at position 0).
__global__ void __launch_bounds__(kThreads)
flags_scan_tiles_kernel(const int32_t* __restrict__ delta,
                        const int8_t* __restrict__ flags,
                        const uint32_t* __restrict__ carry, int64_t n,
                        int32_t lo, int32_t hi, int32_t* __restrict__ depth,
                        int8_t* __restrict__ out) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  const int64_t first = thread_first();
  uint32_t v[kItems];
  uint32_t acc = thread_prefix(delta, carry, first, n, v, warp_sums);
  uint32_t fin[2];
  load_bytes(flags, first, n, fin);
  // the predecessor's raw depth is the carry; its gap and valid bits are one
  // byte load away.  Position 0 has none: outside every interval.
  int32_t prev_raw = static_cast<int32_t>(acc);
  bool prev_m = false;
  if (first > 0 && first < n) {
    const uint32_t pf = static_cast<uint8_t>(flags[first - 1]);
    prev_m = in_issue(prev_raw, pf & 1u, pf & 2u, lo, hi);
  }
  uint32_t f[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    acc += v[k];
    const int32_t d = static_cast<int32_t>(acc);
    const uint32_t fk = byte_of(fin, k);
    const bool m = in_issue(d, fk & 1u, fk & 2u, lo, hi);
    const bool change = d != prev_raw || (k == 0 && first == 0);
    const uint32_t bits = static_cast<uint32_t>(m && !prev_m) |
                          (static_cast<uint32_t>(!m && prev_m) << 1) |
                          (static_cast<uint32_t>(change) << 2);
    f[k >> 2] |= bits << (8 * (k & 3));
    v[k] = static_cast<uint32_t>(d);
    prev_raw = d;
    prev_m = m;
  }
  store_items(depth, first, n, v);
  store_bytes(out, first, n, f);
}

// fused_depth_scan_masked: the same math as flags_scan_tiles_kernel with gap
// and valid as separate int8 streams (nonzero is true) and rise, fall and
// change as separate 0/1 int8 streams.
__global__ void __launch_bounds__(kThreads)
masked_scan_tiles_kernel(const int32_t* __restrict__ delta,
                         const int8_t* __restrict__ gap,
                         const int8_t* __restrict__ valid,
                         const uint32_t* __restrict__ carry, int64_t n,
                         int32_t lo, int32_t hi, int32_t* __restrict__ depth,
                         int8_t* __restrict__ rise, int8_t* __restrict__ fall,
                         int8_t* __restrict__ change) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  const int64_t first = thread_first();
  uint32_t v[kItems];
  uint32_t acc = thread_prefix(delta, carry, first, n, v, warp_sums);
  uint32_t g[2], va[2];
  load_bytes(gap, first, n, g);
  load_bytes(valid, first, n, va);
  int32_t prev_raw = static_cast<int32_t>(acc);
  bool prev_m = false;
  if (first > 0 && first < n) {
    prev_m = in_issue(prev_raw, gap[first - 1] != 0, valid[first - 1] != 0, lo, hi);
  }
  uint32_t r[2] = {0u, 0u}, f[2] = {0u, 0u}, c[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    acc += v[k];
    const int32_t d = static_cast<int32_t>(acc);
    const bool m = in_issue(d, byte_of(g, k) != 0, byte_of(va, k) != 0, lo, hi);
    const int sh = 8 * (k & 3);
    r[k >> 2] |= static_cast<uint32_t>(m && !prev_m) << sh;
    f[k >> 2] |= static_cast<uint32_t>(!m && prev_m) << sh;
    c[k >> 2] |= static_cast<uint32_t>(d != prev_raw || (k == 0 && first == 0)) << sh;
    v[k] = static_cast<uint32_t>(d);
    prev_raw = d;
    prev_m = m;
  }
  store_items(depth, first, n, v);
  store_bytes(rise, first, n, r);
  store_bytes(fall, first, n, f);
  store_bytes(change, first, n, c);
}

// fused_depth_scan: rise and fall of lo < depth <= hi inside valid (nonzero
// is true), on the raw depth: no gap mask and no change stream.
__global__ void __launch_bounds__(kThreads)
edges_scan_tiles_kernel(const int32_t* __restrict__ delta,
                        const int8_t* __restrict__ valid,
                        const uint32_t* __restrict__ carry, int64_t n,
                        int32_t lo, int32_t hi, int32_t* __restrict__ depth,
                        int8_t* __restrict__ rise, int8_t* __restrict__ fall) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  const int64_t first = thread_first();
  uint32_t v[kItems];
  uint32_t acc = thread_prefix(delta, carry, first, n, v, warp_sums);
  uint32_t va[2];
  load_bytes(valid, first, n, va);
  bool prev_m = false;
  if (first > 0 && first < n) {
    prev_m = in_issue(static_cast<int32_t>(acc), false, valid[first - 1] != 0, lo, hi);
  }
  uint32_t r[2] = {0u, 0u}, f[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    acc += v[k];
    const int32_t d = static_cast<int32_t>(acc);
    const bool m = in_issue(d, false, byte_of(va, k) != 0, lo, hi);
    const int sh = 8 * (k & 3);
    r[k >> 2] |= static_cast<uint32_t>(m && !prev_m) << sh;
    f[k >> 2] |= static_cast<uint32_t>(!m && prev_m) << sh;
    v[k] = static_cast<uint32_t>(d);
    prev_m = m;
  }
  store_items(depth, first, n, v);
  store_bytes(rise, first, n, r);
  store_bytes(fall, first, n, f);
}

// ---------------------------------------------------------------------------
// stream compaction
// ---------------------------------------------------------------------------
//
// compact_flags and compact_runs replace the compaction gci_tpu builds on
// depth_scan + searchsorted (gci_tpu/depth/fused.py _compact_fn,
// _compact_pack_fn and _flag_compact_pack_fn, gci_tpu/depth/device.py
// make_sharded_compact_gather_fn): the ascending indices of the slots where
// a predicate holds, with their exact count, for up to three predicates in
// one call.  Two forms, each a template instance of compact_kernel:
//
//   * flag form: one int8 stream x and up to three bit masks m; the
//     predicate is (x & m) != 0;
//   * run form: one int32 depth; the predicate is depth[i] != depth[i-1],
//     slot 0 compared against a carry, or forced when there is none.  It
//     writes each run's depth beside its index.
//
// Bound by device-memory bytes: 1 B/slot in for the flag form, 4 for the
// run form, plus 8 B (index) or 12 B (index and depth) per set slot out.
// One launch reads the input once:
//
//   * persistent blocks, as many as fit on the card, launched cooperatively
//     so that all of them run at once; block b takes tiles of
//     Form::kTileBytes b, b + G, b + 2G, ... (G blocks).  Thread 0 keeps
//     the block's next kCompactStages - 1 tiles in flight into a
//     shared-memory ring by 1-D bulk copies (cp.async.bulk, completion on an
//     mbarrier): the loads hold no registers and stay in flight while the
//     block ranks its tile and waits on its look-back.  The last, partial
//     tile is loaded by the block itself and padded with slots that set no
//     predicate.  (Tiles claimed from an atomic counter, as depth_scan
//     takes them, were slower with a ring: a tile claimed into the back of
//     one block's ring is ranked a few tiles later, and its successors,
//     claimed by other blocks, wait for it);
//   * each warp counts its columns' set slots per predicate (keeping their
//     bits in registers), the warps' counts are summed, and warp s
//     publishes the tile's count of predicate s one tile ahead: the block
//     counts tile k + 1 before it takes tile k's exclusive offset from its
//     predecessors' status words (depth_scan's decoupled look-back, one row
//     of status words per predicate, the rows walked by different warps at
//     once; the words carry their values, so loads and stores are relaxed).
//     Every block runs and ranks its tiles in order, so the lowest tile not
//     yet ranked never waits;
//   * each set slot's index (and depth) is stored at its place in the
//     output.  There is no per-tile cache and no per-slot scratch.
//
// The caller gives the outputs' capacity: a slot ranked at or past it is not
// stored.  The block of the last tile writes the exact totals after the
// status rows, and the C entry copies them to the host and synchronizes the
// stream (the call's one host sync); the caller launches once more at the
// exact size if a total exceeds the capacity.
//
// Ranking.  A warp column is 512 bytes, 16 of them a lane (16 flag bytes or
// 4 depths), so every warp access is one contiguous block.  A lane's slots
// become one bit each per predicate, and its counts (at most 16) are packed
// kCountBits a predicate into one word: one warp inclusive scan
// (__shfl_up_sync) ranks every predicate at once, and a column's total stays
// below 2^kCountBits.  A column empty under every predicate is skipped after
// one __any_sync.  Each column's set slots are staged in shared memory at
// their ranks and stored by consecutive lanes, so a dense column's indices
// leave as contiguous stores.

// Each form's tile bytes and the blocks a SM must hold (which caps the
// registers: 64 a thread at 4 blocks, 128 at 2), and the ring's slots: the
// faster of the shapes timed on the H100 (PERF.md).
constexpr int kFlagTileBytes = 16384, kRunTileBytes = 32768;
constexpr int kFlagMinBlocks = 4, kRunMinBlocks = 2;
constexpr int kCompactStages = 3;

constexpr int kCompactThreads = 256;
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kCompactColBytes = 512;  // a warp column: 16 bytes a lane
constexpr int kCountBits = 10;         // a predicate's field of a packed count
constexpr uint32_t kCountMask = (1u << kCountBits) - 1u;
static_assert(kCompactStages >= 2, "the ring holds the tile ranked and the next, counted");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Bits 0-3: bit 0 of each of the four bytes of w.
__device__ __forceinline__ uint32_t byte_bits(uint32_t w) {
  // bits 0, 8, 16, 24 gathered into bits 28-31
  return ((w & 0x01010101u) * 0x10204080u) >> 28;
}

// Bits 0-3: whether byte k of (w & mrep) is nonzero, for the four bytes of w.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w, uint32_t mrep) {
  const uint32_t t = w & mrep;
  // bit 7 of each byte: its low seven bits nonzero (no carry leaves a
  // byte: 0x7F + 0x7F < 0x100), or its own bit 7
  const uint32_t hi = (((t & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | t) & 0x80808080u;
  return byte_bits(hi >> 7);
}

// Flag form over NS masks (byte s of `masks` is predicate s's mask, 1-255).
template <int NS>
struct FlagForm {
  using Elem = int8_t;
  static constexpr int kTileBytes = kFlagTileBytes;
  static constexpr int kMinBlocks = kFlagMinBlocks;
  static constexpr int kStreams = NS;
  static constexpr bool kValues = false;

  const int8_t* in;
  uint32_t masks;

  // What pads the last tile past n: no flag.
  __device__ __forceinline__ int8_t pad(int64_t) const { return 0; }
  __device__ __forceinline__ uint32_t before(const int8_t*, int64_t) const { return 0u; }

  // b[s]: bit j is slot first + j (tile-local) under mask s.  The whole
  // warp calls it.
  __device__ __forceinline__ void bits(const int8_t* tile, int first, uint32_t,
                                       uint32_t (&b)[NS]) const {
    const uint4 w = *reinterpret_cast<const uint4*>(tile + first);
    const uint32_t any = ((masks | masks >> 8 | masks >> 16) & 0xFFu) * 0x01010101u;
    const bool maybe = ((w.x | w.y | w.z | w.w) & any) != 0u;
    const bool column = __any_sync(kFull, maybe);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const uint32_t m = (masks >> (8 * s)) & 0xFFu;
      if (!column) {
        b[s] = 0u;
      } else if ((m & (m - 1u)) == 0u) {
        // one bit (every mask of the main path): shift it to each byte's bit 0
        const int sh = __ffs(m) - 1;
        b[s] = byte_bits(w.x >> sh) | (byte_bits(w.y >> sh) << 4) |
               (byte_bits(w.z >> sh) << 8) | (byte_bits(w.w >> sh) << 12);
      } else {
        const uint32_t mrep = m * 0x01010101u;
        b[s] = nonzero_bytes(w.x, mrep) | (nonzero_bytes(w.y, mrep) << 4) |
               (nonzero_bytes(w.z, mrep) << 8) | (nonzero_bytes(w.w, mrep) << 12);
      }
    }
  }
};

// Run form: the run boundaries of an int32 depth.
struct RunForm {
  using Elem = int32_t;
  static constexpr int kTileBytes = kRunTileBytes;
  static constexpr int kMinBlocks = kRunMinBlocks;
  static constexpr int kStreams = 1;
  static constexpr bool kValues = true;

  const int32_t* in;
  int32_t carry;  // the depth before slot 0, when has_carry
  int has_carry;

  // The last tile is padded with the last depth, which starts no run.
  __device__ __forceinline__ int32_t pad(int64_t n) const { return in[n - 1]; }

  // The depth before the tile: the slot before it, the carry, or (a forced
  // boundary) any value but the tile's first depth.
  __device__ __forceinline__ uint32_t before(const int32_t* tile, int64_t tile_first) const {
    if (tile_first > 0) return static_cast<uint32_t>(in[tile_first - 1]);
    return has_carry ? static_cast<uint32_t>(carry) : static_cast<uint32_t>(tile[0]) + 1u;
  }

  __device__ __forceinline__ void bits(const int32_t* tile, int first, uint32_t before,
                                       uint32_t (&b)[1]) const {
    const int4 v = *reinterpret_cast<const int4*>(tile + first);
    const int32_t up = __shfl_up_sync(kFull, v.w, 1);
    const int32_t prev = (threadIdx.x & 31) ? up
                         : first > 0      ? tile[first - 1]
                                          : static_cast<int32_t>(before);
    b[0] = static_cast<uint32_t>(v.x != prev) | (static_cast<uint32_t>(v.y != v.x) << 1) |
           (static_cast<uint32_t>(v.z != v.y) << 2) | (static_cast<uint32_t>(v.w != v.z) << 3);
  }
};

// status: per predicate one row of ceil(n / tile slots) zeroed status
// words, then one word per predicate that receives its total.  Outputs
// hold cap entries each.
template <class Form>
__global__ void __launch_bounds__(kCompactThreads, Form::kMinBlocks)
compact_kernel(const Form f, int64_t n, unsigned long long* status, int64_t cap,
               int64_t* __restrict__ idx0, int64_t* __restrict__ idx1,
               int64_t* __restrict__ idx2, int32_t* __restrict__ vals) {
  using Elem = typename Form::Elem;
  constexpr int NS = Form::kStreams;
  constexpr int kTileBytes = Form::kTileBytes;
  constexpr int kTileSlots = kTileBytes / static_cast<int>(sizeof(Elem));
  constexpr int kCompactCols = kTileBytes / (kCompactWarps * kCompactColBytes);  // a warp's
  static_assert(kCompactCols * kCompactWarps * kCompactColBytes == kTileBytes,
                "a tile is whole columns of every warp");
  static_assert(kCompactCols * 16 <= static_cast<int>(kCountMask),
                "a lane's count over its columns fits its field");
  constexpr int kColSlots = kCompactColBytes / static_cast<int>(sizeof(Elem));
  constexpr int kLaneSlots = 16 / static_cast<int>(sizeof(Elem));
  extern __shared__ __align__(128) unsigned char compact_ring[];
  __shared__ __align__(8) unsigned long long full[kCompactStages];
  __shared__ uint32_t warp_counts[2][NS][kCompactWarps];  // this tile's, the next's
  __shared__ unsigned long long warp_base[NS][kCompactWarps];
  __shared__ uint16_t stage[kCompactWarps][kColSlots];

  const int64_t n_tiles = (n + kTileSlots - 1) / kTileSlots;
  unsigned long long* totals = status + NS * n_tiles;
  Elem* ring = reinterpret_cast<Elem*>(compact_ring);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // the block's k-th tile, and thread 0 starting its copy into ring slot
  // k % kCompactStages; the last, partial tile (or none past the end)
  // completes the slot's phase with no bytes
  auto tile_at = [&](int k) {
    return static_cast<int64_t>(blockIdx.x) + static_cast<int64_t>(k) * gridDim.x;
  };
  auto refill = [&](int k) {
    const int st = k % kCompactStages;
    const uint32_t bar = smem_addr(&full[st]);
    const int64_t first = tile_at(k) * kTileSlots;
    if (first + kTileSlots <= n) {
      // the slot's earlier reads (generic proxy) before the copy's writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(bar), "r"(kTileBytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];"
          ::"r"(smem_addr(ring + st * kTileSlots)), "l"(f.in + first),
            "r"(kTileBytes), "r"(bar) : "memory");
    } else {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
    }
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kCompactStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&full[s])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#pragma unroll
    for (int k = 0; k < kCompactStages; ++k) refill(k);
  }
  __syncthreads();

  // the block's k-th tile in its ring slot, once arrived (the partial tile
  // loaded and padded by the block)
  auto ready = [&](int k) {
    mbar_wait(smem_addr(&full[k % kCompactStages]), (k / kCompactStages) & 1);
    Elem* t = ring + (k % kCompactStages) * kTileSlots;
    const int64_t first = tile_at(k) * kTileSlots;
    if (first + kTileSlots > n) {
      const Elem p = f.pad(n);
      for (int i = threadIdx.x; i < kTileSlots; i += kCompactThreads) {
        t[i] = first + i < n ? f.in[first + i] : p;
      }
      __syncthreads();
    }
    return t;
  };
  // the bits of the warp's columns of the block's k-th tile into b (kept
  // in registers until the tile's slots are stored), their set slots per
  // warp and predicate into warp_counts[k & 1], and the tile's count
  // published by warp s (tile 0's as its inclusive prefix)
  auto count = [&](int k, const Elem* t, uint32_t (&b)[kCompactCols][NS]) {
    const int64_t tile = tile_at(k);
    const uint32_t before = f.before(t, tile * kTileSlots);
    uint32_t lane_counts = 0u;
#pragma unroll
    for (int c = 0; c < kCompactCols; ++c) {
      f.bits(t, (warp * kCompactCols + c) * kColSlots + lane * kLaneSlots, before, b[c]);
#pragma unroll
      for (int s = 0; s < NS; ++s) lane_counts += __popc(b[c][s]) << (kCountBits * s);
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const uint32_t w = __reduce_add_sync(kFull, (lane_counts >> (kCountBits * s)) & kCountMask);
      if (lane == 0) warp_counts[k & 1][s][warp] = w;
    }
    __syncthreads();
    if (warp < NS && lane == 0) {
      uint32_t total = 0u;
#pragma unroll
      for (int w = 0; w < kCompactWarps; ++w) total += warp_counts[k & 1][warp][w];
      publish<true>(status + warp * n_tiles + tile,
                    tile == 0 ? kTileInclusive : kTileAggregate,
                    static_cast<unsigned long long>(total));
    }
  };

  const Elem* t = ready(0);
  uint32_t bits[kCompactCols][NS];  // the tile's
  count(0, t, bits);
  for (int k = 0; tile_at(k) < n_tiles; ++k) {
    const int64_t tile = tile_at(k);
    const int64_t tile_first = tile * kTileSlots;
    // the next tile's count goes out before this one's look-back, so the
    // blocks behind find every count of their window already published
    const Elem* next = nullptr;
    uint32_t next_bits[kCompactCols][NS];
    if (tile_at(k + 1) < n_tiles) {
      next = ready(k + 1);
      count(k + 1, next, next_bits);
    }

    // warp s: the warps' offsets of predicate s and the tile's exclusive
    // offset from its look-back
    if (warp < NS) {
      const int s = warp;
      const uint32_t c = lane < kCompactWarps ? warp_counts[k & 1][s][lane] : 0u;
      uint32_t inc = c;
#pragma unroll
      for (int o = 1; o < kCompactWarps; o <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += y;
      }
      const unsigned long long total = __shfl_sync(kFull, inc, kCompactWarps - 1);
      unsigned long long* row = status + s * n_tiles;
      unsigned long long exclusive = 0;
      if (tile > 0) {
        // the status words carry their values: relaxed loads and stores
        exclusive = look_back<unsigned long long, true>(row, tile);
        if (lane == 0) publish<true>(row + tile, kTileInclusive, exclusive + total);
      }
      if (lane < kCompactWarps) warp_base[s][lane] = exclusive + inc - c;
      if (lane == 0 && tile == n_tiles - 1) totals[s] = exclusive + total;
    }
    __syncthreads();

    // each set slot's index (and depth) at its rank
    unsigned long long base[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) base[s] = warp_base[s][warp];
#pragma unroll
    for (int c = 0; c < kCompactCols; ++c) {
      uint32_t packed = 0u;
#pragma unroll
      for (int s = 0; s < NS; ++s) packed |= __popc(bits[c][s]) << (kCountBits * s);
      if (!__any_sync(kFull, packed != 0u)) continue;
      uint32_t inc = packed;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += y;
      }
      const uint32_t col_total = __shfl_sync(kFull, inc, 31);
      const uint32_t lane_rank = inc - packed;
      const int col = (warp * kCompactCols + c) * kColSlots;  // tile-local
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const uint32_t total = (col_total >> (kCountBits * s)) & kCountMask;
        if (total == 0u) continue;  // the same in every lane
        uint32_t at = (lane_rank >> (kCountBits * s)) & kCountMask;
        for (uint32_t m = bits[c][s]; m != 0u; m &= m - 1u, ++at) {
          stage[warp][at] = static_cast<uint16_t>(lane * kLaneSlots + __ffs(m) - 1);
        }
        __syncwarp();
        int64_t* out = s == 0 ? idx0 : s == 1 ? idx1 : idx2;
        for (uint32_t i = lane; i < total; i += 32) {
          const unsigned long long pos = base[s] + i;
          if (pos < static_cast<unsigned long long>(cap)) {
            const int offset = col + stage[warp][i];
            out[pos] = tile_first + offset;
            if (Form::kValues) vals[pos] = static_cast<int32_t>(t[offset]);
          }
        }
        __syncwarp();
        base[s] += total;
      }
    }
    __syncthreads();  // the ring slot is free again
    if (threadIdx.x == 0) refill(k + kCompactStages);
    t = next;
#pragma unroll
    for (int c = 0; c < kCompactCols; ++c) {
#pragma unroll
      for (int s = 0; s < NS; ++s) bits[c][s] = next_bits[c][s];
    }
  }
}

// One launch over n > 0 slots: status as compact_kernel takes it (zeroed
// here, on the stream); outputs of cap entries (unused predicates' may be
// null).  Then the predicates' totals into the host array `totals`, and
// the stream synchronized: the call's one host sync.
template <class Form>
int launch_compact(const Form& f, int64_t n, unsigned long long* status, int64_t cap,
                   int64_t* idx0, int64_t* idx1, int64_t* idx2, int32_t* vals,
                   int device, cudaStream_t stream, int64_t* totals) {
  constexpr int kSmem = kCompactStages * Form::kTileBytes;
  constexpr int kTileSlots = Form::kTileBytes / static_cast<int>(sizeof(typename Form::Elem));
  // blocks that fit on each device at once, found on the first launch there
  // (the CUDA runtime's queries cost more than the launch)
  constexpr int kDevices = 64;
  static int resident_on[kDevices];
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident_on[device] == 0) {
    err = cudaFuncSetAttribute(compact_kernel<Form>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compact_kernel<Form>,
                                                        kCompactThreads, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm * sms == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident_on[device] = per_sm * sms;
  }
  const int64_t n_tiles = (n + kTileSlots - 1) / kTileSlots;
  err = cudaMemsetAsync(status, 0, (n_tiles + 1) * Form::kStreams * sizeof(*status), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t resident = resident_on[device];
  const unsigned grid = static_cast<unsigned>(n_tiles < resident ? n_tiles : resident);
  // a cooperative launch runs every block at once or fails, so no block
  // waits in its look-back on a tile whose block is not running
  Form form = f;
  void* args[] = {&form, &n, &status, &cap, &idx0, &idx1, &idx2, &vals};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&compact_kernel<Form>),
                                    dim3(grid), dim3(kCompactThreads), args, kSmem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the totals through this thread's pinned words for the device (a copy
  // to pageable memory is staged, and slower)
  static thread_local int64_t* pinned[kDevices];
  if (pinned[device] == nullptr) {
    err = cudaHostAlloc(reinterpret_cast<void**>(&pinned[device]), 3 * sizeof(int64_t),
                        cudaHostAllocDefault);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaMemcpyAsync(pinned[device], status + Form::kStreams * n_tiles,
                        Form::kStreams * sizeof(*totals), cudaMemcpyDeviceToHost, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamSynchronize(stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int s = 0; s < Form::kStreams; ++s) totals[s] = pinned[device][s];
  return 0;
}

int64_t tiles_for(int64_t n) { return (n + kTile - 1) / kTile; }

// Sets the device and runs passes 1 and 2 over `in`, leaving each tile's
// exclusive carry in tile_scratch.  Returns a cudaError_t.
int launch_tile_carries(const int32_t* in, uint32_t* tile_scratch, int64_t n,
                        int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = tiles_for(n);
  tile_sums_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      in, n, tile_scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_carry_kernel<<<1, kCarryThreads, 0, stream>>>(tile_scratch, tiles);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the look-back scan over n > 0 slots; status holds
// ceil(n / kScanTile) + 1 zeroed 64-bit words: the tiles' status words, then
// the tile counter.
template <typename T>
int launch_lookback_scan(const T* in, int32_t* out, unsigned long long* status,
                         int64_t n, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (n + kScanTile - 1) / kScanTile;
  lookback_scan_kernel<T><<<static_cast<unsigned>(tiles), kScanThreads, 0, stream>>>(
      in, out, n, status, reinterpret_cast<unsigned int*>(status + tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry below takes n slots (n > 0 launches), its scratch, the CUDA
// device and stream, and returns a cudaError_t.  The depth_scan entries take
// ceil(n / gci_depth_scan_tile_slots()) + 1 zeroed 64-bit status words and a
// 16-byte aligned input of either type; the others ceil(n /
// gci_scan_tile_slots()) uint32 words of tile_scratch, 16-byte aligned int32
// streams and 8-byte aligned int8 streams.
extern "C" {

// Slots per tile: the caller allocates ceil(n / tile) uint32 words of scratch.
int gci_scan_tile_slots() { return kTile; }

// Slots per look-back tile of the depth_scan entries.
int gci_depth_scan_tile_slots() { return kScanTile; }

const char* gci_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[i] = in[0] + ... + in[i] (mod 2^32).
int gci_depth_scan(const int32_t* in, int32_t* out, unsigned long long* status,
                   int64_t n, int device, void* stream) {
  if (n <= 0) return 0;
  return launch_lookback_scan(in, out, status, n, device,
                              static_cast<cudaStream_t>(stream));
}

// out[i] = in[0] + ... + in[i] (mod 2^32), each int8 sign-extended.
int gci_depth_scan_i8(const int8_t* in, int32_t* out, unsigned long long* status,
                      int64_t n, int device, void* stream) {
  if (n <= 0) return 0;
  return launch_lookback_scan(in, out, status, n, device,
                              static_cast<cudaStream_t>(stream));
}

// Packed-word scan: depth (int32) and flag byte (bit0 rise, bit1 fall,
// bit2 change, bit3 in-gap) of word = read_delta<<2 | gap<<1 | valid.
int gci_packed_scan(const int32_t* word, int32_t* depth, int8_t* flags,
                    uint32_t* tile_scratch, int64_t n, int32_t lo, int32_t hi,
                    int device, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  int rc = launch_tile_carries(word, tile_scratch, n, device, s);
  if (rc != 0) return rc;
  packed_scan_tiles_kernel<<<static_cast<unsigned>(tiles_for(n)), kThreads, 0, s>>>(
      word, tile_scratch, n, lo, hi, depth, flags);
  return static_cast<int>(cudaGetLastError());
}

// Flags scan: raw depth and out byte (bit0 rise, bit1 fall, bit2 change) of
// a read delta under flag bytes (bit0 in-gap, bit1 scan-window valid).
int gci_flags_scan(const int32_t* delta, const int8_t* flags, int32_t* depth,
                   int8_t* out, uint32_t* tile_scratch, int64_t n, int32_t lo,
                   int32_t hi, int device, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  int rc = launch_tile_carries(delta, tile_scratch, n, device, s);
  if (rc != 0) return rc;
  flags_scan_tiles_kernel<<<static_cast<unsigned>(tiles_for(n)), kThreads, 0, s>>>(
      delta, flags, tile_scratch, n, lo, hi, depth, out);
  return static_cast<int>(cudaGetLastError());
}

// Masked scan: raw depth and 0/1 rise, fall, change streams of a read delta
// under separate gap and valid streams.
int gci_masked_scan(const int32_t* delta, const int8_t* gap,
                    const int8_t* valid, int32_t* depth, int8_t* rise,
                    int8_t* fall, int8_t* change, uint32_t* tile_scratch,
                    int64_t n, int32_t lo, int32_t hi, int device,
                    void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  int rc = launch_tile_carries(delta, tile_scratch, n, device, s);
  if (rc != 0) return rc;
  masked_scan_tiles_kernel<<<static_cast<unsigned>(tiles_for(n)), kThreads, 0, s>>>(
      delta, gap, valid, tile_scratch, n, lo, hi, depth, rise, fall, change);
  return static_cast<int>(cudaGetLastError());
}

// Edges scan: depth and 0/1 rise, fall streams of lo < depth <= hi inside
// valid.
int gci_edges_scan(const int32_t* delta, const int8_t* valid, int32_t* depth,
                   int8_t* rise, int8_t* fall, uint32_t* tile_scratch,
                   int64_t n, int32_t lo, int32_t hi, int device,
                   void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  int rc = launch_tile_carries(delta, tile_scratch, n, device, s);
  if (rc != 0) return rc;
  edges_scan_tiles_kernel<<<static_cast<unsigned>(tiles_for(n)), kThreads, 0, s>>>(
      delta, valid, tile_scratch, n, lo, hi, depth, rise, fall);
  return static_cast<int>(cudaGetLastError());
}

// The compaction's scratch, in 64-bit words (zeroed by the entry): per
// predicate ceil(n / tile slots) status words, then one word per predicate
// that receives its total.  Tile slots of the two forms:
int gci_compact_flags_tile_slots() { return kFlagTileBytes; }
int gci_compact_runs_tile_slots() { return kRunTileBytes / 4; }

// Flag form: the ascending indices of (x & m) != 0 for the n_masks (1-3)
// masks in the bytes of `masks`, into idx0..idx2 (capacity entries each;
// unused predicates' may be null), and each mask's count into totals (a
// host array).  x is 16-byte aligned.
int gci_compact_flags(const int8_t* x, uint32_t masks, int n_masks,
                      unsigned long long* scratch, int64_t n, int64_t capacity,
                      int64_t* idx0, int64_t* idx1, int64_t* idx2, int device,
                      void* stream, int64_t* totals) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (n_masks) {
    case 1: return launch_compact(FlagForm<1>{x, masks}, n, scratch, capacity, idx0, idx1,
                                  idx2, nullptr, device, s, totals);
    case 2: return launch_compact(FlagForm<2>{x, masks}, n, scratch, capacity, idx0, idx1,
                                  idx2, nullptr, device, s, totals);
    case 3: return launch_compact(FlagForm<3>{x, masks}, n, scratch, capacity, idx0, idx1,
                                  idx2, nullptr, device, s, totals);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Run form: the ascending indices of depth[i] != depth[i-1] (slot 0
// against carry when has_carry, else forced) and their depths (capacity
// entries each), and their count into totals[0].  depth is 16-byte
// aligned.
int gci_compact_runs(const int32_t* depth, int32_t carry, int has_carry,
                     unsigned long long* scratch, int64_t n, int64_t capacity, int64_t* idx,
                     int32_t* vals, int device, void* stream, int64_t* totals) {
  if (n <= 0) return 0;
  return launch_compact(RunForm{depth, carry, has_carry}, n, scratch, capacity, idx, nullptr,
                        nullptr, vals, device, static_cast<cudaStream_t>(stream), totals);
}

}  // extern "C"
