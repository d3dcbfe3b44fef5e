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

// One 64-bit store of (state, value), ordered after every earlier write of
// the thread.
__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned long long state,
                                        uint32_t value) {
  const unsigned long long w = (state << 32) | value;
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(word), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long observe(const unsigned long long* word) {
  unsigned long long w;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(w) : "l"(word) : "memory");
  return w;
}

// Exclusive prefix of tile `tile` (> 0), by one whole warp, from the status
// words of its predecessors: lane l reads tile pred - l, nearest first.  The
// warp sums the words up to the nearest inclusive prefix, re-reading any
// of those still invalid until its tile has published; it never waits on a
// word past that prefix.  Returned in every lane.
__device__ __forceinline__ uint32_t look_back(const unsigned long long* status,
                                              int64_t tile) {
  const int lane = threadIdx.x & 31;
  uint32_t exclusive = 0;
  for (int64_t pred = tile - 1;; pred -= 32) {
    const int64_t idx = pred - lane;
    // before tile 0 there is nothing: an inclusive prefix of 0
    unsigned long long w = idx >= 0 ? observe(status + idx) : kTileInclusive << 32;
    unsigned inclusive;
    int last;
    while (true) {
      inclusive = __ballot_sync(kFull, (w >> 32) == kTileInclusive);
      last = inclusive ? __ffs(inclusive) - 1 : 31;
      const bool waiting = lane <= last && (w >> 32) == 0;
      if (!__any_sync(kFull, waiting)) break;
      if (waiting) w = observe(status + idx);
    }
    uint32_t v = lane <= last ? static_cast<uint32_t>(w) : 0u;
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
      const uint32_t exclusive = look_back(status, tile);
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
// one call.  Two forms, each a template instance of the same kernels:
//
//   * flag form: one int8 stream x and up to three bit masks m; the
//     predicate is (x & m) != 0;
//   * run form: one int32 depth; the predicate is depth[i] != depth[i-1],
//     slot 0 compared against a carry, or forced when there is none.  It
//     writes each run's depth beside its index.
//
// Bound by device-memory bytes: 1 B/slot in for the flag form, 4 for the
// run form, plus 8 B (index) or 12 B (index and depth) per set slot out.
// The outputs are exactly sized, so their size must be known before they
// are written, and the caller learns it in one host sync:
//
//   1. compact_count_kernel  one block per tile ranks each predicate's set
//                            slots and writes the tile's count; when the
//                            tile holds at most kCache of them, it keeps
//                            their tile-local offsets (and, run form, their
//                            depths) in the tile's own scratch;
//   2. compact_carry_kernel  one block per predicate scans the tile counts
//                            into exclusive offsets, in place, and writes
//                            the total after them; the host reads the
//                            totals and allocates the outputs;
//   3. compact_write_kernel  one block per tile copies its kept entries to
//                            its offset; a tile that held more than kCache
//                            set slots re-reads its input and ranks again.
//
// So the input is read once where set slots are sparser than one in
// kTileSlots / kCache (1/128 for both forms; MH63's depth has one run
// boundary per ~1,000 slots, a 58x human one about one per 170), and twice
// in the tiles past that.  Scratch is per tile only: a 64-bit count and
// kCache 16-bit offsets (run form: and kCache depths) per tile and
// predicate, about 0.05 B per slot; no per-slot buffer, no prefix.
//
// Each warp owns kCompactCols consecutive columns of its tile, and lane l
// loads the 16 bytes at 16 l of each column, so a warp access is one
// contiguous 512-byte block.  A lane's slots become one bit each (the flag
// form tests four bytes per word at once).  A set slot's rank in its warp is
// the popcount of its lane's bits below it plus the set slots of the lanes
// before it, which a bit-sliced ballot gives: bit b of the lanes' counts is
// one __ballot_sync, of which the lanes before lane l hold
// popc(ballot & lanemask_lt) << b.  Across the warps of a tile, a
// shared-memory scan of the warp totals.  Each column's set slots are staged
// in shared memory at their ranks and then written by consecutive lanes, so
// a dense column's indices leave as contiguous stores, not one lane's run
// after another.

constexpr int kCompactThreads = 256;
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kCompactCols = 8;

// Bits 0-3: whether byte k of (w & mrep) is nonzero, for the four bytes of w.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w, uint32_t mrep) {
  const uint32_t t = w & mrep;
  // bit 7 of each byte: its low seven bits nonzero (no carry leaves a
  // byte: 0x7F + 0x7F < 0x100), or its own bit 7
  const uint32_t hi = (((t & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | t) & 0x80808080u;
  // bits 0, 8, 16, 24 gathered into bits 28-31
  return ((hi >> 7) * 0x10204080u) >> 28;
}

// Flag form over NS masks (byte s of `masks` is stream s's mask, 1-255).
template <int NS>
struct FlagForm {
  static constexpr int kStreams = NS;
  static constexpr int kLaneSlots = 16;  // one 16-byte load per column
  static constexpr int kCountBits = 5;   // a lane's count is 0..16
  static constexpr int kColSlots = 32 * kLaneSlots;
  static constexpr int kWarpSlots = kCompactCols * kColSlots;
  static constexpr int kTileSlots = kCompactWarps * kWarpSlots;
  static constexpr int kCache = 256;
  static constexpr bool kValues = false;
  struct Vals {};

  const int8_t* x;
  uint32_t masks;

  // bits[c][s]: bit j is slot warp_first + kColSlots * c + 16 * lane + j
  // under mask s; slots at or past n are clear.
  __device__ __forceinline__ void load(int64_t warp_first, int64_t n,
                                       uint32_t (&bits)[kCompactCols][NS],
                                       Vals&) const {
    const int lane = threadIdx.x & 31;
    uint4 w[kCompactCols];
    if (warp_first + kWarpSlots <= n) {
#pragma unroll
      for (int c = 0; c < kCompactCols; ++c) {
        w[c] = __ldg(reinterpret_cast<const uint4*>(x + warp_first + kColSlots * c + 16 * lane));
      }
    } else {
#pragma unroll
      for (int c = 0; c < kCompactCols; ++c) {
        const int64_t first = warp_first + kColSlots * c + 16 * lane;
        uint32_t b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (first + j < n) {
            b[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(x[first + j]))
                         << (8 * (j & 3));
          }
        }
        w[c] = make_uint4(b[0], b[1], b[2], b[3]);
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const uint32_t mrep = ((masks >> (8 * s)) & 0xFFu) * 0x01010101u;
#pragma unroll
      for (int c = 0; c < kCompactCols; ++c) {
        bits[c][s] = nonzero_bytes(w[c].x, mrep) | (nonzero_bytes(w[c].y, mrep) << 4) |
                     (nonzero_bytes(w[c].z, mrep) << 8) | (nonzero_bytes(w[c].w, mrep) << 12);
      }
    }
  }

  __device__ __forceinline__ static int32_t value(const Vals&, int, int) { return 0; }
};

// Run form: the run boundaries of an int32 depth.
struct RunForm {
  static constexpr int kStreams = 1;
  static constexpr int kLaneSlots = 4;  // one 16-byte load per column
  static constexpr int kCountBits = 3;  // a lane's count is 0..4
  static constexpr int kColSlots = 32 * kLaneSlots;
  static constexpr int kWarpSlots = kCompactCols * kColSlots;
  static constexpr int kTileSlots = kCompactWarps * kWarpSlots;
  static constexpr int kCache = 64;
  static constexpr bool kValues = true;
  struct Vals {
    uint32_t v[kCompactCols][4];
  };

  const int32_t* depth;
  int32_t carry;  // the depth before slot 0, when has_carry
  int has_carry;

  __device__ __forceinline__ void load(int64_t warp_first, int64_t n,
                                       uint32_t (&bits)[kCompactCols][1],
                                       Vals& vals) const {
    const int lane = threadIdx.x & 31;
    auto& v = vals.v;
    if (warp_first + kWarpSlots <= n) {
#pragma unroll
      for (int c = 0; c < kCompactCols; ++c) {
        const int4 q =
            __ldg(reinterpret_cast<const int4*>(depth + warp_first + kColSlots * c + 4 * lane));
        v[c][0] = q.x; v[c][1] = q.y; v[c][2] = q.z; v[c][3] = q.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < kCompactCols; ++c) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int64_t i = warp_first + kColSlots * c + 4 * lane + k;
          v[c][k] = i < n ? static_cast<uint32_t>(depth[i]) : 0u;
        }
      }
    }
    // the depth just before the warp's first slot
    uint32_t prev_col_last = 0u;
    bool forced = false;
    if (warp_first > 0) {
      if (warp_first <= n) prev_col_last = static_cast<uint32_t>(depth[warp_first - 1]);
    } else if (has_carry) {
      prev_col_last = static_cast<uint32_t>(carry);
    } else {
      forced = true;
    }
#pragma unroll
    for (int c = 0; c < kCompactCols; ++c) {
      const uint32_t up = __shfl_up_sync(kFull, v[c][3], 1);
      uint32_t prev = lane == 0 ? prev_col_last : up;
      uint32_t b = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        b |= static_cast<uint32_t>(v[c][k] != prev) << k;
        prev = v[c][k];
      }
      prev_col_last = __shfl_sync(kFull, v[c][3], 31);
      const int64_t first = warp_first + kColSlots * c + 4 * lane;
      if (first + 4 > n) b &= first >= n ? 0u : (1u << (n - first)) - 1u;
      bits[c][0] = b;
    }
    if (forced && lane == 0) bits[0][0] |= 1u;
  }

  // slot j of the lane's column c, by selects (a runtime index into the
  // register array would put it in local memory)
  __device__ __forceinline__ static int32_t value(const Vals& vals, int c, int j) {
    const uint32_t* v = vals.v[c];
    return static_cast<int32_t>(j == 0 ? v[0] : j == 1 ? v[1] : j == 2 ? v[2] : v[3]);
  }
};

// The per-tile scratch of one call, carved from one buffer: per predicate a
// row of n_tiles + 1 64-bit words (counts, then exclusive offsets and the
// total), then kCache 16-bit tile-local offsets per tile and predicate,
// then (run form) kCache depths per tile.
template <class Form>
struct CompactScratch {
  unsigned long long* counts;
  uint16_t* cache;
  int32_t* vcache;
  int64_t n_tiles;

  __host__ __device__ static int64_t tiles(int64_t n) {
    return (n + Form::kTileSlots - 1) / Form::kTileSlots;
  }
  // 64-bit words of scratch for n slots
  __host__ __device__ static int64_t words(int64_t n) {
    const int64_t t = tiles(n);
    const int64_t cache_bytes = Form::kStreams * t * Form::kCache * 2 +
                                (Form::kValues ? t * Form::kCache * 4 : 0);
    return Form::kStreams * (t + 1) + (cache_bytes + 7) / 8;
  }
  __host__ __device__ static CompactScratch carve(void* base, int64_t n) {
    CompactScratch sc;
    sc.n_tiles = tiles(n);
    sc.counts = static_cast<unsigned long long*>(base);
    sc.cache = reinterpret_cast<uint16_t*>(sc.counts + Form::kStreams * (sc.n_tiles + 1));
    sc.vcache = reinterpret_cast<int32_t*>(sc.cache +
                                           Form::kStreams * sc.n_tiles * Form::kCache);
    return sc;
  }
  __device__ __forceinline__ unsigned long long* row(int s) const {
    return counts + s * (n_tiles + 1);
  }
};

template <class Form>
__device__ __forceinline__ int64_t compact_warp_first() {
  return static_cast<int64_t>(blockIdx.x) * Form::kTileSlots +
         static_cast<int64_t>(threadIdx.x >> 5) * Form::kWarpSlots;
}

// Each warp's set slots per stream into warp_counts[s][warp]; one barrier.
template <class Form>
__device__ __forceinline__ void warp_totals(const uint32_t (&bits)[kCompactCols][Form::kStreams],
                                            uint32_t (*warp_counts)[kCompactWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < Form::kStreams; ++s) {
    uint32_t c = 0u;
#pragma unroll
    for (int col = 0; col < kCompactCols; ++col) c += __popc(bits[col][s]);
    c = __reduce_add_sync(kFull, c);
    if (lane == 0) warp_counts[s][warp] = c;
  }
  __syncthreads();
}

// Calls put(pos, c, offset, value) for every set slot of stream s, in
// order: pos = base + its rank in the warp, c its column, offset its place
// in the column and value its slot's Form::value.  Each column's set slots
// are ranked by ballots and staged in the warp's shared-memory rows
// (kColSlots entries each), then handed to put by consecutive lanes, so the
// writes put makes are contiguous.  Every lane of the warp must call it.
template <class Form, class Put>
__device__ __forceinline__ void emit_ranked(const uint32_t (&bits)[kCompactCols][Form::kStreams],
                                            const typename Form::Vals& vals, int s,
                                            unsigned long long base, uint16_t* stage,
                                            int32_t* vstage, Put put) {
  const int lane = threadIdx.x & 31;
  const uint32_t lanes_before = (1u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < kCompactCols; ++c) {
    const uint32_t b = bits[c][s];
    const uint32_t cnt = __popc(b);
    uint32_t before = 0u, col_total = 0u;
#pragma unroll
    for (int k = 0; k < Form::kCountBits; ++k) {
      const uint32_t ballot = __ballot_sync(kFull, (cnt >> k) & 1u);
      before += static_cast<uint32_t>(__popc(ballot & lanes_before)) << k;
      col_total += static_cast<uint32_t>(__popc(ballot)) << k;
    }
    if (col_total == 0u) continue;  // the same in every lane
    uint32_t at = before;
    for (uint32_t m = b; m != 0u; m &= m - 1u, ++at) {
      const int j = __ffs(m) - 1;
      stage[at] = static_cast<uint16_t>(Form::kLaneSlots * lane + j);
      if (Form::kValues) vstage[at] = Form::value(vals, c, j);
    }
    __syncwarp();
    for (uint32_t i = lane; i < col_total; i += 32) {
      put(base + i, c, stage[i], Form::kValues ? vstage[i] : 0);
    }
    __syncwarp();
    base += col_total;
  }
}

// Pass 1: each tile's set slots per stream, and, where they are at most
// kCache, their tile-local offsets (and depths) in the tile's scratch.
template <class Form>
__global__ void __launch_bounds__(kCompactThreads)
compact_count_kernel(const Form f, int64_t n, const CompactScratch<Form> sc) {
  constexpr int NS = Form::kStreams;
  __shared__ uint32_t warp_counts[NS][kCompactWarps];
  __shared__ uint16_t stage[kCompactWarps][Form::kColSlots];
  __shared__ int32_t vstage[kCompactWarps][Form::kValues ? Form::kColSlots : 1];
  const int warp = threadIdx.x >> 5;
  const int64_t warp_first = compact_warp_first<Form>();
  uint32_t bits[kCompactCols][NS];
  typename Form::Vals vals;
  f.load(warp_first, n, bits, vals);
  warp_totals<Form>(bits, warp_counts);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    uint32_t total = 0u, before = 0u;
#pragma unroll
    for (int w = 0; w < kCompactWarps; ++w) {
      const uint32_t c = warp_counts[s][w];
      total += c;
      if (w < warp) before += c;
    }
    if (threadIdx.x == 0) sc.row(s)[blockIdx.x] = total;
    if (total <= Form::kCache) {  // the same in every thread of the block
      uint16_t* cache = sc.cache + (s * sc.n_tiles + blockIdx.x) * Form::kCache;
      int32_t* vcache = sc.vcache + static_cast<int64_t>(blockIdx.x) * Form::kCache;
      emit_ranked<Form>(bits, vals, s, before, stage[warp], vstage[warp],
                        [&](unsigned long long pos, int c, int offset, int32_t value) {
        cache[pos] = static_cast<uint16_t>(warp * Form::kWarpSlots + Form::kColSlots * c + offset);
        if (Form::kValues) vcache[pos] = value;
      });
    }
  }
}

// Pass 2: row blockIdx.x of the counts (n_tiles words) scanned into
// exclusive offsets in place, by one block; the row's sum goes after them.
__global__ void __launch_bounds__(kCarryThreads)
compact_carry_kernel(unsigned long long* __restrict__ counts, int64_t n_tiles) {
  static_assert(kCarryThreads == 1024, "one warp scans the 32 warp sums");
  __shared__ unsigned long long warp_sums[32];
  unsigned long long* row = counts + blockIdx.x * (n_tiles + 1);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long running = 0;
  for (int64_t base = 0; base < n_tiles;
       base += static_cast<int64_t>(kCarryThreads) * kItems) {
    const int64_t first = base + static_cast<int64_t>(threadIdx.x) * kItems;
    unsigned long long v[kItems];
    unsigned long long s = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      v[k] = first + k < n_tiles ? row[first + k] : 0ull;
      s += v[k];
    }
    unsigned long long inc = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      unsigned long long w = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned long long y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    unsigned long long acc = running + (warp ? warp_sums[warp - 1] : 0ull) + inc - s;
    const unsigned long long total = warp_sums[31];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (first + k < n_tiles) row[first + k] = acc;
      acc += v[k];
    }
    running += total;
  }
  if (threadIdx.x == 0) row[n_tiles] = running;
}

// Pass 3: each set slot's index (and, run form, its depth) at the tile's
// offset plus its rank in the tile: copied from the tile's scratch, or,
// where pass 1 kept none, ranked again from the input.
template <class Form>
__global__ void __launch_bounds__(kCompactThreads)
compact_write_kernel(const Form f, int64_t n, const CompactScratch<Form> sc,
                     int64_t* __restrict__ idx0, int64_t* __restrict__ idx1,
                     int64_t* __restrict__ idx2, int32_t* __restrict__ vals_out) {
  constexpr int NS = Form::kStreams;
  __shared__ uint32_t warp_counts[NS][kCompactWarps];
  const int64_t tile = blockIdx.x;
  const int64_t tile_first = tile * Form::kTileSlots;
  bool kept = true;
#pragma unroll
  for (int s = 0; s < NS; ++s) kept &= sc.row(s)[tile + 1] - sc.row(s)[tile] <= Form::kCache;
  if (kept) {  // the same in every thread of the block
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      int64_t* out = s == 0 ? idx0 : s == 1 ? idx1 : idx2;
      const unsigned long long base = sc.row(s)[tile];
      const int count = static_cast<int>(sc.row(s)[tile + 1] - base);
      const uint16_t* cache = sc.cache + (s * sc.n_tiles + tile) * Form::kCache;
      for (int i = threadIdx.x; i < count; i += kCompactThreads) {
        out[base + i] = tile_first + cache[i];
        if (Form::kValues) vals_out[base + i] = sc.vcache[tile * Form::kCache + i];
      }
    }
    return;
  }
  __shared__ uint16_t stage[kCompactWarps][Form::kColSlots];
  __shared__ int32_t vstage[kCompactWarps][Form::kValues ? Form::kColSlots : 1];
  const int warp = threadIdx.x >> 5;
  const int64_t warp_first = compact_warp_first<Form>();
  uint32_t bits[kCompactCols][NS];
  typename Form::Vals vals;
  f.load(warp_first, n, bits, vals);
  warp_totals<Form>(bits, warp_counts);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    int64_t* out = s == 0 ? idx0 : s == 1 ? idx1 : idx2;
    unsigned long long base = sc.row(s)[tile];
    for (int w = 0; w < warp; ++w) base += warp_counts[s][w];
    emit_ranked<Form>(bits, vals, s, base, stage[warp], vstage[warp],
                      [&](unsigned long long pos, int c, int offset, int32_t value) {
      out[pos] = warp_first + Form::kColSlots * c + offset;
      if (Form::kValues) vals_out[pos] = value;
    });
  }
}

// Passes 1 and 2 over scratch of CompactScratch<Form>::words(n) words.
template <class Form>
int launch_compact_count(const Form& f, void* scratch, int64_t n, int device,
                         cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto sc = CompactScratch<Form>::carve(scratch, n);
  compact_count_kernel<Form><<<static_cast<unsigned>(sc.n_tiles), kCompactThreads, 0, stream>>>(
      f, n, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_carry_kernel<<<Form::kStreams, kCarryThreads, 0, stream>>>(sc.counts, sc.n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// Pass 3, after launch_compact_count on the same scratch.
template <class Form>
int launch_compact_write(const Form& f, void* scratch, int64_t n, int64_t* idx0,
                         int64_t* idx1, int64_t* idx2, int32_t* vals, int device,
                         cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto sc = CompactScratch<Form>::carve(scratch, n);
  compact_write_kernel<Form><<<static_cast<unsigned>(sc.n_tiles), kCompactThreads, 0, stream>>>(
      f, n, sc, idx0, idx1, idx2, vals);
  return static_cast<int>(cudaGetLastError());
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

// The compaction's scratch, in 64-bit words, for n slots and n_masks masks
// (flag form) or for the run form: per predicate n_tiles + 1 words of counts,
// offsets and the total (the total of predicate s is word
// s * (n_tiles + 1) + n_tiles), then the tiles' kept entries.
int64_t gci_compact_flags_scratch_words(int64_t n, int n_masks) {
  switch (n_masks) {
    case 1: return CompactScratch<FlagForm<1>>::words(n);
    case 2: return CompactScratch<FlagForm<2>>::words(n);
    case 3: return CompactScratch<FlagForm<3>>::words(n);
    default: return -1;
  }
}
int64_t gci_compact_runs_scratch_words(int64_t n) { return CompactScratch<RunForm>::words(n); }

// Slots per tile of the two forms.
int gci_compact_flags_tile_slots() { return FlagForm<1>::kTileSlots; }
int gci_compact_runs_tile_slots() { return RunForm::kTileSlots; }

// Flag form, passes 1 and 2: the counts of (x & m) != 0 for the n_masks
// (1-3) masks in the bytes of `masks`.  x is 16-byte aligned.
int gci_compact_flags_count(const int8_t* x, uint32_t masks, int n_masks, void* scratch,
                            int64_t n, int device, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (n_masks) {
    case 1: return launch_compact_count(FlagForm<1>{x, masks}, scratch, n, device, s);
    case 2: return launch_compact_count(FlagForm<2>{x, masks}, scratch, n, device, s);
    case 3: return launch_compact_count(FlagForm<3>{x, masks}, scratch, n, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Flag form, pass 3: the ascending indices under each mask into idx0..idx2
// (exactly sized by the totals; unused streams may be null).
int gci_compact_flags_write(const int8_t* x, uint32_t masks, int n_masks, void* scratch,
                            int64_t n, int64_t* idx0, int64_t* idx1, int64_t* idx2,
                            int device, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (n_masks) {
    case 1: return launch_compact_write(FlagForm<1>{x, masks}, scratch, n, idx0, idx1, idx2,
                                        nullptr, device, s);
    case 2: return launch_compact_write(FlagForm<2>{x, masks}, scratch, n, idx0, idx1, idx2,
                                        nullptr, device, s);
    case 3: return launch_compact_write(FlagForm<3>{x, masks}, scratch, n, idx0, idx1, idx2,
                                        nullptr, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Run form, passes 1 and 2: the count of depth[i] != depth[i-1] (slot 0
// against carry when has_carry, else forced).  depth is 16-byte aligned.
int gci_compact_runs_count(const int32_t* depth, int32_t carry, int has_carry, void* scratch,
                           int64_t n, int device, void* stream) {
  if (n <= 0) return 0;
  return launch_compact_count(RunForm{depth, carry, has_carry}, scratch, n, device,
                              static_cast<cudaStream_t>(stream));
}

// Run form, pass 3: the boundaries' ascending indices and their depths.
int gci_compact_runs_write(const int32_t* depth, int32_t carry, int has_carry, void* scratch,
                           int64_t n, int64_t* idx, int32_t* vals, int device, void* stream) {
  if (n <= 0) return 0;
  return launch_compact_write(RunForm{depth, carry, has_carry}, scratch, n, idx, nullptr,
                              nullptr, vals, device, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
