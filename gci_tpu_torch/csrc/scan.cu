// Hopper (sm_90a) kernels of the single-GPU depth path.
//
// Both kernels are an inclusive int32 prefix sum over the concatenated genome
// axis, wrapping mod 2^32, and share one reduce-then-scan skeleton:
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
// words, so a warp moves one contiguous kilobyte per access and the running
// sum of a thread's slots stays in registers.  The prefix just before a
// thread's first slot is the thread's exclusive carry, so the predecessor
// that the epilogue compares against needs no neighbour exchange.
//
// depth_scan replaces gci_tpu/depth/pallas_scan.py:depth_scan (the prefix sum
// behind every on-device compaction).  It is bound by device-memory bytes:
// 4 B in and 4 B out per slot, plus the 4 B/slot re-read of pass 1.  The
// design keeps every access a full 16-byte vector and does no other work.
//
// fused_depth_scan_packed replaces gci_tpu/depth/pallas_scan.py:
// fused_depth_scan_packed (_scan_packed_kernel).  It is bound by device-memory
// bytes: 4 B in and 5 B out per slot (depth plus the flag byte), plus the
// 4 B/slot re-read of pass 1.  Depth, gap mask, issue-interval edges and run
// boundaries are all derived from the one packed prefix in registers, so the
// masked depth and the interval mask never reach device memory.
//
// A single-pass decoupled look-back scan would delete pass 1's re-read; that
// is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // two int4 per thread
constexpr int kTile = kThreads * kItems;
constexpr int kCarryThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

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

__global__ void __launch_bounds__(kThreads)
tile_sums_kernel(const int32_t* __restrict__ in, int64_t n,
                 uint32_t* __restrict__ sums) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  uint32_t v[kItems];
  load_items(in, first, n, v);
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

__global__ void __launch_bounds__(kThreads)
scan_tiles_kernel(const int32_t* __restrict__ in,
                  const uint32_t* __restrict__ carry, int64_t n,
                  int32_t* __restrict__ out) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  uint32_t v[kItems];
  load_items(in, first, n, v);
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) s += v[k];
  uint32_t total;
  uint32_t acc =
      carry[blockIdx.x] + block_exclusive_scan<kThreads>(s, warp_sums, &total);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    acc += v[k];
    v[k] = acc;
  }
  store_items(out, first, n, v);
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
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  uint32_t v[kItems];
  load_items(word, first, n, v);
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) s += v[k];
  uint32_t total;
  // packed prefix just before this thread's first slot: its predecessor
  uint32_t sw =
      carry[blockIdx.x] + block_exclusive_scan<kThreads>(s, warp_sums, &total);
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
  if (first + kItems <= n) {
    *reinterpret_cast<uint2*>(flags + first) = make_uint2(f[0], f[1]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (first + k < n) {
        flags[first + k] = static_cast<int8_t>((f[k >> 2] >> (8 * (k & 3))) & 0xFFu);
      }
    }
  }
}

int launch_tile_carries(const int32_t* in, uint32_t* tile_scratch, int64_t n,
                        int64_t tiles, cudaStream_t stream) {
  tile_sums_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      in, n, tile_scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_carry_kernel<<<1, kCarryThreads, 0, stream>>>(tile_scratch, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Slots per tile: the caller allocates ceil(n / tile) uint32 words of scratch.
int gci_scan_tile_slots() { return kTile; }

const char* gci_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[i] = in[0] + ... + in[i] (mod 2^32).  Returns a cudaError_t.
int gci_depth_scan(const int32_t* in, int32_t* out, uint32_t* tile_scratch,
                   int64_t n, int device, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (n + kTile - 1) / kTile;
  auto s = static_cast<cudaStream_t>(stream);
  int rc = launch_tile_carries(in, tile_scratch, n, tiles, s);
  if (rc != 0) return rc;
  scan_tiles_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      in, tile_scratch, n, out);
  return static_cast<int>(cudaGetLastError());
}

// Packed-word scan: depth (int32) and flag byte (bit0 rise, bit1 fall,
// bit2 change, bit3 in-gap) of word = read_delta<<2 | gap<<1 | valid.
// Returns a cudaError_t.
int gci_packed_scan(const int32_t* word, int32_t* depth, int8_t* flags,
                    uint32_t* tile_scratch, int64_t n, int32_t lo, int32_t hi,
                    int device, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (n + kTile - 1) / kTile;
  auto s = static_cast<cudaStream_t>(stream);
  int rc = launch_tile_carries(word, tile_scratch, n, tiles, s);
  if (rc != 0) return rc;
  packed_scan_tiles_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      word, tile_scratch, n, lo, hi, depth, flags);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
