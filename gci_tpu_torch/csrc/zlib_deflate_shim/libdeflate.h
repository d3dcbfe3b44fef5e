// The subset of libdeflate's API that gci_tpu/native/gci_native.cpp calls,
// implemented on zlib.  Used to build that host codec on machines that have
// zlib but no libdeflate: raw-deflate blocks and CRC-32 are the same formats,
// so every file the codec writes inflates to the same bytes (the compressed
// bytes themselves may differ).
#pragma once

#include <zlib.h>

#include <cstddef>
#include <cstdint>
#include <cstdlib>

enum libdeflate_result {
  LIBDEFLATE_SUCCESS = 0,
  LIBDEFLATE_BAD_DATA = 1,
  LIBDEFLATE_SHORT_OUTPUT = 2,
  LIBDEFLATE_INSUFFICIENT_SPACE = 3,
};

struct libdeflate_decompressor {
  int unused;
};

struct libdeflate_compressor {
  int level;
};

static inline struct libdeflate_decompressor* libdeflate_alloc_decompressor() {
  return static_cast<libdeflate_decompressor*>(
      std::calloc(1, sizeof(libdeflate_decompressor)));
}

static inline void libdeflate_free_decompressor(struct libdeflate_decompressor* d) {
  std::free(d);
}

static inline struct libdeflate_compressor* libdeflate_alloc_compressor(int level) {
  auto* c = static_cast<libdeflate_compressor*>(
      std::calloc(1, sizeof(libdeflate_compressor)));
  if (c) c->level = level < 0 ? 0 : (level > 9 ? 9 : level);  // zlib tops at 9
  return c;
}

static inline void libdeflate_free_compressor(struct libdeflate_compressor* c) {
  std::free(c);
}

// One whole raw-deflate stream in, at most out_nbytes_avail bytes out.
static inline enum libdeflate_result libdeflate_deflate_decompress(
    struct libdeflate_decompressor*, const void* in, size_t in_nbytes,
    void* out, size_t out_nbytes_avail, size_t* actual_out_nbytes_ret) {
  z_stream s{};
  if (inflateInit2(&s, -15) != Z_OK) return LIBDEFLATE_BAD_DATA;
  s.next_in = static_cast<Bytef*>(const_cast<void*>(in));
  s.avail_in = static_cast<uInt>(in_nbytes);
  s.next_out = static_cast<Bytef*>(out);
  s.avail_out = static_cast<uInt>(out_nbytes_avail);
  const int r = inflate(&s, Z_FINISH);
  const size_t produced = s.total_out;
  inflateEnd(&s);
  if (r == Z_STREAM_END) {
    if (actual_out_nbytes_ret) *actual_out_nbytes_ret = produced;
    else if (produced != out_nbytes_avail) return LIBDEFLATE_SHORT_OUTPUT;
    return LIBDEFLATE_SUCCESS;
  }
  return r == Z_BUF_ERROR && s.avail_out == 0 ? LIBDEFLATE_INSUFFICIENT_SPACE
                                              : LIBDEFLATE_BAD_DATA;
}

// Raw-deflate compress; returns the compressed size, or 0 if it did not fit.
static inline size_t libdeflate_deflate_compress(struct libdeflate_compressor* c,
                                                 const void* in, size_t in_nbytes,
                                                 void* out,
                                                 size_t out_nbytes_avail) {
  z_stream s{};
  if (deflateInit2(&s, c->level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK) {
    return 0;
  }
  s.next_in = static_cast<Bytef*>(const_cast<void*>(in));
  s.avail_in = static_cast<uInt>(in_nbytes);
  s.next_out = static_cast<Bytef*>(out);
  s.avail_out = static_cast<uInt>(out_nbytes_avail);
  const int r = deflate(&s, Z_FINISH);
  const size_t produced = s.total_out;
  deflateEnd(&s);
  return r == Z_STREAM_END ? produced : 0;
}

static inline uint32_t libdeflate_crc32(uint32_t crc, const void* buffer, size_t len) {
  return static_cast<uint32_t>(
      crc32_z(crc, static_cast<const Bytef*>(buffer), len));
}
