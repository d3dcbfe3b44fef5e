// gci_native — C++ host-side packer/codec for the gci_tpu framework.
//
// TPU-native replacement for the reference's host toolchain (pysam/htslib
// decode loops, gzip text codecs, subprocessed `samtools`/`cat`):
//   * streaming gzip/BGZF inflate (multi-member aware, multithreaded BGZF)
//   * .depth.gz text codec (reference format: ">target\n" + one int per line;
//     spec GCI.py:113-117, utility/GCI_score.py:11-39)
//   * BAM record scan -> packed fixed-width record tensors for device upload
//     (behavioral spec for per-record fields: GCI.py:146-169)
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// Every hot loop is single-pass and allocation-light; BGZF blocks decompress
// on a thread pool.

#include <libdeflate.h>
#include <zlib.h>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#define GCI_API extern "C" __attribute__((visibility("default")))

namespace {

struct Buffer {
  std::vector<uint8_t> data;
};

// ---------------------------------------------------------------------------
// file slurp
// ---------------------------------------------------------------------------
static bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize((size_t)n);
  size_t got = fread(out.data(), 1, (size_t)n, f);
  fclose(f);
  return got == (size_t)n;
}

// ---------------------------------------------------------------------------
// gzip inflate (streaming, multi-member)
// ---------------------------------------------------------------------------
static bool gzip_inflate_all(const uint8_t* src, size_t n,
                             std::vector<uint8_t>& out) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 15 + 32) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = (uInt)n;
  std::vector<uint8_t> chunk(1 << 22);
  while (true) {
    zs.next_out = chunk.data();
    zs.avail_out = (uInt)chunk.size();
    int ret = inflate(&zs, Z_NO_FLUSH);
    size_t produced = chunk.size() - zs.avail_out;
    out.insert(out.end(), chunk.data(), chunk.data() + produced);
    if (ret == Z_STREAM_END) {
      if (zs.avail_in == 0) break;
      // concatenated member
      if (inflateReset2(&zs, 15 + 32) != Z_OK) {
        inflateEnd(&zs);
        return false;
      }
      continue;
    }
    if (ret != Z_OK) {
      inflateEnd(&zs);
      return false;
    }
    if (zs.avail_in == 0 && produced == 0) break;  // truncated input
  }
  inflateEnd(&zs);
  return true;
}

// ---------------------------------------------------------------------------
// depth file decode
// ---------------------------------------------------------------------------
struct DepthFile {
  std::vector<std::string> names;
  std::vector<int64_t> offsets;  // per-target start into values; size = n+1
  std::vector<int64_t> values;
  std::string error;
};

static DepthFile* depth_decode_text(const uint8_t* p, size_t n) {
  auto* df = new DepthFile();
  df->values.reserve(n / 2);
  size_t i = 0;
  bool seen_header = false;
  while (i < n) {
    if (p[i] == '>') {
      size_t j = i + 1;
      while (j < n && p[j] != '\n') j++;
      size_t e = j;
      while (e > i + 1 && (p[e - 1] == '\r' || p[e - 1] == ' ')) e--;
      // reference takes the text after the last '>' (GCI_score.py:32)
      size_t s = i + 1;
      for (size_t k = e; k > i + 1; k--) {
        if (p[k - 1] == '>') { s = k; break; }
      }
      df->names.emplace_back(reinterpret_cast<const char*>(p) + s, e - s);
      df->offsets.push_back((int64_t)df->values.size());
      seen_header = true;
      i = j + 1;
    } else if (p[i] == '\n' || p[i] == '\r') {
      i++;
    } else {
      if (!seen_header) {
        df->error = "depth file has no '>' target header";
        return df;
      }
      int64_t v = 0;
      while (i < n && p[i] >= '0' && p[i] <= '9') {
        v = v * 10 + (p[i] - '0');
        i++;
      }
      while (i < n && p[i] != '\n') i++;
      if (i < n) i++;
      df->values.push_back(v);
    }
  }
  df->offsets.push_back((int64_t)df->values.size());
  return df;
}

// ---------------------------------------------------------------------------
// gzip deflate helper (single member, like Python's gzip.compress)
// ---------------------------------------------------------------------------
static bool gzip_deflate_all(const uint8_t* src, size_t n, int level,
                             std::vector<uint8_t>& out) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, level, Z_DEFLATED, 15 + 16, 8, Z_DEFAULT_STRATEGY) !=
      Z_OK)
    return false;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = (uInt)n;
  std::vector<uint8_t> chunk(1 << 22);
  int ret = Z_OK;
  do {
    zs.next_out = chunk.data();
    zs.avail_out = (uInt)chunk.size();
    ret = deflate(&zs, zs.avail_in ? Z_NO_FLUSH : Z_FINISH);
    size_t produced = chunk.size() - zs.avail_out;
    out.insert(out.end(), chunk.data(), chunk.data() + produced);
  } while (ret != Z_STREAM_END);
  deflateEnd(&zs);
  return true;
}

// ---------------------------------------------------------------------------
// BGZF framing (shared by BAM and BGZF-framed depth files)
// ---------------------------------------------------------------------------
struct BgzfBlock {
  size_t comp_off;    // offset of deflate payload in file
  uint32_t comp_len;  // deflate payload length
  uint32_t isize;     // uncompressed size
  size_t out_off;     // offset in the output buffer
};

// Scan BGZF framing; returns false if not BGZF.
static bool bgzf_scan(const uint8_t* p, size_t n, std::vector<BgzfBlock>& blocks,
                      size_t& total_out) {
  size_t off = 0;
  total_out = 0;
  while (off + 18 <= n) {
    if (!(p[off] == 0x1f && p[off + 1] == 0x8b && p[off + 2] == 8 &&
          (p[off + 3] & 4)))
      return false;
    uint16_t xlen = (uint16_t)(p[off + 10] | (p[off + 11] << 8));
    size_t xs = off + 12;
    size_t xe = xs + xlen;
    if (xe > n) return false;
    uint32_t bsize = 0;
    bool found = false;
    for (size_t q = xs; q + 4 <= xe;) {
      uint8_t si1 = p[q], si2 = p[q + 1];
      uint16_t slen = (uint16_t)(p[q + 2] | (p[q + 3] << 8));
      if (si1 == 66 && si2 == 67 && slen == 2) {
        bsize = (uint32_t)(p[q + 4] | (p[q + 5] << 8)) + 1u;
        found = true;
      }
      q += 4 + slen;
    }
    if (!found) return false;
    size_t block_end = off + bsize;
    if (block_end > n) return false;
    uint32_t isize = (uint32_t)(p[block_end - 4] | (p[block_end - 3] << 8) |
                                (p[block_end - 2] << 16) |
                                (uint32_t)(p[block_end - 1] << 24));
    BgzfBlock b;
    b.comp_off = xe;
    b.comp_len = (uint32_t)(block_end - 8 - xe);
    b.isize = isize;
    b.out_off = total_out;
    total_out += isize;
    blocks.push_back(b);
    off = block_end;
  }
  return off == n;
}

// One libdeflate (de)compressor per thread, reused across blocks: allocation
// is the expensive part and BGZF blocks are single-shot raw-deflate members,
// libdeflate's ideal case (~2.7x faster than zlib inflate on this host).
static struct libdeflate_decompressor* tl_decompressor() {
  static thread_local struct libdeflate_decompressor* d = nullptr;
  if (!d) d = libdeflate_alloc_decompressor();
  return d;
}

static struct libdeflate_compressor* tl_compressor(int level) {
  static thread_local struct libdeflate_compressor* c = nullptr;
  static thread_local int c_level = -1;
  if (!c || c_level != level) {
    if (c) libdeflate_free_compressor(c);
    c = libdeflate_alloc_compressor(level);
    c_level = level;
  }
  return c;
}

static bool inflate_raw(const uint8_t* src, uint32_t srclen, uint8_t* dst,
                        uint32_t dstlen) {
  size_t actual = 0;
  enum libdeflate_result r = libdeflate_deflate_decompress(
      tl_decompressor(), src, srclen, dst, dstlen, &actual);
  return r == LIBDEFLATE_SUCCESS && actual == dstlen;
}

// Decompress all BGZF blocks with a thread pool.
static bool bgzf_decompress_parallel(const uint8_t* file,
                                     const std::vector<BgzfBlock>& blocks,
                                     uint8_t* out, int nthreads) {
  std::atomic<size_t> next(0);
  std::atomic<bool> ok(true);
  auto worker = [&]() {
    while (true) {
      size_t i = next.fetch_add(1);
      if (i >= blocks.size() || !ok.load()) break;
      const BgzfBlock& b = blocks[i];
      if (b.isize == 0) continue;
      if (!inflate_raw(file + b.comp_off, b.comp_len, out + b.out_off,
                       b.isize))
        ok.store(false);
    }
  };
  if (nthreads <= 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < nthreads; t++) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  }
  return ok.load();
}

}  // namespace

// ===========================================================================
// C ABI: generic buffers
// ===========================================================================
GCI_API void* gci_buffer_new() { return new Buffer(); }
GCI_API void gci_buffer_free(void* h) { delete (Buffer*)h; }
GCI_API const uint8_t* gci_buffer_data(void* h) {
  return ((Buffer*)h)->data.data();
}
GCI_API int64_t gci_buffer_size(void* h) {
  return (int64_t)((Buffer*)h)->data.size();
}

GCI_API void* gci_gzip_decompress_file(const char* path) {
  std::vector<uint8_t> raw;
  if (!read_file(path, raw)) return nullptr;
  auto* b = new Buffer();
  if (!gzip_inflate_all(raw.data(), raw.size(), b->data)) {
    delete b;
    return nullptr;
  }
  return b;
}

GCI_API void* gci_gzip_compress(const uint8_t* data, int64_t n, int level) {
  auto* b = new Buffer();
  if (!gzip_deflate_all(data, (size_t)n, level, b->data)) {
    delete b;
    return nullptr;
  }
  return b;
}

// ===========================================================================
// C ABI: depth file
// ===========================================================================
GCI_API void* gci_depth_decode_file(const char* path, int nthreads) {
  const bool dbg = getenv("GCI_NATIVE_DEBUG") != nullptr;
  auto now = []() {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  };
  double t0 = now();
  std::vector<uint8_t> raw;
  if (!read_file(path, raw)) return nullptr;
  const uint8_t* p = raw.data();
  size_t n = raw.size();
  std::vector<uint8_t> inflated;
  if (n >= 2 && p[0] == 0x1f && p[1] == 0x8b) {
    // BGZF-framed files (our own writer) decompress in parallel; plain gzip
    // members (reference writer) fall back to serial streaming inflate.
    std::vector<BgzfBlock> blocks;
    size_t total = 0;
    if (bgzf_scan(p, n, blocks, total)) {
      if (dbg) fprintf(stderr, "[gci_native] bgzf blocks=%zu\n", blocks.size());
      inflated.resize(total);
      if (!bgzf_decompress_parallel(p, blocks, inflated.data(), nthreads))
        return nullptr;
    } else if (!gzip_inflate_all(p, n, inflated)) {
      return nullptr;
    } else if (dbg) {
      fprintf(stderr, "[gci_native] serial gzip inflate\n");
    }
    p = inflated.data();
    n = inflated.size();
  }
  double t1 = now();
  auto* r = depth_decode_text(p, n);
  if (dbg)
    fprintf(stderr, "[gci_native] inflate %.2fs parse %.2fs\n", t1 - t0,
            now() - t1);
  return r;
}

GCI_API void gci_depth_free(void* h) { delete (DepthFile*)h; }
GCI_API const char* gci_depth_error(void* h) {
  auto* df = (DepthFile*)h;
  return df->error.empty() ? nullptr : df->error.c_str();
}
GCI_API int64_t gci_depth_num_targets(void* h) {
  return (int64_t)((DepthFile*)h)->names.size();
}
GCI_API const char* gci_depth_target_name(void* h, int64_t i) {
  return ((DepthFile*)h)->names[(size_t)i].c_str();
}
GCI_API int64_t gci_depth_target_len(void* h, int64_t i) {
  auto* df = (DepthFile*)h;
  return df->offsets[(size_t)i + 1] - df->offsets[(size_t)i];
}
GCI_API void gci_depth_copy_target(void* h, int64_t i, int64_t* out) {
  auto* df = (DepthFile*)h;
  int64_t s = df->offsets[(size_t)i];
  int64_t e = df->offsets[(size_t)i + 1];
  memcpy(out, df->values.data() + s, (size_t)(e - s) * sizeof(int64_t));
}

// Encode int64 values to "v\n" text lines. Returns a Buffer handle.
GCI_API void* gci_depth_encode_lines(const int64_t* vals, int64_t n) {
  auto* b = new Buffer();
  b->data.reserve((size_t)n * 3);
  char tmp[24];
  for (int64_t i = 0; i < n; i++) {
    int64_t v = vals[i];
    int len = 0;
    if (v == 0) {
      tmp[len++] = '0';
    } else {
      char rev[24];
      int r = 0;
      while (v > 0) {
        rev[r++] = (char)('0' + (v % 10));
        v /= 10;
      }
      while (r > 0) tmp[len++] = rev[--r];
    }
    tmp[len++] = '\n';
    b->data.insert(b->data.end(), tmp, tmp + len);
  }
  return b;
}

// ===========================================================================
// BGZF + BAM
// ===========================================================================
namespace {

struct PackedBam {
  // header
  std::vector<std::string> ref_names;
  std::vector<int64_t> ref_lens;
  std::string header_text;
  // per-record packed columns (spec: fields used by GCI.py:146-169)
  std::vector<int32_t> ref_id;
  std::vector<int32_t> pos;        // reference_start
  std::vector<int32_t> ref_end;    // pos + consumed-reference cigar span
  std::vector<int32_t> qlen;       // l_seq (pysam query_length)
  std::vector<int32_t> mapq;
  std::vector<int32_t> flag;
  std::vector<int32_t> cig_m, cig_i, cig_d, cig_s, cig_eq, cig_x;
  std::vector<int32_t> nm;         // -1 when tag absent
  std::vector<uint64_t> name_hash;  // FNV-1a 64 of read name
  std::vector<uint64_t> name_hash2; // independent second hash (collision guard)
  std::vector<int64_t> name_off;   // into name_blob; size = n+1
  std::string name_blob;
  // raw record bytes (kept on demand for filtered-BAM export)
  std::vector<int64_t> rec_off;  // offset of block_size field in `body`
  std::vector<uint8_t> body;     // uncompressed record stream (after header)
  std::string error;
};

static uint64_t fnv1a64(const char* s, size_t n) {
  uint64_t h = 1469598103934665603ull;
  for (size_t i = 0; i < n; i++) {
    h ^= (uint8_t)s[i];
    h *= 1099511628211ull;
  }
  return h;
}

// Independent 64-bit hash (xorshift-mixed multiplicative); paired with
// fnv1a64 it forms a 128-bit key, making name-hash collisions negligible.
static uint64_t hash2_64(const char* s, size_t n) {
  uint64_t h = 0x9e3779b97f4a7c15ull ^ (n * 0xff51afd7ed558ccdull);
  for (size_t i = 0; i < n; i++) {
    h ^= (uint8_t)s[i];
    h *= 0xc2b2ae3d27d4eb4full;
    h ^= h >> 29;
  }
  h *= 0xff51afd7ed558ccdull;
  h ^= h >> 33;
  return h;
}

// Both name hashes in ONE walk over the bytes (bit-identical to calling
// fnv1a64 + hash2_64 separately; the name is walked once instead of twice).
static inline void hash_pair64(const char* s, size_t n, uint64_t* o1,
                               uint64_t* o2) {
  uint64_t h1 = 1469598103934665603ull;
  uint64_t h2 = 0x9e3779b97f4a7c15ull ^ (n * 0xff51afd7ed558ccdull);
  for (size_t i = 0; i < n; i++) {
    uint8_t b = (uint8_t)s[i];
    h1 ^= b;
    h1 *= 1099511628211ull;
    h2 ^= b;
    h2 *= 0xc2b2ae3d27d4eb4full;
    h2 ^= h2 >> 29;
  }
  h2 *= 0xff51afd7ed558ccdull;
  h2 ^= h2 >> 33;
  *o1 = h1;
  *o2 = h2;
}

static inline uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
static inline int32_t rd_i32(const uint8_t* p) {
  int32_t v;
  memcpy(&v, p, 4);
  return v;
}
static inline uint16_t rd_u16(const uint8_t* p) {
  uint16_t v;
  memcpy(&v, p, 2);
  return v;
}

// Size of one aux value of the given type; -1 = unknown, -2 = string/array.
static int aux_value_size(uint8_t t) {
  switch (t) {
    case 'A': case 'c': case 'C': return 1;
    case 's': case 'S': return 2;
    case 'i': case 'I': case 'f': return 4;
    case 'd': return 8;
    default: return -2;
  }
}

// Parse the aux region for NM; returns -1 when absent.
static int64_t find_nm(const uint8_t* p, const uint8_t* end,
                       const uint8_t** cg_data, uint32_t* cg_count) {
  int64_t nm = -1;
  while (p + 3 <= end) {
    uint8_t t1 = p[0], t2 = p[1], type = p[2];
    p += 3;
    bool is_nm = (t1 == 'N' && t2 == 'M');
    bool is_cg = (t1 == 'C' && t2 == 'G');
    if (type == 'Z' || type == 'H') {
      const uint8_t* q = p;
      while (q < end && *q) q++;
      p = q + 1;
    } else if (type == 'B') {
      if (p + 5 > end) break;
      uint8_t sub = p[0];
      uint32_t cnt = rd_u32(p + 1);
      int es = aux_value_size(sub);
      if (es < 0) break;
      if (is_cg && sub == 'I') {
        *cg_data = p + 5;
        *cg_count = cnt;
      }
      p += 5 + (size_t)es * cnt;
    } else {
      int es = aux_value_size(type);
      if (es < 0) break;
      if (is_nm && p + es <= end) {
        switch (type) {
          case 'c': nm = *(const int8_t*)p; break;
          case 'C': nm = *(const uint8_t*)p; break;
          case 's': nm = (int16_t)rd_u16(p); break;
          case 'S': nm = rd_u16(p); break;
          case 'i': nm = rd_i32(p); break;
          case 'I': nm = (int64_t)rd_u32(p); break;
          default: break;  // float NM: unsupported, treat as absent
        }
      }
      p += es;
    }
  }
  return nm;
}

// Decoded fields of one BAM record (spec: fields used by GCI.py:146-169).
struct RecFields {
  int32_t ref_id, pos, ref_end, qlen, mapq, flag;
  int32_t m, i, d, s, eq, x, nm;
  uint64_t h1, h2;
  const char* rname;
  size_t rname_len;
};

// `rec` points at refID (the byte after block_size).
static void parse_record_fields(const uint8_t* rec, uint32_t block_size,
                                RecFields& o) {
  const uint8_t* rec_end = rec + block_size;
  int32_t refID = rd_i32(rec + 0);
  int32_t pos = rd_i32(rec + 4);
  uint8_t l_read_name = rec[8];
  uint8_t mapq = rec[9];
  uint16_t n_cigar = rd_u16(rec + 12);
  uint16_t flag = rd_u16(rec + 14);
  int32_t l_seq = rd_i32(rec + 16);
  const char* rname = (const char*)rec + 32;
  const uint8_t* cig = rec + 32 + l_read_name;
  const uint8_t* seq = cig + 4ull * n_cigar;
  const uint8_t* qual = seq + (l_seq + 1) / 2;
  const uint8_t* aux = qual + l_seq;
  const uint8_t* cg_data = nullptr;
  uint32_t cg_count = 0;
  int64_t nm = find_nm(aux, rec_end, &cg_data, &cg_count);
  // long-CIGAR convention: real cigar is in CG:B,I when the inline
  // cigar is kSmN with k == l_seq (same rule htslib applies)
  const uint8_t* use_cig = cig;
  uint32_t use_n = n_cigar;
  if (cg_data && n_cigar == 2) {
    uint32_t c0 = rd_u32(cig);
    if ((c0 & 0xf) == 4 /*S*/ && (int32_t)(c0 >> 4) == l_seq) {
      use_cig = cg_data;
      use_n = cg_count;
    }
  }
  int64_t m = 0, ins = 0, del = 0, soft = 0, eq = 0, x = 0, rspan = 0;
  for (uint32_t c = 0; c < use_n; c++) {
    uint32_t v = rd_u32(use_cig + 4ull * c);
    uint32_t op = v & 0xf;
    int64_t len = v >> 4;
    switch (op) {
      case 0: m += len; rspan += len; break;   // M
      case 1: ins += len; break;               // I
      case 2: del += len; rspan += len; break; // D
      case 3: rspan += len; break;             // N
      case 4: soft += len; break;              // S
      case 7: eq += len; rspan += len; break;  // =
      case 8: x += len; rspan += len; break;   // X
      default: break;                          // H, P
    }
  }
  o.ref_id = refID;
  o.pos = pos;
  o.ref_end = (int32_t)(pos + rspan);
  o.qlen = l_seq;
  o.mapq = mapq;
  o.flag = flag;
  o.m = (int32_t)m;
  o.i = (int32_t)ins;
  o.d = (int32_t)del;
  o.s = (int32_t)soft;
  o.eq = (int32_t)eq;
  o.x = (int32_t)x;
  o.nm = (int32_t)nm;
  o.rname = rname;
  o.rname_len = l_read_name > 0 ? (size_t)l_read_name - 1 : 0;
  hash_pair64(rname, o.rname_len, &o.h1, &o.h2);
}

static PackedBam* bam_parse(const uint8_t* u, size_t n, bool keep_names,
                            bool keep_raw, int nthreads) {
  auto* pb = new PackedBam();
  if (n < 12 || memcmp(u, "BAM\1", 4) != 0) {
    pb->error = "not a BAM stream";
    return pb;
  }
  size_t off = 4;
  int32_t l_text = rd_i32(u + off);
  off += 4;
  pb->header_text.assign((const char*)u + off, (size_t)l_text);
  off += (size_t)l_text;
  int32_t n_ref = rd_i32(u + off);
  off += 4;
  for (int32_t r = 0; r < n_ref; r++) {
    int32_t l_name = rd_i32(u + off);
    off += 4;
    pb->ref_names.emplace_back((const char*)u + off, (size_t)l_name - 1);
    off += (size_t)l_name;
    pb->ref_lens.push_back(rd_i32(u + off));
    off += 4;
  }
  size_t body_start = off;
  // pass 1: walk the block_size chain to index record offsets (cheap)
  std::vector<size_t> offs;
  offs.reserve(n / 300 + 16);
  while (off + 4 <= n) {
    uint32_t block_size = rd_u32(u + off);
    if (off + 4 + block_size > n) {
      pb->error = "truncated BAM record";
      return pb;
    }
    offs.push_back(off);
    off += 4 + (size_t)block_size;
  }
  size_t nrec = offs.size();
  pb->ref_id.resize(nrec);
  pb->pos.resize(nrec);
  pb->ref_end.resize(nrec);
  pb->qlen.resize(nrec);
  pb->mapq.resize(nrec);
  pb->flag.resize(nrec);
  pb->cig_m.resize(nrec);
  pb->cig_i.resize(nrec);
  pb->cig_d.resize(nrec);
  pb->cig_s.resize(nrec);
  pb->cig_eq.resize(nrec);
  pb->cig_x.resize(nrec);
  pb->nm.resize(nrec);
  pb->name_hash.resize(nrec);
  pb->name_hash2.resize(nrec);
  std::vector<int64_t> name_lens(nrec);
  if (keep_raw) {
    pb->rec_off.resize(nrec);
    for (size_t i = 0; i < nrec; i++)
      pb->rec_off[i] = (int64_t)(offs[i] - body_start);
  }

  // pass 2: parse records in parallel contiguous ranges
  int T = nthreads > 1 ? nthreads : 1;
  if ((size_t)T > nrec) T = nrec ? (int)nrec : 1;
  std::vector<std::string> blobs((size_t)T);
  auto worker = [&](int t) {
    size_t lo = nrec * (size_t)t / (size_t)T;
    size_t hi = nrec * (size_t)(t + 1) / (size_t)T;
    std::string& blob = blobs[(size_t)t];
    for (size_t i = lo; i < hi; i++) {
      RecFields o;
      parse_record_fields(u + offs[i] + 4, rd_u32(u + offs[i]), o);
      pb->ref_id[i] = o.ref_id;
      pb->pos[i] = o.pos;
      pb->ref_end[i] = o.ref_end;
      pb->qlen[i] = o.qlen;
      pb->mapq[i] = o.mapq;
      pb->flag[i] = o.flag;
      pb->cig_m[i] = o.m;
      pb->cig_i[i] = o.i;
      pb->cig_d[i] = o.d;
      pb->cig_s[i] = o.s;
      pb->cig_eq[i] = o.eq;
      pb->cig_x[i] = o.x;
      pb->nm[i] = o.nm;
      name_lens[i] = (int64_t)o.rname_len;
      pb->name_hash[i] = o.h1;
      pb->name_hash2[i] = o.h2;
      if (keep_names) blob.append(o.rname, o.rname_len);
    }
  };
  if (T <= 1) {
    worker(0);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < T; t++) ts.emplace_back(worker, t);
    for (auto& th : ts) th.join();
  }

  pb->name_off.resize(nrec + 1);
  pb->name_off[0] = 0;
  for (size_t i = 0; i < nrec; i++)
    pb->name_off[i + 1] = pb->name_off[i] + (keep_names ? name_lens[i] : 0);
  if (keep_names) {
    size_t total_blob = 0;
    for (auto& b : blobs) total_blob += b.size();
    pb->name_blob.reserve(total_blob);
    for (auto& b : blobs) pb->name_blob += b;
  }
  if (keep_raw)
    pb->body.assign(u + body_start, u + n);
  return pb;
}

}  // namespace

GCI_API void* gci_bam_open(const char* path, int nthreads, int keep_names,
                           int keep_raw) {
  const bool dbg = getenv("GCI_NATIVE_DEBUG") != nullptr;
  auto now = []() {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  };
  double t0 = now();
  std::vector<uint8_t> raw;
  if (!read_file(path, raw)) return nullptr;
  double t1 = now();
  std::vector<BgzfBlock> blocks;
  size_t total = 0;
  std::vector<uint8_t> un;
  double t2 = t1, t3 = t1;
  if (bgzf_scan(raw.data(), raw.size(), blocks, total)) {
    t2 = now();
    un.resize(total);
    t3 = now();
    if (!bgzf_decompress_parallel(raw.data(), blocks, un.data(), nthreads)) {
      auto* pb = new PackedBam();
      pb->error = "BGZF inflate failed";
      return pb;
    }
  } else if (raw.size() >= 2 && raw[0] == 0x1f && raw[1] == 0x8b) {
    if (!gzip_inflate_all(raw.data(), raw.size(), un)) {
      auto* pb = new PackedBam();
      pb->error = "gzip inflate failed";
      return pb;
    }
  } else {
    un = std::move(raw);  // uncompressed BAM
  }
  double t4 = now();
  auto* r = bam_parse(un.data(), un.size(), keep_names != 0, keep_raw != 0,
                      nthreads);
  if (dbg)
    fprintf(stderr,
            "[gci_native] bam_open read=%.2fs scan=%.2fs resize=%.2fs "
            "inflate=%.2fs parse=%.2fs blocks=%zu inflated=%zu\n",
            t1 - t0, t2 - t1, t3 - t2, t4 - t3, now() - t4, blocks.size(),
            total);
  return r;
}

// Diagnostic: the BAM pack stage's decompression floor.  Scans the BGZF
// block chain and inflates every block into a REUSED per-thread 64 KiB
// scratch (no whole-file materialization, no parse): the wall time is the
// irreducible libdeflate cost of the file at the given thread count.
// Returns inflated bytes (-1 on error); *seconds gets the inflate wall.
GCI_API int64_t gci_bgzf_inflate_floor(const char* path, int nthreads,
                                       double* seconds) {
  std::vector<uint8_t> raw;
  if (!read_file(path, raw)) return -1;
  std::vector<BgzfBlock> blocks;
  size_t total = 0;
  if (!bgzf_scan(raw.data(), raw.size(), blocks, total)) return -1;
  auto t0 = std::chrono::steady_clock::now();
  std::atomic<size_t> next(0);
  std::atomic<bool> ok(true);
  auto worker = [&]() {
    std::vector<uint8_t> scratch(1 << 16);
    while (true) {
      size_t i = next.fetch_add(1);
      if (i >= blocks.size() || !ok.load()) break;
      const BgzfBlock& b = blocks[i];
      if (b.isize > scratch.size()) scratch.resize(b.isize);
      if (!inflate_raw(raw.data() + b.comp_off, b.comp_len,
                       scratch.data(), b.isize))
        ok.store(false);
    }
  };
  int T = nthreads > 1 ? nthreads : 1;
  if ((size_t)T > blocks.size()) T = blocks.size() ? (int)blocks.size() : 1;
  if (T <= 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < T; t++) ts.emplace_back(worker);
    for (auto& th : ts) th.join();
  }
  *seconds = std::chrono::duration<double>(
                 std::chrono::steady_clock::now() - t0)
                 .count();
  return ok.load() ? (int64_t)total : -1;
}

// ===========================================================================
// PAF parser: tab-separated text -> packed columns
// ===========================================================================
namespace {

struct PackedPaf {
  // int columns: qlen qstart qend tstart tend nmatch alnlen mapq
  std::vector<int64_t> ints;  // row-major, 8 per row
  std::vector<uint64_t> name_hash, name_hash2;
  std::vector<int64_t> name_off;   // n+1
  std::string name_blob;
  // targets are deduped into a table (typically a handful of contigs per
  // multi-million-row PAF): per-row int32 ids instead of per-row strings
  std::vector<int32_t> target_id;
  std::vector<std::string> target_names;
  std::unordered_map<std::string, int32_t> target_lookup;
  // fast path: fnv hash -> first tid with that hash; a memcmp against
  // target_names verifies exactness (collisions fall back to the string map)
  std::unordered_map<uint64_t, int32_t> target_hash;
  std::string error;
  size_t n_rows = 0;

  int32_t intern_target(const char* s, size_t len) {
    uint64_t th = fnv1a64(s, len);
    auto it = target_hash.find(th);
    if (it != target_hash.end()) {
      const std::string& nm = target_names[(size_t)it->second];
      if (nm.size() == len && memcmp(nm.data(), s, len) == 0)
        return it->second;
    }
    std::string tgt(s, len);
    auto it2 = target_lookup.find(tgt);
    if (it2 != target_lookup.end()) return it2->second;
    int32_t tid = (int32_t)target_names.size();
    target_lookup.emplace(tgt, tid);
    target_names.push_back(std::move(tgt));
    target_hash.emplace(th, tid);  // keeps the FIRST tid on collision
    return tid;
  }
};

static inline int64_t parse_int(const char* s, const char* e) {
  int64_t v = 0;
  bool neg = false;
  if (s < e && *s == '-') { neg = true; s++; }
  while (s < e && *s >= '0' && *s <= '9') v = v * 10 + (*s++ - '0');
  return neg ? -v : v;
}

static void paf_parse_range(const char* p, size_t i, size_t n,
                            PackedPaf* pf) {
  const int NEED[8] = {1, 2, 3, 7, 8, 9, 10, 11};
  // typical PAF rows run 50-200 bytes; reserving ~1/90 avoids the first
  // few vector doublings on multi-million-row shards
  size_t est = (n - i) / 90 + 16;
  pf->ints.reserve(est * 8);
  pf->name_hash.reserve(est);
  pf->name_hash2.reserve(est);
  pf->name_off.reserve(est + 1);
  pf->target_id.reserve(est);
  // per-shard last-target memo: consecutive rows of a sorted PAF share
  // targets, making the intern lookup a length check + memcmp
  int32_t last_tid = -1;
  const char* last_tgt = nullptr;
  size_t last_tlen = 0;
  while (i < n) {
    const char* nl = (const char*)memchr(p + i, '\n', n - i);
    size_t line_end = nl ? (size_t)(nl - p) : n;
    size_t e = line_end;
    if (e > i && p[e - 1] == '\r') e--;
    // memchr-driven split of the 12 standard columns (extension fields
    // after column 12 are never touched)
    const char* f[12];
    size_t flen[12];
    int nf = 0;
    size_t s = i;
    while (nf < 12) {
      const char* tab = (const char*)memchr(p + s, '\t', e - s);
      size_t fe = tab ? (size_t)(tab - p) : e;
      f[nf] = p + s;
      flen[nf] = fe - s;
      nf++;
      if (!tab) break;
      s = fe + 1;
    }
    if (nf >= 12) {
      pf->name_blob.append(f[0], flen[0]);
      pf->name_off.push_back((int64_t)pf->name_blob.size());
      uint64_t h1, h2;
      hash_pair64(f[0], flen[0], &h1, &h2);
      pf->name_hash.push_back(h1);
      pf->name_hash2.push_back(h2);
      int32_t tid;
      if (flen[5] == last_tlen && last_tid >= 0 &&
          memcmp(f[5], last_tgt, last_tlen) == 0) {
        tid = last_tid;
      } else {
        tid = pf->intern_target(f[5], flen[5]);
        last_tid = tid;
        last_tgt = f[5];
        last_tlen = flen[5];
      }
      pf->target_id.push_back(tid);
      for (int k = 0; k < 8; k++)
        pf->ints.push_back(parse_int(f[NEED[k]], f[NEED[k]] + flen[NEED[k]]));
      pf->n_rows++;
    }
    i = line_end + 1;
  }
}

// Parse in parallel line-aligned ranges, then splice the shards in order
// (per-shard target tables remap into the merged table).
static PackedPaf* paf_parse(const char* p, size_t n, int nthreads) {
  auto* pf = new PackedPaf();
  pf->name_off.push_back(0);
  int T = nthreads > 1 ? nthreads : 1;
  if ((size_t)T > n / (1 << 20) + 1) T = (int)(n / (1 << 20) + 1);
  std::vector<size_t> starts((size_t)T + 1, n);
  starts[0] = 0;
  for (int t = 1; t < T; t++) {
    size_t cand = n * (size_t)t / (size_t)T;
    const char* nl = (const char*)memchr(p + cand, '\n', n - cand);
    starts[(size_t)t] = nl ? (size_t)(nl - p) + 1 : n;
  }
  for (int t = 1; t < T; t++)
    if (starts[(size_t)t] < starts[(size_t)t - 1])
      starts[(size_t)t] = starts[(size_t)t - 1];
  std::vector<PackedPaf> shards((size_t)T);
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < T; t++) {
      ts.emplace_back([&, t]() {
        shards[(size_t)t].name_off.push_back(0);
        paf_parse_range(p, starts[(size_t)t], starts[(size_t)t + 1],
                        &shards[(size_t)t]);
      });
    }
    for (auto& th : ts) th.join();
  }
  for (auto& sh : shards) {
    int64_t nb = (int64_t)pf->name_blob.size();
    pf->ints.insert(pf->ints.end(), sh.ints.begin(), sh.ints.end());
    pf->name_hash.insert(pf->name_hash.end(), sh.name_hash.begin(),
                         sh.name_hash.end());
    pf->name_hash2.insert(pf->name_hash2.end(), sh.name_hash2.begin(),
                          sh.name_hash2.end());
    pf->name_blob += sh.name_blob;
    for (size_t k = 1; k < sh.name_off.size(); k++)
      pf->name_off.push_back(nb + sh.name_off[k]);
    // remap this shard's target ids into the merged table
    std::vector<int32_t> remap(sh.target_names.size());
    for (size_t k = 0; k < sh.target_names.size(); k++) {
      const std::string& tgt = sh.target_names[k];
      auto it = pf->target_lookup.find(tgt);
      if (it == pf->target_lookup.end()) {
        remap[k] = (int32_t)pf->target_names.size();
        pf->target_lookup.emplace(tgt, remap[k]);
        pf->target_names.push_back(tgt);
      } else {
        remap[k] = it->second;
      }
    }
    for (int32_t tid : sh.target_id)
      pf->target_id.push_back(remap[(size_t)tid]);
    pf->n_rows += sh.n_rows;
  }
  return pf;
}

}  // namespace

// Parse only the lines whose FIRST byte lies in [lo, hi) of the buffer
// (lo/hi < 0 = unbounded); ranges partition the row stream exactly.
static void* paf_parse_sliced(const char* p, size_t n, int64_t lo, int64_t hi,
                              int nthreads) {
  if (lo < 0 && hi < 0) return paf_parse(p, n, nthreads);
  if (lo < 0) lo = 0;
  if (hi < 0 || hi > (int64_t)n) hi = (int64_t)n;
  // start: first line whose first byte is >= lo
  size_t s = (size_t)lo;
  if (s > 0) {
    const char* nl = (const char*)memchr(p + s - 1, '\n', n - (s - 1));
    s = nl ? (size_t)(nl - p) + 1 : n;
  }
  // end: the line containing byte hi-1 runs to its newline (lines starting
  // at >= hi belong to the next shard)
  size_t e = (size_t)hi;
  if (e > s && e < n && p[e - 1] != '\n') {
    const char* nl = (const char*)memchr(p + e, '\n', n - e);
    e = nl ? (size_t)(nl - p) + 1 : n;
  }
  if (s >= e) {
    auto* pf = new PackedPaf();
    pf->name_off.push_back(0);
    return pf;
  }
  return paf_parse(p + s, e - s, nthreads);
}

// lo/hi < 0: whole file.  Otherwise parse exactly the lines whose FIRST byte
// lies in [lo, hi) of the (uncompressed) file — the per-host input shard for
// a shared PAF (ranges partition the row stream with no overlap or loss,
// mirroring the BAM comp_range mechanism).  Gzipped PAFs don't support
// caller-computed byte ranges (the uncompressed size is unknown before
// inflating); use gci_paf_open_shard for those.
GCI_API void* gci_paf_open(const char* path, int nthreads, int64_t lo,
                           int64_t hi) {
  std::vector<uint8_t> raw;
  if (!read_file(path, raw)) return nullptr;
  std::vector<uint8_t> un;
  const char* p = (const char*)raw.data();
  size_t n = raw.size();
  if (n >= 2 && raw[0] == 0x1f && raw[1] == 0x8b) {
    if (lo >= 0 || hi >= 0) return nullptr;  // range + gzip unsupported
    if (!gzip_inflate_all(raw.data(), n, un)) return nullptr;
    p = (const char*)un.data();
    n = un.size();
  }
  return paf_parse_sliced(p, n, lo, hi, nthreads);
}

// Host h of H's input shard: the [n*h/H, n*(h+1)/H) line range of the
// UNCOMPRESSED bytes.  Works for plain AND gzipped PAFs: gzip has no random
// access, so every host still inflates the whole member chain (the cheap
// part — libdeflate at GB/s), but tokenizes only ~1/H of the rows (the
// expensive part).  Ranges computed post-inflate are identical on every
// host, so the shards partition the row stream exactly.
GCI_API void* gci_paf_open_shard(const char* path, int nthreads, int h,
                                 int H) {
  std::vector<uint8_t> raw;
  if (!read_file(path, raw)) return nullptr;
  std::vector<uint8_t> un;
  const char* p = (const char*)raw.data();
  size_t n = raw.size();
  if (n >= 2 && raw[0] == 0x1f && raw[1] == 0x8b) {
    if (!gzip_inflate_all(raw.data(), n, un)) return nullptr;
    p = (const char*)un.data();
    n = un.size();
  }
  if (H <= 1) return paf_parse(p, n, nthreads);
  int64_t lo = (int64_t)(n * (uint64_t)h / (uint64_t)H);
  int64_t hi = h == H - 1 ? (int64_t)n
                          : (int64_t)(n * (uint64_t)(h + 1) / (uint64_t)H);
  return paf_parse_sliced(p, n, lo, hi, nthreads);
}

GCI_API void gci_paf_free(void* h) { delete (PackedPaf*)h; }
GCI_API int64_t gci_paf_num_rows(void* h) {
  return (int64_t)((PackedPaf*)h)->n_rows;
}
GCI_API void gci_paf_copy_ints(void* h, int64_t* out) {
  auto* pf = (PackedPaf*)h;
  if (!pf->ints.empty())
    memcpy(out, pf->ints.data(), pf->ints.size() * sizeof(int64_t));
}
GCI_API void gci_paf_copy_hashes(void* h, uint64_t* h1, uint64_t* h2) {
  auto* pf = (PackedPaf*)h;
  if (!pf->name_hash.empty()) {
    memcpy(h1, pf->name_hash.data(), pf->name_hash.size() * sizeof(uint64_t));
    memcpy(h2, pf->name_hash2.data(), pf->name_hash2.size() * sizeof(uint64_t));
  }
}
GCI_API int64_t gci_paf_name_blob_size(void* h) {
  return (int64_t)((PackedPaf*)h)->name_blob.size();
}
GCI_API void gci_paf_copy_names(void* h, uint8_t* blob, int64_t* offs) {
  auto* pf = (PackedPaf*)h;
  if (blob && !pf->name_blob.empty())
    memcpy(blob, pf->name_blob.data(), pf->name_blob.size());
  if (offs)
    memcpy(offs, pf->name_off.data(), pf->name_off.size() * sizeof(int64_t));
}
GCI_API int64_t gci_paf_num_targets(void* h) {
  return (int64_t)((PackedPaf*)h)->target_names.size();
}
GCI_API const char* gci_paf_target_name(void* h, int64_t i) {
  return ((PackedPaf*)h)->target_names[(size_t)i].c_str();
}
GCI_API void gci_paf_copy_tids(void* h, int32_t* out) {
  auto* pf = (PackedPaf*)h;
  if (!pf->target_id.empty())
    memcpy(out, pf->target_id.data(), pf->target_id.size() * sizeof(int32_t));
}

// Sequential (left-to-right) segmented float64 sums: bit-identical to the
// reference's per-group Python ``sum`` of identities (GCI.py:246) — numpy's
// reduceat/pairwise summation would differ in the last ULP for long groups.
GCI_API void gci_seg_sum_f64(const double* v, const int64_t* starts,
                             int64_t nseg, int64_t n, double* out) {
  for (int64_t k = 0; k < nseg; k++) {
    int64_t s = starts[k];
    int64_t e = k + 1 < nseg ? starts[k + 1] : n;
    double acc = 0.0;
    for (int64_t i = s; i < e; i++) acc += v[i];
    out[k] = acc;
  }
}

GCI_API void gci_bam_free(void* h) { delete (PackedBam*)h; }
GCI_API const char* gci_bam_error(void* h) {
  auto* pb = (PackedBam*)h;
  return pb->error.empty() ? nullptr : pb->error.c_str();
}
GCI_API int64_t gci_bam_num_refs(void* h) {
  return (int64_t)((PackedBam*)h)->ref_names.size();
}
GCI_API const char* gci_bam_ref_name(void* h, int64_t i) {
  return ((PackedBam*)h)->ref_names[(size_t)i].c_str();
}
GCI_API int64_t gci_bam_ref_len(void* h, int64_t i) {
  return ((PackedBam*)h)->ref_lens[(size_t)i];
}
GCI_API int64_t gci_bam_num_records(void* h) {
  return (int64_t)((PackedBam*)h)->ref_id.size();
}

// Copy all packed columns into caller-provided arrays (each length n).
GCI_API void gci_bam_copy_columns(void* h, int32_t* ref_id, int32_t* pos,
                                  int32_t* ref_end, int32_t* qlen,
                                  int32_t* mapq, int32_t* flag, int32_t* m,
                                  int32_t* i_, int32_t* d, int32_t* s,
                                  int32_t* eq, int32_t* x, int32_t* nm,
                                  uint64_t* name_hash) {
  auto* pb = (PackedBam*)h;
  size_t n = pb->ref_id.size();
  auto cp = [n](int32_t* dst, const std::vector<int32_t>& src) {
    if (dst) memcpy(dst, src.data(), n * sizeof(int32_t));
  };
  cp(ref_id, pb->ref_id);
  cp(pos, pb->pos);
  cp(ref_end, pb->ref_end);
  cp(qlen, pb->qlen);
  cp(mapq, pb->mapq);
  cp(flag, pb->flag);
  cp(m, pb->cig_m);
  cp(i_, pb->cig_i);
  cp(d, pb->cig_d);
  cp(s, pb->cig_s);
  cp(eq, pb->cig_eq);
  cp(x, pb->cig_x);
  cp(nm, pb->nm);
  if (name_hash)
    memcpy(name_hash, pb->name_hash.data(), n * sizeof(uint64_t));
}

GCI_API int64_t gci_bam_name_blob_size(void* h) {
  return (int64_t)((PackedBam*)h)->name_blob.size();
}
GCI_API void gci_bam_copy_names(void* h, uint8_t* blob, int64_t* offsets) {
  auto* pb = (PackedBam*)h;
  if (blob && !pb->name_blob.empty())
    memcpy(blob, pb->name_blob.data(), pb->name_blob.size());
  if (offsets)
    memcpy(offsets, pb->name_off.data(),
           pb->name_off.size() * sizeof(int64_t));
}
GCI_API void gci_bam_copy_hash2(void* h, uint64_t* out) {
  auto* pb = (PackedBam*)h;
  if (out && !pb->name_hash2.empty())
    memcpy(out, pb->name_hash2.data(),
           pb->name_hash2.size() * sizeof(uint64_t));
}
GCI_API int64_t gci_bam_body_size(void* h) {
  return (int64_t)((PackedBam*)h)->body.size();
}
GCI_API void gci_bam_copy_body(void* h, uint8_t* out) {
  auto* pb = (PackedBam*)h;
  if (out && !pb->body.empty())
    memcpy(out, pb->body.data(), pb->body.size());
}
GCI_API void gci_bam_copy_rec_offsets(void* h, int64_t* out) {
  auto* pb = (PackedBam*)h;
  if (out && !pb->rec_off.empty())
    memcpy(out, pb->rec_off.data(), pb->rec_off.size() * sizeof(int64_t));
}
GCI_API int64_t gci_bam_header_text_size(void* h) {
  return (int64_t)((PackedBam*)h)->header_text.size();
}
GCI_API void gci_bam_copy_header_text(void* h, uint8_t* out) {
  auto* pb = (PackedBam*)h;
  if (!pb->header_text.empty())
    memcpy(out, pb->header_text.data(), pb->header_text.size());
}

// ===========================================================================
// BGZF writer (for BAM export): compress `data` into BGZF blocks + EOF marker
// ===========================================================================
static bool bgzf_compress_core(const uint8_t* data, int64_t n, int level,
                               int nthreads, std::vector<uint8_t>& result) {
  const size_t CHUNK = 0xff00;  // htslib's per-block payload size
  size_t nblocks = (size_t)((n + CHUNK - 1) / CHUNK);
  std::vector<std::vector<uint8_t>> outs(nblocks);
  std::atomic<size_t> next(0);
  std::atomic<bool> ok(true);
  auto worker = [&]() {
    std::vector<uint8_t> comp(CHUNK + 1024);
    while (true) {
      size_t i = next.fetch_add(1);
      if (i >= nblocks || !ok.load()) break;
      size_t s = i * CHUNK;
      size_t len = (size_t)std::min<int64_t>((int64_t)CHUNK, n - (int64_t)s);
      size_t clen = libdeflate_deflate_compress(tl_compressor(level), data + s,
                                                len, comp.data(), comp.size());
      if (!clen) {
        ok.store(false);
        break;
      }
      uint32_t crc = libdeflate_crc32(0, data + s, len);
      uint32_t bsize = (uint32_t)(clen + 26);  // 12 hdr + 6 extra + 8 trailer
      std::vector<uint8_t>& o = outs[i];
      o.reserve(bsize);
      const uint8_t hdr[12] = {0x1f, 0x8b, 8, 4, 0, 0, 0, 0, 0, 0xff, 6, 0};
      o.insert(o.end(), hdr, hdr + 12);
      uint8_t extra[6] = {66, 67, 2, 0, (uint8_t)((bsize - 1) & 0xff),
                          (uint8_t)(((bsize - 1) >> 8) & 0xff)};
      o.insert(o.end(), extra, extra + 6);
      o.insert(o.end(), comp.data(), comp.data() + clen);
      uint8_t tail[8];
      memcpy(tail, &crc, 4);
      uint32_t is = (uint32_t)len;
      memcpy(tail + 4, &is, 4);
      o.insert(o.end(), tail, tail + 8);
    }
  };
  if (nthreads <= 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < nthreads; t++) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  }
  if (!ok.load()) return false;
  size_t total = 0;
  for (auto& o : outs) total += o.size();
  result.reserve(result.size() + total);
  for (auto& o : outs) result.insert(result.end(), o.begin(), o.end());
  return true;
}

static const uint8_t BGZF_EOF_BLOCK[28] = {
    0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff,
    0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00};

GCI_API void* gci_bgzf_compress(const uint8_t* data, int64_t n, int level,
                                int nthreads) {
  auto* b = new Buffer();
  if (!bgzf_compress_core(data, n, level, nthreads, b->data)) {
    delete b;
    return nullptr;
  }
  b->data.insert(b->data.end(), BGZF_EOF_BLOCK,
                 BGZF_EOF_BLOCK + sizeof(BGZF_EOF_BLOCK));
  return b;
}

// ===========================================================================
// FASTA scanner: ONE pass -> per-record lengths + maximal N/n gap runs
// (behavior spec: GCI.py:18-46 get_Ns_ref; also serves the record-length
// consistency scan at GCI.py:939-941 without a second file read)
// ===========================================================================
struct FastaScan {
  std::string error;
  std::vector<std::string> names;
  std::vector<int64_t> lengths;
  std::vector<int64_t> gap_target;  // index into names
  std::vector<int64_t> gap_start;
  std::vector<int64_t> gap_end;
};

GCI_API void* gci_fasta_scan(const char* path) {
  auto* fs = new FastaScan();
  // plain files are mmapped (no copy, kernel readahead); gzip inflates to RAM
  std::vector<uint8_t> plain;
  const uint8_t* p = nullptr;
  size_t n = 0;
  int fd = open(path, O_RDONLY);
  void* map = MAP_FAILED;
  size_t map_len = 0;
  if (fd < 0) {
    fs->error = "cannot read file";
    return fs;
  }
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 0) {
    close(fd);
    fs->error = "cannot stat file";
    return fs;
  }
  map_len = (size_t)st.st_size;
  if (map_len == 0) {
    close(fd);
    return fs;
  }
  map = mmap(nullptr, map_len, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) {
    fs->error = "mmap failed";
    return fs;
  }
  madvise(map, map_len, MADV_SEQUENTIAL);
  p = (const uint8_t*)map;
  n = map_len;
  if (n >= 2 && p[0] == 0x1f && p[1] == 0x8b) {
    bool ok = gzip_inflate_all(p, n, plain);
    munmap(map, map_len);
    map = MAP_FAILED;
    if (!ok) {
      fs->error = "bad gzip stream";
      return fs;
    }
    p = plain.data();
    n = plain.size();
  }

  bool in_run = false, have_record = false;
  int64_t pos = 0, run_start = 0;
  auto close_run = [&]() {
    if (in_run) {
      fs->gap_target.push_back((int64_t)fs->names.size() - 1);
      fs->gap_start.push_back(run_start);
      fs->gap_end.push_back(pos);
      in_run = false;
    }
  };
  auto finish_record = [&]() {
    close_run();
    if (have_record) fs->lengths.back() = pos;
  };

  const uint8_t* cur = p;
  const uint8_t* endp = p + n;
  while (cur < endp) {
    const uint8_t* nl = (const uint8_t*)memchr(cur, '\n', (size_t)(endp - cur));
    const uint8_t* le = nl ? nl : endp;
    size_t llen = (size_t)(le - cur);
    if (llen && le[-1] == '\r') llen--;
    if (llen) {
      if (cur[0] == '>') {
        finish_record();
        size_t sp = 1;
        while (sp < llen && cur[sp] != ' ' && cur[sp] != '\t') sp++;
        fs->names.emplace_back((const char*)cur + 1, sp - 1);
        fs->lengths.push_back(0);
        have_record = true;
        pos = 0;
      } else if (have_record) {
        if (memchr(cur, ' ', llen) || memchr(cur, '\t', llen) ||
            memchr(cur, '\r', llen)) {
          // rare: interior whitespace; per-byte fallback for this line
          for (size_t k = 0; k < llen; k++) {
            uint8_t b = cur[k];
            if (b == '\r' || b == ' ' || b == '\t') continue;
            if (b == 'N' || b == 'n') {
              if (!in_run) {
                run_start = pos;
                in_run = true;
              }
            } else if (in_run) {
              close_run();
            }
            pos++;
          }
        } else {
          // fast path: memchr-skip non-N bases (SIMD under the hood)
          size_t off = 0;
          while (off < llen) {
            const uint8_t* pN =
                (const uint8_t*)memchr(cur + off, 'N', llen - off);
            const uint8_t* pn =
                (const uint8_t*)memchr(cur + off, 'n', llen - off);
            const uint8_t* px =
                (pN && pn) ? (pN < pn ? pN : pn) : (pN ? pN : pn);
            if (!px) {
              if (in_run) close_run();
              pos += (int64_t)(llen - off);
              break;
            }
            size_t non_n = (size_t)(px - (cur + off));
            if (non_n) {
              if (in_run) close_run();
              pos += (int64_t)non_n;
            }
            size_t k = (size_t)(px - cur);
            if (!in_run) {
              run_start = pos;
              in_run = true;
            }
            while (k < llen && (cur[k] == 'N' || cur[k] == 'n')) {
              k++;
              pos++;
            }
            off = k;
          }
        }
      }
    }
    if (!nl) break;
    cur = nl + 1;
  }
  finish_record();
  if (map != MAP_FAILED) munmap(map, map_len);
  return fs;
}

GCI_API void gci_fasta_free(void* h) { delete (FastaScan*)h; }
GCI_API const char* gci_fasta_error(void* h) {
  auto* fs = (FastaScan*)h;
  return fs->error.empty() ? nullptr : fs->error.c_str();
}
GCI_API int64_t gci_fasta_num_targets(void* h) {
  return (int64_t)((FastaScan*)h)->names.size();
}
GCI_API const char* gci_fasta_target_name(void* h, int64_t i) {
  return ((FastaScan*)h)->names[(size_t)i].c_str();
}
GCI_API int64_t gci_fasta_target_len(void* h, int64_t i) {
  return ((FastaScan*)h)->lengths[(size_t)i];
}
GCI_API int64_t gci_fasta_num_gaps(void* h) {
  return (int64_t)((FastaScan*)h)->gap_target.size();
}
GCI_API void gci_fasta_copy_gaps(void* h, int64_t* tgt, int64_t* start,
                                 int64_t* end) {
  auto* fs = (FastaScan*)h;
  size_t m = fs->gap_target.size();
  if (!m) return;
  memcpy(tgt, fs->gap_target.data(), m * sizeof(int64_t));
  memcpy(start, fs->gap_start.data(), m * sizeof(int64_t));
  memcpy(end, fs->gap_end.data(), m * sizeof(int64_t));
}

// Encode run-length (value, count) pairs to "v\n" repeated count times.
// The O(runs) serialization partner of the event-space depth backend.
static void encode_runs_core(const int64_t* vals, const int64_t* counts,
                             int64_t n, std::vector<uint8_t>& out) {
  char line[32];
  for (int64_t i = 0; i < n; i++) {
    int64_t c = counts[i];
    if (c <= 0) continue;
    int64_t v = vals[i];
    int len = 0;
    if (v == 0) {
      line[len++] = '0';
    } else {
      char rev[24];
      int r = 0;
      while (v > 0) {
        rev[r++] = (char)('0' + (v % 10));
        v /= 10;
      }
      while (r > 0) line[len++] = rev[--r];
    }
    line[len++] = '\n';
    // grow by doubling the already-written pattern (memcpy-bandwidth repeat)
    size_t start = out.size();
    size_t want = (size_t)len * (size_t)c;
    out.resize(start + want);
    memcpy(out.data() + start, line, (size_t)len);
    size_t done = (size_t)len;
    while (done < want) {
      size_t chunk = std::min(done, want - done);
      memcpy(out.data() + start + done, out.data() + start, chunk);
      done += chunk;
    }
  }
}

GCI_API void* gci_depth_encode_runs(const int64_t* vals, const int64_t* counts,
                                    int64_t n) {
  auto* b = new Buffer();
  int64_t total = 0;
  for (int64_t i = 0; i < n; i++) total += counts[i];
  b->data.reserve((size_t)total * 2 + 16);
  encode_runs_core(vals, counts, n, b->data);
  return b;
}

// Fused: "header" bytes + run-length text -> BGZF blocks (no EOF marker).
// The expanded per-base text is never materialized: each worker generates
// its 64KB block's text straight from the run list (binary-searched byte
// offsets + pattern fill), so expansion AND deflate both parallelize and
// the only O(genome) memory is the compressed output.
//
// Framing is deterministic in uncompressed byte offsets (block bi covers
// text bytes [bi*0xff00, (bi+1)*0xff00)), so disjoint [block_lo, block_hi)
// ranges compressed independently (even on different hosts) concatenate to
// the exact bytes a single whole-stream call produces — the distributed
// checkpoint writer relies on this.  The reference's analogue is its
// per-chunk gzip fan-out + `cat` (GCI.py:99-143).
//
// A per-worker cache keys fully-interior blocks (one run covers the whole
// block) by (run value, phase): a multi-megabase run has at most line-width
// distinct block texts, so its deflate+crc cost collapses to memcpy.
// --- RLE-aware deflate: emit fixed-Huffman tokens straight from the run
// structure.  Depth text is a sequence of periodic segments ("v\n" repeated),
// so instead of letting a general compressor rediscover the periodicity one
// 32KB hash probe at a time, emit the first line as literals and the rest as
// distance-`width` matches: O(len/258) tokens per block instead of O(len)
// match-finder work.  Output is a perfectly standard deflate stream (BTYPE=01)
// — every gzip/BGZF reader, including the reference's (GCI_score.py:11-39),
// inflates it unchanged.  ~3-5x larger than libdeflate level 6 on depth text
// but ~20x faster to produce; `level >= 2` keeps the libdeflate path.
struct RleBitWriter {
  uint8_t* out;
  size_t cap;
  size_t pos = 0;
  uint64_t bitbuf = 0;
  int nbits = 0;
  bool overflow = false;
  void put(uint32_t bits, int n) {
    bitbuf |= (uint64_t)bits << nbits;
    nbits += n;
    while (nbits >= 8) {
      if (pos >= cap) {
        overflow = true;
        nbits = 0;
        return;
      }
      out[pos++] = (uint8_t)bitbuf;
      bitbuf >>= 8;
      nbits -= 8;
    }
  }
  size_t finish() {
    if (nbits) {
      if (pos >= cap) {
        overflow = true;
        return 0;
      }
      out[pos++] = (uint8_t)bitbuf;
      bitbuf = 0;
      nbits = 0;
    }
    return overflow ? 0 : pos;
  }
};

static inline uint32_t rle_revbits(uint32_t v, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; i++) {
    r = (r << 1) | (v & 1);
    v >>= 1;
  }
  return r;
}

static inline void rle_put_lit(RleBitWriter& bw, uint8_t c) {
  if (c < 144)
    bw.put(rle_revbits(0x30 + c, 8), 8);
  else
    bw.put(rle_revbits(0x190 + (c - 144), 9), 9);
}

static const int kRleLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 13,
                                    15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
                                    67, 83, 99, 115, 131, 163, 195, 227, 258};
static const int kRleLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2,
                                     2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5,
                                     0};
static const int kRleDistBase[30] = {
    1,    2,    3,    4,    5,    7,    9,    13,   17,    25,
    33,   49,   65,   97,   129,  193,  257,  385,  513,   769,
    1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
static const int kRleDistExtra[30] = {0, 0, 0,  0,  1,  1,  2,  2,  3,  3,
                                      4, 4, 5,  5,  6,  6,  7,  7,  8,  8,
                                      9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

static inline void rle_put_match(RleBitWriter& bw, int len, int dist) {
  int li = 28;
  while (kRleLenBase[li] > len) li--;
  int code = 257 + li;
  if (code < 280)
    bw.put(rle_revbits((uint32_t)(code - 256), 7), 7);
  else
    bw.put(rle_revbits((uint32_t)(0xC0 + code - 280), 8), 8);
  if (kRleLenExtra[li]) bw.put((uint32_t)(len - kRleLenBase[li]), kRleLenExtra[li]);
  int di = 29;
  while (kRleDistBase[di] > dist) di--;
  bw.put(rle_revbits((uint32_t)di, 5), 5);
  if (kRleDistExtra[di]) bw.put((uint32_t)(dist - kRleDistBase[di]), kRleDistExtra[di]);
}

// --- CRC32 of periodic text without materializing it: zlib-style GF(2)
// zero-byte shift ladder (crc32_combine algebra).  crc(A||B) =
// shift(crc(A), len(B)) ^ crc(B); shift by n zero bytes = product of the
// precomputed x^(8*2^i) matrices over n's set bits.  A run of k identical
// lines then costs O(log k) instead of O(k) — combined with the token
// emitter above, a multi-gigabase checkpoint never exists as text at all.
static inline uint32_t gf2_times(const uint32_t* mat, uint32_t vec) {
  uint32_t sum = 0;
  while (vec) {
    if (vec & 1) sum ^= *mat;
    vec >>= 1;
    mat++;
  }
  return sum;
}

static void gf2_square(uint32_t* dst, const uint32_t* src) {
  for (int n = 0; n < 32; n++) dst[n] = gf2_times(src, src[n]);
}

typedef uint32_t CrcLadderRow[32];
static const CrcLadderRow* crc_zero_ladder() {
  static uint32_t lad[43][32];
  static std::once_flag once;
  std::call_once(once, []() {
    uint32_t odd[32], even[32];
    odd[0] = 0xedb88320u;  // reflected CRC-32 polynomial
    uint32_t row = 1;
    for (int n = 1; n < 32; n++) {
      odd[n] = row;
      row <<= 1;
    }
    gf2_square(even, odd);    // 2 zero bits
    gf2_square(odd, even);    // 4 zero bits
    gf2_square(lad[0], odd);  // 8 zero bits = 1 byte
    for (int i = 1; i < 43; i++) gf2_square(lad[i], lad[i - 1]);
  });
  return lad;
}

static uint32_t crc_shift_bytes(uint32_t crc, uint64_t n) {
  const CrcLadderRow* lad = crc_zero_ladder();
  for (int i = 0; n; i++, n >>= 1)
    if (n & 1) crc = gf2_times(lad[i], crc);
  return crc;
}

static inline uint32_t crc_combine(uint32_t c1, uint32_t c2, uint64_t len2) {
  return crc_shift_bytes(c1, len2) ^ c2;
}

// per-value cache: crc of the value's line repeated 2^j times
struct ValCrcLadder {
  int maxj = 0;
  bool init = false;
  uint32_t pow[43];
};

static uint32_t crc_k_lines(ValCrcLadder& vc, int ll, uint64_t k) {
  int hb = 63 - __builtin_clzll(k);
  while (vc.maxj < hb) {
    vc.pow[vc.maxj + 1] = crc_combine(vc.pow[vc.maxj], vc.pow[vc.maxj],
                                      (uint64_t)ll << vc.maxj);
    vc.maxj++;
  }
  uint32_t c = vc.pow[hb];
  for (int j = hb - 1; j >= 0; j--)
    if (k & (1ull << j)) c = crc_combine(c, vc.pow[j], (uint64_t)ll << j);
  return c;
}

static bool depth_runs_bgzf_core(const int64_t* vals, const int64_t* counts,
                                 int64_t n, const uint8_t* header,
                                 int64_t header_len, int level, int nthreads,
                                 int64_t block_lo, int64_t block_hi,
                                 std::vector<uint8_t>& result) {
  // per-run decimal line text + cumulative byte offsets (O(runs))
  std::vector<char> line_buf;
  std::vector<uint32_t> line_off;   // start of run i's line in line_buf
  std::vector<uint8_t> line_len;    // bytes incl. newline (<= 21)
  std::vector<int64_t> run_val;     // kept-run values (cache key)
  std::vector<int64_t> byte_off;    // text byte offset where run i starts
  line_buf.reserve((size_t)n * 4);
  line_off.reserve((size_t)n);
  line_len.reserve((size_t)n);
  run_val.reserve((size_t)n);
  byte_off.reserve((size_t)n + 1);
  int64_t cursor = header_len;
  for (int64_t i = 0; i < n; i++) {
    if (counts[i] <= 0) continue;
    char tmp[24];
    int len = 0;
    int64_t v = vals[i];
    if (v == 0) {
      tmp[len++] = '0';
    } else {
      char rev[24];
      int r = 0;
      while (v > 0) {
        rev[r++] = (char)('0' + (v % 10));
        v /= 10;
      }
      while (r > 0) tmp[len++] = rev[--r];
    }
    tmp[len++] = '\n';
    byte_off.push_back(cursor);
    line_off.push_back((uint32_t)line_buf.size());
    line_len.push_back((uint8_t)len);
    run_val.push_back(vals[i]);
    line_buf.insert(line_buf.end(), tmp, tmp + len);
    cursor += (int64_t)len * counts[i];
  }
  const int64_t total = cursor;
  byte_off.push_back(total);
  const size_t n_runs = line_off.size();

  const int64_t CHUNK = 0xff00;
  const int64_t nblocks_all = (total + CHUNK - 1) / CHUNK;
  if (block_lo < 0) block_lo = 0;
  if (block_hi < 0 || block_hi > nblocks_all) block_hi = nblocks_all;
  if (block_lo > block_hi) block_lo = block_hi;
  const size_t nblocks = (size_t)(block_hi - block_lo);
  std::vector<std::vector<uint8_t>> outs(nblocks);
  std::atomic<size_t> next(0);
  std::atomic<bool> ok(true);
  auto worker = [&]() {
    std::vector<uint8_t> text((size_t)CHUNK);
    std::vector<uint8_t> comp((size_t)CHUNK + 8 * 1024);
    // (value, phase) -> finished BGZF block bytes, for blocks wholly inside
    // one run.  Per-worker (no locking); identical inputs deflate to
    // identical bytes, so caching never changes the output.
    std::unordered_map<uint64_t, std::vector<uint8_t>> cache;
    std::unordered_map<int64_t, ValCrcLadder> crc_cache;
    while (true) {
      size_t slot = next.fetch_add(1);
      if (slot >= nblocks || !ok.load()) break;
      const size_t bi = (size_t)block_lo + slot;
      const int64_t s = (int64_t)bi * CHUNK;
      const int64_t e = std::min<int64_t>(s + CHUNK, total);
      const size_t len = (size_t)(e - s);
      uint64_t ckey = 0;
      bool cacheable = false;
      if (len == (size_t)CHUNK && s >= header_len && n_runs) {
        size_t ri = (size_t)(std::upper_bound(byte_off.begin(),
                                              byte_off.end() - 1, s) -
                             byte_off.begin()) - 1;
        if (byte_off[ri] <= s && byte_off[ri + 1] >= e) {
          const int ll = (int)line_len[ri];
          const int phase = (int)((s - byte_off[ri]) % ll);
          // value < 2^58 always (depth sums); 5 bits of phase fit beside it
          ckey = ((uint64_t)run_val[ri] << 5) | (uint64_t)phase;
          cacheable = true;
          auto it = cache.find(ckey);
          if (it != cache.end()) {
            outs[slot] = it->second;
            continue;
          }
        }
      }
      size_t clen;
      uint32_t crc;
      if (level <= 1) {
        // --- RLE token path: deflate stream + CRC straight from the runs;
        // the block's text is never materialized ---
        RleBitWriter bw{comp.data(), comp.size()};
        bw.put(3, 3);  // BFINAL=1, BTYPE=01 (fixed Huffman)
        crc = 0;
        bool first_piece = true;
        auto add_crc = [&](uint32_t c, uint64_t l) {
          if (!l) return;
          crc = first_piece ? c : crc_combine(crc, c, l);
          first_piece = false;
        };
        // short segments accumulate in `text` and CRC once per stretch —
        // per-segment combine calls would dominate on dense (many-run) data
        size_t pend = 0;
        auto flush_pend = [&]() {
          if (!pend) return;
          add_crc(libdeflate_crc32(0, text.data(), pend), (uint64_t)pend);
          pend = 0;
        };
        int64_t q = s;
        if (q < header_len) {
          size_t h = (size_t)std::min<int64_t>(header_len - q, (int64_t)len);
          for (size_t i = 0; i < h; i++) rle_put_lit(bw, header[q + i]);
          memcpy(text.data(), header + q, h);
          pend = h;
          q += (int64_t)h;
        }
        if (q < e && n_runs) {
          size_t ri = (size_t)(std::upper_bound(byte_off.begin(),
                                                byte_off.end() - 1, q) -
                               byte_off.begin()) - 1;
          while (q < e && ri < n_runs) {
            const char* lp = line_buf.data() + line_off[ri];
            const uint8_t* lpu = (const uint8_t*)lp;
            const int ll = (int)line_len[ri];
            const int64_t stop = std::min(byte_off[ri + 1], e);
            const int64_t m = stop - q;
            const int phase = (int)((q - byte_off[ri]) % ll);
            // tokens: one period of literals, then distance-`ll` matches
            const int64_t lit = std::min<int64_t>(ll, m);
            for (int64_t i = 0; i < lit; i++)
              rle_put_lit(bw, lpu[(phase + i) % ll]);
            int64_t pos = lit, r = m - lit;
            while (r > 0) {
              int64_t take = r < 258 ? r : 258;
              if (take < 3) {
                for (int64_t i = 0; i < take; i++)
                  rle_put_lit(bw, lpu[(phase + pos + i) % ll]);
              } else {
                rle_put_match(bw, (int)take, ll);
              }
              pos += take;
              r -= take;
            }
            // crc: head partial line + 2^j-line ladder + tail partial line
            if (m < 4096) {
              // one (phase-rotated) period, then doubling memcpy expansion
              // (`done` stays a multiple of ll, so the copied prefix is
              // periodic-aligned) — per-line 3-6 byte memcpys were the
              // dense-case fill bottleneck
              uint8_t* tb = text.data() + pend;
              const int64_t first = std::min<int64_t>(ll, m);
              for (int64_t i = 0; i < first; i++)
                tb[i] = lpu[(phase + i) % ll];
              int64_t done = first;
              while (done < m) {
                int64_t cpy = std::min(done, m - done);
                memcpy(tb + done, tb, (size_t)cpy);
                done += cpy;
              }
              pend += (size_t)m;
            } else {
              flush_pend();
              int64_t head = phase ? (ll - phase) : 0;
              if (head > m) head = m;
              if (head)
                add_crc(libdeflate_crc32(0, lpu + phase, (size_t)head),
                        (uint64_t)head);
              const uint64_t k = (uint64_t)(m - head) / (uint64_t)ll;
              const int64_t tail = (m - head) % ll;
              if (k) {
                ValCrcLadder& vc = crc_cache[run_val[ri]];
                if (!vc.init) {
                  vc.pow[0] = libdeflate_crc32(0, lpu, (size_t)ll);
                  vc.init = true;
                }
                add_crc(crc_k_lines(vc, ll, k), k * (uint64_t)ll);
              }
              if (tail)
                add_crc(libdeflate_crc32(0, lpu, (size_t)tail),
                        (uint64_t)tail);
            }
            q = stop;
            ri++;
          }
        }
        flush_pend();
        bw.put(0, 7);  // end-of-block (code 256)
        clen = bw.finish();
      } else {
        // --- generate this block's text, then libdeflate ---
        int64_t q = s;
        size_t w = 0;
        if (q < header_len) {
          size_t h = (size_t)std::min<int64_t>(header_len - q, (int64_t)len);
          memcpy(text.data(), header + q, h);
          w += h;
          q += (int64_t)h;
        }
        if (q < e && n_runs) {
          // first run whose byte range contains q
          size_t ri = (size_t)(std::upper_bound(byte_off.begin(),
                                                byte_off.end() - 1, q) -
                               byte_off.begin()) - 1;
          while (q < e && ri < n_runs) {
            const char* lp = line_buf.data() + line_off[ri];
            const int ll = (int)line_len[ri];
            int64_t run_end = byte_off[ri + 1];
            int64_t stop = std::min(run_end, e);
            int phase = (int)((q - byte_off[ri]) % ll);
            while (q < stop) {
              int take = (int)std::min<int64_t>(ll - phase, stop - q);
              memcpy(text.data() + w, lp + phase, (size_t)take);
              w += (size_t)take;
              q += take;
              phase = 0;
            }
            ri++;
          }
        }
        clen = libdeflate_deflate_compress(tl_compressor(level), text.data(),
                                           len, comp.data(), comp.size());
        crc = libdeflate_crc32(0, text.data(), len);
      }
      if (!clen) {
        ok.store(false);
        break;
      }
      uint32_t bsize = (uint32_t)(clen + 26);
      std::vector<uint8_t>& o = outs[slot];
      o.reserve(bsize);
      const uint8_t hdr[12] = {0x1f, 0x8b, 8, 4, 0, 0, 0, 0, 0, 0xff, 6, 0};
      o.insert(o.end(), hdr, hdr + 12);
      uint8_t extra[6] = {66, 67, 2, 0, (uint8_t)((bsize - 1) & 0xff),
                          (uint8_t)(((bsize - 1) >> 8) & 0xff)};
      o.insert(o.end(), extra, extra + 6);
      o.insert(o.end(), comp.data(), comp.data() + clen);
      uint8_t tail[8];
      memcpy(tail, &crc, 4);
      uint32_t is = (uint32_t)len;
      memcpy(tail + 4, &is, 4);
      o.insert(o.end(), tail, tail + 8);
      if (cacheable) cache.emplace(ckey, o);
    }
  };
  if (nthreads <= 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < nthreads; t++) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  }
  if (!ok.load()) return false;
  size_t out_total = 0;
  for (auto& o : outs) out_total += o.size();
  result.reserve(out_total);
  for (auto& o : outs) result.insert(result.end(), o.begin(), o.end());
  return true;
}

GCI_API void* gci_depth_runs_to_bgzf(const int64_t* vals,
                                     const int64_t* counts, int64_t n,
                                     const uint8_t* header,
                                     int64_t header_len, int level,
                                     int nthreads) {
  auto* b = new Buffer();
  if (!depth_runs_bgzf_core(vals, counts, n, header, header_len, level,
                            nthreads, 0, -1, b->data)) {
    delete b;
    return nullptr;
  }
  return b;
}

// Total BGZF block count for a (header, runs) stream — lets the distributed
// writer partition [0, nblocks) into per-host contiguous ranges up front.
GCI_API int64_t gci_depth_runs_bgzf_nblocks(const int64_t* counts, int64_t n,
                                            const int64_t* vals,
                                            int64_t header_len) {
  int64_t total = header_len;
  for (int64_t i = 0; i < n; i++) {
    if (counts[i] <= 0) continue;
    int64_t v = vals[i];
    int w = 1;
    while (v >= 10) {
      v /= 10;
      w++;
    }
    total += (int64_t)(w + 1) * counts[i];
  }
  return (total + 0xff00 - 1) / 0xff00;
}

GCI_API void* gci_depth_runs_to_bgzf_range(const int64_t* vals,
                                           const int64_t* counts, int64_t n,
                                           const uint8_t* header,
                                           int64_t header_len, int level,
                                           int nthreads, int64_t block_lo,
                                           int64_t block_hi) {
  auto* b = new Buffer();
  if (!depth_runs_bgzf_core(vals, counts, n, header, header_len, level,
                            nthreads, block_lo, block_hi, b->data)) {
    delete b;
    return nullptr;
  }
  return b;
}

GCI_API void* gci_bgzf_eof_block() {
  auto* b = new Buffer();
  b->data.assign(BGZF_EOF_BLOCK, BGZF_EOF_BLOCK + sizeof(BGZF_EOF_BLOCK));
  return b;
}

// ===========================================================================
// Run-space depth decode: .depth.gz -> per-target (value, count) runs.
// Makes resume-from-checkpoint O(runs) in memory instead of O(genome)
// (utility/GCI_score.py:11-39 semantics, event-space representation).
// ===========================================================================
struct DepthRuns {
  std::string error;
  std::vector<std::string> names;
  std::vector<int64_t> run_off;  // per-target start into runs; size n+1
  std::vector<int64_t> run_values;
  std::vector<int64_t> run_counts;
};

namespace {
struct RunEvent {
  // value >= 0: run; value == -1: header (name_idx into local_names)
  int64_t value;
  int64_t count;
};
struct RunChunk {
  std::vector<std::string> names;
  std::vector<RunEvent> events;
  bool bad = false;
};

static void parse_runs_range(const uint8_t* p, size_t s, size_t e,
                             RunChunk& out) {
  size_t i = s;
  int64_t cur_val = -2;
  int64_t cur_cnt = 0;
  auto flush = [&]() {
    if (cur_cnt) out.events.push_back({cur_val, cur_cnt});
    cur_cnt = 0;
    cur_val = -2;
  };
  while (i < e) {
    uint8_t b = p[i];
    if (b == '>') {
      size_t j = i + 1;
      while (j < e && p[j] != '\n') j++;
      size_t he = j;
      while (he > i + 1 && (p[he - 1] == '\r' || p[he - 1] == ' ')) he--;
      size_t hs = i + 1;
      for (size_t k = he; k > i + 1; k--) {
        if (p[k - 1] == '>') {
          hs = k;
          break;
        }
      }
      flush();
      out.names.emplace_back(reinterpret_cast<const char*>(p) + hs, he - hs);
      out.events.push_back({-1, (int64_t)out.names.size() - 1});
      i = j + 1;
    } else if (b == '\n' || b == '\r') {
      i++;
    } else {
      size_t ls = i;
      int64_t v = 0;
      bool any = false;
      while (i < e && p[i] >= '0' && p[i] <= '9') {
        v = v * 10 + (p[i] - '0');
        i++;
        any = true;
      }
      while (i < e && p[i] != '\n') i++;
      if (i < e) i++;
      if (!any) {
        out.bad = true;
        return;
      }
      int64_t reps = 1;
      // periodic fast path: checkpoints are dominated by runs of identical
      // lines; extend with 8-byte period-L compares (memcmp speed) instead
      // of re-parsing every line.  A period-L byte match cannot cross a
      // '>' header (no '>' in a digit line), so run/record boundaries are
      // preserved exactly.
      size_t L = i - ls;
      if (L > 0 && p[i - 1] == '\n' && i < e) {
        size_t x = i;
        while (x + 8 <= e) {
          uint64_t a, b;
          memcpy(&a, p + x, 8);
          memcpy(&b, p + x - L, 8);
          if (a != b) break;
          x += 8;
        }
        while (x < e && p[x] == p[x - L]) x++;
        size_t extra = (x - i) / L;
        reps += (int64_t)extra;
        i += extra * L;
      }
      if (v == cur_val) {
        cur_cnt += reps;
      } else {
        flush();
        cur_val = v;
        cur_cnt = reps;
      }
    }
  }
  flush();
}
}  // namespace

// Parse [0, n) of inflated text into dr via T parallel line-aligned
// sub-ranges, coalescing runs across every border.
static bool parse_runs_buffer(DepthRuns* dr, const uint8_t* p, size_t n,
                              int nthreads, bool* seen_header) {
  int T = nthreads > 1 ? nthreads : 1;
  if ((size_t)T > n / (1 << 20) + 1) T = (int)(n / (1 << 20) + 1);
  std::vector<size_t> starts(T + 1, n);
  starts[0] = 0;
  for (int t = 1; t < T; t++) {
    size_t cand = n * (size_t)t / (size_t)T;
    const uint8_t* nl = (const uint8_t*)memchr(p + cand, '\n', n - cand);
    starts[t] = nl ? (size_t)(nl - p) + 1 : n;
  }
  for (int t = 1; t < T; t++)
    if (starts[t] < starts[t - 1]) starts[t] = starts[t - 1];
  std::vector<RunChunk> chunks((size_t)T);
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < T; t++) {
      ts.emplace_back([&, t]() {
        parse_runs_range(p, starts[t], starts[t + 1], chunks[(size_t)t]);
      });
    }
    for (auto& th : ts) th.join();
  }
  for (auto& ch : chunks) {
    if (ch.bad) {
      dr->error = "malformed depth line";
      return false;
    }
    for (auto& ev : ch.events) {
      if (ev.value == -1) {
        dr->names.push_back(std::move(ch.names[(size_t)ev.count]));
        dr->run_off.push_back((int64_t)dr->run_values.size());
        *seen_header = true;
      } else {
        if (!*seen_header) {
          dr->error = "depth file has no '>' target header";
          return false;
        }
        // coalesce runs split across chunk borders
        if (!dr->run_values.empty() &&
            dr->run_off.back() < (int64_t)dr->run_values.size() &&
            dr->run_values.back() == ev.value) {
          dr->run_counts.back() += ev.count;
        } else {
          dr->run_values.push_back(ev.value);
          dr->run_counts.push_back(ev.count);
        }
      }
    }
  }
  return true;
}

GCI_API void* gci_depth_decode_runs_file(const char* path, int nthreads) {
  const bool dbg = getenv("GCI_NATIVE_DEBUG") != nullptr;
  auto now = []() {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  };
  double t0 = now();
  auto* dr = new DepthRuns();
  std::vector<uint8_t> raw;
  if (!read_file(path, raw)) {
    dr->error = "cannot read file";
    return dr;
  }
  double t1 = now();
  const uint8_t* p = raw.data();
  size_t n = raw.size();
  bool seen_header = false;
  std::vector<BgzfBlock> blocks;
  size_t total = 0;
  if (n >= 2 && p[0] == 0x1f && p[1] == 0x8b &&
      bgzf_scan(p, n, blocks, total)) {
    // Windowed decode: the expanded text (tens of GB for a genome) is
    // never materialized whole — inflate ~64 MB of blocks at a time into a
    // reused buffer (parallel), parse up to the last newline, carry the
    // partial line.  O(runs + window) memory; also avoids the multi-GB
    // value-init/first-touch cost (measured 29 s for 6.2 GB on this host).
    const size_t WIN = 64u << 20;
    std::vector<uint8_t> win;
    std::vector<uint8_t> carry;
    size_t bi = 0;
    double t_infl = 0, t_parse = 0;
    while (bi < blocks.size()) {
      size_t start = bi;
      size_t tot = 0;
      while (bi < blocks.size() && tot < WIN) {
        tot += blocks[bi].isize;
        bi++;
      }
      size_t clen = carry.size();
      win.resize(clen + tot);
      if (clen) memcpy(win.data(), carry.data(), clen);
      double ti = now();
      {
        std::atomic<size_t> next(start);
        std::atomic<bool> ok(true);
        size_t base_off = blocks[start].out_off;
        auto worker = [&]() {
          while (true) {
            size_t k = next.fetch_add(1);
            if (k >= bi || !ok.load()) break;
            const BgzfBlock& b = blocks[k];
            if (b.isize == 0) continue;
            if (!inflate_raw(p + b.comp_off, b.comp_len,
                             win.data() + clen + (b.out_off - base_off),
                             b.isize))
              ok.store(false);
          }
        };
        int T = nthreads > 1 ? nthreads : 1;
        std::vector<std::thread> ts;
        for (int t = 1; t < T; t++) ts.emplace_back(worker);
        worker();
        for (auto& th : ts) th.join();
        if (!ok.load()) {
          dr->error = "bgzf decompress failed";
          return dr;
        }
      }
      t_infl += now() - ti;
      size_t usable = win.size();
      bool last = bi == blocks.size();
      if (!last) {
        size_t cut = usable;
        while (cut > 0 && win[cut - 1] != '\n') cut--;
        if (cut == 0) {
          carry.assign(win.begin(), win.end());
          continue;  // no newline yet: grow with the next window
        }
        carry.assign(win.begin() + cut, win.end());
        usable = cut;
      } else {
        carry.clear();
      }
      ti = now();
      if (!parse_runs_buffer(dr, win.data(), usable, nthreads, &seen_header))
        return dr;
      t_parse += now() - ti;
    }
    if (dbg)
      fprintf(stderr,
              "[gci_native] decode_runs(windowed) read=%.2fs inflate=%.2fs "
              "parse=%.2fs inflated=%zu\n",
              t1 - t0, t_infl, t_parse, total);
  } else {
    // plain gzip (reference writer) or uncompressed: whole-buffer path
    std::vector<uint8_t> inflated;
    if (n >= 2 && p[0] == 0x1f && p[1] == 0x8b) {
      if (!gzip_inflate_all(p, n, inflated)) {
        dr->error = "gzip inflate failed";
        return dr;
      }
      p = inflated.data();
      n = inflated.size();
    }
    if (!parse_runs_buffer(dr, p, n, nthreads, &seen_header)) return dr;
  }
  dr->run_off.push_back((int64_t)dr->run_values.size());
  return dr;
}

GCI_API void gci_druns_free(void* h) { delete (DepthRuns*)h; }
GCI_API const char* gci_druns_error(void* h) {
  auto* dr = (DepthRuns*)h;
  return dr->error.empty() ? nullptr : dr->error.c_str();
}
GCI_API int64_t gci_druns_num_targets(void* h) {
  return (int64_t)((DepthRuns*)h)->names.size();
}
GCI_API const char* gci_druns_target_name(void* h, int64_t i) {
  return ((DepthRuns*)h)->names[(size_t)i].c_str();
}
GCI_API int64_t gci_druns_target_nruns(void* h, int64_t i) {
  auto* dr = (DepthRuns*)h;
  return dr->run_off[(size_t)i + 1] - dr->run_off[(size_t)i];
}
GCI_API void gci_druns_copy_target(void* h, int64_t i, int64_t* values,
                                   int64_t* counts) {
  auto* dr = (DepthRuns*)h;
  int64_t s = dr->run_off[(size_t)i];
  int64_t e = dr->run_off[(size_t)i + 1];
  if (e > s) {
    memcpy(values, dr->run_values.data() + s, (size_t)(e - s) * sizeof(int64_t));
    memcpy(counts, dr->run_counts.data() + s, (size_t)(e - s) * sizeof(int64_t));
  }
}

// ===========================================================================
// Streaming BAM reader: bounded-memory chunk pipeline.
//
// TPU-native replacement for the reference's windowed pysam fetch
// (GCI.py:146-169, task split GCI.py:260-270): a background producer reads
// BGZF blocks sequentially, inflates them on a small thread pool
// (libdeflate), walks the record chain across block boundaries, and emits
// packed column chunks.  Peak memory is O(chunk + carry), not O(file):
// buffers are reused across chunks so the first-touch page-fault cost is
// paid once.  Byte ranges [coff_start, coff_end) enable per-host input
// sharding: a shard owns exactly the records whose first byte lies in a
// BGZF block whose file offset is inside the range (the Hadoop-BAM split
// convention), with heuristic record resync at non-zero starts.
// ===========================================================================
namespace {

struct StreamChunk {
  std::vector<int32_t> ref_id, pos, ref_end, qlen, mapq, flag;
  std::vector<int32_t> cig_m, cig_i, cig_d, cig_s, cig_eq, cig_x, nm;
  std::vector<uint64_t> h1, h2;
  std::vector<int64_t> name_off;  // n+1 when keep_names
  std::string name_blob;
  // raw record bytes (keep_raw): rec_off[i] points at record i's
  // block_size field within body
  std::vector<uint8_t> body;
  std::vector<int64_t> rec_off;
};

enum RecCheck { REC_BAD = 0, REC_PENDING = 1, REC_VALID = 2 };

// Validate a candidate record start at p (avail bytes visible).
static RecCheck validate_one_record(const uint8_t* p, size_t avail,
                                    int64_t n_ref) {
  if (avail < 36) return REC_PENDING;
  uint32_t bs = rd_u32(p);
  if (bs < 32 || bs > (1u << 26)) return REC_BAD;
  int32_t refID = rd_i32(p + 4);
  if (refID < -1 || refID >= (int32_t)n_ref) return REC_BAD;
  if (rd_i32(p + 8) < -1) return REC_BAD;
  uint8_t l_read_name = p[12];
  if (l_read_name == 0) return REC_BAD;
  uint16_t n_cigar = rd_u16(p + 16);
  int32_t l_seq = rd_i32(p + 20);
  if (l_seq < 0) return REC_BAD;
  int32_t next_refID = rd_i32(p + 24);
  if (next_refID < -1 || next_refID >= (int32_t)n_ref) return REC_BAD;
  if (rd_i32(p + 28) < -1) return REC_BAD;
  uint64_t min_size = 32ull + l_read_name + 4ull * n_cigar +
                      ((uint64_t)l_seq + 1) / 2 + (uint64_t)l_seq;
  if (min_size > bs) return REC_BAD;
  size_t name_end = 36ull + l_read_name;  // NUL included in l_read_name
  if (avail >= name_end) {
    if (p[name_end - 1] != 0) return REC_BAD;
    size_t cig_avail = std::min<size_t>(n_cigar, (avail - name_end) / 4);
    for (size_t c = 0; c < cig_avail; c++) {
      if ((rd_u32(p + name_end + 4 * c) & 0xf) > 8) return REC_BAD;
    }
  }
  return avail >= 4ull + bs ? REC_VALID : REC_PENDING;
}

// Validate a chain of records starting at p.  `min_end_ok` is the number of
// fully validated records required to accept an end-of-buffer-aligned chain
// (2 normally; 1 once the file is at EOF so a final short chain can close).
static RecCheck validate_record_chain(const uint8_t* buf, size_t size,
                                      size_t p, int64_t n_ref,
                                      int min_end_ok) {
  int ok = 0;
  size_t q = p;
  while (ok < 3) {
    if (q == size) return ok >= min_end_ok ? REC_VALID : REC_PENDING;
    RecCheck v = validate_one_record(buf + q, size - q, n_ref);
    if (v != REC_VALID) return v;
    ok++;
    q += 4ull + rd_u32(buf + q);
    if (q > size) return REC_BAD;  // block_size overran the buffer
  }
  return REC_VALID;
}

struct BamStream {
  FILE* f = nullptr;
  int nthreads = 2;
  bool keep_names = false;
  bool keep_raw = false;
  int64_t coff_limit = -1;  // records starting at block coff >= this are not ours
  size_t chunk_target = 64u << 20;  // inflated bytes per chunk
  // header
  std::vector<std::string> ref_names;
  std::vector<int64_t> ref_lens;
  std::string header_text;
  std::string error;
  // compressed-side state (producer only)
  std::vector<uint8_t> comp_buf;
  size_t comp_pos = 0;
  int64_t comp_base_coff = 0;  // absolute file offset of comp_buf[0]
  bool file_eof = false;
  // inflated-side state (producer only)
  std::vector<uint8_t> infl;   // carry + this chunk's inflated blocks
  std::vector<uint8_t> carry;  // leftover bytes (partial record / unsynced)
  // (offset in carry, block coff) map; single entry in synced mode
  std::vector<std::pair<size_t, int64_t>> carry_map;
  bool synced = true;          // false until record resync done (range mode)
  size_t resync_from = 0;      // scan cursor within carry while unsynced
  bool finished = false;
  int64_t stop_block_coff = -1;
  // pipeline
  std::thread producer;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<StreamChunk*> ready;
  bool producer_done = false;
  bool closing = false;
  size_t max_ready = 2;
  // phase attribution (GCI_NATIVE_DEBUG): producer wall per phase
  double t_read = 0, t_inflate = 0, t_walk = 0, t_parse = 0, t_wait = 0;

  ~BamStream() {
    {
      std::lock_guard<std::mutex> lk(mu);
      closing = true;
    }
    cv_push.notify_all();
    cv_pop.notify_all();
    if (producer.joinable()) producer.join();
    for (auto* c : ready) delete c;
    if (f) fclose(f);
  }
};

// Producer-side error reporting: the consumer reads `error` under `mu`
// (gci_bam_stream_error), so the producer must write it under `mu` too —
// and only once, so the c_str() the consumer saw can never be reallocated.
static void stream_set_error(BamStream* bs, const char* msg) {
  std::lock_guard<std::mutex> lk(bs->mu);
  if (bs->error.empty()) bs->error = msg;
}

// Ensure comp_buf holds >= need bytes beyond comp_pos (reads more from the
// file).  Returns false when EOF prevents it.
static bool stream_ensure_comp(BamStream* bs, size_t need) {
  while (bs->comp_buf.size() - bs->comp_pos < need) {
    if (bs->file_eof) return false;
    size_t old = bs->comp_buf.size();
    size_t want = std::max<size_t>(need - (old - bs->comp_pos), 4u << 20);
    bs->comp_buf.resize(old + want);
    size_t got = fread(bs->comp_buf.data() + old, 1, want, bs->f);
    bs->comp_buf.resize(old + got);
    if (got < want) bs->file_eof = true;
  }
  return true;
}

// Parse the BGZF header at comp_pos.  Returns total block size (0 = EOF /
// no more blocks, -1 = corrupt).
static int64_t stream_next_block_size(BamStream* bs) {
  if (!stream_ensure_comp(bs, 18)) {
    return bs->comp_buf.size() - bs->comp_pos == 0 ? 0 : -1;
  }
  const uint8_t* p = bs->comp_buf.data() + bs->comp_pos;
  if (!(p[0] == 0x1f && p[1] == 0x8b && p[2] == 8 && (p[3] & 4))) return -1;
  uint16_t xlen = (uint16_t)(p[10] | (p[11] << 8));
  if (!stream_ensure_comp(bs, 12ull + xlen)) return -1;
  p = bs->comp_buf.data() + bs->comp_pos;
  uint32_t bsize = 0;
  for (size_t q = 12; q + 4 <= 12ull + xlen;) {
    uint8_t si1 = p[q], si2 = p[q + 1];
    uint16_t slen = (uint16_t)(p[q + 2] | (p[q + 3] << 8));
    if (si1 == 66 && si2 == 67 && slen == 2) {
      bsize = (uint32_t)(p[q + 4] | (p[q + 5] << 8)) + 1u;
    }
    q += 4ull + slen;
  }
  if (bsize < 28 || bsize > 65536) return -1;
  if (!stream_ensure_comp(bs, bsize)) return -1;
  return (int64_t)bsize;
}

struct StreamBlock {
  size_t payload_off;  // into comp_buf
  uint32_t payload_len;
  uint32_t isize;
  int64_t coff;     // absolute file offset of the block start
  size_t out_off;   // into infl (after carry)
};

// Build one chunk.  Returns the chunk (possibly empty of records), or null
// when the stream is finished (EOF / shard boundary) or errored.
static StreamChunk* stream_build_chunk(BamStream* bs) {
  if (bs->finished) return nullptr;
  auto now = []() {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  };
  double tp0 = now();
  // compact the compressed buffer
  if (bs->comp_pos) {
    bs->comp_buf.erase(bs->comp_buf.begin(),
                       bs->comp_buf.begin() + bs->comp_pos);
    bs->comp_base_coff += (int64_t)bs->comp_pos;
    bs->comp_pos = 0;
  }
  // --- gather blocks ---
  std::vector<StreamBlock> blocks;
  size_t total_isize = 0;
  while (total_isize < bs->chunk_target) {
    int64_t coff = bs->comp_base_coff + (int64_t)bs->comp_pos;
    if (bs->coff_limit >= 0 && coff >= bs->coff_limit &&
        bs->stop_block_coff < 0)
      bs->stop_block_coff = coff;
    if (bs->stop_block_coff >= 0 && bs->synced && bs->carry.empty() &&
        blocks.empty()) {
      // nothing in flight crosses the boundary: the shard is complete
      bs->finished = true;
      break;
    }
    int64_t bsize = stream_next_block_size(bs);
    if (bsize < 0) {
      stream_set_error(bs, "corrupt BGZF stream");
      return nullptr;
    }
    if (bsize == 0) break;  // file EOF
    const uint8_t* p = bs->comp_buf.data() + bs->comp_pos;
    uint16_t xlen = (uint16_t)(p[10] | (p[11] << 8));
    uint32_t isize = (uint32_t)(p[bsize - 4] | (p[bsize - 3] << 8) |
                                (p[bsize - 2] << 16) |
                                ((uint32_t)p[bsize - 1] << 24));
    StreamBlock b;
    b.payload_off = bs->comp_pos + 12 + xlen;
    b.payload_len = (uint32_t)(bsize - 20 - xlen);
    b.isize = isize;
    b.coff = coff;
    b.out_off = total_isize;
    if (isize) blocks.push_back(b);
    total_isize += isize;
    bs->comp_pos += (size_t)bsize;
  }
  const size_t carry_len = bs->carry.size();
  bool final_drain = false;
  if (blocks.empty() && total_isize == 0) {
    // no new data: EOF (or shard end hit above)
    if (bs->finished || bs->carry.empty()) {
      bs->finished = true;
      return nullptr;
    }
    if (!bs->file_eof || bs->comp_buf.size() - bs->comp_pos != 0) {
      bs->finished = true;  // defensive: avoid spinning
      return nullptr;
    }
    if (!bs->synced &&
        validate_record_chain(bs->carry.data(), bs->carry.size(),
                              bs->resync_from,
                              (int64_t)bs->ref_names.size(),
                              1) != REC_VALID) {
      // never found a record boundary before EOF: empty shard tail
      bs->finished = true;
      return nullptr;
    }
    // fall through: the walk below drains the carry's complete records
    final_drain = true;
  }
  // --- inflate: infl = carry + blocks ---
  double tp1 = now();
  bs->t_read += tp1 - tp0;
  bs->infl.resize(carry_len + total_isize);
  if (carry_len) memcpy(bs->infl.data(), bs->carry.data(), carry_len);
  {
    std::atomic<size_t> next(0);
    std::atomic<bool> ok(true);
    auto worker = [&]() {
      while (true) {
        size_t i = next.fetch_add(1);
        if (i >= blocks.size() || !ok.load()) break;
        const StreamBlock& b = blocks[i];
        if (!inflate_raw(bs->comp_buf.data() + b.payload_off, b.payload_len,
                         bs->infl.data() + carry_len + b.out_off, b.isize))
          ok.store(false);
      }
    };
    int T = bs->nthreads > 1 ? bs->nthreads : 1;
    if ((size_t)T > blocks.size()) T = blocks.size() ? (int)blocks.size() : 1;
    if (T <= 1) {
      worker();
    } else {
      std::vector<std::thread> ts;
      for (int t = 0; t < T; t++) ts.emplace_back(worker);
      for (auto& th : ts) th.join();
    }
    if (!ok.load()) {
      stream_set_error(bs, "BGZF inflate failed");
      return nullptr;
    }
  }
  double tp2 = now();
  bs->t_inflate += tp2 - tp1;
  const uint8_t* buf = bs->infl.data();
  const size_t size = bs->infl.size();
  // offset -> block coff map over the walk buffer
  std::vector<std::pair<size_t, int64_t>> off2coff;
  off2coff.reserve(bs->carry_map.size() + blocks.size());
  for (auto& e : bs->carry_map) off2coff.push_back(e);
  for (auto& b : blocks)
    off2coff.emplace_back(carry_len + b.out_off, b.coff);
  auto coff_of = [&](size_t p) -> int64_t {
    if (off2coff.empty()) return bs->comp_base_coff;
    size_t lo = 0, hi = off2coff.size();
    while (lo + 1 < hi) {
      size_t mid = (lo + hi) / 2;
      if (off2coff[mid].first <= p) lo = mid; else hi = mid;
    }
    return off2coff[lo].second;
  };
  // --- resync (range mode, until the first record boundary is found) ---
  size_t walk_start = 0;
  if (!bs->synced) {
    const int64_t n_ref = (int64_t)bs->ref_names.size();
    const int min_end_ok = bs->file_eof && blocks.empty() ? 1 : 2;
    size_t p = bs->resync_from;
    bool found = false;
    size_t pend = size;
    for (; p < size; p++) {
      RecCheck r = validate_record_chain(buf, size, p, n_ref, min_end_ok);
      if (r == REC_VALID) {
        found = true;
        break;
      }
      if (r == REC_PENDING) {
        pend = p;
        break;  // need more data before skipping this candidate
      }
    }
    if (!found) {
      if (bs->file_eof && blocks.empty()) {
        // end of file, nothing synced: shard had no records
        bs->finished = true;
        if (pend < size) stream_set_error(bs, "truncated BAM record");
        return nullptr;
      }
      // keep [pend, size) (or a 36-byte tail) and scan again with more data
      size_t keep_from = pend < size ? pend : (size > 36 ? size - 36 : 0);
      std::vector<std::pair<size_t, int64_t>> nm;
      for (size_t k = 0; k < off2coff.size(); k++) {
        size_t s = std::max(off2coff[k].first, keep_from);
        size_t e2 = k + 1 < off2coff.size() ? off2coff[k + 1].first : size;
        if (e2 > keep_from && s < e2) nm.emplace_back(s - keep_from, off2coff[k].second);
      }
      bs->carry.assign(buf + keep_from, buf + size);
      bs->carry_map = std::move(nm);
      bs->resync_from = 0;
      if (bs->carry.size() > (512u << 20)) {
        stream_set_error(bs, "cannot resync BAM records in byte range");
        return nullptr;
      }
      return new StreamChunk();  // empty chunk; caller keeps pulling
    }
    walk_start = p;
    bs->synced = true;
    bs->resync_from = 0;
  }
  // --- walk the record chain ---
  std::vector<size_t> offs;
  offs.reserve(total_isize / 300 + 8);
  size_t p = walk_start;
  size_t leftover = size;
  // ownership cut: a record is ours iff its block's coff < coff_limit.
  // Compare against coff_limit DIRECTLY (not stop_block_coff): when the
  // header read already consumed the block holding the first records, the
  // gather loop never sees that block, and stop_block_coff would be first
  // set at EOF — letting another shard's carried records leak into this
  // one (caught by test_four_process_zero_record_shard: double-packed
  // records masked downstream only by the name dedup).
  const int64_t stop_at =
      bs->coff_limit >= 0 ? bs->coff_limit : bs->stop_block_coff;
  while (p + 4 <= size) {
    uint32_t block_size = rd_u32(buf + p);
    if (p + 4ull + block_size > size) break;  // partial record -> carry
    if (stop_at >= 0 && coff_of(p) >= stop_at) {
      bs->finished = true;
      leftover = size;  // discard the rest: it belongs to the next shard
      p = size;
      break;
    }
    offs.push_back(p);
    p += 4ull + block_size;
  }
  if (p < size && !bs->finished) leftover = p;
  else if (bs->finished) leftover = size;
  else leftover = p;
  // new carry
  if (leftover < size && !bs->finished) {
    if (final_drain) {
      // EOF with a partial record left over: the file is cut short
      stream_set_error(bs, "truncated BAM record");
      return nullptr;
    }
    int64_t cc = coff_of(leftover);
    bs->carry.assign(buf + leftover, buf + size);
    bs->carry_map.assign(1, {0, cc});
  } else {
    bs->carry.clear();
    bs->carry_map.clear();
  }
  if (final_drain) bs->finished = true;
  double tp3 = now();
  bs->t_walk += tp3 - tp2;
  // --- parse records into the chunk (parallel ranges) ---
  auto* ch = new StreamChunk();
  size_t nrec = offs.size();
  ch->ref_id.resize(nrec);
  ch->pos.resize(nrec);
  ch->ref_end.resize(nrec);
  ch->qlen.resize(nrec);
  ch->mapq.resize(nrec);
  ch->flag.resize(nrec);
  ch->cig_m.resize(nrec);
  ch->cig_i.resize(nrec);
  ch->cig_d.resize(nrec);
  ch->cig_s.resize(nrec);
  ch->cig_eq.resize(nrec);
  ch->cig_x.resize(nrec);
  ch->nm.resize(nrec);
  ch->h1.resize(nrec);
  ch->h2.resize(nrec);
  std::vector<int64_t> name_lens(bs->keep_names ? nrec : 0);
  int T = bs->nthreads > 1 ? bs->nthreads : 1;
  if ((size_t)T > nrec) T = nrec ? (int)nrec : 1;
  std::vector<std::string> blobs((size_t)T);
  auto pworker = [&](int t) {
    size_t lo = nrec * (size_t)t / (size_t)T;
    size_t hi = nrec * (size_t)(t + 1) / (size_t)T;
    std::string& blob = blobs[(size_t)t];
    for (size_t i = lo; i < hi; i++) {
      RecFields o;
      parse_record_fields(buf + offs[i] + 4, rd_u32(buf + offs[i]), o);
      ch->ref_id[i] = o.ref_id;
      ch->pos[i] = o.pos;
      ch->ref_end[i] = o.ref_end;
      ch->qlen[i] = o.qlen;
      ch->mapq[i] = o.mapq;
      ch->flag[i] = o.flag;
      ch->cig_m[i] = o.m;
      ch->cig_i[i] = o.i;
      ch->cig_d[i] = o.d;
      ch->cig_s[i] = o.s;
      ch->cig_eq[i] = o.eq;
      ch->cig_x[i] = o.x;
      ch->nm[i] = o.nm;
      ch->h1[i] = o.h1;
      ch->h2[i] = o.h2;
      if (bs->keep_names) {
        name_lens[i] = (int64_t)o.rname_len;
        blob.append(o.rname, o.rname_len);
      }
    }
  };
  if (T <= 1) {
    pworker(0);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < T; t++) ts.emplace_back(pworker, t);
    for (auto& th : ts) th.join();
  }
  if (bs->keep_names) {
    ch->name_off.resize(nrec + 1);
    ch->name_off[0] = 0;
    for (size_t i = 0; i < nrec; i++)
      ch->name_off[i + 1] = ch->name_off[i] + name_lens[i];
    size_t tb = 0;
    for (auto& b : blobs) tb += b.size();
    ch->name_blob.reserve(tb);
    for (auto& b : blobs) ch->name_blob += b;
  }
  if (bs->keep_raw && nrec) {
    size_t lo = offs.front();
    size_t hi = offs.back() + 4ull + rd_u32(buf + offs.back());
    ch->body.assign(buf + lo, buf + hi);
    ch->rec_off.resize(nrec);
    for (size_t i = 0; i < nrec; i++)
      ch->rec_off[i] = (int64_t)(offs[i] - lo);
  }
  bs->t_parse += now() - tp3;
  return ch;
}

static void stream_producer(BamStream* bs) {
  while (true) {
    {
      std::lock_guard<std::mutex> lk(bs->mu);
      if (bs->closing) break;
    }
    StreamChunk* ch = stream_build_chunk(bs);
    std::unique_lock<std::mutex> lk(bs->mu);
    if (!ch) break;  // finished or error
    auto w0 = std::chrono::steady_clock::now();
    bs->cv_push.wait(lk, [&] {
      return bs->ready.size() < bs->max_ready || bs->closing;
    });
    bs->t_wait += std::chrono::duration<double>(
                      std::chrono::steady_clock::now() - w0)
                      .count();
    if (bs->closing) {
      delete ch;
      break;
    }
    bs->ready.push_back(ch);
    bs->cv_pop.notify_one();
  }
  {
    std::lock_guard<std::mutex> lk(bs->mu);
    bs->producer_done = true;
  }
  bs->cv_pop.notify_all();
}

// Read + parse the BAM header starting at file offset 0.  Leaves leftover
// inflated record bytes in carry (with block map) when keep_leftover.
static bool stream_read_header(BamStream* bs, bool keep_leftover) {
  std::vector<uint8_t> hdr;
  std::vector<std::pair<size_t, int64_t>> hmap;  // (infl off, block coff)
  size_t header_end = 0;
  while (true) {
    // try to parse with what we have
    const uint8_t* p = hdr.data();
    size_t n = hdr.size();
    bool need_more = false;
    do {
      if (n < 12) { need_more = true; break; }
      if (memcmp(p, "BAM\1", 4) != 0) {
        bs->error = "not a BAM stream";
        return false;
      }
      int64_t off = 4;
      int32_t l_text = rd_i32(p + off);
      off += 4;
      if ((int64_t)n < off + l_text + 4) { need_more = true; break; }
      bs->header_text.assign((const char*)p + off, (size_t)l_text);
      off += l_text;
      int32_t n_ref = rd_i32(p + off);
      off += 4;
      bs->ref_names.clear();
      bs->ref_lens.clear();
      bool ok = true;
      for (int32_t r = 0; r < n_ref; r++) {
        if ((int64_t)n < off + 4) { ok = false; break; }
        int32_t l_name = rd_i32(p + off);
        off += 4;
        if ((int64_t)n < off + l_name + 4) { ok = false; break; }
        bs->ref_names.emplace_back((const char*)p + off, (size_t)l_name - 1);
        off += l_name;
        bs->ref_lens.push_back(rd_i32(p + off));
        off += 4;
      }
      if (!ok) { need_more = true; break; }
      header_end = (size_t)off;
    } while (false);
    if (!need_more) break;
    // inflate one more block into hdr
    int64_t coff = bs->comp_base_coff + (int64_t)bs->comp_pos;
    int64_t bsize = stream_next_block_size(bs);
    if (bsize <= 0) {
      bs->error = "truncated BAM header";
      return false;
    }
    const uint8_t* bp = bs->comp_buf.data() + bs->comp_pos;
    uint16_t xlen = (uint16_t)(bp[10] | (bp[11] << 8));
    uint32_t isize = (uint32_t)(bp[bsize - 4] | (bp[bsize - 3] << 8) |
                                (bp[bsize - 2] << 16) |
                                ((uint32_t)bp[bsize - 1] << 24));
    size_t old = hdr.size();
    hdr.resize(old + isize);
    if (isize &&
        !inflate_raw(bp + 12 + xlen, (uint32_t)(bsize - 20 - xlen),
                     hdr.data() + old, isize)) {
      bs->error = "BGZF inflate failed in header";
      return false;
    }
    hmap.emplace_back(old, coff);
    bs->comp_pos += (size_t)bsize;
  }
  if (keep_leftover && header_end < hdr.size()) {
    bs->carry.assign(hdr.begin() + header_end, hdr.end());
    std::vector<std::pair<size_t, int64_t>> nm;
    for (size_t k = 0; k < hmap.size(); k++) {
      size_t s = std::max(hmap[k].first, header_end);
      size_t e2 = k + 1 < hmap.size() ? hmap[k + 1].first : hdr.size();
      if (e2 > header_end && s < e2)
        nm.emplace_back(s - header_end, hmap[k].second);
    }
    bs->carry_map = std::move(nm);
  }
  return true;
}

// Scan forward from comp_pos for a BGZF block boundary (magic + valid
// header chain).  Returns false when none exists before EOF.
static bool stream_scan_block_boundary(BamStream* bs) {
  while (true) {
    stream_ensure_comp(bs, 1u << 20);
    const uint8_t* p = bs->comp_buf.data();
    size_t n = bs->comp_buf.size();
    for (size_t q = bs->comp_pos; q + 18 <= n; q++) {
      if (!(p[q] == 0x1f && p[q + 1] == 0x8b && p[q + 2] == 8 &&
            (p[q + 3] & 4)))
        continue;
      uint16_t xlen = (uint16_t)(p[q + 10] | (p[q + 11] << 8));
      if (xlen < 6) continue;
      uint32_t bsize = 0;
      bool found = false;
      if (q + 12ull + xlen > n) break;  // need more data
      for (size_t e = q + 12; e + 4 <= q + 12ull + xlen;) {
        uint8_t si1 = p[e], si2 = p[e + 1];
        uint16_t slen = (uint16_t)(p[e + 2] | (p[e + 3] << 8));
        if (si1 == 66 && si2 == 67 && slen == 2) {
          bsize = (uint32_t)(p[e + 4] | (p[e + 5] << 8)) + 1u;
          found = true;
        }
        e += 4ull + slen;
      }
      if (!found || bsize < 28 || bsize > 65536) continue;
      // chain check: the next block must also look like BGZF (or EOF)
      size_t nq = q + bsize;
      if (nq == n && bs->file_eof) {
        bs->comp_pos = q;
        return true;
      }
      if (nq + 18 > n) {
        if (!bs->file_eof) break;  // need more data
        continue;
      }
      if (p[nq] == 0x1f && p[nq + 1] == 0x8b && p[nq + 2] == 8 &&
          (p[nq + 3] & 4)) {
        bs->comp_pos = q;
        return true;
      }
    }
    if (bs->file_eof) return false;
    // grow the window: keep scanning from just before the unscanned tail
    size_t scanned = n > bs->comp_pos + 17 ? n - 17 : bs->comp_pos;
    size_t old = n;
    stream_ensure_comp(bs, (n - bs->comp_pos) + (1u << 20));
    if (bs->comp_buf.size() == old && bs->file_eof) return false;
    bs->comp_pos = std::min(bs->comp_pos, scanned);
  }
}

}  // namespace

GCI_API void* gci_bam_stream_open(const char* path, int nthreads,
                                  int keep_names, int64_t coff_start,
                                  int64_t coff_end, int64_t chunk_bytes,
                                  int keep_raw) {
  auto* bs = new BamStream();
  bs->nthreads = nthreads > 0 ? nthreads : 1;
  bs->keep_names = keep_names != 0;
  bs->keep_raw = keep_raw != 0;
  if (chunk_bytes > 0) bs->chunk_target = (size_t)chunk_bytes;
  bs->f = fopen(path, "rb");
  if (!bs->f) {
    bs->error = "cannot open file";
    return bs;
  }
  // uncompressed BAMs ("BAM\1" magic, no BGZF framing) can't stream by
  // blocks — report a distinct error so the caller falls back to the
  // whole-file reader (gci_bam_open handles plain BAM)
  uint8_t magic4[4];
  size_t got4 = fread(magic4, 1, 4, bs->f);
  fseek(bs->f, 0, SEEK_SET);
  if (got4 == 4 && memcmp(magic4, "BAM\1", 4) == 0) {
    bs->error = "uncompressed BAM stream";
    return bs;
  }
  fseek(bs->f, 0, SEEK_END);
  int64_t fsize = ftell(bs->f);
  fseek(bs->f, 0, SEEK_SET);
  if (coff_end >= 0 && coff_end < fsize) bs->coff_limit = coff_end;
  // header always comes from offset 0 (every shard needs the ref table)
  if (!stream_read_header(bs, coff_start <= 0)) return bs;
  if (coff_start > 0) {
    if (coff_start >= fsize) {
      bs->finished = true;
    } else {
      // jump to the shard: reset compressed state, find a block boundary,
      // then resync to the first record that starts at/after it
      bs->comp_buf.clear();
      bs->comp_pos = 0;
      bs->comp_base_coff = coff_start;
      bs->file_eof = false;
      fseek(bs->f, (long)coff_start, SEEK_SET);
      bs->carry.clear();
      bs->carry_map.clear();
      if (!stream_scan_block_boundary(bs)) {
        bs->finished = true;  // no blocks in range
      } else {
        bs->synced = false;
      }
    }
  }
  bs->producer = std::thread(stream_producer, bs);
  return bs;
}

// Producer phase walls (seconds): 0=read 1=inflate 2=walk 3=parse 4=wait.
// Call after draining the stream (producer idle) for stable values.
GCI_API double gci_bam_stream_phase(void* h, int idx) {
  auto* bs = (BamStream*)h;
  switch (idx) {
    case 0: return bs->t_read;
    case 1: return bs->t_inflate;
    case 2: return bs->t_walk;
    case 3: return bs->t_parse;
    case 4: return bs->t_wait;
    default: return -1.0;
  }
}

GCI_API void gci_bam_stream_free(void* h) {
  auto* bs = (BamStream*)h;
  if (bs && getenv("GCI_NATIVE_DEBUG"))
    fprintf(stderr,
            "[gci_native] bam_stream producer: read=%.2fs inflate=%.2fs "
            "walk=%.2fs parse=%.2fs wait=%.2fs\n",
            bs->t_read, bs->t_inflate, bs->t_walk, bs->t_parse, bs->t_wait);
  delete bs;
}
GCI_API const char* gci_bam_stream_error(void* h) {
  auto* bs = (BamStream*)h;
  std::lock_guard<std::mutex> lk(bs->mu);
  return bs->error.empty() ? nullptr : bs->error.c_str();
}
GCI_API int64_t gci_bam_stream_num_refs(void* h) {
  return (int64_t)((BamStream*)h)->ref_names.size();
}
GCI_API const char* gci_bam_stream_ref_name(void* h, int64_t i) {
  return ((BamStream*)h)->ref_names[(size_t)i].c_str();
}
GCI_API int64_t gci_bam_stream_ref_len(void* h, int64_t i) {
  return ((BamStream*)h)->ref_lens[(size_t)i];
}
GCI_API int64_t gci_bam_stream_header_text_size(void* h) {
  return (int64_t)((BamStream*)h)->header_text.size();
}
GCI_API void gci_bam_stream_copy_header_text(void* h, uint8_t* out) {
  auto* bs = (BamStream*)h;
  if (!bs->header_text.empty())
    memcpy(out, bs->header_text.data(), bs->header_text.size());
}

// Pop the next chunk (blocking).  NULL = end of stream; check
// gci_bam_stream_error to distinguish EOF from failure.
GCI_API void* gci_bam_stream_next(void* h) {
  auto* bs = (BamStream*)h;
  std::unique_lock<std::mutex> lk(bs->mu);
  bs->cv_pop.wait(lk, [&] {
    return !bs->ready.empty() || bs->producer_done || bs->closing;
  });
  if (!bs->ready.empty()) {
    StreamChunk* c = bs->ready.front();
    bs->ready.pop_front();
    bs->cv_push.notify_one();
    return c;
  }
  return nullptr;
}

GCI_API void gci_chunk_free(void* h) { delete (StreamChunk*)h; }
GCI_API int64_t gci_chunk_num_records(void* h) {
  return (int64_t)((StreamChunk*)h)->ref_id.size();
}
GCI_API void gci_chunk_copy_columns(void* h, int32_t* ref_id, int32_t* pos,
                                    int32_t* ref_end, int32_t* qlen,
                                    int32_t* mapq, int32_t* flag, int32_t* m,
                                    int32_t* i_, int32_t* d, int32_t* s,
                                    int32_t* eq, int32_t* x, int32_t* nm,
                                    uint64_t* h1, uint64_t* h2) {
  auto* c = (StreamChunk*)h;
  size_t n = c->ref_id.size();
  auto cp = [n](int32_t* dst, const std::vector<int32_t>& src) {
    if (dst && n) memcpy(dst, src.data(), n * sizeof(int32_t));
  };
  cp(ref_id, c->ref_id);
  cp(pos, c->pos);
  cp(ref_end, c->ref_end);
  cp(qlen, c->qlen);
  cp(mapq, c->mapq);
  cp(flag, c->flag);
  cp(m, c->cig_m);
  cp(i_, c->cig_i);
  cp(d, c->cig_d);
  cp(s, c->cig_s);
  cp(eq, c->cig_eq);
  cp(x, c->cig_x);
  cp(nm, c->nm);
  if (h1 && n) memcpy(h1, c->h1.data(), n * sizeof(uint64_t));
  if (h2 && n) memcpy(h2, c->h2.data(), n * sizeof(uint64_t));
}
GCI_API int64_t gci_chunk_body_size(void* h) {
  return (int64_t)((StreamChunk*)h)->body.size();
}
GCI_API void gci_chunk_copy_body(void* h, uint8_t* out, int64_t* offs) {
  auto* c = (StreamChunk*)h;
  if (out && !c->body.empty()) memcpy(out, c->body.data(), c->body.size());
  if (offs && !c->rec_off.empty())
    memcpy(offs, c->rec_off.data(), c->rec_off.size() * sizeof(int64_t));
}
GCI_API int64_t gci_chunk_name_blob_size(void* h) {
  return (int64_t)((StreamChunk*)h)->name_blob.size();
}
GCI_API void gci_chunk_copy_names(void* h, uint8_t* blob, int64_t* offs) {
  auto* c = (StreamChunk*)h;
  if (blob && !c->name_blob.empty())
    memcpy(blob, c->name_blob.data(), c->name_blob.size());
  if (offs && !c->name_off.empty())
    memcpy(offs, c->name_off.data(), c->name_off.size() * sizeof(int64_t));
}
