// RecordIO: chunked record file format (native component of the PyTorch
// port; the same PTR1 format as paddle_tpu/native/recordio.cc, so a shard
// written by either package reads in the other).
//
// Upstream's chunked record container (paddle/fluid/recordio/: magic +
// compressor + CRC per chunk), with 64-bit lengths, zlib and a single-pass
// streaming scanner.
//
// On-disk layout:
//   file   := chunk*
//   chunk  := magic(u32 = 0x50545231 "PTR1") | compressor(u32)
//           | num_records(u32) | raw_len(u64) | stored_len(u64)
//           | crc32(u32, of stored payload) | payload
//   payload (after decompression) := { rec_len(u64) | bytes }*
//
// Exposed through a C API loaded with ctypes
// (paddle_tpu_torch/native/__init__.py builds it with g++ at first use).
//
// zlib: the four functions used here are declared below when <zlib.h> is
// absent, and the library links the runtime libz.so.1.

#if __has_include(<zlib.h>)
#include <zlib.h>
#else
extern "C" {
typedef unsigned char Bytef;
typedef unsigned long uLong;
typedef unsigned long uLongf;
typedef unsigned int uInt;
int compress2(Bytef* dest, uLongf* destLen, const Bytef* source,
              uLong sourceLen, int level);
int uncompress(Bytef* dest, uLongf* destLen, const Bytef* source,
               uLong sourceLen);
uLong crc32(uLong crc, const Bytef* buf, uInt len);
uLong compressBound(uLong sourceLen);
}
#define Z_OK 0
#endif

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x50545231;  // "PTR1"

enum Compressor : uint32_t { kNone = 0, kZlib = 1 };

struct Writer {
  FILE* f = nullptr;
  uint32_t compressor = kZlib;
  size_t max_chunk_bytes = 1 << 20;
  std::vector<std::string> pending;
  size_t pending_bytes = 0;

  bool FlushChunk() {
    if (pending.empty()) return true;
    std::string raw;
    raw.reserve(pending_bytes + pending.size() * 8);
    for (auto& r : pending) {
      uint64_t len = r.size();
      raw.append(reinterpret_cast<const char*>(&len), 8);
      raw.append(r);
    }
    std::string stored;
    if (compressor == kZlib) {
      uLongf bound = compressBound(raw.size());
      stored.resize(bound);
      if (compress2(reinterpret_cast<Bytef*>(&stored[0]), &bound,
                    reinterpret_cast<const Bytef*>(raw.data()), raw.size(),
                    /*level=*/1) != Z_OK) {
        return false;
      }
      stored.resize(bound);
    } else {
      stored = raw;
    }
    uint32_t magic = kMagic, comp = compressor,
             n = static_cast<uint32_t>(pending.size());
    uint64_t raw_len = raw.size(), stored_len = stored.size();
    uint32_t crc = crc32(0L, reinterpret_cast<const Bytef*>(stored.data()),
                         stored.size());
    bool ok = fwrite(&magic, 4, 1, f) == 1 && fwrite(&comp, 4, 1, f) == 1 &&
              fwrite(&n, 4, 1, f) == 1 && fwrite(&raw_len, 8, 1, f) == 1 &&
              fwrite(&stored_len, 8, 1, f) == 1 &&
              fwrite(&crc, 4, 1, f) == 1 &&
              fwrite(stored.data(), 1, stored.size(), f) == stored.size();
    pending.clear();
    pending_bytes = 0;
    return ok;
  }
};

struct Scanner {
  FILE* f = nullptr;
  std::vector<std::string> records;  // current chunk
  size_t cursor = 0;

  // returns: 1 ok, 0 eof, -1 corrupt
  int LoadChunk() {
    uint32_t magic = 0, comp = 0, n = 0, crc = 0;
    uint64_t raw_len = 0, stored_len = 0;
    if (fread(&magic, 4, 1, f) != 1) return 0;  // clean EOF
    if (magic != kMagic || fread(&comp, 4, 1, f) != 1 ||
        fread(&n, 4, 1, f) != 1 || fread(&raw_len, 8, 1, f) != 1 ||
        fread(&stored_len, 8, 1, f) != 1 || fread(&crc, 4, 1, f) != 1) {
      return -1;
    }
    std::string stored(stored_len, '\0');
    if (stored_len &&
        fread(&stored[0], 1, stored_len, f) != stored_len) {
      return -1;
    }
    if (crc32(0L, reinterpret_cast<const Bytef*>(stored.data()),
              stored.size()) != crc) {
      return -1;
    }
    std::string raw;
    if (comp == kZlib) {
      raw.resize(raw_len);
      uLongf out_len = raw_len;
      if (uncompress(reinterpret_cast<Bytef*>(&raw[0]), &out_len,
                     reinterpret_cast<const Bytef*>(stored.data()),
                     stored.size()) != Z_OK ||
          out_len != raw_len) {
        return -1;
      }
    } else {
      raw = std::move(stored);
    }
    records.clear();
    cursor = 0;
    size_t pos = 0;
    for (uint32_t i = 0; i < n; ++i) {
      if (pos + 8 > raw.size()) return -1;
      uint64_t len;
      memcpy(&len, raw.data() + pos, 8);
      pos += 8;
      if (pos + len > raw.size()) return -1;
      records.emplace_back(raw.data() + pos, len);
      pos += len;
    }
    return 1;
  }
};

}  // namespace

extern "C" {

void* pt_recordio_writer_open(const char* path, int compressor,
                              long max_chunk_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  w->compressor = compressor ? kZlib : kNone;
  if (max_chunk_bytes > 0) w->max_chunk_bytes = max_chunk_bytes;
  return w;
}

int pt_recordio_write(void* wp, const char* data, long len) {
  auto* w = static_cast<Writer*>(wp);
  w->pending.emplace_back(data, len);
  w->pending_bytes += len;
  if (w->pending_bytes >= w->max_chunk_bytes) {
    return w->FlushChunk() ? 0 : -1;
  }
  return 0;
}

int pt_recordio_writer_close(void* wp) {
  auto* w = static_cast<Writer*>(wp);
  bool ok = w->FlushChunk();
  fclose(w->f);
  delete w;
  return ok ? 0 : -1;
}

void* pt_recordio_scanner_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* s = new Scanner();
  s->f = f;
  return s;
}

// Returns record length (>=0) with *out malloc'd; -1 on EOF; -2 on corrupt.
long pt_recordio_next(void* sp, char** out) {
  auto* s = static_cast<Scanner*>(sp);
  if (s->cursor >= s->records.size()) {
    int r = s->LoadChunk();
    if (r == 0) return -1;
    if (r < 0) return -2;
  }
  const std::string& rec = s->records[s->cursor++];
  *out = static_cast<char*>(malloc(rec.size() ? rec.size() : 1));
  memcpy(*out, rec.data(), rec.size());
  return static_cast<long>(rec.size());
}

void pt_recordio_scanner_close(void* sp) {
  auto* s = static_cast<Scanner*>(sp);
  fclose(s->f);
  delete s;
}

void pt_free(char* p) { free(p); }

}  // extern "C"
