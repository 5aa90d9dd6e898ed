// Segmented append-only partition log with mmap'd sparse-free index.
//
// Native storage engine for partition data (the TPU build's equivalent of
// the reference's Rust engine: /root/reference/src/broker/log/{mod,segment,
// index,entry}.rs — Log rolls segments when full, Segment = <base>.log file
// + index, Index = mmap of 16-byte (offset, position) entries).
//
// Deliberate upgrades over the reference (SURVEY.md quirks 8 / §3.5):
//   * offsets are assigned here (monotone u64 per log; a record batch blob
//     may claim a span of offsets) — the reference never assigns offsets;
//   * index lookups are binary search, not linear scan (index.rs:57-64);
//   * records carry a CRC32 checked on read;
//   * a real read path (the reference's reader is a stub, reader.rs:3-8).
//
// On-disk layout per log directory:
//   <base20>.log    records: [u64 offset][u32 count][u32 len][u32 crc][len bytes]
//   <base20>.index  [u32 magic][u32 ver][u64 entry_count] then 16-byte
//                   entries [u64 rel_offset][u64 position], mmap'd.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint32_t INDEX_MAGIC = 0x4a534c47;  // "JSLG"
constexpr uint32_t INDEX_VERSION = 1;
constexpr size_t INDEX_HEADER = 16;
constexpr size_t INDEX_ENTRY = 16;
constexpr size_t RECORD_HEADER = 20;

// ---------------------------------------------------------------- crc32
// Slice-by-8 (same polynomial/values as the classic bytewise table — the
// on-disk format is unchanged): CRC is the hot loop of every blob read and
// append (a 64-record batch blob is tens of KB), and the bytewise loop was
// the storage engine's throughput ceiling. Two instances: IEEE 0xEDB88320
// (record blobs, zlib-compatible) and Castagnoli 0x82F63B78 (Kafka record
// batch CRC — exposed so the broker can validate produced batches).
void build_crc_tables(uint32_t poly, uint32_t t[8][256]) {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? poly ^ (c >> 1) : c >> 1;
    t[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = t[0][i];
    for (int s = 1; s < 8; s++) {
      c = t[0][c & 0xFF] ^ (c >> 8);
      t[s][i] = c;
    }
  }
}
uint32_t crc_slice8(const uint32_t t[8][256], const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  while (n >= 8) {
    uint32_t lo, hi;
    memcpy(&lo, p, 4);
    memcpy(&hi, p + 4, 4);
    c ^= lo;
    c = t[7][c & 0xFF] ^ t[6][(c >> 8) & 0xFF] ^
        t[5][(c >> 16) & 0xFF] ^ t[4][c >> 24] ^
        t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
        t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
#endif
  while (n--) c = t[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}
uint32_t crc_table[8][256];
uint32_t crc32c_table[8][256];
bool crc_init_done = false;
void crc_init() {
  build_crc_tables(0xEDB88320u, crc_table);
  build_crc_tables(0x82F63B78u, crc32c_table);
  crc_init_done = true;
}
uint32_t crc32(const uint8_t* p, size_t n) {
  if (!crc_init_done) crc_init();
  return crc_slice8(crc_table, p, n);
}
uint32_t crc32c(const uint8_t* p, size_t n) {
  if (!crc_init_done) crc_init();
  return crc_slice8(crc32c_table, p, n);
}

void put_u32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}
void put_u64(uint8_t* p, uint64_t v) {
  put_u32(p, (uint32_t)(v >> 32)); put_u32(p + 4, (uint32_t)v);
}
uint32_t get_u32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}
uint64_t get_u64(const uint8_t* p) {
  return ((uint64_t)get_u32(p) << 32) | get_u32(p + 4);
}

// ---------------------------------------------------------------- segment
struct Segment {
  uint64_t base = 0;
  int log_fd = -1;
  uint64_t log_size = 0;
  uint8_t* index = nullptr;  // mmap
  size_t index_cap = 0;      // bytes
  uint64_t entries = 0;
  // Read-side mmap of the .log file (lazy, grown by remap as the tail
  // fills) + a validated-CRC bitmap: random lookups were pread+full-CRC
  // per call (~60 us for a 32 KB batch blob — the round-3 bench floor of
  // 16.5k lookups/s). Serving from the map removes both syscalls and the
  // copy-before-CRC, and each blob's checksum is verified once per open:
  // CRC guards on-disk corruption, which does not change between reads of
  // an immutable record (Kafka's own fetch path makes the same trade —
  // integrity is checked at produce/replication, page-cache serves reads).
  uint8_t* data_map = nullptr;
  size_t data_map_len = 0;
  std::vector<bool> validated;

  uint64_t* count_slot() { return reinterpret_cast<uint64_t*>(index + 8); }
  uint8_t* entry(uint64_t i) { return index + INDEX_HEADER + i * INDEX_ENTRY; }
  uint64_t max_entries() const { return (index_cap - INDEX_HEADER) / INDEX_ENTRY; }

  void close() {
    if (index) { munmap(index, index_cap); index = nullptr; }
    if (data_map) { munmap(data_map, data_map_len); data_map = nullptr; data_map_len = 0; }
    if (log_fd >= 0) { ::close(log_fd); log_fd = -1; }
  }
};

std::string seg_name(const std::string& dir, uint64_t base, const char* ext) {
  char buf[64];
  snprintf(buf, sizeof buf, "%020llu.%s", (unsigned long long)base, ext);
  return dir + "/" + buf;
}

struct LogImpl {
  std::string dir;
  uint64_t max_segment_bytes;
  size_t index_bytes;
  std::vector<Segment> segments;
  uint64_t next_offset = 0;
  std::string err;

  bool fail(const std::string& m) { err = m + ": " + strerror(errno); return false; }

  bool open_segment(uint64_t base, bool fresh) {
    Segment s;
    s.base = base;
    std::string lp = seg_name(dir, base, "log");
    s.log_fd = ::open(lp.c_str(), O_RDWR | O_CREAT, 0644);
    if (s.log_fd < 0) return fail("open " + lp);
    struct stat st;
    fstat(s.log_fd, &st);
    s.log_size = st.st_size;

    std::string ip = seg_name(dir, base, "index");
    int ifd = ::open(ip.c_str(), O_RDWR | O_CREAT, 0644);
    if (ifd < 0) { s.close(); return fail("open " + ip); }
    // Never shrink an existing index (a smaller configured index_bytes on
    // reopen must not destroy entries); grow-only.
    struct stat ist;
    fstat(ifd, &ist);
    size_t cap = std::max<size_t>(index_bytes, ist.st_size);
    if ((size_t)ist.st_size < cap && ftruncate(ifd, cap) != 0) {
      ::close(ifd); s.close(); return fail("ftruncate " + ip);
    }
    s.index = (uint8_t*)mmap(nullptr, cap, PROT_READ | PROT_WRITE, MAP_SHARED, ifd, 0);
    ::close(ifd);
    if (s.index == MAP_FAILED) { s.index = nullptr; s.close(); return fail("mmap " + ip); }
    s.index_cap = cap;

    if (fresh || get_u32(s.index) != INDEX_MAGIC) {
      put_u32(s.index, INDEX_MAGIC);
      put_u32(s.index + 4, INDEX_VERSION);
      *s.count_slot() = 0;
      s.entries = 0;
    } else {
      s.entries = *s.count_slot();
      if (s.entries > s.max_entries()) {  // corrupt header: rebuild from log
        s.entries = 0;
        *s.count_slot() = 0;
      }
    }
    segments.push_back(s);
    return true;
  }

  // Recompute next_offset from the tail record of the last segment. Torn
  // tail records (index entry written but the log write incomplete after a
  // crash — including a size-complete but zero-filled/garbage tail from
  // filesystem delayed allocation) are discarded: the record must match its
  // index entry's offset AND pass its CRC before being trusted.
  void recover_tail() {
    if (segments.empty()) { next_offset = 0; return; }
    Segment& s = segments.back();
    while (s.entries > 0) {
      uint8_t* e = s.entry(s.entries - 1);
      uint64_t rel = get_u64(e);
      uint64_t pos = get_u64(e + 8);
      uint8_t hdr[RECORD_HEADER];
      if (pread(s.log_fd, hdr, RECORD_HEADER, pos) == (ssize_t)RECORD_HEADER) {
        uint64_t off = get_u64(hdr);
        uint32_t cnt = get_u32(hdr + 8);
        uint32_t len = get_u32(hdr + 12);
        uint32_t crc = get_u32(hdr + 16);
        struct stat st;
        fstat(s.log_fd, &st);
        if (off == s.base + rel && (uint64_t)st.st_size >= pos + RECORD_HEADER + len) {
          std::vector<uint8_t> payload(len);
          if (len == 0 || pread(s.log_fd, payload.data(), len, pos + RECORD_HEADER) == (ssize_t)len) {
            if (crc32(payload.data(), len) == crc) {
              next_offset = off + (cnt ? cnt : 1);
              if ((uint64_t)st.st_size > pos + RECORD_HEADER + len) {
                // trailing garbage past the last indexed record
                if (ftruncate(s.log_fd, pos + RECORD_HEADER + len) == 0)
                  s.log_size = pos + RECORD_HEADER + len;
              }
              return;
            }
          }
        }
      }
      s.entries--;  // torn: drop the entry, truncate, try the previous one
      *s.count_slot() = s.entries;
      if (ftruncate(s.log_fd, pos) == 0) s.log_size = pos;
    }
    next_offset = s.base;
  }

  bool open() {
    mkdir(dir.c_str(), 0755);  // best-effort; parent must exist
    std::vector<uint64_t> bases;
    DIR* d = opendir(dir.c_str());
    if (!d) return fail("opendir " + dir);
    while (dirent* de = readdir(d)) {
      const char* n = de->d_name;
      size_t len = strlen(n);
      if (len == 24 && strcmp(n + 20, ".log") == 0)
        bases.push_back(strtoull(n, nullptr, 10));
    }
    closedir(d);
    std::sort(bases.begin(), bases.end());
    if (bases.empty()) {
      if (!open_segment(0, true)) return false;
    } else {
      for (uint64_t b : bases)
        if (!open_segment(b, false)) return false;
    }
    recover_tail();
    return true;
  }

  // Full write at position with EINTR/short-write retry.
  bool write_all(int fd, const uint8_t* p, size_t n, uint64_t pos) {
    while (n > 0) {
      ssize_t w = pwrite(fd, p, n, pos);
      if (w < 0) {
        if (errno == EINTR) continue;
        return false;
      }
      p += w; n -= w; pos += w;
    }
    return true;
  }

  // Append one blob claiming `count` consecutive offsets; returns base offset.
  bool append(const uint8_t* data, size_t len, uint32_t count, uint64_t* out_off) {
    Segment* s = &segments.back();
    if ((s->log_size + RECORD_HEADER + len > max_segment_bytes && s->log_size > 0) ||
        s->entries >= s->max_entries()) {
      fdatasync(s->log_fd);  // seal the old tail durably before rolling
      msync(s->index, s->index_cap, MS_SYNC);
      if (!open_segment(next_offset, true)) return false;
      s = &segments.back();
    }
    uint64_t off = next_offset;
    uint8_t hdr[RECORD_HEADER];
    put_u64(hdr, off);
    put_u32(hdr + 8, count);
    put_u32(hdr + 12, (uint32_t)len);
    put_u32(hdr + 16, crc32(data, len));
    if (!write_all(s->log_fd, hdr, RECORD_HEADER, s->log_size) ||
        !write_all(s->log_fd, data, len, s->log_size + RECORD_HEADER)) {
      // Leave log_size unchanged: partial bytes past it are overwritten by
      // the next append or truncated by recovery (no index entry points at
      // them).
      return fail("pwrite");
    }
    uint8_t* e = s->entry(s->entries);
    put_u64(e, off - s->base);
    put_u64(e + 8, s->log_size);
    s->entries++;
    *s->count_slot() = s->entries;
    s->log_size += RECORD_HEADER + len;
    next_offset = off + (count ? count : 1);
    *out_off = off;
    return true;
  }

  // Segment containing `off`: last segment with base <= off.
  Segment* find_segment(uint64_t off) {
    if (segments.empty()) return nullptr;
    size_t lo = 0, hi = segments.size();
    while (hi - lo > 1) {
      size_t mid = (lo + hi) / 2;
      if (segments[mid].base <= off) lo = mid; else hi = mid;
    }
    return segments[lo].base <= off ? &segments[lo] : nullptr;
  }

  // Index slot of the blob containing `off` (greatest rel <= off-base), or -1.
  int64_t find_entry(Segment* s, uint64_t off) {
    if (s->entries == 0 || off < s->base) return -1;
    uint64_t rel = off - s->base;
    uint64_t lo = 0, hi = s->entries;
    while (hi - lo > 1) {
      uint64_t mid = (lo + hi) / 2;
      if (get_u64(s->entry(mid)) <= rel) lo = mid; else hi = mid;
    }
    return get_u64(s->entry(lo)) <= rel ? (int64_t)lo : -1;
  }

  // Read-side view of `need` bytes at `pos` in a segment's log file,
  // served from the lazy data mmap. nullptr = span not mappable (empty
  // file, mmap failure, or bytes beyond the indexed size) — callers fall
  // back to pread. Bounded by log_size, so a torn tail is never visible.
  //
  // The mapping is taken with 64 MiB headroom past the current tail:
  // virtual address space is free, MAP_SHARED pages past EOF become valid
  // as the file grows (accesses here are always <= log_size, which is <=
  // the file size), and without the headroom a produce-then-consume tail
  // workload would pay a full munmap+mmap (TLB shootdown included) on
  // every read of a fresh record.
  const uint8_t* map_span(Segment* s, uint64_t pos, size_t need) {
    if (need == 0 || pos + need > s->log_size) return nullptr;
    if (s->data_map_len < pos + need) {
      if (s->data_map) {
        munmap(s->data_map, s->data_map_len);
        s->data_map = nullptr;
        s->data_map_len = 0;
      }
      constexpr uint64_t HEADROOM = 64ull << 20;
      uint64_t len = ((s->log_size + HEADROOM - 1) / HEADROOM) * HEADROOM;
      void* m = mmap(nullptr, len, PROT_READ, MAP_SHARED, s->log_fd, 0);
      if (m == MAP_FAILED) return nullptr;
      s->data_map = (uint8_t*)m;
      s->data_map_len = len;
    }
    return s->data_map + pos;
  }

  // Only the tail segment can be dirty: sealed segments are synced once at
  // roll time (see append), so flush cost stays O(1) as the log ages.
  void flush() {
    if (segments.empty()) return;
    Segment& s = segments.back();
    if (s.log_fd >= 0) fdatasync(s.log_fd);
    if (s.index) msync(s.index, s.index_cap, MS_SYNC);
  }

  void close() {
    for (auto& s : segments) s.close();
    segments.clear();
  }
};

// ---------------------------------------------------------------- python
struct PyLog {
  PyObject_HEAD
  LogImpl* impl;
};

PyObject* log_err(LogImpl* impl, const char* what) {
  PyErr_Format(PyExc_OSError, "%s: %s", what,
               impl->err.empty() ? "unknown" : impl->err.c_str());
  return nullptr;
}

bool check_open(PyLog* self) {
  if (self->impl->segments.empty()) {
    PyErr_SetString(PyExc_OSError, "log is closed");
    return false;
  }
  return true;
}

PyObject* Log_append(PyLog* self, PyObject* args, PyObject* kwargs) {
  Py_buffer buf;
  unsigned int count = 1;
  static const char* kws[] = {"data", "count", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "y*|I", (char**)kws, &buf, &count))
    return nullptr;
  if (count < 1) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "count must be >= 1");
    return nullptr;
  }
  if ((uint64_t)buf.len > UINT32_MAX) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "payload exceeds u32 length limit");
    return nullptr;
  }
  if (!check_open(self)) { PyBuffer_Release(&buf); return nullptr; }
  uint64_t off;
  bool ok = self->impl->append((const uint8_t*)buf.buf, buf.len, count, &off);
  PyBuffer_Release(&buf);
  if (!ok) return log_err(self->impl, "append");
  return PyLong_FromUnsignedLongLong(off);
}

// C read core: blob containing `off`. Returns 1 = hit (payload is a new
// ref), 0 = miss (past end / in a gap), -1 = error (Python exception set).
int read_blob(LogImpl* L, uint64_t off, uint64_t* base, uint32_t* count,
              PyObject** payload) {
  Segment* s = L->find_segment(off);
  if (!s) return 0;
  int64_t slot = L->find_entry(s, off);
  if (slot < 0) return 0;
  uint64_t pos = get_u64(s->entry(slot) + 8);
  uint8_t hdrbuf[RECORD_HEADER];
  const uint8_t* hdr = L->map_span(s, pos, RECORD_HEADER);
  if (!hdr) {
    if (pread(s->log_fd, hdrbuf, RECORD_HEADER, pos) != (ssize_t)RECORD_HEADER) {
      // The index says a record lives here; failing to read its header is
      // corruption or IO failure, not end-of-log.
      PyErr_Format(PyExc_OSError, "short header read at log position %llu",
                   (unsigned long long)pos);
      return -1;
    }
    hdr = hdrbuf;
  }
  *base = get_u64(hdr);
  *count = get_u32(hdr + 8);
  uint32_t len = get_u32(hdr + 12);
  uint32_t crc = get_u32(hdr + 16);
  if (off >= *base + (*count ? *count : 1)) return 0;  // gap past tail blob

  // Hot path: serve the payload straight from the data mmap — no
  // syscalls, and the CRC is verified once per blob per open (the
  // validated bitmap), not on every lookup of an immutable record.
  const uint8_t* body = L->map_span(s, pos + RECORD_HEADER, len);
  if (body) {
    if (s->validated.size() < s->entries) s->validated.resize(s->entries, false);
    if (!s->validated[slot]) {
      if (crc32(body, len) != crc) {
        PyErr_Format(PyExc_OSError, "crc mismatch at offset %llu",
                     (unsigned long long)*base);
        return -1;
      }
      s->validated[slot] = true;
    }
    *payload = PyBytes_FromStringAndSize((const char*)body, len);
    return *payload ? 1 : -1;
  }

  *payload = PyBytes_FromStringAndSize(nullptr, len);
  if (!*payload) return -1;
  if (pread(s->log_fd, PyBytes_AS_STRING(*payload), len, pos + RECORD_HEADER) != (ssize_t)len) {
    Py_CLEAR(*payload);
    PyErr_SetString(PyExc_OSError, "short read");
    return -1;
  }
  if (crc32((const uint8_t*)PyBytes_AS_STRING(*payload), len) != crc) {
    Py_CLEAR(*payload);
    PyErr_Format(PyExc_OSError, "crc mismatch at offset %llu",
                 (unsigned long long)*base);
    return -1;
  }
  return 1;
}

// Returns (base_offset, count, payload) of the blob containing `offset`,
// or None past the end.
PyObject* Log_read(PyLog* self, PyObject* args) {
  unsigned long long off;
  if (!PyArg_ParseTuple(args, "K", &off)) return nullptr;
  if (!check_open(self)) return nullptr;
  uint64_t base; uint32_t count; PyObject* payload;
  int rc = read_blob(self->impl, off, &base, &count, &payload);
  if (rc < 0) return nullptr;
  if (rc == 0) Py_RETURN_NONE;
  return Py_BuildValue("(KIN)", (unsigned long long)base, count, payload);
}

// List of (base_offset, count, payload) blobs from `offset`, up to max_bytes
// of payload. Kafka max_bytes contract (KIP-74), matching MemLog.read_from:
// a blob that would push the running total PAST max_bytes is excluded —
// unless it is the FIRST blob, which is always returned so an oversized
// batch can never wedge a consumer at a fixed offset.
PyObject* Log_read_from(PyLog* self, PyObject* args) {
  unsigned long long off;
  unsigned long long max_bytes = 1 << 20;
  if (!PyArg_ParseTuple(args, "K|K", &off, &max_bytes)) return nullptr;
  if (!check_open(self)) return nullptr;
  PyObject* out = PyList_New(0);
  if (!out) return nullptr;
  uint64_t total = 0;
  uint64_t cur = off;
  while (total < max_bytes && cur < self->impl->next_offset) {
    uint64_t base; uint32_t count; PyObject* payload;
    int rc = read_blob(self->impl, cur, &base, &count, &payload);
    if (rc < 0) { Py_DECREF(out); return nullptr; }
    if (rc == 0) break;
    if (total && total + (uint64_t)PyBytes_GET_SIZE(payload) > max_bytes) {
      Py_DECREF(payload);
      break;
    }
    total += PyBytes_GET_SIZE(payload);
    PyObject* one = Py_BuildValue("(KIN)", (unsigned long long)base, count, payload);
    if (!one || PyList_Append(out, one) < 0) {
      Py_XDECREF(one); Py_DECREF(out); return nullptr;
    }
    Py_DECREF(one);
    cur = base + (count ? count : 1);
  }
  return out;
}

PyObject* Log_next_offset(PyLog* self, PyObject*) {
  return PyLong_FromUnsignedLongLong(self->impl->next_offset);
}

PyObject* Log_segment_count(PyLog* self, PyObject*) {
  return PyLong_FromSize_t(self->impl->segments.size());
}

PyObject* Log_flush(PyLog* self, PyObject*) {
  self->impl->flush();
  Py_RETURN_NONE;
}

PyObject* Log_close(PyLog* self, PyObject*) {
  self->impl->close();
  Py_RETURN_NONE;
}

void Log_dealloc(PyLog* self) {
  if (self->impl) { self->impl->close(); delete self->impl; }
  Py_TYPE(self)->tp_free((PyObject*)self);
}

PyMethodDef Log_methods[] = {
    {"append", (PyCFunction)Log_append, METH_VARARGS | METH_KEYWORDS,
     "append(data, count=1) -> base offset; blob claims `count` offsets"},
    {"read", (PyCFunction)Log_read, METH_VARARGS,
     "read(offset) -> (base_offset, count, payload) | None"},
    {"read_from", (PyCFunction)Log_read_from, METH_VARARGS,
     "read_from(offset, max_bytes=1MiB) -> [(base_offset, count, payload)]"},
    {"next_offset", (PyCFunction)Log_next_offset, METH_NOARGS, "next offset"},
    {"segment_count", (PyCFunction)Log_segment_count, METH_NOARGS, "segments"},
    {"flush", (PyCFunction)Log_flush, METH_NOARGS, "fsync segments + indexes"},
    {"close", (PyCFunction)Log_close, METH_NOARGS, "close files"},
    {nullptr, nullptr, 0, nullptr},
};

PyTypeObject LogType = {PyVarObject_HEAD_INIT(nullptr, 0)};

PyObject* seglog_open(PyObject*, PyObject* args, PyObject* kwargs) {
  const char* dir;
  unsigned long long max_segment_bytes = 1ull << 30;  // reference segment.rs:11
  unsigned long long index_bytes = 10ull << 20;       // reference index.rs:9
  static const char* kws[] = {"dir", "max_segment_bytes", "index_bytes", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "s|KK", (char**)kws, &dir,
                                   &max_segment_bytes, &index_bytes))
    return nullptr;
  if (index_bytes < INDEX_HEADER + INDEX_ENTRY) {
    PyErr_SetString(PyExc_ValueError, "index_bytes too small");
    return nullptr;
  }
  PyLog* self = PyObject_New(PyLog, &LogType);
  if (!self) return nullptr;
  self->impl = new LogImpl();
  self->impl->dir = dir;
  self->impl->max_segment_bytes = max_segment_bytes;
  self->impl->index_bytes = index_bytes;
  if (!self->impl->open()) {
    PyObject* e = log_err(self->impl, "open");
    Py_DECREF(self);
    return e;
  }
  return (PyObject*)self;
}

// Exposed so tests can pin the record checksum to the standard CRC-32
// (zlib-compatible) — on-disk compatibility across implementation changes.
PyObject* seglog_crc32(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  uint32_t c = crc32((const uint8_t*)buf.buf, (size_t)buf.len);
  PyBuffer_Release(&buf);
  return PyLong_FromUnsignedLong(c);
}

PyObject* seglog_crc32c(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  uint32_t c = crc32c((const uint8_t*)buf.buf, (size_t)buf.len);
  PyBuffer_Release(&buf);
  return PyLong_FromUnsignedLong(c);
}

PyMethodDef module_methods[] = {
    {"open", (PyCFunction)seglog_open, METH_VARARGS | METH_KEYWORDS,
     "open(dir, max_segment_bytes=1GiB, index_bytes=10MiB) -> Log"},
    {"crc32", (PyCFunction)seglog_crc32, METH_VARARGS,
     "crc32(bytes) -> int (standard CRC-32, zlib-compatible)"},
    {"crc32c", (PyCFunction)seglog_crc32c, METH_VARARGS,
     "crc32c(bytes) -> int (Castagnoli CRC-32C, Kafka batch checksum)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef seglog_module = {
    PyModuleDef_HEAD_INIT, "_seglog",
    "Segmented append-only log with mmap index (native storage engine)",
    -1, module_methods,
};

}  // namespace

extern "C" __attribute__((visibility("default"))) PyObject* PyInit__seglog() {
  LogType.tp_name = "_seglog.Log";
  LogType.tp_basicsize = sizeof(PyLog);
  LogType.tp_dealloc = (destructor)Log_dealloc;
  LogType.tp_flags = Py_TPFLAGS_DEFAULT;
  LogType.tp_methods = Log_methods;
  if (PyType_Ready(&LogType) < 0) return nullptr;
  return PyModule_Create(&seglog_module);
}
