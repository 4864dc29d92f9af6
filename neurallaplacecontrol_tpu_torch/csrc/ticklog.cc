// Native tick-telemetry runtime: crash-surviving mmap ring log for serving.
//
// The reference has no deployment story at all (its episode loop prints to
// a Python logger, mppi_with_model.py:289-302). This ring log appends one
// fixed-width float32 record per serving tick into an mmap'd file: an append
// is a memcpy plus one cursor store, with no syscalls and no allocation, and
// the records survive a process crash because the pages belong to the OS once
// written. A separate reader process can mmap the same file and tail it live
// (the cursor store is release-ordered so a reader never sees a cursor that
// outruns its record). The PyTorch port's copy of the JAX package's
// runtime/ticklog.cc; the file format is the same in both packages.
//
// File layout (little-endian):
//   u64 magic 'NLTPUTL1'
//   u64 capacity            ring size in records
//   u64 width               floats per record (caller-defined schema)
//   u64 cursor              total records ever appended (monotone)
//   f32 data[ capacity * width ]   record i lives at slot (i % capacity)
//
// C ABI (consumed by neurallaplacecontrol_tpu_torch/runtime/ticklog.py via ctypes):
//   tl_create(path, capacity, width) -> handle  create new or open existing
//                                               (existing must match dims)
//   tl_open(path)                    -> handle  open existing read/write
//   tl_append(h, rec)                -> u64     new total count (0 on error)
//   tl_count / tl_capacity / tl_width(h)        metadata
//   tl_read(h, start, k, out)        -> int     records [start, start+k);
//                                               -1 if any already evicted
//   tl_last(h, k, out)               -> u64     newest min(k, retained)
//                                               records, oldest-first
//   tl_sync(h)                       -> int     msync for machine-crash
//                                               durability (appends already
//                                               survive process crashes)
//   tl_close(h)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x314c545550544c4eULL;  // "NLTPUTL1"

struct Header {
  uint64_t magic;
  uint64_t capacity;
  uint64_t width;
  uint64_t cursor;
};

struct Handle {
  int fd = -1;
  void* map = nullptr;
  size_t map_len = 0;
  Header* hdr = nullptr;
  float* data = nullptr;
};

size_t file_len(uint64_t capacity, uint64_t width) {
  return sizeof(Header) + sizeof(float) * capacity * width;
}

Handle* map_file(int fd, size_t len) {
  void* map = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Handle* h = new Handle;
  h->fd = fd;
  h->map = map;
  h->map_len = len;
  h->hdr = static_cast<Header*>(map);
  h->data = reinterpret_cast<float*>(static_cast<char*>(map) + sizeof(Header));
  return h;
}

std::atomic<uint64_t>* cursor_atomic(Handle* h) {
  // the cursor field is 8-aligned inside the mapping; accessed atomically
  // so a concurrent reader process never tears it
  return reinterpret_cast<std::atomic<uint64_t>*>(&h->hdr->cursor);
}

}  // namespace

extern "C" {

void* tl_open(const char* path) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < sizeof(Header)) {
    close(fd);
    return nullptr;
  }
  Handle* h = map_file(fd, static_cast<size_t>(st.st_size));
  if (!h) return nullptr;
  if (h->hdr->magic != kMagic ||
      h->map_len != file_len(h->hdr->capacity, h->hdr->width)) {
    munmap(h->map, h->map_len);
    close(h->fd);
    delete h;
    return nullptr;
  }
  return h;
}

void* tl_create(const char* path, uint64_t capacity, uint64_t width) {
  if (capacity == 0 || width == 0) return nullptr;
  // reuse an existing compatible log (restart-friendly: the controller
  // resumes appending where the crashed process stopped). An existing file
  // that is not a valid log is REFUSED, never deleted — creation below is
  // tmp+rename-atomic, so this path never sees our own partial files.
  if (access(path, F_OK) == 0) {
    Handle* h = static_cast<Handle*>(tl_open(path));
    if (!h) return nullptr;  // foreign/corrupt: not ours to destroy
    if (h->hdr->capacity != capacity || h->hdr->width != width) {
      munmap(h->map, h->map_len);
      close(h->fd);
      delete h;
      return nullptr;  // a VALID log with other dims: refuse
    }
    return h;
  }
  // initialize under a temp name, then rename(2) into place: the target
  // path is only ever absent or a COMPLETE valid log, so a crash anywhere
  // in here leaves at worst a stray .tmp file, never a bricked path
  std::string tmp = std::string(path) + ".tmp." + std::to_string(getpid());
  int fd = open(tmp.c_str(), O_RDWR | O_CREAT | O_EXCL, 0644);
  if (fd < 0) return nullptr;
  size_t len = file_len(capacity, width);
  if (ftruncate(fd, static_cast<off_t>(len)) != 0) {
    close(fd);
    unlink(tmp.c_str());
    return nullptr;
  }
  Handle* h = map_file(fd, len);
  if (!h) {
    unlink(tmp.c_str());
    return nullptr;
  }
  h->hdr->magic = kMagic;
  h->hdr->capacity = capacity;
  h->hdr->width = width;
  cursor_atomic(h)->store(0, std::memory_order_release);
  if (msync(h->map, sizeof(Header), MS_SYNC) != 0 ||
      rename(tmp.c_str(), path) != 0) {
    munmap(h->map, h->map_len);
    close(h->fd);
    delete h;
    unlink(tmp.c_str());
    return nullptr;
  }
  return h;
}

uint64_t tl_count(void* hp) {
  Handle* h = static_cast<Handle*>(hp);
  return cursor_atomic(h)->load(std::memory_order_acquire);
}

uint64_t tl_capacity(void* hp) { return static_cast<Handle*>(hp)->hdr->capacity; }
uint64_t tl_width(void* hp) { return static_cast<Handle*>(hp)->hdr->width; }

uint64_t tl_append(void* hp, const float* rec) {
  Handle* h = static_cast<Handle*>(hp);
  std::atomic<uint64_t>* cur = cursor_atomic(h);
  uint64_t i = cur->load(std::memory_order_relaxed);  // single writer
  uint64_t w = h->hdr->width;
  std::memcpy(h->data + (i % h->hdr->capacity) * w, rec, sizeof(float) * w);
  cur->store(i + 1, std::memory_order_release);  // record visible first
  return i + 1;
}

int tl_read(void* hp, uint64_t start, uint64_t k, float* out) {
  Handle* h = static_cast<Handle*>(hp);
  uint64_t count = tl_count(hp);
  uint64_t cap = h->hdr->capacity;
  uint64_t w = h->hdr->width;
  if (start + k > count) return -1;                       // not yet written
  if (count > cap && start < count - cap) return -1;      // evicted
  for (uint64_t j = 0; j < k; ++j) {
    std::memcpy(out + j * w, h->data + ((start + j) % cap) * w,
                sizeof(float) * w);
  }
  // a live writer in another process may have lapped the window DURING the
  // copy; re-check so a tailing reader never returns torn records
  uint64_t count2 = tl_count(hp);
  if (count2 > cap && start < count2 - cap) return -1;
  return 0;
}

uint64_t tl_last(void* hp, uint64_t k, float* out) {
  Handle* h = static_cast<Handle*>(hp);
  uint64_t count = tl_count(hp);
  uint64_t cap = h->hdr->capacity;
  uint64_t retained = count < cap ? count : cap;
  if (k > retained) k = retained;
  if (k == 0) return 0;
  return tl_read(hp, count - k, k, out) == 0 ? k : 0;
}

int tl_sync(void* hp) {
  Handle* h = static_cast<Handle*>(hp);
  return msync(h->map, h->map_len, MS_SYNC);
}

void tl_close(void* hp) {
  Handle* h = static_cast<Handle*>(hp);
  if (!h) return;
  if (h->map) munmap(h->map, h->map_len);
  if (h->fd >= 0) close(h->fd);
  delete h;
}

}  // extern "C"
