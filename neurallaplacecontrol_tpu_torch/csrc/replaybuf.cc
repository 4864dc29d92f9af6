// Native replay-buffer runtime: zero-copy mmap storage + threaded gather.
//
// The reference persists replay buffers as pickled torch tensors
// (mppi_dataset_collector.py:441 torch.save) which are fully deserialized
// on every load. This runtime stores the four transition arrays
// (s0, a0, sn, ts) as a single page-aligned little-endian float32 file that
// is mmap'd read-only: open is O(1), the OS page cache shares one copy
// across processes, and batch gathers for host-side pipelines run on
// worker threads.
//
// File layout (all little-endian):
//   u64 magic 'NLTPURB1'
//   u64 n_rows
//   u64 dims[4]           flattened per-row widths of s0, a0, sn, ts
//   f32 data[ n_rows * (d0+d1+d2+d3) ]   row-major, arrays concatenated
//       [ s0 block | a0 block | sn block | ts block ]
//
// The PyTorch port's copy of the JAX package's runtime/replaybuf.cc; the file
// format is the same, so a buffer written by either package opens in the other.
//
// C ABI (consumed by neurallaplacecontrol_tpu_torch/runtime via ctypes):
//   rb_write(path, n, dims[4], s0, a0, sn, ts) -> 0 on success
//   rb_open(path)                              -> handle (NULL on error)
//   rb_rows(h) / rb_dim(h, i)                  -> metadata
//   rb_data(h, i)                              -> const float* array base
//   rb_gather(h, i, idx, k, out, n_threads)    -> gather k rows of array i
//   rb_close(h)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint64_t kMagic = 0x3142525550544c4eULL;  // "NLTPURB1"
constexpr int kArrays = 4;

struct Header {
  uint64_t magic;
  uint64_t n_rows;
  uint64_t dims[kArrays];
};

struct Handle {
  int fd = -1;
  void* map = nullptr;
  size_t map_len = 0;
  Header hdr{};
  const float* base[kArrays] = {nullptr, nullptr, nullptr, nullptr};
};

}  // namespace

extern "C" {

int rb_write(const char* path, uint64_t n_rows, const uint64_t* dims,
             const float* s0, const float* a0, const float* sn,
             const float* ts) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  Header hdr;
  hdr.magic = kMagic;
  hdr.n_rows = n_rows;
  const float* arrays[kArrays] = {s0, a0, sn, ts};
  for (int i = 0; i < kArrays; ++i) hdr.dims[i] = dims[i];
  if (std::fwrite(&hdr, sizeof(hdr), 1, f) != 1) {
    std::fclose(f);
    return -2;
  }
  for (int i = 0; i < kArrays; ++i) {
    size_t count = n_rows * dims[i];
    if (count && std::fwrite(arrays[i], sizeof(float), count, f) != count) {
      std::fclose(f);
      return -3;
    }
  }
  std::fclose(f);
  return 0;
}

void* rb_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < sizeof(Header)) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* h = new Handle();
  h->fd = fd;
  h->map = map;
  h->map_len = st.st_size;
  std::memcpy(&h->hdr, map, sizeof(Header));
  // validate magic AND the full payload size — a crash/full-disk during
  // rb_write can leave a complete header with a truncated payload, which
  // would otherwise SIGBUS on first read past EOF
  uint64_t payload = 0;
  for (int i = 0; i < kArrays; ++i) payload += h->hdr.n_rows * h->hdr.dims[i];
  const uint64_t need = sizeof(Header) + payload * sizeof(float);
  if (h->hdr.magic != kMagic || static_cast<uint64_t>(st.st_size) < need) {
    munmap(map, st.st_size);
    ::close(fd);
    delete h;
    return nullptr;
  }
  const float* cursor =
      reinterpret_cast<const float*>(static_cast<const char*>(map) + sizeof(Header));
  for (int i = 0; i < kArrays; ++i) {
    h->base[i] = cursor;
    cursor += h->hdr.n_rows * h->hdr.dims[i];
  }
  return h;
}

uint64_t rb_rows(void* handle) { return static_cast<Handle*>(handle)->hdr.n_rows; }

uint64_t rb_dim(void* handle, int i) {
  return static_cast<Handle*>(handle)->hdr.dims[i];
}

const float* rb_data(void* handle, int i) {
  return static_cast<Handle*>(handle)->base[i];
}

// Gather rows idx[0..k) of array i into out (k * dims[i] floats).
// Threaded: contiguous chunks of the output are filled in parallel, so a
// large shuffled epoch gather saturates memory bandwidth instead of a
// single core.
int rb_gather(void* handle, int i, const int64_t* idx, uint64_t k, float* out,
              int n_threads) {
  auto* h = static_cast<Handle*>(handle);
  if (i < 0 || i >= kArrays) return -1;
  const uint64_t d = h->hdr.dims[i];
  const uint64_t n = h->hdr.n_rows;
  const float* base = h->base[i];
  if (n_threads < 1) n_threads = 1;

  // out-of-range indices are an ERROR (returning partial/uninitialized
  // output would silently feed garbage rows into training)
  std::vector<int> bad(n_threads > 0 ? n_threads : 1, 0);
  auto worker = [&](int tid, uint64_t lo, uint64_t hi) {
    for (uint64_t j = lo; j < hi; ++j) {
      const int64_t row = idx[j];
      if (row < 0 || static_cast<uint64_t>(row) >= n) {
        bad[tid] = 1;
        return;
      }
      std::memcpy(out + j * d, base + static_cast<uint64_t>(row) * d,
                  d * sizeof(float));
    }
  };

  if (n_threads == 1 || k < 4096) {
    worker(0, 0, k);
    return bad[0] ? -2 : 0;
  }
  std::vector<std::thread> threads;
  const uint64_t chunk = (k + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const uint64_t lo = t * chunk;
    const uint64_t hi = lo + chunk < k ? lo + chunk : k;
    if (lo >= hi) break;
    threads.emplace_back(worker, t, lo, hi);
  }
  for (auto& th : threads) th.join();
  for (int b : bad)
    if (b) return -2;
  return 0;
}

void rb_close(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  if (h->map) munmap(h->map, h->map_len);
  if (h->fd >= 0) ::close(h->fd);
  delete h;
}

}  // extern "C"
