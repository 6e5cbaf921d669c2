// Shared-memory ring buffer for DataLoader worker->trainer batch transport.
//
// Reference parity: paddle/fluid/memory/allocation/mmap_allocator.cc +
// paddle/fluid/pybind/reader_py.cc — the reference moves LoDTensors between
// DataLoader worker processes and the trainer through shared memory to avoid
// pickling through a pipe. This is the port's equivalent: a
// single-producer single-consumer byte ring in POSIX shm (one ring per
// worker), length-framed records, lock-free via C11 atomics.
//
// The port's own copy of paddle_tpu/_native/shm_ring.cpp. Built with the
// host g++ at first use by paddle_tpu_torch/_native/__init__.py and reached
// through ctypes: a plain C interface, no Python.h.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct RingHeader {
  std::atomic<uint64_t> head;  // write cursor (bytes, monotonically grows)
  std::atomic<uint64_t> tail;  // read cursor
  uint64_t capacity;           // data region size in bytes
};

struct Ring {
  RingHeader* hdr;
  uint8_t* data;
  uint64_t map_size;
  int fd;
};

inline uint64_t ring_free(const RingHeader* h) {
  return h->capacity -
         (h->head.load(std::memory_order_acquire) -
          h->tail.load(std::memory_order_acquire));
}

inline uint64_t ring_used(const RingHeader* h) {
  return h->head.load(std::memory_order_acquire) -
         h->tail.load(std::memory_order_acquire);
}

void copy_in(Ring* r, uint64_t pos, const uint8_t* src, uint64_t n) {
  uint64_t off = pos % r->hdr->capacity;
  uint64_t first = n < (r->hdr->capacity - off) ? n : (r->hdr->capacity - off);
  std::memcpy(r->data + off, src, first);
  if (n > first) std::memcpy(r->data, src + first, n - first);
}

void copy_out(Ring* r, uint64_t pos, uint8_t* dst, uint64_t n) {
  uint64_t off = pos % r->hdr->capacity;
  uint64_t first = n < (r->hdr->capacity - off) ? n : (r->hdr->capacity - off);
  std::memcpy(dst, r->data + off, first);
  if (n > first) std::memcpy(dst + first, r->data, n - first);
}

}  // namespace

extern "C" {

// Create (owner=1) or attach (owner=0) a ring of `capacity` data bytes.
// Returns an opaque handle or null.
void* shmring_open(const char* name, uint64_t capacity, int owner) {
  int flags = owner ? (O_CREAT | O_RDWR) : O_RDWR;
  int fd = shm_open(name, flags, 0600);
  if (fd < 0) return nullptr;
  uint64_t map_size = sizeof(RingHeader) + capacity;
  if (owner) {
    if (ftruncate(fd, static_cast<off_t>(map_size)) != 0) {
      close(fd);
      shm_unlink(name);
      return nullptr;
    }
  } else {
    struct stat st;
    if (fstat(fd, &st) != 0 || static_cast<uint64_t>(st.st_size) < map_size) {
      close(fd);
      return nullptr;
    }
  }
  void* mem = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Ring* r = new Ring();
  r->hdr = static_cast<RingHeader*>(mem);
  r->data = reinterpret_cast<uint8_t*>(mem) + sizeof(RingHeader);
  r->map_size = map_size;
  r->fd = fd;
  if (owner) {
    r->hdr->head.store(0, std::memory_order_relaxed);
    r->hdr->tail.store(0, std::memory_order_relaxed);
    r->hdr->capacity = capacity;
  }
  return r;
}

// Push one length-framed record. Returns 0 on success, -1 if it does not
// fit right now (caller retries), -2 if it can never fit.
int shmring_push(void* handle, const uint8_t* buf, uint64_t n) {
  Ring* r = static_cast<Ring*>(handle);
  uint64_t need = n + sizeof(uint64_t);
  if (need > r->hdr->capacity) return -2;
  if (ring_free(r->hdr) < need) return -1;
  uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
  copy_in(r, head, reinterpret_cast<const uint8_t*>(&n), sizeof(uint64_t));
  copy_in(r, head + sizeof(uint64_t), buf, n);
  r->hdr->head.store(head + need, std::memory_order_release);
  return 0;
}

// Size of the next record, or -1 if empty.
int64_t shmring_next_size(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  if (ring_used(r->hdr) < sizeof(uint64_t)) return -1;
  uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  uint64_t n;
  copy_out(r, tail, reinterpret_cast<uint8_t*>(&n), sizeof(uint64_t));
  return static_cast<int64_t>(n);
}

// Pop the next record into out (must hold shmring_next_size bytes).
// Returns bytes written, or -1 if empty.
int64_t shmring_pop(void* handle, uint8_t* out, uint64_t max) {
  Ring* r = static_cast<Ring*>(handle);
  int64_t n = shmring_next_size(handle);
  if (n < 0 || static_cast<uint64_t>(n) > max) return -1;
  uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  copy_out(r, tail + sizeof(uint64_t), out, static_cast<uint64_t>(n));
  r->hdr->tail.store(tail + sizeof(uint64_t) + static_cast<uint64_t>(n),
                     std::memory_order_release);
  return n;
}

uint64_t shmring_used(void* handle) {
  return ring_used(static_cast<Ring*>(handle)->hdr);
}

void shmring_close(void* handle, const char* name, int unlink_it) {
  Ring* r = static_cast<Ring*>(handle);
  munmap(r->hdr, r->map_size);
  close(r->fd);
  if (unlink_it) shm_unlink(name);
  delete r;
}

}  // extern "C"
