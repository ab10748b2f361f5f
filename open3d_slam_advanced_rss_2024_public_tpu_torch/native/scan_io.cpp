// Native host-side components: zero-copy scan decoding + SPSC ring buffer.
//
// A copy of the JAX package's native/scan_io.cpp for the PyTorch port.  The
// reference's runtime is native C++ (SlamWrapper worker threads +
// CircularBuffer hand-offs, libpointmatcher's CSV/PCD IO); the device path
// runs in PyTorch and CUDA, and the host-side data plane gets this module:
//   * decode_f32_file: mmap-based bulk decode of float32 record files
//     (KITTI velodyne .bin, raw scan dumps) straight into caller memory,
//   * pcd_read_binary: binary-PCD payload extraction (header parsed in
//     Python, payload copied natively),
//   * an SPSC lock-free ring buffer (CircularBuffer.hpp equivalent) for
//     sensor->pipeline hand-off without the GIL in the hot path.
//
// Exposed with a plain C ABI for ctypes.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// Bulk float32 record decode (mmap + single memcpy into caller buffer).
// Returns number of floats written, or -1 on error.
// ---------------------------------------------------------------------------
long decode_f32_file(const char* path, float* out, long max_floats) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -1; }
  long n_floats = static_cast<long>(st.st_size / sizeof(float));
  if (n_floats > max_floats) n_floats = max_floats;
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) { close(fd); return -1; }
  std::memcpy(out, map, n_floats * sizeof(float));
  munmap(map, st.st_size);
  close(fd);
  return n_floats;
}

// Return file size in bytes (-1 on error) so callers can size buffers.
long file_size_bytes(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return -1;
  return static_cast<long>(st.st_size);
}

// ---------------------------------------------------------------------------
// Binary PCD payload: copy `count` float32 fields starting at byte offset
// `data_offset` (header length) into `out`.  Returns floats copied or -1.
// ---------------------------------------------------------------------------
long pcd_read_binary(const char* path, long data_offset, float* out,
                     long n_floats) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -1; }
  long avail = (static_cast<long>(st.st_size) - data_offset) /
               static_cast<long>(sizeof(float));
  if (avail < 0) { close(fd); return -1; }
  if (n_floats > avail) n_floats = avail;
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) { close(fd); return -1; }
  std::memcpy(out, static_cast<const char*>(map) + data_offset,
              n_floats * sizeof(float));
  munmap(map, st.st_size);
  close(fd);
  return n_floats;
}

// ---------------------------------------------------------------------------
// SPSC lock-free ring buffer of fixed-size float records
// (≙ open3d_slam CircularBuffer.hpp, but wait-free).
// ---------------------------------------------------------------------------
struct RingBuffer {
  float* data;
  long* sizes;           // per-slot payload float counts
  double* stamps;        // per-slot timestamps
  long slot_floats;      // capacity of one slot
  long n_slots;
  std::atomic<long> head; // next write
  std::atomic<long> tail; // next read
};

void* ring_create(long n_slots, long slot_floats) {
  RingBuffer* rb = new RingBuffer();
  rb->data = new float[n_slots * slot_floats];
  rb->sizes = new long[n_slots];
  rb->stamps = new double[n_slots];
  rb->slot_floats = slot_floats;
  rb->n_slots = n_slots;
  rb->head.store(0);
  rb->tail.store(0);
  return rb;
}

void ring_destroy(void* h) {
  RingBuffer* rb = static_cast<RingBuffer*>(h);
  delete[] rb->data;
  delete[] rb->sizes;
  delete[] rb->stamps;
  delete rb;
}

long ring_size(void* h) {
  RingBuffer* rb = static_cast<RingBuffer*>(h);
  return rb->head.load(std::memory_order_acquire) -
         rb->tail.load(std::memory_order_acquire);
}

// Push a record; returns 1 on success, 0 when full (bounded-buffer drop,
// like the reference's CircularBuffer semantics).
int ring_push(void* h, const float* payload, long n_floats, double stamp) {
  RingBuffer* rb = static_cast<RingBuffer*>(h);
  long head = rb->head.load(std::memory_order_relaxed);
  long tail = rb->tail.load(std::memory_order_acquire);
  if (head - tail >= rb->n_slots) return 0;  // full
  long slot = head % rb->n_slots;
  long n = n_floats < rb->slot_floats ? n_floats : rb->slot_floats;
  std::memcpy(rb->data + slot * rb->slot_floats, payload, n * sizeof(float));
  rb->sizes[slot] = n;
  rb->stamps[slot] = stamp;
  rb->head.store(head + 1, std::memory_order_release);
  return 1;
}

// Pop into caller buffer; returns floats read, 0 when empty.
long ring_pop(void* h, float* out, long max_floats, double* stamp_out) {
  RingBuffer* rb = static_cast<RingBuffer*>(h);
  long tail = rb->tail.load(std::memory_order_relaxed);
  long head = rb->head.load(std::memory_order_acquire);
  if (tail >= head) return 0;  // empty
  long slot = tail % rb->n_slots;
  long n = rb->sizes[slot] < max_floats ? rb->sizes[slot] : max_floats;
  std::memcpy(out, rb->data + slot * rb->slot_floats, n * sizeof(float));
  *stamp_out = rb->stamps[slot];
  rb->tail.store(tail + 1, std::memory_order_release);
  return n;
}

}  // extern "C"
