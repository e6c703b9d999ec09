// Native runtime components for gfx_ocean_tpu.
//
// The reference's host layer is entirely native (Rust over gfx-hal); the
// TPU rebuild keeps the compute path in XLA but implements the host-side
// asset I/O natively too (SURVEY.md §2.6): a zero-copy bincode reader for
// the shipped spectrum.bin/omega.bin (format: u64-LE element count +
// packed f32 payload — what bincode 1.x emits for Vec<f32> / Vec<[f32;2]>,
// deserialized by the reference at src/render.rs:769-810), a .npy v1
// writer for field dumps, and a monotonic ns timer for benchmark
// harnesses.
//
// Exposed as a plain C ABI consumed via ctypes
// (gfx_ocean_tpu/native/bincode_native.py). Status codes < 0 are errors;
// the Python wrapper maps them to exceptions. No exceptions cross the
// boundary.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int64_t kErrOpen = -1;
constexpr int64_t kErrStat = -2;
constexpr int64_t kErrTooSmall = -3;
constexpr int64_t kErrSizeMismatch = -4;
constexpr int64_t kErrMap = -5;
constexpr int64_t kErrWrite = -6;
constexpr int64_t kErrArg = -7;

struct MappedFile {
  const uint8_t* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) { ::close(fd); fd = -1; return false; }
    size = static_cast<size_t>(st.st_size);
    if (size == 0) { data = nullptr; return true; }
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) { ::close(fd); fd = -1; return false; }
    data = static_cast<const uint8_t*>(p);
    return true;
  }

  ~MappedFile() {
    if (data) munmap(const_cast<uint8_t*>(data), size);
    if (fd >= 0) ::close(fd);
  }
};

// Copy a bincode Vec<f32[components]> payload into dst (caller-allocated).
int64_t load_bincode(const char* path, float* dst, int64_t expected_elems,
                     int64_t components) {
  if (!path || !dst || components <= 0) return kErrArg;
  MappedFile f;
  if (!f.open(path)) return kErrOpen;
  if (f.size < 8) return kErrTooSmall;
  uint64_t count;
  std::memcpy(&count, f.data, 8);  // u64 little-endian length prefix
  // Reject counts whose payload size would overflow u64 (a corrupt
  // header like 2^61 would wrap count*4*components to a small value and
  // pass the size check) — mirrors the Python parser's exact bigint
  // arithmetic (assets/bincode.py).
  if (count > (UINT64_MAX - 8) / (4ull * static_cast<uint64_t>(components)))
    return kErrSizeMismatch;
  const uint64_t payload = count * 4ull * static_cast<uint64_t>(components);
  if (f.size != 8 + payload) return kErrSizeMismatch;
  if (expected_elems >= 0 && static_cast<uint64_t>(expected_elems) != count)
    return kErrSizeMismatch;
  std::memcpy(dst, f.data + 8, payload);
  return static_cast<int64_t>(count);
}

}  // namespace

extern "C" {

// Returns the element count of a bincode vector file with `components`
// f32s per element, or a negative status.
int64_t on_bincode_count(const char* path, int64_t components) {
  if (!path || components <= 0) return kErrArg;
  MappedFile f;
  if (!f.open(path)) return kErrOpen;
  if (f.size < 8) return kErrTooSmall;
  uint64_t count;
  std::memcpy(&count, f.data, 8);
  if (count > (UINT64_MAX - 8) / (4ull * static_cast<uint64_t>(components)))
    return kErrSizeMismatch;  // overflow-safe: see load_bincode
  if (f.size != 8 + count * 4ull * static_cast<uint64_t>(components))
    return kErrSizeMismatch;
  return static_cast<int64_t>(count);
}

int64_t on_load_f32(const char* path, float* dst, int64_t expected) {
  return load_bincode(path, dst, expected, 1);
}

int64_t on_load_vec2f(const char* path, float* dst, int64_t expected) {
  return load_bincode(path, dst, expected, 2);
}

// Write a C-contiguous f32 array as .npy v1.0.
int64_t on_write_npy_f32(const char* path, const float* data,
                         const int64_t* shape, int32_t ndim) {
  if (!path || !data || !shape || ndim <= 0 || ndim > 8) return kErrArg;
  char shape_str[256] = {0};
  size_t off = 0;
  int64_t total = 1;
  for (int i = 0; i < ndim; ++i) {
    total *= shape[i];
    off += static_cast<size_t>(
        snprintf(shape_str + off, sizeof(shape_str) - off, "%lld%s",
                 static_cast<long long>(shape[i]),
                 (ndim == 1 || i + 1 < ndim) ? "," : ""));
    if (off >= sizeof(shape_str) - 1) return kErrArg;
  }
  char header[512];
  int hlen = snprintf(header, sizeof(header),
                      "{'descr': '<f4', 'fortran_order': False, "
                      "'shape': (%s), }", shape_str);
  if (hlen < 0) return kErrWrite;
  // Pad so that magic(6)+version(2)+hlen(2)+header is a multiple of 64.
  int padded = ((10 + hlen + 1 + 63) / 64) * 64 - 10;
  FILE* fp = fopen(path, "wb");
  if (!fp) return kErrOpen;
  const uint8_t magic[8] = {0x93, 'N', 'U', 'M', 'P', 'Y', 1, 0};
  uint16_t hsize = static_cast<uint16_t>(padded);
  bool ok = fwrite(magic, 1, 8, fp) == 8 && fwrite(&hsize, 2, 1, fp) == 1 &&
            fwrite(header, 1, hlen, fp) == static_cast<size_t>(hlen);
  for (int i = hlen; ok && i < padded - 1; ++i) ok = fputc(' ', fp) != EOF;
  ok = ok && fputc('\n', fp) != EOF;
  ok = ok && fwrite(data, 4, total, fp) == static_cast<size_t>(total);
  return (fclose(fp) == 0 && ok) ? total : kErrWrite;
}

// Monotonic nanoseconds (CLOCK_MONOTONIC_RAW where available).
int64_t on_now_ns(void) {
  struct timespec ts;
#ifdef CLOCK_MONOTONIC_RAW
  clock_gettime(CLOCK_MONOTONIC_RAW, &ts);
#else
  clock_gettime(CLOCK_MONOTONIC, &ts);
#endif
  return static_cast<int64_t>(ts.tv_sec) * 1000000000ll + ts.tv_nsec;
}

}  // extern "C"
