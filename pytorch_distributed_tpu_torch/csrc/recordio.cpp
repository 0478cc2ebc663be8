// The packed-record reader core of the input pipeline, host code (built
// with g++, not nvcc; data/native.py loads it with ctypes).
//
// The reference reads ImageNet from packed ffrecord files through a C++
// core (`hfai.datasets.ImageNet`, restnet_ddp.py:107-119). This reads the
// TPRC container, the JAX package's on-disk format, byte for byte (see
// data/packed_record.py for the layout), through the same C ABI:
//
//   [0)   magic  "TPRC"            4 bytes
//   [4)   version u32              = 1
//   [8)   n       u64              record count
//   [16)  flags   u64              bit0: per-record crc32 table present
//   [24)  offsets u64 * (n+1)      payload-relative record boundaries
//   [..)  crcs    u32 * n          (iff flags & 1)
//   [..)  payload                  concatenated record bytes
//
// Reads use pread(2): stateless, thread-safe, no shared file offset, so the
// loader's worker threads can fetch records concurrently against one
// handle. Optional crc32 verification per record (the zlib polynomial).
// tpr_crop_batch reads, crops, flips and collates a whole batch of raw
// uint8 image records on its own threads, with the GIL released by ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x43525054;  // "TPRC" little-endian
constexpr uint64_t kFlagCrc = 1;

struct Reader {
  int fd = -1;
  uint64_t n = 0;
  uint64_t flags = 0;
  uint64_t payload_start = 0;
  std::vector<uint64_t> offsets;  // n+1 entries, payload-relative
  std::vector<uint32_t> crcs;     // n entries iff (flags & kFlagCrc)
};

uint32_t crc32_table[256];
bool crc32_table_init_done = false;

void crc32_init() {
  if (crc32_table_init_done) return;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc32_table[i] = c;
  }
  crc32_table_init_done = true;
}

uint32_t crc32(const uint8_t* data, size_t len) {
  crc32_init();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i)
    c = crc32_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

bool read_exact(int fd, void* buf, size_t len, uint64_t offset) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  while (len > 0) {
    ssize_t r = pread(fd, p, len, static_cast<off_t>(offset));
    if (r <= 0) return false;
    p += r;
    offset += static_cast<uint64_t>(r);
    len -= static_cast<size_t>(r);
  }
  return true;
}

}  // namespace

extern "C" {

// Returns an opaque handle, or nullptr on failure.
void* tpr_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  auto* r = new Reader();
  r->fd = fd;
  struct stat st;
  uint8_t header[24];
  if (fstat(fd, &st) != 0) goto fail;
  if (!read_exact(fd, header, sizeof(header), 0)) goto fail;
  {
    uint32_t magic, version;
    memcpy(&magic, header, 4);
    memcpy(&version, header + 4, 4);
    memcpy(&r->n, header + 8, 8);
    memcpy(&r->flags, header + 16, 8);
    if (magic != kMagic || version != 1) goto fail;
    // A corrupt n must not reach resize(): the offset table alone needs
    // 8*(n+1) bytes, so n is bounded by the file size.
    uint64_t file_size = static_cast<uint64_t>(st.st_size);
    if (file_size < 24 || r->n > (file_size - 24) / 8) goto fail;
  }
  try {
    r->offsets.resize(r->n + 1);
    if (!read_exact(fd, r->offsets.data(), 8 * (r->n + 1), 24)) goto fail;
    r->payload_start = 24 + 8 * (r->n + 1);
    if (r->flags & kFlagCrc) {
      r->crcs.resize(r->n);
      if (!read_exact(fd, r->crcs.data(), 4 * r->n, r->payload_start)) goto fail;
      r->payload_start += 4 * r->n;
    }
  } catch (...) {
    goto fail;
  }
  return r;
fail:
  close(fd);
  delete r;
  return nullptr;
}

void tpr_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (r == nullptr) return;
  close(r->fd);
  delete r;
}

int64_t tpr_count(void* handle) {
  return static_cast<int64_t>(static_cast<Reader*>(handle)->n);
}

// Byte size of record i, or -1 if out of range.
int64_t tpr_size(void* handle, uint64_t i) {
  auto* r = static_cast<Reader*>(handle);
  if (i >= r->n) return -1;
  return static_cast<int64_t>(r->offsets[i + 1] - r->offsets[i]);
}

// Read record i into buf (caller sized it via tpr_size). Returns bytes read,
// -1 on I/O error, -2 on crc mismatch.
int64_t tpr_read(void* handle, uint64_t i, uint8_t* buf, int verify_crc) {
  auto* r = static_cast<Reader*>(handle);
  if (i >= r->n) return -1;
  uint64_t len = r->offsets[i + 1] - r->offsets[i];
  if (!read_exact(r->fd, buf, len, r->payload_start + r->offsets[i])) return -1;
  if (verify_crc && (r->flags & kFlagCrc)) {
    if (crc32(buf, len) != r->crcs[i]) return -2;
  }
  return static_cast<int64_t>(len);
}

// Gather a batch: indices[k] → buf + buf_offsets[k]. Returns 0, or the
// negative status of the first failing record.
int64_t tpr_read_batch(void* handle, const uint64_t* indices, int64_t count,
                       uint8_t* buf, const uint64_t* buf_offsets,
                       int verify_crc) {
  for (int64_t k = 0; k < count; ++k) {
    int64_t status = tpr_read(handle, indices[k], buf + buf_offsets[k], verify_crc);
    if (status < 0) return status;
  }
  return 0;
}

// Batched crop/flip/collate over RAW image records (data/raw.py layout:
// label u32 | h u16 | w u16 | h*w*3 uint8 RGB). The whole batch — read,
// header parse, crop window copy, optional horizontal flip, label extract —
// happens here in one call with no per-sample Python work and no GIL
// (ctypes releases it): the native half of the decode-free input path.
//
// out_images is [count, crop, crop, 3] uint8, out_labels [count] int32;
// tops/lefts give each sample's crop origin, flips[k] != 0 mirrors
// horizontally. expect_h/expect_w pin the stored image size the CALLER
// drew the crop coordinates for: a record whose header disagrees fails
// with -3 (the Python side then falls back to the per-sample path, which
// reads true per-record sizes) instead of silently cropping with a wrong
// distribution. Work is split over n_threads (pread is stateless, so
// threads share the handle safely). Returns 0; -1 on I/O/bounds error;
// -3 on a size mismatch.
int64_t tpr_crop_batch(void* handle, const uint64_t* indices, int64_t count,
                       const int32_t* tops, const int32_t* lefts,
                       const uint8_t* flips, int32_t crop,
                       int32_t expect_h, int32_t expect_w,
                       uint8_t* out_images, int32_t* out_labels,
                       int n_threads) {
  auto* r = static_cast<Reader*>(handle);
  const uint64_t out_stride =
      static_cast<uint64_t>(crop) * static_cast<uint64_t>(crop) * 3;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > count) n_threads = static_cast<int>(count);

  std::vector<int64_t> status(static_cast<size_t>(n_threads), 0);
  auto worker = [&](int t) {
    std::vector<uint8_t> scratch;
    for (int64_t k = t; k < count; k += n_threads) {
      uint64_t i = indices[k];
      if (i >= r->n) { status[t] = -1; return; }
      uint64_t len = r->offsets[i + 1] - r->offsets[i];
      if (len < 8) { status[t] = -1; return; }
      scratch.resize(len);
      if (!read_exact(r->fd, scratch.data(), len,
                      r->payload_start + r->offsets[i])) {
        status[t] = -1;
        return;
      }
      int32_t label;
      uint16_t h, w;
      memcpy(&label, scratch.data(), 4);
      memcpy(&h, scratch.data() + 4, 2);
      memcpy(&w, scratch.data() + 6, 2);
      if (h != expect_h || w != expect_w) { status[t] = -3; return; }
      const int32_t top = tops[k], left = lefts[k];
      if (top < 0 || left < 0 || top + crop > h || left + crop > w ||
          len < 8 + static_cast<uint64_t>(h) * w * 3) {
        status[t] = -1;
        return;
      }
      const uint8_t* img = scratch.data() + 8;
      uint8_t* dst = out_images + static_cast<uint64_t>(k) * out_stride;
      const uint64_t row_bytes = static_cast<uint64_t>(crop) * 3;
      for (int32_t y = 0; y < crop; ++y) {
        const uint8_t* src =
            img + (static_cast<uint64_t>(top + y) * w + left) * 3;
        uint8_t* drow = dst + static_cast<uint64_t>(y) * row_bytes;
        if (flips[k]) {
          for (int32_t x = 0; x < crop; ++x) {
            const uint8_t* px = src + static_cast<uint64_t>(crop - 1 - x) * 3;
            drow[3 * x + 0] = px[0];
            drow[3 * x + 1] = px[1];
            drow[3 * x + 2] = px[2];
          }
        } else {
          memcpy(drow, src, row_bytes);
        }
      }
      out_labels[k] = label;
    }
  };

  if (n_threads == 1) {
    worker(0);
    return status[0];
  }
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(n_threads));
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
  for (auto& th : threads) th.join();
  for (int t = 0; t < n_threads; ++t)
    if (status[t] < 0) return status[t];
  return 0;
}

}  // extern "C"
