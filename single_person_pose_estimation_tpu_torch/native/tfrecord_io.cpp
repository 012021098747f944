// Native TFRecord reader: mmap + index + CRC32C (SSE4.2 when available).
//
// The PyTorch port's copy of the JAX package's native/tfrecord_io.cpp
// (same C interface, same checks). Files are mmap'd once, the record
// framing is walked and CRC-verified in native code, and Python receives
// zero-copy pointers into the mapping via ctypes
// (single_person_pose_estimation_tpu_torch/data/tfrecord.py).
//
// Framing per record: u64le length, u32le masked_crc(length), data,
// u32le masked_crc(data); masked(c) = ((c>>15)|(c<<17)) + 0xa282ead8.
//
// Build: data/tfrecord.py runs the host C++ compiler at first use
// (c++ -O3 -shared -fPIC -std=c++17 [-msse4.2]) into the package's _build/.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli). Software slice-by-8 fallback; SSE4.2 when compiled in.
// ---------------------------------------------------------------------------

uint32_t g_table[8][256];
bool g_table_init = false;

void init_table() {
  if (g_table_init) return;
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
    g_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = g_table[0][i];
    for (int t = 1; t < 8; t++) {
      c = g_table[0][c & 0xFF] ^ (c >> 8);
      g_table[t][i] = c;
    }
  }
  g_table_init = true;
}

uint32_t crc32c_sw(const uint8_t* p, int64_t n, uint32_t crc) {
  init_table();
  crc = ~crc;
  while (n >= 8) {
    uint64_t v;
    memcpy(&v, p, 8);
    v ^= crc;
    crc = g_table[7][v & 0xFF] ^ g_table[6][(v >> 8) & 0xFF] ^
          g_table[5][(v >> 16) & 0xFF] ^ g_table[4][(v >> 24) & 0xFF] ^
          g_table[3][(v >> 32) & 0xFF] ^ g_table[2][(v >> 40) & 0xFF] ^
          g_table[1][(v >> 48) & 0xFF] ^ g_table[0][(v >> 56) & 0xFF];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) crc = g_table[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

#if defined(__SSE4_2__)
uint32_t crc32c_hw(const uint8_t* p, int64_t n, uint32_t crc) {
  crc = ~crc;
  while (n >= 8) {
    uint64_t v;
    memcpy(&v, p, 8);
    crc = (uint32_t)_mm_crc32_u64(crc, v);
    p += 8;
    n -= 8;
  }
  while (n-- > 0) crc = _mm_crc32_u8(crc, *p++);
  return ~crc;
}
#endif

uint32_t crc32c(const uint8_t* p, int64_t n) {
#if defined(__SSE4_2__)
  return crc32c_hw(p, n, 0);
#else
  return crc32c_sw(p, n, 0);
#endif
}

uint32_t masked_crc(const uint8_t* p, int64_t n) {
  uint32_t c = crc32c(p, n);
  return ((c >> 15) | (c << 17)) + 0xA282EAD8u;
}

// ---------------------------------------------------------------------------
// File handle: mmap + record index
// ---------------------------------------------------------------------------

struct TfrecFile {
  uint8_t* base = nullptr;
  int64_t size = 0;
  std::vector<int64_t> offsets;  // offset of each record's data
  std::vector<int64_t> lengths;
};

}  // namespace

extern "C" {

void* tfrec_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  auto* f = new TfrecFile();
  f->size = st.st_size;
  if (f->size > 0) {
    f->base = (uint8_t*)mmap(nullptr, f->size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (f->base == MAP_FAILED) {
      close(fd);
      delete f;
      return nullptr;
    }
    madvise(f->base, f->size, MADV_SEQUENTIAL);
  }
  close(fd);

  int64_t pos = 0;
  while (pos + 12 <= f->size) {
    uint64_t len;
    memcpy(&len, f->base + pos, 8);
    uint32_t len_crc;
    memcpy(&len_crc, f->base + pos + 8, 4);
    if (masked_crc(f->base + pos, 8) != len_crc) goto corrupt;
    {
      // Overflow-proof bounds check: `len` is untrusted (CRC32C is not
      // cryptographic), and `pos + 12 + (int64_t)len + 4` can wrap for
      // len near 2^64, passing a naive comparison and sending the
      // data-CRC memcpy below out of the mapping.
      int64_t remaining = f->size - pos - 12;  // >= 0 by the loop condition
      if (remaining < 4 || len > (uint64_t)(remaining - 4)) goto corrupt;
    }
    {
      uint32_t data_crc;
      memcpy(&data_crc, f->base + pos + 12 + len, 4);
      if (masked_crc(f->base + pos + 12, (int64_t)len) != data_crc)
        goto corrupt;
    }
    f->offsets.push_back(pos + 12);
    f->lengths.push_back((int64_t)len);
    pos += 12 + (int64_t)len + 4;
  }
  if (pos != f->size) goto corrupt;
  return f;

corrupt:
  if (f->base) munmap(f->base, f->size);
  delete f;
  return nullptr;
}

void tfrec_close(void* handle) {
  auto* f = (TfrecFile*)handle;
  if (!f) return;
  if (f->base) munmap(f->base, f->size);
  delete f;
}

int64_t tfrec_num_records(void* handle) {
  return ((TfrecFile*)handle)->offsets.size();
}

const void* tfrec_record_ptr(void* handle, int64_t i, int64_t* length_out) {
  auto* f = (TfrecFile*)handle;
  if (i < 0 || i >= (int64_t)f->offsets.size()) return nullptr;
  *length_out = f->lengths[i];
  return f->base + f->offsets[i];
}

uint32_t tfrec_crc32c(const char* data, int64_t n) {
  return crc32c((const uint8_t*)data, n);
}

}  // extern "C"
