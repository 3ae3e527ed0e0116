// Native host-side IO + codec library of compressed_tensors_tpu_torch.
//
// Covers host work that benefits from native code:
//   - parallel pread of safetensors shard ranges (cold-cache checkpoint
//     loads are IO-latency bound; N threads keep the device queue full)
//   - the dense int32 <-> int4/int8 packing codec, on the host
//
// Exposed via a plain C ABI and loaded with ctypes. Built with g++ into
// build/native/ on first use by compressed_tensors_tpu_torch.utils.native.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

// Read [offset, offset+size) of `path` into `dest` using `num_threads`
// parallel pread workers. Returns 0 on success, -1 on failure.
int ct_read_range_parallel(const char* path, uint64_t offset, uint64_t size,
                           uint8_t* dest, int num_threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;

  if (num_threads < 1) num_threads = 1;
  uint64_t chunk = (size + num_threads - 1) / num_threads;
  // keep chunks at least 4MB so small reads stay single-threaded
  const uint64_t kMinChunk = 4ull << 20;
  if (chunk < kMinChunk) {
    chunk = kMinChunk;
    num_threads = (int)((size + chunk - 1) / chunk);
    if (num_threads < 1) num_threads = 1;
  }

  std::vector<std::thread> workers;
  std::vector<int> status(num_threads, 0);
  for (int t = 0; t < num_threads; ++t) {
    workers.emplace_back([&, t]() {
      uint64_t begin = (uint64_t)t * chunk;
      if (begin >= size) return;
      uint64_t end = begin + chunk;
      if (end > size) end = size;
      uint64_t pos = begin;
      while (pos < end) {
        ssize_t n = pread(fd, dest + pos, end - pos, (off_t)(offset + pos));
        if (n <= 0) {
          status[t] = -1;
          return;
        }
        pos += (uint64_t)n;
      }
    });
  }
  for (auto& w : workers) w.join();
  close(fd);
  for (int s : status)
    if (s != 0) return -1;
  return 0;
}

// Unpack dense cross-element int32-packed values (num_bits in [1,8]) into
// signed int8. Layout matches compressed-tensors pack_to_int32: element i of
// a row sits at global bit position i*num_bits (little-endian within int32
// words), stored offset-unsigned by 2^(num_bits-1).
void ct_unpack_int32(const int32_t* packed, int8_t* out, int64_t rows,
                     int64_t packed_cols, int64_t cols, int num_bits) {
  const uint32_t mask = (num_bits == 32) ? 0xffffffffu
                                         : ((1u << num_bits) - 1u);
  const int32_t offset = 1 << (num_bits - 1);
  const uint32_t* words = (const uint32_t*)packed;
  for (int64_t r = 0; r < rows; ++r) {
    const uint32_t* row = words + r * packed_cols;
    int8_t* orow = out + r * cols;
    for (int64_t c = 0; c < cols; ++c) {
      uint64_t bit_start = (uint64_t)c * num_bits;
      uint64_t word_idx = bit_start >> 5;
      uint32_t bit_off = (uint32_t)(bit_start & 31);
      uint32_t lo_bits = 32 - bit_off;
      uint32_t val;
      if (lo_bits >= (uint32_t)num_bits) {
        val = (row[word_idx] >> bit_off) & mask;
      } else {
        uint32_t lo = row[word_idx] >> bit_off;
        uint32_t hi = row[word_idx + 1] << lo_bits;
        val = (lo | hi) & mask;
      }
      orow[c] = (int8_t)((int32_t)val - offset);
    }
  }
}

// Pack signed int8 values (within the num_bits range) into dense int32.
void ct_pack_int32(const int8_t* values, int32_t* out, int64_t rows,
                   int64_t cols, int64_t packed_cols, int num_bits) {
  const int32_t offset = 1 << (num_bits - 1);
  uint32_t* words = (uint32_t*)out;
  memset(words, 0, (size_t)(rows * packed_cols) * sizeof(uint32_t));
  for (int64_t r = 0; r < rows; ++r) {
    const int8_t* row = values + r * cols;
    uint32_t* orow = words + r * packed_cols;
    for (int64_t c = 0; c < cols; ++c) {
      uint32_t val = (uint32_t)(row[c] + offset);
      uint64_t bit_start = (uint64_t)c * num_bits;
      uint64_t word_idx = bit_start >> 5;
      uint32_t bit_off = (uint32_t)(bit_start & 31);
      orow[word_idx] |= val << bit_off;
      uint32_t lo_bits = 32 - bit_off;
      if (lo_bits < (uint32_t)num_bits) {
        orow[word_idx + 1] |= val >> lo_bits;
      }
    }
  }
}

// Multithreaded variant of ct_unpack_int32 (row-partitioned).
void ct_unpack_int32_mt(const int32_t* packed, int8_t* out, int64_t rows,
                        int64_t packed_cols, int64_t cols, int num_bits,
                        int num_threads) {
  if (num_threads < 2 || rows < num_threads) {
    ct_unpack_int32(packed, out, rows, packed_cols, cols, num_bits);
    return;
  }
  std::vector<std::thread> workers;
  int64_t rows_per = (rows + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int64_t begin = (int64_t)t * rows_per;
    if (begin >= rows) break;
    int64_t count = rows_per;
    if (begin + count > rows) count = rows - begin;
    workers.emplace_back([=]() {
      ct_unpack_int32(packed + begin * packed_cols, out + begin * cols,
                      count, packed_cols, cols, num_bits);
    });
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
