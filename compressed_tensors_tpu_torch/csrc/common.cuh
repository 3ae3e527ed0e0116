// Helpers shared by the port's hand-written Hopper kernels: tensor-core
// mma.sync wrappers, cp.async copies and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ct {

__device__ __forceinline__ uint32_t ld_shared_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A * B for one 16x8x16 bf16 tile, f32 accumulate. Fragment layouts
// (PTX ISA, mma.m16n8k16): g = lane / 4, t = lane % 4;
//   a0: (g, 2t..2t+1)  a1: (g+8, 2t..)  a2: (g, 2t+8..)  a3: (g+8, 2t+8..)
//   b0: (k = 2t..2t+1, n = g)  b1: (k = 2t+8.., n = g)
//   d0,d1: (g, 2t..2t+1)  d2,d3: (g+8, 2t..2t+1)
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D += A * B for one 16x8x32 int8 tile, int32 accumulate. Layouts as above
// with 4 int8 per register: a0: (g, 4t..4t+3)  a1: (g+8, 4t..)
//   a2: (g, 4t+16..)  a3: (g+8, 4t+16..);  b0: (k = 4t..4t+3, n = g)
//   b1: (k = 4t+16.., n = g);  d as for the bf16 tile.
__device__ __forceinline__ void mma_s8_16832(int* d, const uint32_t* a,
                                             const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16-byte global -> shared copy; src_bytes == 0 fills the 16 bytes with 0.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace ct
