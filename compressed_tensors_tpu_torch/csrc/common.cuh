// Helpers shared by the port's hand-written Hopper kernels: tensor-core
// mma.sync wrappers, ldmatrix, cp.async copies, the wgmma descriptor,
// fences and waits over 128-byte-swizzled tiles, the cluster launch, the
// split-K reduction, warp reductions, the int8 row quantizer of the a8b /
// a8 modes, fp8 e4m3 conversions, the KV cache element types and the
// decode-attention fragments of the block, flash and paged decode kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ct {

__device__ __forceinline__ uint32_t ld_shared_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, which lands in r[i] (row lane / 4, elements
// 2 (lane % 4) and + 1); .trans hands out columns instead of rows
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// (lo, hi) rounded to a bf16 pair in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// 4-byte global -> shared copy; src_bytes == 0 writes a 0
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const uint32_t s = smem_addr(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// D += A * B for one 16x8x32 fp8 e4m3 tile, f32 accumulate (sm_89+).
// Fragments as for the int8 tile, 4 e4m3 bytes per register.
__device__ __forceinline__ void mma_e4m3_16832(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- wgmma over 128-byte-swizzled K-major tiles (sm_90a) ------------- //

// byte offset of 16-byte chunk c of row r in a tile of 128-byte rows: the
// 128-byte XOR swizzle that wgmma's descriptors below read
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// wgmma operand descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle (the tile 1024-byte aligned): start address, leading
// byte offset 16 (unused), stride 1024 bytes between 8-row groups. A k
// step of 32 bytes inside the rows advances the start address by 32.
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile) {
  const uint32_t addr = smem_addr(tile);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// generic-proxy shared-memory writes (cp.async, st.shared) made visible to
// the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accumulator accesses across wgmma waits
template <int NR>
__device__ __forceinline__ void fence_regs(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int NR>
__device__ __forceinline__ void fence_regs(int (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// Kernel with dynamic shared memory above 48 KB: opted in once, then
// launched as one cluster per K split (cluster dims (1, 1, grid.z)).
template <auto Kernel, class... Args>
int launch(size_t smem, dim3 grid, int threads, cudaStream_t s,
           Args... args) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, Kernel, args...);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// f32 -> fp8 e4m3 (float8_e4m3fn) bits, round to nearest even, with no
// saturation: |x| above 464 (448 plus half an ulp), inf and NaN become
// NaN (0x7f), as __NV_NOSAT specifies and as ml_dtypes and XLA cast. The
// bit manipulation of c10::Float8_e4m3fn, without the saturation newer
// PyTorch versions add (the plain versions mark overflow NaN explicitly).
__device__ __forceinline__ uint8_t f32_to_e4m3(float x) {
  uint32_t f = __float_as_uint(x);
  const uint32_t sign = f & 0x80000000u;
  f ^= sign;
  uint32_t r;
  if (f >= (1087u << 20)) {          // >= 480, inf or NaN
    r = 0x7fu;
  } else if (f < (121u << 23)) {     // below 2^-6: subnormal e4m3
    r = __float_as_uint(__fadd_rn(__uint_as_float(f),
                                  __uint_as_float(141u << 23))) - (141u << 23);
  } else {
    const uint32_t odd = (f >> 20) & 1u;
    f += ((uint32_t)(7 - 127) << 23) + 0x7ffffu;
    f += odd;
    r = f >> 20;
  }
  return static_cast<uint8_t>(r | (sign >> 24));
}

// y = bf16(sum over splits of the f32 partials), the second pass of the
// split-K matmuls
static __global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                            __nv_bfloat16* __restrict__ y,
                                            int splits, size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * count + i];
  y[i] = __float2bfloat16(s);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Per-row int8 quantization of bf16 x, the activation pass of modes a8b
// and a8: scale = max(absmax, 1e-8) / 127 and q = clip(rint(x / scale),
// -127, 127), with IEEE division and round half to even, as the TPU kernel
// quantizes (w4a16_matmul.py:579-590). One block of A8B_QTHREADS a row
// reads the row once in 16-byte loads and keeps up to A8B_QHELD of them a
// thread (K <= 16384) in registers between the absmax and the codes
// (longer rows read the rest again), 8 codes a store; a row that is not
// 16-byte aligned takes 2-byte loads and reads itself twice.
constexpr int A8B_QTHREADS = 256, A8B_QHELD = 8;

__device__ __forceinline__ float absmax_bf16x8(uint4 u, float a) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    a = fmaxf(a, fmaxf(fabsf(f.x), fabsf(f.y)));
  }
  return a;
}

__device__ __forceinline__ int8_t quantize_a8b(float x, float scale) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(x / scale), -127.f), 127.f));
}

__device__ __forceinline__ uint2 quantize_a8b_x8(uint4 u, float scale) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  uint32_t q[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    q[j >> 1] |= (static_cast<uint32_t>(static_cast<uint8_t>(quantize_a8b(f.x, scale)))
                  | static_cast<uint32_t>(static_cast<uint8_t>(quantize_a8b(f.y, scale))) << 8)
                 << (16 * (j & 1));
  }
  return make_uint2(q[0], q[1]);
}

static __global__ void __launch_bounds__(A8B_QTHREADS)
quantize_rows_a8b_kernel(const __nv_bfloat16* __restrict__ x,
                         int8_t* __restrict__ xq, float* __restrict__ xs,
                         int K) {
  const int row = blockIdx.x, tid = threadIdx.x;
  const __nv_bfloat16* xr = x + (size_t)row * K;
  int8_t* qr = xq + (size_t)row * K;
  const bool vec = !(K & 7) && !(reinterpret_cast<uintptr_t>(xr) & 15) &&
                   !(reinterpret_cast<uintptr_t>(qr) & 7);
  const int nch = vec ? K / 8 : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(xr);
  uint4 v[A8B_QHELD];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < A8B_QHELD; ++i) {
    const int c = tid + i * A8B_QTHREADS;
    if (c < nch) {
      v[i] = xv[c];
      amax = absmax_bf16x8(v[i], amax);
    }
  }
  for (int c = tid + A8B_QHELD * A8B_QTHREADS; c < nch; c += A8B_QTHREADS)
    amax = absmax_bf16x8(xv[c], amax);
  if (!vec)
    for (int i = tid; i < K; i += A8B_QTHREADS)
      amax = fmaxf(amax, fabsf(__bfloat162float(xr[i])));
  __shared__ float red[A8B_QTHREADS / 32];
  amax = warp_max(amax);
  if ((tid & 31) == 0) red[tid >> 5] = amax;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int i = 1; i < A8B_QTHREADS / 32; ++i) m = fmaxf(m, red[i]);
  const float scale = fmaxf(m, 1e-8f) / 127.f;
  uint2* out = reinterpret_cast<uint2*>(qr);
#pragma unroll
  for (int i = 0; i < A8B_QHELD; ++i) {
    const int c = tid + i * A8B_QTHREADS;
    if (c < nch) out[c] = quantize_a8b_x8(v[i], scale);
  }
  for (int c = tid + A8B_QHELD * A8B_QTHREADS; c < nch; c += A8B_QTHREADS)
    out[c] = quantize_a8b_x8(xv[c], scale);
  if (!vec)
    for (int i = tid; i < K; i += A8B_QTHREADS)
      qr[i] = quantize_a8b(__bfloat162float(xr[i]), scale);
  if (tid == 0) xs[row] = scale;
}

// KV cache element types of the decode kernels. A bf16 cache holds the
// model's K/V as they are; an e4m3 or int8 cache holds x / scale, written
// with IEEE division (e4m3: the cast above; int8: rint, then clip to
// [-128, 127]), and is read back with a raw conversion: the scales fold
// into q and onto the output instead.
enum CacheKind { kCacheBF16 = 0, kCacheE4M3 = 1, kCacheInt8 = 2 };

template <int KIND> struct Cache;

template <> struct Cache<kCacheBF16> {
  using T = __nv_bfloat16;
  static constexpr bool kScaled = false;
  __device__ static float2 load2(const T* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static T from_new(__nv_bfloat16 x, float) { return x; }
};

template <> struct Cache<kCacheE4M3> {
  using T = uint8_t;
  static constexpr bool kScaled = true;
  // two e4m3 values -> f16x2 in one cvt (sm_89+), then f32: both exact
  __device__ static float2 load2(const T* p) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        *reinterpret_cast<const __nv_fp8x2_storage_t*>(p), __NV_E4M3);
    return __half22float2(__half2(h));
  }
  __device__ static T from_new(__nv_bfloat16 x, float s) {
    return f32_to_e4m3(__bfloat162float(x) / s);
  }
  // e4m3 -> bf16 is exact (3 mantissa bits, exponents within bf16's)
  __device__ static uint32_t widen2(uint32_t two) {
    const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(two), __NV_E4M3)));
    return pack_bf16x2(f.x, f.y);
  }
};

template <> struct Cache<kCacheInt8> {
  using T = int8_t;
  static constexpr bool kScaled = true;
  __device__ static float2 load2(const T* p) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
  }
  __device__ static T from_new(__nv_bfloat16 x, float s) {
    const float q = rintf(__bfloat162float(x) / s);
    return static_cast<T>(fminf(fmaxf(q, -128.f), 127.f));
  }
  // int8 -> bf16 is exact: for a byte r, bf16(0x4300 | (r & 0x7f)) -
  // bf16(0x4300 | (r & 0x80)) is its signed value (two LOP3s and a bf16x2
  // subtract a pair)
  __device__ static uint32_t widen2(uint32_t two) {
    uint32_t r;
    asm("prmt.b32 %0, %1, 0, 0x4140;\n" : "=r"(r) : "r"(two));
    uint32_t a = (r & 0x007F007Fu) | 0x43004300u;
    uint32_t b = (r & 0x00800080u) | 0x43004300u;
    __nv_bfloat162 d = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                               *reinterpret_cast<__nv_bfloat162*>(&b));
    return *reinterpret_cast<uint32_t*>(&d);
  }
};

// ---- decode attention on mma.sync (block decode, flash / paged decode) //
// The query heads of a kv group, padded to 16, are the A rows of mma.sync
// m16n8k16 bf16. A tile holds cached positions as rows of the cache's own
// bytes (bf16, e4m3 or int8) at a stride of RB bytes; a warp takes 16
// positions of it: S = Q K^T with K by ldmatrix, P V with V by
// ldmatrix.trans. 8-bit tiles reach the mma through b16 ldmatrix and are
// widened to bf16 in registers (exact): a K register holds bytes 4t ..
// 4t + 3 of a row, fed as k indices 2t, 2t + 1, 2t + 8, 2t + 9 (q is
// staged in that order, decode_q_col); a V register from ldmatrix.trans
// holds two positions of two columns, split by a byte permute into an even
// and an odd output column (decode_o_col).

// bytes 0 and 2 (even) or 1 and 3 (odd) of a register into its low half
__device__ __forceinline__ uint32_t bytes02(uint32_t r) { return __byte_perm(r, 0, 0x0020); }
__device__ __forceinline__ uint32_t bytes13(uint32_t r) { return __byte_perm(r, 0, 0x0031); }

// the column of q's element d in its staged bf16 row
template <bool RAW>
__device__ __forceinline__ int decode_q_col(int d) {
  const int e = d & 15;
  return RAW ? (d & ~15) + (e & 2) * 4 + (e >> 2) * 2 + (e & 1) : d;
}

// the output column of o[i][e & 1] (rows g for e < 2, g + 8 above)
template <bool RAW>
__device__ __forceinline__ int decode_o_col(int i, int e, int t) {
  return RAW ? 32 * (i >> 2) + 16 * ((i >> 1) & 1) + 4 * t + (i & 1) + 2 * (e & 1)
             : i * 8 + 2 * t + (e & 1);
}

// the Q fragments of the 16 staged rows (row stride RS bf16)
template <int D>
__device__ __forceinline__ void decode_q_frags(uint32_t (&qf)[D / 16][4],
                                               const __nv_bfloat16* qs, int RS,
                                               int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], qs + ((mi & 1) * 8 + (lane & 7)) * RS + (mi >> 1) * 8 + kk * 16);
}

// s[j] += q . k of rows g, g + 8 and positions r0 + 8 j + 2 t, + 1 of
// the K tile at `tile` (row stride RB bytes)
template <int D, int KIND>
__device__ __forceinline__ void decode_score16(float (&s)[2][4],
                                               const uint32_t (&qf)[D / 16][4],
                                               const unsigned char* tile, int RB,
                                               int r0, int lane) {
  using C = Cache<KIND>;
  const int mi = lane >> 3;
  if constexpr (KIND != kCacheBF16) {
    // matrices: positions 0-7 / 8-15 of the warp's 16 by bytes 32 c .. + 15
    // / + 16 .. + 31; a lane's register holds bytes 4t .. 4t + 3 of its row
    const unsigned char* kbase = tile + (r0 + (mi & 1) * 8 + (lane & 7)) * RB + (mi >> 1) * 16;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      uint32_t r[4];
      ldmatrix_x4(r, kbase + c * 32);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t bf[2] = {C::widen2(r[2 * h + j] & 0xffffu),
                                  C::widen2(r[2 * h + j] >> 16)};
          mma_bf16_16816(s[j], qf[2 * c + h], bf);
        }
      }
    }
  } else {
    const unsigned char* kbase = tile + (r0 + (mi >> 1) * 8 + (lane & 7)) * RB + (mi & 1) * 16;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t bf[4];
      ldmatrix_x4(bf, kbase + kk * 32);
      mma_bf16_16816(s[0], qf[kk], bf);
      mma_bf16_16816(s[1], qf[kk], bf + 2);
    }
  }
}

// o += P . V over positions r0 .. r0 + 15 of the V tile at `tile` (row
// stride RB bytes); pf: P as the bf16 A fragment of those positions. On
// 8-bit tiles o[4c + 2h + u] holds columns 32 c + 16 h + 2n + u.
template <int D, int KIND>
__device__ __forceinline__ void decode_pv16(float (&o)[D / 8][4], const uint32_t (&pf)[4],
                                            const unsigned char* tile, int RB, int r0,
                                            int lane) {
  using C = Cache<KIND>;
  const int mi = lane >> 3;
  const unsigned char* vbase = tile + (r0 + (mi & 1) * 8 + (lane & 7)) * RB + (mi >> 1) * 16;
  if constexpr (KIND != kCacheBF16) {
    // transposed matrices as for K: a lane's register holds elements 2g,
    // 2g + 1 of positions 2t, 2t + 1. Bytes 0, 2 are output column 2g,
    // bytes 1, 3 column 2g + 1.
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, vbase + c * 32);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t ev[2] = {C::widen2(bytes02(r[2 * h])),
                                C::widen2(bytes02(r[2 * h + 1]))};
        const uint32_t od[2] = {C::widen2(bytes13(r[2 * h])),
                                C::widen2(bytes13(r[2 * h + 1]))};
        mma_bf16_16816(o[4 * c + 2 * h], pf, ev);
        mma_bf16_16816(o[4 * c + 2 * h + 1], pf, od);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < D / 8; i += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, vbase + i * 16);
      mma_bf16_16816(o[i], pf, bf);
      mma_bf16_16816(o[i + 1], pf, bf + 2);
    }
  }
}

}  // namespace ct
