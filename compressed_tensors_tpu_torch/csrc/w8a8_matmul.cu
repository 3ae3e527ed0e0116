// W8A8 matmul for Hopper with dynamic per-token activation quantization,
// int8 or fp8 e4m3, in one template for both types.
//
// Replaces compressed_tensors_tpu/ops/kernels/w8a8_matmul.py:w8a8_matmul
// (:118, pallas_call :175). Pass 1 quantizes each row of x exactly as the
// TPU kernel does:
//   int8: scale = max(absmax / 127.5, 1e-10), q = rint(clip(x / scale,
//         -128, 127)) (round half to even);
//   fp8:  scale = max(absmax / 448, 1e-10), q = e4m3(clip(x / scale, -448,
//         448)) (round to nearest even),
// with IEEE division, keeping the per-row scale. One block a row reads the
// row once in 16-byte loads and keeps it in registers (K <= 16384) between
// the absmax and the quantization. Pass 2 is a GEMM on wgmma over the
// checkpoint's (N, K) weight rows and the (M, K) quantized rows, both
// K-major, which is what 8-bit wgmma requires: int8 x int8 with exact
// int32 sums, or e4m3 x e4m3 with f32 sums. The epilogue acc * x_scale *
// w_scale is computed in f32 and written once in bf16, 16 bytes a store.
//
// Both operands of every wgmma are 128-byte-swizzled tiles in shared
// memory, one 128-deep k-tile (a 128-byte row) per stage of a cp.async
// ring, 2 tiles of loads ahead of the one in use. Two designs share the
// ring, the loader and the epilogue:
//   decode rows (M <= 64, bm = 16, 32 or 64): the N*K weight bytes bound
//         it. y^T = W . x^T: each block of two warpgroups takes 128 weight
//         rows (wgmma m64n{bm}k32, A = the weight tile, B = x), two blocks
//         an SM, and K is split over a thread-block cluster of up to 4
//         blocks when the column tiles leave SMs idle (qkv, o_proj and
//         down_proj), the partial tiles summed through distributed shared
//         memory (int32 partials as integers, so int8 stays exact).
//   prefill rows (bm = 128): the 2*M*N*K tensor-core operations bound it.
//         128 x 256 output tiles, each warpgroup 64 rows on wgmma
//         m64n256k32 (int8) or m64n64k32 over four column slices (fp8,
//         below), row tiles fastest in the grid so the blocks of a weight
//         column tile run together and read it once from device memory; K
//         split over a cluster as at decode rows when the tiles leave SMs
//         idle.
// The tensor cores sum e4m3 products with fewer bits than f32: chained
// over a 128-deep k-tile they left elements of the 8B linears outside the
// a8b rule (2^-8 |y| + 1e-4 max|y|). So fp8 sums each run of CHAIN (2) k32
// steps afresh in one of two partial accumulators (at prefill rows over a
// 64-column slice, so both fit beside the 128 f32 sums) and adds it to
// the f32 total in registers while the next run is in flight; int8 sums
// the whole K exactly in s32, its wgmmas in flight across the barriers.
// Ragged M, N and K (a multiple of 16) are zero-filled by cp.async and
// masked at the store. No warp specialization and no setmaxnreg.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using ct::fence_async_smem;
using ct::fence_regs;
using ct::swz;
using ct::wgmma_commit;
using ct::wgmma_desc;
using ct::wgmma_fence;
using ct::wgmma_wait0;
using ct::wgmma_wait1;

// fp8 k32 steps summed in the tensor cores before an f32 add, cp.async
// ring stages, output columns of a prefill tile (tools/w8a8_sweep.py;
// PERF.md keeps the readings of the other values tried)
constexpr int CHAIN = 2, STAGES = 4, PBN = 256;

constexpr int BK = 128;           // k values (bytes) a k-tile: one swizzled row
constexpr int STEPS = BK / 32;    // wgmma k32 steps a k-tile
constexpr int THREADS = 256;      // two warpgroups
constexpr int BW = 128;           // weight rows a decode block
constexpr int QTHREADS = 256;     // row-quantize block
constexpr int QHELD = 8;          // 16-byte chunks a quantize thread holds

// ---- pass 1: per-row quantization ------------------------------------ //

__device__ __forceinline__ float absmax8(uint4 u, float a) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    a = fmaxf(a, fmaxf(fabsf(f.x), fabsf(f.y)));
  }
  return a;
}

template <bool FP8>
__device__ __forceinline__ uint2 quantize8(uint4 u, float scale) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  uint32_t q[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v = (e ? f.y : f.x) / scale;
      uint32_t b;
      if (FP8)
        b = ct::f32_to_e4m3(fminf(fmaxf(v, -448.f), 448.f));
      else
        b = static_cast<uint8_t>(static_cast<int8_t>(
            rintf(fminf(fmaxf(v, -128.f), 127.f))));
      q[j >> 1] |= b << (8 * (2 * (j & 1) + e));
    }
  }
  return make_uint2(q[0], q[1]);
}

template <bool FP8>
__global__ void __launch_bounds__(QTHREADS)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x,
                     uint8_t* __restrict__ xq, float* __restrict__ xs, int K) {
  const int row = blockIdx.x, tid = threadIdx.x, nch = K / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  uint4 v[QHELD];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < QHELD; ++i) {
    const int c = tid + i * QTHREADS;
    if (c < nch) {
      v[i] = xr[c];
      amax = absmax8(v[i], amax);
    }
  }
  for (int c = tid + QHELD * QTHREADS; c < nch; c += QTHREADS)
    amax = absmax8(xr[c], amax);
  __shared__ float red[QTHREADS / 32];
  amax = ct::warp_max(amax);
  if ((tid & 31) == 0) red[tid >> 5] = amax;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int i = 1; i < QTHREADS / 32; ++i) m = fmaxf(m, red[i]);
  const float scale = fmaxf(m / (FP8 ? 448.f : 127.5f), 1e-10f);
  uint2* out = reinterpret_cast<uint2*>(xq + (size_t)row * K);
#pragma unroll
  for (int i = 0; i < QHELD; ++i) {
    const int c = tid + i * QTHREADS;
    if (c < nch) out[c] = quantize8<FP8>(v[i], scale);
  }
  for (int c = tid + QHELD * QTHREADS; c < nch; c += QTHREADS)
    out[c] = quantize8<FP8>(xr[c], scale);
  if (tid == 0) xs[row] = scale;
}

// ---- 8-bit wgmma, both operands in shared memory ---------------------- //

// d (+)= A (64 x 32, K-major, da) . B (N x 32, K-major, db) over one
// warpgroup; scale_d = 0 overwrites d. float: e4m3 with f32 sums; int: s8
// with s32 sums.
__device__ __forceinline__ void wgmma_m64n16k32(
    float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.f32.e4m3.e4m3 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n16k32(
    int (&d)[8], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n32k32(
    float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.f32.e4m3.e4m3 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n32k32(
    int (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k32(
    float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.f32.e4m3.e4m3 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k32(
    int (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n256k32(
    float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.f32.e4m3.e4m3 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n256k32(
    int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N, class Acc>
__device__ __forceinline__ void wgmma8(Acc (&d)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  if constexpr (N == 16) wgmma_m64n16k32(d, da, db, scale_d);
  else if constexpr (N == 32) wgmma_m64n32k32(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_m64n64k32(d, da, db, scale_d);
  else wgmma_m64n256k32(d, da, db, scale_d);
}

// ---- pass 2: the GEMM ------------------------------------------------- //

// cp.async copies of rows [row0, row0 + R) of an (rows, K) 8-bit matrix,
// bytes [k0, k0 + BK), into a swizzled tile; zero past rows and K
template <int R>
__device__ __forceinline__ void load_rows(unsigned char* tile,
                                          const uint8_t* __restrict__ src,
                                          int rows, int row0, int K, int k0) {
  constexpr int CH = R * (BK / 16);
#pragma unroll
  for (int c = threadIdx.x; c < CH; c += THREADS) {
    const int r = c >> 3, ch = c & 7;
    const bool ok = row0 + r < rows && k0 + ch * 16 < K;
    ct::cp_async16(tile + swz(r, ch),
                   ok ? src + (size_t)(row0 + r) * K + k0 + ch * 16 : src,
                   ok ? 16 : 0);
  }
}

// The k-loop over tiles [kt0, kt1): stage(st) holds the A tile at offset 0
// (this warpgroup's 64 rows at a_off) and the B tile at b_off. Tile kt's
// wgmmas are issued once it has landed for every thread; its loads go to
// the stage of tile kt - 2, which every warpgroup has waited on by then.
// Without PROMOTE (int8: exact) the whole K sums in the wgmma accumulator,
// the wgmmas in flight across the next barrier. With PROMOTE (fp8) each
// run of CHAIN k32 steps over a slice of N / SUB columns sums afresh in
// one of two partial accumulators and is added to acc in f32 while the
// next run is in flight.
template <int N, bool PROMOTE, int SUB, class Acc, class Load>
__device__ __forceinline__ void k_loop(Acc (&acc)[N / 2], unsigned char* smem,
                                       size_t stage_bytes, int a_off,
                                       int b_off, int kt0, int kt1,
                                       Load load_tile) {
  constexpr int NS = N / SUB, RUNS = STEPS / CHAIN * SUB;
  static_assert(!PROMOTE || N / 2 + NS <= 192, "acc and two partials fit");
  Acc part[PROMOTE ? 2 : 1][PROMOTE ? NS / 2 : 1];
#pragma unroll
  for (int i = 0; i < STAGES - 2; ++i) {
    if (kt0 + i < kt1) load_tile(smem + i * stage_bytes, kt0 + i);
    ct::cp_async_commit();
  }
  for (int kt = kt0, st = 0; kt < kt1; ++kt, st = st == STAGES - 1 ? 0 : st + 1) {
    ct::cp_async_wait<STAGES - 3>();  // tile kt has landed (this thread's copies)
    fence_async_smem();
    __syncthreads();                  // ... everyone's; tile kt - 2 retired
    if (kt + STAGES - 2 < kt1)
      load_tile(smem + (st + STAGES - 2) % STAGES * stage_bytes, kt + STAGES - 2);
    ct::cp_async_commit();
    const unsigned char* stage = smem + st * stage_bytes;
    if constexpr (PROMOTE) {
#pragma unroll
      for (int r = 0; r < RUNS; ++r) {
        const int h = r % SUB;
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < CHAIN; ++c) {
          const int s = r / SUB * CHAIN + c;
          wgmma8<NS>(part[r % 2], wgmma_desc(stage + a_off + 32 * s),
                     wgmma_desc(stage + b_off + h * NS * BK + 32 * s), c);
        }
        wgmma_commit();
        if (r > 0) {  // run r - 1 is done while run r is in flight
          wgmma_wait1();
          fence_regs(part[(r - 1) % 2]);
#pragma unroll
          for (int i = 0; i < NS / 2; ++i)
            acc[(r - 1) % SUB * NS / 2 + i] += part[(r - 1) % 2][i];
        }
      }
      wgmma_wait0();
      fence_regs(part[(RUNS - 1) % 2]);
#pragma unroll
      for (int i = 0; i < NS / 2; ++i)
        acc[(RUNS - 1) % SUB * NS / 2 + i] += part[(RUNS - 1) % 2][i];
    } else {
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < STEPS; ++s)
        wgmma8<N>(acc, wgmma_desc(stage + a_off + 32 * s),
                  wgmma_desc(stage + b_off + 32 * s), 1);
      wgmma_commit();
      wgmma_wait1();
    }
  }
  wgmma_wait0();
  fence_regs(acc);
  ct::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue's tile
}

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(int v) { return __int_as_float(v); }

// The epilogue over the cluster's (ROWS, COLS) partial tiles staged at red
// (row stride COLS + 4, int32 partials as their bits): block r of the
// cluster sums rows [r * per, (r + 1) * per) in rank order (int32 as
// integers), scales each sum by x_scale[row] * w_scale[col] in f32 and
// writes 8 bf16 a store.
template <class Acc, int ROWS, int COLS>
__device__ __forceinline__ void reduce_store(const float* red,
                                             __nv_bfloat16* __restrict__ y,
                                             const float* __restrict__ xs,
                                             const float* __restrict__ ws,
                                             int M, int N, int m0, int n0) {
  constexpr int RS = COLS + 4, CPR = COLS / 8;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = min(ROWS, M - m0), per = (rows + splits - 1) / splits;
  const int r0 = rank * per, r1 = min(rows, r0 + per);
  const bool vec = !(N & 7);
  for (int e = threadIdx.x; e < (r1 - r0) * CPR; e += THREADS) {
    const int r = r0 + e / CPR, c = (e % CPR) * 8, col = n0 + c;
    if (col >= N) continue;
    Acc sum[8] = {};
    for (int j = 0; j < splits; ++j) {
      const float* p = cluster.map_shared_rank(red, j) + r * RS + c;
      const float4 lo = *reinterpret_cast<const float4*>(p);
      const float4 hi = *reinterpret_cast<const float4*>(p + 4);
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if constexpr (std::is_same<Acc, int>::value)
          sum[i] += __float_as_int(v[i]);
        else
          sum[i] += v[i];
      }
    }
    const float sx = xs[m0 + r];
    __nv_bfloat16* dst = y + (size_t)(m0 + r) * N + col;
    if (vec) {  // N % 8 == 0: the 8 columns are in range
      const float4 s0 = *reinterpret_cast<const float4*>(ws + col);
      const float4 s1 = *reinterpret_cast<const float4*>(ws + col + 4);
      const float sw[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      uint4 o;
      uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ow[i] = ct::pack_bf16x2(static_cast<float>(sum[2 * i]) * sx * sw[2 * i],
                                static_cast<float>(sum[2 * i + 1]) * sx *
                                    sw[2 * i + 1]);
      *reinterpret_cast<uint4*>(dst) = o;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (col + i < N)
          dst[i] = __float2bfloat16(static_cast<float>(sum[i]) * sx * ws[col + i]);
    }
  }
  cluster.sync();  // no block leaves while another reads its tile
}

template <int BM>
struct DecodeCfg {
  static constexpr size_t STAGE = (size_t)(BW + BM) * BK;
  static constexpr size_t RING = STAGES * STAGE;
  static constexpr size_t RED = (size_t)BM * (BW + 4) * 4;
  static constexpr size_t SMEM = RING > RED ? RING : RED;
  static_assert(STAGE % 1024 == 0, "swizzled tiles 1024-byte aligned");
};

// decode rows: y^T = W . x^T, a block 128 weight rows (two warpgroups of 64)
// by BM batch rows, k-tiles [z * per, (z + 1) * per) of cluster rank z
template <bool FP8, int BM>
__global__ void __launch_bounds__(THREADS, 2)
w8a8_decode_kernel(const uint8_t* __restrict__ xq, const float* __restrict__ xs,
                   const uint8_t* __restrict__ w, const float* __restrict__ ws,
                   __nv_bfloat16* __restrict__ y, int M, int N, int K,
                   int tiles_per_split) {
  using Acc = typename std::conditional<FP8, float, int>::type;
  using C = DecodeCfg<BM>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2;
  const int n0 = blockIdx.x * BW;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, (K + BK - 1) / BK);

  Acc acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0;
  k_loop<BM, FP8, 1>(
      acc, smem, C::STAGE, wg * 64 * BK, BW * BK, kt0, kt1,
      [&](unsigned char* stage, int kt) {
        load_rows<BW>(stage, w, N, n0, K, kt * BK);
        load_rows<BM>(stage + BW * BK, xq, M, 0, K, kt * BK);
      });

  // element i: batch row 8 (i / 4) + 2 t + (i & 1), weight row wrow + 8
  // ((i >> 1) & 1)
  float* red = reinterpret_cast<float*>(smem);
  const int wrow = wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
  for (int i = 0; i < BM / 2; ++i)
    red[(8 * (i >> 2) + 2 * t + (i & 1)) * (BW + 4) + wrow + 8 * ((i >> 1) & 1)] =
        as_f32(acc[i]);
  reduce_store<Acc, BM, BW>(red, y, xs, ws, M, N, 0, n0);
}

struct PrefillCfg {
  static constexpr int BM = 128, BN = PBN;
  static constexpr size_t STAGE = (size_t)(BM + BN) * BK;
  static constexpr size_t RING = STAGES * STAGE;
  static constexpr size_t RED = (size_t)BM * (BN + 4) * 4;
  static constexpr size_t SMEM = RING > RED ? RING : RED;
  static_assert(SMEM <= 227 * 1024, "a block's shared memory");
};

// prefill rows: 128 x BN output tiles, warpgroup wg rows 64 wg .. + 63;
// grid (row tiles, column tiles, splits)
template <bool FP8>
__global__ void __launch_bounds__(THREADS, 1)
w8a8_prefill_kernel(const uint8_t* __restrict__ xq, const float* __restrict__ xs,
                    const uint8_t* __restrict__ w, const float* __restrict__ ws,
                    __nv_bfloat16* __restrict__ y, int M, int N, int K,
                    int tiles_per_split) {
  using Acc = typename std::conditional<FP8, float, int>::type;
  using C = PrefillCfg;
  constexpr int BN = C::BN;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * BN;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, (K + BK - 1) / BK);

  Acc acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  // fp8: partials of 64 columns, so two fit beside acc
  k_loop<BN, FP8, FP8 ? 4 : 1>(
      acc, smem, C::STAGE, wg * 64 * BK, C::BM * BK, kt0, kt1,
      [&](unsigned char* stage, int kt) {
        load_rows<C::BM>(stage, xq, M, m0, K, kt * BK);
        load_rows<BN>(stage + C::BM * BK, w, N, n0, K, kt * BK);
      });

  // element i: row 64 wg + 16 warp + g + 8 ((i >> 1) & 1), column 8 (i / 4)
  // + 2 t + (i & 1)
  float* red = reinterpret_cast<float*>(smem);
  const int row = wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2)
    *reinterpret_cast<float2*>(red + (row + 8 * ((i >> 1) & 1)) * (BN + 4) +
                               8 * (i >> 2) + 2 * t) =
        make_float2(as_f32(acc[i]), as_f32(acc[i + 1]));
  reduce_store<Acc, C::BM, BN>(red, y, xs, ws, M, N, m0, n0);
}

template <auto Kernel>
int launch_gemm(size_t smem, dim3 grid, cudaStream_t s, const void* xq,
                const void* xs, const void* w, const void* ws, void* y, int M,
                int N, int K, int per) {
  return ct::launch<Kernel>(smem, grid, THREADS, s,
                            static_cast<const uint8_t*>(xq),
                            static_cast<const float*>(xs),
                            static_cast<const uint8_t*>(w),
                            static_cast<const float*>(ws),
                            static_cast<__nv_bfloat16*>(y), M, N, K, per);
}

// bm 16, 32, 64 (decode rows, M <= bm) or 128 (prefill rows, 128 x PBN
// tiles); splits 1-8 blocks of a cluster, per k-tiles each
template <bool FP8>
int run_gemm(const void* xq, const void* xs, const void* w, const void* ws,
             void* y, int M, int N, int K, int bm, int splits, int per,
             cudaStream_t s) {
  if (K % 16 || splits < 1 || splits > 8 || (bm <= 64 && M > bm))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 decode((N + BW - 1) / BW, 1, splits);
  switch (bm) {
    case 16:
      return launch_gemm<&w8a8_decode_kernel<FP8, 16>>(
          DecodeCfg<16>::SMEM, decode, s, xq, xs, w, ws, y, M, N, K, per);
    case 32:
      return launch_gemm<&w8a8_decode_kernel<FP8, 32>>(
          DecodeCfg<32>::SMEM, decode, s, xq, xs, w, ws, y, M, N, K, per);
    case 64:
      return launch_gemm<&w8a8_decode_kernel<FP8, 64>>(
          DecodeCfg<64>::SMEM, decode, s, xq, xs, w, ws, y, M, N, K, per);
    case 128:
      return launch_gemm<&w8a8_prefill_kernel<FP8>>(
          PrefillCfg::SMEM, dim3((M + 127) / 128, (N + PBN - 1) / PBN, splits),
          s, xq, xs, w, ws, y, M, N, K, per);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool FP8>
int quantize(const void* x, void* xq, void* xs, int M, int K, cudaStream_t s) {
  if (K % 16) return static_cast<int>(cudaErrorInvalidValue);
  quantize_rows_kernel<FP8><<<M, QTHREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<uint8_t*>(xq),
      static_cast<float*>(xs), K);
  return static_cast<int>(cudaGetLastError());
}

template <bool FP8>
int matmul(const void* x, const void* w, const void* w_scale, void* y,
           void* xq, void* xs, int M, int N, int K, int bm, int splits,
           int per, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = quantize<FP8>(x, xq, xs, M, K, s);
  if (err) return err;
  return run_gemm<FP8>(xq, xs, w, w_scale, y, M, N, K, bm, splits, per, s);
}

}  // namespace

// x (M, K) bf16; w (N, K) int8; w_scale (N,) f32; y (M, N) bf16; xq (M, K)
// int8 and xs (M,) f32 scratch (they keep the quantized rows). K % 16 ==
// 0. The plan: bm 16, 32 or 64 (decode rows, M <= bm) or 128 (prefill
// rows), splits (1-8) blocks of a cluster sharing K, per 128-deep k-tiles
// each.
extern "C" int ct_w8a8_matmul(const void* x, const void* w, const void* w_scale,
                              void* y, void* xq, void* xs, int M, int N, int K,
                              int bm, int splits, int per, void* stream) {
  return matmul<false>(x, w, w_scale, y, xq, xs, M, N, K, bm, splits, per,
                       stream);
}

// The same with w (N, K) and the xq scratch in fp8 e4m3.
extern "C" int ct_w8a8_fp8_matmul(const void* x, const void* w,
                                  const void* w_scale, void* y, void* xq,
                                  void* xs, int M, int N, int K, int bm,
                                  int splits, int per, void* stream) {
  return matmul<true>(x, w, w_scale, y, xq, xs, M, N, K, bm, splits, per,
                      stream);
}

// The two passes on their own (timing): pass 1 of x into xq/xs, and pass 2
// from xq/xs; fp8 selects the type.
extern "C" int ct_w8a8_quantize(const void* x, void* xq, void* xs, int M, int K,
                                int fp8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp8 ? quantize<true>(x, xq, xs, M, K, s)
             : quantize<false>(x, xq, xs, M, K, s);
}

extern "C" int ct_w8a8_gemm(const void* xq, const void* xs, const void* w,
                            const void* w_scale, void* y, int M, int N, int K,
                            int fp8, int bm, int splits, int per,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp8 ? run_gemm<true>(xq, xs, w, w_scale, y, M, N, K, bm, splits, per, s)
             : run_gemm<false>(xq, xs, w, w_scale, y, M, N, K, bm, splits, per,
                               s);
}
