// W4A16 group-quantized matmul for Hopper: y = x . W^T with W kept packed.
//
// Replaces compressed_tensors_tpu/ops/kernels/w4a16_matmul.py:w4a16_matmul
// (mode "int4b"). Weights stay in the checkpoint's pack-quantized words:
// (N, K/8) int32, nibble j of word w holding u = q + 8 of column 8w + j.
// Each 64x64 output tile walks K in 64-deep tiles: cp.async double-buffers
// the x tile (bf16) and the packed weight tile into shared memory, the
// block decodes the nibbles to exact small integers (u - 8 - zp) in bf16,
// and mma.sync m16n8k16 accumulates one quant group's partial product in
// f32. At each group boundary the partial is scaled by the group's f32
// scale into the output accumulator, so the weights are never rounded:
// the only bf16 values are x's. The output is written once in bf16.
//
// Bound on the H100: at decode (M = 64) the kernel is bound by the bytes of
// the packed weights (K*N/2); with M = 64 a grid of 64x64 tiles covers
// only N/64 blocks, so small-N calls split K across blocks (f32 partials,
// reduced by a second kernel) to bring more SMs to the weight stream. At
// prefill (M = B*S) it is bound by bf16 tensor-core operations.
//
// The second entry point, ct_w4a16_a8b_matmul, is the int8-activation mode
// "a8b" (see its note below). Mode "fp4" and w4_e8_matmul are in
// wna16_matmul.cu, the plane-layout modes int4 / a8 / mat in
// w4a16_planes.cu.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 64, THREADS = 128;
constexpr int XS = BK + 8;  // smem row stride (bf16): conflict-free fragments

__global__ void __launch_bounds__(THREADS)
w4a16_kernel(const __nv_bfloat16* __restrict__ x,
             const int32_t* __restrict__ w,
             const float* __restrict__ scales,  // (K/group, N)
             const float* __restrict__ zp,      // (K/group, N) or null
             __nv_bfloat16* __restrict__ y, float* __restrict__ partial,
             int M, int N, int K, int group, int tiles_per_split) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][BM][XS];
  __shared__ __align__(16) int32_t wp[2][BN][BK / 8];
  __shared__ __align__(16) __nv_bfloat16 wd[BN][XS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2x2 warps of 32x32
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kwords = K / 8;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, K / BK);
  const int tiles_per_group = group / BK;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    // x: 64 rows x 8 chunks of 16 bytes
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      const int r = c >> 3, c8 = c & 7;
      const int row = m0 + r;
      const __nv_bfloat16* src = x + (size_t)min(row, M - 1) * K + k0 + c8 * 8;
      ct::cp_async16(&xs[stage][r][c8 * 8], src, row < M ? 16 : 0);
    }
    // packed weights: 64 rows x 2 chunks of 4 words
    {
      const int r = tid >> 1, h = tid & 1;
      const int n = n0 + r;
      const int32_t* src = w + (size_t)min(n, N - 1) * kwords + k0 / 8 + h * 4;
      ct::cp_async16(&wp[stage][r][h * 4], src, n < N ? 16 : 0);
    }
    ct::cp_async_commit();
  };

  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.f;

  if (kt0 < kt1) load_tile(0, kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int stage = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      load_tile(stage ^ 1, kt + 1);
      ct::cp_async_wait<1>();
    } else {
      ct::cp_async_wait<0>();
    }
    __syncthreads();

    const int g = kt / tiles_per_group;
    // decode: each thread turns 4 words (32 nibbles) of one weight row
    // into exact integers q - zp = u - (8 + zp) in bf16
    {
      const int r = tid >> 1, h = tid & 1;
      const int n = min(n0 + r, N - 1);
      const float off = zp ? 8.f + zp[(size_t)g * N + n] : 8.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t word = static_cast<uint32_t>(wp[stage][r][h * 4 + j]);
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = __float2bfloat16(static_cast<float>((word >> (4 * e)) & 0xF) - off);
        *reinterpret_cast<uint4*>(&wd[r][(h * 4 + j) * 8]) =
            *reinterpret_cast<const uint4*>(v);
      }
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int c = ks * 16 + (lane & 3) * 2;
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + (lane >> 2);
        a[mt][0] = ct::ld_shared_u32(&xs[stage][r][c]);
        a[mt][1] = ct::ld_shared_u32(&xs[stage][r + 8][c]);
        a[mt][2] = ct::ld_shared_u32(&xs[stage][r][c + 8]);
        a[mt][3] = ct::ld_shared_u32(&xs[stage][r + 8][c + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn * 32 + nt * 8 + (lane >> 2);
        b[nt][0] = ct::ld_shared_u32(&wd[n][c]);
        b[nt][1] = ct::ld_shared_u32(&wd[n][c + 8]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) ct::mma_bf16_16816(part[mt][nt], a[mt], b[nt]);
    }

    // end of a quant group (groups never straddle a split): scale in f32
    if ((kt + 1) % tiles_per_group == 0 || kt + 1 == kt1) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;
        const float s0 = col < N ? scales[(size_t)g * N + col] : 0.f;
        const float s1 = col + 1 < N ? scales[(size_t)g * N + col + 1] : 0.f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          acc[mt][nt][0] += part[mt][nt][0] * s0;
          acc[mt][nt][1] += part[mt][nt][1] * s1;
          acc[mt][nt][2] += part[mt][nt][2] * s0;
          acc[mt][nt][3] += part[mt][nt][3] * s1;
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
        }
      }
    }
    __syncthreads();  // stage and wd are overwritten next iteration
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm * 32 + mt * 16 + (lane >> 2) + hh * 8;
        if (row >= M) continue;
        const float v0 = acc[mt][nt][hh * 2], v1 = acc[mt][nt][hh * 2 + 1];
        if (partial) {
          float* dst = partial + ((size_t)blockIdx.z * M + row) * N + col;
          if (col < N) dst[0] = v0;
          if (col + 1 < N) dst[1] = v1;
        } else {
          __nv_bfloat16* dst = y + (size_t)row * N + col;
          if (col < N) dst[0] = __float2bfloat16(v0);
          if (col + 1 < N) dst[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ---- mode a8b: int8 activations --------------------------------------- //
// Replaces the same TPU function's mode "a8b" (w4a16_matmul.py:579-590 and
// the kernel body :258-290). Pass 1 quantizes each row of x as the TPU
// kernel does (ct::quantize_rows_a8b_kernel, common.cuh). Pass 2 decodes
// the nibbles to exact int8 values q - zp = u - (8 + zp) in shared memory
// and runs mma.sync s8.s8 -> s32 over each quant group; at the group's end the
// exact integer sums are scaled by the group's f32 scale into an f32
// accumulator, the row's x scale is applied once, and y is written once in
// bf16. The TPU kernel dots the offset nibbles u and subtracts
// (8 + zp) * sum(x) afterwards; with exact integer group sums both give
// the same value up to f32 rounding.
//
// Bound on the H100: at prefill chunks (M = 512 rows and more) the
// 2*M*N*K int8 tensor-core operations.

constexpr int AS8 = BK + 16;  // int8 smem row stride (bytes)

__global__ void __launch_bounds__(THREADS)
w4a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
            const int32_t* __restrict__ w,
            const float* __restrict__ scales,  // (K/group, N)
            const float* __restrict__ zp,      // (K/group, N) or null
            __nv_bfloat16* __restrict__ y, int M, int N, int K, int group) {
  __shared__ __align__(16) int8_t as[2][BM][AS8];
  __shared__ __align__(16) int32_t wp[2][BN][BK / 8];
  __shared__ __align__(16) int8_t wd[BN][AS8];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2x2 warps of 32x32
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kwords = K / 8, ktiles = K / BK;
  const int tiles_per_group = group / BK;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    // x: 64 rows x 4 chunks of 16 int8
    for (int c = tid; c < BM * (BK / 16); c += THREADS) {
      const int r = c >> 2, c16 = c & 3;
      const int row = m0 + r;
      ct::cp_async16(&as[stage][r][c16 * 16],
                     xq + (size_t)min(row, M - 1) * K + k0 + c16 * 16,
                     row < M ? 16 : 0);
    }
    // packed weights: 64 rows x 2 chunks of 4 words
    {
      const int r = tid >> 1, h = tid & 1;
      const int n = n0 + r;
      const int32_t* src = w + (size_t)min(n, N - 1) * kwords + k0 / 8 + h * 4;
      ct::cp_async16(&wp[stage][r][h * 4], src, n < N ? 16 : 0);
    }
    ct::cp_async_commit();
  };

  float acc[2][4][4];
  int part[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        part[i][j][e] = 0;
      }

  load_tile(0, 0);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < ktiles) {
      load_tile(stage ^ 1, kt + 1);
      ct::cp_async_wait<1>();
    } else {
      ct::cp_async_wait<0>();
    }
    __syncthreads();

    const int g = kt / tiles_per_group;
    // decode: each thread turns 4 words of one weight row into 32 exact
    // int8 values u - (8 + zp), |value| <= 15
    {
      const int r = tid >> 1, h = tid & 1;
      const int n = min(n0 + r, N - 1);
      const int off = zp ? 8 + __float2int_rn(zp[(size_t)g * N + n]) : 8;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t word = static_cast<uint32_t>(wp[stage][r][h * 4 + j]);
        uint32_t lo = 0, hi = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lo |= (static_cast<uint32_t>(static_cast<int>((word >> (4 * e)) & 0xF) - off) & 0xFF) << (8 * e);
          hi |= (static_cast<uint32_t>(static_cast<int>((word >> (4 * e + 16)) & 0xF) - off) & 0xFF) << (8 * e);
        }
        *reinterpret_cast<uint2*>(&wd[r][(h * 4 + j) * 8]) = make_uint2(lo, hi);
      }
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      const int c = ks * 32 + (lane & 3) * 4;
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + (lane >> 2);
        a[mt][0] = ct::ld_shared_u32(&as[stage][r][c]);
        a[mt][1] = ct::ld_shared_u32(&as[stage][r + 8][c]);
        a[mt][2] = ct::ld_shared_u32(&as[stage][r][c + 16]);
        a[mt][3] = ct::ld_shared_u32(&as[stage][r + 8][c + 16]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn * 32 + nt * 8 + (lane >> 2);
        b[nt][0] = ct::ld_shared_u32(&wd[n][c]);
        b[nt][1] = ct::ld_shared_u32(&wd[n][c + 16]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) ct::mma_s8_16832(part[mt][nt], a[mt], b[nt]);
    }

    // end of a quant group: its exact integer sums times the f32 scale
    if ((kt + 1) % tiles_per_group == 0) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;
        const float s0 = col < N ? scales[(size_t)g * N + col] : 0.f;
        const float s1 = col + 1 < N ? scales[(size_t)g * N + col + 1] : 0.f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          acc[mt][nt][0] += static_cast<float>(part[mt][nt][0]) * s0;
          acc[mt][nt][1] += static_cast<float>(part[mt][nt][1]) * s1;
          acc[mt][nt][2] += static_cast<float>(part[mt][nt][2]) * s0;
          acc[mt][nt][3] += static_cast<float>(part[mt][nt][3]) * s1;
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0;
        }
      }
    }
    __syncthreads();  // stage and wd are overwritten next iteration
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wm * 32 + mt * 16 + (lane >> 2) + hh * 8;
      if (row >= M) continue;
      const float sx = xs[row];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;
        __nv_bfloat16* dst = y + (size_t)row * N + col;
        if (col < N) dst[0] = __float2bfloat16(acc[mt][nt][hh * 2] * sx);
        if (col + 1 < N) dst[1] = __float2bfloat16(acc[mt][nt][hh * 2 + 1] * sx);
      }
    }
  }
}

}  // namespace

// x (M, K) bf16; w (N, K/8) int32; scales/zp (K/group, N) f32 (zp may be
// null); y (M, N) bf16; partial (splits, M, N) f32 scratch when splits > 1.
// K % 64 == 0 and group % 64 == 0; tiles_per_split is a multiple of
// group / 64 so that no quant group straddles two splits.
extern "C" int ct_w4a16_matmul(const void* x, const void* w, const void* scales,
                               const void* zp, void* y, void* partial, int M,
                               int N, int K, int group, int splits,
                               int tiles_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  w4a16_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(w),
      static_cast<const float*>(scales), static_cast<const float*>(zp),
      static_cast<__nv_bfloat16*>(y),
      splits > 1 ? static_cast<float*>(partial) : nullptr, M, N, K, group,
      tiles_per_split);
  if (splits > 1) {
    const size_t count = (size_t)M * N;
    ct::splitk_reduce_kernel<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(y),
        splits, count);
  }
  return static_cast<int>(cudaGetLastError());
}

// Mode a8b. x (M, K) bf16; w (N, K/8) int32; scales/zp (K/group, N) f32
// (zp may be null); y (M, N) bf16; xq (M, K) int8 and xs (M,) f32 scratch.
// K % 64 == 0 and group % 64 == 0.
extern "C" int ct_w4a16_a8b_matmul(const void* x, const void* w,
                                   const void* scales, const void* zp, void* y,
                                   void* xq, void* xs, int M, int N, int K,
                                   int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ct::quantize_rows_a8b_kernel<<<M, 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(xs), K);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  w4a8_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int32_t*>(w), static_cast<const float*>(scales),
      static_cast<const float*>(zp), static_cast<__nv_bfloat16*>(y), M, N, K,
      group);
  return static_cast<int>(cudaGetLastError());
}
