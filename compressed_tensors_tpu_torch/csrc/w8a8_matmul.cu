// W8A8 matmul for Hopper with dynamic per-token activation quantization,
// int8 or fp8 e4m3.
//
// Replaces compressed_tensors_tpu/ops/kernels/w8a8_matmul.py:w8a8_matmul.
// Pass 1 quantizes each row of x exactly as the TPU kernel does:
//   int8: scale = max(absmax / 127.5, 1e-10), q = rint(clip(x / scale,
//         -128, 127)) (round half to even);
//   fp8:  scale = max(absmax / 448, 1e-10), q = e4m3(clip(x / scale, -448,
//         448)) (round to nearest even),
// with IEEE division, keeping the per-row scale. Pass 2 is a GEMM on the
// tensor cores over the checkpoint's (N, K) weight rows, K-major, which is
// already the B operand of mma.sync m16n8k32: int8 x int8 with exact int32
// sums, or e4m3 x e4m3 (the sm_89+ instruction, which assembles for
// sm_90a) with f32 sums. The epilogue acc * x_scale * w_scale is written
// once in bf16. Both types share the 64x64x64 tiling, double-buffered with
// cp.async; only the mma instruction and the accumulator type differ.
//
// Bound on the H100: at decode (M = 64) the N*K weight bytes; at a
// 512-row prefill chunk the int8/fp8 tensor-core operations (1979
// TOP/s), which mma.sync at this tiling reaches only a fraction of.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 64, THREADS = 128;
constexpr int AS = BK + 16;  // smem row stride (bytes): conflict-free fragments

template <bool FP8>
__global__ void quantize_rows_kernel(const __nv_bfloat16* __restrict__ x,
                                     uint8_t* __restrict__ xq,
                                     float* __restrict__ xs, int K) {
  const int row = blockIdx.x;
  const __nv_bfloat16* xr = x + (size_t)row * K;
  float amax = 0.f;
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    amax = fmaxf(amax, fabsf(__bfloat162float(xr[i])));
  __shared__ float red[32];
  amax = ct::warp_max(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : 0.f;
    v = ct::warp_max(v);
    if (threadIdx.x == 0) red[0] = v;
  }
  __syncthreads();
  const float scale = fmaxf(red[0] / (FP8 ? 448.f : 127.5f), 1e-10f);
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const float v = __bfloat162float(xr[i]) / scale;
    uint8_t q;
    if (FP8)
      q = ct::f32_to_e4m3(fminf(fmaxf(v, -448.f), 448.f));
    else
      q = static_cast<uint8_t>(static_cast<int8_t>(
          rintf(fminf(fmaxf(v, -128.f), 127.f))));
    xq[(size_t)row * K + i] = q;
  }
  if (threadIdx.x == 0) xs[row] = scale;
}

template <bool FP8>
__global__ void __launch_bounds__(THREADS)
w8a8_gemm_kernel(const uint8_t* __restrict__ xq, const float* __restrict__ xs,
                 const uint8_t* __restrict__ w, const float* __restrict__ ws,
                 __nv_bfloat16* __restrict__ y, int M, int N, int K) {
  using Acc = typename std::conditional<FP8, float, int>::type;
  __shared__ __align__(16) uint8_t as[2][BM][AS];
  __shared__ __align__(16) uint8_t bs[2][BN][AS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = K / BK;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    for (int c = tid; c < BM * (BK / 16); c += THREADS) {
      const int r = c >> 2, c16 = c & 3;
      const int row = m0 + r;
      ct::cp_async16(&as[stage][r][c16 * 16],
                     xq + (size_t)min(row, M - 1) * K + k0 + c16 * 16,
                     row < M ? 16 : 0);
      const int n = n0 + r;
      ct::cp_async16(&bs[stage][r][c16 * 16],
                     w + (size_t)min(n, N - 1) * K + k0 + c16 * 16,
                     n < N ? 16 : 0);
    }
    ct::cp_async_commit();
  };

  Acc acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

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
        b[nt][0] = ct::ld_shared_u32(&bs[stage][n][c]);
        b[nt][1] = ct::ld_shared_u32(&bs[stage][n][c + 16]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if constexpr (FP8)
            ct::mma_e4m3_16832(acc[mt][nt], a[mt], b[nt]);
          else
            ct::mma_s8_16832(acc[mt][nt], a[mt], b[nt]);
        }
    }
    __syncthreads();
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
        if (col < N)
          dst[0] = __float2bfloat16(static_cast<float>(acc[mt][nt][hh * 2]) * sx * ws[col]);
        if (col + 1 < N)
          dst[1] = __float2bfloat16(static_cast<float>(acc[mt][nt][hh * 2 + 1]) * sx * ws[col + 1]);
      }
    }
  }
}

template <bool FP8>
int launch(const void* x, const void* w, const void* w_scale, void* y, void* xq,
           void* xs, int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  quantize_rows_kernel<FP8><<<M, 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<uint8_t*>(xq),
      static_cast<float*>(xs), K);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  w8a8_gemm_kernel<FP8><<<grid, THREADS, 0, s>>>(
      static_cast<const uint8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(w), static_cast<const float*>(w_scale),
      static_cast<__nv_bfloat16*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) bf16; w (N, K) int8; w_scale (N,) f32; y (M, N) bf16;
// xq (M, K) int8 and xs (M,) f32 scratch. K % 64 == 0.
extern "C" int ct_w8a8_matmul(const void* x, const void* w, const void* w_scale,
                              void* y, void* xq, void* xs, int M, int N, int K,
                              void* stream) {
  return launch<false>(x, w, w_scale, y, xq, xs, M, N, K, stream);
}

// The same with w (N, K) and the xq scratch in fp8 e4m3.
extern "C" int ct_w8a8_fp8_matmul(const void* x, const void* w,
                                  const void* w_scale, void* y, void* xq,
                                  void* xs, int M, int N, int K, void* stream) {
  return launch<true>(x, w, w_scale, y, xq, xs, M, N, K, stream);
}
