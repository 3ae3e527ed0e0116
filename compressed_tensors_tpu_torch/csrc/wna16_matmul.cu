// WnA16 matmuls for Hopper over weights that are not int4 words: y = x . W^T
// with W kept compressed, one templated kernel over the weight decode.
//
// ct_w4a16_fp4_matmul replaces mode "fp4" of the same TPU function
// (w4a16_matmul.py:332-362): NVFP4 / MXFP4 weights as the checkpoint's
// (N, K/2) uint8 E2M1 codes (low nibble = even column, so each output row
// is already K-major, the tensor cores' B operand) with (K/group, N) f32
// scales (e4m3 scale / global scale, or the E8M0 power of two), group 16 or
// 32. Hopper has no e2m1 convert (cvt ... e2m1x2 is sm_100+), so the decode
// builds each value's f32 bits from its code; the block then rounds
// code * scale to bf16, as the TPU kernel rounds its scaled tile to x's
// dtype, and one full-depth bf16 mma.sync chain accumulates in f32.
//
// ct_w4_e8_matmul replaces w4_e8_matmul (w4a16_matmul.py:442-533): (N, K)
// signed int8 q - zp with (K/group, N) f32 scales, group a multiple of 16.
// int8 -> bf16 is exact; each group's bf16 partial product (f32
// accumulate) is scaled by the group's f32 scale into the accumulator at
// the group's last 16-deep step, as the TPU body scales each group's dot.
//
// Both: 64x64 output tiles over 64-deep k-tiles with cp.async double
// buffering, K split over blocks when the tile grid leaves SMs idle (a
// split may cut a group: each split scales its part of the group's sum),
// ragged K (a multiple of 32 for fp4, 16 for int8) zero-filled, the output
// written once in bf16. Bound on the H100: at decode (M = 64) the weight
// bytes (K/2 or K per row plus the scales), at prefill the 2*M*N*K bf16
// tensor-core operations.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 64, THREADS = 128;
constexpr int XS = BK + 8;  // smem row stride (bf16): conflict-free fragments

// E2M1 code (sign in bit 3) -> f32, exact: magnitude code m >= 2 is
// 2^((m >> 1) - 1) * (1 + (m & 1) / 2); m = 1 is 0.5, m = 0 is 0.
__device__ __forceinline__ float e2m1_to_f32(uint32_t code) {
  const uint32_t m = code & 7u;
  const uint32_t bits = m >= 2u ? (((m >> 1) + 126u) << 23) | ((m & 1u) << 22)
                                : (m == 1u ? 126u << 23 : 0u);
  return __uint_as_float(bits | ((code & 8u) << 28));
}

// Weight decoders: one thread turns the raw bytes of columns [32h, 32h + 32)
// of one weight row's k-tile (in shared memory) into bf16 values.
struct Fp4Weights {
  static constexpr int kTileBytes = BK / 2;  // bytes per row per k-tile
  static constexpr bool kScaled = true;      // the scale is in the weight
  __device__ static void decode(const uint8_t* raw, __nv_bfloat16* dst, int h,
                                int k0, int n, int N, int K, int group,
                                const float* __restrict__ scales) {
    const uint4 v = *reinterpret_cast<const uint4*>(raw + h * 16);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // nibble e of word j is column 8j + e; 8 columns share a group
      const int col = k0 + h * 32 + j * 8;
      const float s = col < K ? scales[(size_t)(col / group) * N + n] : 0.f;
      __align__(16) __nv_bfloat16 out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        out[e] = __float2bfloat16(e2m1_to_f32((words[j] >> (4 * e)) & 0xFu) * s);
      *reinterpret_cast<uint4*>(dst + h * 32 + j * 8) =
          *reinterpret_cast<const uint4*>(out);
    }
  }
};

struct Int8Weights {
  static constexpr int kTileBytes = BK;
  static constexpr bool kScaled = false;     // group scales on the partials
  __device__ static void decode(const uint8_t* raw, __nv_bfloat16* dst, int h,
                                int, int, int, int, int, const float*) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint2 v = *reinterpret_cast<const uint2*>(raw + h * 32 + j * 8);
      __align__(16) __nv_bfloat16 out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t word = e < 4 ? v.x : v.y;
        const int8_t q = static_cast<int8_t>(static_cast<uint8_t>(word >> (8 * (e & 3))));
        out[e] = __float2bfloat16(static_cast<float>(q));
      }
      *reinterpret_cast<uint4*>(dst + h * 32 + j * 8) =
          *reinterpret_cast<const uint4*>(out);
    }
  }
};

template <class W>
__global__ void __launch_bounds__(THREADS)
wna16_kernel(const __nv_bfloat16* __restrict__ x,
             const uint8_t* __restrict__ w,
             const float* __restrict__ scales,  // (K/group, N)
             __nv_bfloat16* __restrict__ y, float* __restrict__ partial,
             int M, int N, int K, int group, int tiles_per_split) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][BM][XS];
  __shared__ __align__(16) uint8_t wr[2][BN][W::kTileBytes];
  __shared__ __align__(16) __nv_bfloat16 wd[BN][XS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2x2 warps of 32x32
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int row_bytes = K * W::kTileBytes / BK;  // K/2 (fp4) or K (int8)
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, (K + BK - 1) / BK);
  const int k_end = min(kt1 * BK, K);

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    // x: 64 rows x 8 chunks of 8 bf16; chunks past M or K are zero-filled
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      const int r = c >> 3, col = k0 + (c & 7) * 8;
      const bool ok = m0 + r < M && col < K;
      ct::cp_async16(&xs[stage][r][(c & 7) * 8],
                     x + (ok ? (size_t)(m0 + r) * K + col : 0), ok ? 16 : 0);
    }
    // weights: 64 rows x kTileBytes / 16 chunks of 16 bytes
    constexpr int kChunks = W::kTileBytes / 16;
    for (int c = tid; c < BN * kChunks; c += THREADS) {
      const int r = c / kChunks, q = c % kChunks;
      const int byte = kt * W::kTileBytes + q * 16;
      const bool ok = n0 + r < N && byte < row_bytes;
      ct::cp_async16(&wr[stage][r][q * 16],
                     w + (ok ? (size_t)(n0 + r) * row_bytes + byte : 0),
                     ok ? 16 : 0);
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
  float (&dot)[2][4][4] = W::kScaled ? acc : part;

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

    const int k0 = kt * BK;
    W::decode(&wr[stage][tid >> 1][0], &wd[tid >> 1][0], tid & 1, k0,
              min(n0 + (tid >> 1), N - 1), N, K, group, scales);
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int kk = k0 + ks * 16;
      if (kk >= k_end) break;
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
        for (int nt = 0; nt < 4; ++nt) ct::mma_bf16_16816(dot[mt][nt], a[mt], b[nt]);

      // a group's last step (or the split's): its partial times the scale
      if (!W::kScaled && ((kk + 16) % group == 0 || kk + 16 >= k_end)) {
        const int g = kk / group;
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

}  // namespace

template <class W>
static int launch_wna16(const void* x, const void* w, const void* scales, void* y,
                 void* partial, int M, int N, int K, int group, int splits,
                 int tiles_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  wna16_kernel<W><<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scales), static_cast<__nv_bfloat16*>(y),
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

// Mode fp4. x (M, K) bf16; codes (N, K/2) uint8; scales (K/group, N) f32;
// y (M, N) bf16; partial (splits, M, N) f32 scratch when splits > 1.
// K % 32 == 0, group % 16 == 0.
extern "C" int ct_w4a16_fp4_matmul(const void* x, const void* codes,
                                   const void* scales, void* y, void* partial,
                                   int M, int N, int K, int group, int splits,
                                   int tiles_per_split, void* stream) {
  return launch_wna16<Fp4Weights>(x, codes, scales, y, partial, M, N, K, group,
                                  splits, tiles_per_split, stream);
}

// Grouped int8. x (M, K) bf16; w (N, K) int8; scales (K/group, N) f32;
// y and partial as above. K % 16 == 0, group % 16 == 0.
extern "C" int ct_w4_e8_matmul(const void* x, const void* w, const void* scales,
                               void* y, void* partial, int M, int N, int K,
                               int group, int splits, int tiles_per_split,
                               void* stream) {
  return launch_wna16<Int8Weights>(x, w, scales, y, partial, M, N, K, group,
                                   splits, tiles_per_split, stream);
}
