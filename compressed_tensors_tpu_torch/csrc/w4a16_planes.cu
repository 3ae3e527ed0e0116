// W4A16 matmul on the int32 8-plane layout for Hopper: y = x . W^T in the
// modes "int4", "a8" and "mat" (w4_layout="packed").
//
// Replaces compressed_tensors_tpu/ops/kernels/w4a16_matmul.py:w4a16_matmul
// (:541, pallas_call :675) in modes "int4" (kernel body :401-437), "a8"
// (:295-330) and "mat" (:364-399), on the layout that
// repack_w4_for_kernel (:99-110) and retile_groups (:88-95) build:
// (K_pad/8, N) int32 words, K_pad a multiple of the k-tile TK = 8 * g,
// word (t*g + r, n) holding in nibble plane j the offset code u = q + 8 of
// k-position t*8g + j*g + r; scales and zero points (K_pad/g, N) f32. Each
// plane of a k-tile is one quant group, and consecutive N columns are
// consecutive words, so a block's (g x 64) word tile is one coalesced read.
//
// Design (simple and correct first). One block per 64x64 output tile and
// K split; for each of its k-tiles the word tile is staged once in shared
// memory with cp.async, and the block walks the 8 planes. For plane j it
// stages x's g columns of group t*8 + j (double-buffered: the next plane's
// columns load while this one computes), decodes plane j of the word tile
// into a (64 x g) operand tile, and runs mma.sync over it:
//   int4: bf16 u (exact), m16n8k16, one f32 fragment for the group, then
//         scaled by s_j into the f32 accumulator;
//   a8:   int8 u in [0, 15], s8 m16n8k32 on the int8 rows of x (quantized
//         by ct::quantize_rows_a8b_kernel, B2's pass), exact int32 group
//         sums scaled by s_j; the row's x scale multiplies the result once;
//   mat:  bf16(u * s_j), the TPU kernel's scaled tile (it rounds u*s, not
//         (u - 8 - zp)*s), accumulated straight into the f32 accumulator.
// The affine offset is the TPU kernel's rank-8 correction
// sum(x_j) * (8 + zp_j) * s_j, with sum(x_j) the row sums of the staged x
// columns (int8 sums in a8); it is subtracted at the end of each plane, the
// same terms the TPU kernel subtracts per k-tile, in another f32 order.
// K_orig != K_pad (Qwen2.5: 3584 -> 4096, 18944 -> 19456) is masked: x is
// read with its own row stride K_orig, and columns at or past K_orig are
// zero-filled by cp.async; the padded groups' codes (8) meet scale 0.
// At decode rows (M = 64) the (M, N) tile grid can leave most SMs idle
// (N = 3584: 56 blocks), so K is split over up to 4 blocks at k-tile
// boundaries, as in the int4b kernel (f32 partials, ct::splitk_reduce_kernel).
//
// Bound on the H100: at decode rows the checkpoint bytes (N*K/2 of codes,
// bf16 group scales, 4-bit zero points) over 3.35 TB/s; at prefill rows
// (M = 512) the 2*M*N*K operations at the bf16 (int4, mat) or int8 (a8)
// tensor-core peak.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, THREADS = 128, PLANES = 8;
constexpr int WS = BN + 4;  // word tile row stride (int32)
constexpr int MAX_GROUP = 128;

enum Mode { kInt4 = 0, kA8 = 1, kMat = 2 };

// operand element, mma depth and shared row padding by mode
template <int MODE> struct Op {
  using T = __nv_bfloat16;
  using Part = float;
  static constexpr int KS = 16, PAD = 8;
};
template <> struct Op<kA8> {
  using T = int8_t;
  using Part = int;
  static constexpr int KS = 32, PAD = 16;
};

// bytes of dynamic shared memory: the word tile, two x chunks, the decoded
// plane and the row sums
template <int MODE>
size_t smem_bytes(int g) {
  const size_t row = (size_t)(g + Op<MODE>::PAD) * sizeof(typename Op<MODE>::T);
  return (size_t)g * WS * 4 + 3 * BM * row + BM * sizeof(float);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
planes_kernel(const void* __restrict__ xv,        // (M, Kx) bf16 or int8 (a8)
              const float* __restrict__ xscale,   // (M,) row scales (a8)
              const int32_t* __restrict__ words,  // (K/8, N)
              const float* __restrict__ scales,   // (K/g, N)
              const float* __restrict__ zp,       // (K/g, N) or null
              __nv_bfloat16* __restrict__ y, float* __restrict__ partial,
              int M, int N, int Kx, int K, int g, int tiles_per_split) {
  using T = typename Op<MODE>::T;
  using P = typename Op<MODE>::Part;
  constexpr int KS = Op<MODE>::KS;
  constexpr int XCH = 16 / sizeof(T);   // elements per 16-byte chunk
  constexpr int EPW = 4 / sizeof(T);    // elements per 32-bit register
  const int RS = g + Op<MODE>::PAD;     // x / plane tile row stride

  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* wt = reinterpret_cast<int32_t*>(smem);               // [g][WS]
  T* xs = reinterpret_cast<T*>(smem + (size_t)g * WS * 4);      // [2][BM][RS]
  T* wd = xs + 2 * BM * RS;                                     // [BN][RS]
  float* sx = reinterpret_cast<float*>(wd + BN * RS);           // [BM]
  const T* x = static_cast<const T*>(xv);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2x2 warps of 32x32
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tk = PLANES * g;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, K / tk);
  const int steps = max(kt1 - kt0, 0) * PLANES;  // one step per plane

  // x columns of step s's group (k-tile kt0 + s / 8, plane s % 8)
  auto load_x = [&](int buf, int s) {
    const int kc = (kt0 + s / PLANES) * tk + (s % PLANES) * g;
    const int per_row = g / XCH;
    for (int c = tid; c < BM * per_row; c += THREADS) {
      const int r = c / per_row, col = kc + (c % per_row) * XCH;
      const bool ok = m0 + r < M && col < Kx;
      ct::cp_async16(xs + ((size_t)buf * BM + r) * RS + (c % per_row) * XCH,
                     x + (ok ? (size_t)(m0 + r) * Kx + col : 0), ok ? 16 : 0);
    }
  };
  // the (g x 64) word tile of k-tile t
  auto load_words = [&](int t) {
    for (int c = tid; c < g * (BN / 4); c += THREADS) {
      const int r = c / (BN / 4), q = c % (BN / 4);
      const bool ok = n0 + q * 4 < N;
      ct::cp_async16(wt + r * WS + q * 4,
                     words + (ok ? (size_t)(t * g + r) * N + n0 + q * 4 : 0),
                     ok ? 16 : 0);
    }
  };

  float acc[2][4][4];
  P part[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        part[i][j][e] = 0;
      }

  if (steps > 0) {
    load_words(kt0);
    load_x(0, 0);
  }
  ct::cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1, t = kt0 + s / PLANES, j = s % PLANES;
    if (s + 1 < steps) load_x(buf ^ 1, s + 1);
    ct::cp_async_commit();
    ct::cp_async_wait<1>();  // this step's x (and word tile) have landed
    __syncthreads();

    const int grp = t * PLANES + j;
    const T* xb = xs + (size_t)buf * BM * RS;
    // decode plane j: thread -> column n, segments of 16 bytes of rows
    {
      constexpr int SEG = XCH;
      const int n = tid & (BN - 1);
      float s_mat = 0.f;
      if constexpr (MODE == kMat)
        s_mat = n0 + n < N ? scales[(size_t)grp * N + n0 + n] : 0.f;
      for (int seg = tid / BN; seg < g / SEG; seg += THREADS / BN) {
        const int r0 = seg * SEG;
        __align__(16) T v[SEG];
#pragma unroll
        for (int i = 0; i < SEG; ++i) {
          const uint32_t u =
              (static_cast<uint32_t>(wt[(r0 + i) * WS + n]) >> (4 * j)) & 0xFu;
          if constexpr (MODE == kA8)
            v[i] = static_cast<int8_t>(u);
          else if constexpr (MODE == kMat)
            v[i] = __float2bfloat16(static_cast<float>(u) * s_mat);
          else
            v[i] = __float2bfloat16(static_cast<float>(u));
        }
        *reinterpret_cast<uint4*>(wd + (size_t)n * RS + r0) =
            *reinterpret_cast<const uint4*>(v);
      }
    }
    // row sums of the group's x columns (two threads per row)
    {
      const int r = tid >> 1, h = tid & 1;
      const T* xr = xb + (size_t)r * RS + h * (g / 2);
      float sum;
      if constexpr (MODE == kA8) {
        int isum = 0;
        for (int c = 0; c < g / 2; ++c) isum += xr[c];
        isum += __shfl_xor_sync(0xffffffffu, isum, 1);
        sum = static_cast<float>(isum);
      } else {
        sum = 0.f;
        for (int c = 0; c < g / 2; ++c) sum += __bfloat162float(xr[c]);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      }
      if (h == 0) sx[r] = sum;
    }
    __syncthreads();
    // the word tile is read: fetch the next k-tile's behind this plane's dots
    if (j == PLANES - 1 && t + 1 < kt1) {
      load_words(t + 1);
      ct::cp_async_commit();
    }

    for (int kk = 0; kk < g; kk += KS) {
      const int c = kk + (lane & 3) * EPW;
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const T* xr = xb + (size_t)(wm * 32 + mt * 16 + (lane >> 2)) * RS;
        a[mt][0] = ct::ld_shared_u32(xr + c);
        a[mt][1] = ct::ld_shared_u32(xr + 8 * RS + c);
        a[mt][2] = ct::ld_shared_u32(xr + c + KS / 2);
        a[mt][3] = ct::ld_shared_u32(xr + 8 * RS + c + KS / 2);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const T* wr = wd + (size_t)(wn * 32 + nt * 8 + (lane >> 2)) * RS;
        b[nt][0] = ct::ld_shared_u32(wr + c);
        b[nt][1] = ct::ld_shared_u32(wr + c + KS / 2);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if constexpr (MODE == kA8)
            ct::mma_s8_16832(part[mt][nt], a[mt], b[nt]);
          else if constexpr (MODE == kMat)
            ct::mma_bf16_16816(acc[mt][nt], a[mt], b[nt]);
          else
            ct::mma_bf16_16816(part[mt][nt], a[mt], b[nt]);
        }
    }

    // end of the group: its partial times s_j (int4, a8), minus the
    // offset correction sum(x_j) * (8 + zp_j) * s_j
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;
      float sc[2], off[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = col + e < N;
        const size_t at = (size_t)grp * N + col + e;
        sc[e] = ok ? scales[at] : 0.f;
        off[e] = (8.f + (zp && ok ? zp[at] : 0.f)) * sc[e];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + (lane >> 2);
        const float x0 = sx[r], x1 = sx[r + 8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float o = (e & 1 ? off[1] : off[0]) * (e < 2 ? x0 : x1);
          if constexpr (MODE == kMat) {
            acc[mt][nt][e] -= o;
          } else {
            acc[mt][nt][e] += static_cast<float>(part[mt][nt][e]) * sc[e & 1] - o;
            part[mt][nt][e] = 0;
          }
        }
      }
    }
    __syncthreads();  // xs[buf], wd and sx are overwritten next step
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wm * 32 + mt * 16 + (lane >> 2) + hh * 8;
      if (row >= M) continue;
      const float rs = MODE == kA8 ? xscale[row] : 1.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;
        const float v0 = acc[mt][nt][hh * 2] * rs;
        const float v1 = acc[mt][nt][hh * 2 + 1] * rs;
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

template <int MODE>
int launch_planes(const void* x, const void* xscale, const void* w,
                  const void* scales, const void* zp, void* y, void* partial,
                  int M, int N, int Kx, int K, int g, int splits,
                  int tiles_per_split, cudaStream_t s) {
  if (g % 32 || g > MAX_GROUP) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;  // the largest group's need, set once
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        planes_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<MODE>(MAX_GROUP)));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  planes_kernel<MODE><<<grid, THREADS, smem_bytes<MODE>(g), s>>>(
      x, static_cast<const float*>(xscale), static_cast<const int32_t*>(w),
      static_cast<const float*>(scales), static_cast<const float*>(zp),
      static_cast<__nv_bfloat16*>(y),
      splits > 1 ? static_cast<float*>(partial) : nullptr, M, N, Kx, K, g,
      tiles_per_split);
  if (splits > 1) {
    const size_t count = (size_t)M * N;
    ct::splitk_reduce_kernel<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(y),
        splits, count);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Modes int4 and mat. x (M, Kx) bf16 with Kx <= K and Kx % 16 == 0; words
// (K/8, N) int32 with K a multiple of 8 * g; scales and zp (K/g, N) f32 (zp
// may be null); y (M, N) bf16; partial (splits, M, N) f32 scratch when
// splits > 1; tiles_per_split counts k-tiles of 8 * g. g % 32 == 0, g <= 128,
// N % 4 == 0.
extern "C" int ct_w4a16_planes_int4(const void* x, const void* w,
                                    const void* scales, const void* zp, void* y,
                                    void* partial, int M, int N, int Kx, int K,
                                    int g, int splits, int tiles_per_split,
                                    void* stream) {
  return launch_planes<kInt4>(x, nullptr, w, scales, zp, y, partial, M, N, Kx,
                              K, g, splits, tiles_per_split,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int ct_w4a16_planes_mat(const void* x, const void* w,
                                   const void* scales, const void* zp, void* y,
                                   void* partial, int M, int N, int Kx, int K,
                                   int g, int splits, int tiles_per_split,
                                   void* stream) {
  return launch_planes<kMat>(x, nullptr, w, scales, zp, y, partial, M, N, Kx,
                             K, g, splits, tiles_per_split,
                             static_cast<cudaStream_t>(stream));
}

// Mode a8: as above, plus xq (M, Kx) int8 and xs (M,) f32 scratch for the
// quantized rows and their scales.
extern "C" int ct_w4a16_planes_a8(const void* x, const void* w,
                                  const void* scales, const void* zp, void* y,
                                  void* partial, void* xq, void* xs, int M,
                                  int N, int Kx, int K, int g, int splits,
                                  int tiles_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ct::quantize_rows_a8b_kernel<<<M, 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(xs), Kx);
  return launch_planes<kA8>(xq, xs, w, scales, zp, y, partial, M, N, Kx, K, g,
                            splits, tiles_per_split, s);
}
