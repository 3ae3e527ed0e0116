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
// plane of a k-tile is one quant group.
//
// Design. One block of 8 warps (2 x 4, warp tiles of BM/2 x 32) per BM x
// 128 output tile (BM = 128 above 64 rows, 64 at decode rows) and K split.
// Each k-tile's (g x 128) word tile is staged once in shared memory by
// 16-byte cp.async, a quarter of its rows at each of the previous k-tile's
// first four steps, so that the weight stream spreads evenly behind the
// math. A step is one plane, i.e. one quant group: x's g columns of the
// group are staged by cp.async two steps ahead at decode rows (three
// buffers), one step ahead at 128 rows (two: shared memory is full), and
// each step costs one barrier. At a k-tile's first step each row pair
// (2p, 2p + 1) of the word tile is rewritten in place as the pair's low
// halves (planes 0-3) and high halves (planes 4-7), so a lane reads 4
// bytes per two k rows and plane. x's A fragments come in by ldmatrix;
// each lane reads the 2 (4 in a8) pair words of its B column and k rows
// with 32-bit ld.shared (row stride = 4 mod 32 words, the upper 8 rows of
// each 16 XOR-swizzled by 8 columns: conflict-free) and decodes the plane
// in registers straight into the B fragment, never through shared memory:
//   int4: the offset folds into the decode: u - (8 + zp) is an integer in
//         [-15, 15], exact in bf16, built as bf16 (128 + u) - (136 + zp)
//         from the bits 0x4300 | u (a shift, a mask and a bf16 subtract
//         per pair); m16n8k16 into one f32 fragment per group, scaled by
//         s_j into the f32 accumulator. This is B1's arithmetic: no row
//         sums and no rank-8 correction. At 128 rows the warp's four n8
//         tiles go in two passes per group (fewer live partials: no spill).
//   a8:   the same fold in int8 (bytewise ((u | 0x80) - (8 + zp)) ^ 0x80),
//         s8 m16n8k32 on the rows of x quantized by
//         ct::quantize_rows_a8b_kernel; exact int32 group sums times s_j,
//         the row's x scale once at the end.
//   mat:  the TPU kernel's scaled tile bf16(u * s_j) (u * s_j exactly
//         rounded, as one fma of 2^23 + u), accumulated straight into f32,
//         minus its correction sum(x_j) * (8 + zp_j) * s_j; the row sums
//         sum(x_j) come from one more mma per row tile against a B fragment
//         of ones (x summed in f32 on the tensor cores).
// Zero points must be integers (every checkpoint's are). Groups at or
// past K_orig (Qwen2.5: 3584 -> 4096, 18944 -> 19456) hold code 8 and scale
// 0 and meet x's zero fill: their plane steps are skipped. x is read with
// its own row stride K_orig and zero-filled by cp.async past it. At decode
// rows K is split over blocks at k-tile boundaries (f32 partials,
// ct::splitk_reduce_kernel).
//
// Bound on the H100: at decode rows the checkpoint bytes (N*K/2 of codes,
// bf16 group scales, 4-bit zero points) over 3.35 TB/s; at prefill rows
// (M = 512) the 2*M*N*K operations at the bf16 (int4, mat) or int8 (a8)
// tensor-core peak. Shared memory (two word tiles, x, scales) leaves one
// block an SM.
#include "common.cuh"

namespace {

constexpr int BN = 128, PLANES = 8;
constexpr int WARPS_N = 4, WN = BN / WARPS_N, NT = WN / 8;  // 4 n8 tiles
constexpr int WSW = BN + 4;  // word tile row stride (words), = 4 mod 32

enum Mode { kInt4 = 0, kA8 = 1, kMat = 2 };

// x element, mma depth and x row padding (row bytes = 16 mod 128: the
// ldmatrix rows fall in distinct banks) by mode
template <int MODE> struct Op {
  using T = __nv_bfloat16;
  static constexpr int KS = 16, PAD = 8;
};
template <> struct Op<kA8> {
  using T = int8_t;
  static constexpr int KS = 32, PAD = 16;
};

template <int MODE, int BM, int G>
struct Cfg {
  using T = typename Op<MODE>::T;
  static constexpr int XRS = G + Op<MODE>::PAD;          // x row stride
  static constexpr int XST = BM == 64 ? 3 : 2;           // x buffers
  static constexpr size_t WORDS = (size_t)G * WSW * 4;   // one word tile
  static constexpr size_t XBUF = (size_t)BM * XRS * sizeof(T);
  static constexpr size_t SCALES = (size_t)PLANES * BN * 4;
  static constexpr size_t SMEM = 2 * WORDS + XST * XBUF + 2 * 2 * SCALES;
};

// column of word (r, n) in the word tile: rows 8-15 of every 16 are
// shifted by 8 columns (whole 16-byte chunks), which spreads the a8 reads
// of rows 4t + i and 4t + 16 + i over distinct banks
__device__ __forceinline__ int wcol(int r, int n) { return n ^ (r & 8); }

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bsub2(uint32_t a, uint32_t b) {
  return bf16x2_bits(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                             *reinterpret_cast<const __nv_bfloat162*>(&b)));
}

// bf16(u * s) for u = (w >> sh) & 15: the fma (2^23 + u) * s - 2^23 * s is
// u * s rounded once to f32, as the plain version computes it
__device__ __forceinline__ float u_times(uint32_t w, int sh, float s, float c) {
  return __fmaf_rn(__uint_as_float(((w >> sh) & 0xFu) | 0x4B000000u), s, c);
}

template <int MODE, int BM, int G, int NH>
__global__ void __launch_bounds__(256, 1)
planes_kernel(const void* __restrict__ xv,        // (M, Kx) bf16 or int8 (a8)
              const float* __restrict__ xscale,   // (M,) row scales (a8)
              const int32_t* __restrict__ words,  // (K/8, N)
              const float* __restrict__ scales,   // (K/g, N)
              const float* __restrict__ zp,       // (K/g, N) or null
              __nv_bfloat16* __restrict__ y, float* __restrict__ partial,
              int M, int N, int Kx, int K, int tiles_per_split) {
  using C = Cfg<MODE, BM, G>;
  using T = typename C::T;
  using Part = typename std::conditional<MODE == kA8, int, float>::type;
  constexpr int KS = Op<MODE>::KS, XRS = C::XRS, XST = C::XST;
  constexpr int XCH = 16 / sizeof(T);  // x elements per 16-byte chunk
  constexpr int NTHR = 256;            // 2 x 4 warps
  constexpr int WROWS = BM / 2;        // rows per warp
  constexpr int MT = WROWS / 16;       // m16 tiles per warp
  constexpr int NTH = NT / NH;         // n8 tiles per pass
  constexpr int L = XST - 1;           // steps of x lookahead
  constexpr int TK = PLANES * G;

  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* wt = reinterpret_cast<uint32_t*>(smem);          // [2][G][WSW]
  T* xs = reinterpret_cast<T*>(smem + 2 * C::WORDS);         // [XST][BM][XRS]
  float* ss = reinterpret_cast<float*>(smem + 2 * C::WORDS + XST * C::XBUF);
  float* zs = ss + 2 * PLANES * BN;                          // [2][8][BN] each
  const T* x = static_cast<const T*>(xv);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int qr = lane >> 2, qt = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int live_groups = (Kx + G - 1) / G;  // later groups are padding
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(min(kt0 + tiles_per_split, K / TK),
                      (live_groups + PLANES - 1) / PLANES);
  // one step per live plane; only the last k-tile of K has fewer than 8
  const int steps = kt1 > kt0
      ? (kt1 - 1 - kt0) * PLANES + min(PLANES, live_groups - (kt1 - 1) * PLANES)
      : 0;

  // rows [r0, r1) of k-tile t's word tile into stage st
  auto load_words = [&](int st, int t, int r0, int r1) {
    uint32_t* dst = wt + (size_t)st * G * WSW;
    for (int c = tid; c < (r1 - r0) * (BN / 4); c += NTHR) {
      const int r = r0 + c / (BN / 4), q = (c % (BN / 4)) * 4;
      const bool ok = n0 + q < N;
      ct::cp_async16(dst + r * WSW + wcol(r, q),
                     words + (ok ? (size_t)(t * G + r) * N + n0 + q : 0),
                     ok ? 16 : 0);
    }
  };
  // k-tile t's 8 group rows of scales and zero points (zero without zp)
  auto load_scales = [&](int st, int t) {
    for (int c = tid; c < 2 * PLANES * BN / 4; c += NTHR) {
      const int which = c / (PLANES * BN / 4), i = c % (PLANES * BN / 4);
      const int j = i / (BN / 4), q = (i % (BN / 4)) * 4;
      const float* src = which ? zp : scales;
      const bool ok = src != nullptr && n0 + q < N;
      ct::cp_async16((which ? zs : ss) + ((size_t)st * PLANES + j) * BN + q,
                     ok ? src + (size_t)(t * PLANES + j) * N + n0 + q : scales,
                     ok ? 16 : 0);
    }
  };
  // x's G columns of step s's group
  auto load_x = [&](int s) {
    const int kc = (kt0 + s / PLANES) * TK + (s % PLANES) * G;
    T* dst = xs + (size_t)(s % XST) * BM * XRS;
    for (int c = tid; c < BM * (G / XCH); c += NTHR) {
      const int r = c / (G / XCH), cc = (c % (G / XCH)) * XCH, col = kc + cc;
      const bool ok = m0 + r < M && col < Kx;
      ct::cp_async16(dst + r * XRS + cc,
                     x + (ok ? (size_t)(m0 + r) * Kx + col : 0), ok ? 16 : 0);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  if (steps > 0) {
    load_words(0, kt0, 0, G);
    load_scales(0, kt0);
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    if (i < steps) load_x(i);
    ct::cp_async_commit();
  }

  for (int s = 0; s < steps; ++s) {
    const int t = kt0 + s / PLANES, j = s % PLANES, wst = (t - kt0) & 1;
    ct::cp_async_wait<L - 1>();  // step s's x; this tile's words
    __syncthreads();             // ... visible; step s - 1's buffers free
    if (s + L < steps) load_x(s + L);
    if (j < 4 && t + 1 < kt1) {  // a quarter of the next tile's words
      load_words(wst ^ 1, t + 1, j * (G / 4), (j + 1) * (G / 4));
      if (j == 0) load_scales(wst ^ 1, t + 1);
    }
    ct::cp_async_commit();

    uint32_t* wb = wt + (size_t)wst * G * WSW;
    if (j == 0) {
      // at a tile's first step, each row pair (2p, 2p + 1) becomes the
      // pair's low halves (planes 0-3) and high halves (planes 4-7): a
      // lane then reads 4 bytes per two k rows and plane, not 8
      for (int c = tid; c < (G / 2) * BN; c += NTHR) {
        const int r = 2 * (c / BN), n = c % BN;
        uint32_t* w0 = wb + r * WSW + wcol(r, n);
        uint32_t* w1 = wb + (r + 1) * WSW + wcol(r + 1, n);
        const uint32_t a = *w0, b = *w1;
        *w0 = __byte_perm(a, b, 0x5410);
        *w1 = __byte_perm(a, b, 0x7632);
      }
      __syncthreads();
    }
    const T* xp = xs + (size_t)(s % XST) * BM * XRS;
    const float* sj = ss + ((size_t)wst * PLANES + j) * BN;
    const float* zj = zs + ((size_t)wst * PLANES + j) * BN;
    const int hj = j >> 2, sh = 4 * (j & 3);  // pair row, shift
    // per B column (n = qr of each n8 tile): the decode's constants
    uint32_t bc[NT];
    float bs[NT], bf[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = wn * WN + nt * 8 + qr;
      if constexpr (MODE == kInt4) {
        bc[nt] = bf16x2_bits(__float2bfloat162_rn(136.f + zj[n]));
      } else if constexpr (MODE == kA8) {
        bc[nt] = static_cast<uint32_t>(8 + __float2int_rn(zj[n])) * 0x01010101u;
      } else {
        bs[nt] = sj[n];
        bf[nt] = -8388608.f * bs[nt];
      }
    }
    float rs[MT][4];  // mat: row sums of the group's x columns
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) rs[mt][e] = 0.f;
    // the warp's n8 tiles in NH passes over the group (fewer live partials)
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      Part part[MT][NTH][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < NTH; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][q][e] = 0;

#pragma unroll
      for (int kk = 0; kk < G; kk += KS) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ct::ldmatrix_x4(a[mt], xp + (wm * WROWS + mt * 16 + (lane & 15)) * XRS + kk
                             + (lane >> 4) * XCH);
#pragma unroll
        for (int q = 0; q < NTH; ++q) {
          const int nt = h * NTH + q, n = wn * WN + nt * 8 + qr;
          uint32_t b[2];
          if constexpr (MODE == kA8) {
            // rows kk + 4qt .. + 3 (b0) and kk + 16 + 4qt .. + 3 (b1): two
            // row pairs each; byte i of the fragment is row 4qt + i
            const int bb = (j & 3) >> 1;
            const uint32_t sel = bb | ((2 + bb) << 4) | ((4 + bb) << 8)
                                 | ((6 + bb) << 12);
#pragma unroll
            for (int hb = 0; hb < 2; ++hb) {
              const int r0 = kk + 16 * hb + 4 * qt + hj, r1 = r0 + 2;
              const uint32_t q4 = __byte_perm(wb[r0 * WSW + wcol(r0, n)],
                                              wb[r1 * WSW + wcol(r1, n)], sel);
              b[hb] = ((((q4 >> (sh & 4)) & 0x0F0F0F0Fu) | 0x80808080u) - bc[nt])
                      ^ 0x80808080u;
            }
          } else {
            // rows (kk + 2qt, + 1) (b0) and (kk + 2qt + 8, + 9) (b1): one
            // row pair each
#pragma unroll
            for (int hb = 0; hb < 2; ++hb) {
              const int r = kk + 2 * qt + 8 * hb + hj;
              const uint32_t pw = wb[r * WSW + wcol(r, n)];
              if constexpr (MODE == kInt4) {
                b[hb] = bsub2(((pw >> sh) & 0x000F000Fu) | 0x43004300u, bc[nt]);
              } else {
                b[hb] = ct::pack_bf16x2(u_times(pw, sh, bs[nt], bf[nt]),
                                       u_times(pw, sh + 16, bs[nt], bf[nt]));
              }
            }
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if constexpr (MODE == kA8)
              ct::mma_s8_16832(part[mt][q], a[mt], b);
            else if constexpr (MODE == kInt4)
              ct::mma_bf16_16816(part[mt][q], a[mt], b);
            else
              ct::mma_bf16_16816(acc[mt][nt], a[mt], b);
          }
        }
        if constexpr (MODE == kMat) {
          if (h == 0) {
            const uint32_t ones[2] = {0x3F803F80u, 0x3F803F80u};
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) ct::mma_bf16_16816(rs[mt], a[mt], ones);
          }
        }
      }

      // end of the group: int4 / a8 scale the exact partial by s_j; mat
      // subtracts sum(x_j) * (8 + zp_j) * s_j
#pragma unroll
      for (int q = 0; q < NTH; ++q) {
        const int nt = h * NTH + q, col = wn * WN + nt * 8 + 2 * qt;
        const float s0 = sj[col], s1 = sj[col + 1];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (MODE == kMat) {
            const float o0 = (8.f + zj[col]) * s0, o1 = (8.f + zj[col + 1]) * s1;
            acc[mt][nt][0] -= rs[mt][0] * o0;
            acc[mt][nt][1] -= rs[mt][0] * o1;
            acc[mt][nt][2] -= rs[mt][2] * o0;
            acc[mt][nt][3] -= rs[mt][2] * o1;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][nt][e] += static_cast<float>(part[mt][q][e]) * (e & 1 ? s1 : s0);
          }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wm * WROWS + mt * 16 + qr + hh * 8;
      if (row >= M) continue;
      const float rsc = MODE == kA8 ? xscale[row] : 1.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + wn * WN + nt * 8 + 2 * qt;  // N % 4 == 0
        if (col >= N) continue;
        const float v0 = acc[mt][nt][hh * 2] * rsc;
        const float v1 = acc[mt][nt][hh * 2 + 1] * rsc;
        if (partial)
          *reinterpret_cast<float2*>(
              partial + ((size_t)blockIdx.z * M + row) * N + col) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * N + col) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int MODE, int BM, int G, int NH = 1>
int launch_g(const void* x, const void* xscale, const void* w,
             const void* scales, const void* zp, void* y, void* partial,
             int M, int N, int Kx, int K, int splits, int tiles_per_split,
             cudaStream_t s) {
  constexpr size_t smem = Cfg<MODE, BM, G>::SMEM;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        planes_kernel<MODE, BM, G, NH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  planes_kernel<MODE, BM, G, NH><<<grid, 256, smem, s>>>(
      x, static_cast<const float*>(xscale), static_cast<const int32_t*>(w),
      static_cast<const float*>(scales), static_cast<const float*>(zp),
      static_cast<__nv_bfloat16*>(y),
      splits > 1 ? static_cast<float*>(partial) : nullptr, M, N, Kx, K,
      tiles_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, int BM>
int launch_bm(const void* x, const void* xscale, const void* w,
              const void* scales, const void* zp, void* y, void* partial,
              int M, int N, int Kx, int K, int g, int splits,
              int tiles_per_split, cudaStream_t s) {
  switch (g) {
    case 32: return launch_g<MODE, BM, 32>(x, xscale, w, scales, zp, y, partial,
                                           M, N, Kx, K, splits, tiles_per_split, s);
    case 64: return launch_g<MODE, BM, 64>(x, xscale, w, scales, zp, y, partial,
                                           M, N, Kx, K, splits, tiles_per_split, s);
    case 128:  // int4 at 128 rows in two passes: no spill at 255 registers
      return launch_g<MODE, BM, 128, MODE == kInt4 && BM == 128 ? 2 : 1>(
          x, xscale, w, scales, zp, y, partial, M, N, Kx, K, splits,
          tiles_per_split, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// BM = 128 above 64 rows, 64 at decode rows (the wrapper's split-K counts
// blocks the same way); g in {32, 64, 128}
template <int MODE>
int launch_planes(const void* x, const void* xscale, const void* w,
                  const void* scales, const void* zp, void* y, void* partial,
                  int M, int N, int Kx, int K, int g, int splits,
                  int tiles_per_split, cudaStream_t s) {
  if (N % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int err = M > 64
      ? launch_bm<MODE, 128>(x, xscale, w, scales, zp, y, partial, M, N, Kx,
                             K, g, splits, tiles_per_split, s)
      : launch_bm<MODE, 64>(x, xscale, w, scales, zp, y, partial, M, N, Kx,
                            K, g, splits, tiles_per_split, s);
  if (err) return err;
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
  ct::quantize_rows_a8b_kernel<<<M, ct::A8B_QTHREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(xs), Kx);
  return launch_planes<kA8>(xq, xs, w, scales, zp, y, partial, M, N, Kx, K, g,
                            splits, tiles_per_split, s);
}
