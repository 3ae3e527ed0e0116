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
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

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

// ---- mode a8b: int8 activations on wgmma ------------------------------ //
// Replaces the same TPU function's mode "a8b" (w4a16_matmul.py:579-590 and
// the kernel body :258-290). Pass 1 quantizes each row of x as the TPU
// kernel does (ct::quantize_rows_a8b_kernel, common.cuh: one read of the
// row). Pass 2 is a GEMM on wgmma m64n128k32 .s8.s8 -> s32 with both
// operands K-major in 128-byte-swizzled shared memory: A = 64 quantized
// rows of x a warpgroup (two warpgroups, 128 rows), B = the block's 128
// weight rows decoded to the exact int8 values q - zp = u - (8 + zp).
//
// Bound on the H100: at prefill chunks (M = 256-512 rows and more) the
// 2*M*N*K int8 tensor-core operations. What the design does about it:
//   - a 128 x 128 output tile walks K in 128-deep k-tiles through a
//     4-stage cp.async ring that carries x's rows, the packed (N, K/8)
//     int32 words, and the tile's group scales and zero points (no global
//     load in the loop), 3 k-tiles of loads in flight;
//   - each k-tile's words are decoded once a block (not once a warp's
//     rows), into one of two swizzled int8 tiles, by all 256 threads while
//     the tensor cores run the tile before: (w & 0x0f0f0f0f, w >> 4 &
//     0x0f0f0f0f), two prmt into column order, and (u + 128 - (8 + zp)) ^
//     0x80 per byte (no byte carries), 8 values in 7 instructions;
//   - a k-tile's exact int32 sums (a group of 128, or a part of a larger
//     group; each 64-deep half apart when the group is an odd multiple of
//     64) are added into the f32 accumulator times the group's column
//     scales, read from the staged scale rows, once its wgmmas retire;
//     int32 -> f32 by the exponent trick (|sum| < 2^22: the bits of 1.5 *
//     2^23 + sum, minus 1.5 * 2^23), exact, on the integer and FMA pipes
//     instead of cvt's 16 a clock an SM;
//   - row tiles run fastest in the grid, so the blocks of one weight
//     column tile run together and read it once from device memory, and
//     K is split over a thread-block cluster (a8b_plan in the wrapper)
//     when the tiles leave SMs idle, the f32 tiles summed in rank order
//     through distributed shared memory; the row scale is applied once
//     there and y is written 8 bf16 a store.
// What it still pays (PERF.md): a k-tile's loads, decode, wgmmas and
// scaling run one after the other on 8 warps, about 5x the operation
// bound. ptxas serializes every wgmma if a second partial is read while
// one is in flight (C7514), so the scaling cannot overlap the warpgroup's
// own wgmmas; skewing the two warpgroups and a producer warpgroup with
// named barriers were both slower.
// The TPU kernel dots the offset nibbles u and subtracts (8 + zp) * sum(x)
// afterwards; with exact integer group sums both give the same value up
// to f32 rounding. Ragged M, N and K (a multiple of 64) are zero-filled by
// cp.async and masked at the store.
namespace a8b {

// 4 stages: 3, 5 and 6 read within 2% on the H100 (PERF.md)
constexpr int BM = 128, BN = 128, BK = 128, THREADS = 256, STAGES = 4;
constexpr int NP = BN / 2;  // int32 partials a thread
constexpr int CS = 80;                                  // code row stride (bytes)
constexpr size_t X_BYTES = (size_t)BM * BK;            // swizzled int8 rows
constexpr size_t C_BYTES = (size_t)BN * CS;            // 16 words a row
constexpr size_t S_BYTES = (size_t)2 * BN * 4;         // scale row of each 64-deep half
constexpr size_t STAGE = X_BYTES + C_BYTES + 2 * S_BYTES;  // + zero points
constexpr size_t B_BYTES = (size_t)BN * BK;            // decoded, swizzled
constexpr size_t RING = STAGES * STAGE + 2 * B_BYTES;
constexpr int AHEAD = STAGES - 1;  // k-tiles of loads in flight
constexpr int RS = BN + 4;                              // f32 tile row stride
constexpr size_t RED = (size_t)BM * RS * 4;
constexpr size_t SMEM = RING > RED ? RING : RED;
static_assert(STAGE % 1024 == 0 && SMEM <= 227 * 1024, "stage layout");

// d (+)= A (64 x 32, K-major, da) . B (128 x 32, K-major, db) over one
// warpgroup, s8 x s8 with s32 sums; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
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
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// one int32 word (nibble j = u of column j) -> 8 int8 values u - off in
// column order; add = (128 - off) in every byte
__device__ __forceinline__ uint2 decode_word(uint32_t w, uint32_t add) {
  const uint32_t ev = w & 0x0F0F0F0Fu, od = (w >> 4) & 0x0F0F0F0Fu;
  return make_uint2((prmt(ev, od, 0x5140u) + add) ^ 0x80808080u,
                    (prmt(ev, od, 0x7362u) + add) ^ 0x80808080u);
}

// x as f32, exactly, for |x| < 2^22: the bits of 1.5 * 2^23 + x
__device__ __forceinline__ float exact_f32(int x) {
  return __int_as_float(x + 0x4B400000) - 12582912.f;
}

// acc += part * (the column scales of the staged row sc, at this thread's
// column 2 t); element i: column 8 (i / 4) + 2 t + (i & 1)
__device__ __forceinline__ void flush(float (&acc)[NP], const int (&part)[NP],
                                      const float* sc) {
#pragma unroll
  for (int j = 0; j < NP / 4; ++j) {
    const float2 s = *reinterpret_cast<const float2*>(sc + 8 * j);
    acc[4 * j] += exact_f32(part[4 * j]) * s.x;
    acc[4 * j + 1] += exact_f32(part[4 * j + 1]) * s.y;
    acc[4 * j + 2] += exact_f32(part[4 * j + 2]) * s.x;
    acc[4 * j + 3] += exact_f32(part[4 * j + 3]) * s.y;
  }
}

// part = the sums of k32 steps [s0, s0 + N) of A (as) . B (bs), one commit
// group
template <int N>
__device__ __forceinline__ void issue(int (&part)[NP], const unsigned char* as,
                                      const unsigned char* bs, int s0) {
  ct::wgmma_fence();
#pragma unroll
  for (int s = 0; s < N; ++s)
    wgmma_m64n128k32(part, ct::wgmma_desc(as + 32 * (s0 + s)),
                     ct::wgmma_desc(bs + 32 * (s0 + s)), s);
  ct::wgmma_commit();
}

// HALF: group % 128 != 0, so a group may end in the middle of a k-tile:
// each 64-deep half sums and scales apart. VEC: 16-byte scale copies (N %
// 4 == 0, scales and zero points 16-byte aligned). grid (row tiles, column
// tiles, splits), cluster (1, 1, splits), k-tiles [z * per, (z + 1) * per).
template <bool HALF, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
w4a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
            const int32_t* __restrict__ w,
            const float* __restrict__ scales,  // (K/group, N)
            const float* __restrict__ zp,      // (K/group, N) or null
            __nv_bfloat16* __restrict__ y, int M, int N, int K, int group,
            int tiles_per_split) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, (K + BK - 1) / BK);
  const size_t kwords = K / 8;

  auto stage = [&](int st) { return smem + st * STAGE; };
  auto scales_of = [&](int st) {
    return reinterpret_cast<float*>(stage(st) + X_BYTES + C_BYTES);
  };
  unsigned char* dec = smem + STAGES * STAGE;

  auto load_tile = [&](int st, int kt) {
    unsigned char* base = stage(st);
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < BM * 8 / THREADS; ++i) {  // x: 8 chunks a row
      const int c = tid + i * THREADS, r = c >> 3, ch = c & 7;
      const bool ok = m0 + r < M && k0 + ch * 16 < K;
      ct::cp_async16(base + ct::swz(r, ch),
                     ok ? xq + (size_t)(m0 + r) * K + k0 + ch * 16 : xq,
                     ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < BN * 4 / THREADS; ++i) {  // words: 4 chunks a row
      const int c = tid + i * THREADS, r = c >> 2, ch = c & 3;
      const bool ok = n0 + r < N && k0 + ch * 32 < K;
      ct::cp_async16(base + X_BYTES + r * CS + ch * 16,
                     ok ? w + (n0 + r) * kwords + k0 / 8 + ch * 4 : w,
                     ok ? 16 : 0);
    }
    // the scale (and zero-point) row of each 64-deep half's group
    float* ss = scales_of(st);
    if (VEC) {
      if (tid < 2 * BN / 4) {
        const int half = tid / (BN / 4), col = (tid % (BN / 4)) * 4;
        const int kk = k0 + 64 * half;
        const bool ok = kk < K && n0 + col < N;
        const size_t off = ok ? (size_t)(kk / group) * N + n0 + col : 0;
        ct::cp_async16(ss + half * BN + col, scales + off, ok ? 16 : 0);
        if (zp) ct::cp_async16(ss + 2 * BN + half * BN + col, zp + off, ok ? 16 : 0);
      }
    } else {
      for (int c = tid; c < 2 * BN; c += THREADS) {
        const int half = c / BN, col = c % BN;
        const int kk = k0 + 64 * half;
        const bool ok = kk < K && n0 + col < N;
        const size_t off = ok ? (size_t)(kk / group) * N + n0 + col : 0;
        ct::cp_async4(ss + half * BN + col, scales + off, ok ? 4 : 0);
        if (zp) ct::cp_async4(ss + 2 * BN + half * BN + col, zp + off, ok ? 4 : 0);
      }
    }
  };

  // the decode in units of 4 words (16 bytes in, 32 out): unit u = tid +
  // THREADS * j is quarter u / BN of weight row u % BN (conflict-free: a
  // quarter warp reads 8 rows of the 80-byte stride, writes 8 rows of one
  // swizzled chunk)
  auto decode_tile = [&](int st, unsigned char* dst) {
    const unsigned char* cs = stage(st) + X_BYTES;
#pragma unroll
    for (int j = 0; j < BN * 4 / THREADS; ++j) {
      const int u = tid + THREADS * j, r = u % BN, q = u / BN;
      uint32_t add = 0x78787878u;  // 128 - 8
      if (zp)
        add = static_cast<uint32_t>(
                  120 - __float2int_rn(scales_of(st)[2 * BN + q / 2 * BN + r]))
              * 0x01010101u;
      const uint4 v = *reinterpret_cast<const uint4*>(cs + r * CS + 16 * q);
      const uint2 a = decode_word(v.x, add), b = decode_word(v.y, add);
      const uint2 e = decode_word(v.z, add), f = decode_word(v.w, add);
      *reinterpret_cast<uint4*>(dst + ct::swz(r, 2 * q)) = make_uint4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<uint4*>(dst + ct::swz(r, 2 * q + 1)) = make_uint4(e.x, e.y, f.x, f.y);
    }
    ct::fence_async_smem();
  };

  float acc[NP];
  int part[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    acc[i] = 0.f;
    part[i] = 0;
  }

  // tiles kt0 .. kt0 + AHEAD - 1 in flight, the first decoded. Iteration
  // kt issues tile kt's wgmmas, decodes tile kt + 1 into the other B tile
  // while they run, waits for them and scales the sums; its loads go to
  // the stage of tile kt - 1, which every thread is done with at the
  // barrier.
#pragma unroll
  for (int i = 0; i < AHEAD; ++i) {
    if (kt0 + i < kt1) load_tile(i, kt0 + i);
    ct::cp_async_commit();
  }
  ct::cp_async_wait<AHEAD - 1>();
  __syncthreads();
  if (kt0 < kt1) decode_tile(0, dec);
  for (int kt = kt0, st = 0, bb = 0; kt < kt1;
       ++kt, st = st == STAGES - 1 ? 0 : st + 1, bb ^= 1) {
    ct::cp_async_wait<AHEAD - 2>();  // tile kt + 1 has landed
    ct::fence_async_smem();
    __syncthreads();  // ... for all; tile kt decoded; tile kt - 1 retired
    if (kt + AHEAD < kt1) load_tile((st + AHEAD) % STAGES, kt + AHEAD);
    ct::cp_async_commit();

    const unsigned char* as = stage(st) + wg * 64 * BK;
    const unsigned char* bs = dec + bb * B_BYTES;
    const float* sc = scales_of(st) + 2 * t;
    const int st1 = st == STAGES - 1 ? 0 : st + 1;
#pragma unroll
    for (int h = 0; h < (HALF ? 2 : 1); ++h) {  // HALF: a group a 64-deep half
      issue<HALF ? 2 : 4>(part, as, bs, 2 * h);
      if (h == 0 && kt + 1 < kt1) decode_tile(st1, dec + (bb ^ 1) * B_BYTES);
      ct::wgmma_wait0();
      ct::fence_regs(part);
      flush(acc, part, sc + BN * h);
    }
  }
  ct::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the f32 tile

  // element i: row 64 wg + 16 (warp % 4) + g + 8 ((i >> 1) & 1), column
  // 8 (i / 4) + 2 t + (i & 1)
  float* red = reinterpret_cast<float*>(smem);
  const int row = wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
  for (int i = 0; i < NP; i += 2)
    *reinterpret_cast<float2*>(red + (row + 8 * ((i >> 1) & 1)) * RS +
                               8 * (i >> 2) + 2 * t) = make_float2(acc[i], acc[i + 1]);

  // the cluster's tiles summed in rank order, block r writing rows
  // [r * per, (r + 1) * per) times the row's x scale, 8 bf16 a store
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = min(BM, M - m0), per = (rows + splits - 1) / splits;
  const int r0 = rank * per, r1 = min(rows, r0 + per);
  const bool vec = !(N & 7);
  for (int e = tid; e < (r1 - r0) * (BN / 8); e += THREADS) {
    const int r = r0 + e / (BN / 8), c = (e % (BN / 8)) * 8, col = n0 + c;
    if (col >= N) continue;
    float sum[8] = {};
    for (int j = 0; j < splits; ++j) {
      const float* p = cluster.map_shared_rank(red, j) + r * RS + c;
      const float4 lo = *reinterpret_cast<const float4*>(p);
      const float4 hi = *reinterpret_cast<const float4*>(p + 4);
      sum[0] += lo.x; sum[1] += lo.y; sum[2] += lo.z; sum[3] += lo.w;
      sum[4] += hi.x; sum[5] += hi.y; sum[6] += hi.z; sum[7] += hi.w;
    }
    const float sx = xs[m0 + r];
    __nv_bfloat16* dst = y + (size_t)(m0 + r) * N + col;
    if (vec) {  // N % 8 == 0: the 8 columns are in range
      uint4 o;
      o.x = ct::pack_bf16x2(sum[0] * sx, sum[1] * sx);
      o.y = ct::pack_bf16x2(sum[2] * sx, sum[3] * sx);
      o.z = ct::pack_bf16x2(sum[4] * sx, sum[5] * sx);
      o.w = ct::pack_bf16x2(sum[6] * sx, sum[7] * sx);
      *reinterpret_cast<uint4*>(dst) = o;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (col + i < N) dst[i] = __float2bfloat16(sum[i] * sx);
    }
  }
  cluster.sync();  // no block leaves while another reads its tile
}

template <bool HALF, bool VEC>
int launch(dim3 grid, cudaStream_t s, const void* xq, const void* xs,
           const void* w, const void* scales, const void* zp, void* y, int M,
           int N, int K, int group, int per) {
  return ct::launch<&w4a8_kernel<HALF, VEC>>(
      SMEM, grid, THREADS, s, static_cast<const int8_t*>(xq),
      static_cast<const float*>(xs), static_cast<const int32_t*>(w),
      static_cast<const float*>(scales), static_cast<const float*>(zp),
      static_cast<__nv_bfloat16*>(y), M, N, K, group, per);
}

// the GEMM from the quantized rows; splits 1-8 blocks of a cluster, per
// 128-deep k-tiles each
int gemm(const void* xq, const void* xs, const void* w, const void* scales,
         const void* zp, void* y, int M, int N, int K, int group, int splits,
         int per, cudaStream_t s) {
  if (K % 64 || group % 64 || splits < 1 || splits > 8 || per < 1 ||
      (splits - 1) * per >= (K + BK - 1) / BK)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  const bool half = group % BK;
  const bool vec = !(N & 3) && !(reinterpret_cast<uintptr_t>(scales) & 15) &&
                   !(reinterpret_cast<uintptr_t>(zp) & 15);
  if (half)
    return vec ? launch<true, true>(grid, s, xq, xs, w, scales, zp, y, M, N, K, group, per)
               : launch<true, false>(grid, s, xq, xs, w, scales, zp, y, M, N, K, group, per);
  return vec ? launch<false, true>(grid, s, xq, xs, w, scales, zp, y, M, N, K, group, per)
             : launch<false, false>(grid, s, xq, xs, w, scales, zp, y, M, N, K, group, per);
}

int quantize(const void* x, void* xq, void* xs, int M, int K, cudaStream_t s) {
  ct::quantize_rows_a8b_kernel<<<M, ct::A8B_QTHREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(xs), K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace a8b

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
// (zp may be null); y (M, N) bf16; xq (M, K) int8 and xs (M,) f32 scratch
// (they keep the quantized rows). K % 64 == 0 and group % 64 == 0; w and
// xq 16-byte aligned. The plan: splits (1-8) blocks of a cluster sharing
// K, per 128-deep k-tiles each.
extern "C" int ct_w4a16_a8b_matmul(const void* x, const void* w,
                                   const void* scales, const void* zp, void* y,
                                   void* xq, void* xs, int M, int N, int K,
                                   int group, int splits, int per,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = a8b::quantize(x, xq, xs, M, K, s);
  if (err) return err;
  return a8b::gemm(xq, xs, w, scales, zp, y, M, N, K, group, splits, per, s);
}

// The two passes of mode a8b on their own (timing): the row quantization
// of x into xq/xs, and the GEMM from xq/xs.
extern "C" int ct_w4a16_a8b_quantize(const void* x, void* xq, void* xs, int M,
                                     int K, void* stream) {
  return a8b::quantize(x, xq, xs, M, K, static_cast<cudaStream_t>(stream));
}

extern "C" int ct_w4a16_a8b_gemm(const void* xq, const void* xs, const void* w,
                                 const void* scales, const void* zp, void* y,
                                 int M, int N, int K, int group, int splits,
                                 int per, void* stream) {
  return a8b::gemm(xq, xs, w, scales, zp, y, M, N, K, group, splits, per,
                   static_cast<cudaStream_t>(stream));
}
