// W4A16 group-quantized matmuls for Hopper: y = x . W^T with W kept in the
// checkpoint's pack-quantized words, (N, K/8) int32, nibble j of word w
// holding u = q + 8 of column 8w + j.
//
// ct_w4a16_matmul replaces compressed_tensors_tpu/ops/kernels/
// w4a16_matmul.py:w4a16_matmul (:541, pallas_call :675), mode "int4b" (the
// body's int4b branch, :234-285): x in bf16 dotted with the 4-bit weights,
// each quant group's f32 partial scaled by the group's f32 scale. The TPU
// kernel dots the raw codes u and subtracts (8 + zp) * sum(x) * s
// afterwards; here the offset is folded into the exact integers u - 8 - zp
// in bf16, as B10 does, so no two large terms cancel. Zero points are
// integers, as a checkpoint's are; a non-integer one is rounded to bf16 in
// 136 + zp, and the weights are then not exact. No weight is rounded: the
// only bf16 values are x's and these small integers, sums are f32, and y is
// rounded to bf16 once.
//
// The nibble decode: for byte b of a word w (columns 2b and 2b + 1), prmt
// puts byte b of w in byte 0 and byte b of w >> 4 in byte 2, one LOP3 keeps
// each half's low nibble under the bf16 exponent 0x43 (the value 128 + u,
// exact), and one bf16x2 subtract of 136 + zp finishes both weights: 13
// instructions a word, in column order. Each k-tile (64 deep) of a block's
// words is decoded once, by all its threads, into a 128-byte-swizzled bf16
// tile that wgmma reads from shared memory, while the tensor cores run the
// k-tile before.
//
// Two designs, picked by int4b_plan (ops/kernels/w4a16_matmul.py) by M:
//   decode rows (M <= 64; 16, 32 or 64 rows): bound by the packed weight
//     bytes, K*N/2, which should stream at 3.35 TB/s while the tensor cores
//     do 2*M*N*K operations (at M = 64, 256 operations a weight byte, near
//     the card's ridge). y^T = W x^T on wgmma m64n{16,32,64}k16: A = the
//     decoded tile of the block's 128 weight rows (64 a warpgroup), B = the
//     k-tile of x. Two blocks share an SM, so one block's decode and group
//     flush run while the other's copies and wgmmas do.
//   prefill rows (128 x 192 tiles): bound by the 2*M*N*K bf16 operations.
//     A = 64 rows of x a warpgroup (two warpgroups), B = the block's 192
//     decoded weight rows. The tile is wide in N since an element of x
//     costs 2 bytes from L2 and one of W 0.5, and no taller or wider, since
//     the exact-weight contract keeps each group's f32 partial (96
//     registers a thread) beside the f32 sum (96). Row tiles run fastest
//     in the grid up to 512 rows (each weight tile is then read once from
//     device memory), column tiles above (the weight stays in L2 while x
//     streams once).
// Both walk K in 64-deep k-tiles through a 4-stage cp.async ring of x, the
// words and the tile's group scale and zero-point rows (no global load in
// the loop; rows past M or N are not copied, since only outputs that are
// never stored read them). Every k-tile waits for its wgmmas; where a
// group ends, the partials times their scales go into the f32 sums (a
// branch after the wait: ptxas serializes a kernel's wgmmas at a wait in a
// branch, not at FMAs), and the next group restarts the partials with
// scale-d = 0. K is split over the blocks of a thread-block cluster (grid
// z, up to 8) when the column tiles leave SMs idle: each split scales its
// part of a group's sum, stages its f32 tile in its own shared memory, and
// the cluster sums the tiles in rank order through distributed shared
// memory, each block writing a slice of the rows in bf16; no partial goes
// to device memory and there is no second kernel. Ragged M and N are
// masked at the store; K and the group are multiples of 64.
// Experts (ct_w4a16_matmul_experts, the MoE layer's stacked weights): one
// launch computes y[e] = x[e] . W[e]^T for every expert e of an (E, M, K)
// dispatch buffer and (E, N, K/8) words with (E, K/group, N) scales and
// zero points. The expert index rides in grid y (which the K-split cluster
// does not span): each block offsets its operands by its expert's
// strides, and the design and split come from M rows and all E experts'
// blocks (int4b_plan).
// What bounds it now (PERF.md): the k-loop runs its copies, decode,
// wgmmas and flush largely one after the other between its barriers;
// neither the copies' latency (3-6 stages alike) nor x's bytes (copying
// half of x's rows saves 1-6%) hold it. Tried and dropped: decode rows on
// mma.sync with the nibbles decoded into B fragments (5-15% slower at M =
// 64), 256 weight rows a decode block (one block, or four warpgroups, an
// SM: slower), word copies of 2 or 4 k-tiles a row and L2 prefetch hints
// (no gain), 128 x 128 and 64 x 128 prefill tiles, a masked flush every
// k-tile.
//
// The second entry point, ct_w4a16_a8b_matmul, is the int8-activation mode
// "a8b" (see its note below). Mode "fp4" and w4_e8_matmul are in
// wna16_matmul.cu, the plane-layout modes int4 / a8 / mat in
// w4a16_planes.cu.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// ---- mode int4b ------------------------------------------------------- //
namespace int4b {

constexpr int BK = 64;                   // k-tile depth; a group is a multiple
constexpr int THREADS = 256;             // two warpgroups
constexpr int STAGES = 4;                // cp.async ring
constexpr uint32_t EXP2 = 0x43004300u;   // bf16x2 exponent of (128, 128)
constexpr uint32_t OFF8 = 0x43084308u;   // bf16x2 (136, 136): no zero point

// bf16x2 (136 + zp, 136 + zp): 128 + u - that = u - 8 - zp
__device__ __forceinline__ uint32_t offset2(float zp) {
  return ct::pack_bf16x2(136.f + zp, 136.f + zp);
}

// the two weights of byte b of w (columns 2b, 2b + 1) as bf16x2 (u - 8 -
// zp); w4 = w >> 4, sel = b | b << 4 | (b + 4) << 8 | (b + 4) << 12, off2
// = offset2(zp)
__device__ __forceinline__ uint32_t nib_pair(uint32_t w, uint32_t w4,
                                             uint32_t sel, uint32_t off2) {
  uint32_t r = (prmt(w, w4, sel) & 0x000F000Fu) | EXP2;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&r),
                                   *reinterpret_cast<__nv_bfloat162*>(&off2));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// a word's 8 weights in column order, 16 bytes of bf16
__device__ __forceinline__ uint4 decode_word(uint32_t w, uint32_t off2) {
  const uint32_t w4 = w >> 4;
  return make_uint4(nib_pair(w, w4, 0x4400u, off2), nib_pair(w, w4, 0x5511u, off2),
                    nib_pair(w, w4, 0x6622u, off2), nib_pair(w, w4, 0x7733u, off2));
}

// A k-tile's words (ROWS rows of 8 words at cs, 32 bytes a row) -> the
// swizzled bf16 tile dst (128 bytes a row), zero points at zs when has_zp:
// unit u = threadIdx.x + THREADS * j is words 2q, 2q + 1 (q = u % 4) of
// row u / 4, written as chunks 2q and 2q + 1 (a quarter warp's 8 stores
// hit 8 distinct chunk columns)
template <int ROWS>
__device__ __forceinline__ void decode_tile(const unsigned char* cs,
                                            const float* zs, bool has_zp,
                                            unsigned char* dst) {
#pragma unroll 1  // unrolled, the prefill kernel spills beside its 192 sums
  for (int j = 0; j < ROWS * 4 / THREADS; ++j) {
    const int u = threadIdx.x + THREADS * j, r = u >> 2, q = u & 3;
    const uint2 v = *reinterpret_cast<const uint2*>(cs + r * 32 + q * 8);
    const uint32_t off2 = has_zp ? offset2(zs[r]) : OFF8;
    *reinterpret_cast<uint4*>(dst + ct::swz(r, 2 * q)) = decode_word(v.x, off2);
    *reinterpret_cast<uint4*>(dst + ct::swz(r, 2 * q + 1)) = decode_word(v.y, off2);
  }
  ct::fence_async_smem();
}

// Copies of one k-tile into a stage: x rows [m0, m0 + XROWS)
// of the k-tile at k0 into the swizzled tile xs; the words of weight rows
// [n0, n0 + WROWS) into ws (32 bytes a row); the scale and zero-point rows
// of the k-tile's group into ss and ss + WROWS (16-byte copies when vec: N
// % 4 == 0, both 16-byte aligned). Rows past M or N are not copied: they
// only reach outputs that are never stored.
template <int XROWS, int WROWS>
__device__ __forceinline__ void load_tile(unsigned char* xs, unsigned char* ws,
                                          float* ss, const __nv_bfloat16* x,
                                          const int32_t* w, const float* scales,
                                          const float* zp, int M, int N, int K,
                                          int group, int m0, int n0, int kt,
                                          bool vec) {
  const int tid = threadIdx.x, k0 = kt * BK;
#pragma unroll
  for (int c = tid; c < XROWS * 8; c += THREADS) {
    const int r = c >> 3, ch = c & 7;
    if (m0 + r < M)
      ct::cp_async16(xs + ct::swz(r, ch), x + (size_t)(m0 + r) * K + k0 + ch * 8, 16);
  }
#pragma unroll
  for (int c = tid; c < WROWS * 2; c += THREADS) {
    const int r = c >> 1, h = c & 1;
    if (n0 + r < N)
      ct::cp_async16(ws + r * 32 + h * 16,
                     w + (size_t)(n0 + r) * (K / 8) + kt * 8 + h * 4, 16);
  }
  const size_t row = (size_t)(k0 / group) * N + n0;
  if (vec) {
    for (int col = tid * 4; col < min(WROWS, N - n0); col += THREADS * 4) {
      ct::cp_async16(ss + col, scales + row + col, 16);
      if (zp) ct::cp_async16(ss + WROWS + col, zp + row + col, 16);
    }
  } else {
    for (int col = tid; col < min(WROWS, N - n0); col += THREADS) {
      ct::cp_async4(ss + col, scales + row + col, 4);
      if (zp) ct::cp_async4(ss + WROWS + col, zp + row + col, 4);
    }
  }
}

// y[row, col .. col + 1] from two f32 values
__device__ __forceinline__ void store_pair(__nv_bfloat16* y, int M, int N,
                                           int row, int col, float v0,
                                           float v1) {
  if (row >= M || col >= N) return;
  __nv_bfloat16* dst = y + (size_t)row * N + col;
  if (col + 1 < N && !(N & 1)) {
    *reinterpret_cast<uint32_t*>(dst) = ct::pack_bf16x2(v0, v1);
  } else {
    dst[0] = __float2bfloat16(v0);
    if (col + 1 < N) dst[1] = __float2bfloat16(v1);
  }
}

// Sums the cluster's f32 (bm, bn) tiles staged at red (row stride rs
// floats) in rank order, block r writing rows [r * per, (r + 1) * per) of
// the tile to y in bf16, 4 columns a store
__device__ __forceinline__ void cluster_reduce(float* red, int rs, int bm,
                                               int bn, __nv_bfloat16* y,
                                               int M, int N, int m0, int n0) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = min(bm, M - m0), per = (rows + splits - 1) / splits;
  const int r0 = rank * per, r1 = min(rows, r0 + per);
  const bool vec = !(N & 3);
  for (int e = threadIdx.x; e < (r1 - r0) * (bn / 4); e += THREADS) {
    const int r = r0 + e / (bn / 4), c = (e % (bn / 4)) * 4, col = n0 + c;
    if (col >= N) continue;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < splits; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(red, j) + r * rs + c);
      s[0] += v.x;
      s[1] += v.y;
      s[2] += v.z;
      s[3] += v.w;
    }
    __nv_bfloat16* dst = y + (size_t)(m0 + r) * N + col;
    if (vec) {  // N % 4 == 0: the 4 columns are in range
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(ct::pack_bf16x2(s[0], s[1]), ct::pack_bf16x2(s[2], s[3]));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (col + i < N) dst[i] = __float2bfloat16(s[i]);
    }
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// ---- wgmma with both operands 128-byte-swizzled in shared memory ------- //

// d (+)= A (64 x 16, K-major, da) . B (16 x 16, K-major, db) over one
// warpgroup, both 128-byte-swizzled in shared memory; scale_d = 0
// overwrites d
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A (64 x 16, K-major, da) . B (32 x 16, K-major, db) over one
// warpgroup, both 128-byte-swizzled in shared memory; scale_d = 0
// overwrites d
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A (64 x 16, K-major, da) . B (64 x 16, K-major, db) over one
// warpgroup, both 128-byte-swizzled in shared memory; scale_d = 0
// overwrites d
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
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

// d (+)= A (64 x 16, K-major, da) . B (192 x 16, K-major, db) over one
// warpgroup, both 128-byte-swizzled in shared memory; scale_d = 0
// overwrites d
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 16) wgmma_m64n16k16(d, da, db, scale_d);
  else if constexpr (N == 32) wgmma_m64n32k16(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_m64n64k16(d, da, db, scale_d);
  else wgmma_m64n192k16(d, da, db, scale_d);
}

// ---- decode rows: y^T = W x^T ----------------------------------------- //
namespace dec {

constexpr int BN = 128;  // weight rows a block: two warpgroups of 64

template <int MT>  // x rows: 16 MT, the wgmma N
struct Cfg {
  static constexpr int ROWS = 16 * MT;
  static constexpr size_t X_BYTES = (size_t)ROWS * 128;  // 64 bf16 a row, swizzled
  static constexpr size_t W_BYTES = (size_t)BN * 32;     // 8 words a row
  static constexpr size_t RAW = X_BYTES + W_BYTES + 2 * BN * 4;  // + scale, zp rows
  static constexpr size_t STAGE = (RAW + 1023) / 1024 * 1024;
  static constexpr size_t A_BYTES = (size_t)BN * 128;    // decoded, swizzled
  static constexpr size_t RING = STAGES * STAGE + 2 * A_BYTES;
  static constexpr int RS = BN + 8;                      // f32 tile row stride
  static constexpr size_t RED = (size_t)ROWS * RS * 4;
  static constexpr size_t SMEM = RING > RED ? RING : RED;
  static_assert(SMEM <= 113 * 1024, "two blocks an SM");
};

// grid (column tiles, experts, splits), cluster (1, 1, splits); k-tiles
// [z * per, (z + 1) * per). Accumulator element i: weight row 64 wg + 16
// (warp % 4) + g + 8 ((i >> 1) & 1), x row 8 (i / 4) + 2 t + (i & 1).
template <int MT>
__global__ void __launch_bounds__(THREADS, 2)
decode_kernel(const __nv_bfloat16* __restrict__ x,
              const int32_t* __restrict__ w,
              const float* __restrict__ scales,  // (K/group, N)
              const float* __restrict__ zp,      // (K/group, N) or null
              __nv_bfloat16* __restrict__ y, int M, int N, int K, int group,
              int per, int vec) {
  using C = Cfg<MT>;
  constexpr int ND = 8 * MT;  // f32 accumulator registers a thread
  extern __shared__ __align__(1024) unsigned char smem[];
  {  // expert blockIdx.y's operands in the stacked (E, ...) buffers
    const size_t e = blockIdx.y, groups = (size_t)(K / group) * N;
    x += e * M * K;
    w += e * N * (K / 8);
    scales += e * groups;
    if (zp) zp += e * groups;
    y += e * M * N;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * per;
  const int kt1 = min(kt0 + per, K / BK);
  const int tpg = group / BK;
  auto stage = [&](int st) { return smem + st * C::STAGE; };
  auto group_rows = [&](int st) {
    return reinterpret_cast<float*>(stage(st) + C::X_BYTES + C::W_BYTES);
  };
  auto load = [&](int st, int kt) {
    load_tile<C::ROWS, BN>(stage(st), stage(st) + C::X_BYTES, group_rows(st),
                           x, w, scales, zp, M, N, K, group, 0, n0, kt, vec);
  };
  auto decode = [&](int st, unsigned char* dst) {
    decode_tile<BN>(stage(st) + C::X_BYTES, group_rows(st) + BN, zp, dst);
  };
  unsigned char* adec = smem + STAGES * C::STAGE;

  float acc[ND], part[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = part[i] = 0.f;
  int live = 0;  // the partial holds a started group
  const int wrow = wg * 64 + (warp & 3) * 16 + (lane >> 2);

  // tiles kt0 .. kt0 + STAGES - 2 in flight, the first decoded. Iteration
  // kt issues tile kt's wgmmas, decodes tile kt + 1 into the other A tile
  // while they run, waits for them and adds the partials into the sums;
  // its copies refill the stage of tile kt - 1, which every thread is done
  // with at the barrier.
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (kt0 + i < kt1) load(i, kt0 + i);
    ct::cp_async_commit();
  }
  ct::cp_async_wait<STAGES - 2>();
  __syncthreads();
  if (kt0 < kt1) decode(0, adec);
  for (int kt = kt0, st = 0, bb = 0; kt < kt1;
       ++kt, st = st == STAGES - 1 ? 0 : st + 1, bb ^= 1) {
    ct::cp_async_wait<STAGES - 3>();  // tile kt + 1 has landed
    ct::fence_async_smem();
    __syncthreads();  // ... for all; tile kt decoded; tile kt - 1 retired
    if (kt + STAGES - 1 < kt1) load(st == 0 ? STAGES - 1 : st - 1, kt + STAGES - 1);
    ct::cp_async_commit();

    const bool end = (kt + 1) % tpg == 0 || kt + 1 == kt1;
    const unsigned char* as = adec + bb * C::A_BYTES + wg * 64 * 128;
    const unsigned char* xs = stage(st);
    ct::wgmma_fence();
#pragma unroll
    for (int s = 0; s < BK / 16; ++s)
      wgmma_ss<16 * MT>(part, ct::wgmma_desc(as + 32 * s),
                        ct::wgmma_desc(xs + 32 * s), s ? 1 : live);
    ct::wgmma_commit();
    if (kt + 1 < kt1)
      decode(st == STAGES - 1 ? 0 : st + 1, adec + (bb ^ 1) * C::A_BYTES);
    ct::wgmma_wait0();
    ct::fence_regs(part);
    if (end) {
      const float s0 = group_rows(st)[wrow], s1 = group_rows(st)[wrow + 8];
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] += part[i] * (i & 2 ? s1 : s0);
    }
    live = !end;
  }

  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int m = 8 * (i >> 2) + 2 * t + (i & 1);
      const int col = n0 + wrow + 8 * ((i >> 1) & 1);
      if (m < M && col < N) y[(size_t)m * N + col] = __float2bfloat16(acc[i]);
    }
    return;
  }
  ct::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the f32 tile
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < ND; ++i)
    red[(8 * (i >> 2) + 2 * t + (i & 1)) * C::RS + wrow + 8 * ((i >> 1) & 1)] = acc[i];
  cluster_reduce(red, C::RS, C::ROWS, BN, y, M, N, 0, n0);
}

}  // namespace dec

// ---- prefill rows: 128 x 192 tiles ------------------------------------ //
namespace pre {

constexpr int BM = 128, BN = 192;
constexpr int ND = BN / 2;                              // f32 accumulator registers a thread
constexpr size_t X_BYTES = (size_t)BM * 128;            // 64 bf16 a row, swizzled
constexpr size_t W_BYTES = (size_t)BN * 32;             // 8 words a row
constexpr size_t STAGE = (X_BYTES + W_BYTES + 2 * BN * 4 + 1023) / 1024 * 1024;
constexpr size_t B_BYTES = (size_t)BN * 128;            // decoded, swizzled
constexpr size_t RING = STAGES * STAGE + 2 * B_BYTES;
constexpr int RS = BN + 8;                              // f32 tile row stride
constexpr size_t RED = (size_t)BM * RS * 4;
constexpr size_t SMEM = RING > RED ? RING : RED;
static_assert(SMEM <= 227 * 1024, "shared memory");

// grid (row tiles, column tiles x experts, splits) when rows_fast, else
// (column tiles, row tiles x experts, splits), ny tiles of grid y an
// expert; cluster (1, 1, splits); k-tiles [z * per, (z + 1) * per).
// Accumulator element i: row 16 (warp % 4) + g + 8 ((i >> 1) & 1) of the
// warpgroup's 64, column 8 (i / 4) + 2 t + (i & 1).
__global__ void __launch_bounds__(THREADS, 1)
prefill_kernel(const __nv_bfloat16* __restrict__ x,
               const int32_t* __restrict__ w,
               const float* __restrict__ scales,  // (K/group, N)
               const float* __restrict__ zp,      // (K/group, N) or null
               __nv_bfloat16* __restrict__ y, int M, int N, int K, int group,
               int per, int vec, int rows_fast, int ny) {
  extern __shared__ __align__(1024) unsigned char smem[];
  {  // expert blockIdx.y / ny's operands in the stacked (E, ...) buffers
    const size_t e = blockIdx.y / ny, groups = (size_t)(K / group) * N;
    x += e * M * K;
    w += e * N * (K / 8);
    scales += e * groups;
    if (zp) zp += e * groups;
    y += e * M * N;
  }
  const int by = blockIdx.y % ny;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, t = lane & 3;
  const int m0 = (rows_fast ? blockIdx.x : by) * BM;
  const int n0 = (rows_fast ? by : blockIdx.x) * BN;
  const int kt0 = blockIdx.z * per;
  const int kt1 = min(kt0 + per, K / BK);
  const int tpg = group / BK;
  auto stage = [&](int st) { return smem + st * STAGE; };
  auto group_rows = [&](int st) {
    return reinterpret_cast<float*>(stage(st) + X_BYTES + W_BYTES);
  };
  auto load = [&](int st, int kt) {
    load_tile<BM, BN>(stage(st), stage(st) + X_BYTES, group_rows(st), x, w,
                      scales, zp, M, N, K, group, m0, n0, kt, vec);
  };
  auto decode = [&](int st, unsigned char* dst) {
    decode_tile<BN>(stage(st) + X_BYTES, group_rows(st) + BN, zp, dst);
  };
  unsigned char* bdec = smem + STAGES * STAGE;

  float acc[ND], part[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = part[i] = 0.f;
  int live = 0;  // the partial holds a started group

  // the pipeline of the decode rows, with x as A and the decoded weight
  // tile as B
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (kt0 + i < kt1) load(i, kt0 + i);
    ct::cp_async_commit();
  }
  ct::cp_async_wait<STAGES - 2>();
  __syncthreads();
  if (kt0 < kt1) decode(0, bdec);
  for (int kt = kt0, st = 0, bb = 0; kt < kt1;
       ++kt, st = st == STAGES - 1 ? 0 : st + 1, bb ^= 1) {
    ct::cp_async_wait<STAGES - 3>();  // tile kt + 1 has landed
    ct::fence_async_smem();
    __syncthreads();  // ... for all; tile kt decoded; tile kt - 1 retired
    if (kt + STAGES - 1 < kt1) load(st == 0 ? STAGES - 1 : st - 1, kt + STAGES - 1);
    ct::cp_async_commit();

    const bool end = (kt + 1) % tpg == 0 || kt + 1 == kt1;
    const unsigned char* as = stage(st) + wg * 64 * 128;
    const unsigned char* bs = bdec + bb * B_BYTES;
    ct::wgmma_fence();
#pragma unroll
    for (int s = 0; s < BK / 16; ++s)
      wgmma_ss<BN>(part, ct::wgmma_desc(as + 32 * s), ct::wgmma_desc(bs + 32 * s),
                   s ? 1 : live);
    ct::wgmma_commit();
    if (kt + 1 < kt1) decode(st == STAGES - 1 ? 0 : st + 1, bdec + (bb ^ 1) * B_BYTES);
    ct::wgmma_wait0();
    ct::fence_regs(part);
    if (end) {
      const float* sc = group_rows(st) + 2 * t;
#pragma unroll
      for (int j = 0; j < ND / 4; ++j) {
        const float2 s = *reinterpret_cast<const float2*>(sc + 8 * j);
        acc[4 * j] += part[4 * j] * s.x;
        acc[4 * j + 1] += part[4 * j + 1] * s.y;
        acc[4 * j + 2] += part[4 * j + 2] * s.x;
        acc[4 * j + 3] += part[4 * j + 3] * s.y;
      }
    }
    live = !end;
  }

  const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < ND; i += 2)
      store_pair(y, M, N, m0 + row + 8 * ((i >> 1) & 1), n0 + 8 * (i >> 2) + 2 * t,
                 acc[i], acc[i + 1]);
    return;
  }
  ct::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the f32 tile
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < ND; i += 2)
    *reinterpret_cast<float2*>(red + (row + 8 * ((i >> 1) & 1)) * RS +
                               8 * (i >> 2) + 2 * t) = make_float2(acc[i], acc[i + 1]);
  cluster_reduce(red, RS, BM, BN, y, M, N, m0, n0);
}

}  // namespace pre

template <int MT>
int launch_decode(const void* x, const void* w, const void* scales,
                  const void* zp, void* y, int E, int M, int N, int K,
                  int group, int splits, int per, int vec, cudaStream_t s) {
  const dim3 grid((N + dec::BN - 1) / dec::BN, E, splits);
  return ct::launch<&dec::decode_kernel<MT>>(
      dec::Cfg<MT>::SMEM, grid, THREADS, s, static_cast<const __nv_bfloat16*>(x),
      static_cast<const int32_t*>(w), static_cast<const float*>(scales),
      static_cast<const float*>(zp), static_cast<__nv_bfloat16*>(y), M, N, K,
      group, per, vec);
}

int launch_prefill(const void* x, const void* w, const void* scales,
                   const void* zp, void* y, int E, int M, int N, int K,
                   int group, int splits, int per, int vec, cudaStream_t s) {
  const int rt = (M + pre::BM - 1) / pre::BM, ct_ = (N + pre::BN - 1) / pre::BN;
  const int rows_fast = rt * pre::BM <= 512, ny = rows_fast ? ct_ : rt;
  if ((long long)ny * E > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(rows_fast ? rt : ct_, ny * E, splits);
  return ct::launch<&pre::prefill_kernel>(
      pre::SMEM, grid, THREADS, s, static_cast<const __nv_bfloat16*>(x),
      static_cast<const int32_t*>(w), static_cast<const float*>(scales),
      static_cast<const float*>(zp), static_cast<__nv_bfloat16*>(y), M, N, K,
      group, per, vec, rows_fast, ny);
}

// E experts (1: one matrix); bm 16, 32 or 64 >= M (decode rows) or 128
// (prefill rows); splits (1-8) blocks of a cluster share K, per 64-deep
// k-tiles each
int matmul(const void* x, const void* w, const void* scales, const void* zp,
           void* y, int E, int M, int N, int K, int group, int bm, int splits,
           int per, cudaStream_t s) {
  const int tiles = K / BK;
  if (E < 1 || E > 65535 || M < 1 || N < 1 || K < BK || K % BK ||
      group % BK || (E > 1 && K % group) || splits < 1 || splits > 8 ||
      per < 1 || (splits - 1) * per >= tiles || splits * per < tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = !(N & 3) && !(reinterpret_cast<uintptr_t>(scales) & 15) &&
                  !(reinterpret_cast<uintptr_t>(zp) & 15);
  if (bm == pre::BM)
    return launch_prefill(x, w, scales, zp, y, E, M, N, K, group, splits, per,
                          vec, s);
  if (M > bm) return static_cast<int>(cudaErrorInvalidValue);
#define CT_ARGS x, w, scales, zp, y, E, M, N, K, group, splits, per, vec, s
  switch (bm) {
    case 16: return launch_decode<1>(CT_ARGS);
    case 32: return launch_decode<2>(CT_ARGS);
    case 64: return launch_decode<4>(CT_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CT_ARGS
}

}  // namespace int4b

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
// tiles x experts, splits), ny column tiles an expert (each block offsets
// its operands to expert blockIdx.y / ny's in the stacked (E, ...)
// buffers), cluster (1, 1, splits), k-tiles [z * per, (z + 1) * per).
template <bool HALF, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
w4a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
            const int32_t* __restrict__ w,
            const float* __restrict__ scales,  // (K/group, N)
            const float* __restrict__ zp,      // (K/group, N) or null
            __nv_bfloat16* __restrict__ y, int M, int N, int K, int group,
            int tiles_per_split, int ny) {
  extern __shared__ __align__(1024) unsigned char smem[];
  {
    const size_t e = blockIdx.y / ny, groups = (size_t)(K / group) * N;
    xq += e * M * K;
    xs += e * M;
    w += e * N * (K / 8);
    scales += e * groups;
    if (zp) zp += e * groups;
    y += e * M * N;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2;
  const int m0 = blockIdx.x * BM, n0 = (blockIdx.y % ny) * BN;
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
           int N, int K, int group, int per, int ny) {
  return ct::launch<&w4a8_kernel<HALF, VEC>>(
      SMEM, grid, THREADS, s, static_cast<const int8_t*>(xq),
      static_cast<const float*>(xs), static_cast<const int32_t*>(w),
      static_cast<const float*>(scales), static_cast<const float*>(zp),
      static_cast<__nv_bfloat16*>(y), M, N, K, group, per, ny);
}

// the GEMM from the quantized rows of E experts (1: one matrix); splits
// 1-8 blocks of a cluster, per 128-deep k-tiles each
int gemm(const void* xq, const void* xs, const void* w, const void* scales,
         const void* zp, void* y, int E, int M, int N, int K, int group,
         int splits, int per, cudaStream_t s) {
  const int ny = (N + BN - 1) / BN;
  if (K % 64 || group % 64 || (E > 1 && K % group) || E < 1 ||
      (long long)ny * E > 65535 || splits < 1 || splits > 8 || per < 1 ||
      (splits - 1) * per >= (K + BK - 1) / BK)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + BM - 1) / BM, ny * E, splits);
  const bool half = group % BK;
  const bool vec = !(N & 3) && !(reinterpret_cast<uintptr_t>(scales) & 15) &&
                   !(reinterpret_cast<uintptr_t>(zp) & 15);
#define CT_ARGS grid, s, xq, xs, w, scales, zp, y, M, N, K, group, per, ny
  if (half)
    return vec ? launch<true, true>(CT_ARGS) : launch<true, false>(CT_ARGS);
  return vec ? launch<false, true>(CT_ARGS) : launch<false, false>(CT_ARGS);
#undef CT_ARGS
}

int quantize(const void* x, void* xq, void* xs, int M, int K, cudaStream_t s) {
  ct::quantize_rows_a8b_kernel<<<M, ct::A8B_QTHREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(xs), K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace a8b

}  // namespace

// Mode int4b. x (M, K) bf16; w (N, K/8) int32; scales/zp (K/group, N) f32
// (zp may be null); y (M, N) bf16. K % 64 == 0 and group % 64 == 0; x and
// w 16-byte aligned. The plan (int4b_plan): bm 16, 32 or 64 rows (the
// decode design, M <= bm) or 128 (the prefill design); splits (1-8)
// blocks of a cluster share K, per 64-deep k-tiles each.
extern "C" int ct_w4a16_matmul(const void* x, const void* w, const void* scales,
                               const void* zp, void* y, int M, int N, int K,
                               int group, int bm, int splits, int per,
                               void* stream) {
  return int4b::matmul(x, w, scales, zp, y, 1, M, N, K, group, bm, splits, per,
                       static_cast<cudaStream_t>(stream));
}

// Mode int4b over E experts in one launch: x (E, M, K) bf16, w (E, N, K/8)
// int32, scales/zp (E, K/group, N) f32, y (E, M, N) bf16, each stacked
// contiguously; K % group == 0; the plan as above for M rows and E
// experts.
extern "C" int ct_w4a16_matmul_experts(const void* x, const void* w,
                                       const void* scales, const void* zp,
                                       void* y, int E, int M, int N, int K,
                                       int group, int bm, int splits, int per,
                                       void* stream) {
  return int4b::matmul(x, w, scales, zp, y, E, M, N, K, group, bm, splits, per,
                       static_cast<cudaStream_t>(stream));
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
  return a8b::gemm(xq, xs, w, scales, zp, y, 1, M, N, K, group, splits, per, s);
}

// Mode a8b over E experts: the row pass quantizes all E * M rows of x (E,
// M, K) into xq (E, M, K) and xs (E, M), then one GEMM launch covers every
// expert (operands stacked as for ct_w4a16_matmul_experts).
extern "C" int ct_w4a16_a8b_matmul_experts(const void* x, const void* w,
                                           const void* scales, const void* zp,
                                           void* y, void* xq, void* xs, int E,
                                           int M, int N, int K, int group,
                                           int splits, int per, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)E * M > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int err = a8b::quantize(x, xq, xs, E * M, K, s);
  if (err) return err;
  return a8b::gemm(xq, xs, w, scales, zp, y, E, M, N, K, group, splits, per, s);
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
  return a8b::gemm(xq, xs, w, scales, zp, y, 1, M, N, K, group, splits, per,
                   static_cast<cudaStream_t>(stream));
}
