// WnA16 matmuls for Hopper over weights that are not int4 words: y = x . W^T
// with W kept compressed, in two designs on wgmma.
//
// ct_w4a16_fp4_matmul replaces mode "fp4" of the TPU function
// compressed_tensors_tpu/ops/kernels/w4a16_matmul.py:w4a16_matmul (:541,
// pallas_call :675, body :332-362): NVFP4 / MXFP4 weights as the
// checkpoint's (N, K/2) uint8 E2M1 codes (low nibble = even column) with
// (K/group, N) f32 scales (e4m3 scale / global scale, or the E8M0 power of
// two). Each weight is bf16(E2M1(code) * s): the f32 product rounded to
// bf16, as the TPU kernel rounds its scaled tile to x's dtype; bf16
// products sum in f32.
//
// ct_w4_e8_matmul replaces w4_e8_matmul (w4a16_matmul.py:485, pallas_call
// :511, body :442-482): (N, K) signed int8 q - zp with (K/group, N) f32
// scales. int8 -> bf16 is exact; each group's f32 partial product is
// scaled by the group's f32 scale into the accumulator, as the TPU body
// scales each group's dot (a split of K may cut a group: each split scales
// its part of the group's sum).
//
// Decoders, in registers:
//   fp4:  E2M1 magnitudes are exact in bf16: two prmt lookups in 8-byte
//         tables give the high and low bytes of four magnitudes at once, a
//         sign-replicating prmt puts each code's sign on its high byte, one
//         more prmt pairs them into bf16x2; each value is then multiplied by
//         its f32 scale and rounded by cvt.rn.bf16x2.f32. Where a thread
//         decodes a whole group (prefill rows), the table holds the group's
//         eight scaled values bf16(m * s) instead, rounded the same way, and
//         the lookups alone decode.
//   int8: for a byte r, bf16(0x4300 | (r & 0x7f)) - bf16(0x4300 | (r & 0x80))
//         is its signed value, exactly: two LOP3s and a bf16x2 subtract a
//         pair.
//
// What bounds each design on the H100, and what the design does about it:
//   decode rows (M <= 64, bm = 16, 32 or 64): the weight bytes (codes and
//         scales, read once). The product is y^T = W . x^T on wgmma
//         m64n{bm}k16 with A in registers: each of the 8 warps of a block
//         (128 output columns, two warpgroups) decodes its 16 weight rows of
//         a k-tile straight into the A fragments, so no bf16 weight tile
//         goes through shared memory, and the tensor cores read x, the B
//         operand, from its 128-byte-swizzled tile (once a warpgroup, with
//         no ldmatrix). A 4-stage cp.async ring holds each 64-deep k-tile's
//         codes, its scales (one row per 16-deep step) and x: 3 k-tiles in
//         flight a block, no global load in the loop, one barrier a k-tile.
//         A k-tile's four wgmmas issue back to back from one asm statement;
//         the next k-tile decodes once they retire (ptxas serializes every
//         wgmma of a kernel whose A registers are written while one is in
//         flight), and the SM's other blocks keep the tensor cores and the
//         loads busy meanwhile.
//   prefill rows (bm = 128): the 2*M*N*K tensor-core operations. 128 x 128
//         output tiles, 4 warpgroups of wgmma m64n64k16 with both operands
//         in shared memory in the 128-byte swizzle. A 5-stage ring holds x,
//         the codes and the scales; each k-tile's codes are decoded once a
//         block into one of three bf16 B tiles, the next k-tile's decode
//         runs while the current one's wgmmas do, and those stay in flight
//         across the next barrier. No warp specialization and no setmaxnreg.
// int8 group partials accumulate in a second wgmma accumulator (restarted
// by scale-d = 0) and scale into the first after the step that ends the
// group, with no branch around a wgmma or a wait (ptxas serializes a
// kernel's wgmmas at one): every flush waits and adds the partial times 0
// where no group ends. Groups that are a multiple of the k-tile flush once
// a k-tile; others once a step (a kernel of their own).
// K is split over the blocks of a thread-block cluster (grid z, cluster dims
// (1, 1, splits), splits <= 8) when the column tiles leave SMs idle: each
// block leaves its f32 partial tile in its own shared memory and the
// cluster sums them through distributed shared memory, each block writing a
// slice of the rows in bf16, so no partial goes to device memory. Ragged K
// (a multiple of 32 for fp4, 16 for int8), M and N are zero-filled by
// cp.async and masked at the store.
// Experts (ct_w4_e8_matmul_experts, the MoE layer's stacked weights): one
// launch computes y[e] = x[e] . W[e]^T for every expert e of an (E, M, K)
// dispatch buffer, (E, N, K) weights and (E, K/group, N) scales. The
// expert index rides in grid y beside the row tiles (the K-split cluster
// spans grid z only); each block offsets its operands by its expert's
// strides, and the design and split come from M rows and all E experts'
// blocks (wna16_plan).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using ct::cp_async4;
using ct::fence_async_smem;
using ct::fence_regs;
using ct::launch;
using ct::swz;
using ct::wgmma_commit;
using ct::wgmma_desc;
using ct::wgmma_fence;
using ct::wgmma_wait0;
using ct::wgmma_wait1;

constexpr int BN = 128, BK = 64, STEPS = BK / 16;
constexpr int DECODE_STAGES = 4, PREFILL_STAGES = 5;

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// Eight E2M1 codes (byte j holds the codes of two adjacent k, the even one
// in the low nibble) -> four bf16x2 words, pair j = byte j, each value
// bf16(E2M1(code) * s) with s = sa for bytes 0-1 and sb for bytes 2-3.
// bf16 bits of the magnitudes 0, 0.5, 1, 1.5, 2, 3, 4, 6 are
// 0x0000 0x3F00 0x3F80 0x3FC0 0x4000 0x4040 0x4080 0x40C0: the tables hold
// their high and low bytes by magnitude.
__device__ __forceinline__ void fp4_decode(uint32_t codes, float sa, float sb,
                                           uint32_t* out) {
  const uint32_t mag = codes & 0x77777777u;
  // byte i of the lookups: magnitude of nibble i (lo) or nibble 4 + i (hi)
  uint32_t hi_lo = prmt(0x3F3F3F00u, 0x40404040u, mag);
  uint32_t hi_hi = prmt(0x3F3F3F00u, 0x40404040u, mag >> 16);
  const uint32_t lo_lo = prmt(0xC0800000u, 0xC0804000u, mag);
  const uint32_t lo_hi = prmt(0xC0800000u, 0xC0804000u, mag >> 16);
  // sign of nibble 2j: bit 7 of byte j of codes << 4; of nibble 2j + 1:
  // bit 7 of byte j of codes (prmt selector bit 3 replicates a byte's sign)
  const uint32_t c4 = codes << 4;
  hi_lo |= prmt(c4, codes, 0xD9C8u) & 0x80808080u;
  hi_hi |= prmt(c4, codes, 0xFBEAu) & 0x80808080u;
  const uint32_t pair[4] = {prmt(lo_lo, hi_lo, 0x5140u), prmt(lo_lo, hi_lo, 0x7362u),
                            prmt(lo_hi, hi_hi, 0x5140u), prmt(lo_hi, hi_hi, 0x7362u)};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float s = j < 2 ? sa : sb;
    out[j] = ct::pack_bf16x2(__uint_as_float(pair[j] << 16) * s,
                             __uint_as_float(pair[j] & 0xFFFF0000u) * s);
  }
}

// The 8 bf16 values bf16(E2M1(m) * s), m = 0 .. 7, of one scale, as two
// byte tables (high bytes, low bytes; 8 bytes = 2 words each) that
// fp4_decode_table reads: each rounded as fp4_decode rounds it
struct Fp4Table {
  uint32_t hi0, hi1, lo0, lo1;
};

__device__ __forceinline__ Fp4Table fp4_table(float s) {
  const uint32_t t0 = ct::pack_bf16x2(0.f, 0.5f * s);
  const uint32_t t1 = ct::pack_bf16x2(1.f * s, 1.5f * s);
  const uint32_t t2 = ct::pack_bf16x2(2.f * s, 3.f * s);
  const uint32_t t3 = ct::pack_bf16x2(4.f * s, 6.f * s);
  return {prmt(t0, t1, 0x7531u), prmt(t2, t3, 0x7531u),
          prmt(t0, t1, 0x6420u), prmt(t2, t3, 0x6420u)};
}

// Eight E2M1 codes as fp4_decode takes them -> four bf16x2 words, each
// value looked up in the scaled table; a code's sign flips its value's
// (bf16(-v) = -bf16(v))
__device__ __forceinline__ uint4 fp4_decode_table(uint32_t codes,
                                                  const Fp4Table& t) {
  const uint32_t mag = codes & 0x77777777u;
  uint32_t hi_lo = prmt(t.hi0, t.hi1, mag);
  uint32_t hi_hi = prmt(t.hi0, t.hi1, mag >> 16);
  const uint32_t lo_lo = prmt(t.lo0, t.lo1, mag);
  const uint32_t lo_hi = prmt(t.lo0, t.lo1, mag >> 16);
  const uint32_t c4 = codes << 4;
  hi_lo ^= prmt(c4, codes, 0xD9C8u) & 0x80808080u;
  hi_hi ^= prmt(c4, codes, 0xFBEAu) & 0x80808080u;
  return make_uint4(prmt(lo_lo, hi_lo, 0x5140u), prmt(lo_lo, hi_lo, 0x7362u),
                    prmt(lo_hi, hi_hi, 0x5140u), prmt(lo_hi, hi_hi, 0x7362u));
}

// Two int8 values, bytes p and p + 1 of w (sel = p | 4 << 4 | (p + 1) << 8
// | 4 << 12 puts them in the low byte of each half, zero above) -> bf16x2
__device__ __forceinline__ uint32_t i8_pair(uint32_t w, uint32_t sel) {
  const uint32_t r = prmt(w, 0u, sel);
  uint32_t a = (r & 0x007F007Fu) | 0x43004300u;  // 128 + (r & 127)
  uint32_t b = (r & 0x00800080u) | 0x43004300u;  // 128 or 256
  __nv_bfloat162 d = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&d);
}

struct Fp4 {
  static constexpr int kRowBytes = BK / 2;  // code bytes per row per k-tile
  static constexpr bool kScaled = true;     // the scale is in the weight
  static constexpr bool kTiled = true;      // no group partial to flush
};
// int8 with groups a multiple of the k-tile (kTiled: a group ends only at
// a tile's end) or any multiple of 16
template <bool TILED>
struct Int8 {
  static constexpr int kRowBytes = BK;
  static constexpr bool kScaled = false;    // group scales on the partials
  static constexpr bool kTiled = TILED;
};

// f32 (rows, BN) tile staged for the cluster's reduction: row stride BN + 8
constexpr int RED = BN + 8;

// The 4-byte scale copies of a k-tile when N % 4 != 0: the scale row of
// each 16-deep step's group at ss + step * BN, zero past N and K (no call:
// ptxas serializes the wgmmas of a function that makes one)
template <int NTHR>
__device__ __forceinline__ void load_scales_narrow(float* ss, const float* scales,
                                                int N, int K, int n0, int g16,
                                                int kt) {
  for (int c = threadIdx.x; c < STEPS * BN; c += NTHR) {
    const int u = kt * STEPS + c / BN, col = c % BN;
    const bool ok = u * 16 < K && n0 + col < N;
    cp_async4(ss + c, scales + (ok ? (size_t)(u / g16) * N + n0 + col : 0),
              ok ? 4 : 0);
  }
}

// Copies of one k-tile into a stage, issued by NTHR threads: x rows
// [m0, m0 + ROWS) (zero past M and K) at xs + xoff(r, chunk) bytes; code
// rows [n0, n0 + BN) at cs + r * cstride; the scale row of each 16-deep
// step's group at ss + step * BN (zero past N and K; 16-byte copies when
// N % 4 == 0). Each thread's 32-bit offsets are computed once; a tile adds
// its k offset to the bases.
template <int NTHR, int ROWS, class W>
struct Loader {
  static constexpr int XCH = ROWS * (BK / 8), XI = (XCH + NTHR - 1) / NTHR;
  static constexpr int CH = W::kRowBytes / 16, CCH = BN * CH;
  static constexpr int CI = (CCH + NTHR - 1) / NTHR;
  static constexpr int SCH = STEPS * BN / 4;  // 16-byte scale chunks

  const __nv_bfloat16* x;
  const uint8_t* w;
  const float* scales;
  int xo[XI], xd[XI], xc[XI], co[CI], cd[CI], cb[CI];
  int N, K, n0, g16, row_bytes, sstep, scol;

  template <class XOff>
  __device__ __forceinline__ Loader(const __nv_bfloat16* x_, const uint8_t* w_,
                                    const float* sc, int M, int N_, int K_,
                                    int m0, int n0_, int group, XOff xoff,
                                    int cstride)
      : x(x_), w(w_), scales(sc), N(N_), K(K_), n0(n0_), g16(group / 16),
        row_bytes(K_ * W::kRowBytes / BK) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < XI; ++i) {  // xc = -1: no row (zero fill)
      const int c = tid + i * NTHR, r = c >> 3;
      const bool ok = c < XCH && m0 + r < M;
      xc[i] = ok ? (c & 7) * 8 : -1;
      xo[i] = ok ? (m0 + r) * K + (c & 7) * 8 : 0;
      xd[i] = xoff(r, c & 7);
    }
#pragma unroll
    for (int i = 0; i < CI; ++i) {  // cb = -1: no row
      const int c = tid + i * NTHR, r = c / CH;
      const bool ok = c < CCH && n0 + r < N;
      cb[i] = ok ? (c % CH) * 16 : -1;
      co[i] = ok ? (n0 + r) * row_bytes + (c % CH) * 16 : 0;
      cd[i] = r * cstride + (c % CH) * 16;
    }
    sstep = tid / (BN / 4);
    scol = (tid % (BN / 4)) * 4;
  }

  __device__ __forceinline__ void load(unsigned char* xs, uint8_t* cs,
                                       float* ss, int kt) const {
    const int k0 = kt * BK, byte = kt * W::kRowBytes;
    const __nv_bfloat16* xb = x + k0;
    const uint8_t* wb = w + byte;
#pragma unroll
    for (int i = 0; i < XI; ++i) {
      if (XCH % NTHR && threadIdx.x + i * NTHR >= XCH) break;  // no chunk
      const bool ok = xc[i] >= 0 && k0 + xc[i] < K;
      ct::cp_async16(xs + xd[i], ok ? xb + xo[i] : x, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < CI; ++i) {
      if (CCH % NTHR && threadIdx.x + i * NTHR >= CCH) break;
      const bool ok = cb[i] >= 0 && byte + cb[i] < row_bytes;
      ct::cp_async16(cs + cd[i], ok ? wb + co[i] : w, ok ? 16 : 0);
    }
    if (N & 3) {
      load_scales_narrow<NTHR>(ss, scales, N, K, n0, g16, kt);
    } else if (threadIdx.x < SCH) {
      const int u = kt * STEPS + sstep;  // 16-deep step
      const bool ok = u * 16 < K && n0 + scol < N;
      ct::cp_async16(ss + sstep * BN + scol,
                     scales + (ok ? (u / g16) * N + n0 + scol : 0),
                     ok ? 16 : 0);
    }
  }
};

// y[row, col .. col + 1] from two f32 values
__device__ __forceinline__ void store_pair(__nv_bfloat16* y, int M, int N,
                                           int row, int col, float v0,
                                           float v1) {
  if (row >= M || col >= N) return;
  __nv_bfloat16* dst = y + (size_t)row * N + col;
  if (col + 1 < N && !(N & 1)) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  } else {
    dst[0] = __float2bfloat16(v0);
    if (col + 1 < N) dst[1] = __float2bfloat16(v1);
  }
}

// Sums the cluster's f32 (BM, BN) tiles staged at red (row stride RED) in
// rank order, block r writing rows [r * per, (r + 1) * per) of y in bf16.
template <int NTHR, int BM>
__device__ __forceinline__ void cluster_reduce(float* red, __nv_bfloat16* y,
                                               int M, int N, int m0, int n0) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = min(BM, M - m0), per = (rows + splits - 1) / splits;
  const int r0 = rank * per, r1 = min(rows, r0 + per);
  for (int e = threadIdx.x; e < (r1 - r0) * (BN / 2); e += NTHR) {
    const int r = r0 + e / (BN / 2), c = 2 * (e % (BN / 2));
    float v0 = 0.f, v1 = 0.f;
    for (int j = 0; j < splits; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(
          cluster.map_shared_rank(red, j) + r * RED + c);
      v0 += v.x;
      v1 += v.y;
    }
    store_pair(y, M, N, m0 + r, n0 + c, v0, v1);
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// The prefill epilogue. Without a split each thread writes its accumulator
// fragments (acc[mt][nt]: rows row0 + 16 mt + g (+ 8), columns col0 + 8 nt
// + 2 t) in bf16; with a split the block stages its f32 tile in its own
// shared memory (the ring, now free) for the cluster's reduction.
template <int NTHR, int BM, int MT, int NT>
__device__ __forceinline__ void finish(float (&acc)[MT][NT][4], float* red,
                                       __nv_bfloat16* y, int M, int N, int m0,
                                       int n0, int row0, int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (gridDim.z == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store_pair(y, M, N, m0 + row0 + mt * 16 + g + 8 * h,
                     n0 + col0 + nt * 8 + 2 * t, acc[mt][nt][2 * h],
                     acc[mt][nt][2 * h + 1]);
    return;
  }
  ct::cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            red + (row0 + mt * 16 + g + 8 * h) * RED + col0 + nt * 8 + 2 * t) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  cluster_reduce<NTHR, BM>(red, y, M, N, m0, n0);
}

// acc[mt][nt] += part[mt][nt] * (the scale of each column, or 0 unless
// end): the end of a group (or of the split) in the int8 prefill; sc points
// at the scale row of the group's last step, at this thread's column 2 t
template <int MT, int NT>
__device__ __forceinline__ void flush_group(float (&acc)[MT][NT][4],
                                            float (&part)[MT][NT][4],
                                            const float* sc, bool end = true) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 s = end ? *reinterpret_cast<const float2*>(sc + nt * 8)
                         : make_float2(0.f, 0.f);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      acc[mt][nt][0] += part[mt][nt][0] * s.x;
      acc[mt][nt][1] += part[mt][nt][1] * s.y;
      acc[mt][nt][2] += part[mt][nt][2] * s.x;
      acc[mt][nt][3] += part[mt][nt][3] * s.y;
    }
  }
}

constexpr int DECODE_THREADS = 256;

// ---- prefill rows ----------------------------------------------------- //

// 128 x 128 tiles, 4 warpgroups (one block of 16 warps an SM: int8 holds
// a group partial beside its accumulator in registers)
template <class W>
struct PrefillCfg {
  static constexpr int BM = 128, THREADS = 512;
  static constexpr int CPT = BN * (BK / 8) / THREADS;  // k chunks a thread decodes
  static_assert(CPT == 2, "a thread decodes one 16-deep step of a row");
  static constexpr size_t X_BYTES = (size_t)BM * BK * 2;     // swizzled
  static constexpr size_t C_BYTES = (size_t)BN * W::kRowBytes;
  static constexpr size_t S_BYTES = (size_t)STEPS * BN * 4;
  static constexpr size_t STAGE = X_BYTES + C_BYTES + S_BYTES;
  static constexpr size_t B_BYTES = (size_t)BN * BK * 2;     // swizzled
  static constexpr size_t RING = PREFILL_STAGES * STAGE + 3 * B_BYTES;
  static constexpr size_t RED_BYTES = (size_t)BM * RED * 4;
  static constexpr size_t SMEM = RING > RED_BYTES ? RING : RED_BYTES;
  static_assert(STAGE % 1024 == 0, "swizzled tiles 1024-byte aligned");
};

// ---- prefill rows on wgmma ------------------------------------------- //

// d (+)= A (64 x 16 in registers: this warp's rows 16 w .. + 15, the
// mma.sync A fragment) . B (16 x 16, K-major in shared memory, db) over one
// warpgroup; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A (64 x 16 in registers: this warp's rows 16 w .. + 15, the
// mma.sync A fragment) . B (16 x 32, K-major in shared memory, db) over one
// warpgroup; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A (64 x 16 in registers: this warp's rows 16 w .. + 15, the
// mma.sync A fragment) . B (16 x 64, K-major in shared memory, db) over one
// warpgroup; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int BM>
__device__ __forceinline__ void wgmma_rs(float (&d)[BM / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (BM == 16) wgmma_m64n16k16_rs(d, a, db, scale_d);
  else if constexpr (BM == 32) wgmma_m64n32k16_rs(d, a, db, scale_d);
  else wgmma_m64n64k16_rs(d, a, db, scale_d);
}

// the four k16 steps of a k-tile: d (+)= A_s . B_s for s = 0 .. 3, A_s in
// registers (this warp's 16 rows), B_s (16 x 16, K-major, db[s]) in shared
// memory; scale_d = 0 overwrites d at the first step. One statement, fence
// included, reads all 16 A registers: every A register is defined before
// the fence, and none is reused while the wgmmas are in flight.
__device__ __forceinline__ void wgmma_tile_m64n16(float (&d)[8],
                                                 const uint32_t (&a)[4][4],
                                                 const uint64_t (&db)[4],
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %28, 0;\n"
      "wgmma.fence.sync.aligned;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %24, p, 1, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%12, %13, %14, %15}, %25, 1, 1, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%16, %17, %18, %19}, %26, 1, 1, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%20, %21, %22, %23}, %27, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
        "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
        "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),
        "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
        "l"(db[0]), "l"(db[1]), "l"(db[2]), "l"(db[3]), "r"(scale_d));
}

// the four k16 steps of a k-tile: d (+)= A_s . B_s for s = 0 .. 3, A_s in
// registers (this warp's 16 rows), B_s (16 x 32, K-major, db[s]) in shared
// memory; scale_d = 0 overwrites d at the first step. One statement, fence
// included, reads all 16 A registers: every A register is defined before
// the fence, and none is reused while the wgmmas are in flight.
__device__ __forceinline__ void wgmma_tile_m64n32(float (&d)[16],
                                                 const uint32_t (&a)[4][4],
                                                 const uint64_t (&db)[4],
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.fence.sync.aligned;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %32, p, 1, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%20, %21, %22, %23}, %33, 1, 1, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%24, %25, %26, %27}, %34, 1, 1, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%28, %29, %30, %31}, %35, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
        "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
        "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),
        "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
        "l"(db[0]), "l"(db[1]), "l"(db[2]), "l"(db[3]), "r"(scale_d));
}

// the four k16 steps of a k-tile: d (+)= A_s . B_s for s = 0 .. 3, A_s in
// registers (this warp's 16 rows), B_s (16 x 64, K-major, db[s]) in shared
// memory; scale_d = 0 overwrites d at the first step. One statement, fence
// included, reads all 16 A registers: every A register is defined before
// the fence, and none is reused while the wgmmas are in flight.
__device__ __forceinline__ void wgmma_tile_m64n64(float (&d)[32],
                                                 const uint32_t (&a)[4][4],
                                                 const uint64_t (&db)[4],
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %52, 0;\n"
      "wgmma.fence.sync.aligned;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %48, p, 1, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%36, %37, %38, %39}, %49, 1, 1, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%40, %41, %42, %43}, %50, 1, 1, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%44, %45, %46, %47}, %51, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
        "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
        "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),
        "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
        "l"(db[0]), "l"(db[1]), "l"(db[2]), "l"(db[3]), "r"(scale_d));
}

template <int BM>
__device__ __forceinline__ void wgmma_tile(float (&d)[BM / 2],
                                           const uint32_t (&a)[4][4],
                                           const uint64_t (&db)[4],
                                           int scale_d) {
  if constexpr (BM == 16) wgmma_tile_m64n16(d, a, db, scale_d);
  else if constexpr (BM == 32) wgmma_tile_m64n32(d, a, db, scale_d);
  else wgmma_tile_m64n64(d, a, db, scale_d);
}

// d (+)= A (64 x 16, K-major, da) . B (64 x 16, K-major, db) over one
// warpgroup; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
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

// 128 x 128 output tiles, 4 warpgroups of m64n64 (2 x 2). A 5-stage
// cp.async ring holds x, the codes and the scales, so each tile lands 3
// k-tiles before its decode needs it. In each k-tile the warpgroups issue
// their four k16 wgmmas (A: x, B: the decoded tile, both swizzled in
// shared memory) asynchronously and decode the next k-tile into the other
// B buffer while they run; int8 ends a segment of wgmmas at each group
// end, waits, and scales the group's partial into the accumulator (the
// next group overwrites the partial).
template <class W>
__global__ void __launch_bounds__(512, 1)
wna16_prefill_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                           const uint8_t* __restrict__ w,
                           const float* __restrict__ scales,  // (K/group, N)
                           __nv_bfloat16* __restrict__ y, int M, int N, int K,
                           int group, int tiles_per_split, int ny) {
  using C = PrefillCfg<W>;
  constexpr int S = PREFILL_STAGES, CPT = C::CPT;
  static_assert(C::THREADS == 512, "4 warpgroups");
  extern __shared__ __align__(1024) unsigned char smem[];
  {  // expert e's operands in the stacked (E, ...) buffers
    const size_t e = blockIdx.y / ny;
    x += e * M * K;
    w += e * N * (size_t)(K * W::kRowBytes / BK);
    scales += e * (size_t)(K / group) * N;
    y += e * M * N;
  }

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wgm = warp >> 3, wgn = (warp >> 2) & 1, wq = warp & 3;
  const int m0 = (blockIdx.y % ny) * C::BM, n0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, (K + BK - 1) / BK);
  const int k_end = min(kt1 * BK, K);
  const Loader<C::THREADS, C::BM, W> loader(
      x, w, scales, M, N, K, m0, n0, group,
      [](int r, int ch) { return swz(r, ch); }, W::kRowBytes);

  unsigned char* bdec = smem + S * C::STAGE;  // [3][BN x BK] bf16
  auto stage = [&](int st) { return smem + st * C::STAGE; };
  auto codes_of = [&](int st) { return stage(st) + C::X_BYTES; };
  auto scales_of = [&](int st) {
    return reinterpret_cast<const float*>(stage(st) + C::X_BYTES + C::C_BYTES);
  };
  auto load_tile = [&](int st, int kt) {
    unsigned char* base = stage(st);
    loader.load(base, base + C::X_BYTES,
                reinterpret_cast<float*>(base + C::X_BYTES + C::C_BYTES), kt);
  };
  const int dr = tid / (8 / CPT), dc = (tid % (8 / CPT)) * CPT;
  auto decode_tile = [&](int st, int buf) {
    unsigned char* dst = bdec + buf * C::B_BYTES;
    const uint8_t* cs = codes_of(st) + dr * W::kRowBytes;
    // fp4: the thread's two chunks (16 codes) are one 16-deep step, one
    // group: one table of its scaled values serves all 16
    Fp4Table table;
    if constexpr (W::kScaled) table = fp4_table(scales_of(st)[(dc >> 1) * BN + dr]);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = dc + j;
      uint4 out;
      if constexpr (W::kScaled) {
        out = fp4_decode_table(*reinterpret_cast<const uint32_t*>(cs + 4 * c),
                               table);
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(cs + 8 * c);
        out.x = i8_pair(v.x, 0x4140u);
        out.y = i8_pair(v.x, 0x4342u);
        out.z = i8_pair(v.y, 0x4140u);
        out.w = i8_pair(v.y, 0x4342u);
      }
      *reinterpret_cast<uint4*>(dst + swz(dr, c)) = out;
    }
    fence_async_smem();
  };

  float acc[1][8][4], part[1][8][4];
  float (&acc32)[32] = reinterpret_cast<float (&)[32]>(acc);
  float (&part32)[32] = reinterpret_cast<float (&)[32]>(part);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc32[i] = part32[i] = 0.f;
  // int8: steps (kTiled: k-tiles) left in the current group
  const int g16 = group / 16;
  int left = W::kTiled ? (g16 - (kt0 * STEPS) % g16) / STEPS
                       : g16 - (kt0 * STEPS) % g16;
  int live = 0;  // int8: the partial holds a started group
  const int t = lane & 3;

  // tiles kt0 .. kt0 + S - 3 in flight, the first decoded. Iteration kt
  // issues tile kt's wgmmas, decodes tile kt + 1 into the next of three B
  // buffers while they run, and leaves them in flight across the next
  // barrier (tile kt - 1's are waited on); its loads go to tile kt - 2's
  // stage, whose wgmmas every warpgroup has waited on before the barrier.
#pragma unroll
  for (int i = 0; i < S - 2; ++i) {
    if (kt0 + i < kt1) load_tile(i, kt0 + i);
    ct::cp_async_commit();
  }
  ct::cp_async_wait<S - 3>();
  fence_async_smem();
  __syncthreads();
  if (kt0 < kt1) decode_tile(0, 0);
  for (int kt = kt0, st = 0, bb = 0; kt < kt1;
       ++kt, st = st == S - 1 ? 0 : st + 1, bb = bb == 2 ? 0 : bb + 1) {
    ct::cp_async_wait<S - 4>();  // tile kt + 1 has landed
    fence_async_smem();
    __syncthreads();  // ... for all; tile kt decoded; kt - 2 done
    if (kt + S - 2 < kt1) load_tile((st + S - 2) % S, kt + S - 2);
    ct::cp_async_commit();

    const unsigned char* xs = stage(st) + wgm * 64 * 128;
    const unsigned char* bs = bdec + bb * C::B_BYTES + wgn * 64 * 128;
    const float* ss = scales_of(st);
    const int k0 = kt * BK;
    const int st1 = st == S - 1 ? 0 : st + 1, bb1 = bb == 2 ? 0 : bb + 1;
    if constexpr (W::kScaled) {
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < STEPS; ++s)
        wgmma_m64n64k16(acc32, wgmma_desc(xs + 32 * s),
                        wgmma_desc(bs + 32 * s), 1);
      wgmma_commit();
      if (kt + 1 < kt1) decode_tile(st1, bb1);
    } else {
      // as in the decode rows: every flush waits, with no branch around a
      // wgmma, and adds part * 0 where no group ends
      auto flush = [&](int s, bool end) {
        wgmma_wait0();
        fence_regs(part32);
        flush_group(acc, part, ss + s * BN + wgn * 64 + 2 * t, end);
        live = !end;
      };
      if constexpr (W::kTiled) {
        const bool end = --left == 0 || kt + 1 == kt1;
        if (end) left = g16 / STEPS;
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < STEPS; ++s)
          wgmma_m64n64k16(part32, wgmma_desc(xs + 32 * s),
                          wgmma_desc(bs + 32 * s), s ? 1 : live);
        wgmma_commit();
        if (kt + 1 < kt1) decode_tile(st1, bb1);
        flush(STEPS - 1, end);
      } else {
#pragma unroll
        for (int s = 0; s < STEPS; ++s) {
          const bool end = --left == 0 || k0 + s * 16 + 16 >= k_end;
          if (end) left = g16;
          wgmma_fence();
          wgmma_m64n64k16(part32, wgmma_desc(xs + 32 * s),
                          wgmma_desc(bs + 32 * s), live);
          wgmma_commit();
          if (s == 0 && kt + 1 < kt1) decode_tile(st1, bb1);
          flush(s, end);
        }
      }
    }
    wgmma_wait1();  // tile kt - 1's wgmmas are done
  }
  wgmma_wait0();
  fence_regs(acc32);
  finish<C::THREADS, C::BM, 1, 8>(acc, reinterpret_cast<float*>(smem), y, M,
                                  N, m0, n0, wgm * 64 + wq * 16, wgn * 64);
}

// ---- decode rows on wgmma -------------------------------------------- //

// The decode rows as y^T = W . x^T: each warp decodes its 16 weight rows
// (output columns) of a 16-deep step straight into the register A fragment
// of wgmma m64nBMk16 (a warpgroup: 64 weight rows), and x, the B operand,
// is read by the tensor cores from its swizzled tile in shared memory.
template <class W, int BM>
struct DecodeCfg {
  static constexpr int CS = W::kRowBytes + 16;   // code row stride (bytes)
  static constexpr size_t X_BYTES = (size_t)BM * BK * 2;  // swizzled
  static constexpr size_t C_BYTES = (size_t)BN * CS;
  static constexpr size_t S_BYTES = (size_t)STEPS * BN * 4;
  static constexpr size_t STAGE = X_BYTES + C_BYTES + S_BYTES;
  static constexpr size_t RING = DECODE_STAGES * STAGE;
  static constexpr size_t RED_BYTES = (size_t)BM * RED * 4;
  static constexpr size_t SMEM = RING > RED_BYTES ? RING : RED_BYTES;
  static_assert(STAGE % 1024 == 0, "swizzled tiles 1024-byte aligned");
};

template <class W, int BM>
__global__ void __launch_bounds__(DECODE_THREADS, 2)
wna16_decode_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                          const uint8_t* __restrict__ w,
                          const float* __restrict__ scales,  // (K/group, N)
                          __nv_bfloat16* __restrict__ y, int M, int N, int K,
                          int group, int tiles_per_split) {
  using C = DecodeCfg<W, BM>;
  constexpr int S = DECODE_STAGES, ND = BM / 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  {  // expert e's operands in the stacked (E, ...) buffers
    const size_t e = blockIdx.y;
    x += e * M * K;
    w += e * N * (size_t)(K * W::kRowBytes / BK);
    scales += e * (size_t)(K / group) * N;
    y += e * M * N;
  }

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, (K + BK - 1) / BK);
  const int k_end = min(kt1 * BK, K);
  const Loader<DECODE_THREADS, BM, W> loader(
      x, w, scales, M, N, K, 0, n0, group,
      [](int r, int ch) { return swz(r, ch); }, C::CS);
  auto stage = [&](int st) { return smem + st * C::STAGE; };
  auto load_tile = [&](int st, int kt) {
    unsigned char* base = stage(st);
    loader.load(base, base + C::X_BYTES,
                reinterpret_cast<float*>(base + C::X_BYTES + C::C_BYTES), kt);
  };

  // this lane's weight rows ncol and ncol + 8, and its byte selectors
  const int ncol = warp * 16 + g;
  const uint32_t p = 2 * (t & 1);
  const uint32_t sel8 = p | (4u << 4) | ((p + 1) << 8) | (4u << 12);
  const uint32_t sel4 = t | ((t + 4) << 4);

  // a tile's codes -> the A fragments of its four 16-deep steps:
  // a[s] = {(row g, k 2t..), (row g + 8, k 2t..), (row g, k 2t + 8..),
  // (row g + 8, k 2t + 8..)} of this warp's 16 rows
  auto decode = [&](int st, uint32_t (&a)[STEPS][4]) {
    const uint8_t* cs = stage(st) + C::X_BYTES;
    const float* ss = reinterpret_cast<const float*>(cs + C::C_BYTES);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows ncol, ncol + 8
      const uint8_t* row = cs + (ncol + 8 * h) * C::CS;
#pragma unroll
      for (int q = 0; q < STEPS / 2; ++q) {
        if constexpr (W::kScaled) {
          // bytes 32q .. 32q + 15 of the row: byte t of word i holds k
          // 8i + 2t, + 1 of steps 2q (words 0-1) and 2q + 1 (words 2-3)
          const uint4 raw = *reinterpret_cast<const uint4*>(row + q * 16);
          const uint32_t codes = prmt(prmt(raw.x, raw.y, sel4),
                                      prmt(raw.z, raw.w, sel4), 0x5410u);
          uint32_t out[4];
          fp4_decode(codes, ss[(2 * q) * BN + ncol + 8 * h],
                     ss[(2 * q + 1) * BN + ncol + 8 * h], out);
          a[2 * q][h] = out[0];
          a[2 * q][2 + h] = out[1];
          a[2 * q + 1][h] = out[2];
          a[2 * q + 1][2 + h] = out[3];
        } else {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const uint8_t* src = row + (2 * q + u) * 16 + 4 * (t >> 1);
            a[2 * q + u][h] =
                i8_pair(*reinterpret_cast<const uint32_t*>(src), sel8);
            a[2 * q + u][2 + h] =
                i8_pair(*reinterpret_cast<const uint32_t*>(src + 8), sel8);
          }
        }
      }
    }
  };

  float acc[ND], part[W::kScaled ? 1 : ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;
  if constexpr (!W::kScaled) {
#pragma unroll
    for (int i = 0; i < ND; ++i) part[i] = 0.f;
  }
  // int8: steps (kTiled: k-tiles) left in the current group
  const int g16 = group / 16;
  int left = W::kTiled ? (g16 - (kt0 * STEPS) % g16) / STEPS
                       : g16 - (kt0 * STEPS) % g16;
  int live = 0;  // int8: the partial holds a started group

  // tile kt at stage st: once tile kt - 1's wgmmas are done (ptxas
  // serializes every wgmma of the kernel if an A register is written while
  // one is in flight), its A fragments decoded into a and its four wgmmas
  // issued back to back (int8: waited on and scaled at each group end);
  // then, once tile kt + 1 has landed, tile kt + S - 1 into kt - 1's stage.
  // The SM's other blocks fill the tensor cores while a block decodes.
  uint32_t a[STEPS][4];
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (kt0 + i < kt1) load_tile(i, kt0 + i);
    ct::cp_async_commit();
  }
  ct::cp_async_wait<S - 2>();
  fence_async_smem();
  __syncthreads();
  for (int kt = kt0, st = 0; kt < kt1; ++kt, st = st == S - 1 ? 0 : st + 1) {
    wgmma_wait0();
    decode(st, a);
    const unsigned char* xs = stage(st);
    const float* ss = reinterpret_cast<const float*>(xs + C::X_BYTES +
                                                     C::C_BYTES);
    uint64_t db[STEPS];
#pragma unroll
    for (int s = 0; s < STEPS; ++s) db[s] = wgmma_desc(xs + 32 * s);
    if constexpr (W::kScaled) {
      wgmma_tile<BM>(acc, a, db, 1);
    } else {
      // the partial of the group (or the split's part of it) scales into
      // the accumulator after the step that ends it, with no branch around
      // a wgmma: every flush waits, and adds part * 0 where no group ends
      // (ptxas serializes the kernel's wgmmas at a divergent wait)
      auto flush = [&](int s, bool end) {
        wgmma_commit();
        wgmma_wait0();
        fence_regs(part);
        const float s0 = end ? ss[s * BN + ncol] : 0.f;
        const float s1 = end ? ss[s * BN + ncol + 8] : 0.f;
#pragma unroll
        for (int i = 0; i < ND; ++i) acc[i] += part[i] * (i & 2 ? s1 : s0);
        live = !end;
      };
      if constexpr (W::kTiled) {
        // groups end at tile ends: one flush a tile
        const bool end = --left == 0 || kt + 1 == kt1;
        if (end) left = g16 / STEPS;
        wgmma_tile<BM>(part, a, db, live);
        flush(STEPS - 1, end);
      } else {
#pragma unroll
        for (int s = 0; s < STEPS; ++s) {
          const bool end = --left == 0 || kt * BK + s * 16 + 16 >= k_end;
          if (end) left = g16;
          wgmma_fence();
          wgmma_rs<BM>(part, a[s], db[s], live);
          flush(s, end);
        }
      }
    }
    wgmma_commit();
    ct::cp_async_wait<S - 3>();  // tile kt + 1 has landed
    fence_async_smem();
    __syncthreads();  // ... for all; every warpgroup waited on tile kt - 1
    if (kt + S - 1 < kt1) load_tile(st == 0 ? S - 1 : st - 1, kt + S - 1);
    ct::cp_async_commit();
  }
  wgmma_wait0();
  fence_regs(acc);

  // element i of acc: batch row 8 (i / 4) + 2 t + (i & 1), weight row
  // ncol + 8 ((i >> 1) & 1)
  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int m = 8 * (i >> 2) + 2 * t + (i & 1);
      const int col = n0 + ncol + 8 * ((i >> 1) & 1);
      if (m < M && col < N) y[(size_t)m * N + col] = __float2bfloat16(acc[i]);
    }
    return;
  }
  ct::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < ND; ++i)
    red[(8 * (i >> 2) + 2 * t + (i & 1)) * RED + ncol + 8 * ((i >> 1) & 1)] =
        acc[i];
  cluster_reduce<DECODE_THREADS, BM>(red, y, M, N, 0, n0);
}

// ---- launch ----------------------------------------------------------- //

template <class W, int BM>
int launch_decode(const void* x, const void* w, const void* scales, void* y,
                  int E, int M, int N, int K, int group, int splits,
                  int tiles_per_split, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, E, splits);
  return launch<&wna16_decode_wgmma_kernel<W, BM>>(DecodeCfg<W, BM>::SMEM,
                                                  grid, DECODE_THREADS, s,
                static_cast<const __nv_bfloat16*>(x),
                static_cast<const uint8_t*>(w),
                static_cast<const float*>(scales),
                static_cast<__nv_bfloat16*>(y), M, N, K, group,
                tiles_per_split);
}

// E experts (1: one matrix); bm 16, 32 or 64 >= M (decode rows) or 128
// (prefill rows)
template <class W>
int launch_wna16(const void* x, const void* w, const void* scales, void* y,
                 int E, int M, int N, int K, int group, int bm, int splits,
                 int tiles_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ny = (M + 127) / 128;
  if (splits < 1 || splits > 8 || group % 16 || (bm <= 64 && M > bm) ||
      E < 1 || E > 65535 || (E > 1 && K % group) ||
      (bm == 128 && (long long)ny * E > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bm) {
    case 16: return launch_decode<W, 16>(x, w, scales, y, E, M, N, K, group,
                                         splits, tiles_per_split, s);
    case 32: return launch_decode<W, 32>(x, w, scales, y, E, M, N, K, group,
                                         splits, tiles_per_split, s);
    case 64: return launch_decode<W, 64>(x, w, scales, y, E, M, N, K, group,
                                         splits, tiles_per_split, s);
    case 128: {
      dim3 grid((N + BN - 1) / BN, ny * E, splits);
      return launch<&wna16_prefill_wgmma_kernel<W>>(PrefillCfg<W>::SMEM, grid,
                                                   PrefillCfg<W>::THREADS, s,
                    static_cast<const __nv_bfloat16*>(x),
                    static_cast<const uint8_t*>(w),
                    static_cast<const float*>(scales),
                    static_cast<__nv_bfloat16*>(y), M, N, K, group,
                    tiles_per_split, ny);
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int w4_e8(const void* x, const void* w, const void* scales, void* y, int E,
          int M, int N, int K, int group, int bm, int splits,
          int tiles_per_split, void* stream) {
  return group % BK
      ? launch_wna16<Int8<false>>(x, w, scales, y, E, M, N, K, group, bm,
                                  splits, tiles_per_split, stream)
      : launch_wna16<Int8<true>>(x, w, scales, y, E, M, N, K, group, bm,
                                 splits, tiles_per_split, stream);
}

}  // namespace

// Mode fp4. x (M, K) bf16; codes (N, K/2) uint8; scales (K/group, N) f32;
// y (M, N) bf16. K % 32 == 0, group % 16 == 0. bm: 16, 32 or 64 (decode
// rows, M <= bm) or 128 (prefill rows); splits (1-8) blocks of a cluster
// share K, tiles_per_split 64-deep k-tiles each.
extern "C" int ct_w4a16_fp4_matmul(const void* x, const void* codes,
                                   const void* scales, void* y, int M, int N,
                                   int K, int group, int bm, int splits,
                                   int tiles_per_split, void* stream) {
  return launch_wna16<Fp4>(x, codes, scales, y, 1, M, N, K, group, bm, splits,
                           tiles_per_split, stream);
}

// Grouped int8. x (M, K) bf16; w (N, K) int8; scales (K/group, N) f32;
// y and the rest as above. K % 16 == 0, group % 16 == 0.
extern "C" int ct_w4_e8_matmul(const void* x, const void* w, const void* scales,
                               void* y, int M, int N, int K, int group, int bm,
                               int splits, int tiles_per_split, void* stream) {
  return w4_e8(x, w, scales, y, 1, M, N, K, group, bm, splits,
               tiles_per_split, stream);
}

// Grouped int8 over E experts in one launch: x (E, M, K) bf16, w (E, N, K)
// int8, scales (E, K/group, N) f32, y (E, M, N) bf16, each stacked
// contiguously; K % group == 0; the plan as above for M rows and E
// experts.
extern "C" int ct_w4_e8_matmul_experts(const void* x, const void* w,
                                       const void* scales, void* y, int E,
                                       int M, int N, int K, int group, int bm,
                                       int splits, int tiles_per_split,
                                       void* stream) {
  return w4_e8(x, w, scales, y, E, M, N, K, group, bm, splits,
               tiles_per_split, stream);
}
