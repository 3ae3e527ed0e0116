// Latent-head decode attention for Hopper (MLA, DeepSeek V2/V3): one kernel
// body templated on PAGED and the cache type, two entry points, B5-L on the
// dense slab cache and B7-L on the paged pool, and a merge pass.
//
// Replaces compressed_tensors_tpu/ops/kernels/decode_attention.py:
// decode_attention and compressed_tensors_tpu/ops/kernels/paged_decode.py:
// paged_decode_attention at the call shape of compressed_tensors_tpu/
// models/mla.py:144-165 (kvh=1, rep=h, d=Dp, true_d=nope+rope): the
// absorbed MLA decode step, h query heads over one latent head whose K rows
// are [c_kv ; k_pe] (Dk wide, 576 for DeepSeek-V2/V3) and V rows c_kv (Dv
// wide, 512). Position p of row b is at b * S_pad + p of the slab cache
// (L, B, 1, S_pad, D), or at p % page of pool page tables[b, p / page] of
// the pool (L, NP, 1, page, D); only positions 0..lengths[b] are touched.
//
// Bound on the H100: the live cache bytes, sum(len + 1) * (Dk + Dv) *
// sizeof(cache element) per layer, against 3.35 TB/s. The products are
// 2 h (Dk + Dv) operations a position (128 heads: 9 us at the bf16 peak for
// a 26 us byte bound), so they stay on the tensor cores. The design, by
// the five things that held the single-tile kernel it replaces:
//   1. (one 4-warp block an SM, nothing hiding its stalls; option (a)) A
//      block of 2 consumer warpgroups and a producer warpgroup holds up to
//      64 query heads as one wgmma M = 64 tile (DeepSeek-V2's 128: two head
//      blocks), so a K/V tile reaches shared memory once per (row, head
//      block) whatever the head count, where 16-head groups fetched it 8
//      times at 128 heads. The head blocks of one range are neighbouring
//      blocks that stream the same rows at the same pace, the second read
//      served by L2 (a TMA multicast to a cluster of the two would save
//      that L2 read; not taken: the head block's own loads fill the SM).
//      Fewer than 64 heads keep only round_up(h, 8) rows of q in shared
//      memory: the descriptor's rows past them read the next 64-column
//      chunk of q (finite values whose output rows are never stored).
//   2. (the compute threads issued every copy; option (b)) One producer
//      warp issues TMA loads through tensor maps over the cache's rows
//      (slab: its L * B * S_pad rows; pool: its L * NP * page rows, a
//      16-position tile lying in one page) seen as (64 columns, row,
//      64-column chunk): one box of 16 positions and all chunks for K and
//      one for V a tile, into a ring of 3-8 stages (as many as shared
//      memory holds) signalled by mbarriers (full: the bytes landed;
//      empty: the 8 consumer warps are done). q (64 rows at most, all
//      chunks) comes the same way at a segment's first tile, behind a
//      q-empty barrier the consumers arrive on after the segment's last
//      scores. No block-wide barrier runs per tile: the two consumer
//      warpgroups meet at one named barrier a tile, to add their score
//      partials, and at another only in the tile that takes the step's
//      row (bf16).
//   3. (V fragments built from scalars; option (c)) V is the wgmma B
//      operand in place, MN-major (the transposed descriptor) over the
//      128-byte-swizzled tile the TMA wrote; P is the A operand from
//      registers (the S accumulators rounded to bf16). An 8-bit tile
//      (e4m3 or int8, no swizzle) is widened once, exactly, into a bf16
//      staging tile of the same swizzled layout: each warpgroup widens the
//      columns it reads itself, so one staging tile and a barrier of its
//      own four warps suffice.
//   4. (splits fixed by the capacity; option (d)) Splits follow the live
//      work, with no host read of lengths: a persistent grid of R ranges
//      (R = SMs / head blocks) times the head blocks. The T live tiles
//      (min(len, S_pad) / 16 + 1 a row, row after row) are cut into R
//      contiguous ranges floor(r T / R) .. floor((r + 1) T / R), each range
//      one block (per head block) that walks its tiles row by row; every
//      SM gets T / R tiles, the greedy S_pad-192 case included. A row's
//      part inside one range is a segment: one online softmax over its
//      tiles in order.
//   5. (8 fetches a tile at 128 heads, and partials from every split;
//      option (e)) A segment that is a whole row writes the row's output;
//      the others (at most two a range: its first and its last) write f32
//      partials (max, sum, unnormalized output), which the merge pass
//      combines in range order for the rows a range boundary cuts, and it
//      writes zeros for inactive rows. At 128 heads R halves, so each row
//      takes fewer segments.
// Within a block the two consumer warpgroups split S = Q K^T (the 64 rows
// by the tile's 16 positions, m64n16k16) by k-steps, half each, and add the
// two f32 partials in one order through shared memory; both run the same
// online softmax, and each owns half of the output's 64-column chunks
// (m64n64k16 a chunk, 4 chunks = 128 f32 registers a thread at Dv 512;
// setmaxnreg gives the consumers 232 registers and the producer 40).
// DeepSeek's widths (576, 512) have their own instantiation with the score
// loop unrolled; other widths run the same body with run-time chunk counts.
// A row with a negative length is inactive: its output is zero and no
// cache byte of it is read or written. The step's K/V rows are written in
// place at position lengths[b] (when below S_pad) by head block 0's block
// whose range holds the row's last tile; every block puts the same values
// into its own copy of that tile, and zeros into the V rows past it.
//
// Arithmetic as the TPU kernels: a bf16 cache holds the rows as they are;
// an e4m3 or int8 cache holds x / scale (per-tensor scales), read back with
// a raw conversion, k_scale folded into q (q * k_scale rounded to bf16) and
// v_scale onto the normalized f32 output. Scores are bf16 q . bf16 k summed
// in f32, times inv_sqrt_d = 1/sqrt(true_d); the online softmax runs in
// f32 over tiles of 16 positions, each tile's unnormalized probabilities
// rounded to bf16 against the running max before P.V, their f32 sum
// dividing; segments merge by their maxima in range order.
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int TILE = 16;               // positions a tile
constexpr int HB = 64;                 // query heads a block (wgmma M)
constexpr int CONSUMERS = 256;         // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup (one warp works)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // setmaxnreg
constexpr int MAX_D = 640;             // widest K row
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory a block
constexpr int CTRL = 1024;             // barriers and tile metadata
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_COLS = 64;         // output columns a merge block

// tile metadata flags
constexpr int F_FIRST = 1;     // a segment's first tile: load q, reset the softmax
constexpr int F_LAST = 2;      // a segment's last tile: write its result
constexpr int F_WHOLE = 4;     // that segment is the whole row
constexpr int F_ROW_END = 8;   // the tile holds position min(len, S_pad)
constexpr int F_WRITE = 16;    // and the step's rows go to the cache there
constexpr int F_SLOT1 = 32;    // the range's second partial slot

// ---- clock64() phase stamps, compiled only with -DCT_LATENT_STAMPS ---- //
// (tools/latent_stamps.py builds that variant into its own library)
enum {
  ST_C_WAIT, ST_C_Q, ST_C_PREP, ST_C_S, ST_C_SOFT, ST_C_PV, ST_C_FIN, ST_C_TOTAL,
  ST_C_UNITS, ST_P_SCHED, ST_P_EMPTY, ST_P_ISSUE, ST_P_TOTAL, ST_P_UNITS,
  ST_TILES, ST_SEGS, ST_MERGE, ST_M_BLOCKS, ST_N
};
#ifdef CT_LATENT_STAMPS
__device__ unsigned long long g_stamps[ST_N];
const char* const kStampNames =
    "full wait,q load,widen/patch,S = QK^T,softmax,P.V,finalize,total,"
    "consumer units,schedule,empty wait,issue,producer total,producer units,"
    "tiles,segments,merge,merge blocks";
struct Stamps {
  unsigned long long acc[ST_N] = {}, t0, t;
  bool on;
  __device__ explicit Stamps(bool on_) : on(on_) { t0 = t = clock64(); }
  __device__ void mark(int i) {
    if (!on) return;
    const unsigned long long n = clock64();
    acc[i] += n - t;
    t = n;
  }
  __device__ void add(int i, unsigned long long v) {
    if (on) acc[i] += v;
  }
  __device__ void flush(int total) {
    if (!on) return;
    if (total >= 0) acc[total] = clock64() - t0;
    for (int i = 0; i < ST_N; ++i)
      if (acc[i]) atomicAdd(&g_stamps[i], acc[i]);
  }
};
#else
struct Stamps {
  __device__ explicit Stamps(bool) {}
  __device__ void mark(int) {}
  __device__ void add(int, unsigned long long) {}
  __device__ void flush(int) {}
};
#endif

// ---- mbarriers, TMA, named barriers ------------------------------------ //

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// the box of a (column, row, 64-column chunk) tensor map at row `row`
// (all its chunks) into shared memory at dst, its bytes counted on the
// mbarrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int row,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row)
      : "memory");
}
// the 256 consumer threads (named barrier 1; the producer never joins it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// ---- wgmma ----------------------------------------------------------- //

// d (+)= Q (64 x 16, K-major, da) . K^T (16 positions x 16, K-major, db)
__device__ __forceinline__ void wgmma_scores(float (&d)[8], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += P (64 x 16 positions, bf16 registers) . V (16 positions x 64
// columns, MN-major, db)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// descriptor of an MN-major operand: 64 columns (128 bytes) by rows of
// the K dimension, 128-byte-swizzled, 8-row groups 1024 bytes apart (the
// leading offset is set to the same 1024: one 64-column block is read)
__device__ __forceinline__ uint64_t wgmma_desc_mn(const void* tile) {
  const uint32_t addr = ct::smem_addr(tile);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// ---- the schedule ---------------------------------------------------- //

// tiles of a row: positions 0..min(len, capacity), 0 for an inactive row
__device__ __forceinline__ int row_tiles(const int* lengths, int b, int capacity) {
  const int len = lengths[b];
  return len < 0 ? 0 : min(len, capacity) / TILE + 1;
}
// the range holding global tile x: the largest r with floor(r T / R) <= x
__device__ __forceinline__ int range_of(long long x, long long T, int R) {
  return (int)(((x + 1) * R - 1) / T);
}

// ---- the shared memory of a block ------------------------------------- //

// bytes of the score partials the two consumer warpgroups exchange: two
// tile parities x two warpgroups x 128 threads x 8 f32
constexpr int XS_BYTES = 2 * 2 * 128 * 8 * 4;

struct Layout {
  int nkc, nvc;          // 64-column chunks of K and V rows
  int rows;              // rows of q kept (round_up(min(H, 64), 8))
  int qchunk;            // bytes of one 64-column chunk of q
  int kchunk;            // bytes of one 64-column chunk of a ring tile
  size_t q_off, xs_off, ring_off, stage, stg_off, stg_size, total;
  int stages;
  __host__ __device__ Layout(int dk, int dv, int isz, int H) {  // isz: cache bytes
    nkc = dk / 64;
    nvc = dv / 64;
    const int h = H < HB ? H : HB;
    rows = (h + 7) / 8 * 8;
    qchunk = rows * 128;
    kchunk = TILE * 64 * isz;  // 2 KB bf16 (128-byte rows), 1 KB 8-bit
    q_off = CTRL;
    // q's chunks, then the rows the last chunk's descriptor reads past it
    const size_t qbytes = (size_t)nkc * qchunk + (size_t)(HB - rows) * 128;
    xs_off = q_off + (qbytes + 1023) / 1024 * 1024;
    ring_off = xs_off + XS_BYTES;
    stage = (size_t)(nkc + nvc) * kchunk;
    // a bf16 tile, and for an odd V chunk count warpgroup 1's own copy of
    // the middle chunk that both warpgroups read
    stg_size = isz == 2 ? 0 : (size_t)(nkc + nvc + (nvc & 1)) * TILE * 128;
    const size_t fixed = ring_off + stg_size + 1024;  // + alignment slack
    const long long room = (long long)SMEM_LIMIT - (long long)fixed;
    stages = room > 0 ? (int)(room / (long long)stage) : 0;
    if (stages > MAX_STAGES) stages = MAX_STAGES;
    stg_off = ring_off + (size_t)stages * stage;
    total = stg_off + stg_size + 1024;
  }
};

struct Meta {
  int b, t, flags, cached;
};

// 16 e4m3 / int8 codes (one 16-byte word) as 16 bf16 (two words), exact
// (bf16 tiles are read in place: never called for them)
template <int KIND>
__device__ __forceinline__ void widen16(uint4 in, uint4& lo, uint4& hi) {
  if constexpr (KIND == ct::kCacheBF16) {
    lo = hi = in;
  } else {
    using C = ct::Cache<KIND>;
    const uint32_t w[4] = {in.x, in.y, in.z, in.w};
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = C::widen2(w[i] & 0xffffu);
      o[2 * i + 1] = C::widen2(w[i] >> 16);
    }
    lo = make_uint4(o[0], o[1], o[2], o[3]);
    hi = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// NKC: the 64-column chunks of a K row when fixed at compile time (9:
// DeepSeek's 576; the S loop fully unrolled, its wgmmas pipelined), or 0
// (Dk / 64 at run time). NCH: the 64-column output chunks each consumer
// warpgroup owns, ceil(Dv / 128): warpgroup 0 takes chunks 0..NCH-1,
// warpgroup 1 the last NCH (for an odd count both compute the middle
// chunk, warpgroup 0 writes it), so both issue the same wgmmas
template <bool PAGED, int KIND, int NKC, int NCH>
__global__ void __launch_bounds__(THREADS, 1)
latent_kernel(const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              const __grid_constant__ CUtensorMap map_q,
              const __nv_bfloat16* __restrict__ q,      // (B, H, Dk)
              const __nv_bfloat16* __restrict__ new_k,  // (B, 1, Dk)
              const __nv_bfloat16* __restrict__ new_v,  // (B, 1, Dv)
              typename ct::Cache<KIND>::T* __restrict__ cache_k,  // slab or pool
              typename ct::Cache<KIND>::T* __restrict__ cache_v,
              const int* __restrict__ tables,           // (B, table_width) or null
              const int* __restrict__ lengths,          // (B,)
              __nv_bfloat16* __restrict__ out,          // (B, H, Dv)
              float2* __restrict__ part_ml,             // (blocks * 2, 64)
              float* __restrict__ part_o,               // (blocks * 2, 64, Dv)
              int* __restrict__ prefix,                 // (B + 1,)
              const float* __restrict__ k_scale,        // (1,), scaled caches
              const float* __restrict__ v_scale, int B, int H, int Dk, int Dv,
              int layer, int page, int capacity, int table_width, int num_pages,
              int ranges, float inv_sqrt_d) {
  using C = ct::Cache<KIND>;
  using T = typename C::T;
  constexpr bool WIDE = KIND != ct::kCacheBF16;  // 8-bit tiles, widened
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (ct::smem_addr(smem_raw) & 1023)) & 1023);
  const Layout lay(Dk, Dv, sizeof(T), H);
  const int S = lay.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* q_full = empty + MAX_STAGES;  // q of a segment landed
  uint64_t* q_empty = q_full + 1;         // the 8 consumer warps are done with q
  Meta* meta = reinterpret_cast<Meta*>(q_empty + 1);
  unsigned char* qs = smem + lay.q_off;
  unsigned char* ring = smem + lay.ring_off;
  unsigned char* stg = smem + lay.stg_off;
  float* xs = reinterpret_cast<float*>(smem + lay.xs_off);

  const int n_hb = (H + HB - 1) / HB;
  const int hb = blockIdx.x % n_hb, r = blockIdx.x / n_hb;
  const int h0 = hb * HB, hn = min(HB, H - h0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(ct::smem_addr(full + s), 1);
      mbar_init(ct::smem_addr(empty + s), CONSUMERS / 32);
    }
    mbar_init(ct::smem_addr(q_full), 1);
    mbar_init(ct::smem_addr(q_empty), CONSUMERS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // ====================== the producer warpgroup ====================== //
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp != CONSUMERS / 32) return;  // one warp issues the copies
    Stamps st(lane == 0);
    // T, the live tiles of all rows (block 0 writes the row prefix sums
    // the merge pass reads); a lane keeps the tile counts of its first 4
    // rows of 32 for the second pass
    constexpr int KEPT = 4;
    int kept[KEPT];
#pragma unroll
    for (int u = 0; u < KEPT; ++u)  // loaded together, one latency
      kept[u] = 32 * u + lane < B ? row_tiles(lengths, 32 * u + lane, capacity) : 0;
    long long T = 0;
    for (int b0 = 0, k = 0; b0 < B; b0 += 32, ++k) {
      const int b = b0 + lane;
      int n = 0;
#pragma unroll
      for (int u = 0; u < KEPT; ++u)
        if (u == k) n = kept[u];
      if (k >= KEPT) n = b < B ? row_tiles(lengths, b, capacity) : 0;
      int incl = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      if (blockIdx.x == 0 && b < B) prefix[b] = (int)(T + incl - n);
      T += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (blockIdx.x == 0 && lane == 0) prefix[B] = (int)T;
    const long long lo = (long long)r * T / ranges;
    const long long hi = (long long)(r + 1) * T / ranges;
    // the row holding tile lo, and lo's tile in it
    int b = 0, t = 0;
    if (lo < hi) {
      long long acc = 0;
      for (int b0 = 0, k = 0; b0 < B; b0 += 32, ++k) {
        const int bb = b0 + lane;
        int n = 0;
#pragma unroll
        for (int u = 0; u < KEPT; ++u)
          if (u == k) n = kept[u];
        if (k >= KEPT) n = bb < B ? row_tiles(lengths, bb, capacity) : 0;
        int incl = n;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += v;
        }
        const bool hit = n > 0 && acc + incl - n <= lo && lo < acc + incl;
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (m) {
          const int src = __ffs(m) - 1;
          b = b0 + src;
          t = (int)(lo - acc - __shfl_sync(0xffffffffu, incl - n, src));
          break;
        }
        acc += __shfl_sync(0xffffffffu, incl, 31);
      }
    }
    st.mark(ST_P_SCHED);
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_k))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_v))
                   : "memory");
      const uint32_t tile_bytes = (uint32_t)lay.stage;
      const uint32_t q_bytes = (uint32_t)(lay.nkc * lay.qchunk);
      int stage = 0;
      uint32_t phase = 0, q_phase = 0;
      int n_b = lo < hi ? row_tiles(lengths, b, capacity) : 0;
      int len = lo < hi ? lengths[b] : 0;
      bool first = true;
      int seg_t0 = t;
      long long seg_x0 = lo;
      int page_c = -1, page_id = 0;
      for (long long x = lo; x < hi; ++x) {
        if (t == n_b) {  // the next active row
          do {
            ++b;
            n_b = row_tiles(lengths, b, capacity);
          } while (n_b == 0);
          len = lengths[b];
          t = 0;
          first = true;
          page_c = -1;
        }
        if (first) {  // the segment's q, once the last segment's is used
          seg_t0 = t;
          seg_x0 = x;
          st.add(ST_SEGS, 1);
          mbar_wait(ct::smem_addr(q_empty), q_phase ^ 1);
          mbar_expect(ct::smem_addr(q_full), q_bytes);
          tma_load(ct::smem_addr(qs), &map_q, b * H + h0, ct::smem_addr(q_full));
          q_phase ^= 1;
        }
        const bool row_end = t == n_b - 1, seg_end = row_end || x == hi - 1;
        int flags = (first ? F_FIRST : 0) | (seg_end ? F_LAST : 0) |
                    (row_end ? F_ROW_END : 0);
        if (seg_end && seg_t0 == 0 && row_end) flags |= F_WHOLE;
        if (seg_x0 != lo) flags |= F_SLOT1;
        if (row_end && hb == 0 && len < capacity) flags |= F_WRITE;
        // the tile's first row in the tensor maps
        const int p0 = t * TILE;
        int row;
        if (PAGED) {
          const int c = p0 / page;
          if (c != page_c) {
            page_c = c;
            page_id = tables[(size_t)b * table_width + c];
          }
          row = (layer * num_pages + page_id) * page + (p0 - c * page);
        } else {
          row = (layer * B + b) * capacity + p0;
        }
        mbar_wait(ct::smem_addr(empty + stage), phase ^ 1);
        st.mark(ST_P_EMPTY);
        meta[stage] = Meta{b, t, flags, min(len, capacity)};
        const uint32_t bar = ct::smem_addr(full + stage);
        mbar_expect(bar, tile_bytes);
        const uint32_t dst = ct::smem_addr(ring + (size_t)stage * lay.stage);
        tma_load(dst, &map_k, row, bar);
        tma_load(dst + lay.nkc * lay.kchunk, &map_v, row, bar);
        st.mark(ST_P_ISSUE);
        st.add(ST_TILES, 1);
        first = false;
        ++t;
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      // the end: a tile with no bytes and row -1
      mbar_wait(ct::smem_addr(empty + stage), phase ^ 1);
      meta[stage] = Meta{-1, 0, 0, 0};
      mbar_arrive(ct::smem_addr(full + stage));
      st.add(ST_P_UNITS, 1);
      st.flush(ST_P_TOTAL);
    }
    return;
  }

  // ======================= the consumer warpgroups ===================== //
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  Stamps st(tid == 0);
  const int wg = tid >> 7, wq = (tid >> 5) & 3;  // warpgroup, its warp
  const int tw = tid & 127;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = 16 * wq + g;                    // rows r0, r0 + 8
  const int c_base = wg ? lay.nvc - NCH : 0;     // this warpgroup's chunks
  const int c_write = wg ? NCH : 0;              // the first chunk it writes
  const int steps = 2 * (NKC ? NKC : lay.nkc);   // k-steps of S a warpgroup
  // staging slot of this warpgroup's V chunk i: warpgroup 1 keeps its own
  // copy of a middle chunk both read (odd chunk count)
  const bool own_mid = wg && (lay.nvc & 1);
  auto v_slot = [&](int i) { return own_mid && i == 0 ? lay.nvc : c_base + i; };
  const float sk = C::kScaled ? k_scale[0] : 1.f;
  const float sv = C::kScaled ? v_scale[0] : 1.f;
  // this warpgroup's four warps (named barrier 2 + wg)
  auto wg_sync = [&]() { asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory"); };

  // An 8-bit tile widened into the bf16 staging tile (64-byte rows of a
  // 64-column chunk -> the swizzled 128-byte rows), each warpgroup the
  // columns it reads itself (its k-steps' half of K and its V chunks), so
  // it rewrites them once its own last reads are done and syncs only its
  // own warps; in the row's last tile the step's row from new_k / new_v
  // and zeros past it. Then the ring stage is released.
  auto widen_mine = [&](int stg_stage, const Meta& m, unsigned char* dst) {
    const unsigned char* src_tile = ring + (size_t)stg_stage * lay.stage;
    const int kw = steps;  // 16-column words of K this warpgroup reads
    const int items = (kw + NCH * 4) * TILE;
    const bool row_end = m.flags & F_ROW_END;
    const int rnew = m.cached - m.t * TILE;
    for (int i = tw; i < items; i += 128) {
      const int rr = i & (TILE - 1), wi = i >> 4;
      int c, w, slot;  // source chunk in the tile, word, staging chunk
      if (wi < kw) {
        c = slot = (wg * kw + wi) >> 2;
        w = (wg * kw + wi) & 3;
      } else {
        c = lay.nkc + c_base + ((wi - kw) >> 2);
        slot = lay.nkc + v_slot((wi - kw) >> 2);
        w = (wi - kw) & 3;
      }
      uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
      if (!row_end || rr < rnew) {
        widen16<KIND>(
            *reinterpret_cast<const uint4*>(src_tile + c * lay.kchunk + rr * 64 + w * 16), lo,
            hi);
      } else if (rr == rnew) {
        const bool is_k = c < lay.nkc;
        const __nv_bfloat16* src = is_k ? new_k + (size_t)m.b * Dk + c * 64
                                        : new_v + (size_t)m.b * Dv + (c - lay.nkc) * 64;
        const float sc = is_k ? sk : sv;
        uint32_t codes[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t word = 0;
#pragma unroll
          for (int u = 0; u < 4; ++u)
            word |= (uint32_t)(uint8_t)C::from_new(src[w * 16 + 4 * e + u], sc) << (8 * u);
          codes[e] = word;
        }
        widen16<KIND>(make_uint4(codes[0], codes[1], codes[2], codes[3]), lo, hi);
      }  // rows past the step's row: zeros (K's scores are masked too)
      unsigned char* dchunk = dst + slot * (TILE * 128);
      *reinterpret_cast<uint4*>(dchunk + ct::swz(rr, 2 * w)) = lo;
      *reinterpret_cast<uint4*>(dchunk + ct::swz(rr, 2 * w + 1)) = hi;
    }
    ct::fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(ct::smem_addr(empty + stg_stage));  // stage read
  };

  // zeroed once; a segment's first tile scales them by alpha = 0
  float o[NCH][32];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  int stage = 0, n = 0;
  uint32_t phase = 0, q_phase = 0;
  mbar_wait(ct::smem_addr(full + stage), phase);
  Meta mt = meta[stage];
  st.mark(ST_C_WAIT);
  while (mt.b >= 0) {
    const int b = mt.b, flags = mt.flags, cached = mt.cached;
    const int rnew = cached - mt.t * TILE;  // the step's row in this tile
    unsigned char* kt = ring + (size_t)stage * lay.stage;
    unsigned char* vt = kt + (size_t)lay.nkc * lay.kchunk;

    if (flags & F_FIRST) {  // q of (b, head block), from the producer's TMA
      mbar_wait(ct::smem_addr(q_full), q_phase);
      q_phase ^= 1;
      if (C::kScaled) {  // k_scale folded into this warpgroup's k-steps of q
        const int items = steps * 2 * lay.rows;
        for (int i = tw; i < items; i += 128) {
          const int rr = i % lay.rows, rest = i / lay.rows;
          const int ks = wg * steps + (rest >> 1), j = 2 * (ks & 3) + (rest & 1);
          uint4* w = reinterpret_cast<uint4*>(qs + (ks >> 2) * lay.qchunk + ct::swz(rr, j));
          uint4 v = *w;
          uint32_t* e4 = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&e4[e]));
            e4[e] = ct::pack_bf16x2(f.x * sk, f.y * sk);
          }
          *w = v;
        }
        ct::fence_async_smem();  // synced with the tile's widening below
      }
      m_run[0] = m_run[1] = -INFINITY;
      l_run[0] = l_run[1] = 0.f;
      st.mark(ST_C_Q);
    }

    // the step's rows written to the cache (head block 0's block)
    if (flags & F_WRITE) {
      size_t ok, ov;
      if (PAGED) {
        const int pid = tables[(size_t)b * table_width + cached / page];
        const size_t base = ((size_t)layer * num_pages + pid) * page + cached % page;
        ok = base * Dk;
        ov = base * Dv;
      } else {
        const size_t base = ((size_t)layer * B + b) * capacity + cached;
        ok = base * Dk;
        ov = base * Dv;
      }
      for (int d = tid; d < Dk; d += CONSUMERS)
        cache_k[ok + d] = C::from_new(new_k[(size_t)b * Dk + d], sk);
      for (int d = tid; d < Dv; d += CONSUMERS)
        cache_v[ov + d] = C::from_new(new_v[(size_t)b * Dv + d], sv);
    }

    const unsigned char* ksrc = WIDE ? stg : kt;
    const unsigned char* vsrc = WIDE ? stg + (size_t)lay.nkc * TILE * 128 : vt;
    if (WIDE) {  // this warpgroup's columns of the 8-bit tile, widened
      widen_mine(stage, mt, stg);
      wg_sync();
      st.mark(ST_C_PREP);
    } else if (flags & F_ROW_END) {
      // the step's row into the tile (the cache may not hold it yet), and
      // zeros in the V rows past it
      const int kp = lay.nkc * 8, vp = lay.nvc * 8;
      const int zero_rows = TILE - 1 - rnew;
      const int items = kp + vp + zero_rows * vp;
      for (int i = tid; i < items; i += CONSUMERS) {
        if (i < kp) {
          const int c = i >> 3, j = i & 7;
          *reinterpret_cast<uint4*>(kt + c * lay.kchunk + ct::swz(rnew, j)) =
              *reinterpret_cast<const uint4*>(new_k + (size_t)b * Dk + c * 64 + j * 8);
        } else if (i < kp + vp) {
          const int c = (i - kp) >> 3, j = (i - kp) & 7;
          *reinterpret_cast<uint4*>(vt + c * lay.kchunk + ct::swz(rnew, j)) =
              *reinterpret_cast<const uint4*>(new_v + (size_t)b * Dv + c * 64 + j * 8);
        } else {
          const int z = i - kp - vp, rr = rnew + 1 + z / vp, rem = z % vp;
          *reinterpret_cast<uint4*>(vt + (rem >> 3) * lay.kchunk + ct::swz(rr, rem & 7)) =
              make_uint4(0u, 0u, 0u, 0u);
        }
      }
      ct::fence_async_smem();
      consumers_sync();
      st.mark(ST_C_PREP);
    }

    // S = Q K^T over the block's 64 rows and the tile's 16 positions: each
    // warpgroup sums half of the row's 16-column k-steps, and both add
    // the two partials in one order (warpgroup 0's + warpgroup 1's)
    float s[8];
    ct::wgmma_fence();
    {
      const int kb = WIDE ? TILE * 128 : lay.kchunk;  // bytes a K chunk
#pragma unroll
      for (int i = 0; i < steps; ++i) {
        const int ks = wg * steps + i, c = ks >> 2, off = 32 * (ks & 3);
        wgmma_scores(s, ct::wgmma_desc(qs + c * lay.qchunk + off),
                     ct::wgmma_desc(ksrc + c * kb + off), i);
      }
    }
    ct::wgmma_commit();
    ct::wgmma_wait0();
    ct::fence_regs(s);
    {
      float* mine = xs + (((n & 1) * 2 + wg) * 128 + (tid & 127)) * 8;
      const float* theirs = xs + (((n & 1) * 2 + (wg ^ 1)) * 128 + (tid & 127)) * 8;
      reinterpret_cast<float4*>(mine)[0] = make_float4(s[0], s[1], s[2], s[3]);
      reinterpret_cast<float4*>(mine)[1] = make_float4(s[4], s[5], s[6], s[7]);
      consumers_sync();
      const float4 t0 = reinterpret_cast<const float4*>(theirs)[0];
      const float4 t1 = reinterpret_cast<const float4*>(theirs)[1];
      const float o8[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = wg ? o8[e] + s[e] : s[e] + o8[e];
    }
    // this warp's reads of q are done at the segment's last scores (the
    // producer loads the next segment's q once all 8 warps arrive)
    if (flags & F_LAST) {
      __syncwarp();
      if (lane == 0) mbar_arrive(ct::smem_addr(q_empty));
    }
    st.mark(ST_C_S);

    // online softmax of rows r0 and r0 + 8 over the tile's positions:
    // s[4j + 2h + u] is row r0 + 8h, position 8j + 2tq + u
    float p[8], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = 4 * j + 2 * h + u;
          const int pos = mt.t * TILE + 8 * j + 2 * tq + u;
          s[e] = pos <= cached ? s[e] * inv_sqrt_d : -INFINITY;
          mx = fmaxf(mx, s[e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = expf(m_run[h] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = 4 * j + 2 * h + u;
          p[e] = expf(s[e] - m_use);
          sum += p[e];
        }
      l_run[h] = l_run[h] * alpha[h] + sum;
      m_run[h] = m_new;
    }
    const uint32_t pa[4] = {ct::pack_bf16x2(p[0], p[1]), ct::pack_bf16x2(p[2], p[3]),
                            ct::pack_bf16x2(p[4], p[5]), ct::pack_bf16x2(p[6], p[7])};
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[c][4 * j] *= alpha[0];
        o[c][4 * j + 1] *= alpha[0];
        o[c][4 * j + 2] *= alpha[1];
        o[c][4 * j + 3] *= alpha[1];
      }
    }
    st.mark(ST_C_SOFT);

    // O += P V over this warpgroup's chunks of the output columns
    ct::wgmma_fence();
    {
      const int vb = WIDE ? TILE * 128 : lay.kchunk;  // bytes a V chunk
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        wgmma_pv(o[c], pa, wgmma_desc_mn(vsrc + (WIDE ? v_slot(c) : c_base + c) * vb));
    }
    ct::wgmma_commit();
    ct::wgmma_wait0();
#pragma unroll
    for (int c = 0; c < NCH; ++c) ct::fence_regs(o[c]);
    if constexpr (!WIDE) {
      __syncwarp();
      if (lane == 0) mbar_arrive(ct::smem_addr(empty + stage));  // stage read
    }
    st.mark(ST_C_PV);

    if (flags & F_LAST) {  // the segment's result
      float l[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] = l_run[h] + __shfl_xor_sync(0xffffffffu, l_run[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      }
      const bool whole = flags & F_WHOLE;
      const size_t slot = (size_t)blockIdx.x * 2 + ((flags & F_SLOT1) ? 1 : 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r0 + 8 * h;
        if (rr >= hn) continue;
        const float inv = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          if (c_base + c < c_write) continue;  // warpgroup 0 writes it
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = (c_base + c) * 64 + 8 * j + 2 * tq;
            const float v0 = o[c][4 * j + 2 * h], v1 = o[c][4 * j + 2 * h + 1];
            if (whole) {
              float y0 = v0 * inv, y1 = v1 * inv;
              if (C::kScaled) {
                y0 *= sv;
                y1 *= sv;
              }
              *reinterpret_cast<uint32_t*>(out + ((size_t)b * H + h0 + rr) * Dv + col) =
                  ct::pack_bf16x2(y0, y1);
            } else {
              *reinterpret_cast<float2*>(part_o + (slot * HB + rr) * Dv + col) =
                  make_float2(v0, v1);
            }
          }
        }
        if (!whole && wg == 0 && tq == 0)
          part_ml[slot * HB + rr] = make_float2(m_run[h], l[h]);
      }
      st.mark(ST_C_FIN);
    }
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
    ++n;
    mbar_wait(ct::smem_addr(full + stage), phase);
    mt = meta[stage];
    st.mark(ST_C_WAIT);
  }
  st.add(ST_C_UNITS, 1);
  st.flush(ST_C_TOTAL);
}

// Second pass: the rows whose tiles more than one range holds merged from
// their segments' partials in range order (the others were written whole
// by their block), inactive rows zeroed. grid (row, head block, block of
// MERGE_COLS output columns). The segments' weights exp(m - max) sit in
// shared memory (`max_segs` of them a head row, at most min(ranges,
// S_pad / 16 + 1)); each thread then sums 4 columns at a time over the
// segments.
template <bool SCALED>
__global__ void __launch_bounds__(MERGE_THREADS)
latent_merge_kernel(const int* __restrict__ lengths, const int* __restrict__ prefix,
                    const float2* __restrict__ part_ml, const float* __restrict__ part_o,
                    __nv_bfloat16* __restrict__ out, const float* __restrict__ v_scale,
                    int B, int H, int Dv, int capacity, int ranges, int max_segs) {
  extern __shared__ float weights[];  // [max_segs][HB], the slots, the sums
  __shared__ float rowl[HB];
  __shared__ int nseg;
  const int n_hb = (H + HB - 1) / HB, ncb = (Dv + MERGE_COLS - 1) / MERGE_COLS;
  const int cb = blockIdx.x % ncb, bh = blockIdx.x / ncb;
  const int b = bh / n_hb, hb = bh % n_hb, tid = threadIdx.x;
  const int h0 = hb * HB, hn = min(HB, H - h0), dv4 = Dv / 4;
  const int c40 = cb * (MERGE_COLS / 4), n4 = min(MERGE_COLS, Dv - cb * MERGE_COLS) / 4;
  uint2* dst = reinterpret_cast<uint2*>(out + ((size_t)b * H + h0) * Dv);
  const int len = lengths[b];
  if (len < 0) {
    for (int e = tid; e < hn * n4; e += MERGE_THREADS)
      dst[(e / n4) * dv4 + c40 + e % n4] = make_uint2(0u, 0u);
    return;
  }
  const long long T = prefix[B], P = prefix[b];
  const int n = row_tiles(lengths, b, capacity);
  const int ra = range_of(P, T, ranges), rz = range_of(P + n - 1, T, ranges);
  if (ra == rz) return;
  Stamps st(tid == 0);
  int* slots = reinterpret_cast<int*>(weights + (size_t)max_segs * HB);
  // the ranges holding tiles of the row, in order: range rr's partial is
  // its second slot where the row starts inside it; ranges with no tile
  // hold none
  __shared__ int start[MERGE_THREADS + 1];
  int count = 0;
  for (int base = ra; base <= rz; base += MERGE_THREADS) {
    const int rr = base + tid;
    long long lo = 0, hi = 0;
    if (rr <= rz) {
      lo = (long long)rr * T / ranges;
      hi = (long long)(rr + 1) * T / ranges;
    }
    const int live = lo < hi;
    start[tid] = live;
    __syncthreads();
    if (tid == 0) {  // exclusive prefix of the flags
      int acc = count;
      for (int i = 0; i < MERGE_THREADS; ++i) {
        const int f = start[i];
        start[i] = acc;
        acc += f;
      }
      start[MERGE_THREADS] = acc;
    }
    __syncthreads();
    if (live) slots[start[tid]] = (rr * n_hb + hb) * 2 + (rr == ra && lo < P ? 1 : 0);
    count = start[MERGE_THREADS];
    __syncthreads();
  }
  if (tid == 0) nseg = count;
  __syncthreads();
  const int ns = nseg;
  // the segments' (max, sum) pairs: maxima into `weights`, sums into the
  // slots' room after them, all loaded at once
  float* sums = reinterpret_cast<float*>(slots + max_segs);
  for (int e = tid; e < ns * hn; e += MERGE_THREADS) {
    const int j = e / hn, h = e - j * hn;
    const float2 ml = part_ml[(size_t)slots[j] * HB + h];
    weights[j * HB + h] = ml.x;
    sums[j * HB + h] = ml.y;
  }
  __syncthreads();
  if (tid < hn) {
    float mx = -INFINITY;
    for (int j = 0; j < ns; ++j) mx = fmaxf(mx, weights[j * HB + tid]);
    float l = 0.f;
    for (int j = 0; j < ns; ++j) {
      const float f = expf(weights[j * HB + tid] - mx);
      weights[j * HB + tid] = f;
      l += sums[j * HB + tid] * f;
    }
    rowl[tid] = l;
  }
  __syncthreads();
  const float sv = SCALED ? v_scale[0] : 1.f;
#pragma unroll 4
  for (int e = tid; e < hn * n4; e += MERGE_THREADS) {
    const int h = e / n4, c4 = c40 + e % n4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < ns; ++j) {
      const float f = weights[j * HB + h];
      const float4 v = *reinterpret_cast<const float4*>(
          part_o + ((size_t)slots[j] * HB + h) * Dv + 4 * c4);
      acc.x += f * v.x;
      acc.y += f * v.y;
      acc.z += f * v.z;
      acc.w += f * v.w;
    }
    const float l = fmaxf(rowl[h], 1e-30f);
    float y[4] = {acc.x / l, acc.y / l, acc.z / l, acc.w / l};
    if (SCALED)
      for (float& v : y) v *= sv;
    dst[h * dv4 + c4] = make_uint2(ct::pack_bf16x2(y[0], y[1]), ct::pack_bf16x2(y[2], y[3]));
  }
  st.mark(ST_MERGE);
  st.add(ST_M_BLOCKS, 1);
  st.flush(-1);
}

// ---- host side ------------------------------------------------------- //

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {  // cuTensorMapEncodeTiled from the driver, once
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a tensor map over `rows` rows of `d` elements of `isz` bytes at `base`,
// seen as (64 columns, row, 64-column chunk): boxes of 64 columns by
// `box_rows` rows by all d / 64 chunks, landing chunk after chunk;
// 128-byte-swizzled for bf16 (the wgmma layout), plain for 8-bit bytes
// (widened by the consumers)
int make_map(CUtensorMap* map, const void* base, long long rows, int d, int isz,
             int box_rows) {
  EncodeTiled enc = encoder();
  if (!enc) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {64, (cuuint64_t)rows, (cuuint64_t)(d / 64)};
  const cuuint64_t strides[2] = {(cuuint64_t)d * isz, (cuuint64_t)64 * isz};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, (cuuint32_t)(d / 64)};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult res = enc(
      map, isz == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
      const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      isz == 2 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidPitchValue);
}

struct Args {
  const void *q, *new_k, *new_v;
  void *cache_k, *cache_v;
  const void *tables, *lengths;
  void* out;
  void *part_ml, *part_o, *prefix;
  const void *k_scale, *v_scale;
  int B, H, Dk, Dv, layer, page, capacity, table_width, num_pages;
  long long rows;  // rows of each cache (all layers)
  int ranges;
  float inv_sqrt_d;
};

// the merge pass's dynamic shared memory ceiling (its static arrays take
// the rest of the block's 227 KB)
constexpr int MERGE_SMEM_LIMIT = SMEM_LIMIT - 4096;

template <auto Kernel, int BYTES>
int opt_in_smem() {  // once per kernel: the shared memory a block may use
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  return 0;
}

template <bool PAGED, int KIND, int NKC, int NCH>
int launch_kind(const Args& a, cudaStream_t s) {
  using T = typename ct::Cache<KIND>::T;
  constexpr bool SCALED = ct::Cache<KIND>::kScaled;
  auto* kernel = latent_kernel<PAGED, KIND, NKC, NCH>;
  auto* merge = latent_merge_kernel<SCALED>;
  int err = opt_in_smem<latent_kernel<PAGED, KIND, NKC, NCH>, SMEM_LIMIT>();
  if (!err) err = opt_in_smem<latent_merge_kernel<SCALED>, MERGE_SMEM_LIMIT>();
  if (err) return err;
  const Layout lay(a.Dk, a.Dv, sizeof(T), a.H);
  const int max_segs = min(a.ranges, a.capacity / TILE + 1);
  const size_t merge_smem = (size_t)max_segs * (2 * HB * sizeof(float) + sizeof(int));
  if (lay.stages < 3 || lay.total > (size_t)SMEM_LIMIT ||
      merge_smem > (size_t)MERGE_SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  alignas(64) CUtensorMap map_k, map_v, map_q;
  err = make_map(&map_k, a.cache_k, a.rows, a.Dk, sizeof(T), TILE);
  if (!err) err = make_map(&map_v, a.cache_v, a.rows, a.Dv, sizeof(T), TILE);
  if (!err) err = make_map(&map_q, a.q, (long long)a.B * a.H, a.Dk, 2, lay.rows);
  if (err) return err;
  const int n_hb = (a.H + HB - 1) / HB;
  kernel<<<a.ranges * n_hb, THREADS, lay.total, s>>>(
      map_k, map_v, map_q, static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.new_k), static_cast<const __nv_bfloat16*>(a.new_v),
      static_cast<T*>(a.cache_k), static_cast<T*>(a.cache_v),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.lengths),
      static_cast<__nv_bfloat16*>(a.out), static_cast<float2*>(a.part_ml),
      static_cast<float*>(a.part_o), static_cast<int*>(a.prefix),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale), a.B, a.H,
      a.Dk, a.Dv, a.layer, a.page, a.capacity, a.table_width, a.num_pages, a.ranges,
      a.inv_sqrt_d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  merge<<<a.B * n_hb * ((a.Dv + MERGE_COLS - 1) / MERGE_COLS), MERGE_THREADS, merge_smem,
          s>>>(
      static_cast<const int*>(a.lengths), static_cast<const int*>(a.prefix),
      static_cast<const float2*>(a.part_ml), static_cast<const float*>(a.part_o),
      static_cast<__nv_bfloat16*>(a.out), static_cast<const float*>(a.v_scale), a.B, a.H,
      a.Dv, a.capacity, a.ranges, max_segs);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED, int KIND>
int launch_chunks(const Args& a, cudaStream_t s) {
  if (a.Dk == 576 && a.Dv == 512)  // DeepSeek V2/V3's latent widths
    return launch_kind<PAGED, KIND, 9, 4>(a, s);
  switch ((a.Dv / 64 + 1) / 2) {  // output chunks a consumer warpgroup
    case 1: return launch_kind<PAGED, KIND, 0, 1>(a, s);
    case 2: return launch_kind<PAGED, KIND, 0, 2>(a, s);
    case 3: return launch_kind<PAGED, KIND, 0, 3>(a, s);
    case 4: return launch_kind<PAGED, KIND, 0, 4>(a, s);
    case 5: return launch_kind<PAGED, KIND, 0, 5>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool PAGED>
int launch(const Args& a, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.H < 1 || a.B < 1 || a.Dk % 64 || a.Dv % 64 || a.Dv < 64 || a.Dv > a.Dk ||
      a.Dk > MAX_D || a.ranges < 1 || a.page < 1 || (PAGED && a.page % TILE))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kind) {
    case ct::kCacheBF16: return launch_chunks<PAGED, ct::kCacheBF16>(a, s);
    case ct::kCacheE4M3: return launch_chunks<PAGED, ct::kCacheE4M3>(a, s);
    case ct::kCacheInt8: return launch_chunks<PAGED, ct::kCacheInt8>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Dense slab (B5-L). q (B, H, Dk), new_k (B, 1, Dk), new_v (B, 1, Dv) bf16;
// cache_k (L, B, 1, S_pad, Dk) and cache_v (L, B, 1, S_pad, Dv) of cache
// type `kind` (ct::CacheKind); lengths (B,) int32; out (B, H, Dv) bf16;
// k_scale/v_scale (1,) f32, read only for the e4m3 and int8 caches;
// scratch: part_ml (ranges * ceil(H / 64) * 2, 64) float2, part_o (the
// same slots, 64, Dv) f32, prefix (B + 1,) int32. All contiguous. Dk and Dv
// multiples of 64, Dv <= Dk <= 640, any H >= 1; `ranges` >= 1 ranges of
// the live tiles (the schedule; one block each per head block).
extern "C" int ct_latent_decode(const void* q, const void* new_k, const void* new_v,
                                void* cache_k, void* cache_v, const void* lengths,
                                void* out, const void* k_scale, const void* v_scale,
                                void* part_ml, void* part_o, void* prefix, int B, int H,
                                int s_pad, int Dk, int Dv, int layer, int layers, int kind,
                                int ranges, float inv_sqrt_d, void* stream) {
  const Args a{q,       new_k,   new_v,   cache_k, cache_v, nullptr,
               lengths, out,     part_ml, part_o,  prefix,  k_scale,
               v_scale, B,       H,       Dk,      Dv,      layer,
               1,       s_pad,   0,       0,       (long long)layers * B * s_pad,
               ranges,  inv_sqrt_d};
  return launch<false>(a, kind, stream);
}

// Paged pool (B7-L). pool_k (L, NP, 1, page, Dk) and pool_v (L, NP, 1,
// page, Dv) of cache type `kind`; tables (B, P) int32 page ids; page a
// multiple of 16; the rest as for ct_latent_decode.
extern "C" int ct_latent_paged_decode(const void* q, const void* new_k, const void* new_v,
                                      void* pool_k, void* pool_v, const void* tables,
                                      const void* lengths, void* out, const void* k_scale,
                                      const void* v_scale, void* part_ml, void* part_o,
                                      void* prefix, int B, int H, int num_pages,
                                      int table_width, int page, int Dk, int Dv, int layer,
                                      int layers, int kind, int ranges, float inv_sqrt_d,
                                      void* stream) {
  const Args a{q,       new_k,   new_v,     pool_k,  pool_v,  tables,
               lengths, out,     part_ml,   part_o,  prefix,  k_scale,
               v_scale, B,       H,         Dk,      Dv,      layer,
               page,    table_width * page, table_width,      num_pages,
               (long long)layers * num_pages * page, ranges,  inv_sqrt_d};
  return launch<true>(a, kind, stream);
}

#ifdef CT_LATENT_STAMPS
// the phase names (comma-separated) and the phase sums since the last
// reset (copied to host_out, ST_N values); reset != 0 zeroes them after
extern "C" const char* ct_latent_stamp_names() { return kStampNames; }
extern "C" int ct_latent_stamps(unsigned long long* host_out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host_out, g_stamps, sizeof(g_stamps));
  if (e == cudaSuccess && reset) {
    static const unsigned long long zero[ST_N] = {};
    e = cudaMemcpyToSymbol(g_stamps, zero, sizeof(g_stamps));
  }
  return static_cast<int>(e);
}
#endif
