// Length-aware decode attention for Hopper, on the dense slab cache (flash
// decode) and on the paged pool (paged decode): one kernel body, two entry
// points, split over the keys.
//
// Replaces compressed_tensors_tpu/ops/kernels/flash_decode.py:
// flash_decode_attention and compressed_tensors_tpu/ops/kernels/
// paged_decode.py:paged_decode_attention. Position p of row b is at b *
// S_pad + p of the slab cache (L, B, KVH, S_pad, D), or at p % page of pool
// page tables[b, p / page] of the pool (L, NP, KVH, page, D); only the
// positions 0..lengths[b] are touched, so the cost follows the row's
// length, not the allocation. The two layouts differ only in that offset,
// so on equal cache contents both entry points give the same bits.
//
// Bound on the H100: the live cache bytes, 2 * sum(len + 1) * KVH * D *
// sizeof(cache element) per layer, against 3.35 TB/s. The design streams
// them in their own type and keeps the card full:
//   - the keys split: grid (kv head, row, split), a split `per` tiles of 64
//     positions; blocks past a row's last position exit at once. Each block
//     leaves its f32 (max, sum, unnormalized output) of the group's query
//     heads in scratch, and a second pass merges a row's splits (a row of
//     one split is written by its block; the pass is not launched when the
//     capacity fits one split, and block 0 of an inactive row zeroes it);
//   - 16 bytes a cp.async, the cache's own bytes (bf16, e4m3 or int8) in a
//     ring of tiles, the next tiles in flight while one is used; an 8-bit
//     tile's fragments are widened to bf16 in registers after ldmatrix
//     (e4m3 and int8 -> bf16 are exact), so it moves half the bytes of
//     bf16 through every level;
//   - the tensor cores: the `rep` query heads of a group, padded to 16, are
//     the A rows of mma.sync m16n8k16 bf16; each of the 4 warps takes 16
//     positions of a tile: S = Q K^T with K by ldmatrix, the online softmax
//     on the fragments, P V with V by ldmatrix.trans (on 8-bit tiles the
//     b16 matrices hold byte pairs: q's elements and the output columns
//     are permuted to match, see below); the warps' states merge in shared
//     memory at the end.
// A row with a negative length is inactive: its output is zero and no
// cache byte of it is read or written, not even the null page 0. The step's
// K/V row is written in place at position lengths[b] (for the pool, page
// tables[b, lengths[b] / page], which the caller has allocated) by the
// block whose split holds that position, which folds the same values into
// its own tile from registers: no block reads position lengths[b] back, so
// none waits on another's write.
//
// Arithmetic as the TPU kernels (flash_decode.py:148-242): a bf16 cache
// holds K/V as they are; an e4m3 or int8 cache holds x / scale (per-tensor
// k/v scales, IEEE division), read back with a raw conversion, k_scale
// folded into q (q * k_scale rounded to bf16) and v_scale onto the
// normalized f32 output. Scores are bf16 q . bf16 k summed in f32, times
// 1/sqrt(D); the online softmax runs in f32, the unnormalized
// probabilities are rounded to bf16 before P.V, their f32 sum divides.
#include "common.cuh"

namespace {

constexpr int TILE = 64;              // positions a tile
constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int QROWS = 16;             // query heads of a group, padded

template <int D, int KIND>
struct Cfg {
  using T = typename ct::Cache<KIND>::T;
  static constexpr bool kRaw = KIND != ct::kCacheBF16;  // 8-bit: widened in registers
  static constexpr int RS = D + 8;    // bf16 row stride: ldmatrix conflict-free
  static constexpr int RB = kRaw ? D + 16 : 2 * RS;  // a cache row's bytes in a stage
  static constexpr int NST = kRaw ? 3 : 2;  // ring stages (tools/decode_split_sweep.py)
  static constexpr size_t Q_BYTES = (size_t)QROWS * RS * 2;
  static constexpr size_t TILE_BYTES = (size_t)TILE * RB;  // K or V, own type
  static constexpr size_t STAGE = 2 * TILE_BYTES;          // K then V
  static constexpr size_t MAIN = Q_BYTES + NST * STAGE;
  // the warps' merge: o (WARPS x 16 x (D + 4)) and m, l, factors (WARPS x 16)
  static constexpr int OS = D + 4;
  static constexpr size_t MERGE = (size_t)WARPS * QROWS * OS * 4 + 3 * WARPS * QROWS * 4
                                  + 2 * QROWS * 4;
  static constexpr size_t SMEM = MAIN > MERGE ? MAIN : MERGE;
};

// three blocks an SM: at most 168 registers (e4m3's widening took 182 and
// two blocks an SM unbounded; no spill at three)
template <int D, bool PAGED, int KIND>
__global__ void __launch_bounds__(THREADS, 3)
split_kernel(const __nv_bfloat16* __restrict__ q,      // (B, H, D)
             const __nv_bfloat16* __restrict__ new_k,  // (B, KVH, D)
             const __nv_bfloat16* __restrict__ new_v,
             typename ct::Cache<KIND>::T* __restrict__ cache_k,  // slab or pool
             typename ct::Cache<KIND>::T* __restrict__ cache_v,
             const int* __restrict__ tables,           // (B, table_width) or null
             const int* __restrict__ lengths,          // (B,)
             __nv_bfloat16* __restrict__ out,          // (B, H, D)
             float2* __restrict__ part_ml,             // (B, KVH, splits, rep)
             float* __restrict__ part_o,               // (B, KVH, splits, rep, D)
             const float* __restrict__ k_scale,        // (1,), scaled caches
             const float* __restrict__ v_scale,
             int B, int KVH, int rep, int layer, int page, int capacity,
             int table_width, int num_pages, int per, int splits,
             float inv_sqrt_d) {
  using C = ct::Cache<KIND>;
  using G = Cfg<D, KIND>;
  using T = typename G::T;
  constexpr int RS = G::RS, RB = G::RB, NST = G::NST;
  extern __shared__ __align__(16) unsigned char smem[];

  const int kvh = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int len = lengths[b];
  const int H = KVH * rep;
  if (len < 0) {  // inactive: block z = 0 writes its zeros
    if (z == 0)
      for (int e = threadIdx.x; e < rep * D; e += THREADS)
        out[((size_t)b * H + kvh * rep) * D + e] = __float2bfloat16(0.f);
    return;
  }
  const int cached = min(len, capacity);  // positions read from the cache
  const int n_pos = cached + 1;           // and the new token at `cached`
  const int span = per * TILE, p0 = z * span;
  if (p0 >= n_pos) return;
  const int p1 = min(p0 + span, n_pos);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // element offset of cached position `pos` of this row and kv head
  auto offset = [&](int pos) -> size_t {
    if (PAGED) {
      const int c = pos / page;
      return ((((size_t)layer * num_pages + tables[(size_t)b * table_width + c]) * KVH
               + kvh) * page + (pos - c * page)) * D;
    }
    return ((((size_t)layer * B + b) * KVH + kvh) * capacity + pos) * D;
  };

  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring = smem + G::Q_BYTES;

  const float sk = C::kScaled ? k_scale[0] : 1.f;
  const float sv = C::kScaled ? v_scale[0] : 1.f;
  // this block holds the new token: its cache representation (lane d of the
  // block: element d), written in place and put into its own tile
  const bool mine = cached < p1;
  T nk = C::from_new(__float2bfloat16(0.f), 1.f), nv = nk;
  if (mine && tid < D) {
    const size_t src = ((size_t)b * KVH + kvh) * D + tid;
    nk = C::from_new(new_k[src], sk);
    nv = C::from_new(new_v[src], sv);
    if (len < capacity) {
      const size_t dst = offset(len) + tid;
      cache_k[dst] = nk;
      cache_v[dst] = nv;
    }
  }
  // q of the group's heads (k_scale folded, rounded to bf16), rows past rep
  // 0, in the order of an 8-bit K fragment's k indices (ct::decode_q_col)
  for (int i = tid; i < QROWS * D; i += THREADS) {
    const int h = i / D, d = i % D;
    float qv = 0.f;
    if (h < rep) {
      qv = __bfloat162float(q[((size_t)b * H + kvh * rep + h) * D + d]);
      if (C::kScaled) qv = __bfloat162float(__float2bfloat16(qv * sk));
    }
    qs[h * RS + ct::decode_q_col<G::kRaw>(d)] = __float2bfloat16(qv);
  }

  // tile tt's copies into stage st: cached positions only (positions past
  // the cache are zero-filled; the new token's row is left to the block)
  constexpr int CPR = D * sizeof(T) / 16;  // 16-byte chunks a row (K or V)
  // a tile inside one page (or the slab): one offset a tile
  const bool one_page = !PAGED || page % TILE == 0;
  auto load_tile = [&](int st, int tt) {
    unsigned char* base = ring + st * G::STAGE;
    const int ch = tid % CPR;
    const size_t tile0 = one_page && tt * TILE < cached ? offset(tt * TILE) : 0;
#pragma unroll
    for (int r = tid / CPR; r < TILE; r += THREADS / CPR) {
      const int pos = tt * TILE + r;
      if (pos == cached) continue;
      const bool ok = pos < cached;
      const size_t off =
          ok ? (one_page ? tile0 + (size_t)r * D : offset(pos)) + ch * (16 / sizeof(T))
             : 0;
      unsigned char* dk = base + r * RB + ch * 16;
      ct::cp_async16(dk, cache_k + off, ok ? 16 : 0);
      ct::cp_async16(dk + G::TILE_BYTES, cache_v + off, ok ? 16 : 0);
    }
  };
  // the new token's row into the stage of tile tt (it sits there)
  auto put_new = [&](unsigned char* base, int tt) {
    const int r = cached - tt * TILE;
    if (r >= 0 && r < TILE && tid < D) {
      T* kt = reinterpret_cast<T*>(base + r * RB);
      T* vt = reinterpret_cast<T*>(base + G::TILE_BYTES + r * RB);
      kt[tid] = nk;
      vt[tid] = nv;
    }
  };

  // Q fragments (16 rows x D)
  const int g = lane >> 2, t = lane & 3;
  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int t0 = p0 / TILE, t1 = (p1 + TILE - 1) / TILE;
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (t0 + i < t1) load_tile(i, t0 + i);
    ct::cp_async_commit();
  }
  for (int tt = t0, st = 0; tt < t1; ++tt, st = st == NST - 1 ? 0 : st + 1) {
    ct::cp_async_wait<NST - 2>();  // tile tt has landed (this thread's copies)
    const unsigned char* base = ring + st * G::STAGE;
    put_new(ring + st * G::STAGE, tt);
    __syncthreads();  // tile tt visible; every warp is done with tile tt - 1
    if (tt + NST - 1 < t1) load_tile((st + NST - 1) % NST, tt + NST - 1);
    ct::cp_async_commit();
    if (tt == t0) ct::decode_q_frags<D>(qf, qs, RS, lane);

    // this warp's 16 positions of the tile
    const int w0 = tt * TILE + warp * 16;
    if (w0 >= p1) continue;
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    ct::decode_score16<D, KIND>(s, qf, base, RB, warp * 16, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int pos = w0 + j * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = pos + (e & 1) < p1 ? s[j][e] * inv_sqrt_d : -INFINITY;
    }

    // online softmax on the fragments (rows g and g + 8: query heads)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    // a warp whose positions so far are all past the row: nothing to scale
    const float u0 = mx0 == -INFINITY ? 0.f : mx0;
    const float u1 = mx1 == -INFINITY ? 0.f : mx1;
    const float a0 = expf(m0 - u0), a1 = expf(m1 - u1);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= a0;
      o[i][1] *= a0;
      o[i][2] *= a1;
      o[i][3] *= a1;
    }
    uint32_t pf[4];  // P as the bf16 A fragment of the 16 positions
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float p0_ = expf(s[j][0] - u0), p1_ = expf(s[j][1] - u0);
      const float p2_ = expf(s[j][2] - u1), p3_ = expf(s[j][3] - u1);
      l0 += p0_ + p1_;
      l1 += p2_ + p3_;
      pf[2 * j] = ct::pack_bf16x2(p0_, p1_);
      pf[2 * j + 1] = ct::pack_bf16x2(p2_, p3_);
    }
    ct::decode_pv16<D, KIND>(o, pf, base + G::TILE_BYTES, RB, warp * 16, lane);
  }

  // merge the 4 warps' states in shared memory (the ring is free)
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  ct::cp_async_wait<0>();
  __syncthreads();
  float* os = reinterpret_cast<float*>(smem);             // [WARPS][16][OS]
  float* ms = os + WARPS * QROWS * G::OS;                  // [WARPS][16]
  float* ls = ms + WARPS * QROWS;
  float* fac = ls + WARPS * QROWS;                         // [WARPS][16]
  float* rowl = fac + WARPS * QROWS;                       // [16]
  float* rowm = rowl + QROWS;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    float* dst = os + (warp * QROWS + g) * G::OS;
    if constexpr (G::kRaw) {
      const int col = 32 * (i >> 2) + 16 * ((i >> 1) & 1) + 4 * t + (i & 1);
      dst[col] = o[i][0];
      dst[col + 2] = o[i][1];
      dst[8 * G::OS + col] = o[i][2];
      dst[8 * G::OS + col + 2] = o[i][3];
    } else {
      dst += i * 8 + 2 * t;
      *reinterpret_cast<float2*>(dst) = make_float2(o[i][0], o[i][1]);
      *reinterpret_cast<float2*>(dst + 8 * G::OS) = make_float2(o[i][2], o[i][3]);
    }
  }
  if (t == 0) {
    ms[warp * QROWS + g] = m0;
    ms[warp * QROWS + g + 8] = m1;
    ls[warp * QROWS + g] = l0;
    ls[warp * QROWS + g + 8] = l1;
  }
  __syncthreads();
  if (tid < QROWS) {  // position p0 is live: some warp's max is finite
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, ms[w * QROWS + tid]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(ms[w * QROWS + tid] - mx);
      fac[w * QROWS + tid] = f;
      l += f * ls[w * QROWS + tid];
    }
    rowm[tid] = mx;
    rowl[tid] = l;
  }
  __syncthreads();
  const bool whole = (n_pos + span - 1) / span == 1;  // the row's only split
  const size_t slot = ((size_t)b * KVH + kvh) * splits + z;
  for (int e = tid; e < rep * D; e += THREADS) {
    const int r = e / D, d = e % D;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      acc += fac[w * QROWS + r] * os[(w * QROWS + r) * G::OS + d];
    if (whole) {
      const float v = acc / fmaxf(rowl[r], 1e-30f);
      out[((size_t)b * H + kvh * rep + r) * D + d] =
          __float2bfloat16(C::kScaled ? v * sv : v);
    } else {
      part_o[(slot * rep + r) * D + d] = acc;
      if (d == 0) part_ml[slot * rep + r] = make_float2(rowm[r], rowl[r]);
    }
  }
}

// Second pass, launched when a row may take more than one split: a row's
// split partials merged (a row of one split was written by its block, an
// inactive row zeroed). grid (KVH, B).
template <int D, bool SCALED>
__global__ void __launch_bounds__(THREADS)
merge_kernel(const int* __restrict__ lengths, const float2* __restrict__ part_ml,
             const float* __restrict__ part_o, __nv_bfloat16* __restrict__ out,
             const float* __restrict__ v_scale, int KVH, int rep, int capacity,
             int span, int splits) {
  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int len = lengths[b];
  if (len < 0) return;
  const int ns = (min(len, capacity) + span) / span;  // ceil((cached + 1) / span)
  if (ns == 1) return;
  __nv_bfloat16* op = out + ((size_t)b * KVH * rep + kvh * rep) * D;
  const size_t slot = ((size_t)b * KVH + kvh) * splits;
  __shared__ float rowm[QROWS], rowl[QROWS];
  if (tid < rep) {
    float mx = -INFINITY;
    for (int zz = 0; zz < ns; ++zz) mx = fmaxf(mx, part_ml[(slot + zz) * rep + tid].x);
    float l = 0.f;
    for (int zz = 0; zz < ns; ++zz) {
      const float2 ml = part_ml[(slot + zz) * rep + tid];
      l += ml.y * expf(ml.x - mx);
    }
    rowm[tid] = mx;
    rowl[tid] = l;
  }
  __syncthreads();
  const float sv = SCALED ? v_scale[0] : 1.f;
  for (int e = tid; e < rep * D; e += THREADS) {
    const int r = e / D, d = e % D;
    float acc = 0.f;
    for (int zz = 0; zz < ns; ++zz)
      acc += expf(part_ml[(slot + zz) * rep + r].x - rowm[r]) *
             part_o[((slot + zz) * rep + r) * D + d];
    const float v = acc / fmaxf(rowl[r], 1e-30f);
    op[e] = __float2bfloat16(SCALED ? v * sv : v);
  }
}

struct Args {
  const void *q, *new_k, *new_v;
  void *cache_k, *cache_v;
  const void *tables, *lengths;
  void* out;
  void *part_ml, *part_o;
  const void *k_scale, *v_scale;
  int B, KVH, rep, layer, page, capacity, table_width, num_pages, per, splits;
  float inv_sqrt_d;
};

template <int D, bool PAGED, int KIND>
int launch_kind(const Args& a, cudaStream_t s) {
  using T = typename ct::Cache<KIND>::T;
  auto* kernel = split_kernel<D, PAGED, KIND>;
  constexpr size_t smem = Cfg<D, KIND>::SMEM;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  kernel<<<dim3(a.KVH, a.B, a.splits), THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.new_k),
      static_cast<const __nv_bfloat16*>(a.new_v), static_cast<T*>(a.cache_k),
      static_cast<T*>(a.cache_v), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.lengths), static_cast<__nv_bfloat16*>(a.out),
      static_cast<float2*>(a.part_ml), static_cast<float*>(a.part_o),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale), a.B,
      a.KVH, a.rep, a.layer, a.page, a.capacity, a.table_width, a.num_pages, a.per,
      a.splits, a.inv_sqrt_d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return static_cast<int>(e);
  merge_kernel<D, ct::Cache<KIND>::kScaled><<<dim3(a.KVH, a.B), THREADS, 0, s>>>(
      static_cast<const int*>(a.lengths), static_cast<const float2*>(a.part_ml),
      static_cast<const float*>(a.part_o), static_cast<__nv_bfloat16*>(a.out),
      static_cast<const float*>(a.v_scale), a.KVH, a.rep, a.capacity, a.per * TILE,
      a.splits);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool PAGED>
int launch_d(int kind, const Args& a, cudaStream_t s) {
  switch (kind) {
    case ct::kCacheBF16: return launch_kind<D, PAGED, ct::kCacheBF16>(a, s);
    case ct::kCacheE4M3: return launch_kind<D, PAGED, ct::kCacheE4M3>(a, s);
    case ct::kCacheInt8: return launch_kind<D, PAGED, ct::kCacheInt8>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool PAGED>
int launch(const Args& a, int D, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.rep < 1 || a.rep > QROWS || a.per < 1 || a.page % 16 ||
      a.splits != (a.capacity + a.per * TILE) / (a.per * TILE))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64) return launch_d<64, PAGED>(kind, a, s);
  if (D == 128) return launch_d<128, PAGED>(kind, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Dense slab. q (B, H, D), new_k/new_v (B, KVH, D) bf16; cache_k/cache_v
// (L, B, KVH, S_pad, D) of cache type `kind` (ct::CacheKind); lengths (B,)
// int32; out (B, H, D) bf16; k_scale/v_scale (1,) f32, read only for the
// e4m3 and int8 caches; part_ml (B, KVH, splits, rep) float2 and part_o
// (B, KVH, splits, rep, D) f32 scratch, splits = (S_pad + 64 per) / (64
// per), read only when splits > 1. All contiguous. D in {64, 128}, H / KVH
// <= 16.
extern "C" int ct_flash_decode(const void* q, const void* new_k, const void* new_v,
                               void* cache_k, void* cache_v, const void* lengths,
                               void* out, const void* k_scale, const void* v_scale,
                               void* part_ml, void* part_o, int B, int KVH, int rep,
                               int s_pad, int D, int layer, int kind, int per,
                               int splits, float inv_sqrt_d, void* stream) {
  const Args a{q, new_k, new_v, cache_k, cache_v, nullptr, lengths, out, part_ml,
               part_o, k_scale, v_scale, B, KVH, rep, layer, 16, s_pad, 0, 0, per,
               splits, inv_sqrt_d};
  return launch<false>(a, D, kind, stream);
}

// Paged pool. pool_k/pool_v (L, NP, KVH, page, D) of cache type `kind`,
// page % 16 == 0; tables (B, P) int32 page ids; splits = (P page + 64 per)
// / (64 per); the rest as for ct_flash_decode.
extern "C" int ct_paged_decode(const void* q, const void* new_k, const void* new_v,
                               void* pool_k, void* pool_v, const void* tables,
                               const void* lengths, void* out, const void* k_scale,
                               const void* v_scale, void* part_ml, void* part_o,
                               int B, int KVH, int rep, int num_pages,
                               int table_width, int page, int D, int layer,
                               int kind, int per, int splits, float inv_sqrt_d,
                               void* stream) {
  const Args a{q, new_k, new_v, pool_k, pool_v, tables, lengths, out, part_ml,
               part_o, k_scale, v_scale, B, KVH, rep, layer, page,
               table_width * page, table_width, num_pages, per, splits, inv_sqrt_d};
  return launch<true>(a, D, kind, stream);
}
