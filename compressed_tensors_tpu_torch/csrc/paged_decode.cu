// Length-aware decode attention for Hopper, on the dense slab cache (flash
// decode) and on the paged pool (paged decode): one kernel body, two entry
// points.
//
// Replaces compressed_tensors_tpu/ops/kernels/flash_decode.py:
// flash_decode_attention and compressed_tensors_tpu/ops/kernels/
// paged_decode.py:paged_decode_attention. Both walk a row's keys in chunks
// of `page` positions: chunk c of row b is at b * S_pad + page * c of the
// slab cache (L, B, KVH, S_pad, D), or in pool page tables[b, c] of the
// pool (L, NP, KVH, page, D). Only the chunks that hold positions
// 0..lengths[b] are read, so the cost follows the row's length, not the
// allocation.
//
// One block per (kv head, batch row); the `rep` query heads of the group
// are its rows, one warp each. A row with a negative length is inactive:
// its output is zero and the block reads and writes no cache byte, not
// even the null page 0. Otherwise the block
//   1. writes the step's K/V row in place at position lengths[b] (for the
//      pool, page tables[b, lengths[b] / page], which the caller has
//      allocated), then synchronizes;
//   2. stages 32 keys and values at a time in shared memory (as f32) and
//      runs the online softmax in f32: lane j scores key j, the warp
//      reduces max and sum with shuffles, the unnormalized probabilities
//      are rounded to bf16 before P.V (flash_decode.py:179,209), and each
//      lane accumulates D/32 output dims;
//   3. normalizes in f32 and writes the output once in bf16.
// The two layouts differ only in where a key lives, so on equal cache
// contents both entry points give the same bits.
//
// Cache types (common.cuh, ct::Cache): bf16, or fp8 e4m3 / int8 with
// per-tensor k/v scales. As in the TPU kernels (flash_decode.py:83-163,
// 242), the new row is quantized (x / scale) and written in its cache
// type, cached values are converted raw, k_scale folds into q (q * k_scale
// rounded to bf16) and v_scale multiplies the normalized f32 output before
// its bf16 rounding.
//
// Bound on the H100: the live cache bytes, 2 * sum(len + 1) * KVH * D *
// sizeof(cache element) per layer, against 3.35 TB/s.
#include "common.cuh"

namespace {

constexpr int KC = 32, THREADS = 256, WARPS = THREADS / 32, MAX_HPW = 2;

template <int D, bool PAGED, int KIND>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const __nv_bfloat16* __restrict__ q,      // (B, H, D)
             const __nv_bfloat16* __restrict__ new_k,  // (B, KVH, D)
             const __nv_bfloat16* __restrict__ new_v,
             typename ct::Cache<KIND>::T* __restrict__ cache_k,  // slab or pool
             typename ct::Cache<KIND>::T* __restrict__ cache_v,
             const int* __restrict__ tables,           // (B, chunks) or null
             const int* __restrict__ lengths,          // (B,)
             __nv_bfloat16* __restrict__ out,          // (B, H, D)
             const float* __restrict__ k_scale,        // (1,), scaled caches
             const float* __restrict__ v_scale,
             int B, int KVH, int rep, int layer, int page, int chunks,
             int num_pages, float inv_sqrt_d) {
  using C = ct::Cache<KIND>;
  constexpr int DPL = D / 32;  // output dims per lane
  __shared__ float qs[WARPS * MAX_HPW][D];
  __shared__ float ks[KC][D + 1];
  __shared__ float vs[KC][D];
  __shared__ size_t key_off[KC];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = KVH * rep;
  const int len = lengths[b];

  if (len < 0) {  // inactive row: no cache byte read or written
    for (int i = tid; i < rep * D; i += THREADS)
      out[((size_t)b * H + kvh * rep) * D + i] = __float2bfloat16(0.f);
    return;
  }
  // element offset of position `pos` of this row and kv head
  auto offset = [&](int pos) -> size_t {
    const int c = pos / page, r = pos - c * page;
    size_t base;
    if (PAGED)
      base = (((size_t)layer * num_pages + tables[(size_t)b * chunks + c]) * KVH + kvh)
             * page;
    else
      base = (((size_t)layer * B + b) * KVH + kvh) * (size_t)chunks * page + (size_t)c * page;
    return (base + r) * D;
  };

  const float sk = C::kScaled ? k_scale[0] : 1.f;
  const float sv = C::kScaled ? v_scale[0] : 1.f;
  const int capacity = chunks * page;
  if (len < capacity) {
    const size_t dst = offset(len), src = ((size_t)b * KVH + kvh) * D;
    for (int d = tid; d < D; d += THREADS) {
      cache_k[dst + d] = C::from_new(new_k[src + d], sk);
      cache_v[dst + d] = C::from_new(new_v[src + d], sv);
    }
  }
  for (int i = tid; i < rep * D; i += THREADS) {
    const float qv = __bfloat162float(q[((size_t)b * H + kvh * rep) * D + i]);
    qs[i / D][i % D] =
        C::kScaled ? __bfloat162float(__float2bfloat16(qv * sk)) : qv;
  }
  __syncthreads();  // the new row and q are visible to the whole block

  const int n_keys = min(len, capacity - 1) + 1;
  float m[MAX_HPW], l[MAX_HPW], acc[MAX_HPW][DPL];
#pragma unroll
  for (int i = 0; i < MAX_HPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }

  for (int c0 = 0; c0 < n_keys; c0 += KC) {
    if (tid < KC && c0 + tid < n_keys) key_off[tid] = offset(c0 + tid);
    __syncthreads();
    for (int i = tid; i < KC * D / 2; i += THREADS) {
      const int j = i / (D / 2), d2 = (i % (D / 2)) * 2;
      float2 kf = make_float2(0.f, 0.f), vf = make_float2(0.f, 0.f);
      if (c0 + j < n_keys) {
        const size_t off = key_off[j] + d2;
        kf = C::load2(cache_k + off);
        vf = C::load2(cache_v + off);
      }
      ks[j][d2] = kf.x; ks[j][d2 + 1] = kf.y;
      vs[j][d2] = vf.x; vs[j][d2 + 1] = vf.y;
    }
    __syncthreads();
#pragma unroll
    for (int hi = 0; hi < MAX_HPW; ++hi) {
      const int h = warp + hi * WARPS;
      if (h >= rep) break;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += qs[h][d] * ks[lane][d];
      const float s = (c0 + lane < n_keys) ? dot * inv_sqrt_d : -INFINITY;
      const float m_new = fmaxf(m[hi], ct::warp_max(s));  // key c0 is live
      const float p = expf(s - m_new);
      const float alpha = expf(m[hi] - m_new);
      l[hi] = l[hi] * alpha + ct::warp_sum(p);
      const float pb = __bfloat162float(__float2bfloat16(p));
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[hi][e] *= alpha;
      for (int j = 0; j < KC && c0 + j < n_keys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pb, j);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[hi][e] += pj * vs[j][lane + 32 * e];
      }
      m[hi] = m_new;
    }
    __syncthreads();
  }

#pragma unroll
  for (int hi = 0; hi < MAX_HPW; ++hi) {
    const int h = warp + hi * WARPS;
    if (h >= rep) break;
    __nv_bfloat16* op = out + ((size_t)b * H + kvh * rep + h) * D;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const float o = acc[hi][e] / l[hi];
      op[lane + 32 * e] = __float2bfloat16(C::kScaled ? o * sv : o);
    }
  }
}

template <int D, bool PAGED, int KIND>
void launch_kind(dim3 grid, cudaStream_t s, const void* q, const void* new_k,
                 const void* new_v, void* cache_k, void* cache_v,
                 const void* tables, const void* lengths, void* out,
                 const void* k_scale, const void* v_scale, int B, int KVH,
                 int rep, int layer, int page, int chunks, int num_pages,
                 float inv_sqrt_d) {
  using T = typename ct::Cache<KIND>::T;
  flash_kernel<D, PAGED, KIND><<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(new_k),
      static_cast<const __nv_bfloat16*>(new_v), static_cast<T*>(cache_k),
      static_cast<T*>(cache_v), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), B,
      KVH, rep, layer, page, chunks, num_pages, inv_sqrt_d);
}

template <int D, bool PAGED>
int launch_d(int kind, dim3 grid, cudaStream_t s, const void* q,
             const void* new_k, const void* new_v, void* cache_k, void* cache_v,
             const void* tables, const void* lengths, void* out,
             const void* k_scale, const void* v_scale, int B, int KVH, int rep,
             int layer, int page, int chunks, int num_pages, float inv_sqrt_d) {
  switch (kind) {
    case ct::kCacheBF16:
      launch_kind<D, PAGED, ct::kCacheBF16>(
          grid, s, q, new_k, new_v, cache_k, cache_v, tables, lengths, out,
          k_scale, v_scale, B, KVH, rep, layer, page, chunks, num_pages, inv_sqrt_d);
      break;
    case ct::kCacheE4M3:
      launch_kind<D, PAGED, ct::kCacheE4M3>(
          grid, s, q, new_k, new_v, cache_k, cache_v, tables, lengths, out,
          k_scale, v_scale, B, KVH, rep, layer, page, chunks, num_pages, inv_sqrt_d);
      break;
    case ct::kCacheInt8:
      launch_kind<D, PAGED, ct::kCacheInt8>(
          grid, s, q, new_k, new_v, cache_k, cache_v, tables, lengths, out,
          k_scale, v_scale, B, KVH, rep, layer, page, chunks, num_pages, inv_sqrt_d);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED>
int launch(const void* q, const void* new_k, const void* new_v, void* cache_k,
           void* cache_v, const void* tables, const void* lengths, void* out,
           const void* k_scale, const void* v_scale, int B, int KVH, int rep,
           int layer, int page, int chunks, int num_pages, int D, int kind,
           float inv_sqrt_d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rep > WARPS * MAX_HPW) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(KVH, B);
  if (D == 64)
    return launch_d<64, PAGED>(kind, grid, s, q, new_k, new_v, cache_k, cache_v,
                               tables, lengths, out, k_scale, v_scale, B, KVH,
                               rep, layer, page, chunks, num_pages, inv_sqrt_d);
  if (D == 128)
    return launch_d<128, PAGED>(kind, grid, s, q, new_k, new_v, cache_k, cache_v,
                                tables, lengths, out, k_scale, v_scale, B, KVH,
                                rep, layer, page, chunks, num_pages, inv_sqrt_d);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Dense slab. q (B, H, D), new_k/new_v (B, KVH, D) bf16; cache_k/cache_v
// (L, B, KVH, S_pad, D) of cache type `kind` (ct::CacheKind); lengths (B,)
// int32; out (B, H, D) bf16; k_scale/v_scale (1,) f32, read only for the
// e4m3 and int8 caches. All contiguous. S_pad % chunk == 0, D in {64, 128},
// H / KVH <= 16.
extern "C" int ct_flash_decode(const void* q, const void* new_k, const void* new_v,
                               void* cache_k, void* cache_v, const void* lengths,
                               void* out, const void* k_scale, const void* v_scale,
                               int B, int KVH, int rep, int s_pad, int chunk,
                               int D, int layer, int kind, float inv_sqrt_d,
                               void* stream) {
  return launch<false>(q, new_k, new_v, cache_k, cache_v, nullptr, lengths, out,
                       k_scale, v_scale, B, KVH, rep, layer, chunk, s_pad / chunk,
                       0, D, kind, inv_sqrt_d, stream);
}

// Paged pool. pool_k/pool_v (L, NP, KVH, page, D) of cache type `kind`;
// tables (B, P) int32 page ids; the rest as for ct_flash_decode.
extern "C" int ct_paged_decode(const void* q, const void* new_k, const void* new_v,
                               void* pool_k, void* pool_v, const void* tables,
                               const void* lengths, void* out, const void* k_scale,
                               const void* v_scale, int B, int KVH, int rep,
                               int num_pages, int table_width, int page, int D,
                               int layer, int kind, float inv_sqrt_d,
                               void* stream) {
  return launch<true>(q, new_k, new_v, pool_k, pool_v, tables, lengths, out,
                      k_scale, v_scale, B, KVH, rep, layer, page, table_width,
                      num_pages, D, kind, inv_sqrt_d, stream);
}
