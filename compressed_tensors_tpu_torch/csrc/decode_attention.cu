// One decode step of GQA attention on the stacked KV cache, for Hopper.
//
// Replaces compressed_tensors_tpu/ops/kernels/decode_attention.py:
// decode_attention. One block per (kv head, batch row) on the cache
// (L, B, KVH, S_pad, D) at layer `layer`:
//   1. the new K/V row is written in place at position lengths[b]; a row
//      with a negative length is left untouched (and its output is zero);
//   2. the block stages 32-key chunks of K and V for positions
//      0..lengths[b] in shared memory, and each warp runs the softmax in
//      f32 for its query heads of the group: lane j scores key j, the warp
//      reduces max and sum with shuffles, and each lane accumulates D/32
//      output dims.
// Positions past lengths[b] are never read, so the cost follows the
// row's length, not S_pad. Scores are (q . k) * 1/sqrt(D) in f32 as in the
// TPU kernel, which normalizes the probabilities and rounds them to bf16
// before P.V (decode_attention.py:233). So does this kernel, in two passes
// over the keys: the first finds each head's softmax max and sum, the
// second forms p = exp(s - max) / sum, rounds it to bf16 and accumulates
// P.V in f32.
//
// Cache types (common.cuh, ct::Cache): bf16, or fp8 e4m3 / int8 with
// k/v scales, per tensor or per kv head (scale_stride 0 or 1). As in the
// TPU kernel (decode_attention.py:83-115, 203-259), the new row is
// quantized (x / scale) and written in its cache type, cached values are
// converted raw, k_scale folds into q (q * k_scale rounded to bf16) and
// v_scale multiplies the f32 output before its bf16 rounding: no
// per-element scale work on the cache.
//
// Bound on the H100: the bytes of the cache prefix it reads,
// B*KVH*(len+1)*D*sizeof(cache element) per K and V, against 3.35 TB/s;
// the first pass reads K a second time.
#include "common.cuh"

namespace {

constexpr int KC = 32, THREADS = 256, WARPS = THREADS / 32, MAX_HPW = 2;

template <int D, int KIND>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const __nv_bfloat16* __restrict__ q,      // (B, H, D)
              const __nv_bfloat16* __restrict__ new_k,  // (B, KVH, D)
              const __nv_bfloat16* __restrict__ new_v,
              typename ct::Cache<KIND>::T* __restrict__ cache_k,  // (L, B, KVH, S_pad, D)
              typename ct::Cache<KIND>::T* __restrict__ cache_v,
              const int* __restrict__ lengths,          // (B,)
              __nv_bfloat16* __restrict__ out,          // (B, H, D)
              const float* __restrict__ k_scale,        // scaled caches only
              const float* __restrict__ v_scale,
              int B, int KVH, int rep, int s_pad, int layer, int scale_stride,
              float inv_sqrt_d) {
  using C = ct::Cache<KIND>;
  constexpr int DPL = D / 32;  // output dims per lane
  __shared__ float qs[WARPS * MAX_HPW][D];
  __shared__ float ks[KC][D + 1];
  __shared__ float vs[KC][D];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = KVH * rep;
  const int len = lengths[b];
  const size_t row_off = (((size_t)layer * B + b) * KVH + kvh) * s_pad * D;
  typename C::T* ck = cache_k + row_off;
  typename C::T* cv = cache_v + row_off;

  if (len < 0) {  // inactive row: cache untouched, output zero
    for (int i = tid; i < rep * D; i += THREADS)
      out[((size_t)b * H + kvh * rep) * D + i] = __float2bfloat16(0.f);
    return;
  }
  const float sk = C::kScaled ? k_scale[kvh * scale_stride] : 1.f;
  const float sv = C::kScaled ? v_scale[kvh * scale_stride] : 1.f;
  if (len < s_pad) {
    const size_t src = ((size_t)b * KVH + kvh) * D;
    for (int d = tid; d < D; d += THREADS) {
      ck[(size_t)len * D + d] = C::from_new(new_k[src + d], sk);
      cv[(size_t)len * D + d] = C::from_new(new_v[src + d], sv);
    }
  }
  for (int i = tid; i < rep * D; i += THREADS) {
    const float qv = __bfloat162float(q[((size_t)b * H + kvh * rep) * D + i]);
    qs[i / D][i % D] =
        C::kScaled ? __bfloat162float(__float2bfloat16(qv * sk)) : qv;
  }
  __syncthreads();  // the new row and q are visible to the whole block

  const int n_keys = min(len, s_pad - 1) + 1;
  float m[MAX_HPW], l[MAX_HPW], acc[MAX_HPW][DPL];
#pragma unroll
  for (int i = 0; i < MAX_HPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }

  // stage keys [c0, c0 + KC) (and their values) as f32; zeros past n_keys
  auto stage = [&](int c0, bool values) {
    for (int i = tid; i < KC * D / 2; i += THREADS) {
      const int j = i / (D / 2), d2 = (i % (D / 2)) * 2;
      float2 kf = make_float2(0.f, 0.f), vf = make_float2(0.f, 0.f);
      if (c0 + j < n_keys) {
        const size_t off = (size_t)(c0 + j) * D + d2;
        kf = C::load2(ck + off);
        if (values) vf = C::load2(cv + off);
      }
      ks[j][d2] = kf.x; ks[j][d2 + 1] = kf.y;
      if (values) { vs[j][d2] = vf.x; vs[j][d2 + 1] = vf.y; }
    }
    __syncthreads();
  };
  // lane's score for key c0 + lane of head h; -inf past n_keys
  auto score = [&](int c0, int h) {
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) dot += qs[h][d] * ks[lane][d];
    return (c0 + lane < n_keys) ? dot * inv_sqrt_d : -INFINITY;
  };

  // pass 1: each head's softmax max and sum
  for (int c0 = 0; c0 < n_keys; c0 += KC) {
    stage(c0, false);
#pragma unroll
    for (int hi = 0; hi < MAX_HPW; ++hi) {
      const int h = warp + hi * WARPS;
      if (h >= rep) break;
      const float s = score(c0, h);
      const float m_new = fmaxf(m[hi], ct::warp_max(s));  // key c0 is live
      l[hi] = l[hi] * expf(m[hi] - m_new) + ct::warp_sum(expf(s - m_new));
      m[hi] = m_new;
    }
    __syncthreads();
  }
  // pass 2: normalized probabilities, rounded to bf16, times V
  for (int c0 = 0; c0 < n_keys; c0 += KC) {
    stage(c0, true);
#pragma unroll
    for (int hi = 0; hi < MAX_HPW; ++hi) {
      const int h = warp + hi * WARPS;
      if (h >= rep) break;
      const float p = __bfloat162float(
          __float2bfloat16(expf(score(c0, h) - m[hi]) / l[hi]));
      for (int j = 0; j < KC && c0 + j < n_keys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[hi][e] += pj * vs[j][lane + 32 * e];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int hi = 0; hi < MAX_HPW; ++hi) {
    const int h = warp + hi * WARPS;
    if (h >= rep) break;
    __nv_bfloat16* op = out + ((size_t)b * H + kvh * rep + h) * D;
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      op[lane + 32 * e] = __float2bfloat16(C::kScaled ? acc[hi][e] * sv : acc[hi][e]);
  }
}

template <int D, int KIND>
void launch_kind(dim3 grid, cudaStream_t s, const void* q, const void* new_k,
                 const void* new_v, void* cache_k, void* cache_v,
                 const void* lengths, void* out, const void* k_scale,
                 const void* v_scale, int B, int KVH, int rep, int s_pad,
                 int layer, int scale_stride, float inv_sqrt_d) {
  using T = typename ct::Cache<KIND>::T;
  decode_kernel<D, KIND><<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(new_k),
      static_cast<const __nv_bfloat16*>(new_v), static_cast<T*>(cache_k),
      static_cast<T*>(cache_v), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), B, KVH, rep, s_pad, layer,
      scale_stride, inv_sqrt_d);
}

template <int D>
int launch_d(int kind, dim3 grid, cudaStream_t s, const void* q,
             const void* new_k, const void* new_v, void* cache_k, void* cache_v,
             const void* lengths, void* out, const void* k_scale,
             const void* v_scale, int B, int KVH, int rep, int s_pad, int layer,
             int scale_stride, float inv_sqrt_d) {
  switch (kind) {
    case ct::kCacheBF16:
      launch_kind<D, ct::kCacheBF16>(grid, s, q, new_k, new_v, cache_k, cache_v,
                                     lengths, out, k_scale, v_scale, B, KVH, rep,
                                     s_pad, layer, scale_stride, inv_sqrt_d);
      break;
    case ct::kCacheE4M3:
      launch_kind<D, ct::kCacheE4M3>(grid, s, q, new_k, new_v, cache_k, cache_v,
                                     lengths, out, k_scale, v_scale, B, KVH, rep,
                                     s_pad, layer, scale_stride, inv_sqrt_d);
      break;
    case ct::kCacheInt8:
      launch_kind<D, ct::kCacheInt8>(grid, s, q, new_k, new_v, cache_k, cache_v,
                                     lengths, out, k_scale, v_scale, B, KVH, rep,
                                     s_pad, layer, scale_stride, inv_sqrt_d);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, D), new_k/new_v (B, KVH, D) bf16; cache_k/cache_v (L, B, KVH,
// S_pad, D) of cache type `kind` (ct::CacheKind); lengths (B,) int32; out
// (B, H, D) bf16; k_scale/v_scale f32, one value (scale_stride 0) or one per
// kv head (scale_stride 1), read only for the e4m3 and int8 caches. All
// contiguous. D in {64, 128} and rep = H / KVH <= 16.
extern "C" int ct_decode_attention(const void* q, const void* new_k,
                                   const void* new_v, void* cache_k,
                                   void* cache_v, const void* lengths, void* out,
                                   const void* k_scale, const void* v_scale,
                                   int B, int KVH, int rep, int s_pad, int D,
                                   int layer, int kind, int scale_stride,
                                   float inv_sqrt_d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rep > WARPS * MAX_HPW) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(KVH, B);
  if (D == 64)
    return launch_d<64>(kind, grid, s, q, new_k, new_v, cache_k, cache_v, lengths,
                        out, k_scale, v_scale, B, KVH, rep, s_pad, layer,
                        scale_stride, inv_sqrt_d);
  if (D == 128)
    return launch_d<128>(kind, grid, s, q, new_k, new_v, cache_k, cache_v, lengths,
                         out, k_scale, v_scale, B, KVH, rep, s_pad, layer,
                         scale_stride, inv_sqrt_d);
  return static_cast<int>(cudaErrorInvalidValue);
}
