// One decode step of GQA attention on the stacked KV cache, for Hopper.
//
// Replaces compressed_tensors_tpu/ops/kernels/decode_attention.py:
// decode_attention (:290, pallas_call :417). One block of 4 warps per (kv
// head, batch row) on the cache (L, B, KVH, S_pad, D) at layer `layer`:
//   1. the new K/V row is written in place at position lengths[b] (when it
//      is below S_pad); a row with a negative length is left untouched and
//      its output is zero;
//   2. the group's query heads attend positions 0..lengths[b] (all S_pad
//      when the row is full). Positions past it are never read, so the
//      cost follows the row's length, not S_pad.
// Scores are (q . k) * 1/sqrt(D) in f32, and the probabilities are
// normalized with the row's exact max and sum and rounded to bf16 before
// P.V, as the TPU kernel does (decode_attention.py:233) and an online
// softmax cannot.
//
// Cache types (common.cuh, ct::Cache): bf16, or fp8 e4m3 / int8 with k/v
// scales, per tensor or per kv head (scale_stride 0 or 1). As in the TPU
// kernel (decode_attention.py:83-115, 203-259), the new row is quantized
// (x / scale) and written in its cache type, cached values are converted
// raw, k_scale folds into q (q * k_scale rounded to bf16) and v_scale
// multiplies the f32 output before its bf16 rounding.
//
// Bound on the H100: the bytes of the cache prefix it reads,
// B*KVH*(len+1)*D*sizeof(cache element) per K and V, against 3.35 TB/s.
// The design reads each of them once where the row's scores fit:
//   - the tensor cores: the `rep` query heads, padded to 16, are the A rows
//     of mma.sync m16n8k16 bf16; each warp takes 16 positions of a 64-
//     position tile: S = Q K^T, and P V with the probabilities as the A
//     fragment (the fragments of B6/B7, ct::decode_score16 / decode_pv16:
//     8-bit tiles are widened to bf16 in registers after ldmatrix);
//   - the cache in its own type by 16-byte cp.async, a ring of NU tiles
//     (K or V), so the next tiles are in flight while one is used, across
//     the two passes; the new row is put into its tile from registers;
//   - form "scores" (S_pad <= SCORE_POSITIONS, every call of
//     decode_attn="auto"): the K tiles' scores go to shared memory
//     (f32, rep rows of up to 512 positions, <= 33 KB), the block reduces
//     each head's exact max and sum there, and the V tiles' pass forms p =
//     bf16(exp(s - m) / l) from them: K and V are each read once;
//   - form "recompute" (longer rows, decode_attn="block"): the K pass keeps
//     each warp's running max and sum, the warps merge them, and a second
//     pass reads K again with V, recomputing the scores;
//   - the warps' outputs (already normalized) are summed in shared memory.
#include "common.cuh"

namespace {

constexpr int TILE = 64;                 // positions a tile
constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int QROWS = 16;                // query heads of a group, padded
constexpr int SCORE_POSITIONS = 512;     // form "scores" up to this S_pad

template <int D, int KIND>
struct Cfg {
  using T = typename ct::Cache<KIND>::T;
  static constexpr bool kRaw = KIND != ct::kCacheBF16;
  static constexpr int RS = D + 8;                    // q row stride (bf16)
  static constexpr int RB = kRaw ? D + 16 : 2 * RS;   // a cached row's bytes in a tile
  // ring tiles: 2 at D = 128 keep four blocks an SM (bf16: 2 tiles 0.0212
  // ms, 4 0.0271 on the H100; PERF.md), 4 at D = 64
  static constexpr int NU = D == 128 ? 2 : 4;
  static constexpr size_t Q_BYTES = (size_t)QROWS * RS * 2;
  static constexpr size_t UNIT = (size_t)TILE * RB;   // one K or V tile, own type
  static constexpr int OS = D + 4;                    // the warps' merge row stride
  static constexpr size_t MERGE = (size_t)WARPS * QROWS * OS * 4;
  static constexpr size_t MAIN = NU * UNIT > MERGE ? NU * UNIT : MERGE;
  // row max and sum (16 each), the warps' running max and sum (recompute)
  static constexpr size_t STATS = (2 * QROWS + 2 * WARPS * QROWS) * 4;
  static constexpr size_t BASE = Q_BYTES + MAIN + STATS;  // + the scores
};

// row stride (floats) of the score rows of a cache of s_pad positions
__host__ __device__ constexpr int score_stride(int s_pad) {
  return (s_pad + TILE - 1) / TILE * TILE + 8;
}

// four blocks an SM (at most 128 registers): a decode step's 256-512
// blocks of short rows fill the card in one wave
template <int D, int KIND, bool STORE>
__global__ void __launch_bounds__(THREADS, 4)
block_decode_kernel(const __nv_bfloat16* __restrict__ q,      // (B, H, D)
                    const __nv_bfloat16* __restrict__ new_k,  // (B, KVH, D)
                    const __nv_bfloat16* __restrict__ new_v,
                    typename ct::Cache<KIND>::T* __restrict__ cache_k,  // (L, B, KVH, S_pad, D)
                    typename ct::Cache<KIND>::T* __restrict__ cache_v,
                    const int* __restrict__ lengths,          // (B,)
                    __nv_bfloat16* __restrict__ out,          // (B, H, D)
                    const float* __restrict__ k_scale,        // scaled caches only
                    const float* __restrict__ v_scale,
                    int B, int KVH, int rep, int s_pad, int layer,
                    int scale_stride, float inv_sqrt_d) {
  using C = ct::Cache<KIND>;
  using G = Cfg<D, KIND>;
  using T = typename G::T;
  constexpr int RS = G::RS, RB = G::RB, NU = G::NU;
  extern __shared__ __align__(16) unsigned char smem[];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int H = KVH * rep;
  const int len = lengths[b];
  __nv_bfloat16* op = out + ((size_t)b * H + kvh * rep) * D;
  if (len < 0) {  // inactive row: cache untouched, output zero
    for (int i = tid; i < rep * D; i += THREADS) op[i] = __float2bfloat16(0.f);
    return;
  }
  const size_t row_off = (((size_t)layer * B + b) * KVH + kvh) * s_pad * D;
  T* ck = cache_k + row_off;
  T* cv = cache_v + row_off;
  const float sk = C::kScaled ? k_scale[kvh * scale_stride] : 1.f;
  const float sv = C::kScaled ? v_scale[kvh * scale_stride] : 1.f;

  // positions read from the cache, and attended (the new row at `cached`
  // when the row is below S_pad)
  const bool fresh = len < s_pad;
  const int cached = fresh ? len : s_pad;
  const int n_pos = fresh ? len + 1 : s_pad;
  const int tiles = (n_pos + TILE - 1) / TILE;

  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring = smem + G::Q_BYTES;
  float* rowm = reinterpret_cast<float*>(ring + G::MAIN);  // [16]
  float* rowl = rowm + QROWS;                               // [16]
  float* wm = rowl + QROWS;                                 // [WARPS][16]
  float* wl = wm + WARPS * QROWS;                           // [WARPS][16]
  float* sc = wl + WARPS * QROWS;                           // [rep][SCS]
  const int scs = score_stride(s_pad);

  // the units of the ring, in order: the K tiles (pass 1), then the V
  // tiles ("scores") or K and V of each tile in turn ("recompute")
  const int units = (STORE ? 2 : 3) * tiles;
  auto unit_tile = [&](int u) {
    return u < tiles ? u : STORE ? u - tiles : (u - tiles) >> 1;
  };
  auto unit_is_v = [&](int u) {
    return u >= tiles && (STORE || ((u - tiles) & 1));
  };
  constexpr int CPR = D * sizeof(T) / 16;  // 16-byte chunks a row
  auto load_unit = [&](int slot, int u) {
    unsigned char* base = ring + slot * G::UNIT;
    const T* src = unit_is_v(u) ? cv : ck;
    const int p0 = unit_tile(u) * TILE, ch = tid % CPR;
#pragma unroll
    for (int r = tid / CPR; r < TILE; r += THREADS / CPR) {
      const int pos = p0 + r;
      if (fresh && pos == cached) continue;  // the new row: put_new
      const bool ok = pos < cached;
      ct::cp_async16(base + r * RB + ch * 16,
                     src + (ok ? (size_t)pos * D + ch * (16 / sizeof(T)) : 0),
                     ok ? 16 : 0);
    }
  };
  // the first tiles in flight while the block writes the new row and
  // stages q (the copies skip the new row's position)
#pragma unroll
  for (int i = 0; i < NU - 1; ++i) {
    if (i < units) load_unit(i, i);
    ct::cp_async_commit();
  }

  // the new row in its cache representation (thread d: element d),
  // written in place and put into its tiles
  T nk = C::from_new(__float2bfloat16(0.f), 1.f), nv = nk;
  if (fresh && tid < D) {
    const size_t src = ((size_t)b * KVH + kvh) * D + tid;
    nk = C::from_new(new_k[src], sk);
    nv = C::from_new(new_v[src], sv);
    ck[(size_t)len * D + tid] = nk;
    cv[(size_t)len * D + tid] = nv;
  }
  // q of the group's heads (k_scale folded, rounded to bf16), rows past rep
  // 0, in the order of an 8-bit K fragment's k indices
  for (int i = tid; i < QROWS * D; i += THREADS) {
    const int h = i / D, d = i % D;
    float qv = 0.f;
    if (h < rep) {
      qv = __bfloat162float(q[((size_t)b * H + kvh * rep + h) * D + d]);
      if (C::kScaled) qv = __bfloat162float(__float2bfloat16(qv * sk));
    }
    qs[h * RS + ct::decode_q_col<G::kRaw>(d)] = __float2bfloat16(qv);
  }

  auto put_new = [&](unsigned char* base, int u) {
    const int r = cached - unit_tile(u) * TILE;
    if (fresh && r >= 0 && r < TILE && tid < D)
      reinterpret_cast<T*>(base + r * RB)[tid] = unit_is_v(u) ? nv : nk;
  };

  uint32_t pf[4];
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // recompute: pass 1

  // the probability of head `row` at score s, rounded to bf16
  auto prob = [&](int row, float s) {
    return row < rep ? expf(s - rowm[row]) / rowl[row] : 0.f;
  };

  for (int u = 0, slot = 0; u < units; ++u, slot = slot == NU - 1 ? 0 : slot + 1) {
    ct::cp_async_wait<NU - 2>();  // unit u has landed (this thread's copies)
    unsigned char* base = ring + slot * G::UNIT;
    put_new(base, u);
    __syncthreads();  // unit u visible; every warp is done with unit u - 1
    if (u + NU - 1 < units)
      load_unit(slot == 0 ? NU - 1 : slot - 1, u + NU - 1);
    ct::cp_async_commit();

    if (u == tiles) {  // pass 1 is done: each head's max and sum
      if constexpr (STORE) {
        for (int r = warp; r < QROWS; r += WARPS) {
          float mx = -INFINITY, l = 0.f;
          if (r < rep) {
            for (int p = lane; p < n_pos; p += 32) mx = fmaxf(mx, sc[r * scs + p]);
            mx = ct::warp_max(mx);  // position 0 is live: finite
            for (int p = lane; p < n_pos; p += 32) l += expf(sc[r * scs + p] - mx);
            l = ct::warp_sum(l);
          }
          if (lane == 0) {
            rowm[r] = mx;
            rowl[r] = l;
          }
        }
      } else {
#pragma unroll
        for (int x = 1; x <= 2; x <<= 1) {
          l0 += __shfl_xor_sync(0xffffffffu, l0, x);
          l1 += __shfl_xor_sync(0xffffffffu, l1, x);
        }
        if (t == 0) {
          wm[warp * QROWS + g] = m0;
          wm[warp * QROWS + g + 8] = m1;
          wl[warp * QROWS + g] = l0;
          wl[warp * QROWS + g + 8] = l1;
        }
        __syncthreads();
        if (tid < QROWS) {  // warp 0 holds position 0: the max is finite
          float mx = -INFINITY, l = 0.f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w * QROWS + tid]);
#pragma unroll
          for (int w = 0; w < WARPS; ++w)
            l += wl[w * QROWS + tid] * expf(wm[w * QROWS + tid] - mx);
          rowm[tid] = mx;
          rowl[tid] = l;
        }
      }
      __syncthreads();
    }

    // this warp's 16 positions of the tile
    const int w0 = unit_tile(u) * TILE + warp * 16;
    if (w0 >= n_pos) continue;
    if (!unit_is_v(u)) {
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      uint32_t qf[D / 16][4];  // q read again a K tile: registers for o
      ct::decode_q_frags<D>(qf, qs, RS, lane);
      ct::decode_score16<D, KIND>(s, qf, base, RB, warp * 16, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int pos = w0 + j * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = pos + (e & 1) < n_pos ? s[j][e] * inv_sqrt_d : -INFINITY;
      }
      if (u < tiles) {
        if constexpr (STORE) {  // rows g, g + 8 of the heads into the scores
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int pos = w0 + j * 8 + 2 * t;
            if (g < rep)
              *reinterpret_cast<float2*>(sc + g * scs + pos) = make_float2(s[j][0], s[j][1]);
            if (g + 8 < rep)
              *reinterpret_cast<float2*>(sc + (g + 8) * scs + pos) =
                  make_float2(s[j][2], s[j][3]);
          }
        } else {  // the warp's running max and sum (position w0 is live)
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
          l0 *= expf(m0 - mx0);
          l1 *= expf(m1 - mx1);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            l0 += expf(s[j][0] - mx0) + expf(s[j][1] - mx0);
            l1 += expf(s[j][2] - mx1) + expf(s[j][3] - mx1);
          }
          m0 = mx0;
          m1 = mx1;
        }
      } else {  // recompute: P of the tile for its V unit, next
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          pf[2 * j] = ct::pack_bf16x2(prob(g, s[j][0]), prob(g, s[j][1]));
          pf[2 * j + 1] = ct::pack_bf16x2(prob(g + 8, s[j][2]), prob(g + 8, s[j][3]));
        }
      }
    } else {
      if constexpr (STORE) {  // P from the stored scores (-inf past n_pos)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int pos = w0 + j * 8 + 2 * t;
          const float2 a = g < rep ? *reinterpret_cast<const float2*>(sc + g * scs + pos)
                                   : make_float2(0.f, 0.f);
          const float2 c = g + 8 < rep
                               ? *reinterpret_cast<const float2*>(sc + (g + 8) * scs + pos)
                               : make_float2(0.f, 0.f);
          pf[2 * j] = ct::pack_bf16x2(prob(g, a.x), prob(g, a.y));
          pf[2 * j + 1] = ct::pack_bf16x2(prob(g + 8, c.x), prob(g + 8, c.y));
        }
      }
      ct::decode_pv16<D, KIND>(o, pf, base, RB, warp * 16, lane);
    }
  }

  // the warps' outputs summed in shared memory (the ring is free)
  ct::cp_async_wait<0>();
  __syncthreads();
  float* os = reinterpret_cast<float*>(ring);  // [WARPS][16][OS]
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      os[(warp * QROWS + g + 8 * (e >> 1)) * G::OS + ct::decode_o_col<G::kRaw>(i, e, t)] =
          o[i][e];
  __syncthreads();
  for (int i = tid; i < rep * D; i += THREADS) {
    const int r = i / D, d = i % D;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) acc += os[(w * QROWS + r) * G::OS + d];
    op[i] = __float2bfloat16(C::kScaled ? acc * sv : acc);
  }
}

template <int D, int KIND, bool STORE>
int launch_form(dim3 grid, cudaStream_t s, const void* q, const void* new_k,
                const void* new_v, void* cache_k, void* cache_v,
                const void* lengths, void* out, const void* k_scale,
                const void* v_scale, int B, int KVH, int rep, int s_pad,
                int layer, int scale_stride, float inv_sqrt_d) {
  using T = typename ct::Cache<KIND>::T;
  using G = Cfg<D, KIND>;
  auto* kernel = block_decode_kernel<D, KIND, STORE>;
  constexpr size_t most =
      G::BASE + (STORE ? (size_t)QROWS * score_stride(SCORE_POSITIONS) * 4 : 0);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const size_t smem = G::BASE + (STORE ? (size_t)rep * score_stride(s_pad) * 4 : 0);
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(new_k),
      static_cast<const __nv_bfloat16*>(new_v), static_cast<T*>(cache_k),
      static_cast<T*>(cache_v), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), B, KVH, rep, s_pad, layer,
      scale_stride, inv_sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int KIND>
int launch_kind(bool store, dim3 grid, cudaStream_t s, const void* q,
                const void* new_k, const void* new_v, void* cache_k,
                void* cache_v, const void* lengths, void* out,
                const void* k_scale, const void* v_scale, int B, int KVH,
                int rep, int s_pad, int layer, int scale_stride,
                float inv_sqrt_d) {
  return store
      ? launch_form<D, KIND, true>(grid, s, q, new_k, new_v, cache_k, cache_v,
                                   lengths, out, k_scale, v_scale, B, KVH, rep,
                                   s_pad, layer, scale_stride, inv_sqrt_d)
      : launch_form<D, KIND, false>(grid, s, q, new_k, new_v, cache_k, cache_v,
                                    lengths, out, k_scale, v_scale, B, KVH, rep,
                                    s_pad, layer, scale_stride, inv_sqrt_d);
}

template <int D>
int launch_d(int kind, bool store, dim3 grid, cudaStream_t s, const void* q,
             const void* new_k, const void* new_v, void* cache_k, void* cache_v,
             const void* lengths, void* out, const void* k_scale,
             const void* v_scale, int B, int KVH, int rep, int s_pad, int layer,
             int scale_stride, float inv_sqrt_d) {
  switch (kind) {
    case ct::kCacheBF16:
      return launch_kind<D, ct::kCacheBF16>(store, grid, s, q, new_k, new_v, cache_k,
                                            cache_v, lengths, out, k_scale, v_scale, B,
                                            KVH, rep, s_pad, layer, scale_stride,
                                            inv_sqrt_d);
    case ct::kCacheE4M3:
      return launch_kind<D, ct::kCacheE4M3>(store, grid, s, q, new_k, new_v, cache_k,
                                            cache_v, lengths, out, k_scale, v_scale, B,
                                            KVH, rep, s_pad, layer, scale_stride,
                                            inv_sqrt_d);
    case ct::kCacheInt8:
      return launch_kind<D, ct::kCacheInt8>(store, grid, s, q, new_k, new_v, cache_k,
                                            cache_v, lengths, out, k_scale, v_scale, B,
                                            KVH, rep, s_pad, layer, scale_stride,
                                            inv_sqrt_d);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, H, D), new_k/new_v (B, KVH, D) bf16; cache_k/cache_v (L, B, KVH,
// S_pad, D) of cache type `kind` (ct::CacheKind); lengths (B,) int32; out
// (B, H, D) bf16; k_scale/v_scale f32, one value (scale_stride 0) or one per
// kv head (scale_stride 1), read only for the e4m3 and int8 caches. All
// contiguous. D in {64, 128}, rep = H / KVH <= 16; store selects form
// "scores" (S_pad <= 512) over "recompute".
extern "C" int ct_decode_attention(const void* q, const void* new_k,
                                   const void* new_v, void* cache_k,
                                   void* cache_v, const void* lengths, void* out,
                                   const void* k_scale, const void* v_scale,
                                   int B, int KVH, int rep, int s_pad, int D,
                                   int layer, int kind, int scale_stride,
                                   int store, float inv_sqrt_d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rep < 1 || rep > QROWS || s_pad < 1 || (store && s_pad > SCORE_POSITIONS))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(KVH, B);
  if (D == 64)
    return launch_d<64>(kind, store, grid, s, q, new_k, new_v, cache_k, cache_v,
                        lengths, out, k_scale, v_scale, B, KVH, rep, s_pad, layer,
                        scale_stride, inv_sqrt_d);
  if (D == 128)
    return launch_d<128>(kind, store, grid, s, q, new_k, new_v, cache_k, cache_v,
                         lengths, out, k_scale, v_scale, B, KVH, rep, s_pad, layer,
                         scale_stride, inv_sqrt_d);
  return static_cast<int>(cudaErrorInvalidValue);
}
