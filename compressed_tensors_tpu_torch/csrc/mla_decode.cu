// Latent-head decode attention for Hopper (MLA, DeepSeek V2/V3): one kernel
// body templated on PAGED, two entry points, B5-L on the dense slab cache
// and B7-L on the paged pool.
//
// Replaces compressed_tensors_tpu/ops/kernels/decode_attention.py:
// decode_attention and compressed_tensors_tpu/ops/kernels/paged_decode.py:
// paged_decode_attention at the call shape of compressed_tensors_tpu/
// models/mla.py:149-165 (kvh=1, rep=h, d=Dp, true_d=nope+rope): the
// absorbed MLA decode step, h query heads over one latent head whose K rows
// are [c_kv ; k_pe] (Dk wide, 576 for DeepSeek-V2-Lite) and V rows c_kv (Dv
// wide, 512). Position p of row b is at b * S_pad + p of the slab cache
// (L, B, 1, S_pad, D), or at p % page of pool page tables[b, p / page] of
// the pool (L, NP, 1, page, D); only positions 0..lengths[b] are touched.
// Any number of query heads: the heads go in groups of 16 (the rows of one
// mma tile), the last group padded and masked.
//
// Bound on the H100: the live cache bytes, sum(len + 1) * (Dk + Dv) *
// sizeof(cache element) per layer, against 3.35 TB/s (the products are 2 h
// (Dk + Dv) operations a position: far below the tensor cores' rate). The
// design keeps the card full at one kv head and keeps the wide rows out of
// registers:
//   - the keys split as in the flash / paged decode kernels
//     (csrc/paged_decode.cu): grid ((row, head group), split), a split `per`
//     runs of 64 positions, a second pass merging a row's splits (not
//     launched when the capacity fits one split). One kv head gives B
//     blocks a split where the GQA kernels have KVH * B, so the splits
//     fill the 132 SMs;
//   - more than 16 query heads (DeepSeek-V2/V3's 128) take one block a
//     group of 16 heads: the 16 x Dv f32 output of a group is all the
//     registers of a block hold. The head group is the fastest part of
//     grid.x (no limit on B), so the groups of one (row, split) are
//     launched next to each other and may read each K/V tile while it is
//     in L2 (the HBM reads of the cache at 128 heads are not measured:
//     PERF.md);
//   - a tile of 32 positions, K and V in the cache's own bytes (bf16, e4m3
//     or int8), copied with 16-byte cp.async into a ring of two stages, the
//     next tile in flight while one is used;
//   - q (16 rows of Dk, 18 KB in bf16) lives in shared memory, not in
//     registers, and is read by ldmatrix a k-step at a time;
//   - the tensor cores (mma.sync m16n8k16 bf16, the query heads padded to
//     16 rows): S = Q K^T with each of the 4 warps taking 8 positions of
//     the tile over the whole Dk; one online softmax a head for the block
//     (8 threads a head, the scores and probabilities through shared
//     memory); P V with each warp taking a quarter of the Dv output
//     columns, so the 16 x Dv f32 output (32 KB at Dv 512) is spread over
//     the 4 warps' registers. 8-bit K and V are widened to bf16 (exact) as
//     their fragments are read.
// A row with a negative length is inactive: its output is zero and no
// cache byte of it is read or written. The step's K/V rows are written in
// place at position lengths[b] by the first head group's block whose split
// holds it; every group's block puts the same values into its own tile
// (no block reads that position from the cache).
//
// Arithmetic as the TPU kernels: a bf16 cache holds the rows as they are;
// an e4m3 or int8 cache holds x / scale (per-tensor scales), read back with
// a raw conversion, k_scale folded into q (q * k_scale rounded to bf16) and
// v_scale onto the normalized f32 output. Scores are bf16 q . bf16 k summed
// in f32, times inv_sqrt_d = 1/sqrt(true_d); the online softmax runs in
// f32, each tile's unnormalized probabilities rounded to bf16 against the
// running max before P.V, their f32 sum dividing.
#include "common.cuh"

namespace {

constexpr int TILE = 32;              // positions a tile
constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int QROWS = 16;             // query heads a block (a head group)
constexpr int MAX_D = 640;            // widest K row
constexpr int MAX_NT = MAX_D / WARPS / 8;  // n8 output tiles a warp
constexpr int SS = TILE + 4;          // f32 score row stride
constexpr int PS = TILE + 8;          // bf16 probability row stride

// The shared memory of a block, in bytes from its start.
struct Layout {
  int rbk, rbv;        // K / V row stride in a stage
  int rsq;             // q row stride, bf16 elements
  size_t stage, kv_off, s_off, p_off, a_off, total;
  __host__ __device__ Layout(int dk, int dv, int isz) {
    rbk = dk * isz + 16;
    rbv = dv * isz + 16;
    rsq = dk + 8;
    stage = (size_t)TILE * (rbk + rbv);
    kv_off = (size_t)QROWS * rsq * 2;
    s_off = kv_off + 2 * stage;
    p_off = s_off + (size_t)QROWS * SS * 4;
    a_off = p_off + (size_t)QROWS * PS * 2;
    total = a_off + 3 * QROWS * 4;
  }
};

// elements idx, idx + 1 of a staged row as a bf16 pair (low half: idx)
template <int KIND>
__device__ __forceinline__ uint32_t row_pair(const unsigned char* row, int idx) {
  if constexpr (KIND == ct::kCacheBF16) {
    return ct::ld_shared_u32(row + idx * 2);
  } else {
    return ct::Cache<KIND>::widen2(*reinterpret_cast<const uint16_t*>(row + idx));
  }
}

// column col of staged rows k and k + 1 as a bf16 pair (low half: row k)
template <int KIND>
__device__ __forceinline__ uint32_t col_pair(const unsigned char* tile, int rb, int k,
                                             int col) {
  if constexpr (KIND == ct::kCacheBF16) {
    const uint32_t lo = *reinterpret_cast<const uint16_t*>(tile + k * rb + col * 2);
    const uint32_t hi = *reinterpret_cast<const uint16_t*>(tile + (k + 1) * rb + col * 2);
    return lo | (hi << 16);
  } else {
    const uint32_t lo = tile[k * rb + col], hi = tile[(k + 1) * rb + col];
    return ct::Cache<KIND>::widen2(lo | (hi << 8));
  }
}

template <bool PAGED, int KIND>
__global__ void __launch_bounds__(THREADS)
latent_kernel(const __nv_bfloat16* __restrict__ q,      // (B, H, Dk)
              const __nv_bfloat16* __restrict__ new_k,  // (B, 1, Dk)
              const __nv_bfloat16* __restrict__ new_v,  // (B, 1, Dv)
              typename ct::Cache<KIND>::T* __restrict__ cache_k,  // slab or pool
              typename ct::Cache<KIND>::T* __restrict__ cache_v,
              const int* __restrict__ tables,           // (B, table_width) or null
              const int* __restrict__ lengths,          // (B,)
              __nv_bfloat16* __restrict__ out,          // (B, H, Dv)
              float2* __restrict__ part_ml,             // (B, splits, H)
              float* __restrict__ part_o,               // (B, splits, H, Dv)
              const float* __restrict__ k_scale,        // (1,), scaled caches
              const float* __restrict__ v_scale, int B, int H, int Dk, int Dv,
              int layer, int page, int capacity, int table_width, int num_pages,
              int span, int splits, float inv_sqrt_d) {
  using C = ct::Cache<KIND>;
  using T = typename C::T;
  constexpr int ISZ = sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];

  // grid.x runs over (row, head group), the groups of a row adjacent
  const int groups = (H + QROWS - 1) / QROWS, hg = blockIdx.x % groups;
  const int b = blockIdx.x / groups, z = blockIdx.y;
  const int h0 = hg * QROWS, hn = min(QROWS, H - h0);  // this group
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = lengths[b];
  if (len < 0) {  // inactive: block z = 0 of each group writes its zeros
    if (z == 0)
      for (int e = tid; e < hn * Dv; e += THREADS)
        out[((size_t)b * H + h0) * Dv + e] = __float2bfloat16(0.f);
    return;
  }
  const int cached = min(len, capacity);  // positions read from the cache
  const int n_pos = cached + 1;           // and the new token at `cached`
  const int p0 = z * span;
  if (p0 >= n_pos) return;
  const int p1 = min(p0 + span, n_pos);

  const Layout lay(Dk, Dv, ISZ);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* ss = reinterpret_cast<float*>(smem + lay.s_off);           // [16][SS]
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + lay.p_off);  // [16][PS]
  float* alpha_s = reinterpret_cast<float*>(smem + lay.a_off);      // [16]
  float* rowm = alpha_s + QROWS;
  float* rowl = rowm + QROWS;

  // row offset (elements) of cached position `pos` in a cache of width d
  auto offset = [&](int pos, int d) -> size_t {
    if (PAGED) {
      const int c = pos / page;
      return (((size_t)layer * num_pages + tables[(size_t)b * table_width + c]) * page +
              (pos - c * page)) * d;
    }
    return (((size_t)layer * B + b) * capacity + pos) * d;
  };

  const float sk = C::kScaled ? k_scale[0] : 1.f;
  const float sv = C::kScaled ? v_scale[0] : 1.f;
  // the first group's block holding the new token writes its rows in place
  if (hg == 0 && cached < p1 && len < capacity) {
    for (int d = tid; d < Dk; d += THREADS)
      cache_k[offset(len, Dk) + d] = C::from_new(new_k[(size_t)b * Dk + d], sk);
    for (int d = tid; d < Dv; d += THREADS)
      cache_v[offset(len, Dv) + d] = C::from_new(new_v[(size_t)b * Dv + d], sv);
  }
  // the group's q rows (k_scale folded, rounded to bf16), rows past H zero
  for (int i = tid; i < QROWS * Dk; i += THREADS) {
    const int h = i / Dk, d = i - h * Dk;
    float qv = 0.f;
    if (h < hn) {
      qv = __bfloat162float(q[((size_t)b * H + h0 + h) * Dk + d]);
      if (C::kScaled) qv = __bfloat162float(__float2bfloat16(qv * sk));
    }
    qs[h * lay.rsq + d] = __float2bfloat16(qv);
  }

  // tile tt's copies into stage st: cached positions only, positions past
  // the cache zero-filled, the new token's row left to put_new
  const int ck = Dk * ISZ / 16, cvc = Dv * ISZ / 16;  // 16-byte chunks a row
  auto load_tile = [&](int st, int tt) {
    unsigned char* kt = smem + lay.kv_off + st * lay.stage;
    unsigned char* vt = kt + (size_t)TILE * lay.rbk;
    for (int i = tid; i < TILE * ck; i += THREADS) {
      const int r = i / ck, c = i - r * ck, pos = tt * TILE + r;
      if (pos == cached) continue;
      const bool ok = pos < cached;
      const T* src = ok ? cache_k + offset(pos, Dk) + c * (16 / ISZ) : cache_k;
      ct::cp_async16(kt + r * lay.rbk + c * 16, src, ok ? 16 : 0);
    }
    for (int i = tid; i < TILE * cvc; i += THREADS) {
      const int r = i / cvc, c = i - r * cvc, pos = tt * TILE + r;
      if (pos == cached) continue;
      const bool ok = pos < cached;
      const T* src = ok ? cache_v + offset(pos, Dv) + c * (16 / ISZ) : cache_v;
      ct::cp_async16(vt + r * lay.rbv + c * 16, src, ok ? 16 : 0);
    }
  };
  auto put_new = [&](int st, int tt) {
    const int r = cached - tt * TILE;
    if (r < 0 || r >= TILE) return;
    T* kt = reinterpret_cast<T*>(smem + lay.kv_off + st * lay.stage + r * lay.rbk);
    T* vt = reinterpret_cast<T*>(smem + lay.kv_off + st * lay.stage +
                                 (size_t)TILE * lay.rbk + r * lay.rbv);
    for (int d = tid; d < Dk; d += THREADS)
      kt[d] = C::from_new(new_k[(size_t)b * Dk + d], sk);
    for (int d = tid; d < Dv; d += THREADS)
      vt[d] = C::from_new(new_v[(size_t)b * Dv + d], sv);
  };

  const int g = lane >> 2, t = lane & 3, mi = lane >> 3;
  // softmax: 8 threads a head, 4 positions each
  const int srow = tid >> 3, sub = tid & 7;
  float m_run = -INFINITY, l_run = 0.f;
  // this warp's output columns col0 .. col0 + Dv / 4
  const int nt = Dv / 32, col0 = warp * (Dv / 4);
  float o[MAX_NT][4];
#pragma unroll
  for (int i = 0; i < MAX_NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;

  const int t0 = p0 / TILE, t1 = (p1 + TILE - 1) / TILE;
  load_tile(0, t0);
  ct::cp_async_commit();
  for (int tt = t0, st = 0; tt < t1; ++tt, st ^= 1) {
    if (tt + 1 < t1) load_tile(st ^ 1, tt + 1);
    ct::cp_async_commit();
    ct::cp_async_wait<1>();  // tile tt has landed (this thread's copies)
    put_new(st, tt);
    __syncthreads();  // tile tt and q visible to every warp

    // S = Q K^T: this warp's 8 positions over the whole Dk
    const unsigned char* kt = smem + lay.kv_off + st * lay.stage;
    const unsigned char* vt = kt + (size_t)TILE * lay.rbk;
    {
      // two independent accumulators (even and odd k-steps; Dk / 16 is even)
      float sacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const unsigned char* krow = kt + (warp * 8 + g) * lay.rbk;
      const __nv_bfloat16* qa = qs + ((mi & 1) * 8 + (lane & 7)) * lay.rsq + (mi >> 1) * 8;
      for (int kk = 0; kk < Dk / 16; kk += 2) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          uint32_t a[4], bf[2];
          ct::ldmatrix_x4(a, qa + (kk + u) * 16);
          bf[0] = row_pair<KIND>(krow, (kk + u) * 16 + 2 * t);
          bf[1] = row_pair<KIND>(krow, (kk + u) * 16 + 2 * t + 8);
          ct::mma_bf16_16816(sacc[u], a, bf);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[0][e] += sacc[1][e];
      const int c = warp * 8 + 2 * t;
      ss[g * SS + c] = sacc[0][0] * inv_sqrt_d;
      ss[g * SS + c + 1] = sacc[0][1] * inv_sqrt_d;
      ss[(g + 8) * SS + c] = sacc[0][2] * inv_sqrt_d;
      ss[(g + 8) * SS + c + 1] = sacc[0][3] * inv_sqrt_d;
    }
    __syncthreads();

    // online softmax of head srow over the tile's positions
    {
      float sv4[4], mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = sub * 4 + j;
        sv4[j] = tt * TILE + c < p1 ? ss[srow * SS + c] : -INFINITY;
        mx = fmaxf(mx, sv4[j]);
      }
#pragma unroll
      for (int x = 1; x <= 4; x <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float m_new = fmaxf(m_run, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_run - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sv4[j] - m_use);
        sum += p;
        ps[srow * PS + sub * 4 + j] = __float2bfloat16(p);
      }
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (sub == 0) alpha_s[srow] = alpha;
    }
    __syncthreads();

    // O = O * alpha + P V over this warp's columns
    {
      const float a0 = alpha_s[g], a1 = alpha_s[g + 8];
#pragma unroll
      for (int i = 0; i < MAX_NT; ++i) {
        if (i < nt) {
          o[i][0] *= a0;
          o[i][1] *= a0;
          o[i][2] *= a1;
          o[i][3] *= a1;
        }
      }
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        uint32_t pa[4];
        ct::ldmatrix_x4(pa, ps + ((mi & 1) * 8 + (lane & 7)) * PS + (mi >> 1) * 8 + kk * 16);
#pragma unroll
        for (int i = 0; i < MAX_NT; ++i) {
          if (i < nt) {
            const int col = col0 + i * 8 + g;
            uint32_t bf[2];
            bf[0] = col_pair<KIND>(vt, lay.rbv, kk * 16 + 2 * t, col);
            bf[1] = col_pair<KIND>(vt, lay.rbv, kk * 16 + 2 * t + 8, col);
            ct::mma_bf16_16816(o[i], pa, bf);
          }
        }
      }
    }
    __syncthreads();  // every warp done with stage st, the scores and P
  }
  ct::cp_async_wait<0>();

#pragma unroll
  for (int x = 1; x <= 4; x <<= 1) l_run += __shfl_xor_sync(0xffffffffu, l_run, x);
  if (sub == 0) {
    rowm[srow] = m_run;
    rowl[srow] = l_run;
  }
  __syncthreads();
  const bool whole = (n_pos + span - 1) / span == 1;  // the row's only split
  const size_t slot = (size_t)b * splits + z;
#pragma unroll
  for (int i = 0; i < MAX_NT; ++i) {
    if (i >= nt) continue;
    const int col = col0 + i * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = g + 8 * half;
      if (r >= hn) continue;
      const float v0 = o[i][2 * half], v1 = o[i][2 * half + 1];
      if (whole) {
        const float inv = 1.f / fmaxf(rowl[r], 1e-30f);
        float y0 = v0 * inv, y1 = v1 * inv;
        if (C::kScaled) {
          y0 *= sv;
          y1 *= sv;
        }
        *reinterpret_cast<uint32_t*>(out + ((size_t)b * H + h0 + r) * Dv + col) =
            ct::pack_bf16x2(y0, y1);
      } else {
        *reinterpret_cast<float2*>(part_o + (slot * H + h0 + r) * Dv + col) =
            make_float2(v0, v1);
      }
    }
  }
  if (!whole && tid < hn) part_ml[slot * H + h0 + tid] = make_float2(rowm[tid], rowl[tid]);
}

// Second pass, launched when a row may take more than one split: a row's
// split partials merged (a row of one split was written by its block, an
// inactive row zeroed). grid (row, head group), the group fastest.
template <bool SCALED>
__global__ void __launch_bounds__(THREADS)
latent_merge_kernel(const int* __restrict__ lengths, const float2* __restrict__ part_ml,
                    const float* __restrict__ part_o, __nv_bfloat16* __restrict__ out,
                    const float* __restrict__ v_scale, int H, int Dv, int capacity,
                    int span, int splits) {
  const int groups = (H + QROWS - 1) / QROWS, hg = blockIdx.x % groups;
  const int b = blockIdx.x / groups, tid = threadIdx.x;
  const int h0 = hg * QROWS, hn = min(QROWS, H - h0);
  const int len = lengths[b];
  if (len < 0) return;
  const int ns = (min(len, capacity) + span) / span;  // ceil((cached + 1) / span)
  if (ns == 1) return;
  const size_t slot = (size_t)b * splits;
  __shared__ float rowm[QROWS], rowl[QROWS];
  if (tid < hn) {
    const int h = h0 + tid;
    float mx = -INFINITY;
    for (int zz = 0; zz < ns; ++zz) mx = fmaxf(mx, part_ml[(slot + zz) * H + h].x);
    float l = 0.f;
    for (int zz = 0; zz < ns; ++zz) {
      const float2 ml = part_ml[(slot + zz) * H + h];
      l += ml.y * expf(ml.x - mx);
    }
    rowm[tid] = mx;
    rowl[tid] = l;
  }
  __syncthreads();
  const float sv = SCALED ? v_scale[0] : 1.f;
  for (int e = tid; e < hn * Dv; e += THREADS) {
    const int r = e / Dv, d = e - r * Dv, h = h0 + r;
    float acc = 0.f;
    for (int zz = 0; zz < ns; ++zz)
      acc += expf(part_ml[(slot + zz) * H + h].x - rowm[r]) *
             part_o[((slot + zz) * H + h) * Dv + d];
    const float v = acc / fmaxf(rowl[r], 1e-30f);
    out[((size_t)b * H + h0) * Dv + e] = __float2bfloat16(SCALED ? v * sv : v);
  }
}

struct Args {
  const void *q, *new_k, *new_v;
  void *cache_k, *cache_v;
  const void *tables, *lengths;
  void* out;
  void *part_ml, *part_o;
  const void *k_scale, *v_scale;
  int B, H, Dk, Dv, layer, page, capacity, table_width, num_pages, per, splits;
  float inv_sqrt_d;
};

template <bool PAGED, int KIND>
int launch_kind(const Args& a, cudaStream_t s) {
  using T = typename ct::Cache<KIND>::T;
  auto* kernel = latent_kernel<PAGED, KIND>;
  static bool attr_set = false;
  if (!attr_set) {  // opt in once for the widest rows any call may bring
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Layout(MAX_D, MAX_D, sizeof(T)).total));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int span = a.per * 64;
  const int groups = (a.H + QROWS - 1) / QROWS;
  const size_t smem = Layout(a.Dk, a.Dv, sizeof(T)).total;
  kernel<<<dim3(groups * a.B, a.splits), THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.new_k),
      static_cast<const __nv_bfloat16*>(a.new_v), static_cast<T*>(a.cache_k),
      static_cast<T*>(a.cache_v), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.lengths), static_cast<__nv_bfloat16*>(a.out),
      static_cast<float2*>(a.part_ml), static_cast<float*>(a.part_o),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale), a.B,
      a.H, a.Dk, a.Dv, a.layer, a.page, a.capacity, a.table_width, a.num_pages, span,
      a.splits, a.inv_sqrt_d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return static_cast<int>(e);
  latent_merge_kernel<ct::Cache<KIND>::kScaled><<<groups * a.B, THREADS, 0, s>>>(
      static_cast<const int*>(a.lengths), static_cast<const float2*>(a.part_ml),
      static_cast<const float*>(a.part_o), static_cast<__nv_bfloat16*>(a.out),
      static_cast<const float*>(a.v_scale), a.H, a.Dv, a.capacity, span, a.splits);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED>
int launch(const Args& a, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int span = a.per * 64;
  if (a.H < 1 || a.Dk % 64 || a.Dv % 64 || a.Dv < 64 || a.Dv > a.Dk ||
      a.Dk > MAX_D || a.per < 1 || a.page < 1 ||
      a.splits != (a.capacity + span) / span)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kind) {
    case ct::kCacheBF16: return launch_kind<PAGED, ct::kCacheBF16>(a, s);
    case ct::kCacheE4M3: return launch_kind<PAGED, ct::kCacheE4M3>(a, s);
    case ct::kCacheInt8: return launch_kind<PAGED, ct::kCacheInt8>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Dense slab (B5-L). q (B, H, Dk), new_k (B, 1, Dk), new_v (B, 1, Dv) bf16;
// cache_k (L, B, 1, S_pad, Dk) and cache_v (L, B, 1, S_pad, Dv) of cache
// type `kind` (ct::CacheKind); lengths (B,) int32; out (B, H, Dv) bf16;
// k_scale/v_scale (1,) f32, read only for the e4m3 and int8 caches;
// part_ml (B, splits, H) float2 and part_o (B, splits, H, Dv) f32 scratch,
// splits = (S_pad + 64 per) / (64 per), read only when splits > 1. All
// contiguous. Dk and Dv multiples of 64, Dv <= Dk <= 640, any H >= 1.
extern "C" int ct_latent_decode(const void* q, const void* new_k, const void* new_v,
                                void* cache_k, void* cache_v, const void* lengths,
                                void* out, const void* k_scale, const void* v_scale,
                                void* part_ml, void* part_o, int B, int H, int s_pad,
                                int Dk, int Dv, int layer, int kind, int per, int splits,
                                float inv_sqrt_d, void* stream) {
  const Args a{q,       new_k,   new_v, cache_k, cache_v, nullptr, lengths, out,
               part_ml, part_o,  k_scale, v_scale, B,     H,       Dk,      Dv,
               layer,   1,       s_pad, 0,       0,     per,     splits,  inv_sqrt_d};
  return launch<false>(a, kind, stream);
}

// Paged pool (B7-L). pool_k (L, NP, 1, page, Dk) and pool_v (L, NP, 1,
// page, Dv) of cache type `kind`; tables (B, P) int32 page ids; splits =
// (P page + 64 per) / (64 per); the rest as for ct_latent_decode.
extern "C" int ct_latent_paged_decode(const void* q, const void* new_k, const void* new_v,
                                      void* pool_k, void* pool_v, const void* tables,
                                      const void* lengths, void* out, const void* k_scale,
                                      const void* v_scale, void* part_ml, void* part_o,
                                      int B, int H, int num_pages, int table_width,
                                      int page, int Dk, int Dv, int layer, int kind,
                                      int per, int splits, float inv_sqrt_d,
                                      void* stream) {
  const Args a{q,       new_k,  new_v,   pool_k,  pool_v, tables, lengths,
               out,     part_ml, part_o, k_scale, v_scale, B,     H,
               Dk,      Dv,     layer,   page,    table_width * page,
               table_width, num_pages, per, splits, inv_sqrt_d};
  return launch<true>(a, kind, stream);
}
