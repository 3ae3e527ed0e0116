// Causal GQA flash attention over a fresh prompt, for Hopper.
//
// Replaces compressed_tensors_tpu/ops/kernels/prefill_attention.py:
// prefill_attention (:141, _prefill_call :120, pallas_call :125).
//
// Design: FlashAttention-2 on mma.sync m16n8k16 bf16. The `rep` query
// heads that share a kv head fold position-major into the rows of one
// (S * rep, D) problem per (batch row, kv head): folded row f is position
// f / rep, head f % rep, so a tile of rows ends at its last row's position
// and each key tile staged in shared memory serves every head of the
// group. A block of 4 warps owns 64 folded rows, 16 per warp; Q comes in
// once through ldmatrix and stays in registers. K and V walk in tiles of
// 64 keys, bf16 in padded shared memory (row stride D + 8: ldmatrix
// conflict-free), double-buffered by cp.async behind the previous tile's
// math. S = Q.K^T lands in f32 fragments; the online softmax runs on them
// (row max over the quad by __shfl_xor_sync, exp2 of log2e-scaled
// scores), the probabilities are rounded to bf16 in registers and reused
// as the A operand of P.V, with V read by ldmatrix.trans. Only tiles that
// reach past a warp's first position pay the causal mask (keys past S
// fall under it: every row's position is below S); a warp skips the tiles
// wholly past its last position. Blocks with the most keys launch first
// (the query tile index runs in reverse on the slowest grid axis).
// Numerics follow the TPU kernel: q is scaled by 1/sqrt(D) in bf16, scores
// and the running max and sum are f32, probabilities are rounded to bf16
// before P.V with f32 accumulation, and the output is divided by the sum
// at the end.
//
// Bound on the H100: 4*B*H*(S(S+1)/2)*D operations on bf16 inputs (the
// causal half of QK^T and P.V) at the 989 TFLOP/s tensor-core peak; at
// the serving chunk (S = 512) the q/k/v/out bytes are of the same order.
#include "common.cuh"

namespace {

constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // folded rows per block
constexpr int BKV = 64;         // keys per tile
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
prefill_kernel(const __nv_bfloat16* __restrict__ q,  // (B, S, H, D)
               const __nv_bfloat16* __restrict__ k,  // (B, S, KVH, D)
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out,      // (B, S, H, D)
               int S, int H, int KVH, int rep, float sm_scale) {
  constexpr int RS = D + 8;     // shared row stride (bf16)
  constexpr int DCH = D / 8;    // 16-byte chunks per row
  constexpr int DT = D / 8;     // n8 tiles of the output
  constexpr int KT = BKV / 8;   // n8 tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][RS]
  __nv_bfloat16* ks = qs + BQ * RS;                                // [2][BKV][RS]
  __nv_bfloat16* vs = ks + 2 * BKV * RS;                           // [2][BKV][RS]

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int qtile = gridDim.z - 1 - blockIdx.z;  // longest tiles first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qr = lane >> 2, qt = lane & 3;
  const int rows = S * rep;
  const int f0 = qtile * BQ;
  const int last_pos = min(S - 1, (min(f0 + BQ, rows) - 1) / rep);
  const int tiles = last_pos / BKV + 1;

  // Q tile: folded row f -> (position f / rep, head kvh * rep + f % rep)
  for (int c = tid; c < BQ * DCH; c += THREADS) {
    const int r = c / DCH, ch = c % DCH, f = f0 + r;
    const bool ok = f < rows;
    const size_t off = ok ? (((size_t)b * S + f / rep) * H + kvh * rep + f % rep) * D
                          : 0;
    ct::cp_async16(qs + r * RS + ch * 8, q + off + ch * 8, ok ? 16 : 0);
  }
  auto load_kv = [&](int buf, int t) {
    for (int c = tid; c < BKV * DCH; c += THREADS) {
      const int r = c / DCH, ch = c % DCH, key = t * BKV + r;
      const bool ok = key < S;
      const size_t off = ok ? (((size_t)b * S + key) * KVH + kvh) * D + ch * 8 : 0;
      ct::cp_async16(ks + (buf * BKV + r) * RS + ch * 8, k + off, ok ? 16 : 0);
      ct::cp_async16(vs + (buf * BKV + r) * RS + ch * 8, v + off, ok ? 16 : 0);
    }
  };
  load_kv(0, 0);
  ct::cp_async_commit();

  // this lane's two rows (qr, qr + 8 of the warp's 16) and their positions
  const int fw = f0 + warp * 16;
  const int pos0 = min(S - 1, (fw + qr) / rep);
  const int pos1 = min(S - 1, (fw + qr + 8) / rep);
  const int warp_first = min(S - 1, fw / rep);
  const int warp_last = min(S - 1, (fw + 15) / rep);

  uint32_t qf[D / 16][4];
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    ct::cp_async_wait<0>();
    __syncthreads();  // tile t (and Q) landed; tile t - 1's buffers free
    if (t + 1 < tiles) load_kv(buf ^ 1, t + 1);
    ct::cp_async_commit();
    if (t == 0) {  // Q fragments, scaled by 1/sqrt(D) in bf16
      const __nv_bfloat162 sc = __float2bfloat162_rn(sm_scale);
      const int mi = lane >> 3;
      const __nv_bfloat16* base =
          qs + (warp * 16 + (mi & 1) * 8 + (lane & 7)) * RS + (mi >> 1) * 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ct::ldmatrix_x4(qf[kk], base + kk * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          __nv_bfloat162 h = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&qf[kk][i]), sc);
          qf[kk][i] = *reinterpret_cast<uint32_t*>(&h);
        }
      }
    }
    const int c0 = t * BKV;
    if (c0 > warp_last) continue;  // every key of the tile is masked here
    const __nv_bfloat16* kb = ks + buf * BKV * RS;
    const __nv_bfloat16* vb = vs + buf * BKV * RS;

    // S = Q K^T: 16 rows x 64 keys
    float s[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    {
      const int mi = lane >> 3;
      const __nv_bfloat16* base = kb + ((mi >> 1) * 8 + (lane & 7)) * RS + (mi & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < KT; j += 2) {
          uint32_t bf[4];
          ct::ldmatrix_x4(bf, base + j * 8 * RS + kk * 16);
          ct::mma_bf16_16816(s[j], qf[kk], bf);
          ct::mma_bf16_16816(s[j + 1], qf[kk], bf + 2);
        }
      }
    }
    if (c0 + BKV - 1 > warp_first) {  // the diagonal (and the S tail)
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int key = c0 + j * 8 + 2 * qt;
        if (key > pos0) s[j][0] = -INFINITY;
        if (key + 1 > pos0) s[j][1] = -INFINITY;
        if (key > pos1) s[j][2] = -INFINITY;
        if (key + 1 > pos1) s[j][3] = -INFINITY;
      }
    }

    // online softmax on the fragments (rows qr and qr + 8)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    // finite: key 0 <= every position, and tile 0 comes first
    const float a0 = exp2f((m0 - mx0) * LOG2E), a1 = exp2f((m1 - mx1) * LOG2E);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      o[i][0] *= a0;
      o[i][1] *= a0;
      o[i][2] *= a1;
      o[i][3] *= a1;
    }
    const float mb0 = m0 * LOG2E, mb1 = m1 * LOG2E;
    uint32_t pf[KT / 2][4];  // P as bf16 A fragments, 16 keys each
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float p0 = exp2f(s[j][0] * LOG2E - mb0), p1 = exp2f(s[j][1] * LOG2E - mb0);
      const float p2 = exp2f(s[j][2] * LOG2E - mb1), p3 = exp2f(s[j][3] * LOG2E - mb1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = ct::pack_bf16x2(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = ct::pack_bf16x2(p2, p3);
    }

    // O += P V
    {
      const int mi = lane >> 3;
      const __nv_bfloat16* base = vb + ((mi & 1) * 8 + (lane & 7)) * RS + (mi >> 1) * 8;
#pragma unroll
      for (int ks_ = 0; ks_ < BKV / 16; ++ks_) {
#pragma unroll
        for (int i = 0; i < DT; i += 2) {
          uint32_t bf[4];
          ct::ldmatrix_x4_trans(bf, base + ks_ * 16 * RS + i * 8);
          ct::mma_bf16_16816(o[i], pf[ks_], bf);
          ct::mma_bf16_16816(o[i + 1], pf[ks_], bf + 2);
        }
      }
    }
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int f = fw + qr + hh * 8;
    if (f >= rows) continue;
    __nv_bfloat16* op =
        out + (((size_t)b * S + f / rep) * H + kvh * rep + f % rep) * D + 2 * qt;
    const float inv = hh ? inv1 : inv0;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<__nv_bfloat162*>(op + i * 8) =
          __floats2bfloat162_rn(o[i][hh * 2] * inv, o[i][hh * 2 + 1] * inv);
  }
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           __nv_bfloat16* out, int B, int S, int H, int KVH, float sm_scale,
           cudaStream_t s) {
  const size_t smem = (size_t)(BQ + 4 * BKV) * (D + 8) * sizeof(__nv_bfloat16);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int rep = H / KVH;
  dim3 grid(KVH, B, (S * rep + BQ - 1) / BQ);
  prefill_kernel<D><<<grid, THREADS, smem, s>>>(q, k, v, out, S, H, KVH, rep,
                                                sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, H, D), k/v (B, S, KVH, D), out (B, S, H, D), all bf16,
// contiguous; H a multiple of KVH. D in {64, 128}; returns
// cudaErrorInvalidValue otherwise.
extern "C" int ct_prefill_attention(const void* q, const void* k, const void* v,
                                    void* out, int B, int S, int H, int KVH,
                                    int D, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KVH < 1 || H % KVH) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 64) return launch<64>(qp, kp, vp, op, B, S, H, KVH, sm_scale, s);
  if (D == 128) return launch<128>(qp, kp, vp, op, B, S, H, KVH, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
