// Causal GQA flash attention over a fresh prompt, for Hopper.
//
// Replaces compressed_tensors_tpu/ops/kernels/prefill_attention.py:
// prefill_attention. One block per (query tile, kv head, batch row); the
// `rep` query heads that share the kv head fold into the block's rows
// (thread t: head t / TQ, position tile * TQ + t % TQ), so each K/V chunk
// staged in shared memory serves all of them. Each thread keeps its query
// row and its output accumulator in registers and runs the online softmax
// in f32 over 32-key chunks; chunks past the tile's last position are never
// read, and the S x S scores never reach device memory. Numerics follow
// the TPU kernel: q is scaled by 1/sqrt(D) in bf16, scores and the running
// max/sum are f32, probabilities are rounded to bf16 before P.V.
//
// Bound on the H100: at the slice's prefill (S = 128, D = 64) the work is
// 4*B*H*S*S/2*D FLOPs on bf16 inputs, far below the tensor-core roof;
// this first version runs the dot products on the CUDA cores (f32 FMA),
// which is the limit it meets.
#include "common.cuh"

namespace {

constexpr int KC = 32;        // keys per staged chunk
constexpr int THREADS = 128;  // rows per block = rep * TQ <= THREADS

template <int D>
__global__ void __launch_bounds__(THREADS)
prefill_kernel(const __nv_bfloat16* __restrict__ q,  // (B, S, H, D)
               const __nv_bfloat16* __restrict__ k,  // (B, S, KVH, D)
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out,      // (B, S, H, D)
               int S, int H, int KVH, int rep, int tq, float sm_scale) {
  __shared__ float ks[KC][D];
  __shared__ float vs[KC][D];

  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  const int rows = rep * tq;
  const bool live_thread = t < rows;
  const int hr = live_thread ? t / tq : 0;
  const int pos = tile * tq + (live_thread ? t % tq : 0);
  const int head = kvh * rep + hr;
  const bool live = live_thread && pos < S;

  float qr[D], acc[D];
  const __nv_bfloat16 scale_bf = __float2bfloat16(sm_scale);
  if (live) {
    const __nv_bfloat16* qp = q + (((size_t)b * S + pos) * H + head) * D;
#pragma unroll
    for (int d = 0; d < D; ++d)
      qr[d] = __bfloat162float(__hmul(qp[d], scale_bf));
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;
  constexpr float LOG2E = 1.4426950408889634f;

  const int kv_end = min(S, (tile + 1) * tq);  // causal: keys <= last row
  for (int c0 = 0; c0 < kv_end; c0 += KC) {
    // stage K/V chunk (bf16 pairs -> f32)
    for (int i = t; i < KC * D / 2; i += blockDim.x) {
      const int j = i / (D / 2), d2 = (i % (D / 2)) * 2;
      const int key = c0 + j;
      float2 kf = make_float2(0.f, 0.f), vf = make_float2(0.f, 0.f);
      if (key < S) {
        const size_t off = (((size_t)b * S + key) * KVH + kvh) * D + d2;
        kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(k + off));
        vf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v + off));
      }
      ks[j][d2] = kf.x; ks[j][d2 + 1] = kf.y;
      vs[j][d2] = vf.x; vs[j][d2 + 1] = vf.y;
    }
    __syncthreads();
    if (live && c0 <= pos) {
      float s[KC];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot += qr[d] * ks[j][d];
        s[j] = (c0 + j <= pos) ? dot : -INFINITY;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);  // finite: key c0 <= pos is live
      const float alpha = exp2f((m - m_new) * LOG2E);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float p = exp2f((s[j] - m_new) * LOG2E);
        l += p;
        const float pb = __bfloat162float(__float2bfloat16(p));
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] += pb * vs[j][d];
      }
      m = m_new;
    }
    __syncthreads();
  }

  if (live) {
    __nv_bfloat16* op = out + (((size_t)b * S + pos) * H + head) * D;
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = __float2bfloat16(acc[d] * inv);
  }
}

}  // namespace

// q (B, S, H, D), k/v (B, S, KVH, D), out (B, S, H, D), all bf16,
// contiguous. D in {64, 128}; returns cudaErrorInvalidValue otherwise.
extern "C" int ct_prefill_attention(const void* q, const void* k, const void* v,
                                    void* out, int B, int S, int H, int KVH,
                                    int D, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rep = H / KVH;
  const int tq = THREADS / rep;
  if (tq < 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((S + tq - 1) / tq, KVH, B);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 64)
    prefill_kernel<64><<<grid, THREADS, 0, s>>>(qp, kp, vp, op, S, H, KVH, rep, tq, sm_scale);
  else if (D == 128)
    prefill_kernel<128><<<grid, THREADS, 0, s>>>(qp, kp, vp, op, S, H, KVH, rep, tq, sm_scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
