// T=1 decode attention over the dense head-major KV cache, as online-
// softmax partials.
//
// Replaces the TPU kernel of llm_tpu/ops/dense_attention.py
// (_dense_attention_call, body _make_kernel; entry dense_attention_pass).
// For each stream b and kv head h, over the first W positions of layer l of
// the cache [L, B, Hkv, S, D] (the wrapper passes the layer's base pointer):
//
//   s[r, p] = q[b, h, r] . k[b, h, p] * kq_scale (* k_scale[b, h, p])
//             (+ slope[h, r] * p)                masked to -1e30 for p >= n_past[b]
//   m = max_p s,  p[r, p] = exp(s - m) (0 where masked),  l = sum_p p
//   acc[r] = sum_p p[r, p] (* v_scale[b, h, p]) * v[b, h, p]
//
// with the reference's exact masking: NEG_INF = -1e30 (not -inf) and p = 0
// for a masked key, so n_past = 0 gives m = -1e30, l = 0, acc = 0, which
// the caller's merge with the new token's own key relies on.
//
// What bounds it on the H100: the cache bytes of the window (K and V read
// once each, 3.35 TB/s); the arithmetic is 4*D flops per key and head.
//
// Design, simple first: one block per (b, kv head, chunk of positions), so
// B=1 x 32 heads still fills the card when the window is cut into chunks.
// q sits in shared memory. Warps take keys in turn: each lane holds D/32
// elements of the key row, and a shuffle reduction gives the score of each
// of the rep query heads. Per head one warp takes the chunk's max, the
// exponentials and their sum. The block then forms acc over the chunk with
// threads across (head, d), reading V rows coalesced. A second kernel
// merges the chunks' (m, l, acc) in a fixed order: deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDPerLane = 8;  // D <= 256
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename KV, bool QUANT, bool ALIBI>
__global__ void __launch_bounds__(kThreads) attention_chunk(
    const float* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ n_past,
    const float* __restrict__ slopes, float* __restrict__ pm,
    float* __restrict__ pl, float* __restrict__ pacc, int Hkv, int rep, int D,
    int S, int W, int chunk, float kq_scale) {
  extern __shared__ float smem[];
  float* qs = smem;              // [rep, D]
  float* ps = smem + rep * D;    // [rep, chunk]: scores, then probabilities
  const int bh = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int b = bh / Hkv, h = bh - b * Hkv;
  const int p0 = c * chunk, p1 = min(p0 + chunk, W);
  const int np = n_past[b];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const KV* kb = k + (int64_t)bh * S * D;
  const KV* vb = v + (int64_t)bh * S * D;

  for (int i = threadIdx.x; i < rep * D; i += kThreads)
    qs[i] = q[(int64_t)bh * rep * D + i];
  __syncthreads();

  // scores
  for (int p = p0 + warp; p < p1; p += kWarps) {
    float kr[kMaxDPerLane];
#pragma unroll
    for (int i = 0; i < kMaxDPerLane; ++i) {
      const int d = lane + 32 * i;
      kr[i] = d < D ? to_f(kb[(int64_t)p * D + d]) : 0.f;
    }
    for (int r = 0; r < rep; ++r) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) s += qs[r * D + d] * kr[i];
      }
      s = warp_sum(s);
      if (lane == 0) {
        float sc = s * kq_scale;
        if constexpr (QUANT) sc = sc * ks[(int64_t)bh * S + p];
        if constexpr (ALIBI) sc = sc + slopes[h * rep + r] * static_cast<float>(p);
        ps[r * chunk + (p - p0)] = p < np ? sc : kNegInf;
      }
    }
  }
  __syncthreads();

  // chunk max, exponentials, sum
  for (int r = warp; r < rep; r += kWarps) {
    float mx = kNegInf;
    for (int i = lane; i < p1 - p0; i += 32) mx = fmaxf(mx, ps[r * chunk + i]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < p1 - p0; i += 32) {
      const float e = p0 + i < np ? expf(ps[r * chunk + i] - mx) : 0.f;
      ps[r * chunk + i] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      pm[((int64_t)bh * nc + c) * rep + r] = mx;
      pl[((int64_t)bh * nc + c) * rep + r] = sum;
    }
  }
  __syncthreads();

  // acc over the chunk
  for (int i = threadIdx.x; i < rep * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    float a = 0.f;
    for (int p = p0; p < p1; ++p) {
      float pr = ps[r * chunk + (p - p0)];
      if constexpr (QUANT) pr = pr * vs[(int64_t)bh * S + p];
      a += pr * to_f(vb[(int64_t)p * D + d]);
    }
    pacc[(((int64_t)bh * nc + c) * rep + r) * D + d] = a;
  }
}

// merge the chunks of each (b, h) in order: m = max_c m_c,
// l = sum_c l_c e^(m_c - m), acc = sum_c acc_c e^(m_c - m)
__global__ void merge_chunks(const float* __restrict__ pm,
                             const float* __restrict__ pl,
                             const float* __restrict__ pacc,
                             float* __restrict__ m, float* __restrict__ l,
                             float* __restrict__ acc, int nc, int rep, int D) {
  const int bh = blockIdx.x;
  for (int i = threadIdx.x; i < rep * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    float mx = kNegInf;
    for (int c = 0; c < nc; ++c)
      mx = fmaxf(mx, pm[((int64_t)bh * nc + c) * rep + r]);
    float ls = 0.f, a = 0.f;
    for (int c = 0; c < nc; ++c) {
      const int64_t j = ((int64_t)bh * nc + c) * rep + r;
      const float f = expf(pm[j] - mx);
      ls += pl[j] * f;
      a += pacc[j * D + d] * f;
    }
    acc[((int64_t)bh * rep + r) * D + d] = a;
    if (d == 0) {
      m[(int64_t)bh * rep + r] = mx;
      l[(int64_t)bh * rep + r] = ls;
    }
  }
}

template <typename KV, bool QUANT, bool ALIBI>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* n_past, const void* slopes,
                   void* pm, void* pl, void* pacc, int BH, int Hkv, int rep,
                   int D, int S, int W, int chunk, float kq_scale,
                   cudaStream_t s) {
  auto kern = attention_chunk<KV, QUANT, ALIBI>;
  const size_t smem = sizeof(float) * (size_t)rep * (D + chunk);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(BH, (W + chunk - 1) / chunk);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(n_past),
      static_cast<const float*>(slopes), static_cast<float*>(pm),
      static_cast<float*>(pl), static_cast<float*>(pacc), Hkv, rep, D, S, W,
      chunk, kq_scale);
  return cudaSuccess;
}

}  // namespace

// kv_dtype: 0 bf16, 1 f32, 2 int8 (then ks/vs are the f32 scales
// [B, Hkv, S] of the layer). slopes [Hkv, rep] or NULL. Scratch pm/pl
// [B*Hkv, nc, rep] and pacc [B*Hkv, nc, rep, D] with nc = ceil(W/chunk).
// Outputs m/l [B, Hkv, rep] and acc [B, Hkv, rep, D], all f32.
// Returns cudaGetLastError().
extern "C" int dense_attention_launch(
    int kv_dtype, const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* n_past, const void* slopes, void* pm,
    void* pl, void* pacc, void* m, void* l, void* acc, int B, int Hkv,
    int rep, int D, int S, int W, int chunk, float kq_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool alibi = slopes != nullptr;
  const int BH = B * Hkv;
#define DA(T, QU, AL) \
  launch<T, QU, AL>(q, k, v, ks, vs, n_past, slopes, pm, pl, pacc, BH, Hkv, \
                    rep, D, S, W, chunk, kq_scale, s)
  cudaError_t e;
  switch (kv_dtype) {
    case 0: e = alibi ? DA(__nv_bfloat16, false, true)
                      : DA(__nv_bfloat16, false, false); break;
    case 1: e = alibi ? DA(float, false, true) : DA(float, false, false); break;
    case 2: e = alibi ? DA(int8_t, true, true) : DA(int8_t, true, false); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DA
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  merge_chunks<<<BH, kThreads, 0, s>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pl),
      static_cast<const float*>(pacc), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(acc), (W + chunk - 1) / chunk,
      rep, D);
  return static_cast<int>(cudaGetLastError());
}
