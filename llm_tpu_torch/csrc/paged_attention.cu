// T=1 decode attention over the paged KV pool, as online-softmax partials.
//
// Replaces the TPU kernels of llm_tpu/ops/paged_attention.py
// (_paged_attention_call, body _make_kernel; entry paged_attention_pass)
// and of llm_tpu/ops/dense_attention.py (_dense_attention_call; entry
// dense_attention_pass): one layer of the dense cache [B, Hkv, S, D] is a
// pool of B pages of S positions whose page tables are [b].
// For each stream b and kv head h, over the logical positions [0, W) of
// layer l (the wrapper passes the layer's base pointer of the pool
// [L, NP, Hkv, page, Dp]), position p = j * page + o is read from physical
// page tables[b, min(j, P - 1)]:
//
//   s[r, p] = q[b, h, r] . k[page, h, o] * kq_scale (* k_scale[page, h, o])
//             (+ slope[h, r] * p)                masked for p >= n_past[b]
//   m = max_p s,  p[r, p] = exp(s - m),  l = sum_p p
//   acc[r] = sum_p p[r, p] (* v_scale[page, h, o]) * v[page, h, o]
//
// with the reference's masking constants: a masked key contributes exactly
// nothing, so n_past = 0 gives m = -1e30, l = 0, acc = 0, which the
// caller's merge with the new token's own key relies on. Pools: bf16, f32,
// int8 codes, or int4 codes packed planar into D/2 bytes a row (low nibble
// element d, high nibble element d + D/2, both sign-extended).
//
// What bounds it on the H100: the pool bytes of the positions below n_past
// (K and V rows read once each, plus their scales, 3.35 TB/s); the
// arithmetic is 4*D flops per key and head.
//
// Design, simple first: one block per (b, kv head, chunk of logical
// positions), so B=1 x 32 heads still fills the card when the window is cut
// into chunks. Positions resolve to rows of the pool through the page table
// (the entry clamped to P - 1, as the Pallas index map does, and the page
// id to the pool). When the page size is a multiple of the chunk, a chunk
// lies within one page: one lookup gives its first row and the others
// follow it. Otherwise the block resolves each position into shared memory
// first. Keys at or past n_past are never read: a chunk wholly past n_past
// writes the masked partials and returns. Warps take keys in turn, lanes across D,
// and a shuffle reduction gives each of the rep query heads' scores; one
// warp a head takes the chunk's max, exponentials and sum; the block then
// forms acc with threads across (head, d), reading V rows coalesced. A
// second kernel merges the chunks in a fixed order: deterministic, so
// greedy tokens repeat from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDPerLane = 8;  // D <= 256
constexpr float kNegInf = -1e30f;

// element d of one pool row (half = D / 2, used by packed int4 rows only)
__device__ __forceinline__ float elem(const __nv_bfloat16* row, int d, int) {
  return __bfloat162float(row[d]);
}
__device__ __forceinline__ float elem(const float* row, int d, int) {
  return row[d];
}
__device__ __forceinline__ float elem(const int8_t* row, int d, int) {
  return static_cast<float>(row[d]);
}
__device__ __forceinline__ float elem(const uint8_t* row, int d, int half) {
  const int n = (d < half ? row[d] : row[d - half] >> 4) & 0xF;
  return static_cast<float>(n < 8 ? n : n - 16);
}

// the pool row of position p of stream b, kv head h; no table (NULL):
// stream b reads page b
__device__ __forceinline__ int64_t pool_row(const int* tables, int b, int h,
                                            int p, int NP, int Hkv, int page,
                                            int P) {
  const int j = p / page;
  int phys = tables ? tables[(int64_t)b * P + min(j, P - 1)] : b;
  phys = min(max(phys, 0), NP - 1);
  return ((int64_t)phys * Hkv + h) * page + (p - j * page);
}

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

// CONTIG: page % chunk == 0, so the chunk's rows are consecutive
template <typename KV, bool QUANT, bool ALIBI, bool CONTIG>
__global__ void __launch_bounds__(kThreads) paged_chunk(
    const float* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ tables,
    const int* __restrict__ n_past, const float* __restrict__ slopes,
    float* __restrict__ pm, float* __restrict__ pl, float* __restrict__ pacc,
    int NP, int Hkv, int rep, int D, int Dp, int page, int P, int W,
    int chunk, float kq_scale) {
  extern __shared__ int64_t smem[];
  int64_t* rows = smem;  // [chunk] pool rows (not CONTIG)
  float* qs = reinterpret_cast<float*>(smem + chunk);  // [rep, D]
  float* ps = qs + rep * D;  // [rep, chunk]: scores, then probabilities
  const int bh = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int b = bh / Hkv, h = bh - b * Hkv;
  const int p0 = c * chunk, p1 = min(p0 + chunk, min(n_past[b], W));
  const int n = p1 - p0;
  const int64_t part = (int64_t)bh * nc + c;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = D / 2;

  if (n <= 0) {  // every key of the chunk is masked
    for (int i = threadIdx.x; i < rep * D; i += kThreads)
      pacc[part * rep * D + i] = 0.f;
    for (int r = threadIdx.x; r < rep; r += kThreads) {
      pm[part * rep + r] = kNegInf;
      pl[part * rep + r] = 0.f;
    }
    return;
  }

  int64_t row0 = 0;
  if constexpr (CONTIG) {
    row0 = pool_row(tables, b, h, p0, NP, Hkv, page, P);
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads)
      rows[i] = pool_row(tables, b, h, p0 + i, NP, Hkv, page, P);
  }
  auto row_at = [&](int i) -> int64_t {
    if constexpr (CONTIG) return row0 + i;
    else return rows[i];
  };
  for (int i = threadIdx.x; i < rep * D; i += kThreads)
    qs[i] = q[(int64_t)bh * rep * D + i];
  __syncthreads();

  // scores
  for (int i = warp; i < n; i += kWarps) {
    const int64_t row = row_at(i);
    const KV* kr_ = k + row * Dp;
    float kr[kMaxDPerLane];
#pragma unroll
    for (int t = 0; t < kMaxDPerLane; ++t) {
      const int d = lane + 32 * t;
      kr[t] = d < D ? elem(kr_, d, half) : 0.f;
    }
    for (int r = 0; r < rep; ++r) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxDPerLane; ++t) {
        const int d = lane + 32 * t;
        if (d < D) s += qs[r * D + d] * kr[t];
      }
      s = warp_sum(s);
      if (lane == 0) {
        float sc = s * kq_scale;
        if constexpr (QUANT) sc = sc * ks[row];
        if constexpr (ALIBI)
          sc = sc + slopes[h * rep + r] * static_cast<float>(p0 + i);
        ps[r * chunk + i] = sc;
      }
    }
  }
  __syncthreads();

  // chunk max, exponentials, sum (every position here is below n_past)
  for (int r = warp; r < rep; r += kWarps) {
    float mx = kNegInf;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, ps[r * chunk + i]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(ps[r * chunk + i] - mx);
      ps[r * chunk + i] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      pm[part * rep + r] = mx;
      pl[part * rep + r] = sum;
    }
  }
  __syncthreads();

  // acc over the chunk
  for (int i = threadIdx.x; i < rep * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    float a = 0.f;
    for (int t = 0; t < n; ++t) {
      const int64_t row = row_at(t);
      float pr = ps[r * chunk + t];
      if constexpr (QUANT) pr = pr * vs[row];
      a += pr * elem(v + row * Dp, d, half);
    }
    pacc[(part * rep + r) * D + d] = a;
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

template <typename KV, bool QUANT, bool ALIBI, bool CONTIG>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* tables, const void* n_past,
                   const void* slopes, void* pm, void* pl, void* pacc, int BH,
                   int NP, int Hkv, int rep, int D, int Dp, int page, int P,
                   int W, int chunk, float kq_scale, cudaStream_t s) {
  auto kern = paged_chunk<KV, QUANT, ALIBI, CONTIG>;
  const size_t smem = sizeof(int64_t) * (size_t)chunk +
                      sizeof(float) * (size_t)rep * (D + chunk);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(BH, (W + chunk - 1) / chunk);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(n_past), static_cast<const float*>(slopes),
      static_cast<float*>(pm), static_cast<float*>(pl),
      static_cast<float*>(pacc), NP, Hkv, rep, D, Dp, page, P, W, chunk,
      kq_scale);
  return cudaSuccess;
}

}  // namespace

// kv_dtype: 0 bf16, 1 f32, 2 int8, 3 int4 (uint8 rows of D/2 bytes); for
// 2 and 3, ks/vs are the f32 scales [NP, Hkv, page] of the layer. k/v are
// the layer's pool [NP, Hkv, page, Dp]; tables [B, P] int32, or NULL for
// one page a stream (page b: the dense cache); n_past [B] int32; slopes
// [Hkv, rep] or NULL. Scratch pm/pl [B*Hkv, nc, rep] and pacc
// [B*Hkv, nc, rep, D] with nc = ceil(W/chunk). Outputs m/l [B, Hkv, rep]
// and acc [B, Hkv, rep, D], all f32. Returns cudaGetLastError().
extern "C" int paged_attention_launch(
    int kv_dtype, const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* tables, const void* n_past,
    const void* slopes, void* pm, void* pl, void* pacc, void* m, void* l,
    void* acc, int B, int NP, int Hkv, int rep, int D, int page, int P, int W,
    int chunk, float kq_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool alibi = slopes != nullptr, contig = page % chunk == 0;
  const int BH = B * Hkv;
#define PA(T, QU, AL, CO, DP)                                               \
  launch<T, QU, AL, CO>(q, k, v, ks, vs, tables, n_past, slopes, pm, pl,   \
                        pacc, BH, NP, Hkv, rep, D, DP, page, P, W, chunk,  \
                        kq_scale, s)
#define PA4(T, QU, DP)                                                      \
  (alibi ? (contig ? PA(T, QU, true, true, DP) : PA(T, QU, true, false, DP)) \
         : (contig ? PA(T, QU, false, true, DP)                             \
                   : PA(T, QU, false, false, DP)))
  cudaError_t e;
  switch (kv_dtype) {
    case 0: e = PA4(__nv_bfloat16, false, D); break;
    case 1: e = PA4(float, false, D); break;
    case 2: e = PA4(int8_t, true, D); break;
    case 3: e = PA4(uint8_t, true, D / 2); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PA4
#undef PA
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
