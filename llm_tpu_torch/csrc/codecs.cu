// GGML block bytes -> the canonical integer decoding, on the card.
//
// The counterpart of llm_tpu/native/codecs.cpp, the JAX package's host C++
// codec library (not a TPU kernel): its per-block decoders (dec_q4_0 ...
// dec_q6_k, :62-183, format table :219-228) run here, one thread a run of
// four elements, on the raw bytes of a tensor that the loader has copied
// to the card. It computes what llm_tpu_torch/ggml/quant.decode_blocks
// computes, bit for bit:
//
//   value[e] = (q[e] - zero) * scale[e / g] + bias[e / g]
//
//   q      int32 [n_blocks * bs]      the block's integer fields
//   scale  f32   [n_blocks * bs / g]  d, or d * sub-block scale (K-quants)
//   bias   f32   [n_blocks * bs / g]  m (Q4_1, Q5_1), or -(dmin * min)
//                                     (Q2_K, Q4_K, Q5_K); NULL otherwise
//
// for all ten formats: Q4_0, Q4_1, Q5_0, Q5_1, Q8_0 (blocks of 32) and
// Q2_K ... Q6_K (superblocks of 256). A tensor of R rows of K elements is
// R * K / bs blocks in a row, so the decode is flat over the blocks and its
// outputs read as [R, K] and [R, K / g]. The planes (row selection, K and
// R padding, the signed-lo XOR, f16 pairs) stay with
// ops/packing.pack_decoded, as codecs.cpp's llm_transcode fuses them only
// on the host.
//
// Exactness. Every scale product d * sc or dmin * mn is exact in f32 (an
// f16's 11-bit mantissa times at most 8 bits), f16 fields convert exactly
// with __half2float (subnormals too), and the products are rounded with
// __fmul_rn so that no FMA contraction can touch them.
//
// What bounds it on the H100: bytes. A weight reads 0.5-1.06 bytes of block
// and writes 4 bytes of q plus 4 / g (8 / g with a bias) of scales, over
// 3.35 TB/s; its bit arithmetic is a few integer operations a weight.
//
// Design. A block of 256 threads takes 1024 elements: 32 blocks of 32 or
// 4 superblocks. Their bytes (336-1088, a multiple of 8, so each block's
// span starts 8-byte aligned when the tensor does) are staged into shared
// memory with coalesced 4-byte loads; a block's start inside them is not
// 4-byte aligned (18-210 byte blocks), so the decode reads bytes from
// shared memory. Each thread decodes 4 consecutive elements, which lie in
// one group of one block, and stores them as one 16-byte vector: a warp
// writes 512 contiguous bytes of q. The thread at a group's first element
// also writes the group's scale (and bias). Indices are int64.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int ELEMS = 4;  // elements a thread
constexpr int CTA_ELEMS = THREADS * ELEMS;

// ggml type ids (llm_tpu_torch/ggml/types.py GgmlType)
enum Type : int {
  Q4_0 = 2, Q4_1 = 3, Q5_0 = 6, Q5_1 = 7, Q8_0 = 8,
  Q2_K = 10, Q3_K = 11, Q4_K = 12, Q5_K = 13, Q6_K = 14,
};

// block size, bytes a block, elements a scale group, whether it has a bias
template <int T> struct Fmt;
template <> struct Fmt<Q4_0> { static constexpr int BS = 32, TS = 18, G = 32; static constexpr bool BIAS = false; };
template <> struct Fmt<Q4_1> { static constexpr int BS = 32, TS = 20, G = 32; static constexpr bool BIAS = true; };
template <> struct Fmt<Q5_0> { static constexpr int BS = 32, TS = 22, G = 32; static constexpr bool BIAS = false; };
template <> struct Fmt<Q5_1> { static constexpr int BS = 32, TS = 24, G = 32; static constexpr bool BIAS = true; };
template <> struct Fmt<Q8_0> { static constexpr int BS = 32, TS = 34, G = 32; static constexpr bool BIAS = false; };
template <> struct Fmt<Q2_K> { static constexpr int BS = 256, TS = 84, G = 16; static constexpr bool BIAS = true; };
template <> struct Fmt<Q3_K> { static constexpr int BS = 256, TS = 110, G = 16; static constexpr bool BIAS = false; };
template <> struct Fmt<Q4_K> { static constexpr int BS = 256, TS = 144, G = 32; static constexpr bool BIAS = true; };
template <> struct Fmt<Q5_K> { static constexpr int BS = 256, TS = 176, G = 32; static constexpr bool BIAS = true; };
template <> struct Fmt<Q6_K> { static constexpr int BS = 256, TS = 210, G = 16; static constexpr bool BIAS = false; };

__device__ __forceinline__ float f16_at(const uint8_t* p) {
  return __half2float(__ushort_as_half(
      static_cast<unsigned short>(p[0] | (p[1] << 8))));
}

__device__ __forceinline__ uint32_t u32_at(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

// the 32-block formats' nibble: elements 0..15 low nibbles, 16..31 high
__device__ __forceinline__ int nibble32(const uint8_t* qs, int j) {
  return j < 16 ? (qs[j] & 0xF) : (qs[j - 16] >> 4);
}

// get_scale_min_k4 of sub-block g (0..7) of the 12 packed bytes
__device__ __forceinline__ void scale_min_k4(const uint8_t* sb, int g,
                                             int* s, int* m) {
  if (g < 4) {
    *s = sb[g] & 63;
    *m = sb[g + 4] & 63;
  } else {
    *s = (sb[g + 4] & 0xF) | ((sb[g - 4] >> 6) << 4);
    *m = (sb[g + 4] >> 4) | ((sb[g] >> 6) << 4);
  }
}

// q of element j of block b
template <int T>
__device__ __forceinline__ int decode_q(const uint8_t* b, int j) {
  if constexpr (T == Q4_0) {
    return nibble32(b + 2, j);
  } else if constexpr (T == Q4_1) {
    return nibble32(b + 4, j);
  } else if constexpr (T == Q5_0) {
    return nibble32(b + 6, j) | (((u32_at(b + 2) >> j) & 1) << 4);
  } else if constexpr (T == Q5_1) {
    return nibble32(b + 8, j) | (((u32_at(b + 4) >> j) & 1) << 4);
  } else if constexpr (T == Q8_0) {
    return static_cast<int8_t>(b[2 + j]);
  } else {
    const int byte = j & 31;
    if constexpr (T == Q2_K || T == Q3_K) {
      // half (2) x shift (4) x byte (32)
      const int half = j >> 7, shift = (j >> 5) & 3;
      const int qs = T == Q2_K ? 16 : 32;
      const int low2 = (b[qs + half * 32 + byte] >> (2 * shift)) & 3;
      if constexpr (T == Q2_K) {
        return low2;
      } else {
        return low2 | (((b[byte] >> (half * 4 + shift)) & 1) << 2);
      }
    } else if constexpr (T == Q4_K || T == Q5_K) {
      // chunk (4) x {low, high nibble} x byte (32)
      const int chunk = j >> 6, sub = (j >> 5) & 1;
      const uint8_t v = b[(T == Q4_K ? 16 : 48) + chunk * 32 + byte];
      const int lo4 = sub ? (v >> 4) : (v & 0xF);
      if constexpr (T == Q4_K) {
        return lo4;
      } else {
        return lo4 | (((b[16 + byte] >> (2 * chunk + sub)) & 1) << 4);
      }
    } else {  // Q6_K: half (2) x {q1 .. q4} x byte (32)
      const int half = j >> 7, r = (j >> 5) & 3;
      const uint8_t l = b[half * 64 + (r & 1) * 32 + byte];
      const int lo4 = (r & 2) ? (l >> 4) : (l & 0xF);
      const int hq = b[128 + half * 32 + byte];
      return lo4 | (((hq >> (2 * r)) & 3) << 4);
    }
  }
}

// scale and bias of group g of block b
template <int T>
__device__ __forceinline__ void decode_scale(const uint8_t* b, int g,
                                             float* sc, float* bi) {
  if constexpr (T == Q4_0 || T == Q5_0 || T == Q8_0) {
    *sc = f16_at(b);
  } else if constexpr (T == Q4_1 || T == Q5_1) {
    *sc = f16_at(b);
    *bi = f16_at(b + 2);
  } else if constexpr (T == Q2_K) {
    const int s = b[g];
    *sc = __fmul_rn(f16_at(b + 80), static_cast<float>(s & 0xF));
    *bi = -__fmul_rn(f16_at(b + 82), static_cast<float>(s >> 4));
  } else if constexpr (T == Q3_K) {
    // 6-bit scales: 4 low bits of bytes 0..7, 2 high bits of bytes 8..11
    const uint8_t* sb = b + 96;
    const int i = g & 3, which = g >> 2;
    const int low = sb[(which & 1) * 4 + i];
    const int s6 = ((which & 2) ? (low >> 4) : (low & 0xF)) |
                   (((sb[8 + i] >> (2 * which)) & 3) << 4);
    *sc = __fmul_rn(f16_at(b + 108), static_cast<float>(s6 - 32));
  } else if constexpr (T == Q4_K || T == Q5_K) {
    int s, m;
    scale_min_k4(b + 4, g, &s, &m);
    *sc = __fmul_rn(f16_at(b), static_cast<float>(s));
    *bi = -__fmul_rn(f16_at(b + 2), static_cast<float>(m));
  } else {  // Q6_K: int8 scales in group order
    *sc = __fmul_rn(f16_at(b + 208),
                    static_cast<float>(static_cast<int8_t>(b[192 + g])));
  }
}

template <int T>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const uint8_t* __restrict__ raw, int64_t n_blocks,
              int* __restrict__ q, float* __restrict__ scale,
              float* __restrict__ bias) {
  using F = Fmt<T>;
  constexpr int NB = CTA_ELEMS / F::BS;  // GGML blocks a thread block
  constexpr int SPAN = NB * F::TS;
  static_assert(SPAN % 8 == 0, "a span keeps 8-byte alignment");
  __shared__ __align__(16) uint8_t s[SPAN];

  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * NB;
  const int nb = n_blocks - b0 < NB ? static_cast<int>(n_blocks - b0) : NB;
  const int n_bytes = nb * F::TS;
  const uint8_t* src = raw + b0 * F::TS;
  const uint32_t* src4 = reinterpret_cast<const uint32_t*>(src);
  uint32_t* s4 = reinterpret_cast<uint32_t*>(s);
  for (int w = threadIdx.x; w < n_bytes / 4; w += THREADS) s4[w] = src4[w];
  for (int i = (n_bytes & ~3) + threadIdx.x; i < n_bytes; i += THREADS)
    s[i] = src[i];
  __syncthreads();

  const int e = threadIdx.x * ELEMS;
  if (e >= nb * F::BS) return;
  const int lb = e / F::BS, j = e % F::BS;
  const uint8_t* b = s + lb * F::TS;
  int4 v;
  v.x = decode_q<T>(b, j);
  v.y = decode_q<T>(b, j + 1);
  v.z = decode_q<T>(b, j + 2);
  v.w = decode_q<T>(b, j + 3);
  const int64_t ge = b0 * F::BS + e;
  *reinterpret_cast<int4*>(q + ge) = v;
  if (j % F::G == 0) {
    float sc = 0.f, bi = 0.f;
    decode_scale<T>(b, j / F::G, &sc, &bi);
    scale[ge / F::G] = sc;
    if constexpr (F::BIAS) bias[ge / F::G] = bi;
  }
}

template <int T>
cudaError_t launch(const void* raw, int64_t n_blocks, void* q, void* scale,
                   void* bias, cudaStream_t stream) {
  constexpr int NB = CTA_ELEMS / Fmt<T>::BS;
  const int64_t grid = (n_blocks + NB - 1) / NB;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  decode_kernel<T><<<static_cast<unsigned>(grid), THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(raw), n_blocks, static_cast<int*>(q),
      static_cast<float*>(scale), static_cast<float*>(bias));
  return cudaGetLastError();
}

}  // namespace

// Decode `n_blocks` GGML blocks of type `ggml_type` from `raw` (device
// bytes, 4-byte aligned) into q, scale and bias (NULL for formats without
// one), on `stream`. Returns the launch's cudaError_t.
extern "C" int codecs_decode(int ggml_type, const void* raw,
                             long long n_blocks, void* q, void* scale,
                             void* bias, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks <= 0) return cudaErrorInvalidValue;
  switch (ggml_type) {
    case Q4_0: return launch<Q4_0>(raw, n_blocks, q, scale, bias, s);
    case Q4_1: return launch<Q4_1>(raw, n_blocks, q, scale, bias, s);
    case Q5_0: return launch<Q5_0>(raw, n_blocks, q, scale, bias, s);
    case Q5_1: return launch<Q5_1>(raw, n_blocks, q, scale, bias, s);
    case Q8_0: return launch<Q8_0>(raw, n_blocks, q, scale, bias, s);
    case Q2_K: return launch<Q2_K>(raw, n_blocks, q, scale, bias, s);
    case Q3_K: return launch<Q3_K>(raw, n_blocks, q, scale, bias, s);
    case Q4_K: return launch<Q4_K>(raw, n_blocks, q, scale, bias, s);
    case Q5_K: return launch<Q5_K>(raw, n_blocks, q, scale, bias, s);
    case Q6_K: return launch<Q6_K>(raw, n_blocks, q, scale, bias, s);
    default: return cudaErrorInvalidValue;
  }
}
