// Fused dequantize -> matmul over K-major quantized weight planes.
//
// Replaces the TPU kernels of llm_tpu/ops/qmatmul.py: K1 (_qmatmul_pallas,
// _qmatmul_pallas_stacked; body _make_kernel) and K3 (_qmatmul_pallas_c,
// _qmatmul_pallas_c_stacked; body _make_kernel_c). K3 computes the same
// function over a coalesced buffer whose order only shaped TPU DMAs, so one
// kernel over the plane layout serves both. A layer of stacked planes is a
// base-pointer offset taken by the wrapper.
//
//   y[M, R] f32 = bf16(x[M, Kp]) . bf16(dequant(W))     (f32 accumulation)
//   dequant(W)[k, r] = (q[k, r] - zero) * scale[k/g, r] (+ bias[k/g, r])
//
// What bounds it on the H100: at decode (M = 1) the packed weight bytes,
// 4.5 bits a weight for q4_0 (3.35 TB/s); at prefill (M = 512) the
// arithmetic, which this kernel does on the FP32 pipes (67 TFLOP/s), not
// the tensor cores, so it stays far from the bf16 tensor-core bound.
//
// Design, simple first:
// - one thread per output column r, 128 columns a block: neighbouring
//   threads read neighbouring words of every plane row;
// - x is staged in shared memory 256 K elements at a time, rounded to bf16
//   and widened to f32; every thread reads the same address (broadcast);
// - each thread dequantizes 32 weights (one "unit" of K) in registers,
//   rounds them to bf16 like the reference kernel, and accumulates MT rows
//   of x with f32 FMAs (bf16 x bf16 products are exact in f32);
// - grid (R/128, M tiles, K splits). At decode a weight gives few column
//   blocks (R = 4096: 32 blocks for 132 SMs), so K is split and a second
//   pass sums the splits in a fixed order: deterministic, no atomics.
// The dequant rounding uses __fmul_rn/__fadd_rn, which the compiler never
// contracts into an FMA, so each weight is bit-equal to the plain dequant.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // output columns per block
constexpr int kChunk = 256;    // K elements of x staged per pass
constexpr int kUnit = 32;      // K elements dequantized at once

__device__ __forceinline__ float half_bits(uint32_t b) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
}

// scale or bias of group `grp` (index along K) for column r
template <bool PACKED>
__device__ __forceinline__ float group_value(const void* plane, int grp,
                                             int Rp, int r) {
  if constexpr (PACKED) {
    const uint32_t w =
        static_cast<const uint32_t*>(plane)[(int64_t)(grp >> 1) * Rp + r];
    return half_bits((grp & 1) ? (w >> 16) : (w & 0xFFFFu));
  }
  return static_cast<const float*>(plane)[(int64_t)grp * Rp + r];
}

// the 32 weights of K unit u in column r, each rounded to bf16
template <int LO, int HI, bool SIGNED, int ZERO, int G, bool BIAS, bool PACKED>
__device__ __forceinline__ void dequant_unit(
    const void* __restrict__ lo, const uint32_t* __restrict__ hi,
    const void* __restrict__ scale, const void* __restrict__ bias, int u,
    int Rp, int r, float (&w)[kUnit]) {
  int q[kUnit];
  if constexpr (LO == 8) {
    const int8_t* p = static_cast<const int8_t*>(lo);
#pragma unroll
    for (int j = 0; j < kUnit; ++j) q[j] = p[(int64_t)(u * kUnit + j) * Rp + r];
  } else {
    constexpr int PW = 32 / LO;  // fields per word
    const uint32_t* p = static_cast<const uint32_t*>(lo);
#pragma unroll
    for (int wi = 0; wi < kUnit / PW; ++wi) {
      const uint32_t word = p[(int64_t)(u * (kUnit / PW) + wi) * Rp + r];
#pragma unroll
      for (int i = 0; i < PW; ++i) {
        if constexpr (SIGNED)
          q[wi * PW + i] =
              static_cast<int32_t>(word << (32 - LO - LO * i)) >> (32 - LO);
        else
          q[wi * PW + i] = (word >> (LO * i)) & ((1u << LO) - 1u);
      }
    }
    if constexpr (HI > 0) {
      constexpr int HPW = 32 / HI;
#pragma unroll
      for (int wi = 0; wi < kUnit / HPW; ++wi) {
        const uint32_t word = hi[(int64_t)(u * (kUnit / HPW) + wi) * Rp + r];
#pragma unroll
        for (int i = 0; i < HPW; ++i)
          q[wi * HPW + i] |= ((word >> (HI * i)) & ((1u << HI) - 1u)) << LO;
      }
    }
  }
  constexpr int zero = SIGNED ? 0 : ZERO;
#pragma unroll
  for (int gi = 0; gi < kUnit / G; ++gi) {
    const int grp = u * (kUnit / G) + gi;
    const float s = group_value<PACKED>(scale, grp, Rp, r);
    float b = 0.f;
    if constexpr (BIAS) b = group_value<PACKED>(bias, grp, Rp, r);
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
      const int j = gi * G + jj;
      float v = __fmul_rn(static_cast<float>(q[j] - zero), s);
      if constexpr (BIAS) v = __fadd_rn(v, b);
      w[j] = __bfloat162float(__float2bfloat16_rn(v));
    }
  }
}

template <int LO, int HI, bool SIGNED, int ZERO, int G, bool BIAS, bool PACKED,
          int MT>
__global__ void __launch_bounds__(kThreads) qmatmul_kernel(
    const __nv_bfloat16* __restrict__ x, const void* __restrict__ lo,
    const uint32_t* __restrict__ hi, const void* __restrict__ scale,
    const void* __restrict__ bias, float* __restrict__ out, int M, int Kp,
    int Rp, int ldy, int units_per_split) {
  __shared__ __align__(16) float xs[MT][kChunk];
  const int r = blockIdx.x * kThreads + threadIdx.x;  // < Rp: Rp % 128 == 0
  const int m0 = blockIdx.y * MT;
  const int n_units = Kp / kUnit;
  const int u_begin = blockIdx.z * units_per_split;
  const int u_end = min(u_begin + units_per_split, n_units);

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int u0 = u_begin; u0 < u_end; u0 += kChunk / kUnit) {
    const int nu = min(kChunk / kUnit, u_end - u0);
    const int len = nu * kUnit;
    __syncthreads();
    for (int i = threadIdx.x; i < MT * len; i += kThreads) {
      const int m = i / len, kk = i - m * len;
      xs[m][kk] = (m0 + m < M)
                      ? __bfloat162float(x[(int64_t)(m0 + m) * Kp +
                                           u0 * kUnit + kk])
                      : 0.f;
    }
    __syncthreads();
    for (int uu = 0; uu < nu; ++uu) {
      float w[kUnit];
      dequant_unit<LO, HI, SIGNED, ZERO, G, BIAS, PACKED>(lo, hi, scale, bias,
                                                          u0 + uu, Rp, r, w);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float a = acc[m];
#pragma unroll
        for (int j = 0; j < kUnit; ++j) a = fmaf(xs[m][uu * kUnit + j], w[j], a);
        acc[m] = a;
      }
    }
  }

  if (gridDim.z == 1) {  // out is y [M, ldy]
    if (r < ldy) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m0 + m < M) out[(int64_t)(m0 + m) * ldy + r] = acc[m];
    }
  } else {  // out is the split partials [splits, M, Rp]
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m0 + m < M)
        out[((int64_t)blockIdx.z * M + m0 + m) * Rp + r] = acc[m];
  }
}

// y[m, r] = sum over splits s, in order, of part[s, m, r]
__global__ void sum_splits(const float* __restrict__ part,
                           float* __restrict__ y, int splits, int M, int Rp,
                           int ldy) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)M * ldy) return;
  const int m = i / ldy, r = i - (int64_t)m * ldy;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[((int64_t)sp * M + m) * Rp + r];
  y[i] = s;
}

template <int LO, int HI, bool SIGNED, int ZERO, int G, bool BIAS, bool PACKED,
          int MT>
void launch(const void* x, const void* lo, const void* hi, const void* scale,
            const void* bias, void* out, int M, int Kp, int Rp, int ldy,
            int splits, int units_per_split, cudaStream_t stream) {
  dim3 grid(Rp / kThreads, (M + MT - 1) / MT, splits);
  qmatmul_kernel<LO, HI, SIGNED, ZERO, G, BIAS, PACKED, MT>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(x), lo,
          static_cast<const uint32_t*>(hi), scale, bias,
          static_cast<float*>(out), M, Kp, Rp, ldy, units_per_split);
}

template <int LO, int HI, bool SIGNED, int ZERO, int G, bool BIAS, bool PACKED>
void launch_mt(int mt, const void* x, const void* lo, const void* hi,
               const void* scale, const void* bias, void* out, int M, int Kp,
               int Rp, int ldy, int splits, int ups, cudaStream_t s) {
  if (mt == 1)
    launch<LO, HI, SIGNED, ZERO, G, BIAS, PACKED, 1>(x, lo, hi, scale, bias,
                                                     out, M, Kp, Rp, ldy,
                                                     splits, ups, s);
  else
    launch<LO, HI, SIGNED, ZERO, G, BIAS, PACKED, 16>(x, lo, hi, scale, bias,
                                                      out, M, Kp, Rp, ldy,
                                                      splits, ups, s);
}

}  // namespace

// fmt: position in llm_tpu_torch.ops.packing.FORMATS (q4_0, q4_1, q5_0,
// q5_1, q8_0, q2_k, q3_k, q4_k, q5_k, q6_k). scale_packed: two f16 scales
// per word (32-block formats only). mt: rows of x per thread (1 or 16).
// With splits > 1, `part` is scratch [splits, M, Rp] f32 and a second
// kernel writes y; otherwise part is unused. Returns cudaGetLastError().
extern "C" int qmatmul_launch(int fmt, int scale_packed, int mt, const void* x,
                              const void* lo, const void* hi,
                              const void* scale, const void* bias, void* y,
                              void* part, int M, int Kp, int Rp, int R,
                              int splits, int units_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* out = splits > 1 ? part : y;
#define QM(LO, HI, SG, Z, G, B, P)                                           \
  launch_mt<LO, HI, SG, Z, G, B, P>(mt, x, lo, hi, scale, bias, out, M, Kp, \
                                    Rp, R, splits, units_per_split, s)
  const bool p = scale_packed != 0;
  switch (fmt) {
    case 0: if (p) QM(4, 0, true, 8, 32, false, true);
            else QM(4, 0, true, 8, 32, false, false); break;     // q4_0
    case 1: if (p) QM(4, 0, false, 0, 32, true, true);
            else QM(4, 0, false, 0, 32, true, false); break;     // q4_1
    case 2: if (p) QM(4, 1, false, 16, 32, false, true);
            else QM(4, 1, false, 16, 32, false, false); break;   // q5_0
    case 3: if (p) QM(4, 1, false, 0, 32, true, true);
            else QM(4, 1, false, 0, 32, true, false); break;     // q5_1
    case 4: if (p) QM(8, 0, false, 0, 32, false, true);
            else QM(8, 0, false, 0, 32, false, false); break;    // q8_0
    case 5: QM(2, 0, false, 0, 16, true, false); break;          // q2_k
    case 6: QM(2, 1, false, 4, 16, false, false); break;         // q3_k
    case 7: QM(4, 0, false, 0, 32, true, false); break;          // q4_k
    case 8: QM(4, 1, false, 0, 32, true, false); break;          // q5_k
    case 9: QM(4, 2, false, 32, 16, false, false); break;        // q6_k
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef QM
  if (splits > 1) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t n = (int64_t)M * R;
    sum_splits<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(part), static_cast<float*>(y), splits, M,
        Rp, R);
  }
  return static_cast<int>(cudaGetLastError());
}
