// The scalar fused dequantize -> matmul kernel (f32 FMAs, one thread a
// column), the body of csrc/qmatmul_probe.cu only. It is no longer the
// production kernel (that is csrc/qmatmul_tc.cuh, on the tensor cores):
// the probes P2 and P3 keep decomposing the design they were written for,
// and its FULL stage is the old side of chip_smoke.py's A/B.
//
//   y[M, R] f32 = bf16(x[M, Kp]) . bf16(dequant(W))     (f32 accumulation)
//   dequant(W)[k, r] = (q[k, r] - zero) * scale[k/g, r] (+ bias[k/g, r])
//
// Two weight layouts, one addressing rule. Row j of a segment (lo, hi,
// scale or bias) at column r lies at
//   planes:    seg[j * Rp + r]
//   coalesced: seg[((rt * n_k + kt) * rows_tile + j - kt * seg_rows) * tile_r
//                  + r % tile_r]
// with rt = r / tile_r, kt the k-tile that holds the unit, and seg the
// segment's first row in the buffer (the reference's `coalesce_qt` order).
// tile_k is a multiple of 32, so a 32-element unit lies in one k-tile;
// tile_r is a multiple of 128, so a block's columns lie in one r-tile. A
// coalesced q8_0 lo holds four signed bytes a word; f32 scales are read
// from their bits. The unit, x-staging and K-split order do not depend on
// the layout, so both layouts give bit-equal results.
//
// Design, simple first:
// - one thread per output column r, 128 columns a block: neighbouring
//   threads read neighbouring words of every segment row;
// - x is staged in shared memory 256 K elements at a time, rounded to bf16
//   and widened to f32; every thread reads the same address (broadcast);
// - each thread dequantizes 32 weights (one "unit" of K) in registers,
//   rounds them to bf16 like the reference kernel, and accumulates MT rows
//   of x with f32 FMAs (bf16 x bf16 products are exact in f32);
// - grid (Rp/128, M tiles, K splits); the wrapper splits K when the column
//   blocks alone leave SMs idle, and a second pass sums the splits in a
//   fixed order: deterministic, no atomics.
// The dequant rounding uses __fmul_rn/__fadd_rn, which the compiler never
// contracts into an FMA, so each weight is bit-equal to the plain dequant.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qm {

constexpr int kThreads = 128;  // output columns per block
constexpr int kChunk = 256;    // K elements of x staged per pass
constexpr int kUnit = 32;      // K elements dequantized at once

// How far a launch runs. FULL is the whole kernel; the others stop
// after a stage and leave one value a column (STREAM, UNPACK: a wrapping
// uint32 sum of what they read; DEQUANT: the f32 sum of the weights), so
// that every load reaches a store and none is dropped by the compiler.
// They read no x.
enum Stage : int { FULL = 0, STREAM = 1, UNPACK = 2, DEQUANT = 3 };

// The dequant arithmetic of a FULL launch. BASE is the reference's.
//   BF16:     w = bf16(bf16(q - zero) * bf16(scale))
//   F32DOT:   w = (q - zero) * scale in f32, x not rounded either
//   GHOIST:   per group, sum x * (q - zero) in f32, then one FMA by scale
//   NOSCALE:  w = q - zero (wrong on purpose: the cost of scaling)
//   NOUNPACK: w = bf16(int32(lo word) * scale) for each field of the word
//             (wrong on purpose: the cost of the field extraction)
enum Mode : int { BASE = 0, BF16 = 1, F32DOT = 2, GHOIST = 3, NOSCALE = 4,
                  NOUNPACK = 5 };

// A GGML format as the kernel sees it (llm_tpu_torch.ops.packing.FORMATS).
template <int LO_, int HI_, bool SIGNED_, int ZERO_, int G_, bool BIAS_,
          bool PACKED_>
struct Fmt {
  static constexpr int LO = LO_, HI = HI_, G = G_;
  static constexpr int ZERO = SIGNED_ ? 0 : ZERO_;  // still to subtract
  static constexpr bool SIGNED = SIGNED_, BIAS = BIAS_, PACKED = PACKED_;
};

// Where one layer of the weight lies. For planes lo/hi/scale/bias are the
// planes; for a coalesced buffer they point at each segment's first row
// (buf + offset * tile_r) and tile_r > 0.
struct Weight {
  const void* lo;
  const uint32_t* hi;
  const uint32_t* scale;
  const uint32_t* bias;
  int Rp;                          // padded R: plane row stride, grid width
  int tile_k, tile_r, n_k;         // coalesced tiling
  int rows_tile;                   // word rows of one (r, k) block
  int lo_rows, hi_rows, sc_rows;   // rows of each segment in a k-tile
};

// The rows of one unit's segments at column r.
template <bool COAL>
struct UnitRows {
  int64_t col, stride;
  int lo0, hi0, sc0;  // segment rows of the k-tiles before this one

  __device__ __forceinline__ UnitRows(const Weight& w, int u, int r) {
    if constexpr (COAL) {
      const int kt = u * kUnit / w.tile_k;
      col = ((int64_t)(r / w.tile_r) * w.n_k + kt) * w.rows_tile * w.tile_r +
            r % w.tile_r;
      stride = w.tile_r;
      lo0 = kt * w.lo_rows;
      hi0 = kt * w.hi_rows;
      sc0 = kt * w.sc_rows;
    } else {
      col = r;
      stride = w.Rp;
      lo0 = hi0 = sc0 = 0;
    }
  }
  __device__ __forceinline__ int64_t lo(int j) const {
    return col + (int64_t)(j - lo0) * stride;
  }
  __device__ __forceinline__ int64_t hi(int j) const {
    return col + (int64_t)(j - hi0) * stride;
  }
  __device__ __forceinline__ int64_t sc(int j) const {
    return col + (int64_t)(j - sc0) * stride;
  }
};

__device__ __forceinline__ float half_bits(uint32_t b) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// scale or bias of group `grp` (index along K), and the word it came from
template <class F, bool COAL>
__device__ __forceinline__ float group_value(const uint32_t* seg,
                                             const UnitRows<COAL>& at,
                                             int grp, uint32_t& word) {
  if constexpr (F::PACKED) {
    word = seg[at.sc(grp >> 1)];
    return half_bits((grp & 1) ? (word >> 16) : (word & 0xFFFFu));
  }
  word = seg[at.sc(grp)];
  return __uint_as_float(word);
}

// Unit u (32 weights of K) of column r. What it leaves depends on STAGE:
//   STREAM:  ck += every word it loads (lo, hi, the scale and bias word of
//            each group; a packed word is read by both its groups);
//   UNPACK:  ck += every field q and every scale and bias word;
//   DEQUANT: fs += every weight rounded to bf16;
//   FULL:    w[] the weights the product uses (MODE); gs[] the group scales
//            (GHOIST).
template <class F, bool COAL, int STAGE, int MODE>
__device__ __forceinline__ void unit(const Weight& wt, int u, int r,
                                     float (&w)[kUnit],
                                     float (&gs)[kUnit / F::G], uint32_t& ck,
                                     float& fs) {
  constexpr int LO = F::LO;
  constexpr int PW = LO == 8 ? 4 : 32 / LO;  // fields per lo word
  const UnitRows<COAL> at(wt, u, r);
  int q[kUnit];
  uint32_t lo_words[kUnit / PW];
  if constexpr (LO == 8 && !COAL) {  // int8 plane
    const int8_t* p = static_cast<const int8_t*>(wt.lo);
#pragma unroll
    for (int j = 0; j < kUnit; ++j) {
      q[j] = p[at.lo(u * kUnit + j)];
      if constexpr (STAGE == STREAM) ck += static_cast<uint32_t>(q[j]);
    }
  } else {
    const uint32_t* p = static_cast<const uint32_t*>(wt.lo);
#pragma unroll
    for (int wi = 0; wi < kUnit / PW; ++wi) {
      const uint32_t word = p[at.lo(u * (kUnit / PW) + wi)];
      lo_words[wi] = word;
      if constexpr (STAGE == STREAM) ck += word;
#pragma unroll
      for (int i = 0; i < PW; ++i) {
        if constexpr (F::SIGNED || LO == 8)
          q[wi * PW + i] =
              static_cast<int32_t>(word << (32 - LO - LO * i)) >> (32 - LO);
        else
          q[wi * PW + i] = (word >> (LO * i)) & ((1u << LO) - 1u);
      }
    }
  }
  if constexpr (F::HI > 0) {
    constexpr int HPW = 32 / F::HI;
#pragma unroll
    for (int wi = 0; wi < kUnit / HPW; ++wi) {
      const uint32_t word = wt.hi[at.hi(u * (kUnit / HPW) + wi)];
      if constexpr (STAGE == STREAM) ck += word;
#pragma unroll
      for (int i = 0; i < HPW; ++i)
        q[wi * HPW + i] |= ((word >> (F::HI * i)) & ((1u << F::HI) - 1u))
                           << LO;
    }
  }
  if constexpr (STAGE == UNPACK) {
#pragma unroll
    for (int j = 0; j < kUnit; ++j) ck += static_cast<uint32_t>(q[j]);
  }
#pragma unroll
  for (int gi = 0; gi < kUnit / F::G; ++gi) {
    const int grp = u * (kUnit / F::G) + gi;
    uint32_t sw, bw = 0;
    const float s = group_value<F, COAL>(wt.scale, at, grp, sw);
    float b = 0.f;
    if constexpr (F::BIAS) b = group_value<F, COAL>(wt.bias, at, grp, bw);
    if constexpr (STAGE == STREAM || STAGE == UNPACK) {
      ck += sw;
      if constexpr (F::BIAS) ck += bw;
    }
    if constexpr (MODE == GHOIST) gs[gi] = s;
#pragma unroll
    for (int jj = 0; jj < F::G; ++jj) {
      const int j = gi * F::G + jj;
      const float qf = static_cast<float>(q[j] - F::ZERO);
      float v = __fmul_rn(qf, s);
      if constexpr (F::BIAS) v = __fadd_rn(v, b);
      if constexpr (STAGE == DEQUANT) fs += bf16_round(v);
      if constexpr (STAGE == FULL) {
        if constexpr (MODE == BASE) w[j] = bf16_round(v);
        if constexpr (MODE == BF16)
          w[j] = __bfloat162float(
              __hmul(__float2bfloat16_rn(qf), __float2bfloat16_rn(s)));
        if constexpr (MODE == F32DOT) w[j] = v;
        if constexpr (MODE == GHOIST || MODE == NOSCALE) w[j] = qf;
        if constexpr (MODE == NOUNPACK)
          w[j] = bf16_round(__fmul_rn(
              __int2float_rn(static_cast<int32_t>(lo_words[j / PW])), s));
      }
    }
  }
}

__device__ __forceinline__ float x_value(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float x_value(const float v) { return v; }

// FULL: out is y [M, ldy] (gridDim.z == 1) or the split partials
// [splits, M, Rp]. Other stages: out is [splits, gridDim.y, Rp] of one
// value a column (uint32 bits for STREAM and UNPACK).
template <class F, int MT, bool COAL, int STAGE, int MODE, typename XT>
__global__ void __launch_bounds__(kThreads)
    qmatmul_kernel(const XT* __restrict__ x, const Weight wt,
                   float* __restrict__ out, int M, int Kp, int ldy,
                   int units_per_split) {
  const int r = blockIdx.x * kThreads + threadIdx.x;  // < Rp: Rp % 128 == 0
  const int n_units = Kp / kUnit;
  const int u_begin = blockIdx.z * units_per_split;
  const int u_end = min(u_begin + units_per_split, n_units);
  float w[kUnit];
  float gs[kUnit / F::G];
  uint32_t ck = 0;
  float fs = 0.f;

  if constexpr (STAGE != FULL) {
    for (int u = u_begin; u < u_end; ++u)
      unit<F, COAL, STAGE, BASE>(wt, u, r, w, gs, ck, fs);
    const int64_t o = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * wt.Rp + r;
    if constexpr (STAGE == DEQUANT)
      out[o] = fs;
    else
      reinterpret_cast<uint32_t*>(out)[o] = ck;
  } else {
    __shared__ __align__(16) float xs[MT][kChunk];
    const int m0 = blockIdx.y * MT;
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
                        ? x_value(x[(int64_t)(m0 + m) * Kp + u0 * kUnit + kk])
                        : 0.f;
      }
      __syncthreads();
      for (int uu = 0; uu < nu; ++uu) {
        unit<F, COAL, FULL, MODE>(wt, u0 + uu, r, w, gs, ck, fs);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float a = acc[m];
          if constexpr (MODE == GHOIST) {
#pragma unroll
            for (int gi = 0; gi < kUnit / F::G; ++gi) {
              float part = 0.f;
#pragma unroll
              for (int jj = 0; jj < F::G; ++jj)
                part = fmaf(xs[m][uu * kUnit + gi * F::G + jj],
                            w[gi * F::G + jj], part);
              a = fmaf(part, gs[gi], a);
            }
          } else {
#pragma unroll
            for (int j = 0; j < kUnit; ++j)
              a = fmaf(xs[m][uu * kUnit + j], w[j], a);
          }
          acc[m] = a;
        }
      }
    }

    if (gridDim.z == 1) {
      if (r < ldy) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
          if (m0 + m < M) out[(int64_t)(m0 + m) * ldy + r] = acc[m];
      }
    } else {
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m0 + m < M)
          out[((int64_t)blockIdx.z * M + m0 + m) * wt.Rp + r] = acc[m];
    }
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

// A FULL launch, then the split sum when K is split. MT rows of x a thread.
template <class F, int MT, bool COAL, int MODE, typename XT>
cudaError_t launch_full(const void* x, const Weight& wt, void* y, void* part,
                        int M, int Kp, int R, int splits, int ups,
                        cudaStream_t s) {
  dim3 grid(wt.Rp / kThreads, (M + MT - 1) / MT, splits);
  qmatmul_kernel<F, MT, COAL, FULL, MODE, XT><<<grid, kThreads, 0, s>>>(
      static_cast<const XT*>(x), wt, static_cast<float*>(splits > 1 ? part : y),
      M, Kp, R, ups);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int64_t n = (int64_t)M * R;
  sum_splits<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(y), splits, M,
      wt.Rp, R);
  return cudaGetLastError();
}

// mt: rows of x a thread (1 or 16)
template <class F, bool COAL, int MODE, typename XT>
cudaError_t launch_full_mt(int mt, const void* x, const Weight& wt, void* y,
                           void* part, int M, int Kp, int R, int splits,
                           int ups, cudaStream_t s) {
  if (mt == 1)
    return launch_full<F, 1, COAL, MODE, XT>(x, wt, y, part, M, Kp, R, splits,
                                             ups, s);
  return launch_full<F, 16, COAL, MODE, XT>(x, wt, y, part, M, Kp, R, splits,
                                            ups, s);
}

// The weight arguments of the C entry points; tile_r == 0: planes.
inline Weight make_weight(const void* lo, const void* hi, const void* scale,
                          const void* bias, int Rp, int tile_k, int tile_r,
                          int n_k, int rows_tile, int lo_rows, int hi_rows,
                          int sc_rows) {
  return Weight{lo, static_cast<const uint32_t*>(hi),
                static_cast<const uint32_t*>(scale),
                static_cast<const uint32_t*>(bias), Rp, tile_k, tile_r, n_k,
                rows_tile, lo_rows, hi_rows, sc_rows};
}

}  // namespace qm
