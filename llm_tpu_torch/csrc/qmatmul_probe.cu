// Probe variants of the scalar qmatmul kernel (qmatmul_body.cuh: one thread
// a column, scalar f32 FMAs), for the port's chip probes
// (llm_tpu_torch/probes/). The production kernel is now qmatmul_tc.cuh;
// these keep decomposing the design they were written for:
//
// - qmatmul_full_launch: that kernel whole (FULL, BASE) over planes or a
//   coalesced buffer, for all 10 formats: the scalar K1 and K3, P2's `full`
//   stage and the old side of chip_smoke.py's A/B against the new kernel.
// - qmatmul_stage_launch: the kernel cut after a stage (STREAM, UNPACK or
//   DEQUANT), over planes or a coalesced buffer, for q4_0, q8_0 (f16-packed
//   scales) and q6_k. Replaces the stage kernels of
//   scripts/probe_kernel_decompose.py (make_probe, run_chain) and the
//   stream-only kernel of scripts/probe_coalesced.py (make_stream_chain).
//   The TPU versions kept their loads alive with a max over 8 elements; here
//   every load reaches the column's value, so the compiler drops none.
// - qmatmul_mode_launch: the full kernel with another dequant arithmetic
//   (qm::Mode) over a coalesced q4_0 buffer. Replaces the modes of
//   scripts/probe_dequant_variants.py (make_call).
//
// What bounds them on the H100: the stages read the weight's packed bytes
// and nothing else (3.35 TB/s); the modes are the scalar kernel's loop with
// other arithmetic, so the same bounds as that kernel.

#include "qmatmul_body.cuh"
#include "qmatmul_formats.cuh"

namespace {

using qm::Fmt;
using Q4_0 = Fmt<4, 0, true, 8, 32, false, true>;
using Q8_0 = Fmt<8, 0, false, 0, 32, false, true>;
using Q6_K = Fmt<4, 2, false, 32, 16, false, false>;

// out[r] = the stage's value of column r over every split of m-tile 0, in
// split order: a wrapping uint32 sum (STREAM, UNPACK) or an f32 sum.
template <int STAGE>
__global__ void combine_stage(const float* __restrict__ part,
                              float* __restrict__ out, int splits, int mtiles,
                              int Rp) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= Rp) return;
  if constexpr (STAGE == qm::DEQUANT) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += part[(int64_t)sp * mtiles * Rp + r];
    out[r] = s;
  } else {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(part);
    uint32_t s = 0;
    for (int sp = 0; sp < splits; ++sp) s += p[(int64_t)sp * mtiles * Rp + r];
    reinterpret_cast<uint32_t*>(out)[r] = s;
  }
}

template <class F, bool COAL, int STAGE>
cudaError_t launch_stage(const qm::Weight& wt, void* part, void* out,
                         int mtiles, int Kp, int splits, int ups,
                         cudaStream_t s) {
  dim3 grid(wt.Rp / qm::kThreads, mtiles, splits);
  qm::qmatmul_kernel<F, 1, COAL, STAGE, qm::BASE, __nv_bfloat16>
      <<<grid, qm::kThreads, 0, s>>>(nullptr, wt, static_cast<float*>(part),
                                     0, Kp, 0, ups);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  combine_stage<STAGE><<<(wt.Rp + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), splits,
      mtiles, wt.Rp);
  return cudaGetLastError();
}

template <class F, bool COAL>
cudaError_t stage_of(int stage, const qm::Weight& wt, void* part, void* out,
                     int mtiles, int Kp, int splits, int ups, cudaStream_t s) {
  switch (stage) {
    case qm::STREAM:
      return launch_stage<F, COAL, qm::STREAM>(wt, part, out, mtiles, Kp,
                                               splits, ups, s);
    case qm::UNPACK:
      return launch_stage<F, COAL, qm::UNPACK>(wt, part, out, mtiles, Kp,
                                               splits, ups, s);
    case qm::DEQUANT:
      return launch_stage<F, COAL, qm::DEQUANT>(wt, part, out, mtiles, Kp,
                                                splits, ups, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <class F>
cudaError_t stage_layout(bool coal, int stage, const qm::Weight& wt,
                         void* part, void* out, int mtiles, int Kp,
                         int splits, int ups, cudaStream_t s) {
  if (coal)
    return stage_of<F, true>(stage, wt, part, out, mtiles, Kp, splits, ups, s);
  return stage_of<F, false>(stage, wt, part, out, mtiles, Kp, splits, ups, s);
}

}  // namespace

// The scalar kernel whole (formerly the production entry point). fmt:
// position in llm_tpu_torch.ops.packing.FORMATS; scale_packed: two f16
// scales per word; mt: rows of x per thread (1 or 16); x bf16 [M, Kp]. lo/hi/scale/bias are
// the planes, or with tile_r > 0 the segments of a coalesced buffer. With
// splits > 1, `part` is scratch [splits, M, Rp] f32 and a second kernel
// writes y. Returns cudaGetLastError().
extern "C" int qmatmul_full_launch(int fmt, int scale_packed, int mt,
                                   const void* x, const void* lo,
                                   const void* hi, const void* scale,
                                   const void* bias, int tile_k, int tile_r,
                                   int n_k, int rows_tile, int lo_rows,
                                   int hi_rows, int sc_rows, void* y,
                                   void* part, int M, int Kp, int Rp, int R,
                                   int splits, int units_per_split,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const qm::Weight wt =
      qm::make_weight(lo, hi, scale, bias, Rp, tile_k, tile_r, n_k, rows_tile,
                      lo_rows, hi_rows, sc_rows);
  return static_cast<int>(with_format<qm::Fmt>(fmt, scale_packed != 0,
                                               [&](auto f) {
    using F = decltype(f);
    if (tile_r > 0)
      return qm::launch_full_mt<F, true, qm::BASE, __nv_bfloat16>(
          mt, x, wt, y, part, M, Kp, R, splits, units_per_split, s);
    return qm::launch_full_mt<F, false, qm::BASE, __nv_bfloat16>(
        mt, x, wt, y, part, M, Kp, R, splits, units_per_split, s);
  }));
}

// stage: qm::Stage (STREAM, UNPACK, DEQUANT). fmt: the FORMATS position of
// q4_0 (0) or q8_0 (4), both with f16-packed scales, or q6_k (9). The
// weight arguments are qmatmul_full_launch's. part: scratch [splits,
// mtiles, Rp] of 4-byte values; out: [Rp] (uint32 bits for STREAM and
// UNPACK, f32 for DEQUANT). mtiles, splits and units_per_split are those of
// qmatmul_full_launch at the same M. Returns cudaGetLastError().
extern "C" int qmatmul_stage_launch(int stage, int fmt, int scale_packed,
                                    const void* lo, const void* hi,
                                    const void* scale, const void* bias,
                                    int tile_k, int tile_r, int n_k,
                                    int rows_tile, int lo_rows, int hi_rows,
                                    int sc_rows, void* part, void* out,
                                    int mtiles, int Kp, int Rp, int splits,
                                    int units_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const qm::Weight wt =
      qm::make_weight(lo, hi, scale, bias, Rp, tile_k, tile_r, n_k, rows_tile,
                      lo_rows, hi_rows, sc_rows);
  const bool coal = tile_r > 0;
  cudaError_t e = cudaErrorInvalidValue;
  if (fmt == 0 && scale_packed)
    e = stage_layout<Q4_0>(coal, stage, wt, part, out, mtiles, Kp, splits,
                           units_per_split, s);
  else if (fmt == 4 && scale_packed)
    e = stage_layout<Q8_0>(coal, stage, wt, part, out, mtiles, Kp, splits,
                           units_per_split, s);
  else if (fmt == 9 && !scale_packed)
    e = stage_layout<Q6_K>(coal, stage, wt, part, out, mtiles, Kp, splits,
                           units_per_split, s);
  return static_cast<int>(e);
}

// mode: qm::Mode. A coalesced q4_0 buffer with f16-packed scales (tile_r >
// 0); x is bf16 [M, Kp], or f32 for F32DOT. The other arguments are
// qmatmul_full_launch's. Returns cudaGetLastError().
extern "C" int qmatmul_mode_launch(int mode, int mt, const void* x,
                                   const void* lo, const void* scale,
                                   int tile_k, int tile_r, int n_k,
                                   int rows_tile, int lo_rows, int sc_rows,
                                   void* y, void* part, int M, int Kp, int Rp,
                                   int R, int splits, int units_per_split,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_r <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const qm::Weight wt = qm::make_weight(lo, nullptr, scale, nullptr, Rp,
                                        tile_k, tile_r, n_k, rows_tile,
                                        lo_rows, 0, sc_rows);
  const int ups = units_per_split;
  cudaError_t e;
  switch (mode) {
    case qm::BASE:
      e = qm::launch_full_mt<Q4_0, true, qm::BASE, __nv_bfloat16>(
          mt, x, wt, y, part, M, Kp, R, splits, ups, s);
      break;
    case qm::BF16:
      e = qm::launch_full_mt<Q4_0, true, qm::BF16, __nv_bfloat16>(
          mt, x, wt, y, part, M, Kp, R, splits, ups, s);
      break;
    case qm::F32DOT:
      e = qm::launch_full_mt<Q4_0, true, qm::F32DOT, float>(
          mt, x, wt, y, part, M, Kp, R, splits, ups, s);
      break;
    case qm::GHOIST:
      e = qm::launch_full_mt<Q4_0, true, qm::GHOIST, __nv_bfloat16>(
          mt, x, wt, y, part, M, Kp, R, splits, ups, s);
      break;
    case qm::NOSCALE:
      e = qm::launch_full_mt<Q4_0, true, qm::NOSCALE, __nv_bfloat16>(
          mt, x, wt, y, part, M, Kp, R, splits, ups, s);
      break;
    case qm::NOUNPACK:
      e = qm::launch_full_mt<Q4_0, true, qm::NOUNPACK, __nv_bfloat16>(
          mt, x, wt, y, part, M, Kp, R, splits, ups, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
