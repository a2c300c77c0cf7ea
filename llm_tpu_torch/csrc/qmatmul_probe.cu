// The chip probes' kernels (llm_tpu_torch/probes/: P1-P3): cuts and dequant
// modes of the production tensor-core qmatmul kernels of qmatmul_tc.cuh,
// launched by the wrapper on qmatmul.plan's consumer path, tokens a block
// and K split at the same M. A cut or a mode differs from K1 only where
// its `if constexpr` branch does (qmatmul_tc.cuh: Stage, Mode):
//
// - qmatmul_stage_launch: qmm_swapped (M <= 32) or qmm_wgmma (M > 32) cut
//   after a stage (STREAM, UNPACK or DEQUANT) of each thread's 32 weights
//   a k-tile, over planes or a coalesced buffer, for q4_0, q8_0 (f16-packed
//   scales) and q6_k. Every copy (the packed rows and x), wait, barrier and
//   fence of the main loop stays, and its trip count; every word summed is
//   read from shared memory after its stage's wait, and every sum reaches
//   a store, so the compiler drops no load. The grid covers the padded
//   width Rp: a stage's value is defined on every column (q4_0's padding
//   fields are -8). Replaces the stage kernels of
//   scripts/probe_kernel_decompose.py (make_probe, run_chain) and the
//   stream-only kernel of scripts/probe_coalesced.py (make_stream_chain).
// - qmatmul_mode_launch: qmm_swapped at 8 tokens a block over a coalesced
//   q4_0 buffer (f16-packed scales) with another dequant arithmetic (Mode).
//   Replaces the modes of scripts/probe_dequant_variants.py (make_call).
//
// What bounds them on the H100: K1's bounds (the packed bytes at 3.35 TB/s,
// then the loop's instructions and synchronisation: qmatmul_tc.cuh); a cut
// does less work on the same stream of bytes, a mode other work.

#include "qmatmul_tc.cuh"

namespace {

using tc::Fmt;
using Q4_0 = Fmt<4, 0, true, 8, 32, false, true>;
using Q8_0 = Fmt<8, 0, false, 0, 32, false, true>;
using Q6_K = Fmt<4, 2, false, 32, 16, false, false>;

// out[r] = the cut's value of column r summed over the splits of m-tile 0
// in split order: a wrapping uint32 sum, or an f32 one (DEQUANT)
template <bool F32>
__global__ void combine_stage(const float* __restrict__ part,
                              float* __restrict__ out, int splits,
                              int mtiles, int Rp) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= Rp) return;
  if constexpr (F32) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      s += part[(int64_t)sp * mtiles * Rp + r];
    out[r] = s;
  } else {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(part);
    uint32_t s = 0;
    for (int sp = 0; sp < splits; ++sp) s += p[(int64_t)sp * mtiles * Rp + r];
    reinterpret_cast<uint32_t*>(out)[r] = s;
  }
}

// The cut on `path` (tc::Path) into part [splits, mtiles, Rp], then the
// split sum into out [Rp]
template <class F, bool COAL, int STAGE>
cudaError_t launch_stage(int path, const void* x, int ldx,
                         const tc::Weight& wt, void* part, void* out, int M,
                         int Rp, int bm, int mtiles, int splits, int tps,
                         int n_kt, cudaStream_t s) {
  const dim3 grid(Rp / tc::BN, mtiles, splits);
  float* p = static_cast<float*>(part);
  cudaError_t e;
  switch (path) {
    case tc::SWAPPED8:
      e = tc::run<tc::qmm_swapped<F, COAL, 1, STAGE>, float>(
          tc::Swapped<F, COAL, 1>::SMEM, grid, s, x, ldx, wt, p, M, Rp, Rp,
          n_kt, tps);
      break;
    case tc::SWAPPED16:
      e = tc::run<tc::qmm_swapped<F, COAL, 2, STAGE>, float>(
          tc::Swapped<F, COAL, 2>::SMEM, grid, s, x, ldx, wt, p, M, Rp, Rp,
          n_kt, tps);
      break;
    case tc::WIDE:
      e = tc::run_wide<F, COAL, STAGE>(bm, grid, s, x, ldx, wt, p, M, Rp,
                                       Rp, n_kt, tps);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  combine_stage<STAGE == tc::DEQUANT><<<(Rp + 255) / 256, 256, 0, s>>>(
      p, static_cast<float*>(out), splits, mtiles, Rp);
  return cudaGetLastError();
}

template <class F, bool COAL>
cudaError_t stage_of(int stage, int path, const void* x, int ldx,
                     const tc::Weight& wt, void* part, void* out, int M,
                     int Rp, int bm, int mtiles, int splits, int tps,
                     int n_kt, cudaStream_t s) {
  switch (stage) {
    case tc::STREAM:
      return launch_stage<F, COAL, tc::STREAM>(path, x, ldx, wt, part, out,
                                               M, Rp, bm, mtiles, splits,
                                               tps, n_kt, s);
    case tc::UNPACK:
      return launch_stage<F, COAL, tc::UNPACK>(path, x, ldx, wt, part, out,
                                               M, Rp, bm, mtiles, splits,
                                               tps, n_kt, s);
    case tc::DEQUANT:
      return launch_stage<F, COAL, tc::DEQUANT>(path, x, ldx, wt, part, out,
                                                M, Rp, bm, mtiles, splits,
                                                tps, n_kt, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <class F>
cudaError_t stage_layout(bool coal, int stage, int path, const void* x,
                         int ldx, const tc::Weight& wt, void* part,
                         void* out, int M, int Rp, int bm, int mtiles,
                         int splits, int tps, int n_kt, cudaStream_t s) {
  if (coal)
    return stage_of<F, true>(stage, path, x, ldx, wt, part, out, M, Rp, bm,
                             mtiles, splits, tps, n_kt, s);
  return stage_of<F, false>(stage, path, x, ldx, wt, part, out, M, Rp, bm,
                            mtiles, splits, tps, n_kt, s);
}

// A mode's launch on the swapped path at 8 tokens a block, then the split
// sum (as tc::launch)
template <int MODE>
cudaError_t launch_mode(const void* x, int ldx, const tc::Weight& wt,
                        void* y, void* part, int M, int R, int mtiles,
                        int splits, int tps, int n_kt, cudaStream_t s) {
  const int ldo = (R + tc::BN - 1) / tc::BN * tc::BN;
  const dim3 grid(ldo / tc::BN, mtiles, splits);
  float* out = static_cast<float*>(splits > 1 ? part : y);
  cudaError_t e = tc::run<tc::qmm_swapped<Q4_0, true, 1, tc::FULL, MODE>,
                          float>(
      tc::Swapped<Q4_0, true, 1>::SMEM + tc::mode_smem(MODE), grid, s, x,
      ldx, wt, out, M, R, ldo, n_kt, tps);
  if (e != cudaSuccess || splits == 1) return e;
  const int64_t n = (int64_t)M * R;
  tc::sum_splits<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(y), splits, M,
      ldo, R);
  return cudaGetLastError();
}

}  // namespace

// stage: tc::Stage (STREAM, UNPACK, DEQUANT). fmt: the FORMATS position of
// q4_0 (0) or q8_0 (4), both with f16-packed scales, or q6_k (9). path, x,
// ldx and the weight arguments are qmatmul_launch's (csrc/qmatmul.cu); x
// is copied and never summed. part: scratch [splits, mtiles, Rp] of 4-byte
// values; out: [Rp] (uint32 bits for STREAM and UNPACK, f32 for DEQUANT).
// Returns the launches' cudaError_t.
extern "C" int qmatmul_stage_launch(int stage, int fmt, int scale_packed,
                                    int path, const void* x, int ldx,
                                    const void* lo, const void* hi,
                                    const void* scale, const void* bias,
                                    int tile_k, int tile_r, int n_k,
                                    int rows_tile, int lo_rows, int hi_rows,
                                    int sc_rows, void* part, void* out,
                                    int M, int Kp, int Rp, int bm,
                                    int mtiles, int splits,
                                    int tiles_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const tc::Weight wt{lo,     hi,     scale,     bias,    Rp,      tile_k,
                      tile_r, n_k,    rows_tile, lo_rows, hi_rows, sc_rows};
  const bool coal = tile_r > 0;
  const int n_kt = Kp / tc::BK;
  cudaError_t e = cudaErrorInvalidValue;
  if (fmt == 0 && scale_packed)
    e = stage_layout<Q4_0>(coal, stage, path, x, ldx, wt, part, out, M, Rp,
                           bm, mtiles, splits, tiles_per_split, n_kt, s);
  else if (fmt == 4 && scale_packed)
    e = stage_layout<Q8_0>(coal, stage, path, x, ldx, wt, part, out, M, Rp,
                           bm, mtiles, splits, tiles_per_split, n_kt, s);
  else if (fmt == 9 && !scale_packed)
    e = stage_layout<Q6_K>(coal, stage, path, x, ldx, wt, part, out, M, Rp,
                           bm, mtiles, splits, tiles_per_split, n_kt, s);
  return static_cast<int>(e);
}

// mode: tc::Mode. A coalesced q4_0 buffer with f16-packed scales (tile_r >
// 0); x f32 [M, ldx] (M <= 8 a block: the swapped path at 8 tokens). The
// other arguments are qmatmul_launch's; part: scratch [splits, M, R
// rounded to 128] f32 when splits > 1. Returns the launches' cudaError_t.
extern "C" int qmatmul_mode_launch(int mode, const void* x, int ldx,
                                   const void* lo, const void* scale,
                                   int tile_k, int tile_r, int n_k,
                                   int rows_tile, int lo_rows, int sc_rows,
                                   void* y, void* part, int M, int Kp,
                                   int Rp, int R, int mtiles, int splits,
                                   int tiles_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_r <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const tc::Weight wt{lo,     nullptr, scale,     nullptr, Rp, tile_k,
                      tile_r, n_k,     rows_tile, lo_rows, 0,  sc_rows};
  const int n_kt = Kp / tc::BK, tps = tiles_per_split;
  cudaError_t e;
  switch (mode) {
    case tc::BASE:
      e = launch_mode<tc::BASE>(x, ldx, wt, y, part, M, R, mtiles, splits,
                                tps, n_kt, s);
      break;
    case tc::BF16:
      e = launch_mode<tc::BF16>(x, ldx, wt, y, part, M, R, mtiles, splits,
                                tps, n_kt, s);
      break;
    case tc::F32DOT:
      e = launch_mode<tc::F32DOT>(x, ldx, wt, y, part, M, R, mtiles, splits,
                                  tps, n_kt, s);
      break;
    case tc::GHOIST:
      e = launch_mode<tc::GHOIST>(x, ldx, wt, y, part, M, R, mtiles, splits,
                                  tps, n_kt, s);
      break;
    case tc::NOSCALE:
      e = launch_mode<tc::NOSCALE>(x, ldx, wt, y, part, M, R, mtiles,
                                   splits, tps, n_kt, s);
      break;
    case tc::NOUNPACK:
      e = launch_mode<tc::NOUNPACK>(x, ldx, wt, y, part, M, R, mtiles,
                                    splits, tps, n_kt, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
