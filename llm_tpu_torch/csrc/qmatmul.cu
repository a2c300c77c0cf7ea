// Fused dequantize -> matmul over quantized weight planes or the coalesced
// buffer (the kernel itself is in qmatmul_body.cuh).
//
// Replaces the TPU kernels of llm_tpu/ops/qmatmul.py: K1 (_qmatmul_pallas,
// _qmatmul_pallas_stacked; body _make_kernel) over K-major planes, and K3
// (_qmatmul_pallas_c, _qmatmul_pallas_c_stacked; body _make_kernel_c) over
// the coalesced QuantTensorC buffer. A layer of a stacked weight is a
// base-pointer offset taken by the wrapper.
//
// What bounds it on the H100: at decode (M = 1) the packed weight bytes,
// 4.5 bits a weight for q4_0 (3.35 TB/s); at prefill (M = 512) the
// arithmetic, which this kernel does on the FP32 pipes (67 TFLOP/s), not
// the tensor cores, so it stays far from the bf16 tensor-core bound.

#include "qmatmul_body.cuh"

namespace {

using qm::Fmt;

// f: the format's traits; calls fn(f) with the instantiation of (fmt,
// scale_packed). K-quants always carry f32 scales.
template <class Fn>
cudaError_t with_format(int fmt, bool p, Fn&& fn) {
  switch (fmt) {
    case 0: return p ? fn(Fmt<4, 0, true, 8, 32, false, true>{})      // q4_0
                     : fn(Fmt<4, 0, true, 8, 32, false, false>{});
    case 1: return p ? fn(Fmt<4, 0, false, 0, 32, true, true>{})      // q4_1
                     : fn(Fmt<4, 0, false, 0, 32, true, false>{});
    case 2: return p ? fn(Fmt<4, 1, false, 16, 32, false, true>{})    // q5_0
                     : fn(Fmt<4, 1, false, 16, 32, false, false>{});
    case 3: return p ? fn(Fmt<4, 1, false, 0, 32, true, true>{})      // q5_1
                     : fn(Fmt<4, 1, false, 0, 32, true, false>{});
    case 4: return p ? fn(Fmt<8, 0, false, 0, 32, false, true>{})     // q8_0
                     : fn(Fmt<8, 0, false, 0, 32, false, false>{});
    case 5: return fn(Fmt<2, 0, false, 0, 16, true, false>{});        // q2_k
    case 6: return fn(Fmt<2, 1, false, 4, 16, false, false>{});       // q3_k
    case 7: return fn(Fmt<4, 0, false, 0, 32, true, false>{});        // q4_k
    case 8: return fn(Fmt<4, 1, false, 0, 32, true, false>{});        // q5_k
    case 9: return fn(Fmt<4, 2, false, 32, 16, false, false>{});      // q6_k
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// fmt: position in llm_tpu_torch.ops.packing.FORMATS (q4_0, q4_1, q5_0,
// q5_1, q8_0, q2_k, q3_k, q4_k, q5_k, q6_k). scale_packed: two f16 scales
// per word (32-block formats only). mt: rows of x per thread (1 or 16).
// lo/hi/scale/bias are the planes, or with tile_r > 0 the segments of a
// coalesced buffer (see qmatmul_body.cuh). With splits > 1, `part` is
// scratch [splits, M, Rp] f32 and a second kernel writes y; otherwise part
// is unused. Returns cudaGetLastError().
extern "C" int qmatmul_launch(int fmt, int scale_packed, int mt, const void* x,
                              const void* lo, const void* hi,
                              const void* scale, const void* bias, int tile_k,
                              int tile_r, int n_k, int rows_tile, int lo_rows,
                              int hi_rows, int sc_rows, void* y, void* part,
                              int M, int Kp, int Rp, int R, int splits,
                              int units_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const qm::Weight wt =
      qm::make_weight(lo, hi, scale, bias, Rp, tile_k, tile_r, n_k, rows_tile,
                      lo_rows, hi_rows, sc_rows);
  return static_cast<int>(with_format(fmt, scale_packed != 0, [&](auto f) {
    using F = decltype(f);
    if (tile_r > 0)
      return qm::launch_full_mt<F, true, qm::BASE, __nv_bfloat16>(
          mt, x, wt, y, part, M, Kp, R, splits, units_per_split, s);
    return qm::launch_full_mt<F, false, qm::BASE, __nv_bfloat16>(
        mt, x, wt, y, part, M, Kp, R, splits, units_per_split, s);
  }));
}
