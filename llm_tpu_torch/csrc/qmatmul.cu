// Fused dequantize -> matmul over quantized weight planes or the coalesced
// buffer, on the tensor cores (the kernels are in qmatmul_tc.cuh, which
// says what they replace, what bounds them and how).
//
// Replaces the TPU kernels of llm_tpu/ops/qmatmul.py: K1 (_qmatmul_pallas,
// _qmatmul_pallas_stacked; body _make_kernel) over K-major planes, and K3
// (_qmatmul_pallas_c, _qmatmul_pallas_c_stacked; body _make_kernel_c) over
// the coalesced QuantTensorC buffer. A layer of a stacked weight is a
// base-pointer offset taken by the wrapper.

#include "qmatmul_tc.cuh"

// Calls fn(F<...>{}) with the kernel's traits of format `fmt` (its
// position in llm_tpu_torch.ops.packing.FORMATS: q4_0, q4_1, q5_0, q5_1,
// q8_0, q2_k, q3_k, q4_k, q5_k, q6_k) and f16-packed scales `p`: F<LO, HI,
// SIGNED, ZERO, G, BIAS, PACKED> (lo and hi field bits, the lo field stored
// as q - ZERO in two's complement, the zero point, the group size, a bias
// plane, two f16 scales a word). K-quants always carry f32 scales.
template <template <int, int, bool, int, int, bool, bool> class F, class Fn>
cudaError_t with_format(int fmt, bool p, Fn&& fn) {
  switch (fmt) {
    case 0: return p ? fn(F<4, 0, true, 8, 32, false, true>{})      // q4_0
                     : fn(F<4, 0, true, 8, 32, false, false>{});
    case 1: return p ? fn(F<4, 0, false, 0, 32, true, true>{})      // q4_1
                     : fn(F<4, 0, false, 0, 32, true, false>{});
    case 2: return p ? fn(F<4, 1, false, 16, 32, false, true>{})    // q5_0
                     : fn(F<4, 1, false, 16, 32, false, false>{});
    case 3: return p ? fn(F<4, 1, false, 0, 32, true, true>{})      // q5_1
                     : fn(F<4, 1, false, 0, 32, true, false>{});
    case 4: return p ? fn(F<8, 0, false, 0, 32, false, true>{})     // q8_0
                     : fn(F<8, 0, false, 0, 32, false, false>{});
    case 5: return fn(F<2, 0, false, 0, 16, true, false>{});        // q2_k
    case 6: return fn(F<2, 1, false, 4, 16, false, false>{});       // q3_k
    case 7: return fn(F<4, 0, false, 0, 32, true, false>{});        // q4_k
    case 8: return fn(F<4, 1, false, 0, 32, true, false>{});        // q5_k
    case 9: return fn(F<4, 2, false, 32, 16, false, false>{});      // q6_k
    default: return cudaErrorInvalidValue;
  }
}

// fmt: position in llm_tpu_torch.ops.packing.FORMATS (q4_0, q4_1, q5_0,
// q5_1, q8_0, q2_k, q3_k, q4_k, q5_k, q6_k). scale_packed: two f16 scales
// per word (32-block formats only). path: tc::Path (0, 1: swapped, x f32
// [M, ldx]; 2: wide, x bf16 [M, ldx], 16-byte aligned, bm = 64, 128 or 256
// tokens a block); ldx % 8 == 0, and the columns from ldx up to Kp are read
// as zeros. lo/hi/scale/bias are the planes, or with tile_r > 0 the
// segments of a coalesced buffer (see qmatmul_tc.cuh); tile_k % 64 == 0.
// The grid is (R rounded to 128) / 128 x mtiles x splits, each split
// `tiles_per_split` 64-k tiles of Kp; with splits > 1, `part` is scratch
// [splits, M, R rounded to 128] f32 and a second kernel writes y [M, R].
// Returns the launch's cudaError_t.
extern "C" int qmatmul_launch(int fmt, int scale_packed, int path,
                              const void* x, int ldx, const void* lo,
                              const void* hi, const void* scale,
                              const void* bias, int tile_k, int tile_r,
                              int n_k, int rows_tile, int lo_rows,
                              int hi_rows, int sc_rows, void* y, void* part,
                              int M, int Kp, int Rp, int R, int bm,
                              int mtiles, int splits, int tiles_per_split,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const tc::Weight wt{lo,     hi,     scale,     bias,    Rp,      tile_k,
                      tile_r, n_k,    rows_tile, lo_rows, hi_rows, sc_rows};
  const int n_kt = Kp / tc::BK;
  return static_cast<int>(with_format<tc::Fmt>(fmt, scale_packed != 0,
                                               [&](auto f) {
    using F = decltype(f);
    if (tile_r > 0)
      return tc::launch<F, true>(path, x, ldx, wt, y, part, M, R, bm, mtiles,
                                 splits, tiles_per_split, n_kt, s);
    return tc::launch<F, false>(path, x, ldx, wt, y, part, M, R, bm, mtiles,
                                splits, tiles_per_split, n_kt, s);
  }));
}
