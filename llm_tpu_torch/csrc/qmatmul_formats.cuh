// The 10 GGML formats as a qmatmul kernel's traits, shared by
// csrc/qmatmul.cu (the tensor-core kernel, tc::Fmt) and csrc/qmatmul_probe.cu
// (the scalar kernel, qm::Fmt). A kernel's Fmt takes <LO, HI, SIGNED, ZERO,
// G, BIAS, PACKED>: lo and hi field bits, the lo field stored as q - ZERO
// in two's complement, the zero point, the group size, a bias plane, two
// f16 scales a word.

#pragma once

#include <cuda_runtime.h>

// Calls fn(F<...>{}) with the instantiation of format `fmt` (its position
// in llm_tpu_torch.ops.packing.FORMATS: q4_0, q4_1, q5_0, q5_1, q8_0, q2_k,
// q3_k, q4_k, q5_k, q6_k) and f16-packed scales `p`. K-quants always carry
// f32 scales.
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
