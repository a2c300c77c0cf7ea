// The fused dequantize -> matmul on Hopper's tensor cores: the production
// kernel of csrc/qmatmul.cu.
//
//   y[M, R] f32 = bf16(x[M, K]) . bf16(dequant(W))     (f32 accumulation)
//   dequant(W)[k, r] = bf16_rn(f32(q[k, r] - zero) * scale [+ bias])
//
// Replaces the TPU kernels of llm_tpu/ops/qmatmul.py: K1 (_qmatmul_pallas,
// _qmatmul_pallas_stacked; body _make_kernel) over K-major planes and K3
// (_qmatmul_pallas_c, _qmatmul_pallas_c_stacked; body _make_kernel_c) over
// the coalesced QuantTensorC buffer. The reference feeds the MXU bf16 x and
// bf16 weights with f32 accumulation; here that product is mma.sync
// m16n8k16 bf16 -> f32 (M <= 32) or wgmma m64n128k16 (M > 32).
//
// What bounds it on the H100, and what the design does about it:
// - M <= 32 (decode, serving steps): the packed weight bytes (4.5 bits a
//   weight for q4_0; 3.35 TB/s) and the dequant arithmetic, which must
//   keep up with them. 16-byte cp.async copies fill a ring of STAGES
//   tiles, so several tiles a block are in flight, and three or four
//   blocks share an SM. Then the loop's own instructions (~7 a q4_0
//   weight, 4 of them the dequant) and its stalls, not the loads, set
//   its time (PERF.md). The operands are swapped (y^T = W^T x^T): the weight tile
//   is the 16-row A side and the tokens the n = 8 (M <= 8) or 16 side, so
//   M = 8 pads nothing. x is read as it is, f32, and rounded to bf16 once
//   a stage into the mma's B fragments: no copy of x before the launch.
// - M > 32 (prefill chunks of 64 and 512): the bf16 tensor-core rate, and
//   the dequant, which must overlap the products and not follow them (a
//   pass over 7B's weights is ~0.9 ms of issue at ~4 instructions a q4_0
//   weight). Hopper's design: x (bf16) the A side, 64, 128 or 256 tokens a
//   block by M (wgmma's 64-row tiles: M = 64 pads nothing, and M = 512
//   dequantizes each weight twice, not four times), the block's 128
//   weight columns the B side. Two rings: the packed rows, every thread's
//   16-byte cp.async several k-tiles ahead (the bytes in flight that
//   stream the weights), and x through a TMA tensor map with 128-byte
//   swizzle (its out-of-bounds fill gives the zero columns past ldx and
//   rows past M) on mbarriers. Every thread of the two warpgroups
//   dequantizes 32 weights of a k-tile into the bf16 B tile (three
//   buffers, in wgmma's swizzled K-major layout); the warpgroups then
//   issue their wgmmas asynchronously, both operands from shared memory,
//   the accumulators in registers, and go on to dequantize the next
//   k-tile while the tensor cores work. Where the grid does not fill the
//   card (wo, down) K is split. What bounds it now is not the FLOPs but a
//   k-tile's latency: its barrier, proxy fence, wgmma wait and mbarrier
//   wait cost ~160-340 cycles each on the H100 (probes/sync_costs), in
//   series with the dequant, against ~1000 cycles of wgmma at bm = 256.
//   (A dedicated dequant warpgroup beside consumer warpgroups measured no
//   faster: PERF.md.)
// - The dequant needs no int -> float conversion: a field ORed into the
//   mantissa of 2^23 (0x4B000000) is 2^23 + q exactly; subtracting
//   2^23 + zero leaves q - zero. A field at bit p of a word (p + width
//   <= 23) gives (q - zero) * 2^p, multiplied by scale * 2^-p: the same
//   exact product, rounded once, so a word needs one shift, not one a
//   field. __fmul_rn/__fadd_rn are never contracted into an FMA, and
//   cvt.rn.bf16x2.f32 rounds a pair: each weight is bit-equal to the plain
//   dequant rounded to bf16.
//
// The dequantized tile sits in shared memory as bf16 [BN][BK], r-major and
// k-contiguous, its 16-byte chunks swizzled by row (chunk ^ row % 8: the
// 128-byte swizzle that TMA writes and wgmma reads), so that the 16-byte
// stores and ldmatrix meet no bank conflicts.
//
// Two weight layouts, one addressing rule: a stage's rows of a segment
// (lo, hi, scale, bias) start at
//   planes:    seg + (kt * rows) * Rp + r0
//   coalesced: seg + ((rt * n_k + ckt) * rows_tile + kt * rows
//                     - ckt * seg_rows) * tile_r + r0 % tile_r
// with ckt the coalesced k-tile that holds the stage (tile_k % BK == 0) and
// rows the segment's rows a stage; a row is 512 contiguous bytes either
// way (128 bytes of an int8 q8_0 plane). Both layouts fill the same
// shared tiles and sum the same products in the same order: K3 is
// bit-equal to K1 at every M. The K split (grid z) is summed by a second
// pass in a fixed order: deterministic, no atomics.
//
// The chip probes (csrc/qmatmul_probe.cu) instantiate the same two kernels
// with a Stage other than FULL (the main loop cut after a stage of each
// thread's 32 weights) or, on the swapped path, a Mode other than BASE
// (another dequant arithmetic); FULL and BASE are the production code, and
// every other branch below is `if constexpr` away from it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int BN = 128;     // weight columns (r) a block
constexpr int BK = 64;      // k a stage
constexpr int STAGES = 4;   // ring of stages in flight (swapped path)
constexpr int THREADS = 256;  // the swapped path's block
constexpr int XS = BK + 8;    // f32 x row in shared memory (conflict-free)

// Consumer paths (the plan's `path`): swapped with 8 or 16 tokens a block,
// or wide.
enum Path : int { SWAPPED8 = 0, SWAPPED16 = 1, WIDE = 2 };

// How far the main loop runs. FULL is the kernel. A cut keeps every copy
// (the packed rows and x), wait, barrier and fence of the loop and its trip
// count; it drops what feeds only the tensor cores (x's bf16 staging,
// ldmatrix and mma.sync; wgmma, its fence and its waits) and leaves one
// value a column of the block (lanes of one column summed):
//   STREAM:  wrapping uint32 sum of every weight word the thread's dequant
//            reads from the stage (a q8_0 plane's bytes sign-extended; a
//            scale or bias word once a group, so a packed word twice);
//   UNPACK:  the same sum of the codes q (as unpack_q gives them: q4_0's
//            and q8_0's signed) plus the scale and bias words: the
//            production field extraction, then a shift of each field down
//            to bit 0 that the dequant does not need;
//   DEQUANT: f32 sum of every weight after the exact dequant to bf16; the
//            swapped path keeps it in registers (no store of the tile),
//            the wide path stores the bf16 B tile as FULL does.
enum Stage : int { FULL = 0, STREAM = 1, UNPACK = 2, DEQUANT = 3 };

// The dequant arithmetic of a FULL launch of the swapped path at 8 tokens
// a block over a coalesced q4_0 buffer (the probe P3). BASE is K1's.
//   BF16:     w = bf16(bf16(q - zero) * bf16(scale)) in bf16x2 arithmetic:
//             (128 + q) from the bits 0x4300 | q, minus 136, times the
//             scale; no f32 step, each step exact or rounded once
//   F32DOT:   x and w unrounded: x as three bf16 terms, w = (q - zero) *
//             scale (exact in f32) as two, five mma products a k-step
//   GHOIST:   the tile holds q - zero (exact); the two k16 products of a
//             32-group go into a partial, then acc += scale * partial
//   NOSCALE:  w = q - zero (wrong on purpose: the cost of the scaling)
//   NOUNPACK: w = bf16(int32(lo word) * scale) for each field of the word
//             (wrong on purpose: the cost of the field extraction)
enum Mode : int { BASE = 0, BF16 = 1, F32DOT = 2, GHOIST = 3, NOSCALE = 4,
                  NOUNPACK = 5 };

// What a cut leaves a thread: a wrapping sum (STREAM, UNPACK) or an f32 one
// (DEQUANT)
struct Cut {
  uint32_t ck;
  float fs;
};

// A GGML format as the kernel sees it (llm_tpu_torch.ops.packing.FORMATS).
// SIGNED: the lo field is q - ZERO in two's complement (q4_0).
template <int LO_, int HI_, bool SIGNED_, int ZERO_, int G_, bool BIAS_,
          bool PACKED_>
struct Fmt {
  static constexpr int LO = LO_, HI = HI_, G = G_, ZERO = ZERO_;
  static constexpr bool SIGNED = SIGNED_, BIAS = BIAS_, PACKED = PACKED_;
};

// Where one layer of the weight lies. For planes lo/hi/scale/bias are the
// planes; for a coalesced buffer they point at each segment's first row
// (buf + offset * tile_r) and tile_r > 0.
struct Weight {
  const void* lo;
  const void* hi;
  const void* scale;
  const void* bias;
  int Rp;                          // padded R: plane row stride
  int tile_k, tile_r, n_k;         // coalesced tiling
  int rows_tile;                   // word rows of one (r, k) block
  int lo_rows, hi_rows, sc_rows;   // rows of each segment in a k-tile
};

// The packed stage of a format in shared memory: lo, hi, scale, bias rows.
template <class F, bool COAL>
struct Tile {
  static constexpr bool Q8P = F::LO == 8 && !COAL;  // int8 [Kp, Rp] plane
  static constexpr int LO_ROWS = Q8P ? BK : BK * F::LO / 32;
  static constexpr int LO_ROW = Q8P ? BN : BN * 4;  // bytes a row
  static constexpr int HI_ROWS = BK * F::HI / 32;
  static constexpr int SC_ROWS = F::PACKED ? BK / (2 * F::G) : BK / F::G;
  static constexpr int BI_ROWS = F::BIAS ? SC_ROWS : 0;
  static constexpr int HI_OFF = LO_ROWS * LO_ROW;
  static constexpr int SC_OFF = HI_OFF + HI_ROWS * BN * 4;
  static constexpr int BI_OFF = SC_OFF + SC_ROWS * BN * 4;
  static constexpr int BYTES = BI_OFF + BI_ROWS * BN * 4;
};

// ---------------------------------------------------------------------------
// primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared (a shared-window address), asynchronous;
// pred false writes zeros.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// byte offset of 16-byte chunk `c` of row `row` in a [rows][64] bf16 tile
__device__ __forceinline__ int swz(int row, int c) {
  return row * (BK * 2) + ((c ^ (row & 7)) << 4);
}

__device__ __forceinline__ float half_bits(uint32_t b) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
}

// (a & b) ^ c in one LOP3: b and c in registers, so that the compiler
// does not split it into two instructions of one immediate each
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// ---------------------------------------------------------------------------
// producer: packed words of a (BK x BN) weight tile, and x

template <bool COAL>
__device__ __forceinline__ const char* seg_row0(const Weight& w,
                                                const void* seg, int seg_rows,
                                                int rows, int elt, int kt,
                                                int r0, int64_t& stride) {
  const char* p = static_cast<const char*>(seg);
  if constexpr (COAL) {
    const int ckt = kt * BK / w.tile_k;
    stride = (int64_t)w.tile_r * 4;
    const int64_t row = ((int64_t)(r0 / w.tile_r) * w.n_k + ckt) * w.rows_tile +
                        (int64_t)kt * rows - (int64_t)ckt * seg_rows;
    return p + row * stride + (int64_t)(r0 % w.tile_r) * 4;
  } else {
    stride = (int64_t)w.Rp * elt;
    return p + (int64_t)kt * rows * stride + (int64_t)r0 * elt;
  }
}

// This thread's 16-byte copies of a stage's packed weight: for each, its
// source in the next tile to load, its place in the stage and the step to
// the tile after. Computed once a block (and again where a coalesced
// buffer's k-tile changes), advanced by an add a tile.
template <class F, bool COAL>
struct Feed {
  using T = Tile<F, COAL>;
  static constexpr int count(int rows, int row) {
    return (rows * (row / 16) + THREADS - 1) / THREADS;
  }
  static constexpr int NLO = count(T::LO_ROWS, T::LO_ROW);
  static constexpr int NHI = count(T::HI_ROWS, BN * 4);
  static constexpr int NSC = count(T::SC_ROWS, BN * 4);
  static constexpr int NBI = count(T::BI_ROWS, BN * 4);
  static constexpr int N = NLO + NHI + NSC + NBI;
  const char* src[N];
  int64_t step[N];
  int dst[N];
  bool on[N];

  __device__ __forceinline__ void seg(int& i, int n, const Weight& w,
                                      const void* p0, int seg_rows, int rows,
                                      int row, int elt, int off, int kt,
                                      int r0, int tid) {
    int64_t stride;
    const char* p = seg_row0<COAL>(w, p0, seg_rows, rows, elt, kt, r0, stride);
    const int cpr = row / 16;
    for (int j = 0; j < n; ++j, ++i) {
      const int c = tid + j * THREADS;
      on[i] = c < rows * cpr;
      const int cc = on[i] ? c : 0;
      src[i] = p + (cc / cpr) * stride + (cc % cpr) * 16;
      dst[i] = off + cc * 16;
      step[i] = rows * stride;
    }
  }

  __device__ __forceinline__ void init(const Weight& w, int kt, int r0,
                                       int tid) {
    int i = 0;
    seg(i, NLO, w, w.lo, w.lo_rows, T::LO_ROWS, T::LO_ROW, T::Q8P ? 1 : 4, 0,
        kt, r0, tid);
    if constexpr (F::HI > 0)
      seg(i, NHI, w, w.hi, w.hi_rows, T::HI_ROWS, BN * 4, 4, T::HI_OFF, kt,
          r0, tid);
    seg(i, NSC, w, w.scale, w.sc_rows, T::SC_ROWS, BN * 4, 4, T::SC_OFF, kt,
        r0, tid);
    if constexpr (F::BIAS)
      seg(i, NBI, w, w.bias, w.sc_rows, T::BI_ROWS, BN * 4, 4, T::BI_OFF, kt,
          r0, tid);
  }

  __device__ __forceinline__ void issue(uint32_t stage) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (on[i]) cp16(stage + dst[i], src[i], true);
  }

  // to tile kt (the one after the last issued)
  __device__ __forceinline__ void advance(const Weight& w, int kt, int r0,
                                          int tid) {
    if constexpr (COAL) {
      if ((kt * BK) % w.tile_k == 0) {
        init(w, kt, r0, tid);
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) src[i] += step[i];
  }
};

// ---------------------------------------------------------------------------
// dequant: 32 weights (k = 32u .. 32u+31 of the stage) of column c, from
// the packed stage `pk` into row c of the bf16 tile `wt`; a cut (STAGE)
// adds into `cut` instead, a mode (MODE) changes the arithmetic

template <class F>
__device__ __forceinline__ float group_value(const char* seg, int grp, int c) {
  if constexpr (F::PACKED) {
    const uint32_t word =
        reinterpret_cast<const uint32_t*>(seg)[(grp >> 1) * BN + c];
    return half_bits((grp & 1) ? (word >> 16) : (word & 0xFFFFu));
  }
  return reinterpret_cast<const float*>(seg)[grp * BN + c];
}

// the word group_value reads
template <class F>
__device__ __forceinline__ uint32_t group_word(const char* seg, int grp,
                                               int c) {
  return reinterpret_cast<const uint32_t*>(
      seg)[(F::PACKED ? grp >> 1 : grp) * BN + c];
}

// the f32 sum of a bf16 pair
__device__ __forceinline__ float bf16x2_sum(uint32_t p) {
  return __uint_as_float(p << 16) + __uint_as_float(p & 0xFFFF0000u);
}

// (lo, hi) rounded to a bf16 pair, and what the rounding left in lo and hi
// (exact in f32)
__device__ __forceinline__ uint32_t bf16x2_rest(float& lo, float& hi) {
  const uint32_t p = bf16x2(lo, hi);
  lo -= __uint_as_float(p << 16);
  hi -= __uint_as_float(p & 0xFFFF0000u);
  return p;
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// F32DOT: the bf16 tile of w's second terms, from the first's (after x's B
// fragments: 8 tokens a block)
constexpr int XB1_BYTES = BK / 16 * 32 * 8;
constexpr int F32DOT_LO = BN * BK * 2 + XB1_BYTES;
// the shared memory a mode adds to the swapped block: F32DOT's second tile
// and x's second and third terms
constexpr int mode_smem(int mode) {
  return mode == F32DOT ? BN * BK * 2 + 2 * XB1_BYTES : 0;
}

template <class F, bool COAL, int STAGE = FULL, int MODE = BASE,
          bool STORE = true>
__device__ __forceinline__ void dequant_unit(const char* pk, int c, int u,
                                             char* wt, Cut* cut = nullptr) {
  using T = Tile<F, COAL>;
  constexpr int LO = F::LO, G = F::G, NG = 32 / G;
  constexpr uint32_t MAGIC = 0x4B000000u;  // 2^23 as f32
  constexpr bool WORDS = STAGE == STREAM || STAGE == UNPACK;
  static_assert(MODE == BASE || (STAGE == FULL && LO == 4 && F::HI == 0 &&
                                 F::SIGNED && G == 32 && !T::Q8P),
                "the modes take q4_0");
  float s[NG], b[NG];
#pragma unroll
  for (int gi = 0; gi < NG; ++gi) {
    if constexpr (WORDS) {
      // the group's scale (and bias) word, once a group
      cut->ck += group_word<F>(pk + T::SC_OFF, u * NG + gi, c);
      if constexpr (F::BIAS)
        cut->ck += group_word<F>(pk + T::BI_OFF, u * NG + gi, c);
    } else {
      s[gi] = group_value<F>(pk + T::SC_OFF, u * NG + gi, c);
      b[gi] = 0.f;
      if constexpr (F::BIAS)
        b[gi] = group_value<F>(pk + T::BI_OFF, u * NG + gi, c);
    }
  }
  const uint32_t* lo32 = reinterpret_cast<const uint32_t*>(pk);
  float v[32];
  if constexpr (F::HI == 0 && !T::Q8P) {
    // fields at bit p < 16 of the word, the rest of the word shifted by 16:
    // (q - zero) * 2^pp times scale * 2^-pp, pp = p % 16
    constexpr int NW = LO, PW = 32 / LO, NPP = 16 / LO;
    constexpr uint32_t MASK = (1u << LO) - 1u;
    constexpr uint32_t XOR = (F::SIGNED || LO == 8) ? (1u << (LO - 1)) : 0u;
    constexpr int OFF = XOR ? (int)XOR : F::ZERO;
    if constexpr (STAGE == STREAM) {
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) cut->ck += lo32[(u * NW + wi) * BN + c];
      return;
    }
    if constexpr (MODE == BF16 || MODE == NOUNPACK) {
      // a word is a chunk: its 8 weights, 4 bf16 pairs
      const uint32_t s2 = bf16x2(s[0], s[0]);
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) {
        const uint32_t w = lo32[(u * NW + wi) * BN + c];
        uint4 chunk;
        if constexpr (MODE == BF16) {
          // fields f and f + 4 as the bf16 pair (128 + q): XOR 8 undoes
          // the two's complement of q - 8
          uint32_t pr[4];
#pragma unroll
          for (int f = 0; f < 4; ++f)
            pr[f] = and_xor(w >> (4 * f), 0x000F000Fu, 0x43084308u);
          const uint32_t pairs[4] = {prmt(pr[0], pr[1], 0x5410u),
                                     prmt(pr[2], pr[3], 0x5410u),
                                     prmt(pr[0], pr[1], 0x7632u),
                                     prmt(pr[2], pr[3], 0x7632u)};
          uint32_t o[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const __nv_bfloat162 q = __hsub2(
                *reinterpret_cast<const __nv_bfloat162*>(&pairs[i]),
                __nv_bfloat162(__ushort_as_bfloat16(0x4308),
                               __ushort_as_bfloat16(0x4308)));
            const __nv_bfloat162 h = __hmul2(
                q, *reinterpret_cast<const __nv_bfloat162*>(&s2));
            o[i] = *reinterpret_cast<const uint32_t*>(&h);
          }
          chunk = make_uint4(o[0], o[1], o[2], o[3]);
        } else {
          const float x = __fmul_rn(__int2float_rn(static_cast<int>(w)), s[0]);
          const uint32_t p = bf16x2(x, x);
          chunk = make_uint4(p, p, p, p);
        }
        *reinterpret_cast<uint4*>(wt + swz(c, 4 * u + wi)) = chunk;
      }
      return;
    }
    float sp[NG][NPP];
    if constexpr (!WORDS) {
#pragma unroll
      for (int gi = 0; gi < NG; ++gi)
#pragma unroll
        for (int i = 0; i < NPP; ++i)
          sp[gi][i] = i == 0 ? s[gi]
                             : __fmul_rn(s[gi], __uint_as_float(
                                                    (127u - LO * i) << 23));
    }
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) {
      const uint32_t w = lo32[(u * NW + wi) * BN + c];
      const uint32_t wh = w >> 16;
#pragma unroll
      for (int f = 0; f < PW; ++f) {
        const int j = wi * PW + f, p = LO * f, pp = p & 15;
        const uint32_t src = p < 16 ? w : wh;
        if constexpr (STAGE == UNPACK) {
          const uint32_t bits = and_xor(src, MASK << pp, (XOR << pp) | MAGIC);
          cut->ck += ((bits ^ MAGIC) >> pp) - XOR;
        } else if constexpr (MODE == NOSCALE || MODE == GHOIST) {
          // the field at bit pp of the mantissa of 2^(23 - pp) is
          // 2^(23 - pp) + q: q - zero with no multiply
          const uint32_t bits =
              and_xor(src, MASK << pp, (XOR << pp) | ((150u - pp) << 23));
          v[j] = __uint_as_float(bits) -
                 static_cast<float>((1 << (23 - pp)) + OFF);
        } else {
          const uint32_t bits = and_xor(src, MASK << pp, (XOR << pp) | MAGIC);
          const float q = __uint_as_float(bits) -
                          static_cast<float>(8388608 + (OFF << pp));
          float x = __fmul_rn(q, sp[j / G][pp / LO]);
          if constexpr (F::BIAS) x = __fadd_rn(x, b[j / G]);
          v[j] = x;
        }
      }
    }
    if constexpr (STAGE == UNPACK) return;
  } else if constexpr (T::Q8P) {
    const uint8_t* lo8 = reinterpret_cast<const uint8_t*>(pk);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if constexpr (STAGE == STREAM) {
        cut->ck += static_cast<uint32_t>(static_cast<int32_t>(
            reinterpret_cast<const int8_t*>(pk)[(u * 32 + j) * BN + c]));
      } else {
        const uint32_t byte = lo8[(u * 32 + j) * BN + c];
        if constexpr (STAGE == UNPACK) {
          cut->ck += (((byte ^ 0x80u) | MAGIC) ^ MAGIC) - 0x80u;
        } else {
          const float q = __uint_as_float((byte ^ 0x80u) | MAGIC) - 8388736.f;
          v[j] = __fmul_rn(q, s[j / G]);
        }
      }
    }
    if constexpr (WORDS) return;
  } else {  // a hi plane: q = lo field | hi field << LO
    constexpr int NW = LO, PW = 32 / LO, NH = F::HI, HPW = 32 / F::HI;
    constexpr uint32_t MASK = (1u << LO) - 1u, HMASK = (1u << F::HI) - 1u;
    const uint32_t* hi32 = reinterpret_cast<const uint32_t*>(pk + T::HI_OFF);
    uint32_t lw[NW], hw[NH];
#pragma unroll
    for (int i = 0; i < NW; ++i) lw[i] = lo32[(u * NW + i) * BN + c];
#pragma unroll
    for (int i = 0; i < NH; ++i) hw[i] = hi32[(u * NH + i) * BN + c];
    if constexpr (STAGE == STREAM) {
#pragma unroll
      for (int i = 0; i < NW; ++i) cut->ck += lw[i];
#pragma unroll
      for (int i = 0; i < NH; ++i) cut->ck += hw[i];
      return;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t q = ((lw[j / PW] >> (LO * (j % PW))) & MASK) |
                         (((hw[j / HPW] >> (F::HI * (j % HPW))) & HMASK) << LO);
      if constexpr (STAGE == UNPACK) {
        cut->ck += q;
      } else {
        const float qf = __uint_as_float(q | MAGIC) -
                         static_cast<float>(8388608 + F::ZERO);
        float x = __fmul_rn(qf, s[j / G]);
        if constexpr (F::BIAS) x = __fadd_rn(x, b[j / G]);
        v[j] = x;
      }
    }
    if constexpr (STAGE == UNPACK) return;
  }
  if constexpr (!WORDS) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (MODE == F32DOT) {
        // w = hi + lo exactly: the first term to the tile, the second to the
        // tile at F32DOT_LO
        float r[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) r[e] = v[8 * i + e];
        const uint4 hi = make_uint4(
            bf16x2_rest(r[0], r[1]), bf16x2_rest(r[2], r[3]),
            bf16x2_rest(r[4], r[5]), bf16x2_rest(r[6], r[7]));
        const uint4 lo = make_uint4(bf16x2(r[0], r[1]), bf16x2(r[2], r[3]),
                                    bf16x2(r[4], r[5]), bf16x2(r[6], r[7]));
        *reinterpret_cast<uint4*>(wt + swz(c, 4 * u + i)) = hi;
        *reinterpret_cast<uint4*>(wt + F32DOT_LO + swz(c, 4 * u + i)) = lo;
      } else {
        const uint4 chunk =
            make_uint4(bf16x2(v[8 * i], v[8 * i + 1]),
                       bf16x2(v[8 * i + 2], v[8 * i + 3]),
                       bf16x2(v[8 * i + 4], v[8 * i + 5]),
                       bf16x2(v[8 * i + 6], v[8 * i + 7]));
        if constexpr (STORE)
          *reinterpret_cast<uint4*>(wt + swz(c, 4 * u + i)) = chunk;
        if constexpr (STAGE == DEQUANT)
          cut->fs += bf16x2_sum(chunk.x) + bf16x2_sum(chunk.y) +
                     bf16x2_sum(chunk.z) + bf16x2_sum(chunk.w);
      }
    }
  }
}

// y or the split partials: out is y [M, ldy] (gridDim.z == 1) or
// [splits, M, ldo]
__device__ __forceinline__ void store_out(float* out, int m, int r, float v,
                                          int M, int ldy, int ldo) {
  if (m >= M) return;
  if (gridDim.z == 1) {
    if (r < ldy) out[(int64_t)m * ldy + r] = v;
  } else {
    out[((int64_t)blockIdx.z * M + m) * ldo + r] = v;
  }
}

// ---------------------------------------------------------------------------
// the swapped path: M <= 16 a block. Warp w dequantizes and multiplies
// weight columns 16w .. 16w+15 of the block (the A side), against NT
// 8-token tiles of x (the B side), read as f32 and rounded to bf16.

template <class F, bool COAL, int NT>
struct Swapped {
  static constexpr int BM = 8 * NT;
  static constexpr int X_BYTES = BM * XS * 4;
  static constexpr int STAGE = Tile<F, COAL>::BYTES + X_BYTES;
  static constexpr int XB_BYTES = BK / 16 * NT * 32 * 8;  // bf16 B fragments
  static constexpr int SMEM = STAGES * STAGE + BN * BK * 2 + XB_BYTES;
  static constexpr int XC = (BM * 16 + THREADS - 1) / THREADS;  // x copies
  static constexpr int XE = (BK / 16 * NT * 32 + THREADS - 1) / THREADS;
};

// A cut's value of a column into out [splits, mtiles, ldo] (uint32 bits
// for STREAM and UNPACK)
template <int STAGE>
__device__ __forceinline__ void store_cut(float* out, int r, int ldo,
                                          const Cut& cut) {
  const int64_t o = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * ldo + r;
  if constexpr (STAGE == DEQUANT)
    out[o] = cut.fs;
  else
    reinterpret_cast<uint32_t*>(out)[o] = cut.ck;
}

template <class F, bool COAL, int NT, int STAGE = FULL, int MODE = BASE>
__global__ void __launch_bounds__(THREADS, 4)
    qmm_swapped(const float* __restrict__ x, int ldx, const Weight wt,
                float* __restrict__ out, int M, int ldy, int ldo, int n_kt,
                int tps) {
  static_assert(MODE == BASE || (STAGE == FULL && NT == 1),
                "the modes run at 8 tokens a block");
  using S = Swapped<F, COAL, NT>;
  using T = Tile<F, COAL>;
  extern __shared__ __align__(128) char smem[];
  char* wts = smem + STAGES * S::STAGE;
  // x of the current stage as the mma's B fragments, [k16 step][n tile]
  // [lane]: rounded to bf16 once a block, not once a warp
  uint2* xb = reinterpret_cast<uint2*>(wts + BN * BK * 2);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * BN, m0 = blockIdx.y * S::BM;
  const int kt0 = blockIdx.z * tps;
  const int nk = min(kt0 + tps, n_kt) - kt0;

  // this thread's copies: the weight's (feed) and x's, 16 bytes of rows
  // tid / 16 + 16 j (a row past M reads zeros)
  Feed<F, COAL> feed;
  feed.init(wt, kt0, r0, tid);
  const int xc = tid & 15;
  const float* xsrc[S::XC];
  bool x_row[S::XC];
#pragma unroll
  for (int j = 0; j < S::XC; ++j) {
    const int m = (tid >> 4) + j * (THREADS / 16);
    x_row[j] = m < S::BM && m0 + m < M;
    xsrc[j] = x_row[j] ? x + (int64_t)(m0 + m) * ldx + kt0 * BK + xc * 4 : x;
  }
  int xk = kt0 * BK + xc * 4;  // the k this thread's x copies start at
  const uint32_t sbase = smem_u32(smem);
  int slot = 0;  // the ring slot of the next load
  auto load = [&](int i) {
    const uint32_t st = sbase + slot * S::STAGE;
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    feed.issue(st);
    feed.advance(wt, kt0 + i + 1, r0, tid);
#pragma unroll
    for (int j = 0; j < S::XC; ++j) {
      const int m = (tid >> 4) + j * (THREADS / 16);
      if (m < S::BM) {
        const bool ok = x_row[j] && xk < ldx;
        cp16(st + T::BYTES + (m * XS + xc * 4) * 4, ok ? xsrc[j] : x, ok);
        xsrc[j] += BK;
      }
    }
    xk += BK;
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nk) load(i);
    cp_commit();
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  Cut cut{0u, 0.f};
  // F32DOT: x's second and third bf16 terms, after the second weight tile
  uint2* xb1 = xb + F32DOT_LO / 8;
  uint2* xb2 = xb1 + XB1_BYTES / 8;

  for (int i = 0; i < nk; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < nk) load(i + STAGES - 1);
    cp_commit();
    const char* st = smem + (i % STAGES) * S::STAGE;
    if constexpr (STAGE == FULL) {
      const float* xs = reinterpret_cast<const float*>(st + T::BYTES);
#pragma unroll
      for (int j = 0; j < S::XE; ++j) {
        const int e = tid + j * THREADS;
        if (e < BK / 16 * NT * 32) {
          const int l = e & 31, n = (e >> 5) % NT, ks = e / (32 * NT);
          const float* xr =
              xs + (n * 8 + (l >> 2)) * XS + ks * 16 + 2 * (l & 3);
          const float2 lo = *reinterpret_cast<const float2*>(xr);
          const float2 hi = *reinterpret_cast<const float2*>(xr + 8);
          if constexpr (MODE == F32DOT) {
            float a0 = lo.x, a1 = lo.y, b0 = hi.x, b1 = hi.y;
            xb[e] = make_uint2(bf16x2_rest(a0, a1), bf16x2_rest(b0, b1));
            xb1[e] = make_uint2(bf16x2_rest(a0, a1), bf16x2_rest(b0, b1));
            xb2[e] = make_uint2(bf16x2(a0, a1), bf16x2(b0, b1));
          } else {
            xb[e] = make_uint2(bf16x2(lo.x, lo.y), bf16x2(hi.x, hi.y));
          }
        }
      }
    }
    dequant_unit<F, COAL, STAGE, MODE, STAGE == FULL>(
        st, warp * 16 + (lane & 15), lane >> 4, wts, &cut);
    __syncthreads();
    if constexpr (STAGE == FULL) {
      if constexpr (MODE == GHOIST) {
        // a 32-group's two k16 products into a partial, then the scale of
        // the partial's weight rows (16w + g, + 8) and the group
        const int g = lane >> 2;
#pragma unroll
        for (int gq = 0; gq < BK / 32; ++gq) {
          float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ks = 2 * gq + h;
            uint32_t a[4];
            const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            ldmatrix_x4(a, wts + swz(row, 2 * ks + (lane >> 4)));
            const uint2 bb = xb[ks * 32 + lane];
            mma_bf16(p, a, bb.x, bb.y);
          }
          const float sa = group_value<F>(st + T::SC_OFF, gq, warp * 16 + g);
          const float sb =
              group_value<F>(st + T::SC_OFF, gq, warp * 16 + g + 8);
          acc[0][0] = fmaf(sa, p[0], acc[0][0]);
          acc[0][1] = fmaf(sa, p[1], acc[0][1]);
          acc[0][2] = fmaf(sb, p[2], acc[0][2]);
          acc[0][3] = fmaf(sb, p[3], acc[0][3]);
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
          uint32_t a[4];
          const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(a, wts + swz(row, 2 * ks + (lane >> 4)));
          if constexpr (MODE == F32DOT) {
            // the small products first: w's second term, then x's
            uint32_t al[4];
            ldmatrix_x4(al, wts + F32DOT_LO + swz(row, 2 * ks + (lane >> 4)));
            const uint2 b0 = xb[ks * 32 + lane], b1 = xb1[ks * 32 + lane],
                        b2 = xb2[ks * 32 + lane];
            mma_bf16(acc[0], al, b1.x, b1.y);
            mma_bf16(acc[0], a, b2.x, b2.y);
            mma_bf16(acc[0], al, b0.x, b0.y);
            mma_bf16(acc[0], a, b1.x, b1.y);
            mma_bf16(acc[0], a, b0.x, b0.y);
          } else {
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              const uint2 b = xb[(ks * NT + n) * 32 + lane];
              mma_bf16(acc[n], a, b.x, b.y);
            }
          }
        }
      }
    }
  }
  cp_wait<0>();

  if constexpr (STAGE == FULL) {
    const int g = lane >> 2, t = lane & 3;
    const int r = r0 + warp * 16 + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int m = m0 + n * 8 + 2 * t;
      store_out(out, m, r, acc[n][0], M, ldy, ldo);
      store_out(out, m + 1, r, acc[n][1], M, ldy, ldo);
      store_out(out, m, r + 8, acc[n][2], M, ldy, ldo);
      store_out(out, m + 1, r + 8, acc[n][3], M, ldy, ldo);
    }
  } else {
    // lanes l and l + 16 hold the two halves of column 16w + l % 16
    if constexpr (STAGE == DEQUANT)
      cut.fs += __shfl_xor_sync(0xFFFFFFFFu, cut.fs, 16);
    else
      cut.ck += __shfl_xor_sync(0xFFFFFFFFu, cut.ck, 16);
    if (lane < 16) store_cut<STAGE>(out, r0 + warp * 16 + lane, ldo, cut);
  }
}

// ---------------------------------------------------------------------------
// the wide path (M > 32) on wgmma: x (bf16 [M, ldx]) the A side, bm = 64,
// 128 or 256 tokens a block, the block's 128 weight columns the B side. Two
// warpgroups; each k-tile, every thread dequantizes 32 weights into the
// bf16 B tile (three buffers), and each warpgroup then issues its wgmmas on
// it asynchronously: the next tile's dequant overlaps this tile's products.
// Warpgroup c takes, by bm: 64 - all 64 rows and weight columns 64c ..
// 64c + 63 (m64n64k16); 128 - rows 64c .. 64c + 63 (m64n128k16); 256 -
// rows 128c .. 128c + 127 (two m64n128k16). Two rings: the packed weight
// rows (every thread's 16-byte cp.async, several k-tiles ahead: the bytes
// in flight that stream the weights), each thread waiting for its own
// copies before the k-tile's one barrier, and the x tiles (TMA, 128-byte
// swizzle, on an mbarrier a stage, 2 k-tiles ahead: x comes from L2). A
// k-tile runs one barrier, one proxy fence, one wgmma wait and one
// mbarrier wait, ~160-340 cycles each (probes/sync_costs); with bm = 64
// two blocks share an SM.

constexpr int WG = 128;                       // threads a warpgroup
constexpr int WIDE_THREADS = 2 * WG;
constexpr int WIDE_X_STAGES = 4;              // the x ring
constexpr int WIDE_B_TILES = 3;               // the bf16 weight tiles
constexpr int WIDE_MAX_PSTAGES = 16;          // the packed ring, at most
constexpr int B_BYTES = BN * BK * 2;          // a bf16 weight tile

template <class F, bool COAL>
struct Wide {
  static constexpr int PK = Tile<F, COAL>::BYTES;  // a packed stage
  __host__ __device__ static constexpr int XT(int bm) {  // an x tile
    return bm * BK * 2;
  }
  // bm = 64: two blocks an SM, 113 KB each; else one, 227 KB
  __host__ __device__ static constexpr int smem_max(int bm) {
    return bm == 64 ? 115712 : 232448;
  }
  // 1 KB of alignment, the x ring (an mbarrier a stage), the weight tiles,
  // the packed ring
  __host__ __device__ static constexpr int room(int bm) {
    return smem_max(bm) - 1024 - WIDE_X_STAGES * (XT(bm) + 8) -
           WIDE_B_TILES * B_BYTES;
  }
  __host__ __device__ static constexpr int pstages(int bm) {
    return room(bm) / PK < WIDE_MAX_PSTAGES ? room(bm) / PK
                                            : WIDE_MAX_PSTAGES;
  }
  __host__ __device__ static constexpr int smem(int bm) {
    return 1024 + WIDE_X_STAGES * (XT(bm) + 8) + WIDE_B_TILES * B_BYTES +
           pstages(bm) * PK;
  }
};

// cp.async.wait_group n, for a run-time n (0 .. 15)
__device__ __forceinline__ void cp_wait_n(int n) {
  switch (n) {
#define TC_CPW(N) \
  case N:         \
    cp_wait<N>(); \
    break;
    TC_CPW(0) TC_CPW(1) TC_CPW(2) TC_CPW(3) TC_CPW(4) TC_CPW(5) TC_CPW(6)
    TC_CPW(7) TC_CPW(8) TC_CPW(9) TC_CPW(10) TC_CPW(11) TC_CPW(12)
    TC_CPW(13) TC_CPW(14)
#undef TC_CPW
    default:
      cp_wait<15>();
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// wait for the phase of parity `parity` to complete; a wait of more than
// 2^32 cycles (seconds) traps, a launch error, instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 == 0) t0 = now;
    else if (now - t0 > (1ll << 32)) __trap();
  }
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// a 2-D box of the tensor map at (c0, c1), innermost first, onto `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// a K-major operand of 8-row groups of 128-byte rows, 128-byte swizzle
// (the tile 1 KB aligned), starting at shared address `a`
__device__ __forceinline__ uint64_t sw128_desc(uint32_t a) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving the accumulator's registers across the
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int e = 0; e < 64; ++e) asm volatile("" : "+f"(d[e])::"memory");
}
// d (64 x 128, f32) += A (64 x 16 of x) . B (16 x 128 of the weights)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, f32; d[0..31]) += A (64 x 16 of x) . B (16 x 64 of the
// weights)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// MI: the 64-row tiles of a warpgroup, 2 for bm = 256, else 1 (128
// registers a thread: two blocks an SM where the shared memory allows). A
// cut (STAGE) keeps the x ring's TMA loads and waits, the packed ring's
// copies, the proxy fence and the barrier, and issues no wgmma.
template <class F, bool COAL, int MI, int STAGE = FULL>
__global__ void __launch_bounds__(WIDE_THREADS, MI == 1 ? 2 : 1)
    qmm_wgmma(const __grid_constant__ CUtensorMap xmap, const Weight wt,
              float* __restrict__ out, int M, int ldy, int ldo, int n_kt,
              int tps, int bm) {
  using S = Wide<F, COAL>;
  constexpr int XS = WIDE_X_STAGES, BT = WIDE_B_TILES;
  extern __shared__ __align__(1024) char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // tiles start on 1 KB
  char* sbase = smem_raw + (base - raw);
  const int PS = S::pstages(bm), xt = S::XT(bm);
  const uint32_t wtiles = base + XS * xt;        // the bf16 weight tiles
  const uint32_t packed = wtiles + BT * B_BYTES;  // the packed ring
  const uint32_t xbars = packed + PS * S::PK;     // the x ring's mbarriers
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = warp >> 2;  // warpgroup
  const int r0 = blockIdx.x * BN, m0 = blockIdx.y * bm;
  const int kt0 = blockIdx.z * tps;
  const int nk = min(kt0 + tps, n_kt) - kt0;
  if (tid == 0) {
    for (int s = 0; s < XS; ++s) mbar_init(xbars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // k-tile i's x tile into x stage i % XS (one thread), and its packed
  // rows into packed stage i % PS (every thread its copies, a group)
  auto load_x = [&](int i) {
    const uint32_t bar = xbars + 8 * (i % XS);
    mbar_expect_tx(bar, xt);
    tma_load_2d(base + (i % XS) * xt, &xmap, (kt0 + i) * BK, m0, bar);
  };
  Feed<F, COAL> feed;
  feed.init(wt, kt0, r0, tid);
  auto load_packed = [&](int i) {
    if (i < nk) {
      feed.issue(packed + (i % PS) * S::PK);
      feed.advance(wt, kt0 + i + 1, r0, tid);
    }
    cp_commit();
  };
  for (int i = 0; i < PS - 1; ++i) load_packed(i);
  cp_wait_n(PS - 2);  // this thread's copies of k-tile 0
  __syncthreads();    // every thread's, and the mbarriers
  if (tid == 0)
    for (int i = 0; i < min(XS, nk); ++i) load_x(i);

  // this warpgroup's A rows and B columns (bytes into the x and weight
  // tiles)
  const int a_off = bm == 64 ? 0 : c * MI * 64 * BK * 2;
  const int b_off = bm == 64 ? c * 64 * BK * 2 : 0;
  float d[MI][64];
#pragma unroll
  for (int h = 0; h < MI; ++h)
#pragma unroll
    for (int e = 0; e < 64; ++e) d[h][e] = 0.f;
  Cut cut{0u, 0.f};
  for (int i = 0; i < nk; ++i) {
    const uint32_t wb = wtiles + (i % BT) * B_BYTES;
    // this warpgroup's wgmmas of k-tile i - 2 are done. Weight tile i % BT
    // was last read by k-tile i - 3's, done in both warpgroups before the
    // last barrier; packed stage (i - 1) % PS was dequantized before it.
    if constexpr (STAGE == FULL) {
      wgmma_wait1();
#pragma unroll
      for (int h = 0; h < MI; ++h) fence_acc(d[h]);
    }
    load_packed(i + PS - 1);
    dequant_unit<F, COAL, STAGE>(sbase + (packed + (i % PS) * S::PK - base),
                                 tid & (BN - 1), tid >> 7,
                                 sbase + (wb - base), &cut);
    // the generic-proxy stores, before the wgmma reads them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    cp_wait_n(PS - 2);  // this thread's copies of k-tile i + 1
    __syncthreads();
    // k-tile i - 2's x stage is free: both warpgroups waited for its
    // wgmmas before the barrier
    if (tid == 0 && i >= 2 && i - 2 + XS < nk) load_x(i - 2 + XS);
    mbar_wait(xbars + 8 * (i % XS), (i / XS) & 1);
    if constexpr (STAGE == FULL) {
      const uint32_t xa = base + (i % XS) * xt + a_off;
#pragma unroll
      for (int h = 0; h < MI; ++h) fence_acc(d[h]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        const uint64_t db = sw128_desc(wb + b_off + 32 * ks);
        if (bm == 64) {
          wgmma_m64n64k16(d[0], sw128_desc(xa + 32 * ks), db);
        } else {
#pragma unroll
          for (int h = 0; h < MI; ++h)
            wgmma_m64n128k16(
                d[h], sw128_desc(xa + h * 64 * BK * 2 + 32 * ks), db);
        }
      }
      wgmma_commit();
    }
  }
  if constexpr (STAGE != FULL) {
    // threads c and c + 128 hold the two halves of column c: the second
    // hands its value over in the x ring (every TMA load was waited for)
    __syncthreads();
    uint32_t* red = reinterpret_cast<uint32_t*>(sbase);
    if (tid >= BN)
      red[tid - BN] = STAGE == DEQUANT ? __float_as_uint(cut.fs) : cut.ck;
    __syncthreads();
    if (tid < BN) {
      if constexpr (STAGE == DEQUANT)
        cut.fs += __uint_as_float(red[tid]);
      else
        cut.ck += red[tid];
      store_cut<STAGE>(out, r0 + tid, ldo, cut);
    }
  } else {
    wgmma_wait0();
#pragma unroll
    for (int h = 0; h < MI; ++h) fence_acc(d[h]);
    // d[h][4j + e]: row 64h + 16 (warp % 4) + lane / 4 (+ 8 for e >= 2),
    // column 8j + 2 (lane % 4) (+ 1 for odd e), in this warpgroup's tile
    const int nj = bm == 64 ? 8 : 16;
    const int rc = r0 + (bm == 64 ? 64 * c : 0);
#pragma unroll
    for (int h = 0; h < MI; ++h) {
      const int m = m0 + (bm == 64 ? 0 : c * MI * 64) + h * 64 +
                    (warp & 3) * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j >= nj) break;
        const int r = rc + 8 * j + 2 * (lane & 3);
        store_out(out, m, r, d[h][4 * j], M, ldy, ldo);
        store_out(out, m, r + 1, d[h][4 * j + 1], M, ldy, ldo);
        store_out(out, m + 8, r, d[h][4 * j + 2], M, ldy, ldo);
        store_out(out, m + 8, r + 1, d[h][4 * j + 3], M, ldy, ldo);
      }
    }
  }
}

// y[m, r] = sum over splits s, in order, of part[s, m, r]
__global__ void sum_splits(const float* __restrict__ part,
                           float* __restrict__ y, int splits, int M, int ldo,
                           int ldy) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)M * ldy) return;
  const int m = i / ldy, r = i - (int64_t)m * ldy;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp)
    s += part[((int64_t)sp * M + m) * ldo + r];
  y[i] = s;
}

// Raise KERNEL's dynamic shared memory limit (once: above 48 KB it must be
// asked for) and launch it.
template <auto KERNEL, typename XT>
cudaError_t run(int smem, dim3 grid, cudaStream_t s, const void* x, int ldx,
                const Weight& wt, float* out, int M, int ldy, int ldo,
                int n_kt, int tps) {
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  KERNEL<<<grid, THREADS, smem, s>>>(static_cast<const XT*>(x), ldx, wt, out,
                                     M, ldy, ldo, n_kt, tps);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (no
// -lcuda), looked up once
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The wide path's launch, bm = 64, 128 or 256: x bf16 [M, ldx] as a tensor
// map of 64 x bm boxes with 128-byte swizzle (columns past ldx and rows
// past M read as 0).
template <class F, bool COAL, int STAGE = FULL>
cudaError_t run_wide(int bm, dim3 grid, cudaStream_t s, const void* x,
                     int ldx, const Weight& wt, float* out, int M, int ldy,
                     int ldo, int n_kt, int tps) {
  using S = Wide<F, COAL>;
  if (bm != 64 && bm != 128 && bm != 256) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)ldx, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)ldx * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)bm};
  const cuuint32_t estr[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kern = bm == 256 ? qmm_wgmma<F, COAL, 2, STAGE>
                        : qmm_wgmma<F, COAL, 1, STAGE>;
  static bool raised[2] = {false, false};
  if (!raised[bm == 256]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem_max(256));
    if (e != cudaSuccess) return e;
    raised[bm == 256] = true;
  }
  kern<<<grid, WIDE_THREADS, S::smem(bm), s>>>(map, wt, out, M, ldy, ldo,
                                               n_kt, tps, bm);
  return cudaGetLastError();
}

// One launch on `path` (Path), then the split sum when K is split. x is
// f32 [M, ldx] on the swapped paths, bf16 [M, ldx] on the wide one
// (ldx % 8 == 0; columns from ldx up to Kp read as 0; bm tokens a block:
// 64, 128 or 256); part is scratch [splits, M, R rounded to BN] f32 when
// splits > 1.
template <class F, bool COAL>
cudaError_t launch(int path, const void* x, int ldx, const Weight& wt,
                   void* y, void* part, int M, int R, int bm, int mtiles,
                   int splits, int tps, int n_kt, cudaStream_t s) {
  const int ldo = (R + BN - 1) / BN * BN;
  const dim3 grid(ldo / BN, mtiles, splits);
  float* out = static_cast<float*>(splits > 1 ? part : y);
  cudaError_t e;
  switch (path) {
    case SWAPPED8:
      e = run<qmm_swapped<F, COAL, 1>, float>(Swapped<F, COAL, 1>::SMEM, grid,
                                              s, x, ldx, wt, out, M, R, ldo,
                                              n_kt, tps);
      break;
    case SWAPPED16:
      e = run<qmm_swapped<F, COAL, 2>, float>(Swapped<F, COAL, 2>::SMEM, grid,
                                              s, x, ldx, wt, out, M, R, ldo,
                                              n_kt, tps);
      break;
    case WIDE:
      e = run_wide<F, COAL>(bm, grid, s, x, ldx, wt, out, M, R, ldo, n_kt,
                            tps);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || splits == 1) return e;
  const int64_t n = (int64_t)M * R;
  sum_splits<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(y), splits, M, ldo,
      R);
  return cudaGetLastError();
}

}  // namespace tc
