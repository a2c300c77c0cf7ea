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
// m16n8k16 bf16 -> f32.
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
// - M > 32 (prefill chunks of 64 and 512): the bf16 tensor-core rate; x
//   (bf16) is the A side, 128 rows a block, 128 weight columns, so each
//   dequantized tile serves 128 tokens; the next tile is dequantized into
//   a second bf16 tile while this one is multiplied. mma.sync, not
//   wgmma, so this path stays well below the card's bf16 peak.
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
// k-contiguous, its 16-byte chunks swizzled by row so that the 16-byte
// stores and ldmatrix meet no bank conflicts.
//
// Two weight layouts, one addressing rule (as csrc/qmatmul_body.cuh's
// UnitRows): a stage's rows of a segment (lo, hi, scale, bias) start at
//   planes:    seg + (kt * rows) * Rp + r0
//   coalesced: seg + ((rt * n_k + ckt) * rows_tile + kt * rows
//                     - ckt * seg_rows) * tile_r + r0 % tile_r
// with ckt the coalesced k-tile that holds the stage (tile_k % BK == 0) and
// rows the segment's rows a stage; a row is 512 contiguous bytes either
// way (128 bytes of an int8 q8_0 plane). Both layouts fill the same
// shared tiles and sum the same products in the same order: K3 is
// bit-equal to K1 at every M. The K split (grid z) is summed by a second
// pass in a fixed order: deterministic, no atomics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int BN = 128;     // weight columns (r) a block
constexpr int BK = 64;      // k a stage
constexpr int STAGES = 4;   // ring of stages in flight (swapped path)
constexpr int WIDE_STAGES = 3;  // the wide path's ring
constexpr int THREADS = 256;
constexpr int WIDE_BM = 128;  // tokens a block on the wide path
constexpr int XS = BK + 8;    // f32 x row in shared memory (conflict-free)

// Consumer paths (the plan's `path`): swapped with 8 or 16 tokens a block,
// or wide.
enum Path : int { SWAPPED8 = 0, SWAPPED16 = 1, WIDE = 2 };

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
// the packed stage `pk` into row c of the bf16 tile `wt`

template <class F>
__device__ __forceinline__ float group_value(const char* seg, int grp, int c) {
  if constexpr (F::PACKED) {
    const uint32_t word =
        reinterpret_cast<const uint32_t*>(seg)[(grp >> 1) * BN + c];
    return half_bits((grp & 1) ? (word >> 16) : (word & 0xFFFFu));
  }
  return reinterpret_cast<const float*>(seg)[grp * BN + c];
}

template <class F, bool COAL>
__device__ __forceinline__ void dequant_unit(const char* pk, int c, int u,
                                             char* wt) {
  using T = Tile<F, COAL>;
  constexpr int LO = F::LO, G = F::G, NG = 32 / G;
  constexpr uint32_t MAGIC = 0x4B000000u;  // 2^23 as f32
  float s[NG], b[NG];
#pragma unroll
  for (int gi = 0; gi < NG; ++gi) {
    s[gi] = group_value<F>(pk + T::SC_OFF, u * NG + gi, c);
    b[gi] = 0.f;
    if constexpr (F::BIAS) b[gi] = group_value<F>(pk + T::BI_OFF, u * NG + gi, c);
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
    float sp[NG][NPP];
#pragma unroll
    for (int gi = 0; gi < NG; ++gi)
#pragma unroll
      for (int i = 0; i < NPP; ++i)
        sp[gi][i] = i == 0 ? s[gi]
                           : __fmul_rn(s[gi], __uint_as_float(
                                                  (127u - LO * i) << 23));
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) {
      const uint32_t w = lo32[(u * NW + wi) * BN + c];
      const uint32_t wh = w >> 16;
#pragma unroll
      for (int f = 0; f < PW; ++f) {
        const int j = wi * PW + f, p = LO * f, pp = p & 15;
        const uint32_t src = p < 16 ? w : wh;
        const uint32_t bits = and_xor(src, MASK << pp, (XOR << pp) | MAGIC);
        const float q = __uint_as_float(bits) -
                        static_cast<float>(8388608 + (OFF << pp));
        float x = __fmul_rn(q, sp[j / G][pp / LO]);
        if constexpr (F::BIAS) x = __fadd_rn(x, b[j / G]);
        v[j] = x;
      }
    }
  } else if constexpr (T::Q8P) {
    const uint8_t* lo8 = reinterpret_cast<const uint8_t*>(pk);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t byte = lo8[(u * 32 + j) * BN + c];
      const float q = __uint_as_float((byte ^ 0x80u) | MAGIC) - 8388736.f;
      v[j] = __fmul_rn(q, s[j / G]);
    }
  } else {  // a hi plane: q = lo field | hi field << LO
    constexpr int NW = LO, PW = 32 / LO, NH = F::HI, HPW = 32 / F::HI;
    constexpr uint32_t MASK = (1u << LO) - 1u, HMASK = (1u << F::HI) - 1u;
    const uint32_t* hi32 = reinterpret_cast<const uint32_t*>(pk + T::HI_OFF);
    uint32_t lw[NW], hw[NH];
#pragma unroll
    for (int i = 0; i < NW; ++i) lw[i] = lo32[(u * NW + i) * BN + c];
#pragma unroll
    for (int i = 0; i < NH; ++i) hw[i] = hi32[(u * NH + i) * BN + c];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t q = ((lw[j / PW] >> (LO * (j % PW))) & MASK) |
                         (((hw[j / HPW] >> (F::HI * (j % HPW))) & HMASK) << LO);
      const float qf = __uint_as_float(q | MAGIC) -
                       static_cast<float>(8388608 + F::ZERO);
      float x = __fmul_rn(qf, s[j / G]);
      if constexpr (F::BIAS) x = __fadd_rn(x, b[j / G]);
      v[j] = x;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 chunk = make_uint4(
        bf16x2(v[8 * i], v[8 * i + 1]), bf16x2(v[8 * i + 2], v[8 * i + 3]),
        bf16x2(v[8 * i + 4], v[8 * i + 5]), bf16x2(v[8 * i + 6], v[8 * i + 7]));
    *reinterpret_cast<uint4*>(wt + swz(c, 4 * u + i)) = chunk;
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

template <class F, bool COAL, int NT>
__global__ void __launch_bounds__(THREADS, 4)
    qmm_swapped(const float* __restrict__ x, int ldx, const Weight wt,
                float* __restrict__ out, int M, int ldy, int ldo, int n_kt,
                int tps) {
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

  for (int i = 0; i < nk; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < nk) load(i + STAGES - 1);
    cp_commit();
    const char* st = smem + (i % STAGES) * S::STAGE;
    const float* xs = reinterpret_cast<const float*>(st + T::BYTES);
#pragma unroll
    for (int j = 0; j < S::XE; ++j) {
      const int e = tid + j * THREADS;
      if (e < BK / 16 * NT * 32) {
        const int l = e & 31, n = (e >> 5) % NT, ks = e / (32 * NT);
        const float* xr = xs + (n * 8 + (l >> 2)) * XS + ks * 16 + 2 * (l & 3);
        const float2 lo = *reinterpret_cast<const float2*>(xr);
        const float2 hi = *reinterpret_cast<const float2*>(xr + 8);
        xb[e] = make_uint2(bf16x2(lo.x, lo.y), bf16x2(hi.x, hi.y));
      }
    }
    dequant_unit<F, COAL>(st, warp * 16 + (lane & 15), lane >> 4, wts);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4];
      const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(a, wts + swz(row, 2 * ks + (lane >> 4)));
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint2 b = xb[(ks * NT + n) * 32 + lane];
        mma_bf16(acc[n], a, b.x, b.y);
      }
    }
  }
  cp_wait<0>();

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
}

// ---------------------------------------------------------------------------
// the wide path: 128 tokens a block (the A side, bf16 x [M, ldx]), the
// block's 128 weight columns the B side. Warps 2 (m) x 4 (n), a 64 x 32
// tile each; a warp whose rows all lie past M skips its products.

template <class F, bool COAL>
struct Wide {
  static constexpr int X_BYTES = WIDE_BM * BK * 2;
  static constexpr int STAGE = Tile<F, COAL>::BYTES + X_BYTES;
  static constexpr int SMEM = WIDE_STAGES * STAGE + 2 * BN * BK * 2;
};

template <class F, bool COAL>
__global__ void __launch_bounds__(THREADS, 2)
    qmm_wide(const __nv_bfloat16* __restrict__ x, int ldx, const Weight wt,
             float* __restrict__ out, int M, int ldy, int ldo, int n_kt,
             int tps) {
  using S = Wide<F, COAL>;
  using T = Tile<F, COAL>;
  extern __shared__ __align__(128) char smem[];
  char* wts = smem + WIDE_STAGES * S::STAGE;  // two bf16 weight tiles
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * BN, m0 = blockIdx.y * WIDE_BM;
  const int kt0 = blockIdx.z * tps;
  const int nk = min(kt0 + tps, n_kt) - kt0;
  const int wm = warp >> 2, wn = warp & 3;
  const bool active = m0 + wm * 64 < M;

  Feed<F, COAL> feed;
  feed.init(wt, kt0, r0, tid);
  // this thread's x copies: 16 bytes of rows tid / 8 + 32 j
  constexpr int XJ = WIDE_BM * 8 / THREADS;
  const int xc = tid & 7;
  const __nv_bfloat16* xsrc[XJ];
  bool x_row[XJ];
#pragma unroll
  for (int j = 0; j < XJ; ++j) {
    const int m = (tid >> 3) + j * (THREADS / 8);
    x_row[j] = m0 + m < M;
    xsrc[j] = x_row[j] ? x + (int64_t)(m0 + m) * ldx + kt0 * BK + xc * 8 : x;
  }
  int xk = kt0 * BK + xc * 8;
  const uint32_t sbase = smem_u32(smem);
  int slot = 0;  // the ring slot of the next load
  auto load = [&](int i) {
    const uint32_t st = sbase + slot * S::STAGE;
    slot = slot + 1 == WIDE_STAGES ? 0 : slot + 1;
    feed.issue(st);
    feed.advance(wt, kt0 + i + 1, r0, tid);
#pragma unroll
    for (int j = 0; j < XJ; ++j) {
      const bool ok = x_row[j] && xk < ldx;
      cp16(st + T::BYTES + swz((tid >> 3) + j * (THREADS / 8), xc),
           ok ? xsrc[j] : x, ok);
      xsrc[j] += BK;
    }
    xk += BK;
  };

  // tile i's packed stage in slot i % WIDE_STAGES, its bf16 weights in
  // wts tile i % 2: dequantizing tile i + 1 and multiplying tile i share an
  // iteration, one barrier apart
  auto deq = [&](int i) {
    dequant_unit<F, COAL>(smem + (i % WIDE_STAGES) * S::STAGE, tid & (BN - 1),
                          tid >> 7, wts + (i & 1) * BN * BK * 2);
  };
#pragma unroll
  for (int i = 0; i < WIDE_STAGES - 1; ++i) {
    if (i < nk) load(i);
    cp_commit();
  }
  cp_wait<WIDE_STAGES - 2>();
  __syncthreads();
  deq(0);
  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;

  for (int i = 0; i < nk; ++i) {
    // tile i + 1 arrived; tile i's weights are written and tile i - 1's
    // slot and weights are free
    cp_wait<WIDE_STAGES - 3>();
    __syncthreads();
    if (i + WIDE_STAGES - 1 < nk) load(i + WIDE_STAGES - 1);
    cp_commit();
    if (i + 1 < nk) deq(i + 1);
    if (!active) continue;
    const char* xs = smem + (i % WIDE_STAGES) * S::STAGE + T::BYTES;
    const char* wb = wts + (i & 1) * BN * BK * 2;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = wm * 64 + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(a[mi], xs + swz(row, 2 * ks + (lane >> 4)));
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int row = wn * 32 + p * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(b[p], wb + swz(row, 2 * ks + ((lane >> 3) & 1)));
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_bf16(acc[mi][nj], a[mi], b[nj >> 1][(nj & 1) * 2],
                   b[nj >> 1][(nj & 1) * 2 + 1]);
    }
  }
  cp_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int m = m0 + wm * 64 + mi * 16 + g;
      const int r = r0 + wn * 32 + nj * 8 + 2 * t;
      store_out(out, m, r, acc[mi][nj][0], M, ldy, ldo);
      store_out(out, m, r + 1, acc[mi][nj][1], M, ldy, ldo);
      store_out(out, m + 8, r, acc[mi][nj][2], M, ldy, ldo);
      store_out(out, m + 8, r + 1, acc[mi][nj][3], M, ldy, ldo);
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

// One launch on `path` (Path), then the split sum when K is split. x is
// f32 [M, ldx] on the swapped paths, bf16 [M, ldx] on the wide one
// (ldx % 8 == 0; columns from ldx up to Kp read as 0); part is scratch
// [splits, M, R rounded to BN] f32 when splits > 1.
template <class F, bool COAL>
cudaError_t launch(int path, const void* x, int ldx, const Weight& wt,
                   void* y, void* part, int M, int R, int mtiles, int splits,
                   int tps, int n_kt, cudaStream_t s) {
  const int ldo = (R + BN - 1) / BN * BN;
  const dim3 grid(ldo / BN, mtiles, splits);
  float* out = static_cast<float*>(splits > 1 ? part : y);
  cudaError_t e;
  switch (path) {
    case SWAPPED8:
      e = run<qmm_swapped<F, COAL, 1>, float>(Swapped<F, COAL, 1>::SMEM, grid,
                                              s, x, ldx, wt, out, M, R,
                                              ldo,
                                              n_kt, tps);
      break;
    case SWAPPED16:
      e = run<qmm_swapped<F, COAL, 2>, float>(Swapped<F, COAL, 2>::SMEM, grid,
                                              s, x, ldx, wt, out, M, R,
                                              ldo,
                                              n_kt, tps);
      break;
    case WIDE:
      e = run<qmm_wide<F, COAL>, __nv_bfloat16>(Wide<F, COAL>::SMEM, grid, s,
                                                x, ldx, wt, out, M, R,
                                                ldo, n_kt, tps);
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
