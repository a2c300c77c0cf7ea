// T=1 decode attention over the paged KV pool, as online-softmax partials.
//
// Replaces the TPU kernels K4, llm_tpu/ops/paged_attention.py
// (_paged_attention_call, body _make_kernel; entry paged_attention_pass),
// and K2, llm_tpu/ops/dense_attention.py (_dense_attention_call; entry
// dense_attention_pass): one layer of the dense cache [B, Hkv, S, D] is a
// pool of B pages of S positions whose page tables are [b] (tables NULL).
// For each stream b and kv head h, over the logical positions [0, W) of
// layer l (the wrapper passes the layer's base pointer of the pool
// [L, NP, Hkv, page, Dp]), position p = j * page + o is read from physical
// page tables[b, min(j, P - 1)] (clamped to the pool):
//
//   s[r, p] = q[b, h, r] . k[page, h, o] * kq_scale (* k_scale[page, h, o])
//             (+ slope[h, r] * p)                masked for p >= n_past[b]
//   m = max_p s,  p[r, p] = exp(s - m),  l = sum_p p
//   acc[r] = sum_p p[r, p] (* v_scale[page, h, o]) * v[page, h, o]
//
// with the reference's masking constants: a masked key contributes exactly
// nothing, so n_past = 0 gives m = -1e30, l = 0, acc = 0, which the
// caller's merge with the new token's own key relies on. Pools: bf16, f32,
// int8 codes, or int4 codes packed planar into D/2 bytes a row (low nibble
// element j, high nibble element j + D/2, both sign-extended).
//
// What bounds it on the H100: the bytes of the K and V rows below n_past
// (plus their f32 scales for int8 and int4) over 3.35 TB/s, at every pool
// and LLaMA-7B shape: 4*D f32 operations a key and query head against 4*D
// bytes (bf16), 2*D (int8) or D (int4) of K and V. Only int4 at rep >= 4
// and GQA come near the FP32 line (67 TFLOP/s). In practice the int8 and
// int4 pools are bound by the lanes' decode and FMA issue, not the bytes:
// a key costs about as much there as a bf16 key (PERF.md).
//
// Design. One launch a call; one block of 128 threads per (b, kv head,
// split of the window); as few splits as give each SM 4 blocks, so that
// B=1 x 32 heads still fills 132 SMs.
// - K and V in flight together: a block looks up each page of its split
//   once (a tile divides the page size or is a multiple of it, or the
//   window lies in one page), then walks its tiles (about 16 KB of K and V
//   rows) with cp.async 16-byte copies of the K rows, V rows and scales of
//   a tile in one group, two tiles in flight: tile t + 1 lands while tile t
//   is scored. Only rows below n_past are copied.
// - Whole rows in 16-byte loads: a row is read from shared memory by a group
//   of G lanes (power of two), each taking VW bytes (16, or 8 / 4 where the
//   row's byte count asks for it; NV = 2 vectors a lane for f32 rows of
//   more than 512 bytes). At D = 128: G = 16 bf16, 8 int8, 4 int4, 32 f32.
// - q held in registers for HA query heads of the kv head: one K vector
//   serves all of them, and a score takes log2(G) shuffles a head and key
//   (below 32 elements a lane, two keys a row group at a time: two chains
//   in flight, and the first shuffle serves both, so log2(G) a key pair).
//   Where q and acc of every head fit (HA * elements a lane <= 32: rep <= 4
//   at bf16 D = 128) the block loops over tiles with an online softmax; else
//   (GQA rep 8, Falcon's 71 heads) a block takes one tile and loops over
//   head groups (HA * elements <= 64), reading K again from shared memory,
//   never from device memory.
// - P.V in the same lane groups: each lane accumulates HA x its d-slice in
//   f32 registers over its keys, rescaled when a tile raises the running
//   max; the row groups of a warp reduce by shuffles and the four warps
//   through shared memory, once a block (a head group without the loop).
// - Decode in registers, exact: bf16 halves shifted into f32 words; int8
//   and int4 codes biased to unsigned and placed by PRMT into the mantissa
//   of 2^23 (0x4B000000), then 2^23 + bias subtracted (one PRMT and one FADD
//   an element, no integer conversion).
// - f32 arithmetic throughout on the FP32 pipes: the k scale multiplies the
//   score and the v scale the probability, as the reference folds them,
//   and a score rounds as the reference's (no contraction of the ALiBi
//   term: at positions near 1000 one ulp moves acc by 1e-5).
// - The split merge in the same launch: a block with more than one active
//   split in its (b, h) writes its partials to scratch, fences and takes a
//   ticket; the block that draws the last ticket merges the splits in the
//   order 0 .. nsa-1 (reading past L1) and sets the counter back to 0. A
//   single active split writes m, l, acc directly; splits wholly at or past
//   n_past return at once. Deterministic: greedy tokens repeat.
//
// GQA on the tensor cores (gqa_mma, the plan's `mma` branch). Where q and
// acc of every query head do not fit a lane's registers (bf16 rep >= 5,
// int8 rep >= 3, int4 rep >= 2: Falcon-7B's 71 heads a kv head, GQA rep 8
// and 16), the heads-in-registers kernel above takes one tile a block and
// walks the heads in groups of 8, and the FMA issue of the CUDA cores bounds
// it: 4*D f32 operations a key and query head, rep heads a key. The TPU
// kernel makes the rep heads the rows of one MXU product over each K and V
// block; here they are the rows of mma.sync m16n8k16 bf16 -> f32 products:
// S = Q.K^T with the heads padded to m-tiles of 16, then acc += P.V with P
// taken from S's accumulators in registers (FlashAttention-2's fragment
// reuse) and V through ldmatrix.trans. mma.sync and not wgmma: the rows are
// 8 to 80, and wgmma's 64-row tile would pad rep 8 eightfold. What bounds
// it then is the K and V bytes again, and at B*Hkv = 1 (Falcon) the latency
// of a few tiles and of the split merge; at 64 streams and long windows,
// the latency of each block's tile loop, two blocks (8 warps) an SM as its
// shared memory allows. The branch takes such calls from rep 5
// (ops/paged_attention.MMA_MIN_REP): below, an int8 or int4 pool's heads
// make one or two groups of the kernel above, which measured faster on the
// H100 at 2-64 streams (PERF.md).
// - Exact in f32 as the plain path is: K and V are exact in bf16 for the
//   pools this branch takes (bf16 values; int8 and int4 codes), and q (and P,
//   after the v scale) is split into three bf16 terms hi + mid + lo that sum
//   to it exactly; each term's products are exact in f32, so the result
//   differs from the f32 path only by the order of the sums. The k scale
//   multiplies the score and the v scale the probability, and the ALiBi term
//   is added unfused, as in the kernel above.
// - A block of 4 warps per (b, kv head, head group, split), the split's
//   tiles in a loop with the next tile's copies in flight. The warps form
//   warps_m x (4 / warps_m): along the heads, each warp holds an m-tile of
//   16 heads of acc (D / 2 f32 a lane); along the keys, the chunks of 16
//   keys of a tile go round robin over the warps, each with its own online
//   softmax, merged in warp order through shared memory after the last
//   tile. Where the m-tiles need more than 4 warps (rep 71) the head groups
//   go to blocks of their own, each with its ticket.
// - int8 and int4 codes are turned into bf16 rows in shared memory once a
//   tile (the exact decode above); bf16 rows are read where they land. Rows
//   are padded by 16 bytes (ldmatrix without bank conflicts at D % 16 == 0;
//   zeros where D % 16 == 8), the tile's rows up to the next 16 are zeros.
// - The split merge is the ticket merge above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// q and acc floats a lane holds: heads x elements, both at once with the
// tile loop, one at a time without it
constexpr int kRegFloats = 64;
constexpr float kNegInf = -1e30f;

// what a lane's VW-byte vector of a row holds
template <typename KV, int VW>
struct Row {
  static constexpr bool kInt4 = false;
  static constexpr int kElems = VW / (int)sizeof(KV);  // elements a vector
  static constexpr int kPerWord = 4 / (int)sizeof(KV);
};
template <int VW>
struct Row<uint8_t, VW> {  // planar int4: a byte holds elements j, j + D/2
  static constexpr bool kInt4 = true;
  static constexpr int kElems = 2 * VW;
  static constexpr int kPerWord = 8;
};

// element e of a vector whose first byte is byte b0 of the row -> d
template <typename KV, int VW>
__device__ __forceinline__ int elem_d(int b0, int e, int half) {
  if constexpr (Row<KV, VW>::kInt4)
    return e < VW ? b0 + e : half + b0 + (e - VW);
  else
    return b0 / (int)sizeof(KV) + e;
}
// element k of word w -> its index e in the vector
template <typename KV, int VW>
__device__ __forceinline__ constexpr int word_e(int w, int k) {
  if constexpr (Row<KV, VW>::kInt4)
    return k < 4 ? 4 * w + k : VW + 4 * w + (k - 4);
  else
    return w * Row<KV, VW>::kPerWord + k;
}

// an unsigned byte u (0..255) of x placed in 2^23's mantissa: 2^23 + u
__device__ __forceinline__ float magic_byte(uint32_t x, int i) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u + i));
}

// decode one 32-bit word of a row into its kPerWord f32 values (exact)
__device__ __forceinline__ void decode_word(__nv_bfloat16*, uint32_t w,
                                            float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void decode_word(float*, uint32_t w, float* f) {
  f[0] = __uint_as_float(w);
}
__device__ __forceinline__ void decode_word(int8_t*, uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;  // signed code c -> c + 128
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = magic_byte(u, i) - 8388736.f;
}
__device__ __forceinline__ void decode_word(uint8_t*, uint32_t w, float* f) {
  // nibble n -> (n ^ 8) = its sign-extended value + 8
  const uint32_t lo = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t hi = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = magic_byte(lo, i) - 8388616.f;
    f[4 + i] = magic_byte(hi, i) - 8388616.f;
  }
}

template <int VW>
__device__ __forceinline__ void load_words(const unsigned char* p,
                                           uint32_t* w) {
  if constexpr (VW == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else if constexpr (VW == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x; w[1] = x.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(N));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// query heads a lane may hold in registers: a power of two, at most 8
__host__ __device__ constexpr int heads_cap(int elems) {
  return elems >= kRegFloats ? 1 : (kRegFloats / elems > 8 ? 8
                                                           : kRegFloats / elems);
}
// Byte offsets of the block's shared-memory regions, and their total, as
// the wrapper lays them out (ops/paged_attention.smem_layout, the one owner
// of the layout): per stage (1, or 2 with a tile loop) the K rows of a tile
// at kst a stage (stage 0's region also holds the cross-warp sum of acc
// once the scores are done), the V rows at v (vst a stage), the k and v
// scales at ks and vs (sst a stage); then q, the scores of a tile, the
// running m, l and rescale factor of each head, the split's page rows, the
// merge's m and l of each split, a flag.
struct Smem {
  int kst, vst, sst, v, ks, vs, q, p, stats, pages, merge, flag, total;
};
// gqa_mma's regions (ops/paged_attention.mma_smem_layout): per stage the K
// rows, V rows and the k and v scales as above (bf16 rows padded to D + 8
// elements), then the three bf16 terms of q [heads of the block, D + 8] at
// q, the bf16 K and V tiles decoded from int8 or int4 codes at cvt, the
// split's page rows, the merge's m and l of every split, a flag. After the
// last tile the warps' partials for the block's merge overlay everything
// before the page rows, from offset 0.
struct MmaSmem {
  int kst, vst, sst, v, ks, vs, q, cvt, pages, merge, flag, total;
};

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* tables;
  const int* n_past;
  const float* slopes;
  float* part;
  int* tickets;
  float* m;
  float* l;
  float* acc;
  int NP, Hkv, rep, D, page, P, W, tile, tps, G;
  float kq_scale;
  Smem L;
  MmaSmem M;
  int vec, warps_m;  // gqa_mma: bytes a copy, warps along the heads
};

// floats of a split's partials in scratch: acc [rep, D], m [rep], l [rep],
// padded to 16 bytes
__host__ __device__ __forceinline__ int64_t part_stride(int rep, int D) {
  return ((int64_t)rep * (D + 2) + 3) / 4 * 4;
}

// The ticket: the last active split of (b, h) merges the nsa splits' m, l
// and acc of heads r0 .. r0 + nr - 1 (scratch pb, `stride` floats a split)
// in the order 0 .. nsa-1, with mf (2 * nsa * nr floats) and flag in shared
// memory; `ticket` is the blocks' counter.
__device__ __forceinline__ void merge_splits(const Args& a, int bh, int ticket,
                                             int r0, int nr, int nsa,
                                             const float* pb, int64_t stride,
                                             float* mf, int* flag) {
  const int rep = a.rep, D = a.D, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t rD = (int64_t)rep * D;
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(a.tickets + ticket, 1) == nsa - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // m_c and l_c of every split into shared memory, read past L1
  float* lc = mf + nsa * nr;  // [nsa, nr] beside mf [nsa, nr]
  for (int x = tid; x < nsa * nr; x += kThreads) {
    const int c = x / nr, r = r0 + x - c * nr;
    mf[x] = __ldcg(pb + c * stride + rD + r);
    lc[x] = __ldcg(pb + c * stride + rD + rep + r);
  }
  __syncthreads();
  // m = max_c m_c (a warp a head); m_c -> f_c = e^(m_c - m)
  for (int r = warp; r < nr; r += kWarps) {
    float mx = kNegInf;
    for (int c = lane; c < nsa; c += 32) mx = fmaxf(mx, mf[c * nr + r]);
    mx = warp_max(mx);
    for (int c = lane; c < nsa; c += 32)
      mf[c * nr + r] = expf(mf[c * nr + r] - mx);
    if (lane == 0) a.m[(int64_t)bh * rep + r0 + r] = mx;
  }
  __syncthreads();
  // l = sum_c l_c f_c, acc = sum_c acc_c f_c, in the order c = 0 .. nsa-1,
  // four elements of a head a thread (D % 4 == 0, the rows on 16 bytes)
  for (int x = 4 * tid; x < nr * D; x += 4 * kThreads) {
    const int r = x / D, d = x - r * D;
    const int64_t xg = (int64_t)r0 * D + x;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    float ls = 0.f;
#pragma unroll 8
    for (int c = 0; c < nsa; ++c) {
      const float f = mf[c * nr + r];
      const float4 v =
          __ldcg(reinterpret_cast<const float4*>(pb + c * stride + xg));
      sum.x += v.x * f;
      sum.y += v.y * f;
      sum.z += v.z * f;
      sum.w += v.w * f;
      if (d == 0) ls += lc[c * nr + r] * f;
    }
    *reinterpret_cast<float4*>(a.acc + bh * rD + xg) = sum;
    if (d == 0) a.l[(int64_t)bh * rep + r0 + r] = ls;
  }
  if (tid == 0) a.tickets[ticket] = 0;
}

// G lanes a row (power of two), VW bytes a lane and vector, NV vectors a
// lane, HA query heads in registers at a time (q for the scores, acc for
// P.V). PIPE: a block loops over its tiles with the next tile's copies in
// flight and holds q and acc of all rep <= HA heads in registers across
// them (HA * elements <= 32 each); else one tile a block, its heads in
// groups of HA (HA * elements <= 64). With one head, 6 blocks an SM: the
// int4 kernel would take 116 registers and 4 blocks, and run 13% slower.
template <typename KV, int VW, int NV, int HA, bool PIPE>
__global__ void __launch_bounds__(kThreads, HA == 1 ? 6 : 4)
    paged_decode(const Args a) {
  using R = Row<KV, VW>;
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int E = NV * R::kElems;  // elements a lane
  constexpr int WORDS = VW / 4;
  extern __shared__ __align__(16) unsigned char smem[];

  const int rep = a.rep, D = a.D, page = a.page, tile = a.tile, G = a.G;
  const int bh = blockIdx.x, s = blockIdx.y, nsplit = gridDim.y;
  const int b = bh / a.Hkv, h = bh - b * a.Hkv;
  const int tid = threadIdx.x;
  const int span = tile * a.tps, P0 = s * span, j0 = P0 / page;
  const int npg = (P0 + span - 1) / page - j0 + 1;
  const int rb = (R::kInt4 ? D / 2 : D * (int)sizeof(KV));  // row bytes
  const int stages = a.tps > 1 ? 2 : 1;
  const Smem& L = a.L;
  int64_t* pages = reinterpret_cast<int64_t*>(smem + L.pages);
  // one table lookup a page of the split, issued beside n_past's load
  for (int t = tid; t < npg; t += kThreads) {
    const int col = min(j0 + t, a.P - 1);
    int phys = a.tables ? a.tables[(int64_t)b * a.P + col] : b;
    phys = min(max(phys, 0), a.NP - 1);
    pages[t] = ((int64_t)phys * a.Hkv + h) * page;
  }
  const int valid = min(a.n_past[b], a.W);
  const int nsa = valid > 0 ? (valid + span - 1) / span : 0;  // active
  const int64_t rD = (int64_t)rep * D;
  if (s >= nsa) {  // every key of the split is masked
    if (s == 0) {  // no past at all: the exact constants
      for (int i = tid; i < rD; i += kThreads) a.acc[bh * rD + i] = 0.f;
      for (int r = tid; r < rep; r += kThreads) {
        a.m[(int64_t)bh * rep + r] = kNegInf;
        a.l[(int64_t)bh * rep + r] = 0.f;
      }
    }
    return;
  }
  const int nk = min(span, valid - P0);  // keys of the split
  const int nt = (nk + tile - 1) / tile;  // its tiles
  const int vpr = rb / VW;  // vectors a row
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* ps = reinterpret_cast<float*>(smem + L.p);
  float* m_run = reinterpret_cast<float*>(smem + L.stats);
  float* l_run = m_run + rep;
  float* corr = l_run + rep;
  for (int r = tid; r < rep; r += kThreads) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
  }
  __syncthreads();
  auto row_of = [&](int p) -> int64_t {
    const int j = p / page;
    return pages[j - j0] + (p - j * page);
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int gl = lane & (G - 1);  // lane in its row group
  const int rg = tid / G, RG = kThreads / G;  // row group, row groups
  const int half = D / 2;
  bool has[NV];
  int b0[NV];
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    has[t] = gl + t * G < vpr;
    b0[t] = (gl + t * G) * VW;
  }

  // the K rows, V rows and scales of tile t into stage t % stages: a row
  // group a row, each lane its vectors
  const unsigned char* kb = static_cast<const unsigned char*>(a.k);
  const unsigned char* vb = static_cast<const unsigned char*>(a.v);
  auto issue = [&](int t) {
    const int st = t & (stages - 1), p0 = P0 + t * tile;
    const int n = min(tile, nk - t * tile);
    unsigned char* kd = smem + st * L.kst;
    unsigned char* vd = smem + L.v + st * L.vst;
    float* kss = reinterpret_cast<float*>(smem + L.ks + st * L.sst);
    float* vss = reinterpret_cast<float*>(smem + L.vs + st * L.sst);
    for (int i = rg; i < n; i += RG) {
      const int64_t row = row_of(p0 + i);
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        if (!has[u]) continue;
        cp_async<VW>(kd + i * rb + b0[u], kb + row * rb + b0[u]);
        cp_async<VW>(vd + i * rb + b0[u], vb + row * rb + b0[u]);
      }
      if constexpr (QUANT) {
        if (gl == 0) {
          cp_async<4>(kss + i, a.ks + row);
          cp_async<4>(vss + i, a.vs + row);
        }
      }
    }
  };
  for (int x = tid; x < rD / 4; x += kThreads)
    cp_async<16>(qs + 4 * x, a.q + bh * rD + 4 * x);
  issue(0);
  cp_commit();
  if (nt > 1) issue(1);
  cp_commit();

  // a single split writes the results, else scratch [B*Hkv, nsplit,
  // part_stride]: acc, then m and l
  const bool direct = nsa == 1;
  const int64_t stride = part_stride(rep, D);
  float* pb = a.part + (int64_t)bh * nsplit * stride;
  float* dacc = direct ? a.acc + bh * rD : pb + s * stride;
  float* dm = direct ? a.m + (int64_t)bh * rep : pb + s * stride + rD;
  float* dl = direct ? a.l + (int64_t)bh * rep : dm + rep;
  float* red = reinterpret_cast<float*>(smem);  // [kWarps, min(rep, HA), D]
  const int ha = min(rep, HA);

  // the lane's acc of its row group over a group of heads: summed over the
  // row groups of its warp by shuffles, then over the warps in order
  float acc[HA][E];
  auto reduce_acc = [&](int r0) {
#pragma unroll
    for (int hh = 0; hh < HA; ++hh)
#pragma unroll
      for (int e = 0; e < E; ++e)
        for (int o = G; o < 32; o <<= 1)
          acc[hh][e] += __shfl_xor_sync(0xffffffffu, acc[hh][e], o);
    const int nh = min(HA, rep - r0);  // heads of this group
    if (lane < G) {
#pragma unroll
      for (int hh = 0; hh < HA; ++hh) {
        if (hh >= nh) break;
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          if (!has[t]) continue;
#pragma unroll
          for (int e = 0; e < R::kElems; ++e)
            red[(warp * ha + hh) * D + elem_d<KV, VW>(b0[t], e, half)] =
                acc[hh][t * R::kElems + e];
        }
      }
    }
    __syncthreads();
    for (int x = tid; x < nh * D; x += kThreads) {
      float sum = red[x];
#pragma unroll
      for (int w2 = 1; w2 < kWarps; ++w2) sum += red[w2 * ha * D + x];
      dacc[r0 * D + x] = sum;
    }
    __syncthreads();
  };
  if constexpr (PIPE) {
#pragma unroll
    for (int hh = 0; hh < HA; ++hh)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[hh][e] = 0.f;
  }

  for (int t = 0; t < nt; ++t) {
    const int st = t & (stages - 1), p0 = P0 + t * tile;
    const int n = min(tile, nk - t * tile);
    const unsigned char* ksm = smem + st * L.kst;
    const unsigned char* vsm = smem + L.v + st * L.vst;
    const float* kss = reinterpret_cast<const float*>(smem + L.ks + st * L.sst);
    const float* vss = reinterpret_cast<const float*>(smem + L.vs + st * L.sst);
    cp_wait<1>();
    __syncthreads();

    // scores: a row group takes keys rg, rg + RG, ...; every lane of a warp
    // runs the same trips so that the shuffles see the whole warp
    for (int r0 = 0; r0 < rep; r0 += HA) {
      float qr[HA][E];
#pragma unroll
      for (int hh = 0; hh < HA; ++hh)
#pragma unroll
        for (int u = 0; u < NV; ++u)
#pragma unroll
          for (int e = 0; e < R::kElems; ++e)
            qr[hh][u * R::kElems + e] =
                (has[u] && r0 + hh < rep)
                    ? qs[(r0 + hh) * D + elem_d<KV, VW>(b0[u], e, half)]
                    : 0.f;
      // q . k of key i for the HA heads, two accumulators a head
      auto dot_key = [&](int i, float (&dot)[HA]) {
        float odd[HA];
#pragma unroll
        for (int hh = 0; hh < HA; ++hh) dot[hh] = odd[hh] = 0.f;
        if (i >= n) return;
#pragma unroll
        for (int u = 0; u < NV; ++u) {
          if (!has[u]) continue;
          uint32_t w[WORDS];
          load_words<VW>(ksm + i * rb + b0[u], w);
#pragma unroll
          for (int wi = 0; wi < WORDS; ++wi) {
            float f[R::kPerWord];
            decode_word(static_cast<KV*>(nullptr), w[wi], f);
#pragma unroll
            for (int kk = 0; kk < R::kPerWord; ++kk)
#pragma unroll
              for (int hh = 0; hh < HA; ++hh) {
                float& acc_ = (wi & 1) ? odd[hh] : dot[hh];
                acc_ = fmaf(qr[hh][u * R::kElems + word_e<KV, VW>(wi, kk)],
                            f[kk], acc_);
              }
          }
        }
#pragma unroll
        for (int hh = 0; hh < HA; ++hh) dot[hh] += odd[hh];
      };
      // the score of key i, rounded as the reference rounds it: the dot
      // times kq_scale (times the k scale), plus the slope times the
      // position
      auto store = [&](int i, const float (&dot)[HA]) {
        if (i >= n) return;
#pragma unroll
        for (int hh = 0; hh < HA; ++hh) {
          const int r = r0 + hh;
          if (r >= rep) break;
          float sc = __fmul_rn(dot[hh], a.kq_scale);
          if constexpr (QUANT) sc = __fmul_rn(sc, kss[i]);
          if (a.slopes)
            sc = __fadd_rn(sc, __fmul_rn(a.slopes[h * rep + r],
                                         static_cast<float>(p0 + i)));
          ps[r * tile + i] = sc;
        }
      };
      if constexpr (E >= 32) {  // a key a row group at a time
        for (int i0 = 0; i0 < n; i0 += RG) {
          float d[HA];
          dot_key(i0 + rg, d);
#pragma unroll
          for (int hh = 0; hh < HA; ++hh)
            for (int o = G >> 1; o > 0; o >>= 1)
              d[hh] += __shfl_xor_sync(0xffffffffu, d[hh], o);
          if (gl == 0) store(i0 + rg, d);
        }
      } else {  // two keys: independent chains, and their sums share a step
        for (int i0 = 0; i0 < n; i0 += 2 * RG) {
          float d0[HA], d1[HA];
          dot_key(i0 + rg, d0);
          dot_key(i0 + RG + rg, d1);
          // the upper half of the group keeps key 1, the lower key 0; each
          // sends the other key's partial sum across, then one sum remains
          const bool upper = G > 1 && (gl & (G >> 1));
#pragma unroll
          for (int hh = 0; hh < HA; ++hh) {
            if (G > 1) {
              const float send = upper ? d0[hh] : d1[hh];
              d0[hh] = (upper ? d1[hh] : d0[hh]) +
                       __shfl_xor_sync(0xffffffffu, send, G >> 1);
            }
            for (int o = G >> 2; o > 0; o >>= 1)
              d0[hh] += __shfl_xor_sync(0xffffffffu, d0[hh], o);
          }
          if (G == 1) {
            store(i0 + rg, d0);
            store(i0 + RG + rg, d1);
          } else if ((gl & ((G >> 1) - 1)) == 0) {
            store(i0 + (upper ? RG : 0) + rg, d0);
          }
        }
      }
    }
    __syncthreads();

    // the online softmax over the tile, a warp a head: m, the rescale of
    // what came before, the exponentials and l
    for (int r = warp; r < rep; r += kWarps) {
      float mx = kNegInf;
      for (int i = lane; i < n; i += 32) mx = fmaxf(mx, ps[r * tile + i]);
      mx = fmaxf(m_run[r], warp_max(mx));
      float sum = 0.f;
      for (int i = lane; i < n; i += 32) {
        const float e = expf(ps[r * tile + i] - mx);
        ps[r * tile + i] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_run[r] - mx);
        corr[r] = c;
        l_run[r] = l_run[r] * c + sum;
        m_run[r] = mx;
      }
    }
    __syncthreads();

    // acc = acc * corr + P.V over the tile, HA heads at a time
    for (int r0 = 0; r0 < rep; r0 += HA) {
#pragma unroll
      for (int hh = 0; hh < HA; ++hh) {
        const float c = PIPE && r0 + hh < rep ? corr[r0 + hh] : 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[hh][e] = PIPE ? acc[hh][e] * c : 0.f;
      }
#pragma unroll 2
      for (int i = rg; i < n; i += RG) {
        float pr[HA];
#pragma unroll
        for (int hh = 0; hh < HA; ++hh) {
          pr[hh] = r0 + hh < rep ? ps[(r0 + hh) * tile + i] : 0.f;
          if constexpr (QUANT) pr[hh] = pr[hh] * vss[i];
        }
#pragma unroll
        for (int u = 0; u < NV; ++u) {
          if (!has[u]) continue;
          uint32_t w[WORDS];
          load_words<VW>(vsm + i * rb + b0[u], w);
#pragma unroll
          for (int wi = 0; wi < WORDS; ++wi) {
            float f[R::kPerWord];
            decode_word(static_cast<KV*>(nullptr), w[wi], f);
#pragma unroll
            for (int kk = 0; kk < R::kPerWord; ++kk)
#pragma unroll
              for (int hh = 0; hh < HA; ++hh) {
                float& ac = acc[hh][u * R::kElems + word_e<KV, VW>(wi, kk)];
                ac = fmaf(pr[hh], f[kk], ac);
              }
          }
        }
      }
      if constexpr (!PIPE) reduce_acc(r0);  // one tile: K is done with
    }
    __syncthreads();  // every lane is done with this stage
    if (t + 2 < nt) issue(t + 2);
    cp_commit();
  }
  if constexpr (PIPE) {
    cp_wait<0>();
    reduce_acc(0);
  }
  for (int r = tid; r < rep; r += kThreads) {
    dm[r] = m_run[r];
    dl[r] = l_run[r];
  }
  if (direct) return;
  merge_splits(a, bh, bh, 0, rep, nsa, pb, stride,
               reinterpret_cast<float*>(smem + L.merge),
               reinterpret_cast<int*>(smem + L.flag));
}

// ---------------------------------------------------------------------------
// gqa_mma: the rep query heads of a kv head as the rows of tensor-core
// products (see the note at the top)

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
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
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// (x, y) as three bf16 pairs whose sum is (x, y) exactly: each remainder is
// exact in f32 and has at most 16, then 8, significant bits (down to 2^-100;
// below, off by less than bf16's smallest subnormal)
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = __fsub_rn(x, hf.x), ry = __fsub_rn(y, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = bf16x2(__fsub_rn(rx, mf.x), __fsub_rn(ry, mf.y));
}
__device__ __forceinline__ void cp_vec(void* dst, const void* src, int vec) {
  if (vec == 16) cp_async<16>(dst, src);
  else if (vec == 8) cp_async<8>(dst, src);
  else cp_async<4>(dst, src);
}

// KV: the pool's element (bf16, int8 codes, planar int4 bytes); DMAX: the
// largest D of the instantiation (D <= DMAX, D % 8 == 0); a warp holds acc
// of one m-tile of 16 heads (DMAX / 2 f32 a lane). Block (bh * groups +
// head group, split).
template <typename KV, int DMAX>
__global__ void __launch_bounds__(kThreads, 2) gqa_mma(const Args a) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr bool INT4 = Row<KV, 16>::kInt4;
  constexpr int NDT = DMAX / 8;  // n8 tiles of acc at most
  extern __shared__ __align__(16) unsigned char smem[];
  const MmaSmem& L = a.M;
  const int rep = a.rep, D = a.D, page = a.page, tile = a.tile;
  const int WM = a.warps_m, WK = kWarps / WM;
  const int MT = (rep + 15) / 16;                 // m-tiles of heads
  const int rows_g = WM * 16;                     // heads of a group
  const int NG = (MT * 16 + rows_g - 1) / rows_g;  // groups of the kv head
  const int bh = blockIdx.x / NG, grp = blockIdx.x - bh * NG;
  const int r0 = grp * rows_g, nr = min(rows_g, rep - r0);  // its heads
  const int s = blockIdx.y, nsplit = gridDim.y;
  const int b = bh / a.Hkv, h = bh - b * a.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = tile * a.tps, P0 = s * span, j0 = P0 / page;
  const int npg = (P0 + span - 1) / page - j0 + 1;
  const int rb = INT4 ? D / 2 : D * (int)sizeof(KV);  // pool row bytes
  const int ES = D + 8;                  // elements a bf16 row in smem
  const int rs = QUANT ? rb : 2 * ES;    // bytes a stage row
  const int D16 = (D + 15) / 16;         // k16 steps of q.k
  const int stages = a.tps > 1 ? 2 : 1;
  const int tile16 = (tile + 15) & ~15;
  int64_t* pages = reinterpret_cast<int64_t*>(smem + L.pages);
  for (int t = tid; t < npg; t += kThreads) {
    const int col = min(j0 + t, a.P - 1);
    int phys = a.tables ? a.tables[(int64_t)b * a.P + col] : b;
    phys = min(max(phys, 0), a.NP - 1);
    pages[t] = ((int64_t)phys * a.Hkv + h) * page;
  }
  const int valid = min(a.n_past[b], a.W);
  const int nsa = valid > 0 ? (valid + span - 1) / span : 0;  // active
  const int64_t rD = (int64_t)rep * D;
  if (s >= nsa) {  // every key of the split is masked
    if (s == 0) {  // no past at all: the exact constants
      for (int i = tid; i < nr * D; i += kThreads)
        a.acc[bh * rD + (int64_t)r0 * D + i] = 0.f;
      for (int r = tid; r < nr; r += kThreads) {
        a.m[(int64_t)bh * rep + r0 + r] = kNegInf;
        a.l[(int64_t)bh * rep + r0 + r] = 0.f;
      }
    }
    return;
  }
  const int nk = min(span, valid - P0);  // keys of the split
  const int nt = (nk + tile - 1) / tile;  // its tiles
  auto row_of = [&](int p) -> int64_t {
    const int j = p / page;
    return pages[j - j0] + (p - j * page);
  };

  // the K rows, V rows (and scales) of tile t into stage t % stages; bf16
  // rows from n up to the next 16 are zeroed
  const unsigned char* kb = static_cast<const unsigned char*>(a.k);
  const unsigned char* vb = static_cast<const unsigned char*>(a.v);
  const int vec = a.vec, vpr = rb / vec;
  auto issue = [&](int t) {
    const int st = t & (stages - 1), p0 = P0 + t * tile;
    const int n = min(tile, nk - t * tile);
    unsigned char* kd = smem + st * L.kst;
    unsigned char* vd = smem + L.v + st * L.vst;
    for (int x = tid; x < n * vpr; x += kThreads) {
      const int i = x / vpr, c = (x - i * vpr) * vec;
      const int64_t row = row_of(p0 + i);
      cp_vec(kd + i * rs + c, kb + row * rb + c, vec);
      cp_vec(vd + i * rs + c, vb + row * rb + c, vec);
    }
    if constexpr (QUANT) {
      float* kss = reinterpret_cast<float*>(smem + L.ks + st * L.sst);
      float* vss = reinterpret_cast<float*>(smem + L.vs + st * L.sst);
      for (int i = tid; i < n; i += kThreads) {
        const int64_t row = row_of(p0 + i);
        cp_async<4>(kss + i, a.ks + row);
        cp_async<4>(vss + i, a.vs + row);
      }
    } else {
      const int n16 = (n + 15) & ~15, w16 = rs / 16;
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      for (int x = tid; x < (n16 - n) * w16; x += kThreads) {
        const int i = n + x / w16, c = (x - (x / w16) * w16) * 16;
        *reinterpret_cast<uint4*>(kd + i * rs + c) = z;
        *reinterpret_cast<uint4*>(vd + i * rs + c) = z;
      }
    }
  };
  __syncthreads();  // the page rows
  issue(0);
  cp_commit();
  if (nt > 1) issue(1);
  cp_commit();
  const int QR = min(rows_g, MT * 16);    // rows of q in smem
  const int QT = QR * ES * 2;             // bytes a term of q
  // q of the group's heads -> three bf16 terms, heads past rep and columns
  // past D zero; four elements a thread, eight loads in flight
#pragma unroll 8
  for (int x = tid; x < QR * D16 * 4; x += kThreads) {
    const int r = x / (D16 * 4), d = (x - r * (D16 * 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nr && d < D)
      v = *reinterpret_cast<const float4*>(a.q + bh * rD +
                                           (int64_t)(r0 + r) * D + d);
    uint2 t3[3];
    split3(v.x, v.y, t3[0].x, t3[1].x, t3[2].x);
    split3(v.z, v.w, t3[0].y, t3[1].y, t3[2].y);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      *reinterpret_cast<uint2*>(smem + L.q + k * QT + (r * ES + d) * 2) =
          t3[k];
  }
  if constexpr (!QUANT) {  // the pad of every stage row reads as zeros
    for (int x = tid; x < stages * tile16; x += kThreads) {
      const int st = x / tile16, i = x - st * tile16;
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(smem + st * L.kst + i * rs + 2 * D) = z;
      *reinterpret_cast<uint4*>(smem + L.v + st * L.vst + i * rs + 2 * D) = z;
    }
  }
  __syncthreads();

  const int wm = warp / WK, wk = warp - wm * WK;
  const int mt = wm;  // this warp's m-tile in the group
  const int mtn = (nr + 15) / 16;  // the group's m-tiles
  const int g = lane >> 2, t4 = lane & 3;
  // this lane's ldmatrix rows: K (non-transposed) at key kr, column kc; V
  // (transposed) at key vr, column vc; q at head vr, column vc
  const int kr = ((lane >> 4) & 1) * 8 + (lane & 7), kc = ((lane >> 3) & 1) * 8;
  const int vr = ((lane >> 3) & 1) * 8 + (lane & 7), vc = (lane >> 4) * 8;
  const uint32_t qbase = static_cast<uint32_t>(__cvta_generic_to_shared(
      smem + L.q + ((mt * 16 + vr) * ES + vc) * 2));
  float acc[NDT][4], m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int dn = 0; dn < NDT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int st = t & (stages - 1), p0 = P0 + t * tile;
    const int n = min(tile, nk - t * tile), nch = (n + 15) / 16;
    const unsigned char* kraw = smem + st * L.kst;
    const unsigned char* vraw = smem + L.v + st * L.vst;
    const float* kss = reinterpret_cast<const float*>(smem + L.ks + st * L.sst);
    const float* vss = reinterpret_cast<const float*>(smem + L.vs + st * L.sst);
    cp_wait<1>();
    __syncthreads();
    const unsigned char* kmat = kraw;
    const unsigned char* vmat = vraw;
    if constexpr (QUANT) {  // the codes -> bf16 rows, exact
      unsigned char* cvt = smem + L.cvt;
      const int gpr = D16 * 4, n16 = nch * 16;  // 4-element groups a row
      for (int x = tid; x < 2 * n16 * gpr; x += kThreads) {
        const int isv = x >= n16 * gpr, y = x - isv * n16 * gpr;
        const int i = y / gpr, e = (y - i * gpr) * 4;
        const unsigned char* raw = (isv ? vraw : kraw) + i * rb;
        uint2 out = make_uint2(0u, 0u);
        if (i < n && e < D) {
          float f[4];
          if constexpr (INT4) {  // planar: byte j holds j and j + D/2
            const int half = D / 2;
            const uint32_t w = *reinterpret_cast<const uint32_t*>(
                raw + (e < half ? e : e - half));
            const uint32_t nib =
                ((e < half ? w : w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
            for (int k = 0; k < 4; ++k) f[k] = magic_byte(nib, k) - 8388616.f;
          } else {
            const uint32_t u =
                *reinterpret_cast<const uint32_t*>(raw + e) ^ 0x80808080u;
#pragma unroll
            for (int k = 0; k < 4; ++k) f[k] = magic_byte(u, k) - 8388736.f;
          }
          out = make_uint2(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]));
        }
        *reinterpret_cast<uint2*>(cvt + isv * tile16 * ES * 2 +
                                  (i * ES + e) * 2) = out;
      }
      __syncthreads();
      kmat = cvt;
      vmat = cvt + tile16 * ES * 2;
    }
    const uint32_t kbase = static_cast<uint32_t>(
        __cvta_generic_to_shared(kmat + (kr * ES + kc) * 2));
    const uint32_t vbase = static_cast<uint32_t>(
        __cvta_generic_to_shared(vmat + (vr * ES + vc) * 2));

    // 16 keys: 16c .. 16c + 15; a warp past the group's heads idles
    for (int c = wk; mt < mtn && c < nch; c += WK) {
      // S = q.k^T: [2 n8 tiles of keys][4], each bf16 term of q in its own
      // accumulators (shorter chains), summed after
      float s3[3][2][4], sc[2][4];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s3[k][j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DMAX / 16; ++ks) {
        if (ks >= D16) break;
        uint32_t kf[4];
        ldsm_x4(kf, kbase + (c * 16 * ES + ks * 16) * 2);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          uint32_t qf[4];
          ldsm_x4(qf, qbase + k * QT + ks * 32);
          mma_bf16(s3[k][0], qf, kf[0], kf[1]);
          mma_bf16(s3[k][1], qf, kf[2], kf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = (s3[0][j][e] + s3[1][j][e]) + s3[2][j][e];
      // the online softmax of each row over the chunk: the score rounded
      // as the reference rounds it, masked past n; a row's four lanes
      // share its max; P (times the v scale) replaces S
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + mt * 16 + g + 8 * hh;
        const float slope = (a.slopes && r < rep) ? a.slopes[h * rep + r] : 0.f;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = c * 16 + 8 * j + 2 * t4 + e;
            float v = __fmul_rn(sc[j][2 * hh + e], a.kq_scale);
            if constexpr (QUANT) v = __fmul_rn(v, kss[key]);
            if (a.slopes)
              v = __fadd_rn(v, __fmul_rn(slope, static_cast<float>(p0 + key)));
            v = key < n ? v : kNegInf;
            sc[j][2 * hh + e] = v;
            mx = fmaxf(mx, v);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m_run[hh], mx);
        const float corr = expf(m_run[hh] - mn);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = c * 16 + 8 * j + 2 * t4 + e;
            const float ex = key < n ? expf(sc[j][2 * hh + e] - mn) : 0.f;
            sum += ex;
            float p = ex;
            if constexpr (QUANT) p = key < n ? ex * vss[key] : 0.f;
            sc[j][2 * hh + e] = p;
          }
        l_run[hh] = l_run[hh] * corr + sum;
        m_run[hh] = mn;
#pragma unroll
        for (int dn = 0; dn < NDT; ++dn) {
          acc[dn][2 * hh] *= corr;
          acc[dn][2 * hh + 1] *= corr;
        }
      }
      // acc += P.V: P's A fragments from the scores' registers, three bf16
      // terms
      uint32_t pa[3][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        split3(sc[u >> 1][2 * (u & 1)], sc[u >> 1][2 * (u & 1) + 1], pa[0][u],
               pa[1][u], pa[2][u]);
#pragma unroll
      for (int q = 0; q < NDT / 2; ++q) {
        if (q >= D16) break;
        uint32_t vf[4];
        ldsm_x4_t(vf, vbase + (c * 16 * ES + q * 16) * 2);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          mma_bf16(acc[2 * q], pa[k], vf[0], vf[1]);
          mma_bf16(acc[2 * q + 1], pa[k], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // every lane is done with this stage
    if (t + 2 < nt) issue(t + 2);
    cp_commit();
  }
  cp_wait<0>();

  // the block's merge: each warp's m, l and acc of its heads into red
  // [warps along the keys][heads of the group][D + 4], summed in warp order
  const bool direct = nsa == 1;
  const int64_t stride = part_stride(rep, D);
  float* pb = a.part + (int64_t)bh * nsplit * stride;
  float* dacc = direct ? a.acc + bh * rD : pb + s * stride;
  float* dm = direct ? a.m + (int64_t)bh * rep : pb + s * stride + rD;
  float* dl = direct ? a.l + (int64_t)bh * rep : dm + rep;
  float* red = reinterpret_cast<float*>(smem);
  const int RW = D + 4;
  if (mt < mtn) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float lsum = l_run[hh];
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      float* row = red + (wk * rows_g + mt * 16 + g + 8 * hh) * RW;
#pragma unroll
      for (int dn = 0; dn < NDT; ++dn) {
        const int d = dn * 8 + 2 * t4;
        if (d < D)
          *reinterpret_cast<float2*>(row + d) =
              make_float2(acc[dn][2 * hh], acc[dn][2 * hh + 1]);
      }
      if (t4 == 0) {
        row[D] = m_run[hh];
        row[D + 1] = lsum;
      }
    }
  }
  __syncthreads();
  for (int x = tid; x < nr * D; x += kThreads) {
    const int lr = x / D, d = x - lr * D;
    float mx = kNegInf;
    for (int w = 0; w < WK; ++w)
      mx = fmaxf(mx, red[(w * rows_g + lr) * RW + D]);
    float sum = 0.f, ls = 0.f;
    for (int w = 0; w < WK; ++w) {
      const float* row = red + (w * rows_g + lr) * RW;
      const float f = expf(row[D] - mx);
      sum += row[d] * f;
      ls += row[D + 1] * f;
    }
    dacc[(int64_t)(r0 + lr) * D + d] = sum;
    if (d == 0) {
      dm[r0 + lr] = mx;
      dl[r0 + lr] = ls;
    }
  }
  if (direct) return;
  merge_splits(a, bh, blockIdx.x, r0, nr, nsa, pb, stride,
               reinterpret_cast<float*>(smem + L.merge),
               reinterpret_cast<int*>(smem + L.flag));
}

template <typename KV, int DMAX>
cudaError_t launch_mma(const Args& a, int BH, int nsplit, cudaStream_t s) {
  const int rb = Row<KV, 16>::kInt4 ? a.D / 2 : a.D * (int)sizeof(KV);
  const int WM = a.warps_m;
  // the splits cover the window; the copies divide a row
  if ((int64_t)nsplit * a.tile * a.tps < a.W || a.D > DMAX ||
      (a.vec != 16 && a.vec != 8 && a.vec != 4) || rb % a.vec ||
      (WM != 1 && WM != 2 && WM != 4))
    return cudaErrorInvalidValue;
  auto kern = gqa_mma<KV, DMAX>;
  if (a.M.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.M.total);
    if (e != cudaSuccess) return e;
  }
  const int groups = ((a.rep + 15) / 16 + WM - 1) / WM;  // head groups
  kern<<<dim3(BH * groups, nsplit), kThreads, a.M.total, s>>>(a);
  return cudaGetLastError();
}

template <typename KV>
cudaError_t dispatch_mma(const Args& a, int BH, int nsplit, cudaStream_t s) {
  if (a.D <= 64) return launch_mma<KV, 64>(a, BH, nsplit, s);
  if (a.D <= 128) return launch_mma<KV, 128>(a, BH, nsplit, s);
  return launch_mma<KV, 256>(a, BH, nsplit, s);
}

template <typename KV, int VW, int NV, int HA, bool PIPE>
cudaError_t launch(const Args& a, int BH, int nsplit, cudaStream_t s) {
  const int rb = Row<KV, VW>::kInt4 ? a.D / 2 : a.D * (int)sizeof(KV);
  // the splits cover the window, and a tile loop needs every head in
  // registers
  if ((int64_t)nsplit * a.tile * a.tps < a.W || (a.G & (a.G - 1)) ||
      a.G > 32 || rb % VW || (rb / VW + a.G - 1) / a.G > NV ||
      (a.tps > 1 && (!PIPE || a.rep > HA)))
    return cudaErrorInvalidValue;
  auto kern = paged_decode<KV, VW, NV, HA, PIPE>;
  if (a.L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.L.total);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(BH, nsplit), kThreads, a.L.total, s>>>(a);
  return cudaGetLastError();
}

// heads: HA, a power of two; a tile loop (pipe) holds q and acc of every
// head (HA * elements <= 32), one tile a block takes HA = heads_cap
template <typename KV, int VW, int NV>
cudaError_t dispatch(const Args& a, int BH, int nsplit, int heads, bool pipe,
                     cudaStream_t s) {
  constexpr int E = NV * Row<KV, VW>::kElems;
  constexpr int CAP = heads_cap(E);
  if (!pipe) {
    if (heads != CAP) return cudaErrorInvalidValue;
    return launch<KV, VW, NV, CAP, false>(a, BH, nsplit, s);
  }
#define PA_HA(H)                                                \
  if (heads == H) {                                             \
    if constexpr (H * E <= kRegFloats / 2)                      \
      return launch<KV, VW, NV, H, true>(a, BH, nsplit, s);     \
  }
  PA_HA(1)
  PA_HA(2)
  PA_HA(4)
  PA_HA(8)
#undef PA_HA
  return cudaErrorInvalidValue;
}

int by_layout(int kv_dtype, int vec, int nv, const Args& a, int BH,
              int nsplit, int heads, int pipe, cudaStream_t s) {
  cudaError_t e = cudaErrorInvalidValue;
  if (a.warps_m > 0) {  // the tensor-core branch
    if (kv_dtype == 0) e = dispatch_mma<__nv_bfloat16>(a, BH, nsplit, s);
    else if (kv_dtype == 2) e = dispatch_mma<int8_t>(a, BH, nsplit, s);
    else if (kv_dtype == 3) e = dispatch_mma<uint8_t>(a, BH, nsplit, s);
    return static_cast<int>(e);
  }
#define PA(T, VW, NV) e = dispatch<T, VW, NV>(a, BH, nsplit, heads, pipe, s)
  if (kv_dtype == 0 && vec == 16 && nv == 1) PA(__nv_bfloat16, 16, 1);
  else if (kv_dtype == 1 && vec == 16 && nv == 1) PA(float, 16, 1);
  else if (kv_dtype == 1 && vec == 16 && nv == 2) PA(float, 16, 2);
  else if (kv_dtype == 2 && vec == 16 && nv == 1) PA(int8_t, 16, 1);
  else if (kv_dtype == 2 && vec == 8 && nv == 1) PA(int8_t, 8, 1);
  else if (kv_dtype == 3 && vec == 16 && nv == 1) PA(uint8_t, 16, 1);
  else if (kv_dtype == 3 && vec == 8 && nv == 1) PA(uint8_t, 8, 1);
  else if (kv_dtype == 3 && vec == 4 && nv == 1) PA(uint8_t, 4, 1);
#undef PA
  return static_cast<int>(e);
}

}  // namespace

// kv_dtype: 0 bf16, 1 f32, 2 int8, 3 int4 (uint8 rows of D/2 bytes); for
// 2 and 3, ks/vs are the f32 scales [NP, Hkv, page] of the layer. k/v are
// the layer's pool [NP, Hkv, page, Dp], their base aligned to vec bytes;
// tables [B, P] int32, or NULL for one page a stream (page b: the dense
// cache); n_past [B] int32; slopes [Hkv, rep] or NULL; q [B, Hkv, rep, D]
// f32. The plan (ops/paged_attention.launch_plan): tile (positions a
// stage), tps (tiles a block), nsplit (splits of the window, the grid's y),
// vec (16, 8 or 4 bytes), nv (vectors a lane), lanes (G), heads (HA), pipe,
// and smem, the 13 ints of Smem; with warps_m > 0 the tensor-core branch
// gqa_mma (warps_m warps along the heads), whose smem is the 12 ints of
// MmaSmem and which reads vec and no other lane geometry. part: f32
// scratch [B*Hkv, nsplit, part_stride(rep, D)] (unused when nsplit is 1);
// tickets: int32 [grid x], zero before the launch and zero after it.
// Outputs m/l [B, Hkv, rep] and acc [B, Hkv, rep, D], f32. Returns the
// launch's cudaError_t.
extern "C" int paged_attention_launch(
    int kv_dtype, const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* tables, const void* n_past,
    const void* slopes, void* part, void* tickets, void* m, void* l,
    void* acc, int B, int NP, int Hkv, int rep, int D, int page, int P, int W,
    int tile, int tps, int nsplit, int vec, int nv, int lanes, int heads,
    int pipe, int warps_m, const int* smem, float kq_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const float*>(q), k, v,
         static_cast<const float*>(ks), static_cast<const float*>(vs),
         static_cast<const int*>(tables), static_cast<const int*>(n_past),
         static_cast<const float*>(slopes), static_cast<float*>(part),
         static_cast<int*>(tickets), static_cast<float*>(m),
         static_cast<float*>(l), static_cast<float*>(acc), NP, Hkv, rep, D,
         page, P, W, tile, tps, lanes, kq_scale};
  if (warps_m > 0)
    memcpy(&a.M, smem, sizeof(MmaSmem));
  else
    memcpy(&a.L, smem, sizeof(Smem));
  a.vec = vec;
  a.warps_m = warps_m;
  return by_layout(kv_dtype, vec, nv, a, B * Hkv, nsplit, heads, pipe, s);
}
