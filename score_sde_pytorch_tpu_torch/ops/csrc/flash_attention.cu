// Single-head flash attention, forward and backward, for Hopper (sm_90a),
// fp32 and bf16, with every product on the tensor cores (mma.sync).
//
// The forward replaces the Pallas TPU kernel
// score_sde_pytorch_tpu/ops/attention.py:flash_attention (body
// _flash_kernel): softmax(q k^T * C^-1/2) v over q, k, v of shape [B, N, C],
// with an online softmax over KV tiles, the logits never written to device
// memory, and the output cast to the input dtype. The backward replaces
// score_sde_pytorch_tpu/ops/attention.py:_flash_bwd_impl (jnp, wired in
// through custom_vjp) and is described above its kernels, below.
//
// What bounds it on this card. At the NCSN++ shapes (N = 256 or 16,
// C = 256) the work is two products of 2 B N^2 C flops each (five in the
// backward) and the bytes are a few B N C elements. The products run on the
// tensor cores at fp32 accuracy; plain TF32 (10-bit mantissa) would break
// the 2e-5 agreement with the fp32 reference, so:
// - fp32 inputs run 3xTF32: each operand x is split as it is loaded from
//   shared memory into hi = x rounded to TF32 and lo = x - hi, and each
//   product is a_lo b_hi + a_hi b_lo + a_hi b_hi, three mma.sync m16n8k8
//   TF32 with fp32 accumulation (the lo lo term, 2^-22 relative, is
//   dropped). The logits sum each 8-channel step from zero on the tensor
//   cores and add it in fp32 (see logits() below): that keeps them closer
//   to the fp64 result than the plain fp32 path at logits x30.
// - bf16 inputs run mma.sync m16n8k16 bf16 with fp32 accumulation for the
//   logits (S and, in the backward, dP) and for P V, whose probabilities
//   are rounded to bf16 first, as the plain path does (ops/attention.py).
//   bf16 tiles are zero-padded to a multiple of 16 channels. The products
//   of the backward that take P or dS (dV, dK, dQ) keep them in fp32, as
//   the plain backward does: the fp32 operand is split, and the bf16 one,
//   exact in TF32, is not, so each is two TF32 mma.
// - Tiles are staged in shared memory as fp32 with rows padded to width + 4
//   floats (4 x an odd number), so that every fragment load of a warp hits
//   32 distinct banks. fp32 tiles arrive by 16-byte cp.async, double
//   buffered: the next tile loads while this one multiplies. bf16 tiles
//   are widened by the threads as they are staged (synchronously).
// - Where an A operand is a tile of probabilities in the accumulator layout
//   (P V, dV, dK), its depth index is permuted (k = t <-> 2 t,
//   k = t + 4 <-> 2 t + 1) in A and B alike, which turns accumulator
//   fragments into A fragments without shuffles and keeps the B loads along
//   rows of V, dO, Q and K conflict-free.
// - A warp issues in order, so an mma that adds to the sum of the one
//   before it waits out that one's latency. Every product therefore runs
//   each kind of term (lo hi, hi lo, hi hi) over two output tiles, and the
//   logits over two 8-channel steps, before the next kind (mma_tiles(),
//   logits()); the sums keep their order.
// - C = 256, the width of every 32^2 NCSN++ attention, and C = 512 have
//   their own instantiations with all offsets known to the compiler.
// What holds it back now (H100 80GB HBM3, 700 W; PERF.md): mma.sync TF32
// runs at ~320 TFLOP/s on this card, so the three products cap the fp32
// rate near 107 TFLOP/s; the forward reaches a third of that. Of its time
// at B, N, C = 64, 256, 256, the logits take a third: a warp's 16 x 16 tile
// reuses each split fragment for two products only, so loads, splits and
// fp32 step sums outnumber the mma two to one. Loading the tiles and the
// fixed work of a block (one block per SM: the first Q and KV tiles, the
// syncs, the output) take most of the rest. Larger warp tiles fed by wgmma
// straight from shared memory are the way past it; at C = 256 in fp32 they
// need a new shared-memory budget (ROADMAP.md queue 2).
//
// Forward design (FlashAttention-2 shape): one block of 8 warps per (batch,
// query tile of 64 rows); two warps share each 16 query rows, one taking
// the even and one the odd 8-column output tiles, and each computing the
// logits of half of the 32-row KV tile. The running max and sum live in
// registers on the accumulator fragments (quad shuffles reduce a row, and
// the pair swaps its row maxima through shared memory); P goes through
// shared memory to both warps of the pair. A warp's output accumulator is
// C / 4 floats per thread. K and V tiles of 32 rows, two stages:
// (64 + 4 x 32) x (C + 4) floats plus the P tile, 210 KB of dynamic shared
// memory at C = 256, raised per launch. Ragged tiles are masked: rows past
// N load as zeros, their logits as -inf, their outputs are not stored. When
// the backward will run, each row's log-sum-exp m + log(l) is written too.
//
// C from 264 to 512 (the 256^2 DDPM's and the 1024^2 NCSN++'s attention at
// C = 512). The layout above would need ~396 KB of shared memory and C / 2
// accumulator floats per thread. Of the three ways out (split the output
// channels over two blocks that both recompute the logits; 32-row query
// tiles with single-buffered K/V; a channel-chunked logit loop), these
// kernels take the second, because it keeps every logit's order of
// summation, and with it the backward's bitwise agreement with the forward,
// and needs no second pass: the warps that share a group of 16 query rows
// go from two to four ("ways"), each holding a quarter of the output
// channels (C / 8 floats per thread, as many as at C = 256) and computing
// the logits of a quarter of the KV tile. Blocks hold 32 query rows and
// stage one K/V tile at a time: (32 + 2 x 32) x (C + 4) floats, 204 KB at
// C = 512. The backward does the same: dK/dV blocks of 16 KV rows (eight
// warps, each an eighth of the channels) with a single-buffered 32-row
// query tile, 208 KB; dQ blocks of 32 query rows, 142 KB. Single staging
// loses the copy/compute overlap of the C <= 256 kernels, whose code and
// instantiations are unchanged.
//
// Built by score_sde_pytorch_tpu_torch/ops/build.py with nvcc into a shared
// library; the C entry points at the bottom are bound through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxC = 512;
constexpr int kPad = 4;              // floats of padding per staged row

// The widest C of the kernels with kWays warps per 16 query rows (2 up to
// C = 256, 4 up to 512), and the stages of their staged tiles.
template <int kWays>
__host__ __device__ constexpr int ways_max_c() {
  return 128 * kWays;
}

template <int kWays>
__host__ __device__ constexpr int ways_stages() {
  return kWays == 2 ? 2 : 1;
}

// ---------------------------------------------------------------------------
// Tensor-core products.

struct Split {
  uint32_t hi, lo;
};

// x rounded to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32
// on finite values, in two integer operations where the cvt takes about
// five: inputs here are finite).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as TF32 operands. With kSplit, hi = x rounded to TF32 and lo = x - hi
// (exact in fp32, |lo| <= 2^-11 |x|), of which the tensor cores read the
// TF32 part: hi + lo carries x to 2^-22. Without, x must be exact in TF32
// (a bf16 value) and goes in as it is.
template <bool kSplit>
__device__ __forceinline__ Split split(float x) {
  if (kSplit) {
    const uint32_t hi = to_tf32(x);
    return {hi, __float_as_uint(x - __uint_as_float(hi))};
  }
  return {__float_as_uint(x), 0u};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[i] += a b_i over the tiles i < kN with live(i), b_i from
// load_b(i, b_i), accumulated on the tensor cores (the products into P V,
// dV, dK and dQ: their drift stays far inside the kernels' bounds): a_lo
// b_hi, a_hi b_lo if b is split, then a_hi b_hi. A (P or dS) is always
// split; a b that is not is exact in TF32 (a bf16 value) and has no lo part.
// A warp issues in order and waits out the latency of an mma whose sum the
// next one adds to, so the tiles go in groups of kGroup and each kind of
// product runs over the whole group before the next: consecutive mma are
// independent.
template <bool kSplitB, int kGroup, int kN, typename Live, typename LoadB>
__device__ __forceinline__ void mma_tiles(float (&acc)[kN][4],
                                          const Split (&a)[4], Live live,
                                          LoadB load_b) {
  static_assert(kN % kGroup == 0, "whole groups");
#pragma unroll
  for (int i0 = 0; i0 < kN; i0 += kGroup) {
    Split b[kGroup][2];
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (live(i0 + u)) load_b(i0 + u, b[u]);
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (live(i0 + u))
        mma_tf32(acc[i0 + u], a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[u][0].hi,
                 b[u][1].hi);
    if constexpr (kSplitB) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if (live(i0 + u))
          mma_tf32(acc[i0 + u], a[0].hi, a[1].hi, a[2].hi, a[3].hi,
                   b[u][0].lo, b[u][1].lo);
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (live(i0 + u))
        mma_tf32(acc[i0 + u], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[u][0].hi,
                 b[u][1].hi);
  }
}

constexpr int kTileGroup = 2;  // tiles per group of mma_tiles()

// d += a b for one m16n8k16 bf16 step, fp32 accumulation. A (m, k):
// a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..);
// B (k, n): b0 (2t..2t+1, g), b1 (2t + 8.., g); two values to a register,
// the lower k in the low half.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 values held exactly in fp32 as one bf16x2 register (lo in the
// low half): their upper halves, in one byte permute.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Fragment loads from fp32 shared memory (row stride `ld` floats); lane =
// 4 g + t. m16n8k8 layouts: A (m, k) = a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); B (k, n) = b0 (t, g), b1 (t + 4, g).

// A rows m0.. of s, depth columns k0.. in order.
__device__ __forceinline__ void load_a(const float* s, int ld, int m0, int k0,
                                       Split (&a)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = s + (m0 + g) * ld + k0 + t;
  a[0] = split<true>(p[0]);
  a[1] = split<true>(p[8 * ld]);
  a[2] = split<true>(p[4]);
  a[3] = split<true>(p[8 * ld + 4]);
}

// A rows m0.. of s, depth columns k0.. permuted (t -> 2t, t + 4 -> 2t + 1).
__device__ __forceinline__ void load_a_perm(const float* s, int ld, int m0,
                                            int k0, Split (&a)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float2 top = *reinterpret_cast<const float2*>(s + (m0 + g) * ld + k0 +
                                                      2 * t);
  const float2 bottom = *reinterpret_cast<const float2*>(
      s + (m0 + g + 8) * ld + k0 + 2 * t);
  a[0] = split<true>(top.x);
  a[1] = split<true>(bottom.x);
  a[2] = split<true>(top.y);
  a[3] = split<true>(bottom.y);
}

// A = s^T: A (m, k) = s (k, m), depth rows k0.. of s permuted.
__device__ __forceinline__ void load_a_perm_t(const float* s, int ld, int m0,
                                              int k0, Split (&a)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = s + (k0 + 2 * t) * ld + m0 + g;
  a[0] = split<true>(p[0]);
  a[1] = split<true>(p[8]);
  a[2] = split<true>(p[ld]);
  a[3] = split<true>(p[ld + 8]);
}

// A = dS^T with dS (q, kv) = P (q, kv) (dP (q, kv) - D (q)) formed from the
// P and dP tiles as it is loaded, depth (query) rows permuted.
__device__ __forceinline__ void load_ds_perm_t(const float* p_s,
                                               const float* dp_s,
                                               const float* d_s, int ld,
                                               int m0, int k0,
                                               Split (&a)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int row = k0 + 2 * t;
  const float d0 = d_s[row], d1 = d_s[row + 1];
  const float* p = p_s + row * ld + m0 + g;
  const float* dp = dp_s + row * ld + m0 + g;
  a[0] = split<true>(p[0] * (dp[0] - d0));
  a[1] = split<true>(p[8] * (dp[8] - d0));
  a[2] = split<true>(p[ld] * (dp[ld] - d1));
  a[3] = split<true>(p[ld + 8] * (dp[ld + 8] - d1));
}

// B (k, n) = s (n0 + n, k0 + k): the rows of s are B's columns (K in q k^T).
__device__ __forceinline__ void load_b_rows(const float* s, int ld, int n0,
                                            int k0, Split (&b)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = s + (n0 + g) * ld + k0 + t;
  b[0] = split<true>(p[0]);
  b[1] = split<true>(p[4]);
}

// B (k, n) = s (k0 + perm(k), n0 + n): the rows of s are B's depth.
template <bool kSplit>
__device__ __forceinline__ void load_b_perm(const float* s, int ld, int k0,
                                            int n0, Split (&b)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = s + (k0 + 2 * t) * ld + n0 + g;
  b[0] = split<kSplit>(p[0]);
  b[1] = split<kSplit>(p[ld]);
}

// bf16 m16n8k16 fragments from fp32 tiles of bf16 values.
//
// Of row `row` of a logit operand, the 16 channels from k0 as the low and
// high registers of a fragment (a0/a2 of A, b0/b1 of B): logical k = 2t,
// 2t + 1, 2t + 8, 2t + 9 read channels t, t + 4, t + 8, t + 12. A and B read
// the same order, so each logit is the same sum, and scalar loads from rows
// of stride 4 x odd floats hit 32 distinct banks.
__device__ __forceinline__ void load_row_bf16(const float* s, int ld, int row,
                                              int k0, uint32_t& lo,
                                              uint32_t& hi) {
  const float* p = s + row * ld + k0 + (threadIdx.x & 3);
  lo = pack_bf16(p[0], p[4]);
  hi = pack_bf16(p[8], p[12]);
}

// A rows m0.. of s (row stride 8 mod 32 floats), depth columns k0.. in order.
__device__ __forceinline__ void load_a_bf16(const float* s, int ld, int m0,
                                            int k0, uint32_t (&a)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = s + (m0 + g) * ld + k0 + 2 * t;
  const float2 x0 = *reinterpret_cast<const float2*>(p);
  const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * ld);
  const float2 x2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 x3 = *reinterpret_cast<const float2*>(p + 8 * ld + 8);
  a[0] = pack_bf16(x0.x, x0.y);
  a[1] = pack_bf16(x1.x, x1.y);
  a[2] = pack_bf16(x2.x, x2.y);
  a[3] = pack_bf16(x3.x, x3.y);
}

// B (k, n) = s (k0 + k, n0 + n): the rows of s are B's depth, in order.
__device__ __forceinline__ void load_b_bf16(const float* s, int ld, int k0,
                                            int n0, uint32_t (&b)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = s + (k0 + 2 * t) * ld + n0 + g;
  b[0] = pack_bf16(p[0], p[ld]);
  b[1] = pack_bf16(p[8 * ld], p[9 * ld]);
}

// Channels a tile of T is staged with: bf16 tiles are zero-padded to a
// multiple of 16, the depth of the bf16 mma.
template <typename T>
__host__ __device__ __forceinline__ int staged_width(int c) {
  return std::is_same<T, float>::value ? c : (c + 15) / 16 * 16;
}

constexpr int kLogitSteps = 2;  // 8-channel steps a logits() pass interleaves

// The one logit routine of the forward and the backward:
// s[j] = x rows m0..m0+15 . y rows 8 j..8 j+7.
// - fp32 inputs: 3xTF32 over the C channels in steps of 8, each step's
//   products small terms first (a_lo b_hi + a_hi b_lo + a_hi b_hi) summed on
//   the tensor cores from zero and added to s in fp32 (round to nearest),
//   step after step. The tensor cores' accumulation rounds toward zero, and
//   a chain of them over the C = 256 channels of a logit drifts to several
//   times fp32's error, which the softmax of large logits amplifies. The
//   steps are independent, so kLogitSteps of them go at once, each kind of
//   product over all their tiles before the next (as in mma_tiles()).
// - bf16 inputs: the bf16 mma in steps of 16 over the zero-padded width.
// Every logit depends only on its two rows and that order, so the
// backward's P = exp(S * scale - lse) sees bitwise the forward's S.
template <typename T, int kTiles>
__device__ __forceinline__ void logits(const float* x_s, const float* y_s,
                                       int ld, int c, int m0, int n0,
                                       float (&s)[kTiles][4]) {
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll 2
    for (int k0 = 0; k0 < c; k0 += 8 * kLogitSteps) {
      Split a[kLogitSteps][4];
      Split b[kLogitSteps][kTiles][2];
      float step[kLogitSteps][kTiles][4];
#pragma unroll
      for (int u = 0; u < kLogitSteps; ++u) {
        if (k0 + 8 * u < c) {
          load_a(x_s, ld, m0, k0 + 8 * u, a[u]);
#pragma unroll
          for (int j = 0; j < kTiles; ++j)
            load_b_rows(y_s, ld, n0 + 8 * j, k0 + 8 * u, b[u][j]);
        }
#pragma unroll
        for (int j = 0; j < kTiles; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) step[u][j][e] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < kLogitSteps; ++u)
#pragma unroll
        for (int j = 0; j < kTiles; ++j)
          if (k0 + 8 * u < c)
            mma_tf32(step[u][j], a[u][0].lo, a[u][1].lo, a[u][2].lo,
                     a[u][3].lo, b[u][j][0].hi, b[u][j][1].hi);
#pragma unroll
      for (int u = 0; u < kLogitSteps; ++u)
#pragma unroll
        for (int j = 0; j < kTiles; ++j)
          if (k0 + 8 * u < c)
            mma_tf32(step[u][j], a[u][0].hi, a[u][1].hi, a[u][2].hi,
                     a[u][3].hi, b[u][j][0].lo, b[u][j][1].lo);
#pragma unroll
      for (int u = 0; u < kLogitSteps; ++u)
#pragma unroll
        for (int j = 0; j < kTiles; ++j)
          if (k0 + 8 * u < c)
            mma_tf32(step[u][j], a[u][0].hi, a[u][1].hi, a[u][2].hi,
                     a[u][3].hi, b[u][j][0].hi, b[u][j][1].hi);
#pragma unroll
      for (int u = 0; u < kLogitSteps; ++u) {
        if (k0 + 8 * u < c) {
#pragma unroll
          for (int j = 0; j < kTiles; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] += step[u][j][e];
        }
      }
    }
  } else {
    const int g = (threadIdx.x & 31) >> 2;
    const int width = staged_width<T>(c);
#pragma unroll 2
    for (int k0 = 0; k0 < width; k0 += 16) {
      uint32_t a[4];
      load_row_bf16(x_s, ld, m0 + g, k0, a[0], a[2]);
      load_row_bf16(x_s, ld, m0 + g + 8, k0, a[1], a[3]);
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        uint32_t b[2];
        load_row_bf16(y_s, ld, n0 + 8 * j + g, k0, b[0], b[1]);
        mma_bf16(s[j], a, b);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Staging into shared memory.

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// rows x cols of a row-major source (row stride src_ld) into dst (row stride
// dst_ld) as fp32; rows at or past valid_rows become zeros. fp32 goes by
// cp.async (done at the next wait); cols is a multiple of 4. bf16 is
// widened by the threads, to staged_width<bf16>(cols) columns, the ones
// past cols zeros; cols is a multiple of 8.
template <int kThreads>
__device__ __forceinline__ void stage(const float* src, size_t src_ld,
                                      float* dst, int dst_ld, int rows,
                                      int valid_rows, int cols) {
  const int chunks = cols / 4;
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int r = e / chunks;
    const int col = (e - r * chunks) * 4;
    const bool valid = r < valid_rows;
    cp_async16(dst + r * dst_ld + col, valid ? src + r * src_ld + col : src,
               valid);
  }
}

template <int kThreads>
__device__ __forceinline__ void stage(const __nv_bfloat16* src, size_t src_ld,
                                      float* dst, int dst_ld, int rows,
                                      int valid_rows, int cols) {
  const int chunks = staged_width<__nv_bfloat16>(cols) / 8;
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int r = e / chunks;
    const int col = (e - r * chunks) * 8;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 hi = lo;
    if (r < valid_rows && col < cols) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * src_ld + col);
      const __nv_bfloat162* pairs =
          reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 f0 = __bfloat1622float2(pairs[0]);
      const float2 f1 = __bfloat1622float2(pairs[1]);
      const float2 f2 = __bfloat1622float2(pairs[2]);
      const float2 f3 = __bfloat1622float2(pairs[3]);
      lo = make_float4(f0.x, f0.y, f1.x, f1.y);
      hi = make_float4(f2.x, f2.y, f3.x, f3.y);
    }
    float4* out = reinterpret_cast<float4*>(dst + r * dst_ld + col);
    out[0] = lo;
    out[1] = hi;
  }
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float round_like(float x, const float*) { return x; }

__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------------------
// Forward.

constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdK = 32;                // KV rows per tile
constexpr int kFwdPLd = kFwdK + 8;       // P tiles: 8 mod 32, for float2 A loads

// Query rows per forward block: 16 for each group of kWays warps.
template <int kWays>
__host__ __device__ constexpr int fwd_rows() {
  return 16 * (kFwdWarps / kWays);
}

// Each query row group of 16 is shared by kWays warps (way = 0 .. kWays-1):
// a warp computes the logits of its 16 rows against 1 / kWays of the KV
// tile's columns and accumulates 1 / kWays of the output channels (8-column
// tiles kWays i + way), so its output accumulator is 16 x 4 floats per
// thread at the widest C and kWays warps of independent mma chains share
// the row group. kWays = 2: 64 query rows, K/V double-buffered (C <= 256);
// kWays = 4: 32 query rows, one K/V stage (C <= 512).
template <typename T, int kC, int kWays>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_attention_fwd(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, int n, int c_arg, int q_tiles,
                    float scale) {
  constexpr int kQ = fwd_rows<kWays>();
  constexpr int kStages = ways_stages<kWays>();
  constexpr int kAccTiles = ways_max_c<kWays>() / (8 * kWays);
  constexpr int kSTiles = kFwdK / (8 * kWays);  // logit tiles of a warp
  const int c = kC > 0 ? kC : c_arg;
  extern __shared__ __align__(16) float smem[];
  const int ld = staged_width<T>(c) + kPad;
  float* q_s = smem;
  float* kv_s = q_s + kQ * ld;                  // [kStages][K tile, V tile]
  float* p_s = kv_s + kStages * 2 * kFwdK * ld;  // kQ x kFwdPLd
  float* red_s = p_s + kQ * kFwdPLd;            // [kWays][kQ]

  const int batch = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - batch * q_tiles) * kQ;
  const size_t base = static_cast<size_t>(batch) * n * c;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int m0 = 16 * (warp % (kFwdWarps / kWays));
  const int way = warp / (kFwdWarps / kWays);
  const int tiles = (n + kFwdK - 1) / kFwdK;

  auto stage_kv = [&](int tile) {
    const int k0 = tile * kFwdK;
    float* dst = kv_s + (tile & (kStages - 1)) * 2 * kFwdK * ld;
    stage<kFwdThreads>(k + base + static_cast<size_t>(k0) * c, c, dst, ld,
                       kFwdK, n - k0, c);
    stage<kFwdThreads>(v + base + static_cast<size_t>(k0) * c, c,
                       dst + kFwdK * ld, ld, kFwdK, n - k0, c);
  };
  stage<kFwdThreads>(q + base + static_cast<size_t>(q0) * c, c, q_s, ld,
                     kQ, n - q0, c);
  stage_kv(0);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};   // this warp's columns only
  float acc[kAccTiles][4];
#pragma unroll
  for (int i = 0; i < kAccTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int tile = 0; tile < tiles; ++tile) {
    if constexpr (kStages == 1) {
      if (tile > 0) {
        __syncthreads();  // every warp is done with the last tile's K and V
        stage_kv(tile);
        cp_async_commit();
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // this tile has landed; the other stage is free
    if constexpr (kStages == 2) {
      if (tile + 1 < tiles) stage_kv(tile + 1);
      cp_async_commit();
    }
    const float* k_s = kv_s + (tile & (kStages - 1)) * 2 * kFwdK * ld;
    const float* v_s = k_s + kFwdK * ld;
    const int n0 = 8 * kSTiles * way;
    const int k0 = tile * kFwdK + n0;

    float s[kSTiles][4];
    logits<T, kSTiles>(q_s, k_s, ld, c, m0, n0, s);

    // Online softmax on the fragments: this thread holds rows g (e = 0, 1)
    // and g + 8 (e = 2, 3) of the warp's 16; a quad shares a row, and the
    // warps of a row group swap their row maxima through red_s.
    float row_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kSTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + 8 * j + 2 * t + (e & 1) < n;
        s[j][e] = valid ? s[j][e] * scale : -INFINITY;
        row_max[e >> 1] = fmaxf(row_max[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_max[r] = fmaxf(row_max[r],
                         __shfl_xor_sync(0xffffffffu, row_max[r], 1));
      row_max[r] = fmaxf(row_max[r],
                         __shfl_xor_sync(0xffffffffu, row_max[r], 2));
      if (t == 0) red_s[way * kQ + m0 + g + 8 * r] = row_max[r];
    }
    __syncthreads();
    float alpha[2];
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + g + 8 * r;
      // Every tile holds a valid column, so the max is finite; every warp
      // of the row group computes the same bits.
      float tile_max = red_s[row];
#pragma unroll
      for (int w = 1; w < kWays; ++w)
        tile_max = fmaxf(tile_max, red_s[w * kQ + row]);
      const float m_new = fmaxf(m[r], tile_max);
      alpha[r] = expf(m[r] - m_new);  // 0 on the first tile
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kSTiles; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = expf(s[j][2 * r] - m[r]);
        const float p1 = expf(s[j][2 * r + 1] - m[r]);
        row_sum[r] += p0 + p1;
        store2(p_s + (m0 + g + 8 * r) * kFwdPLd + n0 + 8 * j + 2 * t,
               round_like(p0, q), round_like(p1, q));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
      row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
      l[r] = l[r] * alpha[r] + row_sum[r];
    }
#pragma unroll
    for (int i = 0; i < kAccTiles; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }
    __syncthreads();  // P of the whole tile is in p_s

    // acc += P V over the tile's 32 KV rows: fp32 in the permuted depth
    // order, bf16 (P rounded to bf16 above) in order, 16 rows a step.
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int kk = 0; kk < kFwdK; kk += 8) {
        Split a[4];
        load_a_perm(p_s, kFwdPLd, m0, kk, a);
        mma_tiles<true, kTileGroup>(
            acc, a, [&](int i) { return 8 * (kWays * i + way) < c; },
            [&](int i, Split (&b)[2]) {
              load_b_perm<true>(v_s, ld, kk, 8 * (kWays * i + way), b);
            });
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kFwdK; kk += 16) {
        uint32_t a[4];
        load_a_bf16(p_s, kFwdPLd, m0, kk, a);
#pragma unroll
        for (int i = 0; i < kAccTiles; ++i) {
          const int col0 = 8 * (kWays * i + way);
          if (col0 < c) {
            uint32_t b[2];
            load_b_bf16(v_s, ld, kk, col0, b);
            mma_bf16(acc[i], a, b);
          }
        }
      }
    }
  }

  // l over the whole row: the warps' sums, added in one order by all.
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (t == 0) red_s[way * kQ + m0 + g + 8 * r] = l[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + m0 + g + 8 * r;
    if (row >= n) continue;
    float l_row = red_s[m0 + g + 8 * r];
#pragma unroll
    for (int w = 1; w < kWays; ++w) l_row += red_s[w * kQ + m0 + g + 8 * r];
    const float inv = 1.f / l_row;
    T* out_row = o + base + static_cast<size_t>(row) * c;
#pragma unroll
    for (int i = 0; i < kAccTiles; ++i) {
      const int col = 8 * (kWays * i + way) + 2 * t;
      if (col < c)
        store2(out_row + col, acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
    }
    // The backward recomputes P = exp(S - lse) from this row statistic.
    if (lse != nullptr && way == 0 && t == 0)
      lse[static_cast<size_t>(batch) * n + row] = m[r] + logf(l_row);
  }
}

template <typename T, int kC, int kWays>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int n, int c, float scale, cudaStream_t stream) {
  constexpr int kQ = fwd_rows<kWays>();
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kQ + ways_stages<kWays>() * 2 * kFwdK) *
           (staged_width<T>(c) + kPad) +
       kQ * kFwdPLd + kWays * kQ);
  const long long q_tiles = (n + kQ - 1) / kQ;
  const long long blocks = q_tiles * batch;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd<T, kC, kWays>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_fwd<T, kC, kWays><<<static_cast<unsigned>(blocks),
                                      kFwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, n, c,
      static_cast<int>(q_tiles), scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward (FlashAttention-2 shape, _flash_bwd_impl's numerics).
//
// With P = exp(S - lse), the forward's row log-sum-exp, and
// D = rowsum(dO o O):
//   dS = P o (dO V^T - D),  dQ = scale dS K,  dK = scale dS^T Q,  dV = P^T dO.
// Five products, three launches per call, all on one stream:
// 1. attention_bwd_delta: D, one warp per row, into fp32 scratch.
// 2. flash_attention_bwd_dkdv: one block of 8 warps per (batch, KV tile of
//    32 rows) keeps K and V in shared memory and walks the query tiles (32
//    rows, Q and dO double-buffered by cp.async). Per tile pair, warps 0-3
//    compute 16 x 16 tiles of S (the forward's logit routine) and keep P,
//    warps 4-7 the same tiles of dP; both go through shared memory, the dP
//    warps write dS = P o (dP - D) to a [B, N, ld] fp32 scratch (ld = N
//    rounded up to 32), and every warp adds P^T dO and dS^T Q (dS formed as
//    its fragments load) into its 16 KV rows x C / 4 channels of dV and dK
//    (registers: 2 x C / 8 floats per thread).
// 3. flash_attention_bwd_dq: dQ = scale dS K, a product over the stored dS:
//    one block of 8 warps per (batch, 64 query rows), dS and K tiles
//    double-buffered by cp.async. No S or dP is recomputed for dQ.
// Each output row has one writer and every sum runs in a fixed order, so the
// result is bitwise the same from run to run (no atomics).
//
// What bounds it: the five products, 3xTF32 on the tensor cores as in the
// forward, plus the dS round trip (2 B N^2 x 4 bytes: 67 MB at
// B, N = 128, 256) and the D pass. Shared memory of kernel 2 at C = 256:
// K, V and two stages of Q and dO, 6 x 32 x (C + 4) floats, plus P and dP
// tiles: 209 KB, raised per launch. Past C = 256 (kWays = 4, see the top of
// the file) kernel 2 takes 16 KV rows (S and dP tiles of 16 x 8, each warp
// 16 rows x C / 8 channels of dV and dK) and one stage of Q and dO, and
// kernel 3 32 query rows (each warp C / 4 channels).
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;
constexpr int kBwdRows = 32;            // query rows per tile (and dS columns)
constexpr int kPLd = kBwdRows + 4;      // P and dS tiles: 2 x 36 = 8 mod 32
constexpr int kDsLd = kBwdRows + 8;     // dS tiles of the dQ kernel: 8 mod 32

template <typename T>
__global__ void attention_bwd_delta(const T* __restrict__ o,
                                    const T* __restrict__ dout,
                                    float* __restrict__ delta, long long rows,
                                    int c) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const T* o_row = o + row * c;
  const T* do_row = dout + row * c;
  float sum = 0.f;
  for (int col = lane * 2; col < c; col += 64) {
    float2 ov, dv;
    if constexpr (std::is_same<T, float>::value) {
      ov = *reinterpret_cast<const float2*>(o_row + col);
      dv = *reinterpret_cast<const float2*>(do_row + col);
    } else {
      ov = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o_row + col));
      dv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(do_row + col));
    }
    sum = fmaf(ov.x, dv.x, sum);
    sum = fmaf(ov.y, dv.y, sum);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

// KV rows per dK/dV block: 32 with kWays = 2 (C <= 256), 16 with kWays = 4.
template <int kWays>
__host__ __device__ constexpr int dkdv_rows() {
  return 64 / kWays;
}

template <typename T, int kC, int kWays>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ ds_out, T* __restrict__ dk,
                         T* __restrict__ dv, int n, int c_arg, int kv_tiles,
                         int ds_ld, float scale) {
  const int c = kC > 0 ? kC : c_arg;
  constexpr bool kSplit = std::is_same<T, float>::value;  // Q, dO not exact
  constexpr int kKv = dkdv_rows<kWays>();
  constexpr int kStages = ways_stages<kWays>();
  constexpr int kRowGroups = kKv / 16;       // of dK, dV rows
  constexpr int kGroups = 8 / kRowGroups;    // of channels: 4 or 8
  constexpr int kTiles = ways_max_c<kWays>() / (8 * kGroups);  // 8
  constexpr int kSTiles = kKv / 16;          // logit tiles of a warp
  extern __shared__ __align__(16) float smem[];
  const int ld = staged_width<T>(c) + kPad;
  float* k_s = smem;
  float* v_s = k_s + kKv * ld;
  float* qd_s = v_s + kKv * ld;                // [kStages][Q, dO]
  float* p_s = qd_s + kStages * 2 * kBwdRows * ld;
  float* dp_s = p_s + kBwdRows * kPLd;
  float* stats_s = dp_s + kBwdRows * kPLd;     // [kStages][lse, D]

  const int batch = blockIdx.x / kv_tiles;
  const int k0 = (blockIdx.x - batch * kv_tiles) * kKv;
  const size_t base = static_cast<size_t>(batch) * n * c;
  const size_t row_base = static_cast<size_t>(batch) * n;
  float* ds_rows = ds_out + row_base * ds_ld;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  // S or dP: 16 query rows x kKv / 2 KV columns.
  const int sm = 16 * ((warp >> 1) & 1), sn = (kKv / 2) * (warp & 1);
  // Its dK, dV rows and channel group.
  const int am = 16 * (warp % kRowGroups), ag = warp / kRowGroups;
  const int tiles = (n + kBwdRows - 1) / kBwdRows;

  auto stage_query_tile = [&](int tile) {
    const int row0 = tile * kBwdRows;
    const int stage_i = tile & (kStages - 1);
    float* dst = qd_s + stage_i * 2 * kBwdRows * ld;
    stage<kBwdThreads>(q + base + static_cast<size_t>(row0) * c, c, dst, ld,
                       kBwdRows, n - row0, c);
    stage<kBwdThreads>(dout + base + static_cast<size_t>(row0) * c, c,
                       dst + kBwdRows * ld, ld, kBwdRows, n - row0, c);
    if (threadIdx.x < 2 * kBwdRows) {
      const int r = threadIdx.x % kBwdRows;
      const float* src = threadIdx.x < kBwdRows ? lse : delta;
      stats_s[stage_i * 2 * kBwdRows + threadIdx.x] =
          row0 + r < n ? src[row_base + row0 + r] : 0.f;
    }
  };

  stage<kBwdThreads>(k + base + static_cast<size_t>(k0) * c, c, k_s, ld,
                     kKv, n - k0, c);
  stage<kBwdThreads>(v + base + static_cast<size_t>(k0) * c, c, v_s, ld,
                     kKv, n - k0, c);
  stage_query_tile(0);
  cp_async_commit();

  float dk_acc[kTiles][4];
  float dv_acc[kTiles][4];
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int tile = 0; tile < tiles; ++tile) {
    if constexpr (kStages == 1) {
      if (tile > 0) {
        __syncthreads();  // every warp is done with the last query tile
        stage_query_tile(tile);
        cp_async_commit();
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // this query tile has landed; the other stage is free
    if constexpr (kStages == 2) {
      if (tile + 1 < tiles) stage_query_tile(tile + 1);
      cp_async_commit();
    }
    const float* q_s = qd_s + (tile & (kStages - 1)) * 2 * kBwdRows * ld;
    const float* do_s = q_s + kBwdRows * ld;
    const float* lse_s = stats_s + (tile & (kStages - 1)) * 2 * kBwdRows;
    const float* d_s = lse_s + kBwdRows;
    const int q0 = tile * kBwdRows;

    // Warps 0-3 compute 16 x kKv / 2 tiles of S and keep
    // P = exp(S scale - lse) (0 where masked); warps 4-7 the same tiles of
    // dP.
    float x[kSTiles][4];
    if (warp < 4)
      logits<T, kSTiles>(q_s, k_s, ld, c, sm, sn, x);
    else
      logits<T, kSTiles>(do_s, v_s, ld, c, sm, sn, x);
#pragma unroll
    for (int j = 0; j < kSTiles; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = sm + g + 8 * r;
        const int col = sn + 8 * j + 2 * t;
        if (warp < 4) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            p[e] = q0 + i < n && k0 + col + e < n
                       ? expf(x[j][2 * r + e] * scale - lse_s[i])
                       : 0.f;
          store2(p_s + i * kPLd + col, p[0], p[1]);
        } else {
          store2(dp_s + i * kPLd + col, x[j][2 * r], x[j][2 * r + 1]);
        }
      }
    __syncthreads();

    // dS = P o (dP - D) for the dQ kernel, from the dP warps' registers.
    if (warp >= 4) {
#pragma unroll
      for (int j = 0; j < kSTiles; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = sm + g + 8 * r;
          const int col = sn + 8 * j + 2 * t;
          if (q0 + i < n) {
            const float2 p = *reinterpret_cast<const float2*>(
                p_s + i * kPLd + col);
            store2(ds_rows + static_cast<size_t>(q0 + i) * ds_ld + k0 + col,
                   p.x * (x[j][2 * r] - d_s[i]),
                   p.y * (x[j][2 * r + 1] - d_s[i]));
          }
        }
    }

    // dV += P^T dO and dK += dS^T Q over this tile's 32 query rows.
#pragma unroll
    for (int kk = 0; kk < kBwdRows; kk += 8) {
      Split a_p[4];
      Split a_ds[4];
      load_a_perm_t(p_s, kPLd, am, kk, a_p);
      load_ds_perm_t(p_s, dp_s, d_s, kPLd, am, kk, a_ds);
      auto live = [&](int i) { return 8 * (kGroups * i + ag) < c; };
      mma_tiles<kSplit, kTileGroup>(
          dv_acc, a_p, live, [&](int i, Split (&b)[2]) {
            load_b_perm<kSplit>(do_s, ld, kk, 8 * (kGroups * i + ag), b);
          });
      mma_tiles<kSplit, kTileGroup>(
          dk_acc, a_ds, live, [&](int i, Split (&b)[2]) {
            load_b_perm<kSplit>(q_s, ld, kk, 8 * (kGroups * i + ag), b);
          });
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + am + g + 8 * r;
    if (row >= n) continue;
    T* dk_row = dk + base + static_cast<size_t>(row) * c;
    T* dv_row = dv + base + static_cast<size_t>(row) * c;
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int col = 8 * (kGroups * i + ag) + 2 * t;
      if (col < c) {
        store2(dk_row + col, scale * dk_acc[i][2 * r],
               scale * dk_acc[i][2 * r + 1]);
        store2(dv_row + col, dv_acc[i][2 * r], dv_acc[i][2 * r + 1]);
      }
    }
  }
}

// Query rows per dQ block: 16 for each group of kWays warps.
template <int kWays>
__host__ __device__ constexpr int dq_rows() {
  return 16 * (8 / kWays);
}

template <typename T, int kC, int kWays>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_attention_bwd_dq(const float* __restrict__ ds, const T* __restrict__ k,
                       T* __restrict__ dq, int n, int c_arg, int q_tiles,
                       int ds_ld, float scale) {
  const int c = kC > 0 ? kC : c_arg;
  constexpr bool kSplit = std::is_same<T, float>::value;  // K not exact
  constexpr int kRows = dq_rows<kWays>();
  constexpr int kTiles = ways_max_c<kWays>() / (8 * kWays);  // 16 a warp
  extern __shared__ __align__(16) float smem[];
  const int ld = staged_width<T>(c) + kPad;
  float* ds_s = smem;                          // [2 stages] kRows x kDsLd
  float* k_s = ds_s + 2 * kRows * kDsLd;       // [2 stages] 32 x ld

  const int batch = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - batch * q_tiles) * kRows;
  const size_t base = static_cast<size_t>(batch) * n * c;
  const float* ds_rows =
      ds + (static_cast<size_t>(batch) * n + q0) * ds_ld;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int am = 16 * (warp % (8 / kWays)), ah = warp / (8 / kWays);
  const int tiles = ds_ld / kBwdRows;

  auto stage_tile = [&](int tile) {
    const int k0 = tile * kBwdRows;
    stage<kBwdThreads>(ds_rows + k0, ds_ld, ds_s + (tile & 1) * kRows * kDsLd,
                       kDsLd, kRows, n - q0, kBwdRows);
    stage<kBwdThreads>(k + base + static_cast<size_t>(k0) * c, c,
                       k_s + (tile & 1) * kBwdRows * ld, ld, kBwdRows, n - k0,
                       c);
  };
  stage_tile(0);
  cp_async_commit();

  float acc[kTiles][4];
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait<0>();
    __syncthreads();  // this tile has landed; the other stage is free
    if (tile + 1 < tiles) stage_tile(tile + 1);
    cp_async_commit();
    const float* a_s = ds_s + (tile & 1) * kRows * kDsLd;
    const float* b_s = k_s + (tile & 1) * kBwdRows * ld;
#pragma unroll
    for (int kk = 0; kk < kBwdRows; kk += 8) {
      Split a[4];
      load_a_perm(a_s, kDsLd, am, kk, a);
      mma_tiles<kSplit, kTileGroup>(
          acc, a, [&](int i) { return 8 * (kWays * i + ah) < c; },
          [&](int i, Split (&b)[2]) {
            load_b_perm<kSplit>(b_s, ld, kk, 8 * (kWays * i + ah), b);
          });
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + am + g + 8 * r;
    if (row >= n) continue;
    T* dq_row = dq + base + static_cast<size_t>(row) * c;
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int col = 8 * (kWays * i + ah) + 2 * t;
      if (col < c)
        store2(dq_row + col, scale * acc[i][2 * r], scale * acc[i][2 * r + 1]);
    }
  }
}

template <typename T, int kC, int kWays>
int launch_backward(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    float* scratch, void* dq, void* dk, void* dv, int batch,
                    int n, int c, float scale, cudaStream_t stream) {
  constexpr int kKv = dkdv_rows<kWays>();
  constexpr int kStages = ways_stages<kWays>();
  constexpr int kDqRows = dq_rows<kWays>();
  const long long rows = static_cast<long long>(batch) * n;
  const int ds_ld = (n + kBwdRows - 1) / kBwdRows * kBwdRows;
  float* ds = scratch;
  float* delta = scratch + rows * ds_ld;
  const long long delta_blocks = (rows * 32 + kBwdThreads - 1) / kBwdThreads;
  // dK/dV blocks cover every column of dS (ds_ld, a multiple of 32), so the
  // dQ kernel reads zeros past N.
  const long long kv_tiles = ds_ld / kKv;
  const long long q_tiles = (n + kDqRows - 1) / kDqRows;
  if (kv_tiles * batch > 0x7fffffffLL || q_tiles * batch > 0x7fffffffLL ||
      delta_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);

  attention_bwd_delta<T><<<static_cast<unsigned>(delta_blocks), kBwdThreads,
                           0, stream>>>(static_cast<const T*>(o),
                                        static_cast<const T*>(dout), delta,
                                        rows, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int ld = staged_width<T>(c) + kPad;
  const size_t smem_dkdv = sizeof(float) *
      ((2 * kKv + kStages * 2 * kBwdRows) * ld + 2 * kBwdRows * kPLd +
       kStages * 2 * kBwdRows);
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv<T, kC, kWays>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dkdv));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dkdv<T, kC, kWays>
      <<<static_cast<unsigned>(kv_tiles * batch), kBwdThreads, smem_dkdv,
         stream>>>(qt, kt, static_cast<const T*>(v),
                   static_cast<const T*>(dout), lse, delta, ds,
                   static_cast<T*>(dk), static_cast<T*>(dv), n, c,
                   static_cast<int>(kv_tiles), ds_ld, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_dq = sizeof(float) *
      (2 * kDqRows * kDsLd + 2 * kBwdRows * ld);
  err = cudaFuncSetAttribute(flash_attention_bwd_dq<T, kC, kWays>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dq<T, kC, kWays>
      <<<static_cast<unsigned>(q_tiles * batch), kBwdThreads, smem_dq,
         stream>>>(ds, kt, static_cast<T*>(dq), n, c,
                   static_cast<int>(q_tiles), ds_ld, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous [batch, n, c] device buffers of one dtype
// (0 = float32, 1 = bfloat16), 16-byte aligned. c is a multiple of 8 up to
// 512. lse is null or an fp32 [batch, n] buffer that receives each row's
// log-sum-exp of the scaled logits. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       int batch, int n, int c, float scale,
                                       int dtype, void* stream) {
  if (batch < 1 || n < 1 || c < 8 || c > kMaxC || c % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // C = 256 (every 32^2 NCSN++ attention) and C = 512 get their own
  // instantiations, with all offsets known to the compiler.
  if (c <= ways_max_c<2>()) {
    if (dtype == 0 && c == 256)
      return launch<float, 256, 2>(q, k, v, o, lse, batch, n, c, scale, s);
    if (dtype == 0)
      return launch<float, 0, 2>(q, k, v, o, lse, batch, n, c, scale, s);
    if (dtype == 1)
      return launch<__nv_bfloat16, 0, 2>(q, k, v, o, lse, batch, n, c, scale,
                                         s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0 && c == 512)
    return launch<float, 512, 4>(q, k, v, o, lse, batch, n, c, scale, s);
  if (dtype == 0)
    return launch<float, 0, 4>(q, k, v, o, lse, batch, n, c, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 0, 4>(q, k, v, o, lse, batch, n, c, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Number of fp32 elements of the backward's scratch for [batch, n, c]:
// dS as [batch, n, ld] with ld = n rounded up to 32, then D as [batch, n].
extern "C" long long flash_attention_backward_scratch(int batch, int n) {
  const long long ld = (n + kBwdRows - 1) / kBwdRows * kBwdRows;
  return static_cast<long long>(batch) * n * (ld + 1);
}

// Gradients of the forward above. q, k, v, o (the forward's output), dout,
// dq, dk, dv: contiguous [batch, n, c] buffers of one dtype, 16-byte
// aligned; lse: the forward's fp32 [batch, n] log-sum-exp; scratch: fp32,
// 16-byte aligned, of flash_attention_backward_scratch(batch, n) elements.
// Three launches on `stream`; returns the first non-zero
// cudaGetLastError(), or 0.
extern "C" int flash_attention_backward(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const float* lse,
                                        float* scratch, void* dq, void* dk,
                                        void* dv, int batch, int n, int c,
                                        float scale, int dtype, void* stream) {
  if (batch < 1 || n < 1 || c < 8 || c > kMaxC || c % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= ways_max_c<2>()) {
    if (dtype == 0 && c == 256)
      return launch_backward<float, 256, 2>(q, k, v, o, dout, lse, scratch,
                                            dq, dk, dv, batch, n, c, scale, s);
    if (dtype == 0)
      return launch_backward<float, 0, 2>(q, k, v, o, dout, lse, scratch, dq,
                                          dk, dv, batch, n, c, scale, s);
    if (dtype == 1)
      return launch_backward<__nv_bfloat16, 0, 2>(
          q, k, v, o, dout, lse, scratch, dq, dk, dv, batch, n, c, scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0 && c == 512)
    return launch_backward<float, 512, 4>(q, k, v, o, dout, lse, scratch, dq,
                                          dk, dv, batch, n, c, scale, s);
  if (dtype == 0)
    return launch_backward<float, 0, 4>(q, k, v, o, dout, lse, scratch, dq,
                                        dk, dv, batch, n, c, scale, s);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16, 0, 4>(
        q, k, v, o, dout, lse, scratch, dq, dk, dv, batch, n, c, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
