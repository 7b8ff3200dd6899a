// Single-head flash attention, forward and backward, for Hopper (sm_90a),
// fp32 and bf16. The backward is described above its kernels, below.
//
// The forward replaces the Pallas TPU kernel
// score_sde_pytorch_tpu/ops/attention.py:flash_attention (body
// _flash_kernel). It computes the same function,
// softmax(q k^T * C^-1/2) v over q, k, v of shape [B, N, C], with an online
// softmax over KV tiles: fp32 running max, running sum and accumulator, the
// logits never written to device memory, and the output cast to the input
// dtype.
//
// What bounds it on this card. At the NCSN++ shapes (N = 256 or 16, C = 256)
// the logits are small (N x N per image) and the work is two products of
// 4 B N^2 C flops in all. Every q, k, v row is read from device memory once
// per query tile, so the reads are B N C (1 + 2 N / BQ) elements: at N = 256,
// BQ = 64 that is about 9 B N C, under a tenth of a millisecond of HBM time
// at batch 64. The products run in fp32 FMAs on the CUDA cores (TF32 or bf16
// tensor cores would break the 2e-5 agreement with the fp32 reference), so
// the kernel is bounded by the shared-memory loads that feed those FMAs: in
// P V a thread does 64 FMAs per 20 loads, below the 4 FMAs per load at which
// an SM's FMA rate, not its shared-memory bandwidth, would be the limit.
// (Reading V and P as float4 did not help: a 128-bit load shared by two
// half warps still costs four wavefronts, and the kernel ran 26% slower on
// an H100 80GB HBM3 at 700 W.) Operands from registers, through mma.sync or
// wgmma, are the way past this bound.
//
// What the design does about it:
// - One block per (batch, query tile of BQ = 64 rows); a loop over KV tiles
//   of BK = 32 rows inside the block replaces the TPU grid's sequential
//   third axis. The tile count is ceil(N / BQ) * B: at B = 64, N = 256 that
//   is 256 blocks for 132 SMs.
// - The query tile stays in shared memory for the whole loop, as fp32
//   (64 x (C + 4) floats, 66 KB at C = 256). K and V tiles (32 rows each)
//   are staged beside it, and the probabilities of one tile (64 x 33).
//   About 141 KB of dynamic shared memory at C = 256, so the launcher raises
//   the per-kernel limit with cudaFuncSetAttribute.
// - Each thread keeps a 4 x 2 block of logits and a 4 x (C / 16) block of
//   the output accumulator in registers; Q and K are read as float4, with
//   rows padded by 4 floats so that the K reads of a quarter warp fall in
//   distinct banks.
// - Ragged tiles are masked: K/V rows past N load as zeros and their logits
//   as -inf, query rows past N compute but are not stored. Any N >= 1 works.
// - When the backward will run, the kernel also writes each row's
//   log-sum-exp m + log(l): one fp32 store per row.
// - bf16 inputs are widened to fp32 as they are staged; all arithmetic is
//   fp32; the output is rounded once.
// Not done yet (later work): wgmma/TMA, double-buffered K/V loads, and
// tensor-core products for bf16.
//
// Built by score_sde_pytorch_tpu_torch/ops/build.py with nvcc into a shared
// library; the C entry point at the bottom is bound through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;             // query rows per block
constexpr int kBlockK = 32;             // key/value rows per KV tile
constexpr int kThreads = 256;
constexpr int kThreadsX = 16;           // threads along a row (columns)
constexpr int kThreadsY = kThreads / kThreadsX;    // 16 threads down the rows
constexpr int kRows = kBlockQ / kThreadsY;         // 4 query rows per thread
constexpr int kLogitCols = kBlockK / kThreadsX;    // 2 logit columns per thread
constexpr int kMaxC = 256;
constexpr int kOutCols = kMaxC / kThreadsX;        // up to 16 output columns per thread

__device__ __forceinline__ void load8(const float* src, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* dst, float value) { *dst = value; }

__device__ __forceinline__ void store(__nv_bfloat16* dst, float value) {
  *dst = __float2bfloat16_rn(value);
}

// Stages rows [row0, row0 + rows) of a row-major [n, c] matrix into shared
// memory as fp32 with row stride `stride`; rows at or past n become zeros.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          float* dst, int rows, int row0,
                                          int n, int c, int stride) {
  const int chunks = c / 8;
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int r = e / chunks;
    const int col = (e - r * chunks) * 8;
    float vals[8];
    if (row0 + r < n) {
      load8(src + static_cast<size_t>(row0 + r) * c + col, vals);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) vals[i] = 0.f;
    }
    float4* out = reinterpret_cast<float4*>(dst + r * stride + col);
    out[0] = make_float4(vals[0], vals[1], vals[2], vals[3]);
    out[1] = make_float4(vals[4], vals[5], vals[6], vals[7]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_fwd(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, int n, int c, int q_tiles,
                    float scale) {
  extern __shared__ __align__(16) float smem[];
  const int qk_stride = c + 4;
  const int v_stride = c;
  const int p_stride = kBlockK + 1;
  float* q_s = smem;
  float* k_s = q_s + kBlockQ * qk_stride;
  float* v_s = k_s + kBlockK * qk_stride;
  float* p_s = v_s + kBlockK * v_stride;

  const int batch = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - batch * q_tiles) * kBlockQ;
  const size_t base = static_cast<size_t>(batch) * n * c;
  const int tx = threadIdx.x % kThreadsX;
  const int ty = threadIdx.x / kThreadsX;

  load_tile(q + base, q_s, kBlockQ, q0, n, c, qk_stride);

  float m[kRows];
  float l[kRows];
  float acc[kRows][kOutCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // the previous tile's k_s, v_s and p_s are consumed
    load_tile(k + base, k_s, kBlockK, k0, n, c, qk_stride);
    load_tile(v + base, v_s, kBlockK, k0, n, c, v_stride);
    __syncthreads();

    // Logits for rows ty + 16 i and tile columns tx + 16 j. Each logit
    // keeps four partial sums (channels cc mod 4), added at the end: four
    // independent FMA chains per logit, and a rounding error of about half
    // that of one sequential sum over C.
    float4 part[kRows][kLogitCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kLogitCols; ++j)
        part[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int cc = 0; cc < c; cc += 4) {
      float4 qv[kRows];
      float4 kv[kLogitCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            q_s + (ty + kThreadsY * i) * qk_stride + cc);
#pragma unroll
      for (int j = 0; j < kLogitCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            k_s + (tx + kThreadsX * j) * qk_stride + cc);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kLogitCols; ++j) {
          part[i][j].x = fmaf(qv[i].x, kv[j].x, part[i][j].x);
          part[i][j].y = fmaf(qv[i].y, kv[j].y, part[i][j].y);
          part[i][j].z = fmaf(qv[i].z, kv[j].z, part[i][j].z);
          part[i][j].w = fmaf(qv[i].w, kv[j].w, part[i][j].w);
        }
    }
    float s[kRows][kLogitCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kLogitCols; ++j)
        s[i][j] = (part[i][j].x + part[i][j].y) + (part[i][j].z + part[i][j].w);

    // Online softmax. The 16 threads of a half warp share a row, so row
    // reductions are xor shuffles over lane offsets 8, 4, 2, 1; every lane
    // ends with the same row max and sum.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kLogitCols; ++j) {
        const bool valid = k0 + tx + kThreadsX * j < n;
        s[i][j] = valid ? s[i][j] * scale : -INFINITY;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = kThreadsX / 2; off > 0; off /= 2)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      // Every tile holds at least one valid column, so m_new is finite.
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kLogitCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + kThreadsY * i) * p_stride + tx + kThreadsX * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = kThreadsX / 2; off > 0; off /= 2)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V for rows ty + 16 i and output columns tx + 16 j.
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        p[i] = p_s[(ty + kThreadsY * i) * p_stride + kk];
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) {
        const int col = tx + kThreadsX * j;
        if (col < c) {
          const float vv = v_s[kk * v_stride + col];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kThreadsY * i;
    if (row >= n) continue;
    T* out_row = o + base + static_cast<size_t>(row) * c;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) {
      const int col = tx + kThreadsX * j;
      if (col < c) store(out_row + col, acc[i][j] / l[i]);
    }
    // The backward recomputes P = exp(S - lse) from this row statistic.
    if (lse != nullptr && tx == 0)
      lse[static_cast<size_t>(batch) * n + row] = m[i] + logf(l[i]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int n, int c, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kBlockQ) * (c + 4) + kBlockK * (c + 4) +
       kBlockK * c + kBlockQ * (kBlockK + 1));
  const long long q_tiles = (n + kBlockQ - 1) / kBlockQ;
  const long long blocks = q_tiles * batch;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_fwd<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, n, c,
      static_cast<int>(q_tiles), scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward (FlashAttention-2 shape, _flash_bwd_impl's numerics).
//
// Replaces score_sde_pytorch_tpu/ops/attention.py:_flash_bwd_impl (jnp,
// wired in through custom_vjp). With P = exp(S - lse), the forward's row
// log-sum-exp, and D = rowsum(dO o O):
//   dS = P o (dO V^T - D),  dQ = scale dS K,  dK = scale dS^T Q,  dV = P^T dO.
// Three launches per call, all on one stream:
// 1. attention_bwd_delta: D, one warp per row, into an fp32 [B, N] scratch.
// 2. flash_attention_bwd_dkdv: one block per (batch, KV tile of 32 rows); a
//    loop over query tiles recomputes S and dP for the tile pair and adds
//    P^T dO and dS^T Q into register accumulators (2 rows x C/16 columns of
//    each per thread: 64 floats at C = 256).
// 3. flash_attention_bwd_dq: one block per (batch, query tile of 32 rows); a
//    loop over KV tiles adds dS K.
// Each output row is written by exactly one block, so there are no atomics
// and the result is deterministic. S is computed by the same four-partial
// FMA chains as the forward, so exp(S * scale - lse) sums to 1 over a row.
//
// What bounds it: as in the forward, fp32 FMAs fed from shared memory. Both
// tile loops do 2 x 32-row logit products (S and dP) per tile pair, and the
// accumulation does 64 FMAs per 36 shared-memory loads in kernel 2 and 32
// per 18 in kernel 3. Shared memory at C = 256 is four fp32 tiles of
// 32 x (C + 4) (K, V, Q, dO: 133 KB) plus the P and dS tiles, about 142 KB,
// raised with cudaFuncSetAttribute. Later work: tensor-core products
// (3xTF32 or bf16 mma), a fused dQ pass with atomics, larger tiles.
// ---------------------------------------------------------------------------

constexpr int kBwdRows = 32;            // rows of every tile in the backward
constexpr int kPStride = kBwdRows + 1;  // P and dS rows, padded for banks

// out[a][b] = x_s row (ty + 16 a) . y_s row (tx + 16 b), with the forward's
// four partial sums per dot product, so S is bitwise the forward's logit.
__device__ __forceinline__ void dot_block(const float* x_s, const float* y_s,
                                          int stride, int c, int tx, int ty,
                                          float out[2][2]) {
  float4 part[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) part[a][b] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int cc = 0; cc < c; cc += 4) {
    float4 xv[2];
    float4 yv[2];
#pragma unroll
    for (int a = 0; a < 2; ++a)
      xv[a] = *reinterpret_cast<const float4*>(
          x_s + (ty + kThreadsY * a) * stride + cc);
#pragma unroll
    for (int b = 0; b < 2; ++b)
      yv[b] = *reinterpret_cast<const float4*>(
          y_s + (tx + kThreadsX * b) * stride + cc);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        part[a][b].x = fmaf(xv[a].x, yv[b].x, part[a][b].x);
        part[a][b].y = fmaf(xv[a].y, yv[b].y, part[a][b].y);
        part[a][b].z = fmaf(xv[a].z, yv[b].z, part[a][b].z);
        part[a][b].w = fmaf(xv[a].w, yv[b].w, part[a][b].w);
      }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      out[a][b] = (part[a][b].x + part[a][b].y) + (part[a][b].z + part[a][b].w);
}

// Stages lse and D of query rows [row0, row0 + 32) into shared memory.
__device__ __forceinline__ void load_row_stats(const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               float* lse_s, float* d_s,
                                               int row0, int n) {
  if (threadIdx.x < kBwdRows) {
    const int row = row0 + threadIdx.x;
    lse_s[threadIdx.x] = row < n ? lse[row] : 0.f;
    d_s[threadIdx.x] = row < n ? delta[row] : 0.f;
  }
}

// P and dS of the (query tile q0, KV tile k0) pair for this thread's 2 x 2
// logits (query rows ty + 16 a, KV rows tx + 16 b); masked entries are 0.
__device__ __forceinline__ void tile_p_ds(const float* q_s, const float* k_s,
                                          const float* do_s, const float* v_s,
                                          const float* lse_s, const float* d_s,
                                          int stride, int c, int q0, int k0,
                                          int n, float scale, int tx, int ty,
                                          float* p_s, float* ds_s) {
  float s[2][2];
  float dp[2][2];
  dot_block(q_s, k_s, stride, c, tx, ty, s);
  dot_block(do_s, v_s, stride, c, tx, ty, dp);
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int i = ty + kThreadsY * a;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int j = tx + kThreadsX * b;
      const bool valid = q0 + i < n && k0 + j < n;
      const float p = valid ? expf(s[a][b] * scale - lse_s[i]) : 0.f;
      if (p_s != nullptr) p_s[i * kPStride + j] = p;
      ds_s[i * kPStride + j] = p * (dp[a][b] - d_s[i]);
    }
  }
}

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
  for (int col = lane * 8; col < c; col += 32 * 8) {
    float ov[8];
    float dv[8];
    load8(o_row + col, ov);
    load8(do_row + col, dv);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum = fmaf(ov[e], dv[e], sum);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int n, int c, int kv_tiles,
                         float scale) {
  extern __shared__ __align__(16) float smem[];
  const int stride = c + 4;
  float* k_s = smem;
  float* v_s = k_s + kBwdRows * stride;
  float* q_s = v_s + kBwdRows * stride;
  float* do_s = q_s + kBwdRows * stride;
  float* p_s = do_s + kBwdRows * stride;
  float* ds_s = p_s + kBwdRows * kPStride;
  float* lse_s = ds_s + kBwdRows * kPStride;
  float* d_s = lse_s + kBwdRows;

  const int batch = blockIdx.x / kv_tiles;
  const int k0 = (blockIdx.x - batch * kv_tiles) * kBwdRows;
  const size_t base = static_cast<size_t>(batch) * n * c;
  const size_t row_base = static_cast<size_t>(batch) * n;
  const int tx = threadIdx.x % kThreadsX;
  const int ty = threadIdx.x / kThreadsX;

  load_tile(k + base, k_s, kBwdRows, k0, n, c, stride);
  load_tile(v + base, v_s, kBwdRows, k0, n, c, stride);

  float dk_acc[2][kOutCols];
  float dv_acc[2][kOutCols];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int m = 0; m < kOutCols; ++m) dk_acc[a][m] = dv_acc[a][m] = 0.f;

  for (int q0 = 0; q0 < n; q0 += kBwdRows) {
    __syncthreads();  // the previous query tile is consumed
    load_tile(q + base, q_s, kBwdRows, q0, n, c, stride);
    load_tile(dout + base, do_s, kBwdRows, q0, n, c, stride);
    load_row_stats(lse + row_base, delta + row_base, lse_s, d_s, q0, n);
    __syncthreads();
    tile_p_ds(q_s, k_s, do_s, v_s, lse_s, d_s, stride, c, q0, k0, n, scale,
              tx, ty, p_s, ds_s);
    __syncthreads();

    // KV rows ty + 16 a, channels tx + 16 m: dV += P^T dO, dK += dS^T Q.
#pragma unroll 4
    for (int i = 0; i < kBwdRows; ++i) {
      float p[2];
      float ds[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        p[a] = p_s[i * kPStride + ty + kThreadsY * a];
        ds[a] = ds_s[i * kPStride + ty + kThreadsY * a];
      }
#pragma unroll
      for (int m = 0; m < kOutCols; ++m) {
        const int col = tx + kThreadsX * m;
        if (col < c) {
          const float dov = do_s[i * stride + col];
          const float qv = q_s[i * stride + col];
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            dv_acc[a][m] = fmaf(p[a], dov, dv_acc[a][m]);
            dk_acc[a][m] = fmaf(ds[a], qv, dk_acc[a][m]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = k0 + ty + kThreadsY * a;
    if (row >= n) continue;
    T* dk_row = dk + base + static_cast<size_t>(row) * c;
    T* dv_row = dv + base + static_cast<size_t>(row) * c;
#pragma unroll
    for (int m = 0; m < kOutCols; ++m) {
      const int col = tx + kThreadsX * m;
      if (col < c) {
        store(dk_row + col, scale * dk_acc[a][m]);
        store(dv_row + col, dv_acc[a][m]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int n, int c, int q_tiles, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int stride = c + 4;
  float* q_s = smem;
  float* do_s = q_s + kBwdRows * stride;
  float* k_s = do_s + kBwdRows * stride;
  float* v_s = k_s + kBwdRows * stride;
  float* ds_s = v_s + kBwdRows * stride;
  float* lse_s = ds_s + kBwdRows * kPStride;
  float* d_s = lse_s + kBwdRows;

  const int batch = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - batch * q_tiles) * kBwdRows;
  const size_t base = static_cast<size_t>(batch) * n * c;
  const size_t row_base = static_cast<size_t>(batch) * n;
  const int tx = threadIdx.x % kThreadsX;
  const int ty = threadIdx.x / kThreadsX;

  load_tile(q + base, q_s, kBwdRows, q0, n, c, stride);
  load_tile(dout + base, do_s, kBwdRows, q0, n, c, stride);
  load_row_stats(lse + row_base, delta + row_base, lse_s, d_s, q0, n);

  float dq_acc[2][kOutCols];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int m = 0; m < kOutCols; ++m) dq_acc[a][m] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBwdRows) {
    __syncthreads();  // the previous KV tile and dS are consumed
    load_tile(k + base, k_s, kBwdRows, k0, n, c, stride);
    load_tile(v + base, v_s, kBwdRows, k0, n, c, stride);
    __syncthreads();
    tile_p_ds(q_s, k_s, do_s, v_s, lse_s, d_s, stride, c, q0, k0, n, scale,
              tx, ty, nullptr, ds_s);
    __syncthreads();

    // Query rows ty + 16 a, channels tx + 16 m: dQ += dS K.
#pragma unroll 4
    for (int j = 0; j < kBwdRows; ++j) {
      float ds[2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        ds[a] = ds_s[(ty + kThreadsY * a) * kPStride + j];
#pragma unroll
      for (int m = 0; m < kOutCols; ++m) {
        const int col = tx + kThreadsX * m;
        if (col < c) {
          const float kv = k_s[j * stride + col];
#pragma unroll
          for (int a = 0; a < 2; ++a)
            dq_acc[a][m] = fmaf(ds[a], kv, dq_acc[a][m]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = q0 + ty + kThreadsY * a;
    if (row >= n) continue;
    T* dq_row = dq + base + static_cast<size_t>(row) * c;
#pragma unroll
    for (int m = 0; m < kOutCols; ++m) {
      const int col = tx + kThreadsX * m;
      if (col < c) store(dq_row + col, scale * dq_acc[a][m]);
    }
  }
}

template <typename T>
int launch_backward(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    float* delta, void* dq, void* dk, void* dv, int batch,
                    int n, int c, float scale, cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * n;
  const long long delta_blocks = (rows * 32 + kThreads - 1) / kThreads;
  const long long tiles = (n + kBwdRows - 1) / kBwdRows;
  const long long blocks = tiles * batch;
  if (blocks > 0x7fffffffLL || delta_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);

  attention_bwd_delta<T><<<static_cast<unsigned>(delta_blocks), kThreads, 0,
                           stream>>>(static_cast<const T*>(o), dot, delta,
                                     rows, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t tile_floats = static_cast<size_t>(kBwdRows) * (c + 4);
  const size_t smem_dkdv = sizeof(float) *
      (4 * tile_floats + 2 * kBwdRows * kPStride + 2 * kBwdRows);
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dkdv));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dkdv<T><<<static_cast<unsigned>(blocks), kThreads,
                                smem_dkdv, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      n, c, static_cast<int>(tiles), scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_dq = sizeof(float) *
      (4 * tile_floats + kBwdRows * kPStride + 2 * kBwdRows);
  err = cudaFuncSetAttribute(flash_attention_bwd_dq<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dq<T><<<static_cast<unsigned>(blocks), kThreads,
                              smem_dq, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), n, c,
      static_cast<int>(tiles), scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous [batch, n, c] device buffers of one dtype
// (0 = float32, 1 = bfloat16), 16-byte aligned. c is a multiple of 8 up to
// 256. lse is null or an fp32 [batch, n] buffer that receives each row's
// log-sum-exp of the scaled logits. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       int batch, int n, int c, float scale,
                                       int dtype, void* stream) {
  if (batch < 1 || n < 1 || c < 8 || c > kMaxC || c % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, lse, batch, n, c, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, lse, batch, n, c, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Gradients of the forward above. q, k, v, o (the forward's output), dout,
// dq, dk, dv: contiguous [batch, n, c] buffers of one dtype, 16-byte
// aligned; lse: the forward's fp32 [batch, n] log-sum-exp; delta: fp32
// [batch, n] scratch. Three launches on `stream`; returns the first
// non-zero cudaGetLastError(), or 0.
extern "C" int flash_attention_backward(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const float* lse,
                                        float* delta, void* dq, void* dk,
                                        void* dv, int batch, int n, int c,
                                        float scale, int dtype, void* stream) {
  if (batch < 1 || n < 1 || c < 8 || c > kMaxC || c % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_backward<float>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  batch, n, c, scale, s);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq,
                                          dk, dv, batch, n, c, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
