// Single-head flash attention forward for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the Pallas TPU kernel score_sde_pytorch_tpu/ops/attention.py:
// flash_attention (body _flash_kernel). It computes the same function,
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
                    const T* __restrict__ v, T* __restrict__ o, int n, int c,
                    int q_tiles, float scale) {
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
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int n, int c, float scale, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(o), n, c,
      static_cast<int>(q_tiles), scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous [batch, n, c] device buffers of one dtype
// (0 = float32, 1 = bfloat16), 16-byte aligned. c is a multiple of 8 up to
// 256. Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, int batch,
                                       int n, int c, float scale, int dtype,
                                       void* stream) {
  if (batch < 1 || n < 1 || c < 8 || c > kMaxC || c % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, batch, n, c, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, batch, n, c, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
