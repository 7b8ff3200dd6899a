// GroupNorm with an optional swish after it, forward and backward, for
// Hopper (sm_90a), fp32 and bf16, contiguous [B, C, S] (S = H * W).
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm and swish to
// XLA, which fuses them. In PyTorch they are some ten passes over each
// activation forward (two means, x*x, the broadcast x*a and + shift, silu)
// and some twenty-five backward (score_sde_pytorch_tpu_torch/ops/
// group_norm.py has the plain version, which the CPU runs).
//
// What it computes, per group (b, g) of N = C/G * S elements (times the
// ranks of a space group), in the plain version's rounding:
//   mean = sum(x) / N, var = sum(x*x) / N - mean*mean (fp32, unclamped)
//   rstd = rsqrt(max(var, 0) + eps)
//   a_c = rstd * gamma_c, b_c = beta_c - (mean * rstd) * gamma_c
//   u = x * a_c + b_c   (multiply and add rounded apart, as the plain path)
//   y = act(u cast to x's dtype); in bf16 the swish rounds every step to
//   bf16 as x * (1 / (1 + exp(-x))), in fp32 it is x / (1 + exp(-x)).
// Backward, with dyu = dy * act'(u) and xhat = (x - mean) * rstd:
//   dbeta_bc = sum_c dyu, dgamma_bc = sum_c dyu * xhat (per (b, c), then
//   summed over b in a fixed order)
//   m1 = sum_g gamma_c * dbeta_bc / N, m2 = sum_g gamma_c * dgamma_bc / N
//   dx = rstd * (gamma_c * dyu - m1 - xhat * m2 * [var >= 0])
// where [var >= 0] is the clamp's gradient gate.
//
// What bounds it on this card: device memory. A few operations per byte
// moved, far below the ~20 flops per byte at which fp32 would bound it.
// What the design does about it, in two paths that the wrapper picks from
// the group's size:
//   on-chip (a group of at most 4096 vectors of 4 elements): one block per
//   group holds the group in registers; the forward reads x once and
//   writes y once; the backward reads x and dy once and writes dx once,
//   with one per-(b, c) partial of dgamma and dbeta in a [B, C] scratch;
//   split (larger groups, and every group under a space group): many
//   blocks per group; the forward is a stats pass and an apply pass (x read
//   twice); the backward a reduction pass and a dx pass (x and dy read
//   twice), with the space group's all-reduce between the two passes.
// Every sum is taken in a fixed order (warp shuffles, then warps in
// order); no atomics, so runs and CUDA-graph replays are bit-reproducible.
// Kernels use only their launch arguments and torch-allocated buffers and
// need no attribute set (dynamic shared memory stays under 48 KiB), so
// they are legal under stream capture.
//
// Built by score_sde_pytorch_tpu_torch/ops/build.py with nvcc into a shared
// library; the C entry points at the bottom are bound through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Elements per vector: every load and store moves 4 (S is a multiple of 4).
constexpr int W = 4;
constexpr int kSplitThreads = 256;
constexpr int kReduceThreads = 128;
constexpr int kMaxOnchipThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// v rounded to T and back: the plain path's cast to x's dtype.
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

// W consecutive elements as floats: one 16-byte load in fp32, one 8-byte
// load in bf16.
template <typename T>
__device__ __forceinline__ void load(const T* p, float* v) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  } else {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
}

template <typename T>
__device__ __forceinline__ void store(T* p, const float* v) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 r;
    r.x = *reinterpret_cast<unsigned*>(&lo);
    r.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = r;
  }
}

// act(u): u cast to T, then the swish as the plain path computes it in T.
template <typename T>
__device__ __forceinline__ float act(float u, int swish) {
  const float v = rnd<T>(u);
  if (!swish) return v;
  if constexpr (std::is_same<T, float>::value) {
    return v / (1.f + expf(-v));  // F.silu's arithmetic
  } else {
    const float e = rnd<T>(expf(-v));
    const float d = rnd<T>(1.f + e);
    const float r = rnd<T>(1.f / d);
    return rnd<T>(v * r);
  }
}

// d act / d u at u, taken at u cast to T (the value the swish saw).
template <typename T>
__device__ __forceinline__ float act_grad(float u) {
  const float v = rnd<T>(u);
  const float s = 1.f / (1.f + expf(-v));
  return s * (1.f + v * (1.f - s));
}

__device__ __forceinline__ float2 warp_sum2(float a, float b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
  return make_float2(a, b);
}

// The block's sums of a and b, on every thread, in a fixed order: a
// butterfly in each warp, then the warps' sums in warp 0. blockDim.x is a
// multiple of 32; red holds 33 entries.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float2 v = warp_sum2(a, b);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : make_float2(0.f, 0.f);
    v = warp_sum2(v.x, v.y);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();  // red is free again
  return v;
}

// The sum of p[0, count) on every thread, in a fixed order: warp 0's lanes
// take every 32nd entry, then a butterfly.
__device__ __forceinline__ float2 sum_in_order(const float2* p, int count,
                                               float2* red) {
  if (threadIdx.x < 32) {
    float a = 0.f, b = 0.f;
    for (int j = threadIdx.x; j < count; j += 32) {
      a += p[j].x;
      b += p[j].y;
    }
    const float2 t = warp_sum2(a, b);
    if (threadIdx.x == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// (mean, var) from the group's (sum, sum of squares) over n elements, as
// the plain path rounds them: var = E[x^2] - mean^2, unclamped.
__device__ __forceinline__ float2 moments(float2 sums, float n) {
  const float mean = sums.x / n;
  return make_float2(mean, __fsub_rn(sums.y / n, __fmul_rn(mean, mean)));
}

__device__ __forceinline__ float rstd_of(float2 st, float eps) {
  return rsqrtf(fmaxf(st.y, 0.f) + eps);
}

// Channel c's folded affine: u = x * a + b.
struct Affine {
  float g, a, b;
};

__device__ __forceinline__ Affine affine(const float* __restrict__ gamma,
                                         const float* __restrict__ beta,
                                         int c, float rstd, float mr) {
  const float g = gamma[c];
  return {g, __fmul_rn(rstd, g), __fsub_rn(beta[c], __fmul_rn(mr, g))};
}

__device__ __forceinline__ float folded(float x, const Affine& f) {
  return __fadd_rn(__fmul_rn(x, f.a), f.b);
}

// dy * act'(u) for one element.
template <typename T>
__device__ __forceinline__ float dyu(float x, float dy, const Affine& f,
                                     int swish) {
  return swish ? dy * act_grad<T>(folded(x, f)) : dy;
}

// ---- on-chip path: one block per group (b, g), the group in registers.

// Vectors of the group at thread t: t, t + blockDim.x, ..., K of them.
template <typename T, int K>
__global__ void __launch_bounds__(kMaxOnchipThreads)
onchip_fwd(const T* __restrict__ x, const float* __restrict__ gamma,
           const float* __restrict__ beta, T* __restrict__ y,
           float2* __restrict__ stats, int G, int Cg, int S, float n,
           float eps, int swish) {
  __shared__ float2 red[33];
  const long long bg = blockIdx.x;
  const int nv = Cg * S / W;
  const long long base = bg * Cg * S;
  float v[K][W];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nv) {
      load(x + base + (long long)i * W, v[k]);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        s += v[k][w];
        ss += v[k][w] * v[k][w];
      }
    }
  }
  const float2 st = moments(block_sum2(s, ss, red), n);
  if (threadIdx.x == 0) stats[bg] = st;
  const float rstd = rstd_of(st, eps), mr = __fmul_rn(st.x, rstd);
  const int c0 = (int)(bg % G) * Cg;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nv) {
      const Affine f = affine(gamma, beta, c0 + i * W / S, rstd, mr);
      float out[W];
#pragma unroll
      for (int w = 0; w < W; ++w) out[w] = act<T>(folded(v[k][w], f), swish);
      store(y + base + (long long)i * W, out);
    }
  }
}

// dx of the group, and its channels' (dbeta, dgamma) into chan[b * C + c].
// Dynamic shared memory: one float2 per vector.
template <typename T, int K>
__global__ void __launch_bounds__(kMaxOnchipThreads)
onchip_bwd(const T* __restrict__ x, const T* __restrict__ dy,
           const float* __restrict__ gamma, const float* __restrict__ beta,
           const float2* __restrict__ stats, T* __restrict__ dx,
           float2* __restrict__ chan, int G, int Cg, int S, float n,
           float eps, int swish) {
  extern __shared__ float2 part[];
  __shared__ float2 red[33];
  const long long bg = blockIdx.x;
  const int nv = Cg * S / W;
  const long long base = bg * Cg * S;
  const float2 st = stats[bg];
  const float rstd = rstd_of(st, eps), mr = __fmul_rn(st.x, rstd);
  const int c0 = (int)(bg % G) * Cg;
  float xh[K][W], dxh[K][W];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nv) {
      float xv[W], dv[W];
      load(x + base + (long long)i * W, xv);
      load(dy + base + (long long)i * W, dv);
      const Affine f = affine(gamma, beta, c0 + i * W / S, rstd, mr);
      float pb = 0.f, pg = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float du = dyu<T>(xv[w], dv[w], f, swish);
        const float h = (xv[w] - st.x) * rstd;
        pb += du;
        pg += du * h;
        xh[k][w] = h;
        dxh[k][w] = f.g * du;
      }
      part[i] = make_float2(pb, pg);
      s1 += f.g * pb;
      s2 += f.g * pg;
    }
  }
  const float2 tot = block_sum2(s1, s2, red);  // its barrier publishes part
  const float m1 = tot.x / n, m2 = st.y >= 0.f ? tot.y / n : 0.f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int vc = S / W;
  for (int c = warp; c < Cg; c += blockDim.x >> 5) {
    float a = 0.f, b = 0.f;
    for (int j = lane; j < vc; j += 32) {
      a += part[c * vc + j].x;
      b += part[c * vc + j].y;
    }
    const float2 t = warp_sum2(a, b);
    if (lane == 0) chan[bg * Cg + c] = t;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nv) {
      float out[W];
#pragma unroll
      for (int w = 0; w < W; ++w)
        out[w] = rstd * (dxh[k][w] - m1 - xh[k][w] * m2);
      store(dx + base + (long long)i * W, out);
    }
  }
}

// ---- split path: grid (group, chunk); each block a chunk of the group.

template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
split_stats(const T* __restrict__ x, float2* __restrict__ partial, int L,
            int chunk, int P) {
  __shared__ float2 red[33];
  const long long bg = blockIdx.x;
  const int p = blockIdx.y;
  const T* xg = x + bg * L;
  const int end = min(L, (p + 1) * chunk);
  float s = 0.f, ss = 0.f;
  for (int i = p * chunk + threadIdx.x * W; i < end; i += blockDim.x * W) {
    float v[W];
    load(xg + i, v);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      s += v[w];
      ss += v[w] * v[w];
    }
  }
  const float2 t = block_sum2(s, ss, red);
  if (threadIdx.x == 0) partial[bg * P + p] = t;
}

// Each block sums its group's P partials itself (all in the same order).
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
split_apply(const T* __restrict__ x, const float* __restrict__ gamma,
            const float* __restrict__ beta, const float2* __restrict__ partial,
            T* __restrict__ y, float2* __restrict__ stats, int G, int Cg,
            int S, int chunk, int P, float n, float eps, int swish) {
  __shared__ float2 red[33];
  const long long bg = blockIdx.x;
  const int p = blockIdx.y;
  const float2 st = moments(sum_in_order(partial + bg * P, P, red), n);
  if (p == 0 && threadIdx.x == 0) stats[bg] = st;
  const float rstd = rstd_of(st, eps), mr = __fmul_rn(st.x, rstd);
  const int c0 = (int)(bg % G) * Cg, L = Cg * S;
  const long long base = bg * L;
  const int end = min(L, (p + 1) * chunk);
  for (int i = p * chunk + threadIdx.x * W; i < end; i += blockDim.x * W) {
    const Affine f = affine(gamma, beta, c0 + i / S, rstd, mr);
    float v[W];
    load(x + base + i, v);
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = act<T>(folded(v[w], f), swish);
    store(y + base + i, v);
  }
}

// grid (b * C + c, chunk of the channel): the chunk's (dbeta, dgamma).
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
split_bwd_reduce(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta,
                 const float2* __restrict__ stats, float2* __restrict__ part,
                 int G, int Cg, int S, int chunk, int Pc, float eps,
                 int swish) {
  __shared__ float2 red[33];
  const long long bc = blockIdx.x;
  const int p = blockIdx.y;
  const long long bg = bc / Cg;
  const float2 st = stats[bg];
  const float rstd = rstd_of(st, eps), mr = __fmul_rn(st.x, rstd);
  const Affine f = affine(gamma, beta, (int)(bg % G) * Cg + (int)(bc % Cg),
                          rstd, mr);
  const long long base = bc * S;
  const int end = min(S, (p + 1) * chunk);
  float pb = 0.f, pg = 0.f;
  for (int i = p * chunk + threadIdx.x * W; i < end; i += blockDim.x * W) {
    float xv[W], dv[W];
    load(x + base + i, xv);
    load(dy + base + i, dv);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float du = dyu<T>(xv[w], dv[w], f, swish);
      pb += du;
      pg += du * ((xv[w] - st.x) * rstd);
    }
  }
  const float2 t = block_sum2(pb, pg, red);
  if (threadIdx.x == 0) part[bc * Pc + p] = t;
}

// One block per group: its channels' totals into chan, and
// sum_c gamma_c * (dbeta_bc, dgamma_bc) into gsum.
__global__ void __launch_bounds__(kReduceThreads)
split_bwd_finalize(const float* __restrict__ gamma,
                   const float2* __restrict__ part, float2* __restrict__ chan,
                   float2* __restrict__ gsum, int G, int Cg, int Pc) {
  __shared__ float2 red[33];
  const long long bg = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = (int)(bg % G) * Cg;
  float s1 = 0.f, s2 = 0.f;
  for (int c = warp; c < Cg; c += blockDim.x >> 5) {
    const float2* pc = part + (bg * Cg + c) * Pc;
    float a = 0.f, b = 0.f;
    for (int j = lane; j < Pc; j += 32) {
      a += pc[j].x;
      b += pc[j].y;
    }
    const float2 t = warp_sum2(a, b);
    if (lane == 0) {
      chan[bg * Cg + c] = t;
      s1 += gamma[c0 + c] * t.x;
      s2 += gamma[c0 + c] * t.y;
    }
  }
  const float2 t = block_sum2(s1, s2, red);
  if (threadIdx.x == 0) gsum[bg] = t;
}

template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
split_bwd_dx(const T* __restrict__ x, const T* __restrict__ dy,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             const float2* __restrict__ stats, const float2* __restrict__ gsum,
             T* __restrict__ dx, int G, int Cg, int S, int chunk, float n,
             float eps, int swish) {
  const long long bg = blockIdx.x;
  const int p = blockIdx.y;
  const float2 st = stats[bg], gs = gsum[bg];
  const float rstd = rstd_of(st, eps), mr = __fmul_rn(st.x, rstd);
  const float m1 = gs.x / n, m2 = st.y >= 0.f ? gs.y / n : 0.f;
  const int c0 = (int)(bg % G) * Cg, L = Cg * S;
  const long long base = bg * L;
  const int end = min(L, (p + 1) * chunk);
  for (int i = p * chunk + threadIdx.x * W; i < end; i += blockDim.x * W) {
    const Affine f = affine(gamma, beta, c0 + i / S, rstd, mr);
    float xv[W], dv[W];
    load(x + base + i, xv);
    load(dy + base + i, dv);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float h = (xv[w] - st.x) * rstd;
      dv[w] = rstd * (f.g * dyu<T>(xv[w], dv[w], f, swish) - m1 - h * m2);
    }
    store(dx + base + i, dv);
  }
}

// dgamma[c], dbeta[c]: chan[., c] summed over the batch in a fixed order.
__global__ void __launch_bounds__(kReduceThreads)
param_reduce(const float2* __restrict__ chan, float* __restrict__ dgamma,
             float* __restrict__ dbeta, int B, int C) {
  __shared__ float2 red[33];
  const int c = blockIdx.x;
  float a = 0.f, b = 0.f;
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    const float2 t = chan[(long long)i * C + c];
    a += t.x;
    b += t.y;
  }
  const float2 t = block_sum2(a, b, red);
  if (threadIdx.x == 0) {
    dbeta[c] = t.x;
    dgamma[c] = t.y;
  }
}

// ---- launchers

int status() { return static_cast<int>(cudaGetLastError()); }

// A vector of 4 elements of the dtype (0 = float32, 1 = bfloat16) at p.
bool aligned(const void* p, int dtype) {
  return reinterpret_cast<uintptr_t>(p) % (dtype == 0 ? 16 : 8) == 0;
}

dim3 grid(long long x, int y = 1) {
  return dim3(static_cast<unsigned>(x), static_cast<unsigned>(y));
}

// Threads of an on-chip block: about 4 vectors each, 32 to 512.
int onchip_threads(int nv) {
  int t = 32;
  while (t < kMaxOnchipThreads && t * 4 < nv) t *= 2;
  return t;
}

int onchip_k(int nv, int threads) {
  int k = 1;
  while (k * threads < nv) k *= 2;
  return k;
}

#define GN_DISPATCH_K(K, ...)                    \
  switch (K) {                                   \
    case 1: { constexpr int KK = 1; __VA_ARGS__; break; } \
    case 2: { constexpr int KK = 2; __VA_ARGS__; break; } \
    case 4: { constexpr int KK = 4; __VA_ARGS__; break; } \
    case 8: { constexpr int KK = 8; __VA_ARGS__; break; } \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

template <typename T>
int forward(int stage, const void* xp, const float* gamma, const float* beta,
            void* yp, float* stats, float* partial, long long groups, int G,
            int Cg, int S, int chunk, int P, float n, float eps, int swish,
            cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  T* y = static_cast<T*>(yp);
  float2* st = reinterpret_cast<float2*>(stats);
  float2* part = reinterpret_cast<float2*>(partial);
  const int L = Cg * S;
  if (stage == 0) {
    const int nv = L / W;
    const int threads = onchip_threads(nv), k = onchip_k(nv, threads);
    GN_DISPATCH_K(k, onchip_fwd<T, KK><<<grid(groups), threads, 0, s>>>(
                         x, gamma, beta, y, st, G, Cg, S, n, eps, swish));
  } else if (stage == 1) {
    split_stats<T><<<grid(groups, P), kSplitThreads, 0, s>>>(x, part, L,
                                                                 chunk, P);
  } else if (stage == 2) {
    split_apply<T><<<grid(groups, P), kSplitThreads, 0, s>>>(
        x, gamma, beta, part, y, st, G, Cg, S, chunk, P, n, eps, swish);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return status();
}

template <typename T>
int backward(int stage, const void* xp, const void* dyp, const float* gamma,
             const float* beta, const float* stats, void* dxp, float* chan,
             float* part, float* gsum, float* dgamma, float* dbeta,
             long long batch, int G, int Cg, int S, int chunk, int Pc,
             float n, float eps, int swish, cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const T* dy = static_cast<const T*>(dyp);
  T* dx = static_cast<T*>(dxp);
  const float2* st = reinterpret_cast<const float2*>(stats);
  float2* ch = reinterpret_cast<float2*>(chan);
  float2* pc = reinterpret_cast<float2*>(part);
  float2* gs = reinterpret_cast<float2*>(gsum);
  const long long groups = batch * G;
  const int C = G * Cg, L = Cg * S;
  if (stage == 0) {
    const int nv = L / W;
    const int threads = onchip_threads(nv), k = onchip_k(nv, threads);
    const size_t smem = sizeof(float2) * nv;
    GN_DISPATCH_K(k, onchip_bwd<T, KK><<<grid(groups), threads, smem, s>>>(
                         x, dy, gamma, beta, st, dx, ch, G, Cg, S, n, eps,
                         swish));
  } else if (stage == 1) {
    split_bwd_reduce<T><<<grid(groups * Cg, Pc), kSplitThreads, 0, s>>>(
        x, dy, gamma, beta, st, pc, G, Cg, S, chunk, Pc, eps, swish);
    if (const int e = status()) return e;
    split_bwd_finalize<<<grid(groups), kReduceThreads, 0, s>>>(gamma, pc, ch,
                                                               gs, G, Cg, Pc);
  } else if (stage == 2) {
    const int P = (L + chunk - 1) / chunk;
    split_bwd_dx<T><<<grid(groups, P), kSplitThreads, 0, s>>>(
        x, dy, gamma, beta, st, gs, dx, G, Cg, S, chunk, n, eps, swish);
    return status();
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (const int e = status()) return e;
  param_reduce<<<C, kReduceThreads, 0, s>>>(ch, dgamma, dbeta,
                                            static_cast<int>(batch), C);
  return status();
}

// Whether the arguments describe shapes the kernels take: the on-chip
// path's group of at most 4096 vectors, grid sizes in range, and S and
// the chunk whole vectors.
bool bad(int stage, long long groups, int G, int Cg, int S, int chunk) {
  if (groups < 1 || G < 1 || Cg < 1 || S < 1 || chunk < 1 || groups % G)
    return true;
  const long long L = static_cast<long long>(Cg) * S;
  if (L >= (1LL << 30) || (L + chunk - 1) / chunk > 65535 ||
      groups * Cg >= (1LL << 31))
    return true;
  if (S % W || chunk % W) return true;
  if (stage == 0 && L / W > 4096) return true;
  return false;
}

}  // namespace

// x, y: contiguous [B, C, S] device buffers of one dtype (0 = float32,
// 1 = bfloat16), groups = B * G, Cg = C / G; gamma, beta: C floats;
// stats: groups * 2 floats, (mean, var) of each group; partial: groups * P
// * 2 floats for the split path's stage 1 (stats) and 2 (apply), unused by
// stage 0 (on-chip); n: the elements of a group over the space group;
// swish: 0 or 1. S is a multiple of 4 and every pointer of x's dtype is
// aligned to a 4-element vector. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int group_norm_forward(int stage, const void* x,
                                  const float* gamma, const float* beta,
                                  void* y, float* stats, float* partial,
                                  long long groups, int G, int Cg, int S,
                                  int chunk, int P, float n, float eps,
                                  int swish, int dtype, void* stream) {
  if (bad(stage, groups, G, Cg, S, chunk) || P < 1 ||
      !(aligned(x, dtype) && aligned(y, dtype)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GN_FWD(T)                                                    \
  return forward<T>(stage, x, gamma, beta, y, stats, partial, groups, \
                    G, Cg, S, chunk, P, n, eps, swish, s)
  if (dtype == 0) GN_FWD(float);
  if (dtype == 1) GN_FWD(bf16);
#undef GN_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above, with dy and dx of x's shape and dtype, stats from the forward.
// Stage 0 (on-chip) writes dx, chan (batch * C * 2 floats) and dgamma,
// dbeta (C floats each); stage 1 (split) reduces into part (batch * C * Pc
// * 2 floats, Pc chunks of each channel), chan, gsum (groups * 2 floats)
// and dgamma, dbeta; stage 2 (split) writes dx from gsum, which may have
// been summed over the space group in between.
extern "C" int group_norm_backward(int stage, const void* x, const void* dy,
                                   const float* gamma, const float* beta,
                                   const float* stats, void* dx, float* chan,
                                   float* part, float* gsum, float* dgamma,
                                   float* dbeta, long long batch, int G,
                                   int Cg, int S, int chunk, int Pc, float n,
                                   float eps, int swish, int dtype,
                                   void* stream) {
  if (batch < 1 || bad(stage, batch * G, G, Cg, S, chunk) ||
      (stage == 1 && (Pc < 1 || Pc > 65535)) ||
      !(aligned(x, dtype) && aligned(dy, dtype) && aligned(dx, dtype)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GN_BWD(T)                                                      \
  return backward<T>(stage, x, dy, gamma, beta, stats, dx, chan, part, \
                     gsum, dgamma, dbeta, batch, G, Cg, S, chunk, Pc,  \
                     n, eps, swish, s)
  if (dtype == 0) GN_BWD(float);
  if (dtype == 1) GN_BWD(bf16);
#undef GN_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
