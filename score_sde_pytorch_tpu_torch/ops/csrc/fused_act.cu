// Fused bias + leaky ReLU + gain for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the Pallas TPU kernel score_sde_pytorch_tpu/ops/fused_act.py:
// fused_leaky_relu_pallas: out = leaky_relu(x + bias, slope) * scale, with
// the bias broadcast over the channel axis. The port keeps PyTorch's NCHW
// layout, so the channel of element i is (i / inner) % channels, where
// inner is the product of the dims after the channel dim (H * W). The
// backward kernel gives grad_x = grad_out * scale * (x + bias >= 0 ? 1 :
// slope); the bias gradient, a sum of grad_x over the other dims, is left
// to the caller (no TPU kernel computes it).
//
// What bounds it on this card: device memory. Each element is one load and
// one store (two loads in the backward) and a handful of operations, far
// below the ~20 flops per byte at which the H100's fp32 units would be the
// limit. What the design does: a grid-stride loop with neighbouring threads
// on neighbouring elements (coalesced), one bias load per element from L1,
// all arithmetic in fp32 and one rounding on the store for bf16. Not done
// (later work): 16-byte vector loads, and fusing into the producer.
//
// Built by score_sde_pytorch_tpu_torch/ops/build.py with nvcc into a shared
// library; the C entry points at the bottom are bound through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // enough to fill every SM

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float biased(const T* __restrict__ x,
                                        const T* __restrict__ bias,
                                        long long i, long long inner,
                                        int channels) {
  float v = load(x + i);
  if (bias != nullptr) v += load(bias + (i / inner) % channels);
  return v;
}

template <typename T>
__global__ void fused_leaky_relu_fwd(const T* __restrict__ x,
                                     const T* __restrict__ bias,
                                     T* __restrict__ out, long long numel,
                                     long long inner, int channels,
                                     float slope, float scale) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < numel; i += step) {
    const float v = biased(x, bias, i, inner, channels);
    store(out + i, (v >= 0.f ? v : v * slope) * scale);
  }
}

template <typename T>
__global__ void fused_leaky_relu_bwd(const T* __restrict__ x,
                                     const T* __restrict__ bias,
                                     const T* __restrict__ grad_out,
                                     T* __restrict__ grad_x, long long numel,
                                     long long inner, int channels,
                                     float slope, float scale) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < numel; i += step) {
    const float v = biased(x, bias, i, inner, channels);
    const float g = load(grad_out + i) * scale;
    store(grad_x + i, v >= 0.f ? g : g * slope);
  }
}

unsigned blocks_for(long long numel) {
  const long long blocks = (numel + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

bool bad_shape(long long numel, long long inner, int channels) {
  return numel < 1 || inner < 1 || channels < 1 ||
         numel % (inner * channels) != 0;
}

}  // namespace

// x, out: contiguous device buffers of `numel` elements of one dtype
// (0 = float32, 1 = bfloat16) laid out as [..., channels, inner]; bias: null
// or `channels` elements of that dtype. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int fused_leaky_relu_forward(const void* x, const void* bias,
                                        void* out, long long numel,
                                        long long inner, int channels,
                                        float slope, float scale, int dtype,
                                        void* stream) {
  if (bad_shape(numel, inner, channels))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    fused_leaky_relu_fwd<float><<<blocks_for(numel), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(bias),
        static_cast<float*>(out), numel, inner, channels, slope, scale);
  } else if (dtype == 1) {
    fused_leaky_relu_fwd<__nv_bfloat16><<<blocks_for(numel), kThreads, 0,
                                          s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(out), numel, inner, channels, slope,
        scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// As above, with grad_out and grad_x of x's shape and dtype.
extern "C" int fused_leaky_relu_backward(const void* x, const void* bias,
                                         const void* grad_out, void* grad_x,
                                         long long numel, long long inner,
                                         int channels, float slope,
                                         float scale, int dtype,
                                         void* stream) {
  if (bad_shape(numel, inner, channels))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    fused_leaky_relu_bwd<float><<<blocks_for(numel), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(bias),
        static_cast<const float*>(grad_out), static_cast<float*>(grad_x),
        numel, inner, channels, slope, scale);
  } else if (dtype == 1) {
    fused_leaky_relu_bwd<__nv_bfloat16><<<blocks_for(numel), kThreads, 0,
                                          s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(bias),
        static_cast<const __nv_bfloat16*>(grad_out),
        static_cast<__nv_bfloat16*>(grad_x), numel, inner, channels, slope,
        scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
