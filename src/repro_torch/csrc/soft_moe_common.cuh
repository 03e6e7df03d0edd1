// Shared pieces of the Soft-MoE kernels for Hopper (sm_90a): K1 routing
// (soft_moe_routing.cu), K2/K3 combine (soft_moe_combine.cu), K6 routing
// health (soft_moe_routing_health.cu) and, for their constants and
// conversions, the tensor-core pieces (soft_moe_mma.cuh) and the backward
// kernels K4/K5 (soft_moe_bwd.cuh).
//
// Every forward kernel forms its logits l2norm(x) . Phi_n on the tensor
// cores at f32 accuracy (soft_moe_mma.cuh::logits_tile_mma). The inverse
// L2 norm of every token comes from a pre-pass (inv_norm_kernel), and a
// logit is rn[t] * (x[t] . phi[:, s]).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace smoe {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;      // largest token / slot block
constexpr float kNeg = -1e30f; // running-max start, as the TPU kernels' _NEG
constexpr float kEps = 1e-6f;  // must match ref.l2_normalize

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Butterfly reductions: every lane ends with the same, bitwise, result.
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rn[i] = 1 / (sqrt(sum_d x[i, :]^2) + eps) for every token i of the
// (n_tokens, d) input. One warp per token: lanes stride over d, then a
// butterfly sum, so the order is fixed whatever the batch.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    inv_norm_kernel(const T* x, float* rn, long long n_tokens, int d) {
  const long long tok =
      (long long)blockIdx.x * kWarps + (long long)(threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (tok >= n_tokens) return;  // warp-uniform
  const T* row = x + tok * (long long)d;
  float s = 0.f;
  for (int k = lane; k < d; k += 32) {
    const float v = to_f32(row[k]);
    s = fmaf(v, v, s);
  }
  s = warp_sum(s);
  if (lane == 0) rn[tok] = 1.f / (sqrtf(s) + kEps);
}

template <typename T>
cudaError_t launch_inv_norm(const void* x, float* rn, long long n_tokens,
                            int d, cudaStream_t stream) {
  const long long blocks = (n_tokens + kWarps - 1) / kWarps;
  inv_norm_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), rn, n_tokens, d);
  return cudaGetLastError();
}

}  // namespace smoe
