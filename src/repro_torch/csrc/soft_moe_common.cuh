// Shared pieces of the Soft-MoE kernels for Hopper (sm_90a): K1 routing
// (soft_moe_routing.cu), K2/K3 combine (soft_moe_combine.cu), K6 routing
// health (soft_moe_routing_health.cu) and, for their constants and
// conversions, the backward kernels K4/K5 (soft_moe_bwd.cuh).
//
// The forward kernels contract a (tokens x d) tile against Phi_n (d x
// slots) into a 32 x 32 tile of logits l2norm(x) . Phi_n, in f32 on the
// CUDA cores (the TPU kernels cast x and Phi_n to f32 before the dot,
// _logits_tile in src/repro/kernels/soft_moe_kernels.py:90-96). The
// inverse L2 norm of every token comes from a pre-pass (inv_norm_kernel),
// and a logit is rn[t] * (x[t] . phi[:, s]): the dot runs over the whole
// of d in order.
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
constexpr int kKc = 32;        // d sub-tile of the logits dot
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

// Four consecutive elements as floats; p is 8-byte (bf16) or 16-byte (f32)
// aligned, which the entry points guarantee through d % 8 == 0 and
// 16-byte aligned operands.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
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

// Staging buffers of one logits tile.
struct LogitsSmem {
  float xs[kKc][kTile + 2];  // x sub-tile transposed, [k][token]
  float ph[kKc][kTile];      // Phi_n sub-tile, [k][slot]
};

// dot[i][j] = x[2ty+i, :] . phi[:, 2tx+j] over the whole of d, in d order,
// for thread (ty, tx) = (tid / 16, tid % 16) of the 32 x 32 tile. `x` points
// at the tile's first token (row stride d), `phi` at its first slot (row
// stride S). Tokens >= nt and slots >= ns are staged as zeros. Columns
// [c0, c0 + dc) of the staged x rows are also copied to xc[t * dc + c - c0]
// when xc is given (K1 mixes the slots from that chunk). Ends synchronised.
template <typename T>
__device__ __forceinline__ void logits_tile(const T* x, int nt,
                                            const float* phi, int S, int ns,
                                            int d, LogitsSmem& sm,
                                            float dot[2][2], float* xc,
                                            int c0, int dc, int tid) {
  const int ty = tid >> 4, tx = tid & 15;
  dot[0][0] = dot[0][1] = dot[1][0] = dot[1][1] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kKc) {
    for (int i = tid; i < kTile * kKc; i += kThreads) {
      const int t = i / kKc, k = i - t * kKc;  // lanes along d: coalesced
      const int c = k0 + k;
      float v = 0.f;
      if (t < nt && c < d) v = to_f32(x[(size_t)t * d + c]);
      sm.xs[k][t] = v;
      if (xc != nullptr && c >= c0 && c < c0 + dc && c < d) {
        xc[t * dc + (c - c0)] = v;
      }
    }
    for (int i = tid; i < kKc * kTile; i += kThreads) {
      const int k = i / kTile, s = i - k * kTile;
      sm.ph[k][s] =
          (s < ns && k0 + k < d) ? phi[(size_t)(k0 + k) * S + s] : 0.f;
    }
    __syncthreads();
    const int kn = min(kKc, d - k0);
    for (int k = 0; k < kn; ++k) {
      const float2 a = *reinterpret_cast<const float2*>(&sm.xs[k][2 * ty]);
      const float2 b = *reinterpret_cast<const float2*>(&sm.ph[k][2 * tx]);
      dot[0][0] = fmaf(a.x, b.x, dot[0][0]);
      dot[0][1] = fmaf(a.x, b.y, dot[0][1]);
      dot[1][0] = fmaf(a.y, b.x, dot[1][0]);
      dot[1][1] = fmaf(a.y, b.y, dot[1][1]);
    }
    __syncthreads();
  }
}

// Store the tile's logits rn[t] * dot into L (row stride kTile + 1);
// tokens >= nt get 0.
__device__ __forceinline__ void store_logits(float* L, const float dot[2][2],
                                             const float* rn, int nt,
                                             int tid) {
  const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = 2 * ty + i;
    const float r = t < nt ? rn[t] : 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) L[t * (kTile + 1) + 2 * tx + j] = r * dot[i][j];
  }
}

// d-chunk widths the kernels are built for: 128 * NV columns,
// NV in {1, 2, 3, 6}.
inline bool valid_d_chunk(int dc) {
  return dc == 128 || dc == 256 || dc == 384 || dc == 768;
}

}  // namespace smoe
