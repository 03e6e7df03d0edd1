// K2 and K3, the Soft-MoE combine for Hopper (sm_90a): Y = C Ys, with C
// softmaxed over slots per token. One body, two entry modes:
//   * K2 (stats given): C = exp(logits - c_mx) / c_den from K1's saved
//     per-token statistics, with no rescaling. Replaces
//     src/repro/kernels/soft_moe_kernels.py `combine_apply_pallas` (:456,
//     `_combine_call` :403, pallas_call :443).
//   * K3 (online): an online softmax over slot blocks that also emits the
//     final (c_mx, c_den), the backward residuals. Replaces
//     `combine_online_pallas` (:462, pallas_call :422).
// Both run `_combine_kernel` on the TPU. The PyTorch wrapper and the plain
// version that repeats this arithmetic are in
// src/repro_torch/kernels/soft_moe_kernels.py.
//
// What it computes, per batch row (x: (B, m, d), Phi_n: (d, S) f32,
// Ys: (B, S, d) in x's dtype):
//   logits[t, s] = l2norm(x[t]) . Phi_n[:, s]                 (f32)
//   y[t] = sum_s C[t, s] Ys[s]                  (output in x's dtype)
// No (m x S) logits or weights tensor reaches device memory.
//
// What bounds it on the H100: arithmetic. At the Soft-MoE B/16 layer
// (B=64, m=196, d=768, S=128, bf16) it moves ~52 MB (~15.4 us at
// 3.35 TB/s) but does ~4.9 GFLOP in f32 on the CUDA cores (~74 us at
// 67 TFLOP/s).
//
// Design: one CTA per (d-chunk, token block, row) that loops over the
// row's slot blocks itself (the TPU kernel's sequential slot grid axis),
// carrying the (tokens x d-chunk) accumulator in registers and, in K3, the
// per-token (max, denom) in shared memory. Each CTA recomputes the logits
// tile over the whole of d: ceil(d / d_chunk) times the minimum logits
// arithmetic (the tile policy takes one chunk up to d = 768, so no
// recompute at B/16). A row's reduction stays in one CTA in a
// fixed order, so row i of a batched launch equals a batch-1 launch
// bitwise. f32 FMA on the CUDA cores, no TF32 and no tensor cores.
#include "soft_moe_common.cuh"

namespace {

using namespace smoe;

struct CombineArgs {
  const void* x;     // (B, m, d)
  const float* phi;  // (d, S)
  const void* ys;    // (B, S, d)
  const float* rn;   // (B, m) inverse norms from the pre-pass
  float* c_mx;       // (B, m): read by K2, written by K3
  float* c_den;      // (B, m): read by K2, written by K3
  void* y;           // (B, m, d)
  int m, d, S, bt, bs;
};

// One CTA per (d-chunk, token block, row); DC = 128 * NV columns.
template <typename T, int NV, bool ONLINE>
__global__ void __launch_bounds__(kThreads) combine_kernel(CombineArgs a) {
  constexpr int DC = 128 * NV;
  const int jc = blockIdx.x, jt = blockIdx.y, row = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = a.m, d = a.d, S = a.S;
  const int t0 = jt * a.bt, nt = min(a.bt, m - t0);
  const int c0 = jc * DC;

  extern __shared__ float4 smem4[];
  LogitsSmem& lsm = *reinterpret_cast<LogitsSmem*>(smem4);
  float* ys_s = reinterpret_cast<float*>(smem4) + sizeof(LogitsSmem) / 4;
  float* L = ys_s + kTile * DC;           // [kTile][kTile + 1]: logits, then p
  float* mx_s = L + kTile * (kTile + 1);  // per-token max
  float* den_s = mx_s + kTile;            // per-token denom
  float* corr_s = den_s + kTile;          // this block's rescale per token

  const size_t tok0 = (size_t)row * m + t0;
  if (tid < kTile) {
    if (ONLINE || tid >= nt) {
      mx_s[tid] = kNeg;
      den_s[tid] = tid < nt ? 0.f : 1.f;
    } else {
      mx_s[tid] = a.c_mx[tok0 + tid];
      den_s[tid] = a.c_den[tok0 + tid];
    }
    corr_s[tid] = 1.f;
  }
  // Thread owns tokens 4 * warp + i and columns q * 128 + 4 * lane + e.
  float acc[4][4 * NV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int v = 0; v < 4 * NV; ++v) acc[i][v] = 0.f;

  const T* xt = static_cast<const T*>(a.x) + tok0 * d;
  const T* ysrow = static_cast<const T*>(a.ys) + (size_t)row * S * d;
  const float* rn = a.rn + tok0;
  __syncthreads();

  for (int s0 = 0; s0 < S; s0 += a.bs) {
    const int ns = min(a.bs, S - s0);
    float dot[2][2];
    logits_tile<T>(xt, nt, a.phi + s0, S, ns, d, lsm, dot, nullptr, 0, 0, tid);
    store_logits(L, dot, rn, nt, tid);
    // Stage Ys[s0:s0+ns, c0:c0+DC] as f32; rows past ns and columns past d
    // are zeros.
    for (int i = tid; i < kTile * (DC / 4); i += kThreads) {
      const int s = i / (DC / 4), c = 4 * (i - s * (DC / 4));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s < ns && c0 + c < d) v = load4(ysrow + (size_t)(s0 + s) * d + c0 + c);
      *reinterpret_cast<float4*>(&ys_s[s * DC + c]) = v;
    }
    __syncthreads();

    // Combine weights, one warp per token, lane = slot. K2: exact weights
    // from the saved max (p <= 1, no rescale). K3: online softmax.
    for (int t = warp; t < nt; t += kWarps) {
      const float v = lane < ns ? L[t * (kTile + 1) + lane] : -INFINITY;
      float p;
      if (ONLINE) {
        const float m_old = mx_s[t];
        const float m_new = fmaxf(m_old, warp_max(v));
        const float corr = expf(m_old - m_new);
        p = lane < ns ? expf(v - m_new) : 0.f;
        const float psum = warp_sum(p);
        if (lane == 0) {
          den_s[t] = den_s[t] * corr + psum;
          mx_s[t] = m_new;
          corr_s[t] = corr;
        }
      } else {
        p = lane < ns ? expf(v - mx_s[t]) : 0.f;
      }
      L[t * (kTile + 1) + lane] = p;
    }
    __syncthreads();

    // Mix over the chunk: acc = acc * corr + p Ys (corr = 1 in K2).
    if (ONLINE) {
      float c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] = corr_s[4 * warp + i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int v = 0; v < 4 * NV; ++v) acc[i][v] *= c[i];
    }
    for (int s = 0; s < ns; ++s) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = L[(4 * warp + i) * (kTile + 1) + s];
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const float4 yv =
            *reinterpret_cast<const float4*>(&ys_s[s * DC + q * 128 + 4 * lane]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * q + 0] = fmaf(p[i], yv.x, acc[i][4 * q + 0]);
          acc[i][4 * q + 1] = fmaf(p[i], yv.y, acc[i][4 * q + 1]);
          acc[i][4 * q + 2] = fmaf(p[i], yv.z, acc[i][4 * q + 2]);
          acc[i][4 * q + 3] = fmaf(p[i], yv.w, acc[i][4 * q + 3]);
        }
      }
    }
    __syncthreads();  // L, ys_s and the staging buffers are refilled next
  }

  T* out = static_cast<T*>(a.y) + tok0 * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * warp + i;
    if (t >= nt) continue;
    const float den = den_s[t];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + q * 128 + 4 * lane + e;
        if (col < d) out[(size_t)t * d + col] = from_f32<T>(acc[i][4 * q + e] / den);
      }
    }
  }
  if (ONLINE && jc == 0 && tid < nt) {
    a.c_mx[tok0 + tid] = mx_s[tid];
    a.c_den[tok0 + tid] = den_s[tid];
  }
}

template <typename T, int NV, bool ONLINE>
cudaError_t launch(const CombineArgs& a, int B, cudaStream_t stream) {
  constexpr int DC = 128 * NV;
  const size_t smem = sizeof(LogitsSmem) +
                      sizeof(float) * (kTile * DC + kTile * (kTile + 1) + 3 * kTile);
  auto kernel = combine_kernel<T, NV, ONLINE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.d + DC - 1) / DC, (a.m + a.bt - 1) / a.bt, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool ONLINE>
cudaError_t launch_dc(const CombineArgs& a, int B, int d_chunk,
                      cudaStream_t stream) {
  switch (d_chunk) {
    case 128: return launch<T, 1, ONLINE>(a, B, stream);
    case 256: return launch<T, 2, ONLINE>(a, B, stream);
    case 384: return launch<T, 3, ONLINE>(a, B, stream);
    default: return launch<T, 6, ONLINE>(a, B, stream);
  }
}

}  // namespace

// Plain C entry point for ctypes. dtype code of x, ys and y: 0 = float32,
// 1 = bfloat16; Phi_n and the statistics are float32. online = 0 runs K2
// (c_mx, c_den are inputs), online = 1 runs K3 (they are outputs). Every
// pointer is a device pointer; rn (B*m floats) is scratch the caller
// allocates. `stream` is a cudaStream_t. Launches the norm pre-pass and the
// combine kernel and returns the first cudaError_t (0 = success). Shapes
// the kernel does not take (bt or bs outside 1..32, d_chunk not 128, 256,
// 384 or 768,
// d not a multiple of 8, operands not 16-byte aligned) return
// cudaErrorInvalidValue without launching.
extern "C" int soft_moe_combine_launch(
    const void* x, const void* phi, const void* ys, void* c_mx, void* c_den,
    void* y, void* rn, int online, int dtype, int B, int m, int d, int S,
    int bt, int bs, int d_chunk, void* stream) {
  if (B < 0 || B > 65535 || m <= 0 || d <= 0 || S <= 0 || bt < 1 ||
      bt > kTile || bs < 1 || bs > kTile || dtype < 0 || dtype > 1 ||
      online < 0 || online > 1 || !valid_d_chunk(d_chunk) ||
      d % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ys) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CombineArgs a;
  a.x = x;
  a.phi = static_cast<const float*>(phi);
  a.ys = ys;
  a.rn = static_cast<const float*>(rn);
  a.c_mx = static_cast<float*>(c_mx);
  a.c_den = static_cast<float*>(c_den);
  a.y = y;
  a.m = m;
  a.d = d;
  a.S = S;
  a.bt = bt;
  a.bs = bs;
  const long long n_tokens = (long long)B * m;
  cudaError_t e = dtype == 0
      ? launch_inv_norm<float>(x, static_cast<float*>(rn), n_tokens, d, s)
      : launch_inv_norm<__nv_bfloat16>(x, static_cast<float*>(rn), n_tokens, d, s);
  if (e != cudaSuccess) return (int)e;
  if (dtype == 0) {
    e = online ? launch_dc<float, true>(a, B, d_chunk, s)
               : launch_dc<float, false>(a, B, d_chunk, s);
  } else {
    e = online ? launch_dc<__nv_bfloat16, true>(a, B, d_chunk, s)
               : launch_dc<__nv_bfloat16, false>(a, B, d_chunk, s);
  }
  return (int)e;
}
