// K1, Soft-MoE routing for Hopper (sm_90a): one logits pass yields the
// dispatched slots and both softmax directions' statistics.
//
// Replaces the TPU kernel src/repro/kernels/soft_moe_kernels.py
// `routing_fwd_pallas` (body `_routing_fwd_kernel`, pallas_call at :203).
// The PyTorch wrapper and the plain version that repeats this arithmetic
// are in src/repro_torch/kernels/soft_moe_kernels.py.
//
// What it computes, per batch row (x: (B, m, d), Phi_n: (d, S) f32):
//   logits[t, s] = l2norm(x[t]) . Phi_n[:, s]              (f32)
//   D = softmax over tokens (per slot), online over token blocks of bt
//   slots[s]     = sum_t D[t, s] x[t]   (raw x; output in x's dtype)
//   (d_mx, d_den)[s] = the dispatch softmax's (max, denom)   (f32)
//   (c_mx, c_den)[t] = the combine softmax's (max, denom) over all slots
// No (m x S) logits or weights tensor reaches device memory.
//
// What bounds it on the H100: arithmetic. At the Soft-MoE B/16 layer
// (B=64, m=196, d=768, S=128, bf16 x) it moves ~32 MB (~9.7 us at
// 3.35 TB/s) but does ~4.9 GFLOP in f32 on the CUDA cores (~74 us at
// 67 TFLOP/s): 2 m S d for the logits and 2 m S d for the slot mix.
//
// Design (the TPU kernel's grid (b, slot block, token block) runs in
// order and carries state in VMEM; CUDA blocks run in no order):
//   * A pre-pass computes every token's inverse L2 norm (O(B m d) reads).
//   * One CTA per (d-chunk, slot block of 32, row): it loops over the row's
//     token blocks itself, carrying the dispatch softmax (max, denom) and
//     the (32 slots x d-chunk) accumulator in registers (96 a thread at 768
//     columns). The TPU tile's whole (128 slots x d) accumulator does not
//     fit (128 x 768 in f32 is 393 KB against 227 KB of shared memory).
//     A d-chunk is 128, 256, 384 or 768 columns; a CTA recomputes the
//     logits tile over the whole of d, so the logits arithmetic costs
//     ceil(d / d_chunk) times its minimum. The tile policy takes one chunk
//     up to d = 768 (no recompute at B/16).
//   * The combine statistics need a reduction over every slot block. The
//     TPU kernel carries them in a full-length scratch across the slot
//     grid axis (last write wins, :162-174). Here each slot block writes
//     its partial (max, denom) per token, and a second kernel merges the
//     partials per token in slot-block order. No atomics.
//   * Every reduction stays inside one row in a fixed order, so row i of a
//     batched launch equals a batch-1 launch bitwise (the per-row invariant
//     of src/repro/kernels/ops.py).
//   * f32 FMA on the CUDA cores, no TF32 and no tensor cores: a later,
//     measured change.
#include "soft_moe_common.cuh"

namespace {

using namespace smoe;

struct RoutingArgs {
  const void* x;     // (B, m, d)
  const float* phi;  // (d, S)
  const float* rn;   // (B, m) inverse norms from the pre-pass
  void* slots;       // (B, S, d)
  float* d_mx;       // (B, S)
  float* d_den;      // (B, S)
  float* c_part_mx;  // (B, nsb, m) per-slot-block combine partials
  float* c_part_den; // (B, nsb, m)
  int m, d, S, bt, bs, nsb;
};

// One CTA per (d-chunk, slot block, row); DC = 128 * NV columns.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads) routing_kernel(RoutingArgs a) {
  constexpr int DC = 128 * NV;
  const int jc = blockIdx.x, js = blockIdx.y, row = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = a.m, d = a.d, S = a.S;
  const int s0 = js * a.bs, ns = min(a.bs, S - s0);
  const int c0 = jc * DC;

  extern __shared__ float4 smem4[];
  LogitsSmem& lsm = *reinterpret_cast<LogitsSmem*>(smem4);
  float* xc = reinterpret_cast<float*>(smem4) + sizeof(LogitsSmem) / 4;
  float* L = xc + kTile * DC;            // [kTile][kTile + 1]: logits, then p
  float* mx_s = L + kTile * (kTile + 1); // dispatch running max per slot
  float* den_s = mx_s + kTile;           // dispatch running denom per slot
  float* corr_s = den_s + kTile;         // this block's rescale per slot

  // Chunk columns past d are never staged: they stay 0.
  for (int i = tid; i < kTile * DC; i += kThreads) xc[i] = 0.f;
  if (tid < kTile) {
    mx_s[tid] = kNeg;
    den_s[tid] = 0.f;
    corr_s[tid] = 1.f;
  }
  // Thread owns slots 4 * warp + i and columns q * 128 + 4 * lane + e.
  float acc[4][4 * NV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int v = 0; v < 4 * NV; ++v) acc[i][v] = 0.f;

  const T* xrow = static_cast<const T*>(a.x) + (size_t)row * m * d;
  const float* rn = a.rn + (size_t)row * m;
  float* cpm = a.c_part_mx + ((size_t)row * a.nsb + js) * m;
  float* cpd = a.c_part_den + ((size_t)row * a.nsb + js) * m;
  __syncthreads();

  for (int t0 = 0; t0 < m; t0 += a.bt) {
    const int nt = min(a.bt, m - t0);
    float dot[2][2];
    logits_tile<T>(xrow + (size_t)t0 * d, nt, a.phi + s0, S, ns, d, lsm, dot,
                   xc, c0, DC, tid);
    store_logits(L, dot, rn + t0, nt, tid);
    __syncthreads();

    // Combine direction: this slot block's (max, denom) per token. Every
    // d-chunk computes the same logits; chunk 0 writes them.
    if (jc == 0) {
      for (int t = warp; t < nt; t += kWarps) {
        const float v = lane < ns ? L[t * (kTile + 1) + lane] : -INFINITY;
        const float pm = warp_max(v);
        const float e = lane < ns ? expf(v - pm) : 0.f;
        const float pd = warp_sum(e);
        if (lane == 0) {
          cpm[t0 + t] = pm;
          cpd[t0 + t] = pd;
        }
      }
    }
    __syncthreads();

    // Dispatch direction: online softmax over tokens, one warp per slot,
    // lane = token. p replaces the logit in L.
    for (int s = warp; s < ns; s += kWarps) {
      const float v = lane < nt ? L[lane * (kTile + 1) + s] : -INFINITY;
      const float m_old = mx_s[s];
      const float m_new = fmaxf(m_old, warp_max(v));
      const float corr = expf(m_old - m_new);
      const float p = lane < nt ? expf(v - m_new) : 0.f;
      L[lane * (kTile + 1) + s] = p;
      const float psum = warp_sum(p);
      if (lane == 0) {
        den_s[s] = den_s[s] * corr + psum;
        mx_s[s] = m_new;
        corr_s[s] = corr;
      }
    }
    __syncthreads();

    // Slot mix over the chunk: acc = acc * corr + p^T x.
    float c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = corr_s[4 * warp + i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int v = 0; v < 4 * NV; ++v) acc[i][v] *= c[i];
    for (int t = 0; t < nt; ++t) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = L[t * (kTile + 1) + 4 * warp + i];
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const float4 xv =
            *reinterpret_cast<const float4*>(&xc[t * DC + q * 128 + 4 * lane]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * q + 0] = fmaf(p[i], xv.x, acc[i][4 * q + 0]);
          acc[i][4 * q + 1] = fmaf(p[i], xv.y, acc[i][4 * q + 1]);
          acc[i][4 * q + 2] = fmaf(p[i], xv.z, acc[i][4 * q + 2]);
          acc[i][4 * q + 3] = fmaf(p[i], xv.w, acc[i][4 * q + 3]);
        }
      }
    }
    __syncthreads();  // L, xc and the staging buffers are refilled next
  }

  T* out = static_cast<T*>(a.slots) + ((size_t)row * S + s0) * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = 4 * warp + i;
    if (s >= ns) continue;
    const float den = den_s[s];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + q * 128 + 4 * lane + e;
        if (col < d) out[(size_t)s * d + col] = from_f32<T>(acc[i][4 * q + e] / den);
      }
    }
  }
  if (jc == 0 && tid < ns) {
    a.d_mx[(size_t)row * S + s0 + tid] = mx_s[tid];
    a.d_den[(size_t)row * S + s0 + tid] = den_s[tid];
  }
}

// Merge the per-slot-block combine partials of every token, in slot-block
// order: M' = max(M, pm_j); D' = D exp(M - M') + pd_j exp(pm_j - M').
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const float* c_part_mx, const float* c_part_den, float* c_mx,
                 float* c_den, long long n_tokens, int m, int nsb) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_tokens) return;
  const long long row = i / m, t = i - row * m;
  float mx = kNeg, den = 0.f;
  for (int j = 0; j < nsb; ++j) {
    const size_t k = ((size_t)row * nsb + j) * m + t;
    const float pm = c_part_mx[k];
    const float m_new = fmaxf(mx, pm);
    den = den * expf(mx - m_new) + c_part_den[k] * expf(pm - m_new);
    mx = m_new;
  }
  c_mx[i] = mx;
  c_den[i] = den;
}

template <typename T, int NV>
cudaError_t launch(const RoutingArgs& a, int B, cudaStream_t stream) {
  constexpr int DC = 128 * NV;
  const size_t smem = sizeof(LogitsSmem) +
                      sizeof(float) * (kTile * DC + kTile * (kTile + 1) + 3 * kTile);
  auto kernel = routing_kernel<T, NV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.d + DC - 1) / DC, a.nsb, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dc(const RoutingArgs& a, int B, int d_chunk,
                      cudaStream_t stream) {
  switch (d_chunk) {
    case 128: return launch<T, 1>(a, B, stream);
    case 256: return launch<T, 2>(a, B, stream);
    case 384: return launch<T, 3>(a, B, stream);
    default: return launch<T, 6>(a, B, stream);
  }
}

}  // namespace

// Plain C entry point for ctypes. dtype code of x and slots: 0 = float32,
// 1 = bfloat16; Phi_n and every statistic are float32. Every pointer is a
// device pointer: rn (B*m floats) and c_part_mx / c_part_den (B*nsb*m floats
// each, nsb = ceil(S / bs)) are scratch the caller allocates. `stream` is a
// cudaStream_t. Launches the norm pre-pass, the routing kernel and the
// merge, and returns the first cudaError_t (0 = success). Shapes the kernel
// does not take (bt or bs outside 1..32, d_chunk not 128, 256, 384 or 768,
// d not a
// multiple of 8, operands not 16-byte aligned) return cudaErrorInvalidValue
// without launching.
extern "C" int soft_moe_routing_launch(
    const void* x, const void* phi, void* slots, void* d_mx, void* d_den,
    void* c_mx, void* c_den, void* rn, void* c_part_mx, void* c_part_den,
    int dtype, int B, int m, int d, int S, int bt, int bs, int d_chunk,
    void* stream) {
  if (B < 0 || B > 65535 || m <= 0 || d <= 0 || S <= 0 || bt < 1 ||
      bt > kTile || bs < 1 || bs > kTile || dtype < 0 || dtype > 1 ||
      !valid_d_chunk(d_chunk) || d % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(slots) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RoutingArgs a;
  a.x = x;
  a.phi = static_cast<const float*>(phi);
  a.rn = static_cast<const float*>(rn);
  a.slots = slots;
  a.d_mx = static_cast<float*>(d_mx);
  a.d_den = static_cast<float*>(d_den);
  a.c_part_mx = static_cast<float*>(c_part_mx);
  a.c_part_den = static_cast<float*>(c_part_den);
  a.m = m;
  a.d = d;
  a.S = S;
  a.bt = bt;
  a.bs = bs;
  a.nsb = (S + bs - 1) / bs;
  const long long n_tokens = (long long)B * m;
  cudaError_t e = dtype == 0
      ? launch_inv_norm<float>(x, static_cast<float*>(rn), n_tokens, d, s)
      : launch_inv_norm<__nv_bfloat16>(x, static_cast<float*>(rn), n_tokens, d, s);
  if (e != cudaSuccess) return (int)e;
  e = dtype == 0 ? launch_dc<float>(a, B, d_chunk, s)
                 : launch_dc<__nv_bfloat16>(a, B, d_chunk, s);
  if (e != cudaSuccess) return (int)e;
  merge_kernel<<<(unsigned)((n_tokens + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      a.c_part_mx, a.c_part_den, static_cast<float*>(c_mx),
      static_cast<float*>(c_den), n_tokens, m, a.nsb);
  return (int)cudaGetLastError();
}
