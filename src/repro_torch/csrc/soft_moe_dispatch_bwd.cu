// K4, the backward of the Soft-MoE routing (dispatch) for Hopper (sm_90a):
// given the slots' gradient g, dX and dPhi_n, with D recomputed tile by
// tile from K1's saved dispatch statistics.
//
// Replaces the TPU kernel src/repro/kernels/soft_moe_kernels.py
// `dispatch_bwd_pallas` (:529; pallas_calls :556 for dX, :572 for dPhi_n).
// The PyTorch wrapper and the plain version that repeats this arithmetic
// are in src/repro_torch/kernels/soft_moe_kernels.py; the autograd
// Function that calls it is kernels/ops.py::_Routing.
//
// What it computes, per batch row (x: (B, m, d), Phi_n: (d, S) f32,
// g and slots: (B, S, d), d_mx, d_den, sigma = g . slots: (B, S) f32):
//   D[t, s]  = exp(l2norm(x_t) . Phi_n[:, s] - d_mx[s]) / d_den[s]
//   dL       = D * (x_t . g_s - sigma_s)
//   dX       = D g + l2norm-VJP(dL Phi_n^T)           (output in x's dtype)
//   dPhi_n   = sum over rows of l2norm(X)^T dL         (f32)
// No (m x S) tensor reaches device memory.
//
// What bounds it on the H100: arithmetic. At the Soft-MoE B/16 layer
// (B=64, m=196, d=768, S=128, bf16) the least work is 10 m S d f32 FLOP a
// row (logits, x . g, D g, dL Phi_n^T, X^T dL): 12.3 GFLOP, ~184 us at
// 67 TFLOP/s, against ~51 MB of bytes (~15 us at 3.35 TB/s). This split
// recomputes the logits and x . g in both kernels: 14 m S d.
//
// Design (soft_moe_bwd.cuh): a norm pre-pass; dX from one CTA per
// (d-chunk, token block, row) looping over slot blocks (one register
// accumulator; the l2-norm VJP's projection from the logits tile);
// dPhi_n^T partials from one CTA per (d-chunk, slot block, row) looping
// over token blocks (256 CTAs at B/16), summed over rows in row order by a
// second kernel. No atomics: dPhi_n is bitwise the same from run to run.
#include "soft_moe_bwd.cuh"

namespace {

using namespace smoe;

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, 2)
    dispatch_bwd_dx_kernel(BwdArgs a) {
  bwd_dx_body<T, NV, true>(a);
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, 2)
    dispatch_bwd_dphi_kernel(BwdArgs a) {
  bwd_slot_body<T, NV, kDispatchDphi>(a);
}

template <typename T, int NV>
cudaError_t launch(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int DC = 128 * NV;
  const unsigned nc = (a.d + DC - 1) / DC;
  cudaError_t e = launch_body(dispatch_bwd_dx_kernel<T, NV>,
                              dim3(nc, (a.m + a.bt - 1) / a.bt, B),
                              dx_smem_bytes<NV>(), a, stream);
  if (e != cudaSuccess) return e;
  return launch_body(dispatch_bwd_dphi_kernel<T, NV>,
                     dim3(nc, (a.S + a.bs - 1) / a.bs, B),
                     slot_smem_bytes<NV>(), a, stream);
}

template <typename T>
cudaError_t launch_dc(const BwdArgs& a, int B, int d_chunk,
                      cudaStream_t stream) {
  switch (d_chunk) {
    case 128: return launch<T, 1>(a, B, stream);
    case 256: return launch<T, 2>(a, B, stream);
    case 384: return launch<T, 3>(a, B, stream);
    default: return launch<T, 6>(a, B, stream);
  }
}

}  // namespace

// Plain C entry point for ctypes. dtype code of x, g_slots and dx: 0 =
// float32, 1 = bfloat16; Phi_n, the statistics, sigma and dPhi_n are
// float32. Every pointer is a device pointer: rn and inv_n (B*m floats
// each) and dphi_part (B*S*d floats) are scratch the caller allocates.
// `stream` is a cudaStream_t. Launches the norm pre-pass, the dX kernel,
// the dPhi_n partials and their row sum, and returns the first cudaError_t
// (0 = success). Shapes the kernels do not take (bt or bs outside 1..32,
// d_chunk not 128, 256, 384 or 768, d not a multiple of 8, operands not
// 16-byte aligned) return cudaErrorInvalidValue without launching.
extern "C" int soft_moe_dispatch_bwd_launch(
    const void* x, const void* phi, const void* g_slots, const void* d_mx,
    const void* d_den, const void* sigma, void* dx, void* dphi, void* rn,
    void* inv_n, void* dphi_part, int dtype, int B, int m, int d, int S,
    int bt, int bs, int d_chunk, void* stream) {
  if (!bwd_shapes_ok(dtype, B, m, d, S, bt, bs, d_chunk) || !aligned16(x) ||
      !aligned16(g_slots) || !aligned16(dx) || !aligned16(dphi_part)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdArgs a;
  a.x = x;
  a.phi = static_cast<const float*>(phi);
  a.g = g_slots;
  a.ys = nullptr;
  a.mx = static_cast<const float*>(d_mx);
  a.den = static_cast<const float*>(d_den);
  a.rowdot = static_cast<const float*>(sigma);
  a.rn = static_cast<const float*>(rn);
  a.inv_n = static_cast<const float*>(inv_n);
  a.dx = dx;
  a.dys = nullptr;
  a.dphi_part = static_cast<float*>(dphi_part);
  a.m = m;
  a.d = d;
  a.S = S;
  a.bt = bt;
  a.bs = bs;
  if (B > 0) {
    const long long n_tokens = (long long)B * m;
    cudaError_t e =
        dtype == 0
            ? launch_norms<float>(x, static_cast<float*>(rn),
                                  static_cast<float*>(inv_n), n_tokens, d, s)
            : launch_norms<__nv_bfloat16>(x, static_cast<float*>(rn),
                                          static_cast<float*>(inv_n),
                                          n_tokens, d, s);
    if (e != cudaSuccess) return (int)e;
    e = dtype == 0 ? launch_dc<float>(a, B, d_chunk, s)
                   : launch_dc<__nv_bfloat16>(a, B, d_chunk, s);
    if (e != cudaSuccess) return (int)e;
  }
  // B = 0 still writes dPhi_n: an empty sum is 0.
  return (int)launch_dphi_reduce(a.dphi_part, static_cast<float*>(dphi), B, S,
                                 d, s);
}
