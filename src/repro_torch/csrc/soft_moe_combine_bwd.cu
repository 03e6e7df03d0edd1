// K5, the backward of the Soft-MoE combine for Hopper (sm_90a): given the
// output's gradient g, dX, dYs and dPhi_n, with C recomputed tile by tile
// from the saved per-token combine statistics (K1's or K3's).
//
// Replaces the TPU kernel src/repro/kernels/soft_moe_kernels.py
// `combine_bwd_pallas` (:658; pallas_calls :685 for dX, :702 for dYs and
// dPhi_n). The PyTorch wrapper and the plain version that repeats this
// arithmetic are in src/repro_torch/kernels/soft_moe_kernels.py; the
// autograd Functions that call it are kernels/ops.py::_CombineStats and
// _CombineOnline.
//
// What it computes, per batch row (x, g, y: (B, m, d), Phi_n: (d, S) f32,
// Ys: (B, S, d), c_mx, c_den, rho = g . y: (B, m) f32):
//   C[t, s]  = exp(l2norm(x_t) . Phi_n[:, s] - c_mx[t]) / c_den[t]
//   dL       = C * (g_t . Ys_s - rho_t)
//   dX       = l2norm-VJP(dL Phi_n^T)                 (output in x's dtype)
//   dYs      = C^T g                                   (output in Ys' dtype)
//   dPhi_n   = sum over rows of l2norm(X)^T dL         (f32)
// No (m x S) tensor reaches device memory.
//
// What bounds it on the H100: arithmetic. At the Soft-MoE B/16 layer
// (B=64, m=196, d=768, S=128, bf16) the work is 10 m S d flops a row
// (the logits, g . Ys, dL Phi_n^T, C^T g, X^T dL): 12.3 GFLOP, ~184 us at
// the f32 rate of 67 TFLOP/s, against ~83 MB of bytes (~25 us at 3.35
// TB/s). On the tensor cores (soft_moe_bwd.cuh) the logits take two TF32
// passes, g . Ys one bf16 pass, dL Phi_n^T three, C^T g and X^T dL two
// each: ~47 us at the dense TF32 and bf16 peaks; the design's bytes (the
// chunk partials of dYs and dPhi_n, 2 x 101 MB written and read) take
// ~145 us.
//
// Design (soft_moe_bwd.cuh): a pre-pass (the norms and rho); one CTA per
// (token chunk, row) that builds C and rn dL for its chunk once, as the
// TPU kernel's _combine_bwd_dys_dphi_kernel does for dYs and dPhi_n in
// one body, and writes dX and the chunk's dYs and dPhi_n^T partials; two
// more kernels sum the partials, each row's chunks in chunk order (dYs)
// and, for dPhi_n, the row totals in row order. No atomics.
#include "soft_moe_bwd.cuh"

namespace {

using namespace smoe;

template <typename T, int SC>
__global__ void __launch_bounds__(kThreads, min_ctas<T, SC>())
    combine_bwd_kernel(BwdArgs a) {
  bwd_body<T, SC, true>(a);
}

template <typename T, int SC>
cudaError_t launch(const BwdArgs& a, int B, cudaStream_t stream) {
  const unsigned nch = (a.m + a.ct - 1) / a.ct;
  return launch_bwd(combine_bwd_kernel<T, SC>, dim3(nch, B),
                    BwdLayout<T, SC, true>::kBytes, a, stream);
}

template <typename T>
cudaError_t launch_all(const BwdArgs& a, void* dys, int B,
                       cudaStream_t stream) {
  cudaError_t e;
  switch (slot_tile_units(a.S)) {
    case 1: e = launch<T, 1>(a, B, stream); break;
    case 2: e = launch<T, 2>(a, B, stream); break;
    default: e = launch<T, 4>(a, B, stream); break;
  }
  if (e != cudaSuccess) return e;
  const int nch = (a.m + a.ct - 1) / a.ct;
  const long long n = (long long)a.S * a.d;
  chunk_sum_kernel<T><<<(unsigned)((B * n + kThreads - 1) / kThreads),
                        kThreads, 0, stream>>>(a.part_ys,
                                               static_cast<T*>(dys), B, nch,
                                               n);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. dtype code of x, ys, g, y, dx and dys:
// 0 = float32, 1 = bfloat16; Phi_n, the statistics and dPhi_n are
// float32. Every pointer is a device pointer: rn, inv_n and rho (B*m
// floats each), part_phi and part_ys (B * ceil(m / ct) * S * d floats
// each) and, when S > 128, dx_acc (B*m*d floats; may be null otherwise)
// are scratch the caller allocates. ct is the tokens of a chunk (1..64).
// `stream` is a cudaStream_t. Launches the pre-pass (the norms and rho =
// g . y), the main kernel and the partials' sums, and returns the first
// cudaError_t (0 = success). Shapes the kernels do not take (ct outside
// 1..64, d not a multiple of 8, operands not 16-byte aligned) return
// cudaErrorInvalidValue without launching.
extern "C" int soft_moe_combine_bwd_launch(
    const void* x, const void* phi, const void* ys, const void* g,
    const void* y, const void* c_mx, const void* c_den, void* dx, void* dphi,
    void* dys, void* rn, void* inv_n, void* rho, void* dx_acc,
    void* part_phi, void* part_ys, int dtype, int B, int m, int d, int S,
    int ct, void* stream) {
  if (!bwd_shapes_ok(dtype, B, m, d, S, ct) || !aligned16(x) ||
      !aligned16(ys) || !aligned16(g) || !aligned16(dx) || !aligned16(dys) ||
      !aligned16(part_phi) || !aligned16(part_ys) ||
      (S > 128 && (dx_acc == nullptr || !aligned16(dx_acc)))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rn_f = static_cast<float*>(rn);
  float* inv_f = static_cast<float*>(inv_n);
  float* rho_f = static_cast<float*>(rho);
  BwdArgs a;
  a.x = x;
  a.phi = static_cast<const float*>(phi);
  a.g = g;
  a.ys = ys;
  a.mx = static_cast<const float*>(c_mx);
  a.den = static_cast<const float*>(c_den);
  a.rowdot = rho_f;
  a.rn = rn_f;
  a.inv_n = inv_f;
  a.dx = dx;
  a.dx_acc = static_cast<float*>(dx_acc);
  a.part_phi = static_cast<float*>(part_phi);
  a.part_ys = static_cast<float*>(part_ys);
  a.m = m;
  a.d = d;
  a.S = S;
  a.ct = ct;
  a.phi_vec = S % 4 == 0 && aligned16(phi);
  const int nch = (m + ct - 1) / ct;
  if (B > 0) {
    const long long n_tok = (long long)B * m;
    cudaError_t e =
        dtype == 0
            ? launch_prepass<float>(x, rn_f, inv_f, n_tok, g, y, rho_f, n_tok,
                                    d, s)
            : launch_prepass<__nv_bfloat16>(x, rn_f, inv_f, n_tok, g, y,
                                            rho_f, n_tok, d, s);
    if (e != cudaSuccess) return (int)e;
    e = dtype == 0 ? launch_all<float>(a, dys, B, s)
                   : launch_all<__nv_bfloat16>(a, dys, B, s);
    if (e != cudaSuccess) return (int)e;
  }
  // B = 0 still writes dPhi_n: an empty sum is 0.
  return (int)launch_dphi_reduce(a.part_phi, static_cast<float*>(dphi), B,
                                 nch, S, d, s);
}

// Dynamic shared memory (bytes) of one CTA of the main kernel for x's
// dtype code and S slots, as the launch asks for it.
extern "C" int soft_moe_combine_bwd_smem_bytes(int dtype, int S) {
  return bwd_smem_bytes<true>(dtype, S);
}
