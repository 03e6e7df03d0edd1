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
// (B=64, m=196, d=768, S=128, bf16) the work is 10 m S d flops a row
// (the logits, x . g, D g, dL Phi_n^T, X^T dL): 12.3 GFLOP, ~184 us at
// the f32 rate of 67 TFLOP/s, against ~51 MB of bytes (~15 us at 3.35
// TB/s). On the tensor cores (soft_moe_bwd.cuh) the logits take two TF32
// passes, x . g one bf16 pass, D g two and the other two products three
// and two: ~47 us at the dense TF32 and bf16 peaks; the design's bytes
// (the chunk partials of dPhi_n, 101 MB written and read) take ~76 us.
//
// Design (soft_moe_bwd.cuh): a pre-pass (the norms and sigma); one CTA
// per (token chunk, row) that builds D and rn dL for its chunk once and
// writes dX and the chunk's dPhi_n^T partial; a second kernel sums the
// partials, each row's chunks in chunk order and the row totals in row
// order. No atomics: dPhi_n is bitwise the same from run to run.
#include "soft_moe_bwd.cuh"

namespace {

using namespace smoe;

template <typename T, int SC>
__global__ void __launch_bounds__(kThreads, min_ctas<T, SC>())
    dispatch_bwd_kernel(BwdArgs a) {
  bwd_body<T, SC, false>(a);
}

template <typename T, int SC>
cudaError_t launch(const BwdArgs& a, int B, cudaStream_t stream) {
  const unsigned nch = (a.m + a.ct - 1) / a.ct;
  return launch_bwd(dispatch_bwd_kernel<T, SC>, dim3(nch, B),
                    BwdLayout<T, SC, false>::kBytes, a, stream);
}

template <typename T>
cudaError_t launch_sc(const BwdArgs& a, int B, cudaStream_t stream) {
  switch (slot_tile_units(a.S)) {
    case 1: return launch<T, 1>(a, B, stream);
    case 2: return launch<T, 2>(a, B, stream);
    default: return launch<T, 4>(a, B, stream);
  }
}

}  // namespace

// Plain C entry point for ctypes. dtype code of x, g_slots, slots and
// dx: 0 = float32, 1 = bfloat16; Phi_n, the statistics and dPhi_n are
// float32. Every pointer is a device pointer: rn and inv_n (B*m floats
// each), sigma (B*S floats), part_phi (B * ceil(m / ct) * S * d floats)
// and, when S > 128, dx_acc (B*m*d floats; may be null otherwise) are
// scratch the caller allocates. ct is the tokens of a chunk (1..64).
// `stream` is a cudaStream_t. Launches the pre-pass (the norms and sigma
// = g_slots . slots), the main kernel and the partials' sum, and returns
// the first cudaError_t (0 = success). Shapes the kernels do not take (ct
// outside 1..64, d not a multiple of 8, operands not 16-byte aligned)
// return cudaErrorInvalidValue without launching.
extern "C" int soft_moe_dispatch_bwd_launch(
    const void* x, const void* phi, const void* g_slots, const void* slots,
    const void* d_mx, const void* d_den, void* dx, void* dphi, void* rn,
    void* inv_n, void* sigma, void* dx_acc, void* part_phi, int dtype, int B,
    int m, int d, int S, int ct, void* stream) {
  if (!bwd_shapes_ok(dtype, B, m, d, S, ct) || !aligned16(x) ||
      !aligned16(g_slots) || !aligned16(dx) || !aligned16(part_phi) ||
      (S > 128 && (dx_acc == nullptr || !aligned16(dx_acc)))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rn_f = static_cast<float*>(rn);
  float* inv_f = static_cast<float*>(inv_n);
  float* sig_f = static_cast<float*>(sigma);
  BwdArgs a;
  a.x = x;
  a.phi = static_cast<const float*>(phi);
  a.g = g_slots;
  a.ys = nullptr;
  a.mx = static_cast<const float*>(d_mx);
  a.den = static_cast<const float*>(d_den);
  a.rowdot = sig_f;
  a.rn = rn_f;
  a.inv_n = inv_f;
  a.dx = dx;
  a.dx_acc = static_cast<float*>(dx_acc);
  a.part_phi = static_cast<float*>(part_phi);
  a.part_ys = nullptr;
  a.m = m;
  a.d = d;
  a.S = S;
  a.ct = ct;
  a.phi_vec = S % 4 == 0 && aligned16(phi);
  const int nch = (m + ct - 1) / ct;
  if (B > 0) {
    const long long n_tok = (long long)B * m, n_dot = (long long)B * S;
    cudaError_t e =
        dtype == 0
            ? launch_prepass<float>(x, rn_f, inv_f, n_tok, g_slots, slots,
                                    sig_f, n_dot, d, s)
            : launch_prepass<__nv_bfloat16>(x, rn_f, inv_f, n_tok, g_slots,
                                            slots, sig_f, n_dot, d, s);
    if (e != cudaSuccess) return (int)e;
    e = dtype == 0 ? launch_sc<float>(a, B, s)
                   : launch_sc<__nv_bfloat16>(a, B, s);
    if (e != cudaSuccess) return (int)e;
  }
  // B = 0 still writes dPhi_n: an empty sum is 0.
  return (int)launch_dphi_reduce(a.part_phi, static_cast<float*>(dphi), B,
                                 nch, S, d, s);
}

// Dynamic shared memory (bytes) of one CTA of the main kernel for x's
// dtype code and S slots, as the launch asks for it.
extern "C" int soft_moe_dispatch_bwd_smem_bytes(int dtype, int S) {
  return bwd_smem_bytes<false>(dtype, S);
}
