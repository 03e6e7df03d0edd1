// K6, Soft-MoE routing health for Hopper (sm_90a): the paper's Fig. 9
// statistics of the dispatch and combine weights, recomputed tile-wise from
// K1's saved softmax statistics, reduced to O(m + S) outputs.
//
// Replaces the TPU kernel src/repro/kernels/soft_moe_kernels.py
// `routing_health_pallas` (body `_routing_health_kernel`, pallas_call at
// :327). The PyTorch wrapper and the plain version that repeats this
// arithmetic are in src/repro_torch/kernels/soft_moe_kernels.py.
//
// What it computes, per batch row (x: (B, m, d), Phi_n: (d, S) f32, the
// stats f32):
//   L[t, s] = l2norm(x[t]) . Phi_n[:, s]                    (f32)
//   D[t, s] = exp(L - d_mx[s]) / d_den[s]  (log D = L - d_mx - log d_den)
//   C[t, s] = exp(L - c_mx[t]) / c_den[t]
//   disp_entropy[s]  = -sum_t D log D      importance[s]    = sum_t C
//   comb_entropy[t]  = -sum_s C log C      token_contrib[t] = sum_s D
// No (m x S) logits or weights tensor reaches device memory.
//
// What bounds it on the H100: at the f32 rate, arithmetic (the logits, 2 m
// S d flops a row: ~1.07 GFLOP at the granite-moe-1b-a400m+soft layer, B=8,
// m=2048, d=1024, S=32, bf16 x, ~16 us at 67 TFLOP/s, against ~34 MB). On
// the tensor cores the logits take two TF32 passes (bf16 x; three for f32
// x), ~4.3 us at the dense TF32 peak, so the bytes bind: x read by the norm
// pre-pass and again by the main kernel, ~67 MB, ~20 us
// (chip_smoke.py::health_design_bound).
//
// Design (the TPU kernel's grid (b, slot block, token block) runs in order:
// it carries the per-slot sums over token blocks in scratch and the
// per-token sums in a full-length scratch across the slot-block axis; CUDA
// blocks run in no order). It is K2's body (soft_moe_combine.cu) with the
// four sums in place of the mix:
//   * A pre-pass computes every token's inverse L2 norm (inv_norm_kernel).
//   * One CTA per (token chunk, row); a chunk is `ct` tokens
//     (kernels/tuning.py::combine_chunk, at most kCT = 64), fixed whatever
//     the batch. For each tile of up to 128 slots (SC x 32, a template
//     parameter) the CTA forms its (chunk x slot tile) logits once over the
//     whole of d on the tensor cores (soft_moe_mma.cuh::logits_tile_mma,
//     split TF32: f32 accuracy) into shared memory.
//   * From that tile, in one pass that forms each weight once: a warp per
//     token sums C log C and D over the tile's slots, carried across the
//     slot tiles in order, so a token's comb_entropy and token_contrib are
//     whole in its CTA and written once; each lane sums D log D and C of
//     its slots over the warp's tokens, and the warps' sums are added in
//     order: the chunk's per-slot partial (B, n_chunks, S).
//   * A second kernel sums the chunk partials in chunk order. No atomics:
//     every reduction stays inside one row in a fixed order, so row i of a
//     batched launch equals a batch-1 launch bitwise (the per-row invariant
//     of src/repro/kernels/ops.py).
//   * Pad tokens (rows of the 16-row m-tiles past the chunk) and pad slots
//     (columns past S) are skipped; the TPU kernel masks them at -1e30,
//     where their terms are exactly zero. No log of a weight is taken: the
//     w log w terms come from the shifted logits. expf and logf are the
//     accurate ones.
#include "soft_moe_mma.cuh"

namespace {

using namespace smoe;

constexpr int kCT = 64;  // tokens a CTA holds: a chunk is at most this

struct HealthArgs {
  const void* x;       // (B, m, d)
  const float* phi;    // (d, S)
  const float* rn;     // (B, m) inverse norms from the pre-pass
  const float* d_mx;   // (B, S)
  const float* d_den;  // (B, S)
  const float* c_mx;   // (B, m)
  const float* c_den;  // (B, m)
  float* dent;         // (B, nch, S) the chunks' per-slot partials
  float* imp;          // (B, nch, S)
  float* cent;         // (B, m)
  float* contrib;      // (B, m)
  int m, d, S, ct, nch;
  bool phi_vec;        // Phi_n rows 16-byte aligned (S % 4 == 0)
};

// Shared memory of one CTA (bytes): the logits tile [kCT][WS]; per token
// rn, c_mx, log c_den and the running comb_entropy and token_contrib; per
// slot of the tile d_mx and log d_den; the warps' per-slot sums
// [2][kWarps][STC]; then the logits loop's kStages.
template <typename T, int SC>
struct HealthLayout {
  static constexpr int STC = 32 * SC;  // slots of a slot tile
  static constexpr int WS = STC + 4;   // logits rows (4 mod 32 floats)
  static constexpr size_t kPre =
      ((size_t)(kCT * WS + 5 * kCT + 2 * STC + 2 * kWarps * STC) * 4 + 127) /
      128 * 128;
  static constexpr size_t kA = LogitsStage<T, STC>::bytes(kCT);
  static constexpr size_t kBytes = kPre + kStages * kA;
};

template <typename T, int SC>
__global__ void __launch_bounds__(kThreads, 2) health_kernel(HealthArgs a) {
  using Ly = HealthLayout<T, SC>;
  constexpr int STC = Ly::STC, WS = Ly::WS;
  const int chunk = blockIdx.x, row = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = a.m, d = a.d, S = a.S;
  const int t0 = chunk * a.ct, nt = min(a.ct, m - t0);

  extern __shared__ float4 smem4[];
  float* L = reinterpret_cast<float*>(smem4);  // [kCT][WS] logits
  float* trn = L + kCT * WS;                   // per token: rn,
  float* tcmx = trn + kCT;                     //   c_mx,
  float* tlcden = tcmx + kCT;                  //   log c_den,
  float* tcent = tlcden + kCT;                 //   -sum_s C log C so far
  float* tcontrib = tcent + kCT;               //   sum_s D so far
  float* sdmx = tcontrib + kCT;                // per slot of the tile: d_mx
  float* sldden = sdmx + STC;                  //   and log d_den
  float* red = sldden + STC;                   // [2][kWarps][STC] warp sums
  char* stage = reinterpret_cast<char*>(smem4) + Ly::kPre;

  const size_t tok0 = (size_t)row * m + t0;
  const T* x = static_cast<const T*>(a.x) + tok0 * d;
  if (tid < nt) {
    trn[tid] = a.rn[tok0 + tid];
    tcmx[tid] = a.c_mx[tok0 + tid];
    tlcden[tid] = logf(a.c_den[tok0 + tid]);
    tcent[tid] = 0.f;
    tcontrib[tid] = 0.f;
  }
  // (read after the logits loop's first barrier)

  const int nst = (S + STC - 1) / STC;
  for (int js = 0; js < nst; ++js) {
    const int s0 = js * STC, ns = min(STC, S - s0);
    if (tid < ns) {
      const size_t k = (size_t)row * S + s0 + tid;
      sdmx[tid] = a.d_mx[k];
      sldden[tid] = logf(a.d_den[k]);
    }

    // ---- the tile's logits over the whole of d, warps 2 (two 16-token
    // m-tiles each) x 4 (STC / 4 slots), as K2 forms them
    logits_tile_mma<T, 2, 4, 2, SC>(
        x, nt, a.phi, S, s0, d, a.phi_vec, stage, Ly::kA, tid,
        [&](int tl, int s, float dot) {
          if (tl < nt) L[tl * WS + s] = trn[tl] * dot;
        });
    __syncthreads();

    // ---- the weights, once each: one warp a token (tokens warp + 8 i),
    // slots lane + 32 k. A token's sums over the tile's slots are a
    // butterfly sum, added to its running sums; a slot's sums over the
    // warp's tokens stay in the lane's registers.
    float se[SC], sc[SC];
#pragma unroll
    for (int k = 0; k < SC; ++k) se[k] = sc[k] = 0.f;
    for (int tl = warp; tl < nt; tl += kWarps) {  // warp-uniform
      const float* lrow = L + tl * WS;
      const float cmx = tcmx[tl], lcden = tlcden[tl];
      float e = 0.f, c = 0.f;
#pragma unroll
      for (int k = 0; k < SC; ++k) {
        const int s = lane + 32 * k;
        if (s < ns) {
          const float lg = lrow[s];
          const float lnd = lg - sdmx[s] - sldden[s];
          const float lnc = lg - cmx - lcden;
          const float wd = expf(lnd), wc = expf(lnc);
          e += wc * lnc;
          c += wd;
          se[k] += wd * lnd;
          sc[k] += wc;
        }
      }
      e = warp_sum(e);
      c = warp_sum(c);
      if (lane == 0) {
        tcent[tl] -= e;
        tcontrib[tl] += c;
      }
    }
#pragma unroll
    for (int k = 0; k < SC; ++k) {
      red[warp * STC + lane + 32 * k] = se[k];
      red[kWarps * STC + warp * STC + lane + 32 * k] = sc[k];
    }
    __syncthreads();
    if (tid < ns) {  // the warps in order: the chunk's per-slot sums
      float e = 0.f, c = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        e += red[w * STC + tid];
        c += red[kWarps * STC + w * STC + tid];
      }
      const size_t k = ((size_t)row * a.nch + chunk) * S + s0 + tid;
      a.dent[k] = -e;
      a.imp[k] = c;
    }
    // L, the slot stats and the warp sums are refilled by the next slot
    // tile after the logits loop's barriers
  }
  if (tid < nt) {
    a.cent[tok0 + tid] = tcent[tid];
    a.contrib[tok0 + tid] = tcontrib[tid];
  }
}

// Sum the chunks' per-slot partials (B, nch, S) in chunk order from 0.
__global__ void __launch_bounds__(kThreads)
    health_merge_kernel(const float* p_dent, const float* p_imp, int nch,
                        int S, long long n_slots, float* dent, float* imp) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_slots) return;
  const long long row = i / S, s = i - row * S;
  float e = 0.f, c = 0.f;
  for (int j = 0; j < nch; ++j) {
    const size_t k = ((size_t)row * nch + j) * S + s;
    e += p_dent[k];
    c += p_imp[k];
  }
  dent[i] = e;
  imp[i] = c;
}

template <typename T, int SC>
cudaError_t launch_health(const HealthArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = HealthLayout<T, SC>::kBytes;
  auto kernel = health_kernel<T, SC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(a.nch, B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_health_sc(const HealthArgs& a, int B,
                             cudaStream_t stream) {
  switch (slot_tile_units(a.S)) {
    case 1: return launch_health<T, 1>(a, B, stream);
    case 2: return launch_health<T, 2>(a, B, stream);
    default: return launch_health<T, 4>(a, B, stream);
  }
}

}  // namespace

// Plain C entry point for ctypes. dtype code of x: 0 = float32,
// 1 = bfloat16; Phi_n, the stats and every output are float32. Every
// pointer is a device pointer: rn (B*m floats) is scratch the caller
// allocates, and so are p_dent / p_imp (B*nch*S floats each, nch =
// ceil(m / ct)). `ct` is the tokens of a chunk (1..64). `stream` is a
// cudaStream_t. Launches the norm pre-pass, the main kernel and the
// merge, and returns the first cudaError_t (0 = success). Shapes the
// kernels do not take (ct out of range, d not a multiple of 8, x not
// 16-byte aligned) return cudaErrorInvalidValue without launching.
extern "C" int soft_moe_routing_health_launch(
    const void* x, const void* phi, const void* d_mx, const void* d_den,
    const void* c_mx, const void* c_den, void* dent, void* imp, void* cent,
    void* contrib, void* rn, void* p_dent, void* p_imp, int dtype, int B,
    int m, int d, int S, int ct, void* stream) {
  if (B < 0 || B > 65535 || m <= 0 || d <= 0 || S <= 0 || ct < 1 ||
      ct > kCT || dtype < 0 || dtype > 1 || d % 8 != 0 || !aligned16(x)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HealthArgs a;
  a.x = x;
  a.phi = static_cast<const float*>(phi);
  a.rn = static_cast<const float*>(rn);
  a.d_mx = static_cast<const float*>(d_mx);
  a.d_den = static_cast<const float*>(d_den);
  a.c_mx = static_cast<const float*>(c_mx);
  a.c_den = static_cast<const float*>(c_den);
  a.dent = static_cast<float*>(p_dent);
  a.imp = static_cast<float*>(p_imp);
  a.cent = static_cast<float*>(cent);
  a.contrib = static_cast<float*>(contrib);
  a.m = m;
  a.d = d;
  a.S = S;
  a.ct = ct;
  a.nch = (m + ct - 1) / ct;
  a.phi_vec = S % 4 == 0 && aligned16(phi);
  const long long n_tokens = (long long)B * m;
  cudaError_t e = dtype == 0
      ? launch_inv_norm<float>(x, static_cast<float*>(rn), n_tokens, d, s)
      : launch_inv_norm<__nv_bfloat16>(x, static_cast<float*>(rn), n_tokens, d, s);
  if (e != cudaSuccess) return (int)e;
  e = dtype == 0 ? launch_health_sc<float>(a, B, s)
                 : launch_health_sc<__nv_bfloat16>(a, B, s);
  if (e != cudaSuccess) return (int)e;
  const long long n_slots = (long long)B * S;
  health_merge_kernel<<<(unsigned)((n_slots + kThreads - 1) / kThreads),
                        kThreads, 0, s>>>(
      static_cast<const float*>(p_dent), static_cast<const float*>(p_imp),
      a.nch, S, n_slots, static_cast<float*>(dent), static_cast<float*>(imp));
  return (int)cudaGetLastError();
}
