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
// What bounds it on the H100: arithmetic. The logits are 2 m S d flops a
// row in f32 on the CUDA cores; the weights and their sums O(m S). At the
// granite-moe-1b-a400m+soft layer (B=8, m=2048, d=1024, S=32, bf16 x) that
// is ~1.07 GFLOP (~16 us at 67 TFLOP/s) against ~34 MB of x (~10 us at
// 3.35 TB/s).
//
// Design (the TPU kernel's grid (b, slot block, token block) runs in order:
// it sums the per-slot outputs over consecutive token blocks in scratch and
// keeps the per-token outputs in a full-length scratch across the slot-block
// axis, written out on every visit with the last write winning; CUDA blocks
// run in no order):
//   * A pre-pass computes every token's inverse L2 norm (O(B m d) reads).
//   * One CTA per (token chunk, slot block of 32, row). A chunk is `tiles`
//     token blocks (HEALTH_TILES in kernels/tuning.py), so the grid fills
//     the card at a few rows and 32 slots. For each 32 x 32 logits tile the
//     CTA loops over all of d (the outputs are O(m + S): there is no (bs x
//     d) accumulator, so no d-chunk split and no logits recompute).
//   * The CTA sums its slot block's disp_entropy and importance over its
//     chunk in shared memory and writes them as the chunk's partial
//     (B, n_chunks, S); each token's comb_entropy and token_contrib over
//     the slot block is the block's partial (B, n_slot_blocks, m).
//   * A second kernel sums the partials in chunk and slot-block order: no
//     atomics, and every reduction stays inside one row in a fixed order,
//     so row i of a batched launch equals a batch-1 launch bitwise (the
//     per-row invariant of src/repro/kernels/ops.py).
//   * Pad tokens and pad slots of the last blocks are skipped: the TPU
//     kernel masks them at -1e30, where their terms are exactly zero.
//   * f32 arithmetic on the CUDA cores, as the TPU kernel's.
#include "soft_moe_common.cuh"

namespace {

using namespace smoe;

struct HealthArgs {
  const void* x;          // (B, m, d)
  const float* phi;       // (d, S)
  const float* rn;        // (B, m) inverse norms from the pre-pass
  const float* d_mx;      // (B, S)
  const float* d_den;     // (B, S)
  const float* c_mx;      // (B, m)
  const float* c_den;     // (B, m)
  float* p_dent;          // (B, nch, S) per-chunk partials
  float* p_imp;           // (B, nch, S)
  float* p_cent;          // (B, nsb, m) per-slot-block partials
  float* p_contrib;       // (B, nsb, m)
  int m, d, S, bt, bs, tiles, nch, nsb;
};

constexpr int kLd = kTile + 1;  // row stride of a 32 x 32 tile

// One CTA per (token chunk, slot block, row).
template <typename T>
__global__ void __launch_bounds__(kThreads) health_kernel(HealthArgs a) {
  const int jc = blockIdx.x, js = blockIdx.y, row = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = a.m, d = a.d, S = a.S;
  const int s0 = js * a.bs, ns = min(a.bs, S - s0);
  const int t_begin = jc * a.bt * a.tiles;
  const int t_end = min(m, t_begin + a.bt * a.tiles);

  __shared__ LogitsSmem lsm;
  __shared__ float L[kTile * kLd];    // logits of the tile
  __shared__ float wd[kTile * kLd];   // D
  __shared__ float wdl[kTile * kLd];  // D log D
  __shared__ float wc[kTile * kLd];   // C
  __shared__ float wcl[kTile * kLd];  // C log C
  __shared__ float dmx_s[kTile], ldden_s[kTile], cmx_s[kTile], lcden_s[kTile];
  __shared__ float dent_s[kTile], imp_s[kTile];

  if (tid < kTile) {
    const size_t k = (size_t)row * S + s0 + tid;
    dmx_s[tid] = tid < ns ? a.d_mx[k] : 0.f;
    ldden_s[tid] = tid < ns ? logf(a.d_den[k]) : 0.f;
    dent_s[tid] = 0.f;
    imp_s[tid] = 0.f;
  }
  const T* xrow = static_cast<const T*>(a.x) + (size_t)row * m * d;
  const float* rn = a.rn + (size_t)row * m;
  float* pcent = a.p_cent + ((size_t)row * a.nsb + js) * m;
  float* pcontrib = a.p_contrib + ((size_t)row * a.nsb + js) * m;
  __syncthreads();

  for (int t0 = t_begin; t0 < t_end; t0 += a.bt) {
    const int nt = min(a.bt, m - t0);
    if (tid < kTile) {
      const size_t k = (size_t)row * m + t0 + tid;
      cmx_s[tid] = tid < nt ? a.c_mx[k] : 0.f;
      lcden_s[tid] = tid < nt ? logf(a.c_den[k]) : 0.f;
    }
    float dot[2][2];
    logits_tile<T>(xrow + (size_t)t0 * d, nt, a.phi + s0, S, ns, d, lsm, dot,
                   nullptr, 0, 0, tid);
    store_logits(L, dot, rn + t0, nt, tid);
    __syncthreads();

    // The weights and their log-weight products, straight from the shifted
    // logits (no log of a weight is taken); pad entries are zeros.
    for (int i = tid; i < kTile * kTile; i += kThreads) {
      const int t = i / kTile, s = i - t * kTile;
      float vd = 0.f, vdl = 0.f, vc = 0.f, vcl = 0.f;
      if (t < nt && s < ns) {
        const float lg = L[t * kLd + s];
        const float lnd = lg - dmx_s[s] - ldden_s[s];
        vd = expf(lnd);
        vdl = vd * lnd;
        const float lnc = lg - cmx_s[t] - lcden_s[t];
        vc = expf(lnc);
        vcl = vc * lnc;
      }
      wd[t * kLd + s] = vd;
      wdl[t * kLd + s] = vdl;
      wc[t * kLd + s] = vc;
      wcl[t * kLd + s] = vcl;
    }
    __syncthreads();

    // Per slot, over the tile's tokens: one warp a slot, lane = token.
    for (int s = warp; s < ns; s += kWarps) {
      const float e = warp_sum(wdl[lane * kLd + s]);
      const float c = warp_sum(wc[lane * kLd + s]);
      if (lane == 0) {
        dent_s[s] -= e;
        imp_s[s] += c;
      }
    }
    // Per token, over the block's slots: one warp a token, lane = slot.
    for (int t = warp; t < nt; t += kWarps) {
      const float e = warp_sum(wcl[t * kLd + lane]);
      const float c = warp_sum(wd[t * kLd + lane]);
      if (lane == 0) {
        pcent[t0 + t] = -e;
        pcontrib[t0 + t] = c;
      }
    }
    __syncthreads();  // L, the weights and the stats are refilled next
  }
  if (tid < ns) {
    const size_t k = ((size_t)row * a.nch + jc) * S + s0 + tid;
    a.p_dent[k] = dent_s[tid];
    a.p_imp[k] = imp_s[tid];
  }
}

// Sum the partials in order from 0: per slot over the token chunks, per
// token over the slot blocks. Threads [0, B S) take the slots, the rest the
// tokens.
__global__ void __launch_bounds__(kThreads)
    health_merge_kernel(HealthArgs a, int B, float* dent, float* imp,
                        float* cent, float* contrib) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n_slots = (long long)B * a.S;
  if (i < n_slots) {
    const long long row = i / a.S, s = i - row * a.S;
    float e = 0.f, c = 0.f;
    for (int j = 0; j < a.nch; ++j) {
      const size_t k = ((size_t)row * a.nch + j) * a.S + s;
      e += a.p_dent[k];
      c += a.p_imp[k];
    }
    dent[i] = e;
    imp[i] = c;
    return;
  }
  i -= n_slots;
  if (i >= (long long)B * a.m) return;
  const long long row = i / a.m, t = i - row * a.m;
  float e = 0.f, c = 0.f;
  for (int j = 0; j < a.nsb; ++j) {
    const size_t k = ((size_t)row * a.nsb + j) * a.m + t;
    e += a.p_cent[k];
    c += a.p_contrib[k];
  }
  cent[i] = e;
  contrib[i] = c;
}

}  // namespace

// Plain C entry point for ctypes. dtype code of x: 0 = float32,
// 1 = bfloat16; Phi_n, the stats and every output are float32. Every
// pointer is a device pointer: rn (B*m floats), p_dent / p_imp (B*nch*S
// floats each, nch = ceil(m / (bt * tiles))) and p_cent / p_contrib
// (B*nsb*m floats each, nsb = ceil(S / bs)) are scratch the caller
// allocates. `stream` is a cudaStream_t. Launches the norm pre-pass, the
// main kernel and the merge, and returns the first cudaError_t (0 =
// success). Shapes the kernel does not take (bt or bs outside 1..32, tiles
// < 1) return cudaErrorInvalidValue without launching.
extern "C" int soft_moe_routing_health_launch(
    const void* x, const void* phi, const void* d_mx, const void* d_den,
    const void* c_mx, const void* c_den, void* dent, void* imp, void* cent,
    void* contrib, void* rn, void* p_dent, void* p_imp, void* p_cent,
    void* p_contrib, int dtype, int B, int m, int d, int S, int bt, int bs,
    int tiles, void* stream) {
  if (B < 0 || B > 65535 || m <= 0 || d <= 0 || S <= 0 || bt < 1 ||
      bt > kTile || bs < 1 || bs > kTile || tiles < 1 || dtype < 0 ||
      dtype > 1) {
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
  a.p_dent = static_cast<float*>(p_dent);
  a.p_imp = static_cast<float*>(p_imp);
  a.p_cent = static_cast<float*>(p_cent);
  a.p_contrib = static_cast<float*>(p_contrib);
  a.m = m;
  a.d = d;
  a.S = S;
  a.bt = bt;
  a.bs = bs;
  a.tiles = tiles;
  a.nch = (m + bt * tiles - 1) / (bt * tiles);
  a.nsb = (S + bs - 1) / bs;
  if (a.nch > 65535 || a.nsb > 65535) return (int)cudaErrorInvalidValue;
  const long long n_tokens = (long long)B * m;
  cudaError_t e = dtype == 0
      ? launch_inv_norm<float>(x, static_cast<float*>(rn), n_tokens, d, s)
      : launch_inv_norm<__nv_bfloat16>(x, static_cast<float*>(rn), n_tokens, d, s);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.nch, a.nsb, B);
  if (dtype == 0) {
    health_kernel<float><<<grid, kThreads, 0, s>>>(a);
  } else {
    health_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n_out = (long long)B * S + n_tokens;
  health_merge_kernel<<<(unsigned)((n_out + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      a, B, static_cast<float*>(dent), static_cast<float*>(imp),
      static_cast<float*>(cent), static_cast<float*>(contrib));
  return (int)cudaGetLastError();
}
