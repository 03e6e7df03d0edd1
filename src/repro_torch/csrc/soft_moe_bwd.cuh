// Shared bodies of the Soft-MoE backward kernels for Hopper (sm_90a): K4
// (soft_moe_dispatch_bwd.cu) and K5 (soft_moe_combine_bwd.cu).
//
// Both recompute the logits tile l2norm(x) . Phi_n from the forward's saved
// softmax statistics instead of reading an (m x S) tensor, as the TPU
// kernels do (src/repro/kernels/soft_moe_kernels.py:473-527, :594-656):
//
//   dispatch  D = exp(L - d_mx[s]) / d_den[s]   dL = D (x_t . g_s - sigma_s)
//   combine   C = exp(L - c_mx[t]) / c_den[t]   dL = C (g_t . Ys_s - rho_t)
//
// with sigma_s = g_s . slots_s and rho_t = g_t . y_t computed outside
// (O(S d) and O(m d) reductions, as the JAX wrappers do).
//
// Two bodies, each one CTA of 256 threads over a 32 x 32 tile:
//   * bwd_dx_body: one CTA per (d-chunk, token block, row) loops over the
//     row's slot blocks (the TPU kernel's sequential slot axis) and
//     accumulates dx for its tokens over the chunk in registers. The TPU
//     kernel carries two (bt x d) accumulators, acc_raw and acc_n, and
//     finishes with dx = acc_raw + r acc_n - (r^2 inv_n proj) x, where
//     proj = sum_d x . acc_n needs the whole of d. Here one accumulator
//     takes acc_raw + r acc_n (D g + (r dL) Phi_n^T), and proj comes from
//     the logits tile the CTA already holds:
//       proj_t = sum_d x_t . sum_s dL_ts Phi_n[:, s] = sum_s dL_ts (x_t . Phi_n[:, s]),
//     so no reduction crosses d-chunks. Two accumulators of (32 x 768) f32
//     would take 192 registers a thread.
//   * bwd_slot_body: one CTA per (d-chunk, slot block, row) loops over the
//     row's token blocks and accumulates one (slots x chunk) output: dYs =
//     C^T g (K5), or the row's share of dPhi_n^T = sum_t (r dL)^T x (K4,
//     K5). dPhi_n sums over rows; each CTA writes its row's partial and
//     dphi_reduce_kernel sums the partials in row order (no atomics, so
//     dPhi_n is bitwise the same from run to run, and each row's partial
//     is what a batch-1 call computes). dYs and dPhi_n are separate
//     launches of the same body (one accumulator each): both together
//     would take 192 registers a thread.
// Every reduction stays in one CTA in a fixed order, so rows of dx and dYs
// of a batched launch equal batch-1 launches bitwise. Pad tokens and pad
// slots of the last blocks get zero weights (the TPU wrappers pad the
// stats with (max 0, denom 1) and g, sigma, rho with zeros instead).
// f32 FMA on the CUDA cores, as K1-K3.
#pragma once

#include "soft_moe_common.cuh"

namespace smoe {

struct BwdArgs {
  const void* x;        // (B, m, d) tokens
  const float* phi;     // (d, S) Phi_n
  const void* g;        // K4: d slots (B, S, d); K5: d y (B, m, d)
  const void* ys;       // K5: expert outputs (B, S, d); K4: unused
  const float* mx;      // K4: d_mx (B, S); K5: c_mx (B, m)
  const float* den;     // K4: d_den (B, S); K5: c_den (B, m)
  const float* rowdot;  // K4: sigma (B, S); K5: rho (B, m)
  const float* rn;      // (B, m) 1 / (||x|| + eps) from norms_kernel
  const float* inv_n;   // (B, m) 1 / max(||x||, eps), 0 where ||x|| = 0
  void* dx;             // (B, m, d)
  void* dys;            // K5: (B, S, d)
  float* dphi_part;     // (B, S, d) per-row dPhi_n^T partials
  int m, d, S, bt, bs;
};

enum SlotMode { kDispatchDphi = 0, kCombineDys = 1, kCombineDphi = 2 };

constexpr int kLd = kTile + 1;  // row stride of a 32 x 32 weight tile

// The dot tiles' staging (LogitsSmem, then RowsSmem) and the weight tiles
// are live at different times (each dot ends synchronised before the
// weights are written; the weights are read before the next tile's
// staging): they share one region at the front of shared memory. That
// keeps a body under 113 KB, so two CTAs fit an SM; the kernels ask
// ptxas for two (__launch_bounds__(kThreads, 2): at most 128 registers a
// thread, where it would otherwise take up to 178 at 768-column chunks).
constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }
constexpr size_t kStageBytes =
    (cmax(cmax(sizeof(LogitsSmem), sizeof(RowsSmem)),
          2 * kTile * kLd * sizeof(float)) + 15) / 16 * 16;

template <int NV>
constexpr size_t dx_smem_bytes() {
  return kStageBytes + sizeof(float) * (kTile * (128 * NV + 4) + kTile);
}

template <int NV>
constexpr size_t slot_smem_bytes() {
  return kStageBytes + sizeof(float) * kTile * 128 * NV;
}

// Rows [0, n) of src (row stride d), columns [c0, c0 + DC), into dst as
// f32 (row stride vs); rows past n and columns past d are zeros.
template <typename T, int DC>
__device__ __forceinline__ void stage_rows(float* dst, int vs, const T* src,
                                           int n, int d, int c0, int tid) {
  for (int i = tid; i < kTile * (DC / 4); i += kThreads) {
    const int r = i / (DC / 4), c = 4 * (i - r * (DC / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n && c0 + c < d) v = load4(src + (size_t)r * d + c0 + c);
    *reinterpret_cast<float4*>(&dst[r * vs + c]) = v;
  }
}

// acc[i][q, e] += sum_{k < n} W[(4 warp + i) * wi + k * wk] V[k, q * 128 +
// 4 lane + e]: this thread's 4 rows (tokens or slots) of a weight tile
// times the staged chunk V (row stride vs), summed over k in order.
template <int NV>
__device__ __forceinline__ void mix(float (&acc)[4][4 * NV], const float* W,
                                    int wi, int wk, const float* V, int vs,
                                    int n, int warp, int lane) {
  for (int k = 0; k < n; ++k) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = W[(4 * warp + i) * wi + k * wk];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(&V[k * vs + q * 128 + 4 * lane]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * q + 0] = fmaf(p[i], v.x, acc[i][4 * q + 0]);
        acc[i][4 * q + 1] = fmaf(p[i], v.y, acc[i][4 * q + 1]);
        acc[i][4 * q + 2] = fmaf(p[i], v.z, acc[i][4 * q + 2]);
        acc[i][4 * q + 3] = fmaf(p[i], v.w, acc[i][4 * q + 3]);
      }
    }
  }
}

// dx of one (d-chunk, token block, row): DISPATCH = K4, else K5.
template <typename T, int NV, bool DISPATCH>
__device__ __forceinline__ void bwd_dx_body(const BwdArgs& a) {
  constexpr int DC = 128 * NV;
  constexpr int VS = DC + 4;  // keeps the transposed Phi_n stores 4-way
  const int jc = blockIdx.x, jt = blockIdx.y, row = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const int m = a.m, d = a.d, S = a.S;
  const int t0 = jt * a.bt, nt = min(a.bt, m - t0);
  const int c0 = jc * DC;

  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  LogitsSmem& lsm = *reinterpret_cast<LogitsSmem*>(base);
  RowsSmem& rsm = *reinterpret_cast<RowsSmem*>(base);
  float* W1 = reinterpret_cast<float*>(base);  // D (K4)
  float* W2 = W1 + kTile * kLd;                // rn * dL
  float* vc = reinterpret_cast<float*>(base + kStageBytes);  // [kTile][VS]
  float* proj_s = vc + kTile * VS;             // proj per token

  const size_t tok0 = (size_t)row * m + t0;
  const T* xt = static_cast<const T*>(a.x) + tok0 * d;
  const T* g = static_cast<const T*>(a.g);
  // Thread (ty, tx) of the logits tile holds tokens 2 ty + i, slots 2 tx + j.
  float rt[2], tmx[2] = {0.f, 0.f}, tden[2] = {1.f, 1.f}, trho[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = 2 * ty + i;
    rt[i] = t < nt ? a.rn[tok0 + t] : 0.f;
    if (!DISPATCH && t < nt) {
      tmx[i] = a.mx[tok0 + t];
      tden[i] = a.den[tok0 + t];
      trho[i] = a.rowdot[tok0 + t];
    }
  }
  // Thread owns tokens 4 * warp + i and columns q * 128 + 4 * lane + e.
  float acc[4][4 * NV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int v = 0; v < 4 * NV; ++v) acc[i][v] = 0.f;
  float proj[2] = {0.f, 0.f};

  for (int s0 = 0; s0 < S; s0 += a.bs) {
    const int ns = min(a.bs, S - s0);
    float dp[2][2], dg[2][2];
    logits_tile<T>(xt, nt, a.phi + s0, S, ns, d, lsm, dp, nullptr, 0, 0, tid);
    if (DISPATCH) {  // x_t . g_s
      rows_dot_tile<T>(xt, nt, g + ((size_t)row * S + s0) * d, ns, d, rsm,
                       dg, tid);
    } else {  // g_t . Ys_s
      rows_dot_tile<T>(g + tok0 * d, nt,
                       static_cast<const T*>(a.ys) + ((size_t)row * S + s0) * d,
                       ns, d, rsm, dg, tid);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = 2 * ty + i, s = 2 * tx + j;
        float w1 = 0.f, dl = 0.f;
        if (t < nt && s < ns) {
          const float lg = rt[i] * dp[i][j];
          if (DISPATCH) {
            const size_t k = (size_t)row * S + s0 + s;
            w1 = expf(lg - a.mx[k]) / a.den[k];
            dl = w1 * (dg[i][j] - a.rowdot[k]);
          } else {
            const float c = expf(lg - tmx[i]) / tden[i];
            dl = c * (dg[i][j] - trho[i]);
          }
        }
        proj[i] = fmaf(dl, dp[i][j], proj[i]);
        if (DISPATCH) W1[t * kLd + s] = w1;
        W2[t * kLd + s] = rt[i] * dl;
      }
    }
    if (DISPATCH) {  // D g over the chunk
      stage_rows<T, DC>(vc, VS, g + ((size_t)row * S + s0) * d, ns, d, c0,
                        tid);
      __syncthreads();
      mix<NV>(acc, W1, kLd, 1, vc, VS, ns, warp, lane);
      __syncthreads();
    }
    // (rn dL) Phi_n^T over the chunk; lanes along slots read Phi_n's rows
    for (int i = tid; i < kTile * DC; i += kThreads) {
      const int c = i / kTile, s = i - c * kTile;
      vc[s * VS + c] =
          (s < ns && c0 + c < d) ? a.phi[(size_t)(c0 + c) * S + s0 + s] : 0.f;
    }
    __syncthreads();
    mix<NV>(acc, W2, kLd, 1, vc, VS, ns, warp, lane);
    __syncthreads();  // the staging buffers and weight tiles are refilled next
  }

  // proj per token: the 16 threads of a token pair are 16 adjacent lanes
#pragma unroll
  for (int i = 0; i < 2; ++i)
    for (int o = 8; o > 0; o >>= 1)
      proj[i] += __shfl_xor_sync(0xffffffffu, proj[i], o);
  if (tx == 0) {
    proj_s[2 * ty] = proj[0];
    proj_s[2 * ty + 1] = proj[1];
  }
  __syncthreads();
  T* out = static_cast<T*>(a.dx) + tok0 * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * warp + i;
    if (t >= nt) continue;
    const float r = a.rn[tok0 + t];
    const float coef = r * r * a.inv_n[tok0 + t] * proj_s[t];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + q * 128 + 4 * lane + e;
        if (col < d) {
          const float xv = to_f32(xt[(size_t)t * d + col]);
          out[(size_t)t * d + col] = from_f32<T>(acc[i][4 * q + e] - coef * xv);
        }
      }
    }
  }
}

// One (slots x chunk) output of one (d-chunk, slot block, row), by MODE:
// kDispatchDphi (K4) and kCombineDphi (K5) write the row's dPhi_n^T
// partial, kCombineDys (K5) writes dYs.
template <typename T, int NV, int MODE>
__device__ __forceinline__ void bwd_slot_body(const BwdArgs& a) {
  constexpr int DC = 128 * NV;
  constexpr bool DPHI = MODE != kCombineDys;
  const int jc = blockIdx.x, js = blockIdx.y, row = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const int m = a.m, d = a.d, S = a.S;
  const int s0 = js * a.bs, ns = min(a.bs, S - s0);
  const int c0 = jc * DC;

  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  LogitsSmem& lsm = *reinterpret_cast<LogitsSmem*>(base);
  RowsSmem& rsm = *reinterpret_cast<RowsSmem*>(base);
  float* W = reinterpret_cast<float*>(base);  // [token][slot]
  float* vc = reinterpret_cast<float*>(base + kStageBytes);  // [kTile][DC]

  // dPhi_n mixes x from logits_tile's copy, which never stages columns
  // past d: they stay 0.
  if (DPHI)
    for (int i = tid; i < kTile * DC; i += kThreads) vc[i] = 0.f;
  float smx[2] = {0.f, 0.f}, sden[2] = {1.f, 1.f}, ssig[2] = {0.f, 0.f};
  if (MODE == kDispatchDphi) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int s = 2 * tx + j;
      if (s < ns) {
        const size_t k = (size_t)row * S + s0 + s;
        smx[j] = a.mx[k];
        sden[j] = a.den[k];
        ssig[j] = a.rowdot[k];
      }
    }
  }
  // Thread owns slots 4 * warp + i and columns q * 128 + 4 * lane + e.
  float acc[4][4 * NV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int v = 0; v < 4 * NV; ++v) acc[i][v] = 0.f;

  const T* xrow = static_cast<const T*>(a.x) + (size_t)row * m * d;
  const T* g = static_cast<const T*>(a.g);
  const float* rn = a.rn + (size_t)row * m;
  __syncthreads();

  for (int t0 = 0; t0 < m; t0 += a.bt) {
    const int nt = min(a.bt, m - t0);
    float dp[2][2], dg[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    logits_tile<T>(xrow + (size_t)t0 * d, nt, a.phi + s0, S, ns, d, lsm, dp,
                   DPHI ? vc : nullptr, c0, DC, tid);
    if (MODE == kDispatchDphi) {  // x_t . g_s
      rows_dot_tile<T>(xrow + (size_t)t0 * d, nt,
                       g + ((size_t)row * S + s0) * d, ns, d, rsm, dg, tid);
    } else if (MODE == kCombineDphi) {  // g_t . Ys_s
      rows_dot_tile<T>(g + ((size_t)row * m + t0) * d, nt,
                       static_cast<const T*>(a.ys) + ((size_t)row * S + s0) * d,
                       ns, d, rsm, dg, tid);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = 2 * ty + i, s = 2 * tx + j;
        float w = 0.f;
        if (t < nt && s < ns) {
          const float r = rn[t0 + t];
          const float lg = r * dp[i][j];
          if (MODE == kDispatchDphi) {
            const float p = expf(lg - smx[j]) / sden[j];
            w = r * (p * (dg[i][j] - ssig[j]));
          } else {
            const size_t k = (size_t)row * m + t0 + t;
            const float c = expf(lg - a.mx[k]) / a.den[k];
            w = MODE == kCombineDys ? c : r * (c * (dg[i][j] - a.rowdot[k]));
          }
        }
        W[t * kLd + s] = w;
      }
    }
    if (MODE == kCombineDys)  // this token block's rows of g
      stage_rows<T, DC>(vc, DC, g + ((size_t)row * m + t0) * d, nt, d, c0,
                        tid);
    __syncthreads();
    mix<NV>(acc, W, 1, kLd, vc, DC, nt, warp, lane);
    __syncthreads();  // the staging buffers and weight tile are refilled next
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = 4 * warp + i;
    if (s >= ns) continue;
    const size_t o = ((size_t)row * S + s0 + s) * d;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int col = c0 + q * 128 + 4 * lane;  // d % 8 == 0: all 4 or none
      if (col >= d) continue;
      if (DPHI) {
        *reinterpret_cast<float4*>(&a.dphi_part[o + col]) =
            make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                        acc[i][4 * q + 3]);
      } else {
        T* dys = static_cast<T*>(a.dys) + o + col;
#pragma unroll
        for (int e = 0; e < 4; ++e) dys[e] = from_f32<T>(acc[i][4 * q + e]);
      }
    }
  }
}

// dPhi_n[c, s] = sum over rows, in row order, of part[row, s, c]; one
// thread per element (reads coalesced along d).
__global__ void __launch_bounds__(kThreads)
    dphi_reduce_kernel(const float* part, float* dphi, int B, int S, int d) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n = (long long)S * d;
  if (i >= n) return;
  const long long s = i / d, c = i - s * d;
  float acc = 0.f;
  for (int row = 0; row < B; ++row) acc += part[(size_t)row * n + i];
  dphi[(size_t)c * S + s] = acc;
}

inline cudaError_t launch_dphi_reduce(const float* part, float* dphi, int B,
                                      int S, int d, cudaStream_t stream) {
  const long long n = (long long)S * d;
  dphi_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                       stream>>>(part, dphi, B, S, d);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t launch_body(Kernel kernel, dim3 grid, size_t smem,
                        const BwdArgs& a, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Shapes the backward kernels do not take return false (the entry points
// then return cudaErrorInvalidValue without launching).
inline bool bwd_shapes_ok(int dtype, int B, int m, int d, int S, int bt,
                          int bs, int d_chunk) {
  return B >= 0 && B <= 65535 && m > 0 && d > 0 && S > 0 && bt >= 1 &&
         bt <= kTile && bs >= 1 && bs <= kTile && dtype >= 0 && dtype <= 1 &&
         valid_d_chunk(d_chunk) && d % 8 == 0;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace smoe
