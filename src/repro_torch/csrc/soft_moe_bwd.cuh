// The Soft-MoE backward kernels for Hopper (sm_90a): K4
// (soft_moe_dispatch_bwd.cu) and K5 (soft_moe_combine_bwd.cu), one body
// for both, on the tensor cores.
//
// Both recompute the weights from the forward's saved softmax statistics
// instead of reading an (m x S) tensor, as the TPU kernels do
// (src/repro/kernels/soft_moe_kernels.py:473-527, :594-656):
//
//   dispatch  D = exp(L - d_mx[s]) / d_den[s]   dL = D (x_t . g_s - sigma_s)
//   combine   C = exp(L - c_mx[t]) / c_den[t]   dL = C (g_t . Ys_s - rho_t)
//
// with L = rn_t (x_t . Phi_n[:, s]), rn = 1 / (||x|| + eps) from a norm
// pre-pass, and sigma_s = g_s . slots_s, rho_t = g_t . y_t computed
// outside (O(S d) and O(m d) reductions, as the JAX wrappers do). Then
//
//   dX      = D g (K4 only) + rn dL Phi_n^T - rn^2 inv_n proj_t x_t,
//             proj_t = sum_s dL_ts (x_t . Phi_n[:, s])   (the l2-norm VJP)
//   dPhi_n^T = sum_t rn_t dL_ts x_t                        (K4 and K5)
//   dYs      = sum_t C_ts g_t                              (K5)
//
// What bounds it: arithmetic, 10 m S d flops a row (the logits, x . g or
// g . Ys, and three products). The TPU kernels split it into a
// token-major dX kernel and a slot-major one over a sequential grid;
// ported as such, the slot-major grid had b x ceil(S / 32) x
// ceil(d / 768) CTAs, 16 at the granite LM layer (S = 32), each walking
// all the row's tokens with f32 FMA, and the logits were recomputed by
// two bodies (K4) or three (K5).
//
// Design: a pre-pass kernel (one warp a row: the norms, and sigma or
// rho), then one CTA per (token chunk, row), 256 threads. A chunk is
// ``ct`` tokens (tuning.BWD_TILES token blocks, at most kCT = 64), fixed
// whatever the batch, so the grid is ceil(m / ct) x b CTAs at any S. For
// each tile of up to 128 slots (a template parameter, SC x 32 slots):
//   * phase A: the logits and the x . g (K4) or g . Ys (K5) tiles over
//     the whole of d, 32 slots at a time, into registers; then D (or C)
//     and rn dL into shared memory (two kCT x 128 f32 tiles at most);
//   * phase B: over d in tiles of 32 columns, all three products from
//     those weights: dX (complete when the slot tile is the last; an f32
//     scratch carries it between slot tiles when S > 128), and the
//     chunk's dPhi_n^T and dYs partials, written to (b, n_chunks, S, d)
//     f32 buffers. No tile is computed twice: 10 m S d, against 14 (K4)
//     and 16 (K5) for the split bodies.
// A second pass sums the partials with no atomics: dYs over each row's
// chunks in chunk order; dPhi_n over each row's chunks in chunk order and
// the row totals in row order. Row i of a batched call equals a batch-1
// call bitwise, a batch-1 dPhi_n is its row total, and every output is
// bitwise the same from run to run.
//
// Products run on the tensor cores with mma.sync at f32 accuracy (the TPU
// kernels compute in f32; the pieces are in soft_moe_mma.cuh): a bf16
// operand is exact in TF32; an f32 operand is split into a TF32 high part
// and a TF32 low part, and a product takes as many passes as that needs
// (x . g and g . Ys in bf16: one bf16 m16n8k16 pass; one f32 operand: two
// m16n8k8 TF32 passes; two: three, "3xTF32"). Each product sums 32-deep
// slices on the tensor cores into zeroed fragments, the high x high pass
// and the small passes apart (two chains in flight), and adds the slices
// in f32 on the CUDA cores, so the tensor cores' own accumulation never
// runs over the whole of d. Operand tiles are staged with cp.async, the
// next tile's while the current one computes. The weights live in shared
// memory, so the bf16 32-slot body (the granite layer's) fits two CTAs an
// SM; the 128-slot one (B/16's) takes 133 KB of shared memory and one.
#pragma once

#include <type_traits>

#include "soft_moe_mma.cuh"

namespace smoe {

constexpr int kCT = 64;  // tokens a CTA holds: a chunk is at most this
constexpr int kKA = 32;  // d depth of one phase-A stage
constexpr int kSA = 32;  // slots of one phase-A sub-tile
constexpr int kDT = 32;  // d columns of one phase-B tile

struct BwdArgs {
  const void* x;          // (B, m, d) tokens
  const float* phi;       // (d, S) Phi_n
  const void* g;          // K4: d slots (B, S, d); K5: d y (B, m, d)
  const void* ys;         // K5: expert outputs (B, S, d); K4: unused
  const float* mx;        // K4: d_mx (B, S); K5: c_mx (B, m)
  const float* den;       // K4: d_den (B, S); K5: c_den (B, m)
  const float* rowdot;    // K4: sigma (B, S); K5: rho (B, m), from
  const float* rn;        // the pre-pass, as (B, m) 1 / (||x|| + eps)
  const float* inv_n;     // (B, m) 1 / max(||x||, eps), 0 where ||x|| = 0
  void* dx;               // (B, m, d) in x's dtype
  float* dx_acc;          // (B, m, d) f32 scratch, only when S > 128
  float* part_phi;        // (B, n_chunks, S, d) dPhi_n^T partials
  float* part_ys;         // K5: (B, n_chunks, S, d) dYs partials
  int m, d, S, ct;        // ct: tokens of a chunk, 1..kCT
  bool phi_vec;           // Phi_n rows 16-byte aligned (S % 4 == 0)
};

// The pre-pass, one warp a row: for rows [0, n_tok) of x, rn = 1 /
// (||x|| + eps), exactly as inv_norm_kernel computes it, and inv_n = 1 /
// max(||x||, eps), or 0 where ||x|| = 0 (the l2-norm VJP of _l2n_bwd in
// the TPU kernels); for rows [0, n_dot) of u and v, dots = u . v, the
// softmax-VJP row terms (K4: sigma = g_slots . slots; K5: rho = g . y).
// Lanes stride over d, then a butterfly sum: the order is fixed whatever
// the batch.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    prepass_kernel(const T* x, float* rn, float* inv_n, long long n_tok,
                   const T* u, const T* v, float* dots, long long n_dot,
                   int d) {
  const long long w =
      (long long)blockIdx.x * kWarps + (long long)(threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= n_tok + n_dot) return;  // warp-uniform
  const bool norm = w < n_tok;
  const long long r = norm ? w : w - n_tok;
  const T* a = (norm ? x : u) + r * d;
  const T* b = norm ? a : v + r * d;
  float s = 0.f;
  for (int k = lane; k < d; k += 32) s = fmaf(to_f32(a[k]), to_f32(b[k]), s);
  s = warp_sum(s);
  if (lane != 0) return;
  if (norm) {
    const float n = sqrtf(s);
    rn[r] = 1.f / (n + kEps);
    inv_n[r] = n > 0.f ? 1.f / fmaxf(n, kEps) : 0.f;
  } else {
    dots[r] = s;
  }
}

template <typename T>
cudaError_t launch_prepass(const void* x, float* rn, float* inv_n,
                           long long n_tok, const void* u, const void* v,
                           float* dots, long long n_dot, int d,
                           cudaStream_t stream) {
  const long long blocks = (n_tok + n_dot + kWarps - 1) / kWarps;
  prepass_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), rn, inv_n, n_tok, static_cast<const T*>(u),
      static_cast<const T*>(v), dots, n_dot, d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// shared-memory layout of one CTA (bytes)
// ---------------------------------------------------------------------------

template <typename T, int SC, bool COMBINE>
struct BwdLayout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int STC = 32 * SC;       // slots of a slot tile
  static constexpr int WS = STC + 4;        // weight rows (4 mod 32 floats)
  static constexpr int RS = kKA + (kF32 ? 4 : 8);  // phase-A operand rows
  static constexpr int PA = kSA + 8;        // phase-A Phi_n rows
  static constexpr int RB = kDT + 8;        // phase-B operand rows
  static constexpr size_t kW = (size_t)kCT * WS * 4;  // one weight tile
  static constexpr size_t kVec = 3 * kCT * 4;          // proj halves, coef
  // phase A: x, Phi_n, (K5: g rows), slot rows (K4: g_slots; K5: Ys)
  static constexpr size_t A_p = (size_t)kCT * RS * sizeof(T);
  static constexpr size_t A_h = A_p + (size_t)kKA * PA * 4;
  static constexpr size_t A_b = A_h + (COMBINE ? (size_t)kCT * RS * sizeof(T)
                                               : 0);
  static constexpr size_t A_end = A_b + (size_t)kSA * RS * sizeof(T);
  // phase B: Phi_n rows, x, g rows (K5) or g_slots rows (K4)
  static constexpr size_t B_x = (size_t)kDT * WS * 4;
  static constexpr size_t B_g = B_x + (size_t)kCT * RB * sizeof(T);
  static constexpr size_t B_end =
      B_g + (size_t)(COMBINE ? kCT : STC) * RB * sizeof(T);
  static constexpr size_t kStage =
      ((A_end > B_end ? A_end : B_end) + 127) / 128 * 128;
  static constexpr size_t kBytes = 2 * kW + kVec + 2 * kStage;
};

// ---------------------------------------------------------------------------
// the body: one CTA per (token chunk, row)
// ---------------------------------------------------------------------------

template <typename T, int SC, bool COMBINE>
__device__ __forceinline__ void bwd_body(const BwdArgs& a) {
  using L = BwdLayout<T, SC, COMBINE>;
  constexpr bool F32 = L::kF32;
  constexpr int STC = L::STC, WS = L::WS, RS = L::RS, PA = L::PA, RB = L::RB;

  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  float* Wa = reinterpret_cast<float*>(base);  // K4: D; K5: C   [kCT][WS]
  float* Wb = Wa + kCT * WS;                   // rn dL           [kCT][WS]
  float* projw = Wb + kCT * WS;                // [2][kCT]
  float* coef = projw + 2 * kCT;               // [kCT]
  char* stage = base + 2 * L::kW + L::kVec;

  const int chunk = blockIdx.x, row = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m = a.m, d = a.d, S = a.S;
  const int t0 = chunk * a.ct, nt = min(a.ct, m - t0);
  const int nch = (m + a.ct - 1) / a.ct;
  const size_t tok0 = (size_t)row * m + t0;
  const T* x = static_cast<const T*>(a.x) + tok0 * d;
  // token rows of g (K5) and slot rows of g_slots (K4) or Ys (K5)
  const T* gtok = static_cast<const T*>(a.g) + tok0 * d;
  const T* srows = static_cast<const T*>(COMBINE ? a.ys : a.g) +
                   (size_t)row * S * d;

  // Phase A and the dX product: warp (wm, wn) holds tokens wm*16.. and the
  // 16 columns wn*16.. of a 32-wide tile (two 8-wide fragments).
  const int wm = warp & 3, wn = warp >> 2, r0 = wm * 16;
  const bool rows_live = r0 < nt;
  // Per-token operands of this thread's two rows, r0 + g and r0 + g + 8.
  float trn[2], tmx[2] = {0.f, 0.f}, tden[2] = {1.f, 1.f},
                trho[2] = {0.f, 0.f}, proj[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tl = r0 + g + 8 * h;
    trn[h] = tl < nt ? a.rn[tok0 + tl] : 0.f;
    if (COMBINE && tl < nt) {
      tmx[h] = a.mx[tok0 + tl];
      tden[h] = a.den[tok0 + tl];
      trho[h] = a.rowdot[tok0 + tl];
    }
  }
  // The dPhi_n / dYs products: SC fragments of a (16 slots x 8 columns)
  // grid of STC / 16 x 4, warp w taking the SC in a row from w * SC.
  const int pm = (warp * SC) >> 2, pn = (warp * SC) & 3;

  const int n_slot_tiles = (S + STC - 1) / STC;
  const int nka = (d + kKA - 1) / kKA, ndb = (d + kDT - 1) / kDT;

  for (int js = 0; js < n_slot_tiles; ++js) {
    const int s0 = js * STC, ns = min(STC, S - s0);
    const bool last = js == n_slot_tiles - 1;

    // ---- phase A: the weight tiles, 32 slots at a time ----
    for (int sa = 0; sa < STC; sa += kSA) {
      auto stage_a = [&](int kt, int buf) {
        char* sb = stage + buf * L::kStage;
        const int k0 = kt * kKA;
        stage_rows<T, kCT, kKA>(reinterpret_cast<T*>(sb), RS, x, nt, d, k0,
                                tid);
        stage_phi<kKA, kSA>(reinterpret_cast<float*>(sb + L::A_p), PA, a.phi,
                            d, S, k0, s0 + sa, a.phi_vec, tid);
        if (COMBINE)
          stage_rows<T, kCT, kKA>(reinterpret_cast<T*>(sb + L::A_h), RS, gtok,
                                  nt, d, k0, tid);
        stage_rows<T, kSA, kKA>(reinterpret_cast<T*>(sb + L::A_b), RS,
                                srows + (size_t)(s0 + sa) * d,
                                S - s0 - sa, d, k0, tid);
        cp_commit();
      };
      float dot[2][4], dg[2][4];
      zero(dot);
      zero(dg);
      stage_a(0, 0);
      for (int kt = 0; kt < nka; ++kt) {
        if (kt + 1 < nka) {
          stage_a(kt + 1, (kt + 1) & 1);
          cp_wait<1>();
        } else {
          cp_wait<0>();
        }
        __syncthreads();
        if (rows_live) {
          const char* sb = stage + (kt & 1) * L::kStage;
          const T* xa = reinterpret_cast<const T*>(sb) + r0 * RS;
          const float* pa = reinterpret_cast<const float*>(sb + L::A_p) +
                            wn * 16;
          const T* ha = COMBINE
                            ? reinterpret_cast<const T*>(sb + L::A_h) + r0 * RS
                            : xa;
          const T* ba = reinterpret_cast<const T*>(sb + L::A_b) + wn * 16 * RS;
          float pd[2][4], pdl[2][4], pg[2][4], pgl[2][4];
          zero(pd);
          zero(pdl);
          zero(pg);
          zero(pgl);
          // logits: x (exact in TF32 when bf16) . Phi_n (split)
#pragma unroll
          for (int kk = 0; kk < kKA; kk += 8) {
            float v[4];
            ld_a(v, xa + kk, RS, g, t);
            Frag<4> fa;
            make_frag<F32>(fa, v);
#pragma unroll
            for (int nn = 0; nn < 2; ++nn) {
              float w[2];
              ld_b_kn(w, pa + kk * PA + nn * 8, PA, g, t);
              Frag<2> fb;
              make_frag<true>(fb, w);
              mma_f32<F32, true>(pd[nn], pdl[nn], fa, fb);
            }
          }
          // x . g_s (K4) or g_t . Ys_s (K5): rows of ha against rows of ba
          if constexpr (F32) {
#pragma unroll
            for (int kk = 0; kk < kKA; kk += 8) {
              float v[4];
              ld_a(v, ha + kk, RS, g, t);
              Frag<4> fa;
              make_frag<true>(fa, v);
#pragma unroll
              for (int nn = 0; nn < 2; ++nn) {
                float w[2];
                ld_b_nk(w, ba + nn * 8 * RS + kk, RS, g, t);
                Frag<2> fb;
                make_frag<true>(fb, w);
                mma_f32<true, true>(pg[nn], pgl[nn], fa, fb);
              }
            }
          } else {
#pragma unroll
            for (int kk = 0; kk < kKA; kk += 16) {
              const T* p = ha + g * RS + kk + 2 * t;
              const uint32_t fa[4] = {ld32(p), ld32(p + 8 * RS), ld32(p + 8),
                                      ld32(p + 8 * RS + 8)};
#pragma unroll
              for (int nn = 0; nn < 2; ++nn) {
                const T* q = ba + (nn * 8 + g) * RS + kk + 2 * t;
                mma_bf16(pg[nn], fa, ld32(q), ld32(q + 8));
              }
            }
          }
          add_to(dot, pd, pdl);
          add_to(dg, pg, pgl);
        }
        __syncthreads();  // the buffer is refilled next
      }
      // The weights of this sub-tile; pad tokens and pad slots get 0.
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int tl = r0 + g + 8 * h;
            const int sl = sa + wn * 16 + nn * 8 + 2 * t + e;
            const int s = s0 + sl;
            const float dp = dot[nn][2 * h + e];
            float wa = 0.f, wb = 0.f;
            if (tl < nt && s < S) {
              const float lg = trn[h] * dp;
              float p, dl;
              if (COMBINE) {
                p = expf(lg - tmx[h]) / tden[h];
                dl = p * (dg[nn][2 * h + e] - trho[h]);
              } else {
                const size_t k = (size_t)row * S + s;
                p = expf(lg - a.mx[k]) / a.den[k];
                dl = p * (dg[nn][2 * h + e] - a.rowdot[k]);
              }
              wa = p;
              wb = trn[h] * dl;
              proj[h] = fmaf(dl, dp, proj[h]);
            }
            Wa[tl * WS + sl] = wa;
            Wb[tl * WS + sl] = wb;
          }
        }
      }
    }
    if (last) {
      // proj over all S: the four lanes of a row, then the two column
      // halves in order; coef = rn^2 inv_n proj (the l2-norm VJP)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        proj[h] += __shfl_xor_sync(0xffffffffu, proj[h], 1);
        proj[h] += __shfl_xor_sync(0xffffffffu, proj[h], 2);
        if (t == 0) projw[wn * kCT + r0 + g + 8 * h] = proj[h];
      }
    }
    __syncthreads();  // the weight tiles (and proj halves) are complete
    if (last && tid < kCT) {
      const float pj = projw[tid] + projw[kCT + tid];
      const float r = tid < nt ? a.rn[tok0 + tid] : 0.f;
      const float inv = tid < nt ? a.inv_n[tok0 + tid] : 0.f;
      coef[tid] = r * r * inv * pj;
    }
    // (coef is read after the first phase-B barrier below)

    // ---- phase B: the three products over d, 32 columns at a time ----
    auto stage_b = [&](int jd, int buf) {
      char* sb = stage + buf * L::kStage;
      const int c0 = jd * kDT;
      stage_phi<kDT, STC>(reinterpret_cast<float*>(sb), WS, a.phi, d, S, c0,
                          s0, a.phi_vec, tid);
      stage_rows<T, kCT, kDT>(reinterpret_cast<T*>(sb + L::B_x), RB, x, nt, d,
                              c0, tid);
      if (COMBINE)
        stage_rows<T, kCT, kDT>(reinterpret_cast<T*>(sb + L::B_g), RB, gtok,
                                nt, d, c0, tid);
      else
        stage_rows<T, STC, kDT>(reinterpret_cast<T*>(sb + L::B_g), RB,
                                srows + (size_t)s0 * d, ns, d, c0, tid);
      cp_commit();
    };
    stage_b(0, 0);
    for (int jd = 0; jd < ndb; ++jd) {
      const int c0 = jd * kDT;
      if (jd + 1 < ndb) {
        stage_b(jd + 1, (jd + 1) & 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const char* sb = stage + (jd & 1) * L::kStage;
      const float* pb = reinterpret_cast<const float*>(sb);
      const T* xb = reinterpret_cast<const T*>(sb + L::B_x);
      const T* gb = reinterpret_cast<const T*>(sb + L::B_g);

      // dX[tokens, 32 columns] (+)= D g (K4) + (rn dL) Phi_n^T over the
      // slot tile; the slots in slices of 32
      if (rows_live) {
        float acc[2][4];
        zero(acc);
        if (js > 0) {  // dX so far, from the scratch
#pragma unroll
          for (int nn = 0; nn < 2; ++nn)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int tl = r0 + g + 8 * h;
              const int col = c0 + wn * 16 + nn * 8 + 2 * t;
              if (tl < nt && col < d) {
                const float2 v = *reinterpret_cast<const float2*>(
                    a.dx_acc + (tok0 + tl) * d + col);
                acc[nn][2 * h] = v.x;
                acc[nn][2 * h + 1] = v.y;
              }
            }
        }
        // whole 32-slot slices: the weights, Phi_n and g_slots rows past
        // ns are zeros
        for (int k0 = 0; k0 < ns; k0 += 32) {
          float pw[2][4], pwl[2][4], pd[2][4], pdl[2][4];
          zero(pw);
          zero(pwl);
          zero(pd);
          zero(pdl);
#pragma unroll
          for (int kk = 0; kk < 32; kk += 8) {
            float v[4];
            ld_a(v, Wb + r0 * WS + k0 + kk, WS, g, t);
            Frag<4> fw;
            make_frag<true>(fw, v);
            Frag<4> fd;
            if (!COMBINE) {
              ld_a(v, Wa + r0 * WS + k0 + kk, WS, g, t);
              make_frag<true>(fd, v);
            }
#pragma unroll
            for (int nn = 0; nn < 2; ++nn) {
              const int n = wn * 16 + nn * 8;
              float w[2];
              ld_b_nk(w, pb + n * WS + k0 + kk, WS, g, t);
              Frag<2> fp;
              make_frag<true>(fp, w);
              mma_f32<true, true>(pw[nn], pwl[nn], fw, fp);
              if (!COMBINE) {
                ld_b_kn(w, gb + (k0 + kk) * RB + n, RB, g, t);
                Frag<2> fg;
                make_frag<F32>(fg, w);
                mma_f32<true, F32>(pd[nn], pdl[nn], fd, fg);
              }
            }
          }
          add_to(acc, pw, pwl);
          if (!COMBINE) add_to(acc, pd, pdl);
        }
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int tl = r0 + g + 8 * h;
            const int cl = wn * 16 + nn * 8 + 2 * t;
            if (tl >= nt || c0 + cl >= d) continue;
            float v0 = acc[nn][2 * h], v1 = acc[nn][2 * h + 1];
            const size_t o = (tok0 + tl) * d + c0 + cl;
            if (last) {
              const float cf = coef[tl];
              v0 -= cf * to_f32(xb[tl * RB + cl]);
              v1 -= cf * to_f32(xb[tl * RB + cl + 1]);
              T* out = static_cast<T*>(a.dx) + o;
              if constexpr (F32) {
                *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
              } else {
                *reinterpret_cast<__nv_bfloat162*>(out) =
                    __floats2bfloat162_rn(v0, v1);
              }
            } else {
              *reinterpret_cast<float2*>(a.dx_acc + o) = make_float2(v0, v1);
            }
          }
      }

      // The chunk's dPhi_n^T = (rn dL)^T x and (K5) dYs = C^T g partials:
      // [slots, 32 columns] over the chunk's tokens, in slices of 32
      if (pm * 16 < ns) {
        float accp[SC][4], accy[SC][4];
        zero(accp);
        zero(accy);
        // whole 32-token slices: the weights and x and g rows past nt
        // are zeros
        for (int k0 = 0; k0 < nt; k0 += 32) {
          float pp[SC][4], ppl[SC][4], py[SC][4], pyl[SC][4];
          zero(pp);
          zero(ppl);
          zero(py);
          zero(pyl);
#pragma unroll
          for (int kk = 0; kk < 32; kk += 8) {
            float v[4];
            ld_a_t(v, Wb + (k0 + kk) * WS + pm * 16, WS, g, t);
            Frag<4> fw;
            make_frag<true>(fw, v);
            Frag<4> fc;
            if (COMBINE) {
              ld_a_t(v, Wa + (k0 + kk) * WS + pm * 16, WS, g, t);
              make_frag<true>(fc, v);
            }
#pragma unroll
            for (int q = 0; q < SC; ++q) {
              const int n = (pn + q) * 8;
              float w[2];
              ld_b_kn(w, xb + (k0 + kk) * RB + n, RB, g, t);
              Frag<2> fx;
              make_frag<F32>(fx, w);
              mma_f32<true, F32>(pp[q], ppl[q], fw, fx);
              if (COMBINE) {
                ld_b_kn(w, gb + (k0 + kk) * RB + n, RB, g, t);
                Frag<2> fg;
                make_frag<F32>(fg, w);
                mma_f32<true, F32>(py[q], pyl[q], fc, fg);
              }
            }
          }
          add_to(accp, pp, ppl);
          if (COMBINE) add_to(accy, py, pyl);
        }
        const size_t pbase = ((size_t)row * nch + chunk) * S + s0;
#pragma unroll
        for (int q = 0; q < SC; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int sl = pm * 16 + g + 8 * h;
            const int col = c0 + (pn + q) * 8 + 2 * t;
            if (sl >= ns || col >= d) continue;
            const size_t o = (pbase + sl) * d + col;
            *reinterpret_cast<float2*>(a.part_phi + o) =
                make_float2(accp[q][2 * h], accp[q][2 * h + 1]);
            if (COMBINE)
              *reinterpret_cast<float2*>(a.part_ys + o) =
                  make_float2(accy[q][2 * h], accy[q][2 * h + 1]);
          }
      }
      __syncthreads();  // the buffer is refilled next
    }
  }
}

template <typename Kernel>
cudaError_t launch_bwd(Kernel kernel, dim3 grid, size_t smem,
                       const BwdArgs& a, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Dynamic shared memory of one CTA of the main kernel for S slots (dtype
// code 0 = float32, 1 = bfloat16).
template <bool COMBINE>
int bwd_smem_bytes(int dtype, int S) {
  const int sc = slot_tile_units(S);
  if (dtype == 0)
    return (int)(sc == 1   ? BwdLayout<float, 1, COMBINE>::kBytes
                 : sc == 2 ? BwdLayout<float, 2, COMBINE>::kBytes
                           : BwdLayout<float, 4, COMBINE>::kBytes);
  return (int)(sc == 1   ? BwdLayout<__nv_bfloat16, 1, COMBINE>::kBytes
               : sc == 2 ? BwdLayout<__nv_bfloat16, 2, COMBINE>::kBytes
                         : BwdLayout<__nv_bfloat16, 4, COMBINE>::kBytes);
}

// CTAs an SM is asked to hold (__launch_bounds__): two for the bf16
// 32-slot body (the granite LM layer's, 55 KB of shared memory; at most
// 128 registers a thread), else one (up to 164 KB of shared memory).
template <typename T, int SC>
constexpr int min_ctas() {
  return SC == 1 && !std::is_same<T, float>::value ? 2 : 1;
}

// ---------------------------------------------------------------------------
// the second pass
// ---------------------------------------------------------------------------

// out[row, e] = sum over the row's chunks, in chunk order from 0, of
// part[row, chunk, e], e over the row's S d elements: dYs. The loads go
// out eight at a time; the adds keep the order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    chunk_sum_kernel(const float* part, T* out, int B, int nch,
                     long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)B * n) return;
  const long long row = i / n, e = i - row * n;
  const float* p = part + row * nch * n + e;
  float acc = 0.f;
  int c = 0;
  for (; c + 8 <= nch; c += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = p[(size_t)(c + u) * n];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += v[u];
  }
  for (; c < nch; ++c) acc += p[(size_t)c * n];
  out[i] = from_f32<T>(acc);
}

// dPhi_n[c, s] = sum over rows, in row order from 0, of the row total:
// the sum over the row's chunks, in chunk order from 0, of
// part[row, chunk, s, c]. One thread an element (reads coalesced along
// d): only S d threads, so the (row, chunk) partials are read 32 at a
// time; the adds keep the order.
__global__ void __launch_bounds__(kThreads)
    dphi_reduce_kernel(const float* part, float* dphi, int B, int nch, int S,
                       int d) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n = (long long)S * d;
  if (i >= n) return;
  const long long s = i / d, c = i - s * d;
  const long long total = (long long)B * nch;  // (row, chunk) in order
  const float* p = part + i;
  float acc = 0.f, rt = 0.f;
  int k = 0;  // the chunk of item j
  long long j = 0;
  for (; j + 32 <= total; j += 32) {
    float v[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) v[u] = p[(size_t)(j + u) * n];
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      rt += v[u];
      if (++k == nch) {
        acc += rt;
        rt = 0.f;
        k = 0;
      }
    }
  }
  for (; j < total; ++j) {
    rt += p[(size_t)j * n];
    if (++k == nch) {
      acc += rt;
      rt = 0.f;
      k = 0;
    }
  }
  dphi[(size_t)c * S + s] = acc;
}

inline cudaError_t launch_dphi_reduce(const float* part, float* dphi, int B,
                                      int nch, int S, int d,
                                      cudaStream_t stream) {
  const long long n = (long long)S * d;
  dphi_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                       stream>>>(part, dphi, B, nch, S, d);
  return cudaGetLastError();
}

// Shapes the backward kernels do not take return false (the entry points
// then return cudaErrorInvalidValue without launching).
inline bool bwd_shapes_ok(int dtype, int B, int m, int d, int S, int ct) {
  return B >= 0 && B <= 65535 && m > 0 && d > 0 && S > 0 && ct >= 1 &&
         ct <= kCT && dtype >= 0 && dtype <= 1 && d % 8 == 0;
}

}  // namespace smoe
