// Tensor-core and staging pieces shared by the Soft-MoE kernels for Hopper
// (sm_90a) that run their products on the tensor cores: K1 routing
// (soft_moe_routing.cu), K2/K3 combine (soft_moe_combine.cu), the
// backward kernels K4/K5 (soft_moe_bwd.cuh) and K6 routing health
// (soft_moe_routing_health.cu); the fixed-order contraction
// (invariant_matmul.cu) takes its mma and cp.async pieces.
//
// Products run with mma.sync at f32 accuracy: a bf16 operand is exact in
// TF32; an f32 operand is split into a TF32 high part and a TF32 low
// part (make_frag), and a product takes as many passes as that needs
// (mma_f32). Operand tiles are staged from global memory with cp.async
// (cp16 / cp4, stage_rows, stage_phi). The forward kernels K1, K2, K3
// and K6 form their logits tile with logits_tile_mma.
#pragma once

#include <type_traits>

#include "soft_moe_common.cuh"

namespace smoe {

// ---------------------------------------------------------------------------
// tensor-core fragments (mma.sync, row.col; g = lane / 4, t = lane % 4):
//   A 16 x 8 (TF32): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                    a3 (g + 8, t + 4)
//   B 8 x 8 (TF32):  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C 16 x 8 (f32):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                    c3 (g + 8, 2t + 1)
// bf16 m16n8k16 packs two k-neighbours a register: A (g, 2t..2t+1),
// (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..); B (k = 2t.., n = g),
// (k = 2t + 8.., n = g).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// An operand fragment: h the TF32 high part (the value itself when exact),
// l the low part v - h (used only when the operand is split).
template <int N>
struct Frag {
  uint32_t h[N], l[N];
};

template <bool SPLIT, int N>
__device__ __forceinline__ void make_frag(Frag<N>& f, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (SPLIT) {
      f.h[i] = to_tf32(v[i]);
      f.l[i] = to_tf32(v[i] - __uint_as_float(f.h[i]));
    } else {
      f.h[i] = __float_as_uint(v[i]);  // a bf16 value: exact in TF32
    }
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A B in the passes the operands need: hi x hi into big, and the small
// terms lo x hi and hi x lo into small. Two accumulators keep two
// independent chains of tensor-core instructions in flight.
template <bool SA, bool SB>
__device__ __forceinline__ void mma_f32(float (&big)[4], float (&small)[4],
                                        const Frag<4>& a, const Frag<2>& b) {
  if (SA) mma_tf32(small, a.l, b.h);
  if (SB) mma_tf32(small, a.h, b.l);
  mma_tf32(big, a.h, b.h);
}

// acc += small + big, element by element, in that order.
template <int N>
__device__ __forceinline__ void add_to(float (&acc)[N][4],
                                       const float (&big)[N][4],
                                       const float (&small)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += small[i][e] + big[i][e];
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// A 16 x 8 fragment of a row-major array p (row stride ld) at its origin.
template <typename T>
__device__ __forceinline__ void ld_a(float (&v)[4], const T* p, int ld, int g,
                                     int t) {
  v[0] = to_f32(p[g * ld + t]);
  v[1] = to_f32(p[(g + 8) * ld + t]);
  v[2] = to_f32(p[g * ld + t + 4]);
  v[3] = to_f32(p[(g + 8) * ld + t + 4]);
}

// The A fragment of the transpose of a row-major array: A[i][k] = p[k][i].
__device__ __forceinline__ void ld_a_t(float (&v)[4], const float* p, int ld,
                                       int g, int t) {
  v[0] = p[t * ld + g];
  v[1] = p[t * ld + g + 8];
  v[2] = p[(t + 4) * ld + g];
  v[3] = p[(t + 4) * ld + g + 8];
}

// A B fragment from a [k][n] array (row stride ld) ...
template <typename T>
__device__ __forceinline__ void ld_b_kn(float (&v)[2], const T* p, int ld,
                                        int g, int t) {
  v[0] = to_f32(p[t * ld + g]);
  v[1] = to_f32(p[(t + 4) * ld + g]);
}

// ... and from an [n][k] array.
template <typename T>
__device__ __forceinline__ void ld_b_nk(float (&v)[2], const T* p, int ld,
                                        int g, int t) {
  v[0] = to_f32(p[g * ld + t]);
  v[1] = to_f32(p[g * ld + t + 4]);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---------------------------------------------------------------------------
// asynchronous staging
// ---------------------------------------------------------------------------

// 16 bytes (or zeros when !ok: nothing is read) from global to shared.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, ROWS) x columns [c0, c0 + COLS) of src (row stride d) into dst
// (row stride ld); rows >= n and columns >= d are zeros. d % 8 == 0 and
// 16-byte aligned rows: a 16-byte piece lies wholly inside or outside d.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, int n,
                                           int d, int c0, int tid) {
  constexpr int V = 16 / sizeof(T), P = COLS / V;
  for (int i = tid; i < ROWS * P; i += kThreads) {
    const int r = i / P, c = (i - r * P) * V;
    const bool ok = r < n && c0 + c < d;
    cp16(dst + r * ld + c, ok ? src + (size_t)r * d + c0 + c : src, ok);
  }
}

// Phi_n[k0 + k][s0 + s] for k < K, s < NS into dst[k * ld + s]; rows >= d
// and slots >= S are zeros. 16-byte copies when the rows are 16-byte
// aligned (vec: S % 4 == 0, s0 % 4 == 0), else 4-byte ones.
template <int K, int NS>
__device__ __forceinline__ void stage_phi(float* dst, int ld, const float* phi,
                                          int d, int S, int k0, int s0,
                                          bool vec, int tid) {
  if (vec) {
    for (int i = tid; i < K * NS / 4; i += kThreads) {
      const int k = i / (NS / 4), s = 4 * (i - k * (NS / 4));
      const bool ok = k0 + k < d && s0 + s < S;
      cp16(dst + k * ld + s, ok ? phi + (size_t)(k0 + k) * S + s0 + s : phi,
           ok);
    }
    return;
  }
  for (int i = tid; i < K * NS; i += kThreads) {
    const int k = i / NS, s = i - k * NS;
    const bool ok = k0 + k < d && s0 + s < S;
    cp4(dst + k * ld + s, ok ? phi + (size_t)(k0 + k) * S + s0 + s : phi, ok);
  }
}


// Like stage_rows, for a row count known only at run time.
template <typename T, int COLS>
__device__ __forceinline__ void stage_rows_n(T* dst, int ld, const T* src,
                                             int rows, int n, int d, int c0,
                                             int tid) {
  constexpr int V = 16 / sizeof(T), P = COLS / V;
  for (int i = tid; i < rows * P; i += kThreads) {
    const int r = i / P, c = (i - r * P) * V;
    const bool ok = r < n && c0 + c < d;
    cp16(dst + r * ld + c, ok ? src + (size_t)r * d + c0 + c : src, ok);
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// SC, a slot tile in 32-slot units, for S slots: up to 128 slots a tile.
inline int slot_tile_units(int S) { return S <= 32 ? 1 : S <= 64 ? 2 : 4; }

// ---------------------------------------------------------------------------
// the forward kernels' logits tile (K1, K2, K3, K6)
// ---------------------------------------------------------------------------

constexpr int kKL = 32;     // d depth of one logits stage: one 32-deep slice
constexpr int kStages = 3;  // cp.async stages of the forward kernels

// One stage of the logits loop for a tile of COLS slots: Phi_n rows
// [kKL][PS] (f32), then x rows [rows][RS] (x's dtype). Phi_n rows of 4
// (mod 32) words and x rows of kKL + 8 elements: the fragment loads below
// meet no bank conflict.
template <typename T, int COLS>
struct LogitsStage {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int PS = COLS + 4;
  static constexpr int RS = kKL + 8;
  static constexpr int kPhiBytes = kKL * PS * 4;
  __host__ __device__ static constexpr size_t bytes(int rows) {
    return ((size_t)kPhiBytes + (size_t)rows * RS * sizeof(T) + 127) / 128 *
           128;
  }
};

// Two neighbouring elements of a row as floats, in one load.
__device__ __forceinline__ void ld_pair(float& a, float& b, const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void ld_pair(float& a, float& b,
                                        const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  a = __uint_as_float(u << 16);
  b = __uint_as_float(u & 0xffff0000u);
}

// The logits of a (tokens x slots) tile over the whole of d, on the tensor
// cores at f32 accuracy: dot[t][s] = x[t, :] . Phi_n[:, s0 + s] for the nt
// tokens of x (row stride d) and COLS = 8 WN NT slots from s0 (slots >= S
// read as zeros). Warps are laid out WM x WN: warp (wm, wn) holds the
// 16-token m-tiles wm + WM i (i < MT) and the 8-slot n-tiles wn NT + j
// (j < NT); m-tiles wholly past nt are skipped. x is exact in TF32 when
// bf16 and split when f32; Phi_n is split: two passes a product, or three.
// A fragment's k = t and k = t + 4 are the stage's columns 2t and 2t + 1
// (one load for both; Phi_n's fragment takes the same rows, so each
// product still pairs the same d index).
// Each 32-deep slice is summed on the tensor cores into zeroed fragments
// and the slices are added in f32 on the CUDA cores, in d order. d
// streams through kStages cp.async buffers of `stage_bytes` each (at least
// LogitsStage<T, COLS>::bytes(nt rounded up to 16)) from `stage`.
// Ends with no copy in flight and every warp past the loop, then calls
// epi(tl, sl, dot) for each element of each live m-tile (tl <
// round_up(nt, 16), sl < COLS); the caller synchronises after it.
template <typename T, int WM, int WN, int MT, int NT, typename Epi>
__device__ __forceinline__ void logits_tile_mma(const T* x, int nt,
                                                const float* phi, int S,
                                                int s0, int d, bool phi_vec,
                                                char* stage,
                                                size_t stage_bytes, int tid,
                                                Epi epi) {
  using G = LogitsStage<T, 8 * WN * NT>;
  constexpr bool F32 = G::kF32;
  constexpr int COLS = 8 * WN * NT, PS = G::PS, RS = G::RS;
  // one fragment a warp holds: two chains of mma (the high x high pass
  // apart from the small ones) keep the tensor cores busy; more give
  // independent chains of their own
  constexpr bool kTwo = MT * NT <= 2;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int rows = (nt + 15) & ~15;
  const int nk = (d + kKL - 1) / kKL;
  auto fill = [&](int kt) {
    char* sb = stage + (size_t)(kt % kStages) * stage_bytes;
    stage_phi<kKL, COLS>(reinterpret_cast<float*>(sb), PS, phi, d, S,
                         kt * kKL, s0, phi_vec, tid);
    stage_rows_n<T, kKL>(reinterpret_cast<T*>(sb + G::kPhiBytes), RS, x, rows,
                         nt, d, kt * kKL, tid);
  };
  float acc[MT][NT][4], pb[MT][NT][4], ps[kTwo ? MT : 1][kTwo ? NT : 1][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) zero(acc[i]);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) fill(s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();  // stage kt is in; every warp is done with kt - 1
    if (kt + kStages - 1 < nk) fill(kt + kStages - 1);
    cp_commit();
    const char* sb = stage + (size_t)(kt % kStages) * stage_bytes;
    const float* pa = reinterpret_cast<const float*>(sb);
    const T* xa = reinterpret_cast<const T*>(sb + G::kPhiBytes);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      zero(pb[i]);
      if (kTwo) zero(ps[kTwo ? i : 0]);
    }
#pragma unroll
    for (int kk = 0; kk < kKL; kk += 8) {
      auto mma = [&](int i, int j, const Frag<4>& fa, const Frag<2>& fb) {
        if constexpr (kTwo)
          mma_f32<F32, true>(pb[i][j], ps[i][j], fa, fb);
        else
          mma_f32<F32, true>(pb[i][j], pb[i][j], fa, fb);
      };
      auto frag_a = [&](Frag<4>& fa, int i) {
        const T* p = xa + ((wm + WM * i) * 16 + g) * RS + kk + 2 * t;
        float v[4];
        ld_pair(v[0], v[2], p);
        ld_pair(v[1], v[3], p + 8 * RS);
        make_frag<F32>(fa, v);
      };
      auto frag_b = [&](Frag<2>& fb, int j) {
        const float* p = pa + (kk + 2 * t) * PS + (wn * NT + j) * 8 + g;
        const float w[2] = {p[0], p[PS]};
        make_frag<true>(fb, w);
      };
      if constexpr (NT == 1) {  // one Phi_n fragment, the x ones in turn
        Frag<2> fb;
        frag_b(fb, 0);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if ((wm + WM * i) * 16 >= nt) continue;
          Frag<4> fa;
          frag_a(fa, i);
          mma(i, 0, fa, fb);
        }
      } else {  // one x fragment a m-tile, the Phi_n ones in turn
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if ((wm + WM * i) * 16 >= nt) continue;
          Frag<4> fa;
          frag_a(fa, i);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            Frag<2> fb;
            frag_b(fb, j);
            mma(i, j, fa, fb);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] +=
              kTwo ? ps[kTwo ? i : 0][kTwo ? j : 0][e] + pb[i][j][e]
                   : pb[i][j][e];
  }
  cp_wait<0>();
  __syncthreads();  // the stages are free for the caller
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r0 = (wm + WM * i) * 16;
    if (r0 >= nt) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          epi(r0 + g + 8 * h, (wn * NT + j) * 8 + 2 * t + e,
              acc[i][j][2 * h + e]);
  }
}

}  // namespace smoe
