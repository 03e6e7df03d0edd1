// K2 and K3, the Soft-MoE combine for Hopper (sm_90a): Y = C Ys, with C
// softmaxed over slots per token. One body, two entry points:
//   * K2 (stats given, combine_apply_kernel): C = exp(logits - c_mx) /
//     c_den from K1's saved per-token statistics. Replaces
//     src/repro/kernels/soft_moe_kernels.py `combine_apply_pallas` (:456,
//     `_combine_call` :403, pallas_call :443).
//   * K3 (online, combine_online_kernel): finds the per-token (c_mx,
//     c_den) itself and also emits them, the backward residuals. Replaces
//     `combine_online_pallas` (:462, pallas_call :422).
// Both run `_combine_kernel` on the TPU. The PyTorch wrappers and the
// plain versions that repeat this arithmetic are in
// src/repro_torch/kernels/soft_moe_kernels.py.
//
// What they compute, per batch row (x: (B, m, d), Phi_n: (d, S) f32,
// Ys: (B, S, d) in x's dtype):
//   logits[t, s] = l2norm(x[t]) . Phi_n[:, s]                 (f32)
//   y[t] = sum_s C[t, s] Ys[s]                  (output in x's dtype)
// No (m x S) logits or weights tensor reaches device memory.
//
// What bounds them on the H100: at the f32 rate, arithmetic. At the
// Soft-MoE B/16 layer (B=64, m=196, d=768, S=128, bf16) they move ~52 MB
// (~15.4 us at 3.35 TB/s) but do ~4.9 GFLOP (~74 us at 67 TFLOP/s). On the
// tensor cores each product takes two TF32 passes, ~20 us at the dense
// TF32 peak, which binds there; at the granite LM layer the bytes do
// (~68 MB, ~20 us, against ~9 us of passes).
//
// The design: a norm pre-pass, then one CTA per (token chunk, row); a
// chunk is `ct` tokens (kernels/tuning.py::combine_chunk: FWD_TILES token
// blocks, at most kCT = 64), fixed whatever the batch. For each tile of up
// to 128 slots (SC x 32, a template parameter) the CTA forms its (chunk x
// slot tile) logits once over the whole of d on the tensor cores
// (soft_moe_mma.cuh::logits_tile_mma), turns them into weights in shared
// memory, then streams d in 64-column tiles of Ys (staged with cp.async
// in x's dtype, double-buffered) and forms y = C Ys on the tensor cores
// (C split into two TF32 parts, bf16 Ys exact; a C fragment feeds four
// 8-column tiles), the slots in 32-slot slices summed on the CUDA cores.
// A token's output is whole in one CTA: no partials; over 128 slots an f32
// scratch carries y between slot tiles.
//
// The weights of a slot tile. K2: C = exp(l - c_mx) / c_den, exact from
// the saved stats. K3 (combine_weights_online): one warp per token takes
// the tile's max over its slots and carries a running (m, den) across
// the tiles, starting at (-1e30, 0):
//   m_new = max(m, max_s l),  corr = exp(m - m_new),
//   C = exp(l - m_new),  den = den corr + sum_s C,  m = m_new;
// the mix then forms y = y corr + C Ys (the scratch rescaled per token)
// and the last tile writes y / den and the final (m, den). With S <= 128
// (every main config) there is one tile: y = (C Ys) / den and no rescale.
//
// A row's reduction stays in one CTA in a fixed order, so row i of a
// batched launch equals a batch-1 launch bitwise.
#include "soft_moe_mma.cuh"

namespace {

using namespace smoe;

// ---------------------------------------------------------------------------
// the combine on the tensor cores: K2 from saved statistics, K3 online
// ---------------------------------------------------------------------------

constexpr int kCT = 64;  // tokens a CTA holds: a chunk is at most this
constexpr int kDC = 64;  // d columns of one mix tile
constexpr int kRB = kDC + 8;  // mix-tile Ys rows (conflict-free B loads)

struct ApplyArgs {
  const void* x;       // (B, m, d)
  const float* phi;    // (d, S)
  const void* ys;      // (B, S, d)
  const float* rn;     // (B, m) inverse norms from the pre-pass
  float* c_mx;         // (B, m): read by K2, written by K3
  float* c_den;        // (B, m): read by K2, written by K3
  void* y;             // (B, m, d)
  float* y_acc;        // (B, m, d) f32 scratch, only when S > 128
  int m, d, S, ct;     // ct: tokens of a chunk, 1..kCT
  bool phi_vec;        // Phi_n rows 16-byte aligned (S % 4 == 0)
};

// Shared memory of one CTA (bytes): C [kCT][WS], the chunk's rn, c_mx and
// c_den (and K3's rescale per token), then the region of the stages: the
// logits loop's kStages, or the mix loop's two.
template <typename T, int SC, bool ONLINE>
struct ApplyLayout {
  static constexpr int STC = 32 * SC;  // slots of a slot tile
  static constexpr int WS = STC + 4;   // C rows (4 mod 32 floats)
  static constexpr size_t kC =
      (size_t)kCT * WS * 4 + (ONLINE ? 4 : 3) * kCT * 4;
  static constexpr size_t kA = LogitsStage<T, STC>::bytes(kCT);
  static constexpr size_t kB =
      ((size_t)STC * kRB * sizeof(T) + 127) / 128 * 128;
  static constexpr size_t kRegion =
      kStages * kA > 2 * kB ? kStages * kA : 2 * kB;
  static constexpr size_t kBytes = kC + kRegion;
};

// K3's weights of one slot tile (the recurrence in the header): C holds
// the tile's logits on entry and exp(l - m_new) on exit, zeros for pad
// slots and pad tokens (the mix reads whole 32-slot slices of the rows of
// live m-tiles); tmx and tden carry each token's running (max, denom) and
// tcorr gets its rescale exp(m_old - m_new). One warp per token, slots
// lane + 32 k.
template <int SC>
__device__ __forceinline__ void combine_weights_online(
    float* C, int WS, float* tmx, float* tden, float* tcorr, int nt, int ns,
    int warp, int lane) {
  for (int tl = warp; tl < kCT; tl += kWarps) {  // warp-uniform
    float* row = C + tl * WS;
    if (tl >= nt) {
#pragma unroll
      for (int k = 0; k < SC; ++k) row[lane + 32 * k] = 0.f;
      continue;
    }
    float v[SC];
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < SC; ++k) {
      v[k] = lane + 32 * k < ns ? row[lane + 32 * k] : -INFINITY;
      mx = fmaxf(mx, v[k]);
    }
    const float m_old = tmx[tl];
    const float m_new = fmaxf(m_old, warp_max(mx));
    float psum = 0.f;
#pragma unroll
    for (int k = 0; k < SC; ++k) {
      const float p = lane + 32 * k < ns ? expf(v[k] - m_new) : 0.f;
      row[lane + 32 * k] = p;
      psum += p;
    }
    psum = warp_sum(psum);
    if (lane == 0) {
      const float corr = expf(m_old - m_new);
      tcorr[tl] = corr;
      tden[tl] = tden[tl] * corr + psum;
      tmx[tl] = m_new;
    }
  }
}

// The body of K2 (ONLINE false) and K3 (true): one CTA per (token chunk,
// row); slot tiles of 32 SC slots.
template <typename T, int SC, bool ONLINE>
__device__ __forceinline__ void combine_body(const ApplyArgs& a) {
  using Ly = ApplyLayout<T, SC, ONLINE>;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int STC = Ly::STC, WS = Ly::WS;
  const int chunk = blockIdx.x, row = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m = a.m, d = a.d, S = a.S;
  const int t0 = chunk * a.ct, nt = min(a.ct, m - t0);

  extern __shared__ float4 smem4[];
  float* C = reinterpret_cast<float*>(smem4);  // [kCT][WS] weights
  float* trn = C + kCT * WS;                   // the chunk's rn,
  float* tmx = trn + kCT;                      //   c_mx
  float* tden = tmx + kCT;                     //   and c_den
  float* tcorr = tden + kCT;  // K3: the slot tile's rescale per token
  char* stage = reinterpret_cast<char*>(smem4) + Ly::kC;

  const size_t tok0 = (size_t)row * m + t0;
  const T* x = static_cast<const T*>(a.x) + tok0 * d;
  const T* ysrow = static_cast<const T*>(a.ys) + (size_t)row * S * d;
  if (tid < nt) {
    trn[tid] = a.rn[tok0 + tid];
    if constexpr (!ONLINE) {
      tmx[tid] = a.c_mx[tok0 + tid];
      tden[tid] = a.c_den[tok0 + tid];
    }
  }
  if constexpr (ONLINE) {
    if (tid < kCT) {
      tmx[tid] = kNeg;
      tden[tid] = 0.f;
    }
  }
  // (read after the logits loop's first barrier)

  // The mix: warp (wm, wn) holds tokens wm * 16.. and columns wn * 32 +
  // nn * 8.. (nn < 4) of a 64-column tile.
  const int wm = warp & 3, wn = warp >> 2, r0 = wm * 16;
  const bool rows_live = r0 < nt;
  const int nst = (S + STC - 1) / STC, ndt = (d + kDC - 1) / kDC;

  for (int js = 0; js < nst; ++js) {
    const int s0 = js * STC, ns = min(STC, S - s0);
    const bool last = js == nst - 1;

    // ---- the weights: logits over the whole of d, warps 2 (two 16-token
    // m-tiles each) x 4 (STC / 4 slots); pad tokens and pad slots get 0
    logits_tile_mma<T, 2, 4, 2, SC>(
        x, nt, a.phi, S, s0, d, a.phi_vec, stage, Ly::kA, tid,
        [&](int tl, int sl, float dot) {
          if constexpr (ONLINE) {  // the logit; weighed below
            C[tl * WS + sl] = tl < nt ? trn[tl] * dot : 0.f;
          } else {
            C[tl * WS + sl] = tl < nt && sl < ns
                ? expf(trn[tl] * dot - tmx[tl]) / tden[tl] : 0.f;
          }
        });
    __syncthreads();
    if constexpr (ONLINE) {
      combine_weights_online<SC>(C, WS, tmx, tden, tcorr, nt, ns, warp,
                                 lane);
      __syncthreads();
    }

    // ---- y over d, 64 columns at a time, double-buffered: C Ys, the
    // slots in slices of 32
    const T* ys = ysrow + (size_t)s0 * d;
    auto fill = [&](int jd) {
      stage_rows<T, STC, kDC>(
          reinterpret_cast<T*>(stage + (jd & 1) * Ly::kB), kRB, ys, ns, d,
          jd * kDC, tid);
      cp_commit();
    };
    fill(0);
    for (int jd = 0; jd < ndt; ++jd) {
      cp_wait<0>();
      __syncthreads();  // tile jd is in; every warp is done with jd - 1
      if (jd + 1 < ndt) fill(jd + 1);
      if (!rows_live) continue;  // warp-uniform
      const T* yb = reinterpret_cast<const T*>(stage + (jd & 1) * Ly::kB);
      const int c0 = jd * kDC + wn * 32;
      float acc[4][4];
      zero(acc);
      if (js > 0) {  // y so far, from the scratch (K3: rescaled)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int tl = r0 + g + 8 * h;
            const int col = c0 + nn * 8 + 2 * t;
            if (tl < nt && col < d) {
              const float2 v = *reinterpret_cast<const float2*>(
                  a.y_acc + (tok0 + tl) * d + col);
              if constexpr (ONLINE) {
                acc[nn][2 * h] = v.x * tcorr[tl];
                acc[nn][2 * h + 1] = v.y * tcorr[tl];
              } else {
                acc[nn][2 * h] = v.x;
                acc[nn][2 * h + 1] = v.y;
              }
            }
          }
      }
      // whole 32-slot slices: C and the Ys rows past ns are zeros
      for (int k0 = 0; k0 < ns; k0 += 32) {
        float big[4][4], small[4][4];
        zero(big);
        zero(small);
#pragma unroll
        for (int kk = 0; kk < 32; kk += 8) {
          float v[4];
          ld_a(v, C + r0 * WS + k0 + kk, WS, g, t);
          Frag<4> fc;
          make_frag<true>(fc, v);
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) {
            float w[2];
            ld_b_kn(w, yb + (k0 + kk) * kRB + wn * 32 + nn * 8, kRB, g, t);
            Frag<2> fy;
            make_frag<F32>(fy, w);
            mma_f32<true, F32>(big[nn], small[nn], fc, fy);
          }
        }
        add_to(acc, big, small);
      }
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tl = r0 + g + 8 * h;
          const int col = c0 + nn * 8 + 2 * t;
          if (tl >= nt || col >= d) continue;
          float v0 = acc[nn][2 * h], v1 = acc[nn][2 * h + 1];
          if (ONLINE && last) {
            v0 /= tden[tl];
            v1 /= tden[tl];
          }
          const size_t o = (tok0 + tl) * d + col;
          if (!last) {
            *reinterpret_cast<float2*>(a.y_acc + o) = make_float2(v0, v1);
          } else if constexpr (F32) {
            *reinterpret_cast<float2*>(static_cast<float*>(a.y) + o) =
                make_float2(v0, v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(
                static_cast<__nv_bfloat16*>(a.y) + o) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
    }
    cp_wait<0>();
    __syncthreads();  // C and the stages are refilled by the next slot tile
  }
  if constexpr (ONLINE) {  // the final statistics
    if (tid < nt) {
      a.c_mx[tok0 + tid] = tmx[tid];
      a.c_den[tok0 + tid] = tden[tid];
    }
  }
}

template <typename T, int SC>
__global__ void __launch_bounds__(kThreads, 2)
    combine_apply_kernel(ApplyArgs a) {
  combine_body<T, SC, false>(a);
}

template <typename T, int SC>
__global__ void __launch_bounds__(kThreads, 2)
    combine_online_kernel(ApplyArgs a) {
  combine_body<T, SC, true>(a);
}

template <typename T, int SC, bool ONLINE>
cudaError_t launch_combine(const ApplyArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = ApplyLayout<T, SC, ONLINE>::kBytes;
  auto kernel = combine_apply_kernel<T, SC>;
  if constexpr (ONLINE) kernel = combine_online_kernel<T, SC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const unsigned nch = (a.m + a.ct - 1) / a.ct;
  kernel<<<dim3(nch, B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool ONLINE>
cudaError_t launch_combine_sc(const ApplyArgs& a, int B,
                              cudaStream_t stream) {
  switch (slot_tile_units(a.S)) {
    case 1: return launch_combine<T, 1, ONLINE>(a, B, stream);
    case 2: return launch_combine<T, 2, ONLINE>(a, B, stream);
    default: return launch_combine<T, 4, ONLINE>(a, B, stream);
  }
}

cudaError_t launch_norms(int dtype, const void* x, void* rn, int B, int m,
                         int d, cudaStream_t s) {
  const long long n_tokens = (long long)B * m;
  return dtype == 0
      ? launch_inv_norm<float>(x, static_cast<float*>(rn), n_tokens, d, s)
      : launch_inv_norm<__nv_bfloat16>(x, static_cast<float*>(rn), n_tokens, d, s);
}

// Both entry points: the norm pre-pass, then K2's or K3's kernel. Shapes
// the kernels do not take (ct out of range, d not a multiple of 8,
// operands not 16-byte aligned, scratch missing) return
// cudaErrorInvalidValue without launching.
template <bool ONLINE>
int combine_entry(const void* x, const void* phi, const void* ys, void* c_mx,
                  void* c_den, void* y, void* rn, void* y_acc, int dtype,
                  int B, int m, int d, int S, int ct, void* stream) {
  if (B < 0 || B > 65535 || m <= 0 || d <= 0 || S <= 0 || ct < 1 ||
      ct > kCT || dtype < 0 || dtype > 1 || d % 8 != 0 || !aligned16(x) ||
      !aligned16(ys) || !aligned16(y) ||
      (S > 128 && (y_acc == nullptr || !aligned16(y_acc)))) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ApplyArgs a;
  a.x = x;
  a.phi = static_cast<const float*>(phi);
  a.ys = ys;
  a.rn = static_cast<const float*>(rn);
  a.c_mx = static_cast<float*>(c_mx);
  a.c_den = static_cast<float*>(c_den);
  a.y = y;
  a.y_acc = static_cast<float*>(y_acc);
  a.m = m;
  a.d = d;
  a.S = S;
  a.ct = ct;
  a.phi_vec = S % 4 == 0 && aligned16(phi);
  cudaError_t e = launch_norms(dtype, x, rn, B, m, d, s);
  if (e != cudaSuccess) return (int)e;
  e = dtype == 0 ? launch_combine_sc<float, ONLINE>(a, B, s)
                 : launch_combine_sc<__nv_bfloat16, ONLINE>(a, B, s);
  return (int)e;
}

}  // namespace

// Plain C entry points of K2 and K3 for ctypes, one signature. dtype code
// of x, ys and y: 0 = float32, 1 = bfloat16; Phi_n and the statistics
// c_mx, c_den are float32: K2 reads them, K3 writes them. Every pointer is
// a device pointer; rn (B*m floats) and, when S > 128, y_acc (B*m*d
// floats; may be null otherwise) are scratch the caller allocates. `ct`
// is the tokens of a chunk (1..64). `stream` is a cudaStream_t. Each
// launches the norm pre-pass and its combine kernel and returns the first
// cudaError_t (0 = success).
extern "C" int soft_moe_combine_apply_launch(
    const void* x, const void* phi, const void* ys, const void* c_mx,
    const void* c_den, void* y, void* rn, void* y_acc, int dtype, int B,
    int m, int d, int S, int ct, void* stream) {
  return combine_entry<false>(x, phi, ys, const_cast<void*>(c_mx),
                              const_cast<void*>(c_den), y, rn, y_acc, dtype,
                              B, m, d, S, ct, stream);
}

extern "C" int soft_moe_combine_online_launch(
    const void* x, const void* phi, const void* ys, void* c_mx, void* c_den,
    void* y, void* rn, void* y_acc, int dtype, int B, int m, int d, int S,
    int ct, void* stream) {
  return combine_entry<true>(x, phi, ys, c_mx, c_den, y, rn, y_acc, dtype, B,
                             m, d, S, ct, stream);
}
