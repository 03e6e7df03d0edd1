// K2 and K3, the Soft-MoE combine for Hopper (sm_90a): Y = C Ys, with C
// softmaxed over slots per token. Two bodies, two entry points:
//   * K2 (stats given, combine_apply_kernel): C = exp(logits - c_mx) /
//     c_den from K1's saved per-token statistics. Replaces
//     src/repro/kernels/soft_moe_kernels.py `combine_apply_pallas` (:456,
//     `_combine_call` :403, pallas_call :443).
//   * K3 (online, combine_kernel): an online softmax over slot blocks that
//     also emits the final (c_mx, c_den), the backward residuals. Replaces
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
// tensor cores (K2) each product takes two TF32 passes, ~20 us at the
// dense TF32 peak, which binds there; at the granite LM layer the bytes
// do (~68 MB, ~20 us, against ~9 us of passes).
//
// K2's design: a norm pre-pass, then one CTA per (token chunk, row); a
// chunk is `ct` tokens (kernels/tuning.py: FWD_TILES token blocks, at most
// kCT = 64), fixed whatever the batch. For each tile of up to 128 slots
// (SC x 32, a template parameter) the CTA forms its (chunk x slot tile)
// logits once over the whole of d on the tensor cores
// (soft_moe_mma.cuh::logits_tile_mma), then C = exp(L - c_mx) / c_den into
// shared memory, then streams d in 64-column tiles of Ys (staged with
// cp.async in x's dtype, double-buffered) and forms y = C Ys on the tensor
// cores (C split into two TF32 parts, bf16 Ys exact; a C fragment feeds
// four 8-column tiles), the slots in 32-slot slices summed on the CUDA
// cores. A token's output is whole in one CTA: no partials; over 128
// slots an f32 scratch carries y between slot tiles.
//
// K3's design: one CTA per (d-chunk, token block, row) that loops over
// the row's slot blocks itself (the TPU kernel's sequential slot grid
// axis), carrying the (tokens x d-chunk) accumulator in registers and the
// per-token (max, denom) in shared memory. Each CTA recomputes the logits
// tile over the whole of d: ceil(d / d_chunk) times the minimum logits
// arithmetic (the tile policy takes one chunk up to d = 768, so no
// recompute at B/16). f32 FMA on the CUDA cores.
//
// In both, a row's reduction stays in one CTA in a fixed order, so row i
// of a batched launch equals a batch-1 launch bitwise.
#include "soft_moe_mma.cuh"

namespace {

using namespace smoe;

// ---------------------------------------------------------------------------
// K3: the online combine (the d-chunk body)
// ---------------------------------------------------------------------------

struct CombineArgs {
  const void* x;     // (B, m, d)
  const float* phi;  // (d, S)
  const void* ys;    // (B, S, d)
  const float* rn;   // (B, m) inverse norms from the pre-pass
  float* c_mx;       // (B, m), written
  float* c_den;      // (B, m), written
  void* y;           // (B, m, d)
  int m, d, S, bt, bs;
};

// One CTA per (d-chunk, token block, row); DC = 128 * NV columns.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads) combine_kernel(CombineArgs a) {
  constexpr int DC = 128 * NV;
  const int jc = blockIdx.x, jt = blockIdx.y, row = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = a.m, d = a.d, S = a.S;
  const int t0 = jt * a.bt, nt = min(a.bt, m - t0);
  const int c0 = jc * DC;

  extern __shared__ float4 smem4[];
  LogitsSmem& lsm = *reinterpret_cast<LogitsSmem*>(smem4);
  float* ys_s = reinterpret_cast<float*>(smem4) + sizeof(LogitsSmem) / 4;
  float* L = ys_s + kTile * DC;           // [kTile][kTile + 1]: logits, then p
  float* mx_s = L + kTile * (kTile + 1);  // per-token max
  float* den_s = mx_s + kTile;            // per-token denom
  float* corr_s = den_s + kTile;          // this block's rescale per token

  const size_t tok0 = (size_t)row * m + t0;
  if (tid < kTile) {
    mx_s[tid] = kNeg;
    den_s[tid] = tid < nt ? 0.f : 1.f;
    corr_s[tid] = 1.f;
  }
  // Thread owns tokens 4 * warp + i and columns q * 128 + 4 * lane + e.
  float acc[4][4 * NV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int v = 0; v < 4 * NV; ++v) acc[i][v] = 0.f;

  const T* xt = static_cast<const T*>(a.x) + tok0 * d;
  const T* ysrow = static_cast<const T*>(a.ys) + (size_t)row * S * d;
  const float* rn = a.rn + tok0;
  __syncthreads();

  for (int s0 = 0; s0 < S; s0 += a.bs) {
    const int ns = min(a.bs, S - s0);
    float dot[2][2];
    logits_tile<T>(xt, nt, a.phi + s0, S, ns, d, lsm, dot, nullptr, 0, 0, tid);
    store_logits(L, dot, rn, nt, tid);
    // Stage Ys[s0:s0+ns, c0:c0+DC] as f32; rows past ns and columns past d
    // are zeros.
    for (int i = tid; i < kTile * (DC / 4); i += kThreads) {
      const int s = i / (DC / 4), c = 4 * (i - s * (DC / 4));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s < ns && c0 + c < d) v = load4(ysrow + (size_t)(s0 + s) * d + c0 + c);
      *reinterpret_cast<float4*>(&ys_s[s * DC + c]) = v;
    }
    __syncthreads();

    // Combine weights, one warp per token, lane = slot: online softmax.
    for (int t = warp; t < nt; t += kWarps) {
      const float v = lane < ns ? L[t * (kTile + 1) + lane] : -INFINITY;
      const float m_old = mx_s[t];
      const float m_new = fmaxf(m_old, warp_max(v));
      const float corr = expf(m_old - m_new);
      const float p = lane < ns ? expf(v - m_new) : 0.f;
      const float psum = warp_sum(p);
      if (lane == 0) {
        den_s[t] = den_s[t] * corr + psum;
        mx_s[t] = m_new;
        corr_s[t] = corr;
      }
      L[t * (kTile + 1) + lane] = p;
    }
    __syncthreads();

    // Mix over the chunk: acc = acc * corr + p Ys.
    float c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = corr_s[4 * warp + i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int v = 0; v < 4 * NV; ++v) acc[i][v] *= c[i];
    for (int s = 0; s < ns; ++s) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = L[(4 * warp + i) * (kTile + 1) + s];
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const float4 yv =
            *reinterpret_cast<const float4*>(&ys_s[s * DC + q * 128 + 4 * lane]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * q + 0] = fmaf(p[i], yv.x, acc[i][4 * q + 0]);
          acc[i][4 * q + 1] = fmaf(p[i], yv.y, acc[i][4 * q + 1]);
          acc[i][4 * q + 2] = fmaf(p[i], yv.z, acc[i][4 * q + 2]);
          acc[i][4 * q + 3] = fmaf(p[i], yv.w, acc[i][4 * q + 3]);
        }
      }
    }
    __syncthreads();  // L, ys_s and the staging buffers are refilled next
  }

  T* out = static_cast<T*>(a.y) + tok0 * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * warp + i;
    if (t >= nt) continue;
    const float den = den_s[t];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + q * 128 + 4 * lane + e;
        if (col < d) out[(size_t)t * d + col] = from_f32<T>(acc[i][4 * q + e] / den);
      }
    }
  }
  if (jc == 0 && tid < nt) {
    a.c_mx[tok0 + tid] = mx_s[tid];
    a.c_den[tok0 + tid] = den_s[tid];
  }
}

template <typename T, int NV>
cudaError_t launch_online(const CombineArgs& a, int B, cudaStream_t stream) {
  constexpr int DC = 128 * NV;
  const size_t smem = sizeof(LogitsSmem) +
                      sizeof(float) * (kTile * DC + kTile * (kTile + 1) + 3 * kTile);
  auto kernel = combine_kernel<T, NV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.d + DC - 1) / DC, (a.m + a.bt - 1) / a.bt, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_online_dc(const CombineArgs& a, int B, int d_chunk,
                             cudaStream_t stream) {
  switch (d_chunk) {
    case 128: return launch_online<T, 1>(a, B, stream);
    case 256: return launch_online<T, 2>(a, B, stream);
    case 384: return launch_online<T, 3>(a, B, stream);
    default: return launch_online<T, 6>(a, B, stream);
  }
}

// ---------------------------------------------------------------------------
// K2: the combine from saved statistics, on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kCT = 64;  // tokens a CTA holds: a chunk is at most this
constexpr int kDC = 64;  // d columns of one mix tile
constexpr int kRB = kDC + 8;  // mix-tile Ys rows (conflict-free B loads)

struct ApplyArgs {
  const void* x;       // (B, m, d)
  const float* phi;    // (d, S)
  const void* ys;      // (B, S, d)
  const float* rn;     // (B, m) inverse norms from the pre-pass
  const float* c_mx;   // (B, m)
  const float* c_den;  // (B, m)
  void* y;             // (B, m, d)
  float* y_acc;        // (B, m, d) f32 scratch, only when S > 128
  int m, d, S, ct;     // ct: tokens of a chunk, 1..kCT
  bool phi_vec;        // Phi_n rows 16-byte aligned (S % 4 == 0)
};

// Shared memory of one CTA (bytes): C [kCT][WS], the chunk's rn, c_mx and
// c_den, then the region of the stages: the logits loop's kStages, or the
// mix loop's two.
template <typename T, int SC>
struct ApplyLayout {
  static constexpr int STC = 32 * SC;  // slots of a slot tile
  static constexpr int WS = STC + 4;   // C rows (4 mod 32 floats)
  static constexpr size_t kC = (size_t)kCT * WS * 4 + 3 * kCT * 4;
  static constexpr size_t kA = LogitsStage<T, STC>::bytes(kCT);
  static constexpr size_t kB =
      ((size_t)STC * kRB * sizeof(T) + 127) / 128 * 128;
  static constexpr size_t kRegion =
      kStages * kA > 2 * kB ? kStages * kA : 2 * kB;
  static constexpr size_t kBytes = kC + kRegion;
};

// One CTA per (token chunk, row); slot tiles of 32 SC slots.
template <typename T, int SC>
__global__ void __launch_bounds__(kThreads, 2)
    combine_apply_kernel(ApplyArgs a) {
  using Ly = ApplyLayout<T, SC>;
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
  char* stage = reinterpret_cast<char*>(smem4) + Ly::kC;

  const size_t tok0 = (size_t)row * m + t0;
  const T* x = static_cast<const T*>(a.x) + tok0 * d;
  const T* ysrow = static_cast<const T*>(a.ys) + (size_t)row * S * d;
  if (tid < nt) {
    trn[tid] = a.rn[tok0 + tid];
    tmx[tid] = a.c_mx[tok0 + tid];
    tden[tid] = a.c_den[tok0 + tid];
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
          C[tl * WS + sl] = tl < nt && sl < ns
              ? expf(trn[tl] * dot - tmx[tl]) / tden[tl] : 0.f;
        });
    __syncthreads();

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
      if (js > 0) {  // y so far, from the scratch
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int tl = r0 + g + 8 * h;
            const int col = c0 + nn * 8 + 2 * t;
            if (tl < nt && col < d) {
              const float2 v = *reinterpret_cast<const float2*>(
                  a.y_acc + (tok0 + tl) * d + col);
              acc[nn][2 * h] = v.x;
              acc[nn][2 * h + 1] = v.y;
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
          const float v0 = acc[nn][2 * h], v1 = acc[nn][2 * h + 1];
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
}

template <typename T, int SC>
cudaError_t launch_apply(const ApplyArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = ApplyLayout<T, SC>::kBytes;
  auto kernel = combine_apply_kernel<T, SC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const unsigned nch = (a.m + a.ct - 1) / a.ct;
  kernel<<<dim3(nch, B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_apply_sc(const ApplyArgs& a, int B, cudaStream_t stream) {
  switch (slot_tile_units(a.S)) {
    case 1: return launch_apply<T, 1>(a, B, stream);
    case 2: return launch_apply<T, 2>(a, B, stream);
    default: return launch_apply<T, 4>(a, B, stream);
  }
}

cudaError_t launch_norms(int dtype, const void* x, void* rn, int B, int m,
                         int d, cudaStream_t s) {
  const long long n_tokens = (long long)B * m;
  return dtype == 0
      ? launch_inv_norm<float>(x, static_cast<float*>(rn), n_tokens, d, s)
      : launch_inv_norm<__nv_bfloat16>(x, static_cast<float*>(rn), n_tokens, d, s);
}

}  // namespace

// Plain C entry point of K2 for ctypes. dtype code of x, ys and y: 0 =
// float32, 1 = bfloat16; Phi_n and the statistics c_mx, c_den (inputs) are
// float32. Every pointer is a device pointer; rn (B*m floats) and, when S >
// 128, y_acc (B*m*d floats; may be null otherwise) are scratch the caller
// allocates. `ct` is the tokens of a chunk (1..64). `stream` is a
// cudaStream_t. Launches the norm pre-pass and the combine kernel and
// returns the first cudaError_t (0 = success). Shapes the kernel does not
// take (ct out of range, d not a multiple of 8, operands not 16-byte
// aligned, scratch missing) return cudaErrorInvalidValue without
// launching.
extern "C" int soft_moe_combine_apply_launch(
    const void* x, const void* phi, const void* ys, const void* c_mx,
    const void* c_den, void* y, void* rn, void* y_acc, int dtype, int B,
    int m, int d, int S, int ct, void* stream) {
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
  a.c_mx = static_cast<const float*>(c_mx);
  a.c_den = static_cast<const float*>(c_den);
  a.y = y;
  a.y_acc = static_cast<float*>(y_acc);
  a.m = m;
  a.d = d;
  a.S = S;
  a.ct = ct;
  a.phi_vec = S % 4 == 0 && aligned16(phi);
  cudaError_t e = launch_norms(dtype, x, rn, B, m, d, s);
  if (e != cudaSuccess) return (int)e;
  e = dtype == 0 ? launch_apply_sc<float>(a, B, s)
                 : launch_apply_sc<__nv_bfloat16>(a, B, s);
  return (int)e;
}

// Plain C entry point of K3 for ctypes. dtype code of x, ys and y: 0 =
// float32, 1 = bfloat16; Phi_n and the statistics c_mx, c_den (outputs)
// are float32. Every pointer is a device pointer; rn (B*m floats) is
// scratch the caller allocates. `stream` is a cudaStream_t. Launches the
// norm pre-pass and the combine kernel and returns the first cudaError_t
// (0 = success). Shapes the kernel does not take (bt or bs outside 1..32,
// d_chunk not 128, 256, 384 or 768, d not a multiple of 8, operands not
// 16-byte aligned) return cudaErrorInvalidValue without launching.
extern "C" int soft_moe_combine_online_launch(
    const void* x, const void* phi, const void* ys, void* c_mx, void* c_den,
    void* y, void* rn, int dtype, int B, int m, int d, int S, int bt, int bs,
    int d_chunk, void* stream) {
  if (B < 0 || B > 65535 || m <= 0 || d <= 0 || S <= 0 || bt < 1 ||
      bt > kTile || bs < 1 || bs > kTile || dtype < 0 || dtype > 1 ||
      !valid_d_chunk(d_chunk) || d % 8 != 0 || !aligned16(x) ||
      !aligned16(ys) || !aligned16(y)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CombineArgs a;
  a.x = x;
  a.phi = static_cast<const float*>(phi);
  a.ys = ys;
  a.rn = static_cast<const float*>(rn);
  a.c_mx = static_cast<float*>(c_mx);
  a.c_den = static_cast<float*>(c_den);
  a.y = y;
  a.m = m;
  a.d = d;
  a.S = S;
  a.bt = bt;
  a.bs = bs;
  cudaError_t e = launch_norms(dtype, x, rn, B, m, d, s);
  if (e != cudaSuccess) return (int)e;
  e = dtype == 0 ? launch_online_dc<float>(a, B, d_chunk, s)
                 : launch_online_dc<__nv_bfloat16>(a, B, d_chunk, s);
  return (int)e;
}
