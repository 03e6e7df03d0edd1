// K1, Soft-MoE routing for Hopper (sm_90a): one logits pass yields the
// dispatched slots and both softmax directions' statistics.
//
// Replaces the TPU kernel src/repro/kernels/soft_moe_kernels.py
// `routing_fwd_pallas` (body `_routing_fwd_kernel`, pallas_call at :203).
// The PyTorch wrapper and the plain version that repeats this arithmetic
// are in src/repro_torch/kernels/soft_moe_kernels.py.
//
// What it computes, per batch row (x: (B, m, d), Phi_n: (d, S) f32):
//   logits[t, s] = l2norm(x[t]) . Phi_n[:, s]              (f32)
//   D = softmax over tokens (per slot)
//   slots[s]     = sum_t D[t, s] x[t]   (raw x; output in x's dtype)
//   (d_mx, d_den)[s] = the dispatch softmax's (max, denom)   (f32)
//   (c_mx, c_den)[t] = the combine softmax's (max, denom) over all slots
// No (m x S) logits or weights tensor reaches device memory.
//
// What bounds it on the H100: at the f32 rate, arithmetic: 4 m S d flops
// a row (the logits and the slot mix), 4.95 GFLOP at the Soft-MoE B/16
// layer (B=64, m=196, d=768, S=128, bf16 x), ~74 us at 67 TFLOP/s,
// against ~32 MB (~10 us at 3.35 TB/s). On the tensor cores each product
// takes two TF32 passes (bf16 x): ~20 us at the dense TF32 peak, which
// binds there. At the granite LM layer (B=8, m=2048, d=1024, S=32) the
// bytes bind: x read once and the 32 chunks' slot partials written and
// read, ~102 MB, ~30 us (chip_smoke.py::soft_moe_fwd_design_bound).
//
// Design (the TPU kernel's grid (b, slot block, token block) runs in
// order and carries the slot accumulator in VMEM across token blocks;
// CUDA blocks run in no order):
//   * A pre-pass computes every token's inverse L2 norm (inv_norm_kernel).
//   * One CTA per (token chunk, slot tile, row): a chunk is `ct` tokens
//     (kernels/tuning.py::routing_chunk: a function of m, S and the token
//     block, never of the batch; at most 256), a slot tile the `bs` slots
//     of a slot block (at most 32). The CTA forms its (chunk x slot tile)
//     logits once over the whole of d on the tensor cores
//     (soft_moe_mma.cuh::logits_tile_mma) into shared memory, takes the
//     slot tile's combine (max, denom) per token, the chunk's dispatch max
//     per slot and P = exp(L - max) in place, then streams d in 64-column
//     tiles (double-buffered) and forms P^T x on the tensor cores (P split
//     into two TF32 parts, bf16 x exact; a P fragment feeds two 8-column
//     tiles). No tile is computed twice: 4 m S d flops.
//   * A row of one chunk (the ViTs: no partials) writes its normalised
//     slots and dispatch stats directly. A row of several chunks writes
//     each chunk's unnormalised slots and (max, denom); a second kernel
//     merges them in chunk order: M = max_j m_j, den = sum_j den_j
//     e^(m_j - M), slot = sum_j part_j e^(m_j - M) / den.
//   * The combine statistics need a reduction over every slot tile: each
//     writes its partial (max, denom) per token, merged per token in
//     slot-tile order by the same second kernel (a row of one slot tile
//     writes them directly). No atomics.
//   * Every reduction stays inside one row in a fixed order, so row i of a
//     batched launch equals a batch-1 launch bitwise (the per-row invariant
//     of src/repro/kernels/ops.py).
#include "soft_moe_mma.cuh"

namespace {

using namespace smoe;

constexpr int kMaxChunk = 256;  // tokens of a chunk: at most this
constexpr int kWS = kTile + 8;  // logits / P rows (8 mod 32 floats)
constexpr int kDC = 64;         // d columns of one mix tile
constexpr int kRB = kDC + 8;    // mix-tile x rows (conflict-free B loads)

struct RoutingArgs {
  const void* x;     // (B, m, d)
  const float* phi;  // (d, S)
  const float* rn;   // (B, m) inverse norms from the pre-pass
  void* slots;       // (B, S, d): written here when a row is one chunk
  float* part;       // (B, nch, S, d) f32 slot partials when nch > 1
  float* dmx;        // (B, nch, S) the chunks' dispatch (max, denom):
  float* dden;       //   d_mx, d_den themselves when nch == 1
  float* cmx;        // (B, nsb, m) the slot tiles' combine (max, denom):
  float* cden;       //   c_mx, c_den themselves when nsb == 1
  int m, d, S, ct, bs, nch, nsb;
  bool phi_vec;      // Phi_n rows 16-byte aligned for every slot tile
};

// Bytes of one stage of the mix loop (x rows) for a chunk of up to `rows`
// tokens; it runs two stages in the region where the logits loop ran
// kStages.
template <typename T>
__host__ __device__ size_t mix_stage_bytes(int rows) {
  return ((size_t)rows * kRB * sizeof(T) + 127) / 128 * 128;
}

template <typename T>
__host__ __device__ size_t stage_region_bytes(int rows) {
  const size_t a = kStages * LogitsStage<T, kTile>::bytes(rows);
  const size_t b = 2 * mix_stage_bytes<T>(rows);
  return a > b ? a : b;
}

// Dynamic shared memory of one CTA: the logits / P tile, the chunk's
// dispatch (max, denom) per slot and the stages.
template <typename T>
size_t smem_bytes(int rows) {
  return (size_t)rows * kWS * 4 + 2 * kTile * 4 + stage_region_bytes<T>(rows);
}

// One CTA per (token chunk, slot tile, row); chunks of up to 32 MT tokens.
template <typename T, int MT>
__global__ void __launch_bounds__(kThreads, 2) routing_kernel(RoutingArgs a) {
  constexpr bool F32 = std::is_same<T, float>::value;
  const int chunk = blockIdx.x, js = blockIdx.y, row = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m = a.m, d = a.d, S = a.S;
  const int t0 = chunk * a.ct, nt = min(a.ct, m - t0);
  const int s0 = js * a.bs, ns = min(a.bs, S - s0);
  const int rows = (a.ct + 31) & ~31;  // the layout's token rows
  const int rk = (nt + 31) & ~31;      // rows the mix reads (past nt: 0)

  extern __shared__ float4 smem4[];
  float* L = reinterpret_cast<float*>(smem4);  // [rows][kWS]: logits, P
  float* smx = L + rows * kWS;                 // the chunk's max per slot
  float* sden = smx + kTile;                   // its sum of P per slot
  char* stage = reinterpret_cast<char*>(sden + kTile);

  const size_t tok0 = (size_t)row * m + t0;
  const T* x = static_cast<const T*>(a.x) + tok0 * d;
  const float* rn = a.rn + tok0;

  // ---- the logits tile over the whole of d: warps 2 (tokens) x 4 (8 slots)
  logits_tile_mma<T, 2, 4, MT, 1>(
      x, nt, a.phi, S, s0, d, a.phi_vec, stage,
      LogitsStage<T, kTile>::bytes(rows), tid,
      [&](int tl, int sl, float dot) {
        L[tl * kWS + sl] = (tl < nt ? rn[tl] : 0.f) * dot;
      });
  __syncthreads();

  // ---- combine direction: this slot tile's (max, denom) per token
  {
    const size_t o = ((size_t)row * a.nsb + js) * m + t0;
    for (int tl = warp; tl < nt; tl += kWarps) {
      const float v = lane < ns ? L[tl * kWS + lane] : -INFINITY;
      const float pm = warp_max(v);
      const float pd = warp_sum(lane < ns ? expf(v - pm) : 0.f);
      if (lane == 0) {
        a.cmx[o + tl] = pm;
        a.cden[o + tl] = pd;
      }
    }
  }
  __syncthreads();

  // ---- dispatch direction: the chunk's softmax per slot, one warp a slot,
  // lanes over tokens; P replaces the logits (0 past nt and for slots
  // past ns)
  for (int s = warp; s < kTile; s += kWarps) {
    if (s >= ns) {
      for (int tl = lane; tl < rk; tl += 32) L[tl * kWS + s] = 0.f;
      continue;
    }
    float v = -INFINITY;
    for (int tl = lane; tl < nt; tl += 32) v = fmaxf(v, L[tl * kWS + s]);
    const float mx = warp_max(v);
    float sum = 0.f;
    for (int tl = lane; tl < rk; tl += 32) {
      const float p = tl < nt ? expf(L[tl * kWS + s] - mx) : 0.f;
      L[tl * kWS + s] = p;
      sum += p;
    }
    const float den = warp_sum(sum);
    if (lane == 0) {
      smx[s] = mx;
      sden[s] = den;
    }
  }
  __syncthreads();
  if (tid < ns) {
    const size_t o = ((size_t)row * a.nch + chunk) * S + s0 + tid;
    a.dmx[o] = smx[tid];
    a.dden[o] = sden[tid];
  }

  // ---- the slot mix over d, 64 columns at a time, double-buffered: warp
  // (sm, sn) holds slots sm * 16.. and columns sn * 16 + nn * 8 (nn < 2)
  // of the tile; the tokens in slices of 32
  const int sm = warp >> 2, sn = warp & 3;
  const bool one = a.nch == 1;
  const int ndt = (d + kDC - 1) / kDC;
  const size_t mbytes = mix_stage_bytes<T>(rows);
  auto fill = [&](int jd) {
    stage_rows_n<T, kDC>(reinterpret_cast<T*>(stage + (jd & 1) * mbytes),
                         kRB, x, rk, nt, d, jd * kDC, tid);
    cp_commit();
  };
  fill(0);
  float den[2];  // the denominators of this thread's two slots
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int sl = sm * 16 + g + 8 * h;
    den[h] = sl < ns ? sden[sl] : 1.f;
  }
  for (int jd = 0; jd < ndt; ++jd) {
    cp_wait<0>();
    __syncthreads();  // tile jd is in; every warp is done with jd - 1
    if (jd + 1 < ndt) fill(jd + 1);
    if (sm * 16 >= ns) continue;  // warp-uniform: no live slot
    const T* xb = reinterpret_cast<const T*>(stage + (jd & 1) * mbytes);
    float acc[2][4];
    zero(acc);
    for (int k0 = 0; k0 < nt; k0 += 32) {
      float big[2][4], small[2][4];
      zero(big);
      zero(small);
#pragma unroll
      for (int kk = 0; kk < 32; kk += 8) {
        float v[4];
        ld_a_t(v, L + (k0 + kk) * kWS + sm * 16, kWS, g, t);
        Frag<4> fp;
        make_frag<true>(fp, v);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          float w[2];
          ld_b_kn(w, xb + (k0 + kk) * kRB + sn * 16 + nn * 8, kRB, g, t);
          Frag<2> fx;
          make_frag<F32>(fx, w);
          mma_f32<true, F32>(big[nn], small[nn], fp, fx);
        }
      }
      add_to(acc, big, small);
    }
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      const int col = jd * kDC + sn * 16 + nn * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int sl = sm * 16 + g + 8 * h;
        if (sl >= ns || col >= d) continue;
        const float v0 = acc[nn][2 * h], v1 = acc[nn][2 * h + 1];
        if (one) {
          T* out = static_cast<T*>(a.slots) + ((size_t)row * S + s0 + sl) * d + col;
          if constexpr (F32) {
            *reinterpret_cast<float2*>(out) =
                make_float2(v0 / den[h], v1 / den[h]);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(out) =
                __floats2bfloat162_rn(v0 / den[h], v1 / den[h]);
          }
        } else {
          const size_t o =
              (((size_t)row * a.nch + chunk) * S + s0 + sl) * d + col;
          *reinterpret_cast<float2*>(a.part + o) = make_float2(v0, v1);
        }
      }
    }
  }
}

// The second pass. Blocks [0, n_slot) merge, for (row, s) = (b / S, b % S),
// the chunks' slot partials and dispatch stats in chunk order; the blocks
// after them merge each token's per-slot-tile combine partials in
// slot-tile order: M' = max(M, pm_j); D' = D e^(M - M') + pd_j e^(pm_j - M').
struct MergeArgs {
  const float* part;      // (B, nch, S, d)
  const float* pmx;       // (B, nch, S)
  const float* pden;      // (B, nch, S)
  void* slots;            // (B, S, d)
  float* d_mx;            // (B, S)
  float* d_den;           // (B, S)
  const float* cpm;       // (B, nsb, m)
  const float* cpd;       // (B, nsb, m)
  float* c_mx;            // (B, m)
  float* c_den;           // (B, m)
  long long n_slot;       // B S when nch > 1, else 0
  long long n_tok;        // B m when nsb > 1, else 0
  int m, d, S, nch, nsb;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) routing_merge_kernel(MergeArgs a) {
  const int tid = threadIdx.x;
  if ((long long)blockIdx.x < a.n_slot) {
    extern __shared__ float w[];  // [nch]: e^(m_j - M)
    const int S = a.S, d = a.d, nch = a.nch;
    const long long row = blockIdx.x / S, s = blockIdx.x - row * S;
    const float* pm = a.pmx + row * nch * S + s;  // chunk stride S
    const float* pd = a.pden + row * nch * S + s;
    float mx = kNeg;
    for (int j = 0; j < nch; ++j) mx = fmaxf(mx, pm[(size_t)j * S]);
    for (int j = tid; j < nch; j += kThreads) w[j] = expf(pm[(size_t)j * S] - mx);
    __syncthreads();
    float den = 0.f;  // every thread, in the same order
    for (int j = 0; j < nch; ++j) den += pd[(size_t)j * S] * w[j];
    if (tid == 0) {
      a.d_mx[row * S + s] = mx;
      a.d_den[row * S + s] = den;
    }
    const float* p = a.part + (row * nch * S + s) * d;  // chunk stride S d
    T* out = static_cast<T*>(a.slots) + (row * S + s) * d;
    const size_t cs = (size_t)S * d;
    for (int c = 4 * tid; c < d; c += 4 * kThreads) {  // d % 8 == 0
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      int j = 0;
      for (; j + 8 <= nch; j += 8) {  // the loads in flight, the adds in order
        float4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = *reinterpret_cast<const float4*>(p + (size_t)(j + u) * cs + c);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          acc[0] += v[u].x * w[j + u];
          acc[1] += v[u].y * w[j + u];
          acc[2] += v[u].z * w[j + u];
          acc[3] += v[u].w * w[j + u];
        }
      }
      for (; j < nch; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(p + (size_t)j * cs + c);
        acc[0] += v.x * w[j];
        acc[1] += v.y * w[j];
        acc[2] += v.z * w[j];
        acc[3] += v.w * w[j];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) out[c + e] = from_f32<T>(acc[e] / den);
    }
    return;
  }
  const long long i =
      ((long long)blockIdx.x - a.n_slot) * kThreads + tid;
  if (i >= a.n_tok) return;
  const long long row = i / a.m, tk = i - row * a.m;
  float mx = kNeg, den = 0.f;
  for (int j = 0; j < a.nsb; ++j) {
    const size_t k = ((size_t)row * a.nsb + j) * a.m + tk;
    const float pm = a.cpm[k];
    const float m_new = fmaxf(mx, pm);
    den = den * expf(mx - m_new) + a.cpd[k] * expf(pm - m_new);
    mx = m_new;
  }
  a.c_mx[i] = mx;
  a.c_den[i] = den;
}

template <typename T, int MT>
cudaError_t launch(const RoutingArgs& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>((a.ct + 31) & ~31);
  auto kernel = routing_kernel<T, MT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(a.nch, a.nsb, B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ct(const RoutingArgs& a, int B, cudaStream_t stream) {
  if (a.ct <= 64) return launch<T, 2>(a, B, stream);
  if (a.ct <= 128) return launch<T, 4>(a, B, stream);
  return launch<T, 8>(a, B, stream);
}

}  // namespace

// Plain C entry point for ctypes. dtype code of x and slots: 0 = float32,
// 1 = bfloat16; Phi_n and every statistic are float32. Every pointer is a
// device pointer. Scratch the caller allocates: rn (B*m floats); when
// ceil(S / bs) > 1, c_part_mx and c_part_den (B*ceil(S/bs)*m floats each);
// when ceil(m / ct) > 1, s_part (B*ceil(m/ct)*S*d floats) and s_part_mx and
// s_part_den (B*ceil(m/ct)*S floats each); scratch that is not needed may
// be null. `ct` is the tokens of a chunk (1..256), `bs` the slots of a
// slot tile (1..32). `stream` is a cudaStream_t. Launches the norm
// pre-pass, the routing kernel and, where a row has several chunks or
// slot tiles, the merge, and returns the first cudaError_t (0 = success).
// Shapes the kernels do not take (ct or bs out of range, d not a multiple
// of 8, operands not 16-byte aligned, scratch missing) return
// cudaErrorInvalidValue without launching.
extern "C" int soft_moe_routing_launch(
    const void* x, const void* phi, void* slots, void* d_mx, void* d_den,
    void* c_mx, void* c_den, void* rn, void* c_part_mx, void* c_part_den,
    void* s_part, void* s_part_mx, void* s_part_den, int dtype, int B, int m,
    int d, int S, int ct, int bs, void* stream) {
  if (B < 0 || B > 65535 || m <= 0 || d <= 0 || S <= 0 || ct < 1 ||
      ct > kMaxChunk || bs < 1 || bs > kTile || dtype < 0 || dtype > 1 ||
      d % 8 != 0 || !aligned16(x) || !aligned16(slots)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nch = (m + ct - 1) / ct, nsb = (S + bs - 1) / bs;
  if (nsb > 65535 || nch > 12288 ||
      (nsb > 1 && (c_part_mx == nullptr || c_part_den == nullptr)) ||
      (nch > 1 && (!aligned16(s_part) || s_part == nullptr ||
                   s_part_mx == nullptr || s_part_den == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RoutingArgs a;
  a.x = x;
  a.phi = static_cast<const float*>(phi);
  a.rn = static_cast<const float*>(rn);
  a.slots = slots;
  a.part = static_cast<float*>(s_part);
  a.dmx = static_cast<float*>(nch > 1 ? s_part_mx : d_mx);
  a.dden = static_cast<float*>(nch > 1 ? s_part_den : d_den);
  a.cmx = static_cast<float*>(nsb > 1 ? c_part_mx : c_mx);
  a.cden = static_cast<float*>(nsb > 1 ? c_part_den : c_den);
  a.m = m;
  a.d = d;
  a.S = S;
  a.ct = ct;
  a.bs = bs;
  a.nch = nch;
  a.nsb = nsb;
  a.phi_vec = S % 4 == 0 && bs % 4 == 0 && aligned16(phi);
  const long long n_tokens = (long long)B * m;
  cudaError_t e = dtype == 0
      ? launch_inv_norm<float>(x, static_cast<float*>(rn), n_tokens, d, s)
      : launch_inv_norm<__nv_bfloat16>(x, static_cast<float*>(rn), n_tokens, d, s);
  if (e != cudaSuccess) return (int)e;
  e = dtype == 0 ? launch_ct<float>(a, B, s)
                 : launch_ct<__nv_bfloat16>(a, B, s);
  if (e != cudaSuccess) return (int)e;
  if (nch == 1 && nsb == 1) return (int)cudaSuccess;
  MergeArgs g;
  g.part = a.part;
  g.pmx = a.dmx;
  g.pden = a.dden;
  g.slots = slots;
  g.d_mx = static_cast<float*>(d_mx);
  g.d_den = static_cast<float*>(d_den);
  g.cpm = a.cmx;
  g.cpd = a.cden;
  g.c_mx = static_cast<float*>(c_mx);
  g.c_den = static_cast<float*>(c_den);
  g.n_slot = nch > 1 ? (long long)B * S : 0;
  g.n_tok = nsb > 1 ? n_tokens : 0;
  g.m = m;
  g.d = d;
  g.S = S;
  g.nch = nch;
  g.nsb = nsb;
  const long long blocks = g.n_slot + (g.n_tok + kThreads - 1) / kThreads;
  const size_t smem = nch > 1 ? (size_t)nch * 4 : 0;
  if (dtype == 0)
    routing_merge_kernel<float><<<(unsigned)blocks, kThreads, smem, s>>>(g);
  else
    routing_merge_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, smem, s>>>(g);
  return (int)cudaGetLastError();
}
