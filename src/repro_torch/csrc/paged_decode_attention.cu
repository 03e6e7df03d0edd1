// Paged decode attention for Hopper (sm_90a): one query per row and head,
// attending the paged KV pool in place through per-row block tables.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention_kernels.py
// `paged_decode_attend` (body `_paged_decode_kernel`, pallas_call at :176).
// The PyTorch wrapper and the plain version that mirrors this arithmetic
// are in src/repro_torch/kernels/paged_attention.py.
//
// What it computes, per row b and query head h (group g = h / rep):
//   s_t   = scale * q[b,h,:] . K[t,g,:]   over the row's table blocks
//   key t counts iff pos[t] >= 0, pos[t] <= q_pos[b] (causal), and
//         (pos[t] > q_pos[b] - window) | is_global (when a window is set)
//   out   = sum_t softmax(s)_t V[t,g,:], folded in tiles of `bkv` keys
//           with an f32 online softmax (max, denom, acc); a row without a
//           valid key (q_pos < 0, all-null table) returns zeros through the
//           safe divide acc / max(denom, 1e-30). Output in q's dtype.
//
// What bounds it on the H100: memory. Each row reads its live keys once:
// L tokens cost L * (2 * G * D * 2 B + 4 B) in bf16, about 516 B a token
// for qwen2-0.5b (G=2, D=64). At B=8 rows of L=1024 that is 4.2 MB, about
// 1.3 us at 3.35 TB/s, while the arithmetic (4 * H * D flops a token) is
// far below the f32 rate. At these sizes one launch per layer costs more
// in launch overhead than in bytes; that is left for a later change
// (CUDA graphs, split-KV), as is TMA.
//
// Design:
//   * One CTA per (KV group, row): grid (G, B), 256 threads. The CTA reads
//     its table row itself (the TPU kernel prefetched tables as scalars)
//     and loops over the row's tiles inside the CTA (the TPU kernel ran a
//     sequential (b, kv_tile) grid with scratch carried across steps).
//   * GQA is native: the K and V rows of a tile are read once for all
//     `rep` query heads of the group.
//   * Up to 128 keys (several tiles) are staged in shared memory at a time.
//     The stage's table entries are read first, then K and V arrive as
//     16-byte vector loads, several in flight per thread, so the loads
//     overlap instead of each waiting on its own table lookup. All scores
//     of the stage are computed in parallel; the softmax update then folds
//     the stage tile by tile in logical order, one warp per query head, so
//     the arithmetic is the per-tile recurrence of the TPU kernel whatever
//     the staging width.
//   * A row's whole reduction stays in one CTA in a fixed order (no atomics,
//     no split across CTAs): row i of a batched launch equals a batch-1
//     launch bitwise (the per-row invariant of src/repro/kernels/ops.py).
//   * With causal masking the loop stops after the tile holding q_pos:
//     later tiles hold only masked keys, whose update leaves the state
//     unchanged bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStageKeys = 128;
constexpr float kNeg = -1e30f;  // running-max start, as the TPU kernel's _NEG
constexpr size_t kMaxSmem = 220 * 1024;
constexpr int kLoadsInFlight = 8;  // 16-byte loads issued per thread at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Butterfly reductions: every lane ends with the same, bitwise, result.
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void* q;       // (B, H, Dk)
  const void* k;       // (num_blocks, block_size, G, Dk)
  const void* v;       // (num_blocks, block_size, G, Dv)
  const int* pos;      // (num_blocks, block_size), -1 = invalid
  const int* tables;   // (B, nb) physical block ids, 0 = null block
  const int* q_pos;    // (B,), < 0 = inactive row
  void* out;           // (B, H, Dv)
  int H, G, rep, Dk, Dv, block_size, nb, bkv, sub, stage_tiles;
  int causal, has_window, window, is_global;
  float scale;
};

__host__ __device__ inline size_t smem_floats(int rep, int Dk, int Dv,
                                              int stage_keys) {
  return (size_t)rep * Dk             // q
         + (size_t)stage_keys * (Dk + 1)  // K stage, rows padded
         + (size_t)stage_keys * Dv    // V stage
         + (size_t)rep * stage_keys   // scores, then probabilities
         + (size_t)rep * Dv           // accumulators
         + 2 * (size_t)rep            // running max, denom
         + (size_t)stage_keys         // key positions (int)
         + (size_t)stage_keys;        // pool row of each staged tile (int)
}

// Unpack a 16-byte vector of T into floats.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* dst) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) dst[i] = to_f32(e[i]);
}

// Stage `nkeys` rows of width D of one KV group into shared memory as
// f32 (row stride `ld`). Key j lives at pool row row0[j / bkv] + j % bkv.
// Each thread keeps kLoadsInFlight 16-byte loads in flight; the entry point
// admits only D a multiple of the vector width and 16-byte aligned pools,
// so every row start is aligned.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* pool, int G, int g, int D,
                                           const int* row0, int bkv,
                                           int nkeys, float* dst, int ld,
                                           int tid) {
  const size_t row_elems = (size_t)G * D;
  constexpr int kVec = 16 / sizeof(T);
  const int per_key = D / kVec;
  const int n = nkeys * per_key;
  for (int base = tid; base < n; base += kThreads * kLoadsInFlight) {
    uint4 r[kLoadsInFlight];
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int i = base + u * kThreads;
      if (i < n) {
        const int j = i / per_key, c = i - j * per_key;
        const size_t row = (size_t)row0[j / bkv] + j % bkv;
        r[u] = *reinterpret_cast<const uint4*>(
            pool + row * row_elems + (size_t)g * D + (size_t)c * kVec);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int i = base + u * kThreads;
      if (i < n) {
        const int j = i / per_key, c = i - j * per_key;
        unpack<T>(r[u], dst + j * ld + c * kVec);
      }
    }
  }
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Args a) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rep = a.rep, Dk = a.Dk, Dv = a.Dv, bkv = a.bkv;
  const int ks = Dk + 1;  // padded K row stride: no bank conflicts in the dots
  const int stage_keys = a.stage_tiles * bkv;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + rep * Dk;
  float* v_s = k_s + stage_keys * ks;
  float* s_s = v_s + stage_keys * Dv;
  float* acc_s = s_s + rep * stage_keys;
  float* m_s = acc_s + rep * Dv;
  float* den_s = m_s + rep;
  int* pos_s = reinterpret_cast<int*>(den_s + rep);
  int* row0_s = pos_s + stage_keys;

  const int qp = a.q_pos[b];
  TQ* out = static_cast<TQ*>(a.out) + ((size_t)b * a.H + (size_t)g * rep) * Dv;

  int n_tiles = a.nb * a.sub;
  if (a.causal) {
    if (qp < 0) {  // every key is masked: the safe divide yields zeros
      for (int i = tid; i < rep * Dv; i += kThreads) out[i] = from_f32<TQ>(0.f);
      return;
    }
    n_tiles = min(n_tiles, qp / bkv + 1);
  }

  const TQ* q = static_cast<const TQ*>(a.q) + ((size_t)b * a.H + (size_t)g * rep) * Dk;
  for (int i = tid; i < rep * Dk; i += kThreads) q_s[i] = to_f32(q[i]);
  for (int i = tid; i < rep * Dv; i += kThreads) acc_s[i] = 0.f;
  for (int i = tid; i < rep; i += kThreads) {
    m_s[i] = kNeg;
    den_s[i] = 0.f;
  }
  const int* table = a.tables + (size_t)b * a.nb;
  const TKV* kp = static_cast<const TKV*>(a.k);
  const TKV* vp = static_cast<const TKV*>(a.v);

  for (int t0 = 0; t0 < n_tiles; t0 += a.stage_tiles) {
    const int nt = min(a.stage_tiles, n_tiles - t0);
    const int nkeys = nt * bkv;
    __syncthreads();  // the previous stage is fully consumed
    // Pool row of each tile of the stage; key j of the stage is row
    // j % bkv of tile t0 + j / bkv.
    for (int tt = tid; tt < nt; tt += kThreads) {
      const int tile = t0 + tt;
      row0_s[tt] = table[tile / a.sub] * a.block_size + (tile % a.sub) * bkv;
    }
    __syncthreads();
    stage_rows<TKV>(kp, a.G, g, Dk, row0_s, bkv, nkeys, k_s, ks, tid);
    stage_rows<TKV>(vp, a.G, g, Dv, row0_s, bkv, nkeys, v_s, Dv, tid);
    for (int j = tid; j < nkeys; j += kThreads) {
      pos_s[j] = a.pos[row0_s[j / bkv] + j % bkv];
    }
    __syncthreads();
    // Scores of the whole stage; masked keys get -inf, so their
    // probability below is exactly 0 (the TPU kernel zeroes them with a
    // select after exp; the running max is the same either way).
    for (int i = tid; i < rep * nkeys; i += kThreads) {
      const int r = i / nkeys, j = i - r * nkeys;
      const float* qr = q_s + r * Dk;
      const float* kr = k_s + j * ks;
      float dot = 0.f;
      for (int d = 0; d < Dk; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int kpos = pos_s[j];
      bool ok = kpos >= 0;
      if (a.causal) ok = ok && kpos <= qp;
      if (a.has_window) ok = ok && (kpos > qp - a.window || a.is_global);
      s_s[r * stage_keys + j] = ok ? a.scale * dot : -INFINITY;
    }
    __syncthreads();
    // Online softmax: one warp per query head, tiles in logical order.
    for (int r = warp; r < rep; r += kWarps) {
      float m = m_s[r], den = den_s[r];
      float* sr = s_s + r * stage_keys;
      for (int tt = 0; tt < nt; ++tt) {
        float* st = sr + tt * bkv;
        const float* vt = v_s + (size_t)tt * bkv * Dv;
        float mx = -INFINITY;
        for (int j = lane; j < bkv; j += 32) mx = fmaxf(mx, st[j]);
        const float m_new = fmaxf(m, warp_max(mx));
        const float corr = expf(m - m_new);
        float psum = 0.f;
        for (int j = lane; j < bkv; j += 32) {
          const float s = st[j];
          const float p = (s == -INFINITY) ? 0.f : expf(s - m_new);
          st[j] = p;
          psum += p;
        }
        den = den * corr + warp_sum(psum);
        m = m_new;
        __syncwarp();
        for (int d = lane; d < Dv; d += 32) {
          float pv = 0.f;
          for (int j = 0; j < bkv; ++j) pv = fmaf(st[j], vt[j * Dv + d], pv);
          acc_s[r * Dv + d] = acc_s[r * Dv + d] * corr + pv;
        }
        __syncwarp();
      }
      if (lane == 0) {
        m_s[r] = m;
        den_s[r] = den;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * Dv; i += kThreads) {
    out[i] = from_f32<TQ>(acc_s[i] / fmaxf(den_s[i / Dv], 1e-30f));
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const Args& a, int B, size_t smem, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(a.G, B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. dtype codes: 0 = float32, 1 = bfloat16.
// Every pointer is a device pointer; `stream` is a cudaStream_t. Returns
// the cudaError_t of the launch (0 = success); invalid shapes, head dims
// that are not a multiple of 16 bytes and pools that are not 16-byte
// aligned return cudaErrorInvalidValue without launching.
extern "C" int paged_decode_attend_launch(
    const void* q, const void* k, const void* v, const void* pos,
    const void* tables, const void* q_pos, void* out, int q_dtype,
    int kv_dtype, int B, int H, int G, int Dk, int Dv, int block_size, int nb,
    int bkv, int causal, int has_window, int window, int is_global,
    float scale, void* stream) {
  if (B < 0 || H <= 0 || G <= 0 || H % G != 0 || Dk <= 0 || Dv <= 0 ||
      nb <= 0 || bkv <= 0 || block_size % bkv != 0 || q_dtype < 0 ||
      q_dtype > 1 || kv_dtype < 0 || kv_dtype > 1 || B > 65535 ||
      G > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  // 16-byte vector loads: D a multiple of 16 bytes, pools 16-byte aligned.
  const int kv_elem = kv_dtype == 0 ? 4 : 2;
  if ((Dk * kv_elem) % 16 != 0 || (Dv * kv_elem) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaSuccess;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.pos = static_cast<const int*>(pos);
  a.tables = static_cast<const int*>(tables);
  a.q_pos = static_cast<const int*>(q_pos);
  a.out = out;
  a.H = H;
  a.G = G;
  a.rep = H / G;
  a.Dk = Dk;
  a.Dv = Dv;
  a.block_size = block_size;
  a.nb = nb;
  a.bkv = bkv;
  a.sub = block_size / bkv;
  a.causal = causal;
  a.has_window = has_window;
  a.window = window;
  a.is_global = is_global;
  a.scale = scale;
  a.stage_tiles = bkv >= kMaxStageKeys ? 1 : kMaxStageKeys / bkv;
  while (a.stage_tiles > 1 &&
         smem_floats(a.rep, Dk, Dv, a.stage_tiles * bkv) * 4 > kMaxSmem) {
    --a.stage_tiles;
  }
  const size_t smem = smem_floats(a.rep, Dk, Dv, a.stage_tiles * bkv) * 4;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_dtype == 0 && kv_dtype == 0) {
    e = launch<float, float>(a, B, smem, s);
  } else if (q_dtype == 0 && kv_dtype == 1) {
    e = launch<float, __nv_bfloat16>(a, B, smem, s);
  } else if (q_dtype == 1 && kv_dtype == 0) {
    e = launch<__nv_bfloat16, float>(a, B, smem, s);
  } else {
    e = launch<__nv_bfloat16, __nv_bfloat16>(a, B, smem, s);
  }
  return (int)e;
}
