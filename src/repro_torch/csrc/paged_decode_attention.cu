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
//   out   = sum_t softmax(s)_t V[t,g,:] in f32; a row without a valid key
//           (q_pos < 0, all-null table) returns zeros through the safe
//           divide acc / max(denom, 1e-30). Output in q's dtype.
//
// What bounds it on the H100: memory. Each row reads its live keys once:
// L tokens cost L * (2 * G * D * 2 B + 4 B) in bf16, about 516 B a token
// for qwen2-0.5b (G=2, D=64); the arithmetic (4 * H * D flops a token) is
// far below the f32 rate. At 8 rows of 2048 keys and fewer that is a few
// MB, about a microsecond at 3.35 TB/s: a launch costs more than the bytes,
// so what matters is that enough CTAs read at once (the TPU kernel's
// sequential (row, kv tile) grid would leave 16 CTAs on 132 SMs).
//
// Design (split-KV, as flash-decoding):
//   * Split pass, grid (G, n_split, B), 256 threads. The row's tiles of
//     bkv keys are cut into splits of `split_tiles` tiles
//     (kernels/tuning.py::paged_split_tiles: 128 keys at bkv = 16), a
//     function of the pool's tiling alone; n_split covers the table's
//     width. A CTA reads its tiles' table entries and q while q_pos is in
//     flight, stages the split's K and V rows of its KV group in the
//     pool's dtype with cp.async (16-byte pieces, all in flight at once; K
//     rows padded by 16 bytes so that 16-byte reads of neighbouring rows
//     meet no bank conflict), and folds the split into one f32 partial per
//     head: m = max(-1e30, the valid scores), den = sum exp(s - m), acc =
//     sum exp(s - m) V. GQA is native: K and V are read once for the
//     group's rep heads. A thread's sums cover HB heads at once (a template
//     parameter: 1, 2, 4 or 8; rep padded to whole groups with zero q
//     rows), so each K row and each V element is read from shared memory
//     once for them and their sums run side by side: one thread per key
//     for the scores, one per (group of keys, column) for P V, the groups'
//     sums then added in group order.
//   * Splits past the row's causal end (tile q_pos / bkv) and every split
//     of an inactive row (q_pos < 0) write an empty partial (-1e30, 0, 0)
//     and exit: the merge passes over it without changing a bit.
//   * Partials: (B, n_split, H, Dv + 2) f32, acc then m and den.
//   * Merge pass, one warp per (row, head): the row's partials in split
//     order, with the online update m' = max(m, m_j), den' = den e^(m - m')
//     + den_j e^(m_j - m'), acc likewise; then acc / max(den, 1e-30).
//   * No atomics and a fixed order: row i of a batched launch equals a
//     batch-1 launch bitwise (the per-row invariant of
//     src/repro/kernels/ops.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;  // running-max start, as the TPU kernel's _NEG
constexpr size_t kMaxSmem = 227 * 1024;

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

// 16 bytes from global to shared, asynchronously.
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The elements of a 16-byte piece as floats.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* dst) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) dst[i] = to_f32(e[i]);
}

struct Args {
  const void* q;       // (B, H, Dk)
  const void* k;       // (num_blocks, block_size, G, Dk)
  const void* v;       // (num_blocks, block_size, G, Dv)
  const int* pos;      // (num_blocks, block_size), -1 = invalid
  const int* tables;   // (B, nb) physical block ids, 0 = null block
  const int* q_pos;    // (B,), < 0 = inactive row
  float* part;         // (B, n_split, H, Dv + 2) split partials
  void* out;           // (B, H, Dv)
  int B, H, G, rep, Dk, Dv, block_size, nb, bkv, sub, split_tiles, n_split;
  int rep_pad;         // rep rounded up to whole groups of HB heads
  int causal, has_window, window, is_global;
  float scale;
};

// Groups of keys the P V product splits a split's keys into: enough that
// every thread has a (group, column).
__host__ __device__ inline int key_groups(int Dv) {
  return Dv < kThreads ? kThreads / Dv : 1;
}

// Shared memory of a split CTA (byte offsets): K rows (Dk elements + 16
// bytes each), V rows, q as f32, the scores (then the weights), the P V
// groups' sums, the keys' positions, the tiles' first pool rows; q, the
// scores and the sums have rep_pad head rows (the pad rows are zeros).
// Every offset up to the scores is a multiple of 16: the entry point
// admits only whole 16-byte rows.
struct Layout {
  size_t v, q, s, red, pos, row0, bytes;
};

__host__ __device__ inline Layout layout(int rep, int Dk, int Dv, int el,
                                         int keys, int tiles) {
  Layout L;
  L.v = (size_t)keys * ((size_t)Dk * el + 16);
  L.q = L.v + (size_t)keys * Dv * el;
  L.s = L.q + (size_t)rep * Dk * 4;
  L.red = L.s + (size_t)rep * keys * 4;
  L.pos = L.red + (size_t)key_groups(Dv) * rep * Dv * 4;
  L.row0 = L.pos + (size_t)keys * 4;
  L.bytes = L.row0 + (size_t)tiles * 4;
  return L;
}

// HB: the query heads one thread's sums cover at once (1, 2, 4 or 8); the
// group's rep heads are taken HB at a time, rep_pad = HB * ceil(rep / HB).
template <typename TQ, typename TKV, int HB>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Args a) {
  const int g = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rep = a.rep, rep_pad = a.rep_pad, Dk = a.Dk, Dv = a.Dv;
  const int bkv = a.bkv;
  const int qp = a.q_pos[b];
  float* part = a.part +
      (((size_t)b * a.n_split + j) * a.H + (size_t)g * rep) * (Dv + 2);
  const int t0 = j * a.split_tiles;
  const Layout L = layout(rep_pad, Dk, Dv, (int)sizeof(TKV),
                          a.split_tiles * bkv, a.split_tiles);
  extern __shared__ uint4 smem[];
  char* base = reinterpret_cast<char*>(smem);
  char* k_s = base;
  const TKV* v_s = reinterpret_cast<const TKV*>(base + L.v);
  float* q_s = reinterpret_cast<float*>(base + L.q);
  float* s_s = reinterpret_cast<float*>(base + L.s);
  int* pos_s = reinterpret_cast<int*>(base + L.pos);
  int* row0_s = reinterpret_cast<int*>(base + L.row0);
  const int kb = Dk * (int)sizeof(TKV) + 16;  // K row stride, bytes
  const int vb = Dv * (int)sizeof(TKV);       // V row stride, bytes

  // the split's tiles: first pool row of each (key i of the split is row
  // i % bkv of tile t0 + i / bkv), and q; read while q_pos is in flight
  const int* table = a.tables + (size_t)b * a.nb;
  const int nt_all = min(a.split_tiles, a.nb * a.sub - t0);
  for (int tt = tid; tt < nt_all; tt += kThreads) {
    const int tile = t0 + tt;
    row0_s[tt] = table[tile / a.sub] * a.block_size + (tile % a.sub) * bkv;
  }
  const TQ* q = static_cast<const TQ*>(a.q) +
      ((size_t)b * a.H + (size_t)g * rep) * Dk;
  for (int i = tid; i < rep_pad * Dk; i += kThreads) {
    q_s[i] = i < rep * Dk ? to_f32(q[i]) : 0.f;
  }

  int n_tiles = a.nb * a.sub;
  if (a.causal) n_tiles = qp < 0 ? 0 : min(n_tiles, qp / bkv + 1);
  const int nt = min(nt_all, n_tiles - t0);
  if (nt <= 0) {  // no key of this split counts: an empty partial
    for (int i = tid; i < rep * (Dv + 2); i += kThreads) {
      part[i] = i % (Dv + 2) == Dv ? kNeg : 0.f;
    }
    return;
  }
  const int nk = nt * bkv;
  __syncthreads();

  // K and V rows of the group, 16-byte pieces, every copy in flight
  const char* kp = static_cast<const char*>(a.k);
  const char* vp = static_cast<const char*>(a.v);
  const int pk = Dk * (int)sizeof(TKV) / 16, pv = vb / 16;
  for (int i = tid; i < nk * pk; i += kThreads) {
    const int key = i / pk, c = i - key * pk;
    const size_t row = (size_t)row0_s[key / bkv] + key % bkv;
    cp16(k_s + (size_t)key * kb + c * 16,
         kp + ((row * a.G + g) * Dk) * sizeof(TKV) + c * 16);
  }
  for (int i = tid; i < nk * pv; i += kThreads) {
    const int key = i / pv, c = i - key * pv;
    const size_t row = (size_t)row0_s[key / bkv] + key % bkv;
    cp16(base + L.v + (size_t)key * vb + c * 16,
         vp + ((row * a.G + g) * Dv) * sizeof(TKV) + c * 16);
  }
  for (int key = tid; key < nk; key += kThreads) {
    pos_s[key] = a.pos[row0_s[key / bkv] + key % bkv];
  }
  cp_wait_all();
  __syncthreads();

  // scores: one thread per key, for HB heads at a time (the K row is read
  // once for them; their sums are independent); masked keys get -inf, pad
  // heads 0
  constexpr int kVec = 16 / sizeof(TKV);
  for (int key = tid; key < nk; key += kThreads) {
    const char* kr = k_s + (size_t)key * kb;
    const int kpos = pos_s[key];
    bool ok = kpos >= 0;
    if (a.causal) ok = ok && kpos <= qp;
    if (a.has_window) ok = ok && (kpos > qp - a.window || a.is_global);
    for (int r0 = 0; r0 < rep_pad; r0 += HB) {
      float dot[HB];
#pragma unroll
      for (int u = 0; u < HB; ++u) dot[u] = 0.f;
      for (int c = 0; c < Dk; c += kVec) {
        float kv[kVec];
        unpack<TKV>(*reinterpret_cast<const uint4*>(kr + c * sizeof(TKV)),
                    kv);
#pragma unroll
        for (int u = 0; u < HB; ++u) {
          const float* qr = q_s + (r0 + u) * Dk + c;
#pragma unroll
          for (int e = 0; e < kVec; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + e);
            dot[u] = fmaf(qv.x, kv[e], dot[u]);
            dot[u] = fmaf(qv.y, kv[e + 1], dot[u]);
            dot[u] = fmaf(qv.z, kv[e + 2], dot[u]);
            dot[u] = fmaf(qv.w, kv[e + 3], dot[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < HB; ++u) {
        s_s[(r0 + u) * nk + key] =
            r0 + u >= rep ? 0.f : ok ? a.scale * dot[u] : -INFINITY;
      }
    }
  }
  __syncthreads();

  // the split's max and denominator, one warp per head; the scores become
  // weights exp(s - m), exactly 0 for masked keys
  for (int r = warp; r < rep; r += kWarps) {
    float* sr = s_s + r * nk;
    float mx = kNeg;
    for (int key = lane; key < nk; key += 32) mx = fmaxf(mx, sr[key]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int key = lane; key < nk; key += 32) {
      const float s = sr[key];
      const float p = s == -INFINITY ? 0.f : expf(s - mx);
      sr[key] = p;
      den += p;
    }
    den = warp_sum(den);
    if (lane == 0) {
      part[r * (Dv + 2) + Dv] = mx;
      part[r * (Dv + 2) + Dv + 1] = den;
    }
  }
  __syncthreads();

  // acc = P V: thread (key group qi, column) sums the keys qi, qi + nq,
  // ... in order, for HB heads at a time (each V element read once for
  // them); then the nq groups' sums are added in group order
  const int nq = key_groups(Dv);
  float* red = reinterpret_cast<float*>(base + L.red);  // [nq][rep_pad][Dv]
  for (int item = tid; item < nq * Dv; item += kThreads) {
    const int qi = item / Dv, col = item - qi * Dv;
    for (int r0 = 0; r0 < rep_pad; r0 += HB) {
      float acc[HB];
#pragma unroll
      for (int u = 0; u < HB; ++u) acc[u] = 0.f;
      for (int key = qi; key < nk; key += nq) {
        const float vv = to_f32(v_s[key * Dv + col]);
#pragma unroll
        for (int u = 0; u < HB; ++u) {
          acc[u] = fmaf(s_s[(r0 + u) * nk + key], vv, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < HB; ++u) {
        red[(qi * rep_pad + r0 + u) * Dv + col] = acc[u];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * Dv; i += kThreads) {
    const int r = i / Dv, col = i - r * Dv;
    float acc = 0.f;
    for (int qi = 0; qi < nq; ++qi) {
      acc += red[(qi * rep_pad + r) * Dv + col];
    }
    part[r * (Dv + 2) + col] = acc;
  }
}

// One warp per (row, head): the row's split partials merged in split
// order, then the safe divide. A lane holds columns lane + 32 e (e < 4)
// of a 128-column group; the loads of four splits are in flight at once.
template <typename TQ>
__global__ void __launch_bounds__(kThreads) paged_merge_kernel(Args a) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= a.B * a.H) return;  // warp-uniform
  const int b = w / a.H, h = w - b * a.H, Dv = a.Dv;
  const size_t stride = (size_t)a.H * (Dv + 2);  // one split to the next
  const float* p = a.part + ((size_t)b * a.n_split * a.H + h) * (Dv + 2);
  TQ* out = static_cast<TQ*>(a.out) + ((size_t)b * a.H + h) * Dv;
  for (int c0 = 0; c0 < Dv; c0 += 128) {
    float m = kNeg, den = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j = 0; j < a.n_split; ++j) {
      const float* pj = p + j * stride;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + lane + 32 * e;
        v[e] = col < Dv ? pj[col] : 0.f;
      }
      const float mj = pj[Dv];
      const float m_new = fmaxf(m, mj);
      const float c_old = expf(m - m_new), c_j = expf(mj - m_new);
      den = den * c_old + pj[Dv + 1] * c_j;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = acc[e] * c_old + v[e] * c_j;
      m = m_new;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + lane + 32 * e;
      if (col < Dv) out[col] = from_f32<TQ>(acc[e] / fmaxf(den, 1e-30f));
    }
  }
}

template <typename TQ, typename TKV, int HB>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<TQ, TKV, HB>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(a.G, a.n_split, a.B), kThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const unsigned merge_blocks = (a.B * a.H + kWarps - 1) / kWarps;
  paged_merge_kernel<TQ><<<merge_blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_hb(const Args& a, int hb, size_t smem,
                      cudaStream_t stream) {
  switch (hb) {
    case 1: return launch<TQ, TKV, 1>(a, smem, stream);
    case 2: return launch<TQ, TKV, 2>(a, smem, stream);
    case 4: return launch<TQ, TKV, 4>(a, smem, stream);
    default: return launch<TQ, TKV, 8>(a, smem, stream);
  }
}

}  // namespace

// Plain C entry point for ctypes. dtype codes: 0 = float32, 1 = bfloat16.
// Every pointer is a device pointer; `part` is the (B, n_split, H, Dv + 2)
// f32 scratch of the split partials, n_split = ceil(nb * block_size / bkv
// / split_tiles); `stream` is a cudaStream_t. Launches the split pass and
// the merge and returns the first cudaError_t (0 = success); invalid
// shapes, head dims that are not a multiple of 16 bytes, pools that are
// not 16-byte aligned and splits whose K and V rows do not fit in shared
// memory return cudaErrorInvalidValue without launching.
extern "C" int paged_decode_attend_launch(
    const void* q, const void* k, const void* v, const void* pos,
    const void* tables, const void* q_pos, void* part, void* out,
    int q_dtype, int kv_dtype, int B, int H, int G, int Dk, int Dv,
    int block_size, int nb, int bkv, int split_tiles, int causal,
    int has_window, int window, int is_global, float scale, void* stream) {
  if (B < 0 || H <= 0 || G <= 0 || H % G != 0 || Dk <= 0 || Dv <= 0 ||
      nb <= 0 || bkv <= 0 || block_size % bkv != 0 || split_tiles <= 0 ||
      q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 || kv_dtype > 1 ||
      B > 65535 || G > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  // 16-byte pieces: D a multiple of 16 bytes, pools 16-byte aligned.
  const int kv_elem = kv_dtype == 0 ? 4 : 2;
  if ((Dk * kv_elem) % 16 != 0 || (Dv * kv_elem) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_tiles = (long long)nb * (block_size / bkv);
  const long long n_split = (n_tiles + split_tiles - 1) / split_tiles;
  const int rep = H / G;
  const int hb = rep >= 5 ? 8 : rep >= 3 ? 4 : rep;  // heads a thread sums
  const int rep_pad = (rep + hb - 1) / hb * hb;
  const size_t smem =
      layout(rep_pad, Dk, Dv, kv_elem, split_tiles * bkv, split_tiles).bytes;
  if (n_split > 65535 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.pos = static_cast<const int*>(pos);
  a.tables = static_cast<const int*>(tables);
  a.q_pos = static_cast<const int*>(q_pos);
  a.part = static_cast<float*>(part);
  a.out = out;
  a.B = B;
  a.H = H;
  a.G = G;
  a.rep = rep;
  a.rep_pad = rep_pad;
  a.Dk = Dk;
  a.Dv = Dv;
  a.block_size = block_size;
  a.nb = nb;
  a.bkv = bkv;
  a.sub = block_size / bkv;
  a.split_tiles = split_tiles;
  a.n_split = (int)n_split;
  a.causal = causal;
  a.has_window = has_window;
  a.window = window;
  a.is_global = is_global;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_dtype == 0 && kv_dtype == 0) {
    e = launch_hb<float, float>(a, hb, smem, s);
  } else if (q_dtype == 0 && kv_dtype == 1) {
    e = launch_hb<float, __nv_bfloat16>(a, hb, smem, s);
  } else if (q_dtype == 1 && kv_dtype == 0) {
    e = launch_hb<__nv_bfloat16, float>(a, hb, smem, s);
  } else {
    e = launch_hb<__nv_bfloat16, __nv_bfloat16>(a, hb, smem, s);
  }
  return (int)e;
}
