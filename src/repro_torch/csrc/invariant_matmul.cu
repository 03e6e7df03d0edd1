// Fixed-order f32 contraction for Hopper (sm_90a): out[n,p,q] = sum_k
// a[n,p,k] * b[n,k,q], where every output element is summed in one order
// that depends on K alone, never on how many rows (p) or matrices (n) the
// launch holds, nor on the tile or the CTA that computes it.
//
// Replaces no TPU kernel. The reference computes these products with XLA
// einsums: the sparse MoE router logits (src/repro/core/sparse_moe.py:53)
// and the two f32 products of dense attention (src/repro/layers/
// attention.py:121 and :128), which MLA runs over its latent view, and
// MLA's w_uv expansion (:527). On the card cuBLAS picks its f32 kernel,
// and with it the reduction order, by the row count and the batch count,
// so a request's router logits and MLA scores moved with its batch
// neighbours and serve.telemetry.batch_variance_probe read ~1e-2 where the
// reference requires < 1e-5. This kernel gives the per-row invariant of
// src/repro/kernels/ops.py: row i of an M-row launch, or matrix i of an
// n-matrix launch, equals a 1-row or 1-matrix launch bitwise.
// The PyTorch wrapper, its launch plan (_plan) and the plain versions are
// in src/repro_torch/kernels/invariant_matmul.py.
//
// The order, per output element (kTK, kChunk: the same for every launch):
//   * k is cut into 8-wide steps, taken in index order; a step's partial
//     is one chain of tensor-core products at f32 accuracy ("split TF32":
//     each operand v = hi + lo, hi = tf32(v), lo = tf32(v - hi); the step
//     is lo_a hi_b, then + hi_a lo_b, then + hi_a hi_b, each an
//     mma.sync.m16n8k8 started from zero at the step);
//   * the steps' partials are added in f32 on the CUDA cores (round to
//     nearest) into a chunk sum, a chunk being 256 consecutive k from 0;
//   * the chunk sums are added in chunk order into the total, from 0.
//   k past K reads zeros. A tensor core's accumulation inside one mma does
// not round to nearest; promoting every 8-wide step to a CUDA-core sum
// keeps that to one step's terms, and the two-level sum (steps into
// chunks, chunks into the total) keeps the rounding of long sums small.
//   Where the chunks are summed is a launch choice that leaves the order
// as it is: one CTA walks all chunks (its chunk and total sums in
// registers), or, when the grid would not fill the card (decode shapes),
// a cluster of n_chunks CTAs takes one chunk each and the cluster adds the
// chunk sums in chunk order from 0 through distributed shared memory: the
// same additions, so the same bits. No atomics. The split count is the
// chunk count, a function of K alone.
//
// What bounds it on the H100: at decode (a few rows) the bytes of the
// shared operand (the router weight, the latent view) and latency; at
// prefill and training's router rows the issue of the products (the bound
// counts f32 FMAs at 67 TFLOP/s; split TF32 takes 3 mma a step, and each
// operand value 5 ALU ops to split). Design: a CTA of 8 warps owns a
// register-blocked output tile, 16 x 64 (decode rows: all 16 heads of an
// MLA matrix, each latent view read once), 64 x 64 (a warp 16 x 32) or
// 128 x 64 (a warp 32 x 32), so the shared operand is read once a tile of
// rows, not once every 8 rows; each staged value feeds 2-4 mma. Operands
// stream through a ring of kStages 32-deep k tiles in dynamic shared
// memory by cp.async (16-byte copies where the base, the strides and the
// extent allow, else 4-byte ones), so the loads of tile t + 3 overlap the
// products of tile t. At most 128 registers a thread, so two CTAs share an
// SM. A is read k-unit-stride; B either q-unit-stride (the router weight,
// the latent values, w_uv) into [k][q] or k-unit-stride (the transposed
// key view) into [q][k], with no copy. Row strides of 36 and 72 words
// make every fragment load conflict free. The TF32 rounding is done by
// integer ops (the bits of cvt.rna.tf32.f32, which ran slower).
#include <cooperative_groups.h>

#include "soft_moe_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using smoe::Frag;
using smoe::kThreads;

constexpr int kTK = 32;                  // k tile: one stage, 4 mma steps
constexpr int kChunkTiles = 8;           // k tiles a chunk
constexpr int kChunk = kTK * kChunkTiles;  // 256 k a chunk
constexpr int kMaxSplit = 8;             // a portable cluster
constexpr int kStages = 4;               // cp.async ring depth
constexpr int kRS = kTK + 4;             // [row][k] stride: A, k-fast B

struct Args {
  const float* a;
  const float* b;
  float* out;
  int P, K, Q;
  long long sa_n, sa_p;
  long long sb_n, sb_k, sb_q;
  int vec_a, vec_b;  // 16-byte copies of A, of B
  int n_split;       // 1, or the chunk count: one chunk a CTA of a cluster
};

// An output tile of WM x WN warps, each MT 16-row by NT 8-column mma
// tiles; B staged [k][q] or, KF, [q][k].
template <int WM, int WN, int MT, int NT, bool KF>
struct Tile {
  static constexpr int BM = WM * MT * 16;
  static constexpr int BN = WN * NT * 8;
  static constexpr int kQS = BN + 8;  // [k][q] stride
  static constexpr int kA = BM * kRS;
  static constexpr int kB = KF ? BN * kRS : kTK * kQS;
  static constexpr int kStage = kA + kB;  // floats, a multiple of 4
  static constexpr size_t kSmem = (size_t)kStages * kStage * sizeof(float);
  static_assert(WM * WN * 32 == kThreads, "8 warps");
  static_assert(BM * BN <= kStages * kStage, "the merge tile fits");
};

// Rows [r0, r0 + ROWS) x elements [c0, c0 + COLS) of a matrix whose rows
// are unit-stride (row r at src + r * ld) into dst[r][c] (row stride ds);
// a row >= nr or an element >= nc is zero. W-wide copies (16 or 4 bytes).
template <int ROWS, int COLS, int W>
__device__ __forceinline__ void stage_rows(float* dst, int ds, const float* src,
                                           long long ld, int r0, int nr,
                                           int c0, int nc, int tid) {
  constexpr int kP = COLS / W;
  for (int i = tid; i < ROWS * kP; i += kThreads) {
    const int r = i / kP, c = W * (i % kP);
    const bool ok = r0 + r < nr && c0 + c < nc;
    const float* s = ok ? src + (r0 + r) * ld + c0 + c : src;
    if (W == 4) {
      smoe::cp16(dst + r * ds + c, s, ok);
    } else {
      smoe::cp4(dst + r * ds + c, s, ok);
    }
  }
}

// Stage k tile [k0, k0 + 32) of rows p0.. of A and columns q0.. of B.
template <class T, bool KF>
__device__ __forceinline__ void stage(float* sa, float* sb, const Args& g,
                                      const float* a, const float* b, int p0,
                                      int q0, int k0, int tid) {
  if (g.vec_a) {
    stage_rows<T::BM, kTK, 4>(sa, kRS, a, g.sa_p, p0, g.P, k0, g.K, tid);
  } else {
    stage_rows<T::BM, kTK, 1>(sa, kRS, a, g.sa_p, p0, g.P, k0, g.K, tid);
  }
  if (KF) {  // [q][k]: b[k][q] at q * sb_q + k
    if (g.vec_b) {
      stage_rows<T::BN, kTK, 4>(sb, kRS, b, g.sb_q, q0, g.Q, k0, g.K, tid);
    } else {
      stage_rows<T::BN, kTK, 1>(sb, kRS, b, g.sb_q, q0, g.Q, k0, g.K, tid);
    }
  } else {  // [k][q]: b[k][q] at k * sb_k + q
    if (g.vec_b) {
      stage_rows<kTK, T::BN, 4>(sb, T::kQS, b, g.sb_k, k0, g.K, q0, g.Q, tid);
    } else {
      stage_rows<kTK, T::BN, 1>(sb, T::kQS, b, g.sb_k, k0, g.K, q0, g.Q, tid);
    }
  }
}

// v = hi + lo, each rounded to TF32 to nearest, ties away from zero: the
// bits of cvt.rna.tf32.f32 (smoe::make_frag), by integer ops on the ALU
// (half a TF32 unit added to the magnitude, the 13 low bits cleared).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

template <int N>
__device__ __forceinline__ void split(Frag<N>& f, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f.h[i] = tf32_rna(v[i]);
    f.l[i] = tf32_rna(v[i] - __uint_as_float(f.h[i]));
  }
}

// d = a b + 0: one m16n8k8 TF32 product from zero, C read from a zero
// register (the step's accumulators need no zeroing)
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  const float z = 0.f;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(z), "f"(z), "f"(z), "f"(z));
}

template <int WM, int WN, int MT, int NT, bool KF>
__global__ void __launch_bounds__(kThreads, 2) contract_kernel(Args g) {
  using T = Tile<WM, WN, MT, NT, KF>;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tc = lane & 3;  // fragment row / column
  const int wr = (warp / WN) * MT * 16;     // the warp's first tile row
  const int wc = (warp % WN) * NT * 8;      // and column
  const int chunk_id = blockIdx.x % g.n_split;
  const int q0 = (blockIdx.x / g.n_split) * T::BN;
  const int p0 = blockIdx.y * T::BM;
  const long long n = blockIdx.z;
  const float* a = g.a + n * g.sa_n;
  const float* b = g.b + n * g.sb_n;

  // this CTA's k tiles: every chunk, or chunk chunk_id of a split
  const int k_tiles = (g.K + kTK - 1) / kTK;
  const int kt0 = g.n_split > 1 ? chunk_id * kChunkTiles : 0;
  const int kt1 = g.n_split > 1 ? min(kt0 + kChunkTiles, k_tiles) : k_tiles;
  const int nt = kt1 - kt0;

  // a warp whose tiles lie wholly past P or Q does no products
  const bool live = p0 + wr < g.P && q0 + wc < g.Q;

  float total[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[i][j][e] = part[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) {
      float* st = smem + s * T::kStage;
      stage<T, KF>(st, st + T::kA, g, a, b, p0, q0, (kt0 + s) * kTK, tid);
    }
    smoe::cp_commit();
  }

  for (int t = 0; t < nt; ++t) {
    smoe::cp_wait<kStages - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    {
      const int nx = t + kStages - 1;
      if (nx < nt) {
        float* st = smem + (nx % kStages) * T::kStage;
        stage<T, KF>(st, st + T::kA, g, a, b, p0, q0, (kt0 + nx) * kTK, tid);
      }
      smoe::cp_commit();
    }
    const float* sa = smem + (t % kStages) * T::kStage;
    const float* sb = sa + T::kA;
    // the 128-row tile (8 mma chains a warp) keeps one step's fragments
    // live at a time, within 128 registers (two CTAs an SM) and no
    // spills; smaller tiles unroll the steps to overlap their chains
#pragma unroll(MT * NT >= 8 ? 1 : kTK / 8)
    for (int ks = 0; ks < kTK; ks += 8) {
      if (!live) break;
      Frag<4> fa[MT];
      Frag<2> fb[NT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* p = sa + (wr + 16 * i + gr) * kRS + ks + tc;
        const float v[4] = {p[0], p[8 * kRS], p[4], p[8 * kRS + 4]};
        split(fa[i], v);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float v[2];
        if (KF) {
          const float* p = sb + (wc + 8 * j + gr) * kRS + ks + tc;
          v[0] = p[0];
          v[1] = p[4];
        } else {
          const float* p = sb + (ks + tc) * T::kQS + wc + 8 * j + gr;
          v[0] = p[0];
          v[1] = p[4 * T::kQS];
        }
        split(fb[j], v);
      }
      // the step's three passes, each over every tile of the warp: MT NT
      // independent chains in flight
      float d[MT][NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_zero(d[i][j], fa[i].l, fb[j].h);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) smoe::mma_tf32(d[i][j], fa[i].h, fb[j].l);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) smoe::mma_tf32(d[i][j], fa[i].h, fb[j].h);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] += d[i][j][e];
    }
    const int kt = kt0 + t;
    if ((kt + 1) % kChunkTiles == 0 || kt + 1 == k_tiles) {  // chunk ends
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            total[i][j][e] += part[i][j][e];
            part[i][j][e] = 0.f;
          }
    }
  }

  // fragment element e of tile (i, j): row wr + 16 i + gr + 8 (e / 2),
  // column wc + 8 j + 2 tc + e % 2
  if (g.n_split == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + wr + 16 * i + gr + 8 * (e >> 1);
          const int q = q0 + wc + 8 * j + 2 * tc + (e & 1);
          if (p < g.P && q < g.Q) {
            g.out[(n * g.P + p) * (long long)g.Q + q] = total[i][j][e];
          }
        }
    return;
  }

  // split: this CTA's chunk sum (total = 0 + its one chunk) into its
  // shared memory; the cluster then adds the chunks in chunk order
  smoe::cp_wait<0>();
  __syncthreads();
  float* mine = smem;  // [BM][BN]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr + 16 * i + gr + 8 * (e >> 1);
        const int c = wc + 8 * j + 2 * tc + (e & 1);
        mine[r * T::BN + c] = total[i][j][e];
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int x = tid + chunk_id * kThreads; x < T::BM * T::BN;
       x += g.n_split * kThreads) {
    const int p = p0 + x / T::BN, q = q0 + x % T::BN;
    if (p >= g.P || q >= g.Q) continue;
    float s = 0.f;
    for (int c = 0; c < g.n_split; ++c) {
      s += cluster.map_shared_rank(mine, c)[x];  // rank c holds chunk c
    }
    g.out[(n * g.P + p) * (long long)g.Q + q] = s;
  }
  cluster.sync();  // no CTA leaves while another reads its chunk
}

template <int WM, int WN, int MT, int NT, bool KF>
cudaError_t launch(const Args& g, int n, cudaStream_t stream) {
  using T = Tile<WM, WN, MT, NT, KF>;
  const auto kernel = contract_kernel<WM, WN, MT, NT, KF>;
  const long long q_tiles = ((long long)g.Q + T::BN - 1) / T::BN;
  const long long p_tiles = ((long long)g.P + T::BM - 1) / T::BM;
  if (q_tiles * g.n_split > 2147483647LL || p_tiles > 65535) {
    return cudaErrorInvalidValue;
  }
  static int ready = -1;  // the device this instantiation was set up on
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && ready != dev) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
    if (err == cudaSuccess) ready = dev;
  }
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(q_tiles * g.n_split), (unsigned)p_tiles,
                     (unsigned)n);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.n_split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, g);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// out (n, P, Q) f32, contiguous. a is read k-unit-stride (sa_k must be 1
// unless K == 1); b q-unit-stride when b_k_fast == 0 (sb_q 1 unless
// Q == 1), else k-unit-stride (sb_k 1 unless K == 1). The launch plan
// (kernels/invariant_matmul.py::_plan): tile 0 is 16 x 64, tile 1
// 128 x 64, tile 2 64 x 64; vec_a / vec_b ask for
// 16-byte copies; n_split is 1 or the chunk count ceil(K / 256) (at most
// 8). Returns a cudaError_t as int (0 on success); a plan the operands do
// not allow is refused.
extern "C" int invariant_contract_launch(
    const void* a, const void* b, void* out, int n, int P, int K, int Q,
    long long sa_n, long long sa_p, long long sa_k, long long sb_n,
    long long sb_k, long long sb_q, int tile, int b_k_fast, int vec_a,
    int vec_b, int n_split, void* stream) {
  if (n < 0 || P < 0 || K < 0 || Q < 0 || n > 65535 || tile < 0 ||
      tile > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_chunks = K > 0 ? (K + kChunk - 1) / kChunk : 1;
  if (n_split != 1 && (n_split != n_chunks || n_split > kMaxSplit)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((K > 1 && sa_k != 1) || (b_k_fast ? (K > 1 && sb_k != 1)
                                        : (Q > 1 && sb_q != 1))) {
    return (int)cudaErrorInvalidValue;
  }
  if (vec_a && !(smoe::aligned16(a) && K % 4 == 0 && (P < 2 || sa_p % 4 == 0) &&
                 (n < 2 || sa_n % 4 == 0))) {
    return (int)cudaErrorInvalidValue;
  }
  if (vec_b && !(smoe::aligned16(b) && (n < 2 || sb_n % 4 == 0) &&
                 (b_k_fast ? K % 4 == 0 && (Q < 2 || sb_q % 4 == 0)
                           : Q % 4 == 0 && (K < 2 || sb_k % 4 == 0)))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0 || P == 0 || Q == 0) return (int)cudaSuccess;
  Args g;
  g.a = static_cast<const float*>(a);
  g.b = static_cast<const float*>(b);
  g.out = static_cast<float*>(out);
  g.P = P;
  g.K = K;
  g.Q = Q;
  g.sa_n = sa_n;
  g.sa_p = sa_p;
  g.sb_n = sb_n;
  g.sb_k = sb_k;
  g.sb_q = sb_q;
  g.vec_a = vec_a;
  g.vec_b = vec_b;
  g.n_split = n_split;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tile == 0) {
    err = b_k_fast ? launch<1, 8, 1, 1, true>(g, n, s)
                   : launch<1, 8, 1, 1, false>(g, n, s);
  } else if (tile == 1) {
    err = b_k_fast ? launch<4, 2, 2, 4, true>(g, n, s)
                   : launch<4, 2, 2, 4, false>(g, n, s);
  } else {
    err = b_k_fast ? launch<4, 2, 1, 4, true>(g, n, s)
                   : launch<4, 2, 1, 4, false>(g, n, s);
  }
  return (int)err;
}
