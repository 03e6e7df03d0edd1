// Fixed-order f32 contraction for Hopper (sm_90a): out[n,p,q] = sum_k
// a[n,p,k] * b[n,k,q], where every output element is summed in one order
// that depends on k alone, never on how many rows (p) or matrices (n) the
// launch holds.
//
// Replaces no TPU kernel. The reference computes these products with XLA
// einsums: the sparse MoE router logits (src/repro/core/sparse_moe.py:53)
// and the two f32 products of dense attention (src/repro/layers/
// attention.py:121 and :128), which MLA decode runs over its latent view.
// On the card cuBLAS picks its f32 kernel, and with it the reduction
// order, by the row count and the batch count, so a request's router
// logits and MLA scores moved with its batch neighbours and
// serve.telemetry.batch_variance_probe read ~1e-2 where the reference
// requires < 1e-5. This kernel gives the per-row invariant of
// src/repro/kernels/ops.py: row i of an M-row launch, or matrix i of an
// n-matrix launch, equals a 1-row or 1-matrix launch bitwise.
// The PyTorch wrapper and the plain versions are in
// src/repro_torch/kernels/invariant_matmul.py.
//
// The order, per output element:
//   * k is cut into tiles of 32, taken in index order;
//   * lane l of the warp that owns the element accumulates the products
//     of k = 32 t + l, one f32 FMA a tile, in tile order (k past the end
//     reads zeros, which leave the sum as it is);
//   * the 32 lane sums are added by a fixed butterfly (lanes l and l ^ 16,
//     then pairs l and l ^ 8, ... , l ^ 1);
//   * no split-K, no atomics, no shape-dependent choice. Rows past the end
//     read zeros and are not written.
// The products are f32 FMAs on the CUDA cores, not TF32 tensor cores:
// the reference's products are f32.
//
// What bounds it on the H100: at the serving shapes (decode, a few rows)
// the bytes of the weights or of the gathered latent view, and the
// launch; at training's 16384 router rows the f32 FMA rate (67 TFLOP/s)
// in principle. Design (simple first): one CTA of 8 warps per (8-row x
// 32-column output tile, matrix); a warp owns 4 x 8 outputs, so each lane
// keeps 32 sums and each 32-wide k tile costs a lane 4 + 8 shared-memory
// reads for 32 FMAs. The operands are read with their element strides
// (transposed and broadcast views need no copy) into shared memory, four
// k tiles at a time (a decode call's few CTAs walk k serially, so the
// loads of four tiles are in flight together): A [8][128] and B
// transposed [32][129] (padded: lane l reads k = 32 t + l of one column,
// conflict free). Staging changes no sum: the tiles are still taken in
// index order. The closing butterfly is a reduce-
// scatter: at each level a lane keeps half its sums and sends the other
// half, so after five levels lane l holds output l of its warp's 32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTK = 32;       // k tile: one k a lane
constexpr int kStage = 4;     // k tiles staged in shared memory at once
constexpr int kSK = kStage * kTK;
constexpr int kRP = 4;        // rows a warp owns
constexpr int kRQ = 8;        // columns a warp owns (kRP * kRQ = 32 lanes)
constexpr int kWarpsP = 2;
constexpr int kWarpsQ = 4;
constexpr int kTP = kRP * kWarpsP;  // 8 rows a CTA
constexpr int kTQ = kRQ * kWarpsQ;  // 32 columns a CTA
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRP * kRQ == 32, "a warp's outputs are one a lane");
static_assert(kWarpsP * kWarpsQ * 32 == kThreads, "8 warps");

struct Args {
  const float* a;
  const float* b;
  float* out;
  int P, K, Q;
  long long sa_n, sa_p, sa_k;
  long long sb_n, sb_k, sb_q;
};

// One level of the reduce-scatter: a lane with bit H set keeps the upper
// half of its H * 2 live sums, its partner (lane ^ H) the lower half; each
// adds the partner's partial of the half it keeps. Sums are commutative,
// so the pair's result is the same bits in either lane.
template <int H>
__device__ __forceinline__ void reduce_level(float (&acc)[32], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = upper ? acc[j] : acc[j + H];
    const float keep = upper ? acc[j + H] : acc[j];
    acc[j] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

__global__ void __launch_bounds__(kThreads)
contract_kernel(Args g) {
  __shared__ float As[kTP][kSK];
  __shared__ float Bt[kTQ][kSK + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wp = warp / kWarpsQ;  // the warp's rows: p0 + wp * kRP + [0, 4)
  const int wq = warp % kWarpsQ;  // its columns: q0 + wq * kRQ + [0, 8)
  const int p0 = blockIdx.x * kTP;
  const int q0 = blockIdx.y * kTQ;
  const long long n = blockIdx.z;
  const float* a = g.a + n * g.sa_n;
  const float* b = g.b + n * g.sb_n;
  // which stride of b is the unit one decides the load order, so that
  // neighbouring threads read neighbouring addresses (the router's weight
  // is (k, q) row-major, the attention keys (q, k))
  const bool b_k_fast = g.sb_k == 1 && g.sb_q != 1;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < g.K; k0 += kSK) {
    // stage kStage k tiles: all their loads in flight at once
    // A: 8 x 128, k fastest
#pragma unroll
    for (int i = 0; i < (kTP * kSK) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kSK, kk = idx % kSK;
      const int p = p0 + r, k = k0 + kk;
      As[r][kk] = (p < g.P && k < g.K) ? a[p * g.sa_p + k * g.sa_k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (kSK * kTQ) / kThreads; ++i) {  // B: 128 x 32
      const int idx = tid + i * kThreads;
      const int kk = b_k_fast ? idx % kSK : idx / kTQ;
      const int qq = b_k_fast ? idx / kSK : idx % kTQ;
      const int k = k0 + kk, q = q0 + qq;
      Bt[qq][kk] = (q < g.Q && k < g.K) ? b[k * g.sb_k + q * g.sb_q] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kStage; ++t) {  // the staged tiles in index order
      float av[kRP], bv[kRQ];
#pragma unroll
      for (int i = 0; i < kRP; ++i) av[i] = As[wp * kRP + i][t * kTK + lane];
#pragma unroll
      for (int j = 0; j < kRQ; ++j) bv[j] = Bt[wq * kRQ + j][t * kTK + lane];
#pragma unroll
      for (int i = 0; i < kRP; ++i) {
#pragma unroll
        for (int j = 0; j < kRQ; ++j) {
          acc[i * kRQ + j] = fmaf(av[i], bv[j], acc[i * kRQ + j]);
        }
      }
    }
    __syncthreads();
  }

  // Reduce-scatter butterfly over the 32 lanes (levels 16, 8, 4, 2, 1).
  // Every output's sum is the same tree over the lanes' partials (lanes l
  // and l ^ 16 first, ...), whichever lane ends with it.
  reduce_level<16>(acc, lane);
  reduce_level<8>(acc, lane);
  reduce_level<4>(acc, lane);
  reduce_level<2>(acc, lane);
  reduce_level<1>(acc, lane);
  // lane l now holds output l of the warp: row l / kRQ, column l % kRQ
  const int p = p0 + wp * kRP + lane / kRQ;
  const int q = q0 + wq * kRQ + lane % kRQ;
  if (p < g.P && q < g.Q) {
    g.out[(n * g.P + p) * (long long)g.Q + q] = acc[0];
  }
}

}  // namespace

// out (n, P, Q) f32, contiguous; a and b read through their element
// strides. Returns a cudaError_t as int (0 on success).
extern "C" int invariant_contract_launch(
    const void* a, const void* b, void* out, int n, int P, int K, int Q,
    long long sa_n, long long sa_p, long long sa_k, long long sb_n,
    long long sb_k, long long sb_q, void* stream) {
  if (n < 0 || P < 0 || K < 0 || Q < 0 || n > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const long long p_tiles = ((long long)P + kTP - 1) / kTP;
  const long long q_tiles = ((long long)Q + kTQ - 1) / kTQ;
  if (p_tiles > 2147483647LL || q_tiles > 65535) {
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
  g.sa_k = sa_k;
  g.sb_n = sb_n;
  g.sb_k = sb_k;
  g.sb_q = sb_q;
  const dim3 grid((unsigned)p_tiles, (unsigned)q_tiles, (unsigned)n);
  contract_kernel<<<grid, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}
