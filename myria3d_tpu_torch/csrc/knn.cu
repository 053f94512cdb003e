// K1: exact windowed top-K nearest keys (x-sorted clouds) or full scan.
//
// Replaces the Pallas TPU kernels of myria3d_tpu/ops/pallas_knn.py:
// _knn_kernel_vpu_win_packed (encoder self-kNN, K=16), _knn_kernel_vpu_win
// (windowed k=1 decoder search) and _knn_kernel_vpu (full-scan k=1). Where
// those kept 512 binned running minima and extracted with packed
// single-reduction passes (TPU vector-unit layout), this kernel selects
// the EXACT top-K inside the window with full f32 distances.
//
// Layout: one block per (query tile of 256, cloud); one thread per query.
// The tile's window of x-sorted keys (3584 positions at the 12288-point
// encoder stage) streams through a 16 KB shared-memory slab in chunks of
// 1024 keys, so any window length fits without dynamic shared memory; all
// threads read the same key at once (a shared-memory broadcast).
//
// Bound on the H100: per (query, key) pair ~8 f32 operations plus the
// compare against the K-th best, so the scan is compute/issue bound
// (B*Nq*W pairs: 2.1e9 at B=48, Nq=12288, W=3584); memory traffic is the
// key window once per tile plus the (B, Nq, K) outputs.
//
// K7 (knn_topk_mxu_kernel below): the full-scan top-K of the expanded score
// |k|^2 - 2 q.k. Replaces myria3d_tpu/ops/pallas_knn.py:115 _knn_kernel
// (the MXU variant: a contraction-depth-4 dot_general at
// Precision.HIGHEST, per-bin running minima, then k extraction passes; the
// caller adds |q|^2 back and clamps at 0, pallas_knn.py:857-858, which the
// wrapper does in torch). Same design as K1: one block per (256-query tile,
// cloud), one thread per query, a register K-list, keys streamed through a
// shared slab, every key of the cloud scanned (the JAX kernel is exact
// when its bins cover the padded key count, the contract kept here).
// Bound on the H100: FP32 issue, ~8 instructions per (query, key) pair
// (4 products, 3 sums and the add of |k|^2, plus the compare): |k|^2 is
// computed once per staged key by the loading thread and shared by the
// 256 queries of the block, and -2q is folded into the query once (an
// exact power-of-two scaling), so the pair costs no more than K1's
// difference form. No tensor cores: a depth-4 contraction gains nothing
// from them, and TF32 would not keep the f32 ranking that HIGHEST asks
// for. The score is negative for most near keys (it is d2 - |q|^2): the
// K-list compares floats, so the order is right for negative scores.
#include "topk.cuh"

namespace m3d {

template <int KMAX>
__global__ void __launch_bounds__(TILE_Q) knn_topk_kernel(
    const float4* __restrict__ q, const float4* __restrict__ keys,
    const int* __restrict__ bases, int nq, int nk, int n_tiles,
    int win_len, int k, int* __restrict__ idx_out,
    float* __restrict__ d2_out) {
  __shared__ float4 slab[CHUNK];
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int qi = tile * TILE_Q + threadIdx.x;
  const bool active = qi < nq;
  const size_t row = (size_t)b * nq + qi;
  const float4 qv = active ? q[row] : make_float4(0.f, 0.f, 0.f, 0.f);
  const int start = bases ? bases[b * n_tiles + tile] * BINS : 0;

  TopK<KMAX> top;
  top.init();
  scan_window<KMAX>(slab, keys + (size_t)b * nk, nk, start, win_len, qv,
                    active, k, top);
  if (!active) return;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      idx_out[row * k + j] = top.idx[j];
      d2_out[row * k + j] = top.d[j];
    }
  }
}

template <int KMAX>
static void launch(const float4* q, const float4* keys, const int* bases,
                   int B, int nq, int nk, int n_tiles, int win_len, int k,
                   int* idx, float* d2, cudaStream_t stream) {
  const dim3 grid(n_tiles, B);
  knn_topk_kernel<KMAX><<<grid, TILE_Q, 0, stream>>>(
      q, keys, bases, nq, nk, n_tiles, win_len, k, idx, d2);
}

// |k|^2 in a fixed association, every op rounded on its own (no FMA
// contraction), as the plain version sums it: ((x*x + y*y) + z*z) + w*w.
__device__ __forceinline__ float sq_norm(float4 k) {
  float s = __fmul_rn(k.x, k.x);
  s = __fadd_rn(s, __fmul_rn(k.y, k.y));
  s = __fadd_rn(s, __fmul_rn(k.z, k.z));
  return __fadd_rn(s, __fmul_rn(k.w, k.w));
}

// kn + (-2q).k, products summed x, y, z, w in order, every op rounded on
// its own: bit for bit kn - 2 (q.k), since scaling by -2 is exact.
__device__ __forceinline__ float expanded_score(float4 q2, float4 k, float kn) {
  float c = __fmul_rn(q2.x, k.x);
  c = __fadd_rn(c, __fmul_rn(q2.y, k.y));
  c = __fadd_rn(c, __fmul_rn(q2.z, k.z));
  c = __fadd_rn(c, __fmul_rn(q2.w, k.w));
  return __fadd_rn(kn, c);
}

template <int KMAX>
__global__ void __launch_bounds__(TILE_Q) knn_topk_mxu_kernel(
    const float4* __restrict__ q, const float4* __restrict__ keys, int nq,
    int nk, int nk_pad, int k, int* __restrict__ idx_out,
    float* __restrict__ score_out) {
  __shared__ float4 slab[CHUNK];
  __shared__ float norms[CHUNK];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * TILE_Q + threadIdx.x;
  const bool active = qi < nq;
  const size_t row = (size_t)b * nq + qi;
  const float4 qv = active ? q[row] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 q2 = make_float4(-2.f * qv.x, -2.f * qv.y, -2.f * qv.z,
                                -2.f * qv.w);
  const float4* kb = keys + (size_t)b * nk;

  TopK<KMAX> top;
  top.init();
  for (int c0 = 0; c0 < nk_pad; c0 += CHUNK) {
    const int n = min(CHUNK, nk_pad - c0);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const int p = c0 + t;
      const float4 kv = p < nk ? kb[p] : make_float4(0.f, 0.f, 0.f, PAD_W);
      slab[t] = kv;
      norms[t] = sq_norm(kv);
    }
    __syncthreads();
    if (active) {
      for (int t = 0; t < n; ++t) {
        top.push(expanded_score(q2, slab[t], norms[t]), c0 + t, k);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      idx_out[row * k + j] = top.idx[j];
      score_out[row * k + j] = top.d[j];
    }
  }
}

template <int KMAX>
static void launch_mxu(const float4* q, const float4* keys, int B, int nq,
                       int nk, int nk_pad, int k, int* idx, float* score,
                       cudaStream_t stream) {
  const dim3 grid((nq + TILE_Q - 1) / TILE_Q, B);
  knn_topk_mxu_kernel<KMAX><<<grid, TILE_Q, 0, stream>>>(
      q, keys, nq, nk, nk_pad, k, idx, score);
}

}  // namespace m3d

// q (B, nq, 4) f32 centred queries (w = 0); keys (B, nk, 4) f32 centred
// keys (w = 0 valid, 1e4 pad); bases (B, n_tiles) i32 window base chunk
// per query tile, or NULL for a full scan from position 0; win_len key
// positions per window (a multiple of 512). Writes idx (B, nq, k) i32 and
// d2 (B, nq, k) f32, ascending. 1 <= k <= 32.
extern "C" int m3d_knn_topk(const void* q, const void* keys,
                            const void* bases, int B, int nq, int nk,
                            int n_tiles, int win_len, int k, void* idx,
                            void* d2, void* stream) {
  using namespace m3d;
  auto s = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const float4*>(q);
  auto kp = static_cast<const float4*>(keys);
  auto bp = static_cast<const int*>(bases);
  auto ip = static_cast<int*>(idx);
  auto dp = static_cast<float*>(d2);
  if (k <= 1) {
    launch<1>(qp, kp, bp, B, nq, nk, n_tiles, win_len, k, ip, dp, s);
  } else if (k <= 16) {
    launch<16>(qp, kp, bp, B, nq, nk, n_tiles, win_len, k, ip, dp, s);
  } else {
    launch<32>(qp, kp, bp, B, nq, nk, n_tiles, win_len, k, ip, dp, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7. q (B, nq, 4) f32 centred queries; keys (B, nk, 4) f32 centred keys
// (w = 0 valid, 1e4 pad); nk_pad key positions scanned (a multiple of 512:
// positions at or past nk are pad rows). Writes idx (B, nq, k) i32 and the
// expanded scores |k|^2 - 2 q.k (B, nq, k) f32, ascending, ties to the
// lower key index. 1 <= k <= 32.
extern "C" int m3d_knn_topk_mxu(const void* q, const void* keys, int B,
                                int nq, int nk, int nk_pad, int k, void* idx,
                                void* score, void* stream) {
  using namespace m3d;
  auto s = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const float4*>(q);
  auto kp = static_cast<const float4*>(keys);
  auto ip = static_cast<int*>(idx);
  auto sp = static_cast<float*>(score);
  if (k <= 1) {
    launch_mxu<1>(qp, kp, B, nq, nk, nk_pad, k, ip, sp, s);
  } else if (k <= 16) {
    launch_mxu<16>(qp, kp, B, nq, nk, nk_pad, k, ip, sp, s);
  } else {
    launch_mxu<32>(qp, kp, B, nq, nk, nk_pad, k, ip, sp, s);
  }
  return static_cast<int>(cudaGetLastError());
}
