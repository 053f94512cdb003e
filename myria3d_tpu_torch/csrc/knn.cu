// K1: exact windowed top-K nearest keys (x-sorted clouds) or full scan.
//
// Replaces the Pallas TPU kernels of myria3d_tpu/ops/pallas_knn.py:
// _knn_kernel_vpu_win_packed (encoder self-kNN, K=16), _knn_kernel_vpu_win
// (windowed k=1 decoder search) and _knn_kernel_vpu (full-scan k=1). Where
// those kept 512 binned running minima and extracted with packed
// single-reduction passes (TPU vector-unit layout), this kernel selects
// the EXACT top-K inside the window with full f32 distances.
//
// Layout and design: the shared search of topk.cuh. One block per (query
// tile of 256, cloud); 256 / Q threads, each holding Q queries (a warp
// takes a band of the tile in y) and their register K-lists; the tile's
// window staged once into dynamic shared memory by cp.async (a
// double-buffered ring above 5120 positions); each warp scans centre-out
// from its queries' mean x, and a candidate enters on the lexicographic
// (d2, index) rule. Instantiations: K=16 Q=1 (encoder
// self-kNN), K=1 Q=2 (decoder searches), and a generic K=32 Q=1 list for
// any other k in [1, 32] (it keeps the 32 best and writes the first k).
//
// Bound on the H100: FP32 issue, ~8 instructions per (query, key) pair
// (B*Nq*W pairs: 2.1e9 at B=48, Nq=12288, W=3584 keys: 0.5 ms); memory
// traffic is the key window once per tile plus the (B, Nq, K) outputs,
// written as 16-byte vectors when k is a multiple of 4.
//
// K7 (knn_topk_mxu_kernel below): the full-scan top-K of the expanded score
// |k|^2 - 2 q.k. Replaces myria3d_tpu/ops/pallas_knn.py:115 _knn_kernel
// (the MXU variant: a contraction-depth-4 dot_general at
// Precision.HIGHEST, per-bin running minima, then k extraction passes; the
// caller adds |q|^2 back and clamps at 0, pallas_knn.py:857-858, which the
// wrapper does in torch). One block per (256-query tile, cloud), one thread
// per query, keys streamed in position order through a shared slab, the
// register K-list of topk.cuh (K = 1, 16, or the generic 32), every key of
// the cloud scanned (the JAX kernel is exact when its bins cover the
// padded key count, the contract kept here).
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

// The first k slots of a list into one output row (16-byte vectors when
// the whole list is written and K is a multiple of 4).
template <int K>
__device__ __forceinline__ void store_list(const TopK<K>& t, int k, int* __restrict__ idx_row,
                                           float* __restrict__ d_row) {
  if constexpr (K % 4 == 0) {
    if (k == K) {
#pragma unroll
      for (int s = 0; s < K; s += 4) {
        reinterpret_cast<int4*>(idx_row)[s / 4] =
            make_int4(t.idx[s], t.idx[s + 1], t.idx[s + 2], t.idx[s + 3]);
        reinterpret_cast<float4*>(d_row)[s / 4] =
            make_float4(t.d[s], t.d[s + 1], t.d[s + 2], t.d[s + 3]);
      }
      return;
    }
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < k) {
      idx_row[s] = t.idx[s];
      d_row[s] = t.d[s];
    }
  }
}

template <int K, int Q>
__global__ void __launch_bounds__(TILE_Q / Q) knn_topk_kernel(
    const float4* __restrict__ q, const float4* __restrict__ keys,
    const int* __restrict__ bases, int nq, int nk, int n_tiles,
    int win_len, int k, int* __restrict__ idx_out,
    float* __restrict__ d2_out) {
  extern __shared__ float4 smem[];
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  int rows[Q];
  float4 qv[Q];
  bool use[Q];
  float tile_x, warp_x;
  tile_queries<Q>(smem, q + (size_t)b * nq, nullptr, nq, tile, rows, qv, use, tile_x, warp_x);
  const bool live = __any_sync(0xffffffffu, use[0]);
  const int start = bases ? bases[b * n_tiles + tile] * BINS : 0;

  TopK<K> top[Q];
  search_tile<K, Q>(smem, keys + (size_t)b * nk, nk, start, win_len, tile_x, warp_x, live,
                    qv, top);
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    if (use[j]) {
      const size_t row = (size_t)b * nq + rows[j];
      store_list<K>(top[j], k, idx_out + row * k, d2_out + row * k);
    }
  }
}

template <int K, int Q>
static int launch(const float4* q, const float4* keys, const int* bases,
                  int B, int nq, int nk, int n_tiles, int win_len, int k,
                  int* idx, float* d2, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t e = allow_search_smem(knn_topk_kernel<K, Q>, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_tiles, B);
  knn_topk_kernel<K, Q><<<grid, TILE_Q / Q, search_smem_bytes(win_len), stream>>>(
      q, keys, bases, nq, nk, n_tiles, win_len, k, idx, d2);
  return static_cast<int>(cudaGetLastError());
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

template <int K>
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

  TopK<K> top;
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
        const float s = expanded_score(q2, slab[t], norms[t]);
        if (top.admits(s)) top.push(s, c0 + t);
      }
    }
  }
  if (active) store_list<K>(top, k, idx_out + row * k, score_out + row * k);
}

template <int K>
static void launch_mxu(const float4* q, const float4* keys, int B, int nq,
                       int nk, int nk_pad, int k, int* idx, float* score,
                       cudaStream_t stream) {
  const dim3 grid((nq + TILE_Q - 1) / TILE_Q, B);
  knn_topk_mxu_kernel<K><<<grid, TILE_Q, 0, stream>>>(
      q, keys, nq, nk, nk_pad, k, idx, score);
}

}  // namespace m3d

// q (B, nq, 4) f32 centred queries (w = 0); keys (B, nk, 4) f32 centred
// keys (w = 0 valid, 1e4 pad); bases (B, n_tiles) i32 window base chunk
// per query tile, or NULL for a full scan from position 0; win_len key
// positions per window (a multiple of 512). Writes idx (B, nq, k) i32 and
// d2 (B, nq, k) f32, ascending, ties to the lower key index. 1 <= k <= 32.
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
  if (k == 1) return launch<1, 2>(qp, kp, bp, B, nq, nk, n_tiles, win_len, k, ip, dp, s);
  if (k == 16) return launch<16, 1>(qp, kp, bp, B, nq, nk, n_tiles, win_len, k, ip, dp, s);
  return launch<32, 1>(qp, kp, bp, B, nq, nk, n_tiles, win_len, k, ip, dp, s);
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
  if (k == 1) {
    launch_mxu<1>(qp, kp, B, nq, nk, nk_pad, k, ip, sp, s);
  } else if (k == 16) {
    launch_mxu<16>(qp, kp, B, nq, nk, nk_pad, k, ip, sp, s);
  } else {
    launch_mxu<32>(qp, kp, B, nq, nk, nk_pad, k, ip, sp, s);
  }
  return static_cast<int>(cudaGetLastError());
}
