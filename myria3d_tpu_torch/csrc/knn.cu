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
// self-kNN), K=1 Q=2 (decoder searches), K=4 Q=1 for k in [2, 4]
// (PointNet++'s k=3 feature propagation), and a generic K=32 Q=1 list for
// any other k in [1, 32] (it keeps the 32 best and writes the first k).
//
// The ball route (knn_ball_kernel, PointNet++'s ball query; the JAX
// package's ball_query is _knn_kernel_vpu's full scan, then the radius on
// its (B, Nq, K) result): K=32 Q=1 lists whose slots start at (r2,
// INT_MAX), so a key enters iff d2 <= r2 and the list keeps the K nearest
// keys inside the ball, ties to the lower index: the valid slots, in order,
// of the K nearest overall filtered by the radius. Slots left unfilled and
// the rows of masked queries read (-1, +inf); a tile of masked queries
// (they walk last) skips its scan. Every key of the cloud is still tested.
// Its queries, FPS centroids in no order, walk their tiles in x order
// (``perm``, which the wrapper makes where they fill more than one tile).
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
// wrapper does in torch). It runs on the same search as K1 with the
// ``Expanded`` score of topk.cuh: y-banded warps, centre-out order, the
// cp.async ring, two keys a branch. The loading thread writes |k|^2 into
// the staged key's w slot and the query is scaled by -2 once (exact); a
// pair is filtered on a product and 3 FMAs (``Expanded::bound``, proved to
// let through every pair the exact score would) and only a pair that
// passes is scored in the plain association (3 products, 3 sums). Every
// real key of the cloud is tested (the JAX kernel is exact when its bins
// cover the padded key count, the contract kept here), and of the virtual
// pad rows only the first k: they all score PAD_W^2 exactly and ties go to
// the lower index, so no later one can enter
// (``ops/cuda_knn.py::mxu_scan_len``).
// Bound on the H100: FP32 issue, 5 instructions per pair scanned (the
// filter's product, 3 FMAs and the compare; the exact score of the few
// pairs that pass is not counted). What holds it above: the insertions a
// warp waits on while its lists fill, and the scan's shared-memory loads
// and branches. No tensor cores: TF32 does not keep the f32 ranking that
// HIGHEST asks for, 3xTF32 cannot reproduce the plain association bit for
// bit, and a contraction of depth 4 would leave them nearly idle. The
// score is negative for most near keys (it is d2 - |q|^2): the K-list
// compares floats, so the order is right for negative scores.
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

// The ball route's row: the list's first k slots, a slot still unfilled
// (index INT_MAX) and every slot of an unused query (``keep`` false)
// written as (-1, +inf).
template <int K>
__device__ __forceinline__ void store_ball(const TopK<K>& t, int k, bool keep,
                                           int* __restrict__ idx_row, float* __restrict__ d_row) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < k) {
      const bool filled = keep && t.idx[s] != INT_MAX;
      idx_row[s] = filled ? t.idx[s] : -1;
      d_row[s] = filled ? t.d[s] : INFINITY;
    }
  }
}

// One block's tile of K1: the kNN route (Ball false: every query row below
// nq searched and written, ``qmask`` NULL) or the ball route (Ball true:
// lists start at (r2, INT_MAX), so only keys with d2 <= r2 enter; rows
// outside ``qmask`` are written empty, and a tile with no used row skips
// the scan). ``perm`` (B, nq) or NULL: the ball route's tile walk
// (tile_queries); the kNN route walks its rows in order.
template <int K, int Q, bool Ball>
__device__ __forceinline__ void knn_tile(const float4* __restrict__ q,
                                         const float4* __restrict__ keys,
                                         const int* __restrict__ bases,
                                         const int* __restrict__ perm,
                                         const unsigned char* __restrict__ qmask, int nq, int nk,
                                         int n_tiles, int win_len, int k, float bound,
                                         int* __restrict__ idx_out, float* __restrict__ d2_out) {
  extern __shared__ float4 smem[];
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  int rows[Q];
  float4 qv[Q];
  bool use[Q];
  float tile_x, warp_x;
  tile_queries<Q>(smem, q + (size_t)b * nq, qmask ? qmask + (size_t)b * nq : nullptr, nq, tile,
                  rows, qv, use, tile_x, warp_x, perm ? perm + (size_t)b * nq : nullptr);
  // unused rows rank last, so use[0] is the lane's first used query if any
  const bool live = __any_sync(0xffffffffu, use[0]);

  TopK<K> top[Q];
  if constexpr (Ball) {
    if (!__syncthreads_or(live)) {
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        top[j].init(bound);
        if (rows[j] < nq) {
          const size_t row = (size_t)b * nq + rows[j];
          store_ball<K>(top[j], k, false, idx_out + row * k, d2_out + row * k);
        }
      }
      return;
    }
  }
  const int start = bases ? bases[b * n_tiles + tile] * BINS : 0;
  search_tile<SqDist, K, Q>(smem, keys + (size_t)b * nk, nk, start, win_len, tile_x, warp_x,
                            live, qv, top, bound);
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const size_t row = (size_t)b * nq + rows[j];
    if constexpr (Ball) {
      if (rows[j] < nq) store_ball<K>(top[j], k, use[j], idx_out + row * k, d2_out + row * k);
    } else {
      if (use[j]) store_list<K>(top[j], k, idx_out + row * k, d2_out + row * k);
    }
  }
}

template <int K, int Q>
__global__ void __launch_bounds__(TILE_Q / Q) knn_topk_kernel(
    const float4* __restrict__ q, const float4* __restrict__ keys,
    const int* __restrict__ bases, int nq, int nk, int n_tiles, int win_len, int k,
    int* __restrict__ idx_out, float* __restrict__ d2_out) {
  knn_tile<K, Q, false>(q, keys, bases, nullptr, nullptr, nq, nk, n_tiles, win_len, k, INFINITY,
                        idx_out, d2_out);
}

template <int K, int Q>
__global__ void __launch_bounds__(TILE_Q / Q) knn_ball_kernel(
    const float4* __restrict__ q, const float4* __restrict__ keys,
    const int* __restrict__ perm, const unsigned char* __restrict__ qmask, int nq, int nk,
    int n_tiles, int win_len, int k, float r2, int* __restrict__ idx_out,
    float* __restrict__ d2_out) {
  knn_tile<K, Q, true>(q, keys, nullptr, perm, qmask, nq, nk, n_tiles, win_len, k, r2, idx_out,
                       d2_out);
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

template <int K, int Q>
static int launch_ball(const float4* q, const float4* keys, const int* perm,
                       const unsigned char* qmask, int B, int nq, int nk, int n_tiles,
                       int win_len, int k, float r2, int* idx, float* d2, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t e = allow_search_smem(knn_ball_kernel<K, Q>, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_tiles, B);
  knn_ball_kernel<K, Q><<<grid, TILE_Q / Q, search_smem_bytes(win_len), stream>>>(
      q, keys, perm, qmask, nq, nk, n_tiles, win_len, k, r2, idx, d2);
  return static_cast<int>(cudaGetLastError());
}

// K = 16 is held to 64 registers, four blocks an SM (on an H100 SXM, self
// 12288 B=48: 3.92 ms, against 4.12 at 72 registers; scripts/tune_search_q.py).
template <int K, int Q>
__global__ void __launch_bounds__(TILE_Q / Q, K == 16 ? 4 : 1) knn_topk_mxu_kernel(
    const float4* __restrict__ q, const float4* __restrict__ keys, int nq, int nk,
    int n_scan, int k, int* __restrict__ idx_out, float* __restrict__ score_out) {
  extern __shared__ float4 smem[];
  const int b = blockIdx.y;
  int rows[Q];
  float4 qv[Q];
  bool use[Q];
  float tile_x, warp_x;
  tile_queries<Q>(smem, q + (size_t)b * nq, nullptr, nq, blockIdx.x, rows, qv, use, tile_x,
                  warp_x);
  const bool live = __any_sync(0xffffffffu, use[0]);
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    qv[j] = make_float4(__fmul_rn(-2.f, qv[j].x), __fmul_rn(-2.f, qv[j].y),
                        __fmul_rn(-2.f, qv[j].z), 0.f);
  }

  TopK<K> top[Q];
  search_tile<Expanded, K, Q>(smem, keys + (size_t)b * nk, nk, 0, n_scan, tile_x, warp_x,
                              live, qv, top);
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    if (rows[j] < nq) {  // use[j]: no query mask (one register less)
      const size_t row = (size_t)b * nq + rows[j];
      store_list<K>(top[j], k, idx_out + row * k, score_out + row * k);
    }
  }
}

template <int K, int Q>
static int launch_mxu(const float4* q, const float4* keys, int B, int nq, int nk, int n_scan,
                      int k, int* idx, float* score, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t e = allow_search_smem(knn_topk_mxu_kernel<K, Q>, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((nq + TILE_Q - 1) / TILE_Q, B);
  knn_topk_mxu_kernel<K, Q><<<grid, TILE_Q / Q, search_smem_bytes(n_scan), stream>>>(
      q, keys, nq, nk, n_scan, k, idx, score);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace m3d

// q (B, nq, 4) f32 centred queries (w = 0); keys (B, nk, 4) f32 centred
// keys (w = 0 valid, 1e4 pad); bases (B, n_tiles) i32 window base chunk
// per query tile, or NULL for a full scan from position 0; win_len key
// positions per window (a multiple of 512). list_k: the register list, 1
// (k = 1), 4 (k <= 4), 16 (k <= 16) or 32. r2 = +inf: the kNN route, perm
// and qmask NULL. Any other r2 (below the pad keys' d2): the ball route, a
// full scan (bases NULL) on list_k 32; perm (B, nq) i32, a permutation of
// each cloud's queries (the tile walk's rows), or NULL for row order; qmask
// (B, nq) u8 or NULL. Slots left unfilled, and the rows of queries outside
// qmask, read (-1, +inf).
// Writes idx (B, nq, k) i32 and d2 (B, nq, k) f32, ascending, ties to the
// lower key index. 1 <= k <= list_k.
extern "C" int m3d_knn_topk(const void* q, const void* keys, const void* bases,
                            const void* perm, const void* qmask, int B, int nq, int nk,
                            int n_tiles, int win_len, int k, int list_k, float r2,
                            void* idx, void* d2, void* stream) {
  using namespace m3d;
  auto s = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const float4*>(q);
  auto kp = static_cast<const float4*>(keys);
  auto bp = static_cast<const int*>(bases);
  auto pp = static_cast<const int*>(perm);
  auto mp = static_cast<const unsigned char*>(qmask);
  auto ip = static_cast<int*>(idx);
  auto dp = static_cast<float*>(d2);
  if (k < 1 || k > list_k) return static_cast<int>(cudaErrorInvalidValue);
  if (r2 != INFINITY) {
    if (list_k != 32 || bp) return static_cast<int>(cudaErrorInvalidValue);
    return launch_ball<32, 1>(qp, kp, pp, mp, B, nq, nk, n_tiles, win_len, k, r2, ip, dp, s);
  }
  if (pp || mp) return static_cast<int>(cudaErrorInvalidValue);
  switch (list_k) {
    case 1: return launch<1, 2>(qp, kp, bp, B, nq, nk, n_tiles, win_len, k, ip, dp, s);
    case 4: return launch<4, 1>(qp, kp, bp, B, nq, nk, n_tiles, win_len, k, ip, dp, s);
    case 16: return launch<16, 1>(qp, kp, bp, B, nq, nk, n_tiles, win_len, k, ip, dp, s);
    case 32: return launch<32, 1>(qp, kp, bp, B, nq, nk, n_tiles, win_len, k, ip, dp, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K7. q (B, nq, 4) f32 centred queries (w read as 0); keys (B, nk, 4) f32
// centred keys (w = 0 valid, 1e4 pad); n_scan key positions scanned
// (positions at or past nk are virtual pad rows). Writes idx (B, nq, k) i32
// and the expanded scores |k|^2 - 2 q.k (B, nq, k) f32, ascending, ties to
// the lower key index. 1 <= k <= 32.
extern "C" int m3d_knn_topk_mxu(const void* q, const void* keys, int B,
                                int nq, int nk, int n_scan, int k, void* idx,
                                void* score, void* stream) {
  using namespace m3d;
  auto s = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const float4*>(q);
  auto kp = static_cast<const float4*>(keys);
  auto ip = static_cast<int*>(idx);
  auto sp = static_cast<float*>(score);
  if (k == 1) return launch_mxu<1, 2>(qp, kp, B, nq, nk, n_scan, k, ip, sp, s);
  if (k == 16) return launch_mxu<16, 1>(qp, kp, B, nq, nk, n_scan, k, ip, sp, s);
  return launch_mxu<32, 1>(qp, kp, B, nq, nk, n_scan, k, ip, sp, s);
}
