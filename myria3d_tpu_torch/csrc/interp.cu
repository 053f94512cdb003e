// K3: fused exact windowed k-NN + inverse-squared-distance interpolation.
//
// Replaces the Pallas TPU kernels of myria3d_tpu/ops/pallas_knn.py:
// _interp_kernel_vpu_win_packed, _interp_kernel_vpu_win and
// _interp_kernel_vpu (one function: the full-cloud k=10 interpolation of
// the predict step's logits). The TPU kernels selected binned minima and
// recombined the payload as bf16 one-hot matmuls on the MXU; here the
// shared search of topk.cuh selects each query's exact top-k inside the
// window and the epilogue gathers the k payload rows directly in f32.
//
// pyg knn_interpolate semantics: w = 1 / max(d2, 1e-16) over neighbours
// whose d2 is below the pad threshold, y = sum(w x) / max(sum(w), 1e-16);
// a query whose slots all fell on pad keys gets 0, and rows outside the
// query mask are zeroed.
//
// Design (topk.cuh): one block per (256-query tile, cloud), 256 threads of
// one query each with a register list of exactly k = 10 (a generic K = 32
// list for any other k), the window staged once by cp.async (a
// double-buffered ring for the full scan of predict.sorted_window=0),
// centre-out scans per warp with the lexicographic tie rule. Rows outside
// the query mask (the padding of each cloud's full-point bucket) rank last
// in the tile's y order, so they fill whole warps, which skip the scan and
// write zeros.
//
// Bound on the H100: the same (query, key) scan as K1 (B*M*W pairs:
// 5.6e9 at B=48, M=32768, W=3584 keys: ~1.2 ms at 8 instructions a pair),
// FP32 issue bound; the payload gather is k rows of C floats per query
// (7 classes), served from L2.
#include "topk.cuh"

namespace m3d {

constexpr float VALID_THRESH = 0.25e8f;

template <int K, int Q>
__global__ void __launch_bounds__(TILE_Q / Q) knn_interp_kernel(
    const float* __restrict__ x, const float4* __restrict__ q,
    const float4* __restrict__ keys, const int* __restrict__ bases,
    const unsigned char* __restrict__ qmask, int nq, int nk, int n_tiles,
    int win_len, int k, int c, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  int rows[Q];
  float4 qv[Q];
  bool use[Q];
  float tile_x, warp_x;
  tile_queries<Q>(smem, q + (size_t)b * nq, qmask ? qmask + (size_t)b * nq : nullptr, nq, tile,
                  rows, qv, use, tile_x, warp_x);
  // unused rows rank last, so use[0] is the lane's first used query if any
  const bool live = __any_sync(0xffffffffu, use[0]);
  const int start = bases ? bases[b * n_tiles + tile] * BINS : 0;

  TopK<K> top[Q];
  search_tile<SqDist, K, Q>(smem, keys + (size_t)b * nk, nk, start, win_len, tile_x, warp_x,
                            live, qv, top);

  const float* xb = x + (size_t)b * nk * c;
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    if (rows[j] >= nq) continue;
    float* o = out + ((size_t)b * nq + rows[j]) * c;
    if (!use[j]) {
      for (int ch = 0; ch < c; ++ch) o[ch] = 0.f;
      continue;
    }
    float w[K];
    float den = 0.f;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      // only real keys pass the threshold, so a weighted slot's index is
      // always < nk (virtual pad rows are never gathered)
      const bool valid = s < k && top[j].d[s] < VALID_THRESH;
      w[s] = valid ? 1.f / fmaxf(top[j].d[s], 1e-16f) : 0.f;
      den += w[s];
    }
    den = fmaxf(den, 1e-16f);
    for (int ch = 0; ch < c; ++ch) {
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (w[s] > 0.f) acc += w[s] * xb[(size_t)top[j].idx[s] * c + ch];
      }
      o[ch] = acc / den;
    }
  }
}

template <int K, int Q>
static int launch(const float* x, const float4* q, const float4* keys, const int* bases,
                  const unsigned char* qmask, int B, int nq, int nk, int n_tiles, int win_len,
                  int k, int c, float* out, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t e = allow_search_smem(knn_interp_kernel<K, Q>, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_tiles, B);
  knn_interp_kernel<K, Q><<<grid, TILE_Q / Q, search_smem_bytes(win_len), stream>>>(
      x, q, keys, bases, qmask, nq, nk, n_tiles, win_len, k, c, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace m3d

// x (B, nk, c) f32 payload at the keys; q (B, nq, 4) f32 centred queries;
// keys (B, nk, 4) f32 centred keys (w = 0 valid, 1e4 pad); bases
// (B, n_tiles) i32 or NULL for a full scan; qmask (B, nq) u8 or NULL.
// Writes out (B, nq, c) f32. 1 <= k <= 32.
extern "C" int m3d_knn_interp(const void* x, const void* q, const void* keys,
                              const void* bases, const void* qmask, int B,
                              int nq, int nk, int n_tiles, int win_len, int k,
                              int c, void* out, void* stream) {
  using namespace m3d;
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto qp = static_cast<const float4*>(q);
  auto kp = static_cast<const float4*>(keys);
  auto bp = static_cast<const int*>(bases);
  auto mp = static_cast<const unsigned char*>(qmask);
  auto op = static_cast<float*>(out);
  if (k == 10) {
    return launch<10, 1>(xp, qp, kp, bp, mp, B, nq, nk, n_tiles, win_len, k, c, op, s);
  }
  return launch<32, 1>(xp, qp, kp, bp, mp, B, nq, nk, n_tiles, win_len, k, c, op, s);
}
