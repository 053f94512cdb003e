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
