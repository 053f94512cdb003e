// K3: fused exact windowed k-NN + inverse-squared-distance interpolation.
//
// Replaces the Pallas TPU kernels of myria3d_tpu/ops/pallas_knn.py:
// _interp_kernel_vpu_win_packed, _interp_kernel_vpu_win and
// _interp_kernel_vpu (one function: the full-cloud k=10 interpolation of
// the predict step's logits). The TPU kernels selected binned minima and
// recombined the payload as bf16 one-hot matmuls on the MXU; here each
// thread selects its query's exact top-k inside the window (the K1 scan of
// topk.cuh) and gathers the k payload rows directly in f32.
//
// pyg knn_interpolate semantics: w = 1 / max(d2, 1e-16) over neighbours
// whose d2 is below the pad threshold, y = sum(w x) / max(sum(w), 1e-16);
// a query whose slots all fell on pad keys gets 0, and rows outside the
// query mask are zeroed.
//
// Bound on the H100: the same (query, key) scan as K1 (B*M*W pairs:
// 5.6e9 at B=48, M=32768, W=3584 keys), compute/issue bound; the payload
// gather is k rows of C floats per query (7 classes), served from L2.
#include "topk.cuh"

namespace m3d {

constexpr float VALID_THRESH = 0.25e8f;

template <int KMAX>
__global__ void __launch_bounds__(TILE_Q) knn_interp_kernel(
    const float* __restrict__ x, const float4* __restrict__ q,
    const float4* __restrict__ keys, const int* __restrict__ bases,
    const unsigned char* __restrict__ qmask, int nq, int nk, int n_tiles,
    int win_len, int k, int c, float* __restrict__ out) {
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

  float* o = out + row * c;
  if (qmask && !qmask[row]) {
    for (int ch = 0; ch < c; ++ch) o[ch] = 0.f;
    return;
  }
  float w[KMAX];
  float den = 0.f;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    // only real keys pass the threshold, so a weighted slot's index is
    // always < nk (virtual pad rows are never gathered)
    const bool use = j < k && top.d[j] < VALID_THRESH;
    w[j] = use ? 1.f / fmaxf(top.d[j], 1e-16f) : 0.f;
    den += w[j];
  }
  den = fmaxf(den, 1e-16f);
  const float* xb = x + (size_t)b * nk * c;
  for (int ch = 0; ch < c; ++ch) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (w[j] > 0.f) acc += w[j] * xb[(size_t)top.idx[j] * c + ch];
    }
    o[ch] = acc / den;
  }
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
  const dim3 grid(n_tiles, B);
  auto xp = static_cast<const float*>(x);
  auto qp = static_cast<const float4*>(q);
  auto kp = static_cast<const float4*>(keys);
  auto bp = static_cast<const int*>(bases);
  auto mp = static_cast<const unsigned char*>(qmask);
  auto op = static_cast<float*>(out);
  if (k <= 16) {
    knn_interp_kernel<16><<<grid, TILE_Q, 0, s>>>(
        xp, qp, kp, bp, mp, nq, nk, n_tiles, win_len, k, c, op);
  } else {
    knn_interp_kernel<32><<<grid, TILE_Q, 0, s>>>(
        xp, qp, kp, bp, mp, nq, nk, n_tiles, win_len, k, c, op);
  }
  return static_cast<int>(cudaGetLastError());
}
