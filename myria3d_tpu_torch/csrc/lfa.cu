// K2: fused eval-mode LocalFeatureAggregation (LocSE + attentive pooling).
//
// Replaces the Pallas TPU kernel myria3d_tpu/ops/pallas_lfa.py::_lfa_kernel.
// Per centre point i and neighbour slot k (index j = idx[i, k]):
//   rel  = [pos_i, pos_j, pos_j - pos_i, |pos_j - pos_i|]          (10)
//   enc  = LeakyReLU_0.2(A rel + c)    (encoder Linear + eval BN, folded)
//   lf   = [x_j, enc]                                               (C)
//   att  = W^T lf                       (bias-free attention Linear)
//   out  = sum_k softmax_k(att)[o] * lf[k][o]   over valid slots only
// An all-invalid neighbourhood gives 0 (masked_softmax semantics). The
// output is the pooled (B, N, C) before the post-attention MLP.
//
// The TPU kernel gathered neighbours with one-hot MXU matmuls over a bf16
// payload (positions split hi/lo) in 8-aligned row groups; here positions
// and features are gathered by direct indexed f32 loads.
//
// Layout: a block of 256 threads holds 256 / C centre points; thread
// (p, o) owns output channel o of point p. The K x C edge features of each
// point live in shared memory (17 KB per block at K = 16), never in device
// memory. The attention matrix W (C x C, up to 256 x 256 f32 = 256 KB, over
// a block's shared memory) is streamed from L2 with coalesced row reads:
// each W element read feeds K register accumulators.
//
// Bound on the H100: the attention product, K*C*C FMAs per point
// (1 M at C = 256), is f32 CUDA-core arithmetic; W re-reads hit L2.
#include <cuda_runtime.h>
#include <math.h>

namespace m3d {

constexpr int LFA_THREADS = 256;
constexpr int LFA_KMAX = 16;

__global__ void __launch_bounds__(LFA_THREADS) lfa_kernel(
    const float* __restrict__ x, const float* __restrict__ pos,
    const int* __restrict__ idx, const unsigned char* __restrict__ nv,
    const float* __restrict__ enc_a, const float* __restrict__ enc_c,
    const float* __restrict__ att_w, int n, int n_points, int k, int c_in,
    int c, float* __restrict__ out) {
  // one (K, C) slab per point, strided by one extra word so the slabs of
  // the points sharing a warp start in different shared-memory banks
  __shared__ float lf[(LFA_KMAX + 1) * LFA_THREADS];
  const int per_block = LFA_THREADS / c;
  const int p = threadIdx.x / c;
  const int o = threadIdx.x - p * c;
  const long long g = (long long)blockIdx.x * per_block + p;  // centre point
  const bool active = g < n_points;
  float* lfp = lf + p * (LFA_KMAX * c + 1);

  if (active) {
    const long long cloud = (g / n) * n;  // first row of g's cloud
    const float pix = pos[g * 3], piy = pos[g * 3 + 1], piz = pos[g * 3 + 2];
    float a[10];
    float bias = 0.f;
    const bool is_enc = o >= c_in;
    if (is_enc) {
#pragma unroll
      for (int r = 0; r < 10; ++r) a[r] = enc_a[(o - c_in) * 10 + r];
      bias = enc_c[o - c_in];
    }
    for (int kk = 0; kk < k; ++kk) {
      float v = 0.f;
      if (nv[g * k + kk]) {
        const long long j = cloud + idx[g * k + kk];
        if (!is_enc) {
          v = x[j * c_in + o];
        } else {
          const float pjx = pos[j * 3], pjy = pos[j * 3 + 1],
                      pjz = pos[j * 3 + 2];
          const float dx = pjx - pix, dy = pjy - piy, dz = pjz - piz;
          const float dist = sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 0.f));
          v = bias + a[0] * pix + a[1] * piy + a[2] * piz + a[3] * pjx +
              a[4] * pjy + a[5] * pjz + a[6] * dx + a[7] * dy + a[8] * dz +
              a[9] * dist;
          v = v >= 0.f ? v : 0.2f * v;
        }
      }
      lfp[kk * c + o] = v;
    }
  }
  __syncthreads();
  if (!active) return;

  float acc[LFA_KMAX];
#pragma unroll
  for (int kk = 0; kk < LFA_KMAX; ++kk) acc[kk] = 0.f;
  for (int ci = 0; ci < c; ++ci) {
    const float wv = att_w[ci * c + o];
#pragma unroll
    for (int kk = 0; kk < LFA_KMAX; ++kk) {
      if (kk < k) acc[kk] += wv * lfp[kk * c + ci];
    }
  }

  float m = -INFINITY;
#pragma unroll
  for (int kk = 0; kk < LFA_KMAX; ++kk) {
    if (kk < k && nv[g * k + kk]) m = fmaxf(m, acc[kk]);
  }
  float s = 0.f, num = 0.f;
#pragma unroll
  for (int kk = 0; kk < LFA_KMAX; ++kk) {
    if (kk < k && nv[g * k + kk]) {
      const float e = expf(acc[kk] - m);
      s += e;
      num += e * lfp[kk * c + o];
    }
  }
  out[g * c + o] = num / fmaxf(s, 1e-16f);
}

}  // namespace m3d

// x (B, n, c_in) f32; pos (B, n, 3) f32; idx (B, n, k) i32 indices into
// the cloud; nv (B, n, k) u8 slot validity; enc_a (c_in, 10) and enc_c
// (c_in) the folded encoder affine; att_w (c, c) f32 with att = lf @ att_w.
// c = 2 * c_in must divide 256; k <= 16. Writes out (B, n, c) f32.
extern "C" int m3d_lfa(const void* x, const void* pos, const void* idx,
                       const void* nv, const void* enc_a, const void* enc_c,
                       const void* att_w, int B, int n, int k, int c_in,
                       void* out, void* stream) {
  using namespace m3d;
  const int c = 2 * c_in;
  const int per_block = LFA_THREADS / c;
  const long long n_points = (long long)B * n;
  const unsigned blocks = (unsigned)((n_points + per_block - 1) / per_block);
  lfa_kernel<<<blocks, LFA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(pos),
      static_cast<const int*>(idx), static_cast<const unsigned char*>(nv),
      static_cast<const float*>(enc_a), static_cast<const float*>(enc_c),
      static_cast<const float*>(att_w), n, (int)n_points, k, c_in, c,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
