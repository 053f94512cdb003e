// Shared pieces of the exact windowed kNN kernels (knn.cu, interp.cu).
//
// Both kernels scan a contiguous run of x-sorted key positions per tile of
// 256 queries (the window of ``ops/cuda_knn.py::window_bases``), one thread
// per query, with the keys staged through shared memory in chunks. Each
// thread keeps its K best (distance, index) pairs in a register-resident
// sorted list; keys arrive in ascending position order and a candidate
// must beat the current K-th distance strictly, so equal distances keep the
// lower key index first -- the tie rule of the plain PyTorch versions.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace m3d {

constexpr int TILE_Q = 256;      // queries per block == window tile
constexpr int BINS = 512;        // window base granularity (key positions)
constexpr int CHUNK = 1024;      // keys staged in shared memory per step
constexpr float PAD_W = 1e4f;    // 4th coordinate of pad keys

// Squared distance in the association of the plain version
// (w*w + dx*dx + dy*dy + dz*dz, every op rounded on its own, no FMA
// contraction) so the kernel and its plain version rank identically.
// Queries carry w = 0, so the pad term comes from the key alone.
__device__ __forceinline__ float sq_dist(float4 q, float4 k) {
  float s = __fmul_rn(k.w, k.w);
  const float dx = __fsub_rn(q.x, k.x);
  s = __fadd_rn(s, __fmul_rn(dx, dx));
  const float dy = __fsub_rn(q.y, k.y);
  s = __fadd_rn(s, __fmul_rn(dy, dy));
  const float dz = __fsub_rn(q.z, k.z);
  s = __fadd_rn(s, __fmul_rn(dz, dz));
  return s;
}

// Ascending (distance, index) list of the K best candidates seen so far.
// KMAX is the register capacity; the runtime k <= KMAX slots are live.
template <int KMAX>
struct TopK {
  float d[KMAX];
  int idx[KMAX];
  float worst;  // d[k - 1]: a candidate must beat it strictly

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      d[j] = INFINITY;
      idx[j] = 0;
    }
    worst = INFINITY;
  }

  __device__ __forceinline__ void push(float dn, int in, int k) {
    if (!(dn < worst)) return;
    // insertion from the back: slot j takes its left neighbour while that
    // neighbour is strictly worse than the candidate (unrolled, so the
    // list stays in registers)
#pragma unroll
    for (int j = KMAX - 1; j > 0; --j) {
      if (d[j - 1] > dn) {
        d[j] = d[j - 1];
        idx[j] = idx[j - 1];
      } else if (d[j] > dn) {
        d[j] = dn;
        idx[j] = in;
      }
    }
    if (d[0] > dn) {
      d[0] = dn;
      idx[0] = in;
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j == k - 1) worst = d[j];
    }
  }
};

// Scan ``win_len`` key positions from ``start`` for this thread's query.
// Positions at or past ``nk`` are the virtual pad rows of the key set
// padded to a multiple of BINS: (0, 0, 0, PAD_W). Every thread of the block
// must call this (it synchronises); inactive threads pass active=false.
template <int KMAX>
__device__ __forceinline__ void scan_window(
    float4* slab, const float4* __restrict__ keys, int nk, int start,
    int win_len, float4 qv, bool active, int k, TopK<KMAX>& top) {
  for (int c0 = 0; c0 < win_len; c0 += CHUNK) {
    const int n = min(CHUNK, win_len - c0);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const int p = start + c0 + t;
      slab[t] = p < nk ? keys[p] : make_float4(0.f, 0.f, 0.f, PAD_W);
    }
    __syncthreads();
    if (active) {
      for (int t = 0; t < n; ++t) {
        top.push(sq_dist(qv, slab[t]), start + c0 + t, k);
      }
    }
  }
}

}  // namespace m3d
