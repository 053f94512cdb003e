// K4: VJP of the neighbour-row gather (deterministic scatter-add).
//
// Replaces the Pallas TPU kernel myria3d_tpu/ops/pallas_gather.py::
// _scatter_kernel. The forward gathers payload rows x_j for every (centre
// i, slot k) with zeros on invalid slots; its cotangent dout (one row per
// slot) must be summed into the rows it was read from:
//   dpayload[j] = sum over valid slots s with idx[s] == j of dout[s].
//
// The TPU kernel turned this scatter into one-hot MXU matmuls over each
// query tile's sorted-key window. Here the slots are first sorted by key
// once per neighbour graph (an inverse map in CSR form: perm lists the
// valid slot ids grouped by key, slots of one key in ascending order;
// offsets[j]..offsets[j+1] is key j's range). Each output element then sums
// its incoming cotangents in that fixed order: no atomics, so the sums are
// bit-identical from run to run, and invalid slots never enter the map.
//
// Layout: one thread per (key, channel) of the (n_keys, P) output;
// neighbouring threads read neighbouring channels of the same slot row.
//
// Bound on the H100: memory. Every cotangent element is read once
// (n_slots * P * 4 bytes) through a data-dependent row index; the indices
// (4 bytes per slot) are shared by the P threads of a key and hit L1.
#include <cuda_runtime.h>

namespace m3d {

constexpr int GB_THREADS = 256;

__global__ void __launch_bounds__(GB_THREADS) gather_bwd_kernel(
    const float* __restrict__ dout, const int* __restrict__ perm,
    const int* __restrict__ offsets, int n_keys, int p,
    float* __restrict__ dpayload) {
  const long long t = (long long)blockIdx.x * GB_THREADS + threadIdx.x;
  if (t >= (long long)n_keys * p) return;
  const long long key = t / p;
  const int ch = (int)(t - key * p);
  const int s0 = offsets[key], s1 = offsets[key + 1];
  float acc = 0.f;
  for (int s = s0; s < s1; ++s) acc += dout[(long long)perm[s] * p + ch];
  dpayload[t] = acc;
}

}  // namespace m3d

// dout (n_slots, p) f32 slot-major cotangents; perm (>= offsets[n_keys])
// i32 slot ids grouped by key; offsets (n_keys + 1) i32. Writes dpayload
// (n_keys, p) f32, every element (keys with no slot get 0).
extern "C" int m3d_gather_bwd(const void* dout, const void* perm,
                              const void* offsets, int n_keys, int p,
                              void* dpayload, void* stream) {
  using namespace m3d;
  const long long total = (long long)n_keys * p;
  const unsigned blocks = (unsigned)((total + GB_THREADS - 1) / GB_THREADS);
  gather_bwd_kernel<<<blocks, GB_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dout), static_cast<const int*>(perm),
      static_cast<const int*>(offsets), n_keys, p,
      static_cast<float*>(dpayload));
  return static_cast<int>(cudaGetLastError());
}
