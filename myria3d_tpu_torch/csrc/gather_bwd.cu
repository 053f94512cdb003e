// K4: VJP of the neighbour-row gather (deterministic scatter-add), and the
// inverse map of the neighbour graph that it walks.
//
// Replaces the Pallas TPU kernel myria3d_tpu/ops/pallas_gather.py::
// _scatter_kernel. The forward gathers payload rows x_j for every (centre
// i, slot k) with zeros on invalid slots; its cotangent dout (one row per
// slot) must be summed into the rows it was read from:
//   dpayload[j] = sum over valid slots s with idx[s] == j of dout[s].
//
// The TPU kernel turned this scatter into one-hot MXU matmuls over each
// query tile's sorted-key window. Here the slots are first grouped by key
// once per neighbour graph (an inverse map in CSR form: perm lists the
// valid slot ids grouped by key, slots of one key in ascending order;
// offsets[j]..offsets[j+1] is key j's range). Each output element then sums
// its incoming cotangents in that fixed order: no atomics on the sums, so
// they are bit-identical from run to run, and invalid slots never enter
// the map.
//
// Bound on the H100: memory. Every cotangent element is read once
// (n_slots * P * 4 bytes) through a data-dependent row index; the indices
// (4 bytes per slot) are shared by the threads of a key and hit L1. One
// thread owns one (key, channel vector) of the output, neighbouring
// threads neighbouring channels of a key, so every lane of a warp works
// whatever the width. Rows whose width is a multiple of 4 floats (and 16-
// byte aligned) are read as float4, other widths a float a thread. A
// thread loads GB_BATCH slot ids, then their rows, then adds them in
// ascending slot order, so that many row loads are in flight and the sums
// keep their order.
//
// The inverse map itself (m3d_inverse_map_*): a per-key count of the valid
// slots (integer atomics; counts do not depend on their order), an
// exclusive scan (outside, a plain cumulative sum), a fill that hands each
// slot a place in its key's range (an atomic cursor, so in no order), and
// an ordering of each key's range by slot id, which makes perm identical
// to a stable sort of the slots by key: a rank sort by a few lanes for the
// short ranges a neighbour graph gives, and for a key that very many slots
// chose a walk of its cloud's slots in order by the whole block.
#include <cuda_runtime.h>

#include <type_traits>

namespace m3d {

constexpr int GB_THREADS = 256;
constexpr int GB_BATCH = 8;  // row loads started before their adds

__device__ __forceinline__ void add_row(float& a, const float& b) { a += b; }
__device__ __forceinline__ void add_row(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// dout rows of pv vectors of VEC floats (1 or 4); total = n_keys * pv threads.
template <int VEC>
__global__ void __launch_bounds__(GB_THREADS, 1) gather_bwd_kernel(
    const float* __restrict__ dout, const int* __restrict__ perm,
    const int* __restrict__ offsets, int total, int pv, float* __restrict__ dpayload) {
  using V = typename std::conditional<VEC == 4, float4, float>::type;
  const int t = blockIdx.x * GB_THREADS + threadIdx.x;
  if (t >= total) return;
  const int key = t / pv, c = t - key * pv;
  const int s0 = offsets[key], s1 = offsets[key + 1];
  const V* rows = reinterpret_cast<const V*>(dout) + c;
  V acc = V{};
  for (int base = s0; base < s1; base += GB_BATCH) {
    int slot[GB_BATCH];
#pragma unroll
    for (int u = 0; u < GB_BATCH; ++u) slot[u] = base + u < s1 ? perm[base + u] : -1;
    V v[GB_BATCH];
#pragma unroll
    for (int u = 0; u < GB_BATCH; ++u) {
      v[u] = slot[u] >= 0 ? __ldg(rows + (long long)slot[u] * pv) : V{};
    }
#pragma unroll
    for (int u = 0; u < GB_BATCH; ++u) add_row(acc, v[u]);  // adding +0 changes nothing
  }
  reinterpret_cast<V*>(dpayload)[t] = acc;
}

// ---- the inverse map

constexpr int IM_THREADS = 256;
constexpr int IM_LANES = 8;   // lanes that order one key's short range
constexpr int IM_LONG = 256;  // a longer range is ordered by the whole block

// The key of a slot of a cloud (cloud * n_keys + idx), or -1 where the slot
// is invalid or its index lies outside the cloud's keys.
__device__ __forceinline__ int slot_key(const int* __restrict__ idx,
                                        const unsigned char* __restrict__ nv, long long slot,
                                        int cloud, int n_keys) {
  const int j = idx[slot];
  return nv[slot] && (unsigned)j < (unsigned)n_keys ? cloud * n_keys + j : -1;
}

// work[key + 2] += 1 for every valid slot.
__global__ void __launch_bounds__(IM_THREADS) inverse_count_kernel(
    const int* __restrict__ idx, const unsigned char* __restrict__ nv, int slots_per_cloud,
    int n_keys, int* __restrict__ work) {
  const int s = blockIdx.x * IM_THREADS + threadIdx.x;
  if (s >= slots_per_cloud) return;
  const long long slot = (long long)blockIdx.y * slots_per_cloud + s;
  const int key = slot_key(idx, nv, slot, blockIdx.y, n_keys);
  if (key >= 0) atomicAdd(work + key + 2, 1);
}

// After the cumulative sum work[key + 1] is key's first place; every valid
// slot takes the next place of its key, which leaves work[key + 1] at the
// first place of key + 1: work[0 .. n] is then the offsets array.
__global__ void __launch_bounds__(IM_THREADS) inverse_fill_kernel(
    const int* __restrict__ idx, const unsigned char* __restrict__ nv, int slots_per_cloud,
    int n_keys, int* __restrict__ work, int* __restrict__ unordered) {
  const int s = blockIdx.x * IM_THREADS + threadIdx.x;
  if (s >= slots_per_cloud) return;
  const long long slot = (long long)blockIdx.y * slots_per_cloud + s;
  const int key = slot_key(idx, nv, slot, blockIdx.y, n_keys);
  if (key >= 0) unordered[atomicAdd(work + key + 1, 1)] = (int)slot;
}

// perm = each key's range of slot ids, ascending. A block owns IM_THREADS /
// IM_LANES keys. A range of at most IM_LONG slots is rank sorted out of
// unordered by the key's lanes: a slot's place is the number of smaller
// slot ids in its range (they are distinct), d * d compares a key. A longer
// range (a key that very many slots chose) would make that one long serial
// loop; the whole block writes it instead by walking the cloud's slots in
// order, IM_THREADS a step, and keeping those of the key: as many steps as
// the cloud has slots, whatever the range's length.
__global__ void __launch_bounds__(IM_THREADS) inverse_order_kernel(
    const int* __restrict__ idx, const unsigned char* __restrict__ nv, int slots_per_cloud,
    int n_keys, const int* __restrict__ unordered, const int* __restrict__ offsets,
    int total_keys, int* __restrict__ perm) {
  constexpr int KEYS = IM_THREADS / IM_LANES;
  const int key0 = blockIdx.x * KEYS;
  const int key = key0 + threadIdx.x / IM_LANES;
  bool is_long = false;
  if (key < total_keys) {
    const int s0 = offsets[key], s1 = offsets[key + 1];
    is_long = s1 - s0 > IM_LONG;
    if (!is_long) {
      for (int e = s0 + threadIdx.x % IM_LANES; e < s1; e += IM_LANES) {
        const int v = unordered[e];
        int rank = 0;
        for (int f = s0; f < s1; ++f) rank += unordered[f] < v;
        perm[s0 + rank] = v;
      }
    }
  }
  if (!__syncthreads_or(is_long)) return;  // no long range among the block's keys
  __shared__ int hits[IM_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = key0; q < min(key0 + KEYS, total_keys); ++q) {
    const int s0 = offsets[q], d = offsets[q + 1] - s0;
    if (d <= IM_LONG) continue;  // the same for every thread of the block
    const int cloud = q / n_keys;
    const long long first = (long long)cloud * slots_per_cloud;
    int placed = 0;
    for (int base = 0; placed < d && base < slots_per_cloud; base += IM_THREADS) {
      const int s = base + threadIdx.x;
      const bool hit = s < slots_per_cloud && slot_key(idx, nv, first + s, cloud, n_keys) == q;
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) hits[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, all = 0;
#pragma unroll
      for (int w = 0; w < IM_THREADS / 32; ++w) {
        before += w < warp ? hits[w] : 0;
        all += hits[w];
      }
      if (hit) perm[s0 + placed + before + __popc(ballot & ((1u << lane) - 1u))] = (int)(first + s);
      placed += all;
      __syncthreads();
    }
  }
}

}  // namespace m3d

// dout (n_slots, p) f32 slot-major cotangents; perm (>= offsets[n_keys])
// i32 slot ids grouped by key; offsets (n_keys + 1) i32. Writes dpayload
// (n_keys, p) f32, every element (keys with no slot get 0). Rows are read
// as float4 where p is a multiple of 4 and both arrays are 16-byte aligned.
// n_keys * p must fit int32.
extern "C" int m3d_gather_bwd(const void* dout, const void* perm,
                              const void* offsets, int n_keys, int p,
                              void* dpayload, void* stream) {
  using namespace m3d;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = p % 4 == 0 && reinterpret_cast<size_t>(dout) % 16 == 0 &&
                   reinterpret_cast<size_t>(dpayload) % 16 == 0;
  const int pv = vec ? p / 4 : p;
  const long long total = (long long)n_keys * pv;
  if (n_keys <= 0 || p <= 0 || total >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = (unsigned)((total + GB_THREADS - 1) / GB_THREADS);
  const auto launch = vec ? gather_bwd_kernel<4> : gather_bwd_kernel<1>;
  launch<<<blocks, GB_THREADS, 0, s>>>(
      static_cast<const float*>(dout), static_cast<const int*>(perm),
      static_cast<const int*>(offsets), (int)total, pv, static_cast<float*>(dpayload));
  return static_cast<int>(cudaGetLastError());
}

// idx (B, slots_per_cloud) i32 keys within each cloud's n_keys; nv (B,
// slots_per_cloud) u8, 0 at invalid slots. A valid slot whose index is not
// in [0, n_keys) is left out of the map like an invalid one.
// work (B * n_keys + 2) i32, zeroed: counts the valid slots of key q into
// work[q + 2].
extern "C" int m3d_inverse_map_count(const void* idx, const void* nv, int B, int slots_per_cloud,
                                     int n_keys, void* work, void* stream) {
  using namespace m3d;
  const dim3 grid((slots_per_cloud + IM_THREADS - 1) / IM_THREADS, B);
  inverse_count_kernel<<<grid, IM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const unsigned char*>(nv), slots_per_cloud, n_keys,
      static_cast<int*>(work));
  return static_cast<int>(cudaGetLastError());
}

// After work[2:] was summed cumulatively in place: fills unordered (B *
// slots_per_cloud) i32 with each key's slots in no order and leaves the
// offsets in work[: B * n_keys + 1]; then perm (B * slots_per_cloud) i32
// gets each key's range in ascending order. Entries of perm and unordered
// from offsets[B * n_keys] on are not written.
extern "C" int m3d_inverse_map_fill(const void* idx, const void* nv, int B, int slots_per_cloud,
                                    int n_keys, void* work, void* unordered, void* perm,
                                    void* stream) {
  using namespace m3d;
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((slots_per_cloud + IM_THREADS - 1) / IM_THREADS, B);
  inverse_fill_kernel<<<grid, IM_THREADS, 0, s>>>(
      static_cast<const int*>(idx), static_cast<const unsigned char*>(nv), slots_per_cloud, n_keys,
      static_cast<int*>(work), static_cast<int*>(unordered));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int KEYS = IM_THREADS / IM_LANES;
  const long long total = (long long)B * n_keys;
  inverse_order_kernel<<<(unsigned)((total + KEYS - 1) / KEYS), IM_THREADS, 0, s>>>(
      static_cast<const int*>(idx), static_cast<const unsigned char*>(nv), slots_per_cloud, n_keys,
      static_cast<const int*>(unordered), static_cast<const int*>(work), (int)total,
      static_cast<int*>(perm));
  return static_cast<int>(cudaGetLastError());
}
