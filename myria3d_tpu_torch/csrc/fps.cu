// K8: masked farthest-point sampling, one block of 1024 threads per cloud.
//
// Replaces myria3d_tpu/ops/fps.py:25-57 (farthest_point_sampling), which
// is no Pallas kernel but a lax.scan of m rounds that XLA runs as one loop
// on the device. In plain PyTorch each round is a handful of launches: at
// N=12288 a PointNet++ forward takes 3072 + 768 + 192 + 48 rounds, some
// 20,000 launches. Here the whole scan is one launch.
//
// What it computes, step for step as the scan (bit-equal indices):
//   last = first valid point (0 when the cloud is all pads);
//   mind = +1e30 on valid points, -1 on pads;
//   round t: out[t] = last; d = (dx*dx + dy*dy) + dz*dz from pos[last]
//   (each op rounded, no FMA: the association of the CPU sum);
//   mind = min(mind, d) on valid points (pads keep -1, which min(-1, d >= 0)
//   gives without a mask); last = argmax(mind), ties to the lower index.
// Slots at or past min(valid count, m) get index 0 and mask false, so the
// loop stops after min(valid count, m) rounds, and the last round's update
// (whose argmax no slot reads) is skipped.
//
// Layout: thread t owns points t, t + 1024, ... (coalesced loads). Up to
// FPS_MAX_REG points a thread (N <= 12288) the coordinates and mind live in
// registers (fps_kernel<PT>, PT points a thread), and a copy of the
// coordinates in shared memory (x, y, z planes, 12 bytes a point) serves
// the broadcast of the winner's position. Past that, up to FPS_MAX_N
// points, fps_kernel<0> keeps mind in shared memory (4 bytes a point) and
// reads the coordinates from device memory each round (L1/L2 resident).
// Each round ends in one block-wide argmax: a shuffle reduction per warp,
// the 32 warp winners through shared memory (double-buffered by round
// parity, so one __syncthreads a round suffices) and a second shuffle
// reduction that every warp runs, so every thread learns the winner.
//
// Bound on the H100: about 10 FP32 instructions per point per round
// (3 subtractions, 3 products, 2 sums, the min and the compare), 6e9 at
// B=16 and N=12288 -> m=3072, 0.18 ms at 33.5 T/s. What holds it is the
// chain of m dependent block-wide reductions (each a __syncthreads and two
// shuffle trees), with B blocks on 132 SMs: a round cannot start before
// the last one's winner is known. A cluster per cloud, or several rounds'
// candidates at once, would shorten that chain.
#include <cuda_runtime.h>

#include <cfloat>

namespace m3d {

constexpr int FPS_THREADS = 1024;  // 32 warps: the second reduction reads one winner a lane
constexpr int FPS_MAX_REG = 12;    // points a thread in registers (64 registers a thread)
constexpr int FPS_MAX_N = 49152;   // fps_kernel<0>: mind in shared memory, 4 bytes a point
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sq_dist(float x, float y, float z, float lx, float ly, float lz) {
  const float dx = __fsub_rn(x, lx), dy = __fsub_rn(y, ly), dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// (v, i) takes (ov, oi) if it is larger, or equal with a lower index.
__device__ __forceinline__ void take(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    take(v, i, ov, oi);
  }
}

// The block's argmax of the threads' (v, i), returned to every thread.
__device__ __forceinline__ int block_argmax(float v, int i, float (*sv)[32], int (*si)[32],
                                            int parity) {
  warp_argmax(v, i);
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    sv[parity][threadIdx.x >> 5] = v;
    si[parity][threadIdx.x >> 5] = i;
  }
  __syncthreads();
  v = sv[parity][lane];
  i = si[parity][lane];
  warp_argmax(v, i);
  return i;
}

// pos (B, n, 3) f32, mask (B, n) u8; writes idx (B, m) i32 and new_mask
// (B, m) u8. PT > 0: PT points a thread in registers (n <= PT * 1024) and
// 12 n bytes of dynamic shared memory; PT == 0: 4 n bytes.
template <int PT>
__global__ void __launch_bounds__(FPS_THREADS, 1)
    fps_kernel(const float* __restrict__ pos, const unsigned char* __restrict__ mask, int n,
               int m, int* __restrict__ out_idx, unsigned char* __restrict__ out_mask) {
  extern __shared__ float smem[];
  __shared__ float sv[2][32];
  __shared__ int si[2][32];
  __shared__ int s_count, s_first;
  const int t = threadIdx.x;
  const float* p = pos + (size_t)blockIdx.x * n * 3;
  const unsigned char* mk = mask + (size_t)blockIdx.x * n;
  int* oi = out_idx + (size_t)blockIdx.x * m;
  unsigned char* om = out_mask + (size_t)blockIdx.x * m;

  if (t == 0) {
    s_count = 0;
    s_first = n;
  }
  __syncthreads();
  int cnt = 0, first = n;
  for (int j = t; j < n; j += FPS_THREADS) {
    if (mk[j]) {
      ++cnt;
      first = min(first, j);
    }
  }
  cnt = __reduce_add_sync(FULL, cnt);
  first = (int)__reduce_min_sync(FULL, (unsigned)first);
  if ((t & 31) == 0) {
    atomicAdd(&s_count, cnt);
    atomicMin(&s_first, first);
  }

  float* sx = smem;  // PT > 0: the coordinate planes
  float* sy = smem + n;
  float* sz = smem + 2 * n;
  float* smind = smem;  // PT == 0: mind
  float px[PT > 0 ? PT : 1], py[PT > 0 ? PT : 1], pz[PT > 0 ? PT : 1], mind[PT > 0 ? PT : 1];
  if constexpr (PT > 0) {
#pragma unroll
    for (int q = 0; q < PT; ++q) {
      const int j = q * FPS_THREADS + t;
      if (j < n) {
        px[q] = p[3 * j];
        py[q] = p[3 * j + 1];
        pz[q] = p[3 * j + 2];
        mind[q] = mk[j] ? 1e30f : -1.0f;
        sx[j] = px[q];
        sy[j] = py[q];
        sz[j] = pz[q];
      } else {  // past the cloud: never chosen
        px[q] = py[q] = pz[q] = 0.0f;
        mind[q] = -FLT_MAX;
      }
    }
  } else {
    for (int j = t; j < n; j += FPS_THREADS) smind[j] = mk[j] ? 1e30f : -1.0f;
  }
  __syncthreads();
  const int rounds = min(s_count, m);
  int last = s_count > 0 ? s_first : 0;

  for (int r = 0; r < rounds; ++r) {
    if (t == 0) oi[r] = last;
    if (r + 1 == rounds) break;
    float lx, ly, lz;
    if constexpr (PT > 0) {
      lx = sx[last];
      ly = sy[last];
      lz = sz[last];
    } else {
      lx = p[3 * last];
      ly = p[3 * last + 1];
      lz = p[3 * last + 2];
    }
    float bv = -FLT_MAX;
    int bi = 0x7fffffff;
    if constexpr (PT > 0) {
#pragma unroll
      for (int q = 0; q < PT; ++q) {
        mind[q] = fminf(mind[q], sq_dist(px[q], py[q], pz[q], lx, ly, lz));
        if (mind[q] > bv) {
          bv = mind[q];
          bi = q * FPS_THREADS + t;
        }
      }
    } else {
      for (int j = t; j < n; j += FPS_THREADS) {
        const float v = fminf(smind[j], sq_dist(p[3 * j], p[3 * j + 1], p[3 * j + 2], lx, ly, lz));
        smind[j] = v;
        if (v > bv) {
          bv = v;
          bi = j;
        }
      }
    }
    last = block_argmax(bv, bi, sv, si, r & 1);
  }
  for (int s = t; s < m; s += FPS_THREADS) {
    om[s] = s < rounds;
    if (s >= rounds) oi[s] = 0;
  }
}

template <int PT>
int launch_fps(const float* pos, const unsigned char* mask, int B, int n, int m, int* idx,
               unsigned char* new_mask, cudaStream_t s) {
  const size_t smem = (PT > 0 ? 3 : 1) * (size_t)n * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fps_kernel<PT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fps_kernel<PT><<<B, FPS_THREADS, smem, s>>>(pos, mask, n, m, idx, new_mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace m3d

// pos (B, n, 3) f32 contiguous, mask (B, n) u8 (bool); idx (B, m) i32 and
// new_mask (B, m) u8 (bool) written. 1 <= n <= 49152, m >= 1.
extern "C" int m3d_fps(const void* pos, const void* mask, int B, int n, int m, void* idx,
                       void* new_mask, void* stream) {
  using namespace m3d;
  if (B <= 0 || n <= 0 || m <= 0 || n > FPS_MAX_N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto pp = static_cast<const float*>(pos);
  auto mp = static_cast<const unsigned char*>(mask);
  auto ip = static_cast<int*>(idx);
  auto op = static_cast<unsigned char*>(new_mask);
  const int pt = (n + FPS_THREADS - 1) / FPS_THREADS;
  if (pt <= 1) return launch_fps<1>(pp, mp, B, n, m, ip, op, s);
  if (pt <= 2) return launch_fps<2>(pp, mp, B, n, m, ip, op, s);
  if (pt <= 4) return launch_fps<4>(pp, mp, B, n, m, ip, op, s);
  if (pt <= 8) return launch_fps<8>(pp, mp, B, n, m, ip, op, s);
  if (pt <= FPS_MAX_REG) return launch_fps<FPS_MAX_REG>(pp, mp, B, n, m, ip, op, s);
  return launch_fps<0>(pp, mp, B, n, m, ip, op, s);
}
