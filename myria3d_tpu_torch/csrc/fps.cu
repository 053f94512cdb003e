// K8: masked farthest-point sampling, one thread-block cluster per cloud.
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
// What bounds it: about 10 FP32 instructions a valid point a round, 6e9 at
// B=16 and N=12288 -> m=3072, 0.18 ms at 33.5 T/s; but the m rounds form
// a chain, each waiting for the last one's argmax. A round costs a fixed
// part (the argmax over the cloud's threads: its latency chain) and a part
// per point a thread, paced by the issue slots of the SMs the cloud holds.
// The design cuts both:
//
// - Route (ops/cuda_fps.py::route, from B, n and the SM count): a cluster
//   of c CTAs a cloud (cudaLaunchKernelEx, cluster dimension c <= 8), T
//   threads a CTA (<= 512, 128 registers a thread) and PT points a thread in
//   registers, T * PT * c >= n. CTA j of the cluster holds the points
//   [j T PT, (j + 1) T PT), warp w of it the next 32 PT, lane l the points
//   warp-base + 32 q + l (coalesced loads; a warp is a contiguous index
//   range, a thin slab of an x-sorted cloud).
// - Argmax: each lane's best (mind, index) over its points in index order
//   (strict >, so the lower index wins a tie); the warp's through two
//   redux.sync, on an order-preserving uint32 key of mind (sign bit flipped
//   on non-negatives, all bits on negatives: the pads' -1 and the -FLT_MAX
//   of slots past the cloud) and on the index among the lanes holding the
//   largest key. Lanes 0..c-1 of every warp write its slot, (key, ~index)
//   and the winner's position, into CTA `lane` of the cluster: st.async
//   into distributed shared memory, counted by the receiving CTA's
//   mbarrier (c > 1), or a shared store and one __syncthreads (c = 1). The
//   slots are parity-buffered by round, and every warp reads them back and
//   reduces them the same way (max of the packed (key, ~index)), so every
//   thread learns the winner; its position is the slot index / (32 PT).
//   One-way stores and a local wait replace a cluster-wide barrier: no CTA
//   writes round r + 2's slots before every warp of the cluster has sent
//   round r + 1's, which each does after reading round r's.
// - Warps that hold no valid point never update (their slots carry key 0,
//   below every key). With `skip`, a warp also skips a round when the
//   bounding box of its valid points is too far from the new centre to
//   lower any of its distances: with g the per-axis gap from the centre to
//   the box (0 inside), rounded as the kernel rounds, every point of the
//   box has d >= fl(fl(gx*gx + gy*gy) + gz*gz) (rounding is monotone), so
//   when that is >= the warp's largest mind no mind changes and last
//   round's slot stands, bit for bit. It pays where a warp's points lie
//   close together, as on x-sorted clouds (predict's and test's first set
//   abstraction), and costs a few percent where they do not (fit's).
//
// Measured on the H100 (PERF.md, scripts/tune_fps.py): the round's latency
// chain, not its arithmetic, takes most of the time (~0.4 us a round with
// one CTA a cloud, ~0.65 us with a cluster at sa1, against 0.2-0.3 us of
// issue for the points an SM holds).
#include <cuda_runtime.h>

#include <cfloat>

namespace m3d {

constexpr int FPS_MAX_CLUSTER = 8;                        // the portable cluster size
constexpr int FPS_MAX_N = 49152;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sq_dist(float x, float y, float z, float lx, float ly, float lz) {
  const float dx = __fsub_rn(x, lx), dy = __fsub_rn(y, ly), dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// order-preserving key: a < b as floats (no NaN) <=> key(a) < key(b)
__device__ __forceinline__ unsigned fkey(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\t"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

// the shared::cluster address of `addr` (a shared::cta address) in CTA `rank`
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// this phase of `bar` waits for `bytes` more of st.async data (one arrival)
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits for the phase of `bar` with the given parity to complete. A phase
// that never completes (a record that never came) traps instead of hanging.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (unsigned spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred P;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, P;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 22)) __trap();
  }
}

// stores into a peer's shared memory that count against its mbarrier `bar`
__device__ __forceinline__ void st_async(unsigned addr, unsigned long long v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];" ::"r"(
                   addr),
               "l"(v), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void st_async(unsigned addr, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}


__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

constexpr int FPS_THREADS_MAX = 512;  // threads a CTA: 128 registers a thread
constexpr int FPS_REC_BYTES = sizeof(unsigned long long) + sizeof(float4);  // a slot

// Dynamic shared memory of a CTA: its points' positions (float4), the two
// parity buffers of slots ((key, ~index), then the position) and their two
// mbarriers.
__host__ __device__ constexpr size_t fps_smem(int threads, int pt, int c) {
  return (size_t)threads * pt * sizeof(float4) + 2 * (size_t)c * (threads / 32) * FPS_REC_BYTES +
         2 * sizeof(unsigned long long);
}

// pos (B, n, 3) f32, mask (B, n) u8; writes idx (B, m) i32 and new_mask
// (B, m) u8. Grid B * c CTAs of blockDim.x threads (a multiple of 32), in
// clusters of c when c > 1; PT points a thread.
template <int PT>
__global__ void __launch_bounds__(FPS_THREADS_MAX, 1)
    fps_kernel(const float* __restrict__ pos, const unsigned char* __restrict__ mask, int n,
               int m, int c, int skip, int* __restrict__ out_idx,
               unsigned char* __restrict__ out_mask) {
  extern __shared__ float4 smem[];
  __shared__ int s_count, s_first;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int threads = blockDim.x, nw = threads >> 5, slots = c * nw;
  const int rank = c > 1 ? (int)cluster_rank() : 0;
  const int cloud = blockIdx.x / c;
  const int cap = threads * PT;                           // points a CTA
  const int cta_base = rank * cap;
  const int warp_base = cta_base + warp * 32 * PT;
  const float* p = pos + (size_t)cloud * n * 3;
  const unsigned char* mk = mask + (size_t)cloud * n;
  int* oi = out_idx + (size_t)cloud * m;
  unsigned char* om = out_mask + (size_t)cloud * m;
  float4* sp = smem;                                      // cap positions
  unsigned long long* skey = reinterpret_cast<unsigned long long*>(sp + cap);  // [2][slots]
  float4* spos = reinterpret_cast<float4*>(skey + 2 * slots);                 // [2][slots]
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(spos + 2 * slots);  // [2]

  // the cloud's valid count and first valid point (every CTA of the cluster)
  if (t == 0) {
    s_count = 0;
    s_first = n;
    if (c > 1) {
      mbar_init(smem_addr(bars), 1);
      mbar_init(smem_addr(bars + 1), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();
  int cnt = 0, first = n;
  for (int j = t; j < n; j += threads) {
    if (mk[j]) {
      ++cnt;
      first = min(first, j);
    }
  }
  cnt = __reduce_add_sync(FULL, cnt);
  first = (int)__reduce_min_sync(FULL, (unsigned)first);
  if (lane == 0) {
    atomicAdd(&s_count, cnt);
    atomicMin(&s_first, first);
  }

  float px[PT], py[PT], pz[PT], mind[PT];
  float lo_x = FLT_MAX, lo_y = FLT_MAX, lo_z = FLT_MAX;
  float hi_x = -FLT_MAX, hi_y = -FLT_MAX, hi_z = -FLT_MAX;
  bool any = false;
#pragma unroll
  for (int q = 0; q < PT; ++q) {
    const int j = warp_base + q * 32 + lane;
    if (j < n) {
      px[q] = p[3 * j];
      py[q] = p[3 * j + 1];
      pz[q] = p[3 * j + 2];
      const bool valid = mk[j] != 0;
      mind[q] = valid ? 1e30f : -1.0f;
      if (valid) {
        any = true;
        lo_x = fminf(lo_x, px[q]);
        lo_y = fminf(lo_y, py[q]);
        lo_z = fminf(lo_z, pz[q]);
        hi_x = fmaxf(hi_x, px[q]);
        hi_y = fmaxf(hi_y, py[q]);
        hi_z = fmaxf(hi_z, pz[q]);
      }
    } else {  // past the cloud: never chosen
      px[q] = py[q] = pz[q] = 0.0f;
      mind[q] = -FLT_MAX;
    }
    sp[j - cta_base] = make_float4(px[q], py[q], pz[q], 0.0f);
  }
  // the warp's flag and box: computed once, uniform over its lanes
  const bool live = __any_sync(FULL, any);
  lo_x = warp_min(lo_x);
  lo_y = warp_min(lo_y);
  lo_z = warp_min(lo_z);
  hi_x = warp_max(hi_x);
  hi_y = warp_max(hi_y);
  hi_z = warp_max(hi_z);
  // positions stored and mbarriers set up in every CTA before any peer sends
  if (c > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }

  const int rounds = min(s_count, m);
  int last = s_count > 0 ? s_first : 0;
  float lx = p[3 * last], ly = p[3 * last + 1], lz = p[3 * last + 2];
  const bool writer = rank == 0 && warp == 0;             // buffers 32 output slots a lane
  const int my_slot = rank * nw + warp;
  const unsigned bar0 = smem_addr(bars);
  // this warp's slot in buffer 0 and mbarrier 0 of CTA `lane` (lanes < c send)
  const unsigned peer_key = c > 1 ? map_rank(smem_addr(skey + my_slot), lane % c) : 0u;
  const unsigned peer_pos = c > 1 ? map_rank(smem_addr(spos + my_slot), lane % c) : 0u;
  const unsigned peer_bar = c > 1 ? map_rank(bar0, lane % c) : 0u;
  float bv = -INFINITY;
  int bi = warp_base + lane;
  unsigned wk = live ? FULL : 0u, wi = FULL;              // the warp's best (key, index)
  int held = 0;

  for (int r = 0;; ++r) {
    if (writer) {  // out[r], stored 32 slots at a time
      if (lane == (r & 31)) held = last;
      if ((r & 31) == 31 || r + 1 >= rounds) {
        if (lane <= (r & 31)) oi[(r & ~31) + lane] = held;
      }
    }
    if (r + 1 >= rounds) break;
    const int par = r & 1;
    if (c > 1 && t == 0) mbar_expect(bar0 + 8 * par, slots * FPS_REC_BYTES);
    if (live) {
      bool stay = false;
      if (skip) {
        const float gx = fmaxf(fmaxf(__fsub_rn(lo_x, lx), __fsub_rn(lx, hi_x)), 0.0f);
        const float gy = fmaxf(fmaxf(__fsub_rn(lo_y, ly), __fsub_rn(ly, hi_y)), 0.0f);
        const float gz = fmaxf(fmaxf(__fsub_rn(lo_z, lz), __fsub_rn(lz, hi_z)), 0.0f);
        const float lb = __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                                   __fmul_rn(gz, gz));
        stay = fkey(lb) >= wk;
      }
      if (!stay) {
        bv = -INFINITY;
#pragma unroll
        for (int q = 0; q < PT; ++q) {
          mind[q] = fminf(mind[q], sq_dist(px[q], py[q], pz[q], lx, ly, lz));
          if (mind[q] > bv) {
            bv = mind[q];
            bi = warp_base + q * 32 + lane;
          }
        }
        const unsigned key = fkey(bv);
        wk = __reduce_max_sync(FULL, key);
        wi = __reduce_min_sync(FULL, key == wk ? (unsigned)bi : FULL);
      }
    }
    // the warp's slot: (key, ~index) and the winner's position, or key 0
    const unsigned long long packed = live ? ((unsigned long long)wk << 32) | (unsigned)~wi : 0ull;
    const float4 w = live ? sp[wi - cta_base] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c > 1) {
      if (lane < c) {
        const unsigned off = par * slots;
        st_async(peer_key + off * 8, packed, peer_bar + 8 * par);
        st_async(peer_pos + off * 16, w, peer_bar + 8 * par);
      }
      mbar_wait(bar0 + 8 * par, (r >> 1) & 1);
    } else {
      if (lane == 0) {
        skey[par * slots + my_slot] = packed;
        spos[par * slots + my_slot] = w;
      }
      __syncthreads();
    }
    // every warp: the winner of the slots (largest key, then lowest index)
    unsigned long long best = 0ull;
    for (int s = lane; s < slots; s += 32) {
      const unsigned long long v = skey[par * slots + s];
      best = v > best ? v : best;
    }
    const unsigned hi = (unsigned)(best >> 32);
    const unsigned top = __reduce_max_sync(FULL, hi);
    const unsigned low = __reduce_max_sync(FULL, hi == top ? (unsigned)best : 0u);
    last = (int)~low;
    const float4 lw = spos[par * slots + last / (32 * PT)];
    lx = lw.x;
    ly = lw.y;
    lz = lw.z;
  }
  if (rank == 0) {
    for (int s = t; s < m; s += threads) {
      om[s] = s < rounds;
      if (s >= rounds) oi[s] = 0;
    }
  }
  // no CTA leaves while a peer may still address its shared memory
  if (c > 1) cluster_sync();
}

template <int PT>
cudaError_t launch_fps(const float* pos, const unsigned char* mask, int B, int n, int m,
                       int threads, int c, int skip, int* idx, unsigned char* new_mask,
                       cudaStream_t s) {
  const size_t smem = fps_smem(threads, PT, c);
  cudaError_t e = cudaFuncSetAttribute(fps_kernel<PT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * c);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = c > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, fps_kernel<PT>, pos, mask, n, m, c, skip, idx, new_mask);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int PT>
cudaError_t max_clusters(int threads, int c, int* out) {
  const size_t smem = fps_smem(threads, PT, c);
  cudaError_t e = cudaFuncSetAttribute(fps_kernel<PT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c * 1024);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, fps_kernel<PT>, &cfg);
}

// The instantiations: points a thread.
#define M3D_FPS_PTS(X) X(1) X(2) X(3) X(4) X(6) X(8) X(12) X(14)

bool valid_route(int n, int threads, int pt, int c) {
  return threads >= 32 && threads % 32 == 0 && threads <= FPS_THREADS_MAX && c >= 1 &&
         c <= FPS_MAX_CLUSTER && (long long)threads * pt * c >= n &&
         fps_smem(threads, pt, c) <= 232448;
}

}  // namespace m3d

// pos (B, n, 3) f32 contiguous, mask (B, n) u8 (bool); idx (B, m) i32 and
// new_mask (B, m) u8 (bool) written. 1 <= n <= 49152, m >= 1; the route:
// `threads` a CTA, `pt` points a thread (an instantiated count), a cluster
// of `c` CTAs a cloud with threads * pt * c >= n, `skip` the box test.
extern "C" int m3d_fps(const void* pos, const void* mask, int B, int n, int m, int threads,
                       int pt, int c, int skip, void* idx, void* new_mask, void* stream) {
  using namespace m3d;
  if (B <= 0 || n <= 0 || m <= 0 || n > FPS_MAX_N || !valid_route(n, threads, pt, c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto pp = static_cast<const float*>(pos);
  auto mp = static_cast<const unsigned char*>(mask);
  auto ip = static_cast<int*>(idx);
  auto op = static_cast<unsigned char*>(new_mask);
#define M3D_FPS_LAUNCH(P) \
  if (pt == P) return static_cast<int>(launch_fps<P>(pp, mp, B, n, m, threads, c, skip, ip, op, s));
  M3D_FPS_PTS(M3D_FPS_LAUNCH)
#undef M3D_FPS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// cudaOccupancyMaxActiveClusters of a route: how many clusters of `c` CTAs
// of `threads` threads and `pt` points a thread the card holds at once.
extern "C" int m3d_fps_max_clusters(int threads, int pt, int c, void* out) {
  using namespace m3d;
  if (!valid_route(1, threads, pt, c)) return static_cast<int>(cudaErrorInvalidValue);
  auto o = static_cast<int*>(out);
#define M3D_FPS_OCC(P) \
  if (pt == P) return static_cast<int>(max_clusters<P>(threads, c, o));
  M3D_FPS_PTS(M3D_FPS_OCC)
#undef M3D_FPS_OCC
  return static_cast<int>(cudaErrorInvalidValue);
}
