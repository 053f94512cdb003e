// Shared search of the exact kNN kernels K1 and K7 (knn.cu) and K3
// (interp.cu).
//
// One block covers one tile of 256 queries of one cloud and the tile's
// window of x-sorted key positions (``ops/cuda_knn.py::window_bases``);
// positions at or past ``nk`` are the virtual pad rows (0, 0, 0, PAD_W).
// Selection is exact: the K smallest (d2, index) pairs of the window in
// lexicographic order, the score summed in the plain version's association.
// The score of a pair is a policy of the search: the squared distance
// (``SqDist``: K1, K3) or the expanded score |k|^2 - 2 q.k (``Expanded``:
// K7), whose selection and order are the same wherever the scan goes.
//
// Bound on the H100: FP32 issue. A (query, key) pair costs 3 subtractions,
// 3 products and 3 sums (SqDist), each rounded on its own (no FMA, for the
// plain version's bits), plus the compare against the K-th best; the
// expanded score filters on a product and 3 FMAs and scores exactly only
// what passes (``Gate``). The bound that chip_smoke.py prints counts 8
// instructions per pair at 33.5 T/s. The design keeps everything else off
// that path:
//
// 1. The K-list is a compile-time size held in registers (``TopK<K>``):
//    K = 16 (encoder self-kNN), 1 (decoder searches), 4 (any k in [2, 4]:
//    PointNet++'s k=3 propagation searches, which the 32-slot list made
//    keep 32 and write 3), 10 (K3), and one generic K = 32 list for any
//    other k in [1, 32], which keeps the 32 best and writes the first k.
//    The K-th best is the last slot, a register. Every index into the list
//    is static after unrolling, so nothing of it goes to local memory
//    (chip_smoke.py phase 2 reads the stack frame and spills of every
//    instantiation and fails on either). The list's first bound is a
//    parameter (``TopK::init``): +inf, or for K1's ball route the radius's
//    r^2, so that a key outside the ball fails the one-compare filter and
//    never inserts (the generic list kept the 32 nearest keys of the whole
//    cloud and inserted at nearly every key of an unsorted cloud).
// 2. A thread holds Q queries of the tile; each staged key read from
//    shared memory feeds its Q distance tests, and the block runs 256 / Q
//    threads. A warp's 32 Q queries are one band of the tile's rows ranked
//    by y (``tile_queries``): an x-sorted tile spans the cloud's whole y,
//    and a warp of rows in x order waited on an insertion at nearly every
//    key near its x, for some lane's query at the right y (K1 K=16 self
//    12288 took 4.4 ms that way, 2.6 ms in bands). The narrower the band,
//    the rarer such waits, against fewer tests per shared read. Measured at
//    the predict shapes (scripts/tune_search_q.py): Q = 1 for K = 16 and 10
//    (68 and 59 registers; bands of 32 rows, 6-12 % faster than Q = 2 and
//    far faster than Q = 4), Q = 2 for K = 1 (40 registers; its insertion
//    is cheap, so sharing the reads wins: 11 % faster than Q = 4), Q = 1
//    for the generic 32-slot list (two such lists spilled at 168
//    registers) and for the 4-slot list (43 registers; PointNet++'s k=3
//    searches, B=48: 9-32 % less time than Q = 2, 31-67 % less than Q = 4).
//    A tile is x-ordered: its rows are x-sorted queries, or where the
//    queries' rows are in no order (PointNet++'s FPS centroids, at its ball
//    queries) the tile walks a permutation of them in x order (``perm``)
//    and writes each result to its own row. Four blocks of a 56 KB window
//    fit an SM. K7's full scans
//    (self 12288, B=48) keep the same choices: Q = 2 for K = 16 was 33 %
//    slower, Q = 1 for K = 1 18 % slower and Q = 4 3 % slower.
// 3. Near keys first. Each warp binary-searches its queries' mean x into
//    the staged (x-sorted) keys and walks outward, alternately right and
//    left, to both ends: the list fills with near keys at once and later
//    candidates rarely pass the ``d <= worst`` filter, so insertions (a
//    branch a whole warp waits on) become rare. Because keys no longer
//    arrive in position order, a candidate enters iff (d2, index) is below
//    the K-th best in lexicographic order: the selected set and its order
//    are the plain version's whatever the scan order, so unsorted clouds
//    (full scans) stay exact too. Every key of the window is still tested.
// 4. The window is staged once with ``cp.async`` into dynamic shared
//    memory (up to STAGE_MAX positions, 80 KB) and the scan waits on it
//    once. Longer windows and full scans stream through a double-buffered
//    ring of RING-key chunks, the next chunk's copy in flight while the
//    current one is scanned, the chunks taken centre-out from the chunk
//    that holds the tile's middle x (RING = 1024: a 32 KB ring lets four
//    blocks share an SM; 2048 measured 4-16 % slower on K3's and K7's full
//    scans). The loading thread prepares each key's w slot once (w^2, or
//    |k|^2 for the expanded score), so that term costs one add per pair.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include <atomic>

namespace m3d {

constexpr int TILE_Q = 256;      // queries per block == window tile
constexpr int BINS = 512;        // window base granularity (key positions)
constexpr int STAGE_MAX = 5120;  // longest window staged whole (80 KB)
constexpr int RING = 1024;       // ring chunk of longer scans (2 x 16 KB)
constexpr float PAD_W = 1e4f;    // 4th coordinate of pad keys

// Dynamic shared memory of a block scanning ``win_len`` positions (at least
// the 512 words that ``tile_queries`` borrows).
inline size_t search_smem_bytes(int win_len) {
  const size_t slab = static_cast<size_t>(win_len <= STAGE_MAX ? win_len : 2 * RING);
  return slab * sizeof(float4) > 2 * TILE_Q * sizeof(float) ? slab * sizeof(float4)
                                                              : 2 * TILE_Q * sizeof(float);
}

// The scores of the search. ``prepare`` is what the loading thread writes
// once into a staged key's w slot, ``score`` a pair's score against that
// staged key, every op rounded on its own (no FMA contraction), in the
// association of the plain version. Queries carry w = 0. A virtual pad row
// (0, 0, 0, PAD_W) prepares to PAD_W^2 under both, which stage_async writes.
//
// ``bounded``: the scan filters pairs on a cheaper bound first (``Gate``).
//
// SqDist (K1, K3): the squared distance ((w^2 + dx^2) + dy^2) + dz^2.
struct SqDist {
  static constexpr bool bounded = false;
  static __device__ __forceinline__ float prepare(float4 k) { return __fmul_rn(k.w, k.w); }
  static __device__ __forceinline__ float score(float4 q, float4 k) {
    const float dx = __fsub_rn(q.x, k.x);
    float s = __fadd_rn(k.w, __fmul_rn(dx, dx));
    const float dy = __fsub_rn(q.y, k.y);
    s = __fadd_rn(s, __fmul_rn(dy, dy));
    const float dz = __fsub_rn(q.z, k.z);
    return __fadd_rn(s, __fmul_rn(dz, dz));
  }
};

// Expanded (K7): kn + (-2q).k with kn = ((x*x + y*y) + z*z) + w*w, the
// products summed x, y, z, w in order; the query comes scaled by -2 (exact).
// The w product is left out, and that is exact: the query's w is +-0, so
// (-2 q.w) k.w is +-0, and c + (+-0) differs from c at most in the sign of
// a zero c, which kn + c (kn >= +0) does not see.
struct Expanded {
  static constexpr bool bounded = true;
  static __device__ __forceinline__ float prepare(float4 k) {
    float s = __fmul_rn(k.x, k.x);
    s = __fadd_rn(s, __fmul_rn(k.y, k.y));
    s = __fadd_rn(s, __fmul_rn(k.z, k.z));
    return __fadd_rn(s, __fmul_rn(k.w, k.w));
  }
  static __device__ __forceinline__ float score(float4 q2, float4 k) {
    float c = __fmul_rn(q2.x, k.x);
    c = __fadd_rn(c, __fmul_rn(q2.y, k.y));
    c = __fadd_rn(c, __fmul_rn(q2.z, k.z));
    return __fadd_rn(k.w, c);
  }
  // The filter's bound, a product and 3 FMAs: kn (1 - 2^-19) + (-2q).k,
  // one rounding an op. With u = 2^-24, S = kn + (-2q).k exactly and M =
  // kn + sum |q2_i k_i| <= 2 kn + |q|^2 (Cauchy-Schwarz, kn >= |k|^2): the
  // score is within 4 u M of S (3 products, 3 sums) and the bound within
  // u kn + 3 u M of S - 32 u kn, so
  //   bound <= score + 7 u M + u kn - 32 u kn <= score + 7 u |q|^2 (1 + 4u).
  // A pair whose score is at most the K-th best s_K thus has a bound below
  // s_K + 2^-19 |q|^2 (``limit``, rounded up; 2^-120 more covers the
  // absolute error of ops in the subnormal range): the bound lets through
  // every pair the score would, and the score then decides as before.
  static __device__ __forceinline__ float bound(float4 q2, float4 k) {
    float r = __fmul_rn(k.w, 1.f - 0x1p-19f);
    r = __fmaf_rn(q2.x, k.x, r);
    r = __fmaf_rn(q2.y, k.y, r);
    return __fmaf_rn(q2.z, k.z, r);
  }
  // 2^-19 |q|^2 + 2^-120 from q2 = -2q (2^-19 |q|^2 = 2^-21 |q2|^2).
  static __device__ __forceinline__ float slack(float4 q2) {
    return 0x1p-21f * (q2.x * q2.x + q2.y * q2.y + q2.z * q2.z) + 0x1p-120f;
  }
  static __device__ __forceinline__ float limit(float worst, float slack) {
    return __fadd_ru(worst, slack);
  }
};

// (da, ia) before (db, ib): the order of the plain version's int64 keys.
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Ascending (distance, index) list of the K best candidates seen so far,
// in any order of arrival.
template <int K>
struct TopK {
  float d[K];
  int idx[K];

  // Every slot at (bound, INT_MAX): a candidate then enters iff its
  // distance is at most ``bound`` (+inf: any; the ball route's r^2: only
  // keys inside the ball), and a slot still at INT_MAX at the end is unfilled.
  __device__ __forceinline__ void init(float bound = INFINITY) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      d[j] = bound;
      idx[j] = INT_MAX;
    }
  }

  // The cheap filter of the scan: a candidate that fails it cannot enter.
  __device__ __forceinline__ bool admits(float dn) const { return dn <= d[K - 1]; }

  __device__ __forceinline__ void push(float dn, int in) {
    if (!before(dn, in, d[K - 1], idx[K - 1])) return;
    bool c[K];  // the candidate goes before slot j
#pragma unroll
    for (int j = 0; j < K - 1; ++j) c[j] = before(dn, in, d[j], idx[j]);
    c[K - 1] = true;
    // slot j takes its left neighbour while the candidate goes before that
    // neighbour, and the candidate at the first slot it goes before
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      if (c[j - 1]) {
        d[j] = d[j - 1];
        idx[j] = idx[j - 1];
      } else if (c[j]) {
        d[j] = dn;
        idx[j] = in;
      }
    }
    if (c[0]) {
      d[0] = dn;
      idx[0] = in;
    }
  }
};

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of key positions [first, first + n) into ``slab``: rows
// of the cloud by cp.async, virtual pad rows (at or past nk) written
// directly, already prepared. One commit group.
__device__ __forceinline__ void stage_async(float4* slab, const float4* __restrict__ keys,
                                            int nk, int first, int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    if (first + t < nk) {
      cp_async16(slab + t, keys + first + t);
    } else {
      slab[t] = make_float4(0.f, 0.f, 0.f, __fmul_rn(PAD_W, PAD_W));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// After the wait: prepare the w slot of the rows this thread copied (the
// same rows as stage_async's), once per key rather than per pair.
template <typename Score>
__device__ __forceinline__ void prepare_keys(float4* slab, int nk, int first, int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    if (first + t < nk) slab[t].w = Score::prepare(slab[t]);
  }
}

// The s-th of n items taken centre-out from c: c, c + 1, c - 1, c + 2,
// c - 2, ..., then the rest of the longer side.
__device__ __forceinline__ int centre_out(int s, int c, int n) {
  const int m = min(c, n - 1 - c);
  if (s <= 2 * m) return (s & 1) ? c + (s + 1) / 2 : c - s / 2;
  return n - 1 - c > c ? s : n - 1 - s;
}

// The filter of the scan. Without ``Score::bounded`` it is the list's own
// test on the score (``admits``). With it, a pair is first tested by the
// cheaper ``Score::bound`` (never above the score by more than the slack
// that ``Score::limit`` adds to the K-th best): only a pair that passes is
// scored and tested as before, so the same candidates reach the list.
template <typename Score, int K, int Q, bool = Score::bounded>
struct Gate {
  __device__ __forceinline__ Gate(const float4 (&)[Q], const TopK<K> (&)[Q]) {}
};

template <typename Score, int K, int Q>
struct Gate<Score, K, Q, true> {
  float lim[Q];  // Score::limit of each query's K-th best

  __device__ __forceinline__ Gate(const float4 (&qv)[Q], const TopK<K> (&top)[Q]) {
    update(qv, top);
  }

  // after insertions (the slack is recomputed: one register less a query)
  __device__ __forceinline__ void update(const float4 (&qv)[Q], const TopK<K> (&top)[Q]) {
#pragma unroll
    for (int j = 0; j < Q; ++j) lim[j] = Score::limit(top[j].d[K - 1], Score::slack(qv[j]));
  }
};

// A staged key read again inside the branch of admitted candidates: a
// volatile load, so the compiler keeps no copy of the key in registers
// across the filter, which would cost the scan's occupancy.
__device__ __forceinline__ float4 reload(const float4* key) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(key))));
  return v;
}

// Test staged position p against the thread's Q queries.
template <typename Score, int K, int Q>
__device__ __forceinline__ void visit(const float4* slab, int p, int base,
                                      const float4 (&qv)[Q], TopK<K> (&top)[Q],
                                      Gate<Score, K, Q>& gate) {
  const float4 kv = slab[p];
  float d[Q];
  bool hit = false;
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    if constexpr (Score::bounded) {
      d[j] = Score::bound(qv[j], kv);
      hit |= d[j] <= gate.lim[j];
    } else {
      d[j] = Score::score(qv[j], kv);
      hit |= top[j].admits(d[j]);
    }
  }
  if (hit) {
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      if constexpr (Score::bounded) {
        if (d[j] <= gate.lim[j]) {
          const float dn = Score::score(qv[j], reload(slab + p));
          if (top[j].admits(dn)) top[j].push(dn, base + p);
        }
      } else {
        if (top[j].admits(d[j])) top[j].push(d[j], base + p);
      }
    }
    if constexpr (Score::bounded) gate.update(qv, top);
  }
}

// Two positions at once: both keys' distances are computed before the one
// branch, which gives the scheduler 2 Q independent sums.
template <typename Score, int K, int Q>
__device__ __forceinline__ void visit2(const float4* slab, int pa, int pb, int base,
                                       const float4 (&qv)[Q], TopK<K> (&top)[Q],
                                       Gate<Score, K, Q>& gate) {
  const float4 ka = slab[pa];
  const float4 kb = slab[pb];
  float da[Q], db[Q];
  bool hit = false;
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    if constexpr (Score::bounded) {
      da[j] = Score::bound(qv[j], ka);
      db[j] = Score::bound(qv[j], kb);
      hit |= da[j] <= gate.lim[j] || db[j] <= gate.lim[j];
    } else {
      da[j] = Score::score(qv[j], ka);
      db[j] = Score::score(qv[j], kb);
      hit |= top[j].admits(da[j]) || top[j].admits(db[j]);
    }
  }
  if (hit) {
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      if constexpr (Score::bounded) {
        if (da[j] <= gate.lim[j]) {
          const float dn = Score::score(qv[j], reload(slab + pa));
          if (top[j].admits(dn)) top[j].push(dn, base + pa);
        }
        if (db[j] <= gate.lim[j]) {
          const float dn = Score::score(qv[j], reload(slab + pb));
          if (top[j].admits(dn)) top[j].push(dn, base + pb);
        }
      } else {
        if (top[j].admits(da[j])) top[j].push(da[j], base + pa);
        if (top[j].admits(db[j])) top[j].push(db[j], base + pb);
      }
    }
    if constexpr (Score::bounded) gate.update(qv, top);
  }
}

// Scan the n staged keys (global positions base + p) centre-out from the
// first one at or past the warp's centre x. ``cx`` is warp-uniform, so the
// whole warp reads one key at a time (a shared-memory broadcast).
template <typename Score, int K, int Q>
__device__ __forceinline__ void scan_slab(const float4* slab, int n, int base, float cx,
                                          const float4 (&qv)[Q], TopK<K> (&top)[Q]) {
  Gate<Score, K, Q> gate(qv, top);
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (slab[mid].x < cx) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int c = min(lo, n - 1);
  const int m = min(c, n - 1 - c);
  visit<Score>(slab, c, base, qv, top, gate);
#pragma unroll 2
  for (int s = 1; s <= m; ++s) visit2<Score>(slab, c + s, c - s, base, qv, top, gate);
  if (n - 1 - c > c) {
    int p = c + m + 1;
#pragma unroll 2
    for (; p + 1 < n; p += 2) visit2<Score>(slab, p, p + 1, base, qv, top, gate);
    if (p < n) visit<Score>(slab, p, base, qv, top, gate);
  } else {
    int p = c - m - 1;
#pragma unroll 2
    for (; p > 0; p -= 2) visit2<Score>(slab, p, p - 1, base, qv, top, gate);
    if (p == 0) visit<Score>(slab, 0, base, qv, top, gate);
  }
}

// The exact top-K of the thread's Q queries over ``win_len`` key positions
// from ``start`` (keys of this cloud; the block's dynamic shared memory is
// ``search_smem_bytes(win_len)``). ``tile_x`` is the tile's middle query x
// (the ring's first chunk), ``warp_x`` the warp's (its scan's centre);
// ``live`` is warp-uniform, and a warp that is not live stages and
// synchronises with the block but scans nothing. ``bound`` is the lists'
// first bound (``TopK::init``). Every thread of the block must call this.
template <typename Score, int K, int Q>
__device__ __forceinline__ void search_tile(float4* smem, const float4* __restrict__ keys,
                                            int nk, int start, int win_len, float tile_x,
                                            float warp_x, bool live, const float4 (&qv)[Q],
                                            TopK<K> (&top)[Q], float bound = INFINITY) {
#pragma unroll
  for (int j = 0; j < Q; ++j) top[j].init(bound);
  const int len = win_len <= STAGE_MAX ? win_len : RING;
  const int n_chunks = (win_len + len - 1) / len;
  // the ring starts at the last chunk whose first key lies at or left of
  // the tile's middle x (the count of such chunks after the first)
  int centre = 0;
  for (int c0 = 1; c0 < n_chunks; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const int p = start + c * len;
    centre += __syncthreads_count(c < n_chunks && p < nk && __ldg(&keys[p].x) <= tile_x);
  }
  int first = centre_out(0, centre, n_chunks) * len;
  stage_async(smem, keys, nk, start + first, min(len, win_len - first));
  for (int s = 0; s < n_chunks; ++s) {
    float4* slab = smem + (s & 1) * len;
    const int n = min(len, win_len - first);
    int next = 0;
    if (s + 1 < n_chunks) {
      next = centre_out(s + 1, centre, n_chunks) * len;
      stage_async(smem + ((s + 1) & 1) * len, keys, nk, start + next, min(len, win_len - next));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    prepare_keys<Score>(slab, nk, start + first, n);
    __syncthreads();
    if (live) scan_slab<Score, K, Q>(slab, n, start + first, warp_x, qv, top);
    __syncthreads();
    first = next;
  }
}

// This thread's Q query rows of the tile (``rows``, their queries ``qv``,
// and ``use``: below nq and inside ``qmask`` when one is given), the x of
// the tile's middle row and the warp's centre x (the mean x of its used
// queries, the same in every lane).
//
// Row t of the tile walk is query ``perm[t]`` of the cloud when a
// permutation is given (``perm``: the queries in x order, for clouds whose
// rows are not x-sorted), else query t; ``rows`` are the queries' own
// indices, so results go to their own rows. The tile's 256 rows are ranked
// by y, unused rows last, and the warp w takes ranks [32 Q w, 32 Q (w + 1)),
// rank 32 Q w + lane + 32 j to query j of a lane. A tile is x-ordered, so a
// warp's queries then lie in one band of y as well as x: a key near none of
// them fails the filter of every lane, and the warp seldom waits on an
// insertion that only a few of its lanes make. Unused rows fill whole
// warps, which skip the scan. ``scratch`` needs 512 words and is free again
// when this returns.
template <int Q>
__device__ __forceinline__ void tile_queries(float4* scratch, const float4* __restrict__ qb,
                                             const unsigned char* __restrict__ qmask, int nq,
                                             int tile, int (&rows)[Q], float4 (&qv)[Q],
                                             bool (&use)[Q], float& tile_x, float& warp_x,
                                             const int* __restrict__ perm = nullptr) {
  float* ys = reinterpret_cast<float*>(scratch);
  int* order = reinterpret_cast<int*>(ys + TILE_Q);
  const int row_base = tile * TILE_Q;
  // the query at row t of the walk (t itself past nq: an unused row)
  auto query_at = [&](int t) { return perm && t < nq ? perm[t] : t; };
  for (int i = threadIdx.x; i < TILE_Q; i += blockDim.x) {
    const int r = query_at(row_base + i);
    const float y = r < nq && (!qmask || qmask[r]) ? qb[r].y : INFINITY;
    ys[i] = isnan(y) ? INFINITY : y;
  }
  __syncthreads();
  // rank by (y, row): a permutation of the tile
  for (int i = threadIdx.x; i < TILE_Q; i += blockDim.x) {
    const float y = ys[i];
    int rank = 0;
#pragma unroll 8
    for (int t = 0; t < TILE_Q; ++t) {
      const float yt = ys[t];
      rank += yt < y || (yt == y && t < i);
    }
    order[rank] = i;
  }
  __syncthreads();
  const int first = (threadIdx.x >> 5) * 32 * Q + (threadIdx.x & 31);
  float sx = 0.f, n = 0.f;
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int r = query_at(row_base + order[first + 32 * j]);
    rows[j] = r;
    use[j] = r < nq && (!qmask || qmask[r]);
    qv[j] = r < nq ? qb[r] : make_float4(0.f, 0.f, 0.f, 0.f);
    if (use[j]) {
      sx += qv[j].x;
      n += 1.f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sx += __shfl_xor_sync(0xffffffffu, sx, o);
    n += __shfl_xor_sync(0xffffffffu, n, o);
  }
  tile_x = qb[query_at(min(row_base + TILE_Q / 2, nq - 1))].x;
  warp_x = __shfl_sync(0xffffffffu, n > 0.f ? sx / n : tile_x, 0);
  __syncthreads();  // the scratch is the window's staging buffer
}

// Let a search kernel take the largest block's shared memory, once
// per device (``ready`` holds a bit per device, one word per kernel): the
// attribute calls cost host time that a launch-sized search would pay on
// every call.
template <typename Kernel>
inline cudaError_t allow_search_smem(Kernel* kernel, std::atomic<unsigned long long>& ready) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (ready.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(search_smem_bytes(STAGE_MAX)));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) ready.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

}  // namespace m3d
