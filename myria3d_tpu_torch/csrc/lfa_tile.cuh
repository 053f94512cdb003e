// Shared edge tile of the fused LocalFeatureAggregation kernels K2 (lfa.cu,
// the eval forward) and K6 (lfa_train.cu, the train backward).
//
// Both compute the same core for every centre point i and neighbour slot k
// (index j = idx[i, k]; idx < 0 marks an invalid slot):
//   rel = [pos_i, pos_j, pos_j - pos_i, |pos_j - pos_i|]          (10)
//   lf  = [x_j, LeakyReLU_0.2(u(rel))]                           (C)
//   att = lf att_w                                              (C x C)
//   s   = softmax over the valid slots of each column of att
// K2 then pools, K6 differentiates (lfa_train.cu).
//
// Bound on the H100: the attention products, K C^2 FMAs per point. The
// TPU kernels ran them on the MXU at default precision (bf16 passes); here
// they run on the tensor cores in 3xTF32: each f32 operand v is split into
// hi = tf32(v) and lo = tf32(v - hi) (round to nearest, ties away), and
// hi*hi + hi*lo + lo*hi accumulate in f32 (mma.sync m16n8k8). The dropped
// lo*lo term is ~2^-22 of the product, so the result is of f32 grade
// (tests/myria3d_tpu_torch/test_torch_lfa_tf32.py shows one TF32 pass is
// not). The design around that:
//
// 1. An edge tile of P centre points x 16 slots (M = 16 P rows) is built
//    once in shared memory. Its gathers are cp.async copies: the x_j rows
//    straight into lf (16-byte pieces), pos_j and pos_i into a staging
//    buffer, all in flight together, with the indices staged one tile (or
//    two) ahead; K2 runs its gathers one tile ahead of its products, in a
//    second lf buffer, so their latency hides behind a tile's work. Then
//    rel per row, and the encoder half of lf with a fixed channel per
//    thread, its affine in registers. Slots past K and points past the
//    end read -1 and give zero rows.
// 2. One point's 16 slots are one m16 fragment. A warp's unit is one
//    point x 8 NT columns with three accumulator chains per n-tile (the
//    three products, so few n-tiles still overlap the mma latency); its
//    scores go through a small per-warp scratch, where each column's
//    masked softmax and pooling run down the 16 rows in one lane (or 2-4
//    lanes and 1-2 shuffles for narrow units), not as shuffles across the
//    fragment's 8 row lanes (2.5x fewer instructions at 32 columns).
// 3. att_w is held whole in shared memory when C <= 128 (staged once per
//    block by cp.async, 16-byte pieces); at C = 256 it streams through a
//    double-buffered pair of 32-column (or, for K6's transposed product,
//    32-row) slabs, the next slab's copy in flight during the current
//    one's products. Row strides of 4 (edge arrays) and 8 (column slabs)
//    floats past the width keep the fragment loads free of bank conflicts.
// 4. Blocks are persistent over a contiguous run of tiles, so the
//    resident att_w is read from L2 once per block, not per point.
// 5. K2 also reads 16-bit features (bfloat16 or float16 x, the compute
//    dtype of a 16-bit net): cp.async copies bytes unconverted, so those
//    x_j rows are loaded into registers (16 bytes, 8 values, a thread; 8
//    bytes at C_in = 4), widened to f32 and stored into the same f32 edge
//    tile. Everything after the tile is the f32 path's.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace m3d {
namespace lfa {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLOTS = 16;   // rows per centre point: one m16 fragment (K <= 16)
constexpr int REL_LD = 12;  // row stride of the rel rows (three float4)
constexpr float SLOPE = 0.2f;

// x's element type, an int template parameter (so that the kernels'
// instantiations are told apart by name): 0 float, 1 bfloat16, 2 float16;
// the 16-bit ones are read as raw uint16 and widened (widen2)
constexpr int X_F32 = 0, X_BF16 = 1, X_F16 = 2;
template <int XT>
struct XElem {
  using T = uint16_t;
};
template <>
struct XElem<X_F32> {
  using T = float;
};

// the two 16-bit values of a 32-bit word (the first in the low half) as f32
template <int XT>
__device__ __forceinline__ float2 widen2(uint32_t w) {
  if constexpr (XT == X_BF16) {
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
  } else {
    float lo, hi;
    asm("{\n\t.reg .b16 l, h;\n\tmov.b32 {l, h}, %2;\n\tcvt.f32.f16 %0, l;\n\t"
        "cvt.f32.f16 %1, h;\n\t}" : "=f"(lo), "=f"(hi) : "r"(w));
    return make_float2(lo, hi);
  }
}

// The block geometry at width C with P centre points per tile.
template <int C_, int P_>
struct Geo {
  static constexpr int C = C_, P = P_, CIN = C_ / 2;
  static constexpr int M = SLOTS * P;          // edge rows of a tile
  static constexpr int LD = C + 4;             // row stride of the edge arrays
  static constexpr bool RESIDENT = C <= 128;   // att_w held whole
  static constexpr int NS = RESIDENT ? C : 32; // slab width (columns or rows)
  static constexpr int SLABS = C / NS;
  static constexpr int LDC = NS + 8;           // row stride of a column slab
  static constexpr int LDR = RESIDENT ? LDC : C + 4;  // of a row slab
  static constexpr int WBUF = RESIDENT ? C * LDC : (C * LDC > NS * LDR ? C * LDC : NS * LDR);
  static constexpr int WFLOATS = RESIDENT ? WBUF : 2 * WBUF;
  static constexpr int PER_THREAD = M * C / THREADS;  // lf entries a thread builds
  static constexpr int ROW_STEP = THREADS / C;        // rows between them
  static_assert(THREADS % C == 0 && M <= THREADS && C % 8 == 0, "tile shape");
};

// ---- 3xTF32 on mma.sync m16n8k8

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// The same three products into three accumulators (d[0] the large term):
// three dependency chains instead of one, so a warp with few n-tiles still
// keeps the tensor core busy while an mma's result is in flight.
__device__ __forceinline__ void mma3(float (&d)[3][4], const FragA& a, const FragB& b) {
  mma(d[2], a.lo, b.hi);
  mma(d[1], a.hi, b.lo);
  mma(d[0], a.hi, b.hi);
}

// the product: d[0] + (d[1] + d[2])
__device__ __forceinline__ void fold3(float (&d)[3][4], float (&out)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = d[0][e] + (d[1][e] + d[2][e]);
}

__device__ __forceinline__ void zero3(float (&d)[3][4]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[q][e] = 0.f;
  }
}

// Fragment layouts (g = lane / 4, t = lane % 4): A (16 x 8) holds (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8) holds (k = t, n = g),
// (t + 4, g); the f32 accumulator (16 x 8) holds (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).

// A with element (m, k) at base[m * ld + k]
__device__ __forceinline__ FragA load_a(const float* base, int ld, int g, int t) {
  FragA f;
  split(base[g * ld + t], f.hi[0], f.lo[0]);
  split(base[(g + 8) * ld + t], f.hi[1], f.lo[1]);
  split(base[g * ld + t + 4], f.hi[2], f.lo[2]);
  split(base[(g + 8) * ld + t + 4], f.hi[3], f.lo[3]);
  return f;
}

// A with element (m, k) at base[k * ld + m]; rows m >= 8 read as 0 unless
// ``upper`` (a width-8 operand padded to 16 rows)
__device__ __forceinline__ FragA load_at(const float* base, int ld, int g, int t, bool upper) {
  FragA f;
  split(base[t * ld + g], f.hi[0], f.lo[0]);
  split(base[(t + 4) * ld + g], f.hi[2], f.lo[2]);
  if (upper) {
    split(base[t * ld + g + 8], f.hi[1], f.lo[1]);
    split(base[(t + 4) * ld + g + 8], f.hi[3], f.lo[3]);
  } else {
    f.hi[1] = f.lo[1] = f.hi[3] = f.lo[3] = 0u;
  }
  return f;
}

// B with element (k, n) at base[k * ldk + n * ldn]
__device__ __forceinline__ FragB load_b(const float* base, int ldk, int ldn, int g, int t) {
  FragB f;
  split(base[t * ldk + g * ldn], f.hi[0], f.lo[0]);
  split(base[(t + 4) * ldk + g * ldn], f.hi[1], f.lo[1]);
  return f;
}

// B from operands split beforehand (split_resident): hi and lo arrays
__device__ __forceinline__ FragB load_b_split(const float* hi, const float* lo, int ldk, int ldn,
                                              int g, int t) {
  FragB f;
  f.hi[0] = __float_as_uint(hi[t * ldk + g * ldn]);
  f.lo[0] = __float_as_uint(lo[t * ldk + g * ldn]);
  f.hi[1] = __float_as_uint(hi[(t + 4) * ldk + g * ldn]);
  f.lo[1] = __float_as_uint(lo[(t + 4) * ldk + g * ldn]);
  return f;
}

// ---- cp.async staging

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Start the copy of tile ``tile``'s neighbour indices into sidx (M ints,
// row p * 16 + slot); slots past k and points past n_points read -1.
// sbase (P ints) gets each point's first row of its cloud.
template <class G>
__device__ __forceinline__ void stage_idx(int* sidx, int* sbase, const int* __restrict__ idx,
                                          long long tile, long long n_points, int k, int n) {
  for (int r = threadIdx.x; r < G::M; r += THREADS) {
    const long long gp = tile * G::P + r / SLOTS;
    const int kk = r % SLOTS;
    if (kk < k && gp < n_points) {
      cp_async4(sidx + r, idx + gp * k + kk);
    } else {
      sidx[r] = -1;
    }
  }
  for (int p = threadIdx.x; p < G::P; p += THREADS) {
    const long long gp = tile * G::P + p;
    sbase[p] = gp < n_points ? static_cast<int>((gp / n) * n) : 0;
  }
  commit();
}

// The x_j rows of a 16-bit x into lf's first C_in columns as f32: every
// thread first loads its pieces (V values, 16 bytes at V = 8; zero bits at
// invalid slots read as 0.0), then widens and stores them.
template <class G, int XT>
__device__ __forceinline__ void load_x16(float* lf, const int* sidx, const int* sbase,
                                         const uint16_t* __restrict__ x) {
  constexpr int V = G::CIN < 8 ? G::CIN : 8;
  constexpr int W = V / 2;  // 32-bit words a piece
  constexpr int Q = G::CIN / V;
  constexpr int ITERS = (G::M * Q + THREADS - 1) / THREADS;
  static_assert(V == 4 || V == 8, "16-bit x rows in 8- or 16-byte pieces");
  uint32_t raw[ITERS][W];
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / Q, q = e - r * Q;
    const int j = e < G::M * Q ? sidx[r] : -1;
#pragma unroll
    for (int w = 0; w < W; ++w) raw[i][w] = 0u;
    if (j >= 0) {
      const uint16_t* src = x + (static_cast<long long>(sbase[r / SLOTS]) + j) * G::CIN + V * q;
      if constexpr (V == 8) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
        raw[i][0] = v.x, raw[i][1] = v.y, raw[i][2] = v.z, raw[i][3] = v.w;
      } else {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
        raw[i][0] = v.x, raw[i][1] = v.y;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (e < G::M * Q) {
      const int r = e / Q, q = e - r * Q;
      float4* dst = reinterpret_cast<float4*>(lf + r * G::LD + V * q);
#pragma unroll
      for (int h = 0; h < W / 2; ++h) {
        const float2 a = widen2<XT>(raw[i][2 * h]), b = widen2<XT>(raw[i][2 * h + 1]);
        dst[h] = make_float4(a.x, a.y, b.x, b.y);
      }
    }
  }
}

// Start the tile's gathers, once its indices have landed: the x_j rows
// into lf's first C_in columns (f32 x: cp.async copies of 16-byte pieces,
// zero rows at invalid slots; 16-bit x: load_x16, which has landed when it
// returns), pos_j into spos rows 0..M-1 and pos_i into rows M..M+P-1
// (float4 rows). B n < 2^31 rows.
template <class G, int XT = X_F32>
__device__ __forceinline__ void stage_gathers(float* lf, float* spos, const int* sidx,
                                              const int* sbase,
                                              const typename XElem<XT>::T* __restrict__ x,
                                              const float* __restrict__ pos, long long tile,
                                              long long n_points) {
  if constexpr (XT == X_F32) {
    constexpr int Q = G::CIN / 4;
    for (int e = threadIdx.x; e < G::M * Q; e += THREADS) {
      const int r = e / Q, q = e - r * Q;
      const int j = sidx[r];
      float* dst = lf + r * G::LD + 4 * q;
      if (j >= 0) {
        cp_async16(dst, x + (static_cast<long long>(sbase[r / SLOTS]) + j) * G::CIN + 4 * q);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    load_x16<G, XT>(lf, sidx, sbase, x);
  }
  for (int r = threadIdx.x; r < G::M; r += THREADS) {
    const int j = sidx[r];
    if (j >= 0) {
      const float* src = pos + (static_cast<long long>(sbase[r / SLOTS]) + j) * 3;
#pragma unroll
      for (int d = 0; d < 3; ++d) cp_async4(spos + r * 4 + d, src + d);
    }
  }
  for (int p = threadIdx.x; p < G::P; p += THREADS) {
    const long long gp = tile * G::P + p;
    if (gp < n_points) {
#pragma unroll
      for (int d = 0; d < 3; ++d) cp_async4(spos + (G::M + p) * 4 + d, pos + gp * 3 + d);
    }
  }
  commit();
}

// Start the copy of att_w's columns [o0, o0 + NS) (att_w is C x C,
// row-major): dst[c * LDC + o - o0].
template <class G>
__device__ __forceinline__ void stage_cols(float* dst, const float* __restrict__ w, int o0) {
  constexpr int Q = G::NS / 4;
  for (int e = threadIdx.x; e < G::C * Q; e += THREADS) {
    const int c = e / Q, q = e - c * Q;
    cp_async16(dst + c * G::LDC + 4 * q, w + c * G::C + o0 + 4 * q);
  }
  commit();
}

// Start the copy of att_w's rows [c0, c0 + NS): dst[(c - c0) * LDR + o].
template <class G>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ w, int c0) {
  constexpr int Q = G::C / 4;
  for (int e = threadIdx.x; e < G::NS * Q; e += THREADS) {
    const int r = e / Q, q = e - r * Q;
    cp_async16(dst + r * G::LDR + 4 * q, w + (c0 + r) * G::C + 4 * q);
  }
  commit();
}

// Split a resident att_w (staged and landed) into its TF32 halves once per
// block: w keeps hi, lo gets lo, so the products load B without
// converting it (K2, where the second copy fits).
template <class G>
__device__ __forceinline__ void split_resident(float* w, float* lo) {
  for (int e = threadIdx.x; e < G::WBUF; e += THREADS) {
    uint32_t h, l;
    split(w[e], h, l);
    w[e] = __uint_as_float(h);
    lo[e] = __uint_as_float(l);
  }
}

// ---- the edge tile

// The encoder affine of one channel: a . rel + c.
struct Affine {
  float a[10];
  float c;

  __device__ __forceinline__ void load(const float* __restrict__ w, const float* __restrict__ b,
                                       int row) {
#pragma unroll
    for (int r = 0; r < 10; ++r) a[r] = w[row * 10 + r];
    c = b[row];
  }

  __device__ __forceinline__ float operator()(const float* rel) const {
    const float4 p = reinterpret_cast<const float4*>(rel)[0];
    const float4 q = reinterpret_cast<const float4*>(rel)[1];
    const float4 s = reinterpret_cast<const float4*>(rel)[2];
    return c + a[0] * p.x + a[1] * p.y + a[2] * p.z + a[3] * p.w + a[4] * q.x + a[5] * q.y +
           a[6] * q.z + a[7] * q.w + a[8] * s.x + a[9] * s.y;
  }
};

// rel rows of the tile from the staged positions (zeros at invalid slots)
template <class G>
__device__ __forceinline__ void build_rel(float* srel, const int* sidx, const float* spos) {
  for (int r = threadIdx.x; r < G::M; r += THREADS) {
    float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f), v1 = v0, v2 = v0;
    if (sidx[r] >= 0) {
      const float4 pi = reinterpret_cast<const float4*>(spos)[G::M + r / SLOTS];
      const float4 pj = reinterpret_cast<const float4*>(spos)[r];
      const float dx = pj.x - pi.x, dy = pj.y - pi.y, dz = pj.z - pi.z;
      v0 = make_float4(pi.x, pi.y, pi.z, pj.x);
      v1 = make_float4(pj.y, pj.z, dx, dy);
      v2 = make_float4(dz, sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 0.f)), 0.f, 0.f);
    }
    float4* dst = reinterpret_cast<float4*>(srel + r * REL_LD);
    dst[0] = v0;
    dst[1] = v1;
    dst[2] = v2;
  }
}

// The encoder half of the lf rows, LeakyReLU(u(rel)) (0 at invalid rows),
// for encoder channel ``ce`` of the thread: with ALL, every thread builds
// channel threadIdx.x % C_in; else the threads with threadIdx.x % C >= C_in
// build channel threadIdx.x % C - C_in (K6's layout of its d(lf) pass).
template <class G, bool ALL, class U>
__device__ __forceinline__ void build_enc(float* lf, const int* sidx, const float* srel,
                                          const U& u) {
  constexpr int STEP = ALL ? THREADS / G::CIN : G::ROW_STEP;
  constexpr int PER = ALL ? G::M * G::CIN / THREADS : G::PER_THREAD;
  const int ce = ALL ? threadIdx.x % G::CIN : threadIdx.x % G::C - G::CIN;
  if (ce < 0) return;
  const int r0 = ALL ? threadIdx.x / G::CIN : threadIdx.x / G::C;
#pragma unroll 4
  for (int i = 0; i < PER; ++i) {
    const int r = r0 + i * STEP;
    float v = 0.f;
    if (sidx[r] >= 0) {
      v = u(srel + r * REL_LD);
      v = v >= 0.f ? v : SLOPE * v;
    }
    lf[r * G::LD + G::CIN + ce] = v;
  }
}

// How a warp's softmax covers one unit (one point's 16 slots x 8 NT
// columns): the unit's scores go to the warp's scratch (16 rows of SLD
// floats), then LPC lanes share each column, RPL rows a lane.
template <int NT>
struct Cols {
  static constexpr int COLS = 8 * NT, LPC = 32 / COLS, RPL = SLOTS / LPC, SLD = COLS + 4;
  static constexpr int SCRATCH = WARPS * SLOTS * SLD;  // floats a block needs
};

// Product 1 and the masked softmax over columns [cbeg, cbeg + width) of
// the tile in lf (sidx: rows' neighbour rows, < 0 invalid). ``step``
// counts the tile's slab steps so far (streamed att_w: the slab in wbuf's
// half step & 1 was started before); after the last column slab the copy
// of row slab 0 starts if ``rows_next``. For each unit and each of its
// columns, the LPC lanes that share the column call epi(p, col, part, e,
// inv, pooled): the softmax of row r is e[r * SLD] * inv for the lane's
// rows r in [part RPL, part RPL + RPL), pooled = sum_k s[k] lf[k][col]. An
// all-invalid column gives s = 0 and pooled = 0 (masked_softmax). Returns
// the step count. With SPLIT_W, a resident att_w was split by
// split_resident (lo at wbuf + WBUF).
template <class G, int NT, bool SPLIT_W, class Epi>
__device__ __forceinline__ int attention_pass(const float* lf, const int* sidx, float* wbuf,
                                              float* scratch, const float* __restrict__ att_w,
                                              int cbeg, int width, int step, bool rows_next,
                                              const Epi& epi) {
  using K = Cols<NT>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cl = lane % K::COLS, part = lane / K::COLS;
  float* ws = scratch + warp * SLOTS * K::SLD;
  const int steps = G::RESIDENT ? 1 : width / G::NS;
  for (int si = 0; si < steps; ++si, ++step) {
    const float* w = wbuf;
    int c0 = cbeg, wcol0 = 0, wd = width;
    if (!G::RESIDENT) {
      wait_all();
      __syncthreads();
      w = wbuf + (step & 1) * G::WBUF;
      c0 = cbeg + si * G::NS;
      wcol0 = c0;
      wd = G::NS;
      float* next = wbuf + ((step + 1) & 1) * G::WBUF;
      if (si + 1 < steps) {
        stage_cols<G>(next, att_w, c0 + G::NS);
      } else if (rows_next) {
        stage_rows<G>(next, att_w, 0);
      }
    }
    const int groups = wd / K::COLS;
    for (int u = warp; u < G::P * groups; u += WARPS) {
      const int p = u / groups;
      const int col = c0 + (u - p * groups) * K::COLS;
      const float* la = lf + p * SLOTS * G::LD;
      float acc[NT][3][4];
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) zero3(acc[jn]);
#pragma unroll 4
      for (int kb = 0; kb < G::C; kb += 8) {
        const FragA a = load_a(la + kb, G::LD, g, t);
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          const int off = kb * G::LDC + col - wcol0 + 8 * jn;
          const FragB b = SPLIT_W ? load_b_split(w + off, w + G::WBUF + off, G::LDC, 1, g, t)
                                  : load_b(w + off, G::LDC, 1, g, t);
          mma3(acc[jn], a, b);
        }
      }
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        float v[4];
        fold3(acc[jn], v);
        *reinterpret_cast<float2*>(ws + g * K::SLD + 8 * jn + 2 * t) = make_float2(v[0], v[1]);
        *reinterpret_cast<float2*>(ws + (g + 8) * K::SLD + 8 * jn + 2 * t) = make_float2(v[2], v[3]);
      }
      const unsigned valid = __ballot_sync(0xffffffffu, lane < SLOTS && sidx[p * SLOTS + (lane & 15)] >= 0);
      __syncwarp();
      const int r0 = part * K::RPL;
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < K::RPL; ++i) {
        if ((valid >> (r0 + i)) & 1u) m = fmaxf(m, ws[(r0 + i) * K::SLD + cl]);
      }
#pragma unroll
      for (int off = K::COLS; off < 32; off <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float sum = 0.f, pl = 0.f;
#pragma unroll
      for (int i = 0; i < K::RPL; ++i) {
        const int r = r0 + i;
        const float e = ((valid >> r) & 1u) ? __expf(ws[r * K::SLD + cl] - m) : 0.f;
        ws[r * K::SLD + cl] = e;
        sum += e;
        pl += e * la[r * G::LD + col + cl];
      }
#pragma unroll
      for (int off = K::COLS; off < 32; off <<= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
        pl += __shfl_xor_sync(0xffffffffu, pl, off);
      }
      const float inv = 1.f / fmaxf(sum, 1e-16f);
      epi(p, col + cl, part, ws + cl, inv, pl * inv);
      __syncwarp();  // the next unit rewrites the scratch
    }
  }
  return step;
}

// ---- launch set-up, once per kernel and device

struct Prepared {
  std::atomic<unsigned long long> ready{0};
  int blocks_per_sm[64];
  int sms[64];
};

// Let ``kernel`` take ``smem`` bytes of dynamic shared memory and read its
// occupancy and the device's SM count; the attribute and occupancy calls
// cost host time, so they run once per device (``st`` is the kernel's).
template <typename Kernel>
inline cudaError_t prepare(Kernel* kernel, int smem, Prepared& st, int& blocks_per_sm, int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (st.ready.load(std::memory_order_acquire) & bit) {
    blocks_per_sm = st.blocks_per_sm[dev];
    sms = st.sms[dev];
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
  if (bit) {
    st.blocks_per_sm[dev] = blocks_per_sm;
    st.sms[dev] = sms;
    st.ready.fetch_or(bit, std::memory_order_release);
  }
  return cudaSuccess;
}

}  // namespace lfa
}  // namespace m3d
