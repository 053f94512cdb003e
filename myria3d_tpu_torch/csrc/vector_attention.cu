// K9: one eval-mode Point Transformer vector-attention layer (PTv1).
//
// Replaces no TPU kernel: the JAX package has no Point Transformer. It
// takes the place of the ~20 torch passes of VectorAttention.forward over
// (B, N, K, C) edge tensors (models/modules/point_transformer.py). For
// each query point i (row gp of the batch) and each valid slot j of the
// stage's graph (neighbour row nb = idx[gp, j] of the same cloud):
//   h = ReLU(BN0(Lp0 rel))               rel = p_j - p_i       (3 -> 3)
//   r = Lp1 h                                                    (3 -> C)
//   t = ReLU(BN1((k_nb - q_i) + r))
//   u = ReLU(BN2(Lw0 t))                                         (C -> N = C / s)
//   w = Lw1 u                                                    (N -> N)
//   a = softmax of w over the valid slots, a column at a time
//   y_c = sum_j (v_nb + r)_c a_j[c % N]  (the N weights shared by the s groups)
// A query with no valid slot (a pad query) gives y = 0. Only y (B, N, C)
// is written: every intermediate stays in shared memory or registers.
//
// The arithmetic is the torch composition's, operation for operation, so
// that the output is the same float32 values: a Linear sums its products
// with FMAs in input order from 0 and adds its bias last (cuBLAS's FFMA
// kernels at these shapes); an eval BatchNorm is ((x - mean) * inv) *
// weight + bias with inv = rsqrt(var + eps) computed by torch, each step
// rounded (no contraction); the softmax divides exp(w - max) by the sum in
// slot order; the sum over the slots keeps four partial sums, slot j in
// partial j % 4, added as ((s0 + s1) + s2) + s3 (torch's reduction over
// dim 2 at these shapes). Folding the BatchNorms into the Linears moves
// the net's float16 logits off the reference's (a share of 0.0069 of
// them at one seed, against a limit of 0.005).
//
// Bound on the H100: at stages 1-2 (C <= 64) the gathers of the k and v
// rows (L2 traffic of K rows a query, 2 K C 4 bytes) and the q, k, v, y
// bytes; from stage 3 on the product t Lw0, K C N FMAs a query (~1.6 G a
// layer). Design:
// 1. A block takes a tile of P queries, R = P K edge rows, and keeps the
//    tile's t rows (R x C, row stride C + 1: a product reads a column a
//    row per lane without bank conflicts), u and w (R x N) and each row's
//    h (4 floats) and neighbour row in shared memory. P is chosen so that
//    the t tile is ~33 KB at every width (R C = 8192 floats).
// 2. Gathers (the t build and the weighted sum) map a thread to a fixed
//    channel of consecutive rows: each warp reads 128 contiguous bytes of
//    a k or v row. A thread issues the loads of 16 rows (the t build) or
//    of all its slots (the sum, 32 values) before it uses them, invalid
//    slots reading row 0, so that they are in flight together; the tile's
//    q rows are staged once beside the graph's indices. r is recomputed in
//    the sum from the row's h (the same operations) rather than stored.
// 3. Lw0 (C x N, transposed) and Lw1 stay in shared memory for the block's
//    life: blocks are persistent over tiles (grid = what fits at once), so
//    the parameters are read from L2 once a block. A product thread owns
//    one row and four columns: a float4 of Lw0 and one t value a step, FP32
//    FMAs.
// 4. The softmax takes TPP lanes a (query, column) pair (2 or 4), which
//    share its maximum, exponentials and divisions; one lane sums.
// 5. Each tile's graph rows, offsets and q values are fetched into
//    registers while the tile before runs.
#include "lfa_tile.cuh"

namespace m3d {
namespace va {

constexpr int THREADS = lfa::THREADS;

// Offsets (floats) of the packed parameters
// (ops/cuda_vector_attention.py::pack): Lp0's weight (3 x 3, row-major)
// and bias, BN0's mean, inv, weight and bias (3 each), Lp1's weight
// transposed (3 x C) and bias, BN1's four (C each), Lw0's weight
// transposed (C x N) and bias, BN2's four (N each), Lw1's weight
// transposed (N x N) and bias.
template <int C, int N>
struct Params {
  static constexpr int P0 = 0, PB0 = 9, BN0 = 12, WP1 = 24, BP1 = WP1 + 3 * C, BN1 = BP1 + C,
                       W0 = BN1 + 4 * C, B0 = W0 + C * N, BN2 = B0 + N, W1 = BN2 + 4 * N,
                       B1 = W1 + N * N, SIZE = B1 + N;
  static_assert(W0 % 4 == 0 && W1 % 4 == 0 && B0 % 4 == 0, "16-byte aligned pieces");
};

// The block geometry at width C, K slots, N = C / s weights, P queries a tile.
template <int C_, int K_, int N_, int P_>
struct Geo {
  static constexpr int C = C_, K = K_, N = N_, P = P_, R = P * K;
  static constexpr int LDT = C + 1, LDU = N + 1;
  static constexpr int CW = C < THREADS ? C : THREADS;  // threads a row in the gathers
  static constexpr int RPP = THREADS / CW;              // rows a pass in the gathers
  static constexpr int CPT = C / CW;                    // channels a thread
  static constexpr int QT = P / RPP;                    // queries a thread in the sum
  static constexpr int CH = 16;                         // rows a thread loads at once
  static constexpr int QPT = P * C / THREADS;           // q values a thread stages
  static constexpr int NG = N / 4;                      // column quads of a product
  static constexpr int RG = THREADS / NG;               // rows a pass of a product
  static constexpr int TPP = THREADS / (P * N);         // threads a softmax column
  static constexpr int SPT = K / TPP;                   // its slots a thread
  // shared memory (floats): Lw0 and Lw1 (16-byte aligned), then Lw0's bias,
  // BN2's four and Lw1's bias (N each, as packed), then the tile: q rows, t,
  // u, w, h, neighbour rows
  static constexpr int S_W0 = 0, S_W1 = C * N, S_VEC = S_W1 + N * N, S_Q = S_VEC + 6 * N,
                       S_T = S_Q + P * C, S_U = S_T + R * LDT, S_A = S_U + R * LDU,
                       S_H = S_A + R * LDU, S_IDX = S_H + R * 4, FLOATS = S_IDX + R;
  static constexpr int SMEM = FLOATS * 4;
  static_assert(THREADS % CW == 0 && C % CW == 0 && P % RPP == 0 && (R / RPP) % CH == 0,
                "gathers");
  static_assert(N % 4 == 0 && THREADS % NG == 0 && R % RG == 0, "products");
  static_assert(R <= THREADS && P * C % THREADS == 0, "a thread's row of the graph");
  static_assert(P * N * TPP == THREADS && K % TPP == 0 && 32 % TPP == 0, "softmax");
  static_assert(SMEM <= 232448, "K9 block fits the SM's shared memory");
};

// An eval BatchNorm as torch computes it: ((x - mean) * inv) * weight + bias.
__device__ __forceinline__ float bn(float x, float mean, float inv, float w, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), inv), w), b);
}

// A Linear's output from 3 inputs: FMAs in input order from 0, the bias last.
__device__ __forceinline__ float lin3(float x0, float x1, float x2, float w0, float w1, float w2,
                                      float b) {
  return __fadd_rn(fmaf(x2, w2, fmaf(x1, w1, __fmul_rn(x0, w0))), b);
}

// out[r][n] = bias[n] + sum_c a[r][c] b[c][n] for the tile's R rows, then
// with BN (bnp: the BatchNorm's mean, inv, weight and bias, N each) and a
// ReLU: a (R x KD, row stride LDA), b (KD x N, row-major, 16-byte
// aligned), out (row stride LDU); each thread one row of a pass and four
// columns, the rows running fastest across the threads (a warp reads few
// distinct quads of b: one or two wavefronts a step with a's).
template <class G, int KD, int LDA, bool BN>
__device__ __forceinline__ void product(const float* a, const float* b, const float* bias,
                                        const float* bnp, float* out) {
  const int rg = threadIdx.x % G::RG, cg = threadIdx.x / G::RG;
  for (int r = rg; r < G::R; r += G::RG) {
    const float* ar = a + r * LDA;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int c = 0; c < KD; ++c) {
      const float x = ar[c];
      const float4 w = *reinterpret_cast<const float4*>(b + c * G::N + 4 * cg);
      acc[0] = fmaf(x, w.x, acc[0]);
      acc[1] = fmaf(x, w.y, acc[1]);
      acc[2] = fmaf(x, w.z, acc[2]);
      acc[3] = fmaf(x, w.w, acc[3]);
    }
    float* o = out + r * G::LDU + 4 * cg;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * cg + e;
      float v = __fadd_rn(acc[e], bias[n]);
      if (BN) v = fmaxf(bn(v, bnp[n], bnp[G::N + n], bnp[2 * G::N + n], bnp[3 * G::N + n]), 0.f);
      o[e] = v;
    }
  }
}

// Stage n floats (a multiple of 4, both ends 16-byte aligned) into shared memory.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n) {
  for (int e = threadIdx.x; e < n / 4; e += THREADS) {
    reinterpret_cast<float4*>(dst)[e] = __ldg(reinterpret_cast<const float4*>(src) + e);
  }
}

// A tile's inputs of step 0, fetched into registers a tile ahead: its q
// values (QPT a thread) and the thread's edge row (row threadIdx.x < R):
// validity, neighbour index, offset. Every load is unconditional (element
// 0 stands in), and nothing reads them until the tile starts, so they are
// in flight while the tile before runs.
template <class G>
struct Ahead {
  float q[G::QPT];
  float rel[3];
  int nb;
  unsigned char ok;

  __device__ __forceinline__ void fetch(const float* __restrict__ qx, const int* __restrict__ idx,
                                        const unsigned char* __restrict__ valid,
                                        const float* __restrict__ rl, long long tile,
                                        long long n_points, int k) {
    const long long q0 = tile * G::P;
#pragma unroll
    for (int e = 0; e < G::QPT; ++e) {
      const long long at = q0 * G::C + threadIdx.x + e * THREADS;
      q[e] = __ldg(qx + (at < n_points * G::C ? at : 0));
    }
    const long long gp = q0 + threadIdx.x / G::K;
    const int j = threadIdx.x % G::K;
    const long long e = threadIdx.x < G::R && gp < n_points && j < k ? gp * k + j : 0;
    ok = __ldg(valid + e);
    nb = __ldg(idx + e);
#pragma unroll
    for (int d = 0; d < 3; ++d) rel[d] = __ldg(rl + 3 * e + d);
  }
};

}  // namespace va

template <int C, int K, int N, int P>
__global__ void __launch_bounds__(va::THREADS, C <= 128 ? 4 : (C <= 256 ? 2 : 1))
    vector_attention_kernel(const float* __restrict__ q, const float* __restrict__ kx,
                            const float* __restrict__ vx, const int* __restrict__ idx,
                            const unsigned char* __restrict__ valid,
                            const float* __restrict__ rel, const float* __restrict__ prm, int n,
                            long long n_points, int k, float* __restrict__ y) {
  using G = va::Geo<C, K, N, P>;
  using L = va::Params<C, N>;
  extern __shared__ __align__(16) float smem[];
  float* s_w0 = smem + G::S_W0;
  float* s_w1 = smem + G::S_W1;
  float* s_vec = smem + G::S_VEC;  // Lw0's bias, BN2's four, Lw1's bias
  float* s_q = smem + G::S_Q;
  float* s_t = smem + G::S_T;
  float* s_u = smem + G::S_U;
  float* s_a = smem + G::S_A;
  float* s_h = smem + G::S_H;
  int* s_idx = reinterpret_cast<int*>(smem + G::S_IDX);

  va::stage(s_w0, prm + L::W0, C * N);
  va::stage(s_w1, prm + L::W1, N * N);
  va::stage(s_vec, prm + L::B0, 5 * N);
  va::stage(s_vec + 5 * N, prm + L::B1, N);
  // the thread's channels in the gathers: cl + e CW, e < CPT, with Lp1's
  // row and bias of each
  const int cl = threadIdx.x % G::CW, ro = threadIdx.x / G::CW;
  float wp0[G::CPT], wp1[G::CPT], wp2[G::CPT], bp[G::CPT];
#pragma unroll
  for (int e = 0; e < G::CPT; ++e) {
    const int c = cl + e * G::CW;
    wp0[e] = prm[L::WP1 + c], wp1[e] = prm[L::WP1 + C + c], wp2[e] = prm[L::WP1 + 2 * C + c];
    bp[e] = prm[L::BP1 + c];
  }
  const long long n_tiles = (n_points + P - 1) / P;
  va::Ahead<G> ahead;
  ahead.fetch(q, idx, valid, rel, blockIdx.x, n_points, k);

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long q0 = tile * P;
    // 0. the tile's q rows, and each edge row's neighbour row (-1: invalid)
    // and position hidden h, from the values fetched ahead; then the next
    // tile's fetch starts
#pragma unroll
    for (int e = 0; e < G::QPT; ++e) s_q[threadIdx.x + e * va::THREADS] = ahead.q[e];
    if (threadIdx.x < G::R) {
      const int r = threadIdx.x;
      const long long gp = q0 + r / K;
      const bool use = gp < n_points && r % K < k && ahead.ok;
      float h[3] = {0.f, 0.f, 0.f};
      if (use) {
#pragma unroll
        for (int o = 0; o < 3; ++o) {
          const float x = va::lin3(ahead.rel[0], ahead.rel[1], ahead.rel[2], prm[L::P0 + 3 * o],
                                   prm[L::P0 + 3 * o + 1], prm[L::P0 + 3 * o + 2],
                                   prm[L::PB0 + o]);
          h[o] = fmaxf(va::bn(x, prm[L::BN0 + o], prm[L::BN0 + 3 + o], prm[L::BN0 + 6 + o],
                              prm[L::BN0 + 9 + o]),
                       0.f);
        }
      }
      s_idx[r] = use ? static_cast<int>((gp / n) * n + ahead.nb) : -1;
      s_h[4 * r] = h[0], s_h[4 * r + 1] = h[1], s_h[4 * r + 2] = h[2];
    }
    __syncthreads();
    ahead.fetch(q, idx, valid, rel, tile + gridDim.x, n_points, k);
    // 1. the t rows: k gathered, q, r; CH rows' loads in flight at once (an
    // invalid row reads row 0)
    {
      float m1[G::CPT], i1[G::CPT], g1[G::CPT], b1[G::CPT];
#pragma unroll
      for (int e = 0; e < G::CPT; ++e) {
        const int c = cl + e * G::CW;
        m1[e] = __ldg(prm + L::BN1 + c), i1[e] = __ldg(prm + L::BN1 + C + c);
        g1[e] = __ldg(prm + L::BN1 + 2 * C + c), b1[e] = __ldg(prm + L::BN1 + 3 * C + c);
      }
#pragma unroll 1
      for (int i0 = 0; i0 < G::R / G::RPP; i0 += G::CH) {
        int rows[G::CH];
        float kv[G::CH][G::CPT];
#pragma unroll
        for (int i = 0; i < G::CH; ++i) {
          rows[i] = s_idx[ro + (i0 + i) * G::RPP];
          const float* kr = kx + static_cast<long long>(rows[i] >= 0 ? rows[i] : 0) * C;
#pragma unroll
          for (int e = 0; e < G::CPT; ++e) kv[i][e] = __ldg(kr + cl + e * G::CW);
        }
#pragma unroll
        for (int i = 0; i < G::CH; ++i) {
          const int r = ro + (i0 + i) * G::RPP;
          const float h0 = s_h[4 * r], h1 = s_h[4 * r + 1], h2 = s_h[4 * r + 2];
#pragma unroll
          for (int e = 0; e < G::CPT; ++e) {
            const float rr = va::lin3(h0, h1, h2, wp0[e], wp1[e], wp2[e], bp[e]);
            const float x = __fadd_rn(__fsub_rn(kv[i][e], s_q[(r / K) * C + cl + e * G::CW]), rr);
            const float t = fmaxf(va::bn(x, m1[e], i1[e], g1[e], b1[e]), 0.f);
            s_t[r * G::LDT + cl + e * G::CW] = rows[i] >= 0 ? t : 0.f;
          }
        }
      }
    }
    __syncthreads();
    // 2. u = ReLU(BN2(t Lw0 + b0)), w = u Lw1 + b1
    va::product<G, C, G::LDT, true>(s_t, s_w0, s_vec, s_vec + N, s_u);
    __syncthreads();
    va::product<G, N, G::LDU, false>(s_u, s_w1, s_vec + 5 * N, nullptr, s_a);
    __syncthreads();
    // 3. the softmax of each (query, column) over its valid slots: TPP
    // lanes a column, SPT slots each, for the max, the exponentials and the
    // divisions; the column's first lane sums in slot order
    {
      const int pr = threadIdx.x / G::TPP, part = threadIdx.x % G::TPP;
      const int p = pr / N, m = pr % N;
      float* col = s_a + p * K * G::LDU + m;
      const int* rows = s_idx + p * K;
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < G::SPT; ++i) {
        const int j = part * G::SPT + i;
        if (rows[j] >= 0) mx = fmaxf(mx, col[j * G::LDU]);
      }
#pragma unroll
      for (int off = 1; off < G::TPP; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
#pragma unroll
      for (int i = 0; i < G::SPT; ++i) {
        const int j = part * G::SPT + i;
        col[j * G::LDU] = rows[j] >= 0 ? expf(__fsub_rn(col[j * G::LDU], mx)) : 0.f;
      }
      __syncwarp();
      float sum = 0.f;
      if (part == 0) {
#pragma unroll
        for (int j = 0; j < K; ++j) sum = __fadd_rn(sum, col[j * G::LDU]);
      }
      sum = __shfl_sync(0xffffffffu, sum, (threadIdx.x & 31) - part);
#pragma unroll
      for (int i = 0; i < G::SPT; ++i) {
        const int j = part * G::SPT + i;
        col[j * G::LDU] = sum > 0.f ? __fdiv_rn(col[j * G::LDU], sum) : 0.f;
      }
    }
    __syncthreads();
    // 4. y = sum_j (v_nb + r_j) a_j for the thread's QT queries and CPT
    // channels: their K v values each are loaded first (an invalid slot
    // reads row 0 and adds 0); slot j goes to partial sum j % 4
    {
      float vv[G::QT][G::CPT][K];
#pragma unroll
      for (int qi = 0; qi < G::QT; ++qi) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int row = s_idx[(ro + qi * G::RPP) * K + j];
          const float* vr = vx + static_cast<long long>(row >= 0 ? row : 0) * C;
#pragma unroll
          for (int e = 0; e < G::CPT; ++e) vv[qi][e][j] = __ldg(vr + cl + e * G::CW);
        }
      }
#pragma unroll
      for (int qi = 0; qi < G::QT; ++qi) {
        const int p = ro + qi * G::RPP;
        const long long gp = q0 + p;
#pragma unroll
        for (int e = 0; e < G::CPT; ++e) {
          const int c = cl + e * G::CW;
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const int r = p * K + j;
            float z = 0.f;
            if (s_idx[r] >= 0) {
              const float rr = va::lin3(s_h[4 * r], s_h[4 * r + 1], s_h[4 * r + 2], wp0[e],
                                        wp1[e], wp2[e], bp[e]);
              z = __fmul_rn(__fadd_rn(vv[qi][e][j], rr), s_a[r * G::LDU + c % N]);
            }
            part[j % 4] = j < 4 ? z : __fadd_rn(part[j % 4], z);
          }
          if (gp < n_points) {
            y[gp * C + c] = __fadd_rn(__fadd_rn(__fadd_rn(part[0], part[1]), part[2]), part[3]);
          }
        }
      }
    }
    __syncthreads();  // the next tile rewrites the rows, h and weights
  }
}

template <int C, int K, int N, int P>
struct K9 {
  using G = va::Geo<C, K, N, P>;

  static cudaError_t info(int& blocks_per_sm, int& sms) {
    static lfa::Prepared st;
    return lfa::prepare(vector_attention_kernel<C, K, N, P>, G::SMEM, st, blocks_per_sm, sms);
  }

  static cudaError_t launch(const float* q, const float* kx, const float* vx, const int* idx,
                            const unsigned char* valid, const float* rel, const float* prm, int B,
                            int n, int k, float* y, cudaStream_t stream) {
    int blocks_per_sm = 0, sms = 0;
    cudaError_t e = info(blocks_per_sm, sms);
    if (e != cudaSuccess) return e;
    const long long n_points = static_cast<long long>(B) * n;
    const long long n_tiles = (n_points + P - 1) / P;
    const long long slots = static_cast<long long>(blocks_per_sm) * sms;
    const unsigned blocks = static_cast<unsigned>(n_tiles < slots ? n_tiles : slots);
    vector_attention_kernel<C, K, N, P><<<blocks, va::THREADS, G::SMEM, stream>>>(
        q, kx, vx, idx, valid, rel, prm, n, n_points, k, y);
    return cudaGetLastError();
  }
};

// The instantiations: (C, K, N = C / s, P) at Point Transformer's published
// widths (planes 32-512, nsample 8/16/16/16/16, share_planes 8); a graph of
// k <= K slots runs on its width's instantiation.
#define M3D_K9_WIDTHS(X) \
  X(32, 8, 4, 32) X(64, 16, 8, 8) X(128, 16, 16, 4) X(256, 16, 32, 2) X(512, 16, 64, 1)

}  // namespace m3d

// q, kx, vx (B, n, c) f32; idx (B, n, k) i32 indices into the cloud; valid
// (B, n, k) bool; rel (B, n, k, 3) f32 offsets p_j - p_i; prm the packed
// parameters (va::Params, 16-byte aligned). (c, nw = c / s) one of the
// instantiations' (C, N) and k <= K. Writes y (B, n, c) f32.
extern "C" int m3d_vector_attention(const void* q, const void* kx, const void* vx,
                                    const void* idx, const void* valid, const void* rel,
                                    const void* prm, int B, int n, int k, int c, int nw,
                                    void* y, void* stream) {
  using namespace m3d;
  const auto s = static_cast<cudaStream_t>(stream);
#define M3D_K9_CASE(C, K, N, P)                                                              \
  if (c == C && nw == N && k <= K) {                                                         \
    return static_cast<int>(K9<C, K, N, P>::launch(                                          \
        static_cast<const float*>(q), static_cast<const float*>(kx),                         \
        static_cast<const float*>(vx), static_cast<const int*>(idx),                         \
        static_cast<const unsigned char*>(valid), static_cast<const float*>(rel),            \
        static_cast<const float*>(prm), B, n, k, static_cast<float*>(y), s));                \
  }
  M3D_K9_WIDTHS(M3D_K9_CASE)
#undef M3D_K9_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
