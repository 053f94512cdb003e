// K5 and K6: the fused train-mode LocalFeatureAggregation's two kernels,
// and the fixed-order reductions that finish their per-block partials.
//
// The fused train LFA folds the LocSE encoder's batch-moment BatchNorm into
// the eval kernel K2 (lfa.cu). Its batch moments are rel-statistics (K5),
// and its backward is one recompute-and-differentiate kernel (K6); the
// remaining chain rule through the BN moments finishes in torch
// (ops/cuda_lfa_train.py).
//
// K5 replaces myria3d_tpu/ops/pallas_lfa_train.py::_relstats_kernel:
//   S[b] = sum over valid slots of z z^T,  z = [pos_i, pos_j, pos_j - pos_i,
//          |pos_j - pos_i|, 1]                                     (11)
// per cloud (the corner holds the count, the last row the sums of rel).
// The TPU grid carried one (16, 16) accumulator across its sequential query
// tiles; Hopper blocks run in no order, so each block sums the 66 distinct
// products of a contiguous point chunk (per-thread partials, then warp
// shuffles and shared memory in a fixed order) and writes its own partial;
// reduce_chunks_kernel sums the partials in chunk order. Bound: the pos_j
// gather (12 bytes per slot), one pass; 66 FMAs per slot.
//
// K6 replaces myria3d_tpu/ops/pallas_lfa_train.py::_lfa_bwd_kernel. For
// every centre point it recomputes the forward in f32 from direct gathers
// (lf = [x_j, LeakyReLU(gamma * ehat + beta)], ehat = A_hat rel + c_hat,
// att = lf att_w, s = masked softmax over the K slots), then differentiates
// the pooled output g:
//   d(att)[k][o] = s[k][o] (g[o] lf[k][o] - g[o] pooled[o])
//   d(lf)[k][c]  = g[c] s[k][c] + sum_o att_w[c][o] d(att)[k][o]
//   d(att_w)     = sum over edges of lf^T d(att)           (C x C)
//   dx_j = d(lf)[:, :C_in]; du = d(lf)[:, C_in:] * LeakyReLU'(u);
//   dehat = gamma du; per channel: dgamma = sum du ehat, dbeta = sum du,
//   S1 = sum dehat, S2 = sum dehat ehat, M1 = sum dehat rel^T  (C_in x 10)
// No edge tensor leaves the chip except dx_j, one row per slot, which the
// deterministic scatter of K4 (gather_bwd.cu) sums into dx.
//
// Bound on the H100: the three attention products, 3 K C^2 FMAs per point,
// all on the tensor cores in 3xTF32 on K2's edge tile (lfa_tile.cuh). Per
// tile of P points: (1) lf, att and the softmax as in K2, whose epilogue
// writes d(att) and g s into shared memory; (3) d(att_w) += lf^T d(att),
// accumulated in registers over the block's whole run of tiles; (2) d(lf)
// = g s + d(att) att_w^T against att_w read as the transposed operand (row
// slabs at C = 256), then one pass over the d(lf) rows writes dx_j and
// adds the BN sums of the thread's channel in f64. d(att_w) does not fit
// one block above C = 64: it is tiled by 64-column bands over gridDim.y.
// Band 0 does everything; another band recomputes lf and product 1 on its
// own columns only (a quarter of the products at C = 256) and runs
// product 3 on them. Each block writes its d(att_w) band and its BN sums
// as partials, summed across blocks in chunk order and in f64 by
// reduce_chunks_kernel: deterministic, no atomics.
#include "lfa_tile.cuh"

namespace m3d {

constexpr int RS_THREADS = 256;
constexpr int RS_PAIRS = 66;   // distinct products of the 11-vector z
constexpr int BW_SUMS = 14;    // dgamma, dbeta, S1, S2, M1[10]
constexpr int RD_THREADS = 256;
constexpr int SUM_FLOATS = lfa::THREADS / 2 * BW_SUMS * 2;  // K6's f64 BN sums

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// rel = [pos_i, pos_j, pos_j - pos_i, |pos_j - pos_i|]
__device__ __forceinline__ void make_rel(const float* __restrict__ pos,
                                         long long gi, long long gj,
                                         float* rel) {
  rel[0] = pos[gi * 3];
  rel[1] = pos[gi * 3 + 1];
  rel[2] = pos[gi * 3 + 2];
  rel[3] = pos[gj * 3];
  rel[4] = pos[gj * 3 + 1];
  rel[5] = pos[gj * 3 + 2];
  rel[6] = rel[3] - rel[0];
  rel[7] = rel[4] - rel[1];
  rel[8] = rel[5] - rel[2];
  rel[9] = sqrtf(fmaxf(rel[6] * rel[6] + rel[7] * rel[7] + rel[8] * rel[8], 0.f));
}

__global__ void __launch_bounds__(RS_THREADS) relstats_kernel(
    const float* __restrict__ pos, const int* __restrict__ idx,
    const unsigned char* __restrict__ nv, int n, int k, int chunk_pts,
    int n_chunks, float* __restrict__ part) {
  const int b = blockIdx.y, chunk = blockIdx.x;
  const long long cloud = (long long)b * n;
  const long long s0 = (long long)chunk * chunk_pts * k;
  const long long s1 = (long long)min(n, (chunk + 1) * chunk_pts) * k;
  float acc[RS_PAIRS];
#pragma unroll
  for (int t = 0; t < RS_PAIRS; ++t) acc[t] = 0.f;
  for (long long s = s0 + threadIdx.x; s < s1; s += RS_THREADS) {
    const long long slot = cloud * k + s;
    if (!nv[slot]) continue;
    float z[11];
    make_rel(pos, cloud + s / k, cloud + idx[slot], z);
    z[10] = 1.f;
    int t = 0;
#pragma unroll
    for (int a = 0; a < 11; ++a) {
#pragma unroll
      for (int c = a; c < 11; ++c) acc[t++] += z[a] * z[c];
    }
  }
  __shared__ float red[RS_THREADS / 32][RS_PAIRS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < RS_PAIRS; ++t) {
    const float v = warp_sum(acc[t]);
    if (lane == 0) red[warp][t] = v;
  }
  __syncthreads();
  if (threadIdx.x < RS_PAIRS) {
    float v = 0.f;
    for (int w = 0; w < RS_THREADS / 32; ++w) v += red[w][threadIdx.x];
    part[((long long)b * n_chunks + chunk) * RS_PAIRS + threadIdx.x] = v;
  }
}

// out[r][e] = sum over c of part[r][c][e], c ascending, accumulated in f64
// (K5's f32 partials, K6's f32 d(att_w) and f64 BN-sum partials), out f32.
template <typename T>
__global__ void __launch_bounds__(RD_THREADS) reduce_chunks_kernel(
    const T* __restrict__ part, int rows, int n_chunks, int e, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * RD_THREADS + threadIdx.x;
  if (t >= (long long)rows * e) return;
  const long long r = t / e;
  const long long col = t - r * e;
  const T* p = part + r * n_chunks * e + col;
  double acc = 0.0;
  for (int c = 0; c < n_chunks; ++c) acc += static_cast<double>(p[(long long)c * e]);
  out[t] = static_cast<float>(acc);
}

// The d(att_w) band of a K6 block and how its 8 warps share it: the band's
// NB columns, in m16 tiles over its rows c (a width-8 operand padded to
// 16) and n8 tiles over its columns; a warp holds MT x NT tiles, and where
// the band has fewer than 8 tiles, KSPLIT warps split a tile's edge rows.
template <int C>
struct Band {
  static constexpr int NB = C <= 64 ? C : 64, BANDS = C / NB;
  static constexpr int M3 = C >= 16 ? C / 16 : 1, N3 = NB / 8;
  static constexpr int WM = M3 < lfa::WARPS ? M3 : lfa::WARPS, MT = M3 / WM;
  static constexpr int WN = lfa::WARPS / WM;
  static constexpr int NT = N3 >= WN ? N3 / WN : 1, KSPLIT = N3 >= WN ? 1 : WN / N3;
  // accumulators per tile: three dependency chains where a warp holds few
  // tiles, one where it holds enough to overlap them
  static constexpr int CHAINS = MT * NT == 1 ? 3 : 1;
};

template <int C, int P, int NT>
__global__ void __launch_bounds__(lfa::THREADS, C <= 64 ? 2 : 1) lfa_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ pos, const int* __restrict__ idx,
    const float* __restrict__ a_hat, const float* __restrict__ c_hat,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ att_w, const float* __restrict__ gout, int n, long long n_points,
    int k, int tiles_per_chunk, float* __restrict__ dxj, float* __restrict__ dw_part,
    double* __restrict__ sc_part) {
  using G = lfa::Geo<C, P>;
  using D = Band<C>;
  constexpr int M = G::M, LD = G::LD, CIN = G::CIN;
  static_assert(D::KSPLIT * C * D::NB <= 3 * M * LD, "d(att_w) partials fit the edge arrays");
  extern __shared__ __align__(16) float smem[];
  // the BN sums of each encoder thread in f64, a tile's f32 partial added
  // at a time (registers hold them only in the d(lf) pass)
  double* ssum = reinterpret_cast<double*>(smem);
  float* lf = smem + SUM_FLOATS;
  float* da = lf + M * LD;  // d(att)
  float* gs = da + M * LD;  // g s, then d(lf)
  float* wbuf = gs + M * LD;
  float* srel = wbuf + G::WFLOATS;
  float* scratch = srel + M * lfa::REL_LD;
  float* spos = scratch + lfa::Cols<NT>::SCRATCH;
  int* sidx = reinterpret_cast<int*>(spos + (M + P) * 4);  // a ring of three tiles
  int* sbase = sidx + 3 * M;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int chunk = blockIdx.x, band = blockIdx.y;
  const bool lead = band == 0;  // also d(lf): dx_j and the BN sums
  const long long n_tiles = (n_points + P - 1) / P;
  const long long t0 = (long long)chunk * tiles_per_chunk;
  const long long t1 = t0 + tiles_per_chunk < n_tiles ? t0 + tiles_per_chunk : n_tiles;

  const int ch = threadIdx.x % C;
  const bool is_enc = ch >= CIN;
  lfa::Affine aff;  // ehat of the thread's channel
  float gam = 0.f, bet = 0.f;
  if (is_enc) {
    aff.load(a_hat, c_hat, ch - CIN);
    gam = gamma[ch - CIN];
    bet = beta[ch - CIN];
  } else {
#pragma unroll
    for (int r = 0; r < 10; ++r) aff.a[r] = 0.f;
    aff.c = 0.f;
  }
  const auto u_of = [&](const float* rel) { return gam * aff(rel) + bet; };

  const int wm = warp % D::WM, wr = warp / D::WM;
  const int wn = D::KSPLIT == 1 ? wr : wr % D::N3;
  const int ks = D::KSPLIT == 1 ? 0 : wr / D::N3;
  float acc3[D::MT][D::NT][D::CHAINS][4];
#pragma unroll
  for (int i = 0; i < D::MT; ++i) {
#pragma unroll
    for (int j = 0; j < D::NT; ++j) {
#pragma unroll
      for (int q = 0; q < D::CHAINS; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc3[i][j][q][e] = 0.f;
      }
    }
  }
  double* my_sums = ssum + ((threadIdx.x / C) * CIN + ch - CIN) * BW_SUMS;
  if (is_enc) {
#pragma unroll
    for (int q = 0; q < BW_SUMS; ++q) my_sums[q] = 0.0;
  }

  const int cbeg = lead ? 0 : band * D::NB;  // product 1's columns
  const int width = lead ? C : D::NB;
  if (G::RESIDENT) lfa::stage_cols<G>(wbuf, att_w, 0);
  if (t0 < t1) lfa::stage_idx<G>(sidx, sbase, idx, t0, n_points, k, n);
  for (long long tile = t0; tile < t1; ++tile) {
    const int it = static_cast<int>(tile - t0), slot = it % 3;
    int* cur = sidx + slot * M;
    lfa::wait_all();
    __syncthreads();  // this tile's indices landed; the last tile is done
    lfa::stage_gathers<G>(lf, spos, cur, sbase + slot * P, x, pos, tile, n_points);
    if (!G::RESIDENT) lfa::stage_cols<G>(wbuf, att_w, cbeg);
    lfa::wait_all();
    __syncthreads();
    if (tile + 1 < t1) {
      const int next = (it + 1) % 3;
      lfa::stage_idx<G>(sidx + next * M, sbase + next * P, idx, tile + 1, n_points, k, n);
    }
    lfa::build_rel<G>(srel, cur, spos);
    __syncthreads();
    lfa::build_enc<G, false>(lf, cur, srel, u_of);
    __syncthreads();

    // ---- product 1, softmax; d(att) and g s
    using K = lfa::Cols<NT>;
    int step = lfa::attention_pass<G, NT, false>(
        lf, cur, wbuf, scratch, att_w, cbeg, width, 0, lead,
        [&](int p, int col, int part, const float* e, float inv, float pooled) {
          const long long gp = tile * P + p;
          const float go = gp < n_points ? gout[gp * C + col] : 0.f;
          const float q = go * pooled;
#pragma unroll
          for (int i = 0; i < K::RPL; ++i) {
            const int r = part * K::RPL + i;
            const int row = (p * lfa::SLOTS + r) * LD + col;
            const float sv = e[r * K::SLD] * inv;
            da[row] = sv * (go * lf[row] - q);
            if (lead) gs[row] = go * sv;
          }
        });
    __syncthreads();

    // ---- product 3: d(att_w)[:, band] += lf^T d(att)[:, band]
#pragma unroll 2
    for (int kb = ks * 8; kb < M; kb += 8 * D::KSPLIT) {
      lfa::FragA a[D::MT];
#pragma unroll
      for (int i = 0; i < D::MT; ++i) {
        a[i] = lfa::load_at(lf + kb * LD + (wm * D::MT + i) * 16, LD, g, t, C >= 16);
      }
#pragma unroll
      for (int j = 0; j < D::NT; ++j) {
        const lfa::FragB b =
            lfa::load_b(da + kb * LD + band * D::NB + (wn * D::NT + j) * 8, LD, 1, g, t);
#pragma unroll
        for (int i = 0; i < D::MT; ++i) {
          if constexpr (D::CHAINS == 3) {
            lfa::mma3(acc3[i][j], a[i], b);
          } else {
            lfa::mma3(acc3[i][j][0], a[i], b);
          }
        }
      }
    }
    if (!lead) continue;

    // ---- product 2: d(lf) = g s + d(att) att_w^T, in place of g s
    const int steps2 = G::RESIDENT ? 1 : G::SLABS;
    for (int si = 0; si < steps2; ++si, ++step) {
      const float* w = wbuf;
      int c0 = 0, wd = C;
      if (!G::RESIDENT) {
        lfa::wait_all();
        __syncthreads();
        w = wbuf + (step & 1) * G::WBUF;
        c0 = si * G::NS;
        wd = G::NS;
        if (si + 1 < steps2) lfa::stage_rows<G>(wbuf + ((step + 1) & 1) * G::WBUF, att_w, c0 + G::NS);
      }
      const int groups = wd / (8 * NT);
      for (int u = warp; u < P * groups; u += lfa::WARPS) {
        const int p = u / groups;
        const int col = c0 + (u - p * groups) * 8 * NT;
        float* gr = gs + p * lfa::SLOTS * LD;
        const float* dr = da + p * lfa::SLOTS * LD;
        float acc[NT][3][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) lfa::zero3(acc[j]);
#pragma unroll 4
        for (int kb = 0; kb < C; kb += 8) {
          const lfa::FragA a = lfa::load_a(dr + kb, LD, g, t);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const lfa::FragB b = lfa::load_b(w + (col - c0 + 8 * j) * G::LDR + kb, 1, G::LDR, g, t);
            lfa::mma3(acc[j], a, b);
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int cj = col + 8 * j + 2 * t;
          float v[4];
          lfa::fold3(acc[j], v);
          float2* r0 = reinterpret_cast<float2*>(gr + g * LD + cj);
          float2* r1 = reinterpret_cast<float2*>(gr + (g + 8) * LD + cj);
          *r0 = make_float2(r0->x + v[0], r0->y + v[1]);   // g s + d(att) att_w^T
          *r1 = make_float2(r1->x + v[2], r1->y + v[3]);
        }
      }
    }
    __syncthreads();

    // ---- dx_j rows and the BN sums of the thread's channel
    float sums[BW_SUMS];
#pragma unroll
    for (int q = 0; q < BW_SUMS; ++q) sums[q] = 0.f;
#pragma unroll 2
    for (int i = 0; i < G::PER_THREAD; ++i) {
      const int r = threadIdx.x / C + i * G::ROW_STEP;
      const int kk = r % lfa::SLOTS;
      const long long gp = tile * P + r / lfa::SLOTS;
      if (kk >= k || gp >= n_points) continue;
      const int j = cur[r];
      const float dl = gs[r * LD + ch];
      if (!is_enc) {
        dxj[(gp * k + kk) * CIN + ch] = j >= 0 ? dl : 0.f;
      } else if (j >= 0) {
        const float* rel = srel + r * lfa::REL_LD;
        const float e = aff(rel);
        const float u = gam * e + bet;
        const float du = dl * (u >= 0.f ? 1.f : lfa::SLOPE);
        const float de = gam * du;
        sums[0] += du * e;
        sums[1] += du;
        sums[2] += de;
        sums[3] += de * e;
#pragma unroll
        for (int q = 0; q < 10; ++q) sums[4 + q] += de * rel[q];
      }
    }
    if (is_enc) {
#pragma unroll
      for (int q = 0; q < BW_SUMS; ++q) my_sums[q] += sums[q];
    }
  }
  lfa::wait_all();
  __syncthreads();  // the edge arrays hold the partials from here

  // ---- the block's d(att_w) band, summed over its KSPLIT warps in order
  float* red = lf;
#pragma unroll
  for (int i = 0; i < D::MT; ++i) {
#pragma unroll
    for (int j = 0; j < D::NT; ++j) {
      const int c = (wm * D::MT + i) * 16 + g;
      const int ob = (wn * D::NT + j) * 8 + 2 * t;
      float v[4];
      if constexpr (D::CHAINS == 3) {
        lfa::fold3(acc3[i][j], v);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = acc3[i][j][0][e];
      }
      red[(ks * C + c) * D::NB + ob] = v[0];
      red[(ks * C + c) * D::NB + ob + 1] = v[1];
      if (C >= 16) {
        red[(ks * C + c + 8) * D::NB + ob] = v[2];
        red[(ks * C + c + 8) * D::NB + ob + 1] = v[3];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < C * D::NB; e += lfa::THREADS) {
    const int c = e / D::NB, ob = e - c * D::NB;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < D::KSPLIT; ++q) v += red[(q * C + c) * D::NB + ob];
    dw_part[((long long)chunk * C + c) * C + band * D::NB + ob] = v;
  }
  if (!lead) return;

  // ---- the block's BN sums, over the threads of each channel in order
  for (int e = threadIdx.x; e < CIN * BW_SUMS; e += lfa::THREADS) {
    double v = 0.0;
    for (int grp = 0; grp < lfa::THREADS / C; ++grp) v += ssum[grp * CIN * BW_SUMS + e];
    sc_part[(long long)chunk * CIN * BW_SUMS + e] = v;
  }
}

template <int C, int P, int NT>
struct K6 {
  using G = lfa::Geo<C, P>;
  static constexpr int SMEM =
      (SUM_FLOATS + 3 * G::M * G::LD + G::WFLOATS + G::M * lfa::REL_LD +
       lfa::Cols<NT>::SCRATCH + (G::M + P) * 4 + 3 * (G::M + P)) * 4;

  static cudaError_t info(int& blocks_per_sm, int& sms) {
    static lfa::Prepared st;
    return lfa::prepare(lfa_bwd_kernel<C, P, NT>, SMEM, st, blocks_per_sm, sms);
  }

  static cudaError_t launch(const float* x, const float* pos, const int* idx, const float* a_hat,
                            const float* c_hat, const float* gamma, const float* beta,
                            const float* att_w, const float* gout, int B, int n, int k,
                            int n_chunks, float* dxj, float* dw_part, double* sc_part,
                            cudaStream_t stream) {
    int blocks_per_sm = 0, sms = 0;
    cudaError_t e = info(blocks_per_sm, sms);
    if (e != cudaSuccess) return e;
    const long long n_points = (long long)B * n;
    const long long n_tiles = (n_points + P - 1) / P;
    const int per = (int)((n_tiles + n_chunks - 1) / n_chunks);
    lfa_bwd_kernel<C, P, NT><<<dim3(n_chunks, Band<C>::BANDS), lfa::THREADS, SMEM, stream>>>(
        x, pos, idx, a_hat, c_hat, gamma, beta, att_w, gout, n, n_points, k, per, dxj, dw_part,
        sc_part);
    return cudaGetLastError();
  }
};

// The instantiation of each width: points per tile, n-tiles per unit.
#define M3D_K6_WIDTHS(X) X(8, 16, 1) X(16, 16, 2) X(32, 8, 2) X(64, 4, 2) X(128, 4, 4) X(256, 2, 1)

}  // namespace m3d

// pos (B, n, 3) f32; idx (B, n, k) i32; nv (B, n, k) u8. Writes part
// (B, n_chunks, 66) f32: the upper triangle (row-major) of each chunk's
// sum of z z^T. chunk_pts * n_chunks >= n.
extern "C" int m3d_relstats(const void* pos, const void* idx, const void* nv,
                            int B, int n, int k, int n_chunks, int chunk_pts,
                            void* part, void* stream) {
  using namespace m3d;
  relstats_kernel<<<dim3(n_chunks, B), RS_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const int*>(idx),
      static_cast<const unsigned char*>(nv), n, k, chunk_pts, n_chunks,
      static_cast<float*>(part));
  return static_cast<int>(cudaGetLastError());
}

// part (rows, n_chunks, e), f64 if part_f64 else f32 -> out (rows, e) f32,
// summed in chunk order in f64.
extern "C" int m3d_reduce_chunks(const void* part, int part_f64, int rows, int n_chunks, int e,
                                 void* out, void* stream) {
  using namespace m3d;
  const long long total = (long long)rows * e;
  const unsigned blocks = (unsigned)((total + RD_THREADS - 1) / RD_THREADS);
  const auto s = static_cast<cudaStream_t>(stream);
  if (part_f64) {
    reduce_chunks_kernel<double><<<blocks, RD_THREADS, 0, s>>>(
        static_cast<const double*>(part), rows, n_chunks, e, static_cast<float*>(out));
  } else {
    reduce_chunks_kernel<float><<<blocks, RD_THREADS, 0, s>>>(
        static_cast<const float*>(part), rows, n_chunks, e, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// x (B, n, c_in), pos (B, n, 3), gout (B, n, c) f32 with c = 2 c_in in {8,
// 16, ..., 256}; idx (B, n, k) i32, -1 at invalid slots, k <= 16; a_hat
// (c_in, 10), c_hat, gamma, beta (c_in); att_w (c, c), 16-byte aligned,
// with att = lf att_w. Grid (n_chunks, bands): chunk q
// covers a contiguous run of tiles, band r the d(att_w) columns [64 r, 64 r
// + 64) (one band up to c = 64). Writes dxj (B, n, k, c_in), dw_part
// (n_chunks, c, c) f32 and sc_part (n_chunks, c_in, 14) f64.
extern "C" int m3d_lfa_bwd(const void* x, const void* pos, const void* idx, const void* a_hat,
                           const void* c_hat, const void* gamma, const void* beta,
                           const void* att_w, const void* gout, int B, int n, int k, int c_in,
                           int n_chunks, void* dxj, void* dw_part, void* sc_part,
                           void* stream) {
  using namespace m3d;
  const auto s = static_cast<cudaStream_t>(stream);
#define M3D_K6_CASE(C, P, NT)                                                                 \
  case C:                                                                                     \
    return static_cast<int>(K6<C, P, NT>::launch(                                             \
        static_cast<const float*>(x), static_cast<const float*>(pos),                         \
        static_cast<const int*>(idx), static_cast<const float*>(a_hat),                       \
        static_cast<const float*>(c_hat), static_cast<const float*>(gamma),                   \
        static_cast<const float*>(beta), static_cast<const float*>(att_w),                    \
        static_cast<const float*>(gout), B, n, k, n_chunks, static_cast<float*>(dxj),         \
        static_cast<float*>(dw_part), static_cast<double*>(sc_part), s));
  switch (2 * c_in) {
    M3D_K6_WIDTHS(M3D_K6_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef M3D_K6_CASE
}

// K6's launch resources at width c: info = [points per tile, d(att_w)
// bands, dynamic shared memory bytes, blocks per SM, SMs].
extern "C" int m3d_lfa_bwd_info(int c, void* info) {
  using namespace m3d;
  int* out = static_cast<int*>(info);
#define M3D_K6_INFO(C, P, NT)                                  \
  case C:                                                      \
    out[0] = P;                                                \
    out[1] = Band<C>::BANDS;                                   \
    out[2] = K6<C, P, NT>::SMEM;                               \
    return static_cast<int>(K6<C, P, NT>::info(out[3], out[4]));
  switch (c) {
    M3D_K6_WIDTHS(M3D_K6_INFO)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef M3D_K6_INFO
}
