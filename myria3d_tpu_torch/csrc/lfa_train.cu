// K5 and K6: the fused train-mode LocalFeatureAggregation's two kernels,
// and the fixed-order reduction that finishes their per-block partials.
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
// K6 layout: a block of 256 threads holds G = 256 / C centre points at a
// time (thread (p, o) owns channel o of point p, as in K2) and walks a
// contiguous chunk of point groups. The K x C edge features and d(att) of
// the group live in shared memory. The two cross-block reductions:
// d(att_w) is accumulated in registers (each thread owns column o and the
// rows p, p + G, ... of a row band; wide layers split the rows over
// gridDim.y bands of at most 64 entries a thread, and the extra bands
// recompute the forward), the per-channel sums likewise per thread; each
// block writes its partials and reduce_chunks_kernel sums them in chunk
// order, so every result is deterministic.
//
// Bound on the H100: latency of the f32 CUDA-core loops. Per point, the
// attention product and its transpose are 2 K C^2 FMAs and d(att_w)
// another K C^2 (3 M at C = 256); att_w and its transpose stream from L2.
// The design keeps many loads in flight: four W rows per step (two steps
// unrolled) against one 16-byte shared-memory read of four edge features,
// and at most 128 registers a thread so two blocks share an SM (measured
// 3.5x over one W row per step at one block per SM, PERF.md).
#include <cuda_runtime.h>
#include <math.h>

namespace m3d {

constexpr float SLOPE = 0.2f;  // LeakyReLU negative slope
constexpr int RS_THREADS = 256;
constexpr int RS_PAIRS = 66;   // distinct products of the 11-vector z
constexpr int BW_THREADS = 256;
constexpr int BW_KMAX = 16;
constexpr int BW_OWN = 64;     // d(att_w) entries a thread accumulates
constexpr int BW_SUMS = 14;    // dgamma, dbeta, S1, S2, M1[10]
constexpr int RD_THREADS = 256;

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

// out[r][e] = sum over c of part[r][c][e], c ascending
__global__ void __launch_bounds__(RD_THREADS) reduce_chunks_kernel(
    const float* __restrict__ part, int rows, int n_chunks, int e,
    float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * RD_THREADS + threadIdx.x;
  if (t >= (long long)rows * e) return;
  const long long r = t / e;
  const long long col = t - r * e;
  const float* p = part + r * n_chunks * e + col;
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) acc += p[(long long)c * e];
  out[t] = acc;
}

__global__ void __launch_bounds__(BW_THREADS, 2) lfa_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ pos,
    const int* __restrict__ idx, const unsigned char* __restrict__ nv,
    const float* __restrict__ a_hat, const float* __restrict__ c_hat,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ att_w, const float* __restrict__ att_t,
    const float* __restrict__ gout, int n, int n_points, int k, int c_in,
    int c, int groups_per_chunk, int rows, float* __restrict__ dxj,
    float* __restrict__ dw_part, float* __restrict__ sc_part) {
  // one (K, C) slab per point, 16-byte aligned for the float4 reads and
  // strided by four extra words (bank offsets between the slabs of a warp)
  __shared__ __align__(16) float lf[(BW_KMAX + 1) * BW_THREADS];
  __shared__ __align__(16) float da[(BW_KMAX + 1) * BW_THREADS];
  __shared__ float red[BW_THREADS / 2 * BW_SUMS];
  const int G = BW_THREADS / c;
  const int p = threadIdx.x / c;
  const int o = threadIdx.x - p * c;
  const int chunk = blockIdx.x;
  const int band = blockIdx.y;
  const bool lead = band == 0;  // the first band also writes dx_j and the sums
  const int stride = BW_KMAX * c + 4;
  float* lfp = lf + p * stride;
  float* dap = da + p * stride;

  const bool is_enc = o >= c_in;
  float a[10];
  float cc = 0.f, gam = 0.f, bet = 0.f;
#pragma unroll
  for (int r = 0; r < 10; ++r) a[r] = 0.f;
  if (is_enc) {
    const int ce = o - c_in;
#pragma unroll
    for (int r = 0; r < 10; ++r) a[r] = a_hat[ce * 10 + r];
    cc = c_hat[ce];
    gam = gamma[ce];
    bet = beta[ce];
  }
  // d(att_w) rows this thread owns: row0 + j * G, j < n_own
  const int row0 = band * rows + p;
  const int n_own = p < rows ? (rows - p + G - 1) / G : 0;
  float dw[BW_OWN];
#pragma unroll
  for (int j = 0; j < BW_OWN; ++j) dw[j] = 0.f;
  float sums[BW_SUMS];
#pragma unroll
  for (int t = 0; t < BW_SUMS; ++t) sums[t] = 0.f;

  const int n_groups = (n_points + G - 1) / G;
  const int g0 = chunk * groups_per_chunk;
  const int g1 = min(n_groups, g0 + groups_per_chunk);
  for (int grp = g0; grp < g1; ++grp) {
    const long long g = (long long)grp * G + p;  // centre point
    const bool active = g < n_points;
    const long long cloud = active ? (g / n) * n : 0;

    // ---- forward recompute: edge features
    for (int kk = 0; kk < k; ++kk) {
      float v = 0.f;
      if (active && nv[g * k + kk]) {
        const long long j = cloud + idx[g * k + kk];
        if (!is_enc) {
          v = x[j * c_in + o];
        } else {
          float rel[10];
          make_rel(pos, g, j, rel);
          float e = cc;
#pragma unroll
          for (int r = 0; r < 10; ++r) e += a[r] * rel[r];
          const float u = gam * e + bet;
          v = u >= 0.f ? u : SLOPE * u;
        }
      }
      lfp[kk * c + o] = v;
    }
    __syncthreads();

    // ---- attention, masked softmax, pooled output, d(att)
    float s[BW_KMAX];
#pragma unroll
    for (int kk = 0; kk < BW_KMAX; ++kk) s[kk] = 0.f;
#pragma unroll 2
    for (int ci = 0; ci < c; ci += 4) {
      const float w0 = att_w[ci * c + o], w1 = att_w[(ci + 1) * c + o];
      const float w2 = att_w[(ci + 2) * c + o], w3 = att_w[(ci + 3) * c + o];
#pragma unroll
      for (int kk = 0; kk < BW_KMAX; ++kk) {
        if (kk < k) {
          const float4 l = *reinterpret_cast<const float4*>(lfp + kk * c + ci);
          s[kk] = fmaf(w3, l.w, fmaf(w2, l.z, fmaf(w1, l.y, fmaf(w0, l.x, s[kk]))));
        }
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int kk = 0; kk < BW_KMAX; ++kk) {
      if (kk < k && active && nv[g * k + kk]) m = fmaxf(m, s[kk]);
    }
    float ssum = 0.f;
#pragma unroll
    for (int kk = 0; kk < BW_KMAX; ++kk) {
      if (kk < k && active && nv[g * k + kk]) {
        s[kk] = expf(s[kk] - m);
        ssum += s[kk];
      } else {
        s[kk] = 0.f;
      }
    }
    const float den = fmaxf(ssum, 1e-16f);
    float pooled = 0.f;
#pragma unroll
    for (int kk = 0; kk < BW_KMAX; ++kk) {
      s[kk] = s[kk] / den;
      if (kk < k) pooled += s[kk] * lfp[kk * c + o];
    }
    const float go = active ? gout[g * c + o] : 0.f;
    const float tt = go * pooled;
#pragma unroll
    for (int kk = 0; kk < BW_KMAX; ++kk) {
      if (kk < k) dap[kk * c + o] = s[kk] * (go * lfp[kk * c + o] - tt);
    }
    __syncthreads();

    // ---- d(lf) = g s + att_w d(att); dx_j and the per-channel sums
    if (lead && active) {
      float dl[BW_KMAX];
#pragma unroll
      for (int kk = 0; kk < BW_KMAX; ++kk) dl[kk] = go * s[kk];
#pragma unroll 2
      for (int o2 = 0; o2 < c; o2 += 4) {   // att_t[o2][o] = att_w[o][o2]
        const float w0 = att_t[o2 * c + o], w1 = att_t[(o2 + 1) * c + o];
        const float w2 = att_t[(o2 + 2) * c + o], w3 = att_t[(o2 + 3) * c + o];
#pragma unroll
        for (int kk = 0; kk < BW_KMAX; ++kk) {
          if (kk < k) {
            const float4 d = *reinterpret_cast<const float4*>(dap + kk * c + o2);
            dl[kk] = fmaf(w3, d.w, fmaf(w2, d.z, fmaf(w1, d.y, fmaf(w0, d.x, dl[kk]))));
          }
        }
      }
      if (!is_enc) {
#pragma unroll
        for (int kk = 0; kk < BW_KMAX; ++kk) {
          if (kk < k) dxj[(g * k + kk) * c_in + o] = nv[g * k + kk] ? dl[kk] : 0.f;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < BW_KMAX; ++kk) {
          if (kk < k && nv[g * k + kk]) {
            float rel[10];
            make_rel(pos, g, cloud + idx[g * k + kk], rel);
            float e = cc;
#pragma unroll
            for (int r = 0; r < 10; ++r) e += a[r] * rel[r];
            const float u = gam * e + bet;
            const float du = dl[kk] * (u >= 0.f ? 1.f : SLOPE);
            const float de = gam * du;
            sums[0] += du * e;
            sums[1] += du;
            sums[2] += de;
            sums[3] += de * e;
#pragma unroll
            for (int r = 0; r < 10; ++r) sums[4 + r] += de * rel[r];
          }
        }
      }
    }

    // ---- d(att_w)[row][o] += sum over the group's edges of lf[row] d(att)[o]
    for (int pp = 0; pp < G; ++pp) {
      const float* lrow = lf + pp * stride;
      const float* drow = da + pp * stride;
      for (int kk = 0; kk < k; ++kk) {
        const float d = drow[kk * c + o];
        const float* l = lrow + kk * c + row0;
#pragma unroll
        for (int j = 0; j < BW_OWN; ++j) {
          if (j >= n_own) break;
          dw[j] += l[j * G] * d;
        }
      }
    }
    __syncthreads();  // the slabs are rewritten by the next group
  }

#pragma unroll
  for (int j = 0; j < BW_OWN; ++j) {
    if (j >= n_own) break;
    dw_part[((long long)chunk * c + row0 + j * G) * c + o] = dw[j];
  }
  if (lead) {
    if (is_enc) {
#pragma unroll
      for (int t = 0; t < BW_SUMS; ++t) red[(p * c_in + (o - c_in)) * BW_SUMS + t] = sums[t];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < c_in * BW_SUMS; e += BW_THREADS) {
      float v = 0.f;
      for (int pp = 0; pp < G; ++pp) v += red[pp * c_in * BW_SUMS + e];
      sc_part[(long long)chunk * c_in * BW_SUMS + e] = v;
    }
  }
}

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

// part (rows, n_chunks, e) f32 -> out (rows, e) f32, summed in chunk order.
extern "C" int m3d_reduce_chunks(const void* part, int rows, int n_chunks,
                                 int e, void* out, void* stream) {
  using namespace m3d;
  const long long total = (long long)rows * e;
  const unsigned blocks = (unsigned)((total + RD_THREADS - 1) / RD_THREADS);
  reduce_chunks_kernel<<<blocks, RD_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), rows, n_chunks, e,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x (B, n, c_in), pos (B, n, 3), gout (B, n, c) f32 with c = 2 c_in
// dividing 256; idx/nv (B, n, k), k <= 16; a_hat (c_in, 10), c_hat, gamma,
// beta (c_in); att_w (c, c) with att = lf att_w, att_t its transpose.
// Grid (n_chunks, bands): chunk q covers point groups [q * groups_per_chunk,
// ...), band r the d(att_w) rows [r * c / bands, ...), at most 64 entries
// a thread. Writes dxj (B, n, k, c_in), dw_part (n_chunks, c, c) and, from
// band 0, sc_part (n_chunks, c_in, 14).
extern "C" int m3d_lfa_bwd(const void* x, const void* pos, const void* idx,
                           const void* nv, const void* a_hat,
                           const void* c_hat, const void* gamma,
                           const void* beta, const void* att_w,
                           const void* att_t, const void* gout, int B, int n,
                           int k, int c_in, int n_chunks,
                           int groups_per_chunk, int bands, void* dxj,
                           void* dw_part, void* sc_part, void* stream) {
  using namespace m3d;
  const int c = 2 * c_in;
  lfa_bwd_kernel<<<dim3(n_chunks, bands), BW_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(pos),
      static_cast<const int*>(idx), static_cast<const unsigned char*>(nv),
      static_cast<const float*>(a_hat), static_cast<const float*>(c_hat),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(att_w), static_cast<const float*>(att_t),
      static_cast<const float*>(gout), n, B * n, k, c_in, c,
      groups_per_chunk, c / bands, static_cast<float*>(dxj),
      static_cast<float*>(dw_part), static_cast<float*>(sc_part));
  return static_cast<int>(cudaGetLastError());
}
