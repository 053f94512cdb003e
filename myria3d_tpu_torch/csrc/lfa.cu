// K2: fused eval-mode LocalFeatureAggregation (LocSE + attentive pooling).
//
// Replaces the Pallas TPU kernel myria3d_tpu/ops/pallas_lfa.py::_lfa_kernel.
// Per centre point i and neighbour slot k (index j = idx[i, k], < 0 when
// the slot is invalid):
//   rel  = [pos_i, pos_j, pos_j - pos_i, |pos_j - pos_i|]          (10)
//   enc  = LeakyReLU_0.2(A rel + c)    (encoder Linear + eval BN, folded)
//   lf   = [x_j, enc]                                               (C)
//   att  = lf att_w                     (bias-free attention Linear)
//   out  = sum_k softmax_k(att)[o] * lf[k][o]   over valid slots only
// An all-invalid neighbourhood gives 0 (masked_softmax semantics). The
// output is the pooled (B, N, C) before the post-attention MLP.
//
// The TPU kernel gathered neighbours with one-hot MXU matmuls over a bf16
// payload (positions split hi/lo) in 8-aligned row groups; here positions
// are gathered by direct indexed f32 loads, and features in their own
// dtype: f32, or bfloat16 / float16 widened to f32 in the edge tile
// (XT, lfa_tile.cuh). Positions and everything after the tile stay f32.
//
// Bound on the H100: the attention product, K C^2 FMAs per point, on the
// tensor cores in 3xTF32 (lfa_tile.cuh): a block builds the edge tile of P
// points, runs the product against att_w in shared memory and pools in the
// product's epilogue; lf never leaves shared memory. Per width C the tile
// holds P points and a warp's unit covers NT n-tiles of 8 columns, chosen
// so that the 8 warps share a tile's units evenly.
#include "lfa_tile.cuh"

namespace m3d {

// K2's shared memory (floats): DEPTH edge tiles, att_w, rel rows, the
// warps' softmax scratch, DEPTH position stagings, then a ring of three
// tiles' indices and cloud bases (ints).
template <int C, int P, int NT, int DEPTH>
struct Layout {
  using G = lfa::Geo<C, P>;
  static constexpr int LF_TILE = G::M * G::LD, POS_TILE = (G::M + P) * 4;
  static constexpr int W = DEPTH * LF_TILE, REL = W + 2 * G::WBUF;  // resident: hi and lo
  static constexpr int SCRATCH = REL + G::M * lfa::REL_LD;
  static constexpr int POS = SCRATCH + lfa::Cols<NT>::SCRATCH;
  static constexpr int IDX = POS + DEPTH * POS_TILE;
  static constexpr int BYTES = (IDX + 3 * (G::M + P)) * 4;
  static_assert(BYTES <= 232448, "K2 block fits the SM's shared memory");
  static_assert(DEPTH == 1 || G::RESIDENT, "gathers run ahead only beside a resident att_w");
};

template <int C, int P, int NT, int DEPTH, int XT>
__global__ void __launch_bounds__(lfa::THREADS, C <= 8 ? 4 : (C <= 64 ? 2 : 1))
    lfa_kernel(const typename lfa::XElem<XT>::T* __restrict__ x, const float* __restrict__ pos,
               const int* __restrict__ idx, const float* __restrict__ enc_a,
               const float* __restrict__ enc_c, const float* __restrict__ att_w, int n,
               long long n_points, int k, int tiles_per_block, float* __restrict__ out) {
  using G = lfa::Geo<C, P>;
  using L = Layout<C, P, NT, DEPTH>;
  extern __shared__ __align__(16) float smem[];
  float* lf = smem;  // DEPTH tiles
  float* wbuf = smem + L::W;
  float* srel = smem + L::REL;
  float* scratch = smem + L::SCRATCH;
  float* spos = smem + L::POS;  // DEPTH tiles
  int* sidx = reinterpret_cast<int*>(smem + L::IDX);  // a ring of three tiles
  int* sbase = sidx + 3 * G::M;

  const long long n_tiles = (n_points + P - 1) / P;
  const long long t0 = (long long)blockIdx.x * tiles_per_block;
  const long long t1 = t0 + tiles_per_block < n_tiles ? t0 + tiles_per_block : n_tiles;
  if (t0 >= t1) return;

  lfa::Affine enc;  // of encoder channel threadIdx.x % C_in
  enc.load(enc_a, enc_c, threadIdx.x % G::CIN);

  if (G::RESIDENT) lfa::stage_cols<G>(wbuf, att_w, 0);
  lfa::stage_idx<G>(sidx, sbase, idx, t0, n_points, k, n);
  if (DEPTH == 2 && t0 + 1 < t1) {
    lfa::stage_idx<G>(sidx + G::M, sbase + P, idx, t0 + 1, n_points, k, n);
  }
  lfa::wait_all();
  __syncthreads();
  if (G::RESIDENT) lfa::split_resident<G>(wbuf, wbuf + G::WBUF);
  if (DEPTH == 2) lfa::stage_gathers<G, XT>(lf, spos, sidx, sbase, x, pos, t0, n_points);
  for (long long tile = t0; tile < t1; ++tile) {
    const int it = static_cast<int>(tile - t0);
    const int slot = it % 3, b = DEPTH == 2 ? (it & 1) : 0;
    const int* cur = sidx + slot * G::M;
    float* lfb = lf + b * L::LF_TILE;
    float* sp = spos + b * L::POS_TILE;
    if (DEPTH == 1) {
      lfa::wait_all();
      __syncthreads();  // this tile's indices landed; the last tile is done
      lfa::stage_gathers<G, XT>(lfb, sp, cur, sbase + slot * P, x, pos, tile, n_points);
      if (!G::RESIDENT) lfa::stage_cols<G>(wbuf, att_w, 0);
    }
    lfa::wait_all();
    __syncthreads();  // this tile's gathers landed (DEPTH 2: the last tile is done)
    if (tile + DEPTH < t1) {
      const int ahead = (it + DEPTH) % 3;
      lfa::stage_idx<G>(sidx + ahead * G::M, sbase + ahead * P, idx, tile + DEPTH, n_points, k, n);
    }
    if (DEPTH == 2 && tile + 1 < t1) {
      const int next = (it + 1) % 3;
      lfa::stage_gathers<G, XT>(lf + (1 - b) * L::LF_TILE, spos + (1 - b) * L::POS_TILE,
                                sidx + next * G::M, sbase + next * P, x, pos, tile + 1, n_points);
    }
    lfa::build_rel<G>(srel, cur, sp);
    __syncthreads();
    lfa::build_enc<G, true>(lfb, cur, srel, enc);
    __syncthreads();
    lfa::attention_pass<G, NT, G::RESIDENT>(
        lfb, cur, wbuf, scratch, att_w, 0, C, 0, false,
        [&](int p, int col, int part, const float*, float, float pooled) {
          const long long gp = tile * P + p;
          if (part == 0 && gp < n_points) out[gp * C + col] = pooled;
        });
  }
}

template <int C, int P, int NT, int DEPTH, int XT>
struct K2 {
  using L = Layout<C, P, NT, DEPTH>;
  static constexpr int SMEM = L::BYTES;

  static cudaError_t info(int& blocks_per_sm, int& sms) {
    static lfa::Prepared st;
    return lfa::prepare(lfa_kernel<C, P, NT, DEPTH, XT>, SMEM, st, blocks_per_sm, sms);
  }

  static cudaError_t launch(const void* x, const float* pos, const int* idx, const float* enc_a,
                            const float* enc_c, const float* att_w, int B, int n, int k,
                            float* out, cudaStream_t stream) {
    int blocks_per_sm = 0, sms = 0;
    cudaError_t e = info(blocks_per_sm, sms);
    if (e != cudaSuccess) return e;
    const long long n_points = (long long)B * n;
    const long long n_tiles = (n_points + P - 1) / P;
    const long long slots = (long long)blocks_per_sm * sms;
    const long long per = (n_tiles + slots - 1) / slots;
    const unsigned blocks = (unsigned)((n_tiles + per - 1) / per);
    lfa_kernel<C, P, NT, DEPTH, XT><<<blocks, lfa::THREADS, SMEM, stream>>>(
        static_cast<const typename lfa::XElem<XT>::T*>(x), pos, idx, enc_a, enc_c, att_w, n,
        n_points, k, (int)per, out);
    return cudaGetLastError();
  }
};

// The instantiation of each width: points per tile, n-tiles per unit,
// tiles of gathers in flight (one ahead where two edge tiles fit).
#define M3D_K2_WIDTHS(X) \
  X(8, 16, 1, 2) X(16, 16, 2, 2) X(32, 8, 2, 2) X(64, 4, 4, 2) X(128, 4, 4, 2) X(256, 4, 2, 1)

// One width's launch at x's element type xt (lfa::X_F32, X_BF16, X_F16).
template <int C, int P, int NT, int DEPTH>
static cudaError_t k2_launch(int xt, const void* x, const void* pos, const void* idx,
                             const void* enc_a, const void* enc_c, const void* att_w, int B,
                             int n, int k, void* out, cudaStream_t s) {
  const auto args = [&](auto launch) {
    return launch(x, static_cast<const float*>(pos), static_cast<const int*>(idx),
                  static_cast<const float*>(enc_a), static_cast<const float*>(enc_c),
                  static_cast<const float*>(att_w), B, n, k, static_cast<float*>(out), s);
  };
  switch (xt) {
    case lfa::X_F32:
      return args(K2<C, P, NT, DEPTH, lfa::X_F32>::launch);
    case lfa::X_BF16:
      return args(K2<C, P, NT, DEPTH, lfa::X_BF16>::launch);
    case lfa::X_F16:
      return args(K2<C, P, NT, DEPTH, lfa::X_F16>::launch);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace m3d

// x (B, n, c_in) of element type xt (0 f32, 1 bfloat16, 2 float16); pos
// (B, n, 3) f32; idx (B, n, k) i32 indices into the cloud, -1 at invalid
// slots; enc_a (c_in, 10) and enc_c (c_in) the folded encoder affine; att_w
// (c, c) f32 with att = lf @ att_w; x and att_w 16-byte aligned. c = 2 c_in
// in {8, 16, ..., 256}; k <= 16. Writes out (B, n, c) f32.
extern "C" int m3d_lfa(const void* x, const void* pos, const void* idx, const void* enc_a,
                       const void* enc_c, const void* att_w, int B, int n, int k, int c_in,
                       int xt, void* out, void* stream) {
  using namespace m3d;
  const auto s = static_cast<cudaStream_t>(stream);
#define M3D_K2_CASE(C, P, NT, DEPTH)                                                  \
  case C:                                                                             \
    return static_cast<int>(                                                          \
        k2_launch<C, P, NT, DEPTH>(xt, x, pos, idx, enc_a, enc_c, att_w, B, n, k, out, s));
  switch (2 * c_in) {
    M3D_K2_WIDTHS(M3D_K2_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef M3D_K2_CASE
}

// K2's launch resources at width c (f32 x; the 16-bit instantiations take
// the same shared memory): info = [points per tile, 1, dynamic shared
// memory bytes, blocks per SM, SMs] (K6's layout, one band).
extern "C" int m3d_lfa_info(int c, void* info) {
  using namespace m3d;
  int* out = static_cast<int*>(info);
#define M3D_K2_INFO(C, P, NT, DEPTH)                                \
  case C:                                                           \
    out[0] = P;                                                     \
    out[1] = 1;                                                     \
    out[2] = K2<C, P, NT, DEPTH, lfa::X_F32>::SMEM;                 \
    return static_cast<int>(K2<C, P, NT, DEPTH, lfa::X_F32>::info(out[3], out[4]));
  switch (c) {
    M3D_K2_WIDTHS(M3D_K2_INFO)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef M3D_K2_INFO
}
