// pctl_native — host-side C++ kernels for the data layer.
//
// The reference's input pipeline leans on native code throughout (PDAL C++
// readers, torch_cluster grid_cluster C++ for GridSampling — reference
// configs/datamodule/transforms/preparations/points_budget.yaml:14-17).
// This module supplies the equivalents for the TPU build's host side:
//
//   grid_sample   voxel-grid pooling (pos/x mean, y majority vote with
//                 ties -> smallest code, voxels in lexicographic coord
//                 order — bit-compatible with the numpy fallback in
//                 pctl/transforms/transforms.py::GridSampling)
//   bin_windows_* the tile's points binned to the subtile mosaic, read from
//                 the records in place (pctl/dataset/utils.py::subtile_indices)
//   lidar_hd_rows a subtile's Lidar HD features from the tile's records
//                 (pctl/points_pre_transform/lidar_hd.py)
//
// Exposed with a plain C ABI for ctypes (no pybind11 in the image).
// Build: make -C myria3d_tpu/pctl/native  (or automatic on first import).

#include <algorithm>
#include <cerrno>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <thread>
#include <type_traits>
#include <vector>

#include <unistd.h>

extern "C" {

// Voxel-grid pooling.
//   pos       (n, 3) float32
//   x         (n, fdim) float32 (fdim may be 0)
//   y         (n,) int32 (ignored when has_y == 0); class codes in [0, 255]
//   size      voxel edge length
// Outputs (caller allocates n-sized buffers; only the first n_vox entries
// are written):
//   out_pos   (n, 3) float32 voxel means
//   out_x     (n, fdim) float32 voxel means
//   out_y     (n,) int32 voxel majority labels
//   inverse   (n,) int32 point -> voxel slot (for aggregating extra keys)
// Returns n_vox (or -1 on bad input).
int64_t grid_sample(const float* pos, const float* x, const int32_t* y,
                    int64_t n, int64_t fdim, float size, int has_y,
                    float* out_pos, float* out_x, int32_t* out_y,
                    int32_t* inverse) {
  if (n <= 0 || size <= 0.f) return -1;

  float mins[3] = {pos[0], pos[1], pos[2]};
  float maxs[3] = {pos[0], pos[1], pos[2]};
  for (int64_t i = 1; i < n; ++i) {
    for (int d = 0; d < 3; ++d) {
      const float v = pos[i * 3 + d];
      mins[d] = std::min(mins[d], v);
      maxs[d] = std::max(maxs[d], v);
    }
  }

  // Compact keys: cell counts come from the actual extent (a 50 m subtile
  // at 0.25 m is 201x201x~40 cells -> ~21 key bits), so the LSD radix
  // below runs the fewest 8-bit passes. Same x-major>y>z voxel order as
  // the 21-bit-per-axis packing this replaces (and the numpy fallback's
  // sorted-unique-key order) — ascending compact key == ascending packed
  // key because both are lexicographic in (cx, cy, cz).
  uint64_t dims[3];
  for (int d = 0; d < 3; ++d) {
    float v = std::floor((maxs[d] - mins[d]) / size);
    dims[d] = static_cast<uint64_t>(v < 0 ? 0 : v) + 1;
    dims[d] = std::min(dims[d], static_cast<uint64_t>(1) << 21);
  }
  std::vector<uint64_t> key(n);
  uint64_t key_max = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t c[3];
    for (int d = 0; d < 3; ++d) {
      float v = std::floor((pos[i * 3 + d] - mins[d]) / size);
      c[d] = std::min(static_cast<uint64_t>(v < 0 ? 0 : v), dims[d] - 1);
    }
    const uint64_t k = (c[0] * dims[1] + c[1]) * dims[2] + c[2];
    key[i] = k;
    key_max = std::max(key_max, k);
  }

  // stable LSD radix sort of (key, index) pairs, 8-bit digits, ping-pong
  // buffers: O(n) per pass vs the comparison sort's O(n log n) pointer-
  // chasing (measured 3-4x on the 30k-point production subtile). Stability
  // preserves ascending original index within a voxel — the accumulation
  // order of the numpy fallback (np.add.at in index order), so means stay
  // bit-compatible.
  int passes = 0;
  while ((key_max >> (8 * passes)) != 0 && passes < 8) ++passes;
  if (passes == 0) passes = 1;
  std::vector<int64_t> order(n), order2(n);
  std::iota(order.begin(), order.end(), 0);
  for (int p = 0; p < passes; ++p) {
    const int shift = 8 * p;
    int64_t hist[256] = {0};
    for (int64_t i = 0; i < n; ++i)
      ++hist[(key[order[i]] >> shift) & 0xff];
    int64_t off = 0;
    int64_t start[256];
    for (int b = 0; b < 256; ++b) { start[b] = off; off += hist[b]; }
    for (int64_t i = 0; i < n; ++i) {
      const int64_t idx = order[i];
      order2[start[(key[idx] >> shift) & 0xff]++] = idx;
    }
    order.swap(order2);
  }

  std::vector<double> pos_acc(3);
  std::vector<double> x_acc(fdim > 0 ? fdim : 1);
  // majority vote tracked incrementally (ties -> smallest class code, as
  // the one-hot argmax of the numpy fallback): only the classes actually
  // seen in a run are counted and reset — the 256-slot scan/memset per
  // voxel dominated when runs are short (real data: ~3 points/voxel).
  int y_count[256];
  std::memset(y_count, 0, sizeof(y_count));
  int touched[64];

  int64_t n_vox = 0;
  int64_t run_start = 0;
  while (run_start < n) {
    int64_t run_end = run_start;
    const uint64_t k = key[order[run_start]];
    std::fill(pos_acc.begin(), pos_acc.end(), 0.0);
    std::fill(x_acc.begin(), x_acc.end(), 0.0);
    int n_touched = 0, best = 256, best_cnt = 0;
    while (run_end < n && key[order[run_end]] == k) {
      const int64_t i = order[run_end];
      for (int d = 0; d < 3; ++d) pos_acc[d] += pos[i * 3 + d];
      for (int64_t f = 0; f < fdim; ++f) x_acc[f] += x[i * fdim + f];
      if (has_y) {
        const int32_t cls = y[i];
        if (cls >= 0 && cls < 256) {
          if (y_count[cls] == 0 && n_touched < 64) touched[n_touched++] = cls;
          const int c2 = ++y_count[cls];
          if (c2 > best_cnt || (c2 == best_cnt && cls < best)) {
            best = cls; best_cnt = c2;
          }
        }
      }
      inverse[i] = static_cast<int32_t>(n_vox);
      ++run_end;
    }
    const double cnt = static_cast<double>(run_end - run_start);
    for (int d = 0; d < 3; ++d)
      out_pos[n_vox * 3 + d] = static_cast<float>(pos_acc[d] / cnt);
    for (int64_t f = 0; f < fdim; ++f)
      out_x[n_vox * fdim + f] = static_cast<float>(x_acc[f] / cnt);
    if (has_y) {
      if (n_touched >= 64) {
        // overflowed the touched list (pathological >64 distinct classes
        // in one voxel): recompute by scan, then full reset
        best = 0; best_cnt = -1;
        for (int cls = 0; cls < 256; ++cls)
          if (y_count[cls] > best_cnt) { best = cls; best_cnt = y_count[cls]; }
        std::memset(y_count, 0, sizeof(y_count));
      } else {
        for (int t = 0; t < n_touched; ++t) y_count[touched[t]] = 0;
      }
      out_y[n_vox] = best == 256 ? 0 : best;
    }
    ++n_vox;
    run_start = run_end;
  }
  return n_vox;
}

// ---------------------------------------------------------------------------
// Mosaic window binning (subtile extraction): counting sort of point→window
// memberships. Window k along one axis spans
// [centers[k]-radius, centers[k]+radius] inclusive (the reference's
// Chebyshev ball query); a point can fall in several overlapping windows.
//
// X/Y are read straight from the tile's records (base pointer + record
// stride, f32 or f64 fields at any alignment) and the tile minimum is
// subtracted inline, in f64: f32→f64 is exact, so every relative coordinate
// equals the one computed on a staged (n, 2) f64 copy.
//
// Two calls over one split of the points into n_threads contiguous ranges:
// bin_windows_count finds the minima (numpy's: NaN if any value is NaN),
// fills each range's per-window counts and the prefix-sum offsets (length
// n_k*n_k + 1) and returns the total pair count;
// bin_windows_fill scatters each range's point indices from its own cursor
// (the window's offset plus the earlier ranges' counts in it), so every
// window lists its points in ascending order whatever the thread count.
// ---------------------------------------------------------------------------

static inline void axis_candidates(double c, const double* centers,
                                   int32_t n_k, double radius, double stride,
                                   double first, int32_t cmax, int32_t* ks,
                                   int32_t* count) {
  int64_t k_lo = (int64_t)std::floor((c - first - radius) / stride);
  int32_t m = 0;
  for (int32_t j = 0; j < cmax; ++j) {
    int64_t k = k_lo + j;
    if (k < 0 || k >= n_k) continue;
    double d = c - centers[k];
    if (d < 0) d = -d;
    if (d <= radius) ks[m++] = (int32_t)k;
  }
  *count = m;
}

}  // extern "C" (templates below need C++ linkage)

namespace {

// A record field as f64: type 8 = f32, 9 = f64 (the unpack table's enum).
inline double load_coord(const uint8_t* p, int32_t type) {
  if (type == 9) {
    double v;
    std::memcpy(&v, p, sizeof(v));
    return v;
  }
  float v;
  std::memcpy(&v, p, sizeof(v));
  return (double)v;
}

struct WindowGrid {
  const uint8_t* px;
  const uint8_t* py;
  int32_t tx, ty;
  int64_t rec_len;
  double minx, miny;
  const double* centers;
  int32_t n_k;
  double radius, stride;

  // visit(i, flat x-major window id) for every window holding point i, for
  // i in [lo, hi) in order
  template <typename Visit>
  void memberships(int64_t lo, int64_t hi, Visit visit) const {
    const double first = centers[0];
    const int32_t cmax = (int32_t)(2.0 * radius / stride) + 2;
    int32_t kx[8], ky[8], nx, ny;
    for (int64_t i = lo; i < hi; ++i) {
      const double cx = load_coord(px + i * rec_len, tx) - minx;
      const double cy = load_coord(py + i * rec_len, ty) - miny;
      axis_candidates(cx, centers, n_k, radius, stride, first, cmax, kx, &nx);
      axis_candidates(cy, centers, n_k, radius, stride, first, cmax, ky, &ny);
      for (int32_t a = 0; a < nx; ++a)
        for (int32_t b = 0; b < ny; ++b) visit(i, (int64_t)kx[a] * n_k + ky[b]);
    }
  }
};

// numpy's min of a field over the records [lo, hi): NaN if any is NaN.
double field_min(const uint8_t* p, int32_t type, int64_t rec_len, int64_t lo,
                 int64_t hi) {
  double m = INFINITY;
  bool nan = false;
  for (int64_t i = lo; i < hi; ++i) {
    const double v = load_coord(p + i * rec_len, type);
    if (v != v) nan = true;
    else if (v < m) m = v;
  }
  return nan ? NAN : m;
}

// fn(t, lo, hi) on n_threads contiguous ranges of [0, n), one thread each.
template <typename Fn>
void on_ranges(int64_t n, int32_t n_threads, Fn fn) {
  if (n_threads <= 1) {
    fn(0, 0, n);
    return;
  }
  const int64_t per = (n + n_threads - 1) / n_threads;
  std::vector<std::thread> workers;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t lo = std::min<int64_t>(t * per, n);
    workers.emplace_back(fn, t, lo, std::min<int64_t>(lo + per, n));
  }
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// counts: (n_threads, n_k*n_k) scratch and minima: (2,) X/Y minima, both
// written here and read again by bin_windows_fill.
int64_t bin_windows_count(const uint8_t* px, const uint8_t* py, int32_t tx,
                          int32_t ty, int64_t rec_len, int64_t n,
                          const double* centers, int32_t n_k, double radius,
                          double stride, int32_t n_threads, int64_t* counts,
                          int64_t* offsets /* n_k*n_k + 1 */,
                          double* minima) {
  std::vector<double> part(2 * (size_t)std::max(n_threads, 1), INFINITY);
  on_ranges(n, n_threads, [&](int32_t t, int64_t lo, int64_t hi) {
    part[2 * t] = field_min(px, tx, rec_len, lo, hi);
    part[2 * t + 1] = field_min(py, ty, rec_len, lo, hi);
  });
  for (int d = 0; d < 2; ++d) {
    minima[d] = INFINITY;
    for (size_t t = 0; t < part.size() / 2; ++t) {
      const double v = part[2 * t + d];
      if (v != v || v < minima[d]) minima[d] = v;
      if (v != v) break;
    }
  }
  const WindowGrid g{px, py, tx, ty, rec_len, minima[0], minima[1], centers,
                     n_k, radius, stride};
  const int64_t n_win = (int64_t)n_k * n_k;
  std::fill(counts, counts + (int64_t)std::max(n_threads, 1) * n_win, 0);
  on_ranges(n, n_threads, [&](int32_t t, int64_t lo, int64_t hi) {
    int64_t* c = counts + t * n_win;
    g.memberships(lo, hi, [c](int64_t, int64_t w) { ++c[w]; });
  });
  offsets[0] = 0;
  for (int64_t w = 0; w < n_win; ++w) {
    int64_t s = 0;
    for (int32_t t = 0; t < std::max(n_threads, 1); ++t) s += counts[t * n_win + w];
    offsets[w + 1] = offsets[w] + s;
  }
  return offsets[n_win];
}

void bin_windows_fill(const uint8_t* px, const uint8_t* py, int32_t tx,
                      int32_t ty, int64_t rec_len, int64_t n,
                      const double* centers, int32_t n_k, double radius,
                      double stride, int32_t n_threads, const int64_t* counts,
                      const int64_t* offsets, const double* minima,
                      int64_t* out_indices) {
  const WindowGrid g{px, py, tx, ty, rec_len, minima[0], minima[1], centers,
                     n_k, radius, stride};
  const int64_t n_win = (int64_t)n_k * n_k;
  const int32_t nt = std::max(n_threads, 1);
  std::vector<int64_t> cursors((size_t)(nt * n_win));
  for (int64_t w = 0; w < n_win; ++w) {
    int64_t c = offsets[w];
    for (int32_t t = 0; t < nt; ++t) {
      cursors[t * n_win + w] = c;
      c += counts[t * n_win + w];
    }
  }
  on_ranges(n, n_threads, [&](int32_t t, int64_t lo, int64_t hi) {
    int64_t* cur = cursors.data() + t * n_win;
    g.memberships(lo, hi, [cur, out_indices](int64_t i, int64_t w) {
      out_indices[cur[w]++] = i;
    });
  });
}

// ---------------------------------------------------------------------------
// Packed LAS point records -> all-float32 AoS column conversion.
//
// The f32 tile read (pctl/io/las.py::read_las_float32) is the serial head
// of every predict run: numpy's per-field strided copies over ~17 M x 30-38 B
// records cost ~10x a fused single-pass record walk. This kernel does the
// whole conversion in one pass per record (thread-parallel over record
// ranges; records are independent), driven by a field table the Python side
// derives from the LAS point-format dtype:
//   src_off  byte offset of the source field inside the record
//   src_type 0=u8 1=i8 2=u16 3=i16 4=u32 5=i32 6=u64 7=i64 8=f32 9=f64
//   shift/mask  bitfield extraction (value >> shift) & mask on the unsigned
//               integer load; mask == 0 means "no bitfield"
//   scale/offset  out = (double)v * scale + offset (scale 0 => v unscaled);
//               XYZ i32 grids use this (f64 math, single f32 rounding)
// Output: n records of n_fields little-endian f32 values (AoS, stride
// 4*n_fields) — exactly numpy's packed structured array of f32 columns.
// ---------------------------------------------------------------------------

}  // extern "C" (templates below need C++ linkage)

namespace {

// One field over a block of records: a tight strided loop with the type
// pair, bitfield, and affine variant all resolved BEFORE the loop — the
// naive record-major switch-per-element walk mispredicts its indirect
// branch on every element (the field type changes each iteration) and
// measured ~26 ns/field; this column-sweep runs at ~2 ns/field.
template <typename SRC, typename DST>
void unpack_field_block(const uint8_t* rec, int64_t cnt, int64_t rec_len,
                        int32_t shift, uint32_t mask, double scale,
                        double offset, uint8_t* dst, int64_t out_stride) {
  if (mask) {  // bitfield extract (integral sources only, by construction)
    for (int64_t i = 0; i < cnt; ++i) {
      SRC t;
      std::memcpy(&t, rec + i * rec_len, sizeof(SRC));
      const uint32_t u = ((uint32_t)(int64_t)t >> shift) & mask;
      const DST d = static_cast<DST>(u);
      std::memcpy(dst + i * out_stride, &d, sizeof(DST));
    }
  } else if (scale != 0.0) {  // affine descale (XYZ grid coords)
    for (int64_t i = 0; i < cnt; ++i) {
      SRC t;
      std::memcpy(&t, rec + i * rec_len, sizeof(SRC));
      const DST d = static_cast<DST>((double)t * scale + offset);
      std::memcpy(dst + i * out_stride, &d, sizeof(DST));
    }
  } else {  // plain convert/copy
    for (int64_t i = 0; i < cnt; ++i) {
      SRC t;
      std::memcpy(&t, rec + i * rec_len, sizeof(SRC));
      const DST d = static_cast<DST>(t);
      std::memcpy(dst + i * out_stride, &d, sizeof(DST));
    }
  }
}

template <typename SRC>
void unpack_dispatch_dst(int32_t dst_type, const uint8_t* rec, int64_t cnt,
                         int64_t rec_len, int32_t shift, uint32_t mask,
                         double scale, double offset, uint8_t* dst,
                         int64_t out_stride) {
  switch (dst_type) {
    case 0: unpack_field_block<SRC, uint8_t>(rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    case 1: unpack_field_block<SRC, int8_t>(rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    case 2: unpack_field_block<SRC, uint16_t>(rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    case 3: unpack_field_block<SRC, int16_t>(rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    case 4: unpack_field_block<SRC, uint32_t>(rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    case 5: unpack_field_block<SRC, int32_t>(rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    case 6: unpack_field_block<SRC, uint64_t>(rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    case 7: unpack_field_block<SRC, int64_t>(rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    case 8: unpack_field_block<SRC, float>(rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    case 9: unpack_field_block<SRC, double>(rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    default: break;
  }
}

void unpack_dispatch(int32_t src_type, int32_t dst_type, const uint8_t* rec,
                     int64_t cnt, int64_t rec_len, int32_t shift,
                     uint32_t mask, double scale, double offset, uint8_t* dst,
                     int64_t out_stride) {
  switch (src_type) {
    case 0: unpack_dispatch_dst<uint8_t>(dst_type, rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    case 1: unpack_dispatch_dst<int8_t>(dst_type, rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    case 2: unpack_dispatch_dst<uint16_t>(dst_type, rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    case 3: unpack_dispatch_dst<int16_t>(dst_type, rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    case 4: unpack_dispatch_dst<uint32_t>(dst_type, rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    case 5: unpack_dispatch_dst<int32_t>(dst_type, rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    case 6: unpack_dispatch_dst<uint64_t>(dst_type, rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    case 7: unpack_dispatch_dst<int64_t>(dst_type, rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    case 8: unpack_dispatch_dst<float>(dst_type, rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    case 9: unpack_dispatch_dst<double>(dst_type, rec, cnt, rec_len, shift, mask, scale, offset, dst, out_stride); break;
    default: break;
  }
}

// ---------------------------------------------------------------------------
// Typed columns -> packed LAS point records (the write-side mirror).
//
// write_las's numpy path assigns ~17 full-array strided columns into a
// 30-71 B record buffer (measured 88.7 s for a 17 M-point predict output
// on one core); this kernel packs every field in one thread-parallel pass.
// Table semantics (one row per record field; Python builds it from the
// point-format dtype — pctl/io/las.py::_native_pack_table):
//   src       column base pointer; src_stride 0 broadcasts a constant
//   src_type  same enum as the unpack kernel
//   mask/shift  bitfield INSERT: dst |= ((u64)v & mask) << shift
//               (dst buffer must be pre-zeroed; integral sources only)
//   scale/offset  inverse grid affine: dst = (DST)(i64)nearbyint(
//               ((double)v - offset) / scale) — nearbyint under the
//               default FE_TONEAREST mode = numpy's round-half-to-even
//   else      plain static_cast (numpy astype semantics)
// ---------------------------------------------------------------------------

template <typename SRC, typename DST>
void pack_field_block(const uint8_t* src, int64_t src_stride, int64_t cnt,
                      int32_t shift, uint64_t mask, double scale,
                      double offset, uint8_t* dst, int64_t rec_len) {
  if (mask) {  // bitfield insert (integral src AND dst, by construction)
    if constexpr (std::is_integral_v<DST> && std::is_integral_v<SRC>) {
      for (int64_t i = 0; i < cnt; ++i) {
        SRC t;
        std::memcpy(&t, src + i * src_stride, sizeof(SRC));
        DST cur;
        std::memcpy(&cur, dst + i * rec_len, sizeof(DST));
        const uint64_t u = (((uint64_t)(int64_t)t) & mask) << shift;
        cur = static_cast<DST>(cur | static_cast<DST>(u));
        std::memcpy(dst + i * rec_len, &cur, sizeof(DST));
      }
    }
  } else if (scale != 0.0) {  // inverse grid affine (XYZ)
    for (int64_t i = 0; i < cnt; ++i) {
      SRC t;
      std::memcpy(&t, src + i * src_stride, sizeof(SRC));
      const double r = std::nearbyint(((double)t - offset) / scale);
      const DST d = static_cast<DST>((int64_t)r);
      std::memcpy(dst + i * rec_len, &d, sizeof(DST));
    }
  } else {  // plain convert/copy
    for (int64_t i = 0; i < cnt; ++i) {
      SRC t;
      std::memcpy(&t, src + i * src_stride, sizeof(SRC));
      const DST d = static_cast<DST>(t);
      std::memcpy(dst + i * rec_len, &d, sizeof(DST));
    }
  }
}

template <typename SRC>
void pack_dispatch_dst(int32_t dst_type, const uint8_t* src,
                       int64_t src_stride, int64_t cnt, int32_t shift,
                       uint64_t mask, double scale, double offset,
                       uint8_t* dst, int64_t rec_len) {
  switch (dst_type) {
    case 0: pack_field_block<SRC, uint8_t>(src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    case 1: pack_field_block<SRC, int8_t>(src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    case 2: pack_field_block<SRC, uint16_t>(src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    case 3: pack_field_block<SRC, int16_t>(src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    case 4: pack_field_block<SRC, uint32_t>(src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    case 5: pack_field_block<SRC, int32_t>(src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    case 6: pack_field_block<SRC, uint64_t>(src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    case 7: pack_field_block<SRC, int64_t>(src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    case 8: pack_field_block<SRC, float>(src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    case 9: pack_field_block<SRC, double>(src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    default: break;
  }
}

void pack_dispatch(int32_t src_type, int32_t dst_type, const uint8_t* src,
                   int64_t src_stride, int64_t cnt, int32_t shift,
                   uint64_t mask, double scale, double offset, uint8_t* dst,
                   int64_t rec_len) {
  switch (src_type) {
    case 0: pack_dispatch_dst<uint8_t>(dst_type, src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    case 1: pack_dispatch_dst<int8_t>(dst_type, src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    case 2: pack_dispatch_dst<uint16_t>(dst_type, src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    case 3: pack_dispatch_dst<int16_t>(dst_type, src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    case 4: pack_dispatch_dst<uint32_t>(dst_type, src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    case 5: pack_dispatch_dst<int32_t>(dst_type, src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    case 6: pack_dispatch_dst<uint64_t>(dst_type, src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    case 7: pack_dispatch_dst<int64_t>(dst_type, src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    case 8: pack_dispatch_dst<float>(dst_type, src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    case 9: pack_dispatch_dst<double>(dst_type, src, src_stride, cnt, shift, mask, scale, offset, dst, rec_len); break;
    default: break;
  }
}

constexpr int64_t kUnpackBlock = 32768;  // records per L2-resident block

void unpack_records_range(const uint8_t* rec0, int64_t lo, int64_t hi,
                          int64_t rec_len, const int32_t* src_off,
                          const int32_t* src_type, const int32_t* shift,
                          const uint32_t* mask, const double* scale,
                          const double* offset, const int32_t* dst_off,
                          const int32_t* dst_type, int32_t n_fields,
                          int64_t out_stride, uint8_t* out) {
  for (int64_t b = lo; b < hi; b += kUnpackBlock) {
    const int64_t cnt = std::min<int64_t>(kUnpackBlock, hi - b);
    const uint8_t* rec = rec0 + b * rec_len;
    uint8_t* dst = out + b * out_stride;
    for (int32_t f = 0; f < n_fields; ++f) {
      unpack_dispatch(src_type[f], dst_type[f], rec + src_off[f], cnt,
                      rec_len, shift[f], mask[f], scale[f], offset[f],
                      dst + dst_off[f], out_stride);
    }
  }
}

void pack_records_range(const uint8_t* const* srcs, int64_t lo, int64_t hi,
                        const int64_t* src_strides, const int32_t* src_types,
                        const int32_t* shifts, const uint64_t* masks,
                        const double* scales, const double* offsets,
                        const int32_t* dst_offs, const int32_t* dst_types,
                        int32_t n_fields, int64_t rec_len, uint8_t* out) {
  for (int64_t b = lo; b < hi; b += kUnpackBlock) {
    const int64_t cnt = std::min<int64_t>(kUnpackBlock, hi - b);
    uint8_t* rec = out + b * rec_len;
    for (int32_t f = 0; f < n_fields; ++f) {
      pack_dispatch(src_types[f], dst_types[f], srcs[f] + b * src_strides[f],
                    src_strides[f], cnt, shifts[f], masks[f], scales[f],
                    offsets[f], rec + dst_offs[f], rec_len);
    }
  }
}

}  // namespace

extern "C" {

// Typed columns -> packed LAS records (field table from Python; see
// pctl/native/__init__.py::native_las_pack_records for the contract).
// `out` must be pre-zeroed (bitfield inserts OR into their bytes).
void las_pack_records(const uint8_t* const* srcs, const int64_t* src_strides,
                      const int32_t* src_types, const int32_t* shifts,
                      const uint64_t* masks, const double* scales,
                      const double* offsets, const int32_t* dst_offs,
                      const int32_t* dst_types, int32_t n_fields, int64_t n,
                      int32_t rec_len, int32_t n_threads, uint8_t* out) {
  if (n <= 0 || n_fields <= 0) return;
  int64_t nt = n_threads > 0
                   ? n_threads
                   : (int64_t)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  nt = std::min<int64_t>(nt, (n + (1 << 18) - 1) >> 18);  // >=256k rows/thread
  if (nt <= 1) {
    pack_records_range(srcs, 0, n, src_strides, src_types, shifts, masks,
                       scales, offsets, dst_offs, dst_types, n_fields,
                       rec_len, out);
    return;
  }
  std::vector<std::thread> workers;
  const int64_t per = (n + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    const int64_t lo = t * per;
    const int64_t hi = std::min<int64_t>(lo + per, n);
    if (lo >= hi) break;
    workers.emplace_back(pack_records_range, srcs, lo, hi, src_strides,
                         src_types, shifts, masks, scales, offsets, dst_offs,
                         dst_types, n_fields, (int64_t)rec_len, out);
  }
  for (auto& w : workers) w.join();
}

// Generic packed-record -> typed-column unpack (field table from Python;
// see pctl/native/__init__.py::native_las_unpack_records for the contract).
void las_unpack_records(const uint8_t* records, int64_t n, int32_t rec_len,
                        const int32_t* src_off, const int32_t* src_type,
                        const int32_t* shift, const uint32_t* mask,
                        const double* scale, const double* offset,
                        const int32_t* dst_off, const int32_t* dst_type,
                        int32_t n_fields, int32_t out_stride,
                        int32_t n_threads, uint8_t* out) {
  if (n <= 0 || n_fields <= 0) return;
  int64_t nt = n_threads > 0
                   ? n_threads
                   : (int64_t)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  nt = std::min<int64_t>(nt, (n + (1 << 18) - 1) >> 18);  // >=256k rows/thread
  if (nt <= 1) {
    unpack_records_range(records, 0, n, rec_len, src_off, src_type, shift,
                         mask, scale, offset, dst_off, dst_type, n_fields,
                         out_stride, out);
    return;
  }
  std::vector<std::thread> workers;
  const int64_t per = (n + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    const int64_t lo = t * per;
    const int64_t hi = std::min<int64_t>(lo + per, n);
    if (lo >= hi) break;
    workers.emplace_back(unpack_records_range, records, lo, hi,
                         (int64_t)rec_len, src_off, src_type, shift, mask,
                         scale, offset, dst_off, dst_type, n_fields,
                         (int64_t)out_stride, out);
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Predict-path host reduction: the overlap scatter-merge.
// ---------------------------------------------------------------------------

namespace {

// The overlap merge, duplicate-safe: for each list b in order, each row r
// in order, plane[idx[b][r]] += src[b][r] (f16 sources upcast in-flight),
// and covered[idx[b][r]] = 1. A thread owns the destination rows [lo, hi)
// and adds only the rows whose index falls there, in the caller's order, so
// every plane row sees the same additions in the same order as np.add.at
// over the same calls: the plane is bit-equal whatever the thread count.
// With `zero`, the owner first zeroes its rows (and coverage bytes) in
// order: a fresh plane takes its page faults in order and in parallel.
template <typename SRC>
void scatter_add_owned(float* plane, uint8_t* covered, int64_t lo, int64_t hi,
                       bool zero, const int64_t* const* idx,
                       const SRC* const* src, const int64_t* n_rows,
                       int32_t n_lists, int32_t c) {
  if (lo >= hi) return;
  if (zero) {
    std::memset(plane + lo * (int64_t)c, 0, sizeof(float) * (hi - lo) * c);
    if (covered) std::memset(covered + lo, 0, hi - lo);
  }
  const uint64_t span = (uint64_t)(hi - lo);
  for (int32_t b = 0; b < n_lists; ++b) {
    const int64_t* ib = idx[b];
    const SRC* sb = src[b];
    for (int64_t r = 0; r < n_rows[b]; ++r) {
      const int64_t d = ib[r];
      if ((uint64_t)(d - lo) >= span) continue;  // another thread's row
      float* dst = plane + d * (int64_t)c;
      const SRC* s = sb + r * (int64_t)c;
      for (int32_t j = 0; j < c; ++j) dst[j] += (float)s[j];
      if (covered) covered[d] = 1;
    }
  }
}

// At most this many threads a call (the merge shares the host with the
// loader's cook threads), and one a 64k rows of work (the rows added, plus
// the plane's rows when it is zeroed).
constexpr int64_t kMergeMaxThreads = 8;

template <typename SRC>
void scatter_add_rows_impl(float* plane, uint8_t* covered, int64_t n_plane,
                           bool zero, const int64_t* const* idx,
                           const SRC* const* src, const int64_t* n_rows,
                           int32_t n_lists, int32_t c, int32_t n_threads) {
  int64_t nt = n_threads;
  if (nt <= 0) {
    int64_t work = zero ? n_plane : 0;
    for (int32_t b = 0; b < n_lists; ++b) work += n_rows[b];
    nt = std::min<int64_t>((int64_t)std::thread::hardware_concurrency(),
                           kMergeMaxThreads);
    nt = std::min<int64_t>(nt, (work + (1 << 16) - 1) >> 16);
  }
  if (nt <= 1) {
    scatter_add_owned<SRC>(plane, covered, 0, n_plane, zero, idx, src, n_rows,
                           n_lists, c);
    return;
  }
  std::vector<std::thread> workers;
  const int64_t per = (n_plane + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    const int64_t lo = std::min<int64_t>(t * per, n_plane);
    const int64_t hi = std::min<int64_t>(lo + per, n_plane);
    workers.emplace_back(scatter_add_owned<SRC>, plane, covered, lo, hi, zero,
                         idx, src, n_rows, n_lists, c);
  }
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// Overlap merge of n_lists row lists into the (n_plane, c) f32 plane, in
// list order (see scatter_add_owned): any index order, repeats included.
// `covered` (n_plane bytes) may be null; `zero` zeroes plane and coverage
// first. src_type: 8 = f32, 10 = IEEE half (the wire format of the D2H
// logits). n_threads <= 0 picks the count from the rows and the machine.
void scatter_add_rows(float* plane, uint8_t* covered, int64_t n_plane,
                      int32_t zero, const int64_t* const* idx,
                      const void* const* src, const int64_t* n_rows,
                      int32_t n_lists, int32_t src_type, int32_t c,
                      int32_t n_threads) {
  if (n_plane <= 0 || c <= 0) return;
  if (src_type == 8) {
    scatter_add_rows_impl<float>(plane, covered, n_plane, zero != 0, idx,
                                 (const float* const*)src, n_rows, n_lists, c,
                                 n_threads);
  } else if (src_type == 10) {
    scatter_add_rows_impl<_Float16>(plane, covered, n_plane, zero != 0, idx,
                                    (const _Float16* const*)src, n_rows,
                                    n_lists, c, n_threads);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The tile's output LAS records from its merged logits, in one pass that
// writes them itself (pctl/io/las.py::write_las_predictions).
// ---------------------------------------------------------------------------

namespace {

// fn(T{}) with T the C type of a field of the unpack table's enum.
template <typename Fn>
void with_type(int32_t type, Fn fn) {
  switch (type) {
    case 0: fn(uint8_t{}); break;
    case 1: fn(int8_t{}); break;
    case 2: fn(uint16_t{}); break;
    case 3: fn(int16_t{}); break;
    case 4: fn(uint32_t{}); break;
    case 5: fn(int32_t{}); break;
    case 6: fn(uint64_t{}); break;
    case 7: fn(int64_t{}); break;
    case 8: fn(float{}); break;
    case 9: fn(double{}); break;
    default: break;
  }
}

// One row of merged logits: softmax -> p, the argmax, and entropy = log z
// + m - sum(p * logit) clipped at 0 (the stable formulation of the numpy
// chain in myria3d_tpu/models/interpolation.py, and the arithmetic of the
// JAX package's native logits_finalize, operation for operation).
inline void finalize_row(const float* l, int32_t c, float* p, int32_t* argmax,
                         float* entropy) {
  float m = l[0];
  int32_t am = 0;
  for (int32_t j = 1; j < c; ++j)
    if (l[j] > m) { m = l[j]; am = j; }
  float z = 0.0f;
  for (int32_t j = 0; j < c; ++j) {
    p[j] = std::exp(l[j] - m);
    z += p[j];
  }
  float dot = 0.0f;
  const float inv_z = 1.0f / z;
  for (int32_t j = 0; j < c; ++j) {
    p[j] *= inv_z;
    dot += p[j] * l[j];
  }
  *argmax = am;
  const float h = std::log(z) + m - dot;
  *entropy = h > 0.0f ? h : 0.0f;
}

// A column of the points (base pointer, byte stride, enum type; -1 absent).
struct Column {
  const uint8_t* p;
  int64_t stride;
  int32_t type;
};

// The columns the pass reads besides the pack table, in this order.
enum { kX, kY, kZ, kReturnNumber, kClassification, kColumns };

// Rows a block of the pack: ~55-71 KB of source rows and as much of
// records, inside a core's L2 (one field at a time over a whole chunk
// streams the chunk's source once a field).
constexpr int64_t kPackRows = 1024;

// What one thread gathers over its points: numpy's min and max of X, Y and
// Z (NaN if any is NaN: the first NaN met), the clip(ReturnNumber, 1, 15)
// counts, its seconds in the sink, and the errno of a failed write.
struct ThreadTally {
  double lo[3] = {INFINITY, INFINITY, INFINITY};
  double hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  double nan[3] = {0.0, 0.0, 0.0};
  bool has_nan[3] = {false, false, false};
  uint64_t by_return[15] = {};
  double io_s = 0.0;
  int32_t err = 0;
};

struct PredictionPass {
  // sink: fd >= 0 pwrites the records at point_offset; else copies to mem
  int32_t fd;
  int64_t point_offset;
  uint8_t* mem;
  // records the fields are packed over (null: zeros)
  const uint8_t* base;
  // the pack table (las_pack_records's)
  const uint8_t* const* srcs;
  const int64_t* src_strides;
  const int32_t* src_types;
  const int32_t* shifts;
  const uint64_t* masks;
  const double* scales;
  const double* offsets;
  const int32_t* dst_offs;
  const int32_t* dst_types;
  int32_t n_fields;
  int64_t rec_len;
  // the channels
  const float* logits;
  int32_t c;
  const uint8_t* covered;
  const uint8_t* class_map;
  const int32_t* proba_offs;
  int32_t class_off, entropy_off;
  Column cols[kColumns];

  // the records [lo, lo + cnt) packed into buf, kPackRows at a time: a
  // block's source rows and records stay in the core's cache across the
  // fields and the channels
  void pack(int64_t lo, int64_t cnt, uint8_t* buf, float* p) const {
    for (int64_t b = 0; b < cnt; b += kPackRows) {
      const int64_t m = std::min(kPackRows, cnt - b);
      uint8_t* blk = buf + b * rec_len;
      if (base) std::memcpy(blk, base + (lo + b) * rec_len, m * rec_len);
      else std::memset(blk, 0, m * rec_len);
      for (int32_t f = 0; f < n_fields; ++f)
        pack_dispatch(src_types[f], dst_types[f], srcs[f] + (lo + b) * src_strides[f],
                      src_strides[f], m, shifts[f], masks[f], scales[f],
                      offsets[f], blk + dst_offs[f], rec_len);
      channels(lo + b, m, blk, p);
    }
  }

  // the channels of the points [lo, lo + m) into their records at blk
  void channels(int64_t lo, int64_t m, uint8_t* blk, float* p) const {
    const Column& cls = cols[kClassification];
    for (int64_t r = 0; r < m; ++r) {
      const int64_t i = lo + r;
      int32_t am;
      float h;
      finalize_row(logits + i * (int64_t)c, c, p, &am, &h);
      uint8_t code = class_map[am];
      if (covered && !covered[i]) {  // no subtile predicted the point
        std::fill(p, p + c, 0.0f);
        h = 0.0f;
        if (cls.type >= 0)
          with_type(cls.type, [&](auto tag) {
            using T = decltype(tag);
            T v;
            std::memcpy(&v, cls.p + i * cls.stride, sizeof(T));
            code = static_cast<uint8_t>(v);
          });
      }
      uint8_t* rec = blk + r * rec_len;
      for (int32_t j = 0; j < c; ++j)
        if (proba_offs[j] >= 0) std::memcpy(rec + proba_offs[j], p + j, sizeof(float));
      if (class_off >= 0) rec[class_off] = code;
      if (entropy_off >= 0) std::memcpy(rec + entropy_off, &h, sizeof(float));
    }
  }

  // the bounds and return counts of the points [lo, hi)
  void tally(int64_t lo, int64_t hi, ThreadTally& t) const {
    for (int a = 0; a < 3; ++a) {
      const Column& col = cols[kX + a];
      with_type(col.type, [&](auto tag) {
        using T = decltype(tag);
        double mn = t.lo[a], mx = t.hi[a];
        for (int64_t i = lo; i < hi; ++i) {
          T raw;
          std::memcpy(&raw, col.p + i * col.stride, sizeof(T));
          const double v = (double)raw;
          if (v != v) {
            if (!t.has_nan[a]) { t.has_nan[a] = true; t.nan[a] = v; }
          } else {
            mn = v < mn ? v : mn;
            mx = v > mx ? v : mx;
          }
        }
        t.lo[a] = mn;
        t.hi[a] = mx;
      });
    }
    const Column& rn = cols[kReturnNumber];
    with_type(rn.type, [&](auto tag) {
      using T = decltype(tag);
      for (int64_t i = lo; i < hi; ++i) {
        T raw;
        std::memcpy(&raw, rn.p + i * rn.stride, sizeof(T));
        const uint8_t r = static_cast<uint8_t>(raw);  // numpy's astype(uint8)
        ++t.by_return[r < 1 ? 0 : (r > 15 ? 14 : r - 1)];
      }
    });
  }

  // the packed records [lo, lo + cnt) to the sink
  void emit(const uint8_t* buf, int64_t lo, int64_t cnt, ThreadTally& t) const {
    const auto t0 = std::chrono::steady_clock::now();
    const int64_t len = cnt * rec_len, at = lo * rec_len;
    if (fd < 0) {
      std::memcpy(mem + at, buf, len);
    } else {
      for (int64_t done = 0; done < len && !t.err;) {
        const ssize_t w = pwrite(fd, buf + done, len - done, point_offset + at + done);
        if (w > 0) done += w;
        else if (w < 0 && errno != EINTR) t.err = errno;
        else if (w == 0) t.err = EIO;
      }
    }
    t.io_s += std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
  }

  // chunks [c0, c1) of `chunk` points, in order, through one reused buffer
  void run(int64_t c0, int64_t c1, int64_t chunk, int64_t n, ThreadTally& t) const {
    std::vector<uint8_t> buf(std::min(chunk, n) * rec_len);
    std::vector<float> p(c);
    for (int64_t k = c0; k < c1 && !t.err; ++k) {
      const int64_t lo = k * chunk, cnt = std::min(chunk, n - lo);
      pack(lo, cnt, buf.data(), p.data());
      tally(lo, lo + cnt, t);
      emit(buf.data(), lo, cnt, t);
    }
  }
};

// At most this many threads a pass (the host's cook and read-ahead threads
// share it with the next tile).
constexpr int64_t kWriteMaxThreads = 8;

}  // namespace

extern "C" {

// The n output records of a tile, packed from the points by the pack table
// (las_pack_records's; over `base`'s records when given, else over zeros),
// with each point's channels from its row of the (n, c) f32 merged logits:
// the probability of class j at byte proba_offs[j] (-1: not written), the
// class code class_map[argmax] at class_off and the entropy at entropy_off
// (-1: not written). A point whose covered byte is 0 (covered null: every
// point is covered) gets probability 0 and entropy 0, and keeps its
// Classification column (type -1: the code of the argmax). The points go
// in chunks of `chunk`, contiguous runs of chunks to up to n_threads
// threads (<= 0: min(8, cores)), never more threads than chunks; each
// thread packs a chunk into a buffer it reuses, then pwrites it to fd at
// point_offset + lo * rec_len (fd < 0: copies it to mem at lo * rec_len).
// cols: X, Y, Z, ReturnNumber (stride 0 broadcasts), Classification.
// Writes bounds (min X, Y, Z, max X, Y, Z: numpy's min and max, NaN if any
// is NaN), by_return (15 counts of clip(uint8(ReturnNumber), 1, 15)), the
// seconds the threads spent in the sink, averaged over them, and the thread
// count. Returns 0, or the errno of the first failed write.
int32_t las_write_predictions(
    int32_t fd, int64_t point_offset, uint8_t* mem, const uint8_t* base,
    const uint8_t* const* srcs, const int64_t* src_strides,
    const int32_t* src_types, const int32_t* shifts, const uint64_t* masks,
    const double* scales, const double* offsets, const int32_t* dst_offs,
    const int32_t* dst_types, int32_t n_fields, int64_t n, int32_t rec_len,
    const float* logits, int32_t c, const uint8_t* covered,
    const uint8_t* class_map, const int32_t* proba_offs, int32_t class_off,
    int32_t entropy_off, const uint8_t* const* col_ptrs,
    const int64_t* col_strides, const int32_t* col_types, int64_t chunk,
    int32_t n_threads, double* bounds, uint64_t* by_return, double* io_s,
    int32_t* threads_used) {
  PredictionPass pass{fd, point_offset, mem, base, srcs, src_strides,
                      src_types, shifts, masks, scales, offsets, dst_offs,
                      dst_types, n_fields, (int64_t)rec_len, logits, c,
                      covered, class_map, proba_offs, class_off, entropy_off,
                      {}};
  for (int k = 0; k < kColumns; ++k)
    pass.cols[k] = Column{col_ptrs[k], col_strides[k], col_types[k]};
  *io_s = 0.0;
  *threads_used = 0;
  if (n <= 0 || c <= 0 || chunk <= 0) return 0;
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  int64_t nt = n_threads > 0
                   ? n_threads
                   : std::min<int64_t>(kWriteMaxThreads,
                                       (int64_t)std::thread::hardware_concurrency());
  nt = std::max<int64_t>(1, std::min(nt, n_chunks));
  std::vector<ThreadTally> tallies(nt);
  if (nt == 1) {
    pass.run(0, n_chunks, chunk, n, tallies[0]);
  } else {
    std::vector<std::thread> workers;
    for (int64_t t = 0; t < nt; ++t)
      workers.emplace_back([&, t] {
        pass.run(t * n_chunks / nt, (t + 1) * n_chunks / nt, chunk, n, tallies[t]);
      });
    for (auto& w : workers) w.join();
  }
  for (int a = 0; a < 3; ++a) {
    double mn = INFINITY, mx = -INFINITY;
    bool has_nan = false;
    double nan = 0.0;
    for (const ThreadTally& t : tallies) {
      if (t.has_nan[a] && !has_nan) { has_nan = true; nan = t.nan[a]; }
      mn = t.lo[a] < mn ? t.lo[a] : mn;
      mx = t.hi[a] > mx ? t.hi[a] : mx;
    }
    bounds[a] = has_nan ? nan : mn;
    bounds[3 + a] = has_nan ? nan : mx;
  }
  std::fill(by_return, by_return + 15, 0);
  double io = 0.0;
  int32_t err = 0;
  for (const ThreadTally& t : tallies) {
    for (int r = 0; r < 15; ++r) by_return[r] += t.by_return[r];
    io += t.io_s;
    if (!err) err = t.err;
  }
  *io_s = io / nt;
  *threads_used = (int32_t)nt;
  return err;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The Lidar HD features of one subtile, straight from the tile's records.
// ---------------------------------------------------------------------------

namespace {

template <typename T>
inline T load(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}

// A record field as f64, numpy's astype(float64): exact for every type
// taken here (the unpack table's enum: 0-5 the integers of up to 32 bits,
// 8 f32, 9 f64). So (float) of it is numpy's astype(float32), one rounding
// of the exact value, whatever promotion numpy took on the way.
inline double field(const uint8_t* p, int32_t type) {
  switch (type) {
    case 0: return load<uint8_t>(p);
    case 1: return load<int8_t>(p);
    case 2: return load<uint16_t>(p);
    case 3: return load<int16_t>(p);
    case 4: return load<uint32_t>(p);
    case 5: return load<int32_t>(p);
    case 8: return load<float>(p);
    default: return load<double>(p);
  }
}

// field / 7.0 as numpy divides it: an f32 field by a Python float stays
// f32, every other type divides in f64; then the feature stack's f32.
inline float return_norm(const uint8_t* p, int32_t type) {
  if (type == 8) return load<float>(p) / 7.0f;
  return (float)(field(p, type) / 7.0);
}

constexpr int kFeatureFields = 11;
// The rows are scattered over the tile: a record this many rows ahead is
// prefetched (both its cache lines), so the loads overlap the arithmetic.
constexpr int64_t kPrefetchRows = 32;

}  // namespace

extern "C" {

// pctl/points_pre_transform/lidar_hd.py::lidar_hd_pre_transform on the
// records idx[0..n) of the tile (rec_len bytes apart from base, any
// alignment), without gathering them first. Fields (byte offset, type) in
// the order X Y Z Intensity ReturnNumber NumberOfReturns Red Green Blue
// Infrared Classification; type -1 is a missing color, which reads 0.
// Writes pos (n, 3) f32, x (n, 9) f32 (Intensity, ReturnNumber/7,
// NumberOfReturns/7, Red, Green, Blue, Infrared, rgb_avg, ndvi) and y (n,)
// i64, each value by numpy's op sequence there, in its precision:
// colors f32 / 65280 in f32 and 0 where ReturnNumber > 1, rgb_avg
// ((r + g) + b) / 3 in f32 (the mean's order), ndvi (ir - r) / ((ir + r) +
// f32(1e-6)) in f32. No product appears, so nothing can be contracted.
// Returns a bit mask of the colors (bit 0 Red .. bit 3 Infrared) holding a
// value above 65280 or a NaN (numpy's `max() <= 65280` assertion).
int32_t lidar_hd_rows(const uint8_t* base, int64_t rec_len,
                      const int64_t* idx, int64_t n, const int32_t* offs,
                      const int32_t* types, float* pos, float* x,
                      int64_t* y) {
  const float eps = (float)1e-6;  // np.float32(1e-6): the f64 literal rounded
  int32_t too_high = 0;
  int32_t o[kFeatureFields], t[kFeatureFields];
  std::memcpy(o, offs, sizeof(o));
  std::memcpy(t, types, sizeof(t));
  for (int64_t i = 0; i < n; ++i) {
    if (i + kPrefetchRows < n) {
      const uint8_t* ahead = base + idx[i + kPrefetchRows] * rec_len;
      __builtin_prefetch(ahead);
      __builtin_prefetch(ahead + rec_len - 1);
    }
    const uint8_t* r = base + idx[i] * rec_len;
    for (int d = 0; d < 3; ++d) pos[i * 3 + d] = (float)field(r + o[d], t[d]);
    float* xi = x + i * 9;
    xi[0] = (float)field(r + o[3], t[3]);
    xi[1] = return_norm(r + o[4], t[4]);
    xi[2] = return_norm(r + o[5], t[5]);
    const bool occluded = field(r + o[4], t[4]) > 1.0;
    float col[4];
    for (int j = 0; j < 4; ++j) {
      if (t[6 + j] < 0) {
        col[j] = 0.0f;
        continue;
      }
      const float c = (float)field(r + o[6 + j], t[6 + j]);
      if (!(c <= 65280.0f)) too_high |= 1 << j;
      col[j] = occluded ? 0.0f : c / 65280.0f;
    }
    for (int j = 0; j < 4; ++j) xi[3 + j] = col[j];
    xi[7] = ((col[0] + col[1]) + col[2]) / 3.0f;
    xi[8] = (col[3] - col[0]) / ((col[3] + col[0]) + eps);
    y[i] = (int64_t)field(r + o[10], t[10]);
  }
  return too_high;
}

}  // extern "C"
