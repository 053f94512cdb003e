"""pctl.native — ctypes loader for the C++ host kernels.

Builds ``pctl_native.cpp`` (and ``laszip_native.cpp``) with g++ on first
use. The library is required, as the port's CUDA library is: ``get_lib`` and
``get_laz_lib`` raise ``RuntimeError`` with g++'s error when they cannot
build. A wrapper returns None only for an input its C++ cannot take, and the
caller then takes its numpy route:

- ``native_bin_windows_fields``: X/Y that are not native-order f32/f64, or a
  window candidate buffer over 8 → the lexsort binning
  (``pctl/dataset/utils.py::subtile_indices``);
- ``native_lidar_hd_rows``: a missing or unreadable field → the gather and
  the numpy features (``pctl/dataset/tile_stream.py``);
- ``native_grid_sample``: an input the C++ refuses → numpy ``GridSampling``
  (``pctl/transforms/transforms.py``);
- the LAS record unpack and pack: field types their tables cannot express →
  numpy (``pctl/io/las.py``).

Copied from ``myria3d_tpu/pctl/native/__init__.py``; the ``.cpp`` sources
are copies, the code unchanged (one comment of ``laszip_native.cpp`` names
its test file without a host path) but for the overlap merge, the subtile
front end and the tile's output records: the port's ``scatter_add_rows``
takes a whole batch of row lists in any index order, repeats included
(``native_scatter_add_rows``); its window binning reads f32 or f64 X/Y from
the records in place on several threads (``native_bin_windows_fields``; the
staged (n, 2) f64 route is gone); ``lidar_hd_rows`` builds a subtile's
Lidar HD features from the tile's records (``native_lidar_hd_rows``); and
the softmax, class and entropy of the tile's merged logits go with the
record pack, the bounds and the return counts into one pass whose threads
write the output file (``native_las_write_predictions``; the JAX package's
``logits_finalize`` is gone from the copy). The libraries are built into
``build/myria3d_tpu_torch/`` at the repository root instead of beside the
sources: ``-march=native`` code is right only for the machine that built
it, so the library name hashes the source, the flags and the host, and a
build is published atomically (parallel test workers never load a
half-written library).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(_DIR))),
                          "build", "myria3d_tpu_torch")
_SRC = os.path.join(_DIR, "pctl_native.cpp")
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]


def _build_so(src: str, flags: list, timeout: int) -> str:
    """Path of ``src`` compiled with ``flags`` for this host, built on the
    first call (raises ``OSError``/``SubprocessError`` on failure)."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(flags + [platform.machine(), platform.node()]).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    so = os.path.join(_BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")
    if os.path.isfile(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *flags, src, "-o", tmp],
                       check=True, capture_output=True, timeout=timeout)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def _load(src: str, flags: list, timeout: int) -> ctypes.CDLL:
    """``src`` built for this host and loaded; ``RuntimeError`` with g++'s
    error when it cannot build."""
    try:
        so = _build_so(src, flags, timeout)
    except (OSError, subprocess.SubprocessError) as e:
        stderr = getattr(e, "stderr", None) or b""
        raise RuntimeError(f"g++ could not build {os.path.basename(src)} ({e}):\n"
                           f"{stderr.decode(errors='replace')}") from e
    return ctypes.CDLL(so)


_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = _load(_SRC, _FLAGS, 120)
    lib.grid_sample.restype = ctypes.c_int64
    lib.grid_sample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    dp = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    _u8p = ctypes.POINTER(ctypes.c_uint8)
    _bin_args = [
        _u8p, _u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int64, dp, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
        ctypes.c_int32,
    ]
    lib.bin_windows_count.restype = ctypes.c_int64
    lib.bin_windows_count.argtypes = _bin_args + [i64p, i64p, dp]
    lib.bin_windows_fill.restype = None
    lib.bin_windows_fill.argtypes = _bin_args + [i64p, i64p, dp, i64p]
    lib.lidar_hd_rows.restype = ctypes.c_int32
    lib.lidar_hd_rows.argtypes = [
        _u8p, ctypes.c_int64, i64p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), i64p,
    ]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.las_unpack_records.restype = None
    lib.las_unpack_records.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int32,
        i32p, i32p, i32p, u32p, dp, dp, i32p, i32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, u8p,
    ]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    vpp = ctypes.POINTER(ctypes.c_void_p)
    lib.las_pack_records.restype = None
    lib.las_pack_records.argtypes = [
        vpp, i64p, i32p, i32p, u64p, dp, dp, i32p, i32p,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, u8p,
    ]
    fp = ctypes.POINTER(ctypes.c_float)
    lib.scatter_add_rows.restype = None
    lib.scatter_add_rows.argtypes = [
        fp, u8p, ctypes.c_int64, ctypes.c_int32, vpp, vpp, i64p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.las_write_predictions.restype = ctypes.c_int32
    lib.las_write_predictions.argtypes = [
        ctypes.c_int32, ctypes.c_int64, u8p, u8p,
        vpp, i64p, i32p, i32p, u64p, dp, dp, i32p, i32p, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int32,
        fp, ctypes.c_int32, u8p, u8p, i32p, ctypes.c_int32, ctypes.c_int32,
        vpp, i64p, i32p, ctypes.c_int64, ctypes.c_int32,
        dp, u64p, dp, i32p,
    ]
    _lib = lib
    return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def native_grid_sample(
    pos: np.ndarray,
    x: Optional[np.ndarray],
    y: Optional[np.ndarray],
    size: float,
) -> Optional[Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray], np.ndarray]]:
    """(pos_mean, x_mean, y_majority, inverse), or None when the C++
    refuses the input."""
    lib = get_lib()
    n = pos.shape[0]
    pos_c = np.ascontiguousarray(pos, np.float32)
    fdim = 0 if x is None else int(x.shape[1])
    x_c = (
        np.ascontiguousarray(x, np.float32)
        if x is not None else np.zeros((n, 0), np.float32)
    )
    has_y = y is not None
    y_c = (
        np.ascontiguousarray(y, np.int32) if has_y else np.zeros(n, np.int32)
    )
    out_pos = np.empty((n, 3), np.float32)
    out_x = np.empty((n, max(fdim, 1)), np.float32)
    out_y = np.empty(n, np.int32)
    inverse = np.empty(n, np.int32)
    n_vox = lib.grid_sample(
        _fptr(pos_c), _fptr(x_c), _iptr(y_c),
        ctypes.c_int64(n), ctypes.c_int64(fdim), ctypes.c_float(size),
        ctypes.c_int(1 if has_y else 0),
        _fptr(out_pos), _fptr(out_x), _iptr(out_y), _iptr(inverse),
    )
    if n_vox < 0:
        return None
    return (
        out_pos[:n_vox].copy(),
        out_x[:n_vox, :fdim].copy() if fdim else None,
        out_y[:n_vox].copy() if has_y else None,
        inverse,
    )


# At most this many threads bin a tile, and one a 256k points.
_BIN_MAX_THREADS = 8
_COORD_TYPES = {np.dtype("<f4"): 8, np.dtype("<f8"): 9}


def native_bin_windows_fields(
    points: np.ndarray, centers: np.ndarray, radius: float, stride: float
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Counting-sort point→mosaic-window binning (C++), reading X/Y straight
    from the records (f32 or f64 fields, any record size and alignment: no
    (n, 2) f64 staging).

    Returns (offsets (n_k²+1,) int64 prefix sums over x-major flat window
    ids, indices int64 grouped by window, ascending within each) or None
    when X/Y are not native-order f32/f64. Membership
    is the inclusive Chebyshev test ``|coord - center| <= radius`` per axis
    on ``coord - min(coord)`` in f64 — bit-compatible with the numpy path
    in ``pctl/dataset/utils.py``, whatever the thread count.
    """
    lib = get_lib()
    fields = points.dtype.fields or {}
    if "X" not in fields or "Y" not in fields or points.ndim != 1:
        return None
    tx, ty = _COORD_TYPES.get(fields["X"][0]), _COORD_TYPES.get(fields["Y"][0])
    if tx is None or ty is None:
        return None
    if int(2 * radius / stride) + 2 > 8:  # C++ per-axis candidate buffer
        return None
    n = points.shape[0]
    if n == 0:
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    base = points.ctypes.data
    cen = np.ascontiguousarray(centers, np.float64)
    n_k = len(cen)
    threads = max(1, min(_BIN_MAX_THREADS, os.cpu_count() or 1, n >> 18))
    args = [
        ctypes.cast(base + fields["X"][1], u8p), ctypes.cast(base + fields["Y"][1], u8p),
        ctypes.c_int32(tx), ctypes.c_int32(ty), ctypes.c_int64(points.strides[0]),
        ctypes.c_int64(n), cen.ctypes.data_as(dp), ctypes.c_int32(n_k),
        ctypes.c_double(radius), ctypes.c_double(stride), ctypes.c_int32(threads),
    ]
    counts = np.empty((threads, max(n_k * n_k, 1)), np.int64)
    offsets = np.empty(n_k * n_k + 1, np.int64)
    minima = np.empty(2, np.float64)   # of the f64 values: an f32 minimum converts exactly
    total = lib.bin_windows_count(*args, counts.ctypes.data_as(i64p),
                                  offsets.ctypes.data_as(i64p), minima.ctypes.data_as(dp))
    indices = np.empty(max(int(total), 1), np.int64)
    lib.bin_windows_fill(*args, counts.ctypes.data_as(i64p), offsets.ctypes.data_as(i64p),
                         minima.ctypes.data_as(dp), indices.ctypes.data_as(i64p))
    return offsets, indices[: int(total)]


# The fields lidar_hd_rows reads, in its order; a missing color reads 0.
_FEATURE_FIELDS = ("X", "Y", "Z", "Intensity", "ReturnNumber", "NumberOfReturns",
                   "Red", "Green", "Blue", "Infrared", "Classification")
_COLOR_FIELDS = ("Red", "Green", "Blue", "Infrared")


def native_lidar_hd_rows(
    points: np.ndarray, idx: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
    """The Lidar HD features of the records ``points[idx]`` (C++), read in
    place from the 1-D structured array ``points``: (pos (n, 3) f32, x (n, 9)
    f32, y (n,) int64, a bit mask of the colors, Red first, holding a value
    above 65280), bit-equal to
    ``pctl/points_pre_transform/lidar_hd.py::lidar_hd_pre_transform(points[idx])``.
    Releases the interpreter lock. None when a field other than a color is
    missing, or a field is not a native-order integer of up to 32 bits, f32
    or f64."""
    lib = get_lib()
    fields = points.dtype.fields or {}
    if points.ndim != 1:
        return None
    offs = np.zeros(len(_FEATURE_FIELDS), np.int32)
    types = np.full(len(_FEATURE_FIELDS), -1, np.int32)
    for j, name in enumerate(_FEATURE_FIELDS):
        if name not in fields:
            if name in _COLOR_FIELDS:
                continue
            return None
        ft, off = fields[name][:2]
        code = NATIVE_TYPE_ENUM.get(ft.str.lstrip("<=|")) if ft.isnative else None
        if code is None or code in (6, 7):
            return None
        offs[j], types[j] = off, code
    idx = np.ascontiguousarray(idx, np.int64)
    n = len(idx)
    if n and (idx.min() < 0 or idx.max() >= len(points)):
        raise IndexError(f"a row index outside the tile's {len(points)} points")
    pos = np.empty((n, 3), np.float32)
    x = np.empty((n, 9), np.float32)
    y = np.empty(n, np.int64)
    too_high = lib.lidar_hd_rows(
        ctypes.cast(points.ctypes.data, ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(points.strides[0]), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n), _iptr(offs), _iptr(types), _fptr(pos), _fptr(x),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return pos, x, y, int(too_high)


# ---------------------------------------------------------------------------
# LASzip codec (laszip_native.cpp): LAZ point-block compress/decompress
# ---------------------------------------------------------------------------

_LAZ_SRC = os.path.join(_DIR, "laszip_native.cpp")
_laz_lib: Optional[ctypes.CDLL] = None


def get_laz_lib() -> ctypes.CDLL:
    global _laz_lib
    if _laz_lib is not None:
        return _laz_lib
    lib = _load(_LAZ_SRC, ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"], 180)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.laz_decompress.restype = ctypes.c_int64
    lib.laz_decompress.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        i32p, i32p, ctypes.c_int32, u8p,
    ]
    lib.laz_compress.restype = ctypes.c_int64
    lib.laz_compress.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        i32p, i32p, ctypes.c_int32, u8p, ctypes.c_int64,
    ]
    lib.laz_decompress_layered.restype = ctypes.c_int64
    lib.laz_decompress_layered.argtypes = list(lib.laz_decompress.argtypes)
    lib.laz_compress_layered.restype = ctypes.c_int64
    lib.laz_compress_layered.argtypes = list(lib.laz_compress.argtypes)
    _laz_lib = lib
    return _laz_lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def laz_decompress_points(
    file_bytes: bytes,
    point_offset: int,
    num_points: int,
    chunk_size: int,
    items: "list[tuple[int, int]]",
    layered: bool = False,
) -> np.ndarray:
    """Decode a chunked LAZ point block → raw point-record bytes.

    ``items`` is the laszip VLR item list as (type, size) pairs;
    ``layered=True`` selects the compressor-3 (LAS 1.4 point formats 6+)
    layered decoder. Returns a uint8 array of shape
    (num_points * point_size,). Raises ValueError on malformed streams.
    """
    lib = get_laz_lib()
    buf = np.frombuffer(file_bytes, np.uint8)
    types = np.asarray([t for t, _ in items], np.int32)
    sizes = np.asarray([s for _, s in items], np.int32)
    point_size = int(sizes.sum())
    out = np.empty(num_points * point_size, np.uint8)
    fn = lib.laz_decompress_layered if layered else lib.laz_decompress
    got = fn(
        _u8ptr(buf), ctypes.c_int64(len(file_bytes)),
        ctypes.c_int64(point_offset), ctypes.c_int64(num_points),
        ctypes.c_int32(chunk_size),
        types.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(len(items)), _u8ptr(out),
    )
    if got == -8:
        raise ValueError(
            "LAZ layer-stream desync: the file's entropy models do not "
            "match this decoder (please report with the producing software)"
        )
    if got < 0:
        raise ValueError(f"LAZ decompression failed (code {got})")
    if got != num_points:
        raise ValueError(f"LAZ stream truncated: {got}/{num_points} points")
    return out


def laz_compress_points(
    raw_records: np.ndarray,
    num_points: int,
    point_offset: int,
    chunk_size: int,
    items: "list[tuple[int, int]]",
    layered: bool = False,
) -> bytes:
    """Encode raw point records into a chunked LAZ point block (chunk-table
    pointer + chunks + compressed chunk table); ``layered=True`` emits the
    compressor-3 layered container for LAS 1.4 point formats 6+."""
    lib = get_laz_lib()
    raw = np.ascontiguousarray(raw_records.view(np.uint8).reshape(-1))
    types = np.asarray([t for t, _ in items], np.int32)
    sizes = np.asarray([s for _, s in items], np.int32)
    cap = int(raw.nbytes + raw.nbytes // 4 + 65536)
    out = np.empty(cap, np.uint8)
    fn = lib.laz_compress_layered if layered else lib.laz_compress
    n = fn(
        _u8ptr(raw), ctypes.c_int64(num_points),
        ctypes.c_int64(point_offset), ctypes.c_int32(chunk_size),
        types.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(len(items)), _u8ptr(out), ctypes.c_int64(cap),
    )
    if n < 0:
        raise ValueError(f"LAZ compression failed (code {n})")
    return out[:n].tobytes()


# LAS field-table type enum shared with pctl_native.cpp's unpack dispatch
NATIVE_TYPE_ENUM = {
    "u1": 0, "i1": 1, "u2": 2, "i2": 3, "u4": 4,
    "i4": 5, "u8": 6, "i8": 7, "f4": 8, "f8": 9,
}
_TYPE_SIZE = (1, 1, 2, 2, 4, 4, 8, 8, 4, 8)


def native_las_unpack_records(
    records: np.ndarray,        # (>= n * rec_len,) uint8 (or memmap view)
    n: int,
    rec_len: int,
    fields: "list[tuple[int, int, int, int, float, float, int, int]]",
    # per output column:
    #   (src_off, src_type, shift, mask, scale, offset, dst_off, dst_type)
    # type enum 0=u8 1=i8 2=u16 3=i16 4=u32 5=i32 6=u64 7=i64 8=f32 9=f64;
    # mask==0 -> no bitfield (mask only valid on integral sources);
    # scale==0.0 -> no affine, else out = (double)v * scale + offset
    out_dtype: np.dtype,        # structured row layout the table targets
    n_threads: int = 0,
) -> np.ndarray:
    """Fused packed-record -> typed-column conversion (thread-parallel).

    Returns an (n,) structured array of ``out_dtype``.
    """
    lib = get_lib()
    n_fields = len(fields)
    src_off = np.asarray([f[0] for f in fields], np.int32)
    src_type = np.asarray([f[1] for f in fields], np.int32)
    shift = np.asarray([f[2] for f in fields], np.int32)
    mask = np.asarray([f[3] for f in fields], np.uint32)
    scale = np.asarray([f[4] for f in fields], np.float64)
    offset = np.asarray([f[5] for f in fields], np.float64)
    dst_off = np.asarray([f[6] for f in fields], np.int32)
    dst_type = np.asarray([f[7] for f in fields], np.int32)
    stride = out_dtype.itemsize
    for f in fields:
        if f[6] + _TYPE_SIZE[f[7]] > stride:
            raise ValueError("field table writes past the output stride")
    out = np.zeros(n, dtype=out_dtype)  # zeros: pad/void gaps stay defined
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.las_unpack_records(
        _u8ptr(records), ctypes.c_int64(n), ctypes.c_int32(rec_len),
        src_off.ctypes.data_as(i32p),
        src_type.ctypes.data_as(i32p),
        shift.ctypes.data_as(i32p),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        scale.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        offset.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        dst_off.ctypes.data_as(i32p),
        dst_type.ctypes.data_as(i32p),
        ctypes.c_int32(n_fields), ctypes.c_int32(stride),
        ctypes.c_int32(n_threads),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out


class _PackTable:
    """A pack table (see ``native_las_pack_records``) as the C arrays
    ``las_pack_records`` and ``las_write_predictions`` take, checked against
    the record length. The caller keeps the table's columns alive."""

    def __init__(self, fields, rec_len: int):
        n_fields = len(fields)
        self.ptrs = (ctypes.c_void_p * max(n_fields, 1))()
        for i, f in enumerate(fields):
            arr = f[0]
            if f[1] == 0 and arr.size < 1:
                raise ValueError("broadcast field needs at least one element")
            if f[7] + _TYPE_SIZE[f[8]] > rec_len:
                raise ValueError("field table writes past the record length")
            if f[4] != 0 and f[2] >= 8:
                raise ValueError("bitfield insert requires an integral source")
            self.ptrs[i] = arr.__array_interface__["data"][0]
        self.n = n_fields
        self.arrays = [
            np.asarray([f[1] for f in fields], np.int64),    # src_stride
            np.asarray([f[2] for f in fields], np.int32),    # src_type
            np.asarray([f[3] for f in fields], np.int32),    # shift
            np.asarray([f[4] for f in fields], np.uint64),   # mask
            np.asarray([f[5] for f in fields], np.float64),  # scale
            np.asarray([f[6] for f in fields], np.float64),  # offset
            np.asarray([f[7] for f in fields], np.int32),    # dst_off
            np.asarray([f[8] for f in fields], np.int32),    # dst_type
        ]

    def args(self) -> list:
        """The table's arguments, from ``srcs`` to ``n_fields``."""
        types = (ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
                 ctypes.c_double, ctypes.c_double, ctypes.c_int32, ctypes.c_int32)
        return [self.ptrs, *(a.ctypes.data_as(ctypes.POINTER(t))
                             for a, t in zip(self.arrays, types)),
                ctypes.c_int32(self.n)]


def native_las_pack_records(
    fields: "list[tuple[np.ndarray, int, int, int, int, float, float, int, int]]",
    # per record field:
    #   (src_array, src_stride, src_type, shift, mask, scale, offset,
    #    dst_off, dst_type)
    # src_stride 0 broadcasts src_array[0]; mask!=0 -> bitfield INSERT
    #   dst |= ((u64)v & mask) << shift (integral src only);
    # scale!=0 -> inverse grid affine nearbyint((v - offset) / scale)
    n: int,
    rec_dtype: np.dtype,
    n_threads: int = 0,
) -> np.ndarray:
    """Fused typed-column -> packed-record conversion (write-side mirror of
    ``native_las_unpack_records``). Returns an (n,) structured array of
    ``rec_dtype`` (unlisted bytes zero)."""
    lib = get_lib()
    rec_len = rec_dtype.itemsize
    table = _PackTable(fields, rec_len)
    out = np.zeros(n * rec_len, dtype=np.uint8)  # zeroed: OR targets + gaps
    lib.las_pack_records(*table.args(), ctypes.c_int64(n), ctypes.c_int32(rec_len),
                         ctypes.c_int32(n_threads), _u8ptr(out))
    return out.view(rec_dtype)


def native_scatter_add_rows(
    plane: np.ndarray,                  # (N, C) f32, C-contiguous
    idx: Sequence[np.ndarray],          # each (R_i,) int64, any order, repeats allowed
    src: Sequence[np.ndarray],          # each (R_i, C) f32 or f16, C-contiguous
    covered: Optional[np.ndarray] = None,  # (N,) bool
    zero: bool = False,
    n_threads: int = 0,
) -> None:
    """For each list i in order, each row r in order: ``plane[idx[i][r]] +=
    src[i][r]`` (f16 upcast in-flight) and ``covered[idx[i][r]] = True``;
    the plane is bit-equal to ``np.add.at`` over the same calls, whatever
    ``n_threads`` (0: from the rows and the machine). Each thread owns a
    range of the plane's rows. ``zero`` zeroes ``plane`` and ``covered``
    first, each thread its own rows, so ``plane`` may come from ``np.empty``.
    Releases the interpreter lock. Raises ``ValueError`` when the sources
    are not all f16 or all f32."""
    lib = get_lib()
    types = {np.dtype(np.float32): 8, np.dtype(np.float16): 10}
    src_type = types.get(src[0].dtype) if len(src) else 8
    if src_type is None or any(s.dtype != src[0].dtype for s in src):
        raise ValueError(f"sources must be all f16 or all f32, got "
                         f"{sorted({str(s.dtype) for s in src})}")
    n, c = plane.shape
    if not (plane.dtype == np.float32 and plane.flags.c_contiguous):
        raise ValueError("plane must be a C-contiguous float32 (N, C) array")
    if covered is not None and not (covered.dtype == np.bool_ and covered.shape == (n,)
                                    and covered.flags.c_contiguous):
        raise ValueError(f"covered must be a contiguous ({n},) bool array")
    if len(idx) != len(src):
        raise ValueError(f"{len(idx)} index arrays for {len(src)} sources")
    for i, s in zip(idx, src):
        if not (i.dtype == np.int64 and i.ndim == 1 and i.flags.c_contiguous):
            raise ValueError("each index array must be contiguous 1-D int64")
        if not (s.shape == (len(i), c) and s.flags.c_contiguous):
            raise ValueError(f"a source of shape {s.shape} for {len(i)} indices into C={c}")
        if len(i) and (i.min() < 0 or i.max() >= n):
            raise ValueError(f"an index outside the plane's {n} rows")
    idx_ptrs = (ctypes.c_void_p * max(len(idx), 1))(*[i.ctypes.data for i in idx])
    src_ptrs = (ctypes.c_void_p * max(len(src), 1))(*[s.ctypes.data for s in src])
    rows = np.asarray([len(i) for i in idx], np.int64)
    lib.scatter_add_rows(
        _fptr(plane), _u8ptr(covered.view(np.uint8)) if covered is not None else None,
        ctypes.c_int64(n), ctypes.c_int32(int(zero)), idx_ptrs, src_ptrs,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), ctypes.c_int32(len(idx)),
        ctypes.c_int32(src_type), ctypes.c_int32(c), ctypes.c_int32(n_threads),
    )


# Points a chunk of ``native_las_write_predictions`` (~4.6 MB of the tile's
# 71-byte records: a thread's buffer stays in its core's share of the cache).
WRITE_CHUNK = 1 << 16


def native_las_write_predictions(
    sink,                       # an open file descriptor, or an (n * rec_len,) uint8 array
    point_offset: int,          # the records' byte offset in the file (fd sink)
    fields,                     # the pack table (see native_las_pack_records)
    base: Optional[np.ndarray],  # (n * rec_len,) uint8 records packed over, or None (zeros)
    n: int,
    rec_len: int,
    logits: np.ndarray,         # (n, C) f32, C-contiguous: the merged logits
    covered: Optional[np.ndarray],  # (n,) bool, or None: every point covered
    class_map: np.ndarray,      # (C,) u8: consecutive index -> class code
    proba_offs: np.ndarray,     # (C,) int32: byte of class j's probability, or -1
    class_off: int,             # byte of the class code, or -1
    entropy_off: int,           # byte of the entropy, or -1
    columns,                    # (array, stride, type) of X, Y, Z, ReturnNumber,
                                # Classification; None for an absent Classification
    n_threads: int = 0,
):
    """Pack the n output records, with each point's probabilities, class
    code and entropy from its logits row (softmax, argmax through the class
    map, H = log Z + max - sum(p * logit) clipped at 0), and write them to
    the sink, in one pass over chunks of ``WRITE_CHUNK`` points on up to
    min(8, cores) threads (``n_threads``), never more than the chunks. An
    uncovered point gets probability 0 and entropy 0 and keeps its
    Classification. Releases the interpreter lock. Returns (mins (3,), maxs
    (3,) of X, Y, Z as numpy's min and max give them, the (15,) uint64
    counts of clip(ReturnNumber, 1, 15), the seconds the threads spent in
    the sink averaged over them, the thread count); raises ``OSError`` when
    a write fails."""
    lib = get_lib()
    c = len(class_map)
    if not (logits.dtype == np.float32 and logits.flags.c_contiguous
            and logits.shape == (n, c)):
        raise ValueError(f"logits must be a C-contiguous ({n}, {c}) float32 array")
    if covered is not None and not (covered.dtype == np.bool_ and covered.shape == (n,)
                                    and covered.flags.c_contiguous):
        raise ValueError(f"covered must be a contiguous ({n},) bool array")
    class_map = np.ascontiguousarray(class_map, np.uint8)
    proba_offs = np.ascontiguousarray(proba_offs, np.int32)
    if proba_offs.shape != (c,):
        raise ValueError(f"{len(proba_offs)} probability offsets for {c} classes")
    for off, size in [(o, 4) for o in proba_offs] + [(class_off, 1), (entropy_off, 4)]:
        if off >= 0 and off + size > rec_len:
            raise ValueError("a channel written past the record length")
    if base is not None and not (base.dtype == np.uint8 and base.flags.c_contiguous
                                 and base.size == n * rec_len):
        raise ValueError(f"base must be {n * rec_len} contiguous bytes")
    if isinstance(sink, np.ndarray):
        if not (sink.dtype == np.uint8 and sink.flags.c_contiguous
                and sink.size == n * rec_len):
            raise ValueError(f"the sink must be {n * rec_len} contiguous bytes")
        fd, mem = -1, _u8ptr(sink)
    else:
        fd, mem = int(sink), None
    col_ptrs = (ctypes.c_void_p * 5)()
    col_strides = np.zeros(5, np.int64)
    col_types = np.full(5, -1, np.int32)
    for k, col in enumerate(columns):
        if col is None:
            continue
        arr, stride, code = col
        if stride and len(arr) != n:
            raise ValueError(f"a column of {len(arr)} values for {n} points")
        col_ptrs[k] = arr.__array_interface__["data"][0]
        col_strides[k], col_types[k] = stride, code
    if col_types[:4].min() < 0:
        raise ValueError("X, Y, Z and ReturnNumber are required columns")
    table = _PackTable(fields, rec_len)
    bounds = np.zeros(6, np.float64)
    by_return = np.zeros(15, np.uint64)
    io_s = ctypes.c_double(0.0)
    threads = ctypes.c_int32(0)
    dp = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    err = lib.las_write_predictions(
        ctypes.c_int32(fd), ctypes.c_int64(point_offset), mem,
        _u8ptr(base) if base is not None else None,
        *table.args(), ctypes.c_int64(n), ctypes.c_int32(rec_len),
        _fptr(logits), ctypes.c_int32(c),
        _u8ptr(covered.view(np.uint8)) if covered is not None else None,
        _u8ptr(class_map), proba_offs.ctypes.data_as(i32p),
        ctypes.c_int32(class_off), ctypes.c_int32(entropy_off),
        col_ptrs, col_strides.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        col_types.ctypes.data_as(i32p), ctypes.c_int64(WRITE_CHUNK),
        ctypes.c_int32(n_threads), bounds.ctypes.data_as(dp),
        by_return.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.byref(io_s), ctypes.byref(threads),
    )
    if err:
        raise OSError(err, os.strerror(err))
    return bounds[:3], bounds[3:], by_return, io_s.value, threads.value
