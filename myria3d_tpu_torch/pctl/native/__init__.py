"""pctl.native — ctypes loader for the C++ host kernels.

Builds ``pctl_native.cpp`` with g++ on first use; every entry degrades to
``None`` when no toolchain is available so the pure-numpy fallbacks keep
working (the transforms pick native automatically when present).

Copied from ``myria3d_tpu/pctl/native/__init__.py``; the ``.cpp`` sources
are copies, the code unchanged (one comment of ``laszip_native.cpp`` names
its test file without a host path) but for the overlap merge and the subtile
front end: the port's ``scatter_add_rows`` takes a whole batch of row lists
in any index order, repeats included (``native_scatter_add_rows``); its
window binning reads f32 or f64 X/Y from the records in place on several
threads (``native_bin_windows_fields``; the staged (n, 2) f64 route is
gone); and ``lidar_hd_rows`` builds a subtile's Lidar HD features from the
tile's records (``native_lidar_hd_rows``). The libraries are built into
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
import warnings
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


_lib: Optional[ctypes.CDLL] = None


def _build() -> Optional[str]:
    try:
        return _build_so(_SRC, _FLAGS, 120)
    except (OSError, subprocess.SubprocessError) as e:
        warnings.warn(f"pctl_native build failed ({e}); using numpy fallbacks")
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    lib.grid_sample.restype = ctypes.c_int64
    lib.grid_sample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.crop_square.restype = ctypes.c_int64
    lib.crop_square.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.POINTER(ctypes.c_int32),
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
    lib.logits_finalize.restype = None
    lib.logits_finalize.argtypes = [
        fp, ctypes.c_int64, ctypes.c_int32, u8p, u8p, fp, fp, ctypes.c_int32,
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
    """(pos_mean, x_mean, y_majority, inverse) or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
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
    when unavailable or when X/Y are not native-order f32/f64. Membership
    is the inclusive Chebyshev test ``|coord - center| <= radius`` per axis
    on ``coord - min(coord)`` in f64 — bit-compatible with the numpy path
    in ``pctl/dataset/utils.py``, whatever the thread count.
    """
    lib = get_lib()
    if lib is None:
        return None
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
    Releases the interpreter lock. None when the library is unavailable,
    a field other than a color is missing, or a field is not a native-order
    integer of up to 32 bits, f32 or f64."""
    lib = get_lib()
    if lib is None:
        return None
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


def get_laz_lib() -> Optional[ctypes.CDLL]:
    global _laz_lib
    if _laz_lib is not None:
        return _laz_lib
    try:
        laz_so = _build_so(_LAZ_SRC, ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"], 180)
    except (OSError, subprocess.SubprocessError) as e:
        warnings.warn(f"laszip_native build failed ({e}); LAZ unavailable")
        return None
    lib = ctypes.CDLL(laz_so)
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
) -> Optional[np.ndarray]:
    """Decode a chunked LAZ point block → raw point-record bytes.

    ``items`` is the laszip VLR item list as (type, size) pairs;
    ``layered=True`` selects the compressor-3 (LAS 1.4 point formats 6+)
    layered decoder. Returns a uint8 array of shape
    (num_points * point_size,), or None when the native codec is
    unavailable. Raises ValueError on malformed streams.
    """
    lib = get_laz_lib()
    if lib is None:
        return None
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
) -> Optional[bytes]:
    """Encode raw point records into a chunked LAZ point block (chunk-table
    pointer + chunks + compressed chunk table); ``layered=True`` emits the
    compressor-3 layered container for LAS 1.4 point formats 6+."""
    lib = get_laz_lib()
    if lib is None:
        return None
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
) -> Optional[np.ndarray]:
    """Fused packed-record -> typed-column conversion (thread-parallel).

    Returns an (n,) structured array of ``out_dtype``, or None when the
    native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
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
) -> Optional[np.ndarray]:
    """Fused typed-column -> packed-record conversion (write-side mirror of
    ``native_las_unpack_records``). Returns an (n,) structured array of
    ``rec_dtype`` (unlisted bytes zero), or None when the native library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n_fields = len(fields)
    rec_len = rec_dtype.itemsize
    ptrs = (ctypes.c_void_p * n_fields)()
    keep = []  # hold source buffers alive across the call
    for i, f in enumerate(fields):
        arr = f[0]
        if f[1] == 0 and arr.size < 1:
            raise ValueError("broadcast field needs at least one element")
        if f[7] + _TYPE_SIZE[f[8]] > rec_len:
            raise ValueError("field table writes past the record length")
        if f[4] != 0 and f[2] >= 8:
            raise ValueError("bitfield insert requires an integral source")
        keep.append(arr)
        ptrs[i] = arr.__array_interface__["data"][0]
    src_stride = np.asarray([f[1] for f in fields], np.int64)
    src_type = np.asarray([f[2] for f in fields], np.int32)
    shift = np.asarray([f[3] for f in fields], np.int32)
    mask = np.asarray([f[4] for f in fields], np.uint64)
    scale = np.asarray([f[5] for f in fields], np.float64)
    offset = np.asarray([f[6] for f in fields], np.float64)
    dst_off = np.asarray([f[7] for f in fields], np.int32)
    dst_type = np.asarray([f[8] for f in fields], np.int32)
    out = np.zeros(n * rec_len, dtype=np.uint8)  # zeroed: OR targets + gaps
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.las_pack_records(
        ptrs,
        src_stride.ctypes.data_as(i64p),
        src_type.ctypes.data_as(i32p),
        shift.ctypes.data_as(i32p),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        scale.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        offset.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        dst_off.ctypes.data_as(i32p),
        dst_type.ctypes.data_as(i32p),
        ctypes.c_int32(n_fields), ctypes.c_int64(n),
        ctypes.c_int32(rec_len), ctypes.c_int32(n_threads),
        _u8ptr(out),
    )
    del keep
    return out.view(rec_dtype)


def native_scatter_add_rows(
    plane: np.ndarray,                  # (N, C) f32, C-contiguous
    idx: Sequence[np.ndarray],          # each (R_i,) int64, any order, repeats allowed
    src: Sequence[np.ndarray],          # each (R_i, C) f32 or f16, C-contiguous
    covered: Optional[np.ndarray] = None,  # (N,) bool
    zero: bool = False,
    n_threads: int = 0,
) -> bool:
    """For each list i in order, each row r in order: ``plane[idx[i][r]] +=
    src[i][r]`` (f16 upcast in-flight) and ``covered[idx[i][r]] = True``;
    the plane is bit-equal to ``np.add.at`` over the same calls, whatever
    ``n_threads`` (0: from the rows and the machine). Each thread owns a
    range of the plane's rows. ``zero`` zeroes ``plane`` and ``covered``
    first, each thread its own rows, so ``plane`` may come from ``np.empty``.
    Releases the interpreter lock. Returns False when the native library is
    unavailable, or the sources are not all f16 or all f32."""
    lib = get_lib()
    if lib is None:
        return False
    types = {np.dtype(np.float32): 8, np.dtype(np.float16): 10}
    src_type = types.get(src[0].dtype) if len(src) else 8
    if src_type is None or any(s.dtype != src[0].dtype for s in src):
        return False
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
    return True


def native_logits_finalize(
    logits: np.ndarray,       # (N, C) f32, C-contiguous
    class_map: np.ndarray,    # (C,) u8 — consecutive index -> class code
    want_preds: bool = True,
    want_entropy: bool = True,
    n_threads: int = 0,
):
    """Fused softmax + argmax-map + entropy over merged logits.

    Returns (probas (N, C) f32, preds (N,) u8 | None, entropy (N,) f32 |
    None), or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    assert logits.flags.c_contiguous and logits.dtype == np.float32
    n, c = logits.shape
    class_map = np.ascontiguousarray(class_map, dtype=np.uint8)
    assert len(class_map) == c
    probas = np.empty((n, c), dtype=np.float32)
    preds = np.empty(n, dtype=np.uint8) if want_preds else None
    entropy = np.empty(n, dtype=np.float32) if want_entropy else None
    fp = ctypes.POINTER(ctypes.c_float)
    lib.logits_finalize(
        logits.ctypes.data_as(fp), ctypes.c_int64(n), ctypes.c_int32(c),
        _u8ptr(class_map),
        _u8ptr(preds) if preds is not None else None,
        entropy.ctypes.data_as(fp) if entropy is not None else None,
        probas.ctypes.data_as(fp), ctypes.c_int32(n_threads),
    )
    return probas, preds, entropy


def native_crop_square(
    pos: np.ndarray, cx: float, cy: float, half_width: float
) -> Optional[np.ndarray]:
    """Indices of points inside the square, or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pos_c = np.ascontiguousarray(pos, np.float32)
    out = np.empty(pos.shape[0], np.int32)
    m = lib.crop_square(
        _fptr(pos_c), ctypes.c_int64(pos.shape[0]),
        ctypes.c_float(cx), ctypes.c_float(cy), ctypes.c_float(half_width),
        _iptr(out),
    )
    return out[:m].copy()
