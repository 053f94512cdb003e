"""A frozen LAS 1.4 writer (point format 8) for the benchmark's input tile,
and a reader of the extra-bytes dimensions of a predicted tile.

Kept apart from the program's LAS code, so that a change there cannot
change the benchmark's input. The writer lays out exactly what the
production tiles carry: LAS 1.4, point format 8 (38 bytes: scaled int
X/Y/Z, intensity, return bits, classification, GPS time, RGB, NIR), an
OGC WKT VLR for the EPSG code, no extra bytes.
"""

from __future__ import annotations

import struct

import numpy as np

HEADER_SIZE = 375
FMT8 = np.dtype([
    ("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"), ("Intensity", "<u2"), ("returns", "u1"),
    ("flags", "u1"), ("Classification", "u1"), ("UserData", "u1"), ("ScanAngle", "<i2"),
    ("PointSourceId", "<u2"), ("GpsTime", "<f8"), ("Red", "<u2"), ("Green", "<u2"),
    ("Blue", "<u2"), ("Infrared", "<u2"),
])
_EXTRA_TYPES = {1: "u1", 2: "i1", 3: "<u2", 4: "<i2", 5: "<u4", 6: "<i4", 7: "<u8", 8: "<i8",
                9: "<f4", 10: "<f8"}


def _vlr(user_id: str, record_id: int, description: str, data: bytes) -> bytes:
    return struct.pack("<H16sHH32s", 0, user_id.encode().ljust(16, b"\0"), record_id,
                       len(data), description.encode().ljust(32, b"\0")) + data


def write_fmt8(path: str, pts: np.ndarray, scales, offsets, epsg: int) -> None:
    """Write ``pts`` (fields X/Y/Z as float64 and the format-8 attributes
    by their LAS names, ReturnNumber and NumberOfReturns apart)."""
    n = len(pts)
    raw = np.zeros(n, FMT8)
    for i, c in enumerate("XYZ"):
        raw[c] = np.round((pts[c] - offsets[i]) / scales[i]).astype(np.int64)
    raw["returns"] = (pts["ReturnNumber"] & 0x0F) | ((pts["NumberOfReturns"] & 0x0F) << 4)
    for name in ("Intensity", "Classification", "GpsTime", "Red", "Green", "Blue", "Infrared"):
        raw[name] = pts[name]
    wkt = f'PROJCS["EPSG:{epsg}",AUTHORITY["EPSG","{epsg}"]]'.encode() + b"\0"
    vlrs = _vlr("LASF_Projection", 2112, "OGC WKT", wkt)
    by_return = np.bincount(np.clip(pts["ReturnNumber"], 1, 15), minlength=16)[1:16]
    head = bytearray(HEADER_SIZE)
    struct.pack_into("<4sHH", head, 0, b"LASF", 0, 0x10)          # WKT bit
    head[24], head[25] = 1, 4
    head[26:58] = b"perfbench".ljust(32, b"\0")
    head[58:90] = b"perfbench LAS writer".ljust(32, b"\0")
    struct.pack_into("<HHHII", head, 90, 1, 2026, HEADER_SIZE, HEADER_SIZE + len(vlrs), 1)
    head[104] = 8
    struct.pack_into("<HI", head, 105, FMT8.itemsize, 0)
    struct.pack_into("<3d3d", head, 131, *scales, *offsets)
    struct.pack_into("<6d", head, 179, pts["X"].max(), pts["X"].min(), pts["Y"].max(),
                     pts["Y"].min(), pts["Z"].max(), pts["Z"].min())
    struct.pack_into("<QQIQ", head, 227, 0, 0, 0, n)
    struct.pack_into("<15Q", head, 255, *by_return.astype(np.uint64).tolist())
    with open(path, "wb") as f:
        f.write(bytes(head))
        f.write(vlrs)
        raw.tofile(f)


def read_extra(path: str, rows: np.ndarray, names) -> dict:
    """The extra-bytes dimensions ``names`` of a LAS file at the point
    indices ``rows``: ``{name: array}``."""
    with open(path, "rb") as f:
        head = f.read(HEADER_SIZE)
        header_size, offset, n_vlrs = struct.unpack_from("<HII", head, 94)
        fmt = head[104] & 0x3F
        length, = struct.unpack_from("<H", head, 105)
        count, = struct.unpack_from("<Q", head, 247)
        f.seek(header_size)
        extras = []
        for _ in range(n_vlrs):
            _, user, rec, size, _ = struct.unpack("<H16sHH32s", f.read(54))
            data = f.read(size)
            if user.rstrip(b"\0") == b"LASF_Spec" and rec == 4:
                for at in range(0, size - 191, 192):
                    name = data[at + 4:at + 36].split(b"\0")[0].decode()
                    extras.append((name, _EXTRA_TYPES[data[at + 2]]))
    if fmt != 8:
        raise ValueError(f"{path}: point format {fmt}, not 8")
    dtype = np.dtype([("_std", f"V{FMT8.itemsize}")] + extras)
    if dtype.itemsize != length:
        raise ValueError(f"{path}: records of {length} bytes, described {dtype.itemsize}")
    pts = np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=(count,))
    picked = pts[rows]
    return {name: np.array(picked[name]) for name in names}


def read_fmt8(path: str) -> dict:
    """The points of a format-8 file written by :func:`write_fmt8`: X/Y/Z
    scaled to float64, ReturnNumber and NumberOfReturns unpacked, the other
    attributes as stored."""
    with open(path, "rb") as f:
        head = f.read(HEADER_SIZE)
    offset, = struct.unpack_from("<I", head, 96)
    count, = struct.unpack_from("<Q", head, 247)
    scales = struct.unpack_from("<3d", head, 131)
    offsets = struct.unpack_from("<3d", head, 155)
    raw = np.fromfile(path, dtype=FMT8, count=count, offset=offset)
    out = {c: raw[c] * scales[i] + offsets[i] for i, c in enumerate("XYZ")}
    out["ReturnNumber"] = raw["returns"] & 0x0F
    out["NumberOfReturns"] = raw["returns"] >> 4
    for name in ("Intensity", "Classification", "Red", "Green", "Blue", "Infrared"):
        out[name] = raw[name]
    return out
