"""HDF5-backed sample store: the single owner of all h5py choreography.

On-disk schema is kept byte-compatible with caches produced by the
reference's ``create_hdf5`` (``myria3d/pctl/dataset/hdf5.py:197-293``) so
existing dataset files keep working:

    {split}/{basename}/{NNNNN}/{x, pos, y, idx_in_original_cloud}
    {split}/{basename}.attrs["is_complete"]     — tile fully ingested
    x.attrs["x_features_names"]                 — feature column names
    /samples_hdf5_paths                         — vlen-str sample index

The code around the schema is organized differently from the reference:
write, resume and indexing live here behind three verbs (``tile_status`` /
``ingest_tile`` / ``read``), the cached index is invalidated on ingest
instead of silently going stale, and concurrent reads scale across loader
threads: h5py is only used once per sample to resolve dataset metadata
(offset/shape/dtype — cached), after which the data bytes are read with
positional ``os.pread`` on a raw file descriptor. HDF5 calls all serialize
behind h5py's global library lock no matter how many handles exist (the
reference sidesteps that with per-worker *processes*,
``hdf5.py:115-138``) — ``pread`` has no lock and releases the GIL, so the
thread-pool loader's workers genuinely overlap I/O.

Copied from ``myria3d_tpu/pctl/dataset/store.py``; imports point at the port.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterable, List, Optional, Tuple

import h5py
import numpy as np

SPLITS = ("train", "val", "test")
INDEX_KEY = "samples_hdf5_paths"

TILE_ABSENT = "absent"
TILE_PARTIAL = "partial"
TILE_COMPLETE = "complete"

# sample datasets in schema order: (name, stored dtype, returned dtype)
_FIELDS = (
    ("x", np.float32, np.float32),
    ("pos", np.float32, np.float32),
    ("y", np.int32, np.int64),
    ("idx_in_original_cloud", np.int32, np.int32),
)


class HDF5SampleStore:
    """Grouped subtile-sample cache in a single HDF5 file."""

    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()
        self._handles_lock = threading.Lock()
        self._h5_handles: List[h5py.File] = []
        self._fds: List[int] = []
        # bumped by close(): threads whose cached handle/fd belongs to an
        # older generation reopen instead of touching a closed (and possibly
        # number-reused) descriptor
        self._gen = 0
        self._paths_cache: Optional[List[str]] = None
        # sample_path -> (x_features_names, {field: (offset, shape, dtype)})
        # offset None => non-contiguous/filtered dataset, h5py fallback
        self._meta: Dict[str, Tuple[List[str], dict]] = {}
        self._meta_lock = threading.Lock()

    # ------------------------------------------------------------------
    # Write side
    # ------------------------------------------------------------------

    def tile_status(self, split: str, basename: str) -> str:
        """absent | partial (interrupted ingest) | complete."""
        if not os.path.isfile(self.path):
            return TILE_ABSENT
        with h5py.File(self.path, "r") as f:
            grp = f.get(f"{split}/{basename}")
            if grp is None:
                return TILE_ABSENT
            return (
                TILE_COMPLETE if "is_complete" in grp.attrs else TILE_PARTIAL
            )

    def drop_tile(self, split: str, basename: str) -> None:
        with h5py.File(self.path, "a") as f:
            key = f"{split}/{basename}"
            if key in f:
                del f[key]
        self._invalidate()

    def ingest_tile(
        self, split: str, basename: str, samples: Iterable[dict]
    ) -> int:
        """Write every sample of one tile; mark ``is_complete`` last so an
        interrupted ingest is detectable. A tile with zero surviving samples
        still gets its (empty, complete) group — it must not be redone on
        every resume. Returns the number of samples written."""
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        count = 0
        with h5py.File(self.path, "a") as f:
            tile = f.require_group(split).create_group(basename)
            for count, sample in enumerate(samples, start=1):
                grp = tile.create_group(f"{count - 1:05d}")
                ds = grp.create_dataset("x", data=np.asarray(sample["x"], np.float32))
                ds.attrs["x_features_names"] = list(sample["x_features_names"])
                grp.create_dataset("pos", data=np.asarray(sample["pos"], np.float32))
                grp.create_dataset("y", data=np.asarray(sample["y"], np.int32))
                grp.create_dataset(
                    "idx_in_original_cloud",
                    data=np.asarray(sample["idx_in_original_cloud"], np.int32),
                )
            tile.attrs["is_complete"] = True
            # new samples invalidate any cached index
            if INDEX_KEY in f:
                del f[INDEX_KEY]
        self._invalidate()
        return count

    def _invalidate(self) -> None:
        """Ingest moves data around the file — drop caches AND open read
        state (offsets resolved against the old layout must not survive)."""
        self._paths_cache = None
        with self._meta_lock:
            self._meta.clear()
        self.close()

    # ------------------------------------------------------------------
    # Read side
    # ------------------------------------------------------------------

    def _walk_sample_paths(self, f: h5py.File) -> List[str]:
        paths: List[str] = []
        for split in SPLITS:
            split_grp = f.get(split)
            if split_grp is None:
                continue
            for basename, tile in split_grp.items():
                paths.extend(
                    f"{split}/{basename}/{number}" for number in tile.keys()
                )
        return paths

    def sample_paths(self) -> List[str]:
        """All sample paths, cached in memory and inside the file.

        Reads through a read-only handle so concurrent *processes* (multi-
        host training shares one cache file) never contend on the HDF5
        write lock; persisting the index into the file is best-effort and
        skipped when another process holds the lock."""
        if self._paths_cache is not None:
            return self._paths_cache
        # a sibling process may hold the short-lived write lock below —
        # retry briefly instead of failing the whole run
        for attempt in range(50):
            try:
                handle = h5py.File(self.path, "r")
                break
            except OSError:
                if attempt == 49:
                    raise
                import time

                time.sleep(0.1)
        with handle as f:
            if INDEX_KEY in f:
                paths = [
                    p.decode() if isinstance(p, bytes) else str(p)
                    for p in f[INDEX_KEY]
                ]
                self._paths_cache = paths
                return paths
            paths = self._walk_sample_paths(f)
        try:
            with h5py.File(self.path, "a") as f:
                if INDEX_KEY not in f:
                    f.create_dataset(
                        INDEX_KEY,
                        (len(paths),),
                        dtype=h5py.special_dtype(vlen=str),
                        data=paths,
                    )
        except OSError:
            pass  # another process holds the write lock — index stays RAM-only
        self._paths_cache = paths
        return paths

    def split_paths(self, split: str) -> List[str]:
        prefix = f"{split}/"
        return [p for p in self.sample_paths() if p.startswith(prefix)]

    def _h5_reader(self) -> h5py.File:
        """Per-thread lazily-opened read handle (never shared across
        threads, so no coarse lock; h5py's own library lock still guards
        the HDF5 calls made through it)."""
        f = getattr(self._local, "reader", None)
        if (
            f is None or not f.id.valid
            or getattr(self._local, "gen", -1) != self._gen
        ):
            f = h5py.File(self.path, "r")
            self._local.reader = f
            self._local.gen = self._gen
            with self._handles_lock:
                self._h5_handles.append(f)
        return f

    def _raw_fd(self) -> int:
        """Per-thread raw file descriptor for positional pread."""
        fd = getattr(self._local, "fd", None)
        if fd is None or getattr(self._local, "fd_gen", -1) != self._gen:
            fd = os.open(self.path, os.O_RDONLY)
            self._local.fd = fd
            self._local.fd_gen = self._gen
            with self._handles_lock:
                self._fds.append(fd)
        return fd

    def _resolve_meta(self, sample_path: str):
        """Dataset offsets/shapes/dtypes + feature names for one sample
        (one-time h5py metadata walk, cached; offset is None for any
        dataset HDF5 stored non-contiguously)."""
        with self._meta_lock:
            meta = self._meta.get(sample_path)
        if meta is not None:
            return meta
        grp = self._h5_reader()[sample_path]
        names = grp["x"].attrs["x_features_names"]
        names = [n if isinstance(n, str) else n.decode() for n in names]
        fields = {}
        for name, stored, _ in _FIELDS:
            ds = grp[name]
            offset = ds.id.get_offset()  # None unless contiguous
            if ds.dtype != np.dtype(stored):  # foreign-written cache
                offset = None
            fields[name] = (offset, ds.shape, ds.dtype)
        meta = (names, fields)
        with self._meta_lock:
            self._meta[sample_path] = meta
        return meta

    def read(self, sample_path: str) -> dict:
        """Load one sample as a numpy dict.

        Data bytes ride ``os.pread`` (lock-free, GIL-releasing) whenever the
        dataset is contiguous — which everything written by ``ingest_tile``
        is; anything else falls back to a per-thread h5py read."""
        names, fields = self._resolve_meta(sample_path)
        out = {"x_features_names": names}
        fd = self._raw_fd()
        for name, stored, returned in _FIELDS:
            offset, shape, dtype = fields[name]
            if offset is None or int(np.prod(shape)) == 0:
                arr = self._h5_reader()[sample_path][name][...]
            else:
                # preadv straight into a writable numpy buffer: no h5py
                # global lock, GIL released, no read-only frombuffer view
                arr = np.empty(shape, dtype)
                nread = os.preadv(fd, [memoryview(arr).cast("B")], offset)
                if nread != arr.nbytes:
                    raise IOError(
                        f"short read for {sample_path}/{name}: "
                        f"{nread}/{arr.nbytes} bytes"
                    )
            out[name] = arr.astype(returned, copy=False)
        return out

    def close(self) -> None:
        self._gen += 1
        with self._handles_lock:
            for f in self._h5_handles:
                try:
                    if f.id.valid:
                        f.close()
                except Exception:  # noqa: BLE001 — already closed elsewhere
                    pass
            self._h5_handles.clear()
            for fd in self._fds:
                try:
                    os.close(fd)
                except OSError:
                    pass
            self._fds.clear()
        # thread-local refs in OTHER threads may still point at the closed
        # objects; _h5_reader/_raw_fd re-validate and reopen on next use.
        # This thread's refs are dropped eagerly:
        self._local.reader = None
        self._local.fd = None
