"""Build and bind the package's CUDA kernels (``csrc/*.cu``).

The kernels are compiled at first use with ``nvcc`` for Hopper
(``sm_90a``), one process per source, all started together, and linked
into one shared library with a plain C interface under
``build/myria3d_tpu_torch/`` beside the package, loaded with ``ctypes``.
The library name carries a hash of the sources, so an edited source
triggers a rebuild and a stale library is never loaded. Nothing
is built or loaded at import time: the CPU code paths never need it.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a nonzero code.
:func:`resource_usage` reads each kernel's registers, stack frame and
spills from the built library (``cuobjdump``) and from ``ptxas``'s report,
which the build keeps beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "myria3d_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# entry point -> argument types (pointers and the stream as void*; a float
# argument must be c_float, or ctypes passes a double)
_SIGNATURES = {
    "m3d_knn_topk": [_P] * 5 + [_I] * 7 + [_F, _P, _P, _P],
    "m3d_knn_topk_mxu": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "m3d_knn_interp": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "m3d_lfa": [_P] * 6 + [_I] * 5 + [_P, _P],
    "m3d_lfa_info": [_I, _P],
    "m3d_gather_bwd": [_P, _P, _P, _I, _I, _P, _P],
    "m3d_inverse_map_count": [_P, _P, _I, _I, _I, _P, _P],
    "m3d_inverse_map_fill": [_P, _P, _I, _I, _I, _P, _P, _P, _P],
    "m3d_relstats": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "m3d_reduce_chunks": [_P, _I, _I, _I, _I, _P, _P],
    "m3d_lfa_bwd": [_P] * 9 + [_I] * 5 + [_P] * 4,
    "m3d_lfa_bwd_info": [_I, _P],
    "m3d_fps": [_P, _P] + [_I] * 7 + [_P, _P, _P],
    "m3d_fps_max_clusters": [_I, _I, _I, _P],
    "m3d_vector_attention": [_P] * 7 + [_I] * 5 + [_P, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libm3d_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it exists."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # one nvcc per source, all at once, into a private directory; then link
    # to a private name and publish atomically: concurrent builds never
    # load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp_dir, src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = [proc.communicate()[0] for proc in procs]
        failed = [log for proc, log in zip(procs, logs) if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        # ptxas's report (registers, stack frame, spills) beside the library
        log_tmp = os.path.join(tmp_dir, "ptxas.txt")
        Path(log_tmp).write_text("\n".join(logs))
        os.replace(log_tmp, ptxas_log(out))
        lib_tmp = os.path.join(tmp_dir, out.name)
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib_tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
        os.replace(lib_tmp, out)
    return out


def ptxas_log(library: Path) -> Path:
    """Where the build keeps ``ptxas -v``'s report of ``library``."""
    return library.with_suffix(".ptxas.txt")


def _short_name(mangled: str) -> str:
    """``_ZN3m3d15knn_topk_kernelILi16ELi2EEEv...`` -> ``knn_topk_kernel<16,2>``."""
    m = re.match(r"_ZN3m3d(\d+)", mangled)
    if not m:
        return mangled
    name = mangled[m.end():m.end() + int(m.group(1))]
    args = re.match(r"I((?:Li-?\d+E)+)E", mangled[m.end() + len(name):])
    if args:
        name += "<" + ",".join(re.findall(r"Li(-?\d+)E", args.group(1))) + ">"
    return name


def resource_usage(library: Optional[Path] = None) -> dict:
    """``{kernel: {"reg", "stack", "local", "spill_stores", "spill_loads"}}``
    of every kernel in the library (built if needed): registers per thread,
    stack frame and local memory bytes from ``cuobjdump
    --dump-resource-usage``, spill bytes from ``ptxas -v``."""
    library = Path(library or build())
    tool = Path(_nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(tool), "--dump-resource-usage", str(library)],
                          capture_output=True, text=True, check=True).stdout
    usage: dict = {}
    name = None
    for line in dump.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = _short_name(m.group(1))
        elif name is not None and "REG:" in line:
            usage[name] = {key.lower(): int(v)
                           for key, v in re.findall(r"\b(REG|STACK|LOCAL):(\d+)", line)}
            name = None
    log = ptxas_log(library)
    text = log.read_text() if log.is_file() else ""
    for m in re.finditer(r"Function properties for (\S+)\s*\n\s*(\d+) bytes stack frame, "
                         r"(\d+) bytes spill stores, (\d+) bytes spill loads", text):
        usage.setdefault(_short_name(m.group(1)), {}).update(
            spill_stores=int(m.group(3)), spill_loads=int(m.group(4)))
    return usage


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the C entry expects."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def aligned(t: torch.Tensor, nbytes: int = 16) -> torch.Tensor:
    """``t`` contiguous with its data at an ``nbytes`` boundary (a copy if
    it is a view that starts elsewhere), for kernels that read it in
    vectors of that size."""
    t = t.contiguous()
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
