"""The kernel library's bindings (every ``extern "C"`` entry point of
``csrc/`` has its argument types) and its resource report (``_ext.resource_usage``), which
``chip_smoke.py`` phase 2 reads to fail on a stack frame or spills in a
K1/K3 instantiation: parsed here from a canned ``cuobjdump
--dump-resource-usage`` listing and ``ptxas -v`` report in the formats the
CUDA 12 toolkit prints (no toolkit is needed)."""

import re
import subprocess
import types

import pytest

from myria3d_tpu_torch import _ext

DUMP = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

Resource usage:
 Common:
  GLOBAL:0
 Function _ZN3m3d15knn_topk_kernelILi16ELi2EEEvPK6float4S3_PKiiiiiiPiPf:
  REG:113 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:416 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN3m3d14lfa_bwd_kernelEPKfS1_PKiPKhS1_S1_S1_S1_S1_S1_S1_iiiiiiiPfS8_S8_S8_:
  REG:128 STACK:96 SHARED:0 LOCAL:0 CONSTANT[0]:520 TEXTURE:0 SURFACE:0 SAMPLER:0
"""

PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN3m3d15knn_topk_kernelILi16ELi2EEEvPK6float4S3_PKiiiiiiPiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN3m3d15knn_topk_kernelILi16ELi2EEEvPK6float4S3_PKiiiiiiPiPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 113 registers, used 1 barriers, 416 bytes cmem[0]
ptxas info    : Function properties for _ZN3m3d14lfa_bwd_kernelEPKfS1_PKiPKhS1_S1_S1_S1_S1_S1_S1_iiiiiiiPfS8_S8_S8_
    96 bytes stack frame, 180 bytes spill stores, 1176 bytes spill loads
"""


@pytest.mark.parametrize("mangled,short", [
    ("_ZN3m3d15knn_topk_kernelILi16ELi2EEEvPK6float4S3_PKiiiiiiPiPf", "knn_topk_kernel<16,2>"),
    ("_ZN3m3d19knn_topk_mxu_kernelILi1EEEvPK6float4S3_iiiiPiPf", "knn_topk_mxu_kernel<1>"),
    ("_ZN3m3d17gather_bwd_kernelEPKfPKiS3_iiPf", "gather_bwd_kernel"),
    ("_Z3foov", "_Z3foov"),
])
def test_kernel_names_are_shortened(mangled, short):
    assert _ext._short_name(mangled) == short


def test_resource_usage_reads_cuobjdump_and_ptxas(tmp_path, monkeypatch):
    library = tmp_path / "libm3d_kernels_0.so"
    library.write_bytes(b"")
    _ext.ptxas_log(library).write_text(PTXAS)
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return types.SimpleNamespace(stdout=DUMP, returncode=0)

    monkeypatch.setattr(_ext, "_nvcc", lambda: "/toolkit/bin/nvcc")
    monkeypatch.setattr(subprocess, "run", run)
    usage = _ext.resource_usage(library)
    assert calls == [["/toolkit/bin/cuobjdump", "--dump-resource-usage", str(library)]]
    assert usage["knn_topk_kernel<16,2>"] == {
        "reg": 113, "stack": 0, "local": 0, "spill_stores": 0, "spill_loads": 0}
    assert usage["lfa_bwd_kernel"] == {
        "reg": 128, "stack": 96, "local": 0, "spill_stores": 180, "spill_loads": 1176}


def _entry_points():
    """``{name: argument count}`` of every ``extern "C"`` function in csrc/."""
    found = {}
    for src in sorted(_ext.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[name] = len([p for p in params.split(",") if p.strip()])
    return found


def test_every_entry_point_has_a_signature():
    """ctypes cuts a pointer passed without ``argtypes``: every entry point
    is bound, with as many argument types as the C function takes."""
    entries = _entry_points()
    assert set(entries) == set(_ext._SIGNATURES)
    assert {n: len(sig) for n, sig in _ext._SIGNATURES.items()} == entries


@pytest.mark.parametrize("name,pointers,ints", [
    ("m3d_gather_bwd", 5, 2), ("m3d_inverse_map_count", 4, 3), ("m3d_inverse_map_fill", 6, 3),
    ("m3d_relstats", 6, 5)])
def test_train_graph_entry_points_are_bound(name, pointers, ints):
    """K4, its inverse map and K5: pointers (and the stream) as ``void*``,
    sizes as ``int``."""
    sig = _ext._SIGNATURES[name]
    assert sig.count(_ext._P) == pointers and sig.count(_ext._I) == ints
