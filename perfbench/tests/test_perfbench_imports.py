"""The benchmark loads neither JAX nor the JAX package, and its reference
loads nothing of the program (top-level module names compared whole)."""

import os
import subprocess
import sys

from perfbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "myria3d_tpu"}
PB = os.path.join(ROOT, "perfbench")


def _modules(sub: str) -> list:
    return sorted(f"perfbench.{sub}.{n[:-3]}" for n in os.listdir(os.path.join(PB, sub))
                  if n.endswith(".py") and n != "__init__.py")


def _loaded_after(code: str) -> set:
    probe = code + ("\nimport sys\n"
                    "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    code = "\n".join(
        ["import runpy, importlib.util, glob, os",
         "runpy.run_path('perfbench/run.py', run_name='perfbench_run')",
         "runpy.run_path('perfbench/control.py', run_name='perfbench_control')",
         "from perfbench import run",
         "[run.load_reader(os.path.basename(p)[:-3]) for p in glob.glob('perfbench/metrics/*.py')]"]
        + [f"import {m}" for m in _modules("drivers") + _modules("reference")]
        + ["import perfbench.gen, perfbench.las, perfbench.compare, perfbench.devtrace,"
           " perfbench.weights, perfbench.yardstick",
           "import myria3d_tpu_torch.predict, myria3d_tpu_torch.models.model"])
    loaded = _loaded_after(code)
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    assert "myria3d_tpu_torch" in loaded


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("\n".join(f"import {m}" for m in _modules("reference")))
    assert not loaded & (FORBIDDEN | {"myria3d_tpu_torch"})
