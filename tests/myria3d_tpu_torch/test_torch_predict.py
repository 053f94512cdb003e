"""The port's predict pipeline end to end on the CPU (plain versions), its
CLI, its device selection, and the proof that it never imports JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from myria3d_tpu.pctl.dataset.toy_dataset import write_synthetic_toy_las
from myria3d_tpu.pctl.io.las import read_las
from myria3d_tpu_torch import predict as predict_mod
from myria3d_tpu_torch import run

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CKPT = os.path.join(REPO, "trained_model_assets", "randlanet_toy_V0.5.0_torch")
CLASSES = ["unclassified", "ground", "vegetation", "building", "water", "bridge",
           "lasting_above"]


@pytest.fixture(scope="module")
def small_tile(tmp_path_factory):
    """6 000 points over 100 m: four ~1 500-point subtiles, which pad to
    2 048 and so take the windowed searches of ``predict.sorted_window``."""
    path = str(tmp_path_factory.mktemp("tile") / "small_tile.las")
    return write_synthetic_toy_las(path, n_points=6000)


def _overrides(tile, out_dir):
    return ["task.task_name=predict", f"predict.src_las={tile}",
            f"predict.ckpt_path={CKPT}", f"predict.output_dir={out_dir}",
            "datamodule.batch_size=2"]


def test_cli_predict_writes_the_output_las(small_tile, tmp_path):
    outs = run.main(_overrides(small_tile, tmp_path))
    assert outs == [str(tmp_path / "small_tile.las")]
    src, res = read_las(small_tile).points, read_las(outs[0]).points
    assert len(res) == len(src)
    assert {"PredictedClassification", "entropy", *CLASSES} <= set(res.dtype.names)
    probas = np.stack([np.asarray(res[c], np.float64) for c in CLASSES], axis=1)
    sums = probas.sum(1)
    covered = np.abs(sums - 1.0) < 1e-3
    assert np.isfinite(probas).all() and (covered | (sums == 0)).all()
    assert covered.mean() > 0.9
    assert set(np.unique(res["PredictedClassification"][covered])) <= {1, 2, 5, 6, 9, 17, 64}
    entropy = np.asarray(res["entropy"])
    assert np.isfinite(entropy).all() and (entropy >= 0).all()


def test_predict_phases_and_resume(small_tile, tmp_path):
    cfg = run.compose_config(run.CONFIG_DIR, "config.yaml", _overrides(small_tile, tmp_path))
    phases = {}
    out = predict_mod.predict(cfg, phases=phases)
    assert os.path.isfile(out) and phases["n_batches"] == 2
    cfg["predict"]["resume"] = True
    mtime = os.path.getmtime(out)
    assert run.launch_predict(cfg) == [out] and os.path.getmtime(out) == mtime


@pytest.mark.parametrize("task", ["test", "finetune", "create_hdf5"])
def test_other_tasks_are_not_ported(task):
    with pytest.raises(NotImplementedError):
        run.main([f"task.task_name={task}"])


def test_device_from_gpus(monkeypatch):
    assert predict_mod.device_from_gpus(0) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for gpus in (1, [0]):
        with pytest.raises(RuntimeError):
            predict_mod.device_from_gpus(gpus)


def test_port_never_imports_jax(small_tile, tmp_path):
    """The port's modules, its predict path run end to end and the on-card
    smoke script import no JAX, even where JAX is installed (it is here)."""
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "import myria3d_tpu_torch._ext, myria3d_tpu_torch.ops.cuda_knn,"
        " myria3d_tpu_torch.ops.cuda_interp, myria3d_tpu_torch.ops.cuda_lfa\n"
        "from myria3d_tpu_torch import run\n"
        f"run.main({_overrides(small_tile, tmp_path)!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=600)
    assert res.returncode == 0 and "NO_JAX_OK" in res.stdout, res.stderr[-3000:]
