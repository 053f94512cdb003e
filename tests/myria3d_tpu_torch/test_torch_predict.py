"""The port's predict pipeline end to end on the CPU (plain versions), its
CLI, its device selection, and the proof that it never imports JAX or the
JAX package."""

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
            "datamodule.batch_size=2", "trainer.accelerator=cpu"]


def test_cli_predict_writes_the_output_las(small_tile, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)     # predict enters its run directory
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


def test_predict_reports_its_spans_and_merge_counters(small_tile, tmp_path, monkeypatch):
    """The streaming loop's spans (the loader wait, the enqueue, the fetch
    wait, the merge) cover ``streaming_s`` to within 10 %; the loader
    threads' cook is timed; ``merge_points`` counts every subtile's points
    the merge took: every covered point, and a point on a border between
    two subtiles twice."""
    from myria3d_tpu_torch.models.interpolation import Interpolator

    cfg = run.compose_config(run.CONFIG_DIR, "config.yaml", _overrides(small_tile, tmp_path))
    stored, merged = Interpolator.store_predictions, []

    def spy(self, logits, idx):
        merged.append(sum(len(i) for i in idx if i is not None))
        return stored(self, logits, idx)

    monkeypatch.setattr(Interpolator, "store_predictions", spy)
    phases = {}
    out = predict_mod.predict(cfg, phases=phases)
    loop = sum(phases[k] for k in ("loader_wait_s", "enqueue_s", "fetch_blocked_s", "merge_s"))
    assert phases["streaming_s"] > 0
    assert abs(loop - phases["streaming_s"]) <= 0.1 * phases["streaming_s"], phases
    assert phases["cook_busy_s"] > 0
    res = read_las(out).points
    sums = np.stack([np.asarray(res[c], np.float64) for c in CLASSES], axis=1).sum(1)
    covered = int((np.abs(sums - 1.0) < 1e-3).sum())
    assert phases["merge_points"] == sum(merged) and covered <= sum(merged) <= 1.01 * covered
    assert 0 <= phases["merge_points_native"] <= phases["merge_points"]


@pytest.mark.parametrize("setting,fused", [(True, False), (False, True), (None, True)])
def test_exact_interpolation_reaches_the_interpolation(small_tile, tmp_path, monkeypatch,
                                                       setting, fused):
    """``predict.exact_interpolation: true`` takes the f32 two-op
    interpolation (``fused_payload=False``); false or absent takes K3's
    fused path, as the JAX package's ``predict`` switches its step."""
    from myria3d_tpu_torch.models import model as model_mod

    seen = []
    real = model_mod.knn_interpolate

    def spy(*args, **kwargs):
        seen.append(kwargs["fused_payload"])
        return real(*args, **kwargs)

    monkeypatch.setattr(model_mod, "knn_interpolate", spy)
    cfg = run.compose_config(run.CONFIG_DIR, "config.yaml", _overrides(small_tile, tmp_path))
    if setting is None:
        cfg["predict"].pop("exact_interpolation", None)
    else:
        cfg["predict"]["exact_interpolation"] = setting
    assert os.path.isfile(predict_mod.predict(cfg))
    assert seen == [fused, fused]          # one full-cloud interpolation a batch


@pytest.mark.parametrize("task", ["finetune", "bogus"])
def test_other_tasks_are_not_ported(task, monkeypatch, tmp_path):
    """``finetune`` goes to ``train`` and, like every entry point, runs on
    CUDA unless asked for the CPU (no card: the device error); a task the
    CLI does not know raises before composing anything."""
    monkeypatch.chdir(tmp_path)     # the run directory is made under the cwd
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError if task == "finetune" else ValueError,
                       match="runs on CUDA" if task == "finetune" else "bogus"):
        run.main([f"task.task_name={task}"])


def test_device_from_gpus(monkeypatch):
    """``predict.gpus`` picks the CUDA device (``[i]`` -> ``cuda:i``, else
    ``cuda:0``; 0 no longer means the CPU); a missing CUDA device raises;
    the CPU only when asked (``device="cpu"``, ``trainer.accelerator=cpu``)."""
    cfg = {"predict": {"gpus": 0}, "trainer": {"accelerator": "auto"}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for gpus in (0, 1, [0]):
        with pytest.raises(RuntimeError):
            predict_mod.predict_device({**cfg, "predict": {"gpus": gpus}})
    assert predict_mod.predict_device(cfg, device="cpu") == torch.device("cpu")
    assert predict_mod.predict_device({**cfg, "trainer": {"accelerator": "cpu"}}) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert predict_mod.predict_device(cfg) == torch.device("cuda:0")
    assert predict_mod.predict_device({**cfg, "predict": {"gpus": [2]}}) == torch.device("cuda:2")


def test_port_never_imports_jax(small_tile, tmp_path):
    """The port's modules, its predict path run end to end and the on-card
    smoke script import no JAX and nothing of the JAX package, even where
    both are installed (they are here)."""
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "import myria3d_tpu_torch._ext, myria3d_tpu_torch.ops.cuda_knn,"
        " myria3d_tpu_torch.ops.cuda_interp, myria3d_tpu_torch.ops.cuda_lfa\n"
        "from myria3d_tpu_torch import run\n"
        f"run.main({_overrides(small_tile, tmp_path)!r})\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'myria3d_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=600)
    assert res.returncode == 0 and "NO_JAX_OK" in res.stdout, res.stderr[-3000:]
