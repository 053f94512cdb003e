"""The port's full-cloud test path and its device rule on the CPU:
``Trainer.test`` against the JAX package's on the same converted weights,
the subsampled fallback and its strict guard, ``task.task_name=test`` and
``create_hdf5`` through the CLI, and the rule that every entry point runs
on CUDA unless the caller asks for the CPU.

``Trainer.test`` parity: deterministic decimation on both sides (the
``det_decimation`` fixture), the two-op f32 interpolation
(``predict.exact_interpolation``), and the JAX searches on their own kernel
in interpret mode with one bin per key (exact selection, the port's
summation order). ``test/loss_epoch`` agrees within 1e-4 relative; the
confusion matrices differ only by points whose two largest f16 full-cloud
logits lie within 0.02 of each other (two f16 steps at |logit| < 8), where
the 1e-5 float32 differences of the two forwards may flip the argmax.
"""

import logging
import os

import h5py
import jax
import numpy as np
import pytest
import torch

from myria3d_tpu.callbacks.metric_callbacks import ModelMetrics as JaxModelMetrics
from myria3d_tpu.models.criterion import CrossEntropyLoss as JaxCrossEntropy
from myria3d_tpu.models.model import Model as JaxModel
from myria3d_tpu.models.modules.randla_net import RandLANet as JaxRandLANet
from myria3d_tpu.train import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from myria3d_tpu_torch import run
from myria3d_tpu_torch.callbacks.metric_callbacks import ModelMetrics
from myria3d_tpu_torch.models.model import Model, build_net
from myria3d_tpu_torch.pctl.batching import PointCloudBatch, collate_padded, pad_full_cloud
from myria3d_tpu_torch.predict import predict_device
from myria3d_tpu_torch.train import Trainer, TrainerConfig
from myria3d_tpu_torch.utils.checkpoint import state_dict_from_jax
from tests.myria3d_tpu_torch.test_torch_slice import (  # noqa: F401  (fixture)
    _random_jax_variables,
    det_decimation,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CKPT = os.path.join(REPO, "trained_model_assets", "randlanet_toy_V0.5.0_torch")
N, C = 640, 7
TIE_GAP = 0.02


def _samples():
    """Two subtiles with their full-cloud copies (sampled positions in the
    full cloud's frame, as ``CopySampledPos`` keeps them)."""
    rng = np.random.default_rng(5)
    out = []
    for n, m in ((N, 1024), (N - 100, 800)):
        pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        out.append({"pos": pos, "x": rng.uniform(0, 1, (n, 9)).astype(np.float32),
                    "y": rng.integers(0, C, n), "idx_in_original_cloud": np.arange(m),
                    "copies": {"pos_copy": rng.uniform(-1, 1, (m, 3)).astype(np.float32),
                               "transformed_y_copy": rng.integers(0, C, m),
                               "pos_sampled_copy": pos}})
    return out


class FullCloudDataModule:
    batch_size = 2

    def prepare_data(self, stage=None):
        pass

    def setup(self, stage=None):
        pass

    def test_dataloader(self):
        return [collate_padded(_samples(), 2, (N,))]


def _keep_cm(cls):
    class Keeping(cls):
        """Keeps the confusion matrix that ``compute_and_reset`` drops."""

        def compute_and_reset(self, phase):
            self.kept = np.asarray(self.confusion_matrix(phase))
            return super().compute_and_reset(phase)

    return Keeping(C)


def test_trainer_test_matches_jax(det_decimation, jax_search_on_its_kernel):  # noqa: F811
    dm = FullCloudDataModule()
    params, stats = _random_jax_variables(JaxRandLANet(num_features=9, num_classes=C), N)

    jax_search_on_its_kernel()
    jmodel = JaxModel("RandLANet", {"num_features": 9, "num_classes": C},
                      criterion=JaxCrossEntropy(ignore_index=65))
    state = jmodel.init_state(jax.random.PRNGKey(0), dm.test_dataloader()[0].device_arrays())
    state = state.replace(params=params, batch_stats=stats)
    jtrainer = JaxTrainer(JaxTrainerConfig(devices=1),
                          callbacks={"model_detailed_metrics": _keep_cm(JaxModelMetrics)}, seed=0)
    jtrainer.exact_interpolation = True
    want = jtrainer.test(jmodel, dm, state=state)

    net = build_net("RandLANet", {"num_features": 9, "num_classes": C})
    net.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    model = Model(net, interpolation_k=10)
    full_logits = []
    step = model.interp_step
    model.interp_step = lambda *a, **kw: full_logits.append(step(*a, **kw)) or full_logits[-1]
    trainer = Trainer(TrainerConfig(accelerator="cpu"),
                      callbacks={"model_detailed_metrics": _keep_cm(ModelMetrics)}, seed=0)
    trainer.exact_interpolation = True
    got = trainer.test(model, dm)

    assert got.keys() == want.keys()
    assert got["test/loss_epoch"] == pytest.approx(want["test/loss_epoch"], rel=1e-4)
    (logits,) = full_logits
    top2 = logits.float().topk(2, dim=-1).values
    full_mask = torch.from_numpy(pad_full_cloud(dm.test_dataloader()[0].copies)["full_mask"])
    ties = int((((top2[..., 0] - top2[..., 1]) <= TIE_GAP) & full_mask).sum())
    moved = np.abs(trainer.metrics.kept - jtrainer.metrics.kept).sum()
    assert moved <= 2 * ties, (moved, ties)
    assert trainer.metrics.kept.sum() == jtrainer.metrics.kept.sum() == 1024 + 800


def _batch_without_copies(seed=0):
    rng = np.random.default_rng(seed)
    return PointCloudBatch(
        pos=rng.uniform(-1, 1, (2, 256, 3)).astype(np.float32),
        x=rng.uniform(0, 1, (2, 256, 9)).astype(np.float32),
        y=rng.integers(0, C, (2, 256)).astype(np.int32),
        mask=np.ones((2, 256), bool), num_valid=np.full(2, 256, np.int32),
        idx_in_original_cloud=[None] * 2, copies=[{} for _ in range(2)])


class NoCopiesDataModule(FullCloudDataModule):
    def test_dataloader(self):
        return [_batch_without_copies(0), _batch_without_copies(1)]


def _trainer():
    torch.manual_seed(0)
    model = Model(build_net("RandLANet", {"num_features": 9, "num_classes": C,
                                          "num_neighbors": 8}))
    trainer = Trainer(TrainerConfig(accelerator="cpu", limit_test_batches=2),
                      callbacks={"model_detailed_metrics": ModelMetrics(C)}, seed=0)
    return trainer, model


def test_subsampled_fallback_warns_once(caplog):
    trainer, model = _trainer()
    with caplog.at_level(logging.WARNING, logger="myria3d_tpu_torch.train"):
        out = trainer.test(model, NoCopiesDataModule())
    assert np.isfinite(out["test/loss_epoch"])
    assert sum("SUBSAMPLED-regime" in r.getMessage() for r in caplog.records) == 1


def test_strict_full_cloud_raises():
    trainer, model = _trainer()
    trainer.strict_full_cloud = True
    with pytest.raises(RuntimeError, match="strict_full_cloud"):
        trainer.test(model, NoCopiesDataModule())


@pytest.fixture(scope="module")
def cli_hdf5(tmp_path_factory, toy_las_path):
    """The toy HDF5 built by ``task.task_name=create_hdf5`` of the CLI."""
    work = tmp_path_factory.mktemp("cli")
    csv = work / "split.csv"
    name = os.path.basename(toy_las_path)
    csv.write_text("basename,split\n" + "".join(f"{name},{s}\n" for s in ("train", "val", "test")))
    hdf5 = str(work / "toy.hdf5")
    cwd = os.getcwd()
    try:
        run.main(["task.task_name=create_hdf5", "dataset_description=toy_synthetic",
                  f"datamodule.data_dir={os.path.dirname(toy_las_path)}",
                  f"datamodule.split_csv_path={csv}", f"datamodule.hdf5_file_path={hdf5}",
                  "datamodule.tile_width=110", f"hydra.run.dir={work}/run"])
    finally:
        os.chdir(cwd)
    return hdf5


@pytest.mark.parametrize("task", ["create_hdf5", "test"])
def test_cli_runs_the_ported_tasks(cli_hdf5, tmp_path, monkeypatch, task):
    """``create_hdf5`` writes every split's samples; ``test`` evaluates the
    toy checkpoint on the test split, full-cloud, and logs its IoU."""
    if task == "create_hdf5":
        with h5py.File(cli_hdf5, "r") as f:
            assert {"train", "val", "test"} <= set(f)
            assert all(len(f[s]) > 0 for s in ("train", "val", "test"))
        return
    monkeypatch.chdir(tmp_path)
    trainer = run.main(["task.task_name=test", "dataset_description=toy_synthetic",
                        f"datamodule.hdf5_file_path={cli_hdf5}", f"model.ckpt_path={CKPT}",
                        "trainer.accelerator=cpu", "trainer.limit_test_batches=1",
                        "datamodule.batch_size=2", "datamodule.num_workers=1", "logger=csv",
                        f"hydra.run.dir={tmp_path}/run"])
    csv = open(trainer.logger.metrics_path).read()
    assert "test/loss_epoch" in csv and "test/iou" in csv and trainer.global_step == 0


def test_cli_test_needs_a_checkpoint_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="ckpt_path"):
        run.main(["task.task_name=test", f"hydra.run.dir={tmp_path}/run"])


@pytest.mark.parametrize("accelerator", ["auto", "gpu", "cuda"])
def test_fit_needs_cuda_unless_cpu_is_asked(monkeypatch, accelerator):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="accelerator=cpu"):
        TrainerConfig(accelerator=accelerator).device()
    assert TrainerConfig(accelerator="cpu").device() == torch.device("cpu")


@pytest.mark.parametrize("task", ["fit", "predict"])
def test_cli_with_the_shipped_configs_needs_cuda(tmp_path, monkeypatch, task):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="none is available"):
        run.main([f"task.task_name={task}", f"hydra.run.dir={tmp_path}/run",
                  f"predict.src_las={tmp_path}/none.las"])


def test_predict_device_rule(monkeypatch):
    cfg = {"predict": {"gpus": 0}, "trainer": {"accelerator": "auto"}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert predict_device(cfg) == torch.device("cuda:0")
    assert predict_device({**cfg, "predict": {"gpus": [1]}}) == torch.device("cuda:1")
    assert predict_device(cfg, "cpu") == torch.device("cpu")
    assert predict_device({**cfg, "trainer": {"accelerator": "cpu"}}) == torch.device("cpu")
