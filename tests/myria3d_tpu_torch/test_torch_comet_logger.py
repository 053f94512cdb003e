"""The port's Comet logger and the trainer's logging hooks against the JAX
package (``myria3d_tpu/callbacks/logging_callbacks.py:67-133``,
``myria3d_tpu/train.py:184-195,444-458,706-707``), on the CPU.

A stand-in ``comet_ml`` module in ``sys.modules`` records every call made
to its ``Experiment``, so the path with credentials runs without a
network:

- the port's ``CometLogger`` and the JAX package's make the same calls for
  the same inputs; with no ``api_key``, ``disabled``, or no ``comet_ml``
  both do nothing and warn alike; off rank 0 the port's makes no experiment;
- a one-epoch ``fit`` through the port's CLI with ``logger=comet`` records
  the code directory (the port's), the logs path, the config, the metrics
  and the ``train_cm`` / ``val_cm`` / ``test_cm`` confusion matrices, each
  equal to the matrix the trainer's metrics were computed from;
- ``hparams.yaml`` of a port run equals what the JAX package's
  ``log_hyperparameters`` writes for the same config.
"""

import os
import sys
import types
import warnings

import numpy as np
import pytest
import torch

from myria3d_tpu.callbacks import logging_callbacks as jax_logging
from myria3d_tpu.utils import config as jax_config
from myria3d_tpu.utils import utils as jax_utils
from myria3d_tpu_torch import run
from myria3d_tpu_torch.callbacks import logging_callbacks as port_logging
from myria3d_tpu_torch.callbacks import metric_callbacks
from myria3d_tpu_torch.parallel import ddp
from myria3d_tpu_torch.train import build_trainer
from myria3d_tpu_torch.utils import config as port_config

torch.set_num_threads(1)

PORT_DIR = os.path.dirname(os.path.abspath(port_logging.__file__)).rsplit(os.sep, 1)[0]
KW = dict(api_key="key", workspace="ws", project_name="proj", experiment_name="run-1")


@pytest.fixture
def comet_ml(monkeypatch):
    """A stand-in ``comet_ml`` whose ``Experiment`` records its calls in
    ``module.calls`` as ``(method, args, kwargs)``."""
    module = types.ModuleType("comet_ml")
    module.calls = []

    class Experiment:
        def __init__(self, *args, **kwargs):
            module.calls.append(("Experiment", args, kwargs))

        def __getattr__(self, name):
            def record(*args, **kwargs):
                module.calls.append((name, args, kwargs))
            return record

    module.Experiment = Experiment
    monkeypatch.setitem(sys.modules, "comet_ml", module)
    return module


def _drive(logger_cls, **kwargs):
    """Every method of a logger, with the same inputs; the warnings given."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        logger = logger_cls(**kwargs)
    logger.log_metrics({"train/loss_step": np.float32(0.5), "epoch": 1, "bad": "x"}, step=3)
    logger.log_hyperparams({"model": {"lr": 0.1}, "seed": 1})
    logger.log_confusion_matrix(np.arange(9.0).reshape(3, 3), ["a", "b", "c"], 2, "val_cm")
    logger.log_code("/code/dir")
    logger.log_logs_path("/logs/dir")
    logger.finalize()
    return logger, [str(w.message) for w in caught]


def test_comet_logger_makes_the_jax_loggers_calls(comet_ml):
    _, port_warned = _drive(port_logging.CometLogger, **KW)
    port_calls, comet_ml.calls[:] = list(comet_ml.calls), []
    _, jax_warned = _drive(jax_logging.CometLogger, **KW)
    # repr: the NaN of an unconvertible metric equals itself there
    assert repr(port_calls) == repr(comet_ml.calls) and port_warned == jax_warned == []
    assert [c[0] for c in port_calls] == [
        "Experiment", "set_name", "log_metrics", "log_parameters", "log_confusion_matrix",
        "log_code", "log_parameter", "end"]
    assert port_calls[2][1][0]["epoch"] == 1.0 and np.isnan(port_calls[2][1][0]["bad"])


@pytest.mark.parametrize("case", ["no_api_key", "disabled", "no_comet_ml"])
def test_comet_logger_without_credentials_or_comet_ml_does_nothing(comet_ml, monkeypatch, case):
    kwargs = dict(KW)
    if case == "no_api_key":
        kwargs["api_key"] = ""
    elif case == "disabled":
        kwargs["disabled"] = True
    else:
        monkeypatch.setitem(sys.modules, "comet_ml", None)   # import raises ImportError
    port, port_warned = _drive(port_logging.CometLogger, **kwargs)
    ref, jax_warned = _drive(jax_logging.CometLogger, **kwargs)
    assert port.experiment is None and ref.experiment is None and comet_ml.calls == []
    assert port_warned == jax_warned
    assert len(port_warned) == (case == "no_comet_ml")


def test_comet_logger_off_rank_zero_makes_no_experiment(comet_ml, monkeypatch):
    monkeypatch.setattr(ddp, "is_rank_zero", lambda: False)
    logger, _ = _drive(port_logging.CometLogger, **KW)
    assert logger.experiment is None and comet_ml.calls == []


@pytest.fixture
def fresh_run_dir(tmp_path, monkeypatch):
    """cwd at ``tmp_path``, and no ``${hydra:...}`` values left by an earlier
    run in this process, in the port's config module or the JAX package's."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(port_config, "_runtime_info", {})
    monkeypatch.setattr(jax_config, "_runtime_info", {})
    return tmp_path


def _fit_overrides(hdf5, run_dir, logger):
    return ["task.task_name=fit", "experiment=RandLaNetDebug", "dataset_description=toy_synthetic",
            f"logger={logger}", "trainer.accelerator=cpu", f"datamodule.hdf5_file_path={hdf5}",
            "datamodule.num_workers=1", f"hydra.run.dir={run_dir}"]


def test_fit_with_comet_logger_records_the_jax_hooks(comet_ml, toy_dataset_hdf5_path,
                                                     fresh_run_dir, monkeypatch):
    """One epoch of ``fit`` (then the full-cloud test) with ``logger=comet``
    and a key: the code directory and logs path at fit start, the config,
    the metrics, and the three confusion matrices with the class names,
    each the one the trainer computed its metrics from."""
    seen = []
    real = metric_callbacks.ModelMetrics.compute_and_reset

    def spy(self, phase):
        seen.append((phase, self.summed(phase).copy()))
        return real(self, phase)

    monkeypatch.setattr(metric_callbacks.ModelMetrics, "compute_and_reset", spy)
    tmp_path = fresh_run_dir
    monkeypatch.setenv("LOGS_DIR", str(tmp_path / "logs"))
    trainer = run.main(_fit_overrides(toy_dataset_hdf5_path, tmp_path / "run", "comet")
                       + ["logger.comet.api_key=key", "datamodule.batch_size=1"])
    assert trainer.global_step == 1
    calls = comet_ml.calls
    names = [c[0] for c in calls]
    assert names[:4] == ["Experiment", "log_parameters", "log_code", "log_parameter"]
    assert calls[0][2] == {"api_key": "key", "workspace": None, "project_name": None}
    assert set(calls[1][1][0]) >= {"model", "trainer", "datamodule", "logger", "task", "seed"}
    assert calls[2][2] == {"folder": PORT_DIR}
    assert calls[3][1] == ("experiment_logs_dirpath", str(tmp_path / "logs"))
    metrics = [c[1][0] for c in calls if c[0] == "log_metrics"]
    assert any("train/loss_step" in m for m in metrics)
    assert any("val/loss_epoch" in m for m in metrics)
    assert any("test/loss_epoch" in m for m in metrics)
    cms = [c[2] for c in calls if c[0] == "log_confusion_matrix"]
    assert [c["title"] for c in cms] == ["train_cm", "val_cm", "test_cm"]
    assert [c["epoch"] for c in cms] == [0, 0, 0]   # as the JAX trainer passes them
    assert [p for p, _ in seen] == ["train", "val", "test"]
    metrics_cb = trainer.metrics
    labels = [metrics_cb.class_names.get(i, str(i)) for i in range(metrics_cb.num_classes)]
    for logged, (_, cm) in zip(cms, seen):
        assert logged["labels"] == labels
        np.testing.assert_array_equal(np.asarray(logged["matrix"]), cm)
    assert sum(np.asarray(c["matrix"]).sum() for c in cms) > 0


def test_hparams_yaml_equals_the_jax_log_hyperparameters(toy_dataset_hdf5_path, fresh_run_dir):
    """``csv/version_0/hparams.yaml``, written when the port's ``train()``
    builds its trainer (``build_trainer``, before any step), is what the
    JAX package's ``log_hyperparameters(logger, config, model, None)``
    writes for the same composed config."""
    tmp_path = fresh_run_dir
    # hydra.sweep.dir is stamped with the time of composition
    overrides = _fit_overrides(toy_dataset_hdf5_path, tmp_path / "run", "csv") + [
        f"hydra.sweep.dir={tmp_path / 'sweep'}"]
    written = {}

    class Recorder:
        def log_hyperparams(self, params):
            written["yaml"] = jax_config.to_yaml(params)

    jax_cfg = jax_config.compose(run.CONFIG_DIR, "config.yaml", overrides)
    jax_utils.log_hyperparameters(Recorder(), jax_cfg, None, None)
    config = run.compose_config(run.CONFIG_DIR, "config.yaml", overrides)
    run.enter_run_dir(config)
    build_trainer(config)
    with open(tmp_path / "run" / "csv" / "version_0" / "hparams.yaml") as f:
        assert f.read() == written["yaml"]
