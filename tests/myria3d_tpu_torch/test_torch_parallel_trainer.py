"""Data-parallel training of the port through its entry points, on the CPU
(two gloo ranks), modelled on ``tests/myria3d_tpu/test_multiprocess_distributed.py``.

- Two ranks run ``run.main`` (fit, then the full-cloud test of the best
  checkpoint) in a process group: they read disjoint train samples, rank 0
  alone writes each checkpoint once, both ranks take the same steps and
  stop at the same epoch (early stopping), and the two-rank test's IoU
  equals a one-process test of the same checkpoint (decimation is
  deterministic in both, as in the train slice).
- ``python -m myria3d_tpu_torch.run trainer.devices=2`` starts its ranks
  itself for fit (local BN), test and finetune.

Every multi-process run has its own timeout. No module here imports JAX,
so the tests marked ``cuda`` (two ranks sharing the card over gloo, and
predict over two replicas on it) also run on the card with
``python -m pytest --noconftest``.
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RANKS_TIMEOUT = 400
CPU2 = ["cpu", "cpu"]
ASSETS = os.path.join(REPO, "trained_model_assets", "randlanet_toy_V0.5.0_torch")


def _det_decimation(mask, decimation, generator=None):
    """``test_torch_slice._port_det_decimation``: the first ``max(1, valid
    // decimation)`` slots of each cloud."""
    b, n = mask.shape
    n_out = n // decimation
    idx = torch.arange(n_out, device=mask.device).expand(b, n_out)
    valid = mask.sum(1)
    kept = torch.where(valid > 0, (valid // decimation).clamp(min=1), 0)
    new_mask = torch.arange(n_out, device=mask.device)[None, :] < kept[:, None]
    return torch.where(new_mask, idx, 0), new_mask


def _common(hdf5, run_dir):
    return ["experiment=RandLaNetDebug", "dataset_description=toy_synthetic", "logger=csv",
            "trainer.accelerator=cpu", f"datamodule.hdf5_file_path={hdf5}",
            "datamodule.num_workers=1", "datamodule.batch_size=1", f"hydra.run.dir={run_dir}"]


def _metrics(run_dir):
    versions = os.listdir(os.path.join(run_dir, "csv"))
    assert versions == ["version_0"], versions       # one logger wrote
    with open(os.path.join(run_dir, "csv", "version_0", "metrics.csv")) as f:
        return list(csv.DictReader(f))


def _last(rows, key):
    return [float(r[key]) for r in rows if r.get(key) not in (None, "")][-1]


def _rank_fit(argv, hdf5, out_dir):
    """One rank: its train indices, ``run.main(argv)`` with the checkpoint
    writes recorded, and what it did, to ``out_dir/rank<r>.json``."""
    import myria3d_tpu_torch.models.modules.randla_net as port_rl
    from myria3d_tpu_torch.data import HDF5LidarDataModule
    from myria3d_tpu_torch.parallel import ddp
    from myria3d_tpu_torch.run import main
    from myria3d_tpu_torch.utils import checkpoint

    port_rl.random_decimation = _det_decimation
    writes = []
    real_save = checkpoint.save_checkpoint

    def save(ckpt_dir, *args, **kwargs):
        writes.append(os.path.basename(ckpt_dir))
        return real_save(ckpt_dir, *args, **kwargs)

    checkpoint.save_checkpoint = save
    dm = HDF5LidarDataModule(data_dir=None, split_csv_path=None, hdf5_file_path=hdf5,
                             epsg=None, batch_size=2)
    dm.prepare_data()
    loader = dm.train_dataloader(seed=0)
    indices = loader._local_indices(*loader._resolve_process())
    trainer = main(argv)
    with open(os.path.join(out_dir, f"rank{ddp.rank()}.json"), "w") as f:
        json.dump({"indices": [int(dm.dataset.traindata.indices[i]) for i in indices],
                   "writes": writes, "steps": trainer.global_step,
                   "losses": trainer.train_losses,
                   "best": trainer.checkpoint_cb.best_model_path}, f)


def test_two_ranks_fit_and_test_through_run_main(tmp_path, toy_dataset_hdf5_path, monkeypatch):
    from myria3d_tpu_torch.parallel import spawn

    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # one core a rank

    run_dir = tmp_path / "fit"
    # a test batch (one cloud) a rank: the two ranks test the clouds of the
    # one process's first two batches (strided shards of the unshuffled split)
    argv = ["task.task_name=fit", "trainer.max_epochs=4", "trainer.limit_test_batches=1",
            # the first epoch improves, the second cannot: stop after it
            "callbacks.early_stopping.patience=1", "callbacks.early_stopping.min_delta=1e6",
            *_common(toy_dataset_hdf5_path, run_dir)]
    spawn(_rank_fit, CPU2, args=(argv, toy_dataset_hdf5_path, str(tmp_path)),
          timeout=RANKS_TIMEOUT)
    ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    # disjoint shards of the 8 train samples, one loader permutation
    assert not set(ranks[0]["indices"]) & set(ranks[1]["indices"])
    assert len(ranks[0]["indices"]) == len(ranks[1]["indices"]) == 4
    # both ranks ran the two epochs of the early stop, a step each, on the
    # same (reduced) losses
    assert ranks[0]["steps"] == ranks[1]["steps"] == 2
    assert ranks[0]["losses"] == ranks[1]["losses"] and np.isfinite(ranks[0]["losses"]).all()
    best = ranks[0]["best"]
    assert best == ranks[1]["best"] and os.path.dirname(best) == str(run_dir / "checkpoints")
    # rank 0 wrote "last" and any new best once at each validation end,
    # rank 1 nothing
    writes = ranks[0]["writes"]
    assert writes[:2] == ["last", "epoch_000"] and writes[2] == "last"
    assert writes[3:] in ([], ["epoch_001"]) and os.path.basename(best) == writes[-1 if
                                                                               len(writes) > 3 else 1]
    assert ranks[1]["writes"] == []
    rows = _metrics(run_dir)
    iou = _last(rows, "test/iou")

    # one process, the same checkpoint
    import myria3d_tpu_torch.models.modules.randla_net as port_rl
    from myria3d_tpu_torch.run import main

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_rl, "random_decimation", _det_decimation)
        mp.chdir(tmp_path)
        main(["task.task_name=test", f"model.ckpt_path={best}", "trainer.limit_test_batches=2",
              *_common(toy_dataset_hdf5_path, tmp_path / "test")])
    one = _metrics(tmp_path / "test")
    # the confusion matrices add up to the one process's (the loss is the
    # mean of the batches' means, which depends on the batches' grouping)
    assert iou == pytest.approx(_last(one, "test/iou"), abs=1e-12)
    assert np.isfinite(_last(rows, "test/loss_epoch"))


def test_sharded_loader_gives_each_rank_its_samples_and_its_own_bucket():
    """``PaddedBatchLoader`` over 2 ranks: the ``rank::2`` strides of one
    permutation (wrap-padded), as many batches on each rank, each batch in
    its own bucket, and a group whose samples are all filtered out becomes
    an all-masked filler batch in the smallest bucket."""
    from myria3d_tpu_torch.pctl.loader import PaddedBatchLoader

    rng = np.random.default_rng(0)
    sizes = [300, 900, 2000, 400, 700, 100, 3000]
    samples = [{"pos": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                "x": rng.uniform(0, 1, (n, 4)).astype(np.float32),
                "y": rng.integers(0, 7, n).astype(np.int32)} for n in sizes]
    samples[5] = None     # rank 1's last group: sample 5 and sample 0 (wrap)
    samples[0] = None
    seen, shapes = [], []
    for rank in range(2):
        loader = PaddedBatchLoader(samples, batch_size=2, shuffle=False, num_features=4,
                                   buckets=(512, 1024, 2048, 4096), process_index=rank,
                                   process_count=2)
        batches = list(loader)
        seen.append([int(b.num_valid.sum()) for b in batches])
        shapes.append([b.pos.shape for b in batches])
    # rank 0: samples 0 2 | 4 6; rank 1: 1 3 | 5 0 (8 = 7 wrap-padded)
    assert seen == [[2000, 3700], [1300, 0]]
    assert shapes == [[(2, 2048, 3), (2, 4096, 3)], [(2, 1024, 3), (2, 512, 3)]]


def test_one_process_test_over_two_replicas_matches_one_device(tmp_path, toy_dataset_hdf5_path,
                                                              monkeypatch):
    """``train(config)`` (no ranks started) with ``trainer.devices=2`` tests
    over two CPU replicas: three clouds a batch, padded to four rows with
    filler rows (ignore-coded targets), the same confusion matrix as one
    device; ``trainer.sync_batchnorm`` is a field of the trainer config."""
    import myria3d_tpu_torch.models.modules.randla_net as port_rl
    from myria3d_tpu_torch.run import compose_config, enter_run_dir
    from myria3d_tpu_torch.train import TrainerConfig, train

    cfg = TrainerConfig(sync_batchnorm=False, devices=2)
    assert cfg.sync_batchnorm is False and "sync_batchnorm" not in cfg.extra
    monkeypatch.setattr(port_rl, "random_decimation", _det_decimation)
    monkeypatch.chdir(tmp_path)
    ckpt = os.path.join(ASSETS)
    out = {}
    for devices in (1, 2):
        config = compose_config(os.path.join(REPO, "configs"), "config.yaml", [
            "task.task_name=test", f"model.ckpt_path={ckpt}", f"trainer.devices={devices}",
            *_common(toy_dataset_hdf5_path, tmp_path / f"d{devices}"),
            "datamodule.batch_size=3", "trainer.limit_test_batches=1"])
        enter_run_dir(config)
        trainer = train(config)
        assert (trainer.par is None) == (devices == 1)
        out[devices] = _metrics(tmp_path / f"d{devices}")
    assert len(trainer.par.replicas) == 2 and trainer.par.batch_multiple == 2
    for key in ("test/iou", "test/acc"):
        assert _last(out[2], key) == pytest.approx(_last(out[1], key), abs=1e-12)
    assert _last(out[2], "test/loss_epoch") == pytest.approx(_last(out[1], "test/loss_epoch"),
                                                            rel=1e-5)


def _cli(args, cwd):
    out = subprocess.run([sys.executable, "-m", "myria3d_tpu_torch.run", *args], cwd=cwd,
                         capture_output=True, text=True, timeout=RANKS_TIMEOUT,
                         env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-4000:]


def test_cli_devices_2_starts_the_ranks_for_fit_test_and_finetune(tmp_path,
                                                                   toy_dataset_hdf5_path):
    """``trainer.devices=2``: fit with local BN (``trainer.sync_batchnorm=false``),
    then test and finetune from its checkpoint, each over two ranks."""
    fit = tmp_path / "fit"
    _cli(["task.task_name=fit", "trainer.devices=2", "trainer.sync_batchnorm=false",
          *_common(toy_dataset_hdf5_path, fit)], REPO)
    ckpt = fit / "checkpoints" / "last"
    assert {"state_dict.npz", "hparams.json", "train_state.pt"} <= set(os.listdir(ckpt))
    rows = _metrics(fit)
    assert np.isfinite(_last(rows, "train/loss_step")) and 0.0 <= _last(rows, "test/iou") <= 1.0
    _cli(["task.task_name=test", "trainer.devices=2", f"model.ckpt_path={ckpt}",
          *_common(toy_dataset_hdf5_path, tmp_path / "test")], REPO)
    assert 0.0 <= _last(_metrics(tmp_path / "test"), "test/iou") <= 1.0
    ft = tmp_path / "ft"
    _cli(["task.task_name=finetune", "trainer.devices=2", f"model.ckpt_path={ckpt}",
          *_common(toy_dataset_hdf5_path, ft), "experiment=DebugFineTune"], REPO)
    rows = _metrics(ft)
    assert np.isfinite(_last(rows, "train/loss_step")) and not any("test/iou" in r and r["test/iou"]
                                                                  for r in rows)
    assert os.path.isdir(ft / "checkpoints" / "last")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card_rank_step(out_dir, batch, fused, sync_bn):
    """Phase 15 (a) at a small size: one rank's grad step on its half."""
    from myria3d_tpu_torch.models.model import Model, build_net
    from myria3d_tpu_torch.parallel import ParallelSteps, ddp

    import myria3d_tpu_torch.models.modules.randla_net as port_rl

    port_rl.random_decimation = _det_decimation
    r, dev = ddp.rank(), ddp.device()
    half = batch[0].shape[0] // 2
    x, pos, mask, y = (torch.from_numpy(a[r * half:(r + 1) * half]).to(dev) for a in batch)
    torch.manual_seed(0)
    model = Model(build_net("RandLANet", {"num_features": 9, "num_classes": 7,
                                          "fused_train_lfa": fused}))
    model.net.mlp_classif.dropout = [0.0, 0.0]
    model.to(dev)
    model.init_train_state()
    loss, _ = ParallelSteps(model, sync_bn=sync_bn).grad_step(x, pos, y, mask)
    torch.save({"loss": float(loss), "grads": {k: p.grad.cpu() for k, p in
                                                model.net.named_parameters()}},
               os.path.join(out_dir, f"rank{r}.pt"))


def _card_batch(b=4, n=2048):
    rng = np.random.default_rng(0)
    pos = rng.uniform(-10.0, 10.0, (b, n, 3)).astype(np.float32)
    x = rng.uniform(0.0, 1.0, (b, n, 9)).astype(np.float32)
    mask = np.arange(n)[None] < rng.integers(n // 2, n + 1, (b, 1))
    y = np.where(mask, rng.integers(0, 7, (b, n)), 65).astype(np.int64)
    return x, pos, mask, y


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_card_two_ranks_share_the_card_in_a_sync_bn_step(tmp_path, fused):
    """Two gloo ranks on ``cuda:0`` (the kernels in both) against the
    one-process step on the whole batch: loss within 1e-5 relative, the
    cosine of every gradient at least 0.999, but for those below 1e-6 of
    the largest tensor's norm: the biases right before a BatchNorm have an
    exact-zero gradient, f32 noise on both sides (``chip_smoke.cosines``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from myria3d_tpu_torch.models.model import Model, build_net
    from myria3d_tpu_torch.parallel import spawn

    import myria3d_tpu_torch.models.modules.randla_net as port_rl

    batch = _card_batch()
    spawn(_card_rank_step, ["cuda:0", "cuda:0"], args=(str(tmp_path), batch, fused, True),
          timeout=RANKS_TIMEOUT)
    got = torch.load(tmp_path / "rank0.pt", weights_only=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_rl, "random_decimation", _det_decimation)
        torch.manual_seed(0)
        model = Model(build_net("RandLANet", {"num_features": 9, "num_classes": 7,
                                              "fused_train_lfa": fused}))
        model.net.mlp_classif.dropout = [0.0, 0.0]
        model.to("cuda")
        model.init_train_state()
        x, pos, mask, y = (torch.from_numpy(a).cuda() for a in batch)
        loss, _ = model.grad_step(x, pos, y, mask)
    assert got["loss"] == pytest.approx(float(loss), rel=1e-5)
    top = max(float(p.grad.double().norm()) for p in model.net.parameters())
    for k, p in model.net.named_parameters():
        a, b = got["grads"][k].double().flatten(), p.grad.cpu().double().flatten()
        if float(b.norm()) > 1e-6 * top:
            assert float(a @ b / (a.norm() * b.norm())) >= 0.999, k


@pytest.mark.cuda
def test_card_predict_over_two_replicas_on_one_card(tmp_path):
    """``predict(config, devices=["cuda:0", "cuda:0"])`` at batch 5 (rows
    padded to 6) against the one-device predict: the same classes on at
    least 0.999 of the points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from myria3d_tpu_torch import predict as predict_mod
    from myria3d_tpu_torch.pctl.io.las import read_las
    from myria3d_tpu_torch.run import CONFIG_DIR, compose_config

    import myria3d_tpu_torch.models.modules.randla_net as port_rl

    tile = os.path.join(ASSETS, "toy_tile.las")
    classes = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_rl, "random_decimation", _det_decimation)
        for name, kw in (("one", {"device": "cuda:0"}), ("two", {"devices": ["cuda:0"] * 2})):
            cfg = compose_config(CONFIG_DIR, "config.yaml", [
                "task.task_name=predict", f"predict.src_las={tile}",
                f"predict.ckpt_path={ASSETS}", f"predict.output_dir={tmp_path / name}",
                "datamodule.batch_size=5"])
            res = read_las(predict_mod.predict(cfg, **kw)).points
            classes[name] = np.asarray(res["PredictedClassification"])
    assert float((classes["one"] == classes["two"]).mean()) >= 0.999
