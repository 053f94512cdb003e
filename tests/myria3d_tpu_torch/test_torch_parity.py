"""The port's checkpoint-parity harness (``python -m myria3d_tpu_torch.parity``)
held against the JAX package's (``myria3d_tpu/parity.py``): the scoring and
the hparams read from the frozen config equal JAX's on the same inputs, the
synthetic Lightning checkpoint and its golden shapes are JAX's, the
conversion carries every entry exactly, and the harness runs end to end on
the CPU (the proto151 checkpoint is not in the repository: a synthetic
checkpoint with the reference layout stands in, as in
``tests/myria3d_tpu/test_parity.py``): informational without a reference
output, PASS against its own output, FAIL (exit 1) against an output that
disagrees.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from myria3d_tpu import parity as jax_parity
from myria3d_tpu.utils.torch_ckpt import golden_pyg_state_shapes as jax_golden
from myria3d_tpu.utils.torch_ckpt import make_synthetic_lightning_checkpoint as jax_make_ckpt
from myria3d_tpu_torch import parity
from myria3d_tpu_torch.pctl.dataset.toy_dataset import write_synthetic_toy_las
from myria3d_tpu_torch.pctl.io.las import read_las, write_las
from myria3d_tpu_torch.utils.checkpoint import (
    convert_checkpoint_file,
    golden_pyg_state_shapes,
    load_checkpoint,
    make_synthetic_lightning_checkpoint,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CODES = [1, 2, 5, 6, 9, 17, 64]


@pytest.mark.parametrize("seed,absent", [(0, False), (1, True)])
def test_iou_table_matches_jax(seed, absent):
    rng = np.random.default_rng(seed)
    pred = rng.choice(CODES + [3, 99], 500)
    target = rng.choice(CODES + [50], 500)
    if absent:      # a class in neither: IoU 1 on both sides
        pred[pred == 17], target[target == 17] = 2, 2
    assert parity._iou_table(pred, target, CODES) == jax_parity._iou_table(pred, target, CODES)


def test_iou_table_with_nothing_scored_matches_jax():
    got = parity._iou_table(np.array([1, 2]), np.array([50, 50]), CODES)
    want = jax_parity._iou_table(np.array([1, 2]), np.array([50, 50]), CODES)
    assert np.isnan(got["accuracy"]) and np.isnan(want["accuracy"])
    assert {k: v for k, v in got.items() if k != "accuracy"} == {
        k: v for k, v in want.items() if k != "accuracy"}


@pytest.mark.parametrize("overrides", [{}, {"model.neural_net_class_name": "PyGRandLANet"},
                                       {"model.neural_net_class_name": "PointNet2"}])
def test_model_hparams_from_config_match_jax(overrides):
    got = parity._model_hparams_from_config(
        parity._load_frozen_config(parity.DEFAULT_CONFIG, dict(overrides)))
    want = jax_parity._model_hparams_from_config(
        jax_parity._load_frozen_config(jax_parity.DEFAULT_CONFIG, dict(overrides)))
    assert got == want
    assert got["neural_net_class_name"] in ("RandLANet", "PointNet2")


def test_synthetic_checkpoint_converts_exactly(tmp_path):
    assert golden_pyg_state_shapes(9, 7) == jax_golden(9, 7)
    ours = torch.load(make_synthetic_lightning_checkpoint(str(tmp_path / "a.ckpt"), seed=3),
                      weights_only=False)
    theirs = torch.load(jax_make_ckpt(str(tmp_path / "b.ckpt"), seed=3), weights_only=False)
    assert ours.keys() == theirs.keys() and ours["state_dict"].keys() == theirs["state_dict"].keys()
    for k, v in ours["state_dict"].items():
        assert torch.equal(v, theirs["state_dict"][k]), k

    hparams = parity._model_hparams_from_config(
        parity._load_frozen_config(parity.DEFAULT_CONFIG, {}))
    out = convert_checkpoint_file(str(tmp_path / "a.ckpt"), str(tmp_path / "conv"), hparams)
    model = load_checkpoint(out)
    sd = model.net.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == golden_pyg_state_shapes(9, 7)
    for k, v in sd.items():     # num_batches_tracked has no counterpart: ignored
        assert torch.equal(v, ours["state_dict"][f"model.{k}"]), k

    del ours["state_dict"]["model.fc0.bias"]
    torch.save(ours, tmp_path / "short.ckpt")
    with pytest.raises(KeyError, match="fc0.bias"):
        convert_checkpoint_file(str(tmp_path / "short.ckpt"), str(tmp_path / "c2"), hparams)


def _report(stdout: str) -> dict:
    return json.loads([line for line in stdout.splitlines() if line.startswith("{")][-1])


def test_harness_end_to_end_on_the_cpu(tmp_path, capsys):
    tile = write_synthetic_toy_las(str(tmp_path / "tile.las"), n_points=6000)
    ckpt = make_synthetic_lightning_checkpoint(str(tmp_path / "proto.ckpt"))
    args = [ckpt, tile, "--epsg", "2154", "--batch-size", "4", "--accelerator", "cpu"]
    r1 = subprocess.run([sys.executable, "-m", "myria3d_tpu_torch.parity", *args,
                         "--output-dir", str(tmp_path / "run1")], cwd=REPO, capture_output=True,
                        text=True, timeout=600, env={**os.environ, "PYTHONPATH": REPO})
    assert r1.returncode == 0, r1.stdout[-2000:] + r1.stderr[-3000:]
    rep1 = _report(r1.stdout)
    assert rep1["verdict"] == "INFORMATIONAL" and rep1["n_points"] == 6000
    assert np.isfinite(rep1["ours_vs_gt"]["miou"]) and os.path.isfile(rep1["predicted_las"])

    # against its own output: the same classes, PASS with a zero gap
    assert parity.main([*args, "--output-dir", str(tmp_path / "run2"),
                        "--ref-out", rep1["predicted_las"]]) == 0
    rep2 = _report(capsys.readouterr().out)
    assert rep2["verdict"] == "PASS" and rep2["miou_diff"] == 0.0
    assert rep2["ours_vs_ref"]["agreement"] == 1.0

    # against a reference that predicted the ground truth: FAIL, exit 1
    ref = read_las(rep1["predicted_las"])
    pts = ref.points.copy()
    pts["PredictedClassification"] = pts["Classification"]
    write_las(str(tmp_path / "ref.las"), pts, ref.header)
    assert parity.main([*args, "--output-dir", str(tmp_path / "run3"), "--tolerance", "0.05",
                        "--ref-out", str(tmp_path / "ref.las")]) == 1
    rep3 = _report(capsys.readouterr().out)
    assert rep3["verdict"] == "FAIL" and rep3["miou_diff"] > 0.05
    assert rep3["ours_vs_ref"]["agreement"] < 1.0
