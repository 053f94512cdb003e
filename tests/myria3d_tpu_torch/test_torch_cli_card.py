"""The port's CLI predict on the card, as a user runs it. No JAX here:
run it on the card with ``python -m pytest --noconftest
tests/myria3d_tpu_torch/test_torch_cli_card.py``."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from myria3d_tpu_torch.pctl.io.las import read_las

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CKPT = os.path.join(REPO, "trained_model_assets", "randlanet_toy_V0.5.0_torch")
# GT accuracy of predict() on the card on this tile (chip_smoke.py phase 4)
CARD_ACCURACY = 0.7212


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_cli_predict_on_the_card(tmp_path, cuda_device):
    """``python -m myria3d_tpu_torch.run`` predicts on the card from a cwd
    whose ``.env`` sets ``LOGS_DIR``: the LAS lands in that run directory's
    ``out/`` (``.env``, the ``=`` flags and the run directory together),
    its GT accuracy within 0.005 of ``predict()``'s."""
    (tmp_path / ".env").write_text(f"LOGS_DIR={tmp_path}/logs_env\n")
    env = {k: v for k, v in os.environ.items() if k != "LOGS_DIR"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-m", "myria3d_tpu_torch.run", f"--config-path={REPO}/configs",
         "--config-name=config", "task.task_name=predict", "experiment=predict",
         f"predict.src_las={CKPT}/toy_tile.las", f"predict.ckpt_path={CKPT}",
         "predict.output_dir=out"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    (out,) = glob.glob(str(tmp_path / "logs_env" / "runs" / "*" / "*" / "out" / "toy_tile.las"))
    las = read_las(out).points
    acc = float((np.asarray(las["PredictedClassification"])
                 == np.asarray(las["Classification"])).mean())
    assert abs(acc - CARD_ACCURACY) <= 0.005, acc
