"""The port stands alone: no module of ``myria3d_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax or the JAX package, statically or on
the paths they run (predict, fit, test, finetune, the LR range test), and the host modules the port
copied from the JAX package give the same outputs as their originals on
the same seeded inputs."""

import ast
import copy
import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

from myria3d_tpu.models.interpolation import Interpolator as JaxInterpolator
from myria3d_tpu.pctl import batching as jax_batching
from myria3d_tpu.pctl.dataset.toy_dataset import write_synthetic_toy_las
from myria3d_tpu.pctl.dataset.utils import read_las_array as jax_read_las_array
from myria3d_tpu.pctl.dataset.utils import split_cloud_into_samples as jax_split
from myria3d_tpu.pctl.io import las as jax_las
from myria3d_tpu.pctl.points_pre_transform.lidar_hd import (
    lidar_hd_pre_transform as jax_pre_transform,
)
from myria3d_tpu.utils import config as jax_config
from myria3d_tpu.utils.torch_ckpt import convert_randlanet_state_dict as jax_convert
from myria3d_tpu.utils.torch_ckpt import flax_to_torch_state_dict as jax_flax_to_torch
from myria3d_tpu_torch.models.interpolation import Interpolator
from myria3d_tpu_torch.pctl import batching
from myria3d_tpu_torch.pctl.dataset.utils import read_las_array, split_cloud_into_samples
from myria3d_tpu_torch.pctl.io import las
from myria3d_tpu_torch.pctl.points_pre_transform.lidar_hd import lidar_hd_pre_transform
from myria3d_tpu_torch.train import port_targets
from myria3d_tpu_torch.utils import config
from myria3d_tpu_torch.utils.checkpoint import convert_randlanet_state_dict, flax_to_torch_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG_DIR = os.path.join(REPO, "configs")
FOREIGN = ("jax", "jaxlib", "flax", "myria3d_tpu")


def _port_sources():
    root = os.path.join(REPO, "myria3d_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")]
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in FOREIGN]
    assert not bad, bad


# A sys.meta_path finder refusing JAX, flax and the JAX package, then the
# port's modules, its predict path, two fit steps plus the test after fit
# from the toy HDF5, a finetune from the fit's checkpoint and a three-step
# LR range test, all on the CPU.
_GUARDED_RUN = r'''
import importlib, os, pkgutil, sys
FOREIGN = {"jax", "jaxlib", "flax", "myria3d_tpu"}

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FOREIGN:
            raise ImportError(f"refused: {name}")
        return None

sys.meta_path.insert(0, Refuse())
import myria3d_tpu_torch
for mod in pkgutil.walk_packages(myria3d_tpu_torch.__path__, "myria3d_tpu_torch."):
    importlib.import_module(mod.name)
import chip_smoke
from myria3d_tpu_torch import run
from myria3d_tpu_torch.pctl.dataset.toy_dataset import make_toy_dataset_from_test_file

work, tile = sys.argv[1], sys.argv[2]
outs = run.main(["task.task_name=predict", f"predict.src_las={tile}",
                 f"predict.ckpt_path={sys.argv[3]}", f"predict.output_dir={work}/out",
                 "datamodule.batch_size=2", "trainer.accelerator=cpu"])
assert outs == [f"{work}/out/{os.path.basename(tile)}"], outs
hdf5 = make_toy_dataset_from_test_file(f"{work}/toy.hdf5", tile)
trainer = run.main(["task.task_name=fit", "dataset_description=toy_synthetic",
                    f"datamodule.hdf5_file_path={hdf5}", "trainer.accelerator=cpu",
                    "trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
                    "trainer.limit_test_batches=1", f"hydra.run.dir={work}/run",
                    "logger=csv", "datamodule.num_workers=1"])
assert trainer.global_step == 2, trainer.global_step
ckpt = os.path.abspath(trainer.checkpoint_cb.last_model_path)
ft = run.main(["task.task_name=finetune", "experiment=DebugFineTune",
               "dataset_description=toy_synthetic", f"datamodule.hdf5_file_path={hdf5}",
               "trainer.accelerator=cpu", f"model.ckpt_path={ckpt}", f"hydra.run.dir={work}/ft",
               "logger=csv", "datamodule.num_workers=1"])
assert ft.global_step == 1, ft.global_step
from myria3d_tpu_torch.train import build_trainer, lr_range_test, port_targets
from myria3d_tpu_torch.utils.config import instantiate
cfg = run.compose_config(run.CONFIG_DIR, "config.yaml", [
    "dataset_description=toy_synthetic", f"datamodule.hdf5_file_path={hdf5}",
    "datamodule.num_workers=1", "trainer.accelerator=cpu"])
_, model = build_trainer(cfg)
lr = lr_range_test(model, instantiate(port_targets(cfg["datamodule"])), num_steps=3)
assert 1e-4 <= lr <= 3.0, lr
bad = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
assert not bad, bad
print("STANDALONE_OK")
'''


def test_port_runs_with_the_jax_package_unimportable(tmp_path):
    tile = write_synthetic_toy_las(str(tmp_path / "tile.las"), n_points=6000)
    ckpt = os.path.join(REPO, "trained_model_assets", "randlanet_toy_V0.5.0_torch")
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    res = subprocess.run([sys.executable, "-c", _GUARDED_RUN, str(tmp_path), tile, ckpt],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=900)
    assert res.returncode == 0 and "STANDALONE_OK" in res.stdout, res.stderr[-4000:]


# ---------------------------------------------------------------------------
# parity of the copied host modules


@pytest.fixture(scope="module")
def tile(tmp_path_factory):
    return write_synthetic_toy_las(str(tmp_path_factory.mktemp("tile") / "t.las"), n_points=4000)


def _assert_same(a, b, path="data"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
        assert a.dtype == b.dtype, path
    else:
        assert a == b, path


@pytest.mark.parametrize("fmt", ["las", "laz"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_las_round_trip_between_the_copies(tile, tmp_path, fmt, writer):
    """Each side writes the same points (the same bytes), and each reads
    what the other wrote into the same array."""
    pts, header = jax_las.read_las(tile).points, jax_las.read_las(tile).header
    w_mod, r_mod = (las, jax_las) if writer == "port" else (jax_las, las)
    path, other = str(tmp_path / f"a.{fmt}"), str(tmp_path / f"b.{fmt}")
    w_mod.write_las(path, pts, header)
    r_mod.write_las(other, pts, header)
    assert filecmp.cmp(path, other, shallow=False)
    _assert_same(r_mod.read_las(path).points, w_mod.read_las(path).points)
    _assert_same(r_mod.read_las(path).points, pts)


def _transform_nodes():
    """Every transform node of ``configs/`` (default, heavy augmentations,
    fixed-point preparations), one per class."""
    nodes = {}
    for ov in ([], ["datamodule/transforms/augmentations=heavy"],
               ["datamodule/transforms/preparations=fixed_num_points"]):
        t = jax_config.compose(CONFIG_DIR, "config.yaml", ov)["datamodule"]["transforms"]
        for key in ("preparations_train_list", "preparations_eval_list",
                    "preparations_predict_list", "augmentations_list", "normalizations_list"):
            for node in t[key]:
                nodes.setdefault(node["_target_"].rsplit(".", 1)[1], node)
    nodes["SortPointsByX"] = {"_target_": "myria3d_tpu.pctl.transforms.transforms.SortPointsByX"}
    return nodes


TRANSFORMS = _transform_nodes()


@pytest.fixture(scope="module")
def sample(tile):
    pts, _ = jax_read_las_array(tile, None)
    return jax_pre_transform(pts)


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_the_jax_package(sample, name):
    node = TRANSFORMS[name]
    outs = []
    for inst, tree in ((jax_config.instantiate, node), (config.instantiate, port_targets(node))):
        transform = inst(copy.deepcopy(tree))
        np.random.seed(3)
        outs.append(transform(copy.deepcopy(sample)))
    assert type(transform).__module__.startswith("myria3d_tpu_torch.")
    _assert_same(*outs)


def test_lidar_hd_pre_transform_and_subtiles_match(tile):
    pts, header = read_las_array(tile, None)
    jpts, jheader = jax_read_las_array(tile, None)
    _assert_same(pts, jpts)
    _assert_same(lidar_hd_pre_transform(pts), jax_pre_transform(jpts))
    kw = dict(tile_width=100, subtile_width=50, subtile_overlap=25)
    got = list(split_cloud_into_samples(tile, epsg=None, **kw))
    want = list(jax_split(tile, epsg=None, **kw))
    _assert_same([list(s) for s in got], [list(s) for s in want])


@pytest.mark.parametrize("n", [1, 300, 2048, 40_000, 70_000])
def test_bucketing_matches(n):
    assert batching.bucket_size(n, batching.DEFAULT_BUCKETS) == jax_batching.bucket_size(
        n, jax_batching.DEFAULT_BUCKETS)


def _samples(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n, m in ((300, 900), (120, 500), (513, 1400)):
        out.append({"pos": rng.normal(size=(n, 3)).astype(np.float32),
                    "x": rng.uniform(size=(n, 9)).astype(np.float32),
                    "y": rng.integers(0, 7, n).astype(np.int64),
                    "idx_in_original_cloud": rng.permutation(m)[:m],
                    "copies": {"pos_copy": rng.normal(size=(m, 3)).astype(np.float32),
                               "transformed_y_copy": rng.integers(0, 7, m),
                               "pos_sampled_copy": rng.normal(size=(n, 3)).astype(np.float32)}})
    return out + [None]


def test_padding_matches():
    """``collate_padded``, ``pad_full_cloud`` and ``pad_sampled_pos`` on the
    same samples: the same padded arrays."""
    batches = [mod.collate_padded(copy.deepcopy(_samples()), 4, mod.DEFAULT_BUCKETS)
               for mod in (batching, jax_batching)]
    for f in ("pos", "x", "y", "mask", "num_valid"):
        _assert_same(getattr(batches[0], f), getattr(batches[1], f), f)
    _assert_same(batching.pad_full_cloud(batches[0].copies),
                 jax_batching.pad_full_cloud(batches[1].copies))
    _assert_same(batching.pad_sampled_pos(batches[0].copies, batches[0].num_points),
                 jax_batching.pad_sampled_pos(batches[1].copies, batches[1].num_points))


def test_interpolator_writes_the_same_las(tile, tmp_path):
    """The same f16 logits merged by both Interpolators: byte-identical
    output LAS (probabilities, predicted class, entropy)."""
    cfg = jax_config.compose(CONFIG_DIR, "config.yaml", ["dataset_description=toy_synthetic"])
    node = cfg["predict"]["interpolator"]
    pts, header = jax_read_las_array(tile, None)
    rng = np.random.default_rng(0)
    # two batches of two overlapping subtiles, padded to 1600 full points
    chunks = [rng.permutation(len(pts))[:n] for n in (1500, 1200, 1600, 900)]
    logits = rng.normal(size=(2, 2, 1600, 7)).astype(np.float16)
    outs = []
    for inst, tree, sub in ((jax_config.instantiate, node, "jax"),
                            (config.instantiate, port_targets(node), "port")):
        itp = inst(copy.deepcopy(tree))
        itp.prepare(len(pts), points=pts.copy(), header=header)
        for b in range(2):
            itp.store_predictions(logits[b], chunks[2 * b:2 * b + 2])
        outs.append(itp.reduce_predictions_and_save(tile, str(tmp_path / sub), None))
    assert isinstance(itp, Interpolator) and not isinstance(itp, JaxInterpolator)
    assert filecmp.cmp(*outs, shallow=False)


def _flax_like_tree(seed=0):
    rng = np.random.default_rng(seed)
    params = {"fc0": {"kernel": rng.normal(size=(9, 8)), "bias": rng.normal(size=8)},
              "block1": {"mlp1": {"Dense_0": {"kernel": rng.normal(size=(8, 4)),
                                              "bias": rng.normal(size=4)},
                                  "MaskedBatchNorm_0": {"scale": rng.normal(size=4),
                                                        "bias": rng.normal(size=4)}}},
              "fp1": {"Dense_0": {"kernel": rng.normal(size=(4, 3))}}}
    stats = {"block1": {"mlp1": {"MaskedBatchNorm_0": {"mean": rng.normal(size=4),
                                                       "var": rng.uniform(size=4)}}}}
    return params, stats


def test_weight_mapping_matches():
    """``flax_to_torch_state_dict`` and its inverse give the JAX package's
    keys and arrays."""
    params, stats = _flax_like_tree()
    sd, jsd = flax_to_torch_state_dict(params, stats), jax_flax_to_torch(params, stats)
    _assert_same(sd, jsd)
    _assert_same(convert_randlanet_state_dict(sd, params, stats), jax_convert(jsd, params, stats))


@pytest.mark.parametrize("experiment", ["RandLaNetDebug", "predict", "test"])
def test_config_composition_matches(experiment):
    # both hydra dirs pinned: their defaults hold the time of composition
    ov = [f"experiment={experiment}", "datamodule.batch_size=3", "hydra.run.dir=run",
          "hydra.sweep.dir=sweep"]
    got = config.compose(CONFIG_DIR, "config.yaml", ov)
    want = jax_config.compose(CONFIG_DIR, "config.yaml", ov)
    assert config.to_yaml(got) == jax_config.to_yaml(want)
