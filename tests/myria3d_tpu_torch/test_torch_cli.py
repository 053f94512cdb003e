"""The port's CLI (``myria3d_tpu_torch/run.py``) against the JAX package's
``run.py``: argument parsing, ``.env``, ``extras`` and ``print_config``,
the run directory of every task (predict's too), ``experiment=predict``
under ``--config-path configs``, and the run directory the DDP ranks are
handed. The CLI predict on the card is ``test_torch_cli_card.py``."""

import os
import warnings

import numpy as np
import pytest
import torch

import run as jax_run
from myria3d_tpu.pctl.dataset.toy_dataset import write_synthetic_toy_las
from myria3d_tpu.pctl.io.las import read_las
from myria3d_tpu.utils import config as jax_config
from myria3d_tpu.utils import utils as jax_utils
from myria3d_tpu_torch import run
from myria3d_tpu_torch.parallel import ddp
from myria3d_tpu_torch.utils import config as port_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ASSETS = os.path.join(REPO, "trained_model_assets")
CKPT = os.path.join(ASSETS, "randlanet_toy_V0.5.0_torch")
FROZEN = "randlanet_tpu_predict_config_V0.1.0"


@pytest.fixture
def fresh_runtime(monkeypatch):
    """No ``${hydra:...}`` values left by an earlier run in this process, in
    the port's config module or the JAX package's."""
    monkeypatch.setattr(port_config, "_runtime_info", {})
    monkeypatch.setattr(jax_config, "_runtime_info", {})


@pytest.fixture(scope="module")
def small_tile(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tile") / "small_tile.las")
    return write_synthetic_toy_las(path, n_points=6000)


def _given(argv):
    return any(a in ("--config-path", "-cp") or a.startswith("--config-path=") for a in argv)


@pytest.mark.parametrize("argv", [
    [],
    ["-cp", "/x", "-cn", "y"],
    ["--config-path", "/x", "task.task_name=predict"],
    ["--config-path=/x", "--config-name=y", "task.task_name=predict"],
    ["--config-name=y"],
    ["--config-name", "y.yml", "a.b=1"],
    ["--config-path=a=b", "c.d=e=f"],
    ["bare", "task.task_name=test", "--verbose"],
    ["task.task_name=fit", "experiment=predict", "task.task_name=predict"],
    ["--config-path", "configs", "task.task_name=predict"],
], ids=["none", "short", "path", "path=name=", "name=", "yml", "equals_in_values", "bare",
        "last_task_wins", "configs"])
def test_parse_cli_matches_run_py(argv, capsys):
    """``parse_cli`` gives ``_parse_cli``'s split and prints its "Ignoring"
    lines; the one difference: no ``--config-path`` is the repository's
    ``configs/``, which ``run.py`` spells relative to the cwd."""
    port = run.parse_cli(argv)
    port_out = capsys.readouterr().out
    ref = jax_run._parse_cli(argv)
    ref_out = capsys.readouterr().out
    if not _given(argv):
        assert ref[0] == jax_run.DEFAULT_DIRECTORY
        ref = (run.CONFIG_DIR, *ref[1:])
    assert port == ref
    assert port_out == ref_out
    assert port_out.count("Ignoring unrecognized argument") == (2 if "bare" in argv else 0)


DOTENV = """# a comment
M3D_CLI_QUOTED="a quoted value"

  M3D_CLI_SPACED = spaced value
M3D_CLI_PRESET=from the file
M3D_CLI_EQUALS=a=b
M3D_CLI_EMPTY=
no equals sign here
#M3D_CLI_COMMENTED=1
"""


def test_dotenv_sets_what_run_py_sets(tmp_path, monkeypatch):
    """``main`` adds a ``.env``'s variables as ``run.py:217-223`` does: the
    same additions to ``os.environ``, and a variable set before survives."""
    (tmp_path / ".env").write_text(DOTENV)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("M3D_CLI_PRESET", "preset")
    for key in ("M3D_CLI_QUOTED", "M3D_CLI_SPACED", "M3D_CLI_EQUALS", "M3D_CLI_EMPTY",
                "M3D_CLI_COMMENTED"):
        monkeypatch.delenv(key, raising=False)
    before = dict(os.environ)

    def added(main, errors):
        with pytest.raises(errors):
            main(["task.task_name=bogus"])    # reads .env, then fails
        delta = {k: v for k, v in os.environ.items() if before.get(k) != v}
        for k in delta:
            del os.environ[k]
        return delta

    port = added(run.main, ValueError)
    ref = added(jax_run.main, (ValueError, FileNotFoundError))
    assert port == ref == {"M3D_CLI_QUOTED": "a quoted value", "M3D_CLI_SPACED": "spaced value",
                           "M3D_CLI_EQUALS": "a=b", "M3D_CLI_EMPTY": ""}
    assert os.environ["M3D_CLI_PRESET"] == "preset"


def _plain(cfg):
    return port_config._to_plain(cfg)


@pytest.mark.parametrize("flags,batch_size", [
    ([], 48),
    (["--config-path", "configs"], 48),
    (["--config-path=configs"], 48),
    (["-cp", os.path.join(REPO, "configs")], 2),        # run.py adds no experiment here
    (["--config-path", "configs", "experiment=RandLaNetDebug"], 2),
], ids=["no_flag", "configs", "configs=", "absolute", "experiment_given"])
def test_predict_config_matches_run_py(flags, batch_size, tmp_path, monkeypatch, fresh_runtime):
    """From the repository root, the predict config the port's ``main``
    composes equals the one ``run.py``'s ``main`` composes:
    ``experiment=predict`` (its batch size 48) when ``--config-path`` is
    absent or ``configs`` and no experiment is given."""
    monkeypatch.chdir(REPO)
    argv = [*flags, "task.task_name=predict", f"hydra.run.dir={tmp_path}/run",
            f"hydra.sweep.dir={tmp_path}/sweep"]
    seen = {}
    monkeypatch.setattr(run, "launch_predict", lambda cfg: seen.setdefault("port", cfg))
    monkeypatch.setattr(jax_run, "launch_predict", lambda cfg: seen.setdefault("jax", cfg))
    with warnings.catch_warnings():
        run.main(argv)
        os.chdir(REPO)
        jax_run.main(argv)
    assert _plain(seen["port"]) == _plain(seen["jax"])
    assert seen["port"]["datamodule"]["batch_size"] == batch_size


@pytest.mark.parametrize("frozen", [False, True], ids=["composed", "frozen"])
def test_predict_writes_in_the_run_directory_as_run_py(frozen, small_tile, tmp_path, monkeypatch,
                                                       fresh_runtime):
    """A relative ``predict.output_dir`` lands in the directory ``run.py``'s
    ``_enter_run_dir`` leaves the cwd in: ``hydra.run.dir`` for the composed
    config, the invoking cwd for the frozen config (no ``hydra`` node)."""
    monkeypatch.chdir(tmp_path)
    config = (["--config-path", ASSETS, "--config-name", FROZEN] if frozen
              else ["--config-path", os.path.join(REPO, "configs"), "experiment=predict",
                    "hydra.run.dir=run"])
    argv = [*config, "task.task_name=predict", f"predict.src_las={small_tile}",
            f"predict.ckpt_path={CKPT}", "predict.output_dir=out", "datamodule.batch_size=2",
            "trainer.accelerator=cpu"]
    where = {}
    monkeypatch.setattr(jax_run, "launch_predict", lambda cfg: where.setdefault("jax", os.getcwd()))
    with warnings.catch_warnings():
        jax_run.main(argv)
        os.chdir(tmp_path)
        outs = run.main(argv)
    assert where["jax"] == str(tmp_path if frozen else tmp_path / "run")
    assert os.getcwd() == where["jax"]
    assert [os.path.abspath(o) for o in outs] == [os.path.join(where["jax"], "out",
                                                               "small_tile.las")]
    res = read_las(outs[0]).points
    assert len(res) == len(read_las(small_tile).points)
    assert np.isfinite(np.asarray(res["entropy"])).all()


def test_dotenv_logs_dir_sets_the_run_directory(tmp_path, monkeypatch, fresh_runtime):
    """``LOGS_DIR`` from a ``.env`` places the run directory
    (``${oc.env:LOGS_DIR,logs}/runs/<date>/<time>``), as in ``run.py``."""
    (tmp_path / ".env").write_text(f"LOGS_DIR={tmp_path}/logs_env\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("LOGS_DIR")
    where = {}
    monkeypatch.setattr(run, "launch_predict", lambda cfg: where.setdefault("port", os.getcwd()))
    monkeypatch.setattr(jax_run, "launch_predict", lambda cfg: where.setdefault("jax", os.getcwd()))
    argv = [f"--config-path={REPO}/configs", "task.task_name=predict", "experiment=predict"]
    with warnings.catch_warnings():
        run.main(argv)
        assert os.environ.pop("LOGS_DIR") == f"{tmp_path}/logs_env"
        os.chdir(tmp_path)
        jax_run.main(argv)
    runs = os.path.join(tmp_path, "logs_env", "runs")
    for cwd in where.values():
        assert os.path.dirname(os.path.dirname(cwd)) == runs


FIT = ["task.task_name=fit", "experiment=RandLaNetDebug", "dataset_description=toy_synthetic",
       "logger=csv", "trainer.accelerator=cpu", "datamodule.num_workers=1",
       "datamodule.batch_size=2", "trainer.max_epochs=1", "trainer.limit_train_batches=1",
       "trainer.limit_val_batches=1", "trainer.limit_test_batches=1"]


def test_fit_writes_the_config_tree_of_run_py(toy_dataset_hdf5_path, tmp_path, monkeypatch,
                                              fresh_runtime):
    """A one-step CPU fit through ``main`` writes ``config_tree.txt`` in its
    run directory, byte-equal to ``run.py``'s ``print_config`` of the config
    ``run.py`` composes, and installs ``extras``' "ignore" filter as
    ``run.py``'s ``extras`` does."""
    monkeypatch.chdir(tmp_path)
    argv = [*FIT, f"datamodule.hdf5_file_path={toy_dataset_hdf5_path}",
            f"hydra.run.dir={tmp_path}/run", f"hydra.sweep.dir={tmp_path}/sweep"]
    ignore = ("ignore", None, Warning, None, 0)
    assert ignore not in warnings.filters
    with warnings.catch_warnings():
        trainer = run.main(argv)
        port_ignores = ignore in warnings.filters
    assert trainer.global_step == 1
    tree = (tmp_path / "run" / "config_tree.txt").read_bytes()

    os.chdir(tmp_path)
    _, _, overrides, _ = jax_run._parse_cli(argv)
    jax_cfg = jax_run._compose(run.CONFIG_DIR, "config.yaml", overrides)
    with warnings.catch_warnings():
        jax_utils.extras(jax_cfg)
        jax_ignores = warnings.filters[0] == ignore
    jax_utils.print_config(jax_cfg, save_path=str(tmp_path / "jax_tree.txt"))
    assert tree == (tmp_path / "jax_tree.txt").read_bytes()
    assert port_ignores and jax_ignores


@pytest.mark.parametrize("rank_zero,extra,written", [
    (True, [], True), (False, [], False), (True, ["print_config=false"], False),
], ids=["rank_zero", "other_rank", "print_config_false"])
def test_config_tree_on_rank_zero_only(rank_zero, extra, written, tmp_path, monkeypatch,
                                       fresh_runtime):
    """``print_config`` runs on rank zero unless ``print_config`` is false;
    ``extras`` runs in every rank."""
    import myria3d_tpu_torch.train as train_mod

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(ddp, "is_rank_zero", lambda: rank_zero)
    monkeypatch.setattr(train_mod, "train", lambda cfg: "trained")
    with warnings.catch_warnings():
        assert run.main([*FIT, f"hydra.run.dir={tmp_path}/run", *extra]) == "trained"
        assert warnings.filters[0] == ("ignore", None, Warning, None, 0)
    assert os.getcwd() == str(tmp_path / "run")
    assert (tmp_path / "run" / "config_tree.txt").exists() == written


@pytest.mark.parametrize("pinned", [False, True], ids=["now", "pinned_relative"])
def test_ranks_share_the_parent_run_directory(pinned, tmp_path, monkeypatch, fresh_runtime):
    """``start_ranks`` hands every rank the parent's absolute
    ``hydra.run.dir``, so ranks whose starts straddle a second of
    ``${now:%H-%M-%S}`` enter one directory; the parent enters none."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("LOGS_DIR", "rel_logs")
    seen = {}

    def spawn(fn, devices, args=()):
        seen.update(fn=fn, devices=devices, args=args)

    monkeypatch.setattr(ddp, "spawn", spawn)
    compose = run.compose_config
    monkeypatch.setattr(run, "compose_config",
                        lambda *a, **kw: seen.setdefault("config", compose(*a, **kw)))
    argv = [*FIT, "trainer.devices=2", *(["hydra.run.dir=pinned/run"] if pinned else [])]
    assert run.main(argv) is None
    assert os.getcwd() == str(tmp_path)
    assert seen["fn"] is run.main and len(seen["devices"]) == 2
    (rank_argv,) = seen["args"]
    assert rank_argv[:-1] == argv and rank_argv[-1].startswith("hydra.run.dir=")
    run_dir = rank_argv[-1].split("=", 1)[1]
    assert run_dir == os.path.join(str(tmp_path), seen["config"]["hydra"]["run"]["dir"])
    if pinned:
        assert run_dir == str(tmp_path / "pinned" / "run")
    else:
        assert os.path.dirname(os.path.dirname(run_dir)) == str(tmp_path / "rel_logs" / "runs")
    rank_cfg = compose(run.CONFIG_DIR, "config.yaml", run.parse_cli(rank_argv)[2])
    assert rank_cfg["hydra"]["run"]["dir"] == run_dir
