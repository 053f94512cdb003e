"""CLI of the port — ``python -m myria3d_tpu_torch.run
task.task_name={fit,fit+test,test,finetune,predict,create_hdf5}
[--config-path DIR | --config-path=DIR] [--config-name NAME | --config-name=NAME]
[a.b=value ...]``.

Mirrors ``run.py``. It first adds the variables of a ``.env`` in the cwd
to the environment where unset (``LOGS_DIR``, the Comet credentials), then
composes the config and enters the per-run directory ``hydra.run.dir``
like hydra, for every task. ``fit`` (the default task) composes the config
tree under ``configs/`` (default experiment ``RandLaNetDebug``), writes
the config tree to ``config_tree.txt`` there (``print_config: false``
skips it) and runs ``myria3d_tpu_torch.train.train``: fit, then the
full-cloud test on the best checkpoint (``task.auto_lr_find=true`` runs
the LR range test first and fits from its suggestion). ``test`` evaluates
the checkpoint ``model.ckpt_path`` on the test split, full-cloud.
``finetune`` (e.g. ``experiment=DebugFineTune``) fits from the weights of
``model.ckpt_path`` with a fresh optimizer, unfreezing the net's subtrees
by epoch through the ``finetune`` callback. ``predict`` (``launch_predict``,
``run.py:92``) composes with ``experiment=predict`` when ``--config-path``
is absent or ``configs`` and no experiment is given; relative paths of
``predict`` resolve in the run directory (a frozen config with no
``hydra`` node keeps the cwd); ``predict.src_las`` may be a glob, the next
tile is read in the background while the current one streams through the
device, and ``predict.resume`` skips inputs whose output already exists.
``create_hdf5`` builds the HDF5 sample cache of
``datamodule.hdf5_file_path`` from the LAS corpus (``launch_hdf5``,
``run.py:157``). Every task runs on the first CUDA device, and raises when
there is none; ``trainer.accelerator=cpu`` runs it on the CPU.

``fit``, ``test`` and ``finetune`` run data parallel over
``trainer.devices`` > 1 (``auto``: every local GPU): this process starts
one rank per device (``parallel.ddp.spawn``), each in this process's run
directory, and waits for them. Under torchrun (``RANK`` and
``WORLD_SIZE`` set) each process joins torchrun's group instead;
``trainer.num_nodes`` > 1 needs torchrun. Predict splits its batches over
the local GPUs in one process.
"""

from __future__ import annotations

import glob
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(REPO_ROOT, "configs")
TASK_PREFIX = "task.task_name="
DEFAULT_DIRECTORY = "configs"   # --config-path spelled as run.py's default
TASKS = ("fit", "fit+test", "test", "finetune", "predict", "create_hdf5")


def task_of(overrides: List[str], task: str = "fit") -> str:
    """The task the overrides name (the last ``task.task_name=`` wins)."""
    for arg in overrides:
        if arg.startswith(TASK_PREFIX):
            task = arg[len(TASK_PREFIX):]
    return task


def _parse(argv: List[str]):
    """argv -> (config_dir as given or None, config_name, overrides, task),
    as ``run.py:_parse_cli``: ``--config-path DIR``, ``--config-path=DIR``,
    ``-cp DIR`` and the same for the name; a bare argument is ignored."""
    config_dir, config_name, overrides = None, "config.yaml", []
    it = iter(argv)
    for arg in it:
        if arg in ("--config-path", "-cp"):
            config_dir = next(it)
        elif arg in ("--config-name", "-cn"):
            config_name = next(it)
        elif arg.startswith("--config-path="):
            config_dir = arg.split("=", 1)[1]
        elif arg.startswith("--config-name="):
            config_name = arg.split("=", 1)[1]
        elif "=" in arg:
            overrides.append(arg)
        else:
            print(f"Ignoring unrecognized argument: {arg}")
    if not config_name.endswith((".yaml", ".yml")):
        config_name += ".yaml"
    return config_dir, config_name, overrides, task_of(overrides)


def parse_cli(argv: List[str]):
    """argv -> (config_dir, config_name, overrides, task_name); no
    ``--config-path`` gives the repository's ``configs/``."""
    config_dir, config_name, overrides, task = _parse(argv)
    return config_dir or CONFIG_DIR, config_name, overrides, task


def load_dotenv() -> None:
    """Add the ``KEY=value`` lines of a ``.env`` in the cwd to the
    environment where unset (``run.py:217-223``): blank, ``#`` and
    ``=``-less lines are skipped, the value loses its surrounding spaces
    and ``"``."""
    if not os.path.isfile(".env"):
        return
    with open(".env") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#") and "=" in line:
                key, _, value = line.partition("=")
                os.environ.setdefault(key.strip(), value.strip().strip('"'))


def compose_config(config_dir: str, config_name: str, overrides: List[str],
                   default_tree: Optional[bool] = None):
    """Compose the config: the ``configs/`` tree, or a frozen full config
    plus overrides. The predict task composes the tree with
    ``experiment=predict`` when ``default_tree`` (the default: ``config_dir``
    is ``CONFIG_DIR``) and no ``experiment=`` override is given."""
    import yaml

    from myria3d_tpu_torch.utils.config import compose, load_config, resolve_interpolations, update

    path = os.path.join(config_dir, config_name)
    with open(path) as f:
        layered = "defaults:" in f.read()
    if layered:
        if default_tree is None:
            default_tree = config_dir == CONFIG_DIR
        if default_tree and task_of(overrides) == "predict" and not any(
                o.startswith("experiment=") for o in overrides):
            overrides = ["experiment=predict"] + overrides
        return compose(config_dir, config_name, overrides)
    cfg = load_config(path)
    for ov in overrides:
        key, _, raw = ov.partition("=")
        update(cfg, key, yaml.safe_load(raw))
    return resolve_interpolations(cfg)


def launch_predict(config) -> List[str]:
    """Predict every LAS file of ``predict.src_las`` (a path or a glob)."""
    from myria3d_tpu_torch.pctl.dataset.utils import read_las_array
    from myria3d_tpu_torch.predict import predict

    src = config["predict"]["src_las"]
    files = sorted(glob.glob(src)) if any(c in src for c in "*?[") else [src]
    if not files:
        raise FileNotFoundError(f"No LAS file matches predict.src_las={src}")
    out_dir = config["predict"]["output_dir"]
    resume = bool(config["predict"].get("resume", False))
    todo = [f for f in files
            if not (resume and os.path.exists(os.path.join(out_dir, os.path.basename(f))))]
    outs = [os.path.join(out_dir, os.path.basename(f)) for f in files if f not in todo]
    epsg = config["datamodule"].get("epsg")

    def cfg_for(las):
        return {**config, "predict": {**config["predict"], "src_las": las}}

    if int(config["predict"].get("prefetch_tiles", 1) or 0) <= 0:
        return outs + [predict(cfg_for(las)) for las in todo]
    # one reader thread in FIFO order: tile i+1 is read while tile i streams
    with ThreadPoolExecutor(max_workers=1) as reader:
        futures = [reader.submit(read_las_array, las, epsg) for las in todo[:2]]
        for j, las in enumerate(todo):
            outs.append(predict(cfg_for(las), preread=futures[j]))
            if j + 2 < len(todo):
                futures.append(reader.submit(read_las_array, todo[j + 2], epsg))
    return outs


def enter_run_dir(config) -> None:
    """Hydra's job directory, as ``run.py:182-205``: freeze the invoking
    cwd for ``${hydra:runtime.cwd}`` and chdir to ``hydra.run.dir`` (unless
    the config has no ``hydra`` node or sets ``hydra.job.chdir=false``)."""
    from myria3d_tpu_torch.utils.config import set_runtime_info

    set_runtime_info(runtime_cwd=os.getcwd())
    hydra_cfg = config.get("hydra") or {}
    if str((hydra_cfg.get("job") or {}).get("chdir", True)).lower() in ("false", "0"):
        return
    run_dir = (hydra_cfg.get("run") or {}).get("dir")
    if run_dir:
        os.makedirs(run_dir, exist_ok=True)
        set_runtime_info(run_dir=os.path.abspath(run_dir))
        os.chdir(run_dir)


def launch_hdf5(config) -> None:
    """Build the HDF5 sample cache from the LAS corpus of the datamodule
    section (``launch_hdf5``, ``run.py:157-180``)."""
    from myria3d_tpu_torch.pctl.dataset.hdf5 import create_hdf5
    from myria3d_tpu_torch.pctl.dataset.utils import get_las_paths_by_split_dict
    from myria3d_tpu_torch.train import port_targets
    from myria3d_tpu_torch.utils.config import instantiate

    dm = config["datamodule"]
    create_hdf5(
        las_paths_by_split_dict=get_las_paths_by_split_dict(dm["data_dir"], dm["split_csv_path"]),
        hdf5_file_path=dm["hdf5_file_path"], epsg=dm.get("epsg"),
        tile_width=dm.get("tile_width", 1000), subtile_width=dm.get("subtile_width", 50),
        subtile_overlap_train=dm.get("subtile_overlap_train", 0),
        points_pre_transform=instantiate(port_targets(dm.get("points_pre_transform"))),
        pre_filter=instantiate(port_targets(dm.get("pre_filter"))),
    )


def launch_train(config):
    """fit, test and finetune (``run.py:launch_train``): ``extras`` in every
    rank, the config tree printed and saved to ``config_tree.txt`` on rank
    zero, then ``train``."""
    from myria3d_tpu_torch.parallel import ddp
    from myria3d_tpu_torch.train import train
    from myria3d_tpu_torch.utils import utils

    utils.extras(config)
    if config.get("print_config", True) and ddp.is_rank_zero():
        utils.print_config(config)
    return train(config)


def main(argv: List[str]):
    if "--help" in argv or "-h" in argv:
        print(__doc__)
        return None
    load_dotenv()
    config_dir, config_name, overrides, task = _parse(argv)
    if task not in TASKS:
        raise ValueError(
            f"task.task_name={task}: fit, fit+test, test, finetune, predict or create_hdf5")
    # run.py adds experiment=predict when --config-path is absent or "configs"
    config = compose_config(config_dir or CONFIG_DIR, config_name, overrides,
                            default_tree=config_dir in (None, DEFAULT_DIRECTORY))
    if task not in ("predict", "create_hdf5") and start_ranks(config, argv):
        return None   # the ranks ran the task
    enter_run_dir(config)
    if task == "predict":
        from myria3d_tpu_torch.utils import utils

        utils.extras(config)
        return launch_predict(config)
    if task == "create_hdf5":
        return launch_hdf5(config)
    return launch_train(config)


def start_ranks(config, argv: List[str]) -> bool:
    """Data parallel: join torchrun's process group, or start one rank per
    device of ``trainer.devices`` that runs ``main(argv)`` in it; True when
    the ranks ran the task here."""
    from myria3d_tpu_torch.parallel import ddp

    trainer = config.get("trainer") or {}
    accelerator = trainer.get("accelerator", "auto")
    if ddp.is_initialized():
        return False
    if ddp.launched_by_torchrun():
        ddp.init_from_env(accelerator)
        return False
    devices = ddp.rank_devices(trainer.get("devices", "auto"), accelerator)
    if len(devices) <= 1:
        return False
    if int(trainer.get("num_nodes", 1) or 1) > 1:
        raise NotImplementedError("trainer.num_nodes > 1: start each node's ranks with torchrun")
    # every rank enters the parent's run directory (``${now:...}`` resolved once)
    run_dir = ((config.get("hydra") or {}).get("run") or {}).get("dir")
    if run_dir:
        argv = [*argv, f"hydra.run.dir={os.path.abspath(run_dir)}"]
    ddp.spawn(main, devices, args=(argv,))
    return True


if __name__ == "__main__":
    main(sys.argv[1:])
