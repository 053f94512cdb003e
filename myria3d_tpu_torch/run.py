"""CLI of the port — ``python -m myria3d_tpu_torch.run
task.task_name={fit,fit+test,test,finetune,predict,create_hdf5} [--config-path DIR]
[--config-name NAME] [a.b=value ...]``.

Mirrors ``run.py``. ``fit`` (the default task) composes the config tree
under ``configs/`` (default experiment ``RandLaNetDebug``), enters the
per-run directory ``hydra.run.dir`` like hydra, and runs
``myria3d_tpu_torch.train.train``: fit, then the full-cloud test on the
best checkpoint (``task.auto_lr_find=true`` runs the LR range test first
and fits from its suggestion). ``test`` evaluates the checkpoint
``model.ckpt_path`` on the test split, full-cloud. ``finetune`` (e.g.
``experiment=DebugFineTune``) fits from the weights of ``model.ckpt_path``
with a fresh optimizer, unfreezing the net's subtrees by epoch through the
``finetune`` callback. ``predict`` (``launch_predict``, ``run.py:92``)
composes with ``experiment=predict`` (unless a frozen config is given),
``predict.src_las`` may be a glob, the next tile is read in the background
while the current one streams through the device, and ``predict.resume``
skips inputs whose output already exists. ``create_hdf5`` builds the HDF5
sample cache of ``datamodule.hdf5_file_path`` from the LAS corpus
(``launch_hdf5``, ``run.py:157``). Every task runs on the first CUDA
device, and raises when there is none; ``trainer.accelerator=cpu`` runs it
on the CPU.

``fit``, ``test`` and ``finetune`` run data parallel over
``trainer.devices`` > 1 (``auto``: every local GPU): this process starts
one rank per device (``parallel.ddp.spawn``) and waits for them. Under
torchrun (``RANK`` and ``WORLD_SIZE`` set) each process joins torchrun's
group instead; ``trainer.num_nodes`` > 1 needs torchrun. Predict splits
its batches over the local GPUs in one process.
"""

from __future__ import annotations

import glob
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(REPO_ROOT, "configs")
TASK_PREFIX = "task.task_name="


def parse_cli(argv: List[str]):
    """argv -> (config_dir, config_name, overrides, task_name)."""
    config_dir, config_name, overrides, task = CONFIG_DIR, "config.yaml", [], "fit"
    it = iter(argv)
    for arg in it:
        if arg in ("--config-path", "-cp"):
            config_dir = next(it)
        elif arg in ("--config-name", "-cn"):
            config_name = next(it)
        elif "=" in arg:
            overrides.append(arg)
            if arg.startswith(TASK_PREFIX):
                task = arg[len(TASK_PREFIX):]
        else:
            raise SystemExit(f"unrecognized argument: {arg}")
    if not config_name.endswith((".yaml", ".yml")):
        config_name += ".yaml"
    return config_dir, config_name, overrides, task


def compose_config(config_dir: str, config_name: str, overrides: List[str]):
    """Compose the config: the ``configs/`` tree (with ``experiment=predict``
    for the predict task), or a frozen full config plus overrides."""
    import yaml

    from myria3d_tpu_torch.utils.config import compose, load_config, resolve_interpolations, update

    path = os.path.join(config_dir, config_name)
    with open(path) as f:
        layered = "defaults:" in f.read()
    if layered:
        predict = TASK_PREFIX + "predict" in overrides
        if predict and config_dir == CONFIG_DIR and not any(
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


def main(argv: List[str]):
    if "--help" in argv or "-h" in argv:
        print(__doc__)
        return None
    config_dir, config_name, overrides, task = parse_cli(argv)
    if task == "predict":
        return launch_predict(compose_config(config_dir, config_name, overrides))
    if task not in ("fit", "fit+test", "test", "finetune", "create_hdf5"):
        raise ValueError(
            f"task.task_name={task}: fit, fit+test, test, finetune, predict or create_hdf5")
    config = compose_config(config_dir, config_name, overrides)
    if task != "create_hdf5" and start_ranks(config, argv):
        return None   # the ranks ran the task
    enter_run_dir(config)
    if task == "create_hdf5":
        return launch_hdf5(config)
    from myria3d_tpu_torch.train import train

    return train(config)


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
    ddp.spawn(main, devices, args=(argv,))
    return True


if __name__ == "__main__":
    main(sys.argv[1:])
