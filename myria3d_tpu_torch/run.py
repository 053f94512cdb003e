"""CLI of the port — ``python -m myria3d_tpu_torch.run task.task_name=predict
[--config-path DIR] [--config-name NAME] [a.b=value ...]``.

Mirrors ``run.py:92`` (``launch_predict``): the config tree under
``configs/`` is composed with ``experiment=predict`` (unless a frozen
config is given), ``predict.src_las`` may be a glob, the next tile is read
in the background while the current one streams through the device, and
``predict.resume`` skips inputs whose output already exists. Set
``predict.gpus=1`` to run on the first CUDA device. The other tasks
(fit, test, finetune, create_hdf5) are not ported yet.
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
    """Compose the predict config: the ``configs/`` tree with
    ``experiment=predict``, or a frozen full config plus overrides."""
    import yaml

    from myria3d_tpu.utils.config import compose, load_config, resolve_interpolations, update

    path = os.path.join(config_dir, config_name)
    with open(path) as f:
        layered = "defaults:" in f.read()
    if layered:
        if config_dir == CONFIG_DIR and not any(o.startswith("experiment=") for o in overrides):
            overrides = ["experiment=predict"] + overrides
        return compose(config_dir, config_name, overrides)
    cfg = load_config(path)
    for ov in overrides:
        key, _, raw = ov.partition("=")
        update(cfg, key, yaml.safe_load(raw))
    return resolve_interpolations(cfg)


def launch_predict(config) -> List[str]:
    """Predict every LAS file of ``predict.src_las`` (a path or a glob)."""
    from myria3d_tpu.pctl.dataset.utils import read_las_array
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


def main(argv: List[str]):
    if "--help" in argv or "-h" in argv:
        print(__doc__)
        return None
    config_dir, config_name, overrides, task = parse_cli(argv)
    if task != "predict":
        raise NotImplementedError(
            f"task.task_name={task} is not ported yet (predict only)"
        )
    return launch_predict(compose_config(config_dir, config_name, overrides))


if __name__ == "__main__":
    main(sys.argv[1:])
