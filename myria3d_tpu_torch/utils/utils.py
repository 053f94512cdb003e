"""Cross-cutting utilities — reference ``myria3d/utils/utils.py``.

``get_logger`` (process-zero-gated), ``extras`` (warning suppression),
``print_config`` (config tree dump), ``log_hyperparameters`` (+ param
counts), and the ``eval_time`` decorator.

Copied from ``myria3d_tpu/utils/utils.py``; imports point at the port,
``get_logger``'s gate reads the rank of the ``torch.distributed`` process
group when a record is emitted (the group starts after the module-level
loggers are made), and ``define_device_from_config_param`` answers from
``torch``.
"""

from __future__ import annotations

import functools
import logging
import time
import warnings
from typing import Any, Callable, Optional


def get_logger(name: str = __name__) -> logging.Logger:
    """Python logger whose records below ERROR only pass on rank 0
    (reference rank-zero-wrapped logger, ``utils/utils.py:14-32``)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("[%(asctime)s][%(name)s][%(levelname)s] - %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
        logger.addFilter(_rank_zero_or_error)
    return logger


def _rank_zero_or_error(record: logging.LogRecord) -> bool:
    from myria3d_tpu_torch.parallel import ddp

    return record.levelno >= logging.ERROR or ddp.is_rank_zero()


def extras(config: dict) -> None:
    """Apply config-controlled niceties (reference ``utils.py:35-58``)."""
    if config.get("ignore_warnings"):
        warnings.filterwarnings("ignore")


def print_config(config: dict, save_path: Optional[str] = "config_tree.txt") -> None:
    """Print the composed config as a tree; also dump it to a file
    (reference Rich tree printer, ``utils.py:61-102``)."""
    from myria3d_tpu_torch.utils.config import to_yaml

    text = to_yaml(config)
    print(text)
    if save_path:
        try:
            with open(save_path, "w") as f:
                f.write(text)
        except OSError:
            pass


def log_hyperparameters(logger: Any, config: dict, model: Any, state: Any) -> None:
    """Send config + parameter counts to the logger
    (reference ``utils.py:109-150``)."""
    if logger is None:
        return
    from myria3d_tpu_torch.utils.config import _to_plain  # noqa: SLF001

    hparams = dict(_to_plain(config))
    try:
        hparams["model/params_total"] = model.num_params(state)
    except Exception:
        pass
    logger.log_hyperparams(hparams)


def define_device_from_config_param(gpus_param: Any) -> str:
    """Reference ``utils.py:168-178`` parity shim: the knob is accepted for
    config compatibility and the platform the port runs on is returned
    ("cuda" when a CUDA device is visible, else "cpu")."""
    import torch

    del gpus_param  # accepted for config compatibility only
    return "cuda" if torch.cuda.is_available() else "cpu"


def eval_time(method: Callable) -> Callable:
    """Wall-clock timing decorator (reference ``utils.py:153-165``)."""

    @functools.wraps(method)
    def timed(*args, **kwargs):
        log = get_logger(method.__module__)
        start = time.time()
        result = method(*args, **kwargs)
        log.info(f"Processing time of {method.__name__}: {time.time() - start:.2f}s")
        return result

    return timed
