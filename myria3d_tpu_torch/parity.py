"""proto151 checkpoint-parity harness on the port — one command from a
Lightning checkpoint to a verdict.

Port of ``myria3d_tpu/parity.py`` (the north-star harness, ``:1-26``;
BASELINE.md: full-cloud mIoU parity within 0.2 of the shipped ``proto151``
checkpoint; reference usage ``myria3d/predict.py:21-73``):

    python -m myria3d_tpu_torch.parity <torch.ckpt> <src.las> \
        [--ref-out <reference_predicted.las>] [--output-dir DIR] \
        [--config <frozen predict yaml>] [--tolerance 0.2] [--epsg 2154] \
        [--batch-size N] [--accelerator cpu]

Pipeline: convert the Lightning checkpoint (``utils.checkpoint.
convert_checkpoint_file``: the port reads the reference's state dict under
its own names) -> predict on ``src.las`` with ``predict.exact_interpolation``
(the f32 two-op interpolation instead of K3) and ``predict.exact_knn``
(every search a full scan) -> score:

- ours vs ground truth (the source LAS ``Classification``, remapped through
  the dataset's ``classification_preprocessing_dict``): per-class IoU + mIoU;
- reference output vs ground truth (when ``--ref-out`` gives the LAS the
  reference produced on the same tile): the same;
- ours vs reference output: class-map agreement and per-class IoU;
- verdict: PASS iff |mIoU_ours - mIoU_ref| <= tolerance (only when both are
  computable; otherwise the run is informational and still exits 0).

Prints a per-class table plus ONE machine-readable JSON line; exit code 1
on a FAIL verdict. Predict runs on CUDA; ``--accelerator cpu``
(``trainer.accelerator=cpu``) runs it on the CPU with the kernels' plain
versions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np

from myria3d_tpu_torch.utils import utils

log = utils.get_logger(__name__)

DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "trained_model_assets",
    "randlanet_tpu_predict_config_V0.1.0.yaml",
)

# reference class names -> this repo's zoo names (reference selects by
# substring over MODEL_ZOO, ``models/model.py:15-29``)
_ZOO_ALIASES = {"PyGRandLANet": "RandLANet", "PointNet2": "PointNet2"}


def _load_frozen_config(config_path: str, overrides: Dict[str, object]):
    """Load a frozen full predict config (no defaults tree) + overrides."""
    from myria3d_tpu_torch.utils.config import (
        load_config,
        resolve_interpolations,
        update,
    )

    cfg = load_config(config_path)
    for key, value in overrides.items():
        update(cfg, key, value)
    return resolve_interpolations(cfg)


def _model_hparams_from_config(cfg) -> Dict[str, object]:
    """Plain Model kwargs from a composed config's model section (factories
    like optimizer/criterion are predict-irrelevant and dropped)."""
    from myria3d_tpu_torch.utils.config import _to_plain

    raw = _to_plain(dict(cfg["model"]))
    drop = {"_target_", "optimizer", "lr_scheduler", "criterion", "iou",
            "momentum", "num_workers", "ckpt_path"}
    hparams = {k: v for k, v in raw.items() if k not in drop}
    name = hparams.get("neural_net_class_name", "RandLANet")
    hparams["neural_net_class_name"] = _ZOO_ALIASES.get(name, name)
    hparams.setdefault(
        "classification_dict",
        _to_plain(dict(cfg["dataset_description"]["classification_dict"])),
    )
    return hparams


def _iou_table(
    pred: np.ndarray, target: np.ndarray, codes: Sequence[int]
) -> Dict[str, object]:
    """Per-class IoU + mIoU over the points whose target is in ``codes``
    (matches the reference's JaccardIndex over the remapped class space;
    absent classes score 1.0 like ``absent_score=1.0``,
    reference ``configs/model/default.yaml``)."""
    codes = np.asarray(list(codes))
    valid = np.isin(target, codes)
    per_class = {}
    ious = []
    for c in codes:
        p = pred[valid] == c
        t = target[valid] == c
        inter = float(np.sum(p & t))
        union = float(np.sum(p | t))
        iou = 1.0 if union == 0 else inter / union
        per_class[int(c)] = iou
        ious.append(iou)
    return {
        "per_class_iou": per_class,
        "miou": float(np.mean(ious)) if ious else float("nan"),
        "n_scored": int(valid.sum()),
        "accuracy": (
            float((pred[valid] == target[valid]).mean()) if valid.any() else
            float("nan")
        ),
    }


def run_parity(
    torch_ckpt: str,
    src_las: str,
    ref_out: Optional[str] = None,
    output_dir: Optional[str] = None,
    config_path: Optional[str] = None,
    epsg: Optional[str] = None,
    tolerance: float = 0.2,
    batch_size: Optional[int] = None,
    accelerator: Optional[str] = None,
    extra_overrides: Optional[Dict[str, object]] = None,
) -> Dict[str, object]:
    """Convert → predict (exact interpolation) → score. Returns the report."""
    from myria3d_tpu_torch.pctl.io.las import read_las
    from myria3d_tpu_torch.predict import predict
    from myria3d_tpu_torch.utils.checkpoint import convert_checkpoint_file

    config_path = config_path or DEFAULT_CONFIG
    output_dir = output_dir or tempfile.mkdtemp(prefix="myria3d_parity_")
    os.makedirs(output_dir, exist_ok=True)
    ckpt_dir = os.path.join(output_dir, "converted_ckpt")

    overrides: Dict[str, object] = {
        "task.task_name": "predict",
        "predict.src_las": os.path.abspath(src_las),
        "predict.ckpt_path": ckpt_dir,
        "predict.output_dir": os.path.join(output_dir, "predicted"),
        "predict.exact_interpolation": True,
        # every search a full scan (K1 is exact within a window too): the
        # reference's exact torch_cluster kNN (pyg_randla_net.py:14,180)
        "predict.exact_knn": True,
    }
    if epsg is not None:
        overrides["datamodule.epsg"] = epsg
    if batch_size is not None:
        overrides["datamodule.batch_size"] = int(batch_size)
    if accelerator is not None:
        overrides["trainer.accelerator"] = accelerator
    if extra_overrides:
        overrides.update(extra_overrides)
    cfg = _load_frozen_config(config_path, overrides)

    log.info(f"[1/3] Converting {torch_ckpt} -> {ckpt_dir}")
    convert_checkpoint_file(
        torch_ckpt, ckpt_dir, _model_hparams_from_config(cfg)
    )

    log.info(f"[2/3] Predicting on {src_las} (exact interpolation)")
    out_path = predict(cfg)
    assert out_path is not None and os.path.isfile(out_path)

    log.info("[3/3] Scoring")
    from myria3d_tpu_torch.utils.config import _to_plain

    prep = {
        int(k): int(v) for k, v in _to_plain(dict(
            cfg["dataset_description"].get(
                "classification_preprocessing_dict", {}
            )
        )).items()
    }
    codes = [
        int(c) for c in _to_plain(
            dict(cfg["dataset_description"]["classification_dict"])
        ).keys()
    ]

    out_pts = read_las(out_path).points
    ours = np.asarray(out_pts["PredictedClassification"], np.int64)
    gt_raw = np.asarray(out_pts["Classification"], np.int64)
    gt = gt_raw.copy()
    for src_code, dst_code in prep.items():
        gt[gt_raw == src_code] = dst_code

    report: Dict[str, object] = {
        "metric": "proto151_parity",
        "src_las": os.path.abspath(src_las),
        "torch_ckpt": os.path.abspath(torch_ckpt),
        "predicted_las": out_path,
        "n_points": int(len(ours)),
        "tolerance": tolerance,
        "ours_vs_gt": _iou_table(ours, gt, codes),
    }

    if ref_out is not None:
        ref_pts = read_las(ref_out).points
        if "PredictedClassification" not in (ref_pts.dtype.names or ()):
            raise ValueError(
                f"{ref_out} has no PredictedClassification dimension — is it "
                "a reference predict output?"
            )
        ref = np.asarray(ref_pts["PredictedClassification"], np.int64)
        if len(ref) != len(ours):
            raise ValueError(
                f"Point-count mismatch: ours {len(ours)} vs reference "
                f"{len(ref)} — not the same tile?"
            )
        report["ref_vs_gt"] = _iou_table(ref, gt, codes)
        report["ours_vs_ref"] = {
            "agreement": float((ours == ref).mean()),
            **_iou_table(ours, ref, codes),
        }
        diff = abs(
            report["ours_vs_gt"]["miou"] - report["ref_vs_gt"]["miou"]
        )
        report["miou_diff"] = float(diff)
        report["verdict"] = "PASS" if diff <= tolerance else "FAIL"
    else:
        report["verdict"] = "INFORMATIONAL"

    _print_report(report, codes, cfg)
    return report


def _print_report(report, codes, cfg) -> None:
    from myria3d_tpu_torch.utils.config import _to_plain

    names = _to_plain(dict(cfg["dataset_description"]["classification_dict"]))
    rows = [("class", "ours-vs-gt", "ref-vs-gt", "ours-vs-ref")]
    for c in codes:

        def cell(section):
            tab = report.get(section)
            return f"{tab['per_class_iou'][int(c)]:.4f}" if tab else "—"

        rows.append((
            f"{c}:{names[c] if c in names else names[str(c)]}",
            cell("ours_vs_gt"), cell("ref_vs_gt"), cell("ours_vs_ref"),
        ))

    def mcell(section):
        tab = report.get(section)
        return f"{tab['miou']:.4f}" if tab else "—"

    rows.append(("mIoU", mcell("ours_vs_gt"), mcell("ref_vs_gt"),
                 mcell("ours_vs_ref")))
    widths = [max(len(r[i]) for r in rows) for i in range(4)]
    for r in rows:
        print("  ".join(v.ljust(w) for v, w in zip(r, widths)))
    if "ours_vs_ref" in report:
        print(f"class-map agreement: {report['ours_vs_ref']['agreement']:.4%}")
    if "miou_diff" in report:
        print(
            f"mIoU diff: {report['miou_diff']:.4f} "
            f"(tolerance {report['tolerance']}) -> {report['verdict']}"
        )
    print(json.dumps(report))


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m myria3d_tpu_torch.parity", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("torch_ckpt", help="reference Lightning .ckpt (proto151)")
    p.add_argument("src_las", help="LAS/LAZ tile to predict on")
    p.add_argument("--ref-out", default=None,
                   help="LAS the REFERENCE produced on the same tile "
                        "(enables the PASS/FAIL mIoU-parity verdict)")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--config", default=None,
                   help="frozen predict config YAML "
                        f"(default: {DEFAULT_CONFIG})")
    p.add_argument("--epsg", default=None)
    p.add_argument("--tolerance", type=float, default=0.2)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--accelerator", default=None, choices=("auto", "cpu"),
                   help="cpu: predict on the CPU (default: the CUDA device)")
    args = p.parse_args(argv)
    report = run_parity(
        args.torch_ckpt, args.src_las, ref_out=args.ref_out,
        output_dir=args.output_dir, config_path=args.config,
        epsg=args.epsg, tolerance=args.tolerance, batch_size=args.batch_size,
        accelerator=args.accelerator,
    )
    return 1 if report.get("verdict") == "FAIL" else 0


if __name__ == "__main__":
    sys.exit(main())
