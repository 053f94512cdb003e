"""Plain PointNet++ (Qi et al., NeurIPS 2017, arXiv:1706.02413), single-scale
grouping for segmentation, as the repository's
``configs/model/pointnet2_model.yaml`` sets it: the reference the benchmark
holds the program to, at eval.

A function of a flat parameter dict (:func:`param_shapes`). ``fc0`` lifts
the features to 32; four set abstractions each sample a quarter of the
points by farthest-point sampling, group the k nearest valid points inside
the stage's radius (in the normalized units of the net's positions), run a
shared PointNet on ``[x_j | (p_j - centre) / r]`` and max-pool over the
valid slots; four feature propagations interpolate the coarser features
onto the finer points by inverse squared distance over the 3 nearest,
concatenate the skip and run their MLP; a head of 128 and the classifier.
Every Linear is a float32 product, BatchNorm the affine of its running
statistics, LeakyReLU slope 0.2. Imports nothing of the program.
"""

from __future__ import annotations

import torch

from perfbench.reference import search
from perfbench.reference.randla_net import Net as _RandLA

FP_WIDTHS = (256, 256, 128, 128)
NEG = -1e30


def _mlp(prefix: str, chans) -> dict:
    out = {}
    for i, (a, b) in enumerate(zip(chans[:-1], chans[1:])):
        out[f"{prefix}.lins.{i}.weight"] = (b, a)
        out[f"{prefix}.lins.{i}.bias"] = (b,)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{prefix}.norms.{i}.{leaf}"] = (b,)
    return out


def param_shapes(cfg: dict) -> dict:
    """Every parameter and BatchNorm statistic: ``{name: shape}``."""
    widths = cfg["widths"]
    shapes = _mlp("fc0", [cfg["num_features"], 32])
    ins = [32, *widths]
    for i, w in enumerate(widths):
        shapes.update(_mlp(f"sa{i + 1}.pointnet", [ins[i] + 3, w // 2, w // 2, w]))
    width = ins[-1]
    for j in range(len(widths)):
        skip = ins[len(widths) - 1 - j]
        shapes.update(_mlp(f"fp{len(widths) - j}.nn.mlp", [width + skip, FP_WIDTHS[j]]))
        width = FP_WIDTHS[j]
    shapes.update(_mlp("head", [width, 128]))
    shapes["fc_classif.weight"] = (cfg["num_classes"], 128)
    shapes["fc_classif.bias"] = (cfg["num_classes"],)
    return shapes


class Net(_RandLA):
    """The eval forward over parameters ``P``; ``slots`` counts, per set
    abstraction, the valid (centroid, neighbour) slots of the last call."""

    def __call__(self, x, pos, mask, generator=None, sort: bool = False):
        cfg = self.cfg
        n_stages = len(cfg["radii"])
        self.slots = []
        x = self.mlp("fc0", x, mask)
        skips = [(x, pos, mask)]
        for i, radius in enumerate(cfg["radii"]):
            m = max(1, pos.shape[1] // cfg["decimation"])
            sel, sel_mask = search.farthest_point_sampling(pos, mask, m)
            centre = search.gather_rows(pos, sel)
            idx, valid = search.ball(centre, pos, mask, cfg["num_neighbors"], radius,
                                     query_mask=sel_mask)
            self.slots.append(int(valid.sum()))
            pos_j = torch.where(valid[..., None], search.gather_rows(pos, idx), 0.0)
            x_j = torch.where(valid[..., None], search.gather_rows(x, idx), 0.0)
            rel = (pos_j - centre[:, :, None, :]) / radius
            h = self.mlp(f"sa{i + 1}.pointnet", torch.cat([x_j, rel], dim=-1), valid, n_layers=3)
            pooled = torch.where(valid[..., None], h, NEG).amax(dim=2)
            x, pos, mask = torch.where(sel_mask[..., None], pooled, 0.0), centre, sel_mask
            skips.append((x, pos, mask))
        for j in range(n_stages):
            x_skip, pos_skip, mask_skip = skips[len(skips) - 2 - j]
            up = search.interpolate(x, pos, mask, pos_skip, mask_skip, 3)
            x = self.mlp(f"fp{n_stages - j}.nn.mlp", torch.cat([up, x_skip], dim=-1), mask_skip)
            pos, mask = pos_skip, mask_skip
        x = self.mlp("head", x, mask)
        return self.linear("fc_classif", x)
