"""Plain RandLA-Net (Hu et al., CVPR 2020, arXiv:1911.11236) as IGNF/myria3d
configures it: the reference the benchmark holds the program to.

A function of a flat parameter dict keyed by the published pyg names
(``block1.lfa1.mlp_encoder.lins.0.weight``, ...; :func:`param_shapes`).
Encoder blocks 32/128/256/512 with K nearest neighbours and random
decimation between stages, each block a shortcut, ``mlp1``, two local
feature aggregations (LocSE ``[p_i, p_j, p_j - p_i, |p_j - p_i|]`` through
Linear-BN-LeakyReLU, attention pooling by a masked softmax over the K
slots, Linear-BN-LeakyReLU after it) and ``mlp2``; nearest-neighbour
upsampling with skip concatenation in the decoder; a dropout head.

Every Linear is a float32 product; BatchNorm at eval is the affine of its
running statistics, in training the masked moments of the valid rows (of
the valid neighbour slots for the LocSE encoder) with the biased variance.
LeakyReLU slope 0.2, BatchNorm eps 1e-6. The searches run in x-sorted
windows of ``knn_window`` positions when it is set
(:mod:`perfbench.reference.search`), as the configuration states; in
training the clouds are x-sorted inside the forward first and the logits
returned in input order. Random draws come from the caller's generator in
the order the forward makes them: one decimation per block, then the
head's dropout. Imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import search

SLOPE = 0.2
EPS = 1e-6
WIDTHS = (32, 128, 256, 512)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32's 10-bit mantissa (to nearest, ties to even):
    what a TF32 product reads, for the control where the device has no
    TF32 (the CPU). Gradients pass through as TF32 products pass them."""
    b = t.detach().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & -0x2000
    return t + (b.view(torch.float32) - t).detach()


def bottleneck(cfg: dict) -> int:
    return max(32, cfg["num_classes"], cfg["num_features"])


def _mlp_shapes(prefix: str, chans, bias: bool = True, norm: bool = True) -> dict:
    out = {}
    for i, (a, b) in enumerate(zip(chans[:-1], chans[1:])):
        out[f"{prefix}.lins.{i}.weight"] = (b, a)
        if bias:
            out[f"{prefix}.lins.{i}.bias"] = (b,)
    if norm:
        for i, b in enumerate(chans[1:]):
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                out[f"{prefix}.norms.{i}.{leaf}"] = (b,)
    return out


def param_shapes(cfg: dict) -> dict:
    """Every parameter and BatchNorm statistic of the net: ``{name: shape}``."""
    d_b = bottleneck(cfg)
    shapes = {"fc0.weight": (d_b, cfg["num_features"]), "fc0.bias": (d_b,)}
    ins = (d_b,) + WIDTHS
    for i in range(4):
        d_in, d_out, p = ins[i], ins[i + 1], f"block{i + 1}"
        shapes.update(_mlp_shapes(f"{p}.mlp1", [d_in, d_out // 8]))
        shapes.update(_mlp_shapes(f"{p}.shortcut", [d_in, d_out]))
        shapes.update(_mlp_shapes(f"{p}.mlp2", [d_out // 2, d_out]))
        for j, c in ((1, d_out // 4), (2, d_out // 2)):
            shapes.update(_mlp_shapes(f"{p}.lfa{j}.mlp_encoder", [10, c // 2]))
            shapes.update(_mlp_shapes(f"{p}.lfa{j}.mlp_attention", [c, c], bias=False, norm=False))
            shapes.update(_mlp_shapes(f"{p}.lfa{j}.mlp_post_attention", [c, c]))
    shapes.update(_mlp_shapes("mlp_summit", [512, 512]))
    for name, chans in (("fp4", [768, 256]), ("fp3", [384, 128]), ("fp2", [160, 32]),
                        ("fp1", [64, d_b])):
        shapes.update(_mlp_shapes(f"{name}.nn", chans))
    shapes.update(_mlp_shapes("mlp_classif", [d_b, 64, 32]))
    shapes["fc_classif.weight"] = (cfg["num_classes"], 32)
    shapes["fc_classif.bias"] = (cfg["num_classes"],)
    return shapes


class Net:
    """The forward over parameters ``P``; ``train`` takes batch moments
    (updating ``P``'s running statistics as BatchNorm does, momentum
    ``bn_momentum``) and draws the head's dropout. ``tf32`` rounds every
    product's operands to TF32 (the control, on a device without TF32
    products)."""

    tf32 = False

    def __init__(self, P: dict, cfg: dict, train: bool = False):
        self.P, self.cfg, self.train = P, cfg, train

    def linear(self, name: str, x):
        weight = self.P[f"{name}.weight"]
        if self.tf32:
            x, weight = round_tf32(x), round_tf32(weight)
        return F.linear(x, weight, self.P[f"{name}.bias"])

    def bn(self, name: str, x, valid):
        P = self.P
        if not self.train:
            mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
        else:
            dims = tuple(range(x.dim() - 1))
            m = valid[..., None].to(x.dtype)
            cnt = m.sum(dim=dims).clamp(min=1.0)
            mean = (x * m).sum(dim=dims) / cnt
            var = (((x - mean) ** 2) * m).sum(dim=dims) / cnt
            n = valid.sum().to(x.dtype).clamp(min=1.0)
            mom = self.cfg.get("bn_momentum", 0.01)
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp(min=1.0)
                P[f"{name}.running_mean"].mul_(1 - mom).add_(mom * mean.detach())
                P[f"{name}.running_var"].mul_(1 - mom).add_(mom * unbiased.detach())
        return (x - mean) * torch.rsqrt(var + EPS) * P[f"{name}.weight"] + P[f"{name}.bias"]

    def mlp(self, prefix: str, x, valid, n_layers: int = 1, act: bool = True, norm: bool = True,
            dropout=None, generator=None):
        P = self.P
        for i in range(n_layers):
            weight = P[f"{prefix}.lins.{i}.weight"]
            if self.tf32:
                x, weight = round_tf32(x), round_tf32(weight)
            x = F.linear(x, weight, P.get(f"{prefix}.lins.{i}.bias"))
            if norm:
                x = self.bn(f"{prefix}.norms.{i}", x, valid)
            if act:
                x = F.leaky_relu(x, SLOPE)
            rate = dropout[i] if dropout else 0.0
            if self.train and rate > 0.0:
                draw = torch.rand(x.shape, generator=generator, device=x.device)
                x = torch.where(draw < 1.0 - rate, x / (1.0 - rate), 0.0)
        return x

    def lfa(self, prefix: str, x, pos, idx, valid, mask):
        pos_j = search.gather_rows(pos, idx)
        pos_i = pos[:, :, None, :].expand_as(pos_j)
        diff = pos_j - pos_i
        dist = (diff * diff).sum(dim=-1, keepdim=True).clamp(min=0.0).sqrt()
        rel = torch.cat([pos_i, pos_j, diff, dist], dim=-1)
        x_j = torch.where(valid[..., None], search.gather_rows(x, idx), 0.0)
        lf = torch.cat([x_j, self.mlp(f"{prefix}.mlp_encoder", rel, valid)], dim=-1)
        att = self.mlp(f"{prefix}.mlp_attention", lf, None, act=False, norm=False)
        att = torch.where(valid[..., None], att, torch.finfo(att.dtype).min)
        e = torch.where(valid[..., None], torch.exp(att - att.amax(dim=2, keepdim=True)), 0.0)
        scores = e / e.sum(dim=2, keepdim=True).clamp(min=1e-16)
        return self.mlp(f"{prefix}.mlp_post_attention", (scores * lf).sum(dim=2), mask)

    def block(self, p: str, x, pos, mask, window: int):
        idx, _, valid = search.knn(pos, pos, mask, self.cfg["num_neighbors"], query_mask=mask,
                                   window=search.stage_window(window, pos.shape[1]))
        shortcut = self.mlp(f"{p}.shortcut", x, mask, act=False)
        x = self.mlp(f"{p}.mlp1", x, mask)
        x = self.lfa(f"{p}.lfa1", x, pos, idx, valid, mask)
        x = self.lfa(f"{p}.lfa2", x, pos, idx, valid, mask)
        return F.leaky_relu(self.mlp(f"{p}.mlp2", x, mask, act=False) + shortcut, SLOPE)

    def __call__(self, x, pos, mask, generator, sort: bool = False):
        """Logits (B, N, num_classes) of the clouds ``x (B, N, F)``,
        ``pos (B, N, 3)``, ``mask (B, N)``; ``sort`` x-sorts them first."""
        cfg = self.cfg
        window = cfg.get("knn_window", 0)
        order = None
        if sort:
            order = torch.where(mask, pos[..., 0], float("inf")).sort(dim=1, stable=True).indices
            x, pos = search.gather_rows(x, order), search.gather_rows(pos, order)
            mask = mask.gather(1, order)
        x = self.linear("fc0", x)
        skips = []
        for i in range(4):
            x = self.block(f"block{i + 1}", x, pos, mask, window)
            if i == 0:
                skips.append((x, pos, mask))
            keep, mask = search.random_decimation(mask, cfg["decimation"], generator)
            x, pos = search.gather_rows(x, keep), search.gather_rows(pos, keep)
            if i < 3:
                skips.append((x, pos, mask))
        x = self.mlp("mlp_summit", x, mask)
        for fp in ("fp4", "fp3", "fp2", "fp1"):
            x_skip, pos_skip, mask_skip = skips.pop()
            up = search.interpolate(x, pos, mask, pos_skip, mask_skip, 1,
                                    search.stage_window(window, pos.shape[1]))
            x = self.mlp(f"{fp}.nn", torch.cat([up, x_skip], dim=-1), mask_skip)
            pos, mask = pos_skip, mask_skip
        x = self.mlp("mlp_classif", x, mask, n_layers=2, dropout=[0.0, 0.5], generator=generator)
        logits = self.linear("fc_classif", x)
        if order is not None:
            logits = search.gather_rows(logits, order.argsort(dim=1))
        return logits
