"""The one traffic generator: production Lidar HD statistics from a seed.

Two forms of one statistic (``bench_e2e.py:29-96``'s tile; reference
``docs/source/background/general_design.md``: ~30 k raw, ~12.5 k sampled
points a 50 m subtile). Surface sites lie uniformly over the ground; each
is returned ``returns_per_site`` times with ``jitter`` metres of noise, so
GridSampling(0.25) keeps about a third of the points; a site's class comes
from the class mix and sets its height range. Coordinates are Lambert-93
(EPSG 2154), stored at the LAS scale of 1 cm and read as float32, as the
pipeline reads them.

- :func:`write_tile`: a whole tile, written as LAS 1.4 point format 8 (the
  program's input file). Numpy on the host.
- :func:`subtile_batch`: a padded batch of 50 m subtiles as the predict
  and train steps take them, made on the device: the voxel means of 0.25 m
  GridSampling, the nine Lidar HD features, the positions that the net
  reads (lowest z at 0, centred, divided by half the subtile width) and the
  metre positions of the sampled and full clouds that the interpolation
  reads, both x-sorted.

Every size and draw comes from the traffic file's parameters and the seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from perfbench import las

TILE_X0, TILE_Y0 = 862000.0, 6652000.0
COLOR_MAX = 255.0 * 256.0
# the model's 7 classes (classification_dict of the Lidar HD dataset
# description) for the LAS codes of the class mix; 3 and 4 are vegetation
MODEL_CLASS = {1: 0, 2: 1, 3: 2, 4: 2, 5: 2, 6: 3, 9: 4, 17: 5, 64: 6}


def site_heights(cls, u):
    """Height of each site by class from uniform draws ``u`` in [0, 1)."""
    lo_hi = {3: (0.5, 15.0), 4: (0.5, 15.0), 5: (0.5, 15.0), 6: (3.0, 12.0), 9: (-0.2, 0.0),
             64: (0.0, 25.0)}
    z = 2.0 * u
    for c, (lo, hi) in lo_hi.items():
        z = np.where(cls == c, lo + (hi - lo) * u, z) if isinstance(u, np.ndarray) \
            else torch.where(cls == c, lo + (hi - lo) * u, z)
    return z


def write_tile(path: str, p: dict, seed: int) -> None:
    """Synthesize the tile of ``p`` (``tile_points`` over ``tile_width``
    metres) from ``seed`` and write it to ``path``."""
    rng = np.random.default_rng(int(seed))
    n, extent = int(p["tile_points"]), float(p["tile_width"])
    per_site = int(p["returns_per_site"])
    n_sites = -(-n // per_site)
    sx = rng.uniform(0, extent, n_sites)
    sy = rng.uniform(0, extent, n_sites)
    cls_s = rng.choice(np.asarray(p["classes"], np.uint8), n_sites, p=p["class_mix"])
    z_s = site_heights(cls_s, rng.uniform(0.0, 1.0, n_sites))
    rep = np.repeat(np.arange(n_sites), per_site)[:n]
    jitter = float(p["jitter"])
    pts = np.zeros(n, np.dtype([
        ("X", "<f8"), ("Y", "<f8"), ("Z", "<f8"), ("Intensity", "<u2"), ("ReturnNumber", "u1"),
        ("NumberOfReturns", "u1"), ("Classification", "u1"), ("GpsTime", "<f8"),
        ("Red", "<u2"), ("Green", "<u2"), ("Blue", "<u2"), ("Infrared", "<u2")]))
    pts["X"] = sx[rep] + TILE_X0 + rng.normal(0.0, jitter, n)
    pts["Y"] = sy[rep] + TILE_Y0 + rng.normal(0.0, jitter, n)
    pts["Z"] = z_s[rep] + rng.normal(0.0, jitter, n)
    pts["Classification"] = cls_s[rep]
    pts["Intensity"] = rng.integers(0, 4000, n)
    nr = rng.integers(1, 4, n).astype(np.uint8)
    pts["NumberOfReturns"] = nr
    pts["ReturnNumber"] = np.minimum(rng.integers(1, 4, n), nr)
    rgb = rng.integers(5_000, 40_000, (n, 4))
    pts["Red"], pts["Green"], pts["Blue"], pts["Infrared"] = rgb.T
    las.write_fmt8(path, pts, (0.01, 0.01, 0.01), (TILE_X0, TILE_Y0, 0.0), int(p["epsg"]))


@dataclass
class Batch:
    """A padded batch on the device. ``x (B, N, 9)``, ``pos (B, N, 3)`` as
    the net reads it, ``mask (B, N)``, ``y (B, N)`` (65 on pads),
    ``sampled_pos (B, N, 3)`` and ``full_pos (B, M, 3)`` in metres,
    ``full_mask (B, M)``; ``n_sampled`` and ``n_full`` the real counts."""
    x: torch.Tensor
    pos: torch.Tensor
    mask: torch.Tensor
    y: torch.Tensor
    sampled_pos: torch.Tensor
    full_pos: torch.Tensor
    full_mask: torch.Tensor
    n_sampled: np.ndarray
    n_full: np.ndarray


def _standardize(c):
    """The pipeline's per-subtile standardization with a 3-sigma clamp."""
    std = c.std(unbiased=True) + 1e-6
    s = (c - c.mean()) / std
    return s.clamp(-3 * std, 3 * std)


def _subtile(p: dict, gen, device, origin):
    """One subtile's raw points, then its voxel means: a dict of tensors."""
    per_site = int(p["returns_per_site"])
    mean_sites = float(p["tile_points"]) / per_site / (p["tile_width"] / p["subtile_width"]) ** 2
    n_sites = int(round(mean_sites + mean_sites ** 0.5
                        * float(torch.randn((), generator=gen, device=device))))
    w = float(p["subtile_width"])
    u = torch.rand((n_sites, 4), generator=gen, device=device, dtype=torch.float64)
    classes = torch.as_tensor(p["classes"], device=device)
    cls_s = classes[torch.multinomial(torch.as_tensor(p["class_mix"], device=device,
                                                      dtype=torch.float64),
                                      n_sites, replacement=True, generator=gen)]
    sites = torch.stack([u[:, 0] * w, u[:, 1] * w, site_heights(cls_s, u[:, 2])], dim=1)
    n = n_sites * per_site
    xyz = sites.repeat_interleave(per_site, dim=0) + float(p["jitter"]) * torch.randn(
        (n, 3), generator=gen, device=device, dtype=torch.float64)
    cls = cls_s.repeat_interleave(per_site)
    keep = cls != 65                                    # DropPointsByClass
    xyz, cls = xyz[keep], cls[keep]
    n = xyz.shape[0]
    geo = xyz + torch.tensor([TILE_X0 + origin[0], TILE_Y0 + origin[1], 0.0],
                             device=device, dtype=torch.float64)
    base = torch.tensor([TILE_X0, TILE_Y0, 0.0], device=device, dtype=torch.float64)
    pos = (base + torch.round((geo - base) * 100.0) / 100.0).float()   # 1 cm, then float32
    a = torch.rand((n, 7), generator=gen, device=device)
    nr = 1 + (a[:, 0] * 3).long()
    rn = torch.minimum(1 + (a[:, 1] * 3).long(), nr)
    colors = (5000 + (a[:, 3:7] * 35000).floor()) / COLOR_MAX
    colors = torch.where(rn[:, None] > 1, 0.0, colors)  # occluded returns
    rgb_avg = colors[:, :3].sum(dim=1) / 3.0
    ndvi = (colors[:, 3] - colors[:, 0]) / (colors[:, 3] + colors[:, 0] + 1e-6)
    feats = torch.cat([(a[:, 2:3] * 4000).floor(), rn[:, None] / 7.0, nr[:, None] / 7.0,
                       colors, rgb_avg[:, None], ndvi[:, None]], dim=1)
    # GridSampling(0.25): voxel means of positions and features, majority label
    vox = torch.floor((pos - pos.min(dim=0).values) / float(p["voxel"])).long()
    key = (vox[:, 0] << 42) | (vox[:, 1] << 21) | vox[:, 2]
    _, inverse, counts = torch.unique(key, return_inverse=True, return_counts=True)
    nv = counts.shape[0]
    sums = torch.zeros((nv, 12), device=device, dtype=torch.float64)
    sums.index_add_(0, inverse, torch.cat([pos.double(), feats.double()], dim=1))
    means = (sums / counts[:, None]).float()
    votes = torch.zeros((nv, 7), device=device, dtype=torch.int64)
    lab = torch.as_tensor([MODEL_CLASS.get(c, 0) for c in range(66)], device=device)[cls]
    votes.index_put_((inverse, lab), torch.ones_like(lab), accumulate=True)
    sx = means[:, :3]
    x = means[:, 3:]
    x[:, 0] = _standardize(torch.log(x[:, 0] + 1.0))
    x[:, 7] = _standardize(x[:, 7])
    order = torch.sort(sx[:, 0], stable=True).indices
    sx, x, y = sx[order], x[order], votes.argmax(dim=1)[order]
    net = sx.clone()
    net[:, 2] -= net[:, 2].min()                        # NullifyLowestZ
    net = (net - net.mean(dim=0)) / (w / 2.0)           # Center, NormalizePos
    full = pos[torch.sort(pos[:, 0], stable=True).indices]
    return dict(x=x, pos=net, y=y, sampled_pos=sx, full_pos=full)


def subtile_batch(p: dict, rows: int, gen: torch.Generator, device) -> Batch:
    """A batch of ``rows`` subtiles at distinct places of the tile, padded
    to the traffic's ``n_pad`` sampled and ``m_pad`` full points."""
    n_pad, m_pad = int(p["n_pad"]), int(p["m_pad"])
    per_side = int(p["tile_width"] // p["subtile_width"])
    cells = torch.randperm(per_side * per_side, generator=gen, device=device)[:rows].tolist()
    out = dict(x=torch.zeros((rows, n_pad, 9), device=device),
               pos=torch.zeros((rows, n_pad, 3), device=device),
               y=torch.full((rows, n_pad), 65, dtype=torch.int64, device=device),
               sampled_pos=torch.zeros((rows, n_pad, 3), device=device),
               full_pos=torch.zeros((rows, m_pad, 3), device=device))
    n_s, n_f = np.zeros(rows, np.int64), np.zeros(rows, np.int64)
    for r, cell in enumerate(cells):
        origin = (p["subtile_width"] * (cell // per_side), p["subtile_width"] * (cell % per_side))
        s = _subtile(p, gen, device, origin)
        n_s[r], n_f[r] = s["x"].shape[0], s["full_pos"].shape[0]
        if n_s[r] > n_pad or n_f[r] > m_pad or n_s[r] <= n_pad // 2 or n_f[r] <= m_pad * 2 // 3:
            raise ValueError(f"subtile of {n_s[r]} sampled, {n_f[r]} full points leaves the "
                             f"bucket ({n_pad}, {m_pad})")
        for k in ("x", "pos", "y", "sampled_pos"):
            out[k][r, :n_s[r]] = s[k]
        out["full_pos"][r, :n_f[r]] = s["full_pos"]
    ar_n = torch.arange(n_pad, device=device)
    ar_m = torch.arange(m_pad, device=device)
    return Batch(mask=ar_n[None] < torch.as_tensor(n_s, device=device)[:, None],
                 full_mask=ar_m[None] < torch.as_tensor(n_f, device=device)[:, None],
                 n_sampled=n_s, n_full=n_f, **out)
