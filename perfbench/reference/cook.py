"""The plain cook of a tile into the padded batches the predict step reads,
as IGNF/myria3d's predict path defines it (numpy).

- subtiles: squares of ``subtile_width`` on a mosaic anchored at the tile's
  XY minimum, centres ``subtile_width / 2`` apart by ``subtile_width``; a
  point belongs to every square whose centre lies within half a width of it
  on both axes (inclusive), in x-major order of the squares, points in file
  order; empty squares are skipped;
- features (Lidar HD): intensity, return number and number of returns over
  7, R, G, B, NIR over 255 * 256 (zero on returns after the first), their
  RGB mean and the NDVI; positions float32;
- per subtile: the artefact class 65 dropped, the full cloud kept, 0.25 m
  GridSampling (voxel means, voxels in lexicographic order of their integer
  coordinates from the subtile's minimum), the sampled positions kept,
  centred, both clouds x-sorted (stable), the lowest z at 0, positions over
  half the subtile width, log-intensity and the RGB mean standardized with
  a 3-sigma clamp;
- batches of ``batch`` subtiles in order, padded to the smallest bucket of
  the ladders that holds the batch's largest cloud.

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

ARTEFACT = 65
SAMPLED_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 24576, 32768, 40064)
FULL_BUCKETS = (1024, 4096, 8192, 16384, 24576, 32768, 49152, 65536, 98304, 131072)


def bucket(n: int, ladder) -> int:
    for b in ladder:
        if n <= b:
            return b
    top = ladder[-1]
    return -(-n // top) * top


def windows(x: np.ndarray, y: np.ndarray, tile_width: float, width: float):
    """(point indices of each non-empty square in x-major order, number of
    squares each point lies in)."""
    rel = [x - x.min(), y - y.min()]
    centres = np.arange(width / 2, tile_width + width / 2, width)
    n_k = len(centres)
    cand, ok = [], []
    for c in rel:
        k = np.floor(c / width).astype(np.int64)[:, None] + np.arange(-1, 2)[None, :]
        valid = (k >= 0) & (k < n_k)
        valid &= np.abs(c[:, None] - centres[np.clip(k, 0, n_k - 1)]) <= width // 2
        cand.append(k)
        ok.append(valid)
    win = (cand[0][:, :, None] * n_k + cand[1][:, None, :]).reshape(len(x), 9)
    member = (ok[0][:, :, None] & ok[1][:, None, :]).reshape(len(x), 9)
    point = np.broadcast_to(np.arange(len(x))[:, None], win.shape)
    w, p = win[member], point[member]
    order = np.lexsort((p, w))
    w, p = w[order], p[order]
    cuts = np.flatnonzero(np.diff(w)) + 1
    return np.split(p, cuts), member.sum(axis=1)


def features(pts: dict, idx: np.ndarray):
    """(pos float32 (n, 3), x float32 (n, 9), class codes) of the points."""
    pos = np.stack([pts["X"][idx], pts["Y"][idx], pts["Z"][idx]], axis=1).astype(np.float32)
    rn = pts["ReturnNumber"][idx]
    occluded = rn > 1
    colors = {}
    for c in ("Red", "Green", "Blue", "Infrared"):
        ch = pts[c][idx].astype(np.float32) / (255.0 * 256.0)
        ch[occluded] = 0.0
        colors[c] = ch
    rgb_avg = np.stack([colors["Red"], colors["Green"], colors["Blue"]], axis=1).mean(
        axis=1).astype(np.float32)
    ndvi = ((colors["Infrared"] - colors["Red"])
            / (colors["Infrared"] + colors["Red"] + 1e-6)).astype(np.float32)
    x = np.stack([pts["Intensity"][idx].astype(np.float32), rn / 7.0,
                  pts["NumberOfReturns"][idx] / 7.0, colors["Red"], colors["Green"],
                  colors["Blue"], colors["Infrared"], rgb_avg, ndvi], axis=1).astype(np.float32)
    return pos, x, pts["Classification"][idx].astype(np.int64)


def voxels(pos: np.ndarray, size: float):
    """(voxel of each point, voxel count): voxels in lexicographic order of
    ``floor((pos - min) / size)``, computed in float32."""
    c = np.floor((pos - pos.min(axis=0)) / np.float32(size)).astype(np.int64)
    key = (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]      # lexicographic: each < 2**21
    _, inverse, counts = np.unique(key, return_inverse=True, return_counts=True)
    return inverse.ravel(), len(counts)


def _standardize(c: np.ndarray) -> np.ndarray:
    std = c.std(ddof=1) + 1e-6
    return np.clip((c - c.mean()) / std, -3 * std, 3 * std)


def subtile(pos, x, cls, idx, size: float, width: float) -> dict:
    """One subtile's cooked sample: ``pos`` as the net reads it, ``x``,
    ``sampled`` and ``full`` positions (metres, x-sorted) and ``idx``, the
    full cloud's points in the tile, in the full cloud's order."""
    keep = cls != ARTEFACT
    pos, x, idx = pos[keep], x[keep], idx[keep]
    full = pos.copy()
    inverse, n_vox = voxels(pos, size)
    counts = np.bincount(inverse, minlength=n_vox).astype(np.float64)

    def mean(a):
        sums = np.zeros((n_vox, a.shape[1]), np.float64)
        np.add.at(sums, inverse, a)
        return (sums / counts[:, None]).astype(a.dtype)

    pos, x = mean(pos), mean(x)
    sampled = pos.copy()
    pos = pos - pos.mean(axis=0, keepdims=True)
    order = np.argsort(pos[:, 0], kind="stable")
    pos, x, sampled = pos[order], x[order], sampled[order]
    full_order = np.argsort(full[:, 0], kind="stable")
    full, idx = full[full_order], idx[full_order]
    pos[:, 2] = pos[:, 2] - pos[:, 2].min()
    pos = pos * (1 / (width / 2))
    x[:, 0] = _standardize(np.log(x[:, 0] + 1))
    x[:, 7] = _standardize(x[:, 7])
    return {"pos": pos, "x": x, "sampled": sampled, "full": full, "idx": idx}


def sampled_count(pos, cls, size: float) -> int:
    """The number of voxels a subtile's cook keeps."""
    return voxels(pos[cls != ARTEFACT], size)[1]


def pad(samples: list, batch: int) -> dict:
    """The padded batch of ``samples`` (numpy): x, pos, mask, sampled_pos,
    full_pos, full_mask."""
    n = bucket(max(len(s["pos"]) for s in samples), SAMPLED_BUCKETS)
    m = bucket(max(len(s["full"]) for s in samples), FULL_BUCKETS)
    out = {"x": np.zeros((batch, n, 9), np.float32), "pos": np.zeros((batch, n, 3), np.float32),
           "mask": np.zeros((batch, n), bool), "sampled_pos": np.zeros((batch, n, 3), np.float32),
           "full_pos": np.zeros((batch, m, 3), np.float32), "full_mask": np.zeros((batch, m), bool)}
    for r, s in enumerate(samples):
        k, f = len(s["pos"]), len(s["full"])
        out["x"][r, :k], out["pos"][r, :k], out["mask"][r, :k] = s["x"], s["pos"], True
        out["sampled_pos"][r, :k] = s["sampled"]
        out["full_pos"][r, :f], out["full_mask"][r, :f] = s["full"], True
    return out
