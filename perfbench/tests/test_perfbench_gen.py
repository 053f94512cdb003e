"""The generator: the same seed gives the same inputs, another seed others,
and every subtile lands in its mix's bucket."""

import numpy as np
import torch

from perfbench import gen
from perfbench.tests.conftest import small_cell


def _batch(seed: int):
    _, _, _, traffic = small_cell("randla.predict_step")
    g = torch.Generator().manual_seed(seed)
    return traffic, gen.subtile_batch(traffic, traffic["rows"], g, torch.device("cpu"))


def test_subtile_batch_is_the_seeds():
    _, a = _batch(2 ** 31 + 5)
    _, b = _batch(2 ** 31 + 5)
    _, c = _batch(2 ** 31 + 6)
    for name in ("x", "pos", "mask", "y", "sampled_pos", "full_pos", "full_mask"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert not torch.equal(a.full_pos, c.full_pos)


def test_subtile_batch_lands_in_its_bucket_x_sorted():
    traffic, b = _batch(7)
    n, m = traffic["n_pad"], traffic["m_pad"]
    assert b.x.shape == (traffic["rows"], n, 9) and b.full_pos.shape == (traffic["rows"], m, 3)
    assert (b.n_sampled > n // 2).all() and (b.n_sampled <= n).all()
    assert (b.n_full > m * 2 // 3).all() and (b.n_full <= m).all()
    for r in range(traffic["rows"]):
        k, f = int(b.n_sampled[r]), int(b.n_full[r])
        assert int(b.mask[r].sum()) == k and int(b.full_mask[r].sum()) == f
        assert (b.sampled_pos[r, :k, 0].diff() >= 0).all()
        assert (b.full_pos[r, :f, 0].diff() >= 0).all()
        assert b.pos[r, :k].abs().max() <= 1.5          # the net's normalized units
        assert ((b.y[r, :k] >= 0) & (b.y[r, :k] < 7)).all() and (b.y[r, k:] == 65).all()
    # GridSampling(0.25) keeps about a third of the points
    ratio = b.n_sampled.sum() / b.n_full.sum()
    assert 0.25 < ratio < 0.5


def test_write_tile_is_the_seeds(tmp_path):
    from perfbench import las

    _, _, _, traffic = small_cell("randla.tile_predict")
    paths = [str(tmp_path / f"{i}.las") for i in range(3)]
    for path, seed in zip(paths, (11, 11, 12)):
        gen.write_tile(path, traffic, seed)
    data = [open(p, "rb").read() for p in paths]
    assert data[0] == data[1] and data[0] != data[2]
    pts = las.read_fmt8(paths[0])
    assert len(pts["X"]) == traffic["tile_points"]
    assert np.ptp(pts["X"]) <= traffic["tile_width"] + 1 and set(np.unique(pts["Classification"])) \
        <= set(traffic["classes"])
