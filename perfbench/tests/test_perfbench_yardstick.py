"""The yardstick's counts against hand-worked shapes."""

import pytest

from perfbench import yardstick as y

RANDLA = {"num_features": 9, "num_classes": 7, "num_neighbors": 16, "decimation": 4}
PN2 = {"num_features": 9, "num_classes": 7, "num_neighbors": 32, "decimation": 4,
       "radii": [0.05, 0.1, 0.2, 0.4], "widths": [64, 128, 256, 512]}


def test_decimated_keeps_a_quarter_and_never_empties():
    assert y.decimated(12500, 4, 4) == [12500, 3125, 781, 195, 48]
    assert y.decimated(3, 4, 2) == [3, 1, 1]
    assert y.decimated(0, 4, 1) == [0, 0]


def test_randla_flops_by_hand():
    # n = 16: stages 16, 4, 1, 1, 1; K slots min(16, n)
    n = [16, 4, 1, 1, 1]
    d = (32, 32, 128, 256, 512)
    fwd = 2 * 9 * 32 * 16
    for i in range(4):
        m, di, do = n[i], d[i], d[i + 1]
        s = m * min(16, m)
        fwd += 2 * m * (di * do // 8 + di * do + do // 2 * do)
        for c in (do // 4, do // 2):
            fwd += 2 * 10 * (c // 2) * s + 2 * c * c * s + 2 * c * c * m
    fwd += 2 * 512 * 512 * 1
    fwd += 2 * (768 * 256 * 1 + 384 * 128 * 1 + 160 * 32 * 4 + 64 * 32 * 16)
    fwd += 2 * 16 * (32 * 64 + 64 * 32 + 32 * 7)
    assert y.randla_flops(RANDLA, 16) == fwd
    enc = sum(2 * 10 * (c // 2) * n[i] * min(16, n[i])
              for i in range(4) for c in (d[i + 1] // 4, d[i + 1] // 2))
    assert y.randla_flops(RANDLA, 16, train=True) == 3 * fwd - 2 * 9 * 32 * 16 - enc


def test_pointnet2_flops_by_hand():
    # 100 real points padded to 256: 64, 16, 4, 1 centroids (real: 64, 16, 4, 1)
    assert y.pointnet2_stages(PN2, 100, 256) == [100, 64, 16, 4, 1]
    slots = [10, 20, 30, 40]
    want = 2 * 9 * 32 * 100
    ins = [32, 64, 128, 256, 512]
    for i, w in enumerate(PN2["widths"]):
        want += 2 * slots[i] * ((ins[i] + 3) * w // 2 + (w // 2) ** 2 + w // 2 * w)
    ns = [100, 64, 16, 4, 1]
    width = 512
    for j, out in enumerate((256, 256, 128, 128)):
        skip = 3 - j
        want += 2 * (width + ins[skip]) * out * ns[skip]
        width = out
    want += 2 * 100 * (128 * 128 + 128 * 7)
    assert y.pointnet2_flops(PN2, 100, 256, slots) == want


def test_search_and_interp_bounds_by_hand():
    assert y.search_bytes(10, 20, 16) == 16 * 30 + 8 * 16 * 10
    # RandLA: 4 self graphs (K=16, min(K, n)) and 4 k=1 decoder searches
    ns = [16, 4, 1, 1, 1]
    want = sum(16 * 2 * m + 8 * min(16, m) * m for m in ns[:4])
    want += sum(16 * (ns[i] + ns[i + 1]) + 8 * ns[i] for i in range(4))
    assert y.k1_bytes("randla_net", RANDLA, 16, 16) == want
    # K3: bytes-bound at these widths
    n_bytes = 16 * (1000 + 300) + 4 * 7 * 1300
    assert y.k3_bound_s(300, 1000, 10, 7) == pytest.approx(n_bytes / 3.35e12)
    ops = 1e6 * (10 * 15 + 7)
    assert y.k3_bound_s(0, 10 ** 6, 10, 7) == pytest.approx(
        max((16 + 28) * 1e6 / 3.35e12, ops / 67e12))


def test_every_per_layer_metric_finds_its_reader():
    import json
    import os

    from perfbench import run
    from perfbench.tests.conftest import ROOT

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        assert callable(run.load_reader(m["name"])), m["name"]


def test_mfu_pct_counts_a_train_step_by_family():
    from perfbench import run

    read = run.load_reader("mfu_pct.train")
    batches = [([12500, 12000], [41000, 40000], 16384)]
    rec = {"kind": "train", "family": "randla_net", "cfg": RANDLA, "batches": batches,
           "steps": 3, "window_s": 1.0}
    want = 3 * sum(y.randla_flops(RANDLA, n, train=True) for n in (12500, 12000))
    assert read(rec) == pytest.approx(100.0 * want / y.PEAKS["fp32_flops"])
    with pytest.raises(NotImplementedError):
        read(dict(rec, family="pointnet2", cfg=PN2))
