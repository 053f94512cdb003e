"""The CUDA kernels K1-K7 against their plain PyTorch versions on the
card (skipped where there is no CUDA device; ``chip_smoke.py`` runs the
same comparisons at the predict and train steps' full shapes).

Run them on the card without the JAX side's fixtures (the card has no
JAX): ``python -m pytest --noconftest tests/myria3d_tpu_torch/test_torch_cuda_kernels.py``.

Tolerances: K1 shares the plain version's arithmetic order and its
(d2, index) ranking, so indices and d2 are equal, whatever order its scan
takes the keys in (ties, duplicate points, unsorted clouds); K2 sums in
another order (1e-4 of the output's scale); K3 divides the same f32 sums
(1e-5); K4 sums the same f32 terms in another
order (1e-5), over an inverse map equal to the plain version's; K5 and K6
are held to their plain versions in float64 (K5 1e-5; K6 recomputes the forward and sums over every edge: 1e-4 on dx,
1e-3 on the heavily cancelling d(att_w) and BN sums). K2 and K6 run their
attention products in 3xTF32, which keeps them at f32 grade
(``test_torch_lfa_tf32.py``), at every width the model uses. K7 shares its plain
version's association and ranking, so indices and d2 are equal, whatever
order its scan takes the keys in and wherever it stops among the virtual
pad rows. K8 (farthest-point sampling) sums in its plain version's association
and breaks ties as it does, so indices and masks are equal, on every route
(1 to 12 points a thread, clusters of 1 to 8 CTAs, with and without the
box skip), on masks that are no prefix, duplicate points, x-sorted and
unsorted clouds; a PointNet++ train step launches K1, K4 and K8.

K2_16 (K2 reading bfloat16 / float16 features) is held to the plain
version on the same 16-bit values widened to f32: the same arithmetic
(1e-4 of scale), at every width; a 16-bit x launches the 16-bit kernel
(``lfa_attention_x16.launches``), never K2's f32 one. K4 takes 16-bit
cotangents at an f32 boundary: the sums equal the f32 kernel's on the
widened values, cast back. A 16-bit train step of both families takes the
unfused route and launches no K5/K6; a 16-bit predict step launches K2_16.
"""

import numpy as np
import pytest
import torch

from myria3d_tpu_torch.models.model import Model, build_model, build_net
from myria3d_tpu_torch.ops.cuda_fps import MAX_N, farthest_point_sampling_plain, fps
from myria3d_tpu_torch.ops.cuda_gather import (
    gather_bwd,
    gather_bwd_plain,
    inverse_map,
    inverse_map_plain,
)
from myria3d_tpu_torch.ops.cuda_interp import knn_interp, knn_interp_plain
from myria3d_tpu_torch.ops.cuda_knn import knn_topk, knn_topk_mxu, knn_topk_plain
from myria3d_tpu_torch.ops.cuda_lfa import (
    idx_with_invalid,
    lfa_attention,
    lfa_attention_plain,
    lfa_attention_x16,
)
from myria3d_tpu_torch.ops.cuda_lfa_train import (
    lfa_train_bwd,
    lfa_train_bwd_plain,
    rel_stats,
    rel_stats_plain,
)
from myria3d_tpu_torch.ops.knn import centred_clouds, knn_graph

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none (also
    defined here so that the file runs with ``--noconftest``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _sorted_cloud(b, n, dev, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    p = torch.rand((b, n, 3), generator=g) * torch.tensor([50.0, 50.0, 10.0])
    p = torch.take_along_dim(p, p[..., :1].argsort(dim=1), dim=1)
    mask = torch.ones((b, n), dtype=torch.bool)
    mask[1:, n - n // 5:] = False
    return p.to(dev), mask.to(dev)


def _grid_cloud(rng, n):
    """(2, n, 3) points on a quarter-metre grid (x, y in [-8, 8), z in
    [-2, 2)), x-sorted: exact duplicates and many keys at equal distances,
    every squared distance exact in f32."""
    p = np.stack([rng.integers(-32, 32, (2, n)), rng.integers(-32, 32, (2, n)),
                  rng.integers(-8, 8, (2, n))], axis=-1).astype(np.float32) / 4
    p[:, n // 2:n // 2 + n // 8] = p[:, :n // 8]         # exact duplicate rows
    return np.take_along_axis(p, np.argsort(p[..., :1], axis=1, kind="stable"), axis=1)


def _clouds(kind, nq, nk, dev, seed):
    """(q4, k4, query mask) in the kernels' layout. "sorted": x-sorted
    uniform subtiles centred as the model centres them (the second cloud's
    last fifth is padding); "unsorted": the same rows in random order (full
    scans only); "grid": ``_grid_cloud`` queries and keys, the second
    cloud's last tenth of keys pad keys (w = 1e4) and of queries masked;
    "few": sorted clouds whose keys are pad keys but for the first 7 of the
    first cloud (fewer valid keys than k, so pad keys and the virtual pad
    rows past Nk compete for the list)."""
    if kind == "grid":
        rng = np.random.default_rng(seed)
        q, kp = _grid_cloud(rng, nq), _grid_cloud(rng, nk)
        w = np.zeros((2, nk, 1), np.float32)
        w[1, nk - nk // 10:] = 1e4
        qm = np.ones((2, nq), bool)
        qm[1, nq - nq // 10:] = False
        q4 = np.concatenate([q, np.zeros_like(q[..., :1])], axis=-1)
        k4 = np.concatenate([kp, w], axis=-1)
        return (torch.from_numpy(q4).to(dev), torch.from_numpy(k4).to(dev),
                torch.from_numpy(qm).to(dev))
    qp, qm = _sorted_cloud(2, nq, dev, seed)
    kp, km = _sorted_cloud(2, nk, dev, seed + 1)
    if kind == "few":
        km = torch.zeros_like(km)
        km[0, :7] = True
    if kind == "unsorted":
        g = torch.Generator(device="cpu").manual_seed(seed)
        qo, ko = torch.randperm(nq, generator=g).to(dev), torch.randperm(nk, generator=g).to(dev)
        qp, qm, kp, km = qp[:, qo], qm[:, qo], kp[:, ko], km[:, ko]
    q4, k4 = centred_clouds(qp, kp, km)
    return q4, k4, qm


# the shipped cases; every k the tests name, with ties and nq % 256 != 0;
# windows above the 5120-position shared-memory budget (the ring); full
# scans up to nk = 40960, sorted, unsorted and with ties
K1_CASES = ([(16, 2048, 4096, 4096, "sorted"), (1, 2048, 8192, 4096, "sorted"),
             (1, 0, 768, 192, "sorted"), (10, 0, 1000, 300, "sorted")]
            + [(k, 2048, 1000, 4096, "grid") for k in (1, 2, 10, 16, 17, 32)]
            + [(16, 6144, 3000, 16384, "sorted"), (1, 6144, 3000, 16384, "grid"),
               (17, 6144, 1000, 16384, "grid")]
            + [(16, 0, 2000, 40960, "sorted"), (32, 0, 1000, 40960, "grid"),
               (16, 0, 1500, 12288, "unsorted"), (10, 0, 700, 3000, "unsorted")])


@pytest.mark.parametrize("k,window,nq,nk,kind", K1_CASES)
def test_k1_matches_plain(cuda_device, k, window, nq, nk, kind):
    q4, k4, qm = _clouds(kind, nq, nk, cuda_device, 1)
    before = knn_topk.launches
    idx, d2 = knn_topk(q4, k4, k, window=window, query_mask=qm)
    assert knn_topk.launches == before + 1
    pidx, pd2 = knn_topk_plain(q4, k4, k, window=window, query_mask=qm)
    torch.cuda.synchronize()
    assert torch.equal(d2, pd2)
    assert torch.equal(idx, pidx)


# the shipped k with Nk at and off a multiple of 512; every k the tests name,
# with ties; unsorted clouds; Nk above the 5120-position shared-memory
# budget (the ring); fewer valid keys than k, Nk no multiple of 512 (and a
# scan of 101 positions, under the block's 128-row scratch); nq % 256 != 0
K7_CASES = ([(16, 768, 768, "sorted"), (16, 1000, 700, "sorted"), (1, 1000, 300, "sorted"),
             (32, 4096, 1500, "sorted")]
            + [(k, 1000, 4096, "grid") for k in (1, 2, 10, 16, 17, 32)]
            + [(16, 1500, 12288, "unsorted"), (10, 700, 3000, "unsorted"),
               (1, 2000, 12288, "unsorted")]
            + [(16, 2000, 40960, "sorted"), (32, 1000, 40960, "grid"), (1, 1000, 6000, "sorted")]
            + [(16, 1000, 700, "few"), (32, 600, 1100, "few"), (1, 300, 100, "few"),
               (17, 500, 5130, "few")])


@pytest.mark.parametrize("k,nq,nk,kind", K7_CASES)
def test_k7_matches_plain(cuda_device, k, nq, nk, kind):
    q4, k4, _ = _clouds(kind, nq, nk, cuda_device, 5)
    before = knn_topk_mxu.launches, knn_topk.launches
    idx, d2 = knn_topk(q4, k4, k, variant="mxu")
    assert (knn_topk_mxu.launches, knn_topk.launches) == (before[0] + 1, before[1])
    pidx, pd2 = knn_topk_plain(q4, k4, k, variant="mxu")
    torch.cuda.synchronize()
    assert torch.equal(idx, pidx)
    assert torch.equal(d2, pd2)


# (C_in, K, seed, N): every width the model uses, K = 8 and 16, more draws
# at C_in = 16, and clouds whose points end inside a kernel tile
LFA_CASES = ([(c_in, k, 0, 3072) for c_in in (4, 8, 16, 32, 64, 128) for k in (8, 16)]
             + [(16, 16, seed, 3072) for seed in (1, 2, 3)]
             + [(c_in, 16, 0, 3001) for c_in in (4, 128)])


def _lfa_graph(dev, k, seed, n):
    """A (2, n) graph of K neighbours whose second cloud ends in padding,
    with some slots of every seventh point and every slot of 64 points
    marked invalid."""
    pos, mask = _sorted_cloud(2, n, dev, 3 + seed)
    idx, _, nv = knn_graph(pos, mask, k, window=2048)
    nv = nv.clone()
    nv[:, ::7, k // 2:] = False
    nv[0, 100:164] = False
    return pos, mask, idx, nv


def k2_args(dev, c_in, k, seed, n):
    """The inputs of a K2 case: (x, pos, idx, nv, enc_a, enc_c, att_w)."""
    pos, mask, idx, nv = _lfa_graph(dev, k, seed, n)
    g = torch.Generator(device=dev).manual_seed(100 * c_in + seed)
    x = torch.rand((2, n, c_in), generator=g, device=dev) * 2 - 1
    enc_a = torch.randn((c_in, 10), generator=g, device=dev) * 0.3
    enc_c = torch.randn((c_in,), generator=g, device=dev) * 0.3
    att_w = torch.randn((2 * c_in, 2 * c_in), generator=g, device=dev) / (2 * c_in) ** 0.5
    return x, pos, idx, nv, enc_a, enc_c, att_w


@pytest.mark.parametrize("c_in,k,seed,n", LFA_CASES)
def test_k2_matches_plain(cuda_device, c_in, k, seed, n):
    args = k2_args(cuda_device, c_in, k, seed, n)
    before = lfa_attention.launches
    got, want = lfa_attention(*args), lfa_attention_plain(*args)
    torch.cuda.synchronize()
    assert lfa_attention.launches == before + 1
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert (got[0, 100:164] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("c_in,k,seed,n", LFA_CASES)
def test_k2_16_matches_plain(cuda_device, c_in, k, seed, n, dtype):
    x, *rest = k2_args(cuda_device, c_in, k, seed, n)
    x16 = x.to(dtype)
    before = (lfa_attention.launches, lfa_attention_x16.launches)
    got = lfa_attention(x16, *rest)
    want = lfa_attention_plain(x16.float(), *rest)
    torch.cuda.synchronize()
    assert (lfa_attention.launches, lfa_attention_x16.launches) == (before[0], before[1] + 1)
    assert got.dtype == torch.float32
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert (got[0, 100:164] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k4_sums_16_bit_cotangents_in_f32(cuda_device, dtype):
    pos, mask, idx, nv = _graph(2, 4096, 16, cuda_device, 8)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    dout = torch.randn((2, 4096, 16, 32), generator=g, device=cuda_device).to(dtype)
    inv = inverse_map(idx, nv, 4096)
    got = gather_bwd(dout, idx, nv, inv, 4096)
    want = gather_bwd(dout.float(), idx, nv, inv, 4096).to(dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("name", ["RandLANet", "PointNet2"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16_bit_steps_run_their_kernels(cuda_device, name, dtype):
    """A 16-bit train step at B=16 (``fused_train_lfa: auto`` would take
    the fused route in f32) launches no K5 or K6 and gives finite f32
    gradients; the 16-bit eval forward of RandLA-Net launches K2_16 eight
    times (two LFAs a block) and K2 none."""
    hp = {"num_features": 9, "num_classes": 7}
    if name == "PointNet2":
        hp["widths"] = (16, 32, 64, 128)
    model = build_model(name, {**hp, "dtype": dtype}).to(cuda_device)
    model.init_train_state()
    g = torch.Generator().manual_seed(2)
    x = torch.rand((16, 2048, 9), generator=g).to(cuda_device)
    pos = (torch.rand((16, 2048, 3), generator=g) * 2 - 1).to(cuda_device)
    y = torch.randint(0, 7, (16, 2048), generator=g).to(cuda_device)
    mask = torch.ones((16, 2048), dtype=torch.bool, device=cuda_device)
    before = (rel_stats.launches, lfa_train_bwd.launches)
    loss, logits = model.grad_step(x, pos, y, mask)
    torch.cuda.synchronize()
    assert (rel_stats.launches, lfa_train_bwd.launches) == before
    assert logits.dtype == torch.float32 and bool(torch.isfinite(loss))
    for p in model.net.parameters():
        assert p.dtype == torch.float32 and bool(torch.isfinite(p.grad).all())
    if name == "RandLANet":
        before = (lfa_attention.launches, lfa_attention_x16.launches)
        _, logits = model.eval_step(x, pos, y, mask)
        torch.cuda.synchronize()
        assert (lfa_attention.launches, lfa_attention_x16.launches) == (before[0], before[1] + 8)
        assert bool(torch.isfinite(logits).all())


def test_searches_reject_misaligned_rows(cuda_device):
    """K1, K3 and K7 read (..., 4) rows as 16-byte vectors: a view that
    starts one float into its storage is refused, not read unaligned."""
    q4, k4, qm = _clouds("sorted", 512, 512, cuda_device, 2)
    bad = torch.empty(q4.numel() + 1, device=cuda_device)[1:].view(q4.shape).copy_(q4)
    x = torch.zeros((2, 512, 7), device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        knn_topk(bad, k4, 16)
    with pytest.raises(ValueError, match="aligned"):
        knn_topk(q4, bad, 16, variant="mxu")
    with pytest.raises(ValueError, match="aligned"):
        knn_interp(x, bad, k4, 10, query_mask=qm)


# the shipped case; the full scan; ties; a window above the shared-memory
# budget; another k (the generic list); an unsorted full scan; whole warps
# (64 query rows) outside the query mask
K3_CASES = [(10, 2048, 8192, 3072, "sorted", False), (10, 0, 8192, 3072, "sorted", False),
            (10, 2048, 1000, 4096, "grid", False), (10, 6144, 3000, 16384, "sorted", False),
            (3, 2048, 1000, 4096, "grid", False), (10, 0, 1500, 12288, "unsorted", False),
            (10, 2048, 8192, 3072, "sorted", True)]


@pytest.mark.parametrize("k,window,nq,nk,kind,masked_warps", K3_CASES)
def test_k3_matches_plain(cuda_device, k, window, nq, nk, kind, masked_warps):
    q4, k4, qm = _clouds(kind, nq, nk, cuda_device, 4)
    if masked_warps:
        qm[0, nq // 3:] = False
        qm[1, 1000:1500:3] = False
    g = torch.Generator(device=cuda_device).manual_seed(k)
    x = torch.randn((2, nk, 7), generator=g, device=cuda_device) * 3
    before = knn_interp.launches
    got = knn_interp(x, q4, k4, k, window=window, query_mask=qm)
    assert knn_interp.launches == before + 1
    want = knn_interp_plain(x, q4, k4, k, window=window, query_mask=qm)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert (got[~qm] == 0).all()


def test_predict_step_runs_every_kernel(cuda_device):
    torch.manual_seed(0)
    net = build_net("RandLANet", {"num_features": 9, "num_classes": 7})
    model = Model(net).to(cuda_device).eval()
    model.set_sorted_window(4608)
    pos, mask = _sorted_cloud(2, 4096, cuda_device, 6)
    full, fmask = _sorted_cloud(2, 8192, cuda_device, 7)
    x = torch.rand((2, 4096, 9), device=cuda_device)
    counters = (knn_topk, lfa_attention, knn_interp)
    before = [f.launches for f in counters]
    out = model.interp_step(x, pos, mask, pos, full, fmask,
                            torch.Generator(device=cuda_device).manual_seed(0))
    torch.cuda.synchronize()
    assert out.dtype == torch.float16 and out.shape == (2, 8192, 7)
    assert torch.isfinite(out).all()
    # 4 encoder graphs + 4 decoder searches, 8 LFAs, 1 interpolation
    assert [f.launches - b for f, b in zip(counters, before)] == [8, 8, 1]
    assert np.isfinite(out.float().cpu().numpy()).all()


def _graph(b, n, k, dev, seed):
    pos, mask = _sorted_cloud(b, n, dev, seed)
    idx, _, nv = knn_graph(pos, mask, k, window=2048)
    return pos, mask, idx, nv


# the gathers' widths on the unfused route ([pos | x] and lfa2's x per
# block) and those of K6's dx scatters; one that is no multiple of 4 lanes
# wide, and rows wider than one pass of a group in both layouts
K4_WIDTHS = [7, 8, 19, 32, 35, 64, 67, 128, 4, 16, 36, 131, 260]


@pytest.mark.parametrize("p", K4_WIDTHS)
def test_k4_matches_plain(cuda_device, p):
    """The deterministic scatter equals the plain scatter-add up to the
    summation order (1e-5 of scale) and repeats bit for bit."""
    pos, mask, idx, nv = _graph(2, 4096, 16, cuda_device, 8)
    g = torch.Generator(device=cuda_device).manual_seed(p)
    dout = torch.randn((2, 4096, 16, p), generator=g, device=cuda_device)
    inv = inverse_map(idx, nv, 4096)
    before = gather_bwd.launches
    got = gather_bwd(dout, idx, nv, inv, 4096)
    again = gather_bwd(dout, idx, nv, inv, 4096)
    assert gather_bwd.launches == before + 2
    want = gather_bwd_plain(dout, idx, nv, 4096)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(got, again)


def test_k4_unaligned_rows_take_the_scalar_layout(cuda_device):
    """Rows of a multiple of 4 floats that start off a 16-byte boundary are
    read one float a lane: the same sums, bit for bit."""
    pos, mask, idx, nv = _graph(2, 2048, 16, cuda_device, 8)
    dout = torch.randn((2, 2048, 16, 32), device=cuda_device)
    shifted = torch.empty(dout.numel() + 1, device=cuda_device)[1:].view(dout.shape).copy_(dout)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    inv = inverse_map(idx, nv, 2048)
    assert torch.equal(gather_bwd(dout, idx, nv, inv, 2048), gather_bwd(shifted, idx, nv, inv, 2048))


def _hub_graph(dev, case):
    """(idx, nv, n_keys) of graphs the inverse map must order: a kNN graph
    with invalid slots and an all-invalid cloud; every query choosing key 5
    in every slot (one range of every slot of the cloud); queries and keys
    of different counts."""
    if case == "knn":
        _, _, idx, nv = _lfa_graph(dev, 16, 0, 3072)
        nv[1] = False
        return idx, nv, 3072
    g = torch.Generator(device="cpu").manual_seed(3)
    if case == "hub":
        idx = torch.full((2, 700, 8), 5, dtype=torch.int32)
        idx[1] = torch.randint(0, 300, (700, 8), generator=g, dtype=torch.int32)
        nv = torch.ones((2, 700, 8), dtype=torch.bool)
        nv[0, ::3, 1] = False
        return idx.to(dev), nv.to(dev), 300
    if case == "long_ranges":
        # a full-size cloud whose every slot chose one key; one with ranges
        # just under, at and over the length where the block takes over,
        # among ordinary ones
        idx = torch.randint(0, 12288, (2, 12288, 16), generator=g, dtype=torch.int32)
        idx[0] = 77
        nv = torch.rand((2, 12288, 16), generator=g) < 0.97
        flat, flat_nv = idx[1].view(-1), nv[1].view(-1)
        ranges = ((3, 255), (4, 256), (5, 257), (12287, 3000))
        for key, _ in ranges:
            flat[flat == key] = 9
        places = torch.randperm(flat.numel(), generator=g)
        for key, d in ranges:
            flat[places[:d]], flat_nv[places[:d]], places = key, True, places[d:]
        return idx.to(dev), nv.to(dev), 12288
    idx = torch.randint(0, 50, (3, 1000, 4), generator=g, dtype=torch.int32)
    nv = torch.rand((3, 1000, 4), generator=g) < 0.8
    return idx.to(dev), nv.to(dev), 50


@pytest.mark.parametrize("case", ["knn", "hub", "few_keys", "long_ranges"])
def test_inverse_map_matches_plain(cuda_device, case):
    """The hand-built map equals the stable sort's: the same offsets, and
    the same perm over every range (atomics place the slots, each range is
    then ordered, so the result repeats)."""
    idx, nv, n_keys = _hub_graph(cuda_device, case)
    before = inverse_map.launches
    got, want = inverse_map(idx, nv, n_keys), inverse_map_plain(idx, nv, n_keys)
    again = inverse_map(idx, nv, n_keys)
    torch.cuda.synchronize()
    assert inverse_map.launches == before + 2
    n_valid = int(nv.sum())
    assert int(got.offsets[-1]) == n_valid
    assert got.offsets.dtype == got.perm.dtype == torch.int32
    assert torch.equal(got.offsets, want.offsets)
    assert torch.equal(got.perm[:n_valid], want.perm[:n_valid])
    assert torch.equal(again.perm[:n_valid], got.perm[:n_valid])


def test_inverse_map_long_range_in_bounded_time(cuda_device):
    """A key that every slot of a full-size cloud chose (196 608 slots in
    one range, in each of 16 clouds) is ordered by a walk of the cloud's
    slots, not by a compare of every pair: the map takes milliseconds."""
    idx = torch.full((16, 12288, 16), 4242, dtype=torch.int32, device=cuda_device)
    nv = torch.ones((16, 12288, 16), dtype=torch.bool, device=cuda_device)
    got = inverse_map(idx, nv, 12288)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    got = inverse_map(idx, nv, 12288)
    end.record()
    end.synchronize()
    assert start.elapsed_time(end) < 50.0
    want = torch.arange(16 * 12288 * 16, dtype=torch.int32, device=cuda_device)
    assert torch.equal(got.perm, want)
    assert torch.equal(got.offsets, inverse_map_plain(idx, nv, 12288).offsets)


def test_inverse_map_leaves_out_indices_outside_the_keys(cuda_device):
    """A valid slot whose index is no key of its cloud is in no range (and
    writes nowhere): the map of the graph without those slots."""
    idx, nv, n_keys = _hub_graph(cuda_device, "few_keys")
    bad = idx.clone()
    bad[0, ::5, 0] = n_keys + 3
    bad[2, 1::7, 2] = -2
    inside = nv & (bad >= 0) & (bad < n_keys)
    got, want = inverse_map(bad, nv, n_keys), inverse_map_plain(idx, inside, n_keys)
    n_valid = int(inside.sum())
    assert n_valid < int(nv.sum())
    assert torch.equal(got.offsets, want.offsets)
    assert torch.equal(got.perm[:n_valid], want.perm[:n_valid])


# (N, K): the four train stages, K = 8, and K no power of two
K5_CASES = [(12288, 16), (3072, 16), (768, 16), (192, 16), (3072, 8), (192, 8), (768, 12),
            (192, 5)]


@pytest.mark.parametrize("n,k", K5_CASES)
def test_k5_matches_plain(cuda_device, n, k):
    """Against the plain version in float64: K5's f32 sums of up to ~1e5
    positive products a block stay within 1e-5 of scale; invalid slots and
    an all-invalid cloud (zeros); bit-equal on a second call and on the
    marked indices; one launch counted a call."""
    pos, mask = _sorted_cloud(3, n, cuda_device, 9)
    idx, _, nv = knn_graph(pos, mask, k, window=2048)
    nv = nv.clone()
    nv[:, ::7, k // 2:] = False
    nv[2] = False
    before = rel_stats.launches
    got, again = rel_stats(pos, idx, nv), rel_stats(pos, idx, nv)
    marked = rel_stats(pos, idx, nv, idx_with_invalid(idx, nv))
    want = rel_stats_plain(pos.double(), idx, nv)
    torch.cuda.synchronize()
    assert rel_stats.launches == before + 3
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(got, got.transpose(1, 2))
    assert (got[2] == 0).all() and (got[:, 11:] == 0).all()
    assert got[0, 10, 10] == nv[0].sum()
    assert torch.equal(got, again) and torch.equal(got, marked)


def k6_args(dev, c_in, k, seed, n):
    """The inputs of a K6 case: (x, pos, idx, nv, a_hat, c_hat, gamma, beta,
    att_w, gout)."""
    pos, mask, idx, nv = _lfa_graph(dev, k, seed, n)
    g = torch.Generator(device=dev).manual_seed(100 * c_in + seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    x = rnd(2, n, c_in)
    a_hat, c_hat = rnd(c_in, 10, scale=0.3), rnd(c_in, scale=0.3)
    gamma, beta = 1.0 + rnd(c_in, scale=0.2), rnd(c_in, scale=0.2)
    att_w = rnd(2 * c_in, 2 * c_in, scale=(2 * c_in) ** -0.5)
    gout = rnd(2, n, 2 * c_in)
    return x, pos, idx, nv, a_hat, c_hat, gamma, beta, att_w, gout


@pytest.mark.parametrize("c_in,k,seed,n", LFA_CASES)
def test_k6_matches_plain(cuda_device, c_in, k, seed, n):
    """Against the plain version in float64: dx within 1e-4 of scale;
    d(att_w) and the BN sums within 1e-3, as they cancel heavily (sums over
    ~1e5 edges of terms up to ~1e3 times their total); bit-equal on a
    second call."""
    args = k6_args(cuda_device, c_in, k, seed, n)
    idx, nv = args[2], args[3]
    inv = inverse_map(idx, nv, n)
    before = lfa_train_bwd.launches
    got = lfa_train_bwd(*args[:4], inv, *args[4:])
    again = lfa_train_bwd(*args[:4], inv, *args[4:])
    want = lfa_train_bwd_plain(*(a.double() if a.is_floating_point() else a for a in args))
    torch.cuda.synchronize()
    assert lfa_train_bwd.launches == before + 2
    for a, b, tol in zip(got, want, (1e-4, 1e-3, 1e-3)):
        assert (a - b).abs().max() <= tol * b.abs().max()
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_runs_its_kernels(cuda_device, fused):
    """One train step per route: finite loss, and K4 (two gathers a block)
    or K4 (the dx scatter of every LFA), K5 (once per block) and K6 (once
    per LFA) launched; the inverse map once per block on both."""
    torch.manual_seed(0)
    model = build_model("RandLANet", {"num_features": 9, "num_classes": 7, "knn_window": 4608,
                                      "sort_inputs": True, "fused_train_lfa": fused})
    model.to(cuda_device)
    pos, mask = _sorted_cloud(2, 4096, cuda_device, 11)
    pos = pos[:, torch.randperm(4096, device=cuda_device)]   # the model sorts
    x = torch.rand((2, 4096, 9), device=cuda_device)
    y = torch.randint(0, 7, (2, 4096), device=cuda_device).masked_fill(~mask, 65)
    counters = (gather_bwd, rel_stats, lfa_train_bwd, inverse_map)
    before = [f.launches for f in counters]
    loss, logits = model.train_step(x, pos, y, mask,
                                    torch.Generator(device=cuda_device).manual_seed(0))
    torch.cuda.synchronize()
    assert torch.isfinite(loss) and logits.shape == (2, 4096, 7)
    assert [f.launches - b for f, b in zip(counters, before)] == ([8, 4, 8, 4] if fused
                                                                  else [8, 0, 0, 4])


def _card_train_model(cuda_device, b=4, n=4096, **kw):
    torch.manual_seed(0)
    model = build_model("RandLANet", {"num_features": 9, "num_classes": 7, "knn_window": 4608,
                                      "sort_inputs": True, "fused_train_lfa": True}, **kw)
    model.to(cuda_device)
    model.init_train_state()
    pos, mask = _sorted_cloud(b, n, cuda_device, 12)
    x = torch.rand((b, n, 9), device=cuda_device)
    y = torch.randint(0, 7, (b, n), device=cuda_device).masked_fill(~mask, 65)
    return model, (x, pos, y, mask)


def test_finetune_step_runs_its_kernels(cuda_device):
    """A finetune step at epoch 0 on the fused route: the last FC moves,
    every other parameter stays bit-equal (its group at ``lr_mult`` 0); K4,
    K5 and K6 launched."""
    from myria3d_tpu_torch.callbacks.finetuning_callbacks import FinetuningFreezeUnfreeze

    model, batch = _card_train_model(cuda_device)
    model.init_train_state(per_module=True)
    model.set_lr_mult(FinetuningFreezeUnfreeze().lr_mult_for_epoch(model.net, 0))
    before = {k: p.detach().clone() for k, p in model.net.named_parameters()}
    counters = (gather_bwd, rel_stats, lfa_train_bwd)
    start = [f.launches for f in counters]
    loss, _ = model.train_step(*batch, torch.Generator(device=cuda_device).manual_seed(0))
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert all(f.launches > s for f, s in zip(counters, start))
    for k, p in model.net.named_parameters():
        assert torch.equal(p, before[k]) != k.startswith("fc_classif."), k


def test_microbatched_step_runs_its_kernels(cuda_device):
    """B=4 at ``grad_microbatch=2`` on the fused route: each chunk launches
    what a step does (K4 8, K5 4, K6 8), the loss is the chunks' mean and
    the BN running stats the mean of the chunks' (within 1e-6 relative)."""
    from myria3d_tpu_torch.models.model import chunk_generator

    model, (x, pos, y, mask) = _card_train_model(cuda_device, grad_microbatch=2)
    stats = [t for t in model.net.buffers()]
    start = [t.clone() for t in stats]
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    counters = (gather_bwd, rel_stats, lfa_train_bwd)
    before = [f.launches for f in counters]
    loss, logits = model.grad_step(x, pos, y, mask, gen)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [16, 8, 16]
    got = [t.clone() for t in stats]
    losses, chunk_stats = [], []
    with torch.no_grad():
        for i in range(2):
            for t, s in zip(stats, start):
                t.copy_(s)
            out = model.net(x[2 * i:2 * i + 2], pos[2 * i:2 * i + 2], mask[2 * i:2 * i + 2],
                            chunk_generator(gen, i))
            losses.append(model.criterion(out, y[2 * i:2 * i + 2]))
            chunk_stats.append([t.clone() for t in stats])
    assert float((loss - (losses[0] + losses[1]) / 2).abs()) <= 1e-5 * float(loss.abs())
    assert logits.shape == (4, 4096, 7)
    for t, a, b in zip(got, *chunk_stats):
        want = (a + b) / 2
        assert float((t - want).abs().max()) <= 1e-6 * float(want.abs().max())


# (B, N, m): each instantiation the route rule takes (1 to 14 points a
# thread, clusters of 1 to 8 CTAs), the largest bucket and the largest cloud
FPS_CASES = [(3, 150, 40), (3, 700, 175), (3, 1500, 375), (2, 4000, 1000), (2, 8192, 2048),
             (2, 12288, 3072), (2, 20000, 5000), (2, 30000, 7500), (16, 40960, 10240),
             (2, 49152, 1024)]


def _fps_clouds(b, n, m, grid=None, prefix=True, seed=0):
    """Cloud 0 all pads, cloud 1 with fewer valid points than m, pads
    holding garbage; ``grid`` snaps positions to make exact ties;
    ``prefix=False`` scatters the valid points over the slots."""
    g = torch.Generator().manual_seed(n + seed)
    pos = torch.rand((b, n, 3), generator=g) * 2 - 1
    if grid:
        pos = torch.round(pos / grid) * grid
    if prefix:
        counts = torch.tensor([0, m // 2] + [n - 7] * (b - 2))
        mask = torch.arange(n)[None, :] < counts[:, None]
    else:
        mask = torch.rand((b, n), generator=g) < 0.7
        mask[0] = False
        mask[1] = False
        mask[1, torch.randperm(n, generator=g)[:m // 2]] = True
    pos[~mask] = 1e3
    return pos, mask


def _check_k8(pos, mask, m, route=None):
    from myria3d_tpu_torch.ops import cuda_fps

    before = fps.launches
    if route is None:
        idx, new_mask = fps(pos, mask, m)
        assert fps.launches == before + 1
    else:
        idx, new_mask = cuda_fps.launch(pos, mask, m, route)
    torch.cuda.synchronize()
    want_idx, want_mask = farthest_point_sampling_plain(pos, mask, m)
    assert torch.equal(new_mask, want_mask)
    assert torch.equal(idx, want_idx)
    return new_mask


@pytest.mark.parametrize("b,n,m", FPS_CASES)
@pytest.mark.parametrize("grid", [None, 0.05])
def test_k8_matches_plain(cuda_device, b, n, m, grid):
    pos, mask = _fps_clouds(b, n, m, grid)
    new_mask = _check_k8(pos.to(cuda_device), mask.to(cuda_device), m)
    assert new_mask.sum(1).tolist() == [0, m // 2] + [min(m, n - 7)] * (b - 2)


@pytest.mark.parametrize("b,n,m", [(3, 1500, 375), (4, 12288, 3072), (16, 40960, 10240)])
def test_k8_matches_plain_on_a_mask_that_is_no_prefix(cuda_device, b, n, m):
    pos, mask = _fps_clouds(b, n, m, prefix=False)
    _check_k8(pos.to(cuda_device), mask.to(cuda_device), m)


@pytest.mark.parametrize("repeat", [2, 8])
def test_k8_matches_plain_on_duplicate_points(cuda_device, repeat):
    """Every point repeated, so that once the distinct ones run out every
    round ties at 0, and a cloud of one position."""
    g = torch.Generator().manual_seed(repeat)
    n, m = 6144, 3072
    base = torch.rand((3, n // repeat, 3), generator=g) * 2 - 1
    pos = base.repeat_interleave(repeat, dim=1)[:, torch.randperm(n, generator=g)]
    pos[2] = 0.5
    mask = torch.ones((3, n), dtype=torch.bool)
    _check_k8(pos.contiguous().to(cuda_device), mask.to(cuda_device), m)


@pytest.mark.parametrize("sort", [True, False])
def test_k8_matches_plain_on_x_sorted_and_unsorted_clouds(cuda_device, sort):
    """Clouds shaped as subtiles (50 m by 50 m by 10 m in normalized
    units), x-sorted as ``SortPointsByX`` leaves sa1's input, or not: the
    box skip takes the sorted ones."""
    g = torch.Generator().manual_seed(11)
    b, n, m = 8, 12288, 3072
    pos = torch.rand((b, n, 3), generator=g) * torch.tensor([2.0, 2.0, 0.4]) - 1
    if sort:
        pos = pos.gather(1, pos[..., 0].argsort(dim=1)[..., None].expand(-1, -1, 3))
    mask = torch.arange(n)[None, :] < torch.tensor([n, n - 1000, 5000, 3000, n, n, 100, n])[:, None]
    _check_k8(pos.contiguous().to(cuda_device), mask.to(cuda_device), m)


@pytest.mark.parametrize("cluster", range(1, 9))
@pytest.mark.parametrize("skip", [False, True])
def test_k8_matches_plain_on_every_cluster_size(cuda_device, cluster, skip):
    """One cloud split over 1 to 8 CTAs, with and without the box skip, the
    threads and points a thread as the rule sizes a CTA's share."""
    from myria3d_tpu_torch.ops import cuda_fps

    b, n, m = 4, 6144, 1536
    share = -(-n // cluster)
    threads = min(cuda_fps.MAX_THREADS, max(32, cuda_fps._pow2_at_least(-(-share // 6))))
    pt = next(p for p in cuda_fps.PTS if threads * p >= share)
    pos, mask = _fps_clouds(b, n, m, grid=0.05)
    _check_k8(pos.to(cuda_device), mask.to(cuda_device), m,
              cuda_fps.Route(threads, pt, cluster, skip))


def test_k8_routes_every_cluster_resident(cuda_device):
    """At each of phase 16a's shapes, B=16 at 40960 points included, every
    cluster the rule asks for fits on the card at once
    (``cudaOccupancyMaxActiveClusters``): no cloud waits for a second
    wave."""
    from myria3d_tpu_torch.ops import cuda_fps

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for b, n in [(16, 12288), (48, 12288), (16, 3072), (48, 3072), (16, 768), (48, 768),
                 (16, 192), (48, 192), (16, 40960)]:
        rt = cuda_fps.route(b, n, sms)
        assert cuda_fps.max_active_clusters(rt) >= b, (b, n, rt)


def test_k8_refuses_clouds_past_its_limit(cuda_device):
    pos = torch.zeros((1, MAX_N + 1, 3), device=cuda_device)
    with pytest.raises(ValueError, match="exceed"):
        fps(pos, torch.ones((1, MAX_N + 1), dtype=torch.bool, device=cuda_device), 4)


def test_pointnet2_train_step_runs_its_kernels(cuda_device):
    """A narrow PointNet++ train step on the card launches K8 four times (a
    set abstraction each), K1 eight times (four ball queries, four k=3
    searches) and K4 eight times (the gathers' VJP); its gradients are
    finite and bit-identical from run to run."""
    from myria3d_tpu_torch.ops.cuda_knn import knn_topk

    torch.manual_seed(0)
    model = build_model("PointNet2", {"num_features": 9, "num_classes": 7,
                                      "widths": (16, 32, 64, 128)}).to(cuda_device)
    model.net.head.dropout = [0.0]
    model.init_train_state()
    g = torch.Generator().manual_seed(1)
    pos = (torch.rand((2, 4096, 3), generator=g) * 2 - 1).to(cuda_device)
    x = torch.rand((2, 4096, 9), generator=g).to(cuda_device)
    y = torch.randint(0, 7, (2, 4096), generator=g).to(cuda_device)
    mask = (torch.arange(4096)[None, :] < torch.tensor([[4096], [3000]])).to(cuda_device)
    grads = []
    for _ in range(2):
        before = [f.launches for f in (fps, knn_topk, gather_bwd)]
        model.optimizer.zero_grad(set_to_none=True)
        model.grad_step(x, pos, y, mask)
        torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip((fps, knn_topk, gather_bwd), before)] == [4, 8, 8]
        grads.append(torch.cat([p.grad.flatten() for p in model.net.parameters()]))
    assert bool(torch.isfinite(grads[0]).all()) and torch.equal(grads[0], grads[1])


# PointNet++'s searches at full scale: the stages 12288 -> 3072 -> 768 ->
# 192 -> 48 with their radii, x-sorted subtiles in normalized units (as
# predict's sa1 takes them), the last cloud half padding
PN2_STAGES, PN2_RADII = (12288, 3072, 768, 192, 48), (0.05, 0.1, 0.2, 0.4)


def _pn2_searches(b, stage, dev, seed=0):
    """(queries, keys, query mask, r2) of stage ``stage``'s ball query
    (centroids into the stage's cloud) and k=3 search (the cloud into its
    centroids), centred and pad-augmented."""
    from myria3d_tpu_torch.ops.knn import ball_r2, gather_rows

    g = torch.Generator().manual_seed(seed)
    n = PN2_STAGES[0]
    pos = torch.rand((b, n, 3), generator=g) * torch.tensor([2.0, 2.0, 0.4]) \
        - torch.tensor([1.0, 1.0, 1.0])
    pos = torch.take_along_dim(pos, pos[..., :1].argsort(dim=1), dim=1).to(dev)
    mask = torch.ones((b, n), dtype=torch.bool)
    mask[-1, n // 2:] = False
    mask = mask.to(dev)
    for m in PN2_STAGES[1:stage + 2]:
        cloud = (pos, mask)
        sel, mask = fps(pos, mask, m)
        pos = gather_rows(pos, sel)
    (p, v), (c, cm) = cloud, (pos, mask)
    ball = centred_clouds(c, p, v) + (cm,)
    k3 = centred_clouds(p, c, cm) + (v,)
    return ball, k3, ball_r2(PN2_RADII[stage])


@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("b", [16, 48])
def test_ball_route_matches_plain(cuda_device, b, stage):
    """The ball route (x-ordered tiles above one tile of centroids, lists
    from r^2, masked centroids skipped) bit-equal to its plain version, and its valid slots those of
    the generic list's 32 nearest filtered by the radius."""
    from myria3d_tpu_torch.ops.cuda_knn import ball_route

    (q4, k4, qm), _, r2 = _pn2_searches(b, stage, cuda_device)
    before = ball_route.launches
    idx, d2 = knn_topk(q4, k4, 32, query_mask=qm, r2=r2)
    assert ball_route.launches == before + 1
    pidx, pd2 = knn_topk_plain(q4, k4, 32, query_mask=qm, r2=r2)
    assert torch.equal(idx, pidx) and torch.equal(d2, pd2)
    gidx, gd2 = knn_topk(q4, k4, 32)
    inside = (gd2 <= r2) & qm[..., None]
    assert torch.equal(idx >= 0, inside)
    assert torch.equal(torch.where(inside, gidx, -1), idx)
    assert 0 < float(inside.float().mean()) < 1


@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("b", [16, 48])
def test_small_list_matches_the_generic_list(cuda_device, b, stage):
    """The 4-slot list at k = 3 bit-equal to the generic
    32-slot list's first 3 and to the plain version; k = 2 and 4 too."""
    from myria3d_tpu_torch.ops.cuda_knn import launch, small_list

    _, (q4, k4, qm), _ = _pn2_searches(b, stage, cuda_device)
    for k in (2, 3, 4):
        before = small_list.launches
        idx, d2 = knn_topk(q4, k4, k, query_mask=qm)
        assert small_list.launches == before + 1
        gidx, gd2 = launch(q4, k4, k, list_k=32)
        assert torch.equal(idx, gidx) and torch.equal(d2, gd2)
    pidx, pd2 = knn_topk_plain(q4, k4, 4, query_mask=qm)
    assert torch.equal(idx, pidx) and torch.equal(d2, pd2)


@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("b", [16, 48])
def test_shuffled_query_rows_give_the_same_rows_shuffled(cuda_device, b, stage):
    """Both routes (the ball route walking its centroids in x order, the
    4-slot list in row order) give a query the same neighbours wherever
    its row lies: the queries and their mask shuffled per cloud give the
    same rows of output, shuffled alike."""
    (bq, bk, bm), (q4, k4, qm), r2 = _pn2_searches(b, stage, cuda_device)
    for (q, k, m), kk, radius in (((bq, bk, bm), 32, r2), ((q4, k4, qm), 3, None)):
        g = torch.Generator().manual_seed(stage)
        perm = torch.stack([torch.randperm(q.shape[1], generator=g)
                            for _ in range(b)]).to(cuda_device)
        want = knn_topk(q, k, kk, query_mask=m, r2=radius)
        got = knn_topk(torch.take_along_dim(q, perm[..., None], dim=1).contiguous(), k, kk,
                       query_mask=torch.take_along_dim(m, perm, dim=1), r2=radius)
        for a, w in zip(got, want):
            assert torch.equal(a, torch.take_along_dim(w, perm[..., None], dim=1))


@pytest.mark.parametrize("b", [16, 48])
def test_randla_net_steps_take_none_of_the_pointnet2_routes(cuda_device, monkeypatch, b):
    """RandLA-Net's train step and eval forward at B=16 and 48 (N=12288)
    each launch K1's K = 16 list four times (the encoder) and its k = 1
    list four times (the decoder), the 8 K1 launches a step of
    chip_smoke.py's phases 5 and 8, and neither the ball route nor the
    4-slot list."""
    from collections import Counter

    from myria3d_tpu_torch.ops import cuda_knn

    calls = Counter()
    real = cuda_knn.launch

    def spy(q4, k4, k, window=0, query_mask=None, r2=None, list_k=None):
        calls[(k, r2, list_k)] += 1
        return real(q4, k4, k, window, query_mask, r2, list_k)

    monkeypatch.setattr(cuda_knn, "launch", spy)
    model, (x, pos, y, mask) = _card_train_model(cuda_device, b=b, n=12288)
    before = (cuda_knn.ball_route.launches, cuda_knn.small_list.launches, knn_topk.launches)
    want = Counter({(16, None, None): 4, (1, None, None): 4})
    model.train_step(x, pos, y, mask, torch.Generator(device=cuda_device).manual_seed(0))
    assert calls == want
    calls.clear()
    model.net.eval()
    with torch.inference_mode():
        model.net(x, pos, mask)
    torch.cuda.synchronize()
    assert calls == want
    assert (cuda_knn.ball_route.launches, cuda_knn.small_list.launches) == before[:2]
    assert knn_topk.launches == before[2] + 16
