"""The CUDA kernels K1-K6 against their plain PyTorch versions on the
card (skipped where there is no CUDA device; ``chip_smoke.py`` runs the
same comparisons at the predict and train steps' full shapes).

Tolerances: K1 shares the plain version's arithmetic order, so indices and
d2 are equal; K2 sums in another order (1e-4 of the output's scale); K3
divides the same f32 sums (1e-5); K4 sums the same f32 terms in another
order (1e-5); K5 and K6 are held to their plain versions in float64
(K5 1e-5; K6 recomputes the forward and sums over every edge: 1e-4 on dx,
1e-3 on the heavily cancelling d(att_w) and BN sums).
"""

import numpy as np
import pytest
import torch

from myria3d_tpu_torch.models.model import Model, build_model, build_net
from myria3d_tpu_torch.ops.cuda_gather import gather_bwd, gather_bwd_plain, inverse_map
from myria3d_tpu_torch.ops.cuda_interp import knn_interp, knn_interp_plain
from myria3d_tpu_torch.ops.cuda_knn import knn_topk, knn_topk_plain
from myria3d_tpu_torch.ops.cuda_lfa import lfa_attention, lfa_attention_plain
from myria3d_tpu_torch.ops.cuda_lfa_train import (
    lfa_train_bwd,
    lfa_train_bwd_plain,
    rel_stats,
    rel_stats_plain,
)
from myria3d_tpu_torch.ops.knn import centred_clouds, knn_graph

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


def _sorted_cloud(b, n, dev, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    p = torch.rand((b, n, 3), generator=g) * torch.tensor([50.0, 50.0, 10.0])
    p = torch.take_along_dim(p, p[..., :1].argsort(dim=1), dim=1)
    mask = torch.ones((b, n), dtype=torch.bool)
    mask[1:, n - n // 5:] = False
    return p.to(dev), mask.to(dev)


@pytest.mark.parametrize("k,window,nq,nk", [(16, 2048, 4096, 4096), (1, 2048, 8192, 4096),
                                            (1, 0, 768, 192), (10, 0, 1000, 300)])
def test_k1_matches_plain(cuda_device, k, window, nq, nk):
    qp, qm = _sorted_cloud(2, nq, cuda_device, 1)
    kp, km = _sorted_cloud(2, nk, cuda_device, 2)
    q4, k4 = centred_clouds(qp, kp, km)
    before = knn_topk.launches
    idx, d2 = knn_topk(q4, k4, k, window=window, query_mask=qm)
    assert knn_topk.launches == before + 1
    pidx, pd2 = knn_topk_plain(q4, k4, k, window=window, query_mask=qm)
    torch.cuda.synchronize()
    assert torch.equal(d2, pd2)
    assert torch.equal(idx, pidx)


@pytest.mark.parametrize("c_in", [4, 32, 128])
def test_k2_matches_plain(cuda_device, c_in):
    pos, mask = _sorted_cloud(2, 3072, cuda_device, 3)
    idx, _, nv = knn_graph(pos, mask, 16, window=2048)
    g = torch.Generator(device=cuda_device).manual_seed(c_in)
    x = torch.rand((2, 3072, c_in), generator=g, device=cuda_device) * 2 - 1
    enc_a = torch.randn((c_in, 10), generator=g, device=cuda_device) * 0.3
    enc_c = torch.randn((c_in,), generator=g, device=cuda_device) * 0.3
    att_w = torch.randn((2 * c_in, 2 * c_in), generator=g, device=cuda_device) / (2 * c_in) ** 0.5
    args = (x, pos, idx, nv, enc_a, enc_c, att_w)
    got, want = lfa_attention(*args), lfa_attention_plain(*args)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_k3_matches_plain(cuda_device):
    kp, km = _sorted_cloud(2, 3072, cuda_device, 4)
    qp, qm = _sorted_cloud(2, 8192, cuda_device, 5)
    q4, k4 = centred_clouds(qp, kp, km)
    x = torch.randn((2, 3072, 7), device=cuda_device) * 3
    got = knn_interp(x, q4, k4, 10, window=2048, query_mask=qm)
    want = knn_interp_plain(x, q4, k4, 10, window=2048, query_mask=qm)
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


@pytest.mark.parametrize("p", [7, 36, 64])
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


def test_k5_matches_plain(cuda_device):
    """Against the plain version in float64: K5's f32 sums of ~1e5 positive
    products stay within 1e-5 of scale."""
    pos, mask, idx, nv = _graph(2, 4096, 16, cuda_device, 9)
    got, want = rel_stats(pos, idx, nv), rel_stats_plain(pos.double(), idx, nv)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(got, got.transpose(1, 2))


@pytest.mark.parametrize("c_in", [4, 32, 128])
def test_k6_matches_plain(cuda_device, c_in):
    """Against the plain version in float64: dx within 1e-4 of scale;
    d(att_w) and the BN sums within 1e-3, as they cancel heavily (sums over
    ~1e5 edges of terms up to ~1e3 times their total)."""
    pos, mask, idx, nv = _graph(2, 3072, 16, cuda_device, 10)
    g = torch.Generator(device=cuda_device).manual_seed(c_in)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=cuda_device) * scale

    x = rnd(2, 3072, c_in)
    a_hat, c_hat = rnd(c_in, 10, scale=0.3), rnd(c_in, scale=0.3)
    gamma, beta = 1.0 + rnd(c_in, scale=0.2), rnd(c_in, scale=0.2)
    att_w = rnd(2 * c_in, 2 * c_in, scale=(2 * c_in) ** -0.5)
    gout = rnd(2, 3072, 2 * c_in)
    args = (x, pos, idx, nv, a_hat, c_hat, gamma, beta, att_w, gout)
    before = lfa_train_bwd.launches
    got = lfa_train_bwd(*args[:4], inverse_map(idx, nv, 3072), *args[4:])
    want = lfa_train_bwd_plain(*(a.double() if a.is_floating_point() else a for a in args))
    torch.cuda.synchronize()
    assert lfa_train_bwd.launches == before + 1
    for a, b, tol in zip(got, want, (1e-4, 1e-3, 1e-3)):
        assert (a - b).abs().max() <= tol * b.abs().max()


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_runs_its_kernels(cuda_device, fused):
    """One train step per route: finite loss, and K4 (two gathers a block)
    or K5 + K6 (once per LFA) launched."""
    torch.manual_seed(0)
    model = build_model("RandLANet", {"num_features": 9, "num_classes": 7, "knn_window": 4608,
                                      "sort_inputs": True, "fused_train_lfa": fused})
    model.to(cuda_device)
    pos, mask = _sorted_cloud(2, 4096, cuda_device, 11)
    pos = pos[:, torch.randperm(4096, device=cuda_device)]   # the model sorts
    x = torch.rand((2, 4096, 9), device=cuda_device)
    y = torch.randint(0, 7, (2, 4096), device=cuda_device).masked_fill(~mask, 65)
    counters = (gather_bwd, rel_stats, lfa_train_bwd)
    before = [f.launches for f in counters]
    loss, logits = model.train_step(x, pos, y, mask,
                                    torch.Generator(device=cuda_device).manual_seed(0))
    torch.cuda.synchronize()
    assert torch.isfinite(loss) and logits.shape == (2, 4096, 7)
    assert [f.launches - b for f, b in zip(counters, before)] == ([0, 8, 8] if fused else [8, 0, 0])
