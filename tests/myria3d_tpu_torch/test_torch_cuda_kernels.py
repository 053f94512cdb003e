"""The CUDA kernels K1, K2, K3 against their plain PyTorch versions on the
card (skipped where there is no CUDA device; ``chip_smoke.py`` runs the
same comparisons at the predict step's full shapes).

Tolerances: K1 shares the plain version's arithmetic order, so indices and
d2 are equal; K2 sums in another order (1e-4 of the output's scale); K3
divides the same f32 sums (1e-5).
"""

import numpy as np
import pytest
import torch

from myria3d_tpu_torch.models.model import Model, build_net
from myria3d_tpu_torch.ops.cuda_interp import knn_interp, knn_interp_plain
from myria3d_tpu_torch.ops.cuda_knn import knn_topk, knn_topk_plain
from myria3d_tpu_torch.ops.cuda_lfa import lfa_attention, lfa_attention_plain
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
