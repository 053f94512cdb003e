"""The predict step: RandLA-Net eval forward + full-cloud interpolation.

Port of ``myria3d_tpu/models/model.py:366-398`` (``build_interp_step``):
the net runs on the sampled points, then the k-NN interpolation carries
its logits back to every raw point of each subtile, and the result ships
as f16 (the host merge upcasts).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from myria3d_tpu_torch.models.modules.randla_net import RandLANet
from myria3d_tpu_torch.ops.cuda_knn import stage_window
from myria3d_tpu_torch.ops.interpolate import knn_interpolate

# JAX hparams that only steer training or TPU routing; the eval forward
# does not depend on them
_IGNORED_NET_HPARAMS = {"remat", "fused_train_lfa", "sort_inputs", "exact_knn"}


def build_net(neural_net_class_name: str, neural_net_hparams: Dict[str, Any]) -> nn.Module:
    if neural_net_class_name != "RandLANet":
        raise NotImplementedError(
            f"{neural_net_class_name} is not ported yet (RandLANet only)"
        )
    hp = {k: v for k, v in neural_net_hparams.items() if k not in _IGNORED_NET_HPARAMS}
    dtype = hp.pop("dtype", None)
    if dtype not in (None, "float32"):
        raise NotImplementedError(f"compute dtype {dtype!r} is not ported yet")
    # the window is a predict-time choice (``Model.set_sorted_window``): a
    # checkpoint trained with in-model sorting carries one, but the port
    # only windows clouds the predict pipeline has x-sorted
    hp.pop("knn_window", None)
    if not hp.pop("return_logits", True):
        raise NotImplementedError("log-softmax outputs are not ported")
    return RandLANet(**hp)


class Model(nn.Module):
    """Segmentation model for the predict path (reference ``Model``)."""

    def __init__(self, net: RandLANet, interpolation_k: int = 10):
        super().__init__()
        self.net = net
        self.interpolation_k = int(interpolation_k)

    def set_sorted_window(self, window: int) -> None:
        """Window every search (the encoder graphs, the decoder's k=1
        upsampling and the full-cloud interpolation) to ~``window`` sorted
        key positions per 256-query tile. Requires x-sorted clouds (the
        predict pipeline appends ``SortPointsByX``); 0 is a full scan."""
        self.net.knn_window = int(window)

    @torch.inference_mode()
    def interp_step(self, x, pos, mask, sampled_pos, full_pos, full_mask,
                    generator: torch.Generator | None = None) -> torch.Tensor:
        """Forward on the sampled points, then k-NN interpolation of the
        logits onto the full clouds: ``(B, M, num_classes)`` float16."""
        logits = self.net(x, pos, mask, generator)
        full = knn_interpolate(
            logits, sampled_pos, mask, full_pos, full_mask,
            k=self.interpolation_k, fused_payload=True,
            # density-scaled by the sampled (key) cloud's count
            window=stage_window(self.net.knn_window, sampled_pos.shape[1]),
        )
        return full.to(torch.float16)
