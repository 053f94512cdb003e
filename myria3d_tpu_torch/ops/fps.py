"""Masked farthest-point sampling with a static output shape.

Port of ``myria3d_tpu/ops/fps.py``, the sampling of the PointNet++ family's
set abstraction: ``m`` slots a cloud, the first the cloud's first valid
point, each next the valid point farthest from those chosen; pads are never
chosen while a valid point remains and slots past the valid count are
masked. The scan runs in K8 (``ops.cuda_fps``) on the card.
"""

from __future__ import annotations

import torch

from myria3d_tpu_torch.ops.cuda_fps import fps


def farthest_point_sampling(pos: torch.Tensor, mask: torch.Tensor, m: int):
    """Select ``m`` spread-out valid points of each cloud.

    Returns ``idx (B, m) int32`` indices into the N axis and ``new_mask
    (B, m) bool`` (slot < valid point count); masked slots hold index 0.
    """
    return fps(pos.contiguous(), mask.contiguous(), m)
