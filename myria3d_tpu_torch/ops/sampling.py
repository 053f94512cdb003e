"""Random decimation with static shapes.

Port of ``myria3d_tpu/ops/sampling.py:28``: uniform noise per point, pads
pushed to -inf, the top ``N // decimation`` draws give a uniform random
subset of the valid points; each cloud keeps ``max(1, valid // decimation)``
slots (never emptied). Draws come from an explicit ``torch.Generator`` on
the mask's device.
"""

from __future__ import annotations

import torch


def random_decimation(mask: torch.Tensor, decimation: int,
                      generator: torch.Generator | None = None):
    """Pick a random ``1 / decimation`` subset of each cloud's valid points.

    Returns ``idx (B, N // decimation) int64`` into the N axis, in ASCENDING
    order, and ``new_mask (B, N // decimation) bool``. Ascending order keeps
    an x-sorted cloud x-sorted through every stage, which the windowed
    searches of the later stages rely on (``sampling.py:52-64``).
    """
    if decimation < 1:
        raise ValueError(
            "Argument `decimation` should be >= 1 for downsampling. "
            f"(Current value: {decimation})"
        )
    b, n = mask.shape
    n_out = n // decimation
    noise = torch.rand((b, n), generator=generator, device=mask.device)
    noise = torch.where(mask, noise, float("-inf"))
    idx = noise.topk(n_out, dim=1).indices                  # valid points first
    valid_counts = mask.sum(dim=1)
    kept = torch.where(valid_counts > 0, (valid_counts // decimation).clamp(min=1), 0)
    new_mask = torch.arange(n_out, device=mask.device)[None, :] < kept[:, None]
    idx = torch.where(new_mask, idx, n).sort(dim=1).values
    return torch.where(new_mask, idx, 0), new_mask
