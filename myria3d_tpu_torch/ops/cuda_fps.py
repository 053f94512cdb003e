"""K8: masked farthest-point sampling (``csrc/fps.cu``) and its plain
PyTorch version.

Replaces ``myria3d_tpu/ops/fps.py:25-57``, a ``lax.scan`` over the m output
slots that XLA runs as one on-device loop (no Pallas kernel). In plain
PyTorch the scan is a host loop of a few launches a round, some 20,000 a
PointNet++ forward at N=12288; the kernel runs the whole scan in one launch,
one block of 1024 threads per cloud. Indices and masks are bit-equal to the
plain version: the kernel sums the squared differences in the plain
version's association, ``(dx*dx + dy*dy) + dz*dz`` with no FMA.

Clouds of up to :data:`MAX_REG_POINTS` * 1024 points keep their coordinates
and running distances in registers; up to :data:`MAX_N` points the
distances live in shared memory; a larger cloud raises.
"""

from __future__ import annotations

import torch

from myria3d_tpu_torch import _ext

THREADS = 1024       # one block a cloud
MAX_REG_POINTS = 12  # points a thread keeps in registers
MAX_N = 49152        # the largest cloud (its running distances in shared memory)
FAR = 1e30           # the starting distance of a valid point (fps.py:23)


def _check(pos: torch.Tensor, mask: torch.Tensor, m: int) -> None:
    if pos.dim() != 3 or pos.shape[-1] != 3 or mask.shape != pos.shape[:2]:
        raise ValueError("pos must be (B, N, 3) and mask (B, N)")
    if pos.dtype != torch.float32 or mask.dtype != torch.bool:
        raise ValueError("pos must be float32 and mask bool")
    if m < 1:
        raise ValueError(f"m={m} must be at least 1")


def farthest_point_sampling_plain(pos: torch.Tensor, mask: torch.Tensor, m: int):
    """Plain PyTorch version of K8: the ``lax.scan`` of ``fps.py`` step for
    step, one round per output slot. Returns ``idx (B, m) int32`` and
    ``new_mask (B, m) bool``."""
    _check(pos, mask, m)
    b, n, _ = pos.shape
    last = mask.to(torch.uint8).argmax(dim=1)                  # first valid point, else 0
    mind = torch.where(mask, FAR, -1.0).to(torch.float32)
    rows = torch.arange(b, device=pos.device)
    picked = []
    for _ in range(m):
        picked.append(last)
        lp = pos[rows, last]                                    # (B, 3)
        dx, dy, dz = (pos[..., c] - lp[:, c, None] for c in range(3))
        d = (dx * dx + dy * dy) + dz * dz
        mind = torch.minimum(mind, torch.where(mask, d, -1.0))
        last = mind.argmax(dim=1)                               # ties: the lower index
    idx = torch.stack(picked, dim=1).to(torch.int32)
    count = mask.sum(dim=1).clamp(max=m)
    new_mask = torch.arange(m, device=pos.device)[None, :] < count[:, None]
    return torch.where(new_mask, idx, 0), new_mask


def fps(pos: torch.Tensor, mask: torch.Tensor, m: int):
    """``m`` spread-out valid points of each cloud: ``idx (B, m) int32``
    (starting from the first valid point) and ``new_mask (B, m) bool``
    (slot < valid count). CPU tensors take
    :func:`farthest_point_sampling_plain`; CUDA tensors launch the kernel
    (or raise)."""
    if pos.device.type == "cpu":
        return farthest_point_sampling_plain(pos, mask, m)
    _check(pos, mask, m)
    b, n, _ = pos.shape
    if n > MAX_N:
        raise ValueError(f"fps: clouds of {n} points exceed the kernel's {MAX_N}")
    _ext.require_cuda("fps", pos, mask)
    idx = torch.empty((b, m), dtype=torch.int32, device=pos.device)
    new_mask = torch.empty((b, m), dtype=torch.bool, device=pos.device)
    if b * n == 0:
        return idx.zero_(), new_mask.zero_()
    with torch.cuda.device(pos.device):
        code = _ext.lib().m3d_fps(pos.data_ptr(), mask.data_ptr(), b, n, m, idx.data_ptr(),
                                  new_mask.data_ptr(), _ext.stream_of(pos))
    _ext.check(code, "m3d_fps")
    fps.launches += 1
    return idx, new_mask


fps.launches = 0
