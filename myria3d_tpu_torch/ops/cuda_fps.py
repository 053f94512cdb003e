"""K8: masked farthest-point sampling (``csrc/fps.cu``) and its plain
PyTorch version.

Replaces ``myria3d_tpu/ops/fps.py:25-57``, a ``lax.scan`` over the m output
slots that XLA runs as one on-device loop (no Pallas kernel). In plain
PyTorch the scan is a host loop of a few launches a round, some 20,000 a
PointNet++ forward at N=12288; the kernel runs the whole scan in one launch.
Indices and masks are bit-equal to the plain version: the kernel sums the
squared differences in the plain version's association, ``(dx*dx + dy*dy)
+ dz*dz`` with no FMA, and breaks ties to the lower index.

The m rounds form a chain (each waits for the last one's argmax), so the
kernel's time is m times a round's: a fixed part (the argmax over the
cloud's threads and one barrier) and a part per point a thread. The route
(:func:`route`, a rule of the batch, the cloud's size and the card's SM
count) sizes both: a thread-block cluster of up to 8 CTAs a cloud, the
threads a CTA and the points a thread (in registers), and the exact
bounding-box skip of a warp's update on clouds past :data:`LARGE` points.
The skip pays only where a warp's points lie close together: predict and
test sort the first set abstraction's input by x (``SortPointsByX``), fit
does not. On the H100 it takes 0.37-0.39 ms a step off K8 in the PointNet++
predict step and adds 0.06-0.10 ms (~3 %) to K8 in the train step (PERF.md).
Clouds of up to :data:`MAX_N` points; a larger cloud raises. A route the
card cannot launch raises through ``_ext.check``; no route falls back to
another.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from myria3d_tpu_torch import _ext

MAX_N = 49152        # the largest cloud (7 CTAs of 512 threads x 14 points hold it)
FAR = 1e30           # the starting distance of a valid point (fps.py:23)
PTS = (1, 2, 3, 4, 6, 8, 12, 14)   # the kernel's instantiations: points a thread
MAX_CLUSTER = 8      # the portable cluster size


class Route(NamedTuple):
    """How K8 runs a batch: ``threads`` a CTA, ``pt`` points a thread, a
    cluster of ``cluster`` CTAs a cloud, ``skip`` the exact bounding-box
    skip of a warp's update."""
    threads: int
    pt: int
    cluster: int
    skip: bool


MAX_THREADS = 512    # threads a CTA (128 registers a thread)


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, (int(v) - 1).bit_length())


# the route rule's constants, from the card's times of every route at phase
# 16a's shapes (scripts/tune_fps.py, PERF.md)
LARGE = 3072           # clouds past this many points: 12 points a thread, the box skip
CTA_POINTS_LARGE = 3072  # a CTA's share of a large cloud (256 threads x 12 points)
CTA_POINTS = 768       # of a smaller one (128 threads x 6 points)
CTAS_PER_SM = 2        # the batch's CTAs an SM may hold before clusters shrink
CTA_POINTS_MOST = MAX_THREADS * PTS[-1]   # the most a CTA holds (one CTA an SM)


def route(b: int, n: int, sms: int) -> Route:
    """The route of a batch of ``b`` clouds of ``n`` points on a card of
    ``sms`` SMs. The cluster size c is the fewest CTAs (a power of two)
    that hold the cloud at :data:`CTA_POINTS_LARGE` points a CTA past
    :data:`LARGE` points, else at :data:`CTA_POINTS`; where that is more
    than 8, c is the fewest CTAs that hold the cloud at
    :data:`CTA_POINTS_MOST` (512 threads, one an SM: six at 40960 points,
    so that B=16 clusters all fit on the H100, whose GPCs hold 15 clusters
    of seven or eight such CTAs and 17 of six). c is halved while the
    batch's CTAs exceed :data:`CTAS_PER_SM` an SM and fewer CTAs still hold
    the cloud. Then the fewest threads (a power of two, 32 to 512) that
    hold a CTA's share at 12 or 6 points a thread, and the fewest
    instantiated points a thread that hold it. The box skip is on past
    :data:`LARGE` points, whatever the order of the points (see the module
    docstring for what it gains and costs)."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"fps: clouds of {n} points exceed the kernel's {MAX_N}")
    large = n > LARGE
    per_cta, per_thread = (CTA_POINTS_LARGE, 12) if large else (CTA_POINTS, 6)
    c = _pow2_at_least(-(-n // per_cta))
    if c > MAX_CLUSTER:
        c = -(-n // CTA_POINTS_MOST)
    while c > 1 and b * c > CTAS_PER_SM * sms and (c // 2) * CTA_POINTS_MOST >= n:
        c //= 2
    share = -(-n // c)
    threads = min(MAX_THREADS, max(32, _pow2_at_least(-(-share // per_thread))))
    pt = next(p for p in PTS if threads * p >= share)
    return Route(threads, pt, c, large)


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def max_active_clusters(rt: Route) -> int:
    """``cudaOccupancyMaxActiveClusters`` of a route on the current device:
    the clusters the card holds at once."""
    import ctypes

    out = ctypes.c_int(0)
    _ext.check(_ext.lib().m3d_fps_max_clusters(rt.threads, rt.pt, rt.cluster,
                                               ctypes.addressof(out)), "m3d_fps_max_clusters")
    return out.value


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


def launch(pos: torch.Tensor, mask: torch.Tensor, m: int, rt: Route):
    """K8 on CUDA tensors along the route ``rt`` (``fps`` takes
    :func:`route`'s; other routes are for measuring them). Does not count
    a launch."""
    _check(pos, mask, m)
    b, n, _ = pos.shape
    if n > MAX_N:
        raise ValueError(f"fps: clouds of {n} points exceed the kernel's {MAX_N}")
    _ext.require_cuda("fps", pos, mask)
    idx = torch.empty((b, m), dtype=torch.int32, device=pos.device)
    new_mask = torch.empty((b, m), dtype=torch.bool, device=pos.device)
    with torch.cuda.device(pos.device):
        code = _ext.lib().m3d_fps(pos.data_ptr(), mask.data_ptr(), b, n, m, rt.threads, rt.pt,
                                  rt.cluster, int(rt.skip), idx.data_ptr(), new_mask.data_ptr(),
                                  _ext.stream_of(pos))
    _ext.check(code, "m3d_fps")
    return idx, new_mask


def fps(pos: torch.Tensor, mask: torch.Tensor, m: int):
    """``m`` spread-out valid points of each cloud: ``idx (B, m) int32``
    (starting from the first valid point) and ``new_mask (B, m) bool``
    (slot < valid count). CPU tensors take
    :func:`farthest_point_sampling_plain`; CUDA tensors launch the kernel
    on :func:`route`'s route (or raise)."""
    if pos.device.type == "cpu":
        return farthest_point_sampling_plain(pos, mask, m)
    _check(pos, mask, m)
    b, n, _ = pos.shape
    _ext.require_cuda("fps", pos, mask)
    if b * n == 0:
        return (torch.zeros((b, m), dtype=torch.int32, device=pos.device),
                torch.zeros((b, m), dtype=torch.bool, device=pos.device))
    out = launch(pos, mask, m, route(b, n, sm_count(pos.device)))
    fps.launches += 1
    return out


fps.launches = 0
