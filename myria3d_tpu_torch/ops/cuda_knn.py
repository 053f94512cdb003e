"""K1: exact windowed top-K neighbour search (``csrc/knn.cu``) and its
plain PyTorch version; K7, the full scan ranked by the expanded score
``|k|^2 - 2 q.k`` (``variant="mxu"``), and its plain version.

Replaces ``myria3d_tpu/ops/pallas_knn.py::knn_topk_pallas`` (kernels
``_knn_kernel_vpu_win_packed``, ``_knn_kernel_vpu_win``,
``_knn_kernel_vpu``). Inputs are the centred, pad-augmented clouds built
by ``ops.knn``: queries ``(B, Nq, 4)`` with w = 0, keys ``(B, Nk, 4)`` with
w = 0 (valid) or 1e4 (pad), so a pad key sits 1e8 away in squared
distance and no mask enters the kernel.

Windows (x-sorted clouds only): queries are cut into tiles of 256; each
tile scans a contiguous run of ``window_chunks * 512`` sorted key
positions starting at its base chunk (``window_bases``, a searchsorted of
the tile's mid x into the key x's). Keys are padded to a multiple of 512
with pad rows. When the window would cover every key chunk the search is a
full scan. Selection is EXACT within the scanned keys: the K smallest
squared distances, ties to the lower key index; distances are full f32.

The list: a register list of 1 (k = 1), 4 (2 <= k <= 4), 16 (k = 16) or
32 slots (any other k), which keeps the best of its size and writes the
first k (:func:`list_size`). ``r2`` takes the ball route, a full scan:
every slot starts at ``(r2, INT_MAX)``, so only keys with ``d2 <= r2``
enter, and the K nearest of those are kept (the K nearest keys overall,
filtered by the radius, keep the same valid slots in the same order);
unfilled slots and the rows of queries outside ``query_mask`` read
``(-1, +inf)``, and a tile of masked queries skips its scan. Its queries
(PointNet++'s centroids, in FPS order) walk the kernel's tiles in x order
where they fill more than one tile (:func:`ball_walk`), so that a block's
256 queries are neighbours; the outputs do not depend on the walk.

``variant="mxu"`` is the JAX package's ``_knn_kernel``
(``pallas_knn.py:115``): a full scan (a window raises, as there) that ranks
keys by ``|k|^2 - 2 q.k`` in f32 and adds ``|q|^2`` back afterwards,
clamped at 0 (``pallas_knn.py:857-858``). The expanded form cancels: its
d2 carries an error of about ``eps * (|q|^2 + |k|^2)``, so it may order
near-equal neighbours otherwise than K1's difference form. The kernel scans
every real key and only the first ``k`` virtual pad rows
(:func:`mxu_scan_len`), its plain version every padded position.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from myria3d_tpu_torch import _ext

TILE_Q = 256    # queries per window tile (one CUDA block)
BINS = 512      # window base granularity and key padding multiple
PAD_W = 1e4     # 4th coordinate of pad keys
MAX_K = 32
LISTS = (1, 4, 16, 32)   # the kNN route's register lists (csrc/knn.cu)
BALL_LIST = 32           # the ball route's
# the ball route's largest r2: below the d2 a pad key reads valid at
# (``ops.knn.VALID_THRESH``, 0.25 PAD_W^2), so no pad key enters a list
BALL_MAX_R2 = torch.nextafter(torch.tensor(0.25 * PAD_W * PAD_W),
                              torch.tensor(0.0)).item()
# elements of the (B, tiles, 256, window) key tensor the plain version
# materializes per step
_PLAIN_ELEMS = 1 << 26
_UNFILLED = torch.iinfo(torch.int64).max   # the plain ball route's excluded key


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def window_chunks(window: int, nk_pad: int) -> int:
    """Chunks a ``window``-position scan covers: +1 chunk absorbs the
    base's rounding down to a chunk (``pallas_knn.py:554``)."""
    return min(nk_pad // BINS, window // BINS + 1)


def stage_window(window: int, n_keys: int) -> int:
    """Density-scaled window for a search into ``n_keys`` sorted keys
    (``pallas_knn.py:560``): about ``n_keys / 4`` rounded up to a chunk, at
    least 5 chunks, at most ``window``, and clamped to the largest window
    the key count can honour."""
    if not window:
        return 0
    nk_pad = _ceil_to(n_keys, BINS)
    density_cap = max(5 * BINS, _ceil_to(n_keys // 4, BINS))
    w = min(window, density_cap)
    max_win = (nk_pad // BINS - 2) * BINS
    if max_win >= 2 * BINS:
        w = min(w, max_win)
    return w


def window_bases(q4: torch.Tensor, k4: torch.Tensor, w_chunks: int,
                 query_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(B, n_tiles) int32 window base CHUNK per query tile
    (``pallas_knn.py:587``).

    The tile's mid x is searchsorted into the keys' x column (pad keys
    replaced by +inf so the valid sorted prefix stays monotone). With
    ``query_mask``, the probe row is clamped to the last valid query, so a
    tile that straddles the valid/pad boundary keeps the window of its real
    queries. Rows past ``Nq`` are the zero padding of the last tile.
    """
    b, nq, _ = q4.shape
    nk_pad = _ceil_to(k4.shape[1], BINS)
    n_tiles = -(-nq // TILE_Q)
    mid = torch.arange(n_tiles, device=q4.device) * TILE_Q + TILE_Q // 2
    if query_mask is not None:
        last_valid = (query_mask.sum(dim=1) - 1).clamp(min=0)
        probe = torch.minimum(mid[None, :], last_valid[:, None])
    else:
        probe = mid[None, :].expand(b, n_tiles)
    qx = torch.gather(q4[..., 0], 1, probe.clamp(max=nq - 1))
    qx = torch.where(probe < nq, qx, 0.0)
    kx = torch.where(k4[..., 3] == 0.0, k4[..., 0], float("inf"))
    pos = torch.searchsorted(kx.contiguous(), qx.contiguous())
    half = (w_chunks * BINS) // 2
    base = torch.div(pos - half, BINS, rounding_mode="floor")
    return base.clamp(0, nk_pad // BINS - w_chunks).to(torch.int32)


def scans_window(window: int, nk: int) -> bool:
    """Whether a ``window`` into ``nk`` keys scans less than every key
    chunk (else the search is a full scan)."""
    nk_pad = _ceil_to(nk, BINS)
    return bool(window) and window_chunks(window, nk_pad) < nk_pad // BINS


def _windows(q4: torch.Tensor, k4: torch.Tensor, window: int,
             query_mask: torch.Tensor | None):
    """(bases or None for a full scan, window length in key positions)."""
    nk_pad = _ceil_to(k4.shape[1], BINS)
    if scans_window(window, k4.shape[1]):
        w_chunks = window_chunks(window, nk_pad)
        return window_bases(q4, k4, w_chunks, query_mask), w_chunks * BINS
    return None, nk_pad


def _check(q4: torch.Tensor, k4: torch.Tensor, k: int) -> None:
    if q4.dim() != 3 or q4.shape[-1] != 4 or k4.dim() != 3 or k4.shape[-1] != 4:
        raise ValueError("queries and keys must be (B, N, 4)")
    if q4.shape[0] != k4.shape[0]:
        raise ValueError("queries and keys must share the batch size")
    if not 1 <= k <= min(MAX_K, k4.shape[1]):
        raise ValueError(f"k={k} must be in [1, min({MAX_K}, Nk)]")
    if q4.dtype != torch.float32 or k4.dtype != torch.float32:
        raise ValueError("queries and keys must be float32")


def list_size(k: int) -> int:
    """The kNN route's register list for ``k`` neighbours (``LISTS``):
    1 and 16 for themselves, 4 for k in [2, 4], else the generic 32."""
    return 1 if k == 1 else 4 if k <= 4 else 16 if k == 16 else 32


def x_order(q4: torch.Tensor, query_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(B, Nq) int32: each cloud's queries by a stable sort of their x,
    the queries outside ``query_mask`` last."""
    x = q4[..., 0]
    if query_mask is not None:
        x = torch.where(query_mask, x, float("inf"))
    return torch.sort(x, dim=1, stable=True).indices.to(torch.int32)


def ball_walk(q4: torch.Tensor, query_mask: torch.Tensor | None = None):
    """The ball route's tile walk: :func:`x_order` where the queries fill
    more than one tile, else None (row order: one tile's walk changes
    nothing). On the H100 the x walk took 7-17 % less time at PointNet++'s
    sa1 and sa2 ball queries, B=48 (PERF.md)."""
    return x_order(q4, query_mask) if q4.shape[1] > TILE_Q else None


def _check_ball(r2, window: int = 0) -> None:
    if r2 is None:
        return
    if not 0.0 <= r2 <= BALL_MAX_R2:
        raise ValueError(f"r2={r2} must be in [0, {BALL_MAX_R2}] (below the pad keys' d2)")
    if window:
        raise ValueError("the ball route is a full scan (window=0)")


def require_float4(name: str, *tensors: torch.Tensor) -> None:
    """The kernels read (..., 4) rows as 16-byte vectors (and stage keys
    with 16-byte asynchronous copies): raise unless each row is aligned."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: (..., 4) tensors must be 16-byte aligned")


def knn_topk_plain(q4: torch.Tensor, k4: torch.Tensor, k: int, window: int = 0,
                   query_mask: torch.Tensor | None = None, variant: str = "vpu",
                   r2: float | None = None):
    """Plain PyTorch version of K1: same windows, same exact selection
    (of K7 for ``variant="mxu"``: :func:`knn_topk_mxu_plain`).

    Distances are summed in the kernel's association (w², then dx², dy²,
    dz², each op rounded); ranking is on int64 keys (distance bits << 32 |
    window position), so ties go to the lower key index exactly as in the
    kernel. With ``r2`` (the ball route) a key beyond ``r2``, and every key
    of a query outside ``query_mask``, ranks last; a slot that only such
    keys fill reads ``(-1, +inf)``.
    """
    _check_variant(variant, window, r2)
    _check_ball(r2, window)
    if variant == "mxu":
        return knn_topk_mxu_plain(q4, k4, k)
    _check(q4, k4, k)
    b, nq, _ = q4.shape
    nk = k4.shape[1]
    bases, win_len = _windows(q4, k4, window, query_mask)
    nk_pad = _ceil_to(nk, BINS)
    pad_rows = torch.zeros((b, nk_pad - nk, 4), dtype=k4.dtype, device=k4.device)
    pad_rows[..., 3] = PAD_W
    k4p = torch.cat([k4, pad_rows], dim=1)
    n_tiles = -(-nq // TILE_Q)
    start = (bases.long() * BINS if bases is not None
             else torch.zeros((b, n_tiles), dtype=torch.long, device=q4.device))
    qt = F.pad(q4, (0, 0, 0, n_tiles * TILE_Q - nq)).view(b, n_tiles, TILE_Q, 4)
    ar = torch.arange(win_len, device=q4.device)
    step = max(1, _PLAIN_ELEMS // (b * TILE_Q * win_len))
    if r2 is not None:
        r2_t = torch.tensor(r2, dtype=torch.float32, device=q4.device)
        qm = (torch.ones((b, nq), dtype=torch.bool, device=q4.device) if query_mask is None
              else query_mask.bool())
        qm = F.pad(qm, (0, n_tiles * TILE_Q - nq)).view(b, n_tiles, TILE_Q, 1)
    idx_parts, d2_parts = [], []
    for t0 in range(0, n_tiles, step):
        st = start[:, t0:t0 + step]                                # (B, T)
        t = st.shape[1]
        kpos = (st[..., None] + ar).reshape(b, -1, 1).expand(-1, -1, 4)
        kw = torch.gather(k4p, 1, kpos).view(b, t, 1, win_len, 4)
        qq = qt[:, t0:t0 + t, :, None, :]                          # (B,T,256,1,4)
        s = kw[..., 3] * kw[..., 3]
        for c in range(3):
            d = qq[..., c] - kw[..., c]
            s = s + d * d
        key = (s.view(torch.int32).to(torch.int64) << 32) | ar
        if r2 is not None:
            key = torch.where((s <= r2_t) & qm[:, t0:t0 + t], key, _UNFILLED)
        top = key.topk(k, dim=-1, largest=False, sorted=True).values
        idx = (top & 0xFFFFFFFF) + st[..., None, None]
        d2 = (top >> 32).to(torch.int32).view(torch.float32)
        if r2 is not None:
            idx = torch.where(top == _UNFILLED, -1, idx)
            d2 = torch.where(top == _UNFILLED, float("inf"), d2)
        idx_parts.append(idx)
        d2_parts.append(d2)
    idx = torch.cat(idx_parts, dim=1).view(b, n_tiles * TILE_Q, k)[:, :nq]
    d2 = torch.cat(d2_parts, dim=1).view(b, n_tiles * TILE_Q, k)[:, :nq]
    return idx.to(torch.int32).contiguous(), d2.contiguous()


def mxu_scan_len(nk: int, k: int) -> int:
    """Key positions K7 scans: the ``nk`` keys and the first ``k`` of the
    virtual pad rows that fill the cloud to a multiple of 512 (its plain
    version scans them all). Every virtual row (0, 0, 0, PAD_W) scores
    exactly ``PAD_W**2`` and ties go to the lower index, so a row at or past
    ``nk + k`` has ``k`` rows before it that are no worse: it can never be
    among the ``k`` best."""
    return min(_ceil_to(nk, BINS), nk + k)


def _flip_negative(bits: torch.Tensor) -> torch.Tensor:
    """The int32 bits of f32 scores mapped so that signed int order is
    float order, negatives included (the low 31 bits of a negative float
    flipped); the map is its own inverse. No score is -0.0 (``|k|^2 >= +0``
    plus anything is never -0), so float and key equality agree."""
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def _expanded_d2(q4: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """d2 from the expanded score: ``max(score + |q|^2, 0)``."""
    return (score + (q4 * q4).sum(dim=-1, keepdim=True)).clamp(min=0.0)


def expanded_scores(q2: torch.Tensor, kp: torch.Tensor, kn: torch.Tensor) -> torch.Tensor:
    """(B, T, n) scores ``kn + (-2q).k`` of the queries ``q2 = -2 q``
    (B, T, 4) against the keys ``kp`` (B, n, 4) with ``kn = |k|^2`` (B, n):
    the products summed x, y, z, w in order, each op rounded."""
    c = q2[..., 0, None] * kp[:, None, :, 0]
    for d in range(1, 4):
        c = c + q2[..., d, None] * kp[:, None, :, d]
    return kn[:, None, :] + c


def knn_topk_mxu_plain(q4: torch.Tensor, k4: torch.Tensor, k: int):
    """Plain PyTorch version of K7: every key of the cloud (padded to a
    multiple of 512 with virtual pad rows) scored ``kn + (-2q).k`` in the
    kernel's association (``kn = ((x*x + y*y) + z*z) + w*w``;
    :func:`expanded_scores`), ranked on int64 keys (order-preserving score
    bits << 32 | key position), so ties go to the lower index. The query's
    w is read as 0, as the kernel reads it.
    Scores are mostly negative (``d2 - |q|^2``): K1's unsigned ranking of
    the raw bits would reverse them.
    Returns ``(idx, d2)`` as :func:`knn_topk`."""
    _check(q4, k4, k)
    b, nq, _ = q4.shape
    nk = k4.shape[1]
    nk_pad = _ceil_to(nk, BINS)
    pad_rows = torch.zeros((b, nk_pad - nk, 4), dtype=k4.dtype, device=k4.device)
    pad_rows[..., 3] = PAD_W
    kp = torch.cat([k4, pad_rows], dim=1)
    kn = kp[..., 0] * kp[..., 0]
    for c in range(1, 4):
        kn = kn + kp[..., c] * kp[..., c]
    q2 = q4 * -2.0
    q2[..., 3] = 0.0
    ar = torch.arange(nk_pad, device=q4.device)
    step = max(1, _PLAIN_ELEMS // (b * nk_pad))
    idx_parts, score_parts = [], []
    for q0 in range(0, nq, step):
        s = expanded_scores(q2[:, q0:q0 + step], kp, kn)
        key = (_flip_negative(s.view(torch.int32)).to(torch.int64) << 32) | ar
        top = key.topk(k, dim=-1, largest=False, sorted=True).values
        idx_parts.append(top & 0xFFFFFFFF)
        score_parts.append(_flip_negative((top >> 32).to(torch.int32)).view(torch.float32))
    idx = torch.cat(idx_parts, dim=1).to(torch.int32).contiguous()
    return idx, _expanded_d2(q4, torch.cat(score_parts, dim=1)).contiguous()


def knn_topk_mxu(q4: torch.Tensor, k4: torch.Tensor, k: int):
    """K7 on CUDA tensors (the wrapper :func:`knn_topk` calls for
    ``variant="mxu"``): ``(idx (B, Nq, k) int32, d2 (B, Nq, k) float32)``,
    ascending by the expanded score. The kernel leaves the query's w
    product out of the score: it reads the query's w as 0, as the plain
    version does, which is the JAX kernel's score where queries carry w = 0
    (as ``ops.knn.centred_clouds`` builds them)."""
    _check(q4, k4, k)
    _ext.require_cuda("knn_topk_mxu", q4, k4)
    require_float4("knn_topk_mxu", q4, k4)
    b, nq, _ = q4.shape
    nk = k4.shape[1]
    idx = torch.empty((b, nq, k), dtype=torch.int32, device=q4.device)
    score = torch.empty((b, nq, k), dtype=torch.float32, device=q4.device)
    if b * nq == 0:
        return idx, score
    with torch.cuda.device(q4.device):
        code = _ext.lib().m3d_knn_topk_mxu(
            q4.data_ptr(), k4.data_ptr(), b, nq, nk, mxu_scan_len(nk, k), k,
            idx.data_ptr(), score.data_ptr(), _ext.stream_of(q4),
        )
    _ext.check(code, "m3d_knn_topk_mxu")
    knn_topk_mxu.launches += 1
    return idx, _expanded_d2(q4, score)


knn_topk_mxu.launches = 0


def _check_variant(variant: str, window: int, r2=None) -> None:
    if variant not in ("vpu", "mxu"):
        raise ValueError(f"unknown kNN kernel variant {variant!r}")
    if window and variant != "vpu":
        raise ValueError("windowed kNN requires the vpu variant")
    if variant != "vpu" and r2 is not None:
        raise ValueError("r2 is K1's (variant='vpu')")


def launch(q4: torch.Tensor, k4: torch.Tensor, k: int, window: int = 0,
           query_mask: torch.Tensor | None = None, r2: float | None = None,
           list_k: int | None = None):
    """K1 on CUDA tensors, uncounted (:func:`knn_topk` counts): any list of
    ``LISTS`` that holds ``k`` (``list_k``; by default :func:`list_size`,
    and the ball route's ``BALL_LIST``), ``r2`` as :func:`knn_topk`.
    Returns ``(idx, d2)``."""
    _check(q4, k4, k)
    _check_ball(r2, window)
    default = BALL_LIST if r2 is not None else list_size(k)
    list_k = default if list_k is None else list_k
    if list_k not in ((BALL_LIST,) if r2 is not None else LISTS) or k > list_k:
        raise ValueError(f"no {list_k}-slot list for k={k} on the "
                         f"{'ball' if r2 is not None else 'kNN'} route")
    _ext.require_cuda("knn_topk", q4, k4)
    require_float4("knn_topk", q4, k4)
    perm = qmask = None
    if r2 is not None:
        perm = ball_walk(q4, query_mask)
        if query_mask is not None:
            qmask = query_mask.to(torch.uint8).contiguous()
    b, nq, _ = q4.shape
    nk = k4.shape[1]
    idx = torch.empty((b, nq, k), dtype=torch.int32, device=q4.device)
    d2 = torch.empty((b, nq, k), dtype=torch.float32, device=q4.device)
    if b * nq == 0:
        return idx, d2
    bases, win_len = _windows(q4, k4, window, query_mask)
    with torch.cuda.device(q4.device):
        code = _ext.lib().m3d_knn_topk(
            q4.data_ptr(), k4.data_ptr(),
            None if bases is None else bases.data_ptr(),
            None if perm is None else perm.data_ptr(),
            None if qmask is None else qmask.data_ptr(),
            b, nq, nk, -(-nq // TILE_Q), win_len, k, list_k,
            float("inf") if r2 is None else r2,
            idx.data_ptr(), d2.data_ptr(), _ext.stream_of(q4),
        )
    _ext.check(code, "m3d_knn_topk")
    return idx, d2


def knn_topk(q4: torch.Tensor, k4: torch.Tensor, k: int, window: int = 0,
             query_mask: torch.Tensor | None = None, variant: str = "vpu",
             r2: float | None = None):
    """K nearest keys of every query: ``(idx (B, Nq, k) int32,
    d2 (B, Nq, k) float32)``, ascending.

    CPU tensors take :func:`knn_topk_plain`; CUDA tensors launch the
    kernel (or raise): K1, or K7 for ``variant="mxu"`` (full scan only).
    ``window > 0`` requires x-sorted clouds. ``r2`` (the ball route, a full
    scan) is K1's, as in the module's docstring. Every launch counts in
    ``knn_topk.launches``; the ball route's also in ``ball_route.launches``,
    the 4-slot list's in ``small_list.launches``; the kNN route's also in
    ``scans``, by instantiation: ``(list size, "window" or "full scan")``.
    """
    _check_variant(variant, window, r2)
    if q4.device.type == "cpu":
        return knn_topk_plain(q4, k4, k, window, query_mask, variant, r2)
    if variant == "mxu":
        return knn_topk_mxu(q4, k4, k)
    out = launch(q4, k4, k, window, query_mask, r2)
    if q4.shape[0] * q4.shape[1]:   # no queries: nothing launched
        knn_topk.launches += 1
        if r2 is not None:
            ball_route.launches += 1
        else:
            if list_size(k) == 4:
                small_list.launches += 1
            kind = (list_size(k), "window" if scans_window(window, k4.shape[1]) else "full scan")
            scans[kind] = scans.get(kind, 0) + 1
    return out


knn_topk.launches = 0
ball_route = SimpleNamespace(launches=0)   # K1's ball route
small_list = SimpleNamespace(launches=0)   # K1's 4-slot list (2 <= k <= 4)
scans: dict = {}                           # K1's kNN route by (list size, window or full scan)
