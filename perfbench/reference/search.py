"""Plain PyTorch searches and sampling that the reference nets share.

What the configurations state, written out with plain tensor operations:
the per-cloud centring of positions, the x-sorted windows of the
predict path (``sorted_window``), the k nearest keys (ties to the lower key
index), the ball query of PointNet++ (the k nearest keys inside the
radius), farthest-point sampling, random decimation drawn from a
``torch.Generator``, and inverse-distance interpolation.

The arithmetic follows the order the configuration's semantics fix, so that
the same inputs select the same neighbours bit for bit: squared distances
are summed ``((w*w + dx*dx) + dy*dy) + dz*dz`` on centred clouds whose pad
keys sit ``PAD_W`` away on a fourth axis. Imports nothing of the program.
"""

from __future__ import annotations

import torch

TILE_Q = 256          # queries per window tile
BINS = 512            # window granularity and key padding multiple
PAD_W = 1e4           # the pad keys' fourth coordinate
VALID_THRESH = 0.25 * PAD_W * PAD_W
FAR = 1e30            # farthest-point sampling's starting distance
_MAX_ELEMS = 1 << 26  # elements of one block of the (queries x keys) tensors
_EXCLUDED = torch.iinfo(torch.int64).max


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def stage_window(window: int, n_keys: int) -> int:
    """The window of a search into ``n_keys`` x-sorted keys: about a quarter
    of the keys, at least 5 chunks, at most ``window``, and at most the
    largest window the key count can honour; 0 is a full scan."""
    if not window:
        return 0
    nk_pad = _ceil_to(n_keys, BINS)
    w = min(window, max(5 * BINS, _ceil_to(n_keys // 4, BINS)))
    max_win = (nk_pad // BINS - 2) * BINS
    if max_win >= 2 * BINS:
        w = min(w, max_win)
    return w


def cloud_offset(key_pos, key_mask):
    """(B, 1, 3): the mean of each cloud's valid keys."""
    cnt = key_mask.sum(dim=1).clamp(min=1).to(key_pos.dtype)
    total = torch.where(key_mask[..., None], key_pos, 0.0).sum(dim=1)
    return (total / cnt[:, None])[:, None, :]


def centred(query_pos, key_pos, key_mask):
    """Queries (B, Nq, 4) with w = 0 and keys (B, Nk, 4) with w = 0 (valid)
    or PAD_W (pad), both less the mean of the valid keys."""
    off = cloud_offset(key_pos, key_mask)
    q = torch.cat([query_pos - off, torch.zeros_like(query_pos[..., :1])], dim=-1)
    w = torch.where(key_mask, 0.0, PAD_W).to(key_pos.dtype)[..., None]
    return q, torch.cat([key_pos - off, w], dim=-1)


def _window_starts(q4, k4, window: int, query_mask):
    """(first key position of each 256-query tile's window (B, T), window
    length), or a full scan: every tile starts at 0 and scans every padded
    key. A tile's window is centred on the rank of its middle query's x
    among the valid keys' x (the last valid query's, past the valid ones)."""
    b, nq, _ = q4.shape
    nk_pad = _ceil_to(k4.shape[1], BINS)
    n_tiles = -(-nq // TILE_Q)
    chunks = min(nk_pad // BINS, window // BINS + 1) if window else nk_pad // BINS
    if chunks >= nk_pad // BINS:
        return torch.zeros((b, n_tiles), dtype=torch.long, device=q4.device), nk_pad
    mid = torch.arange(n_tiles, device=q4.device) * TILE_Q + TILE_Q // 2
    if query_mask is not None:
        last = (query_mask.sum(dim=1) - 1).clamp(min=0)
        probe = torch.minimum(mid[None, :], last[:, None])
    else:
        probe = mid[None, :].expand(b, n_tiles)
    qx = torch.gather(q4[..., 0], 1, probe.clamp(max=nq - 1))
    qx = torch.where(probe < nq, qx, 0.0)
    kx = torch.where(k4[..., 3] == 0.0, k4[..., 0], float("inf"))
    rank = torch.searchsorted(kx.contiguous(), qx.contiguous())
    base = torch.div(rank - (chunks * BINS) // 2, BINS, rounding_mode="floor")
    base = base.clamp(0, nk_pad // BINS - chunks)
    return base.long() * BINS, chunks * BINS


def nearest_keys(q4, k4, k: int, window: int = 0, query_mask=None, r2: float | None = None):
    """The k nearest keys of every query, ascending by (d2, key position):
    ``(idx (B, Nq, k) int64, d2 (B, Nq, k) float32)``, within the query
    tile's window when ``window`` is set. With ``r2`` (a full scan) only
    keys with ``d2 <= r2`` of queries inside ``query_mask`` count; a slot
    none fills reads ``(-1, +inf)``."""
    b, nq, _ = q4.shape
    nk = k4.shape[1]
    nk_pad = _ceil_to(nk, BINS)
    pad = torch.zeros((b, nk_pad - nk, 4), dtype=k4.dtype, device=k4.device)
    pad[..., 3] = PAD_W
    keys = torch.cat([k4, pad], dim=1)
    starts, win = _window_starts(q4, k4, window, query_mask if r2 is None else None)
    n_tiles = starts.shape[1]
    qt = torch.nn.functional.pad(q4, (0, 0, 0, n_tiles * TILE_Q - nq)).view(b, n_tiles, TILE_Q, 4)
    if r2 is not None:
        qm = torch.ones((b, nq), dtype=torch.bool, device=q4.device) if query_mask is None \
            else query_mask
        qm = torch.nn.functional.pad(qm, (0, n_tiles * TILE_Q - nq)).view(b, n_tiles, TILE_Q, 1)
        r2_t = torch.tensor(r2, dtype=torch.float32, device=q4.device)
    ar = torch.arange(win, device=q4.device)
    step = max(1, _MAX_ELEMS // (b * TILE_Q * win))
    idx_out, d2_out = [], []
    for t0 in range(0, n_tiles, step):
        st = starts[:, t0:t0 + step]
        t = st.shape[1]
        pos = (st[..., None] + ar).reshape(b, -1, 1).expand(-1, -1, 4)
        kw = torch.gather(keys, 1, pos).view(b, t, 1, win, 4)
        qq = qt[:, t0:t0 + t, :, None, :]
        d2 = kw[..., 3] * kw[..., 3]
        for c in range(3):
            diff = qq[..., c] - kw[..., c]
            d2 = d2 + diff * diff
        # d2 >= 0, so its bit pattern orders as the value does; the low
        # bits carry the window position, so ties go to the lower key
        rank = (d2.view(torch.int32).to(torch.int64) << 32) | ar
        if r2 is not None:
            rank = torch.where((d2 <= r2_t) & qm[:, t0:t0 + t], rank, _EXCLUDED)
        top = rank.topk(k, dim=-1, largest=False, sorted=True).values
        idx = (top & 0xFFFFFFFF) + st[..., None, None]
        dist = (top >> 32).to(torch.int32).view(torch.float32)
        if r2 is not None:
            idx = torch.where(top == _EXCLUDED, -1, idx)
            dist = torch.where(top == _EXCLUDED, float("inf"), dist)
        idx_out.append(idx)
        d2_out.append(dist)
    idx = torch.cat(idx_out, dim=1).view(b, n_tiles * TILE_Q, k)[:, :nq]
    d2 = torch.cat(d2_out, dim=1).view(b, n_tiles * TILE_Q, k)[:, :nq]
    return idx, d2


def knn(query_pos, key_pos, key_mask, k: int, query_mask=None, window: int = 0):
    """Masked kNN per cloud: ``(idx, d2, valid)``; slots on pad keys or of
    queries outside ``query_mask`` are invalid and read index 0."""
    k_eff = min(k, key_pos.shape[1])
    q4, k4 = centred(query_pos, key_pos, key_mask)
    idx, d2 = nearest_keys(q4, k4, k_eff, window, query_mask)
    if k_eff < k:
        idx = torch.nn.functional.pad(idx, (0, k - k_eff))
        d2 = torch.nn.functional.pad(d2, (0, k - k_eff), value=PAD_W * PAD_W)
    valid = d2 < VALID_THRESH
    if query_mask is not None:
        valid = valid & query_mask[..., None]
    return torch.where(valid, idx, 0), d2, valid


def ball(query_pos, key_pos, key_mask, k: int, radius: float, query_mask=None):
    """PointNet++'s grouping: the k nearest valid keys with
    ``d2 <= radius**2`` (rounded to float32), ``(idx, valid)``."""
    r2 = torch.tensor(radius * radius, dtype=torch.float32).item()
    k_eff = min(k, key_pos.shape[1])
    q4, k4 = centred(query_pos, key_pos, key_mask)
    idx, _ = nearest_keys(q4, k4, k_eff, query_mask=query_mask, r2=r2)
    if k_eff < k:
        idx = torch.nn.functional.pad(idx, (0, k - k_eff), value=-1)
    valid = idx >= 0
    return torch.where(valid, idx, 0), valid


def gather_rows(x, idx):
    """x (B, N, C), idx (B, ...) -> (B, ..., C)."""
    b, _, c = x.shape
    flat = idx.reshape(b, -1, 1).expand(-1, -1, c).to(torch.int64)
    return torch.gather(x, 1, flat).view(*idx.shape, c)


def idw(feats, d2, valid, query_mask):
    """Inverse squared distance weighting of gathered rows (B, Nq, k, C):
    ``sum(w x) / max(sum(w), 1e-16)`` with ``w = 1 / max(d2, 1e-16)`` on
    valid slots; rows outside ``query_mask`` are 0."""
    w = torch.where(valid, 1.0 / d2.clamp(min=1e-16), 0.0)
    out = (feats * w[..., None]).sum(dim=2) / w.sum(dim=2, keepdim=True).clamp(min=1e-16)
    return torch.where(query_mask[..., None], out, 0.0) if query_mask is not None else out


def interpolate(x, pos_src, src_mask, pos_tgt, tgt_mask, k: int, window: int = 0):
    """pyg ``knn_interpolate`` of ``x (B, Ns, C)`` onto the targets; k = 1
    copies the nearest valid row (0 where there is none)."""
    idx, d2, valid = knn(pos_tgt, pos_src, src_mask, k, query_mask=tgt_mask, window=window)
    if k == 1:
        return torch.where(valid[..., None], gather_rows(x, idx), 0.0)[:, :, 0]
    return idw(gather_rows(x.float(), idx), d2, valid, tgt_mask)


def random_decimation(mask, decimation: int, generator):
    """A uniform random quarter (1 / ``decimation``) of each cloud's valid
    points, in ascending index order: ``(idx (B, N // d), new_mask)``; each
    cloud keeps ``max(1, valid // d)`` points. One ``torch.rand`` of the
    mask's shape per call."""
    b, n = mask.shape
    n_out = n // decimation
    noise = torch.rand((b, n), generator=generator, device=mask.device)
    noise = torch.where(mask, noise, float("-inf"))
    idx = noise.topk(n_out, dim=1).indices
    count = mask.sum(dim=1)
    kept = torch.where(count > 0, (count // decimation).clamp(min=1), 0)
    new_mask = torch.arange(n_out, device=mask.device)[None, :] < kept[:, None]
    idx = torch.where(new_mask, idx, n).sort(dim=1).values
    return torch.where(new_mask, idx, 0), new_mask


def farthest_point_sampling(pos, mask, m: int):
    """``m`` slots a cloud: the first valid point, then each time the valid
    point farthest from those chosen (ties to the lower index); slots past
    the valid count are masked and read 0."""
    b = pos.shape[0]
    last = mask.to(torch.uint8).argmax(dim=1)
    mind = torch.where(mask, FAR, -1.0).to(torch.float32)
    rows = torch.arange(b, device=pos.device)
    picked = []
    for _ in range(m):
        picked.append(last)
        lp = pos[rows, last]
        dx, dy, dz = (pos[..., c] - lp[:, c, None] for c in range(3))
        mind = torch.minimum(mind, torch.where(mask, (dx * dx + dy * dy) + dz * dz, -1.0))
        last = mind.argmax(dim=1)
    idx = torch.stack(picked, dim=1)
    count = mask.sum(dim=1).clamp(max=m)
    new_mask = torch.arange(m, device=pos.device)[None, :] < count[:, None]
    return torch.where(new_mask, idx, 0), new_mask
