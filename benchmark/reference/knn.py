"""Masked batched nearest-neighbour search, plain PyTorch.

The plain sweep of the port's ``ops/knn.py`` (``masked_nn_plain``) under
its default form policy, copied for the benchmark's reference: the
elementwise form d2 = sum_d (y_d - x_d)^2 for ``exact`` sweeps and for
2048 <= m <= 8192 dst slots, the expanded form (|x|^2 - 2<x,y>) + |y|^2
otherwise, each rounded in the kernel's order. Invalid dst sit at 1e30,
the lowest index wins ties, and a row with no valid dst gets idx 0, dist
1e15 and the point (0, 0, 0); a src row that ``src_mask`` leaves out gets
the same.

One departure, which changes no bit of a result: a sweep skips the
trailing dst columns that no row has valid and the trailing src rows that
``src_mask`` leaves out in every row (the odometry's map and source are
valid prefixes of large buffers), and pads its outputs back.
"""

from __future__ import annotations

import torch

_BIG = 1e30
_PLAIN_ELEMS = 1 << 26          # cap on one distance tile (elements)


def sweep_form(m: int, exact: bool) -> str:
    """The distance form of a sweep over ``m`` dst points."""
    if exact or 2048 <= m <= 8192:
        return "elementwise"
    return "expanded"


def _dot3(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _tile_d2(x, y, src_sq, form):
    if form == "expanded":
        acc = x[0] * y[0]
        tmp = x[1] * y[1]
        acc += tmp
        torch.mul(x[2], y[2], out=tmp)
        acc += tmp
        acc *= 2.0
        acc.neg_()
        acc += src_sq
        acc += _dot3(y, y)
        return acc
    acc = y[0] - x[0]
    acc *= acc
    tmp = y[1] - x[1]
    tmp *= tmp
    acc += tmp
    torch.sub(y[2], x[2], out=tmp)
    tmp *= tmp
    acc += tmp
    return acc


def _extent(mask: torch.Tensor) -> int:
    """1 + the last position that some row marks True (at least 1)."""
    cols = torch.nonzero(torch.any(mask, dim=0))
    return max(1, int(cols[-1, 0]) + 1) if len(cols) else 1


def _sweep(src, dst, dst_mask, *, form, points, tile, src_mask=None):
    b, n, _ = src.shape
    m = dst.shape[1]
    src = src.float()
    dst = dst.float()
    mask = dst_mask.bool()
    m_eff = _extent(mask)
    n_eff = n if src_mask is None else _extent(src_mask.bool())
    x_src = src[:, :n_eff]
    d = dst[:, :m_eff]
    dmask = mask[:, :m_eff]
    tile = max(1, min(tile, m_eff, _PLAIN_ELEMS // max(1, b * n_eff)))
    x = [x_src[:, :, None, k] for k in range(3)]
    src_sq = _dot3(x, x)
    best_d = torch.full((b, n_eff), _BIG, dtype=torch.float32,
                        device=src.device)
    best_i = torch.zeros((b, n_eff), dtype=torch.int64, device=src.device)
    for t0 in range(0, m_eff, tile):
        y = [d[:, None, t0:t0 + tile, k] for k in range(3)]
        d_sq = _tile_d2(x, y, src_sq, form)
        d_sq.masked_fill_(~dmask[:, None, t0:t0 + tile], _BIG)
        tile_arg = torch.argmin(d_sq, dim=2)
        tile_min = torch.gather(d_sq, 2, tile_arg[:, :, None])[:, :, 0]
        take = tile_min < best_d
        best_d = torch.where(take, tile_min, best_d)
        best_i = torch.where(take, tile_arg + t0, best_i)
    if src_mask is not None:
        wanted = src_mask.bool()[:, :n_eff]
        best_d = torch.where(wanted, best_d, torch.full_like(best_d, _BIG))
        best_i = torch.where(wanted, best_i, torch.zeros_like(best_i))
    best_i = torch.clamp(best_i, max=m - 1)
    dist = torch.sqrt(torch.clamp(best_d, min=0.0))
    full_d = torch.full((b, n), 1e15, dtype=torch.float32, device=src.device)
    full_d[:, :n_eff] = dist
    if not points:
        full_i = torch.zeros((b, n), dtype=torch.int32, device=src.device)
        full_i[:, :n_eff] = best_i.to(torch.int32)
        return full_i, full_d
    pts = torch.gather(d, 1, best_i.clamp(max=m_eff - 1)[:, :, None]
                       .expand(b, n_eff, 3))
    no_valid = ~torch.any(dmask, dim=1)
    pts = torch.where(no_valid[:, None, None], torch.zeros_like(pts), pts)
    if src_mask is not None:
        pts = torch.where(wanted[:, :, None], pts, torch.zeros_like(pts))
    full_p = torch.zeros((b, n, 3), dtype=torch.float32, device=src.device)
    full_p[:, :n_eff] = pts
    return full_p, full_d


def masked_nn(src, dst, dst_mask, tile: int = 2048, exact: bool = False,
              src_mask=None):
    """Index (B,N) int32 and distance (B,N) of each src point's nearest
    valid dst."""
    return _sweep(src, dst, dst_mask, form=sweep_form(dst.shape[1], exact),
                  points=False, tile=tile, src_mask=src_mask)


def masked_nn_points(src, dst, dst_mask, tile: int = 2048, src_mask=None):
    """Coordinates (B,N,3) and distance (B,N) of each src point's nearest
    valid dst."""
    return _sweep(src, dst, dst_mask, form=sweep_form(dst.shape[1], False),
                  points=True, tile=tile, src_mask=src_mask)


def masked_nn_error(src, src_mask, dst, dst_mask, tile: int = 2048):
    """Mean NN distance of valid src points into valid dst. Returns (B,)."""
    _, d = masked_nn(src, dst, dst_mask, tile=tile, src_mask=src_mask)
    w = src_mask.to(d.dtype)
    return torch.sum(d * w, dim=1) / torch.clamp(torch.sum(w, dim=1),
                                                 min=1e-9)
