"""Masked batched nearest-neighbour search.

Port of ``icpflow_tpu/ops/knn.py``. One sweep, two distance forms:

* expanded:    d2 = (|x|^2 - 2<x,y>) + |y|^2
* elementwise: d2 = sum_d (y_d - x_d)^2   (no cancellation at metre scale)

The form follows what the reference computed on its accelerator
(``knn.py:66-105``): elementwise when ``exact`` or when 2048 <= m <= 8192
(``ICPFLOW_NN_VARIANT=auto``), expanded otherwise. ``ICPFLOW_NN_VARIANT``
may force ``mxu`` (expanded) or ``vpu`` (elementwise) for 128 <= m <= 8192;
``vpu2`` is not ported and raises.

A CUDA tensor goes to the hand-written kernel (``ops/cuda/nn_kernel.py``); a
CPU tensor goes to the plain version below, which has the reference's
fallback semantics (``_masked_nn_xla``): invalid dst at 1e30, the lowest
index wins ties, idx clamped to m-1, dist = sqrt(max(d2, 0)), and where no
dst is valid: idx 0, dist 1e15, point (0,0,0).
"""

from __future__ import annotations

import os

import torch

from .cuda import nn_kernel as _cuda

_BIG = 1e30
_PLAIN_ELEMS = 1 << 26          # cap on one plain distance tile (elements)

plain_calls = 0                 # calls of masked_nn_plain


def pick_variant(m: int) -> str:
    """Kernel form for dst size ``m``: "mxu" (expanded) or "vpu"
    (elementwise). Override with ICPFLOW_NN_VARIANT=mxu|vpu."""
    v = os.environ.get("ICPFLOW_NN_VARIANT", "auto")
    if v == "auto":
        return "vpu" if m >= 2048 else "mxu"
    if v in ("mxu", "vpu"):
        return v
    raise ValueError(
        f"ICPFLOW_NN_VARIANT={v!r}: the port takes auto|mxu|vpu "
        "(the vpu2 kernels are not ported yet; see ROADMAP Queue 2)")


def _elementwise(m: int, exact: bool) -> bool:
    if exact:
        return True
    variant = pick_variant(m)      # validates the override at every call
    return 128 <= m <= 8192 and variant == "vpu"


def _dot3(a, b):
    """(a0*b0 + a1*b1) + a2*b2 with every operation rounded on its own:
    the kernel's exact sequence (csrc/nn_kernel.cu ``dot3``)."""
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def masked_nn_plain(src: torch.Tensor, dst: torch.Tensor,
                    dst_mask: torch.Tensor, *, expanded: bool,
                    points: bool, tile: int = 2048):
    """Plain PyTorch sweep, tiled over dst. Same contract and the same
    arithmetic as the kernel: returns (idx (B,N) int32 | pts (B,N,3),
    dist (B,N))."""
    global plain_calls
    plain_calls += 1
    b, n, _ = src.shape
    m = dst.shape[1]
    src = src.float()
    dst = dst.float()
    mask = dst_mask.bool()
    per_col = max(1, b * n)
    tile = max(1, min(tile, m, _PLAIN_ELEMS // per_col))
    x = [src[:, :, None, d] for d in range(3)]                  # (B,N,1)
    src_sq = _dot3(x, x)
    best_d = torch.full((b, n), _BIG, dtype=torch.float32, device=src.device)
    best_i = torch.zeros((b, n), dtype=torch.int64, device=src.device)
    for t0 in range(0, m, tile):
        y = [dst[:, None, t0:t0 + tile, d] for d in range(3)]   # (B,1,T)
        m_t = mask[:, t0:t0 + tile]
        if expanded:
            d_sq = (src_sq - 2.0 * _dot3(x, y)) + _dot3(y, y)
        else:
            diff = [y[d] - x[d] for d in range(3)]
            d_sq = _dot3(diff, diff)
        d_sq = torch.where(m_t[:, None, :], d_sq,
                           torch.full_like(d_sq, _BIG))
        tile_arg = torch.argmin(d_sq, dim=2)
        tile_min = torch.gather(d_sq, 2, tile_arg[:, :, None])[:, :, 0]
        take = tile_min < best_d
        best_d = torch.where(take, tile_min, best_d)
        best_i = torch.where(take, tile_arg + t0, best_i)
    best_i = torch.clamp(best_i, max=m - 1)
    dist = torch.sqrt(torch.clamp(best_d, min=0.0))
    if not points:
        return best_i.to(torch.int32), dist
    pts = torch.gather(dst, 1, best_i[:, :, None].expand(b, n, 3))
    no_valid = ~torch.any(mask, dim=1)
    pts = torch.where(no_valid[:, None, None], torch.zeros_like(pts), pts)
    return pts, dist


def _sweep(src, dst, dst_mask, *, expanded, points, tile):
    if src.is_cuda:
        return _cuda.masked_nn_cuda(
            src.float().contiguous(), dst.float().contiguous(),
            dst_mask.bool().contiguous(), expanded=expanded, points=points)
    if src.device.type != "cpu":
        raise ValueError(f"no NN sweep for device {src.device}")
    return masked_nn_plain(src, dst, dst_mask, expanded=expanded,
                           points=points, tile=tile)


def masked_nn(src: torch.Tensor, dst: torch.Tensor, dst_mask: torch.Tensor,
              tile: int = 2048, exact: bool = False):
    """For each src point, index and euclidean distance of the nearest
    valid dst. src (B,N,3), dst (B,M,3), dst_mask (B,M).
    Returns idx (B,N) int32 (0 if none valid), dist (B,N)."""
    expanded = not _elementwise(dst.shape[1], exact)
    return _sweep(src, dst, dst_mask, expanded=expanded, points=False,
                  tile=tile)


def masked_nn_points(src: torch.Tensor, dst: torch.Tensor,
                     dst_mask: torch.Tensor, tile: int = 2048):
    """For each src point: coordinates (B,N,3) and distance (B,N) of the
    nearest valid dst (zeros and ~1e15 where none is valid)."""
    expanded = not _elementwise(dst.shape[1], False)
    return _sweep(src, dst, dst_mask, expanded=expanded, points=True,
                  tile=tile)


def masked_nn_error(src: torch.Tensor, src_mask: torch.Tensor,
                    dst: torch.Tensor, dst_mask: torch.Tensor,
                    tile: int = 2048) -> torch.Tensor:
    """Mean NN distance of valid src points into valid dst. Returns (B,)."""
    _, d = masked_nn(src, dst, dst_mask, tile=tile)
    w = src_mask.to(d.dtype)
    return torch.sum(d * w, dim=1) / torch.clamp(torch.sum(w, dim=1),
                                                 min=1e-9)
