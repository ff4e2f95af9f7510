"""Masked batched nearest-neighbour search.

Port of ``icpflow_tpu/ops/knn.py``. One sweep, three forms:

* expanded:    d2 = (|x|^2 - 2<x,y>) + |y|^2
* elementwise: d2 = sum_d (y_d - x_d)^2   (no cancellation at metre scale)
* sentinel:    the elementwise d2 with invalid dst moved to (1e6, 1e6, 1e6)
  instead of masked (the TPU's "vpu2" kernels)

The form follows what the reference computed on its accelerator
(``knn.py:66-105``): elementwise when ``exact`` or when 2048 <= m <= 8192
(``ICPFLOW_NN_VARIANT=auto``), expanded otherwise. ``ICPFLOW_NN_VARIANT``
may force ``mxu`` (expanded), ``vpu`` (elementwise) or ``vpu2`` (sentinel)
for non-``exact`` calls with 128 <= m <= 8192, where the reference ran its
Pallas kernels; outside that range the expanded form runs, as the
reference's XLA path did.

A CUDA tensor goes to the hand-written kernel (``ops/cuda/nn_kernel.py``); a
CPU tensor goes to the plain version below, which has the same contract:

* expanded / elementwise (the reference's ``_masked_nn_xla``): invalid dst
  at 1e30, the lowest index wins ties, idx clamped to m-1,
  dist = sqrt(max(d2, 0)), and where no dst is valid: idx 0, dist 1e15,
  point (0,0,0);
* sentinel (``nn_kernel.py:125-214``): invalid dst stay candidates at the
  sentinel, so where no dst is valid dist is the sentinel's distance
  (~1.73e6), idx 0 and the point the sentinel. The index output takes the
  lowest index on ties; the points output the candidate that minimises
  (d2, j mod 8, j div 8), the TPU's 8-row carry order.
"""

from __future__ import annotations

import os

import torch

from .. import trace as _trace
from .cuda import nn_kernel as _cuda

_BIG = 1e30
_SENTINEL = 1e6
_PLAIN_ELEMS = 1 << 26          # cap on one plain distance tile (elements)
_PLAIN_ELEMS_CPU = 1 << 20      # the same on the CPU: a tile stays in cache
_VARIANT_FORM = {"mxu": "expanded", "vpu": "elementwise", "vpu2": "sentinel"}


def pick_variant(m: int) -> str:
    """Kernel variant for dst size ``m``: "mxu" (expanded), "vpu"
    (elementwise) or "vpu2" (sentinel). Override with
    ICPFLOW_NN_VARIANT=mxu|vpu|vpu2; other values raise."""
    v = os.environ.get("ICPFLOW_NN_VARIANT", "auto")
    if v == "auto":
        return "vpu" if m >= 2048 else "mxu"
    if v in _VARIANT_FORM:
        return v
    raise ValueError(
        f"ICPFLOW_NN_VARIANT={v!r}: the port takes auto|mxu|vpu|vpu2")


def sweep_form(m: int, exact: bool) -> str:
    """The distance form of a sweep over ``m`` dst points."""
    if exact:
        return "elementwise"
    variant = pick_variant(m)      # validates the override at every call
    return _VARIANT_FORM[variant] if 128 <= m <= 8192 else "expanded"


def _dot3(a, b):
    """(a0*b0 + a1*b1) + a2*b2 with every operation rounded on its own:
    the kernel's exact sequence (csrc/nn_kernel.cu ``dot3``)."""
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _tile_d2(x, y, src_sq, form):
    """(B,N,T) squared distances of one dst tile, in the kernel's rounding
    order, computed in place into two buffers."""
    if form == "expanded":
        acc = x[0] * y[0]
        tmp = x[1] * y[1]
        acc += tmp
        torch.mul(x[2], y[2], out=tmp)
        acc += tmp
        acc *= 2.0
        acc.neg_()
        acc += src_sq                           # src_sq - 2<x,y>
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


def masked_nn_plain(src: torch.Tensor, dst: torch.Tensor,
                    dst_mask: torch.Tensor, *, form: str,
                    points: bool, tile: int = 2048,
                    src_mask: torch.Tensor | None = None):
    """Plain PyTorch sweep, tiled over dst. Same contract and the same
    arithmetic as the kernel: returns (idx (B,N) int32 | pts (B,N,3),
    dist (B,N)). The result does not depend on the tile size. A src point
    that ``src_mask`` (B,N) marks False gets idx 0, dist 1e15 and the point
    (0,0,0) in every form. Each call is ``masked_nn_plain`` with its
    (B, N, M) in the trace's ledger of kernel calls."""
    if form not in _cuda.FORMS:
        raise ValueError(f"form must be one of {_cuda.FORMS}, got {form!r}")
    b, n, _ = src.shape
    m = dst.shape[1]
    _trace.launch("masked_nn_plain", (b, n, m))
    src = src.float()
    dst = dst.float()
    mask = dst_mask.bool()
    sentinel = form == "sentinel"
    if sentinel:
        dst = torch.where(mask[:, :, None], dst,
                          torch.full_like(dst, _SENTINEL))
    cap = _PLAIN_ELEMS if src.is_cuda else _PLAIN_ELEMS_CPU
    tile = max(1, min(tile, m, cap // max(1, b * n)))
    x = [src[:, :, None, d] for d in range(3)]                  # (B,N,1)
    src_sq = _dot3(x, x)
    best_d = torch.full((b, n), _BIG, dtype=torch.float32, device=src.device)
    best_i = torch.zeros((b, n), dtype=torch.int64, device=src.device)
    rows = m // 8 + 1

    def carry_key(j):
        """Points-form sentinel tie order (j mod 8, j div 8), below 8*rows."""
        return (j % 8) * rows + j // 8

    for t0 in range(0, m, tile):
        y = [dst[:, None, t0:t0 + tile, d] for d in range(3)]   # (B,1,T)
        d_sq = _tile_d2(x, y, src_sq, form)
        if not sentinel:
            d_sq.masked_fill_(~mask[:, None, t0:t0 + tile], _BIG)
        tile_arg = torch.argmin(d_sq, dim=2)                    # lowest index
        tile_min = torch.gather(d_sq, 2, tile_arg[:, :, None])[:, :, 0]
        take = tile_min < best_d
        if sentinel and points:
            j = torch.arange(t0, t0 + d_sq.shape[2], device=src.device)
            key = torch.where(d_sq == tile_min[:, :, None], carry_key(j),
                              torch.full_like(j, 8 * rows))
            tile_arg = torch.argmin(key, dim=2)
            take = take | ((tile_min == best_d)
                           & (carry_key(tile_arg + t0) < carry_key(best_i)))
        best_d = torch.where(take, tile_min, best_d)
        best_i = torch.where(take, tile_arg + t0, best_i)
    if src_mask is not None:
        wanted = src_mask.bool()
        best_d = torch.where(wanted, best_d, torch.full_like(best_d, _BIG))
        best_i = torch.where(wanted, best_i, torch.zeros_like(best_i))
    best_i = torch.clamp(best_i, max=m - 1)
    dist = torch.sqrt(torch.clamp(best_d, min=0.0))
    if not points:
        return best_i.to(torch.int32), dist
    pts = torch.gather(dst, 1, best_i[:, :, None].expand(b, n, 3))
    if not sentinel:
        no_valid = ~torch.any(mask, dim=1)
        pts = torch.where(no_valid[:, None, None], torch.zeros_like(pts), pts)
    if src_mask is not None:
        pts = torch.where(wanted[:, :, None], pts, torch.zeros_like(pts))
    return pts, dist


def valid_pairs(form: str, src: torch.Tensor, dst_mask: torch.Tensor,
                src_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(B,) (src, dst) candidates a sweep needs, on the inputs' device:
    valid src (all N without ``src_mask``) times valid dst; the sentinel
    form keeps every dst a candidate. At most three small device ops."""
    b, n, _ = src.shape
    m = dst_mask.shape[1]
    if form == "sentinel":
        if src_mask is None:
            return torch.full((b,), n * m, dtype=torch.int64,
                              device=src.device)
        return src_mask.sum(1, dtype=torch.int64) * m
    dv = dst_mask.sum(1, dtype=torch.int64)
    if src_mask is None:
        return dv * n
    return src_mask.sum(1, dtype=torch.int64) * dv


def _sweep(src, dst, dst_mask, *, form, points, tile, src_mask=None):
    if _trace.current() is not None:
        _trace.count(f"nn_valid.{form}.{'points' if points else 'index'}",
                     valid_pairs(form, src, dst_mask, src_mask))
    if src.is_cuda:
        return _cuda.masked_nn_cuda(
            src.float().contiguous(), dst.float().contiguous(),
            dst_mask.bool().contiguous(), form=form, points=points,
            src_mask=None if src_mask is None
            else src_mask.bool().contiguous())
    if src.device.type != "cpu":
        raise ValueError(f"no NN sweep for device {src.device}")
    return masked_nn_plain(src, dst, dst_mask, form=form, points=points,
                           tile=tile, src_mask=src_mask)


def masked_nn(src: torch.Tensor, dst: torch.Tensor, dst_mask: torch.Tensor,
              tile: int = 2048, exact: bool = False,
              src_mask: torch.Tensor | None = None):
    """For each src point, index and euclidean distance of the nearest
    valid dst. src (B,N,3), dst (B,M,3), dst_mask (B,M).
    Returns idx (B,N) int32 (0 if none valid), dist (B,N). ``src_mask``
    (B,N), where given, names the src points whose result is read: the
    others are not swept and get idx 0, dist 1e15."""
    return _sweep(src, dst, dst_mask, form=sweep_form(dst.shape[1], exact),
                  points=False, tile=tile, src_mask=src_mask)


def masked_nn_points(src: torch.Tensor, dst: torch.Tensor,
                     dst_mask: torch.Tensor, tile: int = 2048,
                     src_mask: torch.Tensor | None = None):
    """For each src point: coordinates (B,N,3) and distance (B,N) of the
    nearest valid dst (where none is valid: zeros and 1e15, or the sentinel
    and its distance under the sentinel form). ``src_mask`` (B,N), where
    given, names the src points whose result is read: the others are not
    swept and get zeros and 1e15 in every form."""
    return _sweep(src, dst, dst_mask, form=sweep_form(dst.shape[1], False),
                  points=True, tile=tile, src_mask=src_mask)


def masked_nn_error(src: torch.Tensor, src_mask: torch.Tensor,
                    dst: torch.Tensor, dst_mask: torch.Tensor,
                    tile: int = 2048) -> torch.Tensor:
    """Mean NN distance of valid src points into valid dst. Returns (B,).
    The distance is read only under ``src_mask`` (weight 0 elsewhere), so the
    sweep skips the other rows, which changes no bit of the result."""
    _, d = masked_nn(src, dst, dst_mask, tile=tile, src_mask=src_mask)
    w = src_mask.to(d.dtype)
    return torch.sum(d * w, dim=1) / torch.clamp(torch.sum(w, dim=1),
                                                 min=1e-9)
