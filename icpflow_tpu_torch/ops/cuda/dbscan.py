"""Bind and launch DBSCAN's neighbour sweep (``csrc/dbscan.cu``).

The kernel lives in the port's one kernel library, which
``ops/cuda/library.py`` builds and loads. It takes the points of
``ops/cluster.py: dbscan`` in sorted order and computes steps 2-3 there:
each point's (weighted) neighbour count and its first-hit edge in each of
its 9 candidate runs, for all n rows in one launch, bit for bit the output
of ``cluster._candidates_plain`` on the card.

Every launch is counted in the trace's ledger of kernel calls
(``trace.launch``) as ``dbscan_candidates`` with its (nv, rcap).
"""

from __future__ import annotations

import ctypes

import torch

from ... import trace as _trace
from . import library

# the C entry's arguments: pts, ids, span, mult; n, nv, rcap; eps;
# adaptive; counts, edges, stream
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float]
            + [ctypes.c_int] + [ctypes.c_void_p] * 3)

_entry = None            # icpflow_dbscan_candidates, bound at the first launch


def dbscan_candidates_cuda(xyz_s: torch.Tensor, eps_s: torch.Tensor,
                           ids_s: torch.Tensor, mult_s: torch.Tensor | None,
                           span: torch.Tensor, nv: int, rcap: int,
                           eps: float, adaptive: bool
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel. Returns counts (n,) and edges (n, 9), int64.

    xyz_s (n, 3) and eps_s (n,) float32, ids_s (n,) int64 sorted, mult_s
    (n,) int64 or None (unweighted), span (3,) int64: contiguous, on one
    CUDA device. Anything else raises ``ValueError``, as do nv outside
    [0, n] and rcap outside [1, n]. ``adaptive`` takes the mutual radius
    min(eps_i, eps_j) from eps_s, else the fixed ``eps``. The launch goes
    on the current stream; nothing synchronizes.
    """
    global _entry
    n = xyz_s.shape[0] if xyz_s.dim() == 2 else -1
    dev = xyz_s.device
    tensors = [("xyz_s", xyz_s, torch.float32, (n, 3)),
               ("eps_s", eps_s, torch.float32, (n,)),
               ("ids_s", ids_s, torch.int64, (n,)),
               ("span", span, torch.int64, (3,))]
    if mult_s is not None:
        tensors.append(("mult_s", mult_s, torch.int64, (n,)))
    for name, x, dtype, shape in tensors:
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, not "
                             f"{shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x, _, _ in tensors:
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, not {dev}")
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"n = {n} outside [1, 2^31)")
    if not (0 <= nv <= n and 1 <= rcap <= n):
        raise ValueError(f"nv = {nv} or rcap = {rcap} outside [0, n = {n}]")
    pts = torch.cat([xyz_s, eps_s[:, None]], 1)
    counts = torch.empty((n,), dtype=torch.int64, device=dev)
    edges = torch.empty((n, 9), dtype=torch.int64, device=dev)
    if _entry is None:
        _entry = library.bind("icpflow_dbscan_candidates", ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry(pts.data_ptr(), ids_s.data_ptr(), span.data_ptr(),
                     None if mult_s is None else mult_s.data_ptr(), n, nv,
                     rcap, eps, int(adaptive), counts.data_ptr(),
                     edges.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"dbscan_candidates kernel launch failed: cudaError {err}")
    _trace.launch("dbscan_candidates", (nv, rcap))
    return counts, edges
