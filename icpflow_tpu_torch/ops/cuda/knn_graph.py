"""Bind and launch hdbscan's exact kNN graph (``csrc/knn_graph.cu``).

The kernel lives in the port's one kernel library, which
``ops/cuda/library.py`` builds and loads. It takes the compacted valid
points of ``ops/cluster.py: exact_knn_mutual_reachability`` as (x, y, z,
|q|^2) and computes each row's k nearest others in (d2, column) order, and
the rows whose k-th and (k+1)-th d2 tie: bit for bit what
``cluster._knn_graph_plain`` gives on the card. One launch.

Every launch is counted in the trace's ledger of kernel calls
(``trace.launch``) as ``knn_graph`` with its (m, k).
"""

from __future__ import annotations

import ctypes

import torch

from ... import trace as _trace
from . import library

# the C entry's arguments: pts; m, k; vals, cols, ties, stream
ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
MAX_K = 30
BLOCK_ROWS = 256         # rows a block (csrc: kBlockRows)

_entry = None            # icpflow_knn_graph, bound at the first launch


def knn_graph_cuda(pts: torch.Tensor, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel. Returns vals (m, k) float32, cols (m, k) int32
    (compacted columns; (1e9, m) where a row has no such neighbour) and
    ties (1,) int32, the rows whose k-th and (k+1)-th d2 are equal and
    below 1e9.

    pts (m, 4) float32, contiguous, on a CUDA device, m >= 1; 1 <= k <=
    30. Anything else raises ``ValueError``. The launch goes on the
    current stream; nothing synchronizes.
    """
    global _entry
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k = {k} outside [1, {MAX_K}]")
    if pts.dtype != torch.float32:
        raise ValueError(f"pts must be torch.float32, got {pts.dtype}")
    if pts.dim() != 2 or pts.shape[1] != 4 or not 1 <= pts.shape[0] < 2 ** 31:
        raise ValueError(f"pts has shape {tuple(pts.shape)}, not (m, 4) "
                         "with 1 <= m < 2^31")
    if not pts.is_contiguous():
        raise ValueError("pts must be contiguous")
    if not pts.is_cuda:
        raise ValueError(f"pts must be a CUDA tensor, got {pts.device}")
    m, dev = pts.shape[0], pts.device
    vals = torch.empty((m, k), dtype=torch.float32, device=dev)
    cols = torch.empty((m, k), dtype=torch.int32, device=dev)
    ties = torch.zeros((1,), dtype=torch.int32, device=dev)
    if _entry is None:
        _entry = library.bind("icpflow_knn_graph", ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry(pts.data_ptr(), m, k, vals.data_ptr(), cols.data_ptr(),
                     ties.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn_graph kernel launch failed: cudaError {err}")
    _trace.launch("knn_graph", (m, k))
    return vals, cols, ties
