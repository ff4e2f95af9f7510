"""Bind and launch Kabsch's 3x3 solve (``csrc/kabsch.cu``).

The kernel lives in the port's one kernel library, which
``ops/cuda/library.py`` builds and loads. It takes what
``ops/geometry.py: kabsch`` has reduced from the correspondences (the
covariance H and the weight total) and returns the two factors of the
rotation, R = Vp Up^T, in one launch: bit for bit the factors of
``geometry._kabsch_solve_plain`` on the card, with the identity in both
for a degenerate row.

Every launch is counted in the trace's ledger of kernel calls
(``trace.launch``) as ``kabsch_solve`` with its (B,).
"""

from __future__ import annotations

import ctypes

import torch

from ... import trace as _trace
from . import library

# the C entry's arguments: H, total; b; Vp, Up, stream
ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3

_entry = None            # icpflow_kabsch_solve, bound at the first launch


def kabsch_solve_cuda(H: torch.Tensor, total: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel. Returns Vp, Up (B,3,3) float32.

    H (B,3,3) and total (B,): float32, contiguous, on one CUDA device.
    Anything else raises ``ValueError``. B = 0 launches nothing. The launch
    goes on the current stream; nothing synchronizes.
    """
    global _entry
    b = H.shape[0] if H.dim() == 3 else -1
    for name, x, shape in (("H", H, (b, 3, 3)), ("total", total, (b,))):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be torch.float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"bad shapes H {tuple(H.shape)} total "
                             f"{tuple(total.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if total.device != H.device:
        raise ValueError("H and total must share one device")
    if b >= 2 ** 31 // 9:
        raise ValueError(f"batch {b} too large for int32 offsets")
    Vp = torch.empty((b, 3, 3), dtype=torch.float32, device=H.device)
    Up = torch.empty((b, 3, 3), dtype=torch.float32, device=H.device)
    if b == 0:
        return Vp, Up
    if _entry is None:
        _entry = library.bind("icpflow_kabsch_solve", ARGTYPES)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = _entry(H.data_ptr(), total.data_ptr(), b, Vp.data_ptr(),
                     Up.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"kabsch_solve kernel launch failed: cudaError {err}")
    _trace.launch("kabsch_solve", (b,))
    return Vp, Up
