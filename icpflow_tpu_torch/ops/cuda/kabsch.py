"""Bind and launch Kabsch's 3x3 solve (``csrc/kabsch.cu``).

The kernel lives in the port's one kernel library, which
``ops/cuda/nn_kernel.py`` builds and loads. It takes what
``ops/geometry.py: kabsch`` has reduced from the correspondences (the
covariance H and the weight total) and returns the two factors of the
rotation, R = Vp Up^T, in one launch: bit for bit the factors of
``geometry._kabsch_solve_plain`` on the card, with the identity in both
for a degenerate row.

``launches`` counts its launches. Set it to 0 before a run and read it
after, to show the run went through the kernel. A traced call also counts
them as ``kabsch_launches``.
"""

from __future__ import annotations

import torch

from ... import trace as _trace
from . import nn_kernel

launches = 0


def kabsch_solve_cuda(H: torch.Tensor, total: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel. Returns Vp, Up (B,3,3) float32.

    H (B,3,3) and total (B,): float32, contiguous, on one CUDA device.
    Anything else raises ``ValueError``. B = 0 launches nothing. The launch
    goes on the current stream; nothing synchronizes.
    """
    global launches
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
    lib = nn_kernel.load()
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = lib.icpflow_kabsch_solve(H.data_ptr(), total.data_ptr(), b,
                                       Vp.data_ptr(), Up.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"kabsch_solve kernel launch failed: cudaError {err}")
    launches += 1
    _trace.count("kabsch_launches")
    return Vp, Up
