"""Masked-batch geometry: rigid transforms, weighted Kabsch, stats.

Port of ``icpflow_tpu/ops/geometry.py``. Transforms are column-convention
homogeneous 4x4 (``x' = T[:3,:3] @ x + T[:3,3]``), point batches are
``(B, N, 3)`` with ``(B, N)`` validity masks, and every reduction is
mask-weighted with epsilon-guarded denominators so empty segments stay
finite. All math is fp32; the package turns TF32 off on import.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import trace as _trace
from .cuda import kabsch as _cuda_kabsch

_EPS = 1e-9


def scale_as_xla(x: torch.Tensor, divisor: float,
                 factor: float = 1.0) -> torch.Tensor:
    """``x / divisor * factor`` as XLA compiles it for constant operands:
    one multiply by the fp32 constant ``(1 / divisor) * factor``, folded in
    fp32. The reference's jitted code computes its voxel and CZM bin
    indices so (XLA turns a division by a constant into a multiply by its
    reciprocal), and the port does the same, so that values on a bin
    boundary fall into the same bin."""
    c = np.float32(np.float32(1.0) / np.float32(divisor)) * np.float32(factor)
    return x * float(c)


def transform_points(xyz: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply one 4x4 to (N,3) points."""
    return xyz @ T[:3, :3].T + T[:3, 3]


def transform_points_batch(xyz: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply (B,4,4) to (B,N,3)."""
    return torch.einsum("bij,bnj->bni", T[:, :3, :3], xyz) + T[:, None, :3, 3]


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack (B,3,3) rotation + (B,3) translation into (B,4,4)."""
    T = torch.zeros((R.shape[0], 4, 4), dtype=R.dtype, device=R.device)
    T[:, :3, :3] = R
    T[:, :3, 3] = t
    T[:, 3, 3] = 1.0
    return T


def eye4(batch: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(4, dtype=like.dtype, device=like.device).expand(
        batch, 4, 4).clone()


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Mask-weighted mean along ``axis``; zero where mask is empty."""
    w = mask.to(x.dtype)
    num = torch.sum(x * w.unsqueeze(-1), dim=axis)
    den = torch.sum(w, dim=axis).unsqueeze(-1)
    return num / torch.clamp(den, min=_EPS)


def _svd3x3_jacobi(H: torch.Tensor, sweeps: int = 6):
    """Batched one-sided (Hestenes) Jacobi SVD of (B,3,3) matrices.

    Same algorithm as the reference: 6 cyclic sweeps of column-pair
    rotations, column norms as singular values, a 3-comparator sort network.
    Returns (U, S, V) with H = U diag(S) V^T, S descending.
    """
    W = H.clone()
    V = torch.eye(3, dtype=H.dtype, device=H.device).expand_as(H).clone()

    def rotate(p, q):
        wp = W[:, :, p].clone()
        wq = W[:, :, q].clone()
        a = torch.sum(wp * wp, dim=1)
        b = torch.sum(wq * wq, dim=1)
        c = torch.sum(wp * wq, dim=1)
        small = torch.abs(c) <= _EPS * torch.sqrt(a * b + _EPS)
        tau = (b - a) / (2.0 * torch.where(small, torch.ones_like(c), c))
        t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
        t = torch.where(small, torch.zeros_like(t), t)
        cs = 1.0 / torch.sqrt(1.0 + t * t)
        sn = cs * t
        csn = cs[:, None]
        snn = sn[:, None]
        W[:, :, p] = csn * wp - snn * wq
        W[:, :, q] = snn * wp + csn * wq
        vp = V[:, :, p].clone()
        vq = V[:, :, q].clone()
        V[:, :, p] = csn * vp - snn * vq
        V[:, :, q] = snn * vp + csn * vq

    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            rotate(p, q)

    S = torch.sqrt(torch.sum(W * W, dim=1))                      # (B,3)

    def order(p, q):                                             # S[p] >= S[q]
        swap = S[:, q] > S[:, p]
        sw = swap[:, None]
        for M in (W, V):
            mp, mq = M[:, :, p].clone(), M[:, :, q].clone()
            M[:, :, p] = torch.where(sw, mq, mp)
            M[:, :, q] = torch.where(sw, mp, mq)
        sp, sq = S[:, p].clone(), S[:, q].clone()
        S[:, p] = torch.where(swap, sq, sp)
        S[:, q] = torch.where(swap, sp, sq)

    for p, q in ((0, 1), (1, 2), (0, 1)):                        # sort network
        order(p, q)
    U = W / torch.clamp(S, min=_EPS)[:, None, :]
    return U, S, V


def _norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False):
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


@_trace.spanned("icpflow.kabsch")
def kabsch(src: torch.Tensor, dst: torch.Tensor,
           weights: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted least-squares rigid alignment ``R @ src + t ~= dst``.

    The reflection fix is folded into the factors: the two leading left
    columns are re-orthonormalised, the third columns of both factors are
    completed by cross products, and R = V U^T. Degenerate inputs (weights
    below one point, coincident or collinear points) fall back to identity
    rotation with a centroid-difference translation.

    The weighted sums over N run in PyTorch for either device. The 3x3
    solve that follows them runs on a CUDA tensor in
    :func:`_kabsch_solve_cuda`, one hand-written kernel (``ops/cuda/
    kabsch.py``, ``kabsch_solve`` in the trace's ledger of kernel calls)
    and the two 3x3 products, and on a CPU tensor in
    :func:`_kabsch_solve_plain` (``kabsch_solve_plain`` in the ledger); the
    two agree bit for bit on the card.

    Args: src, dst (B,N,3); weights (B,N). Returns R (B,3,3), t (B,3).
    """
    H, total, mu_s, mu_d = _kabsch_moments(src, dst, weights)
    if H.is_cuda:
        return _kabsch_solve_cuda(H, total, mu_s, mu_d)
    return _kabsch_solve_plain(H, total, mu_s, mu_d)


def _kabsch_moments(src: torch.Tensor, dst: torch.Tensor,
                    weights: torch.Tensor):
    """The weighted sums over N of :func:`kabsch`: the covariance H
    (B,3,3), contiguous, the weight total (B,) and the centroids mu_s, mu_d
    (B,3)."""
    w = weights.to(src.dtype)
    total = torch.sum(w, dim=1)                                  # (B,)
    denom = torch.clamp(total, min=_EPS)[:, None]
    mu_s = torch.sum(src * w[:, :, None], dim=1) / denom
    mu_d = torch.sum(dst * w[:, :, None], dim=1) / denom
    cs = (src - mu_s[:, None, :]) * w[:, :, None]
    cd = dst - mu_d[:, None, :]
    H = torch.einsum("bni,bnj->bij", cs, cd)
    H = H / torch.clamp(total, min=_EPS)[:, None, None]
    return H.contiguous(), total, mu_s, mu_d


def _kabsch_solve_plain(H: torch.Tensor, total: torch.Tensor,
                        mu_s: torch.Tensor, mu_d: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the 3x3 solve (``csrc/kabsch.cu``): the
    covariance H (B,3,3), the weight total (B,) and the centroids mu_s,
    mu_d (B,3) to R (B,3,3) and t (B,3)."""
    _trace.launch("kabsch_solve_plain", (H.shape[0],))
    U, S, V = _svd3x3_jacobi(H)
    u1 = U[:, :, 0]
    n1 = _norm(u1, dim=1, keepdim=True)
    u1 = u1 / torch.clamp(n1, min=_EPS)
    u2 = U[:, :, 1]
    u2 = u2 - torch.sum(u2 * u1, dim=1, keepdim=True) * u1
    n2 = _norm(u2, dim=1, keepdim=True)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=H.dtype,
                      device=H.device).expand_as(u1)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=H.dtype,
                      device=H.device).expand_as(u1)
    alt = torch.linalg.cross(u1, ex, dim=-1)
    alt2 = torch.linalg.cross(u1, ez, dim=-1)
    alt = torch.where((_norm(alt, dim=1) >= _norm(alt2, dim=1))[:, None],
                      alt, alt2)
    u2 = torch.where(n2 > 1e-6, u2 / torch.clamp(n2, min=_EPS),
                     alt / torch.clamp(_norm(alt, dim=1, keepdim=True),
                                       min=_EPS))
    u3 = torch.linalg.cross(u1, u2, dim=-1)
    Up = torch.stack([u1, u2, u3], dim=2)
    v3 = torch.linalg.cross(V[:, :, 0], V[:, :, 1], dim=-1)
    Vp = torch.cat([V[:, :, :2], v3[:, :, None]], dim=2)
    R = torch.einsum("bij,bkj->bik", Vp, Up)                     # V @ U^T

    degenerate = ((total < 1.0) | ~torch.isfinite(S).all(dim=1)
                  | (S[:, 0] <= 1e-12) | (n1[:, 0] <= 1e-6))
    eye = torch.eye(3, dtype=H.dtype, device=H.device).expand_as(R)
    R = torch.where(degenerate[:, None, None], eye, R)
    return R, _kabsch_translation(R, mu_s, mu_d)


def _kabsch_solve_cuda(H: torch.Tensor, total: torch.Tensor,
                       mu_s: torch.Tensor, mu_d: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_kabsch_solve_plain` on the card: the kernel gives the factors
    (the identity twice for a degenerate row, whose R = I I^T is the
    identity exactly), and R and t come from the same einsums as there:
    the order in which cuBLAS rounds them changes with the batch size."""
    Vp, Up = _cuda_kabsch.kabsch_solve_cuda(H, total)
    R = torch.einsum("bij,bkj->bik", Vp, Up)                     # V @ U^T
    return R, _kabsch_translation(R, mu_s, mu_d)


def _kabsch_translation(R: torch.Tensor, mu_s: torch.Tensor,
                        mu_d: torch.Tensor) -> torch.Tensor:
    """t = mu_d - R mu_s, 0 where it is not finite."""
    t = mu_d - torch.einsum("bij,bj->bi", R, mu_s)
    return torch.where(torch.isfinite(t), t, torch.zeros_like(t))


def euler_zyx_deg(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (B,3,3) -> intrinsic ZYX Euler angles in degrees
    (yaw_z, pitch_y, roll_x), pytorch3d ``matrix_to_euler_angles`` order."""
    sy = torch.clamp(-R[:, 2, 0], -1.0, 1.0)
    b = torch.arcsin(sy)
    a = torch.atan2(R[:, 1, 0], R[:, 0, 0])
    c = torch.atan2(R[:, 2, 1], R[:, 2, 2])
    return torch.stack([a, b, c], dim=1) * (180.0 / math.pi)


def bbox_extent_sorted(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sorted axis-aligned bbox side lengths per segment, (B,3) ascending."""
    m = mask[:, :, None]
    hi = torch.amax(torch.where(m, xyz, torch.full_like(xyz, -1e9)), dim=1)
    lo = torch.amin(torch.where(m, xyz, torch.full_like(xyz, 1e9)), dim=1)
    ext = torch.clamp(hi - lo, min=0.0)
    return torch.sort(ext, dim=1).values


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,4,4) @ (B,4,4): apply ``b`` first, then ``a``."""
    return torch.einsum("bij,bjk->bik", a, b)


def invert_rigid(T: torch.Tensor) -> torch.Tensor:
    """Invert (B,4,4) rigid transforms without a linear solve."""
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    Rt = R.transpose(1, 2)
    ti = -torch.einsum("bij,bj->bi", Rt, t)
    return rt_to_mat(Rt, ti)
