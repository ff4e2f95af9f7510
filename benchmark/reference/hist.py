# Frozen copy of the port's plain path, icpflow_tpu_torch/ops/hist.py, for the
# benchmark's reference. It imports nothing of the program; leave it as
# it is when the program changes: it is the yardstick.
"""Histogram translation init by wrapped voxel cross-correlation.

Port of ``icpflow_tpu/ops/hist.py``: both clouds of a pair are voxelised at
bin width ``bin_w`` modulo a fixed wrap period, FFT-correlated, and the
non-maximum-suppressed peaks inside the admissible window become
translation candidates (plus zero and the exact centroid difference). The
candidates, and then yaw hypotheses at the winner, are scored by symmetric
masked mean NN error in two phases (coarse forward-only ranking, fine
re-scoring of the best ``refine``).

Ties follow the reference: top-k takes the lowest flat index first (a
stable descending sort) and argmin the first minimum.
"""

from __future__ import annotations

import numpy as np
import torch

from . import knn as _knn

_SCORE_CAP = 1024  # query-side subsample cap for hypothesis scoring


def _wrap_counts(xyz, mask, origin, bin_w, lx, ly, lz):
    """Scatter masked points into a wrapped (B, Lz, Lx, Ly) count grid.
    Counts are integers, so the float atomic adds on a GPU are exact."""
    b, n, _ = xyz.shape
    rel = (xyz - origin[:, None, :]) / bin_w
    ix = torch.remainder(torch.floor(rel[..., 0]).to(torch.int64), lx)
    iy = torch.remainder(torch.floor(rel[..., 1]).to(torch.int64), ly)
    iz = torch.remainder(torch.floor(rel[..., 2]).to(torch.int64), lz)
    bi = torch.arange(b, device=xyz.device)[:, None].expand(b, n)
    flat = ((bi * lz + iz) * lx + ix) * ly + iy
    grid = torch.zeros(b * lz * lx * ly, dtype=torch.float32,
                       device=xyz.device)
    grid.index_add_(0, flat.reshape(-1), mask.to(torch.float32).reshape(-1))
    return grid.reshape(b, lz, lx, ly)


def _signed_shifts(l: int, device) -> torch.Tensor:
    return torch.arange(l, dtype=torch.float32, device=device) - (l // 2)


def _max_pool_same(x: torch.Tensor, dim: int, k: int) -> torch.Tensor:
    """1-D max pool, stride 1, XLA "SAME" padding with -inf: an even window
    pads (k-1)//2 below and the rest above."""
    lo = (k - 1) // 2
    hi = k - 1 - lo
    x = x.movedim(dim, -1)
    pad = torch.nn.functional.pad(x, (lo, hi), value=float("-inf"))
    out = pad.unfold(-1, k, 1).amax(-1)
    return out.movedim(-1, dim)


def _topk_stable(x: torch.Tensor, k: int, largest: bool = True):
    """Top-k along the last axis with the lowest index first among ties
    (``jax.lax.top_k``)."""
    order = torch.sort(x, dim=-1, descending=largest, stable=True).indices
    idx = order[..., :k]
    return torch.gather(x, -1, idx), idx


def _score_hypotheses(moved_k, src_mask, dst, dst_mask, eval_tile,
                      cap=_SCORE_CAP, symmetric=True):
    """Symmetric masked mean NN error of K hypotheses in one batched sweep
    per direction; queries strided to at most ``cap``. Returns (K, B)."""
    k, b, n_, _ = moved_k.shape
    m = dst.shape[1]
    sn = max(1, -(-n_ // cap))
    sm = max(1, -(-m // cap))
    mk = moved_k.reshape(k * b, n_, 3)
    smask = src_mask[None].expand(k, b, n_).reshape(k * b, n_)
    dstk = dst[None].expand(k, b, m, 3).reshape(k * b, m, 3)
    dmask = dst_mask[None].expand(k, b, m).reshape(k * b, m)
    e_f = _knn.masked_nn_error(mk[:, ::sn], smask[:, ::sn], dstk, dmask,
                               tile=eval_tile)
    if not symmetric:
        return e_f.reshape(k, b)
    e_b = _knn.masked_nn_error(dstk[:, ::sm], dmask[:, ::sm], mk, smask,
                               tile=eval_tile)
    return torch.minimum(e_f, e_b).reshape(k, b)


def _select_hypothesis(moved_k, src_mask, dst, dst_mask, eval_tile,
                       coarse_cap, refine, regen):
    """Best of K hypotheses per pair: (best_idx (B,), best_err (B,)).
    ``regen(sel (R,B)) -> (R,B,N,3)`` rebuilds the selected clouds."""
    k = moved_k.shape[0]
    if coarse_cap <= 0 or k <= refine:
        errs = _score_hypotheses(moved_k, src_mask, dst, dst_mask, eval_tile)
        return torch.argmin(errs, dim=0), torch.amin(errs, dim=0)
    coarse = _score_hypotheses(moved_k, src_mask, dst, dst_mask, eval_tile,
                               cap=coarse_cap, symmetric=False)   # (K,B)
    _, top = _topk_stable(-coarse.T, refine)                       # (B,R)
    sel = top.T                                                    # (R,B)
    fine = _score_hypotheses(regen(sel), src_mask, dst, dst_mask, eval_tile)
    j = torch.argmin(fine, dim=0)                                  # (B,)
    best_idx = torch.gather(sel, 0, j[None, :])[0]
    return best_idx, torch.amin(fine, dim=0)


def estimate_init_translation(
    src: torch.Tensor, src_mask: torch.Tensor, dst: torch.Tensor,
    dst_mask: torch.Tensor, translation_frame: float, *,
    bin_w: float = 0.1, lxy: int = 256, lz: int = 8, topk: int = 5,
    nms_kernel: int = 11, eval_tile: int = 1024, yaws: tuple = (0.0,),
    coarse_cap: int = 0, refine: int = 2, yaw_per_m: float = 0.0,
    yaw_scale_cap: float = 2.0,
) -> torch.Tensor:
    """Best init transform per cluster pair. Returns (B, 4, 4).

    Top-``topk`` NMS peaks of the displacement histogram plus the zero and
    centroid-difference candidates, scored by symmetric masked NN error;
    with nonzero ``yaws`` the winner is re-scored under yaw hypotheses about
    the source centroid, and a yaw wins only by a 5% margin.
    """
    b, n, _ = src.shape
    dev = src.device
    f32 = torch.float32
    src = src.to(f32)
    dst = dst.to(f32)
    wsrc = src_mask.to(f32)
    wdst = dst_mask.to(f32)
    tf = torch.tensor(translation_frame, dtype=f32, device=dev)

    c_src = torch.sum(src * wsrc[:, :, None], 1) / torch.clamp(
        torch.sum(wsrc, 1), min=1e-9)[:, None]
    c_dst = torch.sum(dst * wdst[:, :, None], 1) / torch.clamp(
        torch.sum(wdst, 1), min=1e-9)[:, None]
    dc = c_dst - c_src
    dc_shift = torch.round(dc / bin_w) * bin_w                   # (B,3)

    src_shifted = src + dc_shift[:, None, :]
    origin = c_dst
    grid_src = _wrap_counts(src_shifted, wsrc, origin, bin_w, lxy, lxy, lz)
    grid_dst = _wrap_counts(dst, wdst, origin, bin_w, lxy, lxy, lz)

    # circular cross-correlation: corr[s] = sum_v dst[v] * src[v - s]
    fa = torch.fft.rfftn(grid_dst, dim=(1, 2, 3))
    fb = torch.fft.rfftn(grid_src, dim=(1, 2, 3))
    corr = torch.fft.irfftn(fa * torch.conj(fb), s=(lz, lxy, lxy),
                            dim=(1, 2, 3))
    corr = torch.roll(corr, (lz // 2, lxy // 2, lxy // 2), dims=(1, 2, 3))

    sx = _signed_shifts(lxy, dev) * bin_w
    sz = _signed_shifts(lz, dev) * bin_w
    total_x = dc_shift[:, 0][:, None] + sx[None, :]              # (B,Lxy)
    total_y = dc_shift[:, 1][:, None] + sx[None, :]
    okx = torch.abs(total_x) <= tf
    oky = torch.abs(total_y) <= tf
    okz = torch.abs(sz) <= bin_w + 1e-6
    window = (okz[None, :, None, None] & okx[:, None, :, None]
              & oky[:, None, None, :])

    kz = min(nms_kernel, lz)
    pooled = corr
    for axis, k in ((1, kz), (2, nms_kernel), (3, nms_kernel)):
        pooled = _max_pool_same(pooled, axis, k)
    votes = torch.where((corr >= pooled) & window & (corr > 0), corr,
                        torch.full_like(corr, -1.0))
    top_votes, flat_idx = _topk_stable(votes.reshape(b, -1), topk)

    iz = flat_idx // (lxy * lxy)
    ix = (flat_idx // lxy) % lxy
    iy = flat_idx % lxy
    t_res = torch.stack(
        [(ix - lxy // 2).to(f32) * bin_w,
         (iy - lxy // 2).to(f32) * bin_w,
         (iz - lz // 2).to(f32) * bin_w], dim=-1)               # (B,topk,3)
    t_cand = t_res + dc_shift[:, None, :]
    t_cand = torch.where(top_votes[:, :, None] > 0, t_cand,
                         torch.zeros_like(t_cand))
    t_all = torch.cat([t_cand, torch.zeros((b, 1, 3), dtype=f32, device=dev),
                       dc[:, None, :]], dim=1)
    t_all_kb = t_all.transpose(0, 1)                             # (K,B,3)
    moved_all = src[None] + t_all_kb[:, :, None, :]

    def regen_trans(sel):                                        # (R,B)
        t_sel = torch.gather(t_all_kb, 0, sel[:, :, None].expand(-1, -1, 3))
        return src[None] + t_sel[:, :, None, :]

    best, err0 = _select_hypothesis(moved_all, src_mask, dst, dst_mask,
                                    eval_tile, coarse_cap, refine,
                                    regen_trans)
    t_best = torch.gather(t_all, 1, best[:, None, None].expand(b, 1, 3))[:, 0]

    T = torch.eye(4, dtype=f32, device=dev).expand(b, 4, 4).clone()
    T[:, :3, 3] = t_best
    nonzero_yaws = tuple(y for y in yaws if y != 0.0)
    if not nonzero_yaws:
        return T

    # --- yaw sweep at the voted winner and at the exact centroid shift ----
    dc_exact = c_dst - c_src
    if yaw_per_m > 0:
        base_max = max(abs(y) for y in nonzero_yaws)
        yscale = torch.clamp(yaw_per_m * tf / base_max, 1.0, yaw_scale_cap)
    else:
        yscale = torch.tensor(1.0, dtype=f32, device=dev)
    cand_t = (t_best, dc_exact)
    yaw_tbl = torch.as_tensor(np.repeat(
        np.array(nonzero_yaws, np.float32), len(cand_t)),
        device=dev) * yscale
    t_stack = torch.stack(cand_t, dim=0)                         # (2,B,3)
    t_tiled = t_stack.repeat(len(nonzero_yaws), 1, 1)            # (Y*2,B,3)
    centered = src - c_src[:, None, :]

    def yaw_clouds(psi, t_sel):
        """Rotate ``centered`` by per-(hyp, pair) yaw, add translation.
        psi (H,) or (H,B); t_sel (H,B,3)."""
        if psi.dim() == 1:
            psi = psi[:, None]
        c = torch.cos(psi)[:, :, None]                           # (H,B,1)
        s = torch.sin(psi)[:, :, None]
        x, y, z = (centered[None, ..., 0], centered[None, ..., 1],
                   centered[None, ..., 2])
        rot = torch.stack([c * x - s * y, s * x + c * y,
                           z.expand(torch.broadcast_shapes(z.shape, c.shape))],
                          dim=-1)
        return rot + c_src[None, :, None, :] + t_sel[:, :, None, :]

    rot_all = yaw_clouds(yaw_tbl, t_tiled)                       # (Y*2,B,N,3)

    def regen_yaw(sel):                                          # (R,B)
        psi_s = yaw_tbl[sel]
        t_sel = torch.gather(t_tiled, 0, sel[:, :, None].expand(-1, -1, 3))
        return yaw_clouds(psi_s, t_sel)

    flat_best, err_y = _select_hypothesis(
        rot_all, src_mask, dst, dst_mask, eval_tile, coarse_cap, refine,
        regen_yaw)
    psi = yaw_tbl[flat_best]
    t_yaw = torch.gather(t_tiled, 0,
                         flat_best[None, :, None].expand(1, b, 3))[0]
    use_yaw = err_y < 0.95 * err0                                # 5% margin
    psi = torch.where(use_yaw, psi, torch.zeros_like(psi))
    t_best = torch.where(use_yaw[:, None], t_yaw, t_best)

    cy, sy = torch.cos(psi), torch.sin(psi)
    zero = torch.zeros_like(cy)
    one = torch.ones_like(cy)
    R = torch.stack([
        torch.stack([cy, -sy, zero], -1),
        torch.stack([sy, cy, zero], -1),
        torch.stack([zero, zero, one], -1)], -2)                 # (B,3,3)
    t_full = t_best + c_src - torch.einsum("bij,bj->bi", R, c_src)
    T[:, :3, :3] = R
    T[:, :3, 3] = t_full
    return T
