# Frozen copy of the port's plain path, icpflow_tpu_torch/ops/ground.py, for the
# benchmark's reference. It imports nothing of the program; leave it as
# it is when the program changes: it is the yardstick.
"""Ground segmentation: concentric-zone-model plane fitting.

Port of ``icpflow_tpu/ops/ground.py`` (CZM Patchwork++: CZM binning, R-VPF
vertical-plane removal in zone 0, seed selection, R-GPF iterative PCA plane
fit, the A-GLE acceptance ladder, TGR, and the adaptive per-ring thresholds
carried across frames as explicit state). See that module for the mapping
to the reference and its deliberate deviations; the port keeps them all.

Shape discipline as in the reference: one global sort by (patch, z) gives
(P, K) z-ascending patch tensors, the plane fits run as one batched masked
PCA over all patches (3x3 ``eigh``), and every point is then classified
against its patch's plane. Both sorts are stable, as ``jnp.argsort`` is.
The reference's ``lax.cond`` on "any R-VPF peel" is one host read here.
Ring and sector bins scale by folded fp32 constants, as the reference's
compiled code does (``geometry.scale_as_xla``).

Numerics: ``torch.linalg.eigh`` runs another solver than XLA's (LAPACK on
the CPU, cuSOLVER on the card), so near-degenerate patch covariances can
turn the smallest eigenvector; the tests hold the mask to a stated share of
agreeing points rather than bit equality.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import DEFAULT_DEVICE, resolve_device
from .geometry import scale_as_xla

# CZM layout (patchworkpp.h:100-101): rings per zone x sectors per zone
ZONE_RINGS = (2, 4, 4, 4)
ZONE_SECTORS = (16, 32, 54, 32)
# radial zone boundaries in metres for min_range=1, max_range=64
ZONE_BOUNDS = (1.0, 12.3625, 22.025, 41.35, 64.0)

NUM_PATCHES = sum(r * s for r, s in zip(ZONE_RINGS, ZONE_SECTORS))
NUM_RINGS = sum(ZONE_RINGS)
NUM_RINGS_OF_INTEREST = 4     # patchworkpp.h:85 (near rings: elev+flat gates)

# Patchwork++ defaults (patchworkpp.h:38-108); elevation gates operate in the
# SENSOR frame (ground sits ~ -sensor_height), as in the reference.
UPRIGHTNESS_THR = 0.707
NUM_LPR = 20          # lowest-point representatives for seeding
NUM_MIN_PTS = 10      # patches below this go unfit (patchworkpp.h:84)
TH_SEEDS = 0.125      # seed band above the lowest-point mean
TH_DIST = 0.125       # plane inlier distance
TH_SEEDS_V = 0.25     # R-VPF seed band (patchworkpp.h:95)
TH_DIST_V = 0.1       # R-VPF vertical-plane thickness (patchworkpp.h:96)
SEED_MARGIN = -1.2    # adaptive_seed_selection_margin (patchworkpp.h:99)
NUM_ITER = 3          # R-GPF / R-VPF iterations
TGR_LINE_VAR = 8.0    # line_variable rejection (patchworkpp.cpp:421)
STATS_CAP = 1000.0    # max_{elevation,flatness}_storage (patchworkpp.h:104)

INIT_ELEVATION_THR = (0.0, 0.0, 0.0, 0.0)
INIT_FLATNESS_THR = (0.0, 0.0, 0.0, 0.0)


class GroundState(NamedTuple):
    """Cross-frame adaptive A-GLE state (patchworkpp.cpp:321-358).

    ``*_stats`` rows are capped Welford moments (n, mean, M2) per near ring.
    """
    elev_thr: torch.Tensor    # (NUM_RINGS_OF_INTEREST,)
    flat_thr: torch.Tensor    # (NUM_RINGS_OF_INTEREST,)
    elev_stats: torch.Tensor  # (NUM_RINGS_OF_INTEREST, 3)
    flat_stats: torch.Tensor  # (NUM_RINGS_OF_INTEREST, 3)


def initial_ground_state(device=DEFAULT_DEVICE) -> GroundState:
    """The state before the first frame, on the GPU unless the caller names
    another ``device`` (a CUDA device without a usable GPU raises)."""
    device = resolve_device(device)
    f32 = torch.float32
    r = NUM_RINGS_OF_INTEREST
    return GroundState(
        elev_thr=torch.tensor(INIT_ELEVATION_THR, dtype=f32, device=device),
        flat_thr=torch.tensor(INIT_FLATNESS_THR, dtype=f32, device=device),
        elev_stats=torch.zeros((r, 3), dtype=f32, device=device),
        flat_stats=torch.zeros((r, 3), dtype=f32, device=device),
    )


def ground_state_from_arrays(elev_thr, flat_thr, elev_stats, flat_stats,
                             device=DEFAULT_DEVICE) -> GroundState:
    """A ``GroundState`` from host arrays, e.g. the four fields of the JAX
    package's state as numpy (``np.asarray(field)``); on the GPU unless the
    caller names another ``device``."""
    device = resolve_device(device)
    return GroundState(*(torch.tensor(np.asarray(a), dtype=torch.float32,
                                      device=device)
                         for a in (elev_thr, flat_thr, elev_stats,
                                   flat_stats)))


def _patch_index(xyz: torch.Tensor) -> torch.Tensor:
    """Flat CZM patch id per point; -1 outside [min_range, max_range)."""
    r = torch.sqrt(torch.sum(xyz[:, :2] * xyz[:, :2], dim=1))
    theta = torch.atan2(xyz[:, 1], xyz[:, 0]) + math.pi      # [0, 2pi]
    pid = torch.full(r.shape, -1, dtype=torch.int32, device=xyz.device)
    base = 0
    for z, (nr, ns) in enumerate(zip(ZONE_RINGS, ZONE_SECTORS)):
        lo, hi = ZONE_BOUNDS[z], ZONE_BOUNDS[z + 1]
        in_zone = (r >= lo) & (r < hi)
        ring = torch.clamp(scale_as_xla(r - lo, hi - lo, nr).to(torch.int32),
                           0, nr - 1)
        sector = torch.clamp(
            scale_as_xla(theta, 2 * math.pi, ns).to(torch.int32), 0, ns - 1)
        pid = torch.where(in_zone, base + ring * ns + sector, pid)
        base += nr * ns
    return pid


def _zone_of_patch(device) -> torch.Tensor:
    """(NUM_PATCHES,) zone index of each flat patch id."""
    out = []
    for z, (nr, ns) in enumerate(zip(ZONE_RINGS, ZONE_SECTORS)):
        out += [z] * (nr * ns)
    return torch.tensor(out, dtype=torch.int64, device=device)


def _ring_of_patch(device) -> torch.Tensor:
    """(NUM_PATCHES,) concentric ring index (0..NUM_RINGS-1) per patch."""
    out = []
    ring0 = 0
    for nr, ns in zip(ZONE_RINGS, ZONE_SECTORS):
        for rr in range(nr):
            out += [ring0 + rr] * ns
        ring0 += nr
    return torch.tensor(out, dtype=torch.int64, device=device)


def _welford_update(stats: torch.Tensor, new_n, new_mean, new_m2):
    """Merge per-ring frame moments into capped running moments (Chan et
    al. parallel merge, then the multiplicative storage cap)."""
    n0, mu0, m20 = stats[:, 0], stats[:, 1], stats[:, 2]
    n = n0 + new_n
    safe = torch.clamp(n, min=1e-9)
    delta = new_mean - mu0
    mu = mu0 + delta * new_n / safe
    m2 = m20 + new_m2 + delta * delta * n0 * new_n / safe
    scale = torch.clamp(STATS_CAP / torch.clamp(n, min=1.0), max=1.0)
    out = torch.stack([n * scale, mu, m2 * scale], dim=1)
    return torch.where((new_n > 0)[:, None], out, stats)


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    """Append one zero row: index NUM_PATCHES is "no patch"."""
    return torch.cat([x, torch.zeros_like(x[:1])])


def czm_ground_mask_stateful(
    xyz: torch.Tensor,
    valid: torch.Tensor,
    state: GroundState,
    *,
    patch_cap: int = 256,
    sensor_height: float = 1.723,
    use_consensus: bool = True,
) -> Tuple[torch.Tensor, GroundState]:
    """(N,) bool ground mask + updated adaptive state.

    Points outside the radial range are labelled non-ground (as in
    patchwork++, which simply does not bin them).
    """
    n = xyz.shape[0]
    dev = xyz.device
    f32 = torch.float32
    xyz = xyz.to(f32)
    valid = valid.bool()
    pid = _patch_index(xyz)
    pid = torch.where(valid, pid, torch.full_like(pid, -1))
    key = torch.where(pid >= 0, pid.long(),
                      torch.full_like(pid, NUM_PATCHES, dtype=torch.int64))

    P, K = NUM_PATCHES, patch_cap
    k_iota = torch.arange(K, device=dev)

    def gather_patches(keys):
        """(P,K) z-ascending patch tensors via one global (patch, z) sort."""
        z_order = torch.argsort(xyz[:, 2], stable=True)
        key_z = keys[z_order]
        order = z_order[torch.argsort(key_z, stable=True)]  # patch asc, z asc
        counts = torch.bincount(keys, minlength=P + 1)[:P]
        starts = torch.cumsum(counts, 0) - counts
        gidx = torch.clamp(starts[:, None] + k_iota[None, :], 0, n - 1)
        pmask = k_iota[None, :] < torch.clamp(counts, max=K)[:, None]
        pts = xyz[order[gidx]]                               # (P,K,3) z-asc
        return pts * pmask[:, :, None], pmask, counts

    pts, pmask, counts = gather_patches(key)

    zone = _zone_of_patch(dev)
    ring = _ring_of_patch(dev)
    is_zone0 = zone == 0
    near = ring < NUM_RINGS_OF_INTEREST
    ring_c = torch.clamp(ring, max=NUM_RINGS_OF_INTEREST - 1)

    def seed_select(pts_k, avail, th_seed):
        """Seeds = z < mean(first NUM_LPR available)+th_seed, with the zone-0
        low-outlier floor (patchworkpp.cpp:77-85)."""
        floor_ok = pts_k[:, :, 2] >= (SEED_MARGIN * sensor_height)
        usable = avail & (floor_ok | ~is_zone0[:, None])
        rank = torch.cumsum(usable.to(torch.int32), dim=1) - 1
        lpr = usable & (rank < NUM_LPR)
        w = lpr.to(f32)
        lpr_mean = (torch.sum(pts_k[:, :, 2] * w, 1)
                    / torch.clamp(torch.sum(w, 1), min=1e-9))
        return avail & (pts_k[:, :, 2] < lpr_mean[:, None] + th_seed)

    def fit(pts_k, w):
        """Masked PCA plane fit; n-1 covariance like the reference
        (patchworkpp.cpp:47). Returns plane + raw eigenvalues (ascending)."""
        wf = w.to(f32)
        tot = torch.sum(wf, 1)
        denom = torch.clamp(tot - 1.0, min=1e-9)
        mean = torch.sum(pts_k * wf[:, :, None], 1) / torch.clamp(
            tot, min=1e-9)[:, None]
        c = (pts_k - mean[:, None, :]) * wf[:, :, None]
        cov = torch.einsum("pki,pkj->pij", c, c) / denom[:, None, None]
        cov = 0.5 * (cov + cov.transpose(1, 2))   # as jnp.linalg.eigh does
        evals, evecs = torch.linalg.eigh(cov)                # ascending
        normal = evecs[:, :, 0]
        normal = normal * torch.sign(normal[:, 2:3] + 1e-12)  # point up
        d = -torch.sum(normal * mean, dim=1)
        return normal, d, evals, mean

    def plane_dist(p, nrm, dd):
        return torch.abs(torch.einsum("pki,pi->pk", p, nrm) + dd[:, None])

    # --- R-VPF: remove vertical planes under the ground (zone 0) ---------
    removed_v = torch.zeros_like(pmask)
    vpf_active = is_zone0
    vpf = []                                  # (normal, d, on) per iteration
    for _ in range(NUM_ITER):
        remaining = pmask & ~removed_v
        seeds_v = seed_select(pts, remaining, TH_SEEDS_V)
        nrm, dd, _, _ = fit(pts, seeds_v)
        enough = torch.sum(seeds_v.to(torch.int32), 1) >= 3
        vertical = (torch.abs(nrm[:, 2]) < UPRIGHTNESS_THR) & enough
        act = vpf_active & vertical
        removed_v = removed_v | (act[:, None] & (plane_dist(pts, nrm, dd)
                                                 < TH_DIST_V) & pmask)
        vpf.append((_pad_row(nrm), _pad_row(dd), _pad_row(act)))
        vpf_active = act                                    # break emulation

    pk = torch.clamp(key, max=NUM_PATCHES)

    def vpf_slab(i):
        """(N,) points inside R-VPF iteration i's peeled slab."""
        vn, vd, von = vpf[i]
        dist_v = torch.abs(torch.sum(xyz * vn[pk], dim=1) + vd[pk])
        return von[pk] & (dist_v < TH_DIST_V)

    # Apply the peel to ALL points and re-gather the patch tensors (the
    # capped subset holds the lowest K points; patchworkpp.cpp:463-466,497)
    if bool(torch.stack([v[2] for v in vpf]).any()):        # one host read
        peeled_all = torch.zeros((n,), dtype=torch.bool, device=dev)
        for i in range(NUM_ITER):
            peeled_all = peeled_all | vpf_slab(i)
        key_gpf = torch.where(peeled_all, torch.full_like(key, NUM_PATCHES),
                              key)
        pts_g, pmask_g, _ = gather_patches(key_gpf)
    else:
        pts_g, pmask_g = pts, pmask

    # --- R-GPF: iterative masked PCA plane fit ---------------------------
    inlier = seed_select(pts_g, pmask_g, TH_SEEDS)
    for _ in range(NUM_ITER):
        normal, d, evals, mean = fit(pts_g, inlier)
        inlier = pmask_g & (plane_dist(pts_g, normal, d) < TH_DIST)

    # --- A-GLE acceptance ladder (patchworkpp.cpp:205-265) ---------------
    elevation = mean[:, 2]
    flatness = evals[:, 0]
    line_var = evals[:, 2] / torch.clamp(evals[:, 1], min=1e-12)
    heading = torch.sum(mean * normal, dim=1)

    e_thr = state.elev_thr[ring_c]
    f_thr = state.flat_thr[ring_c]
    upright = torch.abs(normal[:, 2]) > UPRIGHTNESS_THR
    has_fit = (torch.sum(inlier.to(torch.int32), 1) >= 3) & (
        torch.clamp(counts, max=K) >= NUM_MIN_PTS)
    not_elevated = elevation < e_thr
    flat = flatness < f_thr

    if use_consensus:
        # within-frame consensus cap: per-zone mean+3*std of provisionally
        # accepted ground elevations
        acc = (has_fit & upright & not_elevated).to(f32)
        zone_oh = zone[:, None] == torch.arange(len(ZONE_RINGS),
                                                device=dev)[None, :]
        zw = zone_oh.to(f32) * acc[:, None]                  # (P, zones)
        z_cnt = torch.sum(zw, 0)
        z_mean = torch.sum(zw * elevation[:, None], 0) / torch.clamp(
            z_cnt, min=1e-9)
        z_var = (torch.sum(zw * (elevation[:, None] - z_mean[None, :]) ** 2,
                           0) / torch.clamp(z_cnt, min=1e-9))
        consensus = torch.where(z_cnt >= 4,
                                z_mean + 3.0 * torch.sqrt(z_var) + 0.05,
                                torch.full_like(z_cnt, 1e9))
        not_elevated = not_elevated & (elevation < consensus[zone])

    ground_direct = has_fit & upright & (
        ~near | ((heading < 0.0) & (not_elevated | flat)))
    candidate = (has_fit & upright & near & (heading < 0.0)
                 & ~(not_elevated | flat))

    # --- TGR: revert flat-but-elevated candidates (patchworkpp.cpp:385) --
    accepted_for_stats = has_fit & upright & not_elevated & near
    ring_oh = ring_c[:, None] == torch.arange(NUM_RINGS_OF_INTEREST,
                                              device=dev)[None, :]
    rw = ring_oh.to(f32) * accepted_for_stats.to(f32)[:, None]
    r_cnt = torch.sum(rw, 0)
    r_mean_f = torch.sum(rw * flatness[:, None], 0) / torch.clamp(r_cnt,
                                                                  min=1e-9)
    r_var_f = (torch.sum(rw * (flatness[:, None] - r_mean_f[None, :]) ** 2, 0)
               / torch.clamp(r_cnt, min=1e-9))
    mu_f = r_mean_f + 1.5 * torch.sqrt(r_var_f)             # (rings,)
    mu_p = torch.clamp(mu_f[ring_c], min=1e-12)
    prob_flat = 1.0 / (1.0 + torch.exp(torch.clamp(
        (flatness - mu_p) / (mu_p / 10.0), -30.0, 30.0)))
    prob_line = (line_var <= TGR_LINE_VAR).to(f32)
    revert = candidate & (prob_flat * prob_line > 0.5) & (r_cnt[ring_c] > 0)

    ground_patch = ground_direct | revert

    # --- adaptive threshold update (patchworkpp.cpp:321-358) -------------
    new_n = r_cnt
    r_mean_e = torch.sum(rw * elevation[:, None], 0) / torch.clamp(r_cnt,
                                                                   min=1e-9)
    r_m2_e = torch.sum(rw * (elevation[:, None] - r_mean_e[None, :]) ** 2, 0)
    r_m2_f = r_var_f * torch.clamp(r_cnt, min=1e-9)
    elev_stats = _welford_update(state.elev_stats, new_n, r_mean_e, r_m2_e)
    flat_stats = _welford_update(state.flat_stats, new_n, r_mean_f, r_m2_f)

    def thr_from(stats, k_sigma):
        nn = stats[:, 0]
        std = torch.sqrt(stats[:, 2] / torch.clamp(nn, min=1e-9))
        return stats[:, 1] + k_sigma * std, nn > 0

    k_e = torch.tensor([3.0, 2.0, 2.0, 2.0], dtype=f32, device=dev)  # cpp:330
    e_new, e_has = thr_from(elev_stats, k_e)
    f_new, f_has = thr_from(flat_stats, 1.0)
    new_state = GroundState(
        elev_thr=torch.where(e_has, e_new, state.elev_thr),
        flat_thr=torch.where(f_has, f_new, state.flat_thr),
        elev_stats=elev_stats,
        flat_stats=flat_stats,
    )

    # --- classify every point against its patch plane --------------------
    n_pad, d_pad = _pad_row(normal), _pad_row(d)
    gp_pad = _pad_row(ground_patch)
    dist_all = torch.abs(torch.sum(xyz * n_pad[pk], dim=1) + d_pad[pk])
    ground_pt = valid & gp_pad[pk] & (dist_all < TH_DIST)

    # R-VPF slabs are vertical structure, never ground — even where they
    # intersect the accepted ground plane (patchworkpp.cpp:482-485)
    for i in range(NUM_ITER):
        ground_pt = ground_pt & ~vpf_slab(i)

    return ground_pt, new_state


def czm_ground_mask(xyz: torch.Tensor, valid: torch.Tensor, *,
                    patch_cap: int = 256,
                    sensor_height: float = 1.723) -> torch.Tensor:
    """Stateless wrapper: (N,) bool CZM ground mask (adaptive state
    initialised fresh and discarded — single-frame semantics)."""
    mask, _ = czm_ground_mask_stateful(
        xyz, valid, initial_ground_state(xyz.device),
        patch_cap=patch_cap, sensor_height=sensor_height)
    return mask


def segment_ground(
    xyz: torch.Tensor,
    valid: torch.Tensor,
    *,
    range_z: float,
    ground_slack: float,
    sensor_height: float = 1.723,
    patch_cap: int = 256,
    use_czm: bool = True,
    state: Optional[GroundState] = None,
) -> torch.Tensor:
    """Non-ground mask, reference semantics (`utils_ground.py:16-32`).

    non-ground iff  z > range_z + ground_slack  AND  not CZM-ground.
    Pass ``state`` (and use :func:`segment_ground_stateful`) to carry the
    adaptive A-GLE/TGR state across the frames of a sequence.
    """
    valid = valid.bool()
    above = xyz[:, 2] > (range_z + ground_slack)
    if not use_czm:
        return valid & above
    if state is None:
        czm = czm_ground_mask(xyz, valid, patch_cap=patch_cap,
                              sensor_height=sensor_height)
        return valid & above & ~czm
    nonground, _ = segment_ground_stateful(
        xyz, valid, state, range_z=range_z, ground_slack=ground_slack,
        sensor_height=sensor_height, patch_cap=patch_cap)
    return nonground


def segment_ground_stateful(
    xyz: torch.Tensor,
    valid: torch.Tensor,
    state: GroundState,
    *,
    range_z: float,
    ground_slack: float,
    sensor_height: float = 1.723,
    patch_cap: int = 256,
) -> Tuple[torch.Tensor, GroundState]:
    """Sequence form: non-ground mask + updated adaptive state."""
    valid = valid.bool()
    above = xyz[:, 2] > (range_z + ground_slack)
    czm, new_state = czm_ground_mask_stateful(
        xyz, valid, state, patch_cap=patch_cap, sensor_height=sensor_height)
    return valid & above & ~czm, new_state
