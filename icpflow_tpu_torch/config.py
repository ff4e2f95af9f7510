"""Pipeline configuration (PyTorch port of ``icpflow_tpu/config.py``).

The same frozen dataclass, field for field, with the same defaults and
presets, so a configuration carries across packages with
``config_from_dict(dataclasses.asdict(other_cfg))``. The pipeline has no
weights: this dataclass is its whole static state. The state a stream
carries across frames comes over from host arrays with
``ops.ground.ground_state_from_arrays`` and ``EgoOdometry.from_arrays``.

Fields that size buckets (``max_points_scene``, ``max_points``,
``num_clusters``, ``pairs_small``...) keep their meaning: the port pads and
caps exactly where the reference does, because clustering caps and pair
buckets decide which work runs and so change the results.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration of the scene-flow engine (reference flag set,
    ICP-Flow `main.py:45-132`)."""

    # --- dataset / scene crop ---
    dataset: str = "argo"
    num_frames: int = 2
    range_x: float = 32.0
    range_y: float = 32.0
    range_z: float = 0.0
    ground_slack: float = 0.3
    eval_ground: bool = False

    # --- clustering ---
    num_clusters: int = 200
    min_cluster_size: int = 30
    epsilon: float = 0.25
    use_hdbscan: bool = False
    # adaptive clustering: eps_i = clip(eps + scale * range_i, eps, eps_max)
    eps_scale_per_m: float = 0.0
    eps_max: float = 0.8
    # hdbscan (use_hdbscan=True -> ops/hdbscan.py; field meanings as in the
    # reference's config.py). hdbscan_knn_recall changes nothing here: the
    # port's kNN graph is exact. hdbscan_fetch_f16 rounds the edge weights
    # the spanning tree sees to f16, so it changes labels.
    hdbscan_edges: int = 8
    hdbscan_cells: tuple = (0.35, 1.0, 3.0)
    hdbscan_cell_cap: int = 192
    hdbscan_exact: bool = True
    hdbscan_dedup_voxel: float = 0.15
    hdbscan_rep_cap: int = 32768
    hdbscan_reclaim: float = 0.5
    hdbscan_knn_recall: float = 0.0
    hdbscan_fetch_f16: bool = False

    # --- histogram translation init (ops/hist.py) ---
    speed: float = 1.67
    translation_max: float = 12.8
    hist_grid_xy: int = 128       # wrapped grid cells per xy axis
    hist_grid_z: int = 8          # wrapped grid cells along z
    hist_grid_xy_small: int = 0   # small-bucket grid override (0 = same)
    hist_topk: int = 5            # NMS peaks kept
    hist_nms_kernel: int = 11     # NMS max-pool kernel
    # yaw hypotheses scored at the winning translation; (0.0,) disables
    hist_yaws: tuple = (0.0, -0.3, -0.15, 0.15, 0.3)
    # two-phase hypothesis scoring: coarse forward-only ranking on a
    # hist_coarse_cap-query subset, top hist_refine re-scored in full
    hist_coarse_cap: int = 256
    hist_refine: int = 2
    # gap-scaled yaw window: yaw values stretch by
    # clip(hist_yaw_per_m * translation_frame / max_yaw, 1, cap)
    hist_yaw_per_m: float = 0.03
    hist_yaw_scale_cap: float = 2.0

    # --- icp (ops/icp.py) ---
    thres_dist: float = 0.1
    max_points: int = 10000
    icp_max_iters: int = 100
    icp_patience: int = 10        # stale iterations before a pair freezes
    icp_stall_rel: float = 1e-3   # relative rmse gain that counts as progress
    icp_corr_cap: int = 1024      # source-side correspondence stride cap
    icp_init_margin: float = 0.0
    icp_init_margin_rel: float = 0.02
    icp_coarse_iters: int = 6
    icp_coarse_scale: float = 3.0
    icp_coarse_min_tf: float = 10.0
    # tail compaction of the reference; the port always runs only the
    # unfrozen rows, which is the same computation
    icp_shrink: int = 8

    # --- pair gating (match/gates.py) ---
    thres_box: float = 0.1
    thres_error: float = 0.2
    thres_iou: float = 0.2
    thres_rot: float = 0.1
    inlier_scale_per_m: float = 0.0
    inlier_radius_max: float = 0.3
    thres_z: float = 0.3
    per_point_identity: bool = False
    identity_margin: float = 0.02

    # --- buckets ---
    max_points_scene: int = 131072   # padded full-cloud size per frame
    max_pairs: int = 256             # stage-2 cluster-pair bucket
    max_points_small: int = 512      # point count of the small pair bucket
    pairs_small: int = 256
    pairs_large: int = 32
    # the reference's ladder of bucket sizes; the port solves exactly the
    # valid pairs, which is the same computation
    pair_ladder: tuple = (1, 2, 4, 8, 16)
    nn_tile: int = 2048              # dst tile of the plain NN sweep
    cluster_cell_cap: int = 64       # DBSCAN candidate cap (run cap = 2x)
    cluster_max_iters: int = 100     # label-propagation iteration cap
    cluster_dedup_voxel: float = 0.0  # >0: DBSCAN on voxel representatives
    cluster_rep_cap: int = 65536     # representative bucket

    # --- ego motion (ops/ego.py) ---
    use_kiss_icp: bool = False
    ego_voxel_size: float = 0.64
    ego_map_per_voxel: int = 20
    ego_max_range: float = 64.0
    ego_min_range: float = 1.0
    ego_map_capacity: int = 262144
    ego_src_capacity: int = 16384
    ego_initial_threshold: float = 2.0
    ego_min_motion_th: float = 0.1
    ego_refine_sigmas: tuple = (1.0, 0.3, 0.1)
    ego_max_iters: int = 500

    # --- numerics ---
    dtype_points: str = "float32"

    @property
    def hist_bin(self) -> float:
        """Histogram bin width == icp inlier distance."""
        return self.thres_dist

    def translation_frame(self, gap: int, ego_translation: float = 0.0) -> float:
        """Per-pair search radius (ICP-Flow `main.py:200`)."""
        return max(self.speed * gap, ego_translation) * 2.0

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def config_from_dict(d: dict) -> PipelineConfig:
    """Build a config from ``dataclasses.asdict`` output of either package.

    Lists (as JSON gives them) become tuples, so the result stays hashable.
    Unknown keys raise, so a field added on one side is noticed.
    """
    names = {f.name for f in dataclasses.fields(PipelineConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown PipelineConfig fields: {sorted(unknown)}")
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    return PipelineConfig(**kw)


# Presets (ICP-Flow `main.sh:3-43`, `demo.sh:3-15`), range-adaptive DBSCAN.
WAYMO = PipelineConfig(
    dataset="waymo", num_frames=5, range_x=32.0, range_y=32.0, range_z=0.04,
    ground_slack=0.3, num_clusters=200, min_cluster_size=30,
    epsilon=0.6, eps_scale_per_m=0.012, eps_max=0.8,
    speed=1.67, thres_dist=0.1, max_points=10000,
    thres_box=0.1, thres_rot=0.1, thres_error=0.3, thres_iou=0.2,
    inlier_scale_per_m=0.02,
)

NUSCENES = PipelineConfig(
    dataset="nuscene", num_frames=11, range_x=32.0, range_y=32.0, range_z=-1.84,
    ground_slack=0.3, num_clusters=200, min_cluster_size=20,
    epsilon=0.6, eps_scale_per_m=0.012, eps_max=0.8,
    speed=0.833333, thres_dist=0.1, max_points=5000,
    thres_box=0.1, thres_rot=0.1, thres_error=0.2, thres_iou=0.2,
    inlier_scale_per_m=0.02,
)

ARGO = PipelineConfig(
    dataset="argo", num_frames=2, range_x=10000.0, range_y=10000.0,
    range_z=-10000.0, ground_slack=0.0, use_hdbscan=False, num_clusters=200,
    min_cluster_size=20, epsilon=0.6, eps_scale_per_m=0.012, eps_max=0.8,
    speed=1.67, thres_dist=0.1,
    max_points=10000, thres_box=0.1, thres_rot=0.1, thres_error=0.2,
    thres_iou=0.2, inlier_scale_per_m=0.02,
)

DEMO = ARGO.replace(speed=1.0)

PRESETS = {"waymo": WAYMO, "nuscene": NUSCENES, "argo": ARGO, "demo": DEMO}
