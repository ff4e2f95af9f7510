"""Benchmark CLI: the reference `main.py` surface in PyTorch on one GPU.

Same flag names as `main.py:45-132` (so `main.sh` presets translate 1:1),
same per-sample flow: dataset -> per-pair track -> flow -> metric sweep ->
final report + optional npz dumps (`main.py:156-314`). The mutable
``args.translation_frame`` of the reference becomes an explicit per-pair
value (`main.py:200` semantics computed per gap). Port of
``icpflow_tpu/cli.py``: the same flags plus ``--device`` (the GPU unless
``--device cpu``, which takes the plain PyTorch versions of the kernels).

Run e.g.:
    python -m icpflow_tpu_torch.cli --dataset waymo --split test --root /data/pca/
    python -m icpflow_tpu_torch.cli ... --dp 2 --cp 2      # 4 ranks, this host
    torchrun --nnodes N --nproc-per-node G -m icpflow_tpu_torch.cli ... \
        --dp D --cp C --multihost                           # D * C = N * G
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .config import PRESETS, PipelineConfig
from .device import DEFAULT_DEVICE, StageClock, resolve_device
from .metrics import (CATEGORIES, compute_epe, crop_for_eval, make_meters,
                      meters_from_state, meters_to_state, report,
                      update_metrics)
from .models.icp_flow import SceneFlowEngine
from .parallel.mesh import init_world, local_world, make_mesh
from .parallel.shard import (broadcast_batch, make_sharded_step, serve_pairs,
                             stop_ranks)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SceneFlow (PyTorch)")
    p.add_argument("--identifier", type=str, default="run")
    p.add_argument("--dataset", type=str, default="waymo",
                   choices=["waymo", "nuscene", "argo", "demo"])
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--root", type=str, default="./")
    p.add_argument("--num_frames", type=int, default=None)
    p.add_argument("--range_x", type=float, default=None)
    p.add_argument("--range_y", type=float, default=None)
    p.add_argument("--range_z", type=float, default=None)
    p.add_argument("--ground_slack", type=float, default=None)
    p.add_argument("--num_clusters", type=int, default=None)
    p.add_argument("--min_cluster_size", type=int, default=None)
    p.add_argument("--epsilon", type=float, default=None)
    p.add_argument("--if_hdbscan", action="store_true")
    p.add_argument("--speed", type=float, default=None)
    p.add_argument("--thres_dist", type=float, default=None)
    p.add_argument("--max_points", type=int, default=None)
    p.add_argument("--thres_box", type=float, default=None)
    p.add_argument("--thres_error", type=float, default=None)
    p.add_argument("--thres_iou", type=float, default=None)
    p.add_argument("--thres_rot", type=float, default=None)
    p.add_argument("--if_kiss_icp", action="store_true")
    p.add_argument("--eval_ground", action="store_true")
    p.add_argument("--if_save", action="store_true")
    p.add_argument("--if_verbose", action="store_true")
    # pairing-mode naming flags (main.py:271-276 reads these only to pick the
    # save folder; defining them here also fixes the reference's latent
    # AttributeError on `main.py --if_save`)
    p.add_argument("--if_adjacent", action="store_true")
    p.add_argument("--if_temporal", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="with --if_save: skip samples whose flow output "
                        "already exists (file-level resume)")
    p.add_argument("--log_jsonl", type=str, default=None,
                   help="append one JSON line of per-sample metrics to this "
                        "file (machine-readable run trace)")
    p.add_argument("--max_samples", type=int, default=None,
                   help="process only the first N samples")
    # distribution (framework extension; the reference is explicitly
    # single-GPU, main.py:141-142): shard each sample's frame pairs over a
    # (dp, cp) mesh of ranks via parallel/shard.make_sharded_step -- dp
    # across frame pairs, cp across cluster-pair buckets
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel width over frame pairs")
    p.add_argument("--cp", type=int, default=1,
                   help="cluster-pair parallel width inside the matcher")
    p.add_argument("--multihost", action="store_true",
                   help="join the ranks a launcher started (torchrun's RANK, "
                        "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) "
                        "instead of starting dp * cp ranks on this host")
    p.add_argument("--device", type=str, default=DEFAULT_DEVICE,
                   help="torch device; 'cpu' runs the plain PyTorch "
                        "versions of the kernels")
    # static-shape bucket overrides (framework-specific)
    p.add_argument("--max_points_scene", type=int, default=None)
    p.add_argument("--max_pairs", type=int, default=None)
    p.add_argument("--pairs_small", type=int, default=None)
    p.add_argument("--pairs_large", type=int, default=None)
    p.add_argument("--nn_tile", type=int, default=None)
    p.add_argument("--hist_grid_xy", type=int, default=None)
    p.add_argument("--ego_map_capacity", type=int, default=None)
    p.add_argument("--eps_scale_per_m", type=float, default=None)
    p.add_argument("--eps_max", type=float, default=None)
    return p


_OVERRIDE_FIELDS = (
    "num_frames", "range_x", "range_y", "range_z", "ground_slack",
    "num_clusters", "min_cluster_size", "epsilon", "speed", "thres_dist",
    "max_points", "thres_box", "thres_error", "thres_iou", "thres_rot",
    "max_points_scene", "max_pairs", "pairs_small", "pairs_large",
    "nn_tile", "hist_grid_xy", "ego_map_capacity",
    "eps_scale_per_m", "eps_max",
)


def config_from_args(args) -> PipelineConfig:
    cfg = PRESETS[args.dataset]
    over = {f: getattr(args, f) for f in _OVERRIDE_FIELDS
            if getattr(args, f) is not None}
    if args.if_hdbscan:
        over["use_hdbscan"] = True
    if args.if_kiss_icp:
        over["use_kiss_icp"] = True
    if args.eval_ground:
        over["eval_ground"] = True
    return cfg.replace(**over)


def _run_pairs_sharded(engine, step, dp, cfg, data, pairs,
                       ms: Optional[dict] = None):
    """All frame pairs of one sample through the (dp, cp)-sharded step.

    Pads every pair's clouds to one shared bucket (the step takes one
    batch), rounds the batch up to a multiple of dp with dummy pairs (empty
    masks: identity transforms, flow ignored), broadcasts it to the ranks
    and returns (per-pair flows trimmed to their point counts, the metric
    sums over the mesh, per-pair overflow). ``ms``, when a dict, receives
    the ``pad``, ``broadcast`` and ``step`` milliseconds."""
    clock = StageClock(ms, engine.device, "offline.sharded")
    clock.mark("pad")
    ego_poses = data["ego_poses"]
    ti = data["time_indice"]
    n_pairs = len(pairs)
    B = -(-n_pairs // dp) * dp
    n_max = max(max(len(p["point_src"]), len(p["point_dst"])) for p in pairs)
    bucket = 2048
    while bucket < n_max:
        bucket *= 2
    bucket = min(bucket, cfg.max_points_scene)

    ps = np.zeros((B, bucket, 3), np.float32)
    vs = np.zeros((B, bucket), bool)
    ls = np.full((B, bucket), -1, np.int32)
    pd_ = np.zeros((B, bucket, 3), np.float32)
    vd = np.zeros((B, bucket), bool)
    ld = np.full((B, bucket), -1, np.int32)
    gt = np.zeros((B, bucket, 3), np.float32)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    tfs = np.ones((B,), np.float32)
    for i, pair in enumerate(pairs):
        j = i + 1
        ps[i], vs[i], ls[i] = engine.pad_cloud(
            pair["point_src"], pair["label_src"], bucket=bucket)
        pd_[i], vd[i], ld[i] = engine.pad_cloud(
            pair["point_dst"], pair["label_dst"], bucket=bucket)
        gtj = data["scene_flow"][ti == j]
        gt[i, : len(gtj)] = gtj
        poses[i] = ego_poses[j].astype(np.float32)
        tfs[i] = max(cfg.speed * j,
                     float(np.linalg.norm(ego_poses[j][:3, 3]))) * 2.0
    clock.mark("broadcast")
    batch = broadcast_batch((ps, vs, ls, pd_, vd, ld, gt, poses, tfs),
                            engine.device)
    clock.mark("step")
    flow_b, _transforms, sums = step(*batch)
    flow_b = flow_b.cpu().numpy()
    clock.mark("end")
    clock.finish()
    flows = [flow_b[i, : len(pairs[i]["point_src"])] for i in range(n_pairs)]
    return flows, sums.cpu().numpy(), step.overflow[:n_pairs].tolist()


def run(args, timings: Optional[list] = None,
        ranks: Optional[list] = None) -> dict:
    """Process the dataset and return ``{meter name: epe_avg}``.

    ``timings``, when a list, receives one dict a sample: the milliseconds
    of its ``load``, ``ground``, ``ego`` and ``cluster`` stages and, under
    ``pairs``, of each frame pair's ``pad``, ``track`` and ``flow`` (under
    ``sharded``, of the sample's ``pad``, ``broadcast`` and ``step``, when
    the pairs go through the sharded step).

    With ``--dp`` / ``--cp`` above 1 each sample's frame pairs go through
    the sharded step of a (dp, cp) mesh of dp * cp ranks: processes this
    call starts on this host, the caller being rank 0, or with
    ``--multihost`` the processes a launcher started, each of which calls
    ``run``. Rank 0 reads the samples, keeps the meters and writes the
    files; every rank returns its result. ``ranks``, when a list,
    receives every rank's NN kernel launches and plain NN calls
    (``parallel.shard.rank_stats``) once the sharded run ends."""
    cfg = config_from_args(args)
    resolve_device(args.device)
    n_ranks = args.dp * args.cp
    if args.multihost:
        init_world(args.device)
        try:
            if dist.get_world_size() != n_ranks:
                raise ValueError(f"--multihost: {dist.get_world_size()} "
                                 f"ranks, --dp * --cp is {n_ranks}")
            if dist.get_rank() == 0:
                out = [_run(args, cfg, timings, ranks)]
            else:
                serve_pairs(cfg, args.dp, args.cp, args.device)
                out = [None]
            if n_ranks > 1:
                dist.broadcast_object_list(out, src=0)
            return out[0]
        finally:
            dist.destroy_process_group()
    if n_ranks > 1:
        if torch.device(args.device).type == "cuda":
            from .ops.cuda import nn_kernel
            nn_kernel.build()     # once, before the ranks load it
        with local_world(n_ranks, args.device, serve_pairs,
                         (cfg, args.dp, args.cp, args.device)):
            return _run(args, cfg, timings, ranks)
    return _run(args, cfg, timings, ranks)


def _run(args, cfg: PipelineConfig, timings, ranks) -> dict:
    """Rank 0's part of ``run``: read the samples, match their pairs
    (through the sharded step with --dp / --cp above 1), score, write."""
    engine = SceneFlowEngine(cfg, device=args.device)
    step = None
    if args.dp * args.cp > 1:
        step = make_sharded_step(make_mesh(args.dp, args.cp, args.device),
                                 cfg)
        print(f"sharded step over mesh dp={args.dp} cp={args.cp} "
              f"backend={dist.get_backend()}")

    if args.dataset in ("waymo", "nuscene"):
        from .data.pca import DatasetPCA
        ds = DatasetPCA(cfg, args.root, args.split, device=args.device)
    else:
        from .data.argo import DatasetArgo
        ds = DatasetArgo(cfg, args.root, args.split, device=args.device)
    if timings is not None:
        ds.timings = {}
    n_samples = len(ds)
    if args.max_samples:
        n_samples = min(n_samples, args.max_samples)
    print(f"number of test sequences: {len(ds)} (running {n_samples})")

    state_path = f"meters_{args.dataset}_{args.split}.json"
    completed = set()
    meters = make_meters(cfg.num_frames)
    if args.resume and os.path.exists(state_path):
        with open(state_path) as f:
            st = json.load(f)
        meters = meters_from_state(st.get("meters", {}), cfg.num_frames)
        completed = set(st.get("completed", []))
        print(f"resumed meter state: {len(completed)} samples done")
    start = time.time()

    def _flow_path(data_path: str) -> str:
        path = data_path
        suffix = "_icp_flow" if cfg.use_kiss_icp else "_icp_flow_ego"
        if args.if_adjacent:
            suffix += "_adjacent"
        elif args.if_temporal:
            suffix += "_temporal"
        for folder in ("train", "val", "test"):
            if folder in path:
                return path.replace(folder, folder + suffix)
        return path.replace(".npz", suffix + ".npz")

    # native prefetch plane: npz decode for sample k+1..k+depth overlaps the
    # device compute of sample k (PrefetchIterMixin / native PrefetchPool)
    pending = []
    for k in range(n_samples):
        if args.resume and ds.seq_paths[k] in completed:
            print(f"Skipping sample {k} (resume: already scored)")
            continue
        pending.append(k)
    for k, data, pairs in ds.iter_samples(pending):
        ego_poses = data["ego_poses"]
        ti = data["time_indice"]
        flows = [np.zeros((int((ti == 0).sum()), 3), np.float32)]
        pair_times = []
        sample_ms = None if timings is None else {}

        if step is not None:
            pair_flows, dev_sums, overflows = _run_pairs_sharded(
                engine, step, args.dp, cfg, data, pairs, sample_ms)
            flows.extend(pair_flows)
            for overflow in overflows:
                if overflow > 0:
                    print(f"  WARNING: {overflow} candidate pairs beyond the "
                          f"pair buckets were dropped (raise --max_pairs / "
                          f"pairs_small)")
            if args.if_verbose:
                print(f"  device metric sums (summed over the mesh): "
                      f"n={dev_sums[0]:.0f} "
                      f"epe={dev_sums[1] / max(dev_sums[0], 1):.5f}")
        for j, pair in ([] if step is not None else enumerate(pairs, 1)):
            pair_ms = None if timings is None else {}
            clock = StageClock(pair_ms, engine.device, "offline.pair")
            clock.mark("pad")
            # per-pair dynamic search radius, main.py:200
            tf = max(cfg.speed * j,
                     float(np.linalg.norm(ego_poses[j][:3, 3]))) * 2.0
            p_src, v_src, l_src = engine.pad_cloud(
                pair["point_src"], pair["label_src"])
            p_dst, v_dst, l_dst = engine.pad_cloud(
                pair["point_dst"], pair["label_dst"])
            clock.mark("track")
            out = engine.track_pair(p_src, v_src, l_src, p_dst, v_dst, l_dst,
                                    tf)
            clock.mark("flow")
            raw_src = data["raw_points"][ti == j, :3].astype(np.float32)
            # note: identity_pt/seg_pidx index the PADDED ego-aligned cloud,
            # which shares its prefix ordering with raw_src
            npad = p_src.shape[0]
            raw_pad = np.zeros((npad, 3), np.float32)
            raw_pad[: len(raw_src)] = raw_src
            flow = engine.flow(
                raw_pad, l_src, out.result.transforms,
                ego_poses[j].astype(np.float32), seg_pidx=out.seg_src.pidx,
                identity_pt=out.result.identity_pt
            ).cpu().numpy()[: len(raw_src)]
            overflow = int(out.result.overflow)
            if overflow > 0:
                print(f"  WARNING: {overflow} candidate pairs beyond the "
                      f"pair buckets were dropped (raise --max_pairs / "
                      f"pairs_small)")
            flows.append(flow)
            clock.mark("end")
            clock.finish()
            pair_times.append(pair_ms)
        if timings is not None:
            timings.append(dict(ds.timings, pairs=pair_times))
            if step is not None:
                timings[-1]["sharded"] = sample_ms

        flow_seq = np.concatenate(flows)
        # metric protocol: crop + category sweep (utils_eval.py:185-368)
        if cfg.eval_ground:
            keep = np.ones(len(flow_seq), bool)
        else:
            keep = crop_for_eval(
                data["raw_points"], range_x=cfg.range_x, range_y=cfg.range_y,
                range_z=cfg.range_z, ground_slack=cfg.ground_slack,
                eval_ground=cfg.eval_ground)
        update_metrics(
            meters,
            flow_pred=flow_seq[keep], flow_gt=data["scene_flow"][keep],
            sd_labels=data["sd_labels"][keep],
            fb_labels=data["fb_labels"][keep],
            time_indice=ti[keep], num_frames=cfg.num_frames)
        print(f"Processed sample {k}/{n_samples}, {data['data_path']}")
        if args.resume or args.if_save:
            completed.add(data["data_path"])
            with open(state_path, "w") as f:
                json.dump({"completed": sorted(completed),
                           "meters": meters_to_state(meters)}, f)

        if args.log_jsonl:
            vals = compute_epe(flow_seq[keep], data["scene_flow"][keep],
                               np.asarray(ti[keep]) > 0)
            with open(args.log_jsonl, "a") as f:
                f.write(json.dumps({
                    "sample": k, "path": data["data_path"],
                    "epe3d": round(vals[0], 6), "acc3ds": round(vals[1], 6),
                    "acc3dr": round(vals[2], 6),
                    "outlier": round(vals[3], 6),
                    "n_points": int(keep.sum()),
                    "elapsed_s": round(time.time() - start, 2),
                }) + "\n")

        if args.if_verbose:
            # per-frame debug dump (reference --if_verbose, main.py:241-256)
            from .utils.viz import debug_frame
            j_last = cfg.num_frames - 1
            sel = ti == j_last
            debug_frame({
                "src": data["raw_points"][sel, :3],
                "src_label": pairs[j_last - 1]["label_src"],
                "flow": flow_seq[sel],
                "scene_flow": data["scene_flow"][sel],
            }, prefix=os.path.join(tempfile.gettempdir(),
                                   f"icpflow_cli_sample{k}"))

        if args.if_save:
            path = _flow_path(data["data_path"])
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.savez_compressed(path, scene_flow=flow_seq,
                                ego_motion=ego_poses)

    if step is not None:
        stats = stop_ranks(args.device)
        if ranks is not None:
            ranks.extend(stats)
    print("#" * 30, "Results over the entire dataset", "#" * 30)
    print(report(meters, cfg.num_frames))
    print(f"total time (hours): {(time.time() - start) / 3600.0:.4f}")

    if args.if_save:
        out = {}
        for kk in range(cfg.num_frames + 1):
            for cat in CATEGORIES:
                m = meters[f"{cat}_{kk}"]
                out[f"EPE3D_{cat}_{kk}"] = m.epe_avg
                out[f"ACC3DS_{cat}_{kk}"] = m.accs_avg
                out[f"ACC3DR_{cat}_{kk}"] = m.accr_avg
                out[f"OUTLIER_{cat}_{kk}"] = m.outlier_avg
                out[f"ROUTLIER_{cat}_{kk}"] = m.routlier_avg
        stamp = datetime.datetime.now().strftime("%y%m%d-%H%M%S")
        np.savez(f"metrics_{args.dataset}_{args.split}_{stamp}.npz", **out)
    return {name: meters[name].epe_avg for name in meters}


def main():
    args = build_parser().parse_args()
    print("start processing at:", datetime.datetime.now())
    print("args:", args)
    run(args)
    print("end processing at:", datetime.datetime.now())


if __name__ == "__main__":
    main()
