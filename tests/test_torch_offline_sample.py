"""The offline CLI's per-sample step on the CPU: ``cli.process_sample``
(what ``cli.run`` runs for each unsharded sample) and ``cli.run_sample``
(the same step from one sample's path, one call, as the benchmark's
``offline`` entry drives it).

* On a 3-frame sample of the benchmark's nuScenes mix
  (``benchmark/traffic/pca_samples.py``), thinned, at the CLI tests' small
  buckets: the flow, transforms, pairs tables, labels and meters equal
  those of the benchmark's plain reference (``benchmark/reference/
  offline.py``) to the bit. Both run the same plain PyTorch and numpy
  operations in the same order on the same device, so no tolerance is
  allowed; the card's comparison has the cell's limits
  (``benchmark/limits/nuscenes_cli.multigap.json``).
* On the CLI tests' 3-frame box fixture: ``cli.run``'s meters equal, to
  the bit, those of a frozen copy of the per-sample body ``cli.run`` had
  before it was factored out, and those of ``run_sample`` over the same
  files. The meters are sums of the same float64 terms added in the same
  order, so no tolerance is allowed.
* Traced, ``run_sample`` leaves one record, root span ``icpflow.sample``,
  holding its pairs' and its sweep's spans and counters; untraced, none.
"""

import dataclasses
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from benchmark.reference import offline as ref_offline
from benchmark.reference.engine import Reference
from benchmark.traffic import pca_samples
from icpflow_tpu_torch import SceneFlowEngine, cli, trace
from icpflow_tpu_torch.config import NUSCENES
from icpflow_tpu_torch.data.pca import DatasetPCA
from icpflow_tpu_torch.metrics import (crop_for_eval, make_meters,
                                       update_metrics)

from test_cli_pca import make_pca_npz

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(max_points_scene=4096, max_points=512, max_pairs=32,
             pairs_small=32, pairs_large=4, nn_tile=256, hist_grid_xy=64)
CFG = NUSCENES.replace(num_frames=3, **SMALL)
THIN = 16


@pytest.fixture(scope="module")
def nuscenes_sample(tmp_path_factory):
    """(path, arrays) of one 3-frame sample of the multigap mix, every
    ``THIN``-th point of each sweep kept."""
    mix = json.loads((REPO / "benchmark" / "traffic" / "multigap.json")
                     .read_text())
    arrays = pca_samples.sample(np.random.SeedSequence(2 ** 40 + 3), 3,
                                float(mix["hz"]), int(mix["sweep_thin"]),
                                mix["extra"], 0)
    arrays = pca_samples.thinned(arrays, THIN)
    assert pca_samples.sweep_sizes(arrays, CFG.range_x).max() \
        <= CFG.max_points_scene
    path = tmp_path_factory.mktemp("nuscenes") / "sample_00.npz"
    np.savez_compressed(path, **arrays)
    return str(path), arrays


def _meter_sums(meters) -> np.ndarray:
    return np.array([[m.num, m.epe_sum, m.accs_sum, m.accr_sum,
                      m.outlier_sum, m.routlier_sum]
                     for m in meters.values()])


def test_run_sample_equals_the_reference(nuscenes_sample):
    path, arrays = nuscenes_sample
    eng = SceneFlowEngine(CFG, device="cpu")
    ds = DatasetPCA(CFG, os.path.dirname(path), "test", device="cpu")
    meters = make_meters(CFG.num_frames)
    res = cli.run_sample(eng, ds, path, meters)
    ref = ref_offline.sample(Reference(dataclasses.asdict(CFG), "cpu"),
                             arrays)

    assert len(res.results) == len(ref["transforms"]) == CFG.num_frames - 1
    np.testing.assert_array_equal(res.flow, ref["flow"])
    tables = [eng.pairs_array(r) for r in res.results]
    assert sum(len(t) for t in tables) > 0       # clusters were matched
    for j, r in enumerate(res.results):
        np.testing.assert_array_equal(r.transforms.numpy(),
                                      ref["transforms"][j])
        np.testing.assert_array_equal(tables[j], ref["pairs"][j])
        np.testing.assert_array_equal(res.pairs[j]["label_src"],
                                      ref["labels_src"][j])
        np.testing.assert_array_equal(res.pairs[j]["label_dst"],
                                      ref["labels_dst"][j])
    assert list(meters) == ref_offline.meter_names(CFG.num_frames)
    np.testing.assert_array_equal(_meter_sums(meters), ref["meters"])
    assert meters["overall_0"].num > 0


def test_a_traced_sample_leaves_one_record(nuscenes_sample):
    path, _ = nuscenes_sample
    eng = SceneFlowEngine(CFG, device="cpu")
    ds = DatasetPCA(CFG, os.path.dirname(path), "test", device="cpu")
    trace.clear()
    untraced = cli.run_sample(eng, ds, path, make_meters(CFG.num_frames))
    assert trace.calls() == []
    timings = {}
    traced = cli.run_sample(eng, ds, path, make_meters(CFG.num_frames),
                            timings)
    np.testing.assert_array_equal(traced.flow, untraced.flow)
    calls = trace.calls()
    assert len(calls) == 1
    rec = calls[0]
    assert rec.entry == "sample"
    assert rec.spans["icpflow.sample"].parents == {trace.ROOT: 1}
    for name in ("icpflow.score", "icpflow.track", "icpflow.hist_init",
                 "icpflow.load", "icpflow.ground", "icpflow.cluster"):
        assert rec.spans[name].count >= 1, name
    assert rec.spans["icpflow.score"].count == 1
    assert rec.spans["icpflow.track"].count == CFG.num_frames - 1
    assert rec.counters["offline_pairs"] == CFG.num_frames - 1
    assert rec.counters["score_points"] == int(traced.keep.sum()) > 0
    assert rec.counters["icp_iters"] > 0
    # the flat timings: each stage summed over the sample
    assert set(timings) == {"load", "ground", "ego", "cluster", "pad",
                            "track", "flow"}
    assert all(v >= 0 for v in timings.values())


def _argv(root):
    return ["--dataset", "waymo", "--split", "test", "--root", root,
            "--num_frames", "3", "--range_x", "32", "--range_y", "32",
            "--range_z", "0.0", "--ground_slack", "0.3", "--num_clusters",
            "32", "--min_cluster_size", "20", "--epsilon", "0.4", "--speed",
            "1.67", "--max_points", "1024", "--device", "cpu"]


def _pre_refactor_meters(cfg, root):
    """The per-sample body of ``cli._run`` before ``process_sample`` was
    factored out of it (unsharded, untraced), frozen here: every sample of
    the dataset matched, its flow computed, cropped and swept."""
    engine = SceneFlowEngine(cfg, device="cpu")
    ds = DatasetPCA(cfg, root, "test", device="cpu")
    meters = make_meters(cfg.num_frames)
    for k, data, pairs in ds.iter_samples(range(len(ds))):
        ego_poses = data["ego_poses"]
        ti = data["time_indice"]
        flows = [np.zeros((int((ti == 0).sum()), 3), np.float32)]
        for j, pair in enumerate(pairs, 1):
            tf = max(cfg.speed * j,
                     float(np.linalg.norm(ego_poses[j][:3, 3]))) * 2.0
            p_src, v_src, l_src = engine.pad_cloud(
                pair["point_src"], pair["label_src"])
            p_dst, v_dst, l_dst = engine.pad_cloud(
                pair["point_dst"], pair["label_dst"])
            out = engine.track_pair(p_src, v_src, l_src, p_dst, v_dst,
                                    l_dst, tf)
            raw_src = data["raw_points"][ti == j, :3].astype(np.float32)
            npad = p_src.shape[0]
            raw_pad = np.zeros((npad, 3), np.float32)
            raw_pad[: len(raw_src)] = raw_src
            flow = engine.flow(
                raw_pad, l_src, out.result.transforms,
                ego_poses[j].astype(np.float32), seg_pidx=out.seg_src.pidx,
                identity_pt=out.result.identity_pt
            ).cpu().numpy()[: len(raw_src)]
            flows.append(flow)
        flow_seq = np.concatenate(flows)
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
    return meters


def test_cli_run_meters_are_unchanged_to_the_bit(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.chdir(tmp_path)
    os.mkdir("data")
    for i in range(2):
        make_pca_npz(os.path.join("data", f"seq_{i:03d}.npz"),
                     num_frames=3, seed=i)
    args = cli.build_parser().parse_args(_argv("data"))
    cfg = cli.config_from_args(args).replace(**SMALL)
    monkeypatch.setattr(cli, "config_from_args", lambda a: cfg)
    got = cli.run(args)
    assert "Processed sample 1/2" in capsys.readouterr().out

    frozen = _pre_refactor_meters(cfg, "data")
    assert got == {name: m.epe_avg for name, m in frozen.items()}

    engine = SceneFlowEngine(cfg, device="cpu")
    ds = DatasetPCA(cfg, "data", "test", device="cpu")
    meters = make_meters(cfg.num_frames)
    for path in ds.seq_paths:
        cli.run_sample(engine, ds, path, meters)
    np.testing.assert_array_equal(_meter_sums(meters), _meter_sums(frozen))
    assert frozen["dynamic_0"].num > 0
