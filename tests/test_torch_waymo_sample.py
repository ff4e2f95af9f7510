"""The Waymo deployment of the offline path on the CPU: the benchmark's
vehicle-frame generator (``benchmark/traffic/pca_vehicle.py``), the
loader's refusal of a sweep past its bucket, the port against the plain
reference on a thinned Waymo-shaped sample, and DBSCAN's counts of its
valid rows and its bucket.

* ``pca_vehicle`` lifts every point along z and changes nothing else. The
  ego poses are translations in the plane and each instance turns about z
  alone, so the lift commutes with both and the ground-truth flow the
  loader rebuilds is the unlifted sample's, to the bit.
* ``DatasetPCA`` raises on a sweep past its bucket instead of cutting it.
* A 5-sweep sample of the ``full5`` mix, thinned, through ``cli.run_sample``
  with ``benchmark/configs/waymo_cli.json``'s pipeline, ``max_points_scene``
  lowered to the smallest power of two that holds a thinned sweep (so the
  joint bucket is twice it, as on the card, and every sweep lies past half
  the bucket, as 137k points lie past 131,072): the flow, transforms,
  pairs tables and labels equal those of ``benchmark/reference/offline.py``
  to the bit. Both run the same plain PyTorch and numpy operations on the
  same device, so no tolerance is allowed.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.reference import offline as ref_offline
from benchmark.reference.engine import Reference
from benchmark.traffic import pca_samples, pca_vehicle
from icpflow_tpu_torch import SceneFlowEngine, cli, config_from_dict, trace
from icpflow_tpu_torch.config import WAYMO
from icpflow_tpu_torch.data.pca import DatasetPCA, _pad
from icpflow_tpu_torch.metrics import make_meters
from icpflow_tpu_torch.ops import cluster

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
THIN = 32


def _mix() -> dict:
    return json.loads((REPO / "benchmark" / "traffic" / "full5.json")
                      .read_text())


def _pipeline():
    conf = json.loads((REPO / "benchmark" / "configs" / "waymo_cli.json")
                      .read_text())
    return config_from_dict(conf["pipeline"])


def _sample(frames: int, lift: float, index: int = 0) -> dict:
    mix = _mix()
    return pca_vehicle.lifted(
        pca_samples.sample(np.random.SeedSequence(2 ** 33 + index), frames,
                           float(mix["hz"]), int(mix["sweep_thin"]),
                           mix["extra"], index), lift)


@pytest.fixture(scope="module")
def waymo_sample(tmp_path_factory):
    """(path, arrays, cfg): one 5-sweep sample of the full5 mix, every
    ``THIN``-th point of each sweep kept, and the cell's pipeline at the
    smallest power-of-two bucket that holds a thinned sweep."""
    mix = _mix()
    arrays = pca_samples.thinned(_sample(int(mix["frames"]),
                                         float(mix["lift_z"])), THIN)
    worst = int(pca_samples.sweep_sizes(arrays, float(mix["crop"])).max())
    bucket = 1 << (worst - 1).bit_length()
    cfg = _pipeline().replace(max_points_scene=bucket)
    assert bucket // 2 < worst <= bucket
    path = tmp_path_factory.mktemp("waymo") / "sample_00.npz"
    np.savez_compressed(path, **arrays)
    return str(path), arrays, cfg


@pytest.mark.parametrize("lift", [1.9, 0.5])
def test_pca_vehicle_moves_only_z(lift):
    base = _sample(2, 0.0)
    up = pca_vehicle.lifted(base, lift)
    assert set(up) == set(base)
    np.testing.assert_array_equal(up["raw_points"][:, :2],
                                  base["raw_points"][:, :2])
    np.testing.assert_array_equal(
        up["raw_points"][:, 2], base["raw_points"][:, 2] + np.float32(lift))
    assert up["raw_points"].dtype == np.float32
    for k in set(base) - {"raw_points"}:
        np.testing.assert_array_equal(up[k], base[k])


def test_the_lift_keeps_the_gt_flow():
    cfg = WAYMO.replace(num_frames=3)
    ds = DatasetPCA(cfg, "unused", "test", device="cpu")
    base = ds._raw_from_dict(_sample(3, 0.0), "base")
    up = ds._raw_from_dict(_sample(3, 1.9), "up")
    assert np.abs(base["scene_flow"]).max() > 0.5      # movers move
    np.testing.assert_array_equal(up["scene_flow"], base["scene_flow"])
    np.testing.assert_array_equal(up["sd_labels"], base["sd_labels"])


@pytest.mark.parametrize("bucket, fits", [(131072, False), (262144, True)])
def test_the_generator_checks_the_bucket(bucket, fits):
    mix = dict(_mix(), samples=1, frames=2, max_points=bucket)
    if not fits:
        with pytest.raises(ValueError, match="exceeds the mix's bucket"):
            pca_vehicle.make(mix, 2 ** 31 + 5)
        return
    (item,) = pca_vehicle.make(mix, 2 ** 31 + 5)
    sizes = pca_samples.sweep_sizes(item["arrays"], float(mix["crop"]))
    assert (sizes > 131072).all() and (sizes <= bucket).all()
    with np.load(item["path"]) as f:
        np.testing.assert_array_equal(f["raw_points"],
                                      item["arrays"]["raw_points"])


def test_pad_raises_past_the_bucket_and_keeps_what_fits():
    pts = np.arange(15, dtype=np.float32).reshape(5, 3)
    with pytest.raises(ValueError, match="max_points_scene"):
        _pad(pts, 4)
    out, valid = _pad(pts, 5)
    np.testing.assert_array_equal(out, pts)
    assert valid.all()
    out, valid = _pad(pts, 8)
    np.testing.assert_array_equal(out[:5], pts)
    assert valid.tolist() == [True] * 5 + [False] * 3


@pytest.mark.parametrize("through", ["ground_removal", "run_sample"])
def test_dataset_refuses_a_sweep_past_max_points_scene(waymo_sample,
                                                       through):
    """A bucket one point short of the largest sweep: ground removal, and
    so the whole sample, raises instead of cutting the sweep."""
    path, arrays, cfg = waymo_sample
    worst = int(pca_samples.sweep_sizes(arrays, cfg.range_x).max())
    small = cfg.replace(max_points_scene=worst - 1)
    ds = DatasetPCA(small, str(pathlib.Path(path).parent), "test",
                    device="cpu")
    with pytest.raises(ValueError, match="max_points_scene"):
        if through == "ground_removal":
            ds.ground_removal(ds.load_raw(path))
        else:
            cli.run_sample(SceneFlowEngine(small, device="cpu"), ds, path,
                           make_meters(small.num_frames))


def test_run_sample_equals_the_reference_at_a_doubled_joint_bucket(
        waymo_sample):
    path, arrays, cfg = waymo_sample
    eng = SceneFlowEngine(cfg, device="cpu")
    ds = DatasetPCA(cfg, str(pathlib.Path(path).parent), "test",
                    device="cpu")
    trace.clear()
    res = cli.run_sample(eng, ds, path, make_meters(cfg.num_frames), {})
    ref = ref_offline.sample(Reference(dataclasses.asdict(cfg), "cpu"),
                             arrays)

    assert len(res.results) == len(ref["transforms"]) == cfg.num_frames - 1
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
        assert int(r.overflow) == 0

    # the trace counts each joint DBSCAN's valid rows and its bucket
    (rec,) = trace.calls()
    ti = arrays["time_indice"]
    inside = (np.abs(arrays["raw_points"][:, 0]) < cfg.range_x) \
        & (np.abs(arrays["raw_points"][:, 1]) < cfg.range_y)
    sizes = np.bincount(ti[inside])
    pairs = cfg.num_frames - 1
    assert rec.counters["launches.dbscan_candidates_plain"] == pairs
    assert rec.counters["dbscan_slots"] == pairs * 2 * cfg.max_points_scene
    joint = sum(sizes[0] + sizes[j] for j in range(1, cfg.num_frames))
    assert 0 < rec.counters["dbscan_points"] <= joint
    trace.clear()


@pytest.mark.parametrize("n, nv", [(256, 256), (1024, 300), (4096, 1)])
def test_dbscan_counts_its_valid_rows_and_slots(n, nv):
    rng = np.random.default_rng(n)
    pts = torch.as_tensor(rng.uniform(-4, 4, (n, 3)).astype(np.float32))
    valid = torch.zeros(n, dtype=torch.bool)
    valid[torch.as_tensor(rng.permutation(n)[:nv])] = True
    trace.clear()
    with trace.StageClock({}, CPU, "test"):
        cluster.dbscan(pts, valid, eps=0.6, min_points=3)
        cluster.dbscan(pts, valid, eps=0.6, min_points=3)
    (rec,) = trace.calls()
    assert rec.counters["dbscan_points"] == 2 * nv
    assert rec.counters["dbscan_slots"] == 2 * n
    trace.clear()
    cluster.dbscan(pts, valid, eps=0.6, min_points=3)      # untraced
    assert trace.calls() == []


def test_dbscan_dedup_counts_the_representatives():
    rng = np.random.default_rng(3)
    pts = torch.as_tensor(rng.uniform(-2, 2, (2048, 3)).astype(np.float32))
    valid = torch.ones(2048, dtype=torch.bool)
    _, _, _, _, n_unique = cluster.voxel_dedup_compact(pts, valid,
                                                       voxel=0.2, cap=4096)
    trace.clear()
    with trace.StageClock({}, CPU, "test"):
        cluster.dbscan_dedup(pts, valid, dedup_voxel=0.2, rep_cap=4096,
                             eps=0.6, min_points=3)
    (rec,) = trace.calls()
    assert rec.counters["dbscan_points"] == n_unique < 2048
    assert rec.counters["dbscan_slots"] == 4096
    trace.clear()
