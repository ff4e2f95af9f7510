"""The port's StreamingEngine (models/streaming.py) against the JAX package.

A 3-frame scan stream (ground ring, wall, one car moving 1.2 m per frame,
the sensor moving 0.7 m per frame) at the small configuration of
tests/test_streaming.py's reset test, with ego odometry on: ego, CZM
ground, joint clustering with the previous frame, matching and flow, run
by both packages on the same numpy scans. The port runs it twice: under
the default NN policy and under ICPFLOW_NN_VARIANT=vpu2 (the sentinel
sweeps). JAX runs its XLA sweeps on the CPU either way.

Tolerances: poses within 1e-3 m; flow EPE against the GT flow within
+-0.005 m of the JAX package's (the documented knife-edge band of the
matcher, whose NN forms differ: expanded on XLA:CPU, elementwise or
sentinel in the port at m >= 128 or 2048); matched pairs within 1; cluster
labels identical on at least 99% of the points.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from icpflow_tpu.models.streaming import (  # noqa: E402
    StreamingEngine as JStream)
import icpflow_tpu_torch as T  # noqa: E402
from icpflow_tpu_torch import trace  # noqa: E402
from test_streaming import CFG as STREAM_CFG, make_world  # noqa: E402

torch.set_num_threads(2)
CFG = STREAM_CFG.replace(max_points_scene=4096, max_points=512,
                         num_clusters=16, max_pairs=32, pairs_small=32,
                         pairs_large=4, nn_tile=256, hist_grid_xy=64,
                         ego_map_capacity=8192, ego_src_capacity=2048)
CAR_V = np.array([1.2, 0.2, 0.0])
EGO_V = np.array([0.7, 0.0, 0.0])


def _stream():
    """Three sensor-frame scans and the GT flow of frames 1 and 2 (world
    coordinates, new frame vs previous: -CAR_V on the car, 0 elsewhere)."""
    rng = np.random.default_rng(1)
    ground, wall, car = make_world(rng)
    ground, wall = ground[:1600], wall[:1200]
    scans = []
    for k in range(3):
        world = np.concatenate([ground, wall, car + CAR_V * k])
        scan = (world - EGO_V * k) + rng.normal(scale=0.01, size=world.shape)
        scans.append(scan.astype(np.float32))
    gt = np.zeros_like(scans[0])
    gt[len(ground) + len(wall):] = -CAR_V
    return scans, gt


def _epe(out, gt):
    return float(np.linalg.norm(out.flow - gt, axis=1).mean())


@pytest.fixture(scope="module")
def jax_outputs():
    scans, gt = _stream()
    eng = JStream(CFG, estimate_ego=True)
    return [eng.process(s) for s in scans]


@pytest.mark.parametrize("variant", ["auto", "vpu2"])
def test_stream_matches_jax(jax_outputs, variant, monkeypatch):
    monkeypatch.setenv("ICPFLOW_NN_VARIANT", variant)
    scans, gt = _stream()
    eng = T.StreamingEngine(T.config_from_dict(dataclasses.asdict(CFG)),
                            estimate_ego=True, device="cpu")
    calls = trace.launch_total("masked_nn_plain")
    outs = []
    for s in scans:
        timings = {}
        outs.append(eng.process(s, timings=timings))
        want = {"ego", "ground"} | ({"cluster", "track", "flow"}
                                   if outs[-1] is not None else set())
        assert set(timings) == want
    # CPU tensors: plain sweeps, no kernel
    assert trace.launch_total("masked_nn_plain") > calls
    assert trace.launch_total("nn_") == 0
    assert outs[0] is None and jax_outputs[0] is None
    for k in (1, 2):
        o, j = outs[k], jax_outputs[k]
        assert o.flow.shape == j.flow.shape == scans[k].shape
        assert np.isfinite(o.flow).all()
        assert np.abs(o.pose[:3, 3] - j.pose[:3, 3]).max() <= 1e-3
        assert np.abs(o.pose[:3, 3] - EGO_V * k).max() < 0.05
        assert abs(_epe(o, gt) - _epe(j, gt)) <= 0.005
        assert abs(len(o.pairs) - len(j.pairs)) <= 1
        assert len(o.pairs) >= 1
        assert (o.labels == j.labels).mean() >= 0.99
    eng.reset()
    assert eng.process(scans[0]) is None and eng.odo.poses[0].shape == (4, 4)


def test_stream_pose_override_and_no_gpu_refusal():
    scans, _ = _stream()
    eng = T.StreamingEngine(T.config_from_dict(dataclasses.asdict(CFG)),
                            estimate_ego=False, device="cpu")
    assert eng.odo is None
    pose = np.eye(4, dtype=np.float32)
    assert eng.process(scans[0], pose=pose) is None
    out = eng.process(scans[0], pose=pose)
    np.testing.assert_array_equal(out.pose, pose)
    assert np.abs(out.flow).max() < 0.05        # the same scan twice
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown")
    with pytest.raises(RuntimeError, match="cuda"):
        T.StreamingEngine(T.DEMO, device="cuda")


# --------------------------------------------------- use_hdbscan=True
# hdbscan's host stage leaves the JAX package's matcher staged; its
# programs are canonicalised without the clustering fields, so they are the
# ones the stream above compiled (same buckets): only hdbscan compiles here
HDB_CFG = CFG.replace(use_hdbscan=True, hdbscan_rep_cap=8192)


def _world(scans, k):
    """Scan ``k`` in world coordinates, without its ground points."""
    return scans[k][1600:] + EGO_V.astype(np.float32) * k


def test_run_frame_pair_with_hdbscan_matches_jax(jax_outputs):
    from icpflow_tpu import SceneFlowEngine as JEngine
    from icpflow_tpu.pipeline import run_frame_pair as j_run_frame_pair
    scans, gt = _stream()
    src, dst = _world(scans, 1), _world(scans, 0)
    pose = np.eye(4, dtype=np.float32)
    jr = j_run_frame_pair(JEngine(HDB_CFG), src, dst, translation_frame=2.0,
                          pose=pose)
    eng = T.SceneFlowEngine(T.config_from_dict(dataclasses.asdict(HDB_CFG)),
                            device="cpu")
    tr = T.run_frame_pair(eng, src, dst, translation_frame=2.0, pose=pose)
    info = eng.cluster_info
    assert info["path"] == "dedup" and 0 < info["n_unique"] <= 8192
    assert abs(len(tr.pairs) - len(jr.pairs)) <= 1 and len(tr.pairs) >= 1
    g = gt[1600:]
    epe_t = np.linalg.norm(tr.flow - g, axis=1).mean()
    epe_j = np.linalg.norm(jr.flow - g, axis=1).mean()
    assert abs(epe_t - epe_j) <= 0.005 and epe_t < 0.05
    assert (tr.labels_src == jr.labels_src).mean() >= 0.99


def test_stream_with_hdbscan_matches_jax(jax_outputs):
    scans, gt = _stream()
    jeng = JStream(HDB_CFG, estimate_ego=False)
    eng = T.StreamingEngine(T.config_from_dict(dataclasses.asdict(HDB_CFG)),
                            estimate_ego=False, device="cpu")
    for k, scan in enumerate(scans):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = EGO_V * k
        o, j = eng.process(scan, pose=pose), jeng.process(scan, pose=pose)
        if k == 0:
            continue
        assert eng.engine.cluster_info["path"] == "dedup"
        assert np.isfinite(o.flow).all()
        assert abs(_epe(o, gt) - _epe(j, gt)) <= 0.005 and _epe(o, gt) < 0.1
        assert abs(len(o.pairs) - len(j.pairs)) <= 1 and len(o.pairs) >= 1
        assert (o.labels == j.labels).mean() >= 0.99
