"""The rest of a run, with the timed path broken underneath, comes out
not correct: once for each fault a cell can have. A frame pair keeps no
state and one chip exchanges nothing, so a pair cell can have two: half of
its batch left out (the second half of the source points never reaches
the program, and the answer is padded back as unmatched, still points),
and an answer altered where it is produced (one point's flow moved by
5 cm; in a stream, a frame's pose). A stream cell can have those and a
third: its state left unchanged (the odometry hands back the previous
pose, as if it never moved)."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness

SHIFT_M = 0.05


def _halved(real, cloud_arg):
    """``real`` called on the first half of its cloud argument, the answer
    padded back: zero flow and label -1 for the points left out."""
    def wrapped(*args, **kw):
        args = list(args)
        cloud = np.asarray(args[cloud_arg])
        n = len(cloud)
        args[cloud_arg] = cloud[:n // 2]
        r = real(*args, **kw)
        if r is None:
            return r
        flow = np.zeros((n, 3), np.float32)
        flow[:n // 2] = r.flow
        fields = {"flow": flow}
        for key in ("labels_src", "labels"):
            if hasattr(r, key):
                lab = np.full(n, -1, np.int32)
                lab[:n // 2] = getattr(r, key)
                fields[key] = lab
        return r._replace(**fields)
    return wrapped


def _altered(real):
    """One point's flow, or a stream frame's pose, moved by ``SHIFT_M``."""
    def wrapped(*args, **kw):
        r = real(*args, **kw)
        if r is None:
            return r
        if hasattr(r, "pose"):
            pose = r.pose.copy()
            pose[0, 3] += SHIFT_M
            return r._replace(pose=pose)
        flow = r.flow.copy()
        flow[len(flow) // 3, 0] += SHIFT_M
        return r._replace(flow=flow)
    return wrapped


def _patch_pair(monkeypatch, fault):
    from icpflow_tpu_torch import pipeline
    real = pipeline.run_frame_pair
    broken = _halved(real, 1) if fault == "half_batch" else _altered(real)
    monkeypatch.setattr(pipeline, "run_frame_pair", broken)


def _patch_stream(monkeypatch, fault):
    from icpflow_tpu_torch.models.streaming import StreamingEngine
    from icpflow_tpu_torch.ops.ego import EgoOdometry
    if fault == "state_unchanged":
        real = EgoOdometry.register_frame

        def stuck(self, frame):
            pose = real(self, frame)
            return self.poses[-2] if len(self.poses) > 1 else pose
        monkeypatch.setattr(EgoOdometry, "register_frame", stuck)
        return
    real = StreamingEngine.process
    broken = _halved(real, 1) if fault == "half_batch" else _altered(real)
    monkeypatch.setattr(StreamingEngine, "process", broken)


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
def test_pair_faults_are_not_correct(small_root, monkeypatch, fault):
    _patch_pair(monkeypatch, fault)
    out = harness.run_cell("av2_pairs.dense", 17, 0.5, False, "cpu",
                           root=small_root)
    assert out["line"]["correct"] is False
    assert out["line"]["failed"] >= 1


@pytest.mark.parametrize("fault",
                         ["state_unchanged", "half_batch", "altered_answer"])
def test_stream_faults_are_not_correct(small_root, monkeypatch, fault):
    _patch_stream(monkeypatch, fault)
    out = harness.run_cell("av2_stream.sessions16", 17, 0.5, False, "cpu",
                           root=small_root)
    assert out["line"]["correct"] is False


@pytest.mark.parametrize("cell", ["av2_pairs.dense", "av2_stream.sessions16"])
def test_the_unbroken_run_is_correct(small_root, cell):
    out = harness.run_cell(cell, 17, 0.5, False, "cpu", root=small_root)
    assert out["line"]["correct"] is True
    assert all(np.isfinite(c["value"]) for c in out["line"]["check"].values())
