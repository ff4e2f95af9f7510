"""The port's ego odometry (ops/ego.py) against the JAX package.

Same numpy inputs to both packages: the structured static world of
tests/test_ego.py (ground, a wall, poles) seen from a sensor moving 1.2 m
forward and 0.15 m sideways per frame, at that file's buckets
(max_points_scene 8192, ego_map_capacity 16384). The registration source
bucket is 4096: the downsampled source holds ~2.8k points, so it never
overflows and the results do not depend on the padding.

Tolerances: voxel masks exact, on voxel boundaries too (int32 ids from
``floor(xyz * (1/voxel))`` with the fp32 reciprocal, which is what XLA
compiles the reference's ``floor(xyz / voxel)`` into); one
registration within 1e-4 m and 1e-4 rad; the odometry's poses within
1e-3 m and the same map fill count per frame. Both sides sweep NN in the
elementwise form; the sums inside Kabsch and the transforms round in
another order, which moves poses by ~1e-7 m here.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from icpflow_tpu import DEMO  # noqa: E402
from icpflow_tpu.ops import ego as je  # noqa: E402
from icpflow_tpu_torch import config_from_dict  # noqa: E402
from icpflow_tpu_torch.ops import ego as te  # noqa: E402
from test_ego import make_world  # noqa: E402

torch.set_num_threads(2)
CFG = DEMO.replace(max_points_scene=8192, ego_map_capacity=16384,
                   nn_tile=512, ego_src_capacity=4096)
STEP = np.array([1.2, 0.15, 0.0])


def _rot_err(a, b):
    """Rotation angle (rad) of a^T b for two (4,4) poses."""
    r = np.asarray(a, np.float64)[:3, :3].T @ np.asarray(b, np.float64)[:3, :3]
    return float(np.arccos(np.clip((np.trace(r) - 1) / 2, -1.0, 1.0)))


@pytest.mark.parametrize("per_voxel", [1, 20])
def test_voxel_downsample_mask_exact(per_voxel):
    rng = np.random.default_rng(0)
    pts = make_world(rng)
    # points on voxel boundaries, where a true division and the reciprocal
    # multiply the reference compiles to put ~1 in 10 in different cells
    pts[:200] = np.round(pts[:200] / 0.32) * np.float32(0.32)
    valid = rng.random(len(pts)) > 0.1
    for voxel in (0.32, 0.64, 0.96):
        want = je.voxel_downsample_mask(jnp.asarray(pts), jnp.asarray(valid),
                                        voxel=voxel, per_voxel=per_voxel)
        got = te.voxel_downsample_mask(torch.as_tensor(pts),
                                       torch.as_tensor(valid), voxel=voxel,
                                       per_voxel=per_voxel)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    none = te.voxel_downsample_mask(torch.as_tensor(pts),
                                    torch.zeros(len(pts), dtype=torch.bool),
                                    voxel=0.5, per_voxel=per_voxel)
    assert not none.any()


def test_register_frame_icp_matches_jax():
    """One robust registration (both phases, the score choice) of a
    downsampled scan against a small map, from a guess 0.36 m and 0.01 rad
    off, then again from the result at a tight sigma."""
    rng = np.random.default_rng(1)
    world = make_world(rng, n=4000)
    mp = np.zeros((6144, 3), np.float32)
    mp[:len(world)] = world
    mv = np.arange(6144) < len(world)
    c, s = np.cos(0.01), np.sin(0.01)
    true = np.eye(4, dtype=np.float32)
    true[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    true[:3, 3] = [0.8, 0.1, 0.0]
    scan = ((world[::3] - true[:3, 3]) @ true[:3, :3]
            + rng.normal(scale=0.01, size=world[::3].shape)).astype(np.float32)
    src = np.zeros((2048, 3), np.float32)
    src[:len(scan)] = scan
    sv = np.arange(2048) < len(scan)
    guess = np.eye(4, dtype=np.float32)
    guess[:3, 3] = true[:3, 3] + [0.3, -0.2, 0.0]
    for sigma in (1.0, 0.1):
        want = np.array(je.register_frame_icp(
            jnp.asarray(src), jnp.asarray(sv), jnp.asarray(mp),
            jnp.asarray(mv), jnp.asarray(guess), jnp.float32(3.0 * sigma),
            jnp.float32(sigma / 3.0), iters=100))
        got = te.register_frame_icp(
            torch.as_tensor(src), torch.as_tensor(sv), torch.as_tensor(mp),
            torch.as_tensor(mv), torch.as_tensor(guess), 3.0 * sigma,
            sigma / 3.0, iters=100).numpy()
        assert np.abs(got[:3, 3] - want[:3, 3]).max() <= 1e-4
        assert _rot_err(got, want) <= 1e-4
        assert np.linalg.norm(got[:3, 3] - true[:3, 3]) < 0.05
        guess = want


@pytest.fixture(scope="module")
def jax_sequence():
    """Three scans and the JAX package's odometry over them: poses, map
    fill counts, and its state after the second frame."""
    rng = np.random.default_rng(0)
    world = make_world(rng)
    scans = [((world - STEP * k) + rng.normal(scale=0.01, size=world.shape)
              ).astype(np.float32) for k in range(3)]
    odo = je.EgoOdometry(CFG)
    fills, snapshot = [], None
    for k, scan in enumerate(scans):
        if k == 2:
            snapshot = ([p.copy() for p in odo.poses], odo._map.copy(),
                        odo._map_valid.copy(), list(odo._deviations))
        odo.register_frame(scan)
        fills.append(int(odo._map_valid.sum()))
    return scans, odo.poses, fills, snapshot


def test_odometry_matches_jax(jax_sequence):
    scans, jposes, jfills, _ = jax_sequence
    odo = te.EgoOdometry(config_from_dict(dataclasses.asdict(CFG)),
                         device="cpu")
    for k, scan in enumerate(scans):
        pose = odo.register_frame(scan)
        assert pose.dtype == np.float32 and pose.shape == (4, 4)
        assert np.abs(pose[:3, 3] - jposes[k][:3, 3]).max() <= 1e-3, k
        assert int(odo._map_valid.sum()) == jfills[k], k
        assert np.linalg.norm(pose[:3, 3] - STEP * k) < 0.01, k
    assert len(odo._deviations) == 2


def test_odometry_state_carried_across_from_jax(jax_sequence):
    """The JAX odometry's state after frame 2, handed over as numpy, gives
    the port the same third pose."""
    scans, jposes, jfills, (poses, mp, mv, devs) = jax_sequence
    odo = te.EgoOdometry.from_arrays(
        config_from_dict(dataclasses.asdict(CFG)), poses, mp, mv, devs,
        device="cpu")
    assert odo._map.dtype == torch.float32
    assert odo._map_valid.dtype == torch.bool
    pose = odo.register_frame(scans[2])
    assert np.abs(pose[:3, 3] - jposes[2][:3, 3]).max() <= 1e-3
    assert int(odo._map_valid.sum()) == jfills[2]
