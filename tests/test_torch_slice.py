"""The port's main path as a whole against the JAX package.

One frame pair (blobs + clutter, the second frame shifted) through
``SceneFlowEngine.run_pair`` of both packages at a small voxel-dedup
configuration. Labels, ``matched`` and ``dst_label`` must be identical
(integer semantics end to end); transforms and flow within 1e-4 m (fp32
sums taken in another order inside ICP and the statistics).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import icpflow_tpu as J  # noqa: E402
from icpflow_tpu.pipeline import run_frame_pair as j_run_frame_pair  # noqa: E402

import icpflow_tpu_torch as T  # noqa: E402

torch.set_num_threads(2)
ATOL = 1e-4


def _toy_pair(seed=0, n=1500):
    rng = np.random.default_rng(seed)
    blobs = [rng.normal(loc=c, scale=0.2, size=(n // 4, 3))
             for c in ([0, 0, 0], [4, 1, 0], [-3, 2, 0.5])]
    noise = rng.uniform(-8, 8, size=(n - 3 * (n // 4), 3))
    src = np.concatenate(blobs + [noise]).astype(np.float32)
    shift = np.array([0.6, -0.3, 0.0], np.float32)
    dst = (src + shift + rng.normal(scale=0.01, size=src.shape)
           ).astype(np.float32)
    return src, dst


@pytest.fixture(scope="module")
def engines():
    jcfg = J.DEMO.replace(max_points_scene=2048, max_points=512,
                          num_clusters=32, max_pairs=64, min_cluster_size=8,
                          nn_tile=256, hist_grid_xy=64, icp_max_iters=20,
                          cluster_dedup_voxel=0.15)
    tcfg = T.config_from_dict(dataclasses.asdict(jcfg))
    return J.SceneFlowEngine(jcfg), T.SceneFlowEngine(tcfg, device="cpu")


def test_run_pair_matches_jax(engines):
    je, te = engines
    src, dst = _toy_pair()
    ps, vs = je.pad_cloud(src)
    pd, vd = je.pad_cloud(dst)
    jo = je.run_pair(jnp.asarray(ps), jnp.asarray(vs), jnp.asarray(pd),
                     jnp.asarray(vd), 2.0)
    timings = {}
    to = te.run_pair(ps, vs, pd, vd, 2.0, timings=timings)
    assert set(timings) == {"cluster", "track", "flow"}

    np.testing.assert_array_equal(to.lab_src.numpy(), np.asarray(jo.lab_src))
    np.testing.assert_array_equal(to.lab_dst.numpy(), np.asarray(jo.lab_dst))
    jr, tr = jo.track.result, to.track.result
    np.testing.assert_array_equal(tr.matched.numpy(), np.asarray(jr.matched))
    np.testing.assert_array_equal(tr.dst_label.numpy(),
                                  np.asarray(jr.dst_label))
    assert int(tr.overflow) == int(jr.overflow)
    np.testing.assert_allclose(tr.transforms.numpy(),
                               np.asarray(jr.transforms), atol=ATOL)
    np.testing.assert_allclose(tr.stats.numpy(), np.asarray(jr.stats),
                               atol=ATOL)
    np.testing.assert_allclose(to.flow.numpy(), np.asarray(jo.flow),
                               atol=ATOL)
    for name in ("count", "pidx", "mask"):
        np.testing.assert_array_equal(
            getattr(to.track.seg_src, name).numpy(),
            np.asarray(getattr(jo.track.seg_src, name)))
    # the pair did real work: three matched blobs moving by the shift
    assert int(tr.matched.sum()) >= 3
    moving = to.lab_src.numpy()[:len(src)] >= 0
    np.testing.assert_allclose(to.flow.numpy()[:len(src)][moving].mean(0),
                               (0.6, -0.3, 0.0), atol=0.02)


def test_run_frame_pair_matches_jax(engines):
    je, te = engines
    src, dst = _toy_pair(seed=1)
    pose = np.eye(4, dtype=np.float32)
    jr = j_run_frame_pair(je, src, dst, translation_frame=2.0, pose=pose)
    tr = T.run_frame_pair(te, src, dst, translation_frame=2.0, pose=pose)
    assert tr.flow.shape == (len(src), 3)
    np.testing.assert_array_equal(tr.labels_src, jr.labels_src)
    np.testing.assert_array_equal(tr.labels_dst, jr.labels_dst)
    np.testing.assert_allclose(tr.pairs, jr.pairs, atol=ATOL)
    np.testing.assert_allclose(tr.transforms, jr.transforms, atol=ATOL)
    np.testing.assert_allclose(tr.flow, jr.flow, atol=ATOL)
    assert tr.overflow == jr.overflow
    assert len(tr.pairs) >= 3
