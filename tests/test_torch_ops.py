"""The port's ops against the JAX package on the same numpy inputs.

Tolerances, each from what differs between the two:
* kabsch, atol 1e-5: the covariance sums run in another order, which moves
  R and t by a few fp32 ulps;
* extract_segments, bit-identical: a stable sort and gathers, no float math
  besides the masked mean, whose sums are exact here (small-integer
  multiples of the 1/64 m grid the test points sit on);
* estimate_init_translation, winning T atol 1e-4: the FFTs round
  differently, so votes differ in the last bits, but the candidates are
  re-scored by NN error and the winners must agree;
* apply_icp, atol 1e-4: ICP iterates on both sides from one init, with
  per-iteration float differences of a few ulps;
* dbscan / dbscan_dedup, labels identical: integer semantics throughout,
  on scenes that take each of the contracted, compact and slab branches.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from icpflow_tpu.ops import cluster as jcl  # noqa: E402
from icpflow_tpu.ops import geometry as jgeo  # noqa: E402
from icpflow_tpu.ops import hist as jhist  # noqa: E402
from icpflow_tpu.ops import icp as jicp  # noqa: E402
from icpflow_tpu.ops import segments as jseg  # noqa: E402

from icpflow_tpu_torch.ops import cluster as tcl  # noqa: E402
from icpflow_tpu_torch.ops import geometry as tgeo  # noqa: E402
from icpflow_tpu_torch.ops import hist as thist  # noqa: E402
from icpflow_tpu_torch.ops import icp as ticp  # noqa: E402
from icpflow_tpu_torch.ops import segments as tseg  # noqa: E402

torch.set_num_threads(2)


def rot_z(deg):
    t = np.radians(deg)
    return np.array([[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0],
                     [0, 0, 1]], np.float32)


# ---------------------------------------------------------------- kabsch
def _kabsch_cases(rng):
    src = rng.uniform(-2, 2, (6, 64, 3)).astype(np.float32)
    w = (rng.random((6, 64)) > 0.2).astype(np.float32)
    dst = np.empty_like(src)
    for b in range(6):
        R = rot_z(10.0 * b - 20.0)
        dst[b] = src[b] @ R.T + [0.3 * b, -0.2, 0.05]
    dst += rng.normal(scale=0.01, size=dst.shape).astype(np.float32)
    # degenerate rows: all-zero weights, coincident points, collinear points
    w[3] = 0.0
    src[4] = 1.5
    dst[4] = 2.0
    t = np.linspace(-1, 1, 64, dtype=np.float32)
    src[5] = np.stack([t, 2 * t, 0 * t], 1)
    dst[5] = src[5] + [0.5, 0.0, 0.0]
    return src, dst, w


def test_kabsch_normal_and_degenerate_inputs():
    src, dst, w = _kabsch_cases(np.random.default_rng(0))
    jR, jt = jax.jit(jgeo.kabsch)(jnp.asarray(src), jnp.asarray(dst),
                                  jnp.asarray(w))
    tR, tt = tgeo.kabsch(torch.as_tensor(src), torch.as_tensor(dst),
                         torch.as_tensor(w))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    # the fallbacks: identity rotation with centroid-difference translation
    np.testing.assert_array_equal(tR.numpy()[3], np.eye(3))
    np.testing.assert_array_equal(tR.numpy()[4], np.eye(3))
    np.testing.assert_allclose(tt.numpy()[4], [0.5, 0.5, 0.5], atol=1e-6)


def test_geometry_helpers_match():
    rng = np.random.default_rng(1)
    T = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    for b in range(3):
        T[b, :3, :3] = rot_z(25.0 * b + 5)
        T[b, :3, 3] = rng.normal(size=3)
    x = rng.normal(size=(3, 50, 3)).astype(np.float32)
    m = rng.random((3, 50)) > 0.3
    jT, tT = jnp.asarray(T), torch.as_tensor(T)
    pairs = [
        (jgeo.invert_rigid(jT), tgeo.invert_rigid(tT)),
        (jgeo.compose(jT, jT), tgeo.compose(tT, tT)),
        (jgeo.transform_points_batch(jnp.asarray(x), jT),
         tgeo.transform_points_batch(torch.as_tensor(x), tT)),
        (jgeo.euler_zyx_deg(jT[:, :3, :3]), tgeo.euler_zyx_deg(tT[:, :3, :3])),
        (jgeo.masked_mean(jnp.asarray(x), jnp.asarray(m)),
         tgeo.masked_mean(torch.as_tensor(x), torch.as_tensor(m))),
        (jgeo.bbox_extent_sorted(jnp.asarray(x), jnp.asarray(m)),
         tgeo.bbox_extent_sorted(torch.as_tensor(x), torch.as_tensor(m))),
        (jgeo.transform_points(jnp.asarray(x[0]), jT[1]),
         tgeo.transform_points(torch.as_tensor(x[0]), tT[1])),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-5)


# ------------------------------------------------------------- segments
def test_extract_segments_bit_identical():
    rng = np.random.default_rng(2)
    n, L, P = 4096, 12, 256
    # points on a 1/64 m grid: every masked sum below is exact in fp32
    pts = (rng.integers(-640, 640, (n, 3)) / 64.0).astype(np.float32)
    lab = rng.integers(-1, L + 3, n).astype(np.int32)
    lab[rng.random(n) < 0.1] = jseg.GROUND_LABEL
    lab[:700] = 2                           # a cluster above P: subsampled
    valid = np.ones(n, bool)
    valid[-300:] = False
    j = jseg.extract_segments(jnp.asarray(pts), jnp.asarray(lab),
                              jnp.asarray(valid), num_labels=L, max_points=P)
    t = tseg.extract_segments(torch.as_tensor(pts), torch.as_tensor(lab),
                              torch.as_tensor(valid), num_labels=L,
                              max_points=P)
    for name in jseg.SegmentBatch._fields:
        a, b = np.asarray(getattr(j, name)), getattr(t, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=name)
    assert int(t.count[2]) > P


# ----------------------------------------------------------------- hist
def _hist_pairs(rng, P=256):
    srcs, dsts, sm, dm = [], [], [], []
    specs = [((1.2, -0.7, 0.0), 0.0), ((0.0, 0.0, 0.0), 0.0),
             ((3.5, 2.0, 0.05), 0.2), ((-0.4, 0.9, 0.0), -0.25)]
    for shift, yaw in specs:
        a = rng.uniform(-2, 2, (180, 3)).astype(np.float32)
        a[:, 0] *= 2.0
        a[:, 2] *= 0.4
        b = a @ rot_z(np.degrees(yaw)).T + np.asarray(shift, np.float32)
        b += rng.normal(scale=0.01, size=b.shape).astype(np.float32)
        for c, store, ms in ((a, srcs, sm), (b, dsts, dm)):
            o = np.zeros((P, 3), np.float32)
            o[:len(c)] = c
            m = np.zeros(P, bool)
            m[:len(c)] = True
            store.append(o)
            ms.append(m)
    return [np.stack(x) for x in (srcs, sm, dsts, dm)]


def test_estimate_init_translation_winners_match():
    src, sm, dst, dm = _hist_pairs(np.random.default_rng(3))
    kw = dict(bin_w=0.1, lxy=64, lz=8, topk=5, nms_kernel=11, eval_tile=128,
              yaws=(0.0, -0.3, -0.15, 0.15, 0.3), coarse_cap=64, refine=2,
              yaw_per_m=0.03, yaw_scale_cap=2.0)
    jT = jhist.estimate_init_translation(
        jnp.asarray(src), jnp.asarray(sm), jnp.asarray(dst), jnp.asarray(dm),
        jnp.float32(8.0), **kw)
    tT = thist.estimate_init_translation(
        torch.as_tensor(src), torch.as_tensor(sm), torch.as_tensor(dst),
        torch.as_tensor(dm), 8.0, **kw)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-4)
    # the sweep did real work: shifts recovered, a yaw picked
    np.testing.assert_allclose(tT.numpy()[0, :3, 3], (1.2, -0.7, 0.0),
                               atol=0.15)
    assert abs(float(tT[3, 1, 0])) > 0.1


def test_max_pool_same_pads_even_windows_like_xla():
    x = np.random.default_rng(4).normal(size=(2, 8, 5, 6)).astype(np.float32)
    for axis, k in ((1, 8), (2, 11), (3, 4), (1, 3)):
        dims = [1, 1, 1, 1]
        dims[axis] = k
        j = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                  tuple(dims), (1, 1, 1, 1), "SAME")
        t = thist._max_pool_same(torch.as_tensor(x), axis, k)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ------------------------------------------------------------------ icp
def _icp_case(rng, n, R, t, p):
    s = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    d = s @ R.T + t
    out_s = np.zeros((p, 3), np.float32)
    out_d = np.zeros((p, 3), np.float32)
    out_s[:n] = s
    out_d[:n] = d
    m = np.zeros((p,), bool)
    m[:n] = True
    return out_s, out_d, m


def test_apply_icp_matches_on_mixed_batch():
    rng = np.random.default_rng(5)
    ss, ds, ms, inits = [], [], [], []
    for i in range(6):
        R = rot_z(1.0 + 3.0 * (i % 3))
        t = np.array([0.05 * i, -0.03 * i, 0.01], np.float32)
        s, d, m = _icp_case(rng, 150 + 20 * i, R, t, 384)
        init = np.eye(4, dtype=np.float32)
        init[:3, 3] = t + (0.05 if i % 2 else 0.0)
        ss.append(s); ds.append(d); ms.append(m); inits.append(init)
    # a pair with no overlap within the gate: rolled back to its init
    ss[5] = ss[5] * 0.1
    ds[5] = ss[5] + 100.0
    src, dst, msk, init = (np.stack(x) for x in (ss, ds, ms, inits))
    kw = dict(thres=0.3, max_iters=40, tile=128, patience=5, stall_rel=1e-3,
              corr_cap=128, coarse_iters=4, coarse_scale=3.0,
              init_margin_rel=0.02)
    for coarse_on in (True, False):
        jT = jicp.apply_icp(jnp.asarray(src), jnp.asarray(msk),
                            jnp.asarray(dst), jnp.asarray(msk),
                            jnp.asarray(init), jnp.bool_(coarse_on),
                            shrink=4, **kw)
        tT = ticp.apply_icp(torch.as_tensor(src), torch.as_tensor(msk),
                            torch.as_tensor(dst), torch.as_tensor(msk),
                            torch.as_tensor(init), coarse_on, **kw)
        np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-4)
        np.testing.assert_allclose(tT.numpy()[5], init[5], atol=1e-6)


# --------------------------------------------------------------- dbscan
_DB = dict(eps=0.25, min_points=10, num_clusters=16, cell_cap=64,
           max_iters=100)


def _wall_scene(rng, n=4096):
    """Two thin vertical walls: <= 3 edges per point, few fine cells."""
    a = np.stack([rng.uniform(0, 5, 2000), np.full(2000, 3.1),
                  rng.uniform(0, 2, 2000)], 1)
    b = np.stack([np.full(900, -2.1), rng.uniform(0, 3, 900),
                  rng.uniform(0, 1.5, 900)], 1)
    pts = np.concatenate([a, b]) + rng.normal(scale=0.01, size=(2900, 3))
    return _pad(pts, n)


def _far_lines_scene(rng, n=4096):
    """Lines 850 m apart: the fine-cell table would overflow."""
    x = np.linspace(0, 10, 600)
    a = np.stack([x, np.full(600, 0.1), np.full(600, 0.1)], 1)
    b = a + [600.0, 600.0, 0.0]
    c = np.stack([np.full(300, 5.1), np.linspace(2, 8, 300),
                  np.full(300, 0.1)], 1)
    pts = np.concatenate([a, b, c]) + rng.normal(scale=0.005, size=(1500, 3))
    return _pad(pts, n)


def _blob_scene(rng, n=4096):
    """Dense blobs: most points have a hit in every neighbour column."""
    blobs = [rng.normal(loc=c, scale=0.2, size=(900, 3))
             for c in ([0, 0, 0], [4, 1, 0], [-3, 2, 0.5])]
    noise = rng.uniform(-8, 8, size=(300, 3))
    return _pad(np.concatenate(blobs + [noise]), n)


def _pad(pts, n):
    out = np.zeros((n, 3), np.float32)
    out[:len(pts)] = pts
    valid = np.zeros(n, bool)
    valid[:len(pts)] = True
    return out, valid


@pytest.mark.parametrize("scene,path", [(_wall_scene, "contracted"),
                                        (_far_lines_scene, "compact"),
                                        (_blob_scene, "slab")])
def test_dbscan_labels_identical_on_each_branch(scene, path):
    pts, valid = scene(np.random.default_rng(6))
    j = np.asarray(jcl.dbscan(jnp.asarray(pts), jnp.asarray(valid), **_DB))
    info = {}
    t = tcl.dbscan(torch.as_tensor(pts), torch.as_tensor(valid), info=info,
                   **_DB).numpy()
    assert info["path"] == path
    np.testing.assert_array_equal(t, j)
    assert t.dtype == np.int32 and t.max() >= 1


def test_dbscan_dedup_labels_identical_on_lidar_frame():
    """The main path's clusterer settings (bench.py make_cfg: adaptive eps
    0.6 +0.012/m capped at 0.8, 0.15 m dedup, weighted counts) on a frame
    pair of the synthetic lidar scene, cut to 8192 points."""
    import io
    from icpflow_tpu_torch.data.synthetic import ego_aligned_pair, make_sample
    buf = io.BytesIO()
    make_sample(buf, num_frames=2, seed=5)
    buf.seek(0)
    src, dst, _, _ = ego_aligned_pair(dict(np.load(buf)), 1)
    pts = np.concatenate([dst[::19], src[::19]])[:8000]
    pts, valid = _pad(pts, 8192)
    kw = dict(eps=0.6, min_points=4, num_clusters=64, cell_cap=64,
              max_iters=100, eps_scale_per_m=0.012, eps_max=0.8,
              dedup_voxel=0.15, rep_cap=8192)
    j = np.asarray(jcl.dbscan_dedup(jnp.asarray(pts), jnp.asarray(valid),
                                    **kw))
    t = tcl.dbscan_dedup(torch.as_tensor(pts), torch.as_tensor(valid),
                         **kw).numpy()
    np.testing.assert_array_equal(t, j)
    assert t.max() >= 5
    rx, rv, rm, pr, nu = tcl.voxel_dedup_compact(
        torch.as_tensor(pts), torch.as_tensor(valid), voxel=0.15, cap=8192)
    jx, jv, jm, jpr, jnu = jcl.voxel_dedup_compact(
        jnp.asarray(pts), jnp.asarray(valid), voxel=0.15, cap=8192)
    assert nu == int(jnu) < 8000
    for a, b in ((rx, jx), (rv, jv), (rm, jm), (pr, jpr)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(
            a.numpy().dtype))
