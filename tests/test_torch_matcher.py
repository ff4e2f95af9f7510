"""The port's matcher and flow assembly against the JAX package, and the
port's behaviour on pathological inputs.

The matcher scene is sized so that every bookkeeping path runs: static
self-pairs (stage 1), relabelled movers (stage 2), clusters in both the
small and the large bucket, more large pairs than ``pairs_large`` (dropped
and counted) and more stage-2 candidates than ``max_pairs`` (overflow), with
the identity preference and the per-point identity override on.
Tolerances: integer outputs (matched, dst_label, overflow, identity_pt)
identical; transforms, stats and flow within 1e-4 (fp32 sums in another
order inside ICP and the statistics).

The scene stays within ~7 m of the origin. Below 2048 dst points both
sides compute NN distances in the expanded form |x|^2 - 2<x,y> + |y|^2,
whose cancellation error grows with |x|^2: at ~15 m it reaches mm per point
and differs between XLA's dot and the port's sum, which is enough to flip
the relative rollback margin (2%) of a well-initialised mover either way.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import icpflow_tpu as J  # noqa: E402
from icpflow_tpu import flow as jflow  # noqa: E402
from icpflow_tpu.match import gates as jgates  # noqa: E402
from icpflow_tpu.match import matcher as jmatch  # noqa: E402
from icpflow_tpu.ops.segments import extract_segments as j_extract  # noqa: E402

import icpflow_tpu_torch as T  # noqa: E402
from icpflow_tpu_torch import flow as tflow  # noqa: E402
from icpflow_tpu_torch.match import gates as tgates  # noqa: E402
from icpflow_tpu_torch.match import matcher as tmatch  # noqa: E402
from icpflow_tpu_torch.ops.segments import extract_segments as t_extract  # noqa: E402

torch.set_num_threads(2)
ATOL = 1e-4

JCFG = J.DEMO.replace(
    max_points_scene=4096, max_points=256, num_clusters=16, max_pairs=8,
    pairs_small=8, pairs_large=2, max_points_small=128, min_cluster_size=10,
    nn_tile=128, hist_grid_xy=64, hist_grid_xy_small=32, icp_max_iters=15,
    per_point_identity=True)
TCFG = T.config_from_dict(dataclasses.asdict(JCFG))


def _scene(rng, n_cap=4096):
    """(src pts, valid, labels), (dst ...): 11 clusters, some moved and
    relabelled; three of them above ``max_points_small``."""
    specs = [  # (center, n, shift, dst label)
        ([0, 0, 0], 100, [0, 0, 0], 0),
        ([4, 0, 0], 80, [0.1, 0, 0], 1),
        ([0, 3.6, 0], 200, [0, 0, 0], 2),        # large, static
        ([-3.6, 1.2, 0], 220, [0.6, 0.2, 0], 3),  # large, moving
        ([2, -3.2, 0], 240, [0.0, 0.3, 0], 4),   # large, moving
        ([-2, -2, 0], 60, [1.2, 0.4, 0], 9),     # relabelled mover
        ([5.6, 3.2, 0], 70, [-0.8, 0.9, 0], 10),  # relabelled mover
        ([-5.6, -3.6, 0], 50, [0.5, -1.0, 0], 11),  # relabelled mover
        ([3.2, 4.8, 0], 40, [0, 0, 0], 12),      # relabelled static
        ([-4.8, 4.8, 0], 45, [0.3, 0, 0], 13),
        ([6.4, -5.6, 0], 30, [0, 0, 0], 14),
    ]
    src, dst, ls, ld = [], [], [], []
    for lbl, (c, n, shift, dl) in enumerate(specs):
        pts = np.asarray(c, np.float32) + rng.uniform(-1, 1, (n, 3))
        pts[:, 2] *= 0.5
        src.append(pts)
        ls.append(np.full(n, lbl))
        dst.append(pts + shift + rng.normal(scale=0.01, size=pts.shape))
        ld.append(np.full(n, dl))
    # static stowaways of a moving cluster: points labelled 3 in both frames
    # that do not move, clear of cluster 3's moved body
    stow = np.asarray(specs[3][0], np.float32) + [2.2, 0, 0] \
        + rng.uniform(-0.2, 0.2, (12, 3))
    src.append(stow)
    ls.append(np.full(12, 3))
    dst.append(stow + rng.normal(scale=0.005, size=stow.shape))
    ld.append(np.full(12, 3))

    def pad(p, lab):
        p = np.concatenate(p).astype(np.float32)
        lab = np.concatenate(lab).astype(np.int32)
        pp = np.zeros((n_cap, 3), np.float32)
        pp[:len(p)] = p
        vv = np.zeros(n_cap, bool)
        vv[:len(p)] = True
        ll = np.full(n_cap, -1, np.int32)
        ll[:len(lab)] = lab
        return pp, vv, ll

    return pad(src, ls), pad(dst, ld)


@pytest.fixture(scope="module")
def matched():
    (ps, vs, ls), (pd, vd, ld) = _scene(np.random.default_rng(0))
    tf = 3.0
    kw = dict(num_labels=JCFG.num_clusters, max_points=JCFG.max_points)
    js = j_extract(jnp.asarray(ps), jnp.asarray(ls), jnp.asarray(vs), **kw)
    jd = j_extract(jnp.asarray(pd), jnp.asarray(ld), jnp.asarray(vd), **kw)
    jr = jmatch.match_frame_pair(js, jd, jnp.float32(tf), JCFG)
    ts = t_extract(*(torch.as_tensor(a) for a in (ps, ls, vs)), **kw)
    td = t_extract(*(torch.as_tensor(a) for a in (pd, ld, vd)), **kw)
    tr = tmatch.match_frame_pair(ts, td, tf, TCFG)
    return (ps, ls), (js, jr), (ts, tr)


def test_match_frame_pair_matches_jax(matched):
    _, (js, jr), (ts, tr) = matched
    for name in ("matched", "dst_label", "identity_pt"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)),
                                      err_msg=name)
    assert int(tr.overflow) == int(jr.overflow) > 0
    assert tr.identity_pt.any()
    np.testing.assert_allclose(tr.transforms.numpy(),
                               np.asarray(jr.transforms), atol=ATOL)
    np.testing.assert_allclose(tr.stats.numpy(), np.asarray(jr.stats),
                               atol=ATOL)
    # both stages did real work
    m = tr.matched.numpy()
    dl = tr.dst_label.numpy()
    assert m[0] and m[2] and dl[0] == 0
    assert (m & (dl != np.arange(len(m)))).any()


def test_flow_with_identity_override_matches_jax(matched):
    (ps, ls), (js, jr), (ts, tr) = matched
    pose = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.05), np.sin(0.05)
    pose[:2, :2] = [[c, -s], [s, c]]
    pose[:3, 3] = [1.1, -0.3, 0.02]
    jf = jflow.flow_with_identity_override(
        jnp.asarray(ps), jnp.asarray(ls), jr.transforms, jnp.asarray(pose),
        js.pidx, jr.identity_pt)
    tf = tflow.flow_with_identity_override(
        torch.as_tensor(ps), torch.as_tensor(ls), tr.transforms,
        torch.as_tensor(pose), ts.pidx, tr.identity_pt)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=ATOL)
    jp = jflow.flow_from_transforms(jnp.asarray(ps), jnp.asarray(ls),
                                    jr.transforms, jnp.asarray(pose))
    tp = tflow.flow_from_transforms(torch.as_tensor(ps), torch.as_tensor(ls),
                                    tr.transforms, torch.as_tensor(pose))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL)


def test_gates_and_assignment_match_jax():
    rng = np.random.default_rng(1)
    L = 12
    cnt = rng.integers(0, 60, L)
    mean = rng.uniform(-10, 10, (L, 3)).astype(np.float32)
    ext = np.sort(rng.uniform(0.1, 4, (L, 3)), 1).astype(np.float32)
    ext2 = (ext * rng.uniform(0.05, 1.5, (L, 3))).astype(np.float32)
    kw = dict(min_cluster_size=20, thres_box=0.1, translation_frame=6.0)
    j = jgates.sanity_matrix(jnp.asarray(cnt), jnp.asarray(mean),
                             jnp.asarray(ext), jnp.asarray(cnt[::-1].copy()),
                             jnp.asarray(mean[::-1].copy()),
                             jnp.asarray(ext2), **kw)
    t = tgates.sanity_matrix(torch.as_tensor(cnt), torch.as_tensor(mean),
                             torch.as_tensor(ext),
                             torch.as_tensor(cnt[::-1].copy()),
                             torch.as_tensor(mean[::-1].copy()),
                             torch.as_tensor(ext2), **kw)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # assignment: repeated sources and exact error ties -> lowest pair index
    K = 20
    src = rng.integers(0, L, K).astype(np.int32)
    err = rng.choice([0.05, 0.1, 0.15, 0.3], K).astype(np.float32)
    acc = rng.random(K) > 0.3
    jm, jc = jmatch._assign(jnp.asarray(src), jnp.asarray(src),
                            jnp.asarray(err), jnp.asarray(acc), L, 0.2)
    tm, tc = tmatch._assign(torch.as_tensor(src), torch.as_tensor(err),
                            torch.as_tensor(acc), L, 0.2)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    trans = rng.normal(scale=3, size=(K, 3)).astype(np.float32)
    rot = rng.normal(scale=8, size=(K, 3)).astype(np.float32)
    iou = rng.random(K).astype(np.float32)
    kw = dict(translation_frame=4.0, thres_iou=0.2, thres_rot=0.1,
              thres_z=0.3)
    np.testing.assert_array_equal(
        tgates.check_transformation(torch.as_tensor(trans),
                                    torch.as_tensor(rot),
                                    torch.as_tensor(iou), **kw).numpy(),
        np.asarray(jgates.check_transformation(
            jnp.asarray(trans), jnp.asarray(rot), jnp.asarray(iou), **kw)))


# ---- the port alone on pathological inputs: finite, right shape --------
_ROBUST = T.DEMO.replace(
    max_points_scene=2048, max_points=256, num_clusters=16, max_pairs=16,
    pairs_small=16, pairs_large=4, max_points_small=128, min_cluster_size=5,
    nn_tile=128, hist_grid_xy=32, icp_max_iters=10, epsilon=0.4)


def _robust_cases():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 5, 200)[:, None] * np.array([[1.0, 0.3, 0.0]])
    far = rng.uniform(-1, 1, (200, 3)) + [500.0, -800.0, 50.0]
    dup = np.tile(np.array([[1.0, 2.0, 0.5]]), (300, 1))
    return {
        "duplicates": (dup, dup),
        "collinear": (t, t + [0.5, 0.15, 0.0]),
        "single_point": (np.zeros((1, 3)), np.zeros((1, 3))),
        "extreme_coordinates": (far, far),
        "empty_src": (np.zeros((0, 3)), dup),
    }


@pytest.mark.parametrize("case", sorted(_robust_cases()))
def test_port_is_finite_on_pathological_inputs(case):
    src, dst = _robust_cases()[case]
    eng = T.SceneFlowEngine(_ROBUST, device="cpu")
    res = T.run_frame_pair(eng, src.astype(np.float32),
                           dst.astype(np.float32), translation_frame=4.0)
    assert res.flow.shape == (len(src), 3)
    assert np.isfinite(res.flow).all() and np.isfinite(res.transforms).all()
    if case == "extreme_coordinates":
        assert np.abs(res.flow).max() < 1.0     # static scene


def test_port_is_bitwise_deterministic():
    rng = np.random.default_rng(11)
    src = rng.uniform(-5, 5, (800, 3)).astype(np.float32)
    dst = (src + np.array([0.8, -0.2, 0.0], np.float32)
           + rng.normal(scale=0.01, size=src.shape).astype(np.float32))
    eng = T.SceneFlowEngine(_ROBUST, device="cpu")
    r1 = T.run_frame_pair(eng, src, dst, translation_frame=4.0)
    r2 = T.run_frame_pair(eng, src, dst, translation_frame=4.0)
    np.testing.assert_array_equal(r1.flow, r2.flow)
    np.testing.assert_array_equal(r1.labels_src, r2.labels_src)
    np.testing.assert_array_equal(r1.pairs, r2.pairs)
