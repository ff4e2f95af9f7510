"""The port's CZM ground segmentation (ops/ground.py) against the JAX package.

The scenes are those of tests/test_ground.py: flat and sloped ground with
boxes, a wall through zone 0 (the R-VPF peel and the re-gather), a raised
terrace flat and rough (TGR), and a cloud with invalid points. Both
packages get the same numpy inputs.

Tolerances: the mask must agree on at least 99.9% of valid points and the
adaptive state within 1e-4 relative. The plane fits go through a batched
3x3 eigh, which XLA and PyTorch solve with different routines, so a
near-degenerate patch may turn its normal. Measured on the CPU: the masks
agree on every point of every scene here (share 1.0) and the state to
within 7e-6 relative.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from icpflow_tpu.ops import ground as jg  # noqa: E402
from icpflow_tpu_torch.ops import ground as tg  # noqa: E402
from test_ground import make_scene  # noqa: E402

torch.set_num_threads(2)
MIN_AGREE = 0.999
RTOL = 1e-4


def _wall_scene():
    rng = np.random.default_rng(4)
    pts, _ = make_scene(rng, n_ground=30000)
    nw = 4000
    wall = np.stack([rng.uniform(3.0, 5.5, nw),
                     2.5 + rng.normal(scale=0.02, size=nw),
                     rng.uniform(-2.0, 0.2, nw)], 1).astype(np.float32)
    return np.concatenate([pts, wall]).astype(np.float32)


def _terrace_scene(noise):
    rng = np.random.default_rng(5)
    pts, _ = make_scene(rng, n_ground=30000, n_obj=0)
    in_area = (pts[:, 0] > -21) & (pts[:, 0] < -13) & (np.abs(pts[:, 1]) < 4)
    pts = pts[~in_area]
    ns = 3000
    terrace = np.stack([rng.uniform(-20, -14, ns), rng.uniform(-3, 3, ns),
                        -1.723 + 0.3 + rng.normal(scale=noise, size=ns)],
                       1).astype(np.float32)
    return np.concatenate([pts, terrace]).astype(np.float32)


def _scene(name):
    """(points, valid) of one named scene."""
    if name == "flat":
        pts = make_scene(np.random.default_rng(0))[0]
    elif name == "sloped":
        pts = make_scene(np.random.default_rng(1), slope=0.03)[0]
    elif name == "wall":
        pts = _wall_scene()
    elif name == "terrace_flat":
        pts = _terrace_scene(0.03)
    elif name == "terrace_rough":
        pts = _terrace_scene(0.2)
    else:                                      # "invalid"
        pts = make_scene(np.random.default_rng(3), n_ground=500, n_obj=60)[0]
        valid = np.zeros(len(pts), bool)
        valid[:100] = True
        return pts, valid
    return pts, np.ones(len(pts), bool)


def _agree(jmask, tmask, valid):
    jm, tm = np.asarray(jmask), tmask.numpy()
    assert not tm[~valid].any()
    return float((jm == tm)[valid].mean())


def _assert_state_close(js, ts):
    for name, a, b in zip(tg.GroundState._fields, js, ts):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=RTOL,
                                   atol=RTOL * np.abs(a).max() + 1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("name", ["flat", "sloped", "wall", "terrace_flat",
                                  "terrace_rough", "invalid"])
def test_czm_ground_mask_stateful_matches_jax(name):
    pts, valid = _scene(name)
    jm, js = jg.czm_ground_mask_stateful(jnp.asarray(pts), jnp.asarray(valid),
                                         jg.initial_ground_state())
    tm, ts = tg.czm_ground_mask_stateful(torch.as_tensor(pts),
                                         torch.as_tensor(valid),
                                         tg.initial_ground_state("cpu"))
    assert _agree(jm, tm, valid) >= MIN_AGREE
    _assert_state_close(js, ts)
    stateless = tg.czm_ground_mask(torch.as_tensor(pts),
                                   torch.as_tensor(valid))
    assert torch.equal(stateless, tm)


def test_segment_ground_matches_jax():
    pts, _ = make_scene(np.random.default_rng(2))
    valid = np.ones(len(pts), bool)
    kw = dict(range_z=-1.723, ground_slack=0.3)
    for use_czm in (True, False):
        jn = jg.segment_ground(jnp.asarray(pts), jnp.asarray(valid),
                               use_czm=use_czm, **kw)
        tn = tg.segment_ground(torch.as_tensor(pts), torch.as_tensor(valid),
                               use_czm=use_czm, **kw)
        assert _agree(jn, tn, valid) >= MIN_AGREE
    jn, js = jg.segment_ground_stateful(jnp.asarray(pts), jnp.asarray(valid),
                                        jg.initial_ground_state(), **kw)
    tn, ts = tg.segment_ground_stateful(torch.as_tensor(pts),
                                        torch.as_tensor(valid),
                                        tg.initial_ground_state("cpu"), **kw)
    assert _agree(jn, tn, valid) >= MIN_AGREE
    _assert_state_close(js, ts)
    via_state = tg.segment_ground(torch.as_tensor(pts), torch.as_tensor(valid),
                                  state=tg.initial_ground_state("cpu"), **kw)
    assert torch.equal(via_state, tn)


def test_state_carried_across_from_jax_gives_the_same_second_frame():
    """Frame 1 on JAX, its state handed to the port as numpy, frame 2 on
    both: the same mask and the same updated state."""
    pts1, _ = make_scene(np.random.default_rng(6))
    pts2, _ = make_scene(np.random.default_rng(7))
    valid = np.ones(len(pts1), bool)
    _, js1 = jg.czm_ground_mask_stateful(jnp.asarray(pts1), jnp.asarray(valid),
                                         jg.initial_ground_state())
    ts1 = tg.ground_state_from_arrays(*(np.asarray(a) for a in js1),
                                      device="cpu")
    assert (ts1.elev_thr < -1.0).all()           # adapted near true ground
    jm2, js2 = jg.czm_ground_mask_stateful(jnp.asarray(pts2),
                                           jnp.asarray(valid), js1)
    tm2, ts2 = tg.czm_ground_mask_stateful(torch.as_tensor(pts2),
                                           torch.as_tensor(valid), ts1)
    assert _agree(jm2, tm2, valid) >= MIN_AGREE
    _assert_state_close(js2, ts2)


def _ring_boundaries():
    return np.asarray([lo + k * (hi - lo) / nr for lo, hi, nr in zip(
        jg.ZONE_BOUNDS[:-1], jg.ZONE_BOUNDS[1:], jg.ZONE_RINGS)
        for k in range(nr + 1)])


def _points(rng, r, sector_offset):
    """Points at ranges ``r``, at angles ``sector_offset`` sectors past a
    sector boundary of their zone, plus four on the atan2 branch cut."""
    zone = np.clip(np.searchsorted(jg.ZONE_BOUNDS, r, side="right") - 1, 0, 3)
    ns = np.asarray(jg.ZONE_SECTORS)[zone]
    th = ((rng.integers(0, 54, len(r)) % ns) + sector_offset) \
        * (2 * np.pi / ns) - np.pi
    pts = np.stack([r * np.cos(th), r * np.sin(th), rng.normal(size=len(r))],
                   1).astype(np.float32)
    pts[:4, :2] = [[-5.0, 0.0], [-5.0, -0.0], [-30.0, 0.0], [-30.0, -0.0]]
    return pts


def _near_bin_boundary(pts, tol=1e-5):
    """Within ``tol`` (relative in range, radians in angle) of a ring, zone
    or sector boundary, in float64."""
    p = pts.astype(np.float64)
    r = np.hypot(p[:, 0], p[:, 1])
    th = np.arctan2(p[:, 1], p[:, 0]) + np.pi
    near = np.abs(r[:, None] - _ring_boundaries()[None]).min(1) <= tol * r
    for ns in jg.ZONE_SECTORS:
        w = 2 * np.pi / ns
        f = np.mod(th, w)
        near |= np.minimum(f, w - f) <= tol
    return near


def test_patch_index_matches_jax_off_and_on_bin_boundaries():
    """Off the bin boundaries, and on the atan2 branch cut (y = +-0, x < 0),
    the patch ids are the reference's exactly: the bins scale by the fp32
    constants XLA folds the reference's divisions into. On a boundary
    itself the range (a sum of squares XLA may fuse) and atan2 can differ
    by an ulp between XLA and PyTorch, and a point may land in the
    neighbouring bin. Measured on the CPU: 0.04% of points placed on ring
    boundaries and ~3% of those placed on sector boundaries."""
    rng = np.random.default_rng(9)
    pts = _points(rng, rng.uniform(0.5, 70.0, 20000), 0.5)
    pts = pts[~_near_bin_boundary(pts) | (np.arange(len(pts)) < 4)]
    want = np.asarray(jg._patch_index(jnp.asarray(pts)))
    got = tg._patch_index(torch.as_tensor(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).mean() > 0.8

    r = np.repeat(_ring_boundaries().astype(np.float32), 200)
    for offset in (0.5, 0.0):
        pts = _points(rng, r if offset else rng.uniform(0.5, 70.0, 4000),
                      offset)
        want = np.asarray(jg._patch_index(jnp.asarray(pts)))
        got = tg._patch_index(torch.as_tensor(pts)).numpy()
        same = got == want
        assert (same | _near_bin_boundary(pts)).all()
        assert same.mean() > 0.9
