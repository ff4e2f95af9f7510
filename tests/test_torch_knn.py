"""The port's NN sweep (ops/knn.py) against the JAX package.

On the CPU the port runs its plain PyTorch version, which has the same
contract and arithmetic as its CUDA kernel (the kernel itself is held
against it on the card by chip_smoke.py). Here the plain version is held
against the JAX package's XLA sweep and against the Pallas TPU kernels in
interpret mode, on clouds with a row that has no valid dst, exact duplicate
dst points, and M not a multiple of the tile.

Tolerances: dist within 1e-5 m and idx exact. Two fp32 evaluations of one
formula differ in the last bits only, but the expanded form's d^2 carries
cancellation noise of about ulp(|x|^2 + |y|^2): 1e-4 m^2 at 20 m, which
moves a 4 m distance by up to 6e-5 m between implementations. So the
expanded form is compared on clouds within 2 m of the origin (noise a few
1e-6 m), the elementwise form on clouds within 20 m. The random clouds have
no near-ties below the noise; the duplicates are exact ties and must
resolve to the lowest index on both sides.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from icpflow_tpu.ops import knn as jknn  # noqa: E402
from icpflow_tpu.ops.pallas.nn_kernel import (  # noqa: E402
    masked_nn_pallas, masked_nn_points_pallas)

from icpflow_tpu_torch import trace  # noqa: E402
from icpflow_tpu_torch.ops import knn as tknn  # noqa: E402

torch.set_num_threads(2)
ATOL = 1e-5


def _cloud(seed, b=3, n=200, m=300, expanded=True):
    rng = np.random.default_rng(seed)
    r = 2.0 if expanded else 20.0
    src = rng.uniform(-r, r, (b, n, 3)).astype(np.float32)
    dst = rng.uniform(-r, r, (b, m, 3)).astype(np.float32)
    mask = rng.random((b, m)) > 0.3
    mask[0] = False                              # a row with no valid dst
    dst[1, m // 2:] = dst[1, :m - m // 2]        # exact duplicates
    mask[1] = True
    return src, dst, mask


def _t(*arrs):
    return [torch.as_tensor(a) for a in arrs]


@pytest.mark.parametrize("exact", [False, True])
def test_plain_matches_xla_sweep(exact):
    src, dst, mask = _cloud(0, expanded=not exact)
    ji, jd = jknn._masked_nn_xla(jnp.asarray(src), jnp.asarray(dst),
                                 jnp.asarray(mask), tile=128, exact=exact)
    ti, td = tknn.masked_nn_plain(*_t(src, dst, mask),
                                  form="elementwise" if exact else "expanded",
                                  points=False, tile=128)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=ATOL)
    assert ti.dtype == torch.int32
    assert (ti[0] == 0).all() and (td[0] == 1e15).all()


@pytest.mark.parametrize("variant", ["mxu", "vpu"])
def test_plain_matches_pallas_index_kernels_interpreted(variant):
    src, dst, mask = _cloud(1, expanded=variant == "mxu")
    ji, jd = masked_nn_pallas(jnp.asarray(src), jnp.asarray(dst),
                              jnp.asarray(mask), tn=128, tm=128,
                              interpret=True, variant=variant)
    ti, td = tknn.masked_nn_plain(*_t(src, dst, mask),
                                  form=tknn._VARIANT_FORM[variant],
                                  points=False)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=ATOL)


@pytest.mark.parametrize("variant", ["mxu", "vpu"])
def test_plain_matches_pallas_points_kernel_interpreted(variant):
    src, dst, mask = _cloud(2, expanded=variant == "mxu")
    jp, jd = masked_nn_points_pallas(jnp.asarray(src), jnp.asarray(dst),
                                     jnp.asarray(mask), tn=128, tm=128,
                                     interpret=True, variant=variant)
    tp, td = tknn.masked_nn_plain(*_t(src, dst, mask),
                                  form=tknn._VARIANT_FORM[variant],
                                  points=True)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=ATOL)
    assert (tp[0] == 0).all()


def test_dispatch_on_cpu_reaches_plain_version_with_reference_semantics():
    src, dst, mask = _cloud(3, m=384)
    s, d, mk = _t(src, dst, mask)
    trace.clear_launches()
    ti, td = tknn.masked_nn(s, d, mk, tile=128)
    tp, tpd = tknn.masked_nn_points(s, d, mk, tile=128)
    assert trace.launch_shapes() == {
        ("masked_nn_plain", (s.shape[0], s.shape[1], d.shape[1])): 2}
    ji, jd = jknn.masked_nn(jnp.asarray(src), jnp.asarray(dst),
                            jnp.asarray(mask), tile=128)
    jp, jpd = jknn.masked_nn_points(jnp.asarray(src), jnp.asarray(dst),
                                    jnp.asarray(mask), tile=128)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tpd.numpy(), np.asarray(jpd), atol=ATOL)
    smask = np.random.default_rng(4).random(src.shape[:2]) > 0.5
    te = tknn.masked_nn_error(s[1:], torch.as_tensor(smask[1:]), d[1:],
                              mk[1:], tile=128)
    je = jknn.masked_nn_error(jnp.asarray(src[1:]), jnp.asarray(smask[1:]),
                              jnp.asarray(dst[1:]), jnp.asarray(mask[1:]),
                              tile=128)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6)


def test_form_policy_follows_the_accelerator(monkeypatch):
    """Elementwise at 2048 <= m <= 8192 (what the TPU ran, knn.py:81-105),
    expanded below; the override picks a form for 128 <= m <= 8192."""
    rng = np.random.default_rng(5)
    src = rng.uniform(-2, 2, (1, 64, 3)).astype(np.float32)
    dst = rng.uniform(-2, 2, (1, 2048, 3)).astype(np.float32)
    mask = rng.random((1, 2048)) > 0.1
    s, d, mk = _t(src, dst, mask)
    ji, jd = jknn._masked_nn_xla(jnp.asarray(src), jnp.asarray(dst),
                                 jnp.asarray(mask), tile=512, exact=True)
    ti, td = tknn.masked_nn(s, d, mk, tile=512)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)
    want = tknn.masked_nn_plain(s, d, mk, form="elementwise", points=False)
    assert torch.equal(ti, want[0]) and torch.equal(td, want[1])
    monkeypatch.setenv("ICPFLOW_NN_VARIANT", "mxu")
    ti, td = tknn.masked_nn(s, d, mk)
    want = tknn.masked_nn_plain(s, d, mk, form="expanded", points=False)
    assert torch.equal(ti, want[0]) and torch.equal(td, want[1])
    assert tknn.pick_variant(512) == "mxu"
    monkeypatch.setenv("ICPFLOW_NN_VARIANT", "vpu")
    assert tknn.sweep_form(100, False) == "expanded"
    assert tknn.sweep_form(512, False) == "elementwise"
    assert tknn.sweep_form(100, True) == "elementwise"


def _cloud_vpu2(seed, b=3, n=200, m=301):
    """20 m clouds, M not a multiple of 8: row 0 has no valid dst, row 1
    holds exact duplicates, and src point 0 of row 2 sits at the origin
    with exactly two dst points at distance 1, at j=2 and j=9."""
    src, dst, mask = _cloud(seed, b=b, n=n, m=m, expanded=False)
    src[2, 0] = 0.0
    dst[2, 2] = (1.0, 0.0, 0.0)
    dst[2, 9] = (0.0, 1.0, 0.0)
    mask[2] &= np.linalg.norm(dst[2], axis=1) > 1.0
    mask[2, [2, 9]] = True
    return src, dst, mask


@pytest.mark.parametrize("points", [False, True])
def test_plain_matches_pallas_vpu2_kernels_interpreted(points):
    """The sentinel form (TPU kernels _nn_kernel_vpu2 / _nn_kernel_pts_vpu2,
    tc=8): idx and points exact, dist within 1e-5 m, including the row with
    no valid dst (sentinel distance ~1.73e6 and the sentinel point) and the
    tie, which the index form gives to j=2 and the points form to j=9."""
    src, dst, mask = _cloud_vpu2(6)
    fn = masked_nn_points_pallas if points else masked_nn_pallas
    jo, jd = fn(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
                tn=128, tm=128, interpret=True, variant="vpu2", tc=8)
    to, td = tknn.masked_nn_plain(*_t(src, dst, mask), form="sentinel",
                                  points=points, tile=128)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(td[1:].numpy(), np.asarray(jd)[1:], rtol=0,
                               atol=ATOL)
    # the empty row's ~1.73e6 m lies where one fp32 ulp is 0.125 m, and
    # XLA:CPU may contract the sum of squares into FMAs: one ulp apart
    np.testing.assert_allclose(td[0].numpy(), np.asarray(jd)[0],
                               rtol=2.0 ** -23, atol=0)
    d_empty = np.sqrt((((1e6 - src[0].astype(np.float64)) ** 2).sum(-1)))
    np.testing.assert_allclose(td[0].numpy(), d_empty, rtol=1e-6)
    assert float(td[2, 0]) == 1.0
    if points:
        assert (to[0] == 1e6).all()
        np.testing.assert_array_equal(to[2, 0].numpy(), dst[2, 9])
    else:
        assert to.dtype == torch.int32 and (to[0] == 0).all()
        assert int(to[2, 0]) == 2


def test_vpu2_override_reaches_the_sentinel_form(monkeypatch):
    src, dst, mask = _cloud_vpu2(7, m=384)
    s, d, mk = _t(src, dst, mask)
    monkeypatch.setenv("ICPFLOW_NN_VARIANT", "vpu2")
    for fn, points in ((tknn.masked_nn, False), (tknn.masked_nn_points, True)):
        got = fn(s, d, mk, tile=128)
        want = tknn.masked_nn_plain(s, d, mk, form="sentinel", points=points)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # every plain tile split gives the same winners
    for points in (False, True):
        a = tknn.masked_nn_plain(s, d, mk, form="sentinel", points=points,
                                 tile=5)
        z = tknn.masked_nn_plain(s, d, mk, form="sentinel", points=points,
                                 tile=384)
        assert torch.equal(a[0], z[0]) and torch.equal(a[1], z[1])
