"""What the redesigned NN kernel relies on, checked on the CPU.

The CUDA kernel (``csrc/nn_kernel.cu``) skips padding in dst and src, splits
dst over blocks and merges their results by a packed 64-bit key. It runs only
on the card, where ``chip_smoke.py`` holds it against the plain version bit
for bit. Here the properties that make those shortcuts exact are tested on
the plain version and on a numpy model of the split:

(a) a masked sweep equals the sweep over dst with the invalid points
    removed, so skipping padding cannot change a result;
(b) per-slice nearest neighbours combined by the minimum of
    (float32 bits of d2) << 32 | j equal the one-pass sweep, ties, empty
    slices and empty rows included;
(c) ``src_mask``: masked-out src rows get idx 0 / zeros / 1e15, the others
    are unchanged, and the odometry's ICP returns the same pose with it;
(d) the bound and the launch plan against hand-computed values.

Every comparison is exact (bit for bit) unless it says otherwise.
"""

import numpy as np
import pytest
import torch

from icpflow_tpu_torch.ops import ego as tego
from icpflow_tpu_torch.ops import knn as tknn
from icpflow_tpu_torch.ops.cuda import nn_kernel

torch.set_num_threads(2)
FORMS_POINTS = [(f, p) for f in ("expanded", "elementwise", "sentinel")
                for p in (False, True)]


def _cloud(seed, b=2, n=150, m=700):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-3.0, 3.0, (b, n, 3)).astype(np.float32)
    dst = rng.uniform(-3.0, 3.0, (b, m, 3)).astype(np.float32)
    return src, dst, rng


def _mask(kind, rng, b, m):
    if kind == "prefix":
        return np.arange(m)[None] < rng.integers(1, m, (b, 1))
    mask = rng.random((b, m)) < 0.8
    mask[:, m // 5:m // 5 + m // 2] = False        # a long hole
    return mask


def _plain(src, dst, mask, **kw):
    out, dist = tknn.masked_nn_plain(
        torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(mask),
        **kw)
    return out.numpy(), dist.numpy()


# -- (a) padding can be skipped ---------------------------------------------
@pytest.mark.parametrize("kind", ["prefix", "holed"])
@pytest.mark.parametrize("points", [False, True])
@pytest.mark.parametrize("form", ["expanded", "elementwise"])
def test_masked_sweep_equals_sweep_over_valid_dst(form, points, kind):
    src, dst, rng = _cloud(3)
    mask = _mask(kind, rng, *dst.shape[:2])
    dst[0, 5] = dst[0, 2]                            # a tie among valid dst
    mask[0, [2, 5]] = True
    out, dist = _plain(src, dst, mask, form=form, points=points)
    for b in range(len(src)):
        keep = np.flatnonzero(mask[b])
        o, d = _plain(src[b:b + 1], dst[b:b + 1, keep],
                      np.ones((1, len(keep)), bool), form=form, points=points)
        np.testing.assert_array_equal(dist[b], d[0])
        np.testing.assert_array_equal(out[b], o[0] if points else keep[o[0]])


# -- (b) the split and its packed key ----------------------------------------
def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)


def test_float_bits_order_like_nonnegative_floats():
    vals = np.array([0.0, 1e-45, 1e-40, 1.1754944e-38, 1e-20, 0.5, 1.0,
                     1.0000001, 3e12, 1e30, 3e38, np.inf], np.float32)
    assert (np.diff(vals) > 0).all()
    assert (np.diff(_bits(vals).astype(np.int64)) > 0).all()
    # the key: d2 first, the index breaks ties, and the scratch's start
    # (1e30, 0) is above every candidate a sweep can take
    key = (_bits(vals) << np.uint64(32))
    assert (key[:-1] | np.uint64(0xFFFFFFFF) < key[1:]).all()
    assert nn_kernel._NONE_KEY == int(_bits(1e30)) << 32
    assert nn_kernel._NONE_KEY < 2 ** 63              # fits torch.int64


def _split_model(src, dst, mask, slices, chunk):
    """The kernel's split in numpy: slice z sweeps chunks z, z + S, ... in
    index order with a strict ``<``; the slices' (d2, j) are merged by the
    minimum of the packed key, starting from (1e30, 0)."""
    b, n, _ = src.shape
    m = dst.shape[1]
    x = [src[:, :, None, k] for k in range(3)]
    y = [dst[:, None, :, k] for k in range(3)]
    a, c, e = (y[k] - x[k] for k in range(3))
    d2 = (a * a + c * c) + e * e                     # float32, rounded each
    assert d2.dtype == np.float32
    d2 = np.where(mask[:, None, :], d2, np.float32(np.inf))
    key = np.full((b, n), nn_kernel._NONE_KEY, np.uint64)
    for z in range(slices):
        best = np.full((b, n), np.float32(1e30))
        best_j = np.zeros((b, n), np.uint64)
        for j0 in range(z * chunk, m, slices * chunk):
            part = d2[:, :, j0:j0 + chunk]
            arg = part.argmin(axis=2)                # first occurrence
            val = np.take_along_axis(part, arg[..., None], 2)[..., 0]
            take = val < best
            best = np.where(take, val, best)
            best_j = np.where(take, (arg + j0).astype(np.uint64), best_j)
        found = best < np.float32(1e30)
        cand = (_bits(best) << np.uint64(32)) | best_j
        key = np.where(found, np.minimum(key, cand), key)
    best = (key >> np.uint64(32)).astype(np.uint32).view(np.float32)
    idx = np.minimum((key & np.uint64(0xFFFFFFFF)).astype(np.int64), m - 1)
    # the last step as the plain version takes it (torch's vectorised sqrt
    # and numpy's differ in the last bit for a few values)
    dist = torch.sqrt(torch.clamp(torch.as_tensor(best.copy()), min=0.0))
    return idx.astype(np.int32), dist.numpy()


@pytest.mark.parametrize("slices", [1, 2, 3, 7])
def test_split_model_equals_one_pass(slices):
    chunk = 64
    src, dst, rng = _cloud(11, b=3, n=90, m=5 * chunk + 17)
    mask = rng.random(dst.shape[:2]) < 0.85
    dst[:, chunk:2 * chunk] = dst[:, :chunk]         # duplicates: chunk 1
    mask[:, :2 * chunk] = True                       # repeats chunk 0
    mask[1, 2 * chunk:3 * chunk] = False             # an all-invalid chunk
    mask[2] = False                                  # an all-invalid row
    want_i, want_d = _plain(src, dst, mask, form="elementwise", points=False)
    got_i, got_d = _split_model(src, dst, mask, slices, chunk)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d.view(np.uint32),
                                  want_d.view(np.uint32))
    assert (want_i[:2] < chunk).any()                # the lower duplicate won
    assert not ((want_i >= chunk) & (want_i < 2 * chunk)).any()
    assert (want_i[2] == 0).all() and (want_d[2] == 1e15).all()


def test_split_model_with_sentinel_candidates():
    """The sentinel form keeps invalid dst as candidates at 1e6: the same
    key merges them (d2 ~ 3e12 is far below the scratch's 1e30)."""
    chunk = 64
    src, dst, rng = _cloud(12, b=2, n=50, m=3 * chunk + 5)
    mask = rng.random(dst.shape[:2]) < 0.5
    mask[1] = False
    moved = np.where(mask[..., None], dst, np.float32(1e6))
    want_i, want_d = _plain(src, dst, mask, form="sentinel", points=False)
    got_i, got_d = _split_model(src, moved, np.ones_like(mask), 3, chunk)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)
    assert (want_d[1] > 1.7e6).all() and (want_i[1] == 0).all()


# -- (c) src_mask -------------------------------------------------------------
@pytest.mark.parametrize("form,points", FORMS_POINTS)
def test_src_mask_on_the_plain_version(form, points):
    src, dst, rng = _cloud(21)
    mask = _mask("holed", rng, *dst.shape[:2])
    wanted = rng.random(src.shape[:2]) < 0.6
    wanted[1] = False
    base_o, base_d = _plain(src, dst, mask, form=form, points=points)
    none_o, none_d = _plain(src, dst, mask, form=form, points=points,
                            src_mask=None)
    np.testing.assert_array_equal(none_o, base_o)
    np.testing.assert_array_equal(none_d, base_d)
    out, dist = _plain(src, dst, mask, form=form, points=points,
                       src_mask=torch.as_tensor(wanted))
    np.testing.assert_array_equal(out[wanted], base_o[wanted])
    np.testing.assert_array_equal(dist[wanted], base_d[wanted])
    assert (dist[~wanted] == 1e15).all()
    assert (out[~wanted] == 0).all()


def test_src_mask_reaches_the_plain_version_through_the_api():
    src, dst, rng = _cloud(22, m=300)
    mask = _mask("prefix", rng, *dst.shape[:2])
    wanted = np.arange(src.shape[1])[None] < np.array([[40], [0]])
    t = [torch.as_tensor(a) for a in (src, dst, mask)]
    sm = torch.as_tensor(wanted)
    for exact in (False, True):
        idx, dist = tknn.masked_nn(*t, exact=exact, src_mask=sm)
        ref_i, ref_d = tknn.masked_nn(*t, exact=exact)
        assert torch.equal(idx[sm], ref_i[sm]) and torch.equal(dist[sm],
                                                               ref_d[sm])
        assert (dist[~sm] == 1e15).all() and (idx[~sm] == 0).all()


def test_register_frame_icp_same_pose_with_and_without_src_mask(monkeypatch):
    """The odometry passes its source validity as ``src_mask``. The masked
    rows carry weight 0 in every step and in the score whatever their
    neighbour, and a weight-0 row adds exact zeros to every sum, so the pose
    is the same bits as from a sweep over all rows."""
    rng = np.random.default_rng(5)
    world = rng.uniform(-8.0, 8.0, (1500, 3)).astype(np.float32)
    world[:, 2] *= 0.2
    mp = np.zeros((2048, 3), np.float32)
    mp[:len(world)] = world
    mv = np.arange(2048) < len(world)
    shift = np.array([0.3, -0.1, 0.02], np.float32)
    scan = (world[::3] - shift
            + rng.normal(scale=0.01, size=world[::3].shape)).astype(np.float32)
    src = rng.uniform(-8.0, 8.0, (1024, 3)).astype(np.float32)  # junk padding
    src[:len(scan)] = scan
    sv = np.arange(1024) < len(scan)
    args = [torch.as_tensor(a) for a in (src, sv, mp, mv,
                                          np.eye(4, dtype=np.float32))]
    with_mask = tego.register_frame_icp(*args, 3.0, 1.0 / 3.0, iters=30)

    seen = []
    real = tknn.masked_nn

    def no_src_mask(*a, src_mask=None, **kw):
        seen.append(src_mask is not None)
        return real(*a, **kw)

    monkeypatch.setattr(tego._knn, "masked_nn", no_src_mask)
    without = tego.register_frame_icp(*args, 3.0, 1.0 / 3.0, iters=30)
    assert seen and all(seen)                 # the odometry passed it
    assert torch.equal(with_mask, without)
    assert np.linalg.norm(with_mask[:3, 3].numpy() - shift) < 0.02


def test_wrapper_refuses_cpu_tensors_and_bad_src_masks():
    src, dst, rng = _cloud(23, m=64)
    t = [torch.as_tensor(a) for a in (src, dst, np.ones(dst.shape[:2], bool))]
    with pytest.raises(ValueError, match="CUDA tensor"):
        nn_kernel.masked_nn_cuda(*t, form="elementwise", points=False,
                                 src_mask=torch.ones(src.shape[:2],
                                                     dtype=torch.bool))
    with pytest.raises(ValueError, match="form"):
        nn_kernel.masked_nn_cuda(*t, form="vpu", points=False)


# -- (d) the bound and the launch plan ----------------------------------------
def test_bound_ms_against_hand_computed_values():
    pairs = 3643 * 44632                       # one stream frame's exact sweep
    assert nn_kernel.candidate_ops("elementwise", False) == 9
    assert nn_kernel.candidate_ops("expanded", True) == 9
    assert nn_kernel.candidate_ops("sentinel", False) == 9
    assert nn_kernel.candidate_ops("sentinel", True) == 10
    assert nn_kernel.bound_ms(pairs, "elementwise", False) == pytest.approx(
        9 * 162594376 / 33.5e12 * 1e3, rel=1e-12)
    assert nn_kernel.bound_ms(pairs, "elementwise", False) == pytest.approx(
        0.04368, abs=1e-5)
    assert nn_kernel.bound_ms(16384 * 262144, "elementwise",
                              False) == pytest.approx(1.15387, abs=1e-5)
    assert nn_kernel.bound_ms(32 * 1024 * 4096, "sentinel",
                              True) == pytest.approx(0.040065, abs=1e-6)
    assert nn_kernel.bound_ms(0, "expanded", False) == 0.0
    with pytest.raises(ValueError):
        nn_kernel.bound_ms(1, "vpu2", False)
    # bytes: src 12, dst 12 + 1 mask, idx 4 + dist 4 per point
    assert nn_kernel.io_ms(1, 16384, 262144, False) == pytest.approx(
        (16384 * 20 + 262144 * 13) / 3.35e12 * 1e3, rel=1e-12)
    assert nn_kernel.io_ms(2, 10, 20, True, src_mask=True) == pytest.approx(
        2 * (10 * 12 + 20 * 13 + 10 + 10 * 12 + 10 * 4) / 3.35e12 * 1e3,
        rel=1e-12)
    # the bytes are under a tenth of the operations at every shape in use
    for b, n, m in ((1, 16384, 262144), (256, 1024, 4096), (2048, 512, 512)):
        assert nn_kernel.io_ms(b, n, m, True) < 0.1 * nn_kernel.bound_ms(
            b * n * m, "elementwise", True)


@pytest.mark.parametrize("shape,form,points,want", [
    ((1, 16384, 262144), "elementwise", False, 64),        # the odometry
    ((1, 300, 9000), "sentinel", False, 18),               # one slice a chunk
    ((1, 16384, 262144), "elementwise", True, 1),          # points: no split
    ((1, 16384, 262144), "expanded", False, 1),            # d2 can be < 0
    ((7, 4096, 4096), "elementwise", False, 1),            # a short sweep
    ((1, 128, 8193), "elementwise", False, 17),            # just long enough
    ((1, 128, 8192), "elementwise", False, 1),
    ((8, 8448, 262144), "elementwise", False, 1),          # 528 blocks: full
    ((8, 8320, 262144), "sentinel", False, 64),            # 520 blocks: split
])
def test_launch_plan(shape, form, points, want):
    assert nn_kernel.launch_plan(*shape, form, points, 132) == want
    assert 1 <= want <= -(-shape[2] // nn_kernel.CHUNK)
