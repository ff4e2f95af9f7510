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
    are unchanged, and the odometry's ICP, the matcher's ICP and every
    matcher caller of the index output (hypothesis scores, the rollback
    test, the match statistics, the identity preference) return the same
    bits with it;
(d) the bound, the launch plan and the wrapper's checks of a launch
    override against hand-computed values;
(e) the split over a thread-block cluster, for either output: per-rank
    nearest neighbours merged by the lexicographic minimum of
    (d2, order(j)) equal the one-pass sweep for every form and cluster size.

Every comparison is exact (bit for bit) unless it says otherwise.
"""

import numpy as np
import pytest
import torch

import icpflow_tpu_torch as T
from icpflow_tpu_torch.match import matcher as tmatcher
from icpflow_tpu_torch.ops import ego as tego
from icpflow_tpu_torch.ops import hist as thist
from icpflow_tpu_torch.ops import icp as ticp
from icpflow_tpu_torch.ops import knn as tknn
from icpflow_tpu_torch.ops.cuda import nn_kernel
from icpflow_tpu_torch.ops.segments import SegmentBatch

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


@pytest.mark.parametrize("variant,m", [("auto", 300), ("auto", 2100),
                                       ("vpu2", 300)])
def test_src_mask_on_the_points_sweep(variant, m, monkeypatch):
    """``masked_nn_points(..., src_mask=)`` in the expanded, elementwise and
    sentinel form: wanted rows as without a mask, the others (0,0,0) and
    1e15."""
    monkeypatch.setenv("ICPFLOW_NN_VARIANT", variant)
    src, dst, rng = _cloud(24, m=m)
    mask = _mask("holed", rng, *dst.shape[:2])
    wanted = rng.random(src.shape[:2]) < 0.6
    wanted[1, 40:] = False
    t = [torch.as_tensor(a) for a in (src, dst, mask)]
    base_p, base_d = tknn.masked_nn_points(*t)
    none_p, none_d = tknn.masked_nn_points(*t, src_mask=None)
    assert torch.equal(none_p, base_p) and torch.equal(none_d, base_d)
    sm = torch.as_tensor(wanted)
    pts, dist = tknn.masked_nn_points(*t, src_mask=sm)
    assert torch.equal(pts[sm], base_p[sm]) and torch.equal(dist[sm],
                                                            base_d[sm])
    assert (dist[~sm] == 1e15).all() and (pts[~sm] == 0).all()
    assert (base_d[~sm] < 1e15).all()           # they had a neighbour


def _icp_pairs(seed=0, p=256):
    """Four cluster pairs as the matcher hands them to ICP: (B,P,3) buffers
    whose valid points are a prefix, junk in the padding."""
    rng = np.random.default_rng(seed)
    specs = [(100, [0.0, 0.0, 0.0]), (80, [0.05, 0.0, 0.0]),
             (220, [0.06, 0.03, 0.0]), (60, [0.0, -0.04, 0.02])]
    src = rng.uniform(-40.0, 40.0, (len(specs), p, 3)).astype(np.float32)
    dst = rng.uniform(-40.0, 40.0, (len(specs), p, 3)).astype(np.float32)
    sm = np.zeros((len(specs), p), bool)
    dm = np.zeros((len(specs), p), bool)
    for b, (n, shift) in enumerate(specs):
        pts = rng.uniform(-1.0, 1.0, (n, 3)) * [1.0, 1.0, 0.5] + [3.0 * b, 0, 0]
        src[b, :n] = pts
        dst[b, :n] = pts + shift + rng.normal(scale=0.01, size=pts.shape)
        sm[b, :n] = dm[b, :n] = True
    return [torch.as_tensor(a) for a in (src, sm, dst, dm)]


@pytest.mark.parametrize("entry", ["icp_core", "apply_icp"])
@pytest.mark.parametrize("variant", ["mxu", "vpu", "vpu2"])
def test_matcher_icp_same_pose_with_and_without_src_mask(variant, entry,
                                                         monkeypatch):
    """``icp_core`` passes its src validity to the sweep. It reads the
    sweep's result only under that mask (inliers, Kabsch weights, rmse), so
    the pose is the same bits as from a sweep over all rows, in every form."""
    monkeypatch.setenv("ICPFLOW_NN_VARIANT", variant)
    src, sm, dst, dm = _icp_pairs()

    def run():
        if entry == "icp_core":
            return ticp.icp_core(src, sm, dst, dm, max_iters=12,
                                 coarse_iters=2)
        init = torch.eye(4).expand(len(src), 4, 4).clone()
        init[:, 0, 3] = 0.05
        return ticp.apply_icp(src, sm, dst, dm, init, max_iters=12)

    with_mask = run()
    seen = []
    real = tknn.masked_nn_points

    def no_src_mask(*a, src_mask=None, **kw):
        seen.append(src_mask is not None)
        return real(*a, **kw)

    monkeypatch.setattr(ticp._knn, "masked_nn_points", no_src_mask)
    without = run()
    assert seen and all(seen)                 # icp_core passed it
    assert torch.equal(with_mask, without)
    assert torch.isfinite(with_mask).all()
    if entry == "icp_core":                   # it did align the pairs
        assert abs(float(with_mask[2, 0, 3]) - 0.06) < 0.02


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


_INDEX_CFG = T.DEMO.replace(
    max_points=256, max_points_small=128, hist_grid_xy=32,
    hist_grid_xy_small=0, icp_max_iters=8, nn_tile=128,
    per_point_identity=True)


def _index_callers():
    """name -> (run(), the (B,N) masks its result may be read under): every
    matcher caller of the index-output sweep, on the pairs of
    ``_icp_pairs`` (junk in the padding)."""
    src, sm, dst, dm = _icp_pairs()
    init = torch.eye(4).expand(len(src), 4, 4).clone()
    init[:, 0, 3] = 0.05
    shifts = torch.tensor([[0.0, 0.0, 0.0], [0.05, 0.0, 0.0],
                           [0.0, -0.04, 0.02]])
    moved_k = src[None] + shifts[:, None, None, :]
    rows = torch.arange(len(src))
    segs = [SegmentBatch(xyz=x, mask=m, count=m.sum(1),
                         mean=torch.zeros(len(x), 3),
                         extent=torch.ones(len(x), 3),
                         pidx=torch.zeros(m.shape, dtype=torch.int32))
            for x, m in ((src, sm), (dst, dm))]
    return {
        "masked_nn_error": lambda: tknn.masked_nn_error(src, sm, dst, dm,
                                                        tile=128),
        "_score_hypotheses": lambda: thist._score_hypotheses(
            moved_k, sm, dst, dm, 128, cap=100),
        "apply_icp": lambda: ticp.apply_icp(src, sm, dst, dm, init,
                                            max_iters=8),
        "match_eval": lambda: torch.cat(tmatcher.match_eval(
            src, sm, dst, dm, init, _INDEX_CFG), dim=1),
        "_solve_bucket": lambda: tmatcher._solve_bucket(
            segs[0], segs[1], rows, rows, 1.0, _INDEX_CFG, 256),
    }


@pytest.mark.parametrize("entry", ["masked_nn_error", "_score_hypotheses",
                                   "apply_icp", "match_eval",
                                   "_solve_bucket"])
@pytest.mark.parametrize("variant", ["mxu", "vpu", "vpu2"])
def test_index_callers_same_bits_with_and_without_src_mask(variant, entry,
                                                           monkeypatch):
    """Every matcher caller of ``masked_nn`` passes the mask it reads the
    distances under as ``src_mask``. A masked-out row then reads 1e15
    instead of a finite distance, but only ever times a weight of 0 or
    under a False mask, so each result is the same bits as from sweeps over
    all rows, in every form."""
    monkeypatch.setenv("ICPFLOW_NN_VARIANT", variant)
    run = _index_callers()[entry]

    def flat(out):
        out = out if isinstance(out, tuple) else (out,)
        return [o.clone() for o in out]

    with_mask = flat(run())
    seen = []
    real = tknn.masked_nn

    def no_src_mask(*a, src_mask=None, **kw):
        seen.append(src_mask is not None)
        return real(*a, **kw)

    monkeypatch.setattr(tknn, "masked_nn", no_src_mask)
    without = flat(run())
    assert seen and all(seen)                 # every call passed one
    assert len(seen) == {"masked_nn_error": 1, "_score_hypotheses": 2,
                         "apply_icp": 2, "match_eval": 2}.get(entry,
                                                              len(seen))
    for a, b in zip(with_mask, without):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert a.dtype == torch.bool or torch.isfinite(a).all()
    if entry == "_solve_bucket":              # 4 identity / T sweeps at least
        assert len(seen) >= 4
        T_, stats, accept, id_pt = with_mask
        assert stats.shape == (4, 8) and id_pt.shape == (4, 256)
        assert (stats[:, 2] > 0).all()        # inliers were counted


def test_backward_sweeps_take_the_dst_side_mask(monkeypatch):
    """The backward sweeps (dst -> moved src) are read under the *dst*
    cluster's mask: that, not the src cluster's, is their ``src_mask``."""
    src, sm, dst, dm = _icp_pairs()
    dm = dm.clone()
    dm[:, 50:] = False                        # the two sides now differ
    got = []
    real = tknn.masked_nn

    def spy(s, d, d_mask, *, src_mask=None, **kw):
        got.append((d_mask.clone(), src_mask.clone()))
        return real(s, d, d_mask, src_mask=src_mask, **kw)

    monkeypatch.setattr(tknn, "masked_nn", spy)
    tmatcher.match_eval(src, sm, dst, dm, torch.eye(4).expand(4, 4, 4),
                        _INDEX_CFG)
    (f_dst, f_src), (b_dst, b_src) = got
    assert torch.equal(f_dst, dm) and torch.equal(f_src, sm)
    assert torch.equal(b_dst, sm) and torch.equal(b_src, dm)


def test_wrapper_refuses_cpu_tensors_and_bad_src_masks():
    src, dst, rng = _cloud(23, m=64)
    t = [torch.as_tensor(a) for a in (src, dst, np.ones(dst.shape[:2], bool))]
    with pytest.raises(ValueError, match="CUDA tensor"):
        nn_kernel.masked_nn_cuda(*t, form="elementwise", points=False,
                                 src_mask=torch.ones(src.shape[:2],
                                                     dtype=torch.bool))
    with pytest.raises(ValueError, match="form"):
        nn_kernel.masked_nn_cuda(*t, form="vpu", points=False)
    # a launch override that exists is let through to the tensor checks
    with pytest.raises(ValueError, match="CUDA tensor"):
        nn_kernel.masked_nn_cuda(*t, form="expanded", points=False,
                                 slices=4, split="cluster")


@pytest.mark.parametrize("form,points,slices,split,message", [
    ("expanded", False, 2, "atomic", "no atomic split"),   # d2 can be < 0
    ("expanded", False, None, "atomic", "no atomic split"),
    ("elementwise", True, 2, "atomic", "no atomic split"),  # a points output
    ("sentinel", True, None, "atomic", "no atomic split"),
    ("elementwise", False, 3, "cluster", "cluster of"),
    ("expanded", False, 16, "cluster", "cluster of"),
    ("sentinel", True, 5, "cluster", "cluster of"),
    ("elementwise", False, 2, "both", "split must be"),
    ("elementwise", False, 2, "none", "split must be"),
    ("sentinel", False, 0, None, "at least 1"),
    ("expanded", True, -1, "cluster", "at least 1"),
])
def test_wrapper_refuses_a_launch_it_cannot_make(form, points, slices, split,
                                                 message):
    """The overrides are checked before anything else, so the refusal shows
    on a machine without a card too."""
    src, dst, _ = _cloud(25, m=64)
    t = [torch.as_tensor(a) for a in (src, dst, np.ones(dst.shape[:2], bool))]
    with pytest.raises(ValueError, match=message):
        nn_kernel.check_plan(form, points, slices, split)
    with pytest.raises(ValueError, match=message):
        nn_kernel.masked_nn_cuda(*t, form=form, points=points, slices=slices,
                                 split=split)


@pytest.mark.parametrize("form,points,slices,split", [
    ("expanded", False, 8, "cluster"), ("sentinel", False, 4, "cluster"),
    ("elementwise", False, 1, "cluster"), ("elementwise", False, 64, "atomic"),
    ("sentinel", False, 3, "atomic"), ("sentinel", False, 1, "atomic"),
    ("expanded", True, 2, "cluster"), ("elementwise", False, None, None),
    ("elementwise", False, 7, None), ("expanded", False, None, "cluster")])
def test_wrapper_accepts_every_launch_it_can_make(form, points, slices, split):
    nn_kernel.check_plan(form, points, slices, split)


@pytest.mark.parametrize("form,points,m,want", [
    ("elementwise", False, 262144, "atomic"),      # the odometry's map
    ("sentinel", False, 8193, "atomic"),
    ("elementwise", False, 8192, "cluster"),       # the matcher's buckets
    ("sentinel", False, 4096, "cluster"),
    ("expanded", False, 512, "cluster"),
    ("expanded", False, 262144, "cluster"),        # d2 can be < 0: never keys
    ("elementwise", True, 262144, "cluster"),      # a points output
    ("sentinel", True, 4096, "cluster")])
def test_split_kind(form, points, m, want):
    assert nn_kernel.split_kind(form, points, m) == want


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
    ((1, 16384, 262144), "elementwise", True, 8),          # points: a cluster
    ((1, 16384, 262144), "expanded", False, 8),            # d2 can be < 0:
    ((7, 4096, 4096), "elementwise", False, 4),            # over a cluster
    ((1, 128, 8193), "elementwise", False, 17),            # just long enough
    ((1, 128, 8192), "elementwise", False, 8),             # a cluster's
    ((8, 8448, 262144), "elementwise", False, 1),          # 528 blocks: full
    ((8, 8320, 262144), "sentinel", False, 64),            # 520 blocks: split
    ((7, 1024, 4096), "elementwise", True, 8),             # the ICP sweep
    ((7, 1024, 4096), "sentinel", True, 8),
    ((66, 1024, 4096), "elementwise", True, 1),            # 528 blocks: full
    ((65, 1024, 4096), "expanded", True, 2),               # 520 blocks
    ((4, 512, 512), "expanded", True, 8),                  # 64 dst a rank
    ((3, 200, 300), "sentinel", True, 4),
    ((1, 128, 128), "elementwise", True, 2),
    ((1, 128, 127), "elementwise", True, 1),               # too short to cut
    # the matcher's index sweeps: 224 blocks -> 896, 112 -> 896, 32 -> 256,
    # 64 -> 512 (the 512-point buckets never fill the card: 64 dst a rank)
    ((7, 4096, 4096), "expanded", False, 4),
    ((7, 4096, 4096), "sentinel", False, 4),
    ((14, 1024, 4096), "expanded", False, 8),
    ((14, 1024, 4096), "elementwise", False, 8),
    ((14, 1024, 4096), "sentinel", False, 8),
    ((56, 256, 4096), "expanded", False, 8),
    ((56, 256, 4096), "elementwise", False, 8),
    ((56, 256, 4096), "sentinel", False, 8),
    ((8, 512, 512), "expanded", False, 8),
    ((8, 512, 512), "elementwise", False, 8),
    ((8, 512, 512), "sentinel", False, 8),
    ((32, 256, 512), "expanded", False, 8),
    ((32, 256, 512), "elementwise", False, 8),
    ((32, 256, 512), "sentinel", False, 8),
    ((33, 4096, 4096), "sentinel", False, 1),              # 1056 blocks: full
    ((16, 4096, 4096), "elementwise", False, 2),           # 512 blocks -> 1024
    ((2048, 512, 512), "expanded", False, 1),              # the nominal rows
    ((256, 1024, 4096), "sentinel", False, 1),
])
def test_launch_plan(shape, form, points, want):
    assert nn_kernel.launch_plan(*shape, form, points, 132) == want
    m = shape[2]
    if nn_kernel.split_kind(form, points, m) == "cluster":
        # a cluster of at most 8 ranks, each with 64 dst or more
        assert want in nn_kernel.CLUSTER_SIZES and want <= 8
        assert want == 1 or want * nn_kernel.CLUSTER_MIN_POINTS <= m
        span = nn_kernel.cluster_span(m, want)
        assert span % 8 == 0 and 8 <= span <= nn_kernel.CHUNK
        if want > 1:   # every rank has a chunk, and a chunk is at most 256
            assert span <= nn_kernel.CLUSTER_CHUNK
            assert -(-m // span) >= want
    else:
        assert 1 <= want <= -(-m // nn_kernel.CHUNK)


@pytest.mark.parametrize("m,slices,want", [
    (4096, 8, 256), (4096, 4, 256), (4096, 1, 512), (512, 8, 64),
    (512, 2, 256), (300, 4, 80), (1025, 8, 136), (9, 8, 8), (77, 1, 512)])
def test_cluster_span(m, slices, want):
    assert nn_kernel.cluster_span(m, slices) == want


# -- (e) the cluster split and its merge --------------------------------------
_TIES = ((2, 257, 513), (5, 261, 517))    # three equidistant dst, other chunks


def _cluster_inputs(m, seed):
    """Row 0: src 0 and src 1 with three nearest dst each at distance 1, in
    three chunks of any split (j mod 8 = 2, 1, 1 and 5, 5, 5). Row 1: only
    dst 256-511 valid (one rank's chunk). Row 2: no valid dst. Row 3: src
    ~360 m from the origin with two near-copies each in dst, one chunk
    apart, so that the expanded form's d2 is noise of either sign."""
    rng = np.random.default_rng(seed)
    n = 40
    src = rng.uniform(-1.0, 1.0, (4, n, 3))
    src[0, 0] = 0.0
    src[0, 1] = (50.0, 0.0, 0.0)
    dst = rng.uniform(5.0, 15.0, (4, m, 3)) * rng.choice([-1.0, 1.0],
                                                       (4, m, 3))
    for i, trio in enumerate(_TIES):
        dst[0, trio] = src[0, i] + np.eye(3)
    src[3] = rng.uniform(-2.0, 2.0, (n, 3)) + [300.0, -200.0, 10.0]
    for off in (8, 264):
        dst[3, off:off + n] = src[3] + rng.normal(scale=1e-4, size=(n, 3))
    mask = np.ones((4, m), bool)
    mask[1] = (np.arange(m) >= 256) & (np.arange(m) < 512)
    mask[2] = False
    return src.astype(np.float32), dst.astype(np.float32), mask


def _cluster_model(src, dst, mask, form, slices, span, points=True):
    """The cluster split in plain PyTorch. Rank z sweeps chunks z, z + S,
    ... of ``span`` dst points in index order from (1e30, 0), which leaves
    the minimum of (d2, order(j)) over its chunks; rank 0 merges the ranks
    by the same order: order(j) = j, or (j mod 8, j div 8) for the sentinel
    form's points output. d2 comes from the plain version's own arithmetic.
    Returns (pts, dist, j), or (idx, dist, j) for the index output."""
    s, d, mk = (torch.as_tensor(a) for a in (src, dst, mask))
    b, n, m = s.shape[0], s.shape[1], d.shape[1]
    sentinel = form == "sentinel"
    if sentinel:
        d = torch.where(mk[:, :, None], d, torch.full_like(d, 1e6))
    x = [s[:, :, None, k] for k in range(3)]
    y = [d[:, None, :, k] for k in range(3)]
    d2 = tknn._tile_d2(x, y, tknn._dot3(x, x), form)
    if not sentinel:
        d2 = torch.where(mk[:, None, :], d2, torch.full_like(d2, np.inf))
    j = torch.arange(m)
    order = (j % 8) * (m // 8 + 1) + j // 8 if sentinel and points else j
    big = torch.tensor(1e30)
    best = big.expand(b, n).clone()
    best_j = torch.zeros((b, n), dtype=torch.int64)
    for z in range(slices):
        cols = torch.cat([j[j0:j0 + span]
                          for j0 in range(z * span, m, slices * span)]
                         + [j[:0]])
        rd, rj = big.expand(b, n).clone(), torch.zeros_like(best_j)
        if len(cols):
            sub = d2[:, :, cols]
            low = sub.min(dim=2).values
            key = torch.where(sub == low[:, :, None], order[cols],
                              torch.full_like(cols, 8 * m + 8))
            pick = cols[key.argmin(dim=2)]
            found = low < big                    # strict: 1e30 is "none"
            rd = torch.where(found, low, rd)
            rj = torch.where(found, pick, rj)
        take = (rd < best) | ((rd == best) & (order[rj] < order[best_j]))
        best = torch.where(take, rd, best)
        best_j = torch.where(take, rj, best_j)
    found = best < big
    dist = torch.sqrt(torch.clamp(torch.where(found, best, big), min=0.0))
    if not points:       # rank 0 writes the index, clamped, 0 where none
        idx = torch.clamp(torch.where(found, best_j, 0), max=m - 1)
        return idx.to(torch.int32), dist, best_j
    pts = torch.gather(d, 1, best_j[:, :, None].expand(b, n, 3))
    pts = torch.where(found[:, :, None], pts, torch.zeros_like(pts))
    return pts, dist, best_j


@pytest.mark.parametrize("m", [520, 1025, 2049])
@pytest.mark.parametrize("slices", [1, 2, 4, 8])
@pytest.mark.parametrize("form", ["expanded", "elementwise", "sentinel"])
def test_cluster_model_equals_one_pass(form, slices, m):
    src, dst, mask = _cluster_inputs(m, 31)
    span = nn_kernel.cluster_span(m, slices)
    want_p, want_d = _plain(src, dst, mask, form=form, points=True)
    pts, dist, j = _cluster_model(src, dst, mask, form, slices, span)
    np.testing.assert_array_equal(dist.numpy().view(np.uint32),
                                  want_d.view(np.uint32))
    np.testing.assert_array_equal(pts.numpy(), want_p)
    # the ties took the candidate each rule names, from another rank
    carry = form == "sentinel"
    for i, trio in enumerate(_TIES):
        assert dist[0, i] == 1.0
        assert int(j[0, i]) == (min(trio, key=lambda t: (t % 8, t // 8))
                                if carry else min(trio))
        if slices > 1:
            assert len({(t // span) % slices for t in trio}) > 1
    assert ((j[1] >= 256) & (j[1] < 512)).all()      # the one valid chunk
    if carry:                                        # nothing valid
        assert (dist[2] > 1.7e6).all() and (pts[2] == 1e6).all()
    else:
        assert (dist[2] == 1e15).all() and (pts[2] == 0).all()
    if form == "expanded":      # negative d2 met the merge: sqrt(max(d2, 0))
        assert (dist[3] == 0).any()


@pytest.mark.parametrize("m", [520, 1025, 2049])
@pytest.mark.parametrize("slices", [1, 2, 4, 8])
@pytest.mark.parametrize("form", ["expanded", "elementwise", "sentinel"])
def test_cluster_model_of_the_index_output_equals_one_pass(form, slices, m):
    """The index output over a cluster: ragged M, a three-way tie across
    ranks (the lowest j in every form: the carry order is the points
    output's alone), a row whose other ranks hold only padding, a row with
    no valid dst, and negative expanded-form d2."""
    src, dst, mask = _cluster_inputs(m, 41)
    span = nn_kernel.cluster_span(m, slices)
    want_i, want_d = _plain(src, dst, mask, form=form, points=False)
    idx, dist, j = _cluster_model(src, dst, mask, form, slices, span,
                                  points=False)
    np.testing.assert_array_equal(dist.numpy().view(np.uint32),
                                  want_d.view(np.uint32))
    np.testing.assert_array_equal(idx.numpy(), want_i)
    assert idx.dtype == torch.int32
    for i, trio in enumerate(_TIES):
        assert dist[0, i] == 1.0 and int(idx[0, i]) == min(trio)
        if slices > 1:                           # the trio met in the merge
            assert len({(t // span) % slices for t in trio}) > 1
    assert ((idx[1] >= 256) & (idx[1] < 512)).all()  # the one valid chunk
    assert (idx[2] == 0).all()                       # nothing valid
    if form == "sentinel":
        assert (dist[2] > 1.7e6).all()
    else:
        assert (dist[2] == 1e15).all()
    if form == "expanded":      # negative d2 met the merge: sqrt(max(d2, 0))
        assert (dist[3] == 0).any()


@pytest.mark.parametrize("points", [False, True])
@pytest.mark.parametrize("form", ["expanded", "elementwise", "sentinel"])
def test_cluster_model_with_ranks_that_have_no_chunk(form, points):
    """Fewer chunks than ranks (M = 20 over 8 ranks: three chunks of 8), and
    ranks whose only chunk is padding: they arrive with (1e30, 0), which
    never beats a found candidate, and idx is clamped to m - 1."""
    src, dst, rng = _cloud(43, b=3, n=30, m=20)
    mask = np.ones((3, 20), bool)
    mask[1, :16] = False                 # only the last, ragged chunk valid
    mask[2] = False
    span = nn_kernel.cluster_span(20, 8)
    assert span == 8 and -(-20 // span) < 8
    want_o, want_d = _plain(src, dst, mask, form=form, points=points)
    out, dist, j = _cluster_model(src, dst, mask, form, 8, span,
                                  points=points)
    np.testing.assert_array_equal(dist.numpy().view(np.uint32),
                                  want_d.view(np.uint32))
    np.testing.assert_array_equal(out.numpy(), want_o)
    assert (j[1] >= 16).all() and (j[2] == 0).all()
