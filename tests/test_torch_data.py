"""The port's data plane against the JAX package's, on the CPU.

Loaders (native, numpy fallback, the JAX package's copy), the raw-sample
dicts of ``DatasetPCA`` and ``DatasetArgo``, and ``DatasetPCA``'s
preprocessing on the box fixture of ``tests/test_cli_pca.py``: ground masks
and pair labels must be EQUAL to the JAX package's (integer semantics: the
fixture has no point on a CZM sector boundary), estimated poses within
1e-4 m and 1e-3 deg (two fp32 ICPs whose sums are taken in another order).
The JAX side runs on XLA:CPU as its own tests run it; the port runs on
``device="cpu"`` (the plain versions of the kernels).

Roots are relative to a working directory of each side's own: the pose
cache path is derived from the data path by replacing every "test" in it,
and pytest's temporary directories are named after the test.
"""

import dataclasses
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import icpflow_tpu as J  # noqa: E402
from icpflow_tpu.data import native_loader as jnl  # noqa: E402
from icpflow_tpu.data.argo import DatasetArgo as JArgo  # noqa: E402
from icpflow_tpu.data.pca import DatasetPCA as JPCA  # noqa: E402

import icpflow_tpu_torch as T  # noqa: E402
from icpflow_tpu_torch import cli as tcli  # noqa: E402
from icpflow_tpu_torch.data import loading as tloading  # noqa: E402
from icpflow_tpu_torch.data import native_loader as tnl  # noqa: E402
from icpflow_tpu_torch.data.argo import DatasetArgo as TArgo  # noqa: E402
from icpflow_tpu_torch.data.pca import DatasetPCA as TPCA  # noqa: E402

from test_cli_pca import make_pca_npz  # noqa: E402

torch.set_num_threads(2)
POSE_ATOL_M = 1e-4
POSE_ATOL_DEG = 1e-3
NUM_FRAMES = 3

# the reduced buckets of tests/test_cli_pca.py, small ego buffers
JCFG = J.WAYMO.replace(
    num_frames=NUM_FRAMES, range_x=32.0, range_y=32.0, range_z=0.0,
    ground_slack=0.3, num_clusters=32, min_cluster_size=20, epsilon=0.4,
    speed=1.67, max_points_scene=4096, max_points=512, max_pairs=32,
    pairs_small=32, pairs_large=4, nn_tile=256, hist_grid_xy=64,
    ego_map_capacity=8192, ego_src_capacity=2048)
TCFG = T.config_from_dict(dataclasses.asdict(JCFG))


def _force_numpy(monkeypatch):
    """The port's loader as on a host without the native library."""
    monkeypatch.setattr(tnl, "_LIB", None)
    monkeypatch.setattr(tnl, "_TRIED", True)


@pytest.fixture(scope="module")
def npz_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("npz")
    rng = np.random.default_rng(0)
    paths, datas = [], []
    for i in range(5):
        data = {
            "points": rng.normal(size=(3000 + i, 3)).astype(np.float32),
            "labels": rng.integers(0, 100, size=(3000 + i,)).astype(np.int64),
            "mask": rng.random(3000 + i) > 0.5,
            "pose": np.eye(4),
            "idx": np.array([i], np.int32),
        }
        path = os.path.join(root, f"s{i}.npz")
        np.savez_compressed(path, **data)
        paths.append(path)
        datas.append(data)
    return paths, datas


def _same_dict(out, ref):
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == np.asarray(ref[k]).shape, k
        assert out[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(out[k], ref[k])


def test_both_packages_share_the_native_library():
    assert tnl._repo_root() == jnl._repo_root()
    assert tnl.decoder() == ("numpy" if jnl.get_lib() is None else "native")


def test_decoder_names_the_numpy_fallback(monkeypatch):
    _force_numpy(monkeypatch)
    assert tnl.decoder() == "numpy"


def test_load_npz_native_numpy_and_jax(npz_files, monkeypatch):
    paths, datas = npz_files
    for path, data in zip(paths, datas):
        native = tnl.load_npz(path)
        _same_dict(native, data)
        _same_dict(native, jnl.load_npz(path))
    _force_numpy(monkeypatch)
    for path, data in zip(paths, datas):
        _same_dict(tnl.load_npz(path), data)


@pytest.mark.parametrize("cap", [64, 4096])
def test_crop_pad_native_numpy_and_jax(cap, monkeypatch):
    pts = np.random.default_rng(1).uniform(-40, 40, (1500, 4)).astype(
        np.float32)
    native = tnl.crop_pad(pts, 32.0, 30.0, cap)
    ref = jnl.crop_pad(pts, 32.0, 30.0, cap)
    _force_numpy(monkeypatch)
    plain = tnl.crop_pad(pts, 32.0, 30.0, cap)
    keep = (np.abs(pts[:, 0]) < 32.0) & (np.abs(pts[:, 1]) < 30.0)
    assert native[2] == ref[2] and plain[2] == min(int(keep.sum()), cap)
    for got in (native, plain):
        n = min(got[2], cap)
        np.testing.assert_array_equal(got[0][:n], pts[keep][:n, :3])
        np.testing.assert_array_equal(got[1], np.arange(cap) < n)
        np.testing.assert_array_equal(got[0][:n], ref[0][:n])
        np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize("decoder", ["native", "numpy"])
def test_prefetch_pool_in_order(npz_files, decoder, monkeypatch):
    if decoder == "numpy":
        _force_numpy(monkeypatch)
    paths, datas = npz_files
    pool = tnl.PrefetchPool(paths, workers=3, depth=2)
    ref = jnl.PrefetchPool(paths, workers=3, depth=2)
    try:
        seen = 0
        for got, want, data in zip(pool, ref, datas):
            _same_dict(got, data)
            _same_dict(got, want)
            seen += 1
        assert seen == len(paths)
    finally:
        pool.close()
        ref.close()
    pool.close()                                   # closing twice is fine
    assert list(tnl.PrefetchPool([], workers=2, depth=2)) == []


def test_loading_helpers_equal():
    from icpflow_tpu.data import loading as jloading
    rng = np.random.default_rng(2)
    names = [f"seq_{i}_{j}.npz" for i in (10, 9, 100) for j in (2, 11)]
    assert sorted(names, key=tloading.natural_key) == sorted(
        names, key=jloading.natural_key)
    pts = rng.normal(size=(200, 4)).astype(np.float32)
    ti = rng.integers(0, 3, 200)
    inst = rng.integers(0, 2, 200)
    ego = rng.normal(size=(3, 4, 4)).astype(np.float32)
    tsfm = rng.normal(size=(2, 3, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tloading.ego_motion_compensation(pts, ti, ego),
        jloading.ego_motion_compensation(pts, ti, ego))
    np.testing.assert_array_equal(
        tloading.reconstruct_sequence(pts, ti, inst, tsfm, 3),
        jloading.reconstruct_sequence(pts, ti, inst, tsfm, 3))


# -- the two datasets ------------------------------------------------------
@pytest.fixture()
def roots(tmp_path, monkeypatch):
    """A working directory holding one data root a package, each with the
    same 3-frame fixture; paths relative, so no "test" in them."""
    monkeypatch.chdir(tmp_path)
    for side in ("jax_root", "torch_root"):
        os.mkdir(side)
        make_pca_npz(os.path.join(side, "seq_000.npz"), num_frames=NUM_FRAMES)
    return "jax_root", "torch_root"


@pytest.fixture()
def datasets(roots):
    jds = JPCA(JCFG, roots[0], "test")
    tds = TPCA(TCFG, roots[1], "test", device="cpu")
    assert len(jds) == len(tds) == 1
    return jds, tds


def _same_raw(tdata, jdata):
    assert set(tdata) == set(jdata)
    for k in jdata:
        if k == "data_path":
            continue
        assert tdata[k].dtype == jdata[k].dtype, k
        np.testing.assert_array_equal(tdata[k], jdata[k])


@pytest.mark.parametrize("decoder", ["native", "numpy"])
def test_pca_raw_from_dict_equal(datasets, decoder, monkeypatch):
    if decoder == "numpy":
        _force_numpy(monkeypatch)
    jds, tds = datasets
    _same_raw(tds.load_raw(tds.seq_paths[0]), jds.load_raw(jds.seq_paths[0]))


def test_pca_shipped_manifests_resolve_as_in_jax(tmp_path):
    """A root without the manifest's files falls through to the glob, from
    any working directory; with them, the manifest's order is used."""
    root = str(tmp_path) + "/"
    names = np.loadtxt(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "assets/configs/datasets/waymo/test_info.txt"), dtype=str)
    assert TPCA(TCFG, root, "test", device="cpu").seq_paths == []
    first = root + names[0]
    os.makedirs(os.path.dirname(first))
    make_pca_npz(first, num_frames=NUM_FRAMES)
    tds = TPCA(TCFG, root, "test", device="cpu")
    jds = JPCA(JCFG, root, "test")
    assert tds.seq_paths == jds.seq_paths
    assert len(tds) == len(names) and tds.seq_paths[0] == first


def _argo_dict(seed=0, n=1500):
    rng = np.random.default_rng(seed)
    car = np.array([6.0, 2.0, 0.8]) + rng.uniform(-0.5, 0.5, (500, 3)) * [
        4.2, 1.8, 1.5]
    wall = np.array([0.0, 9.0, 1.2]) + rng.uniform(-0.5, 0.5, (n - 500, 3)) \
        * [20.0, 0.3, 2.0]
    pc1 = np.concatenate([car, wall]).astype(np.float32)
    flow = np.zeros_like(pc1)
    flow[:500] = [0.9, 0.1, 0.0]
    pc2 = (pc1 + flow + rng.normal(scale=0.01, size=pc1.shape)).astype(
        np.float32)
    cls = np.full(n, -1, np.int64)
    cls[:500] = 18                                # REGULAR_VEHICLE
    cls[500:520] = 20                             # SIGN: background
    valid1 = rng.random(n) < 0.95
    valid2 = rng.random(n) < 0.95
    return dict(pc1=pc1, pc2=pc2, pc1_flows_valid_idx=np.flatnonzero(valid1),
                pc2_flows_valid_idx=np.flatnonzero(valid2),
                gt_flow_0_1=flow.astype(np.float32), pc1_classes=cls,
                pc2_classes=cls)


def test_argo_raw_and_pairs_equal(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    os.mkdir("argo")
    np.savez_compressed("argo/a.npz", **_argo_dict())
    jcfg = JCFG.replace(dataset="argo", num_frames=2, range_z=-10000.0,
                        ground_slack=0.0)
    jds = JArgo(jcfg, "argo", "val")
    tds = TArgo(T.config_from_dict(dataclasses.asdict(jcfg)), "argo", "val",
                device="cpu")
    assert tds.seq_paths == jds.seq_paths == ["argo/a.npz"]
    assert tds.background_idxes == jds.background_idxes
    _same_raw(tds._raw_from_dict(_argo_dict(), "p"),
              jds._raw_from_dict(_argo_dict(), "p"))
    jdata, jpairs = jds[0]
    tdata, tpairs = tds[0]
    _same_raw(tdata, jdata)
    assert len(tpairs) == len(jpairs) == 1
    for k in jpairs[0]:
        assert tpairs[0][k].dtype == jpairs[0][k].dtype, k
        np.testing.assert_array_equal(tpairs[0][k], jpairs[0][k])
    assert len(np.unique(tpairs[0]["label_src"])) >= 2   # car and wall
    # the prefetched iteration yields the same sample
    (k, idata, ipairs), = list(tds.iter_samples())
    assert k == 0
    np.testing.assert_array_equal(ipairs[0]["label_src"],
                                  tpairs[0]["label_src"])


def test_pca_ground_masks_and_pair_labels_equal(datasets):
    jds, tds = datasets
    jdata = jds.load_raw(jds.seq_paths[0])
    tdata = tds.load_raw(tds.seq_paths[0])
    j_ng = jds.ground_removal(jdata)
    t_ng = tds.ground_removal(tdata)
    assert t_ng.dtype == j_ng.dtype == bool
    np.testing.assert_array_equal(t_ng, j_ng)
    # the masks do real work: the ground slab goes, the wall and car stay
    assert 0.3 < t_ng.mean() < 0.8
    j_pairs = jds.cluster_pairs(jdata, jds.ego_poses(jdata), j_ng)
    t_pairs = tds.cluster_pairs(tdata, tds.ego_poses(tdata), t_ng)
    assert len(t_pairs) == len(j_pairs) == NUM_FRAMES - 1
    for tp, jp in zip(t_pairs, j_pairs):
        assert set(tp) == set(jp)
        for k in jp:
            assert tp[k].dtype == jp[k].dtype, k
            np.testing.assert_array_equal(tp[k], jp[k])
        assert tp["label_src"].max() >= 1            # wall and car labelled


def test_pca_getitem_and_iter_samples_agree(datasets):
    _, tds = datasets
    data, pairs = tds[0]
    tds.timings = {}
    (k, idata, ipairs), = list(tds.iter_samples())
    assert k == 0 and set(tds.timings) == {"load", "ground", "ego", "cluster"}
    assert all(v >= 0 for v in tds.timings.values())
    np.testing.assert_array_equal(idata["ego_poses"], data["ego_motion_gt"])
    for a, b in zip(ipairs, pairs):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def _pose_gap(a, b):
    r = a[:3, :3].T.astype(np.float64) @ b[:3, :3]
    ang = np.degrees(np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1)))
    return float(np.linalg.norm(a[:3, 3] - b[:3, 3])), float(ang)


def test_pca_ego_poses_match_jax_and_cache(datasets, monkeypatch):
    jds, tds = datasets
    jds.cfg = JCFG.replace(use_kiss_icp=True)
    tds.cfg = TCFG.replace(use_kiss_icp=True)
    jdata = jds.load_raw(jds.seq_paths[0])
    tdata = tds.load_raw(tds.seq_paths[0])
    j_poses = jds.ego_poses(jdata)
    t_poses = tds.ego_poses(tdata)
    assert t_poses.shape == j_poses.shape == (NUM_FRAMES, 4, 4)
    assert t_poses.dtype == j_poses.dtype
    for tp, jp, gt in zip(t_poses, j_poses, tdata["ego_motion_gt"]):
        d_m, d_deg = _pose_gap(tp, jp)
        assert d_m <= POSE_ATOL_M and d_deg <= POSE_ATOL_DEG, (d_m, d_deg)
        assert _pose_gap(tp, gt)[0] < 0.05          # and it is an odometry
    # each side wrote its own cache beside its own data; the port reads its
    # cache back instead of registering again
    for root in ("jax_root", "torch_root"):
        assert os.path.isfile(os.path.join(root, "seq_000.npz_pose.npz"))
    from icpflow_tpu_torch.ops import ego

    def no_odometry(*a, **k):
        raise AssertionError("the pose cache was not read")

    monkeypatch.setattr(ego.EgoOdometry, "register_frame", no_odometry)
    np.testing.assert_array_equal(tds.ego_poses(tdata), t_poses)


# -- use_hdbscan, what is not ported yet, and nothing off the card silently --
def test_hdbscan_raises_naming_its_roadmap_item(datasets):
    """``use_hdbscan=True`` (a stub that raised until the clusterer was
    ported): ``DatasetPCA.cluster_pairs`` gives the JAX package's labels,
    and ``SceneFlowEngine.cluster_joint`` takes the same clusterer."""
    jds, tds = datasets
    jds.cfg = JCFG.replace(use_hdbscan=True, hdbscan_rep_cap=8192)
    tds.cfg = T.config_from_dict(dataclasses.asdict(jds.cfg))
    jdata = jds.load_raw(jds.seq_paths[0])
    tdata = tds.load_raw(tds.seq_paths[0])
    ng = jds.ground_removal(jdata)
    j_pairs = jds.cluster_pairs(jdata, jdata["ego_motion_gt"], ng)
    t_pairs = tds.cluster_pairs(tdata, tdata["ego_motion_gt"], ng)
    assert len(t_pairs) == len(j_pairs) == NUM_FRAMES - 1
    for tp, jp in zip(t_pairs, j_pairs):
        for k in jp:
            assert tp[k].dtype == jp[k].dtype, k
            np.testing.assert_array_equal(tp[k], jp[k])
        assert tp["label_src"].max() >= 1            # wall and car labelled
    eng = T.SceneFlowEngine(tds.cfg, device="cpu")
    p = np.concatenate([tp["point_dst"], tp["point_src"]])[:4096]
    lab_dst, lab_src = eng.cluster_joint(p[:2048], np.ones(2048, bool),
                                         p[2048:], np.ones(len(p) - 2048,
                                                           bool))
    assert eng.cluster_info["path"] == "dedup"
    assert lab_dst.dtype == lab_src.dtype == torch.int32


@pytest.mark.parametrize("flags, item", [
    pytest.param(["--dp", "2"], "Queue 1 item 4",
                 id="flags1-Queue 1 item 4"),
    pytest.param(["--cp", "2"], "Queue 1 item 4",
                 id="flags2-Queue 1 item 4"),
    pytest.param(["--multihost"], "Queue 1 item 4",
                 id="flags3-Queue 1 item 4"),
])
def test_cli_stubs_raise_naming_their_roadmap_item(flags, item, roots):
    """What the port still lacks raises and names its ROADMAP item
    (``--if_hdbscan`` runs: ``test_torch_cli.py``)."""
    args = tcli.build_parser().parse_args(
        ["--dataset", "waymo", "--root", roots[1], "--device", "cpu"] + flags)
    with pytest.raises(NotImplementedError, match=item):
        tcli.run(args)


@pytest.mark.parametrize("make", [
    lambda: TPCA(TCFG, "torch_root", "test"),
    lambda: TArgo(TCFG, "torch_root", "val"),
])
def test_datasets_default_to_the_gpu_and_raise_without_one(make):
    with pytest.raises(RuntimeError, match="cuda"):
        make()
