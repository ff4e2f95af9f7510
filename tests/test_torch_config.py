"""The PyTorch port's configuration, data and import boundary.

The port carries the JAX package's whole state (``PipelineConfig``) across
field for field, makes the same synthetic scenes from the same seed, and
never imports JAX or the JAX package.
"""

import dataclasses
import io
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import icpflow_tpu.config as jcfg  # noqa: E402
from icpflow_tpu.data import synthetic as jsyn  # noqa: E402

import icpflow_tpu_torch as T  # noqa: E402
from icpflow_tpu_torch import config as tcfg  # noqa: E402
from icpflow_tpu_torch.data import synthetic as tsyn  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["waymo", "nuscene", "argo", "demo",
                                  "default"])
def test_presets_equal_field_for_field(name):
    j = jcfg.PRESETS.get(name, jcfg.PipelineConfig())
    t = tcfg.PRESETS.get(name, tcfg.PipelineConfig())
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.hist_bin == j.hist_bin
    assert t.translation_frame(3, 1.5) == j.translation_frame(3, 1.5)


def test_config_from_dict_round_trips():
    j = jcfg.DEMO.replace(max_points=4096, hist_yaws=(0.0, 0.2),
                          cluster_dedup_voxel=0.15)
    t = tcfg.config_from_dict(dataclasses.asdict(j))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tcfg.config_from_dict(dataclasses.asdict(t)) == t
    # JSON gives lists: they come back as (hashable) tuples
    d = dataclasses.asdict(t)
    d["hist_yaws"] = list(d["hist_yaws"])
    assert tcfg.config_from_dict(d) == t
    hash(tcfg.config_from_dict(d))
    with pytest.raises(ValueError, match="unknown"):
        tcfg.config_from_dict({"no_such_field": 1})


def test_make_sample_bit_equal_to_jax_package():
    bufs = []
    for mod in (jsyn, tsyn):
        b = io.BytesIO()
        mod.make_sample(b, num_frames=3, seed=11)
        b.seek(0)
        bufs.append(dict(np.load(b)))
    assert bufs[0].keys() == bufs[1].keys()
    for k in bufs[0]:
        assert bufs[0][k].dtype == bufs[1][k].dtype, k
        np.testing.assert_array_equal(bufs[0][k], bufs[1][k], err_msg=k)


def test_ego_aligned_pair_gt_flow_maps_movers_to_frame_zero():
    b = io.BytesIO()
    tsyn.make_sample(b, num_frames=3, seed=3)
    b.seek(0)
    sample = dict(np.load(b))
    src, dst, gt, dyn = tsyn.ego_aligned_pair(sample, 2)
    assert src.dtype == dst.dtype == gt.dtype == np.float32
    assert (src[:, 2] > -1.6).all() and dyn.any() and (~dyn).any()
    assert np.abs(gt[~dyn]).max() == 0.0
    # every mover point lands, under its GT flow, within a few cm of the
    # frame-0 cloud (sensor noise and resampling, not motion)
    moved = src[dyn] + gt[dyn]
    near = [np.min(np.linalg.norm(dst - p, axis=1)) for p in moved[::97]]
    assert np.median(near) < 0.1


def test_import_loads_no_jax():
    code = ("import sys, icpflow_tpu_torch, icpflow_tpu_torch.ops.cluster, "
            "icpflow_tpu_torch.ops.cuda.nn_kernel, icpflow_tpu_torch.metrics, "
            "icpflow_tpu_torch.data.synthetic; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith"
            "('jax.') or m == 'icpflow_tpu' or m.startswith('icpflow_tpu.')]; "
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_sources_never_import_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|icpflow_tpu)(\.|\s|$)")
    pkg = ROOT / "icpflow_tpu_torch"
    files = sorted(f for f in pkg.rglob("*.py")       # build/: generated
                   if f.relative_to(pkg).parts[0] != "build") \
        + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for i, line in enumerate(f.read_text().splitlines(), 1):
            assert not pat.match(line), f"{f.name}:{i}: {line}"


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """No card (or no checkout beside it): non-zero exit, no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal cannot be shown")
    for cwd, script in ((ROOT, "chip_smoke.py"), (tmp_path, "chip_smoke.py")):
        if cwd == tmp_path:
            (tmp_path / script).write_text((ROOT / script).read_text())
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_metrics_match_jax_package():
    from icpflow_tpu import metrics as jm
    from icpflow_tpu_torch import metrics as tm
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(500, 3)).astype(np.float32)
    gt = pred + rng.normal(scale=0.05, size=pred.shape).astype(np.float32)
    mask = rng.random(500) > 0.2
    assert tm.compute_epe(pred, gt, mask) == jm.compute_epe(pred, gt, mask)
    kw = dict(range_x=1.0, range_y=1.5, range_z=-0.5, ground_slack=0.3,
              eval_ground=False)
    np.testing.assert_array_equal(tm.crop_for_eval(pred, **kw),
                                  jm.crop_for_eval(pred, **kw))


def test_no_silent_fallbacks(monkeypatch):
    import torch
    from icpflow_tpu_torch.ops import knn
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    # hdbscan without the native library: the reference's DBSCAN fallback,
    # and it says so
    from icpflow_tpu_torch.ops import cluster, hdbscan
    monkeypatch.setattr(hdbscan, "get_lib", lambda: None)
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(np.concatenate([
        rng.normal(scale=0.1, size=(200, 3)),
        rng.normal(loc=3.0, scale=0.1, size=(200, 3))]).astype(np.float32))
    valid = torch.ones(400, dtype=torch.bool)
    info = {}
    cfg = T.DEMO.replace(use_hdbscan=True, min_cluster_size=10)
    lab = hdbscan.hdbscan(pts, valid, cfg, info=info)
    assert info["path"] == "dbscan_fallback"
    np.testing.assert_array_equal(lab, cluster.dbscan(
        pts, valid, eps=cfg.epsilon, min_points=10,
        num_clusters=cfg.num_clusters, cell_cap=cfg.cluster_cell_cap,
        max_iters=cfg.cluster_max_iters, eps_scale_per_m=0.012,
        eps_max=cfg.eps_max).numpy())
    assert lab.max() == 1
    monkeypatch.undo()
    # the kernel wrapper takes CUDA tensors only
    x = torch.zeros((1, 4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        nn_kernel.masked_nn_cuda(x, x, torch.ones((1, 4), dtype=torch.bool),
                                 form="expanded", points=False)
    # vpu2 runs the sentinel form where the reference ran its Pallas kernels
    # (non-exact, 128 <= m <= 8192) and the expanded form elsewhere; the
    # exact sweep stays elementwise; an unknown value still raises
    monkeypatch.setenv("ICPFLOW_NN_VARIANT", "vpu2")
    for m in (128, 8192):
        assert knn.sweep_form(m, False) == "sentinel"
    for m in (127, 8193):
        assert knn.sweep_form(m, False) == "expanded"
    assert knn.sweep_form(4096, True) == "elementwise"
    y = torch.ones((1, 128, 3))
    _, dist = knn.masked_nn(x, y, torch.zeros((1, 128), dtype=torch.bool))
    assert float(dist.min()) > 1e6           # the sentinel's distance
    pts, _ = knn.masked_nn_points(x, y,
                                  torch.zeros((1, 128), dtype=torch.bool))
    assert bool((pts == 1e6).all())
    monkeypatch.setenv("ICPFLOW_NN_VARIANT", "vpu3")
    with pytest.raises(ValueError, match="vpu3"):
        knn.masked_nn(x, y, torch.ones((1, 128), dtype=torch.bool))
    monkeypatch.delenv("ICPFLOW_NN_VARIANT")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown")
    with pytest.raises(RuntimeError, match="cuda"):
        T.SceneFlowEngine(T.DEMO, device="cuda")


def _entry_points():
    from icpflow_tpu_torch.ops import ego, ground
    cfg = T.DEMO.replace(ego_map_capacity=64)
    state = [np.zeros(ground.NUM_RINGS_OF_INTEREST, np.float32)] * 2 \
        + [np.zeros((ground.NUM_RINGS_OF_INTEREST, 3), np.float32)] * 2
    return {
        "SceneFlowEngine": (T.SceneFlowEngine, (cfg,)),
        "StreamingEngine": (T.StreamingEngine, (cfg,)),
        "EgoOdometry": (ego.EgoOdometry, (cfg,)),
        "EgoOdometry.from_arrays": (
            ego.EgoOdometry.from_arrays,
            (cfg, [], np.zeros((64, 3), np.float32), np.zeros(64, bool), [])),
        "initial_ground_state": (ground.initial_ground_state, ()),
        "ground_state_from_arrays": (ground.ground_state_from_arrays, state),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_gpu_and_never_fall_back(name):
    """Every engine and state constructor runs on the card unless the
    caller asks for the CPU; without a usable GPU the default raises
    instead of moving the work to the host."""
    import inspect
    import torch
    fn, args = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"

    def where(made):                 # an engine, or a GroundState of tensors
        return torch.device(made[0].device if isinstance(made, tuple)
                            else made.device).type

    assert where(fn(*args, device="cpu")) == "cpu"   # the CPU only when asked
    if torch.cuda.is_available():
        assert where(fn(*args)) == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        fn(*args)
