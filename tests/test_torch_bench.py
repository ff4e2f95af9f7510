"""The port's benchmark (``icpflow_tpu_torch/bench.py``) against the JAX
package's ``bench.py``, on the CPU.

``device_metrics`` and ``heldout_eval`` get the same numpy inputs on both
sides: the held-out protocol at the reduced buckets of
``tests/test_torch_cli.py`` over the 3-frame box fixture of
``tests/test_cli_pca.py`` (both packages' ``make_sample`` replaced by it),
one waymo-like and one nuScenes-cadence protocol; every per-gap EPE agrees
within 0.005 m, the band of end-to-end flow parity between two fp32 ICPs.
The port's line carries every field of ``bench.py``'s line or its rename;
a section that raises fails the run; a section the budget skips is named;
the module imports nothing of JAX.
"""

import ast
import importlib.util
import json
import pathlib

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import icpflow_tpu.config as jconfig  # noqa: E402
import icpflow_tpu.data.synthetic as jsyn  # noqa: E402
import icpflow_tpu_torch.config as tconfig  # noqa: E402
import icpflow_tpu_torch.data.synthetic as tsyn  # noqa: E402
from icpflow_tpu_torch import bench as tbench  # noqa: E402

from test_cli_pca import make_pca_npz  # noqa: E402

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
EPE_BAND = 0.005
RENAMES = {"kern_nn_vpu_ms": "kern_nn_elementwise_ms",
           "kern_nn_mxu_ms": "kern_nn_expanded_ms",
           "pallas_xla_max_err": "kernel_plain_max_err",
           "compile_s": "first_call_s"}
# tests/test_torch_cli.py: _argv's fields and _run's reduced buckets
SMALL = dict(dataset="waymo", range_x=32.0, range_y=32.0, range_z=0.0,
             ground_slack=0.3, num_clusters=32, min_cluster_size=20,
             epsilon=0.4, speed=1.67, max_points_scene=4096, max_points=512,
             max_pairs=32, pairs_small=32, pairs_large=4, nn_tile=256,
             hist_grid_xy=64, ego_map_capacity=8192, ego_src_capacity=2048,
             hdbscan_rep_cap=8192)


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jbench():
    return _jax_bench()


def _jax_line_keys():
    """The keys of the ``line`` dict literal in ``bench.py``'s ``main``."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and [t.id for t in node.targets
                     if isinstance(t, ast.Name)] == ["line"]:
            return [k.value for k in node.value.keys]
    raise AssertionError("bench.py has no line = {...}")


def _metric_inputs(seed, n=4096):
    rng = np.random.default_rng(seed)
    gt = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    gt[rng.random(n) < 0.5] = 0.0                      # static points
    flow = (gt + rng.normal(scale=0.04, size=(n, 3))).astype(np.float32)
    valid = rng.random(n) < 0.9
    dyn = rng.random(n) < 0.3
    return flow, gt, valid, dyn


@pytest.mark.parametrize("with_dyn", [False, True], ids=["norm", "dyn"])
@pytest.mark.parametrize("seed", [0, 1])
def test_device_metrics_matches_jax(jbench, seed, with_dyn):
    import jax.numpy as jnp
    flow, gt, valid, dyn = _metric_inputs(seed)
    ref = np.asarray(jbench.device_metrics(
        jnp.asarray(flow), jnp.asarray(gt), jnp.asarray(valid),
        dyn=jnp.asarray(dyn) if with_dyn else None))
    got = tbench.device_metrics(
        torch.as_tensor(flow), torch.as_tensor(gt), torch.as_tensor(valid),
        dyn=torch.as_tensor(dyn) if with_dyn else None).numpy()
    assert got.shape == (4,)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_device_metrics_empty_sets():
    """No valid point, or no dynamic one: the means divide by 1, as JAX's."""
    flow, gt, valid, dyn = _metric_inputs(2, n=64)
    m = tbench.device_metrics(torch.as_tensor(flow), torch.as_tensor(gt),
                              torch.zeros(64, dtype=torch.bool))
    assert m.tolist() == [0.0, 0.0, 0.0, 0.0]
    m = tbench.device_metrics(torch.as_tensor(flow), torch.as_tensor(gt),
                              torch.as_tensor(valid),
                              dyn=torch.zeros(64, dtype=torch.bool))
    assert float(m[1]) == 0.0 and float(m[3]) == pytest.approx(float(m[0]))


def test_heldout_eval_matches_jax(jbench, monkeypatch):
    """Both ``heldout_eval`` over the same two 3-frame scenes (seed 0
    waymo-like, seed 1 at the nuScenes speed 0.833333): the same records,
    every per-gap EPE within 0.005 m of JAX's."""
    monkeypatch.setattr(jsyn, "make_sample", make_pca_npz)
    monkeypatch.setattr(tsyn, "make_sample", make_pca_npz)

    def protocols(base):
        return [("waymo_like", base.replace(num_frames=3), (0,)),
                ("nuscene_like", base.replace(num_frames=3, speed=0.833333),
                 (1,))]

    jcfg = jconfig.WAYMO.replace(**SMALL)
    tcfg = tconfig.WAYMO.replace(**SMALL)
    ref = jbench.heldout_eval(jcfg, protocols=protocols(jcfg))
    got = tbench.heldout_eval(tcfg, protocols=protocols(tcfg), device="cpu")
    assert sorted(got["gaps"]) == sorted(ref["gaps"]) == [
        "nuscene_like_1", "nuscene_like_2", "waymo_like_1", "waymo_like_2"]
    assert len(got["scenes"]) == len(ref["scenes"]) == 4
    for g, r in zip(got["scenes"], ref["scenes"]):
        assert (g["protocol"], g["seed"], g["gap"]) == (
            r["protocol"], r["seed"], r["gap"])
        for key in ("epe3d", "epe3d_dynamic", "epe3d_static"):
            assert abs(g[key] - r[key]) <= EPE_BAND, (g, r)
        assert abs(g["acc3ds"] - r["acc3ds"]) <= 0.01, (g, r)
    for name, r in ref["gaps"].items():
        for key in ("epe3d", "epe3d_dynamic"):
            assert abs(got["gaps"][name][key] - r[key]) <= EPE_BAND
    # at gap 1 the mover is recovered
    for s in got["scenes"]:
        if s["gap"] == 1:
            assert s["epe3d"] < 0.05 and s["epe3d_dynamic"] < 0.1, s


def test_make_cfg_matches_jax(jbench):
    """The bench configuration is the JAX bench's, field by field."""
    j, t = jbench.make_cfg(), tbench.make_cfg()
    for name in tbench.BENCH_OVERRIDES:
        assert getattr(t, name) == getattr(j, name), name
    assert t.hist_bin == j.hist_bin


@pytest.fixture(scope="module")
def skipped_line():
    """The port's line at the small configuration on the CPU with no
    budget: the headline runs (one warm call), every other section is
    skipped."""
    mp = pytest.MonkeyPatch()
    mp.setenv("BENCH_BUDGET_S", "0")
    mp.setattr(tbench, "REPS", 1)
    try:
        return tbench.main(["--device", "cpu", "--small"])
    finally:
        mp.undo()


def test_line_has_every_bench_field(skipped_line):
    keys = _jax_line_keys()
    assert len(keys) > 40 and "value" in keys
    for key in keys:
        assert RENAMES.get(key, key) in skipped_line, key
    for new in ("scene", "power_limit_w", "nn_launches", "nn_plain_calls",
                "heldout", "ego_est", "scene_epe3d_dynamic_gap4x"):
        assert new in skipped_line, new


def test_budget_skip_names_each_section(skipped_line, capsys):
    line = skipped_line
    assert line["skipped"] == [
        "demo_fixture", "heldout_synth", "stage_cluster", "stage_small",
        "stage_match", "nn_kernel", "kern_micro", "hdbscan_e2e", "ego_est"]
    for key in tbench.FIXTURE_FIELDS:
        assert line[key] == -1, key
    for key in ("stage_cluster_ms", "stage_match_ms", "kern_icp_large_ms",
                "kern_nn_elementwise_ms", "nn_util_vs_bound",
                "hdbscan_epe3d", "ego_est_dyn_epe_gap1",
                "heldout_dyn_epe_gap1"):
        assert line[key] == -1, key
    # the headline ran, on the CPU's plain NN
    assert line["value"] > 0 and line["first_call_s"] > 0
    # the rates are rounded to 3 decimals, the value to 4
    assert line["pairs_per_sec_min"] - 1e-3 <= line["value"] \
        <= line["pairs_per_sec_max"] + 1e-3
    assert 0 <= line["epe3d"] < 1 and line["n_pairs_matched"] >= 0
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["nn_launches"] == 0 and line["nn_plain_calls"] > 0


def test_raising_section_fails_the_run(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("section failed")

    monkeypatch.setattr(tbench, "heldout_eval", boom)
    monkeypatch.setattr(tbench, "REPS", 1)
    with pytest.raises(RuntimeError, match="section failed"):
        tbench.run("cpu", small=True)


def test_sections_budget_and_errors():
    secs = tbench.Sections(budget_s=1e9)
    assert secs.run("a", 1.0, lambda: 7) == 7
    with pytest.raises(ZeroDivisionError):
        secs.run("b", 1.0, lambda: 1 / 0)
    assert secs.skipped == []
    secs = tbench.Sections(budget_s=0.0)
    assert secs.run("c", 1.0, lambda: 7, default=-1) == -1
    assert secs.skipped == ["c"]


def test_nn_section_on_the_cpu():
    """The plain version on either side: error 0; the bound is the H100's
    FP32 operations on the valid pairs."""
    rng = np.random.default_rng(0)
    ms, err, bound, by = tbench.nn_section(rng, torch.device("cpu"),
                                           (2, 64, 96))
    assert err == 0.0 and set(ms) == {"elementwise", "expanded"}
    assert all(t > 0 for t in ms.values())
    assert by == "operations" and 0 < bound < 1e-3


def test_heldout_flag_prints_only_the_protocol(monkeypatch, capsys):
    """``--heldout``: the held-out records alone, one line, with the wall
    seconds and the device."""
    calls = []

    def heldout(cfg, protocols=None, device=None, stride=1):
        calls.append((cfg.max_points_scene, protocols, str(device), stride))
        return {"gaps": {}, "scenes": []}

    monkeypatch.setattr(tbench, "heldout_eval", heldout)
    line = tbench.main(["--heldout", "--device", "cpu", "--small"])
    assert calls == [(4096, None, "cpu", tbench.SMALL_STRIDE)]
    assert sorted(line) == ["device", "gaps", "power_limit_w", "scenes",
                            "wall_s"]
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="is_available"):
        tbench.main(["--heldout"])


def test_no_jax_import():
    tree = ast.parse(pathlib.Path(tbench.__file__).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    assert names
    for name in names:
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "icpflow_tpu", "bench"), name
