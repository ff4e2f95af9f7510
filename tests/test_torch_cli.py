"""The port's offline entry points against the JAX package's, on the CPU.

``icpflow_tpu.cli.run`` and ``icpflow_tpu_torch.cli.run`` on the 2-frame
and the 3-frame box fixture of ``tests/test_cli_pca.py`` at its reduced
buckets (one configuration, so the JAX programs compile once), and both
``demo.main`` on one pair of a ``make_sample`` scene written in the
``demo.npz`` schema. Every meter and the printed demo EPE agree within
0.005 m, the documented band of end-to-end flow parity between two fp32
ICPs. The port runs with ``--device cpu`` (the plain versions of the
kernels).

Each side runs in a working directory of its own with a relative root:
``cli.run`` keeps its resume state in the working directory, and the save
path is derived from the data path by replacing every "test" in it, which
pytest's temporary directories contain.
"""

import dataclasses
import glob
import io
import json
import os
import re

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from icpflow_tpu import cli as jcli  # noqa: E402
from icpflow_tpu import demo as jdemo  # noqa: E402

from icpflow_tpu_torch import cli as tcli  # noqa: E402
from icpflow_tpu_torch import demo as tdemo  # noqa: E402
from icpflow_tpu_torch.data.synthetic import (ego_aligned_pair,  # noqa: E402
                                              make_sample)

from test_cli_pca import make_pca_npz  # noqa: E402

torch.set_num_threads(2)
EPE_BAND = 0.005
CONFIG_FROM_ARGS = {jcli: jcli.config_from_args, tcli: tcli.config_from_args}


def _argv(root, num_frames, *extra):
    return ["--dataset", "waymo", "--split", "test", "--root", root,
            "--num_frames", str(num_frames), "--range_x", "32", "--range_y",
            "32", "--range_z", "0.0", "--ground_slack", "0.3",
            "--num_clusters", "32", "--min_cluster_size", "20", "--epsilon",
            "0.4", "--speed", "1.67", "--max_points", "1024", *extra]


def _run(cli, argv, monkeypatch):
    """``cli.run`` at the reduced buckets of tests/test_cli_pca.py, with
    small odometry buffers and an hdbscan representative bucket that holds
    the joint cloud (the JAX package's exact graph sweeps all of it)."""
    args = cli.build_parser().parse_args(argv)
    cfg = CONFIG_FROM_ARGS[cli](args).replace(
        max_points_scene=4096, max_points=512, max_pairs=32, pairs_small=32,
        pairs_large=4, nn_tile=256, hist_grid_xy=64, ego_map_capacity=8192,
        ego_src_capacity=2048, hdbscan_rep_cap=8192)
    monkeypatch.setattr(cli, "config_from_args", lambda a: cfg)
    return cli.run(args)


def _side(tmp_path, monkeypatch, name, num_frames, n_samples=1):
    """Enter a fresh working directory ``name`` with the fixture under the
    relative root ``data``."""
    cwd = tmp_path / name
    (cwd / "data").mkdir(parents=True)
    monkeypatch.chdir(cwd)
    for i in range(n_samples):
        make_pca_npz(os.path.join("data", f"seq_{i:03d}.npz"),
                     num_frames=num_frames, seed=i)
    return cwd


@pytest.mark.parametrize("num_frames, flags", [
    pytest.param(2, (), id="2"), pytest.param(3, (), id="3"),
    pytest.param(2, ("--if_hdbscan",), id="2-if_hdbscan"),
])
def test_cli_run_matches_jax(num_frames, flags, tmp_path, monkeypatch,
                             capsys):
    _side(tmp_path, monkeypatch, "jax", num_frames)
    j_epes = _run(jcli, _argv("data", num_frames, *flags), monkeypatch)
    j_out = capsys.readouterr().out
    _side(tmp_path, monkeypatch, "torch", num_frames)
    t_epes = _run(tcli, _argv("data", num_frames, *flags, "--device", "cpu"),
                  monkeypatch)
    t_out = capsys.readouterr().out

    assert list(t_epes) == list(j_epes)
    assert len(t_epes) == 6 * (num_frames + 1)
    for name, ref in j_epes.items():
        assert abs(t_epes[name] - ref) <= EPE_BAND, (name, t_epes[name], ref)
    # the flow of the moving car is recovered, as the JAX tests require
    assert t_epes["overall_0"] < 0.1 and t_epes["dynamic_0"] < 0.3
    # the same printed lines: count, first words, and the report's layout
    j_lines, t_lines = j_out.splitlines(), t_out.splitlines()
    assert len(t_lines) == len(j_lines)
    number = re.compile(r"\d+\.\d+")
    for t_line, j_line in zip(t_lines, j_lines):
        assert number.sub("#", t_line) == number.sub("#", j_line)
    assert sum(" EPE3D: " in ln for ln in t_lines) == 6 * (num_frames + 1)
    # nothing was written that was not asked for
    assert sorted(os.listdir(".")) == ["data"]
    assert os.listdir("data") == ["seq_000.npz"]


def test_cli_save_resume_and_log(tmp_path, monkeypatch, capsys):
    """--if_save / --resume / --log_jsonl: the flow dumps, the metrics npz,
    the resume state and the trace are written, and a resumed run skips
    what is scored and keeps its meters."""
    _side(tmp_path, monkeypatch, "torch", 2, n_samples=2)
    argv = _argv("data", 2, "--device", "cpu", "--if_save", "--resume",
                 "--log_jsonl", "trace.jsonl")
    first = _run(tcli, argv + ["--max_samples", "1"], monkeypatch)
    out = capsys.readouterr().out
    assert "number of test sequences: 2 (running 1)" in out
    assert "Processed sample 0/1, data/seq_000.npz" in out
    dump = np.load("data/seq_000_icp_flow_ego.npz")
    raw = np.load("data/seq_000.npz")
    keep = (np.abs(raw["raw_points"][:, 0]) < 32) & (
        np.abs(raw["raw_points"][:, 1]) < 32)
    assert dump["scene_flow"].shape == (int(keep.sum()), 3)
    assert dump["scene_flow"].dtype == np.float32
    np.testing.assert_array_equal(dump["ego_motion"], raw["ego_motion_gt"])
    assert not os.path.exists("data/seq_001_icp_flow_ego.npz")
    with open("meters_waymo_test.json") as f:
        state = json.load(f)
    assert state["completed"] == ["data/seq_000.npz"]
    assert state["meters"]["overall_0"]["num"] > 0
    stamped = glob.glob("metrics_waymo_test_*.npz")
    assert len(stamped) == 1
    saved = np.load(stamped[0])
    assert len(saved.files) == 5 * 6 * 3
    assert float(saved["EPE3D_overall_0"]) == first["overall_0"]
    with open("trace.jsonl") as f:
        trace = [json.loads(line) for line in f]
    assert [t["sample"] for t in trace] == [0]
    assert set(trace[0]) == {"sample", "path", "epe3d", "acc3ds", "acc3dr",
                             "outlier", "n_points", "elapsed_s"}

    # resumed over both samples: the first is skipped, its meters kept
    both = _run(tcli, argv, monkeypatch)
    out = capsys.readouterr().out
    assert "resumed meter state: 1 samples done" in out
    assert "Skipping sample 0 (resume: already scored)" in out
    assert "Processed sample 1/2, data/seq_001.npz" in out
    assert os.path.exists("data/seq_001_icp_flow_ego.npz")
    with open("meters_waymo_test.json") as f:
        state = json.load(f)
    assert state["completed"] == ["data/seq_000.npz", "data/seq_001.npz"]
    with open("trace.jsonl") as f:
        assert [json.loads(line)["sample"] for line in f] == [0, 1]
    assert both["overall_2"] != first["overall_2"]      # two scenes' mean
    # a fresh run over both gives the resumed run's meters to the last bit
    for path in glob.glob("meters_*.json") + glob.glob("data/*_icp_flow*"):
        os.remove(path)
    fresh = _run(tcli, _argv("data", 2, "--device", "cpu"), monkeypatch)
    assert fresh == both

    # the adjacent / temporal save folders only rename the dump
    _run(tcli, _argv("data", 2, "--device", "cpu", "--if_save",
                     "--if_adjacent", "--if_kiss_icp", "--max_samples", "1"),
         monkeypatch)
    assert os.path.exists("data/seq_000_icp_flow_adjacent.npz")
    assert os.path.exists("data/seq_000.npz_pose.npz")


def test_cli_verbose_dumps_the_last_frame(tmp_path, monkeypatch, capsys):
    _side(tmp_path, monkeypatch, "torch", 2)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    _run(tcli, _argv("data", 2, "--device", "cpu", "--if_verbose"),
         monkeypatch)
    with open(tmp_path / "icpflow_cli_sample0_segments.txt") as f:
        assert f.readline().startswith("segment ")


def test_cli_flags_are_the_jax_cli_plus_device():
    def flags(parser):
        return {a.dest: (a.default, a.type, tuple(a.choices or ()))
                for a in parser._actions if a.dest != "help"}

    j, t = flags(jcli.build_parser()), flags(tcli.build_parser())
    assert t.pop("device") == ("cuda", str, ())
    assert t == j
    args = tcli.build_parser().parse_args(
        ["--dataset", "nuscene", "--if_kiss_icp", "--eval_ground",
         "--max_points_scene", "8192", "--epsilon", "0.5"])
    t_cfg = tcli.config_from_args(args)
    j_cfg = jcli.config_from_args(args)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert t_cfg.use_kiss_icp and t_cfg.eval_ground and not t_cfg.use_hdbscan


def test_entry_points_default_to_the_gpu_and_raise_without_one(
        tmp_path, monkeypatch):
    _side(tmp_path, monkeypatch, "torch", 2)
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="cuda"):
        _run(tcli, _argv("data", 2), monkeypatch)
    monkeypatch.setattr("sys.argv", ["demo", "--root", "data"])
    with pytest.raises(RuntimeError, match="cuda"):
        tdemo.main()


def test_tf32_stays_off_in_the_cli_process():
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


# -- demo.py ---------------------------------------------------------------
def _demo_npz(path, n=6000):
    """Gap 1 of a ``make_sample`` scene in the ``demo.npz`` schema: the
    clouds within 25 m of the sensor, padded by points the valid indices
    leave out."""
    buf = io.BytesIO()
    make_sample(buf, num_frames=2, seed=3)
    buf.seek(0)
    src, dst, gt, _ = ego_aligned_pair(dict(np.load(buf)), 1)
    rng = np.random.default_rng(0)

    def thin(pts, *rest):
        near = np.flatnonzero(np.linalg.norm(pts[:, :2], axis=1) < 25.0)
        idx = np.sort(rng.choice(near, min(n, len(near)), replace=False))
        return (pts[idx],) + tuple(r[idx] for r in rest)

    src, gt = thin(src, gt)
    dst, = thin(dst)
    junk = np.full((7, 3), 99.0, np.float32)
    np.savez_compressed(
        path, pc1=np.concatenate([junk, src]), pc2=np.concatenate([dst, junk]),
        pc1_flows_valid_idx=np.arange(7, 7 + len(src)),
        pc2_flows_valid_idx=np.arange(len(dst)),
        gt_flow_0_1=np.concatenate([junk, gt]),
        pc1_classes=np.zeros(7 + len(src), np.int64),
        pc2_classes=np.zeros(len(dst) + 7, np.int64))
    return len(src)


def _demo(demo, argv, monkeypatch, capsys):
    cfg = demo.DEMO.replace(
        max_points_scene=8192, max_pairs=64, pairs_small=64, pairs_large=8,
        nn_tile=256, hist_grid_xy=64, icp_max_iters=30)
    monkeypatch.setattr(demo, "DEMO", cfg)
    monkeypatch.setattr("sys.argv", ["demo"] + argv)
    demo.main()
    out = capsys.readouterr().out
    m = re.search(r"^pair\.npz: EPE3D=([\d.]+) EPE_dyn=([\d.]+) "
                  r"ACC3DS=([\d.]+) ACC3DR=([\d.]+) Outlier=([\d.]+) "
                  r"pairs=(\d+)$", out, flags=re.M)
    assert m, out
    assert "total files: 1" in out and "Processed sample: " in out
    return [float(v) for v in m.groups()]


def test_demo_main_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    os.mkdir("demo")
    n = _demo_npz("demo/pair.npz")
    assert n > 4000
    argv = ["--root", "demo", "--max_points", "1024", "--num_clusters", "48",
            "--speed", "1.67"]
    jax = _demo(jdemo, argv, monkeypatch, capsys)
    port = _demo(tdemo, argv + ["--device", "cpu"], monkeypatch, capsys)
    assert abs(port[0] - jax[0]) <= EPE_BAND, (port, jax)
    assert abs(port[1] - jax[1]) <= EPE_BAND, (port, jax)
    assert abs(port[5] - jax[5]) <= 1, (port, jax)
    # the pair does real work: movers are matched and their flow recovered
    assert port[5] >= 3 and port[0] < 0.05, port


def test_demo_flags_are_the_jax_demo_plus_device():
    def flags(parser):
        return {a.dest: (a.default, a.type) for a in parser._actions
                if a.dest != "help"}

    j, t = flags(jdemo.build_parser()), flags(tdemo.build_parser())
    assert t.pop("device") == ("cuda", str)
    assert t == j

