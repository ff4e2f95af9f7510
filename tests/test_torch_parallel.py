"""The port's sharded step, mesh and distributed CLI against the JAX
package's, on the CPU.

The port's ranks are gloo processes (``parallel.mesh.local_world``: the
test process is rank 0, the others are spawned and run a target of
``tests/torch_parallel_ranks.py``); the JAX side runs its ``shard_map``
step on the conftest's virtual 8-device CPU mesh. Both get the same numpy
batches (``make_batch`` of ``tests/test_sharding.py``). Flow within 1e-4 m
of JAX's sharded step and 1e-5 m of the port's own step run pair by pair;
the point count of the metric sums exact, the other sums within 1e-4
relative (the EPE sum, fp32 noise over points whose error is ~0, within
the flow bound times the point count); CLI meters within 1e-4 m, the bound ``tests/test_cli_pca.py``
holds the JAX CLI's sharded run to. Every spawn waits at most
``mesh.TIMEOUT`` (60 s here) for a rank and ``mesh.JOIN_SECONDS`` to join
it, then kills it, so a hung rank fails its test only.
"""

import dataclasses
import datetime
import multiprocessing
import os
import re
import socket

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import icpflow_tpu as J  # noqa: E402
from icpflow_tpu import cli as jcli  # noqa: E402
from icpflow_tpu.match import matcher as jmatcher  # noqa: E402
from icpflow_tpu.parallel import shard as jshard  # noqa: E402
from icpflow_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from icpflow_tpu.utils import plot as jplot  # noqa: E402
from icpflow_tpu.utils import viz3d as jviz3d  # noqa: E402

from icpflow_tpu_torch import cli as tcli  # noqa: E402
from icpflow_tpu_torch.match import matcher as tmatcher  # noqa: E402
from icpflow_tpu_torch.parallel import mesh  # noqa: E402
from icpflow_tpu_torch.parallel.scaling import (default_config,  # noqa: E402
                                                run_scaling)
from icpflow_tpu_torch.parallel.shard import _frame_pair_step  # noqa: E402
from icpflow_tpu_torch.utils import plot as tplot  # noqa: E402
from icpflow_tpu_torch.utils import timer as ttimer  # noqa: E402
from icpflow_tpu_torch.utils import viz3d as tviz3d  # noqa: E402

import torch_parallel_ranks as R  # noqa: E402
from test_torch_cli import _argv, _run, _side  # noqa: E402

torch.set_num_threads(2)
TF = 4.0


def _jcfg(cfg):
    return J.PipelineConfig(**dataclasses.asdict(cfg))


@pytest.fixture(autouse=True)
def _deadline(monkeypatch):
    monkeypatch.setattr(mesh, "TIMEOUT", datetime.timedelta(seconds=60))
    monkeypatch.setattr(mesh, "JOIN_SECONDS", 60)


def _sharded(cfg, n_dp, n_cp, batch, tf=TF):
    """The port's sharded step on a CPU world of n_dp * n_cp ranks."""
    args = (cfg, n_dp, n_cp, batch, tf)
    with mesh.local_world(n_dp * n_cp, "cpu", R.sharded_step, args):
        return R.sharded_step(*args)


def _jax_sharded(cfg, n_dp, n_cp, batch, tf=TF, overflows=None):
    """JAX's sharded step on the virtual mesh; with ``overflows`` (a dict)
    each pair's matcher overflow is recorded by its search radius."""
    b = batch[0].shape[0]
    if overflows is not None:
        orig = jshard.match_frame_pair

        def match(seg_src, seg_dst, tf_, cfg_, **kw):
            res = orig(seg_src, seg_dst, tf_, cfg_, **kw)
            jax.debug.callback(
                lambda t, o: overflows.__setitem__(float(t), int(o)), tf_,
                res.overflow)
            return res

        jshard.match_frame_pair = match
    try:
        step = jshard.make_sharded_step(jmake_mesh(n_dp, n_cp), _jcfg(cfg))
        out = step(*[jnp.asarray(a) for a in batch],
                   jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32),
                                    (b, 4, 4)),
                   jnp.full((b,), tf, jnp.float32))
        return [np.asarray(o) for o in out]
    finally:
        if overflows is not None:
            jshard.match_frame_pair = orig


# -- mesh ---------------------------------------------------------------
@pytest.mark.parametrize("n_dp, n_cp", [(2, 2), (1, 4)])
def test_make_mesh_layout_and_error(n_dp, n_cp):
    """Rank r at (r // n_cp, r % n_cp) as JAX's reshape lays devices out
    (every rank checks its own place); a mesh wider than the world raises
    JAX's ValueError."""
    args = (n_dp, n_cp)
    with mesh.local_world(4, "cpu", R.mesh_places, args) as backend:
        out = R.mesh_places(*args)
    assert backend == "gloo"
    jm = jmake_mesh(n_dp, n_cp)
    assert out["mesh"] == [[d.id for d in row] for row in jm.devices]
    assert out["dp"] == (0, n_dp) and out["cp"] == (0, n_cp)
    assert out["err"] == "need 8 devices, have 4"       # 2 n_dp x n_cp
    with pytest.raises(ValueError, match=r"^need 16 devices, have 8$"):
        jmake_mesh(4 * n_dp, n_cp)
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.make_mesh(1, 1, "cpu")


def test_backend_choice(monkeypatch):
    assert mesh.pick_backend("cpu", 1) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh.pick_backend("cuda", 4) == "nccl"
    assert mesh.pick_backend("cuda", 5) == "gloo"       # ranks share a card


# -- the matcher's cp form ------------------------------------------------
@pytest.mark.parametrize("offset, total", [(0, None), (8, 32), (24, 32)])
def test_assign_matches_jax(offset, total):
    rng = np.random.default_rng(offset)
    K, L = 8, 6
    pair_src = rng.integers(0, L, K).astype(np.int32)
    err = rng.choice([0.01, 0.02, 0.05, 0.3], K).astype(np.float32)  # ties
    accept = rng.random(K) < 0.7
    j_m, j_c = jmatcher._assign(
        jnp.asarray(pair_src), jnp.asarray(pair_src), jnp.asarray(err),
        jnp.asarray(accept), L, 0.1, cp_axis=None, idx_offset=offset,
        total_pairs=total)
    t_m, t_c = tmatcher._assign(
        torch.as_tensor(pair_src), torch.as_tensor(err),
        torch.as_tensor(accept), L, 0.1, idx_offset=offset,
        total_pairs=total)
    np.testing.assert_array_equal(t_m.numpy(), np.asarray(j_m))
    np.testing.assert_array_equal(t_c.numpy(), np.asarray(j_c))
    assert t_m.any()


# -- the sharded step -----------------------------------------------------
@pytest.mark.parametrize("n_dp, n_cp", [
    (2, 2),
    pytest.param(4, 2, marks=pytest.mark.slow),
    pytest.param(2, 4, marks=pytest.mark.slow),
    pytest.param(8, 1, marks=pytest.mark.slow)])
def test_sharded_step_matches_per_pair_and_jax(n_dp, n_cp):
    batch = R.make_batch(n_dp, seed=42)
    flow, transforms, sums, overflow, counts = _sharded(R.CFG, n_dp, n_cp,
                                                        batch)
    assert flow.shape == (n_dp, R.CFG.max_points_scene, 3)
    assert transforms.shape == (n_dp, R.CFG.num_clusters, 4, 4)
    for i in range(n_dp):
        f1, t1, _, o1 = _frame_pair_step(
            *[torch.as_tensor(a[i]) for a in batch], torch.eye(4), TF, R.CFG)
        np.testing.assert_allclose(flow[i], f1.numpy(), rtol=0, atol=1e-5)
        assert int(overflow[i]) == int(o1)
    j_flow, j_transforms, j_sums = _jax_sharded(R.CFG, n_dp, n_cp, batch)
    np.testing.assert_allclose(flow, j_flow, rtol=0, atol=1e-4)
    np.testing.assert_allclose(transforms, j_transforms, rtol=0, atol=1e-4)
    assert sums[0] == j_sums[0] == n_dp * 500
    # the EPE sum of ~zero errors is fp32 noise: by the triangle inequality
    # it may differ by the flow bound (1e-4 m) times the point count
    np.testing.assert_allclose(sums[1:], j_sums[1:], rtol=1e-4,
                               atol=1e-4 * sums[0])
    # collectives: per pair 2 min-reductions and 3 gathers a stage and one
    # sum of the dropped pairs over cp; flow, transforms and overflow
    # gathered and the sums added over dp
    per = 1                                   # B = n_dp
    cp_calls = {"all_reduce_min": 4, "all_gather": 6, "all_reduce_sum": 1}
    want = {k: per * v for k, v in cp_calls.items()} if n_cp > 1 else {}
    if n_dp > 1:
        want["all_gather"] = want.get("all_gather", 0) + 3
        want["all_reduce_sum"] = want.get("all_reduce_sum", 0) + 1
    assert counts == want


def test_sharded_step_recovers_motion():
    """tests/test_sharding.py's recovery check, two pairs a dp rank."""
    batch = R.make_batch(4, seed=7)
    flow = _sharded(R.CFG, 2, 2, batch)[0]
    err = np.linalg.norm(flow - batch[6], axis=-1)
    assert err[batch[1]].mean() < 0.1


def _overflow_batch(cfg):
    """Two far-apart groups of two same-size boxes; dst swaps the labels
    within each group, so every self-pair fails and stage 2 holds (0,0),
    (0,1), (1,0), (1,1) and (2,2), (2,3), (3,2), (3,3), in that order: one
    cp rank's slice each. With ``pairs_small`` 2 each slice solves its
    first two, so cluster 2 is recovered only over cp."""
    rng = np.random.default_rng(3)
    n = cfg.max_points_scene
    ps = np.zeros((1, n, 3), np.float32)
    pd = np.zeros_like(ps)
    ls = np.full((1, n), -1, np.int32)
    ld = ls.copy()
    valid = np.zeros((1, n), bool)
    gt = np.zeros_like(ps)
    shift = np.array([0.5, 0.0, 0.0], np.float32)
    for k in range(4):
        c = np.array([1.2 * (k % 2) + 20.0 * (k // 2) - 10.0, 0, 0],
                     np.float32)
        pts = c + rng.uniform(-0.5, 0.5, (60, 3)).astype(np.float32)
        sl = slice(60 * k, 60 * k + 60)
        ps[0, sl], pd[0, sl], gt[0, sl] = pts, pts + shift, shift
        ls[0, sl], ld[0, sl] = k, k ^ 1
    valid[0, :240] = True
    return ps, valid, ls, pd, valid.copy(), ld, gt


def test_cp_slices_cap_their_own_buckets():
    cfg = R.CFG.replace(pairs_small=2, pairs_large=1)
    batch = _overflow_batch(cfg)
    flow, _, _, overflow, _ = _sharded(cfg, 1, 2, batch)
    overflows = {}
    j_flow = _jax_sharded(cfg, 1, 2, batch, overflows=overflows)[0]
    np.testing.assert_allclose(flow, j_flow, rtol=0, atol=1e-4)
    assert overflows == {TF: int(overflow[0])} == {TF: 6}
    err = np.linalg.norm(flow[0] - batch[6][0], axis=-1)[:240]
    assert np.allclose(err.reshape(4, 60).mean(1), [0, 0.5, 0, 0.5],
                       atol=1e-4)
    # one process: a single pairs_small cap over the whole frame
    f1, _, _, o1 = _frame_pair_step(
        *[torch.as_tensor(a[0]) for a in batch], torch.eye(4), TF, cfg)
    assert int(o1) == 8
    assert np.linalg.norm(f1.numpy() - batch[6][0], axis=-1)[120:180].mean() \
        > 0.4


# -- the CLI --------------------------------------------------------------
def _no_numbers(lines):
    number = re.compile(r"\d+\.\d+")
    return [number.sub("#", ln) for ln in lines]


def test_cli_sharded_matches_unsharded(tmp_path, monkeypatch, capsys):
    _side(tmp_path, monkeypatch, "torch", 3)
    single = _run(tcli, _argv("data", 3, "--device", "cpu"), monkeypatch)
    one = capsys.readouterr().out.splitlines()
    ranks, timings = [], []
    args = tcli.build_parser().parse_args(
        _argv("data", 3, "--device", "cpu", "--dp", "2", "--cp", "2"))
    sharded = tcli.run(args, timings=timings, ranks=ranks)
    out = capsys.readouterr().out.splitlines()
    assert list(sharded) == list(single)
    for name, v in single.items():
        assert abs(sharded[name] - v) < 1e-4, (name, v, sharded[name])
    assert out[0] == "sharded step over mesh dp=2 cp=2 backend=gloo"
    assert _no_numbers(out[1:]) == _no_numbers(one)
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert not any(r["tf32"] for r in ranks)
    assert all(r["plain_calls"] >= 0 and r["nn_launches"] == 0
               for r in ranks)
    assert ranks[0]["plain_calls"] > 0 and ranks[2]["plain_calls"] > 0
    assert set(timings[0]["sharded"]) == {"pad", "broadcast", "step"}


@pytest.mark.slow
def test_cli_sharded_matches_jax_sharded(tmp_path, monkeypatch, capsys):
    """Both CLIs with --dp 2 --cp 2 (JAX on the virtual mesh). Slow: JAX's
    compile of the sharded CLI's step makes it 49 s alone and 66 s beside
    four other test workers; the step itself is held to JAX's in the fast
    tier (``test_sharded_step_matches_per_pair_and_jax``)."""
    _side(tmp_path, monkeypatch, "jax", 3)
    j = _run(jcli, _argv("data", 3, "--dp", "2", "--cp", "2"), monkeypatch)
    _side(tmp_path, monkeypatch, "torch", 3)
    t = _run(tcli, _argv("data", 3, "--device", "cpu", "--dp", "2", "--cp",
                         "2"), monkeypatch)
    for name, v in j.items():
        assert abs(t[name] - v) < 1e-4, (name, v, t[name])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_multihost_initialises_the_world_once(tmp_path, monkeypatch,
                                                  capsys):
    """``--multihost`` under a one-rank env:// world (what torchrun sets):
    ``init_process_group`` runs once, the meters are those of a run
    without it, and the world is left afterwards."""
    _side(tmp_path, monkeypatch, "torch", 2)
    plain = _run(tcli, _argv("data", 2, "--device", "cpu"), monkeypatch)
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    calls = []
    real = torch.distributed.init_process_group

    def spy(*a, **k):
        calls.append(k.get("init_method"))
        return real(*a, **k)

    monkeypatch.setattr(torch.distributed, "init_process_group", spy)
    multi = _run(tcli, _argv("data", 2, "--device", "cpu", "--multihost"),
                 monkeypatch)
    assert calls == ["env://"]
    assert multi == plain
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    with pytest.raises(ValueError, match="1 ranks, --dp \\* --cp is 2"):
        _run(tcli, _argv("data", 2, "--device", "cpu", "--multihost",
                         "--dp", "2"), monkeypatch)
    assert not torch.distributed.is_initialized()


def test_cli_multihost_two_ranks(tmp_path, monkeypatch, capsys):
    """``--multihost --dp 2`` over two ranks started as a launcher would
    (rank 1 a spawned process): rank 1 serves the step, one real pair and
    one dummy pair go through it, and both ranks return rank 0's meters,
    those of a run without the flags."""
    _side(tmp_path, monkeypatch, "torch", 2)
    single = _run(tcli, _argv("data", 2, "--device", "cpu"), monkeypatch)
    cfg = tcli.config_from_args(None)
    argv = _argv("data", 2, "--device", "cpu", "--multihost", "--dp", "2")
    env = dict(WORLD_SIZE="2", LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    rank1 = ctx.Process(target=R.multihost_rank, daemon=True, args=(
        argv, cfg, dict(env, RANK="1", LOCAL_RANK="1"), results))
    rank1.start()
    try:
        for k, v in dict(env, RANK="0", LOCAL_RANK="0").items():
            monkeypatch.setenv(k, v)
        out = tcli.run(tcli.build_parser().parse_args(argv))
        other = results.get(timeout=60)
    finally:
        rank1.join(60)
        if rank1.is_alive():
            rank1.kill()
            rank1.join()
    assert rank1.exitcode == 0
    assert other == out
    for name, v in single.items():
        assert abs(out[name] - v) < 1e-4, (name, v, out[name])
    assert not torch.distributed.is_initialized()


# -- scaling --------------------------------------------------------------
def test_run_scaling_fields_and_counts():
    cfg = default_config().replace(
        max_points_scene=1024, max_points=128, num_clusters=8, max_pairs=8,
        pairs_small=8, pairs_large=2, nn_tile=128, icp_max_iters=4)
    out = run_scaling([1, 2, 4], cfg=cfg, iters=1, device="cpu", devices=2)
    assert [r["dp"] for r in out] == [1, 2]            # 4 > 2 ranks: skipped
    fields = {"dp", "pairs_per_sec", "collectives_per_step",
              "collective_bytes_per_step", "efficiency", "backend", "note"}
    assert all(set(r) == fields for r in out)
    one, two = out
    assert one["collectives_per_step"] == {} \
        and one["collective_bytes_per_step"] == 0 and one["efficiency"] == 1
    assert two["collectives_per_step"] == {"all_gather": 3,
                                           "all_reduce_sum": 1}
    # flow (2,1024,3) f32, transforms (2,8,4,4) f32, overflow (2,) i64,
    # sums (6,) f32
    assert two["collective_bytes_per_step"] == \
        2 * 1024 * 3 * 4 + 2 * 8 * 16 * 4 + 2 * 8 + 6 * 4
    assert all(r["pairs_per_sec"] > 0 and r["backend"] == "gloo"
               for r in out)
    assert one["note"] is None and "not meaningful" in two["note"]


# -- utils ----------------------------------------------------------------
def test_section_timer_and_profile_trace(tmp_path):
    with ttimer.profile_trace(None):
        pass
    with ttimer.profile_trace(str(tmp_path)):
        torch.ones(64).cumsum(0)
    assert any(name.endswith(".json") for name in os.listdir(tmp_path))


def test_viz3d_html_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(3000, 3)).astype(np.float32)
    lab = rng.integers(-1, 4, 3000).astype(np.int64)
    lab[:50] = -10 ** 8
    flow = rng.normal(scale=0.1, size=(3000, 3)).astype(np.float32)
    outs = []
    for mod, name in ((jviz3d, "j"), (tviz3d, "t")):
        p = mod.visualize_pcd_3d(pts, lab, path=str(tmp_path / f"{name}.html"),
                                 flow=flow, max_points=2000)
        q = mod.visualize_registration_3d(
            pts[:300], pts[300:600], np.eye(4, dtype=np.float32),
            path=str(tmp_path / f"{name}_reg.html"))
        outs.append((open(p).read(), open(q).read()))
    assert outs[0] == outs[1]
    assert "scatter3d" in outs[1][0] and "|flow|" in outs[1][0]


def test_plot_parses_the_ports_report(tmp_path):
    """``parse_log`` reads back every meter of ``report`` and a line in the
    reference's format; ``epe_curve`` and ``plot_runs`` equal the JAX
    package's on it. JAX's ``parse_log`` reads the values before it pops
    the name (`icpflow_tpu/utils/plot.py:40`) and so raises on any log."""
    from icpflow_tpu_torch.metrics import make_meters, report
    meters = make_meters(3)
    for i, m in enumerate(meters.values()):
        m.update(0.01 * i, 0.9, 0.95, 0.1, 0.05, 10 + i)
    log = tmp_path / "run.log"
    log.write_text("header\n" + report(meters, 3) + "\n"
                   "overall_9 , EPE3D: 0.5 , ACC3DS: 0.1 , ACC3DR: 0.2 , "
                   "Outlier: 0.3 , Routlier: 0.4\n")
    parsed = tplot.parse_log(str(log))
    want = {name: {k: round(getattr(m, f"{k}_avg"), 6) for k in
                   ("epe", "accs", "accr", "outlier", "routlier")}
            for name, m in meters.items()}
    want["overall_9"] = dict(epe=0.5, accs=0.1, accr=0.2, outlier=0.3,
                             routlier=0.4)
    assert parsed == want
    with pytest.raises(ValueError, match="could not convert"):
        jplot.parse_log(str(log))
    for cat in ("overall", "dynamic"):
        assert tplot.epe_curve(parsed, cat, 3) == jplot.epe_curve(parsed,
                                                                  cat, 3)
    out = tmp_path / "curves.png"
    assert tplot.plot_runs([str(log)], str(out), num_frames=3)
    assert out.stat().st_size > 0
