"""Rank targets of ``tests/test_torch_parallel.py``.

A spawned rank imports its target by module and name; these live apart
from the test file so that a rank imports no JAX and starts in a second or
two. Each target runs on every rank of a ``local_world``, the test process
being rank 0, which keeps what the target returns.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from icpflow_tpu_torch import DEMO
from icpflow_tpu_torch.parallel.mesh import make_mesh
from icpflow_tpu_torch.parallel.shard import make_sharded_step

# tests/test_sharding.py's configuration
CFG = DEMO.replace(
    max_points_scene=1024,
    max_points=128,
    num_clusters=8,
    max_pairs=8,
    min_cluster_size=5,
    nn_tile=128,
    hist_grid_xy=64,
    icp_max_iters=8,
    epsilon=0.4,
)


def make_batch(b, seed=0, cfg=CFG):
    """tests/test_sharding.py: make_batch as numpy arrays: ``b`` frame
    pairs of two clusters each, the second moving by (1 + 0.1 i, -0.5, 0)."""
    rng = np.random.default_rng(seed)
    n = cfg.max_points_scene
    pts_s = np.zeros((b, n, 3), np.float32)
    pts_d = np.zeros((b, n, 3), np.float32)
    lab = np.full((b, n), -1, np.int32)
    valid = np.zeros((b, n), bool)
    gt = np.zeros((b, n, 3), np.float32)
    for i in range(b):
        c0 = rng.uniform(-3, 3, size=3).astype(np.float32)
        pts0 = c0 + rng.uniform(-1, 1, (300, 3)).astype(np.float32)
        c1 = rng.uniform(-3, 3, size=3).astype(np.float32)
        pts1 = c1 + rng.uniform(-1, 1, (200, 3)).astype(np.float32)
        shift = np.array([1.0 + 0.1 * i, -0.5, 0.0], np.float32)
        pts_s[i, :300] = pts0
        pts_s[i, 300:500] = pts1
        pts_d[i, :300] = pts0
        pts_d[i, 300:500] = pts1 + shift
        lab[i, :300] = 0
        lab[i, 300:500] = 1
        valid[i, :500] = True
        gt[i, 300:500] = shift
    return pts_s, valid, lab, pts_d, valid, lab, gt


def mesh_places(n_dp, n_cp):
    """This rank's place on a (n_dp, n_cp) mesh, checked against (rank //
    n_cp, rank % n_cp), and the error of a mesh twice the world's size."""
    mesh = make_mesh(n_dp, n_cp, "cpu")
    rank = dist.get_rank()
    place = (rank // n_cp, rank % n_cp)
    if (tuple(mesh.get_coordinate()) != place
            or (mesh.get_local_rank("dp"), mesh.get_local_rank("cp"))
            != place):
        raise AssertionError(f"rank {rank} at {mesh.get_coordinate()}")
    try:
        make_mesh(2 * n_dp, n_cp, "cpu")
        err = None
    except ValueError as e:
        err = str(e)
    return dict(rank=rank, coord=mesh.get_coordinate(),
                mesh=mesh.mesh.tolist(),
                dp=(mesh.get_local_rank("dp"), mesh.size(0)),
                cp=(mesh.get_local_rank("cp"), mesh.size(1)), err=err)


def sharded_step(cfg, n_dp, n_cp, batch, tf):
    """The port's sharded step over a (n_dp, n_cp) mesh on ``batch`` (the
    seven numpy arrays of ``make_batch``), identity poses, search radius
    ``tf``. Returns (flow, transforms, sums, overflow, collective calls)
    as numpy arrays and a dict."""
    step = make_sharded_step(make_mesh(n_dp, n_cp, "cpu"), cfg)
    b = batch[0].shape[0]
    args = [torch.as_tensor(a) for a in batch]
    poses = torch.eye(4).expand(b, 4, 4).contiguous()
    flow, transforms, sums = step(*args, poses,
                                  torch.full((b,), tf, dtype=torch.float32))
    return (flow.numpy(), transforms.numpy(), sums.numpy(),
            step.overflow.numpy(), dict(step.counts))


def multihost_rank(argv, cfg, env, results):
    """A rank of a ``--multihost`` world as a launcher starts one: ``env``
    holds its RANK, WORLD_SIZE, ... Runs the port's ``cli.run`` at ``cfg``
    and puts what it returns on ``results``."""
    os.environ.update(env)
    from icpflow_tpu_torch import cli
    cli.config_from_args = lambda args: cfg
    results.put(cli.run(cli.build_parser().parse_args(argv)))
