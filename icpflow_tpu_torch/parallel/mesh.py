"""Process groups and the (dp, cp) mesh of the sharded step.

Port of ``icpflow_tpu/parallel/mesh.py``. The reference is single-GPU
(`main.py:141-142`); the JAX package scales over the two data axes of the
method:

  * ``dp`` -- frame pairs: each rank runs whole frame pairs;
  * ``cp`` -- cluster pairs: each rank solves a slice of a frame pair's
    pair buckets, and only the assignment tables (a min-reduction) and the
    per-pair results (a gather) cross between ranks.

JAX's devices are here the ranks of a ``torch.distributed`` world, one
process each: rank r sits at (r // n_cp, r % n_cp), as JAX's
``reshape(n_dp, n_cp)`` lays devices out. The backend is NCCL when every
rank of a host has a card of its own, and gloo when ranks share a card
(NCCL refuses two ranks on one GPU) or run on the CPU.

:func:`local_world` starts the ranks of one host from a calling process,
which becomes rank 0; a launcher such as ``torchrun`` starts them instead
under ``--multihost`` (``init_world`` with no rank reads its environment).
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import os
import queue
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from ..device import DEFAULT_DEVICE, resolve_device

# a rendezvous or a collective that waits longer than this raises, so a
# rank that died fails the others instead of hanging them
TIMEOUT = datetime.timedelta(minutes=10)
JOIN_SECONDS = 60        # how long a finished rank 0 waits for the others


def pick_backend(device, local_world_size: int) -> str:
    """``"nccl"`` when ``device`` is a GPU and each of the host's
    ``local_world_size`` ranks has a card of its own, else ``"gloo"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def init_world(device=DEFAULT_DEVICE, rank: int | None = None,
               world_size: int | None = None,
               init_method: str = "env://") -> str:
    """Join this process to the world as ``rank`` of ``world_size`` (both
    from the launcher's ``RANK`` / ``WORLD_SIZE`` when None: a world on
    one host otherwise). On a GPU the process first takes card ``local rank
    % device_count`` (``LOCAL_RANK`` under a launcher), before any tensor
    or launch. Returns the backend."""
    dev = resolve_device(device)
    if rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                         os.environ.get("WORLD_SIZE", 1)))
    else:
        local_rank, local_world = rank, world_size
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    backend = pick_backend(dev, local_world)
    kw = {} if rank is None else dict(rank=rank, world_size=world_size)
    dist.init_process_group(backend=backend, init_method=init_method,
                            timeout=TIMEOUT, **kw)
    return backend


def _cpu_share(world_size: int) -> int:
    """Threads a rank of ``world_size`` CPU ranks on this host gets."""
    return max(1, (os.cpu_count() or 1) // world_size)


def _rank_main(rank, world_size, init_method, device, target, args,
               ready):
    """A spawned rank: unpickling this function imported the package, which
    turns TF32 off before any math. It reports on ``ready`` before it
    joins; on the CPU the host's cores are split between the ranks."""
    ready.put(rank)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(_cpu_share(world_size))
    init_world(device, rank, world_size, init_method)
    try:
        target(*args)
    finally:
        dist.destroy_process_group()


def _await_ranks(procs, ready):
    """Wait until every spawned rank has reported, failing as soon as one
    exits before it does (a rank that never joins would hold rank 0 in the
    rendezvous for ``TIMEOUT``)."""
    waiting = {r: p for r, p in enumerate(procs, 1)}
    deadline = time.monotonic() + TIMEOUT.total_seconds()
    while waiting:
        try:
            waiting.pop(ready.get(timeout=0.5))
        except queue.Empty:
            dead = {r: p.exitcode for r, p in waiting.items()
                    if p.exitcode is not None}
            if dead:
                raise RuntimeError(f"ranks exited before joining: {dead}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks {sorted(waiting)} did not start")


@contextlib.contextmanager
def local_world(world_size: int, device, target, args=()):
    """Make the calling process rank 0 of a ``world_size``-rank world on
    this host. Ranks 1.. are spawned processes that join and then run
    ``target(*args)``, a module-level function. Yields the backend. On exit
    rank 0 leaves the world, waits ``JOIN_SECONDS`` for the others, kills
    any still running, and raises if one failed. CPU ranks, rank 0 too
    while the world lasts, split the host's cores."""
    ctx = mp.get_context("spawn")
    ready = ctx.Queue()
    with tempfile.TemporaryDirectory() as td:
        init_method = f"file://{td}/store"
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, world_size, init_method, str(device), target, args, ready))
            for r in range(1, world_size)]
        for p in procs:
            p.start()
        ok = False
        threads = torch.get_num_threads()
        if torch.device(device).type == "cpu":
            torch.set_num_threads(min(threads, _cpu_share(world_size)))
        try:
            _await_ranks(procs, ready)
            backend = init_world(device, 0, world_size, init_method)
            try:
                yield backend
            finally:
                dist.destroy_process_group()
            ok = True
        finally:
            torch.set_num_threads(threads)
            for p in procs:
                p.join(JOIN_SECONDS)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        failed = {r: p.exitcode for r, p in enumerate(procs, 1)
                  if p.exitcode != 0}
        if ok and failed:
            raise RuntimeError(f"ranks exited with codes {failed}")


def make_mesh(n_dp: int, n_cp: int = 1,
              device=DEFAULT_DEVICE) -> DeviceMesh:
    """The (dp, cp) mesh over the first ``n_dp * n_cp`` ranks of the
    initialised world. Raises ``ValueError`` when the world is smaller."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call init_world "
                           "or enter local_world first")
    need = n_dp * n_cp
    have = dist.get_world_size()
    if have < need:
        raise ValueError(f"need {need} devices, have {have}")
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(need).reshape(n_dp, n_cp),
                      mesh_dim_names=("dp", "cp"))


class Axis:
    """One mesh dimension: this rank's place on it and the collectives the
    sharded step issues over its process group.

    Each call adds one to ``counts[op]`` and its output bytes to
    ``nbytes[op]``; the axes of one step share both counters.
    """

    _OPS = {"min": dist.ReduceOp.MIN, "sum": dist.ReduceOp.SUM}

    def __init__(self, mesh: DeviceMesh, name: str,
                 counts: collections.Counter, nbytes: collections.Counter):
        self.group = mesh.get_group(name)
        self.size = mesh.size(mesh.mesh_dim_names.index(name))
        self.rank = mesh.get_local_rank(name)
        self.counts = counts
        self.nbytes = nbytes

    def _count(self, op: str, out: torch.Tensor):
        self.counts[op] += 1
        self.nbytes[op] += out.numel() * out.element_size()

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """``x`` reduced by ``op`` ("min" or "sum") over the axis."""
        out = x.clone()
        dist.all_reduce(out, op=self._OPS[op], group=self.group)
        self._count(f"all_reduce_{op}", out)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x``, concatenated along dim 0 in rank order (JAX's
        ``all_gather(..., tiled=True)``)."""
        send = x.contiguous()
        parts = [torch.empty_like(send) for _ in range(self.size)]
        dist.all_gather(parts, send, group=self.group)
        out = torch.cat(parts)
        self._count("all_gather", out)
        return out
