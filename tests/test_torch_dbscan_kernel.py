"""DBSCAN's neighbour sweep on the card (``csrc/dbscan.cu``,
``ops/cuda/dbscan.py``) and the split of ``cluster._candidates`` around it.

On the CPU: a numpy float32 model of the kernel's order of operations
(per run: integer hits, the ``__fdiv_rn`` scale, the fp32 product; per
row: the left-to-right sum over the runs, half-to-even rounding) equals
``_candidates_plain`` bit for bit; the wrapper refuses what the kernel does
not take; a CPU ``dbscan`` call takes the plain sweep and counts its
propagation rounds. No JAX at import: the one case that needs a GPU runs
on the card with ``python3 -m pytest tests/test_torch_dbscan_kernel.py
--noconftest -o addopts="" -p no:cacheprovider -k gpu``.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from icpflow_tpu_torch import trace
from icpflow_tpu_torch.ops import cluster
from icpflow_tpu_torch.ops.cuda import dbscan as cuda_dbscan

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the card check's edge cases)

CPU = torch.device("cpu")


def kernel_model(xyz_s, eps_s, ids_s, mult_s, span, nv, n, rcap, eps,
                 eps_scale_per_m):
    """What ``dbscan_candidates`` computes, in its order, in numpy float32:
    counts (n,) and edges (n, 9) int64."""
    xyz = xyz_s.numpy()
    eps_pt = eps_s.numpy()
    ids = ids_s.numpy()
    mult = None if mult_s is None else mult_s.numpy()
    s1, s2 = int(span[1]), int(span[2])
    counts = np.zeros(n, np.int64)
    edges = np.full((n, 9), n, np.int64)
    if nv == 0:
        return counts, edges
    me = xyz[:nv, None, :]
    k = np.arange(rcap)
    r_fixed = np.float32(eps) * np.float32(eps)
    acc = None
    for j, (dx, dy) in enumerate(cluster._NBR9):
        lo = ids[:nv] + (dx * s1 + dy) * s2 - 1
        st = np.searchsorted(ids, lo, side="left")
        tt = np.searchsorted(ids, lo + 3, side="left") - st
        stop = np.minimum(st + np.minimum(tt, rcap), nv)
        pos = st[:, None] + k
        ok = pos < stop[:, None]
        pc = np.minimum(pos, n - 1)
        d = xyz[pc] - me
        d_sq = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
        if eps_scale_per_m > 0.0:
            r = np.minimum(eps_pt[:nv, None], eps_pt[pc])
            r2 = r * r
        else:
            r2 = r_fixed
        within = ok & (d_sq <= r2)
        if mult is None:
            hits = within.sum(1)
        else:
            hits = np.where(within, mult[pc], 0).sum(1)
        tot = tt.astype(np.float32)
        scale = tot / np.maximum(np.minimum(tot, np.float32(rcap)),
                                 np.float32(1.0))
        hs = hits.astype(np.float32) * scale
        acc = hs if acc is None else acc + hs
        edges[:nv, j] = np.where(within, pos, n).min(1)
    assert acc.dtype == np.float32
    counts[:nv] = np.rint(acc).astype(np.int64)
    return counts, edges


def _sweep_args(call):
    """The arguments of the ``cluster._candidates`` calls ``call()``
    makes."""
    keep = []
    with chip_smoke._captured(cluster, "_candidates", keep):
        call()
    return [args for args, _ in keep]


def _assert_model_equals_plain(args, what):
    got = kernel_model(*args)
    want = [x.numpy() for x in cluster._candidates_plain(*args)]
    n, nv = args[6], args[5]
    assert got[0].shape == want[0].shape == (n,), what
    assert got[1].shape == want[1].shape == (n, 9), what
    bad = (got[0] != want[0]) | (got[1] != want[1]).any(1)
    assert not bad.any(), (
        f"{what}: rows {np.nonzero(bad)[0][:10].tolist()} (nv {nv}) differ")


def _ops_scenes():
    """``tests/test_torch_ops.py``'s three scenes and its keywords."""
    import test_torch_ops as ops
    return ((ops._wall_scene, ops._far_lines_scene, ops._blob_scene),
            ops._DB)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_model_equals_plain_sweep_on_the_ops_scenes(which):
    scenes, kw = _ops_scenes()
    pts, valid = scenes[which](np.random.default_rng(6))
    for k in (kw, dict(kw, eps_scale_per_m=0.05, eps_max=0.4)):
        (args,) = _sweep_args(lambda: cluster.dbscan(
            torch.as_tensor(pts), torch.as_tensor(valid), **k))
        _assert_model_equals_plain(args, f"{scenes[which].__name__} {k}")


@pytest.mark.parametrize("case", range(len(chip_smoke.dbscan_edge_cases())))
def test_model_equals_plain_sweep_on_the_edge_cases(case):
    tag, xyz, valid, mult, kw = chip_smoke.dbscan_edge_cases()[case]
    (args,) = _sweep_args(lambda: cluster.dbscan(
        torch.as_tensor(xyz), torch.as_tensor(valid),
        None if mult is None else torch.as_tensor(mult), **kw))
    nv, rcap = args[5], args[7]
    if tag.startswith("tt > rcap"):      # scale != 1 on some runs
        _, _, ids_s, _, span = args[:5]
        lo = ids_s[:nv] - 1                               # the center run
        tt = (torch.searchsorted(ids_s, lo + 3)
              - torch.searchsorted(ids_s, lo))
        assert int((tt > rcap).sum()) > 100
    if tag.startswith("nv = 0"):
        assert nv == 0
    if tag.startswith("nv = n"):
        assert nv == args[6]
    if tag.startswith("rcap = n"):
        assert rcap == args[6] == 100
    _assert_model_equals_plain(args, tag)


@pytest.mark.parametrize("adaptive", [False, True])
def test_model_equals_plain_sweep_weighted(adaptive):
    """``dbscan_dedup``'s representatives, whose multiplicities weight the
    hits, on the blob scene of ``test_torch_ops.py``."""
    scenes, kw = _ops_scenes()
    pts, valid = scenes[2](np.random.default_rng(11))
    if adaptive:
        kw = dict(kw, eps_scale_per_m=0.05, eps_max=0.4)
    (args,) = _sweep_args(lambda: cluster.dbscan_dedup(
        torch.as_tensor(pts), torch.as_tensor(valid), dedup_voxel=0.1,
        rep_cap=pts.shape[0], **kw))
    assert args[3] is not None and int(args[3].max()) > 1
    _assert_model_equals_plain(args, f"weighted, adaptive {adaptive}")


def _wrapper_args(n=64, **over):
    args = dict(xyz_s=torch.zeros((n, 3)), eps_s=torch.full((n,), 0.25),
                ids_s=torch.arange(n), mult_s=None,
                span=torch.tensor([4, 4, 4]), nv=n, rcap=n, eps=0.25,
                adaptive=False)
    args.update(over)
    return args


@pytest.mark.parametrize("bad,match", [
    (dict(), "CUDA"),
    (dict(xyz_s=torch.zeros((64, 3), dtype=torch.float64)), "float32"),
    (dict(eps_s=torch.full((64,), 0.25, dtype=torch.float16)), "float32"),
    (dict(ids_s=torch.arange(64, dtype=torch.int32)), "int64"),
    (dict(mult_s=torch.ones(64, dtype=torch.int32)), "int64"),
    (dict(xyz_s=torch.zeros((3, 64)).t()), "contiguous"),
    (dict(ids_s=torch.arange(128)[::2]), "contiguous"),
    (dict(span=torch.tensor([4, 4])), "shape"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    """Checked before the library is loaded, so on any machine."""
    trace.clear_launches()
    with pytest.raises(ValueError, match=match):
        cuda_dbscan.dbscan_candidates_cuda(**_wrapper_args(**bad))
    assert trace.launch_total() == 0


def test_cpu_dbscan_takes_the_plain_sweep_and_counts_its_rounds():
    scenes, kw = _ops_scenes()
    pts, valid = scenes[0](np.random.default_rng(6))
    trace.clear_launches()
    cluster.dbscan(torch.as_tensor(pts), torch.as_tensor(valid), **kw)
    nv = int(valid.sum())
    assert trace.launch_shapes("dbscan") == {
        ("dbscan_candidates_plain", (nv, 2 * kw["cell_cap"])): 1}

    trace.clear()
    info = {}
    with trace.StageClock({}, CPU, "test"):
        cluster.dbscan(torch.as_tensor(pts), torch.as_tensor(valid),
                       info=info, **kw)
    (rec,) = trace.calls()
    assert info["rounds"] >= 2
    assert rec.counters["dbscan_rounds"] == info["rounds"]
    assert rec.counters["launches.dbscan_candidates_plain"] == 1
    assert "launches.dbscan_candidates" not in rec.counters
    trace.clear()


def test_gpu_kernel_bit_equal_to_the_plain_sweep():
    """On the card: the kernel against the plain sweep on the edge cases
    (both radii, weighted, nv = 0 and n, rcap = n, tt > rcap, one cell),
    every value of every row; ``dbscan`` launches it once a call and the
    plain sweep never, and its labels equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    for tag, xyz, valid, mult, kw in chip_smoke.dbscan_edge_cases():
        host = (torch.as_tensor(xyz), torch.as_tensor(valid),
                None if mult is None else torch.as_tensor(mult))
        card = tuple(None if a is None else a.to(dev) for a in host)
        trace.clear_launches()
        (args,) = _sweep_args(lambda: cluster.dbscan(*card, **kw))
        nv, rcap = args[5], args[7]
        assert trace.launch_shapes("dbscan") == {
            ("dbscan_candidates", (nv, rcap)): 1}, tag
        got = cuda_dbscan.dbscan_candidates_cuda(
            *args[:5], nv, rcap, args[8], args[9] > 0.0)
        want = cluster._candidates_plain(*args)
        for g, w in zip(got, want):
            assert torch.equal(g, w), tag
        assert torch.equal(cluster.dbscan(*card, **kw).cpu(),
                           cluster.dbscan(*host, **kw)), tag
