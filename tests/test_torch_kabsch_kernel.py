"""Kabsch's 3x3 solve on the card (``csrc/kabsch.cu``,
``ops/cuda/kabsch.py``) and the split of ``geometry.kabsch`` around it.

On the CPU: the split ``kabsch`` is bit-equal to a frozen copy of the
function as it was before the split, over normal, degenerate and
non-finite inputs; a CPU tensor takes the plain solve; the kernel library
is keyed by every CUDA source and built by one nvcc call. No JAX: the one
case that needs a GPU runs on the card with
``python3 -m pytest tests/test_torch_kabsch_kernel.py --noconftest -o
addopts="" -p no:cacheprovider -k gpu``.
"""

import os
import pathlib
import shutil
import stat
import sys

import numpy as np
import pytest
import torch

from icpflow_tpu_torch import trace
from icpflow_tpu_torch.ops import geometry as geo
from icpflow_tpu_torch.ops.cuda import kabsch as cuda_kabsch
from icpflow_tpu_torch.ops.cuda import library

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the card check's case generators)

_EPS = 1e-9
_norm = geo._norm
CPU = torch.device("cpu")


# The function as it was before the kernel, verbatim but for its name and
# its span: the reference that the split must reproduce bit for bit.
def _svd3x3_jacobi(H: torch.Tensor, sweeps: int = 6):
    """Batched one-sided (Hestenes) Jacobi SVD of (B,3,3) matrices.

    Same algorithm as the reference: 6 cyclic sweeps of column-pair
    rotations, column norms as singular values, a 3-comparator sort network.
    Returns (U, S, V) with H = U diag(S) V^T, S descending.
    """
    W = H.clone()
    V = torch.eye(3, dtype=H.dtype, device=H.device).expand_as(H).clone()

    def rotate(p, q):
        wp = W[:, :, p].clone()
        wq = W[:, :, q].clone()
        a = torch.sum(wp * wp, dim=1)
        b = torch.sum(wq * wq, dim=1)
        c = torch.sum(wp * wq, dim=1)
        small = torch.abs(c) <= _EPS * torch.sqrt(a * b + _EPS)
        tau = (b - a) / (2.0 * torch.where(small, torch.ones_like(c), c))
        t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
        t = torch.where(small, torch.zeros_like(t), t)
        cs = 1.0 / torch.sqrt(1.0 + t * t)
        sn = cs * t
        csn = cs[:, None]
        snn = sn[:, None]
        W[:, :, p] = csn * wp - snn * wq
        W[:, :, q] = snn * wp + csn * wq
        vp = V[:, :, p].clone()
        vq = V[:, :, q].clone()
        V[:, :, p] = csn * vp - snn * vq
        V[:, :, q] = snn * vp + csn * vq

    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            rotate(p, q)

    S = torch.sqrt(torch.sum(W * W, dim=1))                      # (B,3)

    def order(p, q):                                             # S[p] >= S[q]
        swap = S[:, q] > S[:, p]
        sw = swap[:, None]
        for M in (W, V):
            mp, mq = M[:, :, p].clone(), M[:, :, q].clone()
            M[:, :, p] = torch.where(sw, mq, mp)
            M[:, :, q] = torch.where(sw, mp, mq)
        sp, sq = S[:, p].clone(), S[:, q].clone()
        S[:, p] = torch.where(swap, sq, sp)
        S[:, q] = torch.where(swap, sp, sq)

    for p, q in ((0, 1), (1, 2), (0, 1)):                        # sort network
        order(p, q)
    U = W / torch.clamp(S, min=_EPS)[:, None, :]
    return U, S, V


def _norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False):
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def _kabsch_frozen(src: torch.Tensor, dst: torch.Tensor,
           weights: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted least-squares rigid alignment ``R @ src + t ~= dst``.

    The reflection fix is folded into the factors: the two leading left
    columns are re-orthonormalised, the third columns of both factors are
    completed by cross products, and R = V U^T. Degenerate inputs (weights
    below one point, coincident or collinear points) fall back to identity
    rotation with a centroid-difference translation.

    Args: src, dst (B,N,3); weights (B,N). Returns R (B,3,3), t (B,3).
    """
    w = weights.to(src.dtype)
    total = torch.sum(w, dim=1)                                  # (B,)
    denom = torch.clamp(total, min=_EPS)[:, None]
    mu_s = torch.sum(src * w[:, :, None], dim=1) / denom
    mu_d = torch.sum(dst * w[:, :, None], dim=1) / denom
    cs = (src - mu_s[:, None, :]) * w[:, :, None]
    cd = dst - mu_d[:, None, :]
    H = torch.einsum("bni,bnj->bij", cs, cd)
    H = H / torch.clamp(total, min=_EPS)[:, None, None]

    U, S, V = _svd3x3_jacobi(H)
    u1 = U[:, :, 0]
    n1 = _norm(u1, dim=1, keepdim=True)
    u1 = u1 / torch.clamp(n1, min=_EPS)
    u2 = U[:, :, 1]
    u2 = u2 - torch.sum(u2 * u1, dim=1, keepdim=True) * u1
    n2 = _norm(u2, dim=1, keepdim=True)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=src.dtype,
                      device=src.device).expand_as(u1)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=src.dtype,
                      device=src.device).expand_as(u1)
    alt = torch.linalg.cross(u1, ex, dim=-1)
    alt2 = torch.linalg.cross(u1, ez, dim=-1)
    alt = torch.where((_norm(alt, dim=1) >= _norm(alt2, dim=1))[:, None],
                      alt, alt2)
    u2 = torch.where(n2 > 1e-6, u2 / torch.clamp(n2, min=_EPS),
                     alt / torch.clamp(_norm(alt, dim=1, keepdim=True),
                                       min=_EPS))
    u3 = torch.linalg.cross(u1, u2, dim=-1)
    Up = torch.stack([u1, u2, u3], dim=2)
    v3 = torch.linalg.cross(V[:, :, 0], V[:, :, 1], dim=-1)
    Vp = torch.cat([V[:, :, :2], v3[:, :, None]], dim=2)
    R = torch.einsum("bij,bkj->bik", Vp, Up)                     # V @ U^T

    degenerate = ((total < 1.0) | ~torch.isfinite(S).all(dim=1)
                  | (S[:, 0] <= 1e-12) | (n1[:, 0] <= 1e-6))
    eye = torch.eye(3, dtype=src.dtype, device=src.device).expand_as(R)
    R = torch.where(degenerate[:, None, None], eye, R)
    t = mu_d - torch.einsum("bij,bj->bi", R, mu_s)
    t = torch.where(torch.isfinite(t), t, torch.zeros_like(t))
    return R, t


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _assert_bit_equal(got, want, what):
    for name, a, b in zip(("R", "t"), got, want):
        diff = (_bits(a) != _bits(b)).reshape(a.shape[0], -1).any(1)
        assert not bool(diff.any()), (
            f"{what}: {name} differs in rows {torch.nonzero(diff)[:, 0].tolist()}")


def _cases(b, seed, first=0, device=CPU):
    return tuple(torch.as_tensor(a, device=device)
                 for a in chip_smoke.kabsch_cases(b, seed, first=first))


@pytest.mark.parametrize("b", [1, 7, 56, 300])
def test_split_kabsch_bit_equal_to_frozen_copy(b):
    """Every kind of case (alone at B = 1, mixed above) through the split
    ``kabsch`` and through the frozen copy: the same bits in R and t."""
    kinds = chip_smoke.KABSCH_KINDS
    runs = ([(k, 1, k) for k in range(len(kinds))] if b == 1
            else [(s, b, s) for s in range(3)])
    for seed, rows, first in runs:
        src, dst, w = _cases(rows, 1000 * b + seed, first)
        _assert_bit_equal(geo.kabsch(src, dst, w), _kabsch_frozen(src, dst, w),
                          f"B={rows} first kind {kinds[first]}")


def test_cpu_tensor_takes_the_plain_solve():
    trace.clear_launches()
    src, dst, w = _cases(8, 3)
    geo.kabsch(src, dst, w)
    geo.kabsch(src[:1], dst[:1], w[:1])
    assert trace.launch_shapes("kabsch") == {
        ("kabsch_solve_plain", (8,)): 1, ("kabsch_solve_plain", (1,)): 1}


def test_traced_cpu_call_counts_no_kabsch_launches():
    trace.clear()
    src, dst, w = _cases(8, 4)
    with trace.StageClock({}, CPU, "test"):
        geo.kabsch(src, dst, w)
        geo.kabsch(src, dst, w)
    (rec,) = trace.calls()
    assert rec.spans["icpflow.kabsch"].count == 2
    assert "launches.kabsch_solve" not in rec.counters
    assert rec.counters["launches.kabsch_solve_plain"] == 2
    trace.clear()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Checked before the library is loaded, so on any machine."""
    H = torch.zeros((4, 3, 3))
    total = torch.ones(4)
    trace.clear_launches()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kabsch.kabsch_solve_cuda(H, total)
    assert trace.launch_total() == 0


def _copy_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(library.CSRC, csrc)
    monkeypatch.setattr(library, "CSRC", csrc)
    return csrc


@pytest.mark.parametrize("name", ["nn_kernel.cu", "kabsch.cu"])
def test_library_path_follows_either_source(tmp_path, monkeypatch, name):
    csrc = _copy_sources(tmp_path, monkeypatch)
    assert [p.name for p in library.sources()] == ["kabsch.cu",
                                                   "nn_kernel.cu"]
    before = library.library_path()
    with open(csrc / name, "a") as f:
        f.write("\n// edited\n")
    after = library.library_path()
    assert after != before and after.parent == before.parent


def test_library_name_keeps_its_recipe(tmp_path, monkeypatch):
    """The name hashes the sources' names and bytes and the flags as it
    always has, so an unchanged ``csrc/`` keeps the cached build of a
    checkout (the hash below is the one the recipe gave when the library
    moved out of ``nn_kernel.py``), in ``icpflow_tpu_torch/build/``."""
    assert library.BUILD_DIR == pathlib.Path(
        library.__file__).resolve().parents[2] / "build"
    monkeypatch.setattr(library, "CSRC", tmp_path)
    (tmp_path / "b.cu").write_bytes(b"// b\n")
    (tmp_path / "a.cu").write_bytes(b"// a\n")
    assert library.library_path() == \
        library.BUILD_DIR / "libicpflow_cuda_c111b5321756fb8e.so"


def test_build_compiles_every_source_in_one_nvcc_call(tmp_path, monkeypatch):
    _copy_sources(tmp_path, monkeypatch)
    monkeypatch.setattr(library, "BUILD_DIR", tmp_path / "build")
    log = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    f'echo "$@" >> "{log}"\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    ': > "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(library, "find_nvcc", lambda: str(nvcc))
    out = library.build(force=True)
    assert out == library.library_path() and out.exists()
    (call,) = log.read_text().splitlines()
    assert call.split()[-2:] == [str(p) for p in library.sources()]
    assert os.listdir(library.BUILD_DIR) == [out.name]


def test_gpu_kernel_bit_equal_to_the_plain_solve():
    """On the card: the card's solve (the kernel and the two einsums)
    against the plain solve over the CPU cases at B = 1, 7, 56, 300 and
    4096 and 10^5 random covariances, 0 differing bits; a whole ``kabsch``
    call makes no host sync; a traced call counts one
    ``launches.kabsch_solve`` an ``icpflow.kabsch`` span, and the ledger
    one ``kabsch_solve`` at its batch and no plain solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    kinds = chip_smoke.KABSCH_KINDS
    for b in (1, 7, 56, 300, 4096):
        runs = ([(k, 1, k) for k in range(len(kinds))] if b == 1
                else [(s, b, s) for s in range(3)])
        for seed, rows, first in runs:
            args = geo._kabsch_moments(*_cases(rows, 1000 * b + seed, first,
                                               dev))
            _assert_bit_equal(geo._kabsch_solve_cuda(*args),
                              geo._kabsch_solve_plain(*args), f"B={rows}")
    args = [torch.as_tensor(a, device=dev) for a in
            chip_smoke.kabsch_random_moments(100_000, 5)]
    _assert_bit_equal(geo._kabsch_solve_cuda(*args),
                      geo._kabsch_solve_plain(*args), "random")

    src, dst, w = _cases(56, 9, device=dev)
    geo.kabsch(src, dst, w)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        geo.kabsch(src, dst, w)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()

    trace.clear()
    trace.clear_launches()
    with trace.StageClock({}, dev, "test"):
        for b in (1, 7, 56):
            geo.kabsch(src[:b], dst[:b], w[:b])
    (rec,) = trace.calls()
    assert rec.counters["launches.kabsch_solve"] == 3
    assert rec.spans["icpflow.kabsch"].count == 3
    assert trace.launch_shapes("kabsch") == {
        ("kabsch_solve", (b,)): 1 for b in (1, 7, 56)}
    trace.clear()
