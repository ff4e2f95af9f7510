"""Bind and launch the Hopper NN kernel (``csrc/nn_kernel.cu``).

The kernel lives in the port's one kernel library, which
``ops/cuda/library.py`` builds and loads; :func:`masked_nn_cuda` binds its
entry at the first launch. Every launch is counted in the trace's ledger of
kernel calls (``trace.launch``) as ``nn_{expanded|elementwise|sentinel}_
{index|points}`` with its (B, N, M).

``on_launch``, when set to a callable, is called as ``on_launch(name, src,
dst, dst_mask, src_mask, plan)`` after each launch, ``plan`` being the
launch's (dst slices, split), so that a measuring
script can read the valid counts of a run's inputs and how each was
launched. It is ``None`` by default and then costs one comparison a launch.

:func:`launch_plan` chooses how a launch splits dst: not at all, over a
thread-block cluster merged in shared memory (either output at the
matcher's shapes), or over many blocks merged by ``atomicMin`` (a long
index sweep by few blocks: :func:`split_kind`).

:func:`bound_ms` and :func:`io_ms` give the least time the card could take
for one launch: the kernel is bound by the FP32 rate of the CUDA cores,
counted on the valid (src, dst) pairs; the bytes it must move are far
below that.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import torch

from ... import trace as _trace
from . import library

FORMS = ("expanded", "elementwise", "sentinel")   # the C entry's form codes
THREADS = 128            # kThreads and kChunk of the source
CHUNK = 512
BLOCKS_PER_SM = 4        # blocks a multiprocessor should have to choose from
SPLIT_MIN_M = 8192       # dst slots above which few blocks split their sweep
SPLIT_SLICES = 64
CLUSTER_SIZES = (1, 2, 4, 8)   # dst slices of a cluster split: one cluster
SPLITS = ("none", "atomic", "cluster")     # the C entry's split codes
CLUSTER_CHUNK = 256      # dst points a chunk of a cluster's sweep, at most
CLUSTER_MIN_POINTS = 64  # dst points a rank of a cluster should have
# the scratch of a split sweep starts at (1e30f, 0): float bits << 32 | index
_NONE_KEY = int(struct.unpack("<I", struct.pack("<f", 1e30))[0]) << 32

# Peak rates of one H100 SXM (NVIDIA's data sheet): 67 TFLOP/s of float32
# outside the tensor cores counts an FMA as two operations; this kernel
# contracts none, so it does at most half that many lane-operations.
FP32_LANE_OPS_PER_S = 33.5e12
HBM_BYTES_PER_S = 3.35e12

# the C entry's arguments: src, dst, dst_mask, src_mask; b, n, m, form,
# points, split, slices, span; out, dist, keys, stream
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 4

on_launch = None         # callable(name, src, dst, dst_mask, src_mask, plan)
_entry = None            # icpflow_masked_nn, bound at the first launch


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def kernel_name(form: str, points: bool) -> str:
    return f"nn_{form}_{'points' if points else 'index'}"


def candidate_ops(form: str, points: bool) -> int:
    """FP32 lane-operations one (src, dst) candidate needs: 8 for the
    distance in any form and one to fold it into the running minimum (the
    index is resolved only where the minimum changes); the sentinel form's
    points output adds its tie compare (``csrc/nn_kernel.cu``)."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    return 10 if form == "sentinel" and points else 9


def bound_ms(valid_pairs: float, form: str, points: bool) -> float:
    """Least milliseconds one H100 could take for a sweep over
    ``valid_pairs`` (src, dst) candidates: their FP32 operations, none of
    them contracted into an FMA, at the card's peak FP32 rate. That rate
    bounds the kernel, not bytes (:func:`io_ms` is far smaller at every
    shape in use). The masked forms need only pairs of a valid src and a
    valid dst; the sentinel forms keep every dst a candidate."""
    return candidate_ops(form, points) * valid_pairs / FP32_LANE_OPS_PER_S * 1e3


def io_ms(b: int, n: int, m: int, points: bool, src_mask: bool = False) -> float:
    """Milliseconds to move one launch's bytes at the card's memory rate:
    src, dst and the masks read once, the outputs written once."""
    nbytes = b * (12 * n + 13 * m + (n if src_mask else 0)
                  + (12 if points else 4) * n + 4 * n)
    return nbytes / HBM_BYTES_PER_S * 1e3


def split_kind(form: str, points: bool, m: int) -> str:
    """How a launch that splits dst merges its slices: "atomic" (a scratch
    buffer of packed keys, ``atomicMin``, a finish pass) for an index sweep
    over more than ``SPLIT_MIN_M`` dst slots in a form whose d2 is never
    negative, "cluster" (one thread-block cluster a block of src points,
    merged through its shared memory inside the one launch) otherwise."""
    if not points and form != "expanded" and m > SPLIT_MIN_M:
        return "atomic"
    return "cluster"


@functools.lru_cache(maxsize=4096)
def launch_plan(b: int, n: int, m: int, form: str, points: bool,
                sms: int) -> int:
    """dst slices of one launch on a card with ``sms`` multiprocessors.

    A block covers ``THREADS`` src points of one batch row. A grid of
    ``BLOCKS_PER_SM`` blocks a multiprocessor runs in one pass.

    A smaller grid splits dst, by :func:`split_kind`. The matcher's sweeps
    (either output, any form, ``m <= SPLIT_MIN_M``: few rows of a cluster
    bucket) split it over one thread-block cluster per block of src points:
    the smallest of :data:`CLUSTER_SIZES` that fills the card, or the
    largest that leaves every rank ``CLUSTER_MIN_POINTS`` dst points where
    none does (the 512-point buckets are cut into 8 parts of 64 points,
    which measured about half the one-pass time, ``PERF.md``).
    :func:`cluster_span` gives the chunk length.

    A long index sweep by few blocks (the odometry's: one batch row against
    a map of ``m > SPLIT_MIN_M`` slots) spreads dst over ``SPLIT_SLICES``
    blocks (at most one per chunk) merged by ``atomicMin``. That is far more
    blocks than one pass wants, because blocks of masked-out src points and
    slices of padding leave at once, and what is left should still fill the
    card. That split costs a scratch fill and a finish pass, which a short
    sweep does not earn back."""
    blocks = b * -(-n // THREADS)
    full = BLOCKS_PER_SM * sms
    if blocks >= full:
        return 1
    if split_kind(form, points, m) == "atomic":
        return min(-(-m // CHUNK), SPLIT_SLICES)
    sizes = [s for s in CLUSTER_SIZES
             if s == 1 or s * CLUSTER_MIN_POINTS <= m]
    return next((s for s in sizes if blocks * s >= full), sizes[-1])


def check_plan(form: str, points: bool, slices: int | None,
               split: str | None) -> None:
    """Raise ``ValueError`` for a launch override that has no
    instantiation: see :func:`masked_nn_cuda`."""
    name = kernel_name(form, points)
    if split is not None and split not in SPLITS[1:]:
        raise ValueError(f"split must be one of {SPLITS[1:]}, got {split!r}")
    if slices is not None and slices < 1:
        raise ValueError(f"slices must be at least 1, got {slices}")
    if split == "atomic" and (points or form == "expanded"):
        raise ValueError(f"{name} has no atomic split (a points output, or "
                         "a d2 that can be negative): it splits dst over a "
                         "cluster")
    if split == "cluster" and slices is not None \
            and slices not in CLUSTER_SIZES:
        raise ValueError(f"{name} splits dst over a cluster of "
                         f"{CLUSTER_SIZES} blocks, not {slices}")


def cluster_span(m: int, slices: int) -> int:
    """dst points a chunk of a sweep that a cluster of ``slices`` blocks
    splits (rank z takes chunks z, z + slices, ...): dst cut into ``slices``
    parts of a multiple of 8 points (the sentinel form's tie rule reads
    j mod 8 from the position in the chunk), and a part into chunks of at
    most ``CLUSTER_CHUNK``. Chunks shorter than the one-pass sweep's spread
    a valid prefix of dst over the ranks. Rank r of every cluster lands on
    the same multiprocessors, so with 512-point chunks and half of a
    4096-slot dst valid, four ranks of every cluster idle and half of the
    card with them; 256-point chunks cost a few percent where all of dst is
    valid and save a third there (``PERF.md``)."""
    if slices == 1:
        return CHUNK
    return min(CLUSTER_CHUNK, -(-m // (8 * slices)) * 8)


def masked_nn_cuda(src: torch.Tensor, dst: torch.Tensor,
                   dst_mask: torch.Tensor, *, form: str, points: bool,
                   src_mask: torch.Tensor | None = None,
                   slices: int | None = None, split: str | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel. Returns (idx (B,N) int32 | pts (B,N,3) f32,
    dist (B,N) f32).

    ``form`` is one of :data:`FORMS` (see ``ops/knn.py``). src (B,N,3) and
    dst (B,M,3) float32, dst_mask (B,M) bool and, where given, src_mask
    (B,N) bool, all contiguous on one CUDA device. Anything else raises
    ``ValueError``. A src point that ``src_mask`` marks False is not swept:
    it gets idx 0, dist 1e15 and the point (0,0,0).

    ``slices`` >= 1 and ``split`` ("atomic" or "cluster") override
    :func:`launch_plan` and :func:`split_kind` (tests and tuning); the result
    does not depend on them. A cluster split takes one of
    :data:`CLUSTER_SIZES` slices, either output, any form. The atomic split
    exists for the index output of the elementwise and sentinel forms only;
    anything else raises ``ValueError``.
    """
    global _entry
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    check_plan(form, points, slices, split)
    tensors = [("src", src, torch.float32), ("dst", dst, torch.float32),
               ("dst_mask", dst_mask, torch.bool)]
    if src_mask is not None:
        tensors.append(("src_mask", src_mask, torch.bool))
    for name, t, dt in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != src.device:
            raise ValueError("src, dst and the masks must share one device")
    if src.dim() != 3 or src.shape[2] != 3 or dst.dim() != 3 \
            or dst.shape[2] != 3 or dst.shape[0] != src.shape[0] \
            or tuple(dst_mask.shape) != tuple(dst.shape[:2]) \
            or (src_mask is not None
                and tuple(src_mask.shape) != tuple(src.shape[:2])):
        raise ValueError(
            f"bad shapes src {tuple(src.shape)} dst {tuple(dst.shape)} mask "
            f"{tuple(dst_mask.shape)} src_mask "
            f"{None if src_mask is None else tuple(src_mask.shape)}")
    b, n, _ = src.shape
    m = dst.shape[1]
    if m < 1:
        raise ValueError("dst must hold at least one point")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the grid's y limit 65535")
    for v in (b * n * 3, b * m * 3):
        if v >= 2 ** 31:
            raise ValueError("tensor too large for int32 sizes")
    dist = torch.empty((b, n), dtype=torch.float32, device=src.device)
    if points:
        out = torch.empty((b, n, 3), dtype=torch.float32, device=src.device)
    else:
        out = torch.empty((b, n), dtype=torch.int32, device=src.device)
    if b == 0 or n == 0:
        return out, dist
    if _entry is None:
        _entry = library.bind("icpflow_masked_nn", ARGTYPES)
    if split is None:
        split = split_kind(form, points, m)
    if slices is None:
        slices = launch_plan(b, n, m, form, points, _sm_count(src.device))
    check_plan(form, points, slices, split)     # the two as resolved
    if slices == 1:
        split = "none"
    keys = None
    if split == "atomic":
        keys = torch.full((b, n), _NONE_KEY, dtype=torch.int64,
                          device=src.device)
    name = kernel_name(form, points)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = _entry(
            src.data_ptr(), dst.data_ptr(), dst_mask.data_ptr(),
            None if src_mask is None else src_mask.data_ptr(), b, n, m,
            FORMS.index(form), int(points), SPLITS.index(split), slices,
            cluster_span(m, slices), out.data_ptr(), dist.data_ptr(),
            None if keys is None else keys.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"masked_nn kernel launch failed: cudaError {err}")
    _trace.launch(name, (b, n, m))
    if on_launch is not None:
        on_launch(name, src, dst, dst_mask, src_mask, (slices, split))
    return out, dist

