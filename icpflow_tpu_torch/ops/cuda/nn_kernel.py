"""Build, bind and launch the Hopper NN kernel (``csrc/nn_kernel.cu``).

The kernel library is compiled with ``nvcc`` at first use, from the source
in this checkout, into ``icpflow_tpu_torch/build/`` (git-ignored), under a
name keyed by a hash of the source and the flags, and loaded with
``ctypes``. Nothing here runs at import: the module imports on a machine
without CUDA.

``launches`` counts kernel launches made through :func:`masked_nn_cuda`,
and ``variant_launches`` counts them per instantiation
(``nn_{expanded|elementwise|sentinel}_{index|points}``). Set them to 0
before a run and read them after, to show the run went through the kernel.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "nn_kernel.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

FORMS = ("expanded", "elementwise", "sentinel")   # the C entry's form codes

launches = 0
variant_launches: collections.Counter = collections.Counter()
build_seconds = None     # wall seconds of the last nvcc build (None: cached)
_lib = None


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libicpflow_nn_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> pathlib.Path:
    """Compile the kernel library unless an up-to-date one exists.

    Raises ``RuntimeError`` with the compiler's output if nvcc fails.
    """
    global build_seconds
    out = library_path()
    if out.exists() and not force:
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    # nvcc names its intermediate files after its pid and the source's name;
    # a private TMPDIR keeps a concurrent build (another checkout, another
    # pid namespace over the same TMPDIR) from overwriting them
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              env=dict(os.environ, TMPDIR=work))
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
        shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.icpflow_masked_nn
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_name(form: str, points: bool) -> str:
    return f"nn_{form}_{'points' if points else 'index'}"


def masked_nn_cuda(src: torch.Tensor, dst: torch.Tensor,
                   dst_mask: torch.Tensor, *, form: str,
                   points: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel. Returns (idx (B,N) int32 | pts (B,N,3) f32,
    dist (B,N) f32).

    ``form`` is one of :data:`FORMS` (see ``ops/knn.py``). src (B,N,3) and
    dst (B,M,3) float32, dst_mask (B,M) bool, all contiguous on one CUDA
    device. Anything else raises ``ValueError``.
    """
    global launches
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    for name, t, dt in (("src", src, torch.float32), ("dst", dst, torch.float32),
                        ("dst_mask", dst_mask, torch.bool)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if src.device != dst.device or dst.device != dst_mask.device:
        raise ValueError("src, dst and dst_mask must share one device")
    if src.dim() != 3 or src.shape[2] != 3 or dst.dim() != 3 \
            or dst.shape[2] != 3 or dst.shape[0] != src.shape[0] \
            or tuple(dst_mask.shape) != tuple(dst.shape[:2]):
        raise ValueError(f"bad shapes src {tuple(src.shape)} dst "
                         f"{tuple(dst.shape)} mask {tuple(dst_mask.shape)}")
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
    lib = load()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.icpflow_masked_nn(
            src.data_ptr(), dst.data_ptr(), dst_mask.data_ptr(), b, n, m,
            FORMS.index(form), int(points), out.data_ptr(), dist.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"masked_nn kernel launch failed: cudaError {err}")
    launches += 1
    variant_launches[kernel_name(form, points)] += 1
    return out, dist
