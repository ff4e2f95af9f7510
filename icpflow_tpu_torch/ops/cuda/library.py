"""Build and load the port's kernel library: every ``csrc/*.cu``.

The library holds the NN sweep (``ops/cuda/nn_kernel.py``), Kabsch's solve
(``ops/cuda/kabsch.py``) and an empty kernel (:func:`launch_floor`). It is
compiled with one ``nvcc`` call at first use, from the sources in this
checkout, into ``icpflow_tpu_torch/build/`` (git-ignored), under a name
keyed by a hash of the sources and the flags, and loaded with ``ctypes``.
Each wrapper binds its own symbol (:func:`bind`) at its first launch.
Nothing here runs at import: the module imports on a machine without CUDA.
"""

from __future__ import annotations

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
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

build_seconds = None     # wall seconds of the last nvcc build (None: cached)
build_log = ""           # what that build printed: ptxas -v, per kernel
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


def sources() -> list:
    """Every CUDA source of the library, in name order."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libicpflow_cuda_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> pathlib.Path:
    """Compile the kernel library (every source, one nvcc call) unless an
    up-to-date one exists.

    Raises ``RuntimeError`` with the compiler's output if nvcc fails.
    """
    global build_seconds, build_log
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
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              env=dict(os.environ, TMPDIR=work))
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        build_log = proc.stderr
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
        lib.icpflow_launch_floor.argtypes = [ctypes.c_void_p]
        lib.icpflow_launch_floor.restype = ctypes.c_int
        _lib = lib
    return _lib


def bind(symbol: str, argtypes: list):
    """The library's C entry ``symbol`` with its arguments declared; it
    returns a ``cudaError_t`` as an int. A wrapper binds its entry once, at
    its first launch."""
    fn = getattr(load(), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch_floor() -> None:
    """Launch the library's empty kernel on the current stream: what any
    launch costs on this card. A measuring script times it beside the
    sweeps; it is no kernel of the port's paths and is not counted."""
    err = load().icpflow_launch_floor(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError {err}")
