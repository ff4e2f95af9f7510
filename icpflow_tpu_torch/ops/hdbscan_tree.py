"""Build and load HDBSCAN's host tree: ``csrc/hdbscan_tree.cc``.

The tree (Kruskal dendrogram, condensed tree, excess-of-mass selection,
labels) runs on the host, after the device has built the kNN
mutual-reachability graph. It is compiled with the host's C++ compiler at
first use, into ``icpflow_tpu_torch/build/`` (git-ignored), under a name
keyed by a hash of the source, the flags and the compiler's version, so
that a checkout never loads a library older than its source or built by
another compiler; and loaded with ``ctypes``. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

from .cuda.library import BUILD_DIR, CSRC

SOURCE = CSRC / "hdbscan_tree.cc"
# no -march=native: the library may be built on one host and loaded on
# another; no contraction into FMAs: the stability sums round as written
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def compiler() -> Optional[str]:
    """The host's C++ compiler: $CXX, then ``g++``, then ``c++``."""
    for c in (os.environ.get("CXX"), "g++", "c++"):
        if c and shutil.which(c):
            return shutil.which(c)
    return None


def library_path(cxx: str):
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(subprocess.run([cxx, "--version"], capture_output=True,
                            text=True, timeout=30).stdout.encode())
    return BUILD_DIR / f"libicpflow_hdbscan_{h.hexdigest()[:16]}.so"


def build():
    """The library's path, compiled first unless an up-to-date one exists.
    Raises ``RuntimeError`` with the compiler's output if it fails."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler ($CXX, g++, c++) on PATH")
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built once a process if needed; None where it
    cannot be built or loaded (``ops/hdbscan.py`` then falls back to
    DBSCAN, as the JAX package does without its native library)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.icpflow_hdbscan_labels.restype = ctypes.c_int64
    lib.icpflow_hdbscan_labels.argtypes = [
        i32p, f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i32p]
    lib.icpflow_hdbscan_labels_weighted.restype = ctypes.c_int64
    lib.icpflow_hdbscan_labels_weighted.argtypes = [
        i32p, f32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        i32p]
    _lib = lib
    return _lib
