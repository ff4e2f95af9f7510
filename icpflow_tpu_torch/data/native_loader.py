"""ctypes bindings for the native host data plane (native/libicpflow_host.so).

Provides (with transparent numpy fallback when the library is absent):
  * ``load_npz(path)`` — C++ npz decode (ZIP walk + zlib inflate + npy parse);
  * ``PrefetchPool(paths, workers)`` — threaded in-order sample prefetch that
    overlaps host IO/decode with device compute (the native equivalent of the
    reference's DataLoader worker processes, `main.py:160-171`);
  * ``crop_pad(points, range_x, range_y, cap)`` — fused crop+pad into the
    fixed scene bucket;
  * ``decoder()`` — which of the two decodes: ``"native"`` or ``"numpy"``.

A copy of ``icpflow_tpu/data/native_loader.py`` (which cannot be imported
without JAX); both packages load the same ``native/libicpflow_host.so``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, List, Optional

import numpy as np

_DTYPES = {0: np.float32, 1: np.float64, 2: np.int64, 3: np.int32,
           4: np.uint8, 5: np.int8, 6: np.uint64, 7: np.bool_}

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def get_lib(build_if_missing: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building once if needed) the native library; None on failure."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.join(_repo_root(), "native", "libicpflow_host.so")
    if not os.path.exists(so) and build_if_missing:
        try:
            subprocess.run(["make", "-C", os.path.dirname(so)],
                           check=True, capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.ifh_npz_open.restype = ctypes.c_void_p
    lib.ifh_npz_open.argtypes = [ctypes.c_char_p]
    lib.ifh_npz_num_arrays.restype = ctypes.c_int
    lib.ifh_npz_num_arrays.argtypes = [ctypes.c_void_p]
    lib.ifh_npz_name.restype = ctypes.c_char_p
    lib.ifh_npz_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ifh_npz_info.restype = ctypes.c_int
    lib.ifh_npz_info.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64)]
    lib.ifh_npz_read.restype = ctypes.c_int64
    lib.ifh_npz_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_void_p, ctypes.c_int64]
    lib.ifh_npz_close.argtypes = [ctypes.c_void_p]
    lib.ifh_crop_pad.restype = ctypes.c_int64
    lib.ifh_crop_pad.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ctypes.c_float, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.ifh_prefetch_create.restype = ctypes.c_void_p
    lib.ifh_prefetch_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.ifh_prefetch_next.restype = ctypes.c_void_p
    lib.ifh_prefetch_next.argtypes = [ctypes.c_void_p]
    lib.ifh_prefetch_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def decoder() -> str:
    """The npz decoder in use: ``"native"`` (the C++ library loaded, built
    first if it was missing) or ``"numpy"`` (no library on this host)."""
    return "numpy" if get_lib() is None else "native"


def _npz_handle_to_dict(lib, h) -> Dict[str, np.ndarray]:
    out = {}
    n = lib.ifh_npz_num_arrays(h)
    for i in range(n):
        name = lib.ifh_npz_name(h, i).decode()
        dtype = ctypes.c_int()
        ndim = ctypes.c_int()
        shape = (ctypes.c_int64 * 8)()
        if lib.ifh_npz_info(h, name.encode(), ctypes.byref(dtype),
                            ctypes.byref(ndim), shape) != 0:
            continue
        shp = tuple(shape[j] for j in range(ndim.value))
        arr = np.empty(shp, dtype=_DTYPES[dtype.value])
        got = lib.ifh_npz_read(h, name.encode(),
                               arr.ctypes.data_as(ctypes.c_void_p),
                               arr.nbytes)
        if got == arr.nbytes:
            out[name] = arr
    return out


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """npz -> dict of arrays via the native reader (numpy fallback)."""
    lib = get_lib()
    if lib is None:
        return dict(np.load(path, allow_pickle=True))
    h = lib.ifh_npz_open(path.encode())
    if not h:
        return dict(np.load(path, allow_pickle=True))
    try:
        return _npz_handle_to_dict(lib, h)
    finally:
        lib.ifh_npz_close(h)


def crop_pad(points: np.ndarray, range_x: float, range_y: float, cap: int):
    """Fused crop+pad; returns (padded (cap,3) f32, valid (cap,), n_kept)."""
    lib = get_lib()
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    if lib is None:
        keep = np.logical_and(np.abs(pts[:, 0]) < range_x,
                              np.abs(pts[:, 1]) < range_y)
        kept = pts[keep][:cap]
        out = np.zeros((cap, 3), np.float32)
        out[: len(kept)] = kept
        valid = np.zeros((cap,), bool)
        valid[: len(kept)] = True
        return out, valid, len(kept)
    out = np.empty((cap, 3), np.float32)
    valid = np.empty((cap,), np.uint8)
    k = lib.ifh_crop_pad(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pts),
        range_x, range_y,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    return out, valid.astype(bool), int(k)


class PrefetchPool:
    """In-order threaded npz prefetch over a list of sample paths."""

    def __init__(self, paths: List[str], workers: int = 4, depth: int = 4):
        self.paths = list(paths)
        self._lib = get_lib()
        self._pool = None
        self._idx = 0
        if self._lib is not None and self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._keepalive = arr
            self._pool = self._lib.ifh_prefetch_create(
                arr, len(self.paths), workers, depth)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._pool is None:                     # numpy fallback
            if self._idx >= len(self.paths):
                raise StopIteration
            path = self.paths[self._idx]
            self._idx += 1
            return dict(np.load(path, allow_pickle=True))
        h = self._lib.ifh_prefetch_next(self._pool)
        if not h:
            raise StopIteration
        try:
            return _npz_handle_to_dict(self._lib, h)
        finally:
            self._lib.ifh_npz_close(h)

    def close(self):
        if self._pool is not None:
            self._lib.ifh_prefetch_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
