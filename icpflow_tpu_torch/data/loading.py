"""Host-side loading helpers.

Numpy equivalents of `utils_loading.py:11-48`: natural sort keys, GT ego
compensation and GT sequence reconstruction via per-instance transforms.
A copy of ``icpflow_tpu/data/loading.py`` (which cannot be imported without
JAX).
"""

from __future__ import annotations

import re

import numpy as np


def natural_key(s: str):
    """Sort strings by embedded numbers. Ref utils_loading.py:11-15."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def ego_motion_compensation(points, time_indice, tsfm):
    """Apply per-frame ego pose to each point. Ref utils_loading.py:21-31."""
    T = tsfm[time_indice.astype(int)]
    return np.einsum("nij,nj->ni", T[:, :3, :3], points[:, :3]) + T[:, :3, 3]


def reconstruct_sequence(points, time_indice, inst_labels, tsfm, n_frames):
    """Apply per-(instance, frame) transforms. Ref utils_loading.py:33-48."""
    assert n_frames == tsfm.shape[1]
    idx = (inst_labels * n_frames + time_indice).astype(int)
    T = tsfm.reshape(-1, 4, 4)[idx]
    return np.einsum("nij,nj->ni", T[:, :3, :3], points[:, :3]) + T[:, :3, 3]


class PrefetchIterMixin:
    """Prefetched sample iteration for the dataset classes.

    The reference overlaps preprocessing with GPU compute via DataLoader
    worker processes (`main.py:160-171`); here the native PrefetchPool
    (`native/npz_reader.cc`) decodes npz samples on background threads while
    the device runs the previous sample's matcher, and the Python side does
    crop/GT/cluster work on the decoded dict. Datasets provide
    ``_raw_from_dict(d, path)``, ``_prepare(data, clock)``, ``device`` and
    ``timings``.
    """

    def iter_samples(self, indices=None, workers: int = 4, depth: int = 4):
        """Yield (global_idx, data, pairs) with host decode prefetched.
        ``self.timings``, when a dict, receives the ``load`` milliseconds
        of each sample beside the stages ``_prepare`` times."""
        from ..device import StageClock
        from .native_loader import PrefetchPool

        if indices is None:
            indices = range(len(self.seq_paths))
        indices = list(indices)
        paths = [self.seq_paths[i] for i in indices]
        pool = PrefetchPool(paths, workers=workers, depth=depth)
        try:
            for k in indices:
                clock = StageClock(self.timings, self.device)
                clock.mark("load")
                d = next(pool, None)
                if d is None:
                    break
                data = self._raw_from_dict(d, self.seq_paths[k])
                yield (k,) + self._prepare(data, clock)
        finally:
            pool.close()
