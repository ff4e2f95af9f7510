"""Seeded samples in PCAccumulation's npz format in the vehicle frame, as
its Waymo split holds them (ICP-Flow ``dataset_pca.py:30-113``): the ground
near z = 0, where ``pca_samples.py`` writes sensor-frame sweeps with the
ground near -1.9 m, as nuScenes has them.

A sample is ``pca_samples.sample``'s, with every sweep's ``raw_points``
lifted by ``lift_z`` along z. The ego poses are translations in the plane
and every instance motion turns about z alone, so each commutes with the
lift: the ground-truth flow that the loader rebuilds from the poses is the
unlifted sample's, and the poses are written unchanged.

A mix (``traffic/<name>.json``) holds what ``pca_samples.py`` reads, with
``generator`` ``"pca_vehicle"`` and ``lift_z``, the metres added to every
point's z.
"""

from __future__ import annotations

import numpy as np

from benchmark.traffic import pca_samples


def lifted(arrays: dict, lift_z: float) -> dict:
    """The sample with ``lift_z`` added to every point's z; the other
    arrays as they are."""
    raw = arrays["raw_points"].copy()
    raw[:, 2] += np.float32(lift_z)
    return dict(arrays, raw_points=raw)


def make(mix: dict, seed: int) -> list:
    """``pca_samples.make``'s samples from ``seed``, each lifted by the
    mix's ``lift_z`` and its ``.npz`` written anew: a list of ``{"path",
    "arrays"}``. The lift moves z alone, so ``pca_samples.make``'s check
    of each sweep against ``max_points`` inside the x/y crop holds for the
    lifted sweep."""
    items = pca_samples.make(mix, seed)
    for item in items:
        item["arrays"] = lifted(item["arrays"], float(mix["lift_z"]))
        with open(item["path"], "wb") as f:
            np.savez_compressed(f, **item["arrays"])
    return items
