"""The traffic generator: the same seed gives the same inputs, every
cloud fits its bucket, and the seed changes the noise, not the work."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.manifest import Manifest

BIG_SEED = 2 ** 31 + 12345


def _items(mix_name, seed):
    man = Manifest()
    mix = man.mix(mix_name)
    return mix, man.generator(mix).make(mix, seed)


def _clouds(items):
    return [c for it in items for c in it]


@pytest.mark.parametrize("mix_name", ["dense", "sparse", "sessions16"])
def test_same_seed_same_inputs(mix_name):
    _, a = _items(mix_name, BIG_SEED)
    _, b = _items(mix_name, BIG_SEED)
    for x, y in zip(_clouds(a), _clouds(b), strict=True):
        assert x.dtype == np.float32 and np.array_equal(x, y)


@pytest.mark.parametrize("mix_name", ["dense", "sparse", "sessions16"])
def test_every_cloud_fits_the_bucket(mix_name):
    mix, items = _items(mix_name, 3)
    assert all(len(c) <= mix["max_points"] for c in _clouds(items))


def test_dense_frames_stay_within_the_scene_bucket():
    for seed in (0, 1, BIG_SEED):
        _, items = _items("dense", seed)
        sizes = [len(c) for c in _clouds(items)]
        assert max(sizes) <= 131072
        assert min(sizes) > 100_000          # dense: well above sparse


def test_another_seed_changes_noise_and_order_not_the_work():
    _, a = _items("dense", 1)
    _, b = _items("dense", 2)
    assert not np.array_equal(a[0][0], b[0][0]) or \
        not np.array_equal(a[1][0], b[1][0])
    sa = sorted(len(c) for c in _clouds(a))
    sb = sorted(len(c) for c in _clouds(b))
    assert abs(sum(sa) - sum(sb)) / sum(sa) < 0.05


def test_negative_and_huge_seeds_are_taken():
    for seed in (-1, 2 ** 40 + 3):
        _items("sparse", seed)


def test_sessions_are_raw_scans_with_ground():
    mix, items = _items("sessions16", 5)
    assert len(items) == mix["sessions"]
    assert all(len(s) == mix["frames"] for s in items)
    # raw sensor-frame scans keep the ground rings at about -1.9 m
    assert (items[0][0][:, 2] < -1.8).sum() > 5000
