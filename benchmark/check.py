"""How ``correct`` is decided: each output the timed path produced is held
against the reference's output for the same input, and each number below
is held to the limit that the cell's ``limits/<cell>.json`` states.

Numbers (the worst over the compared outputs):

* ``flow_gap_m``: the widest distance between a point's flow and the
  reference's, in metres;
* ``transform_gap``: the largest absolute difference between an entry of a
  source label's 4x4 transform and the reference's (frame pairs);
* ``pose_gap``: the same for the ego pose of a stream frame;
* ``pairs_diff``: matched (source label, destination label) pairs found on
  one side only;
* ``stats_gap``: the largest absolute difference in the pairs table's
  statistics (error, inlier, ratio, IoU) of pairs matched on both sides;
* ``label_mismatch``: the share of points whose cluster disagrees with the
  reference's, labels matched by their largest overlap, either way round.

A missing output where the reference has one, or the reverse, reads as
infinitely far off.
"""

from __future__ import annotations

import numpy as np

_FAR = 1e30          # "infinitely far off", finite so that JSON can hold it


def label_mismatch(a: np.ndarray, b: np.ndarray) -> float:
    """Share of points outside the largest overlap of their label, taking
    the worse of the two directions (0 when the partitions are equal up to
    a renaming of the labels)."""
    a = np.asarray(a, np.int64).ravel()
    b = np.asarray(b, np.int64).ravel()
    if a.shape != b.shape:
        return _FAR
    if a.size == 0:
        return 0.0
    _, ia = np.unique(a, return_inverse=True)
    _, ib = np.unique(b, return_inverse=True)
    joint, counts = np.unique(ia * (int(ib.max()) + 1) + ib,
                              return_counts=True)
    ka, kb = joint // (int(ib.max()) + 1), joint % (int(ib.max()) + 1)
    best_a = np.zeros(int(ia.max()) + 1, np.int64)
    np.maximum.at(best_a, ka, counts)
    best_b = np.zeros(int(ib.max()) + 1, np.int64)
    np.maximum.at(best_b, kb, counts)
    agree = min(best_a.sum(), best_b.sum())
    return float(1.0 - agree / a.size)


def _pairs(table: np.ndarray) -> dict:
    t = np.asarray(table, np.float64).reshape(-1, 10)
    return {(int(r[0]), int(r[1])): r[2:] for r in t}


def _max_abs(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return _FAR
    if a.size == 0:
        return 0.0
    d = np.abs(a - b)
    return float(np.nan_to_num(d, nan=_FAR).max())


def compare(out, ref) -> dict:
    """The numbers of one output against the reference's. Both are dicts
    of host arrays, or None (a stream's first frame)."""
    if out is None or ref is None:
        far = 0.0 if out is None and ref is None else _FAR
        return {"flow_gap_m": far, "pairs_diff": far, "label_mismatch": far}
    res = {}
    if out["flow"].shape != ref["flow"].shape:
        res["flow_gap_m"] = _FAR
    else:
        d = np.linalg.norm(np.asarray(out["flow"], np.float64)
                           - np.asarray(ref["flow"], np.float64), axis=1)
        res["flow_gap_m"] = float(np.nan_to_num(d, nan=_FAR).max()) \
            if d.size else 0.0
    if "transforms" in ref:
        res["transform_gap"] = _max_abs(out["transforms"], ref["transforms"])
    if "pose" in ref:
        res["pose_gap"] = _max_abs(out["pose"], ref["pose"])
    po, pr = _pairs(out["pairs"]), _pairs(ref["pairs"])
    res["pairs_diff"] = float(len(set(po) ^ set(pr)))
    common = set(po) & set(pr)
    res["stats_gap"] = max((_max_abs(po[k], pr[k]) for k in common),
                           default=0.0)
    labels = [k for k in ("labels_src", "labels_dst", "labels") if k in ref]
    res["label_mismatch"] = max(label_mismatch(out[k], ref[k])
                                for k in labels)
    return res


def worst(rows) -> dict:
    """The largest reading of each number over many comparisons."""
    out: dict = {}
    for row in rows:
        for k, v in row.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def judge(rows, limits: dict):
    """(numbers, failed): the worst reading of each limited number, and how
    many comparisons broke some limit."""
    numbers = worst(rows)
    failed = sum(1 for row in rows
                 if any(row.get(k, 0.0) > lim for k, lim in limits.items()))
    return {k: numbers.get(k, 0.0) for k in limits}, failed
