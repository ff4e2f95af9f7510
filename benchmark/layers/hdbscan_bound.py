"""The bound of hdbscan's exact kNN graph, copied from ``chip_smoke.py``
(``GRAPH_OPS_PER_PAIR``, ``_graph_bound``) so that the yardstick stays where
it is when the program moves, with the H100's peaks from ``nn_bound.py``.

The work is counted from the graph's rows alone (counter
``hdbscan_rows``: representatives on the ``dedup`` path, valid points on
``full``), whatever computes the graph: every row against every other
row."""

from __future__ import annotations

from benchmark.layers import nn_bound

# lane-operations a (point, candidate) pair of the graph needs: nine for d2
# (three multiplies and two adds for p.q, one multiply by -2, two adds of
# the norms and the exclusion select) and one compare of the top-k merge
# against the running k-th
GRAPH_OPS_PER_PAIR = 10
# neighbours a row keeps: min(min_cluster_size, 30) at the configurations'
# min_cluster_size of 20
K = 20


def graph_bound(pairs: float, nbytes: float):
    """(bound ms, what bounds it): the larger of the graph's
    lane-operations at the card's peak FP32 rate (no FMA) and its bytes,
    inputs read once and outputs written once, at the memory rate."""
    ops = pairs * GRAPH_OPS_PER_PAIR / nn_bound.FP32_LANE_OPS_PER_S * 1e3
    io = nbytes / nn_bound.HBM_BYTES_PER_S * 1e3
    return max(ops, io), "operations" if ops >= io else "bytes"


def bound_ms(rows: float, k: int = K) -> float:
    """Least milliseconds one H100 could take for the graph over ``rows``
    rows: rows * (rows - 1) pairs; points, masks and multiplicities in,
    core distances and k edges a row out."""
    return graph_bound(float(rows) * (rows - 1),
                       rows * (12 + 1 + 8 + 4 + 8 * k))[0]
