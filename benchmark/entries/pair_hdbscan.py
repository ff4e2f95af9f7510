"""``pair_hdbscan``: ``pair``'s call, ``run_frame_pair`` one frame pair a
call, on a configuration with ``use_hdbscan``; its reference clusters with
``reference/hdbscan.py``.

The reference's tree takes the graph's edges in a total order (weight,
source row, destination), so its labels are a function of the edge set. A
program whose tree takes tied edges in another order gives other labels,
which no reference reproduces: before set-up the entry holds the
program's clusterer to the reference's on one joint cloud of the mix,
thinned, from a fixed seed, and refuses a program that differs there,
rather than run a window whose comparison fails.

A traced run adds one harness span, ``hdbscan_graph``, around the exact
kNN graph (``ops/cluster.py: exact_knn_mutual_reachability``), so that
the profile's idle gaps show the device's idle time inside it
(``layers/hdbscan_graph_roofline.pair.py``)."""

from __future__ import annotations

import contextlib

import numpy as np

from benchmark.entries._shared import span
from benchmark.entries.pair import Entry as PairEntry

CHECK_SEED = 20240611
CHECK_THIN = 8      # the dense mix: ~28k points a joint cloud, ties by the
                    # thousand
GRAPH = "exact_knn_mutual_reachability"


class Entry(PairEntry):
    """Frame pairs through ``run_frame_pair`` under ``use_hdbscan``."""

    def __init__(self, conf: dict, mix: dict, device: str):
        if not conf["pipeline"].get("use_hdbscan"):
            raise ValueError("pair_hdbscan runs configurations with "
                             "use_hdbscan")
        super().__init__(conf, mix, device)
        self._check_clusterer(conf, mix, device)

    def _check_clusterer(self, conf, mix, device):
        import torch

        from benchmark.reference.hdbscan import HdbscanReference
        from benchmark.traffic import scenes
        thin = max(CHECK_THIN, int(mix.get("thin", 1)))
        src, dst = scenes.make(dict(mix, scenes=1, thin=thin),
                               CHECK_SEED)[0]
        ones = [np.ones(len(c), bool) for c in (dst, src)]
        got = torch.cat(self.engine.cluster_joint(dst, ones[0], src,
                                                  ones[1])).cpu().numpy()
        ref = HdbscanReference(conf["pipeline"], device)
        want = ref.labels(ref.tensor(np.concatenate([dst, src]),
                                     torch.float32),
                          ref.tensor(np.concatenate(ones), torch.bool))
        moved = int((got != want.cpu().numpy()).sum())
        if moved:
            raise RuntimeError(
                f"the program's HDBSCAN labels differ from the reference's "
                f"at {moved} of {len(got)} points of a thinned cloud of the "
                "mix: its tree does not take tied edges in the order "
                "(weight, source row, destination)")

    @contextlib.contextmanager
    def spans(self):
        """``pair``'s harness spans, and ``hdbscan_graph`` around the exact
        kNN graph where the program has it."""
        from icpflow_tpu_torch.ops import cluster
        graph = getattr(cluster, GRAPH, None)
        with super().spans():
            if graph is not None:
                setattr(cluster, GRAPH, span("hdbscan_graph", graph))
            try:
                yield
            finally:
                if graph is not None:
                    setattr(cluster, GRAPH, graph)

    @staticmethod
    def reference(ref, mix, items, keys) -> dict:
        """The reference's output for each key, clustered by
        ``reference/hdbscan.py``."""
        from benchmark.reference.hdbscan import HdbscanReference
        return PairEntry.reference(
            HdbscanReference(dict(vars(ref.cfg)), ref.device), mix, items,
            keys)
