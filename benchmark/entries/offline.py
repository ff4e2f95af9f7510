"""``offline``: ``icpflow_tpu_torch.cli.run_sample``, one PCA-format sample
a call, read back from its ``.npz`` by ``DatasetPCA``'s loader, prepared
(stateful ground over its sweeps, GT poses, joint clustering of each frame
with frame 0), matched at gaps 1 to n-1 and scored, as ``cli.run`` does
for each sample of a dataset. A call completes n-1 frame pairs and leaves
one trace record, root span ``icpflow.sample``.

The output stacks the sample's frame pairs for ``check.compare``: the
sample's flow (frame 0's zeros first, as ``--if_save`` writes it), the
transforms of each gap, and the pairs tables and labels of each gap with
gap j's labels moved by ``j * OFFSET``, so that no two gaps share a label.
"""

from __future__ import annotations

import contextlib
import itertools
import pathlib

import numpy as np

from benchmark.entries._shared import EntryBase, span

OFFSET = 1 << 20
CACHE = pathlib.Path(__file__).resolve().parents[1] / ".cache"


def stack(flow, transforms, pairs, labels_src, labels_dst) -> dict:
    """One dict of a sample's per-gap lists (gap 1 first)."""
    tables = []
    for j, t in enumerate(pairs, 1):
        t = np.asarray(t, np.float64).reshape(-1, 10).copy()
        t[:, :2] += j * OFFSET
        tables.append(t)

    def labels(per_gap):
        return np.concatenate([np.asarray(lab, np.int64) + j * OFFSET
                               for j, lab in enumerate(per_gap, 1)])
    return dict(flow=np.asarray(flow), transforms=np.stack(transforms),
                pairs=np.concatenate(tables), labels_src=labels(labels_src),
                labels_dst=labels(labels_dst))


class Entry(EntryBase):
    """PCA-format samples through ``cli.run_sample``."""

    unit = "pair"
    root = "sample"

    def __init__(self, conf: dict, mix: dict, device: str):
        from icpflow_tpu_torch import SceneFlowEngine, cli, config_from_dict
        from icpflow_tpu_torch.data.pca import DatasetPCA
        from icpflow_tpu_torch.metrics import make_meters
        self.cfg = config_from_dict(conf["pipeline"])
        self.engine = SceneFlowEngine(self.cfg, device=device)
        # the samples' paths come with the items; the dataset's own list
        # of them is not read
        self.ds = DatasetPCA(self.cfg, str(CACHE), "test", device=device)
        self.cli, self.make_meters = cli, make_meters

    def schedule(self, items):
        """(key, item) for ever: the samples in turn."""
        return itertools.cycle(enumerate(items))

    def warm(self, items):
        for k, item in enumerate(items):
            self.call(k, item, None)

    def units(self, key, item) -> int:
        return self.cfg.num_frames - 1

    def call(self, key, item, timings):
        meters = self.make_meters(self.cfg.num_frames)
        res = self.cli.run_sample(self.engine, self.ds, item["path"], meters,
                                  timings)
        return stack(res.flow,
                     [r.transforms.cpu().numpy() for r in res.results],
                     [self.engine.pairs_array(r) for r in res.results],
                     [p["label_src"] for p in res.pairs],
                     [p["label_dst"] for p in res.pairs])

    @contextlib.contextmanager
    def spans(self):
        """Harness spans around the calls into each layer, for a traced
        run: ``load``, ``ground``, ``cluster``, ``pad``, ``track``,
        ``flow``, ``score``."""
        targets = ((self.ds, "load_raw", "load"),
                   (self.ds, "ground_removal", "ground"),
                   (self.ds, "cluster_pairs", "cluster"),
                   (self.engine, "pad_cloud", "pad"),
                   (self.engine, "track_pair", "track"),
                   (self.engine, "flow", "flow"))
        for obj, attr, name in targets:
            setattr(obj, attr, span(name, getattr(obj, attr)))
        score = self.cli.score_sample
        self.cli.score_sample = span("score", score)
        try:
            yield
        finally:
            for obj, attr, _ in targets:
                delattr(obj, attr)
            self.cli.score_sample = score

    @staticmethod
    def reference(ref, mix, items, keys) -> dict:
        """The reference's output for each key."""
        from benchmark.reference.offline import sample
        out = {}
        for k in sorted(set(keys)):
            r = sample(ref, items[k]["arrays"])
            out[k] = stack(r["flow"], r["transforms"], r["pairs"],
                           r["labels_src"], r["labels_dst"])
        return out
