"""``pair``: ``icpflow_tpu_torch.pipeline.run_frame_pair`` on ego-aligned
host clouds, one call a frame pair, the mix's pairs served in turn."""

from __future__ import annotations

import contextlib
import itertools

from benchmark.entries._shared import EntryBase, span


class Entry(EntryBase):
    """Frame pairs through ``run_frame_pair``."""

    unit = "pair"
    root = "pair"

    def __init__(self, conf: dict, mix: dict, device: str):
        from icpflow_tpu_torch import SceneFlowEngine, config_from_dict
        from icpflow_tpu_torch import pipeline
        self.cfg = config_from_dict(conf["pipeline"])
        self.engine = SceneFlowEngine(self.cfg, device=device)
        self.pipeline = pipeline
        self.translation_frame = self.cfg.translation_frame(int(mix["gap"]))

    def schedule(self, items):
        """(key, item) for ever: the pairs in turn."""
        return itertools.cycle(enumerate(items))

    def warm(self, items):
        for item in items:
            self.call(0, item, None)

    def call(self, key, item, timings):
        src, dst = item
        r = self.pipeline.run_frame_pair(
            self.engine, src, dst, translation_frame=self.translation_frame,
            timings=timings)
        return dict(flow=r.flow, pairs=r.pairs, transforms=r.transforms,
                    labels_src=r.labels_src, labels_dst=r.labels_dst)

    @contextlib.contextmanager
    def spans(self):
        """Harness spans around the calls into each layer, for a traced
        run: ``pad``, ``cluster``, ``track``, ``flow`` (the host's copies
        out follow ``flow``)."""
        eng = self.engine
        for attr, name in (("pad_cloud", "pad"), ("cluster_joint", "cluster"),
                           ("track_pair", "track"), ("flow", "flow")):
            setattr(eng, attr, span(name, getattr(eng, attr)))
        try:
            yield
        finally:
            for attr in ("pad_cloud", "cluster_joint", "track_pair", "flow"):
                delattr(eng, attr)

    @staticmethod
    def reference(ref, mix, items, keys) -> dict:
        """The reference's output for each key."""
        tf = ref.cfg.translation_frame(int(mix["gap"]))
        return {k: ref.frame_pair(items[k][0], items[k][1], tf)
                for k in sorted(set(keys))}
