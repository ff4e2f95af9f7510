"""The program's entries that a cell's window drives, and the reference's
counterpart of each. A configuration file names its entry (``"entry"``).

* ``pair``: ``icpflow_tpu_torch.pipeline.run_frame_pair`` on ego-aligned
  host clouds, one call a frame pair, the mix's pairs served in turn;
* ``stream``: ``StreamingEngine(cfg, estimate_ego=...).process`` on raw
  sensor scans, one call a frame, the mix's sessions served in turn with
  ``reset()`` before each (a fresh map, as at the start of a log).

The program is imported here and only here, when an entry is built.
"""

from __future__ import annotations

import contextlib
import itertools


def _span(name, fn):
    import torch

    def wrapped(*args, **kw):
        with torch.profiler.record_function("bench." + name):
            return fn(*args, **kw)
    return wrapped


class PairEntry:
    """Frame pairs through ``run_frame_pair``."""

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
            setattr(eng, attr, _span(name, getattr(eng, attr)))
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


class StreamEntry:
    """Scan sessions through ``StreamingEngine.process``."""

    def __init__(self, conf: dict, mix: dict, device: str):
        from icpflow_tpu_torch import StreamingEngine, config_from_dict
        self.cfg = config_from_dict(conf["pipeline"])
        self.stream = StreamingEngine(
            self.cfg, estimate_ego=bool(conf.get("estimate_ego", True)),
            device=device)
        self.warm_frames = int(conf.get("warm_frames", 3))

    def schedule(self, items):
        """((session, frame), scan) for ever: the sessions in turn."""
        return (((s, k), scan) for s in itertools.cycle(range(len(items)))
                for k, scan in enumerate(items[s]))

    def warm(self, items):
        for s, session in enumerate(items):
            for k, scan in enumerate(session[:self.warm_frames]):
                self.call((s, k), scan, None)

    def call(self, key, scan, timings):
        if key[1] == 0:
            self.stream.reset()
        r = self.stream.process(scan, timings=timings)
        if r is None:
            return None
        return dict(flow=r.flow, pose=r.pose, pairs=r.pairs, labels=r.labels)

    @contextlib.contextmanager
    def spans(self):
        """Harness spans around the calls into each layer, for a traced
        run: ``ego``, ``ground``, ``pad``, ``cluster``, ``track``,
        ``flow`` (the host's copies out follow ``flow``)."""
        from icpflow_tpu_torch.models import streaming
        eng = self.stream.engine
        wrapped = (("pad_cloud", "pad"), ("cluster_joint", "cluster"),
                   ("track_pair", "track"), ("flow", "flow"))
        for attr, name in wrapped:
            setattr(eng, attr, _span(name, getattr(eng, attr)))
        ground = streaming.segment_ground
        streaming.segment_ground = _span("ground", ground)
        odo_cls = type(self.stream.odo) if self.stream.odo else None
        if odo_cls is not None:
            register = odo_cls.register_frame
            odo_cls.register_frame = _span("ego", register)
        try:
            yield
        finally:
            for attr, _ in wrapped:
                delattr(eng, attr)
            streaming.segment_ground = ground
            if odo_cls is not None:
                odo_cls.register_frame = register

    @staticmethod
    def reference(ref, mix, items, keys) -> dict:
        """The reference's output for each frame of the keys' sessions."""
        out = {}
        for s in sorted({k[0] for k in keys}):
            for k, r in enumerate(ref.stream(items[s])):
                out[(s, k)] = r
        return out


ENTRIES = {"pair": PairEntry, "stream": StreamEntry}
