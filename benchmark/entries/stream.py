"""``stream``: ``StreamingEngine(cfg, estimate_ego=...).process`` on raw
sensor scans, one call a frame, the mix's sessions served in turn with
``reset()`` before each (a fresh map, as at the start of a log)."""

from __future__ import annotations

import contextlib
import itertools

from benchmark.entries._shared import EntryBase, span


class Entry(EntryBase):
    """Scan sessions through ``StreamingEngine.process``."""

    unit = "frame"
    root = "frame"

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
            setattr(eng, attr, span(name, getattr(eng, attr)))
        ground = streaming.segment_ground
        streaming.segment_ground = span("ground", ground)
        odo_cls = type(self.stream.odo) if self.stream.odo else None
        if odo_cls is not None:
            register = odo_cls.register_frame
            odo_cls.register_frame = span("ego", register)
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
