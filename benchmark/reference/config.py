"""The reference's view of a configuration file's ``pipeline`` keys."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    return torch.device(device)


class Config:
    """The pipeline keys as attributes (JSON lists as tuples), with the two
    derived values the reference reads (ICP-Flow ``main.py:200``)."""

    def __init__(self, keys: dict):
        for k, v in keys.items():
            setattr(self, k, tuple(v) if isinstance(v, list) else v)

    @property
    def hist_bin(self) -> float:
        return self.thres_dist

    def translation_frame(self, gap: int,
                          ego_translation: float = 0.0) -> float:
        return max(self.speed * gap, ego_translation) * 2.0
