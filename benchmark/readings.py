"""What the metric readers share: means over a traced window's calls and
shares of its profiled stretch. Each returns None where its record holds
nothing to read (another entry, an untraced run, no profile)."""

from __future__ import annotations


def stage_ms(rec: dict, entry: str, stage: str):
    """Mean milliseconds a call of ``stage`` (the program's StageClock),
    calls without the stage counting 0."""
    if rec.get("entry") != entry or not rec.get("stages"):
        return None
    return sum(t.get(stage, 0.0) for t in rec["stages"]) / len(rec["stages"])


def host_ms(rec: dict, entry: str):
    """Mean milliseconds a call outside the program's stages: the host
    clock around the call less the sum of its StageClock stages."""
    if rec.get("entry") != entry or not rec.get("stages"):
        return None
    rows = zip(rec["host_ms"], rec["stages"])
    return sum(h - sum(t.values()) for h, t in rows) / len(rec["stages"])


def profile(rec: dict, entry: str):
    """The profiled stretch of ``entry``'s window, or None where there is
    none or no operation ran on a device in it (a CPU run)."""
    if rec.get("entry") != entry:
        return None
    prof = rec.get("profile")
    return prof if prof and prof.get("calls") and prof["busy_s"] > 0 else None
