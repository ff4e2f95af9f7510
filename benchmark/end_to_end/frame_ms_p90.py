"""90th percentile of every stream frame's latency in the window, host
clock from the call to its returned host arrays."""
from benchmark import stats


def read(rec):
    if rec.get("unit") != "frame" or not rec.get("latency_ms"):
        return None
    return stats.percentile(rec["latency_ms"], 90)
