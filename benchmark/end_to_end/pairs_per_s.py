"""Frame pairs completed in the window over the window's seconds."""
from benchmark import stats


def read(rec):
    if rec.get("unit") != "pair":
        return None
    return stats.rate(rec["units"], rec["window_s"])
