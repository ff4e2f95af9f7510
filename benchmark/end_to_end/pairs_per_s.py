"""Frame pairs completed in the window over the window's seconds."""
from benchmark import stats


def read(rec):
    if rec.get("entry") != "pair":
        return None
    return stats.rate(rec["calls"], rec["window_s"])
