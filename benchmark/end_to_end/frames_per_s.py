"""Stream frames processed in the window over the window's seconds."""
from benchmark import stats


def read(rec):
    if rec.get("entry") != "stream":
        return None
    return stats.rate(rec["calls"], rec["window_s"])
