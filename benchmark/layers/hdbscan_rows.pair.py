"""Mean rows of hdbscan's exact kNN graph a call (counter ``hdbscan_rows``:
representatives on the ``dedup`` path, valid points on ``full``); None
where no call counted it."""
from benchmark import program_spans


def read(rec):
    calls = program_spans.window_calls(rec, "pair_hdbscan")
    if calls is None or not any("hdbscan_rows" in c.counters for c in calls):
        return None
    return program_spans.counter(rec, "pair_hdbscan", "hdbscan_rows")
