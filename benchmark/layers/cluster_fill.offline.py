"""Share of the DBSCAN buckets' slots that hold a valid point: the
counters ``dbscan_points`` over ``dbscan_slots``, each summed over the
window's unprofiled calls. What a call pays for in its sort, its cells and
its propagation buffers grows with the slots. None where no call counted
them (a program that does not)."""
from benchmark import program_spans


def read(rec):
    calls = program_spans.window_calls(rec, "offline")
    if calls is None:
        return None
    slots = sum(c.counters.get("dbscan_slots", 0) for c in calls)
    if not slots:
        return None
    return sum(c.counters.get("dbscan_points", 0) for c in calls) / slots
