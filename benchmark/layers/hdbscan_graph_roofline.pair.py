"""Percent of its bound hdbscan's exact kNN graph reached over the profiled
calls: the least time the card could take for each call's rows (counter
``hdbscan_rows`` through ``hdbscan_bound.bound_ms``) over the device's busy
time in the graph. That time is the graph's host time (span
``icpflow.graph``) less the device's idle time while the host was in the
harness span ``hdbscan_graph`` around it (the profile's idle gaps): the
stage reads a host count after each block's top-k, so the graph's device
work ends inside the span, and what the device idles there, while the host
launches a block or waits on its read, is not the kernels' time."""
from benchmark import program_spans, readings
from benchmark.layers import hdbscan_bound

ENTRY = "pair_hdbscan"


def read(rec):
    prof = readings.profile(rec, ENTRY)
    calls = program_spans.window_calls(rec, ENTRY, profiled=True)
    if prof is None or calls is None or len(calls) != prof["calls"]:
        return None
    idle_s = dict(prof["idle_gaps"]).get("hdbscan_graph")
    calls = [c for c in calls
             if "hdbscan_rows" in c.counters and "icpflow.graph" in c.spans]
    if idle_s is None or not calls:
        return None
    busy_ms = (sum(c.spans["icpflow.graph"].total_ns for c in calls) * 1e-6
               - idle_s * 1e3)
    if busy_ms <= 0:
        return None
    least = sum(hdbscan_bound.bound_ms(c.counters["hdbscan_rows"])
                for c in calls)
    return 100.0 * least / busy_ms
