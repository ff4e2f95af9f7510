"""Share of ICP trips replayed from a CUDA graph captured by an earlier
trip: 1 - mean captures / mean replays a call (counters
``icp_graph_captures``, ``icp_graph_replays``); None where nothing
was replayed (a CPU run, or a program without the graphs)."""
from benchmark import program_spans


def read(rec):
    replays = program_spans.counter(rec, "offline", "icp_graph_replays")
    if not replays:
        return None
    return 1.0 - program_spans.counter(rec, "offline", "icp_graph_captures") \
        / replays
