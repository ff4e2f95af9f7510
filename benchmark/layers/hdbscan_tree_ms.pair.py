"""Mean host ms a call in hdbscan's host half: the native tree (span
``icpflow.native``), then the border reclaim and the size-ranked relabel
(span ``icpflow.finish``)."""
from benchmark import program_spans


def read(rec):
    parts = [program_spans.span_ms(rec, "pair_hdbscan", name)
             for name in ("icpflow.native", "icpflow.finish")]
    return None if None in parts else sum(parts)
