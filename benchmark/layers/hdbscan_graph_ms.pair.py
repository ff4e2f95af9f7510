"""Mean host ms a call in hdbscan's exact kNN graph (span
``icpflow.graph``). The stage reads a host count once a block of rows,
after the block's top-k, so the span ends behind the graph's device work."""
from benchmark import program_spans


def read(rec):
    return program_spans.span_ms(rec, "pair_hdbscan", "icpflow.graph")
