"""Mean host ms a call in ``ops.geometry.kabsch``, every caller (span
``icpflow.kabsch``)."""
from benchmark import program_spans


def read(rec):
    return program_spans.span_ms(rec, "pair", "icpflow.kabsch")
