"""Mean host ms a call in the matcher's histogram init (span
``icpflow.hist_init``)."""
from benchmark import program_spans


def read(rec):
    return program_spans.span_ms(rec, "pair", "icpflow.hist_init")
