"""Mean host ms a call in the matcher's ICP (span ``icpflow.icp``)."""
from benchmark import program_spans


def read(rec):
    return program_spans.span_ms(rec, "stream", "icpflow.icp")
