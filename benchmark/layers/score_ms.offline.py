"""Mean host ms a call in the metric sweep (span ``icpflow.score``): the
eval crop and the category x granularity sweep on the host."""
from benchmark import program_spans


def read(rec):
    return program_spans.span_ms(rec, "offline", "icpflow.score")
