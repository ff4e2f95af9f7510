"""Mean host ms a call in the histogram init (span ``icpflow.hist_init``),
over the sample's frame pairs."""
from benchmark import program_spans


def read(rec):
    return program_spans.span_ms(rec, "offline", "icpflow.hist_init")
