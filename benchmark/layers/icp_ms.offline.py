"""Mean host ms a call in the matcher's ICP (span ``icpflow.icp``),
summed over the sample's frame pairs."""
from benchmark import program_spans


def read(rec):
    return program_spans.span_ms(rec, "offline", "icpflow.icp")
