"""Mean ICP iterations a call, summed over buckets and stages (counter
``icp_iters``)."""
from benchmark import program_spans


def read(rec):
    return program_spans.counter(rec, "pair", "icp_iters")
