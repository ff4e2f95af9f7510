"""Mean ICP iterations a call, summed over the sample's frame pairs, their
buckets and stages (counter ``icp_iters``)."""
from benchmark import program_spans


def read(rec):
    return program_spans.counter(rec, "offline", "icp_iters")
