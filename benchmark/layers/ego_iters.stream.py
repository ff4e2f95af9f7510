"""Mean odometry iterations a frame, one host read each (counter
``ego_iters``)."""
from benchmark import program_spans


def read(rec):
    return program_spans.counter(rec, "stream", "ego_iters")
