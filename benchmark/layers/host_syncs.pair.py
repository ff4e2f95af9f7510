"""Mean synchronizing CUDA calls a call, all spans (counter ``host_syncs``)."""
from benchmark import program_spans


def read(rec):
    return program_spans.host_syncs(rec, "pair")
